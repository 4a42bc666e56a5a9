"""The SGS models of the triperiodic LES and the dynamic model's other
single-device classes in cales_torch against cales_tpu, fp64 on the CPU:

  * the smag kernel's plain twin without walls (no van Driest damping)
    against fused_smag's no-wall mode in interpret mode and against
    cales_tpu's sgs.smag_visct on the box;
  * the dsmag kernel's twin in its periodic-z mode (ZP: every z ghost the
    plane at the other end) with 'dit' and 'channel' averaging, the port's
    nu_t glue (timeloop._dsmag_ratio) after it, against cales_tpu's
    sgs.dsmag_visct on the box (the setup of tests/test_sgs.py's
    triperiodic oracle), and the port's sgs.dsmag_visct beside it;
  * the twin with the 2D test filter (F2D) against sgs.dsmag_visct with
    filter_2d on a stretched channel with a moving wall, and F2D with ZP
    on the box;
  * the 'dit' ratio against the JAX package's formula (timeloop.py:1512).

Inputs are numpy-seeded random periodic fields whose Fourier amplitudes
fall as 1/k (on the channel with a mean u profile).  Tolerances: nu_t 1e-12
relative to its maximum (the same filters and products; the average's
sums in another order)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cales_tpu.config import Config as JConfig, C_SMAG
from cales_tpu.config import effective_cbcvel as j_effective_cbcvel
from cales_tpu.grid import make_grid_from_config as j_make_grid
from cales_tpu import sgs as jsgs
from cales_tpu.ops import boundary as jbnd
from cales_tpu.ops import pallas_kernels as pk

from cales_torch.config import Config, effective_cbcvel
from cales_torch.grid import make_grid_from_config
from cales_torch import sgs as tsgs
from cales_torch.ops import boundary as tbnd
from cales_torch.ops import kernels as K
from cales_torch.timeloop import _dsmag_ratio

torch.set_num_threads(1)

PER = dict(cbcvel=((('P',) * 3,) * 3,) * 2, cbcpre=(('P',) * 3,) * 2,
           cbcsgs=(('P',) * 3,) * 2)
BOX = dict(l=(2 * np.pi, 1.7, 2.3), gtype=1, gr=0.0, visci=1600.0,
           dtype='float64', **PER)
# a stretched channel (gr = 5, validation/dsmag_channel.py's) whose upper
# wall moves: u 0.3, v -0.2
CHAN = dict(l=(12.8, 4.8, 2.0), gtype=1, gr=5.0, visci=10_000.0,
            dtype='float64',
            cbcvel=((('P', 'P', 'P'), ('P', 'P', 'P'), ('D', 'D', 'D')),) * 2,
            cbcpre=(('P', 'P', 'N'),) * 2, cbcsgs=(('P', 'P', 'D'),) * 2,
            bcvel=(((0.0,) * 3,) * 3,
                   ((0.0,) * 3, (0.0,) * 3, (0.3, -0.2, 0.0))))
ZVALS = (0.0, 0.3, 0.0, -0.2)


def _rel_close(got, ref, rtol):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rtol * np.abs(ref).max())


def _pair(ng, base, **kw):
    args = dict(base, ng=ng, **kw)
    jcfg, tcfg = JConfig(**args), Config(**args)
    return jcfg, tcfg, j_make_grid(jcfg), make_grid_from_config(tcfg)


def _wrap(a):
    return np.pad(np.asarray(a), 1, mode='wrap')


def _by(vals):
    return tuple(tuple(vals[ib][d] for ib in range(2)) for d in range(3))


def _bc_values(cfg, make):
    return [make(cfg.ng, tuple(tuple(cfg.bcvel[ib][d][iv] for ib in range(2))
                               for d in range(3)), np.float64)
            for iv in range(3)]


def _jax_dsmag(jcfg, jgrid, jp, pad_filtered):
    setup = jsgs.SGSSetup(jcfg, jgrid, j_effective_cbcvel(jcfg))
    bcs = jbnd.make_bc_values(jcfg.ng, _by(jcfg.bcsgs), np.float64)
    return np.asarray(jsgs.dsmag_visct(setup, jcfg, jgrid,
                                       *map(jnp.asarray, jp), bcs, None,
                                       pad_filtered))


def _port_dsmag(tcfg, tgrid, tp, pad_filtered):
    setup = tsgs.SGSSetup(tcfg, tgrid, effective_cbcvel(tcfg))
    bcs = tbnd.make_bc_values(tcfg.ng, _by(tcfg.bcsgs), torch.float64)
    return tsgs.dsmag_visct(setup, tcfg, tgrid, *tp, bcs, pad_filtered)


def _twin_nut(fields, edges, tcfg, tgrid, zper, f2d, walls=False, zvals=ZVALS):
    """The dsmag kernel's twin (through its wrapper, on the CPU) and the
    port's nu_t glue: nu_t = max(|S| ratio, 0)."""
    t = torch.as_tensor
    nz = tcfg.ng[2]
    a2 = np.full(nz, 4.0)
    if walls:
        a2[0] = a2[-1] = 2.52
    if f2d:
        a2[:] = 2.52
    K.reset_launches()
    s0, num, den = K.dsmag(*fields, *edges, t(a2), t(tgrid.dzci),
                           t(tgrid.dzfi), tcfg.dli[0], tcfg.dli[1], walls,
                           walls, zvals if walls else (0.0,) * 4,
                           avg=tcfg.dsmag_avg, zper=zper, f2d=f2d)
    assert K.LAUNCHES['dsmag'] == 0
    wz = t(tgrid.dzf[1:nz + 1] / tcfg.l[2])
    return _dsmag_ratio(s0, num, den, tcfg.dsmag_avg, wz)


def _box_interiors(ng, seed):
    """Seeded random periodic fields whose Fourier amplitudes fall as 1/k
    (white noise makes the box's one 'dit' ratio negative, nu_t 0)."""
    nx, ny, nz = ng
    rng = np.random.default_rng(seed)
    kz, ky, kx = np.meshgrid(*(np.fft.fftfreq(n) * n for n in (nz, ny, nx)),
                             indexing='ij')
    k = np.sqrt(kx ** 2 + ky ** 2 + kz ** 2)
    k[0, 0, 0] = np.inf
    out = []
    for _ in range(3):
        q = np.real(np.fft.ifftn(
            np.fft.fftn(rng.standard_normal((nz, ny, nx))) / k))
        out.append(q / np.abs(q).max())
    return out


def _box_inputs(ng, seed):
    """Interiors and their triperiodic fill: padded numpy arrays,
    interiors and (wrap) z-edge stacks as tensors."""
    ui = _box_interiors(ng, seed)
    t = torch.as_tensor
    edges = [t(np.stack([a[-1], a[-1], a[0]])) for a in ui]
    return [_wrap(a) for a in ui], [t(a) for a in ui], edges


def _wrap_filtered_jax(uf, vf, wf):
    return tuple(jnp.asarray(_wrap(q)) for q in (uf, vf, wf))


def _wrap_filtered_port(uf, vf, wf):
    return tuple(torch.as_tensor(_wrap(q.numpy())) for q in (uf, vf, wf))


def test_smag_twin_without_walls_matches_jax_on_the_box():
    """tests/test_pallas_kernels.py's no-wall fused_smag on the box
    (128, 16, 8): nu_t = (Cs Delta)^2 |S|, fd = 1 (sgs.f90:148-149)."""
    ng = (128, 16, 8)
    jcfg, tcfg, jgrid, tgrid = _pair(ng, BOX, sgstype='smag')
    jp, (u, v, w), (ue, ve, we) = _box_inputs(ng, 2)
    setup = tsgs.SGSSetup(tcfg, tgrid, effective_cbcvel(tcfg))
    assert not setup.any_wall
    csd2 = (C_SMAG * setup.delta) ** 2
    ref = np.asarray(pk.fused_smag(
        *map(jnp.asarray, (u.numpy(), v.numpy(), w.numpy(), ue.numpy(),
                           ve.numpy(), we.numpy())),
        jgrid.dzci, jgrid.dzfi, jcfg.dli[0], jcfg.dli[1], jcfg.visc, csd2,
        interpret=True))
    model = np.asarray(jsgs.smag_visct(
        jsgs.SGSSetup(jcfg, jgrid, j_effective_cbcvel(jcfg)), jcfg, jgrid,
        *map(jnp.asarray, jp)))
    _rel_close(ref, model, 1e-12)
    t = torch.as_tensor
    nz = ng[2]
    zero = torch.zeros(ng[1], ng[0], dtype=torch.float64)
    got = K.smag(u, v, w, ue, ve, we, t(tgrid.dzci), t(tgrid.dzfi),
                 tcfg.dli[0], tcfg.dli[1], tcfg.visc, t(csd2),
                 torch.zeros(nz, dtype=torch.float64),
                 torch.ones(nz, dtype=torch.float64), zero, zero,
                 have_zwalls=False)
    _rel_close(got, ref, 1e-12)
    port = tsgs.smag_visct(setup, tcfg, tgrid,
                           *(torch.as_tensor(a) for a in jp))
    _rel_close(port, model, 1e-12)


@pytest.mark.parametrize('avg', ['dit', 'channel'])
def test_dsmag_periodic_z_twin_matches_jax_on_the_box(avg):
    """The twin's periodic-z mode and the port's average against
    cales_tpu's XLA model on the box (its edge stacks go unread: they
    are given here as the wrap, as the post-correction fill has them)."""
    ng = (16, 12, 10)
    jcfg, tcfg, jgrid, tgrid = _pair(ng, BOX, sgstype='dsmag',
                                     dsmag_avg=avg)
    jp, fields, edges = _box_inputs(ng, 0)
    ref = _jax_dsmag(jcfg, jgrid, jp, _wrap_filtered_jax)
    assert ref.max() > 0
    _rel_close(_twin_nut(fields, edges, tcfg, tgrid, True, False), ref,
               1e-12)
    _rel_close(_port_dsmag(tcfg, tgrid, [torch.as_tensor(a) for a in jp],
                           _wrap_filtered_port), ref, 1e-12)
    # the kernel's mode reads no z-edge stack: garbage there changes nothing
    junk = [torch.full_like(e, 7.0) for e in edges]
    _rel_close(_twin_nut(fields, junk, tcfg, tgrid, True, False), ref,
               1e-12)


def _channel_inputs(jcfg, tcfg, jgrid, tgrid, seed):
    """The post-correction fill of random interiors on the channel by both
    packages (a random lower w face), and the port's edge stacks."""
    nx, ny, nz = tcfg.ng
    u, v, w = _box_interiors(tcfg.ng, seed)
    u = u + np.linspace(0.2, 1.0, nz)[:, None, None]
    rng = np.random.default_rng(seed + 1)
    vlo = [np.zeros((nz + 2, ny + 2)), np.zeros((nz + 2, nx + 2)),
           _wrap(1e-3 * rng.standard_normal((ny, nx)))]
    jb = _bc_values(jcfg, jbnd.make_bc_values)
    tb = _bc_values(tcfg, tbnd.make_bc_values)
    jp = jbnd.pad_velocity(*map(jnp.asarray, (u, v, w)),
                           j_effective_cbcvel(jcfg), *jb, jcfg.dl,
                           jgrid.dzc, jgrid.dzf,
                           vlo=tuple(map(jnp.asarray, vlo)), is_correc=True)
    t = lambda a: torch.as_tensor(np.asarray(a))  # noqa: E731
    cbc = effective_cbcvel(tcfg)
    tp = tbnd.pad_velocity(t(u), t(v), t(w), cbc, *tb, tcfg.dl, tgrid.dzc,
                           tgrid.dzf, vlo=tuple(map(t, vlo)), is_correc=True)
    edges = tbnd.zedge_velocity(t(u), t(v), t(w), cbc, *tb, tgrid.dzc,
                                tgrid.dzf, vlo=tuple(map(t, vlo)),
                                is_correc=True)
    return ([np.asarray(a) for a in jp[:3]], tp[:3], (t(u), t(v), t(w)),
            [e.contiguous() for e in edges])


def _static_fill(cfg, grid, make, pad, cbc):
    bcs = _bc_values(cfg, make)

    def fill(uf, vf, wf):
        return pad(uf, vf, wf, cbc, *bcs, cfg.dl, grid.dzc, grid.dzf)[:3]
    return fill


@pytest.mark.parametrize('avg', ['dit', 'channel'])
def test_dsmag_2d_filter_twin_matches_jax_on_a_channel(avg):
    """The 2D test filter (F2D) on the stretched channel with a moving
    upper wall: no z pass, no extrapolation before filtering, alpha^2 2.52
    everywhere; the filtered velocity's z fill keeps the walls' recipe."""
    ng = (16, 12, 10)
    jcfg, tcfg, jgrid, tgrid = _pair(ng, CHAN, sgstype='dsmag',
                                     dsmag_avg=avg, filter_2d=True)
    jp, tp, fields, edges = _channel_inputs(jcfg, tcfg, jgrid, tgrid, 1)
    ref = _jax_dsmag(jcfg, jgrid, jp, _static_fill(
        jcfg, jgrid, jbnd.make_bc_values, jbnd.pad_velocity,
        j_effective_cbcvel(jcfg)))
    assert ref.max() > 0
    _rel_close(_twin_nut(fields, edges, tcfg, tgrid, False, True,
                         walls=True), ref, 1e-12)
    _rel_close(_port_dsmag(tcfg, tgrid, tp, _static_fill(
        tcfg, tgrid, tbnd.make_bc_values, tbnd.pad_velocity,
        effective_cbcvel(tcfg))), ref, 1e-12)


@pytest.mark.parametrize('avg', ['dit', 'channel'])
def test_dsmag_2d_filter_periodic_z_twin_matches_jax_on_the_box(avg):
    ng = (16, 12, 10)
    jcfg, tcfg, jgrid, tgrid = _pair(ng, BOX, sgstype='dsmag',
                                     dsmag_avg=avg, filter_2d=True)
    jp, fields, edges = _box_inputs(ng, 0)
    ref = _jax_dsmag(jcfg, jgrid, jp, _wrap_filtered_jax)
    assert ref.max() > 0
    _rel_close(_twin_nut(fields, edges, tcfg, tgrid, True, True), ref,
               1e-12)


def test_dit_ratio_matches_the_jax_formula():
    """_dsmag_ratio 'dit' on a kernel's per-(z, block) partial sums: one
    ratio, the rows' sums weighted by dzf / l_z (cales_tpu
    timeloop.py:1512-1514, ave0d_dit), on a stretched grid."""
    ng = (32, 16, 12)
    jcfg, tcfg, jgrid, tgrid = _pair(ng, CHAN, sgstype='dsmag',
                                     dsmag_avg='dit')
    nz = ng[2]
    rng = np.random.default_rng(11)
    s0 = np.abs(rng.standard_normal((nz, 16, 32)))
    num = rng.standard_normal((nz, 7))
    den = np.abs(rng.standard_normal((nz, 7)))
    wz = jnp.asarray(jgrid.dzf[1:nz + 1] / jcfg.l[2])
    num1, den1 = jnp.sum(jnp.asarray(num), axis=1), jnp.sum(
        jnp.asarray(den), axis=1)
    ratio = jnp.sum(num1 * wz) / jnp.sum(den1 * wz)
    ref = np.asarray(jnp.maximum(jnp.asarray(s0) * ratio, 0.0))
    t = torch.as_tensor
    got = _dsmag_ratio(t(s0), t(num), t(den), 'dit',
                       t(tgrid.dzf[1:nz + 1] / tcfg.l[2]))
    _rel_close(got, ref, 1e-14)
    assert float(ratio) != 0.0
