"""The SGS layer of cales_torch against cales_tpu, fp64 on the CPU: the
eddy-viscosity models on padded fields (sgs.smag_visct, sgs.dsmag_visct),
and the plain twins of the smag and dsmag kernels against the JAX Pallas
kernels they port (fused_smag, fused_dsmag_onepass with 'channel'
averaging), run in interpret mode as tests/test_pallas_kernels.py runs
them, and against the port's own dsmag model.

Inputs are numpy-seeded random interiors on a stretched channel grid (z
walls, periodic x/y).  Tolerances: nu_t 1e-12 relative to its maximum
(the model's filters and products keep the JAX package's operation order;
1 - exp(-x) in the van Driest factor amplifies an ulp of exp); s0 1e-12
relative; the per-z-row sums of num = M_ij L_ij and den = M_ij M_ij 1e-11
relative to their largest row (sums over ny*nx cells in another order)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cales_tpu.config import Config as JConfig, C_SMAG
from cales_tpu.config import effective_cbcvel as j_effective_cbcvel
from cales_tpu.grid import make_grid_from_config as j_make_grid
from cales_tpu import sgs as jsgs
from cales_tpu.ops import boundary as jbnd
from cales_tpu.ops import pallas_dsmag as pds
from cales_tpu.ops import pallas_kernels as pk

from cales_torch.config import Config, effective_cbcvel
from cales_torch.grid import make_grid_from_config
from cales_torch import sgs as tsgs
from cales_torch.ops import boundary as tbnd
from cales_torch.ops import kernels as K

torch.set_num_threads(1)

CHAN = dict(l=(2 * np.pi, np.pi, 2.0), gtype=1, gr=1.2, visci=1000.0,
            dtype='float64', sgstype='dsmag', dsmag_avg='channel',
            cbcvel=((('P', 'P', 'P'), ('P', 'P', 'P'), ('D', 'D', 'D')),) * 2,
            cbcpre=(('P', 'P', 'N'),) * 2, cbcsgs=(('P', 'P', 'D'),) * 2)


def _cfgs(ng, **kw):
    """The same configuration built by each package."""
    args = dict(CHAN, ng=ng, **kw)
    return JConfig(**args), Config(**args)


def _rel_close(got, ref, rtol):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rtol * np.abs(ref).max())


def _interiors(ng, seed, scale=0.1):
    nx, ny, nz = ng
    rng = np.random.default_rng(seed)
    mean = np.linspace(0.2, 1.0, nz)[:, None, None]
    return [mean * (k == 0) + scale * rng.standard_normal((nz, ny, nx))
            for k in range(3)]


def _bc_values(cfg, make):
    by = lambda iv: tuple(tuple(cfg.bcvel[ib][d][iv] for ib in range(2))  # noqa: E731
                          for d in range(3))
    return [make(cfg.ng, by(iv), np.float64) for iv in range(3)]


def _padded_pair(jcfg, tcfg, seed, wlo=None):
    """The post-correction fill of random interiors by both packages
    (is_correc with a lower-wall w face plane `wlo`): JAX padded arrays,
    torch padded tensors, and the port's edge stacks."""
    jgrid, tgrid = j_make_grid(jcfg), make_grid_from_config(tcfg)
    u, v, w = _interiors(tcfg.ng, seed)
    nx, ny, nz = tcfg.ng
    vlo = [np.zeros((nz + 2, ny + 2)), np.zeros((nz + 2, nx + 2)),
           np.zeros((ny + 2, nx + 2)) if wlo is None else wlo]
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
    return (jgrid, tgrid, [np.asarray(a) for a in jp[:3]], tp[:3],
            (t(u), t(v), t(w)), [e.contiguous() for e in edges], tb)


def _pad_filtered(cfg, grid, make, pad):
    """The filtered-velocity fill: bounduvw with the static planes."""
    bcs = _bc_values(cfg, make)
    cbc = (j_effective_cbcvel if pad is jbnd.pad_velocity
           else effective_cbcvel)(cfg)

    def fill(uf, vf, wf):
        return pad(uf, vf, wf, cbc, *bcs, cfg.dl, grid.dzc, grid.dzf)[:3]
    return fill


@pytest.mark.parametrize('ng', [(16, 12, 10), (24, 8, 12)])
def test_dsmag_visct_matches_jax(ng):
    jcfg, tcfg = _cfgs(ng)
    jgrid, tgrid, jp, tp, _, _, _ = _padded_pair(jcfg, tcfg, 1)
    by = lambda c: tuple(tuple(c.bcsgs[ib][d] for ib in range(2))  # noqa: E731
                         for d in range(3))
    ref = jsgs.dsmag_visct(
        jsgs.SGSSetup(jcfg, jgrid, j_effective_cbcvel(jcfg)), jcfg, jgrid,
        *map(jnp.asarray, jp), jbnd.make_bc_values(jcfg.ng, by(jcfg),
                                                   np.float64),
        None, _pad_filtered(jcfg, jgrid, jbnd.make_bc_values,
                            jbnd.pad_velocity))
    got = tsgs.dsmag_visct(
        tsgs.SGSSetup(tcfg, tgrid, effective_cbcvel(tcfg)), tcfg, tgrid,
        *tp, tbnd.make_bc_values(tcfg.ng, by(tcfg), torch.float64),
        _pad_filtered(tcfg, tgrid, tbnd.make_bc_values, tbnd.pad_velocity))
    assert float(got.max()) > 0
    _rel_close(got.numpy(), ref, 1e-12)


def test_smag_visct_matches_jax_on_a_channel():
    jcfg, tcfg = _cfgs((16, 12, 10), sgstype='smag')
    jgrid, tgrid, jp, tp, _, _, _ = _padded_pair(jcfg, tcfg, 2)
    ref = jsgs.smag_visct(jsgs.SGSSetup(jcfg, jgrid,
                                        j_effective_cbcvel(jcfg)),
                          jcfg, jgrid, *map(jnp.asarray, jp))
    got = tsgs.smag_visct(tsgs.SGSSetup(tcfg, tgrid, effective_cbcvel(tcfg)),
                          tcfg, tgrid, *tp)
    _rel_close(got.numpy(), ref, 1e-12)


@pytest.mark.parametrize('avg,filter_2d', [('dit', False), ('channel', True)])
def test_dsmag_visct_dit_and_2d_filter_match_jax(avg, filter_2d):
    """The variants this file once held outside the port ('dit', the 2D
    test filter) against cales_tpu's model on the channel."""
    jcfg, tcfg = _cfgs((16, 12, 10), dsmag_avg=avg, filter_2d=filter_2d)
    assert tsgs.dsmag_unsupported(tcfg) == []
    jgrid, tgrid, jp, tp, _, _, _ = _padded_pair(jcfg, tcfg, 7)
    by = lambda c: tuple(tuple(c.bcsgs[ib][d] for ib in range(2))  # noqa: E731
                         for d in range(3))
    ref = jsgs.dsmag_visct(
        jsgs.SGSSetup(jcfg, jgrid, j_effective_cbcvel(jcfg)), jcfg, jgrid,
        *map(jnp.asarray, jp), jbnd.make_bc_values(jcfg.ng, by(jcfg),
                                                   np.float64),
        None, _pad_filtered(jcfg, jgrid, jbnd.make_bc_values,
                            jbnd.pad_velocity))
    got = tsgs.dsmag_visct(
        tsgs.SGSSetup(tcfg, tgrid, effective_cbcvel(tcfg)), tcfg, tgrid,
        *tp, tbnd.make_bc_values(tcfg.ng, by(tcfg), torch.float64),
        _pad_filtered(tcfg, tgrid, tbnd.make_bc_values, tbnd.pad_velocity))
    _rel_close(got.numpy(), ref, 1e-12)


@pytest.mark.parametrize('avg,filter_2d,missing', [
    ('duct', True, 'filter_2d with y walls')])
def test_dsmag_variants_outside_the_port_raise(avg, filter_2d, missing):
    _, tcfg = _cfgs((16, 12, 10), dsmag_avg=avg, filter_2d=filter_2d,
                    cbcvel=((('P', 'P', 'P'), ('D', 'D', 'D'),
                             ('D', 'D', 'D')),) * 2,
                    cbcpre=(('P', 'N', 'N'),) * 2,
                    cbcsgs=(('P', 'D', 'D'),) * 2)
    assert any(missing in m for m in tsgs.dsmag_unsupported(tcfg))
    tgrid = make_grid_from_config(tcfg)
    z = torch.zeros((12, 14, 18), dtype=torch.float64)
    with pytest.raises(NotImplementedError, match=missing):
        tsgs.dsmag_visct(tsgs.SGSSetup(tcfg, tgrid, effective_cbcvel(tcfg)),
                         tcfg, tgrid, z, z, z, None, None)


def _alph2(nz):
    a = np.full(nz, 4.0)
    a[0] = a[-1] = 2.52
    return a


def test_dsmag_twin_matches_pallas_onepass():
    """fused_dsmag_onepass ('channel', interpret mode, about 10 s on one
    CPU core) at (nx, ny, nz) = (128, 16, 16) on random interiors with
    random ghost rows; the stacks' middle row is the last interior plane,
    as in the post-correction fill (the one-pass kernel reads that plane
    from the interior, the twin from the stack)."""
    nx, ny, nz = ng = (128, 16, 16)
    _, tcfg = _cfgs(ng)
    grid = make_grid_from_config(tcfg)
    rng = np.random.default_rng(3)
    F = lambda: 0.1 * rng.standard_normal((nz, ny, nx))   # noqa: E731
    E = lambda: 0.1 * rng.standard_normal((3, ny, nx))    # noqa: E731
    u, v, w, ue, ve, we = F(), F(), F(), E(), E(), E()
    for q, e in ((u, ue), (v, ve), (w, we)):
        e[1] = q[-1]
    zvals = (0.0, 0.3, 0.0, -0.2)
    s0r, numr, denr = pds.fused_dsmag_onepass(
        *map(jnp.asarray, (u, v, w, ue, ve, we)), _alph2(nz), grid.dzci,
        grid.dzfi, tcfg.dli[0], tcfg.dli[1], True, True, 'channel',
        interpret=True, zvals=zvals)
    t = torch.as_tensor
    s0, num, den = K.dsmag_plain(*map(t, (u, v, w, ue, ve, we)),
                                 t(_alph2(nz)), t(grid.dzci), t(grid.dzfi),
                                 tcfg.dli[0], tcfg.dli[1], True, True, zvals)
    _rel_close(s0.numpy(), s0r, 1e-12)
    _rel_close(num[:, 0].numpy(), np.asarray(numr)[:, ::8, 0].sum(axis=1),
               1e-11)
    _rel_close(den[:, 0].numpy(), np.asarray(denr)[:, ::8, 0].sum(axis=1),
               1e-11)


@pytest.mark.parametrize('ng', [(16, 12, 10), (20, 8, 6)])
def test_dsmag_twin_matches_the_model(ng):
    """The twin's written-out ghost recipes against sgs.dsmag_visct on the
    post-correction fill (with a non-zero lower w face, as a corrected
    state carries): nu_t = max(s0 num/den, 0) per z row."""
    jcfg, tcfg = _cfgs(ng)
    nx, ny, nz = ng
    wlo = 1e-3 * np.random.default_rng(4).standard_normal((ny, nx))
    wlo = np.pad(wlo, 1, mode='wrap')     # a periodic plane, as carried
    _, tgrid, _, tp, (u, v, w), (ue, ve, we), tb = _padded_pair(
        jcfg, tcfg, 5, wlo=wlo)
    by = tuple(tuple(tcfg.bcsgs[ib][d] for ib in range(2)) for d in range(3))
    ref = tsgs.dsmag_visct(
        tsgs.SGSSetup(tcfg, tgrid, effective_cbcvel(tcfg)), tcfg, tgrid, *tp,
        tbnd.make_bc_values(tcfg.ng, by, torch.float64),
        _pad_filtered(tcfg, tgrid, tbnd.make_bc_values, tbnd.pad_velocity))
    t = torch.as_tensor
    s0, num, den = K.dsmag(u, v, w, ue, ve, we, t(_alph2(nz)),
                           t(tgrid.dzci), t(tgrid.dzfi), tcfg.dli[0],
                           tcfg.dli[1], True, True)
    got = torch.clamp_min(s0 * (num.sum(1) / den.sum(1))[:, None, None], 0.0)
    _rel_close(got.numpy(), ref.numpy(), 1e-12)


def test_smag_twin_matches_pallas():
    nx, ny, nz = ng = (128, 16, 16)
    _, tcfg = _cfgs(ng, sgstype='smag')
    grid = make_grid_from_config(tcfg)
    rng = np.random.default_rng(6)
    F = lambda: 0.1 * rng.standard_normal((nz, ny, nx))   # noqa: E731
    E = lambda: 0.1 * rng.standard_normal((3, ny, nx))    # noqa: E731
    u, v, w, ue, ve, we = F(), F(), F(), E(), E(), E()
    setup = tsgs.SGSSetup(tcfg, grid, effective_cbcvel(tcfg))
    csd2 = (C_SMAG * setup.delta) ** 2
    zc = grid.zc[1:nz + 1]
    dw = np.minimum(zc, tcfg.l[2] - zc)
    nearlo = (zc <= tcfg.l[2] - zc).astype(np.float64)
    tlo, thi = np.abs(rng.standard_normal((2, ny, nx)))
    ref = pk.fused_smag(*map(jnp.asarray, (u, v, w, ue, ve, we)), grid.dzci,
                        grid.dzfi, tcfg.dli[0], tcfg.dli[1], tcfg.visc, csd2,
                        dw_1d=dw, nearlo_1d=nearlo, tauw_lo=jnp.asarray(tlo),
                        tauw_hi=jnp.asarray(thi), interpret=True)
    t = torch.as_tensor
    got = K.smag_plain(*map(t, (u, v, w, ue, ve, we)), t(grid.dzci),
                       t(grid.dzfi), tcfg.dli[0], tcfg.dli[1], tcfg.visc,
                       t(csd2), t(dw), t(nearlo), t(tlo), t(thi))
    _rel_close(got.numpy(), ref, 1e-12)
    K.reset_launches()
    again = K.smag(*map(t, (u, v, w, ue, ve, we)), t(grid.dzci),
                   t(grid.dzfi), tcfg.dli[0], tcfg.dli[1], tcfg.visc,
                   t(csd2), t(dw), t(nearlo), t(tlo), t(thi))
    torch.testing.assert_close(again, got, rtol=0, atol=0)
    assert K.LAUNCHES['smag'] == 0
