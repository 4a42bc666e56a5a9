"""The triperiodic slice and full-3D implicit diffusion: cales_torch against
cales_tpu on the CPU at fp64, with numpy-seeded inputs.

  * the periodic Thomas twin (ops/solve_kernels.thomas_periodic_z_plain,
    ops/tridiag.thomas_periodic) against pallas_solve.apply_thomas_periodic_z
    in interpret mode, pinned (Poisson) and unpinned (Helmholtz), and
    against cales_tpu's ops/tridiag.thomas_periodic; the card kernel's
    scheme (ops/tridiag.thomas_periodic_chunked: chunks a lane, cyclic
    reduction across them) against the same Pallas kernel;
  * mom_rk's 'xy+z' twin (full-3D split, CN fold) against fused_mom_rk in
    interpret mode, and the fold against the unfolded kernel's outputs;
  * correc_updatep's full-3D twin (p += pp + alpha L(pp)) on periodic-z
    edge stacks;
  * poisson.solve with and without alpha on the triperiodic and channel
    operators, by both routes and both z stages, against cales_tpu's solve
    (its XLA path, and its Pallas path in interpret mode);
  * 3 steps of the Taylor-Green vortex ('mat' with the Thomas z stage at
    nz = 384, 'mat' with z_eig, 'fft'), of full-3D implicit diffusion on
    the triperiodic box and the channel (the DNS by 'mat', the static-
    Smagorinsky LES by 'fft', the dynamic-Smagorinsky LES by 'mat'), and
    of impdiff_1d on the triperiodic box,
    against cales_tpu's Simulation(use_pallas=False);
  * the Taylor-Green example through driver.run at a reduced grid.

Tolerances: kernels 1e-12 relative to the reference's maximum (the same
sweeps, sums in another order), the momentum RHS 1e-11 absolute (terms of
size dzci^2 cancel); solves 1e-11 relative, p after removing its mean (the
pinned Thomas, the projected eig and the JAX package's eps-regularised XLA
Thomas fix the constant mode differently); steps u, v, w 1e-11, p 1e-10
after removing its mean."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cales_tpu import poisson as jpoisson
from cales_tpu.config import Config as JaxConfig
from cales_tpu.grid import make_grid_from_config as jax_grid
from cales_tpu.initflow import initflow
from cales_tpu.ops import pallas_kernels as pk
from cales_tpu.ops import pallas_solve as ps
from cales_tpu.ops import tridiag as jtri
from cales_tpu.timeloop import Simulation as JaxSimulation

from cales_torch import poisson as tpoisson
from cales_torch.config import Config
from cales_torch.grid import make_grid_from_config
from cales_torch.ops import boundary as tbnd
from cales_torch.ops import kernels as K
from cales_torch.ops import solve_kernels as SK
from cales_torch.timeloop import Simulation, unsupported

torch.set_num_threads(1)

PER = dict(cbcvel=((('P',) * 3,) * 3,) * 2, cbcpre=(('P',) * 3,) * 2,
           cbcsgs=(('P',) * 3,) * 2)
# examples/taylor_green_vortex_3d/input.nml at a test size
TGV = dict(ng=(16, 16, 16), l=(2 * np.pi,) * 3, gtype=1, gr=0.0,
           visci=1600.0, inivel='tgv', is_wallturb=False, sgstype='none',
           dtype='float64', **PER)
CHAN = dict(cbcvel=((('P', 'P', 'P'), ('P', 'P', 'P'), ('D', 'D', 'D')),) * 2,
            cbcpre=(('P', 'P', 'N'),) * 2, cbcsgs=(('P', 'P', 'D'),) * 2)
# bench.py channel_dns_impdiff at a test size, full-3D
DNS3D = dict(ng=(32, 16, 16), l=(2 * np.pi, np.pi, 2.0), gtype=1, gr=1.0,
             visci=5640.0, inivel='log', is_wallturb=True,
             is_forced=(True, False, False), velf=(1.0, 0.0, 0.0),
             sgstype='none', impdiff=True, impdiff_1d=False, dtype='float64',
             ptransform='mat', **CHAN)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64)


def _close(got, ref, rtol, gauge=False):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    if gauge:
        got, ref = got - got.mean(), ref - ref.mean()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rtol * np.abs(ref).max())


def _solver(cbc, c_or_f, ng=(128, 16, 12), port_zsolver=None, **kw):
    """The JAX and the port solver of one system; port_zsolver: the
    port's z stage where it differs from the JAX one's."""
    kw = dict(dict(ng=ng, l=(2 * np.pi, 1.7, 2.0), gtype=1, gr=0.0,
                   dtype='float64', ptransform='mat'), **kw)
    jcfg, tcfg = JaxConfig(**kw), Config(**kw)
    zs = kw.get('zsolver', 'eig')
    return (jpoisson.make_solver(jcfg, jax_grid(jcfg), cbc, c_or_f,
                                 zsolver=zs),
            tpoisson.make_solver(tcfg, make_grid_from_config(tcfg), cbc,
                                 c_or_f, zsolver=port_zsolver or zs),
            jax_grid(jcfg))


# ------------------------------------------------------ the periodic Thomas

@pytest.mark.parametrize('variant', ['poisson', 'helmholtz'])
def test_thomas_periodic_plain_matches_pallas(variant):
    """Pinned on the singular lane (the Poisson z stage), or the
    alpha-scaled rows with the (lamy + lamx) alpha shift (a full-3D CN
    solve, never pinned)."""
    js, _, _ = _solver(('PP', 'PP', 'PP'), ('c', 'c', 'c'))
    nz, ny, nx = 12, 16, 128
    x = np.random.default_rng(1).standard_normal((nz, ny, nx))
    if variant == 'poisson':
        tol = float(np.finfo(np.float64).eps * 4.0
                    * (np.abs(js.lamx).max() + np.abs(js.lamy).max()))
        ref = ps.apply_thomas_periodic_z(jnp.asarray(x), js.a, js.b, js.c,
                                         js.lamy, js.lamx, pin_singular=True,
                                         tol=tol, interpret=True)
        got = SK.thomas_periodic_z_plain(_t(x), _t(js.a), _t(js.b),
                                         _t(js.c), lamy=_t(js.lamy),
                                         lamx=_t(js.lamx), pin=True, tol=tol)
        assert float(got[-1, 0, 0]) == 0.0        # the pinned gauge
    else:
        alpha = -0.037
        ref = ps.apply_thomas_periodic_z(
            jnp.asarray(x), js.a * alpha, js.b * alpha + 1.0, js.c * alpha,
            js.lamy * alpha, js.lamx * alpha, pin_singular=False, tol=0.0,
            interpret=True)
        got = SK.thomas_periodic_z_plain(
            _t(x), _t(js.a), _t(js.b), _t(js.c), lamy=_t(js.lamy * alpha),
            lamx=_t(js.lamx * alpha), alpha=alpha)
    _close(got, ref, 1e-12)


@pytest.mark.parametrize('lanes, min_rows', [(32, 7), (32, 2), (3, 2)])
@pytest.mark.parametrize('nz', [3, 7, 12, 40])
@pytest.mark.parametrize('variant', ['poisson', 'helmholtz'])
def test_thomas_periodic_chunked_matches_pallas(variant, nz, lanes,
                                                min_rows):
    """The card kernel's scheme step by step (tridiag.
    thomas_periodic_chunked: chunks of rows a lane, the chunk-end rows by
    cyclic reduction, pn and the combine) against the Pallas kernel,
    pinned on the singular lane or on the alpha-scaled Helmholtz rows, with
    the kernel's chunks of at least 7 rows on 32 lanes (one chunk up to
    nz = 14, 5 chunks of 7 or 8 rows at nz = 40), and with chunks of 2
    rows on 32 lanes (19 chunks of 2 or 3 rows at nz = 40: 38 rows of
    cyclic reduction) and on 3 lanes (chunks of 3 and 4 rows at nz = 12,
    13 at nz = 40)."""
    from cales_torch.ops import tridiag as ttri
    js, _, _ = _solver(('PP', 'PP', 'PP'), ('c', 'c', 'c'),
                       ng=(128, 8, nz))
    x = np.random.default_rng(nz).standard_normal((nz, 8, 128))
    if variant == 'poisson':
        tol = float(np.finfo(np.float64).eps * 4.0
                    * (np.abs(js.lamx).max() + np.abs(js.lamy).max()))
        rows, lam = (js.a, js.b, js.c), js.lamy[:, None] + js.lamx[None, :]
        ref = ps.apply_thomas_periodic_z(jnp.asarray(x), *rows, js.lamy,
                                         js.lamx, pin_singular=True, tol=tol,
                                         interpret=True)
    else:
        alpha, tol = -0.037, None
        rows = (js.a * alpha, js.b * alpha + 1.0, js.c * alpha)
        lam = alpha * js.lamy[:, None] + alpha * js.lamx[None, :]
        ref = ps.apply_thomas_periodic_z(
            jnp.asarray(x), *rows, js.lamy * alpha, js.lamx * alpha,
            pin_singular=False, tol=0.0, interpret=True)
    got = ttri.thomas_periodic_chunked(*map(_t, rows), _t(x), lam=_t(lam),
                                       pin_tol=tol, lanes=lanes,
                                       min_rows=min_rows)
    if variant == 'poisson':
        assert float(got[-1, 0, 0]) == 0.0        # the pinned gauge
    _close(got, ref, 1e-12)


@pytest.mark.parametrize('ptransform', ['mat', 'fft'])
def test_pin_takes_the_constant_lane_alone_at_512_cubed(ptransform):
    """The Taylor-Green vortex's 512^3 pressure system in float32: the pin
    tolerance eps(float32) (max|lamx| + max|lamy|) 4 takes lane (0, 0)
    and no other (on the 'fft' route the (0, 0) mode's real and imaginary
    lanes), with the lanes' sums rounded as the kernel rounds them."""
    tcfg = Config(**dict(TGV, ng=(512, 512, 512), dtype='float32',
                         ptransform=ptransform))
    sv = tpoisson.make_solver(tcfg, make_grid_from_config(tcfg),
                              ('PP', 'PP', 'PP'), ('c', 'c', 'c'))
    lamx = sv.lamx if ptransform == 'mat' else np.repeat(sv.lamx[:257], 2)
    tol = tpoisson._thomas_tol(lamx, sv.lamy, torch.float32)
    lam = (torch.as_tensor(lamx, dtype=torch.float32)[None, :]
           + torch.as_tensor(sv.lamy, dtype=torch.float32)[:, None])
    pinned = torch.nonzero(lam.abs() <= tol).tolist()
    assert pinned == ([[0, 0]] if ptransform == 'mat' else [[0, 0], [0, 1]])


def test_thomas_periodic_matches_jax_tridiag():
    """The rank-1 form against cales_tpu's ops/tridiag.thomas_periodic on a
    non-uniform, non-symmetric periodic system with a lane shift."""
    from cales_torch.ops import tridiag as ttri
    rng = np.random.default_rng(2)
    n = 11
    a, c = rng.uniform(0.5, 1.0, (2, n))
    b = -(a + c) - rng.uniform(0.1, 0.5, n)
    rhs = rng.standard_normal((n, 5, 7))
    lam = -rng.uniform(0.0, 2.0, (5, 7))
    ref = jtri.thomas_periodic(a, b, c, jnp.asarray(rhs),
                               lam=jnp.asarray(lam), regularize=False)
    got = ttri.thomas_periodic(_t(a), _t(b), _t(c), _t(rhs), lam=_t(lam))
    _close(got, ref, 1e-13)


# ------------------------------------------------------- mom_rk 'xy+z'

def _stencil_inputs(seed):
    nx, ny, nz = 128, 8, 6
    cfg = Config(ng=(nx, ny, nz), l=(2 * np.pi, 1.7, 2.0), gtype=1, gr=0.0,
                 visci=1000.0, dtype='float64')
    grid = make_grid_from_config(cfg)
    rng = np.random.default_rng(seed)
    F = lambda: 0.1 * rng.standard_normal((nz, ny, nx))   # noqa: E731
    d = dict(u=F(), v=F(), w=F(), p=F(), pp=F(), ruo=F(), rvo=F(), rwo=F())
    # periodic z: the edge stacks are the fields' own wrapped rows
    for k in ('u', 'v', 'w', 'p', 'pp'):
        d[k + 'e'] = tbnd.zedge_scalar(_t(d[k]), ('P', 'P'), (0.0, 0.0),
                                       grid.dzc).numpy()
    return cfg, grid, d


def test_mom_rk_xyz_twin_matches_pallas():
    """split 'xy+z' with the CN fold and no nu_t (the triperiodic and
    channel DNS's momentum pass): ru = advection, all molecular diffusion
    implicit (pallas_kernels.py:641-649, 671-690); and the fold against the
    unfolded kernel: u_fold = u_RK - 1/2 f12 rd.  (With nu_t the same split
    runs in the full-3D LES step below, against the XLA path.)"""
    cfg, grid, d = _stencil_inputs(3)
    J = {k: jnp.asarray(v) for k, v in d.items()}
    T = {k: _t(v) for k, v in d.items()}
    f1, f2, visc = 0.5e-3, -0.2e-3, cfg.visc
    dxi, dyi = cfg.dli[:2]
    bforce = (0.1, 0.0, 0.0)
    args = (J['u'], J['v'], J['w'], None, J['p'], J['ue'], J['ve'], J['we'],
            None, J['pe'], J['ruo'], J['rvo'], J['rwo'], grid.dzci,
            grid.dzfi, f1, f2, visc, dxi, dyi, bforce)
    kw = dict(interpret=True, sum_flags=(True, True), split='xy+z',
              has_sgs=False)
    ref = pk.fused_mom_rk(*args, fold_cn=True, **kw)
    raw = pk.fused_mom_rk(*args, fold_cn=False, **kw)
    got = K.mom_rk_plain(T['u'], T['v'], T['w'], None, T['p'], T['ue'],
                         T['ve'], T['we'], None, T['pe'], T['ruo'], T['rvo'],
                         T['rwo'], _t(grid.dzci), _t(grid.dzfi), f1, f2,
                         visc, dxi, dyi, bforce, sums=(True, True),
                         split='xy+z')
    for i in range(3):
        _close(got[i], ref[i], 1e-13)
        # no fold: the velocity carries the full f12 rd, rd comes out
        unfolded = (np.asarray(raw[i])
                    - 0.5 * (f1 + f2) * np.asarray(raw[6 + i]))
        _close(got[i], unfolded, 1e-13)
    for i in range(3, 6):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref[i]),
                                   rtol=0, atol=1e-11)
    for g, r_ in zip(got[6:], ref[6:]):
        np.testing.assert_allclose(g.sum(dim=1).numpy(),
                                   np.asarray(r_)[:, ::8, 0].sum(axis=1),
                                   rtol=0, atol=1e-11)


def test_correc_updatep_full3d_twin_matches_pallas():
    """p += pp + alpha L(pp) with the 3-D Laplacian (pallas_kernels.py:
    1568-1578) on periodic-z edge stacks."""
    cfg, grid, d = _stencil_inputs(4)
    J = {k: jnp.asarray(v) for k, v in d.items()}
    T = {k: _t(v) for k, v in d.items()}
    dxi, dyi = cfg.dli[:2]
    dtrk, alpha = 3.7e-3, -0.013
    ref = pk.fused_correc_updatep(
        J['u'], J['v'], J['w'], J['pp'], J['p'], J['we'], J['ppe'], dtrk,
        dxi, dyi, grid.dzci, interpret=True, alpha=alpha, impdiff=True,
        impdiff_1d=False, dzfi=grid.dzfi)
    got = K.correc_updatep_plain(
        T['u'], T['v'], T['w'], T['pp'], T['p'], T['we'], T['ppe'], dtrk,
        dxi, dyi, _t(grid.dzci), _t(grid.dzfi), alpha=alpha, impdiff=True,
        impdiff_1d=False)
    for g, r in zip(got, ref):
        _close(g, r, 1e-13)


# ------------------------------------------------------------- the solves

# (BC triple, staggering, alpha): the Poisson systems and the CN Helmholtz
# systems of u (x-staggered) and w (z-staggered: the channel's tail row)
SOLVES = {
    'tri_p': (('PP', 'PP', 'PP'), ('c', 'c', 'c'), None),
    'tri_u': (('PP', 'PP', 'PP'), ('f', 'c', 'c'), -0.041),
    'chan_p': (('PP', 'PP', 'NN'), ('c', 'c', 'c'), None),
    'chan_w': (('PP', 'PP', 'DD'), ('c', 'c', 'f'), -0.041),
}


@pytest.mark.parametrize('zsolver', ['eig', 'thomas'])
@pytest.mark.parametrize('ptransform', ['mat', 'fft'])
@pytest.mark.parametrize('system', sorted(SOLVES))
def test_solve_matches_jax(system, ptransform, zsolver):
    cbc, c_or_f, alpha = SOLVES[system]
    js, ts, grid = _solver(cbc, c_or_f, ng=(12, 10, 8),
                           gr=0.0 if cbc[2] == 'PP' else 1.2,
                           ptransform=ptransform, zsolver=zsolver)
    rhs = np.random.default_rng(5).standard_normal((8, 10, 12))
    if alpha is None:       # solvable: zero dzf-weighted mean
        w = grid.dzf[1:9][:, None, None]
        rhs = rhs - (rhs * w).sum() / (w.sum() * 120)
    ref = jpoisson.solve(js, jnp.asarray(rhs), alpha=alpha)
    got = tpoisson.solve(ts, _t(rhs), alpha=alpha)
    _close(got, ref, 1e-11, gauge=alpha is None)


@pytest.mark.parametrize('system', ['tri_p', 'tri_u', 'chan_w'])
def test_solve_matches_jax_kernel_path(system, monkeypatch):
    """cales_tpu's aliased Pallas solve in interpret mode: the Poisson solve
    with the periodic Thomas z stage (CALES_PSOLVE_THOMAS=1, its rule below
    nz = 384) and the Helmholtz pipeline (poisson.py:314-340)."""
    monkeypatch.setenv('CALES_PSOLVE_THOMAS', '1')
    cbc, c_or_f, alpha = SOLVES[system]
    js, ts, grid = _solver(cbc, c_or_f, gr=0.0 if cbc[2] == 'PP' else 1.2,
                           port_zsolver='thomas')
    assert tpoisson.uses_thomas(ts)
    rhs = np.random.default_rng(6).standard_normal((12, 16, 128))
    if alpha is None:
        rhs = rhs - rhs.mean()
    ref = jpoisson.solve(js, jnp.asarray(rhs), alpha=alpha, pallas=True,
                         pallas_interpret=True)
    got = tpoisson.solve(ts, _t(rhs), alpha=alpha)
    _close(got, ref, 1e-11, gauge=alpha is None)


def test_solve_z_only_periodic_matches_jax():
    """The z-only CN solve with periodic z (impdiff_1d on the triperiodic
    box): the periodic Thomas kernel's unshifted Helmholtz variant, the
    forcing shift added first, against the JAX XLA thomas_periodic."""
    js, ts, _ = _solver(('PP', 'PP', 'PP'), ('c', 'c', 'c'), ng=(12, 10, 8),
                        zsolver='thomas')
    x = np.random.default_rng(7).standard_normal((8, 10, 12))
    ref = jpoisson.solve_z_only(js, jnp.asarray(x), -0.029, shift=0.013)
    got = tpoisson.solve_z_only(ts, _t(x), -0.029, shift=_t([0.013]))
    _close(got, ref, 1e-12)


# ------------------------------------------------------ three steps each

STEP_CASES = {
    # the Thomas z stage from nz = 384 on the 'mat' route (cales_tpu's
    # XLA path takes eig there: two direct solves, one gauge apart)
    'tgv_mat_thomas': dict(TGV, ng=(8, 8, 384), ptransform='mat'),
    'tgv_mat_eig': dict(TGV, ptransform='mat'),
    'tgv_fft': dict(TGV, ptransform='fft'),
    'tgv_impdiff_mat': dict(TGV, ptransform='mat', impdiff=True),
    'tgv_impdiff_1d': dict(TGV, ptransform='mat', impdiff=True,
                           impdiff_1d=True),
    'channel_impdiff_mat': DNS3D,
    'les_impdiff_fft': dict(DNS3D, visci=20_000.0, sgstype='smag',
                            ptransform='fft'),
    # validation/dsmag_channel.py's model with full-3D implicit diffusion
    'dsmag_impdiff_mat': dict(DNS3D, l=(12.8, 4.8, 2.0), gr=5.0,
                              visci=10_000.0, inivel='poi', sgstype='dsmag',
                              dsmag_avg='channel'),
}


@pytest.mark.parametrize('case', sorted(STEP_CASES))
def test_steps_match_jax(case):
    kw = STEP_CASES[case]
    jcfg = JaxConfig(**kw, use_pallas=False)
    jgrid = jax_grid(jcfg)
    tcfg = Config(**kw)
    assert unsupported(tcfg) == []
    jsim = JaxSimulation(jcfg, jgrid)
    tsim = Simulation(tcfg, make_grid_from_config(tcfg), device='cpu')
    fields = initflow(jcfg, jgrid)
    jst, tst = jsim.initial_state(*fields), tsim.initial_state(*fields)
    dt = jsim.pick_dt(jsim.check(jst)[0])
    for _ in range(3):
        jst, jd = jsim.step(jst, dt)
        tst, td = tsim.step(tst, dt)
    for name, tol in (('u', 1e-11), ('v', 1e-11), ('w', 1e-11),
                      ('p', 1e-10), ('visct', 1e-11)):
        a = np.asarray(getattr(jst, name))
        b = getattr(tst, name).numpy()
        if name == 'p':
            a, b = a - a.mean(), b - b.mean()
        if name == 'visct' and tcfg.sgstype != 'none':
            tol *= np.abs(a).max()
        err = np.abs(a - b).max()
        assert err <= tol, f'{name}: {err:.3e} > {tol:.1e}'
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-11)
    for a, b in zip(tsim.check(tst), jsim.check(jst)):
        assert abs(a - b) <= 1e-10 * max(1.0, abs(b))
    names = tsim.kernel_names()
    periodic = tcfg.cbc_pre(2) == 'PP'
    assert ('thomas_periodic' in names) == (
        periodic and (case == 'tgv_mat_thomas'
                      or (tcfg.impdiff and tcfg.ptransform == 'mat')))
    assert ('thomas_z' in names) == (not periodic
                                     and tcfg.ptransform == 'mat')


def test_taylor_green_example_through_driver(tmp_path):
    """examples/taylor_green_vortex_3d/input.nml at 16^3 in fp64 through
    driver.run (is_wallturb F, the 'tgv' start, no forcing): the kinetic
    energy starts at 1/8 and falls at every step, the divergence stays at
    round-off, and the statistics and checkpoint are written."""
    from pathlib import Path
    from cales_torch import driver
    from cales_torch.nml import config_from_nml
    nml = (Path(__file__).resolve().parents[1] / 'examples'
           / 'taylor_green_vortex_3d' / 'input.nml')
    cfg = config_from_nml(nml, dtype='float64').replace(
        ng=(16, 16, 16), iout1d=2, icheck=1)
    assert unsupported(cfg) == []
    ke = []

    def out1d(sim, state, istep):
        ke.append(0.5 * float((state.u ** 2 + state.v ** 2
                               + state.w ** 2).mean()))
    sim, state = driver.run(cfg, datadir=tmp_path, device='cpu',
                            max_steps=4, verbose=False,
                            hooks={'out1d': out1d})
    assert sim.kernel_names() == ['mom_rk', 'fillps', 'correc_updatep']
    assert len(ke) == 2 and ke[0] < 0.125 and ke[1] < ke[0]
    assert sim.check(state)[2] < 1e-12
    assert (tmp_path / 'fld.bin').exists()
    # the default statistics hook on the triperiodic box
    driver.run(cfg.replace(nstep=2), datadir=tmp_path, device='cpu',
               max_steps=2, verbose=False)
    assert (tmp_path / 'stats_0000002').exists() or any(
        p.name.startswith('stats_') for p in tmp_path.iterdir())
