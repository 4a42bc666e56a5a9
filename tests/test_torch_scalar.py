"""The passive scalar in cales_torch on the CPU, against cales_tpu at fp64:
  * ops/stencil.scalar_rhs (scalar_rhs_core) and scal.rk_scal against
    cales_tpu.scal on seeded padded fields, within 1e-13 of each output's
    maximum;
  * mom_rk's plain twin (the scalar stream of csrc/mom_rk.cu) against
    cales_tpu.scal.rk_scal on the JAX package's own fill of the velocity
    and the scalar (Simulation._pad_vel, _pad_scal), for the first and a
    later substep, ssource 0 and 0.05, and the scalar's stacks with z
    walls, y walls, x walls and x and y walls (each face its own letter
    and value), within 1e-13;
  * the recipe-built stacks of the scalar (boundary.zedge_scalar_fast,
    yedge_scalar_fast) bitwise those of zedge_scalar and yedge_scalar;
  * the port alone: a constant scalar stays 1 and a sine decays at the
    discrete rate (tests/test_timeloop.py:131's test_scalar_transport);
  * unsupported() accepts the scalar on every single-device route of the
    slice (the example namelists and bench.py's classes with scalar=True)
    and refuses it where it is not periodic along a periodic velocity, on
    one device and on the y-slab mesh, naming the ROADMAP item."""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cales_tpu import scal as jscal
from cales_tpu.config import Config as JConfig
from cales_tpu.grid import make_grid_from_config as j_make_grid
from cales_tpu.timeloop import Simulation as JaxSimulation

from cales_torch import scal
from cales_torch.config import Config, RK_COEFF
from cales_torch.grid import make_grid_from_config
from cales_torch.nml import config_from_nml
from cales_torch.ops import boundary as bnd
from cales_torch.ops import kernels
from cales_torch.ops import stencil as st
from cales_torch.timeloop import Simulation, unsupported

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
NG = (24, 10, 12)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _metrics(nz, seed=3):
    rng = np.random.default_rng(seed)
    return (1.0 / (0.1 + 0.05 * rng.random(nz + 2)),
            1.0 / (0.1 + 0.05 * rng.random(nz + 2)))


def _padded(seed, ng=NG):
    nx, ny, nz = ng
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((nz + 2, ny + 2, nx + 2)) for _ in range(4)]


def test_scalar_rhs_matches_jax():
    up, vp, wp, sp = _padded(1)
    dzci, dzfi = _metrics(NG[2])
    args = (0.7 / 2000.0, 12.0, 9.0, dzci, dzfi)
    ref = jscal.scalar_rhs(*(jnp.asarray(q) for q in (up, vp, wp, sp)),
                           *args)
    got = st.scalar_rhs(*(torch.as_tensor(q) for q in (up, vp, wp, sp)),
                        *args)
    assert _rel(got.numpy(), ref) <= 1e-13
    assert torch.equal(got, scal.scalar_rhs(
        *(torch.as_tensor(q) for q in (up, vp, wp, sp)), *args))


@pytest.mark.parametrize('forced', [False, True])
@pytest.mark.parametrize('irk', [0, 1, 2])
def test_rk_scal_matches_jax(irk, forced):
    up, vp, wp, sp = _padded(2)
    nx, ny, nz = NG
    dzci, dzfi = _metrics(nz, 4)
    rng = np.random.default_rng(5)
    old = rng.standard_normal((nz, ny, nx))
    gvr = np.full(nz, 1.0 / nz)
    common = dict(ssource=0.05, is_forced=forced, scalf=1.0, gvr_f=gvr)
    args = (0.7 / 2000.0, 1e-3, irk, 12.0, 9.0, dzci, dzfi)
    (js, jds), jf = jscal.rk_scal(
        jscal.ScalarState(jnp.asarray(sp[1:-1, 1:-1, 1:-1]),
                          jnp.asarray(old)),
        *(jnp.asarray(q) for q in (up, vp, wp, sp)), *args, **common)
    (ts, tds), tf = scal.rk_scal(
        scal.ScalarState(torch.as_tensor(sp[1:-1, 1:-1, 1:-1]),
                         torch.as_tensor(old)),
        *(torch.as_tensor(q) for q in (up, vp, wp, sp)), *args,
        **{**common, 'gvr_f': torch.as_tensor(gvr)})
    assert _rel(ts.numpy(), js) <= 1e-13
    assert _rel(tds.numpy(), jds) <= 1e-13
    assert abs(float(tf) - float(jf)) <= 1e-13


# the scalar's stacks: z walls (the channel), y walls (the duct), x walls
# (the developing channel) and x and y walls (the developing duct); each
# scalar face of its own letter and value
WALLS = {
    'z': dict(cbcvel=((('P', 'P', 'P'), ('P', 'P', 'P'),
                       ('D', 'D', 'D')),) * 2,
              cbcpre=(('P', 'P', 'N'), ('P', 'P', 'N')),
              cbcsgs=(('P', 'P', 'D'), ('P', 'P', 'D')),
              cbcscal=(('P', 'P', 'D'), ('P', 'P', 'N')),
              bcscal=((0.0, 0.0, 0.3), (0.0, 0.0, -0.2))),
    'y': dict(cbcvel=((('P', 'P', 'P'), ('D', 'D', 'D'),
                       ('D', 'D', 'D')),) * 2,
              cbcpre=(('P', 'N', 'N'), ('P', 'N', 'N')),
              cbcsgs=(('P', 'D', 'D'), ('P', 'D', 'D')),
              cbcscal=(('P', 'D', 'N'), ('P', 'N', 'D')),
              bcscal=((0.0, 1.0, 0.1), (0.0, -0.3, 0.5))),
    'x': dict(cbcvel=((('D', 'N', 'N'), ('P', 'P', 'P'), ('D', 'D', 'D')),
                      (('N', 'N', 'N'), ('P', 'P', 'P'), ('D', 'D', 'D'))),
              bcvel=(((1.0, 0.0, 0.0), (0.0,) * 3, (0.0,) * 3),
                     ((0.0,) * 3,) * 3),
              cbcpre=(('N', 'P', 'N'), ('D', 'P', 'N')),
              cbcsgs=(('N', 'P', 'D'), ('N', 'P', 'D')),
              cbcscal=(('D', 'P', 'N'), ('N', 'P', 'D')),
              bcscal=((1.0, 0.0, 0.2), (0.1, 0.0, 0.4))),
    'xy': dict(cbcvel=((('D', 'N', 'N'), ('D', 'D', 'D'), ('D', 'D', 'D')),
                       (('N', 'N', 'N'), ('D', 'D', 'D'), ('D', 'D', 'D'))),
               bcvel=(((1.0, 0.0, 0.0), (0.0,) * 3, (0.0,) * 3),
                      ((0.0,) * 3,) * 3),
               cbcpre=(('N', 'N', 'N'), ('D', 'N', 'N')),
               cbcsgs=(('N', 'D', 'D'), ('N', 'D', 'D')),
               cbcscal=(('D', 'D', 'N'), ('N', 'N', 'D')),
               bcscal=((1.0, 0.5, 0.2), (0.1, -0.2, 0.4))),
}


def _walled(walls, ssource=0.0):
    return dict(ng=NG, l=(2.0, 1.5, 1.0), gtype=1, gr=1.0, visci=2000.0,
                inivel='uni', is_wallturb=False, dtype='float64',
                sgstype='smag', ptransform='mat', scalar=True, pr=0.71,
                ssource=ssource, **WALLS[walls])


@pytest.mark.parametrize('walls', list(WALLS))
@pytest.mark.parametrize('ssource', [0.0, 0.05])
@pytest.mark.parametrize('first', [True, False])
def test_mom_rk_plain_scalar_matches_rk_scal(walls, ssource, first):
    """The twin's scalar outputs from the port's stacks against
    cales_tpu.scal.rk_scal on the JAX package's padded velocity (the
    post-correction fill with random kept wall planes) and padded scalar."""
    kw = _walled(walls, ssource)
    jcfg, tcfg = JConfig(**kw, use_pallas=False), Config(**kw)
    assert unsupported(tcfg) == []
    jsim = JaxSimulation(jcfg, j_make_grid(jcfg))
    tsim = Simulation(tcfg, make_grid_from_config(tcfg), device='cpu')
    nx, ny, nz = NG
    rng = np.random.default_rng(11)
    u, v, w, p, s, old = (0.1 * rng.standard_normal((nz, ny, nx))
                          for _ in range(6))
    u, s = u + 1.0, s + 1.0
    vlo = tuple(1e-2 * rng.standard_normal(q) for q in
                ((nz + 2, ny + 2), (nz + 2, nx + 2), (ny + 2, nx + 2)))
    irk, dt = (0 if first else 1), 2e-3
    f1, f2 = RK_COEFF[irk][0] * dt, RK_COEFF[irk][1] * dt
    alpha = tcfg.visc / tcfg.pr
    # JAX: its fill, then rk_scal
    up, vp, wp, _ = jsim._pad_vel(
        *(jnp.asarray(q) for q in (u, v, w)), jsim.bcu_vals, jsim.bcv_vals,
        jsim.bcw_vals, vlo=tuple(jnp.asarray(q) for q in vlo),
        is_correc=True)
    (js, jds), _ = jscal.rk_scal(
        jscal.ScalarState(jnp.asarray(s), jnp.asarray(old)), up, vp, wp,
        jsim._pad_scal(jnp.asarray(s)), alpha, dt, irk, jcfg.dli[0],
        jcfg.dli[1], jsim.grid.dzci, jsim.grid.dzfi, ssource=ssource)
    # the port: its stacks, then the momentum kernel's twin
    T = lambda q: torch.as_tensor(q)   # noqa: E731
    u, v, w, p, s, old = map(T, (u, v, w, p, s, old))
    vlo = tuple(map(T, vlo))
    bcs = tsim._dynamic_bcs(u, v, w)
    zq = tsim._zedge_vel(u, v, w, *bcs, vlo=vlo, is_correc=True)
    nut = torch.full_like(u, 1e-4)
    ye = xe = None
    if tsim.ywalled:
        ye = (*tsim._yedge_vel(u, v, w, bcs, vlo=vlo, is_correc=True),
              tsim._yedge_s(nut), tsim._yedge_p(p), tsim._yedge_scal(s))
    if tsim.xwalled:
        xe = (*tsim._xedge_vel(u, v, w, bcs, vlo=vlo, is_correc=True),
              tsim._xedge_s(nut), tsim._xedge_p(p), tsim._xedge_scal(s))
    r = (None,) * 4 if first else (old,) * 4
    out = kernels.mom_rk(
        u, v, w, nut, p, *zq, tsim._zedge_s(nut), tsim._zedge_p(p), *r[:3],
        tsim.dzci_t, tsim.dzfi_t, f1, f2, tcfg.visc, tcfg.dli[0],
        tcfg.dli[1], (0.0, 0.0, 0.0), ye=ye, xe=xe, sca=s,
        scae=tsim._zedge_scal(s), rso=r[3], scal=(alpha, ssource))
    assert len(out) == 10
    assert _rel(out[9].numpy(), jds) <= 1e-13
    assert _rel(out[8].numpy(), js) <= 1e-13


@pytest.mark.parametrize('lo, hi', [('D', 'D'), ('N', 'D'), ('D', 'N'),
                                    ('N', 'N'), ('P', 'P')])
def test_recipe_stacks_are_the_scalar_fill(lo, hi):
    nx, ny, nz = NG
    q = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (nz, ny, nx)))
    cbc = (('P', 'P'), (lo, hi), (hi, lo))
    vals = ((0.0, 0.0), (0.7, -0.4), (0.2, 1.3))
    dzc = 0.05 + np.arange(nz + 2) / (10.0 * nz)
    dl = (0.1, 0.15, 0.2)
    assert torch.equal(bnd.zedge_scalar_fast(q, cbc[2], vals[2], dzc),
                       bnd.zedge_scalar(q, cbc[2], vals[2], dzc))
    for a, b in zip(bnd.yedge_scalar_fast(q, cbc, vals, dl, dzc),
                    bnd.yedge_scalar(q, cbc, vals, dl, dzc)):
        assert torch.equal(a, b)


def test_scalar_constant_and_sine_decay():
    """tests/test_timeloop.py:131 in the port: a constant scalar stays 1
    after 5 steps, and a sine along x under pure diffusion (u = 0) decays
    by exp(-alpha k_eff^2 t) with the discrete wavenumber."""
    n = 32
    cfg = Config(ng=(n, 4, 4), l=(2 * np.pi, 1.0, 1.0), visci=10.0,
                 inivel='zer', dtype='float64', scalar=True, pr=1.0,
                 iniscal='uni',
                 cbcvel=((('P',) * 3,) * 3, (('P',) * 3,) * 3),
                 cbcpre=(('P',) * 3, ('P',) * 3),
                 cbcsgs=(('P',) * 3, ('P',) * 3),
                 cbcscal=(('P', 'P', 'P'), ('P', 'P', 'P')))
    sim = Simulation(cfg, make_grid_from_config(cfg), device='cpu')
    z = np.zeros((4, 4, n))
    state = sim.initial_state(z, z, z, z)
    dt = 1e-3
    for _ in range(5):
        state, _ = sim.step(state, dt)
    np.testing.assert_allclose(state.s.numpy(), 1.0, atol=1e-13)
    x = (np.arange(n) + 0.5) * cfg.dl[0]
    s0 = np.broadcast_to(np.sin(x)[None, None, :], (4, 4, n)).copy()
    state = state._replace(s=torch.as_tensor(s0))
    nsteps = 100
    state = sim.multi_step(state, dt, nsteps)
    alpha = cfg.visc / cfg.pr
    keff = 2.0 * (1.0 - np.cos(cfg.dl[0])) / cfg.dl[0] ** 2
    expect = s0 * np.exp(-alpha * keff * nsteps * dt)
    assert np.abs(state.s.numpy() - expect).max() < 5e-6


def _bench_classes():
    """bench.py's classes and the port's other single-device routes, as
    Config keywords, for the scalar to ride."""
    chan = dict(ng=(32, 16, 16), l=(2 * np.pi, np.pi, 2.0), gtype=1, gr=1.0,
                is_forced=(True, False, False), velf=(1.0, 0.0, 0.0),
                cbcvel=((('P', 'P', 'P'), ('P', 'P', 'P'),
                         ('D', 'D', 'D')),) * 2,
                cbcpre=(('P', 'P', 'N'), ('P', 'P', 'N')),
                cbcsgs=(('P', 'P', 'D'), ('P', 'P', 'D')))
    duct = dict(chan, cbcvel=((('P', 'P', 'P'), ('D', 'D', 'D'),
                               ('D', 'D', 'D')),) * 2,
                cbcpre=(('P', 'N', 'N'), ('P', 'N', 'N')),
                cbcsgs=(('P', 'D', 'D'), ('P', 'D', 'D')))
    blow = ((0.0,) * 3, (0.0,) * 3, (0.0, 0.0, 0.003))
    tri = dict(chan, is_forced=(False,) * 3, velf=(0.0,) * 3,
               cbcvel=((('P',) * 3,) * 3,) * 2, cbcpre=(('P',) * 3,) * 2,
               cbcsgs=(('P',) * 3,) * 2)
    return {
        'LES fft': dict(chan, sgstype='smag', ptransform='fft'),
        'LES mat': dict(chan, sgstype='smag', ptransform='mat'),
        'LES impdiff_1d': dict(chan, sgstype='smag', impdiff=True,
                               impdiff_1d=True),
        'DNS impdiff_1d': dict(chan, impdiff=True, impdiff_1d=True),
        'DNS full-3D': dict(chan, impdiff=True),
        'dsmag one pass': dict(chan, sgstype='dsmag'),
        'dsmag two passes': dict(chan, sgstype='dsmag',
                                 bcvel=(blow, blow)),
        'WMLES channel': dict(chan, sgstype='smag', visci=125_000.0,
                              lwm=((0, 0, 1), (0, 0, 1)), hwm=0.1),
        'WMLES duct': dict(duct, sgstype='smag', lwm=((0, 1, 1), (0, 1, 1)),
                           hwm=0.1),
        'dsmag duct': dict(duct, sgstype='dsmag', dsmag_avg='duct'),
        'dsmag cavity': dict(duct, sgstype='dsmag', dsmag_avg='cavity',
                             is_forced=(False,) * 3, velf=(0.0,) * 3),
        'triperiodic DNS': tri,
        'triperiodic full-3D': dict(tri, impdiff=True),
    }


EXAMPLES = sorted(p.parent.name for p in (ROOT / 'examples').glob(
    '*/input.nml'))
# y and x walls with the scalar's own letters on those faces
SCALAR_FACES = (('D', 'N', 'D'), ('N', 'D', 'N'))


@pytest.mark.parametrize('name', EXAMPLES + list(_bench_classes()))
def test_unsupported_accepts_the_scalar_on_every_route(name):
    if name in EXAMPLES:
        cfg = config_from_nml(ROOT / 'examples' / name / 'input.nml')
    else:
        cfg = Config(**_bench_classes()[name])
    assert unsupported(cfg) == [], 'the base route must run'
    # the scalar's letters: D, N or P on a face where the velocity has
    # walls (or z faces), P along the velocity's periodic x and y
    letters = tuple(tuple(
        SCALAR_FACES[ib][d] if cfg.cbc_vel(d, 0)[0] != 'P' or d == 2
        else 'P' for d in range(3)) for ib in range(2))
    for iniscal in ('zer', 'uni'):
        scfg = cfg.replace(scalar=True, pr=0.71, iniscal=iniscal,
                           cbcscal=letters,
                           bcscal=((1.0, 0.5, 0.0), (0.0, -0.5, 1.0)),
                           is_sforced=iniscal == 'uni', scalf=1.0)
        assert unsupported(scfg) == []


@pytest.mark.parametrize('change, item', [
    # on the y-slab mesh the scalar takes the letters one device admits
    (dict(dims=(2, 1), cbcscal=(('P', 'N', 'N'), ('P', 'N', 'N'))),
     'a non-periodic scalar along y, where the velocity is periodic'),
    (dict(cbcscal=(('D', 'P', 'N'), ('N', 'P', 'N'))),
     'a non-periodic scalar along x, where the velocity is periodic'),
    (dict(cbcscal=(('P', 'N', 'N'), ('P', 'N', 'N'))),
     'a non-periodic scalar along y, where the velocity is periodic'),
])
def test_unsupported_refuses_the_scalar_outside_the_slice(change, item):
    cfg = Config(**_bench_classes()['LES mat'], scalar=True).replace(
        **change)
    missing = unsupported(cfg)
    assert any(item in m for m in missing), missing
    assert all('ROADMAP queue 1' in m for m in missing
               if 'scalar' in m), missing
    with pytest.raises(NotImplementedError, match='scalar'):
        Simulation(cfg, make_grid_from_config(cfg), device='cpu')


def test_config_carries_the_scalar_fields():
    names = {f.name for f in dataclasses.fields(Config)}
    assert {'scalar', 'pr', 'iniscal', 'cbcscal', 'bcscal', 'ssource',
            'is_sforced', 'scalf'} <= names
