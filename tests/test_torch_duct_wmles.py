"""The wall-modelled square duct LES (examples/turbulent_duct_wmles: the
log-law wall model on the y and z walls, static Smagorinsky with y walls)
against cales_tpu, fp64 on the CPU:

  * (a) the y faces' planes of the wall model's twin (wallmodel.
    wm_planes_plain) against cales_tpu's Simulation._wm_bcs_fast, which
    feeds wallmodel.y_wall_wm_planes the rows it fills by _row_pad_xz:
    both faces, log-law and laminar, with and without the deferred
    forcing (added to u and v before the rows are sampled);
  * (b) the z faces' planes with y walls: their rows' y ghosts come from
    the static y recipe of the effective letters, not from a wrap and not
    from the y faces' planes;
  * (c) the z-edge and y-row stacks (corners included) of fills whose BC
    values carry the wall model's planes on all four faces, assembled,
    against cales_tpu's pad_velocity on the same planes;
  * (d) the smag stage with y walls (the one-sided 'E' ghost stacks, van
    Driest over the nearest of four walls, the shear planes of the
    unextrapolated fill) against cales_tpu.sgs.smag_visct on the same
    padded fields, with and without the wall model;
  * (e) the slice: 3 steps of the duct WMLES at 32x12x12 from a JAX state
    carried across by params.state_from_jax_numpy, against cales_tpu's
    Simulation(use_pallas=False).

Tolerances: the planes 1e-13 of their maximum (the same operations; only
the libraries' log differs); the stacks bitwise (copies and the same
two-term recipes on the same planes); nu_t 1e-11 of its maximum (ROADMAP's
van Driest note: the shear planes' sums are grouped apart); the steps u,
v, w, p (mean-free) and nu_t 1e-11."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cales_tpu import sgs as jsgs
from cales_tpu.config import Config as JConfig
from cales_tpu.grid import make_grid_from_config as j_make_grid
from cales_tpu.initflow import initflow
from cales_tpu.ops import boundary as jbnd
from cales_tpu.timeloop import Simulation as JaxSimulation

from cales_torch import params
from cales_torch.config import Config
from cales_torch.grid import make_grid_from_config
from cales_torch.ops import kernels as K
from cales_torch.timeloop import Simulation, unsupported

torch.set_num_threads(1)

DUCT_BCS = dict(
    cbcvel=((('P', 'P', 'P'), ('D', 'D', 'D'), ('D', 'D', 'D')),) * 2,
    cbcpre=(('P', 'N', 'N'),) * 2, cbcsgs=(('P', 'D', 'D'),) * 2)
# the example's physics at a test size, hwm inside the grid (as
# tests/test_pallas_kernels.py:331-339 places it at 128x16x16)
DUCT_WMLES = dict(ng=(32, 12, 12), l=(12.8, 2.0, 2.0), gtype=1, gr=0.0,
                  visci=20_000.0, inivel='duc', is_wallturb=True,
                  is_forced=(True, False, False), velf=(1.0, 0.0, 0.0),
                  dtype='float64', ptransform='mat', sgstype='smag',
                  lwm=((0, 1, 1), (0, 1, 1)), hwm=0.2, **DUCT_BCS)
# moving wall-parallel values on the y and z faces: (face, dir, comp)
MOVING = (((0.0,) * 3, (0.03, 0.0, -0.02), (0.01, 0.02, 0.0)),
          ((0.0,) * 3, (-0.01, 0.0, 0.04), (0.05, -0.03, 0.0)))
# (nx, ny, nz) with ny != nz, so a y face's plane and a z face's differ
NG = (16, 10, 14)
FADD = (0.013, -0.007)


def _sims(kw):
    jcfg = JConfig(**kw, use_pallas=False)
    jgrid = j_make_grid(jcfg)
    tcfg = Config(**kw)
    return (JaxSimulation(jcfg, jgrid),
            Simulation(tcfg, make_grid_from_config(tcfg), device='cpu'),
            jgrid)


def _fields(ng, seed):
    nx, ny, nz = ng
    u, v, w = 0.3 * np.random.default_rng(seed).standard_normal(
        (3, nz, ny, nx))
    return u + 1.0, v, w


def _tt(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def _to_torch(bcs):
    """One component's JAX BC values by direction and side (python floats
    or padded planes) as the port's."""
    return tuple(tuple(q if np.ndim(q) == 0 else _tt(q) for q in sides)
                 for sides in bcs)


def _planes_against_jax(lwm, fadd, dirs):
    """The twin's planes of the faces along dirs against _wm_bcs_fast's."""
    kw = dict(DUCT_WMLES, ng=NG, lwm=lwm, bcvel=MOVING)
    jsim, tsim, _ = _sims(kw)
    assert tsim.index_wm == jsim.index_wm
    u, v, w = _fields(NG, 7)
    ref = jsim._wm_bcs_fast(*map(jnp.asarray, (u, v, w)),
                            fadd=FADD if fadd else None)
    fu, fv = FADD if fadd else (0.0, 0.0)
    got = K.wm_planes(_tt(u + fu), _tt(v + fv), tsim.wm, w=_tt(w))
    assert len(got) == len(tsim.wm.faces)
    checked = 0
    for face, pair in zip(tsim.wm.faces, got):
        if face.d not in dirs:
            continue
        second = 1 if face.d == 2 else 2
        for c, iv in enumerate((0, second)):
            r = np.asarray(ref[iv][face.d][face.ib])
            assert pair[c].shape == r.shape
            np.testing.assert_allclose(pair[c].numpy(), r, rtol=0,
                                       atol=1e-13 * np.abs(r).max(),
                                       err_msg=f'face {face.d} {face.ib}')
            checked += 1
    assert checked == 2 * sum(lwm[ib][d] != 0 for ib in range(2)
                              for d in dirs)


@pytest.mark.parametrize('fadd', [False, True])
@pytest.mark.parametrize('lwm', [((0, 1, 0), (0, 1, 0)),
                                 ((0, -1, 1), (0, 1, 1))])
def test_y_face_planes_match_jax(lwm, fadd):
    """(a) Both y faces log-law, or the lower one laminar beside z faces:
    bcu over [1:nz+1, 0:nx+1], bcw over [0:nz+1, 1:nx+1] with the z
    weights, the rest the static value."""
    _planes_against_jax(lwm, fadd, (1,))


@pytest.mark.parametrize('fadd', [False, True])
@pytest.mark.parametrize('lwm', [((0, 0, 1), (0, 0, 1)),
                                 ((0, 1, 1), (0, 1, -1))])
def test_z_face_planes_with_y_walls_match_jax(lwm, fadd):
    """(b) The z faces' planes with y walls, the y faces modelled or not:
    the sampled rows' y ghosts by the static 'D' (u moving) or 'N' recipe,
    v's wall face rewritten, nothing wrapped along y."""
    _planes_against_jax(lwm, fadd, (2,))


@pytest.mark.parametrize('fill', ['prediction', 'correction'])
def test_edge_stacks_with_wall_model_planes_match_jax(fill):
    """(c) zedge_velocity and yedge_velocity with the wall model's planes
    on all four faces (moving walls, cales_tpu's own planes), assembled
    by kernels.padded: bitwise cales_tpu's pad_velocity, so every corner
    is the z recipe (with the z planes' rows 0, ny and ny+1) on top of the
    y-filled rows."""
    kw = dict(DUCT_WMLES, ng=NG, bcvel=MOVING)
    jsim, tsim, jgrid = _sims(kw)
    nx, ny, nz = NG
    u, v, w = _fields(NG, 11)
    jbcs = jsim._wm_bcs_fast(*map(jnp.asarray, (u, v, w)))
    tbcs = tuple(_to_torch(b) for b in jbcs)
    assert not np.isscalar(jbcs[0][1][0]) and not np.isscalar(jbcs[1][2][1])
    vlo = None
    if fill == 'correction':
        rng = np.random.default_rng(4)
        wrapx = lambda a: np.concatenate(  # noqa: E731
            [a[:, -1:], a, a[:, :1]], axis=1)
        vlo = (np.zeros((nz + 2, ny + 2)),
               wrapx(1e-2 * rng.standard_normal((nz + 2, nx))),
               wrapx(1e-2 * rng.standard_normal((ny + 2, nx))))
    is_correc = vlo is not None
    ref = jbnd.pad_velocity(
        *map(jnp.asarray, (u, v, w)), jsim.cbcvel, *jbcs, jsim.cfg.dl,
        jgrid.dzc, jgrid.dzf,
        vlo=None if vlo is None else tuple(map(jnp.asarray, vlo)),
        is_correc=is_correc)[:3]
    tv = None if vlo is None else tuple(map(_tt, vlo))
    T = tuple(map(_tt, (u, v, w)))
    ze = tsim._zedge_vel(*T, *tbcs, vlo=tv, is_correc=is_correc)
    yq = tsim._yedge_vel(*T, tbcs, vlo=tv, is_correc=is_correc)
    # the interior x columns: the stacks hold those and the kernels wrap
    # x (pad_velocity's x ghosts at a z ghost row take the planes' ghost
    # columns, and the wall model writes column 0 of bcu_z but not nx+1)
    for q, e, y, r in zip(T, ze, yq, ref):
        np.testing.assert_array_equal(K.padded(q, e, y)[..., 1:-1].numpy(),
                                      np.asarray(r)[..., 1:-1])


@pytest.mark.parametrize('lwm', [((0, 1, 1), (0, 1, 1)),
                                 ((0, 0, 0), (0, 0, 0))])
def test_smag_stage_with_y_walls_matches_jax(lwm):
    """(d) The port's smag stage on the post-correction fill's stacks (the
    'E' stacks, the four walls' shear planes, the smag twin's y-wall
    variant) against cales_tpu.sgs.smag_visct on the same padded fields:
    the wall-modelled duct and the smag duct without a wall model."""
    kw = dict(DUCT_WMLES, ng=NG, lwm=lwm, bcvel=MOVING)
    jsim, tsim, jgrid = _sims(kw)
    nx, ny, nz = NG
    u, v, w = _fields(NG, 13)
    rng = np.random.default_rng(6)
    wrapx = lambda a: np.concatenate([a[:, -1:], a, a[:, :1]],  # noqa: E731
                                     axis=1)
    vlo = (np.zeros((nz + 2, ny + 2)),
           wrapx(1e-2 * rng.standard_normal((nz + 2, nx))),
           wrapx(1e-2 * rng.standard_normal((ny + 2, nx))))
    J = tuple(map(jnp.asarray, (u, v, w)))
    jbcs = jsim._dynamic_bcs(*J)
    up, vp, wp, _ = jbnd.pad_velocity(
        *J, jsim.cbcvel, *jbcs, jsim.cfg.dl, jgrid.dzc, jgrid.dzf,
        vlo=tuple(map(jnp.asarray, vlo)), is_correc=True)
    ref = np.asarray(jsgs.smag_visct(jsim.sgs_setup, jsim.cfg, jgrid, up,
                                     vp, wp))
    T = tuple(map(_tt, (u, v, w)))
    tv = tuple(map(_tt, vlo))
    tbcs = tuple(_to_torch(b) for b in jbcs)
    zq = tsim._zedge_vel(*T, *tbcs, vlo=tv, is_correc=True)
    yq = tsim._yedge_vel(*T, tbcs, vlo=tv, is_correc=True)
    got = tsim._sgs_stage(*T, zq, tv, yq).numpy()
    assert ref.max() > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-11 * ref.max())


def test_duct_wmles_matches_jax_for_three_steps():
    """(e) The slice: the duct WMLES at 32x12x12 (hwm 0.2 inside the grid,
    log-law on all four side walls), the JAX initial state carried across
    by params.state_from_jax_numpy, then 3 steps of each package: u, v, w,
    p (mean-free) and nu_t within 1e-11 after each, and the wall model
    once a substep on the port's path."""
    jsim, tsim, jgrid = _sims(DUCT_WMLES)
    assert unsupported(tsim.cfg) == []
    names = tsim.kernel_names()
    assert 'smag' in names and 'wallmodel' in names
    assert 'correc_smag' not in names
    path = tsim.exec_path()
    assert 'y-wall variant' in path and 'lower y' in path
    jst = jsim.initial_state(*initflow(jsim.cfg, jgrid))
    leaves = dict(u=jst.u, v=jst.v, w=jst.w, p=jst.p, visct=jst.visct,
                  vlo=jst.vlo, rhs_old=jst.rhs_old, zq=jst.zq,
                  time=jst.time, istep=jst.istep)
    tst = params.state_from_jax_numpy(
        jax.tree_util.tree_map(np.asarray, leaves), 'cpu', torch.float64)
    dt = jsim.pick_dt(jsim.check(jst)[0])
    for _ in range(3):
        jst, jd = jsim.step(jst, dt)
        tst, td = tsim.step(tst, dt)
        for name in ('u', 'v', 'w', 'p', 'visct'):
            a, b = np.asarray(getattr(jst, name)), getattr(tst, name).numpy()
            if name == 'p':
                a, b = a - a.mean(), b - b.mean()
            assert np.abs(a - b).max() <= 1e-11, name
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0,
                                   atol=1e-11)
        # the kept w plane whole, v's on the y face (its z-ghost rows,
        # which no fill reads, take the prediction fill's planes in JAX)
        np.testing.assert_allclose(tst.vlo[2].numpy(), np.asarray(jst.vlo[2]),
                                   rtol=0, atol=1e-11)
        np.testing.assert_allclose(tst.vlo[1][1:-1].numpy(),
                                   np.asarray(jst.vlo[1])[1:-1], rtol=0,
                                   atol=1e-11)
    assert float(tst.visct.min()) >= 0 and float(tst.visct.max()) > 0
    assert tst.yq is not None
