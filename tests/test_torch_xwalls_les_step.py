"""The x-walled LES and the plane-valued values end to end: cales_torch's
Simulation on the CPU (the kernels' plain twins) against cales_tpu's
Simulation on its XLA expression path (use_pallas=False), fp64, at
(nx, ny, nz) = (32, 8, 8), from seeded perturbed initial fields:
  * the developing channel (inflow u = 1, outflow, periodic y, z walls)
    with static Smagorinsky, with smag and impdiff_1d, and with sgstype
    'none' and impdiff_1d;
  * the developing duct (the same with y walls) with smag;
  * the developing wall-modelled channel LES of
    tests/test_pallas_kernels.py:538 (test_pallas_xwalled_wm: gtype 6,
    smag, the log-law wall model on both z walls);
  * the developing channel with the parabolic inflow profile of
    tests/test_pallas_kernels.py:584 (test_pallas_plane_valued_bcs), and
    that test's x-varying moving lid on the periodic smag channel;
each stepped 3 steps (2 for the wall-modelled channel, as JAX's own test
does); and a JAX developing-WMLES state carried into the port.

Tolerances: u, v, w and the kept wall planes vlo 1e-11, p 1e-11 (after
removing its mean where the pressure is all-Neumann), nu_t 1e-11 of its
maximum.  vlo is compared along the walled directions: a periodic
direction's plane is never read (pad_velocity's 'P' branch), and the JAX
expression path refills it while the port keeps it, as JAX's own
test_pallas_plane_valued_bcs skips it."""
import functools

import numpy as np
import pytest
import torch

import jax

from cales_tpu.config import Config as JConfig
from cales_tpu.grid import make_grid_from_config as j_make_grid
from cales_tpu.initflow import initflow
from cales_tpu.timeloop import Simulation as JaxSimulation

from cales_torch import params
from cales_torch.config import Config
from cales_torch.grid import make_grid_from_config
from cales_torch.timeloop import Simulation, unsupported

torch.set_num_threads(1)

NG = (32, 8, 8)
NX, NY, NZ = NG
DEV = dict(ng=NG, l=(2.0, 1.5, 1.0), gtype=1, gr=0.0, visci=5000.0,
           inivel='uni', is_wallturb=False, dtype='float64', sgstype='none',
           cbcvel=((('D', 'N', 'N'), ('P', 'P', 'P'), ('D', 'D', 'D')),
                   (('N', 'N', 'N'), ('P', 'P', 'P'), ('D', 'D', 'D'))),
           bcvel=(((1.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 0.0, 0.0)),) * 2,
           cbcpre=(('N', 'P', 'N'), ('D', 'P', 'N')),
           cbcsgs=(('N', 'P', 'D'), ('N', 'P', 'D')))
DDUCT = dict(DEV, l=(2.0, 1.0, 1.0), visci=2000.0,
             cbcvel=((('D', 'N', 'N'), ('D', 'D', 'D'), ('D', 'D', 'D')),
                     (('N', 'N', 'N'), ('D', 'D', 'D'), ('D', 'D', 'D'))),
             cbcpre=(('N', 'N', 'N'), ('D', 'N', 'N')),
             cbcsgs=(('N', 'D', 'D'), ('N', 'D', 'D')))
XWM = dict(DEV, l=(6.4, 3.2, 2.0), gtype=6, visci=50000.0, sgstype='smag',
           lwm=((0, 0, 1), (0, 0, 1)), hwm=0.1)
# a padded (nz+2, ny+2) x-face inflow profile, parabolic in z
_ZC = (np.arange(NZ + 2) - 0.5) / NZ
PROF = (6.0 * _ZC * (1.0 - _ZC))[:, None] * np.ones((1, NY + 2))
# a padded (ny+2, nx+2) moving lid, sinusoidal in x
LID = 1.0 + 0.3 * np.sin(2 * np.pi * np.arange(NX + 2) / NX)[None, :] \
    * np.ones((NY + 2, 1))
CHAN = dict(ng=NG, l=(2 * np.pi, np.pi, 1.0), gtype=1, gr=0.0, visci=2000.0,
            inivel='uni', is_wallturb=False, dtype='float64', sgstype='smag',
            cbcvel=((('P', 'P', 'P'), ('P', 'P', 'P'), ('D', 'D', 'D')),) * 2,
            bcvel=(((0.0,) * 3,) * 3,
                   ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (LID, 0.0, 0.0))),
            cbcpre=(('P', 'P', 'N'), ('P', 'P', 'N')),
            cbcsgs=(('P', 'P', 'D'), ('P', 'P', 'D')))
CASES = {
    'developing channel, smag': dict(DEV, sgstype='smag'),
    'developing channel, smag, impdiff_1d': dict(
        DEV, sgstype='smag', impdiff=True, impdiff_1d=True),
    'developing channel, impdiff_1d': dict(DEV, impdiff=True,
                                           impdiff_1d=True),
    'developing duct, smag': dict(DDUCT, sgstype='smag'),
    'developing WMLES': XWM,
    'inflow profile': dict(DEV, bcvel=(((PROF, 0.0, 0.0), (0.0,) * 3,
                                        (0.0,) * 3),) * 2),
    'lid plane, smag': CHAN,
}


@functools.lru_cache(maxsize=None)
def _sims(case):
    """(JAX simulation, port simulation, initial fields) of a case, made
    once a module: the carried-state test reuses the JAX step the
    wall-modelled case compiled."""
    kw = CASES[case]
    jcfg, tcfg = JConfig(**kw, use_pallas=False), Config(**kw)
    assert unsupported(tcfg) == []
    jgrid = j_make_grid(jcfg)
    rng = np.random.default_rng(17)
    fields = [np.asarray(f) + 0.05 * rng.standard_normal(np.shape(f))
              for f in initflow(jcfg, jgrid)]
    return (JaxSimulation(jcfg, jgrid),
            Simulation(tcfg, make_grid_from_config(tcfg), device='cpu'),
            fields)


def _compare(jst, tst, tsim, tol=1e-11):
    cfg = tsim.cfg
    all_n = 'D' not in ''.join(cfg.cbcpre[ib][d] for ib in range(2)
                               for d in range(3))
    for name in ('u', 'v', 'w', 'p', 'visct'):
        a, b = np.asarray(getattr(jst, name)), getattr(tst, name).numpy()
        if name == 'p' and all_n:
            a, b = a - a.mean(), b - b.mean()
        err = np.abs(a - b).max()
        if name == 'visct':
            err /= max(float(np.abs(a).max()), 1e-300)
        assert err <= tol, f'{name}: {err:.3e}'
    for m in range(3):
        if tsim.cbcvel[0][m][m] == 'P':
            continue
        a, b = np.asarray(jst.vlo[m]), tst.vlo[m].numpy()
        assert a.shape == b.shape, (m, a.shape, b.shape)
        err = np.abs(a - b).max()
        assert err <= tol, f'vlo[{m}]: {err:.3e}'


@pytest.mark.parametrize('case', list(CASES))
def test_xwalled_les_and_planes_match_jax(case):
    kw = CASES[case]
    jsim, tsim, fields = _sims(case)
    jst, tst = jsim.initial_state(*fields), tsim.initial_state(*fields)
    _compare(jst, tst, tsim)
    dt = jsim.pick_dt(jsim.check(jst)[0])
    for _ in range(2 if case == 'developing WMLES' else 3):
        jst, _ = jsim.step(jst, dt)
        tst, _ = tsim.step(tst, dt)
        _compare(jst, tst, tsim)
    assert float(tst.u.abs().max()) > 1e-3
    if kw['sgstype'] == 'smag':
        assert float(tst.visct.max()) > 0.0 and tsim.sgs_kernel == 'smag'
        assert not tsim.fused_smag
    path = tsim.exec_path()
    if tsim.xwalled:
        assert 'x-ghost column stacks' in path
        if kw['sgstype'] == 'smag':
            assert 'x-wall variant' in path
    if case == 'developing WMLES':
        assert tsim.kernel_names() == ['mom_rk', 'fillps', 'correc_updatep',
                                       'smag', 'apply_y', 'z_eig',
                                       'wallmodel']
        assert "x faces' values" in path


def test_developing_wmles_state_carried_across_from_jax():
    """A JAX developing-WMLES state after a step (its nu_t and kept inflow
    face vlo[0] included) steps on in the port to the same state; the
    port rebuilds its edge and x stacks from vlo and the wall model."""
    jsim, tsim, fields = _sims('developing WMLES')
    jst = jsim.initial_state(*fields)
    dt = jsim.pick_dt(jsim.check(jst)[0])
    jst, _ = jsim.step(jst, dt)
    leaves = dict(u=jst.u, v=jst.v, w=jst.w, p=jst.p, visct=jst.visct,
                  vlo=jst.vlo, rhs_old=jst.rhs_old, zq=jst.zq,
                  time=jst.time, istep=jst.istep)
    tst = params.state_from_jax_numpy(
        jax.tree_util.tree_map(np.asarray, leaves), 'cpu', torch.float64)
    assert tst.xq is None and float(tst.visct.abs().max()) > 0.0
    jst, _ = jsim.step(jst, dt)
    tst, _ = tsim.step(tst, dt)
    _compare(jst, tst, tsim)
