"""The slice end to end: cales_torch's Simulation on the CPU (the kernels'
plain twins) against cales_tpu's Simulation on its XLA expression path
(use_pallas=False), fp64, for the headline channel-LES physics (static
Smagorinsky + van Driest, periodic x/y, no-slip z walls on a stretched
grid, bulk forcing along x) at (nx, ny, nz) = (32, 16, 16).

Tolerances: u, v, w 1e-11; p 1e-10 after removing its mean (the solve
projects out the constant mode, so p is defined up to a gauge); nu_t
1e-12.  The dead vlo planes along periodic x/y are not compared."""
import numpy as np
import pytest
import torch

import jax

from cales_tpu.config import Config
from cales_tpu.grid import make_grid_from_config
from cales_tpu.initflow import initflow
from cales_tpu.timeloop import Simulation as JaxSimulation

from cales_torch import params
from cales_torch.ops import kernels as K
from cales_torch.timeloop import Simulation, unsupported

torch.set_num_threads(1)

HEADLINE = dict(ng=(32, 16, 16), l=(2 * np.pi, np.pi, 2.0), gtype=1, gr=1.0,
                visci=20_000.0, inivel='log', is_wallturb=True,
                is_forced=(True, False, False), velf=(1.0, 0.0, 0.0),
                sgstype='smag', dtype='float64', ptransform='fft')
TOL = {'u': 1e-11, 'v': 1e-11, 'w': 1e-11, 'p': 1e-10, 'visct': 1e-12}


@pytest.fixture(scope='module')
def pair():
    cfg = Config(**HEADLINE, use_pallas=False)
    grid = make_grid_from_config(cfg)
    u, v, w, p = initflow(cfg, grid)
    jsim = JaxSimulation(cfg, grid)
    tsim = Simulation(cfg, grid, device='cpu')
    jst = jsim.initial_state(u, v, w, p)
    dt = jsim.pick_dt(jsim.check(jst)[0])
    return jsim, tsim, (u, v, w, p), dt


def _compare(jstate, tstate):
    for name, tol in TOL.items():
        a = np.asarray(getattr(jstate, name))
        b = getattr(tstate, name).numpy()
        if name == 'p':
            a, b = a - a.mean(), b - b.mean()
        err = np.abs(a - b).max()
        assert err <= tol, f'{name}: {err:.3e} > {tol:.0e}'
    # the one live wall-face plane: w at the lower z wall
    np.testing.assert_allclose(tstate.vlo[2].numpy(),
                               np.asarray(jstate.vlo[2]), rtol=0, atol=1e-11)


def test_slice_matches_jax_for_three_steps(pair):
    jsim, tsim, fields, dt = pair
    jst = jsim.initial_state(*fields)
    tst = tsim.initial_state(*fields)
    _compare(jst, tst)
    for _ in range(3):
        jst, jd = jsim.step(jst, dt)
        tst, td = tsim.step(tst, dt)
        _compare(jst, tst)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-10)
    assert tst.istep == 3 and abs(tst.time - 3 * dt) < 1e-12
    # the diagnostics agree too
    for a, b in zip(tsim.check(tst), jsim.check(jst)):
        assert abs(a - b) <= 1e-12 * max(1.0, abs(b))


def test_state_carried_across_from_jax(pair):
    """A JAX state after 2 steps, carried into the port, steps on to the
    same fields (the port rebuilds the z-edge cache the XLA path does not
    keep)."""
    jsim, tsim, fields, dt = pair
    jst = jsim.initial_state(*fields)
    for _ in range(2):
        jst, _ = jsim.step(jst, dt)
    leaves = dict(u=jst.u, v=jst.v, w=jst.w, p=jst.p, visct=jst.visct,
                  vlo=jst.vlo, rhs_old=jst.rhs_old, zq=jst.zq,
                  time=jst.time, istep=jst.istep)
    d = jax.tree_util.tree_map(np.asarray, leaves)
    tst = params.state_from_jax_numpy(d, 'cpu', torch.float64)
    assert tst.zq is None and tst.istep == 2
    for _ in range(2):
        jst, _ = jsim.step(jst, dt)
        tst, _ = tsim.step(tst, dt)
    _compare(jst, tst)
    back = params.state_to_numpy(tst)
    np.testing.assert_array_equal(back['u'], tst.u.numpy())
    assert back['istep'] == 4 and len(back['zq']) == 3


def test_exec_path_names_device_kernels_and_solve(pair):
    _, tsim, _, _ = pair
    path = tsim.exec_path()
    assert path.startswith('cpu')
    for name in K.LAUNCHES:
        assert name in path
    assert 'torch.fft' in path


@pytest.mark.parametrize('change,missing', [
    (dict(impdiff=True), 'impdiff'),
    (dict(lwm=((0, 0, 1), (0, 0, 1)), hwm=0.1), 'wall model'),
    (dict(sgstype='dsmag'), 'dsmag'),
    (dict(sgstype='none'), 'fused_correc_updatep'),
    (dict(cbcvel=((('P', 'P', 'P'), ('D', 'D', 'D'), ('D', 'D', 'D')),) * 2,
          cbcpre=(('P', 'N', 'N'),) * 2), 'non-periodic y'),
    (dict(scalar=True), 'scalar'),
    (dict(dims=(2, 1)), 'mesh'),
    (dict(ptransform='mat'), "ptransform='mat'"),
    (dict(zsolver='thomas'), 'thomas'),
    (dict(cbcvel=(((('P',) * 3,) * 3),) * 2, cbcpre=(('P',) * 3,) * 2,
          cbcsgs=(('P',) * 3,) * 2, gr=0.0), 'triperiodic'),
])
def test_configs_outside_the_slice_raise(change, missing):
    cfg = Config(**{**HEADLINE, **change})
    grid = make_grid_from_config(cfg)
    assert any(missing in m for m in unsupported(cfg))
    with pytest.raises(NotImplementedError, match='outside the ported slice'):
        Simulation(cfg, grid, device='cpu')


def test_headline_config_is_in_the_slice():
    assert unsupported(Config(**HEADLINE)) == []
