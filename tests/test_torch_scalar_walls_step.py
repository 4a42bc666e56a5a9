"""The passive scalar with y and x walls, end to end: cales_torch's
Simulation on the CPU against cales_tpu's on its XLA path
(use_pallas=False), fp64, at (nx, ny, nz) = (32, 8, 8), 3 steps (the
tolerances and the comparison in tests/_scalar_step.py):
  * the duct of tests/test_pallas_kernels.py:1336
    (test_scalar_ywalled_duct_kernel_matches_xla: y and z walls, smag, the
    scalar D on the y walls at 1.0 and 0.5, N on the z walls), its
    stacks the y-row stack pair;
  * the wall-modelled duct of tests/test_pallas_kernels.py:1420 (the
    log-law wall model on the four side walls, N scalar walls), 2 steps
    as that test takes;
  * the developing channel of tests/test_pallas_kernels.py:489
    (test_pallas_step_integration_xwalled_scalar: inflow, outflow, the
    scalar D 1.0 at the inflow, N at the outflow), its x stack pair;
  * the developing duct of tests/test_pallas_kernels.py:655
    (test_pallas_xywalled_scalar: x and y walls, the x stack's (y ghost,
    x ghost) corners from the scalar's own letters);
and a JAX developing-duct state carried across with its scalar."""
import functools

import numpy as np
import pytest
import torch

from _scalar_step import NG, carried, run

torch.set_num_threads(1)

DUCT = dict(ng=NG, l=(2 * np.pi, 2.0, 2.0), gtype=1, gr=0.5, visci=2000.0,
            inivel='duc', is_wallturb=False, dtype='float64',
            is_forced=(True, False, False), velf=(1.0, 0.0, 0.0),
            sgstype='smag', ptransform='mat', scalar=True, pr=0.71,
            iniscal='uni', ssource=0.02,
            cbcscal=(('P', 'D', 'N'), ('P', 'D', 'N')),
            bcscal=((0.0, 1.0, 0.0), (0.0, 0.5, 0.0)),
            cbcvel=((('P', 'P', 'P'), ('D', 'D', 'D'), ('D', 'D', 'D')),) * 2,
            cbcpre=(('P', 'N', 'N'), ('P', 'N', 'N')),
            cbcsgs=(('P', 'D', 'D'), ('P', 'D', 'D')))
XDEV = dict(ng=NG, l=(2.0, 1.5, 1.0), gtype=1, gr=0.0, visci=5000.0,
            inivel='uni', is_wallturb=False, dtype='float64',
            sgstype='none', scalar=True, pr=0.71, iniscal='uni',
            ssource=0.02, cbcscal=(('D', 'P', 'N'), ('N', 'P', 'N')),
            bcscal=((1.0, 0.0, 0.0), (0.0, 0.0, 0.0)),
            cbcvel=((('D', 'N', 'N'), ('P', 'P', 'P'), ('D', 'D', 'D')),
                    (('N', 'N', 'N'), ('P', 'P', 'P'), ('D', 'D', 'D'))),
            bcvel=(((1.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 0.0, 0.0)),) * 2,
            cbcpre=(('N', 'P', 'N'), ('D', 'P', 'N')),
            cbcsgs=(('N', 'P', 'D'), ('N', 'P', 'D')))
CASES = {
    'duct': DUCT,
    'WMLES duct': dict(DUCT, l=(12.8, 2.0, 2.0), gr=0.0, visci=20000.0,
                       is_wallturb=True, hwm=0.2, lwm=((0, 1, 1), (0, 1, 1)),
                       cbcscal=(('P', 'N', 'N'), ('P', 'N', 'N')),
                       bcscal=((0.0,) * 3, (0.0,) * 3)),
    'developing channel': XDEV,
    'developing duct': dict(
        XDEV, l=(2.0, 1.0, 1.0), visci=2000.0,
        cbcscal=(('D', 'D', 'N'), ('N', 'N', 'N')),
        bcscal=((1.0, 0.5, 0.0), (0.0, 0.0, 0.0)),
        cbcvel=((('D', 'N', 'N'), ('D', 'D', 'D'), ('D', 'D', 'D')),
                (('N', 'N', 'N'), ('D', 'D', 'D'), ('D', 'D', 'D'))),
        cbcpre=(('N', 'N', 'N'), ('D', 'N', 'N')),
        cbcsgs=(('N', 'D', 'D'), ('N', 'D', 'D'))),
}


@functools.lru_cache(maxsize=None)
def _run(case):
    return run(CASES[case], nsteps=2 if case == 'WMLES duct' else 3)


@pytest.mark.parametrize('case', list(CASES))
def test_scalar_with_y_and_x_walls_matches_jax(case):
    tst, tsim, _ = _run(case)
    assert tsim.has_scal
    walled = [a for a, on in (('x', tsim.xwalled), ('y', tsim.ywalled)) if on]
    assert walled and f"({'-'.join(walled)}-walled" in tsim.exec_path()


def test_jax_scalar_state_carried_across_with_x_and_y_walls():
    _, tsim, (jsim, jst, dt) = _run('developing duct')
    carried(jsim, jst, tsim, dt)
