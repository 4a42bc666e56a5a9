"""The passive scalar with z walls and on the triperiodic box, end to end:
cales_torch's Simulation on the CPU against cales_tpu's on its XLA path
(use_pallas=False), fp64, at (nx, ny, nz) = (32, 8, 8), 3 steps (the
tolerances and the comparison in tests/_scalar_step.py):
  * the forced-scalar channel LES of tests/test_pallas_kernels.py:1298
    (test_scalar_fused_in_mom_kernel_matches_xla: smag, 'mat', x-forced
    velocity, ssource 0.05, N scalar walls), with the scalar's own bulk
    forcing (is_sforced, scalf 1.0) as well;
  * the wall-modelled channel of tests/test_pallas_kernels.py:1377
    (test_scalar_wmles_kernel_matches_xla: gtype 6, the log-law wall
    model on both z walls: its planes change the velocity's ghosts only);
  * the channel LES with z-implicit diffusion (impdiff_1d), the scalar
    explicit, with a warm and a cold wall (D 0 and 1);
  * the triperiodic DNS of tests/test_timeloop.py:131 (periodic z);
and a JAX state of the forced channel carried across with its scalar."""
import functools

import numpy as np
import pytest
import torch

from _scalar_step import NG, carried, run

torch.set_num_threads(1)

CHAN = dict(ng=NG, l=(2 * np.pi, np.pi, 2.0), gtype=1, gr=0.9,
            visci=2000.0, inivel='log', is_wallturb=True, dtype='float64',
            is_forced=(True, False, False), velf=(1.0, 0.0, 0.0),
            sgstype='smag', ptransform='mat', scalar=True, pr=0.71,
            iniscal='zer', ssource=0.05,
            cbcscal=(('P', 'P', 'N'), ('P', 'P', 'N')),
            cbcvel=((('P', 'P', 'P'), ('P', 'P', 'P'), ('D', 'D', 'D')),) * 2,
            cbcpre=(('P', 'P', 'N'), ('P', 'P', 'N')),
            cbcsgs=(('P', 'P', 'N'), ('P', 'P', 'N')))
CASES = {
    'forced channel LES': dict(CHAN, is_sforced=True, scalf=1.0),
    'WMLES channel': dict(CHAN, l=(12.8, 4.8, 2.0), gtype=6, gr=0.0,
                          visci=125000.0, inivel='poi',
                          lwm=((0, 0, 1), (0, 0, 1)), hwm=0.1,
                          cbcsgs=(('P', 'P', 'D'), ('P', 'P', 'D'))),
    'impdiff_1d channel': dict(CHAN, impdiff=True, impdiff_1d=True,
                               ssource=0.0,
                               cbcscal=(('P', 'P', 'D'), ('P', 'P', 'D')),
                               bcscal=((0.0, 0.0, 0.0), (0.0, 0.0, 1.0))),
    'triperiodic DNS': dict(ng=NG, l=(2 * np.pi, 1.0, 1.0), visci=10.0,
                            inivel='tgv', dtype='float64', scalar=True,
                            pr=1.0, iniscal='uni',
                            cbcvel=((('P',) * 3,) * 3, (('P',) * 3,) * 3),
                            cbcpre=(('P',) * 3, ('P',) * 3),
                            cbcsgs=(('P',) * 3, ('P',) * 3),
                            cbcscal=(('P', 'P', 'P'), ('P', 'P', 'P'))),
}


@functools.lru_cache(maxsize=None)
def _run(case):
    return run(CASES[case])


@pytest.mark.parametrize('case', list(CASES))
def test_scalar_with_z_walls_matches_jax(case):
    tst, tsim, _ = _run(case)
    assert tst.s.shape == tst.u.shape and tsim.has_scal
    if case == 'forced channel LES':
        # the scalar's bulk forcing holds its volume mean at scalf
        mean = float(torch.dot(tst.s.sum(dim=(1, 2)), tsim.gvr_f_t))
        assert abs(mean - 1.0) <= 1e-12
        assert 'forced' in tsim.exec_path()


def test_jax_scalar_state_carried_across():
    _, tsim, (jsim, jst, dt) = _run('forced channel LES')
    carried(jsim, jst, tsim, dt)
