"""Bulk forcing along z on the triperiodic box in cales_torch, stepped 3
steps at fp64 on the CPU against cales_tpu's Simulation(use_pallas=False)
(tests/_box_les_step.py): forced along z, and along x and z, explicit and
with impdiff_1d or full-3D implicit diffusion, with and without an SGS
model.  With implicit diffusion the port takes the bulk mean of w from the
momentum kernel's folded output (the CN fold's volume mean vanishes on a
periodic z), cales_tpu from the unfolded prediction: the same to
rounding, which the 1e-11 bound shows.  The bulk w after each step is the
forcing's target.

Tolerances: those of tests/_box_les_step.py; the bulk w 1e-12."""
import pytest
import torch

from _box_les_step import TGV, compare, step_pair

torch.set_num_threads(1)

ZF = dict(is_forced=(False, False, True), velf=(0.0, 0.0, 0.1))
XZF = dict(is_forced=(True, False, True), velf=(0.05, 0.0, 0.1))
STEP_CASES = {
    'forced_z': dict(TGV, sgstype='none', **ZF),
    'forced_z_smag_1d': dict(TGV, sgstype='smag', impdiff=True,
                             impdiff_1d=True, **ZF),
    'forced_xz_dsmag': dict(TGV, sgstype='dsmag', dsmag_avg='dit', **XZF),
    'forced_xz_1d': dict(TGV, sgstype='none', impdiff=True, impdiff_1d=True,
                         **XZF),
    'forced_z_impdiff3d': dict(TGV, sgstype='none', impdiff=True, **ZF),
}


@pytest.mark.parametrize('case', sorted(STEP_CASES))
def test_box_forced_along_z_steps_match_jax(case):
    kw = STEP_CASES[case]
    jst, tst, jd, td, tsim = step_pair(kw)
    compare(jst, tst, jd, td, sgs=kw['sgstype'] != 'none')
    # the bulk w with the gvr_c weights (cales_tpu timeloop.py:2355)
    wb = float((tst.w.sum(dim=(1, 2))
                * torch.as_tensor(tsim.gvr_c)).sum())
    assert abs(wb - kw['velf'][2]) <= 1e-12
