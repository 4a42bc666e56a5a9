"""The triperiodic LES in cales_torch, stepped 3 steps at fp64 on the CPU
against cales_tpu's Simulation(use_pallas=False) (tests/_box_les_step.py:
the Taylor-Green vortex at chip_smoke.py's small card-vs-CPU grid with
seeded random low modes on top):

  * static Smagorinsky on the box (no van Driest damping; the smag kernel,
    the fused correction off as in cales_tpu), explicit and with full-3D
    implicit diffusion;
  * dynamic Smagorinsky with 'dit' (the dsmag kernel's periodic-z mode and
    one dzf-weighted ratio) by 'mat', and with 'channel' by 'fft';
  * 'dit''s one ratio for the volume after a step.

Tolerances: those of tests/_box_les_step.py."""
import pytest
import torch

from cales_tpu.config import Config as JConfig
from cales_tpu.grid import make_grid_from_config as j_make_grid

from cales_torch.config import Config
from cales_torch.grid import make_grid_from_config
from cales_torch.ops import kernels as K
from cales_torch.timeloop import Simulation

from _box_les_step import TGV, compare, start, step_pair

torch.set_num_threads(1)

STEP_CASES = {
    'smag': dict(TGV, sgstype='smag'),
    'smag_impdiff3d': dict(TGV, sgstype='smag', impdiff=True),
    'dsmag_dit': dict(TGV, sgstype='dsmag', dsmag_avg='dit'),
    'dsmag_channel_fft': dict(TGV, sgstype='dsmag', dsmag_avg='channel',
                              ptransform='fft'),
}


@pytest.mark.parametrize('case', sorted(STEP_CASES))
def test_box_les_steps_match_jax(case):
    kw = STEP_CASES[case]
    jst, tst, jd, td, tsim = step_pair(kw)
    compare(jst, tst, jd, td, sgs=True)
    names = tsim.kernel_names()
    assert 'correc_smag' not in names and 'correc_updatep' in names
    assert ('smag' in names) == (kw['sgstype'] == 'smag')
    assert ('dsmag' in names) == (kw['sgstype'] == 'dsmag')
    assert not tsim.fused_smag and not tsim.have_zwalls
    path = tsim.exec_path()
    if kw['sgstype'] == 'dsmag':
        assert 'periodic-z mode' in path and repr(kw['dsmag_avg']) in path
    else:
        assert 'no van Driest' in path


def test_box_dsmag_dit_uses_one_ratio():
    """'dit' gives one ratio for the volume: nu_t / |S| is the same in every
    cell (a positive ratio here)."""
    kw = STEP_CASES['dsmag_dit']
    tcfg = Config(**kw)
    sim = Simulation(tcfg, make_grid_from_config(tcfg), device='cpu')
    jcfg = JConfig(**kw)
    st = sim.initial_state(*start(jcfg, j_make_grid(jcfg), 5))
    st, _ = sim.step(st, 1e-3)
    ue, ve, we = st.zq
    s0 = K.dsmag(st.u, st.v, st.w, ue, ve, we, sim.alph2_t, sim.dzci_t,
                 sim.dzfi_t, tcfg.dli[0], tcfg.dli[1], False, False,
                 zper=True, avg='dit')[0]
    r = st.visct / s0
    assert float(st.visct.max()) > 0
    assert float(r.max() - r.min()) <= 1e-12 * float(r.max())
