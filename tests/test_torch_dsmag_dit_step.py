"""The dynamic model's 'dit' average and 2D test filter on the z-walled
classes in cales_torch, stepped 3 steps at fp64 on the CPU against
cales_tpu's Simulation(use_pallas=False) (tests/_box_les_step.py):

  * the dsmag channel (validation/dsmag_channel.py's, impdiff_1d) with
    'dit' by the one-pass kernel, and by the two passes (transpiring walls:
    the route rule; and CALES_DSMAG_TWOPASS=1);
  * the channel with the 2D test filter (filter_2d: the kernel's F2D mode,
    alpha^2 2.52), 'channel' and 'dit', explicit;
  * the dsmag duct (bench.py's duct_les_dsmag) with 'dit'.

Tolerances: those of tests/_box_les_step.py."""
import numpy as np
import pytest
import torch

from cales_torch.config import Config
from cales_torch.grid import make_grid_from_config
from cales_torch.timeloop import Simulation

from _box_les_step import compare, step_pair

torch.set_num_threads(1)

W = 0.003
TRANSPIRING = (((0.0,) * 3, (0.0,) * 3, (0.0, 0.0, W)),) * 2
CHAN_BCS = dict(
    cbcvel=((('P', 'P', 'P'), ('P', 'P', 'P'), ('D', 'D', 'D')),) * 2,
    cbcpre=(('P', 'P', 'N'),) * 2, cbcsgs=(('P', 'P', 'D'),) * 2)
CHANNEL = dict(ng=(16, 12, 10), l=(12.8, 4.8, 2.0), gtype=1, gr=5.0,
               visci=10_000.0, inivel='poi', is_wallturb=True,
               is_forced=(True, False, False), velf=(1.0, 0.0, 0.0),
               dtype='float64', sgstype='dsmag', dsmag_avg='dit',
               ptransform='mat', impdiff=True, impdiff_1d=True, **CHAN_BCS)
DUCT = dict(ng=(16, 12, 10), l=(4 * np.pi, 2.0, 2.0), gtype=1, gr=1.0,
            visci=10_000.0, inivel='duc', is_wallturb=True,
            is_forced=(True, False, False), velf=(1.0, 0.0, 0.0),
            sgstype='dsmag', dsmag_avg='dit', dtype='float64',
            ptransform='mat',
            cbcvel=((('P', 'P', 'P'), ('D', 'D', 'D'), ('D', 'D', 'D')),) * 2,
            cbcpre=(('P', 'N', 'N'),) * 2, cbcsgs=(('P', 'D', 'D'),) * 2)
# (config, two passes, CALES_DSMAG_TWOPASS)
STEP_CASES = {
    'channel_dit': (CHANNEL, False, ''),
    'channel_dit_transpiring': (dict(CHANNEL, bcvel=TRANSPIRING), True, ''),
    'channel_dit_twopass_switch': (CHANNEL, True, '1'),
    'channel_filter_2d': (dict(CHANNEL, dsmag_avg='channel',
                               filter_2d=True, impdiff=False), False, ''),
    'channel_filter_2d_dit': (dict(CHANNEL, filter_2d=True, impdiff=False,
                                   ptransform='fft'), False, ''),
    'duct_dit': (DUCT, False, ''),
}


@pytest.mark.parametrize('case', sorted(STEP_CASES))
def test_dsmag_dit_and_2d_filter_steps_match_jax(case, monkeypatch):
    kw, two, switch = STEP_CASES[case]
    monkeypatch.setenv('CALES_DSMAG_TWOPASS', switch)
    jst, tst, jd, td, tsim = step_pair(kw)
    compare(jst, tst, jd, td, sgs=True)
    assert tsim.dsmag_twopass == two
    names = tsim.kernel_names()
    assert ('dsmag' in names) != two
    assert ('dsmag_level1' in names) == two
    path = tsim.exec_path()
    assert repr(kw['dsmag_avg']) in path
    assert ('2D test filter' in path) == kw.get('filter_2d', False)


@pytest.mark.parametrize('kw', [
    dict(CHANNEL, filter_2d=True, impdiff=False),
    dict(CHANNEL, ng=(16, 12, 12), gr=0.0, cbcvel=((('P',) * 3,) * 3,) * 2,
         cbcpre=(('P',) * 3,) * 2, cbcsgs=(('P',) * 3,) * 2,
         is_forced=(False,) * 3, velf=(0.0,) * 3, inivel='tgv',
         is_wallturb=False)], ids=['filter_2d', 'box'])
def test_the_two_pass_switch_refuses_the_one_pass_modes(kw, monkeypatch):
    """CALES_DSMAG_TWOPASS=1 where the two passes have no mode of their
    own (the 2D filter, periodic z): an error, not a one-pass run."""
    monkeypatch.setenv('CALES_DSMAG_TWOPASS', '1')
    cfg = Config(**kw)
    with pytest.raises(NotImplementedError, match='CALES_DSMAG_TWOPASS'):
        Simulation(cfg, make_grid_from_config(cfg), device='cpu')
