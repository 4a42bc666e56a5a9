"""Transpiring z walls (a uniform w = W blown through the lower wall and
sucked through the upper one) in cales_torch, fp64 on the CPU:

  * the slice stepped 3 steps against cales_tpu's
    Simulation(use_pallas=False): the dynamic-Smagorinsky channel with
    impdiff_1d (validation/dsmag_channel.py's, chip_smoke.py's dsmag_blow),
    the dsmag duct (duct_les_dsmag, explicit) and the channel with sgstype
    'none', each with W on both z faces;
  * the port's two passes against its one pass on the channel, the duct and
    the cavity without transpiration (CALES_DSMAG_TWOPASS=1), 2 steps, as
    cales_tpu's test_pallas_dsmag_onepass_channel holds its two routes;
  * the route rule against cales_tpu's _dsmag_onepass_vals_ok;
  * kernel_names and exec_path naming the two-pass kernels.

Tolerances: u, v, w and the kept wall planes 1e-11, p 1e-11 after removing
its mean, nu_t 1e-11 relative to its maximum (the same formulas, sums in
another order)."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cales_tpu.config import Config as JConfig
from cales_tpu.grid import make_grid_from_config as j_make_grid
from cales_tpu.initflow import initflow
from cales_tpu.timeloop import Simulation as JaxSimulation

from cales_torch.config import Config
from cales_torch.grid import make_grid_from_config
from cales_torch.ops import kernels as K
from cales_torch.timeloop import Simulation, dsmag_onepass_vals_ok, unsupported

torch.set_num_threads(1)

W = 0.003
ZERO = ((0.0,) * 3,) * 3
TRANSPIRING = (((0.0,) * 3, (0.0,) * 3, (0.0, 0.0, W)),
               ((0.0,) * 3, (0.0,) * 3, (0.0, 0.0, W)))
CHAN_BCS = dict(
    cbcvel=((('P', 'P', 'P'), ('P', 'P', 'P'), ('D', 'D', 'D')),) * 2,
    cbcpre=(('P', 'P', 'N'),) * 2, cbcsgs=(('P', 'P', 'D'),) * 2)
DUCT_BCS = dict(
    cbcvel=((('P', 'P', 'P'), ('D', 'D', 'D'), ('D', 'D', 'D')),) * 2,
    cbcpre=(('P', 'N', 'N'),) * 2, cbcsgs=(('P', 'D', 'D'),) * 2)
# validation/dsmag_channel.py:77-89, bench.py duct_les_dsmag and
# cavity_les_dsmag at a test size
CHANNEL = dict(ng=(16, 12, 10), l=(12.8, 4.8, 2.0), gtype=1, gr=5.0,
               visci=10_000.0, inivel='poi', is_wallturb=True,
               is_forced=(True, False, False), velf=(1.0, 0.0, 0.0),
               dtype='float64', sgstype='dsmag', dsmag_avg='channel',
               ptransform='mat', impdiff=True, impdiff_1d=True, **CHAN_BCS)
DUCT = dict(ng=(16, 12, 10), l=(4 * np.pi, 2.0, 2.0), gtype=1, gr=1.0,
            visci=10_000.0, inivel='duc', is_wallturb=True,
            is_forced=(True, False, False), velf=(1.0, 0.0, 0.0),
            sgstype='dsmag', dsmag_avg='duct', dtype='float64',
            ptransform='mat', **DUCT_BCS)
CAVITY = dict(DUCT, l=(1.0, 1.0, 1.0), gr=0.0, visci=5_000.0, inivel='tgv',
              is_wallturb=False, is_forced=(False,) * 3, velf=(0.0,) * 3,
              dsmag_avg='cavity',
              bcvel=(ZERO, ((0.0,) * 3, (0.0,) * 3, (0.0, 1.0, 0.0))))
STEP_CASES = {
    'dsmag_channel_impdiff_1d': dict(CHANNEL, bcvel=TRANSPIRING),
    'dsmag_duct': dict(DUCT, bcvel=TRANSPIRING),
    'none_channel': dict(CHANNEL, sgstype='none', bcvel=TRANSPIRING),
}


def _compare(jst, tst, ywalled, tol=1e-11):
    for name in ('u', 'v', 'w', 'p', 'visct'):
        a, b = np.asarray(getattr(jst, name)), getattr(tst, name).numpy()
        if name == 'p':
            a, b = a - a.mean(), b - b.mean()
        err = np.abs(a - b).max()
        if name == 'visct':
            err /= max(np.abs(a).max(), 1e-300)
        assert err <= tol, f'{name}: {err:.3e}'
    # the kept wall planes: w's lower z face, with y walls v's lower y face
    # (unused and not carried under periodic y)
    for m in ((1, 2) if ywalled else (2,)):
        np.testing.assert_allclose(np.asarray(tst.vlo[m]),
                                   np.asarray(jst.vlo[m]), rtol=0, atol=tol)


@pytest.mark.parametrize('case', sorted(STEP_CASES))
def test_transpiring_slice_matches_jax_for_three_steps(case):
    kw = STEP_CASES[case]
    jcfg = JConfig(**kw, use_pallas=False)
    jgrid = j_make_grid(jcfg)
    tcfg = Config(**kw)
    assert unsupported(tcfg) == []
    jsim = JaxSimulation(jcfg, jgrid)
    tsim = Simulation(tcfg, make_grid_from_config(tcfg), device='cpu')
    assert tsim.dsmag_twopass == (kw['sgstype'] == 'dsmag')
    fields = initflow(jcfg, jgrid)
    jst, tst = jsim.initial_state(*fields), tsim.initial_state(*fields)
    dt = jsim.pick_dt(jsim.check(jst)[0])
    for _ in range(3):
        jst, jd = jsim.step(jst, dt)
        tst, td = tsim.step(tst, dt)
        _compare(jst, tst, tsim.ywalled)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0,
                                   atol=1e-11)
    # w on both z faces is W: the kept lower face and the last interior row
    np.testing.assert_allclose(tst.vlo[2][1:-1, 1:-1].numpy(), W, atol=1e-12)
    np.testing.assert_allclose(tst.w[-1].numpy(), W, atol=1e-12)
    if kw['sgstype'] == 'dsmag':
        assert float(tst.visct.min()) >= 0.0 and float(tst.visct.max()) > 0


@pytest.mark.parametrize('kw', [CHANNEL, DUCT, CAVITY],
                         ids=['channel', 'duct', 'cavity'])
def test_twopass_matches_onepass(kw, monkeypatch):
    cfg = Config(**kw)
    grid = make_grid_from_config(cfg)
    fields = initflow(cfg, grid)
    states = []
    for two in ('', '1'):
        monkeypatch.setenv('CALES_DSMAG_TWOPASS', two)
        sim = Simulation(cfg, grid, device='cpu')
        assert sim.dsmag_twopass == (two == '1')
        st = sim.initial_state(*fields)
        for _ in range(2):
            st, _ = sim.step(st, 1e-3)
        states.append(st)
    a, b = states
    for name in ('u', 'v', 'w', 'p', 'visct'):
        x, y = getattr(a, name), getattr(b, name)
        err = float((x - y).abs().max())
        if name == 'visct':
            err /= float(x.abs().max())
        assert err <= 1e-11, f'{name}: {err:.3e}'


def _bcvel(zw=(0.0, 0.0), zu=(0.0, 0.0), yu=(0.0, 0.0)):
    return tuple(((0.0,) * 3, (yu[ib], 0.0, 0.0), (zu[ib], 0.0, zw[ib]))
                 for ib in range(2))


@pytest.mark.parametrize('kw,onepass', [
    (CHANNEL, True),
    (dict(CHANNEL, bcvel=TRANSPIRING), False),
    (dict(CHANNEL, bcvel=_bcvel(zw=(0.0, -0.01))), False),
    (dict(CHANNEL, bcvel=_bcvel(zu=(0.2, -0.1))), True),
    (DUCT, True),
    (dict(DUCT, bcvel=_bcvel(zw=(W, W))), False),
    (dict(DUCT, bcvel=_bcvel(yu=(0.3, 0.0))), True),
    (CAVITY, True),
])
def test_route_rule_matches_jax(kw, onepass):
    """One pass unless a wall-normal face value is non-zero, as the JAX
    package's rule decides on the same configuration."""
    tcfg, jcfg = Config(**kw), JConfig(**kw)
    ywalled = kw['cbcvel'][0][1][0] != 'P'
    jrule = JaxSimulation._dsmag_onepass_vals_ok(
        SimpleNamespace(cfg=jcfg, _ywalled=ywalled))
    assert dsmag_onepass_vals_ok(tcfg, ywalled) == jrule == onepass
    assert unsupported(tcfg) == []


def test_kernel_names_and_exec_path_name_the_two_passes(monkeypatch):
    monkeypatch.delenv('CALES_DSMAG_TWOPASS', raising=False)
    cfg = Config(**STEP_CASES['dsmag_channel_impdiff_1d'])
    sim = Simulation(cfg, make_grid_from_config(cfg), device='cpu')
    names = sim.kernel_names()
    assert 'dsmag_level1' in names and 'dsmag_level2' in names
    assert 'dsmag' not in names
    assert "dsmag two-pass, 'channel' average" in sim.exec_path()
    one = Simulation(Config(**CHANNEL), make_grid_from_config(cfg),
                     device='cpu')
    assert 'dsmag' in one.kernel_names()
    assert 'dsmag_level1' not in one.kernel_names()
    assert "dsmag kernel, 'channel' average" in one.exec_path()
    # on the CPU the two-pass stage runs the twins and launches nothing
    K.reset_launches()
    st = sim.initial_state(*initflow(cfg, sim.grid))
    sim.step(st, 1e-3)
    assert all(n == 0 for n in K.LAUNCHES.values())
