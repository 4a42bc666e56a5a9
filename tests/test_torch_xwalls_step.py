"""The x-walled slices end to end: cales_torch's Simulation on the CPU (the
kernels' plain twins) against cales_tpu's Simulation on its XLA expression
path (use_pallas=False), fp64, at (nx, ny, nz) = (32, 8, 8):
  * the developing channel (inflow u = 1 at x = 0, outflow at x = lx,
    periodic y, z walls);
  * the closed box (walls on all six faces) from random initial fields;
  * the lid-driven cavity (the JAX package's models.cases.
    lid_driven_cavity: u = 1 on the top z face);
  * the developing duct (the developing channel with y walls);
each stepped 3 steps, the kept wall planes vlo (u's lower x face, v's
lower y face, w's lower z face) compared whole; a JAX developing-channel
state carried into the port (its vlo[0] with it); and the four example
namelists of these classes (examples/developing_channel, closed_box,
lid_driven_cavity, developing_duct) at a reduced grid for 2 steps.

Tolerances: u, v, w and the vlo planes 1e-11, p 1e-11 after removing its
mean (the all-Neumann box and cavity fix p up to a constant)."""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from cales_tpu.config import Config as JConfig
from cales_tpu.grid import make_grid_from_config as j_make_grid
from cales_tpu.initflow import initflow
from cales_tpu.models.cases import lid_driven_cavity
from cales_tpu.nml import config_from_nml as jax_nml
from cales_tpu.timeloop import Simulation as JaxSimulation

from cales_torch import params
from cales_torch.config import Config
from cales_torch.grid import make_grid_from_config
from cales_torch.nml import config_from_nml
from cales_torch.timeloop import Simulation, unsupported

torch.set_num_threads(1)

NG = (32, 8, 8)
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
ALLD = (('D', 'D', 'D'),) * 3
BOX = dict(ng=NG, l=(1.0, 1.0, 1.0), gtype=1, gr=0.0, visci=1000.0,
           inivel='zer', dtype='float64', sgstype='none',
           cbcvel=(ALLD, ALLD), cbcpre=(('N',) * 3,) * 2,
           cbcsgs=(('D',) * 3,) * 2)
CASES = ('developing_channel', 'closed_box', 'lid_driven_cavity',
         'developing_duct')
EXAMPLES = Path(__file__).resolve().parents[1] / 'examples'


def _configs(case):
    """(JAX config, port config) of one case."""
    if case == 'lid_driven_cavity':
        jcfg = lid_driven_cavity(ng=NG, visci=1000.0, dtype='float64',
                                 sgstype='none', use_pallas=False)
        kw = {k: getattr(jcfg, k) for k in (
            'ng', 'l', 'visci', 'inivel', 'cbcvel', 'bcvel', 'cbcpre',
            'cbcsgs', 'dsmag_avg', 'dtype', 'sgstype')}
        return jcfg, Config(**kw)
    kw = {'developing_channel': DEV, 'closed_box': BOX,
          'developing_duct': DDUCT}[case]
    return JConfig(**kw, use_pallas=False), Config(**kw)


def _sims(jcfg, tcfg):
    jgrid = j_make_grid(jcfg)
    return (JaxSimulation(jcfg, jgrid),
            Simulation(tcfg, make_grid_from_config(tcfg), device='cpu'),
            initflow(jcfg, jgrid))


def _compare(jst, tst, tol=1e-11):
    for name in ('u', 'v', 'w', 'p'):
        a, b = np.asarray(getattr(jst, name)), getattr(tst, name).numpy()
        if name == 'p':
            a, b = a - a.mean(), b - b.mean()
        err = np.abs(a - b).max()
        assert err <= tol, f'{name}: {err:.3e}'
    for m in range(3):
        a, b = np.asarray(jst.vlo[m]), tst.vlo[m].numpy()
        assert a.shape == b.shape, (m, a.shape, b.shape)
        err = np.abs(a - b).max()
        assert err <= tol, f'vlo[{m}]: {err:.3e}'


@pytest.mark.parametrize('case', CASES)
def test_xwalled_slice_matches_jax_for_three_steps(case):
    jcfg, tcfg = _configs(case)
    assert unsupported(tcfg) == []
    jsim, tsim, fields = _sims(jcfg, tcfg)
    if case == 'closed_box':
        rng = np.random.default_rng(11)
        fields = [0.1 * rng.standard_normal(np.shape(f)) for f in fields]
    jst, tst = jsim.initial_state(*fields), tsim.initial_state(*fields)
    _compare(jst, tst)
    dt = jsim.pick_dt(jsim.check(jst)[0])
    for _ in range(3):
        jst, _ = jsim.step(jst, dt)
        tst, _ = tsim.step(tst, dt)
        _compare(jst, tst)
    # the flow moved: the comparison is not of zeros
    assert float(tst.u.abs().max()) > 1e-3
    for a, b in zip(tsim.check(tst), jsim.check(jst)):
        assert abs(a - b) <= 1e-10 * max(1.0, abs(b))
    path = tsim.exec_path()
    assert 'x-ghost column stacks' in path and 'apply_y' in path
    assert tsim.kernel_names() == ['mom_rk', 'fillps', 'correc_updatep',
                                   'apply_y', 'z_eig']


def test_developing_channel_state_carried_across_from_jax():
    """A JAX developing-channel state after 2 steps (its kept inflow face
    vlo[0] included) steps on in the port to the same state."""
    jcfg, tcfg = _configs('developing_channel')
    jsim, tsim, fields = _sims(jcfg, tcfg)
    jst = jsim.initial_state(*fields)
    dt = jsim.pick_dt(jsim.check(jst)[0])
    for _ in range(2):
        jst, _ = jsim.step(jst, dt)
    leaves = dict(u=jst.u, v=jst.v, w=jst.w, p=jst.p, visct=jst.visct,
                  vlo=jst.vlo, rhs_old=jst.rhs_old, zq=jst.zq,
                  time=jst.time, istep=jst.istep)
    tst = params.state_from_jax_numpy(
        jax.tree_util.tree_map(np.asarray, leaves), 'cpu', torch.float64)
    nx, ny, nz = NG
    assert tuple(tst.vlo[0].shape) == (nz + 2, ny + 2)
    assert tst.xq is None          # rebuilt from vlo by the first substep
    for _ in range(2):
        jst, _ = jsim.step(jst, dt)
        tst, _ = tsim.step(tst, dt)
    _compare(jst, tst)
    back = params.state_to_numpy(tst)
    np.testing.assert_array_equal(back['vlo'][0], tst.vlo[0].numpy())


@pytest.mark.parametrize('example', CASES)
def test_xwalled_example_namelist_matches_jax(example):
    """examples/<example>/input.nml (ptransform 'auto': the port takes
    'mat'), at a reduced grid, 2 steps against cales_tpu's XLA path."""
    nml = EXAMPLES / example / 'input.nml'
    change = dict(ng=(16, 8, 8))
    jcfg = jax_nml(nml, dtype='float64').replace(use_pallas=False, **change)
    tcfg = config_from_nml(nml, dtype='float64').replace(**change)
    assert unsupported(tcfg) == []
    jsim, tsim, fields = _sims(jcfg, tcfg)
    assert tsim.solver_p.trx.kind == tsim.solver_p.try_.kind == 'mat'
    jst, tst = jsim.initial_state(*fields), tsim.initial_state(*fields)
    dt = jsim.pick_dt(jsim.check(jst)[0])
    for _ in range(2):
        jst, _ = jsim.step(jst, dt)
        tst, _ = tsim.step(tst, dt)
    _compare(jst, tst)
