"""The slices end to end: cales_torch's Simulation on the CPU (the kernels'
plain twins) against cales_tpu's Simulation on its XLA expression path
(use_pallas=False), fp64, at (nx, ny, nz) = (32, 16, 16), for
  * the headline channel-LES physics (static Smagorinsky + van Driest,
    periodic x/y, no-slip z walls on a stretched grid, bulk forcing
    along x),
  * the implicit-CN channel DNS (bench.py's channel_dns_impdiff: sgstype
    'none', z diffusion implicit, ptransform 'mat'), and its explicit
    twin,
  * the dynamic-Smagorinsky channel (validation/dsmag_channel.py:
    'channel' averaging, 'mat', impdiff_1d and explicit), and the static-
    Smagorinsky LES with impdiff_1d (nu_t from the smag kernel);
and the DNS against cales_tpu's Pallas kernel path in interpret mode.
Each package gets its own Config, built from the same arguments.

Tolerances: u, v, w 1e-11; p 1e-10 after removing its mean (the solve
projects out the constant mode, so p is defined up to a gauge); nu_t
1e-12 where the projection kernel makes it, 1e-10 relative to its
maximum where the SGS stage does (the dynamic model's ratio of plane
sums, the van Driest factor's exp); against the kernel path (the same
kernel formulas on both sides) 1e-12.  The dead vlo planes along periodic
x/y are not compared."""
import numpy as np
import pytest
import torch

import jax

from cales_tpu.config import Config as JaxConfig
from cales_tpu.grid import make_grid_from_config as jax_grid
from cales_tpu.initflow import initflow
from cales_tpu.timeloop import Simulation as JaxSimulation

from cales_torch import params
from cales_torch.config import Config
from cales_torch.grid import make_grid_from_config
from cales_torch.timeloop import Simulation, unsupported

torch.set_num_threads(1)

HEADLINE = dict(ng=(32, 16, 16), l=(2 * np.pi, np.pi, 2.0), gtype=1, gr=1.0,
                visci=20_000.0, inivel='log', is_wallturb=True,
                is_forced=(True, False, False), velf=(1.0, 0.0, 0.0),
                sgstype='smag', dtype='float64', ptransform='fft')
TOL = {'u': 1e-11, 'v': 1e-11, 'w': 1e-11, 'p': 1e-10, 'visct': 1e-12}
# bench.py _matrix_configs 'channel_dns_impdiff' at a test size
DNS = dict(ng=(32, 16, 16), l=(2 * np.pi, np.pi, 2.0), gtype=1, gr=1.0,
           visci=5640.0, inivel='log', is_wallturb=True,
           is_forced=(True, False, False), velf=(1.0, 0.0, 0.0),
           sgstype='none', impdiff=True, impdiff_1d=True, dtype='float64',
           ptransform='mat',
           cbcvel=((('P', 'P', 'P'), ('P', 'P', 'P'), ('D', 'D', 'D')),) * 2,
           cbcpre=(('P', 'P', 'N'), ('P', 'P', 'N')),
           cbcsgs=(('P', 'P', 'D'), ('P', 'P', 'D')))
# validation/dsmag_channel.py:77-89 at a test size
DSMAG = dict(DNS, l=(12.8, 4.8, 2.0), gr=5.0, visci=10_000.0, inivel='poi',
             sgstype='dsmag', dsmag_avg='channel')
TRIPERIODIC = dict(cbcvel=((('P',) * 3,) * 3,) * 2, cbcpre=(('P',) * 3,) * 2,
                   cbcsgs=(('P',) * 3,) * 2)


def _sims(kw, use_pallas=False):
    """The JAX and the port Simulation of one configuration, each from its
    own package's Config, with the initial fields."""
    jcfg = JaxConfig(**kw, use_pallas=use_pallas)
    jgrid = jax_grid(jcfg)
    tcfg = Config(**kw)
    return (JaxSimulation(jcfg, jgrid),
            Simulation(tcfg, make_grid_from_config(tcfg), device='cpu'),
            initflow(jcfg, jgrid))


@pytest.fixture(scope='module')
def pair():
    jsim, tsim, (u, v, w, p) = _sims(HEADLINE)
    jst = jsim.initial_state(u, v, w, p)
    dt = jsim.pick_dt(jsim.check(jst)[0])
    return jsim, tsim, (u, v, w, p), dt


def _compare(jstate, tstate, tol_all=None, rel=()):
    for name, tol in TOL.items():
        tol = tol if tol_all is None else tol_all
        a = np.asarray(getattr(jstate, name))
        b = getattr(tstate, name).numpy()
        if name == 'p':
            a, b = a - a.mean(), b - b.mean()
        err = np.abs(a - b).max()
        if name in rel:
            err /= np.abs(a).max()
            tol = 1e-10 if tol_all is None else tol_all
        assert err <= tol, f'{name}: {err:.3e} > {tol:.0e}'
    # the one live wall-face plane: w at the lower z wall
    np.testing.assert_allclose(tstate.vlo[2].numpy(),
                               np.asarray(jstate.vlo[2]), rtol=0,
                               atol=tol_all or 1e-11)


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
    for name in ('mom_rk', 'fillps', 'correc_smag'):
        assert name in path
    assert 'torch.fft' in path


@pytest.mark.parametrize('change,missing', [
    (dict(impdiff=True, sgstype='none',
          cbcvel=((('P', 'P', 'P'), ('D', 'D', 'D'), ('D', 'D', 'D')),) * 2,
          cbcpre=(('P', 'N', 'N'),) * 2, cbcsgs=(('P', 'D', 'D'),) * 2),
     'full-3D implicit diffusion'),
    (dict(lwm=((0, 0, 1), (0, 0, 1)), hwm=0.1, impdiff=True,
          impdiff_1d=True), 'wall model'),
    (dict(sgstype='dsmag', dsmag_avg='duct', impdiff=True, impdiff_1d=True,
          cbcvel=((('P', 'P', 'P'), ('D', 'D', 'D'), ('D', 'D', 'D')),) * 2,
          cbcpre=(('P', 'N', 'N'),) * 2, cbcsgs=(('P', 'D', 'D'),) * 2),
     'duct'),
    (dict(sgstype='dsmag', dsmag_avg='cavity', is_forced=(False,) * 3,
          cbcvel=((('D', 'D', 'D'),) * 3,) * 2,
          cbcpre=(('N', 'N', 'N'),) * 2, cbcsgs=(('D', 'D', 'D'),) * 2),
     'cavity'),
    (dict(sgstype='dsmag', dsmag_avg='duct', filter_2d=True,
          cbcvel=((('P', 'P', 'P'), ('D', 'D', 'D'), ('D', 'D', 'D')),) * 2,
          cbcpre=(('P', 'N', 'N'),) * 2, cbcsgs=(('P', 'D', 'D'),) * 2),
     'filter_2d with y walls'),
    (dict(sgstype='dsmag', filter_2d=True,
          bcvel=(((0.0,) * 3, (0.0,) * 3, (0.0, 0.0, 0.003)),) * 2),
     'filter_2d by two passes'),
    (dict(is_forced=(True, False, True), velf=(1.0, 0.0, 0.1)),
     'forcing along z with z walls'),
    (dict(sgstype='dsmag', dsmag_avg='duct', gr=0.0, **TRIPERIODIC),
     "'duct' average with periodic z"),
    (dict(sgstype='dsmag', dsmag_avg='cavity', filter_2d=True),
     "'cavity' average with periodic z or the 2D test filter"),
    (dict(sgstype='dsmag', lwm=((0, 0, 1), (0, 0, 1)), hwm=0.1),
     'wall model'),
    (dict(sgstype='dsmag',
          cbcvel=((('P', 'P', 'P'), ('D', 'D', 'D'), ('D', 'D', 'D')),) * 2,
          cbcpre=(('P', 'N', 'N'),) * 2, cbcsgs=(('P', 'D', 'D'),) * 2,
          bcvel=(((0.,) * 3, (0., 0.1, 0.), (0.,) * 3), ((0.,) * 3,) * 3)),
     'non-zero v'),
    (dict(cbcvel=((('P', 'P', 'P'), ('D', 'D', 'D'), ('D', 'D', 'D')),) * 2,
          cbcpre=(('P', 'N', 'N'),) * 2), 'non-periodic y'),
    # the scalar on a mesh takes the letters one device admits
    (dict(scalar=True, dims=(2, 1),
          cbcscal=(('P', 'N', 'N'), ('P', 'N', 'N'))), 'scalar'),
    # this 'fft' LES runs on the y-slab mesh (test_torch_sharded_fft.py)
    # and on the pencil mesh (test_torch_pencil_steps.py), and so do the
    # one-pass dsmag (test_torch_pencil_dsmag.py) and its 2D test filter
    # (test_torch_pencil_twopass.py), and the one-pass dsmag duct
    # (test_torch_pencil_ydsmag.py); the two passes with y walls (the
    # duct with transpiring z walls) on the pencil mesh stay refused
    (dict(dims=(2, 2), sgstype='dsmag', dsmag_avg='duct',
          cbcvel=((('P', 'P', 'P'), ('D', 'D', 'D'), ('D', 'D', 'D')),) * 2,
          cbcpre=(('P', 'N', 'N'),) * 2, cbcsgs=(('P', 'D', 'D'),) * 2,
          bcvel=(((0.0,) * 3, (0.0,) * 3, (0.0, 0.0, 0.003)),) * 2),
     'mesh'),
    (dict(sgstype='none', cbcvel=((('P', 'P', 'P'), ('D', 'D', 'D'),
                                   ('P', 'P', 'P')),) * 2,
          cbcpre=(('P', 'N', 'P'),) * 2, cbcsgs=(('P', 'D', 'P'),) * 2),
     'periodic z with y walls'),
    (dict(lwm=((0, 0, 1), (0, 0, 1)), hwm=0.1, impdiff=True),
     'wall model with implicit diffusion'),
    # the duct WMLES on four slabs of 4 rows, its y faces' rows 6 from
    # the walls (hwm 1.2): off the walls' slabs
    (dict(lwm=((0, 1, 1), (0, 1, 1)), hwm=1.2, dims=(4, 1), ptransform='mat',
          cbcvel=((('P', 'P', 'P'), ('D', 'D', 'D'), ('D', 'D', 'D')),) * 2,
          cbcpre=(('P', 'N', 'N'),) * 2, cbcsgs=(('P', 'D', 'D'),) * 2),
     'wall model on a device mesh'),
    (dict(lwm=((0, 1, 0), (0, 1, 0)), hwm=0.1), 'wall model on y faces'),
    (dict(lwm=((1, 0, 0), (1, 0, 0)), hwm=0.1), 'wall model on x faces'),
])
def test_configs_outside_the_slice_raise(change, missing):
    cfg = Config(**{**HEADLINE, **change})
    grid = make_grid_from_config(cfg)
    assert any(missing in m for m in unsupported(cfg))
    with pytest.raises(NotImplementedError, match='outside the ported slice'):
        Simulation(cfg, grid, device='cpu')


@pytest.mark.parametrize('change,path', [
    (dict(sgstype='dsmag', dsmag_avg='dit'), "'dit' average"),
    (dict(sgstype='dsmag', filter_2d=True), '2D test filter'),
    (dict(gr=0.0, **TRIPERIODIC), 'no van Driest'),
    (dict(sgstype='none', gr=0.0, is_forced=(False, False, True),
          velf=(0.0, 0.0, 1.0), **TRIPERIODIC), 'periodic z'),
    (dict(sgstype='dsmag', gr=0.0, **TRIPERIODIC), 'periodic-z mode'),
])
def test_box_les_and_z_forcing_configs_are_in_the_slice(change, path):
    """The configurations this test file once held outside the slice
    (the 'dit' average, the 2D test filter, static and dynamic Smagorinsky
    on the triperiodic box, forcing along z): accepted now; their steps
    are held to cales_tpu in tests/test_torch_box_les_step.py,
    test_torch_box_forcing_step.py and test_torch_dsmag_dit_step.py."""
    cfg = Config(**{**HEADLINE, **change})
    assert unsupported(cfg) == []
    sim = Simulation(cfg, make_grid_from_config(cfg), device='cpu')
    assert path in sim.exec_path()


def test_headline_config_is_in_the_slice():
    assert unsupported(Config(**HEADLINE)) == []


@pytest.mark.parametrize('change', [
    dict(sgstype='none'), dict(ptransform='mat'), dict(zsolver='thomas'),
    dict(impdiff=True, impdiff_1d=True, sgstype='none'),
    dict(sgstype='dsmag'), dict(sgstype='dsmag', impdiff=True,
                                impdiff_1d=True),
    dict(impdiff=True, impdiff_1d=True),
    dict(impdiff=True), dict(impdiff=True, sgstype='none'),
    dict(impdiff=True, sgstype='dsmag'),
    dict(sgstype='none', gr=0.0, is_forced=(False,) * 3, **TRIPERIODIC),
    dict(sgstype='none', gr=0.0, impdiff=True, **TRIPERIODIC),
    dict(sgstype='none', gr=0.0, impdiff=True, impdiff_1d=True,
         **TRIPERIODIC),
    dict(lwm=((0, 0, 1), (0, 0, 1)), hwm=0.1),
    dict(lwm=((0, 0, -1), (0, 0, 0)), hwm=0.1, ptransform='mat'),
    dict(lwm=((0, 0, 0), (0, 0, 1)), hwm=0.1, sgstype='none')])
def test_configs_inside_the_slice_build(change):
    """Configurations the implicit-CN, the SGS, the triperiodic and the
    wall-model slices brought in (full-3D implicit diffusion on the
    channel, the triperiodic DNS explicit or implicit, the z faces' wall
    model): no refusal, and the Simulation builds."""
    cfg = Config(**{**HEADLINE, **change})
    assert unsupported(cfg) == []
    Simulation(cfg, make_grid_from_config(cfg), device='cpu')


# ------------------------------------------------------- the channel DNS

@pytest.mark.parametrize('case', ['impdiff_1d', 'explicit'])
def test_dns_matches_jax_for_three_steps(case):
    change = {} if case == 'impdiff_1d' else dict(impdiff=False,
                                                  impdiff_1d=False)
    jsim, tsim, fields = _sims({**DNS, **change})
    jst, tst = jsim.initial_state(*fields), tsim.initial_state(*fields)
    dt = jsim.pick_dt(jsim.check(jst)[0])
    for _ in range(3):
        jst, jd = jsim.step(jst, dt)
        tst, td = tsim.step(tst, dt)
        _compare(jst, tst)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0,
                                   atol=1e-12)
    for a, b in zip(tsim.check(tst), jsim.check(jst)):
        assert abs(a - b) <= 1e-12 * max(1.0, abs(b))
    path = tsim.exec_path()
    assert 'correc_updatep' in path and 'apply_y' in path
    assert ('thomas_z' in path) == (case == 'impdiff_1d')


def test_dns_matches_jax_kernel_path(monkeypatch):
    """cales_tpu's Pallas kernel path (interpret mode) with the x-transform
    fusion off, the branch the port takes: apply_y with MxT, apply_z_eig,
    the Thomas Helmholtz pass with the forcing shift, and
    fused_correc_updatep with alpha Lz(pp)."""
    monkeypatch.setenv('CALES_PALLAS_INTERPRET', '1')
    monkeypatch.setenv('CALES_NO_FUSE_XOP', '1')
    jsim, tsim, fields = _sims({**DNS, 'ng': (128, 16, 16)},
                               use_pallas=True)
    assert jsim.use_pallas_mom and jsim.use_pallas_solve
    assert jsim.use_pallas_cn and jsim._cn_fold and jsim._cn_shift_forcing
    assert not jsim._fuse_xop
    jst, tst = jsim.initial_state(*fields), tsim.initial_state(*fields)
    dt = jsim.pick_dt(jsim.check(jst)[0])
    for _ in range(3):
        jst, _ = jsim.step(jst, dt)
        tst, _ = tsim.step(tst, dt)
    _compare(jst, tst, tol_all=1e-12)


def test_dns_state_carried_across_from_jax():
    jsim, tsim, fields = _sims(DNS)
    jst = jsim.initial_state(*fields)
    dt = jsim.pick_dt(jsim.check(jst)[0])
    for _ in range(2):
        jst, _ = jsim.step(jst, dt)
    leaves = dict(u=jst.u, v=jst.v, w=jst.w, p=jst.p, visct=jst.visct,
                  vlo=jst.vlo, rhs_old=jst.rhs_old, zq=jst.zq,
                  time=jst.time, istep=jst.istep)
    tst = params.state_from_jax_numpy(
        jax.tree_util.tree_map(np.asarray, leaves), 'cpu', torch.float64)
    for _ in range(2):
        jst, _ = jsim.step(jst, dt)
        tst, _ = tsim.step(tst, dt)
    _compare(jst, tst)


@pytest.mark.parametrize('name,impdiff', [
    ('couette', True), ('half_channel', True), ('periodic_channel', False),
    ('temporal_boundary_layer', False),
    ('turbulent_channel_constant_pressure_gradient', True),
    ('turbulent_channel_convective_reference_frame', False)])
def test_example_namelists_in_the_slice_match_jax(name, impdiff):
    """The shipped examples the slice now runs (sgstype 'none': moving
    walls, Neumann tops, constant pressure gradient, a moving frame), at
    (32, 16, 16) with and without z-implicit diffusion, 2 steps against
    cales_tpu's XLA path."""
    from pathlib import Path
    from cales_tpu.nml import config_from_nml as jax_nml
    from cales_torch.nml import config_from_nml
    nml = Path(__file__).resolve().parents[1] / 'examples' / name / 'input.nml'
    change = dict(ng=(32, 16, 16), impdiff=impdiff, impdiff_1d=impdiff)
    jcfg = jax_nml(nml, dtype='float64').replace(use_pallas=False, **change)
    tcfg = config_from_nml(nml, dtype='float64').replace(**change)
    assert unsupported(tcfg) == []
    jgrid = jax_grid(jcfg)
    fields = initflow(jcfg, jgrid)
    jsim = JaxSimulation(jcfg, jgrid)
    tsim = Simulation(tcfg, make_grid_from_config(tcfg), device='cpu')
    jst, tst = jsim.initial_state(*fields), tsim.initial_state(*fields)
    dt = jsim.pick_dt(jsim.check(jst)[0])
    for _ in range(2):
        jst, jd = jsim.step(jst, dt)
        tst, td = tsim.step(tst, dt)
    _compare(jst, tst)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0,
                               atol=1e-11)


# ------------------------------------------ the SGS slice: dsmag, smag + CN

SGS_CASES = {
    'dsmag_impdiff_1d': DSMAG,
    'dsmag_explicit': dict(DSMAG, impdiff=False, impdiff_1d=False),
    'smag_impdiff_1d': dict(HEADLINE, impdiff=True, impdiff_1d=True,
                            ptransform='mat'),
}


@pytest.mark.parametrize('case', sorted(SGS_CASES))
def test_sgs_slice_matches_jax_for_three_steps(case):
    """nu_t from the SGS stage after the post-correction fill (the dsmag
    or smag kernel's twin), the initial nu_t from sgs.dsmag_visct /
    smag_visct."""
    jsim, tsim, fields = _sims(SGS_CASES[case])
    jst, tst = jsim.initial_state(*fields), tsim.initial_state(*fields)
    _compare(jst, tst, rel=('visct',))
    dt = jsim.pick_dt(jsim.check(jst)[0])
    for _ in range(3):
        jst, jd = jsim.step(jst, dt)
        tst, td = tsim.step(tst, dt)
        _compare(jst, tst, rel=('visct',))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0,
                                   atol=1e-11)
    assert float(tst.visct.max()) > 0 and float(tst.visct.min()) >= 0
    for a, b in zip(tsim.check(tst), jsim.check(jst)):
        assert abs(a - b) <= 1e-10 * max(1.0, abs(b))
    kernel = 'dsmag' if case.startswith('dsmag') else 'smag'
    assert kernel in tsim.kernel_names()
    assert 'correc_smag' not in tsim.kernel_names()


def test_dsmag_state_carried_across_from_jax():
    """A JAX dsmag state after 2 steps (with its nu_t), carried into the
    port, steps on to the same state."""
    jsim, tsim, fields = _sims(DSMAG)
    jst = jsim.initial_state(*fields)
    dt = jsim.pick_dt(jsim.check(jst)[0])
    for _ in range(2):
        jst, _ = jsim.step(jst, dt)
    leaves = dict(u=jst.u, v=jst.v, w=jst.w, p=jst.p, visct=jst.visct,
                  vlo=jst.vlo, rhs_old=jst.rhs_old, zq=jst.zq,
                  time=jst.time, istep=jst.istep)
    tst = params.state_from_jax_numpy(
        jax.tree_util.tree_map(np.asarray, leaves), 'cpu', torch.float64)
    np.testing.assert_array_equal(tst.visct.numpy(), np.asarray(jst.visct))
    for _ in range(2):
        jst, _ = jsim.step(jst, dt)
        tst, _ = tsim.step(tst, dt)
    _compare(jst, tst, rel=('visct',))


# --------------------------------------- the wall-modelled channel LES

WMLES = dict(HEADLINE, visci=125_000.0, ptransform='mat',
             lwm=((0, 0, 1), (0, 0, 1)), hwm=0.1)
WM_VARIANTS = {
    'lower face only': dict(WMLES, lwm=((0, 0, 1), (0, 0, 0))),
    'laminar': dict(WMLES, lwm=((0, 0, -1), (0, 0, -1)), visci=2000.0),
    'none': dict(WMLES, sgstype='none'),
}


@pytest.mark.parametrize('case', sorted(WM_VARIANTS))
def test_wmles_variants_match_jax_for_three_steps(case):
    """The wall model on the lower face only (the upper face a no-slip
    wall: its 'D' ghost recipe beside the 'E' one), the laminar model on
    both, and sgstype 'none' (correc_updatep, the post-correction fill's
    planes): 3 steps against cales_tpu's XLA path.  The bench class itself
    is in tests/test_torch_wallmodel.py."""
    jsim, tsim, fields = _sims(WM_VARIANTS[case])
    assert tsim.has_wm and 'wallmodel' in tsim.kernel_names()
    jst, tst = jsim.initial_state(*fields), tsim.initial_state(*fields)
    _compare(jst, tst)
    dt = jsim.pick_dt(jsim.check(jst)[0])
    for _ in range(3):
        jst, jd = jsim.step(jst, dt)
        tst, td = tsim.step(tst, dt)
        _compare(jst, tst)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0,
                                   atol=1e-11)
    for a, b in zip(tsim.check(tst), jsim.check(jst)):
        assert abs(a - b) <= 1e-12 * max(1.0, abs(b))
