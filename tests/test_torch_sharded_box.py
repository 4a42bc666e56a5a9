"""The triperiodic box on a y-slab mesh (dims = (gy, 1)) on the CPU, on gloo
ranks of tests/_sharded_worker.py (the kernels' plain twins), against the
JAX package's single-device Simulation(use_pallas=False), f64, from the
seeded asymmetric start of tests/test_torch_sharded.py, at the size of
tests/test_torch_triperiodic.py's Taylor-Green vortex (16^3, 'mat'):

  * 2 steps at gy = 2 of the DNS (bench.py's triperiodic_dns), the box
    LES with static Smagorinsky (no wall: no van Driest), the box LES with
    dynamic Smagorinsky ('dit': the dsmag kernel's periodic-z mode on a
    slab, ZP + YH) and the smag box forced along z (the bulk mean of w
    summed over the ranks): u, v, w, nu_t within 1e-11, p within 1e-11
    after removing its mean (the sharded z stage is the pinned periodic
    Thomas), the CFL dt, divmax, bulk u (the reference's), and the
    kernels named; in the same spawn solve_sharded with periodic z against
    JAX poisson.solve within 1e-11 after removing the mean;
  * the singular lane (lamx, lamy, lamz) = (0, 0, 0) pinned on the rank
    whose slice of lamx holds it, whatever that order;
  * what unsupported() runs on the mesh (bench.py's six classes, the
    wall-modelled duct example, and the classes with a passive scalar, by
    the two-pass dynamic Smagorinsky, with the 2D test filter, with
    full-3D implicit diffusion, the box with impdiff_1d, the developing
    channel example and its LES, the closed box, the lid-driven cavity
    and the developing duct examples, the developing WMLES with its
    1/7-power inflow profile, the developing channel with a scalar and the
    x+y-walled scalar of tests/test_sharding_paths.py:735, at dims (2, 1)
    and (4, 1)) and what it still refuses (ptransform 'fft' with x walls;
    x walls with dsmag, an inflow profile with y walls, full-3D implicit
    diffusion with y walls).
"""
import numpy as np
import pytest
import torch

from cales_torch import poisson
from cales_torch.config import Config
from cales_torch.grid import make_grid_from_config
from cales_torch.nml import config_from_nml
from cales_torch.timeloop import unsupported

from test_torch_sharded import (ROOT, XDEV_BCS, XDUCT_BCS, _check_steps,
                                _gauge,
                                _jax_solve, _jax_steps, _solve_case, _spawn)
from test_torch_sharded_imp import _bulk
from test_torch_triperiodic import TGV

torch.set_num_threads(1)

BOX = dict(TGV, ptransform='mat')
CASES = {'tri': BOX, 'tri_smag': dict(BOX, sgstype='smag'),
         'tri_dsmag': dict(BOX, sgstype='dsmag', dsmag_avg='dit'),
         'tri_smag_fz': dict(BOX, sgstype='smag',
                             is_forced=(False, False, True),
                             velf=(0.0, 0.0, 0.1))}
TOL = 1e-11


@pytest.fixture(scope='module')
def refs():
    return {key: (kw, _jax_steps(kw, 2)) for key, kw in CASES.items()}


def test_box_steps_and_solve_match_one_device(tmp_path, refs):
    gy = 2
    cases, inputs = [], {}
    for key, (kw, (fields, dt, _, _)) in refs.items():
        assert unsupported(Config(**kw, dims=(gy, 1))) == [], key
        for q, f in zip('uvwp', fields):
            inputs[f'{key}.{q}'] = f
        inputs[f'{key}.dt'] = np.array(dt)
        cases.append({'kind': 'steps', 'key': key, 'ng': kw['ng'],
                      'cfg': {**kw, 'dims': (gy, 1)}, 'nsteps': 2})
    rhs = _solve_case(BOX, np.random.default_rng(9))
    cases.append({'kind': 'solve', 'key': 's', 'ng': BOX['ng'],
                  'cfg': {**BOX, 'dims': (gy, 1)}})
    inputs['s.rhs'] = rhs
    out, work = _spawn(tmp_path, gy, cases, inputs)
    for key, (kw, (_, _, jst, jchk)) in refs.items():
        _check_steps(out, key, jst, jchk, kw, work, 2, bulk=_bulk(kw, jst),
                     zthomas='thomas_periodic')
        names = list(out[f'{key}.names'])
        assert ('dsmag' in names) == (kw['sgstype'] == 'dsmag'), key
        assert 'wallmodel' not in names
    # forced along z: the bulk w (uniform z) is the forced value
    assert abs(out['tri_smag_fz.w'].mean()
               - CASES['tri_smag_fz']['velf'][2]) <= 1e-12
    err = np.abs(_gauge(out['s.p']) - _gauge(_jax_solve(BOX, rhs))).max()
    assert err <= TOL, f'solve_sharded, periodic z: {err:.3e}'


@pytest.mark.parametrize('gy', [2, 4])
def test_singular_lane_pinned_on_the_rank_that_holds_it(gy):
    cfg = Config(**BOX, dims=(gy, 1))
    sv = poisson.make_solver(cfg, make_grid_from_config(cfg),
                             tuple(cfg.cbc_pre(d) for d in range(3)),
                             ('c', 'c', 'c'))
    assert sv.bcz == 'PP'
    tol = poisson._thomas_tol(sv.lamx, sv.lamy, torch.float64)
    nxl = cfg.ng[0] // gy
    zero = int(np.argmin(np.abs(sv.lamx)))
    for lamx in (sv.lamx, sv.lamx[::-1]):
        where = int(np.argmin(np.abs(lamx))) // nxl
        holds = [poisson._holds_singular(lamx[r * nxl:(r + 1) * nxl],
                                         sv.lamy, tol) for r in range(gy)]
        assert holds == [r == where for r in range(gy)]
    assert abs(sv.lamx[zero]) <= tol and min(abs(sv.lamy)) <= tol


# the scalar of chip_smoke.py's phase 13 (s 0 and 1 on the z walls) and of
# its duct (13y: 1 and 0.5 on the y walls, N on the z walls)
_SCALAR = dict(scalar=True, pr=0.71, iniscal='zer',
               cbcscal=(('P', 'P', 'D'), ('P', 'P', 'D')),
               bcscal=((0.0, 0.0, 0.0), (0.0, 0.0, 1.0)))
_DUCT_SCALAR = dict(_SCALAR, cbcscal=(('P', 'D', 'N'), ('P', 'D', 'N')),
                    bcscal=((0.0, 1.0, 0.0), (0.0, 0.5, 0.0)))
_DSMAG_CHANNEL = dict(sgstype='dsmag', dsmag_avg='channel')
_BLOW = (((0.0,) * 3, (0.0,) * 3, (0.0, 0.0, 0.003)),) * 2
# name: (bench.py class, change, CALES_DSMAG_TWOPASS)
_MESH_CLASSES = {
    'les_scalar': ('channel_les_smag', _SCALAR, ''),
    'dsmag_duct_scalar': ('duct_les_dsmag', _DUCT_SCALAR, ''),
    'dsmag_blow': ('channel_les_smag', dict(_DSMAG_CHANNEL, bcvel=_BLOW), ''),
    'twopass_channel': ('channel_les_smag', _DSMAG_CHANNEL, '1'),
    'twopass_duct': ('duct_les_dsmag', {}, '1'),
    'twopass_cavity': ('cavity_les_dsmag', {}, '1'),
    'dsmag_filter_2d': ('channel_les_smag',
                        dict(_DSMAG_CHANNEL, filter_2d=True), ''),
    'box_filter_2d': ('triperiodic_dns', dict(sgstype='dsmag',
                                              dsmag_avg='dit',
                                              filter_2d=True), ''),
    'dns_impdiff_3d': ('channel_dns_impdiff', dict(impdiff_1d=False), ''),
    'box_impdiff_3d': ('triperiodic_dns', dict(impdiff=True), ''),
    'box_impdiff_1d': ('triperiodic_dns', dict(impdiff=True,
                                               impdiff_1d=True), ''),
    'les_scalar_3d': ('channel_les_smag', dict(_SCALAR, impdiff=True), '')}


def _example(name):
    return config_from_nml(str(ROOT / 'examples' / name / 'input.nml'))


def _xwmles():
    import chip_smoke
    return chip_smoke.xwmles_cfg()


def _xdev_scalar():
    return _example('developing_channel').replace(
        scalar=True, pr=0.71, iniscal='uni', ssource=0.02,
        cbcscal=(('D', 'P', 'N'), ('N', 'P', 'N')),
        bcscal=((1.0, 0.0, 0.0), (0.0, 0.0, 0.0)))


def _xy_scalar():
    # tests/test_sharding_paths.py:735 (its ng (128, 32, 16))
    return _example('developing_duct').replace(
        ng=(128, 32, 16), l=(2.0, 1.0, 1.0), visci=2000.0, inivel='uni',
        scalar=True, pr=0.71, iniscal='uni', ssource=0.02,
        cbcscal=(('D', 'D', 'N'), ('N', 'N', 'N')),
        bcscal=((1.0, 0.5, 0.0), (0.0, 0.0, 0.0)))


_XY_CLASSES = {
    'closed_box': lambda: _example('closed_box'),
    'lid_driven_cavity': lambda: _example('lid_driven_cavity'),
    'developing_duct': lambda: _example('developing_duct'),
    'developing_wmles': _xwmles,
    'developing_channel_scalar': _xdev_scalar,
    'xywalled_scalar': _xy_scalar}


@pytest.mark.parametrize('gy', [2, 4])
@pytest.mark.parametrize('name', ['triperiodic_dns', 'channel_dns_impdiff',
                                  'channel_les_smag', 'duct_les_dsmag',
                                  'cavity_les_dsmag', 'wmles_channel',
                                  'turbulent_duct_wmles',
                                  'developing_channel',
                                  'developing_channel_les',
                                  'closed_box', 'lid_driven_cavity',
                                  'developing_duct', 'developing_wmles',
                                  'developing_channel_scalar',
                                  'xywalled_scalar', *_MESH_CLASSES])
def test_mesh_runs_the_classes(name, gy, monkeypatch):
    """bench.py's six classes at 512x256x256, the wall-modelled duct
    example (512x80x80: its y faces' rows 3 and 4 from the wall on slabs of
    40 and 20 rows), the developing channel example at 512x256x256 and its
    LES (static Smagorinsky, impdiff_1d), and those classes with a passive
    scalar, by the two passes (transpiring z walls,
    CALES_DSMAG_TWOPASS=1), with the 2D test filter and with full-3D
    implicit diffusion (the box with impdiff_1d too), and the x-walled
    examples with y walls (closed_box, lid_driven_cavity, developing_duct
    at their 64^3), the developing WMLES with its 1/7-power inflow
    (chip_smoke.xwmles_cfg), the developing channel with chip_smoke.py's
    phase 13x scalar and tests/test_sharding_paths.py:735's x+y-walled
    scalar run on dims (gy, 1)."""
    if name in _XY_CLASSES:
        cfg = _XY_CLASSES[name]().replace(dims=(gy, 1))
    elif name == 'turbulent_duct_wmles':
        cfg = config_from_nml(
            str(ROOT / 'examples' / name / 'input.nml')).replace(
                dims=(gy, 1))
    elif name.startswith('developing_channel'):
        cfg = config_from_nml(
            str(ROOT / 'examples' / 'developing_channel' / 'input.nml')
        ).replace(ng=(512, 256, 256), dims=(gy, 1))
        if name.endswith('les'):
            cfg = cfg.replace(sgstype='smag', impdiff=True, impdiff_1d=True)
    else:
        import bench
        base, change, switch = _MESH_CLASSES.get(name, (name, {}, ''))
        monkeypatch.setenv('CALES_DSMAG_TWOPASS', switch)
        cfg = Config(**{**bench._matrix_configs((512, 256, 256))[base],
                        **change}, dims=(gy, 1))
    assert unsupported(cfg) == [], name


# a padded (nz+2, ny+2) inflow profile of u on the lower x face
_PROFILE = np.ones((BOX['ng'][2] + 2, BOX['ng'][1] + 2))


@pytest.mark.parametrize('change, needle', [
    # x walls with dsmag, an inflow profile with y walls (plane-valued
    # values with y walls), and full-3D implicit diffusion with y walls
    # (the duct's; each refused on one device too)
    (dict(XDEV_BCS, sgstype='dsmag', dsmag_avg='dit'),
     'non-periodic x with dynamic Smagorinsky'),
    (dict(XDUCT_BCS, bcvel=(((_PROFILE, 0.0, 0.0), (0.0,) * 3, (0.0,) * 3),
                            ((0.0,) * 3,) * 3)),
     'plane-valued values with y walls'),
    (dict(impdiff=True, cbcvel=((('P', 'P', 'P'), ('D', 'D', 'D'),
                                 ('D', 'D', 'D')),) * 2,
          cbcpre=(('P', 'N', 'N'),) * 2, cbcsgs=(('P', 'N', 'N'),) * 2),
     'full-3D implicit diffusion with y walls'),
    # 'fft' runs on the mesh with periodic x (the box's 'dit' LES,
    # test_torch_sharded_fft.py); there is no FFT along a walled x
    (dict(XDEV_BCS, ptransform='fft'), "non-periodic x with ptransform "
                                       "'fft'"),
])
def test_box_mesh_refusals(change, needle):
    missing = unsupported(Config(**{**BOX, **change}, dims=(2, 1)))
    assert any(needle in m for m in missing), missing
