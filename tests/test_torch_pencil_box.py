"""The triperiodic box on a 2D pencil mesh (dims = (gy, gx), gx > 1) on the
CPU, on gloo ranks of tests/_sharded_worker.py (the kernels' plain
twins), against the JAX package's single-device Simulation(use_pallas=
False), f64, from the seeded asymmetric start of tests/test_torch_sharded.py,
at the size of tests/test_torch_triperiodic.py's Taylor-Green vortex
(16^3):

  * solve_sharded with periodic z by 'mat' (the pinned periodic Thomas on
    the re-slab's lanes) and by 'fft' at dims (2, 2) against JAX
    poisson.solve within 1e-11 after removing the mean;
  * the singular lane pinned on exactly one of the world's P = gy gx
    slabs, rank 0's, on both routes;
  * 2 steps at dims (2, 2) of the DNS (bench.py's triperiodic_dns) by
    'mat' and by 'fft', the static-Smagorinsky LES (no wall: no van
    Driest) and the dynamic-Smagorinsky LES with 'dit' (dsmag's ZP x XH
    x YH mode's twin), and at (1, 2) of the DNS and the 'dit' LES: u, v,
    w, nu_t within 1e-11, p within 1e-11 after removing its mean, the CFL
    dt, divmax, bulk u (the reference's) and the kernels named.
"""
import numpy as np
import pytest
import torch

from cales_torch import poisson
from cales_torch.config import Config
from cales_torch.grid import make_grid_from_config
from cales_torch.parallel import mesh as meshmod
from cales_torch.timeloop import unsupported

from test_torch_sharded import (_check_steps, _gauge, _jax_solve,
                                _jax_steps, _solve_case, _spawn)
from test_torch_sharded_box import BOX
from test_torch_sharded_fft import _check_fft_steps
from test_torch_sharded_imp import _bulk

torch.set_num_threads(1)

CASES = {'tri': BOX, 'tri_fft': dict(BOX, ptransform='fft'),
         'tri_smag': dict(BOX, sgstype='smag'),
         'tri_dsmag': dict(BOX, sgstype='dsmag', dsmag_avg='dit')}
TOL = 1e-11


@pytest.fixture(scope='module')
def refs():
    return {key: (kw, _jax_steps(kw, 2)) for key, kw in CASES.items()}


def _run(tmp_path, dims, refs, keys, solves=()):
    cases, inputs = [], {}
    rng = np.random.default_rng(91)
    for route in solves:
        kw = dict(BOX, ptransform=route)
        inputs[f's_{route}.rhs'] = _solve_case(kw, rng)
        cases.append({'kind': 'solve', 'key': f's_{route}', 'ng': kw['ng'],
                      'dims': dims, 'cfg': {**kw, 'dims': dims}})
    for key in keys:
        kw, (fields, dt, _, _) = refs[key]
        assert unsupported(Config(**kw, dims=dims)) == [], key
        for q, f in zip('uvwp', fields):
            inputs[f'{key}.{q}'] = f
        inputs[f'{key}.dt'] = np.array(dt)
        cases.append({'kind': 'steps', 'key': key, 'ng': kw['ng'],
                      'dims': dims, 'cfg': {**kw, 'dims': dims},
                      'nsteps': 2})
    out, work = _spawn(tmp_path, dims[0] * dims[1], cases, inputs)
    for route in solves:
        kw = dict(BOX, ptransform=route)
        err = np.abs(_gauge(out[f's_{route}.p'])
                     - _gauge(_jax_solve(kw, inputs[f's_{route}.rhs']))).max()
        assert err <= TOL, f'solve_sharded {route}, periodic z: {err:.3e}'
    for key in keys:
        kw, (_, _, jst, jchk) = refs[key]
        if kw['ptransform'] == 'fft':
            _check_fft_steps(out, key, kw, jst, jchk, work)
        else:
            _check_steps(out, key, jst, jchk, kw, work, 2,
                         bulk=_bulk(kw, jst), zthomas='thomas_periodic')
        names = list(out[f'{key}.names'])
        assert ('dsmag' in names) == (kw['sgstype'] == 'dsmag'), key
        assert ('smag' in names) == (kw['sgstype'] == 'smag'), key


def test_box_solves_and_steps_on_2x2_pencils(tmp_path, refs):
    _run(tmp_path, (2, 2), refs, tuple(CASES), solves=('mat', 'fft'))


def test_box_steps_on_1x2_pencils(tmp_path, refs):
    _run(tmp_path, (1, 2), refs, ('tri', 'tri_dsmag'))


@pytest.mark.parametrize('route', ['mat', 'fft'])
def test_singular_lane_on_one_of_the_world_slabs(route):
    """The re-slab's P = gy gx slabs (mesh.slab) of dims (2, 2): exactly
    one holds the singular lane (kx, ky) = (0, 0), rank 0, by the
    tolerance of the whole spectrum, as poisson._z_thomas pins it."""
    cfg = Config(**{**BOX, 'ptransform': route}, dims=(2, 2))
    sv = poisson.make_solver(cfg, make_grid_from_config(cfg),
                             tuple(cfg.cbc_pre(d) for d in range(3)),
                             ('c', 'c', 'c'))
    assert sv.bcz == 'PP'
    tol = poisson._thomas_tol(sv.lamx, sv.lamy, torch.float64)
    P = 4
    holds = []
    for r in range(P):
        slab = meshmod.SlabMesh.__new__(meshmod.SlabMesh)
        slab.gy, slab.rank = P, r
        if route == 'mat':
            nxl = cfg.ng[0] // P
            lam = sv.lamx[r * nxl:(r + 1) * nxl]
        else:
            lam = poisson.fft_slab_lamx(sv, slab)
        holds.append(poisson._holds_singular(lam, sv.lamy, tol))
    assert holds == [True, False, False, False], holds
