"""cales_torch's y-walled classes on a y-slab mesh (dims = (gy, 1)) on the
CPU, on gloo ranks of tests/_sharded_worker.py (the kernels' plain twins),
against the JAX package's single-device Simulation(use_pallas=False), f64,
from the seeded asymmetric start of tests/test_torch_sharded.py:

  * 2 steps at gy = 2 of the square duct with sgstype 'none', with static
    Smagorinsky and with the dynamic model's 'duct' average (bench.py's
    duct_les_dsmag), and of bench.py's cavity_les_dsmag (the 'cavity'
    average, the moving lid on v at the upper z wall), at the size of
    tests/test_torch_ywalls.py: u, v, w, nu_t within 1e-11, p within 1e-11
    after removing its mean, the kept planes vlo[1] (v's lower y face,
    rank 0's) and vlo[2] (w's lower z face, its y ghost rows the owners'),
    the CFL dt, divmax and bulk u as tests/test_torch_sharded.py holds
    them, and the kernels named; in the same spawn solve_sharded with
    Neumann y (the singular lane (lamx, lamy) = (0, 0) of the y 'NN'
    transform, pinned on rank 0) against JAX poisson.solve within 1e-11
    after removing the mean;
  * what unsupported() runs and refuses on the mesh with y walls.

The smag duct at gy = 4, whose middle slabs' van Driest reads walls they
do not hold, and the twins' slab modes are in
tests/test_torch_sharded_ywalls_twins.py.
"""
import numpy as np
import pytest

from cales_torch import poisson
from cales_torch.config import Config
from cales_torch.grid import make_grid_from_config
from cales_torch.timeloop import unsupported

from test_torch_sharded import (_check_steps, _gauge, _jax_solve,
                                _jax_steps, _solve_case, _spawn)
from test_torch_sharded_imp import _bulk
from test_torch_ywalls import CAVITY, DUCT

# bench.py's duct and cavity classes at tests/test_torch_ywalls.py's size
# (ny = 12: slabs of 6 rows at gy = 2, 3 at gy = 4)
CASES = {'duct_none': dict(DUCT, sgstype='none'),
         'duct_smag': dict(DUCT, sgstype='smag'),
         'duct_dsmag': DUCT, 'cavity_dsmag': CAVITY}
TOL = 1e-11


def run_cases(tmp_path, gy, refs, cases=(), inputs=None):
    """Spawn gy ranks on the cases refs = {key: (kw, (fields, dt, jst,
    jchk))} (and the other cases given with their inputs) and hold each
    to its reference; returns the worker's output."""
    cases, inputs = list(cases), dict(inputs or {})
    for key, (kw, (fields, dt, _, _)) in refs.items():
        assert unsupported(Config(**kw, dims=(gy, 1))) == [], key
        for q, f in zip('uvwp', fields):
            inputs[f'{key}.{q}'] = f
        inputs[f'{key}.dt'] = np.array(dt)
        cases.append({'kind': 'steps', 'key': key, 'ng': kw['ng'],
                      'cfg': {**kw, 'dims': (gy, 1)}, 'nsteps': 2})
    out, work = _spawn(tmp_path, gy, cases, inputs)
    for key, (kw, (_, _, jst, jchk)) in refs.items():
        bulk = 1.0 if any(kw.get('is_forced', ())) else _bulk(kw, jst)
        _check_steps(out, key, jst, jchk, kw, work, 2, bulk=bulk)
        for m in (1, 2):
            err = np.abs(out[f'{key}.vlo{m}'] - np.asarray(jst.vlo[m])).max()
            assert err <= TOL, f'{key} vlo[{m}]: {err:.3e}'
        names = list(out[f'{key}.names'])
        assert ('dsmag' in names) == (kw['sgstype'] == 'dsmag'), key
    return out


def test_duct_and_cavity_steps_match_one_device(tmp_path):
    refs = {key: (kw, _jax_steps(kw, 2)) for key, kw in CASES.items()}
    rhs = _solve_case(DUCT, np.random.default_rng(5))
    out = run_cases(tmp_path, 2, refs,
                    [{'kind': 'solve', 'key': 's', 'ng': DUCT['ng'],
                      'cfg': {**DUCT, 'dims': (2, 1)}}], {'s.rhs': rhs})
    assert np.abs(_gauge(out['s.p']) - _gauge(_jax_solve(DUCT, rhs))
                  ).max() <= TOL
    # the pinned lane: y mode 0 of the Neumann transform and x mode 0,
    # both of eigenvalue 0, x mode 0 among rank 0's lanes
    cfg = Config(**DUCT, dims=(2, 1))
    sv = poisson.make_solver(cfg, make_grid_from_config(cfg),
                             tuple(cfg.cbc_pre(d) for d in range(3)),
                             ('c', 'c', 'c'))
    assert sv.bcy == 'NN' and sv.try_.kind == 'mat'
    assert sv.lamy[0] == 0.0 and sv.lamx[0] == 0.0
    assert np.all(sv.lamy[1:] < 0.0) and np.all(sv.lamx[1:] < 0.0)


@pytest.mark.parametrize('gy', [2, 4])
def test_mesh_runs_the_duct_and_cavity_classes(gy):
    """bench.py's duct_les_dsmag and cavity_les_dsmag (their grid and
    float32), and the 'none' and smag ducts, run on dims (gy, 1)."""
    assert unsupported(Config(**_WM_DUCT, dims=(gy, 1))) == []
    import bench
    cfgs = bench._matrix_configs((512, 256, 256))
    for key in ('duct_les_dsmag', 'cavity_les_dsmag'):
        assert unsupported(Config(**cfgs[key], dims=(gy, 1))) == [], key
    duct = cfgs['duct_les_dsmag']
    for sgs in ('none', 'smag'):
        assert unsupported(Config(**{**duct, 'sgstype': sgs},
                                  dims=(gy, 1))) == [], sgs
    # the 'channel' and 'dit' averages with y walls (the duct example's)
    for avg in ('channel', 'dit'):
        assert unsupported(Config(**{**duct, 'dsmag_avg': avg},
                                  dims=(gy, 1))) == [], avg


_WM_DUCT = dict(DUCT, sgstype='smag', lwm=((0, 1, 1), (0, 1, 1)), hwm=0.2,
                cbcsgs=(('P', 'D', 'D'),) * 2)


@pytest.mark.parametrize('change, env, needle', [
    # the duct WMLES (it runs on the mesh,
    # tests/test_torch_sharded_wmduct.py): its y faces' rows 4 from the
    # walls (hwm 0.6) off slabs of 3 rows, and with full-3D implicit
    # diffusion
    (dict(_WM_DUCT, hwm=0.6), {}, 'a sampled y row off its owning slab'),
    (dict(_WM_DUCT, impdiff=True), {},
     'a wall model with implicit diffusion'),
    (dict(DUCT, filter_2d=True), {},
     'the 2D test filter (filter_2d) with y walls'),
    (dict(DUCT, scalar=True, impdiff=True), {},
     'full-3D implicit diffusion with y walls'),
    # the mixed route runs on the mesh; the thin slabs stay refused on it
    (dict(DUCT, ptransform='fft', ng=(16, 4, 10)), {},
     'with y walls: slabs of 1 y row'),
    (dict(DUCT, ng=(16, 4, 10)), {}, 'with y walls: slabs of 1 y row'),
])
def test_mesh_refuses_what_the_walled_slab_does_not_run(monkeypatch, change,
                                                        env, needle):
    for k, val in env.items():
        monkeypatch.setenv(k, val)
    missing = unsupported(Config(**change, dims=(4, 1)))
    assert any(needle in m for m in missing), missing
