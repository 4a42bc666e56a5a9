"""ptransform 'fft' on a y-slab mesh (dims = (gy, 1)) on the CPU, on gloo
ranks of tests/_sharded_worker.py (the kernels' plain twins), against the
JAX package's single-device XLA solve and Simulation(use_pallas=False),
f64, from the seeded asymmetric start of tests/test_torch_sharded.py:

  * solve_sharded by 'fft' at gy = 2 and 4 on nx = 16 (9 lanes of the half
    spectrum: 5 a rank at gy = 2, 3 at gy = 4, the last rank's tail dead):
    the Poisson solve with z walls (the eigen and the Thomas z stage) and
    with periodic z, u's Helmholtz solve and w's with its face-staggered
    Dirichlet tail row, and the mixed route's Poisson solve (y walls: the
    y DCT on the rfft's lanes), against JAX poisson.solve on one device
    within 1e-11 and against the port's one-device 'fft' solve within
    1e-13, p after removing its mean;
  * 2 steps at gy = 2 of the LES channel, the box with dsmag 'dit', the
    full-3D CN channel and tests/test_sharding_paths.py:99-112's dsmag duct
    (the mixed route), each by 'fft', against JAX Simulation(use_pallas=
    False) with ptransform 'fft': u, v, w, nu_t within 1e-11, p after
    removing its mean, the CFL dt, divmax, bulk u, the kernels named (no
    apply_x; apply_y only on the mixed route; no Thomas kernel in the
    eigen z stages) and the sharded checkpoint.
"""
import numpy as np
import pytest
import torch

from cales_tpu import poisson as jpoisson
from cales_tpu.config import Config as JaxConfig
from cales_tpu.config import effective_cbcvel as jax_cbcvel
from cales_tpu.grid import make_grid_from_config as jax_grid

from cales_torch import poisson
from cales_torch.config import Config, effective_cbcvel
from cales_torch.grid import make_grid_from_config
from cales_torch.io import checkpoint as ckpt
from cales_torch.timeloop import _C_OR_F, unsupported

from test_torch_sharded import (SMAG, _gauge, _jax_steps, _solve_case,
                                _spawn)
from test_torch_sharded_box import BOX
from test_torch_sharded_imp import _bulk
from test_torch_sharded_imp3d import CHAN3D

torch.set_num_threads(1)

# the solves' grids: nx = 16 (9 kx lanes), ny divisible by 4
SOLVE_CHAN = dict(SMAG, ng=(16, 8, 8), ptransform='fft')
SOLVE_BOX = dict(BOX, ng=(16, 8, 8), ptransform='fft')
SOLVE_DUCT = dict(SOLVE_CHAN, l=(2 * np.pi, 1.0, 1.0), gr=0.0,
                  cbcvel=((('P', 'P', 'P'), ('D', 'D', 'D'),
                           ('D', 'D', 'D')),) * 2,
                  cbcpre=(('P', 'N', 'N'),) * 2, cbcsgs=(('P', 'N', 'N'),) * 2)
# (key, config, velocity component or None for the pressure, alpha)
SOLVES = (('p_eig', SOLVE_CHAN, None, None),
          ('p_thomas', dict(SOLVE_CHAN, zsolver='thomas'), None, None),
          ('p_box', SOLVE_BOX, None, None),
          ('p_box_thomas', dict(SOLVE_BOX, zsolver='thomas'), None, None),
          ('p_duct', SOLVE_DUCT, None, None),
          ('p_duct_thomas', dict(SOLVE_DUCT, zsolver='thomas'), None, None),
          ('h_u', SOLVE_CHAN, 0, -0.04),
          ('h_w', SOLVE_CHAN, 2, -0.04),
          ('h_w_thomas', dict(SOLVE_CHAN, zsolver='thomas'), 2, -0.04))
# the step classes at gy = 2, each by 'fft'
CASES = {'les': dict(SMAG, ng=(32, 16, 16), ptransform='fft'),
         'box_dit': dict(BOX, sgstype='dsmag', dsmag_avg='dit',
                         ptransform='fft'),
         'chan3d': dict(CHAN3D, ptransform='fft'),
         # tests/test_sharding_paths.py:99-112
         'duct': dict(ng=(32, 16, 16), l=(2 * np.pi, 1.0, 1.0), gtype=1,
                      gr=0.0, visci=1000.0, inivel='log', is_wallturb=False,
                      dtype='float64', is_forced=(True, False, False),
                      velf=(1.0, 0.0, 0.0), sgstype='dsmag',
                      dsmag_avg='duct', ptransform='fft',
                      cbcvel=((('P', 'P', 'P'), ('D', 'D', 'D'),
                               ('D', 'D', 'D')),) * 2,
                      cbcpre=(('P', 'N', 'N'),) * 2,
                      cbcsgs=(('P', 'N', 'N'),) * 2)}
TOL = 1e-11


def _cbc(kw, ivel):
    if ivel is None:
        return tuple(Config(**kw).cbc_pre(d) for d in range(3)), \
            ('c', 'c', 'c')
    cbc = effective_cbcvel(Config(**kw))
    return tuple(cbc[0][d][ivel] + cbc[1][d][ivel] for d in range(3)), \
        _C_OR_F[ivel]


def _jax_ref(kw, ivel, alpha, rhs):
    """JAX poisson.solve (XLA, one device, its eigen z stage) of rhs."""
    jcfg = JaxConfig(**{**kw, 'zsolver': 'eig'}, use_pallas=False)
    if ivel is None:
        cbc = tuple(jcfg.cbc_pre(d) for d in range(3))
    else:
        c = jax_cbcvel(jcfg)
        cbc = tuple(c[0][d][ivel] + c[1][d][ivel] for d in range(3))
    sv = jpoisson.make_solver(jcfg, jax_grid(jcfg), cbc,
                              _C_OR_F[ivel] if ivel is not None
                              else ('c', 'c', 'c'))
    assert sv.trx.kind == 'fft'
    return np.asarray(jpoisson.solve(sv, rhs, alpha=alpha))


def _port_ref(kw, ivel, alpha, rhs):
    """The port's one-device 'fft' solve of rhs, its zsolver the case's."""
    cfg = Config(**kw)
    cbc, cf = _cbc(kw, ivel)
    sv = poisson.make_solver(cfg, make_grid_from_config(cfg), cbc, cf,
                             zsolver=cfg.zsolver)
    return poisson.solve(sv, torch.as_tensor(rhs), alpha=alpha).numpy()


def _solve_inputs(gy, rng):
    cases, inputs = [], {}
    for key, kw, ivel, alpha in SOLVES:
        assert unsupported(Config(**kw, dims=(gy, 1))) == [], key
        rhs = (_solve_case(kw, rng) if ivel is None
               else rng.standard_normal(kw['ng'][::-1]))
        inputs[f'{key}.rhs'] = rhs
        case = {'kind': 'solve', 'key': key, 'ng': kw['ng'],
                'cfg': {**kw, 'dims': (gy, 1)}}
        if ivel is not None:
            case.update(ivel=ivel, alpha=alpha)
        cases.append(case)
    return cases, inputs


def _check_solves(out, inputs):
    for key, kw, ivel, alpha in SOLVES:
        rhs = inputs[f'{key}.rhs']
        got = out[f'{key}.p']
        for what, ref, tol in (('JAX', _jax_ref(kw, ivel, alpha, rhs), TOL),
                               ('one device', _port_ref(kw, ivel, alpha,
                                                        rhs), 1e-13)):
            a, b = (got, ref) if alpha is not None else (_gauge(got),
                                                         _gauge(ref))
            err = np.abs(a - b).max()
            assert err <= tol * max(1.0, np.abs(b).max()), \
                f'{key} against {what}: {err:.3e}'
        if key.startswith('h_w'):
            # w's tail row (the upper wall's face) passes through the z
            # stage: the x and y transforms there and back round it
            assert np.abs(got[-1] - rhs[-1]).max() <= 1e-13


def _check_fft_steps(out, key, kw, jst, jchk, work):
    for name in ('u', 'v', 'w', 'p', 'visct'):
        a = np.asarray(getattr(jst, name))
        b = out[f'{key}.{name}']
        if name == 'p':
            a, b = _gauge(a), _gauge(b)
        err = np.abs(a - b).max()
        assert err <= TOL, f'{key} {name}: {err:.3e}'
    dt_cfl, _, divmax = out[f'{key}.check']
    assert abs(dt_cfl - jchk[0]) <= 1e-12 * jchk[0]
    assert divmax <= 1e-10 and abs(divmax - jchk[2]) <= 1e-12
    bulk = 1.0 if not kw.get('impdiff') else _bulk(kw, jst)
    if any(kw.get('is_forced', ())):
        assert abs(out[f'{key}.bulk'] - bulk) <= 1e-12
    names = list(out[f'{key}.names'])
    mixed = kw['cbcpre'][0][1] != 'P'
    assert 'apply_x' not in names and 'z_eig' not in names, names
    assert ('apply_y' in names) == mixed, names
    assert not {'thomas_z', 'thomas_periodic'} & set(names), names
    assert ('dsmag' in names) == (kw['sgstype'] == 'dsmag')
    assert out[f'{key}.readback'] == 1.0
    ref = work / f'{key}.ref.bin'
    ckpt.save_checkpoint(ref, *(out[f'{key}.{q}'] for q in 'uvwp'),
                         float(np.asarray(jst.time)), 2)
    assert (work / f'{key}.fld.bin').read_bytes() == ref.read_bytes()


def test_fft_solves_and_steps_on_two_slabs(tmp_path):
    cases, inputs = _solve_inputs(2, np.random.default_rng(61))
    refs = {}
    for key, kw in CASES.items():
        assert unsupported(Config(**kw, dims=(2, 1))) == [], key
        fields, dt, jst, jchk = _jax_steps(kw, 2)
        refs[key] = (jst, jchk)
        for q, f in zip('uvwp', fields):
            inputs[f'{key}.{q}'] = f
        inputs[f'{key}.dt'] = np.array(dt)
        cases.append({'kind': 'steps', 'key': key, 'ng': kw['ng'],
                      'cfg': {**kw, 'dims': (2, 1)}, 'nsteps': 2})
    out, work = _spawn(tmp_path, 2, cases, inputs)
    _check_solves(out, inputs)
    for key, kw in CASES.items():
        _check_fft_steps(out, key, kw, *refs[key], work)


def test_fft_solves_on_four_slabs(tmp_path):
    cases, inputs = _solve_inputs(4, np.random.default_rng(62))
    out, _ = _spawn(tmp_path, 4, cases, inputs)
    _check_solves(out, inputs)


@pytest.mark.parametrize('gy', [2, 4])
def test_lane_split_and_the_singular_lane(gy):
    """nx = 16 at gy = 2 and 4: 9 lanes in blocks of 5 and 3, the dead
    lanes the last rank's; the singular lane (0, 0) on rank 0 only."""
    from cales_torch.parallel.mesh import SlabMesh

    def mesh(rank):
        return SlabMesh(type('Comm', (), dict(size=gy, rank=rank))(),
                        (gy, 1), SOLVE_CHAN['ng'])
    nkl = mesh(0).kx_lanes(16 // 2 + 1)
    assert nkl == {2: 5, 4: 3}[gy] and gy * nkl - 9 == {2: 1, 4: 3}[gy]
    cfg = Config(**SOLVE_CHAN, dims=(gy, 1))
    sv = poisson.make_solver(cfg, make_grid_from_config(cfg),
                             ('PP', 'PP', 'NN'), ('c', 'c', 'c'))
    assert sv.trx.kind == sv.try_.kind == 'fft'
    tol = poisson._thomas_tol(sv.lamx, sv.lamy, torch.float64)
    lanes = [poisson.fft_slab_lamx(sv, mesh(r)) for r in range(gy)]
    assert all(len(q) == nkl for q in lanes)
    np.testing.assert_array_equal(np.concatenate(lanes)[:9], sv.lamx[:9])
    assert np.all(np.concatenate(lanes)[9:] == sv.lamx[8])
    held = [poisson._holds_singular(np.repeat(q, 2), sv.lamy, tol)
            for q in lanes]
    assert held == [True] + [False] * (gy - 1)
