"""Full-3D implicit diffusion, and impdiff_1d on the periodic box, on a
y-slab mesh (dims = (gy, 1)) on the CPU, on gloo ranks of
tests/_sharded_worker.py (the kernels' plain twins), against the JAX
package's single-device Simulation(use_pallas=False), f64, from the seeded
asymmetric start of tests/test_torch_sharded.py:

  * 2 steps at gy = 2 of the full-3D channel DNS of
    tests/test_sharding_paths.py:128 (test_impdiff_3d_channel_sharded: its
    CN stage one sharded Helmholtz solve a velocity component), the
    triperiodic box with full-3D and with impdiff_1d (the slabs' periodic
    z-only solves), and the scalar channel with full-3D (mom_rk's scalar
    variant with the 'xy+z' split on a slab); the channel at gy = 4 too:
    u, v, w and s within 1e-11, p within 1e-11 after removing its mean,
    the CFL dt, divmax, bulk u (the reference's), the kernels named and
    the sharded checkpoint as tests/test_torch_sharded.py holds them, and
    the kept w plane vlo[2] on the slabs' rows (the periodic y ghost rows,
    which no fill reads, stay out);
  * in the same spawn solve_sharded with alpha, u's Helmholtz solve and
    w's with its face-staggered Dirichlet tail row, on two slabs against
    the JAX package's poisson.solve with alpha on the whole field within
    1e-12;
  * mom_rk_plain with the 'xy+z' split and the slab's halos (yh), with and
    without the scalar, on each of two slabs equals the whole field's twin
    cut to the slab, every output exactly.
"""
import numpy as np
import pytest
import torch

from cales_tpu import poisson as jpoisson
from cales_tpu.config import Config as JaxConfig
from cales_tpu.config import effective_cbcvel as jax_cbcvel
from cales_tpu.grid import make_grid_from_config as jax_grid

from cales_torch.config import Config
from cales_torch.grid import make_grid_from_config
from cales_torch.ops import kernels as K
from cales_torch.timeloop import _C_OR_F, Simulation, unsupported

from test_torch_sharded import (CHAN_BCS, _check_steps, _jax_steps,
                                _perturbed, _spawn)
from test_torch_sharded_box import BOX, _SCALAR
from test_torch_sharded_imp import _bulk
from test_torch_sharded_les import _halo, _slab_of

torch.set_num_threads(1)

# tests/test_sharding_paths.py:128's full-3D channel (nx = 32 already)
CHAN3D = dict(ng=(32, 16, 16), l=(2 * np.pi, np.pi, 2.0), gtype=1, gr=0.0,
              visci=1000.0, inivel='log', is_wallturb=True, dtype='float64',
              is_forced=(True, False, False), velf=(1.0, 0.0, 0.0),
              sgstype='none', impdiff=True, ptransform='mat', **CHAN_BCS)
CASES = {'chan3d': CHAN3D,
         'box3d': dict(BOX, impdiff=True),
         'box1d': dict(BOX, impdiff=True, impdiff_1d=True),
         'chan3d_sc': dict(CHAN3D, **_SCALAR)}
ALPHA = -0.04
TOL = 1e-11


@pytest.fixture(scope='module')
def refs():
    return {key: (kw, _jax_steps(kw, 2)) for key, kw in CASES.items()}


def _jax_helmholtz(kw, ivel, rhs):
    jcfg = JaxConfig(**kw, use_pallas=False)
    cbc = jax_cbcvel(jcfg)
    sv = jpoisson.make_solver(jcfg, jax_grid(jcfg), tuple(
        cbc[0][d][ivel] + cbc[1][d][ivel] for d in range(3)), _C_OR_F[ivel])
    return np.asarray(jpoisson.solve(sv, rhs, alpha=ALPHA))


def _run(tmp_path, gy, refs, cases=(), inputs=None):
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
        zper = kw['cbcvel'][0][2][0] == 'P'
        _check_steps(out, key, jst, jchk, kw, work, 2, bulk=_bulk(kw, jst),
                     zthomas='thomas_periodic' if zper else 'thomas_z')
        if kw.get('scalar'):
            err = np.abs(out[f'{key}.s'] - np.asarray(jst.s)).max()
            assert err <= TOL, f'{key} s: {err:.3e}'
        err = np.abs(out[f'{key}.vlo2'][1:-1]
                     - np.asarray(jst.vlo[2])[1:-1]).max()
        assert err <= TOL, f'{key} vlo[2]: {err:.3e}'
    return out


def test_full3d_and_box_steps_and_helmholtz_on_two_slabs(tmp_path, refs):
    rng = np.random.default_rng(41)
    nx, ny, nz = CHAN3D['ng']
    cases, inputs = [], {}
    for ivel in (0, 2):
        key = f'h{ivel}'
        inputs[f'{key}.rhs'] = rng.standard_normal((nz, ny, nx))
        cases.append({'kind': 'solve', 'key': key, 'ng': CHAN3D['ng'],
                      'cfg': {**CHAN3D, 'dims': (2, 1)}, 'ivel': ivel,
                      'alpha': ALPHA})
    out = _run(tmp_path, 2, refs, cases, inputs)
    for ivel in (0, 2):
        key = f'h{ivel}'
        ref = _jax_helmholtz(CHAN3D, ivel, inputs[f'{key}.rhs'])
        err = np.abs(out[f'{key}.p'] - ref).max()
        assert err <= 1e-12 * max(1.0, np.abs(ref).max()), \
            f'solve_sharded alpha, component {ivel}: {err:.3e}'
    # w's tail row (the upper wall's face) passes through the z stage:
    # the x and y transforms there and back round it
    tail = np.abs(out['h2.p'][-1] - inputs['h2.rhs'][-1]).max()
    assert tail <= 1e-12, f'the tail row: {tail:.3e}'


def test_full3d_channel_on_four_slabs(tmp_path, refs):
    _run(tmp_path, 4, {'chan3d': refs['chan3d']})


@pytest.mark.parametrize('key', ['chan3d', 'chan3d_sc'])
def test_mom_rk_xyz_twin_on_slabs_is_the_whole_fields_rows(key):
    kw = CASES[key]
    cfg = Config(**kw)
    sim = Simulation(cfg, make_grid_from_config(cfg), device='cpu')
    assert sim.split == 'xy+z'
    _, _, fields = _perturbed(kw, seed=43)
    u, v, w, p = (torch.as_tensor(f) for f in fields)
    rng = np.random.default_rng(44)
    nz, ny, nx = u.shape
    ru, rv, rw, rso = (torch.as_tensor(rng.standard_normal((nz, ny, nx)))
                       for _ in range(4))
    sca = torch.as_tensor(rng.uniform(0.0, 1.0, (nz, ny, nx)))
    ue, ve, we = sim._zedge_vel(u, v, w, sim.bcu_vals, sim.bcv_vals,
                                sim.bcw_vals)
    pe = sim._zedge_p(p)
    coef = (sim.dzci_t, sim.dzfi_t, 0.3, -0.1, cfg.visc, cfg.dli[0],
            cfg.dli[1], cfg.bforce)
    fields, edges = [u, v, w, p], [ue, ve, we, pe]
    scal = {}
    if sim.has_scal:
        fields.append(sca)
        edges.append(sim._zedge_scal(sca))
        scal = dict(sca=sca, scae=edges[-1], rso=rso, scal=sim.scal_params)
    whole = K.mom_rk_plain(u, v, w, None, p, ue, ve, we, None, pe, ru, rv,
                           rw, *coef, sums=(True, False), split='xy+z',
                           **scal)
    gy = 2
    nyl = ny // gy
    for r in range(gy):
        y0 = r * nyl
        c = lambda a: _slab_of(a, y0, nyl)  # noqa: E731
        q = [c(a) for a in fields]
        e = [c(a) for a in edges]
        h = [_halo(a, b, y0, nyl, 1) for a, b in zip(fields, edges)]
        yh = (h[0], h[1], h[2], None, h[3], *h[4:])
        sk = {}
        if scal:
            sk = dict(sca=q[4], scae=e[4], rso=c(rso), scal=sim.scal_params)
        args = (*q[:3], None, q[3], *e[:3], None, e[3], c(ru), c(rv), c(rw),
                *coef)
        got = K.mom_rk_plain(*args, sums=(True, False), split='xy+z',
                             yh=yh, **sk)
        for m, (a, b) in enumerate(zip(got, whole)):
            if m == 6 or b is None:       # usum: the slab's plane sums
                continue
            assert torch.equal(a, c(b)), (key, r, m)
        same = K.mom_rk(*args, sums=(True, False), split='xy+z', yh=yh,
                        **sk)
        assert all(a is b or torch.equal(a, b) for a, b in zip(got, same))
