"""The solve kernels' plain versions (cales_torch/ops/solve_kernels.py,
ops/tridiag.py) against the JAX Pallas kernels they port, run in interpret
mode on the CPU as tests/test_poisson.py runs them, and the port's solves
(poisson.solve with ptransform 'mat', solve_z_only) against cales_tpu's,
fp64 at (nx, ny, nz) = (128, 16, 24) with numpy-seeded inputs.

Tolerances, relative to the reference's maximum (the same sums in another
order): apply_y and z_eig 1e-13 (sums over up to 128 terms); the Thomas
sweeps 1e-12 (nz sequential steps); the solves 1e-11, after removing the
mean where the solution is defined up to a constant (the singular mode is
projected out by eig, pinned by the port's Thomas and regularized by the
JAX XLA Thomas)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cales_tpu import poisson as jpoisson
from cales_tpu.config import Config
from cales_tpu.grid import make_grid_from_config
from cales_tpu.ops import pallas_solve as ps
from cales_tpu.ops import tridiag as jtri

from cales_torch import poisson as tpoisson
from cales_torch.ops import solve_kernels as SK
from cales_torch.ops import tridiag as ttri

torch.set_num_threads(1)

NG = (128, 16, 24)
CHAN_P = ('PP', 'PP', 'NN')


def _cfg(**kw):
    base = dict(ng=NG, l=(1.3, 0.9, 2.0), gtype=1, gr=0.8, dtype='float64',
                ptransform='mat')
    base.update(kw)
    return Config(**base)


def _rhs(seed):
    nx, ny, nz = NG
    return np.random.default_rng(seed).standard_normal((nz, ny, nx))


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64)


def _close(got, ref, rtol, gauge=False):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    if gauge:
        got, ref = got - got.mean(), ref - ref.mean()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * scale)


@pytest.fixture(scope='module')
def chan():
    cfg = _cfg()
    grid = make_grid_from_config(cfg)
    js = jpoisson.make_solver(cfg, grid, CHAN_P, ('c', 'c', 'c'))
    ts = tpoisson.make_solver(cfg, grid, CHAN_P, ('c', 'c', 'c'))
    return cfg, grid, js, ts


# ------------------------------------------------------------- kernels

@pytest.mark.parametrize('with_x', [False, True])
def test_apply_y_plain_matches_pallas(chan, with_x):
    _, _, js, _ = chan
    x = _rhs(1)
    mxt = js.trx.fwd_mat.T.copy() if with_x else None
    ref = ps.apply_y(jnp.asarray(x), js.try_.fwd_mat, MxT=mxt,
                     interpret=True)
    got = SK.apply_y_plain(_t(x), _t(js.try_.fwd_mat),
                           None if mxt is None else _t(mxt))
    _close(got, ref, 1e-13)


def test_z_eig_plain_matches_pallas(chan):
    """The NN channel pressure system, singular mode included."""
    _, _, js, _ = chan
    x = _rhs(2)
    scale = (np.abs(js.lamz).max() + np.abs(js.lamx).max()
             + np.abs(js.lamy).max())
    tol = float(np.finfo(np.float64).eps * scale * 4.0)
    ref = ps.apply_z_eig(jnp.asarray(x), js.zVl, js.zVr, js.lamz, js.lamy,
                         js.lamx, tol, interpret=True)
    got = SK.z_eig_plain(_t(x), *(_t(q) for q in (js.zVl, js.zVr, js.lamz,
                                                   js.lamy, js.lamx)), tol)
    _close(got, ref, 1e-13)


def test_thomas_plain_matches_pallas_poisson_pinned(chan):
    """lam = lamy + lamx on the diagonal, the singular lane pinned."""
    _, _, js, _ = chan
    x = _rhs(3)
    tol = float(np.finfo(np.float64).eps * 4.0
                * (np.abs(js.lamx).max() + np.abs(js.lamy).max()))
    ref = ps.apply_thomas_z(jnp.asarray(x), js.a, js.b, js.c, js.lamy,
                            js.lamx, pin_singular=True, tol=tol,
                            interpret=True)
    got = SK.thomas_z_plain(_t(x), _t(js.a), _t(js.b), _t(js.c),
                            lamy=_t(js.lamy), lamx=_t(js.lamx), pin=True,
                            tol=tol)
    _close(got, ref, 1e-12)
    assert float(got[0, 0, 0]) == 0.0     # the pinned gauge


def test_thomas_plain_matches_pallas_helmholtz():
    """The CN form: scaled rows, a shift, n_solve < nz (the w tail row)
    and boundary planes on rows 0 and n_solve - 1."""
    cfg = _cfg()
    grid = make_grid_from_config(cfg)
    sv = jpoisson.make_solver(cfg, grid, ('PP', 'PP', 'DD'), ('c', 'c', 'f'))
    nx, ny, nz = NG
    rng = np.random.default_rng(4)
    x = _rhs(4)
    lo, hi = rng.standard_normal((2, ny, nx))
    alpha, f, n = -0.043, 0.0173, nz - 1
    ref = ps.apply_thomas_helmholtz_z(
        jnp.asarray(x), sv.a[:n] * alpha, sv.b[:n] * alpha + 1.0,
        sv.c[:n] * alpha, interpret=True, shift=f, n_solve=n,
        bc_lo=jnp.asarray(lo), bc_hi=jnp.asarray(hi))
    got = SK.thomas_z_plain(_t(x), _t(sv.a), _t(sv.b), _t(sv.c), alpha=alpha,
                            shift=_t([f]), bc_lo=_t(lo), bc_hi=_t(hi),
                            n_solve=n)
    _close(got, ref, 1e-12)


def test_tridiag_thomas_matches_jax():
    rng = np.random.default_rng(5)
    n = 12
    a, c = rng.uniform(0.5, 1.0, (2, n))
    b = -(a + c) - rng.uniform(0.1, 0.5, n)
    rhs = rng.standard_normal((n, 5, 7))
    lam = -rng.uniform(0.0, 2.0, (5, 7))
    ref = jtri.thomas(a, b, c, jnp.asarray(rhs), lam=jnp.asarray(lam),
                      regularize=False)
    got = ttri.thomas(_t(a), _t(b), _t(c), _t(rhs), lam=_t(lam))
    _close(got, ref, 1e-13)


# the Pallas kernel's solves of test_thomas_chunked_matches_pallas, one
# per (variant, nz, n_solve): the lane splits share them
_PALLAS_THOMAS = {}


def _thomas_case(variant, nz, ns):
    """The seeded inputs of a Thomas case on a (128, 8, nz) channel grid:
    the pressure system's rows with lam = lamy + lamx, pinned, or w's
    Crank-Nicolson rows (alpha-scaled) with a shift and boundary planes;
    rows ns .. nz-1 pass through.  Returns (inputs, the Pallas kernel's
    solve in interpret mode)."""
    ng = (128, 8, nz)
    cfg = _cfg(ng=ng)
    grid = make_grid_from_config(cfg)
    rng = np.random.default_rng(nz)
    x = rng.standard_normal((nz, 8, 128))
    if variant == 'poisson':
        sv = jpoisson.make_solver(cfg, grid, CHAN_P, ('c', 'c', 'c'))
        tol = float(np.finfo(np.float64).eps * 4.0
                    * (np.abs(sv.lamx).max() + np.abs(sv.lamy).max()))
        case = dict(x=x, rows=(sv.a, sv.b, sv.c), lam=(sv.lamy, sv.lamx),
                    tol=tol, alpha=None, shift=0.0, bc=None)
    else:
        sv = jpoisson.make_solver(cfg, grid, ('PP', 'PP', 'DD'),
                                  ('c', 'c', 'f'))
        alpha = -0.043
        case = dict(x=x, rows=(sv.a * alpha, sv.b * alpha + 1.0,
                               sv.c * alpha), lam=None, tol=None,
                    alpha=alpha, shift=0.0173,
                    bc=rng.standard_normal((2, 8, 128)))
    key = (variant, nz, ns)
    if key not in _PALLAS_THOMAS:
        rows = tuple(q[:ns] for q in case['rows'])
        if variant == 'poisson':
            ref = ps.apply_thomas_z(jnp.asarray(x), *rows, *case['lam'],
                                    pin_singular=True, tol=case['tol'],
                                    interpret=True, n_solve=ns)
        else:
            ref = ps.apply_thomas_helmholtz_z(
                jnp.asarray(x), *rows, interpret=True, shift=case['shift'],
                n_solve=ns, bc_lo=jnp.asarray(case['bc'][0]),
                bc_hi=jnp.asarray(case['bc'][1]))
        _PALLAS_THOMAS[key] = np.asarray(ref)
    return case, _PALLAS_THOMAS[key]


@pytest.mark.parametrize('lanes, min_rows', [(32, 7), (32, 2), (3, 2)])
@pytest.mark.parametrize('tail', [0, 1])
@pytest.mark.parametrize('nz', [3, 4, 7, 12, 40])
@pytest.mark.parametrize('variant', ['poisson', 'helmholtz'])
def test_thomas_chunked_matches_pallas(variant, nz, tail, lanes, min_rows):
    """The card kernel's scheme step by step (tridiag.thomas_chunked:
    chunks of rows a lane, the chunk ends by cyclic reduction, each
    chunk's rows from its P and Q, the pinned lane's first pivot zeroed)
    against the Pallas kernel: the pressure rows with lam on the diagonal,
    the singular lane pinned (row 0 exactly 0), or w's alpha-scaled rows
    with a shift and boundary planes on rows 0 and n_solve - 1; all nz
    rows solved, or the tail row passed through (n_solve = nz - 1).  The
    kernel's chunks of at least 7 rows on 32 lanes (one chunk below 14
    rows), chunks of 2 rows on 32 lanes (20 chunks of 2 at nz = 40) and
    on 3 lanes (chunks of 3 and 4 rows at nz = 12)."""
    ns = nz - tail
    case, ref = _thomas_case(variant, nz, ns)
    x = _t(case['x'])
    a, b, c = (_t(q[:ns]) for q in case['rows'])
    rhs = x[:ns] + case['shift']
    lam = None
    if variant == 'poisson':
        lamy, lamx = case['lam']
        lam = _t(lamy)[:, None] + _t(lamx)[None, :]
    else:
        rhs[0] += _t(case['bc'][0])
        rhs[ns - 1] += _t(case['bc'][1])
    sol = ttri.thomas_chunked(a, b, c, rhs, lam=lam, pin_tol=case['tol'],
                              lanes=lanes, min_rows=min_rows)
    got = torch.cat([sol, x[ns:] + case['shift']])
    if variant == 'poisson':
        assert float(got[0, 0, 0]) == 0.0     # the pinned gauge
    _close(got, ref, 1e-12)


# -------------------------------------------------------------- solves

def _compatible(rhs, grid):
    """Zero dzf-weighted mean: the singular Poisson system is solvable."""
    nx, ny, nz = NG
    w = grid.dzf[1:nz + 1][:, None, None]
    return rhs - (rhs * w).sum() / (w.sum() * nx * ny)


@pytest.mark.parametrize('ptransform,zsolver', [
    ('mat', 'eig'), ('mat', 'thomas'), ('fft', 'thomas')])
def test_poisson_solve_matches_jax(ptransform, zsolver):
    cfg = _cfg(ptransform=ptransform, zsolver=zsolver)
    grid = make_grid_from_config(cfg)
    rhs = _compatible(_rhs(6), grid)
    js = jpoisson.make_solver(cfg, grid, CHAN_P, ('c', 'c', 'c'),
                              zsolver=zsolver)
    ts = tpoisson.make_solver(cfg, grid, CHAN_P, ('c', 'c', 'c'),
                              zsolver=zsolver)
    assert tpoisson.uses_thomas(ts) == (zsolver == 'thomas')
    ref = jpoisson.solve(js, jnp.asarray(rhs))
    _close(tpoisson.solve(ts, _t(rhs)), ref, 1e-11, gauge=True)


@pytest.mark.parametrize('ptransform', ['mat', 'fft'])
def test_float32_eig_solve_keeps_every_nonsingular_mode(ptransform):
    """The eigen z stage in float32 on the dynamic-Smagorinsky channel's
    stretched grid (gr = 5, validation/dsmag_channel.py) against the same
    solve in float64: only the singular mode may be dropped.  A singular-
    mode bound scaled by float32's eps (the JAX package's) zeroes 5 modes
    here and misses by O(1); the port's float64-scaled bound keeps them,
    leaving float32 rounding (bound 1e-4 relative)."""
    ng = (32, 16, 128)
    nx, ny, nz = ng
    cfg = Config(ng=ng, l=(12.8, 4.8, 2.0), gtype=1, gr=5.0,
                 dtype='float64', ptransform=ptransform)
    grid = make_grid_from_config(cfg)
    sv = tpoisson.make_solver(cfg, grid, CHAN_P, ('c', 'c', 'c'))
    assert not tpoisson.uses_thomas(sv)
    lam = (sv.lamz[:, None, None] + sv.lamy[None, :, None]
           + sv.lamx[None, None, :])
    scale = (np.abs(sv.lamz).max() + np.abs(sv.lamx).max()
             + np.abs(sv.lamy).max())
    assert (np.abs(lam) <= np.finfo(np.float32).eps * scale * 4).sum() > 1
    w = grid.dzf[1:nz + 1][:, None, None]
    rhs = np.random.default_rng(9).standard_normal((nz, ny, nx))
    rhs -= (rhs * w).sum() / (w.sum() * nx * ny)
    ref = tpoisson.solve(sv, _t(rhs))
    got = tpoisson.solve(sv, _t(rhs).float()).double()
    _close(got, ref, 1e-4, gauge=True)


def test_poisson_solve_mat_matches_jax_kernel_path(chan):
    """The JAX package's aliased 3-pass Pallas solve (interpret mode), the
    branch its kernel path runs without the x fusion."""
    _, grid, js, ts = chan
    rhs = _compatible(_rhs(7), grid)
    ref = jpoisson.solve(js, jnp.asarray(rhs), pallas=True,
                         pallas_interpret=True)
    _close(tpoisson.solve(ts, _t(rhs)), ref, 1e-11, gauge=True)


@pytest.mark.parametrize('ivel', [0, 1, 2])
def test_solve_z_only_matches_jax(ivel):
    """The z-only CN Helmholtz solve of each velocity component (w: the
    face-staggered qz = 1 system) with the forcing shift and z planes,
    against the JAX XLA branch and its Pallas Thomas pass."""
    cfg = _cfg()
    grid = make_grid_from_config(cfg)
    cf = (('f', 'c', 'c'), ('c', 'f', 'c'), ('c', 'c', 'f'))[ivel]
    cbc = ('PP', 'PP', 'DD')
    js = jpoisson.make_solver(cfg, grid, cbc, cf)
    ts = tpoisson.make_solver(cfg, grid, cbc, cf)
    assert ts.qz == (1 if ivel == 2 else 0)
    nx, ny, nz = NG
    rng = np.random.default_rng(8 + ivel)
    x = _rhs(8 + ivel)
    lo, hi = rng.standard_normal((2, ny, nx))
    alpha, f = -0.031, 0.0211
    kw = dict(shift=f, bc_planes=(jnp.asarray(lo), jnp.asarray(hi)))
    got = tpoisson.solve_z_only(ts, _t(x), alpha, shift=_t([f]),
                                bc_planes=(_t(lo), _t(hi)))
    for pallas in (False, True):
        ref = jpoisson.solve_z_only(js, jnp.asarray(x), alpha, pallas=pallas,
                                    pallas_interpret=True, **kw)
        _close(got, ref, 1e-12)


@pytest.mark.parametrize('c_or_f', [('c', 'c', 'c'), ('c', 'c', 'f')])
def test_rhs_bound_planes_dyn_matches_jax(c_or_f):
    cfg = _cfg()
    grid = make_grid_from_config(cfg)
    nx, ny, nz = NG
    rng = np.random.default_rng(11)
    zlo = rng.standard_normal((ny + 2, nx + 2))
    cbc = (('P', 'P'), ('P', 'P'), ('D', 'N'))
    vals = ((0.0, 0.0), (0.0, 0.0), (zlo, 0.37))
    ref = jpoisson.rhs_bound_planes_dyn(
        cfg, grid, cbc, c_or_f,
        ((0.0, 0.0), (0.0, 0.0), (jnp.asarray(zlo), 0.37)))
    got = tpoisson.rhs_bound_planes_dyn(cfg, grid, cbc, c_or_f, vals,
                                        torch.float64, 'cpu')
    assert set(got) == set(ref)
    for key in ref:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=0, atol=1e-15, err_msg=str(key))
