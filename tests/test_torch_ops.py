"""cales_torch modules against their cales_tpu counterparts, fp64 on the
CPU: the same numpy-seeded inputs through the JAX function and its torch
port.

Tolerances: boundary fills copy values and apply the same two-term
recipes, so they agree exactly (atol 0); stencil expressions keep the JAX
package's operation order, 1e-13; the Poisson solve goes through two FFT
libraries, 1e-12, and its residual |L p - rhs| is held at a few hundred
ulps of the RHS scale."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cales_tpu.config import Config, effective_cbcvel
from cales_tpu.grid import make_grid_from_config
from cales_tpu import poisson as jpoisson
from cales_tpu import sgs as jsgs
from cales_tpu.ops import boundary as jbnd
from cales_tpu.ops import stencil as jst
from cales_tpu.ops import transforms as jtr

from cales_torch import poisson as tpoisson
from cales_torch import sgs as tsgs
from cales_torch.ops import boundary as tbnd
from cales_torch.ops import stencil as tst
from cales_torch.ops import transforms as ttr

torch.set_num_threads(1)

NG = (12, 10, 8)     # (nx, ny, nz): small, non-square, stretched z


def _cfg(**kw):
    base = dict(ng=NG, l=(2 * np.pi, np.pi, 2.0), gtype=1, gr=1.2,
                visci=500.0, dtype='float64')
    base.update(kw)
    return Config(**base)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _n(a):
    return a.numpy() if torch.is_tensor(a) else np.asarray(a)


def _fields(seed, n=3, shape=None):
    rng = np.random.default_rng(seed)
    nx, ny, nz = NG
    return [rng.standard_normal(shape or (nz, ny, nx)) for _ in range(n)]


# --------------------------------------------------------------- boundary

WALL = (('P', 'P', 'P'), ('P', 'P', 'P'), ('D', 'D', 'D'))
BC_CASES = {
    # name: (cbcvel, bcvel (face, dir, comp) values)
    'channel': ((WALL, WALL), (((0.,) * 3,) * 3, ((0.,) * 3,) * 3)),
    'moving_lid_N': (
        ((('P',) * 3, ('P',) * 3, ('N', 'N', 'D')),
         (('P',) * 3, ('P',) * 3, ('D', 'N', 'N'))),
        (((0.,) * 3, (0.,) * 3, (0.3, -0.2, 0.)),
         ((0.,) * 3, (0.,) * 3, (1.0, 0.4, 0.7)))),
    'triperiodic': (((('P',) * 3,) * 3,) * 2, (((0.,) * 3,) * 3,) * 2),
}


def _bc_setup(name):
    cbcvel, bcvel = BC_CASES[name]
    cfg = _cfg(cbcvel=cbcvel, bcvel=bcvel)
    grid = make_grid_from_config(cfg)

    def by(ivel):
        return tuple(tuple(bcvel[ib][d][ivel] for ib in range(2))
                     for d in range(3))
    jb = [jbnd.make_bc_values(cfg.ng, by(i), np.float64) for i in range(3)]
    tb = [tbnd.make_bc_values(cfg.ng, by(i), torch.float64) for i in range(3)]
    return cfg, grid, effective_cbcvel(cfg), jb, tb


def _vlo(seed):
    nx, ny, nz = NG
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((nz + 2, ny + 2)),
            rng.standard_normal((nz + 2, nx + 2)),
            rng.standard_normal((ny + 2, nx + 2)))


@pytest.mark.parametrize('is_correc', [False, True])
@pytest.mark.parametrize('case', list(BC_CASES))
def test_pad_velocity_matches_jax(case, is_correc):
    cfg, grid, cbc, jb, tb = _bc_setup(case)
    u, v, w = _fields(1)
    vlo = _vlo(2) if is_correc else None
    ref = jbnd.pad_velocity(*map(jnp.asarray, (u, v, w)), cbc, *jb, cfg.dl,
                            grid.dzc, grid.dzf,
                            vlo=None if vlo is None else tuple(map(jnp.asarray, vlo)),
                            is_correc=is_correc)
    got = tbnd.pad_velocity(*map(_t, (u, v, w)), cbc, *tb, cfg.dl, grid.dzc,
                            grid.dzf,
                            vlo=None if vlo is None else tuple(map(_t, vlo)),
                            is_correc=is_correc)
    for a, b in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(_n(a), _n(b), rtol=0, atol=0)
    for a, b in zip(got[3], ref[3]):
        np.testing.assert_allclose(_n(a), _n(b), rtol=0, atol=0)


@pytest.mark.parametrize('is_correc', [False, True])
@pytest.mark.parametrize('case', list(BC_CASES))
def test_zedge_velocity_matches_jax(case, is_correc):
    cfg, grid, cbc, jb, tb = _bc_setup(case)
    u, v, w = _fields(3)
    vlo = _vlo(4)
    ref = jbnd.zedge_velocity(*map(jnp.asarray, (u, v, w)), cbc, *jb,
                              grid.dzc, grid.dzf,
                              vlo=tuple(map(jnp.asarray, vlo)),
                              is_correc=is_correc)
    got = tbnd.zedge_velocity(*map(_t, (u, v, w)), cbc, *tb, grid.dzc,
                              grid.dzf, vlo=tuple(map(_t, vlo)),
                              is_correc=is_correc)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(_n(a), _n(b), rtol=0, atol=0)


@pytest.mark.parametrize('letters,vals', [
    (('N', 'N'), (0.0, 0.0)), (('N', 'D'), (0.4, -1.3)),
    (('D', 'D'), (0.2, 0.0)), (('P', 'P'), (0.0, 0.0))])
def test_zedge_and_pad_scalar_match_jax(letters, vals):
    cfg = _cfg()
    grid = make_grid_from_config(cfg)
    (p,) = _fields(5, n=1)
    cbc = (('P', 'P'), ('P', 'P'), letters)
    bv = ((0.0, 0.0), (0.0, 0.0), vals)
    jv = jbnd.make_bc_values(cfg.ng, bv, np.float64)
    tv = tbnd.make_bc_values(cfg.ng, bv, torch.float64)
    np.testing.assert_allclose(
        _n(tbnd.zedge_scalar(_t(p), letters, tv[2], grid.dzc)),
        _n(jbnd.zedge_scalar(jnp.asarray(p), letters, jv[2], grid.dzc)),
        rtol=0, atol=0)
    np.testing.assert_allclose(
        _n(tbnd.pad_scalar(_t(p), cbc, tv, cfg.dl, grid.dzc)),
        _n(jbnd.pad_scalar(jnp.asarray(p), cbc, jv, cfg.dl, grid.dzc)),
        rtol=0, atol=0)


# ---------------------------------------------------------------- stencil

def _padded_inputs(seed, n=4):
    rng = np.random.default_rng(seed)
    nx, ny, nz = NG
    return [rng.standard_normal((nz + 2, ny + 2, nx + 2)) for _ in range(n)]


def _stencil_pair(name):
    """(jax result, torch result) of one stencil function on the same
    padded inputs."""
    cfg = _cfg()
    grid = make_grid_from_config(cfg)
    dxi, dyi = cfg.dli[0], cfg.dli[1]
    up, vp, wp, sp = _padded_inputs(11)
    J = list(map(jnp.asarray, (up, vp, wp, sp)))
    T = list(map(_t, (up, vp, wp, sp)))
    nz = cfg.ng[2]
    if name == 'momentum_rhs':
        a = (jst.momentum_rhs(*J, 0.01, dxi, dyi, grid.dzci, grid.dzfi),
             tst.momentum_rhs(*T, 0.01, dxi, dyi, grid.dzci, grid.dzfi))
        return tuple([x for comp in r for x in comp] for r in a)
    if name == 'momentum_rhs_nosgs':
        a = (jst.momentum_rhs(*J[:3], None, 0.01, dxi, dyi, grid.dzci,
                              grid.dzfi, with_sgs=False),
             tst.momentum_rhs(*T[:3], None, 0.01, dxi, dyi, grid.dzci,
                              grid.dzfi, with_sgs=False))
        return tuple([x for comp in r for x in comp] for r in a)
    if name == 'fillps':
        return ([jst.fillps(*J[:3], 37.0, dxi, dyi, grid.dzfi)],
                [tst.fillps(*T[:3], 37.0, dxi, dyi, grid.dzfi)])
    if name == 'correc':
        a = jst.correc(*J[:3], J[3], 2.3e-3, dxi, dyi, grid.dzci)
        b = tst.correc(*T[:3], T[3], 2.3e-3, dxi, dyi, grid.dzci)
        return list(a[:3]) + list(a[3]), list(b[:3]) + list(b[3])
    if name.startswith('updatep'):
        imp = name != 'updatep'
        one_d = name == 'updatep_impdiff_1d'
        p = sp[1:-1, 1:-1, 1:-1]
        return ([jst.updatep(J[0], jnp.asarray(p), -0.7, imp, one_d, dxi, dyi,
                             grid.dzci, grid.dzfi)],
                [tst.updatep(T[0], _t(p), -0.7, imp, one_d, dxi, dyi,
                             grid.dzci, grid.dzfi)])
    if name == 'divergence':
        return (list(jst.divergence(*J[:3], dxi, dyi, grid.dzfi)),
                list(tst.divergence(*T[:3], dxi, dyi, grid.dzfi)))
    if name == 'cfl_dt':
        S = [np.abs(sp)]
        return ([jst.cfl_dt(*J[:3], jnp.asarray(S[0]), 0.01, cfg.dl, grid.dzci,
                            grid.dzfi, False, False, 1e-16)],
                [tst.cfl_dt(*T[:3], _t(S[0]), 0.01, cfg.dl, grid.dzci,
                            grid.dzfi, False, False, 1e-16)])
    if name == 'strain_rate':
        return ([jst.strain_rate(*J[:3], grid.dzci, grid.dzfi, dxi, dyi)],
                [tst.strain_rate(*T[:3], grid.dzci, grid.dzfi, dxi, dyi)])
    if name == 'bulk_mean':
        f = up[1:-1, 1:-1, 1:-1]
        gvr = grid.dzf[1:nz + 1] / cfg.l[2]
        return ([jst.bulk_mean(jnp.asarray(f), gvr)],
                [tst.bulk_mean(_t(f), gvr)])
    raise KeyError(name)


@pytest.mark.parametrize('name', [
    'momentum_rhs', 'momentum_rhs_nosgs', 'fillps', 'correc', 'updatep',
    'updatep_impdiff', 'updatep_impdiff_1d', 'divergence', 'cfl_dt',
    'strain_rate', 'bulk_mean'])
def test_stencil_matches_jax(name):
    ref, got = _stencil_pair(name)
    assert len(ref) == len(got)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(_n(a), _n(b), rtol=0, atol=1e-13)


# ------------------------------------------------------------- transforms

@pytest.mark.parametrize('bc,c_or_f,pp_mat', [
    ('PP', 'c', False), ('PP', 'c', True), ('NN', 'c', False),
    ('DD', 'f', False)])
def test_transforms_match_jax(bc, c_or_f, pp_mat):
    n = 10
    jt = jtr.make_transform(bc, c_or_f, n, pp_mat=pp_mat)
    tt = ttr.make_transform(bc, c_or_f, n, pp_mat=pp_mat)
    assert jt.kind == tt.kind and jt.nsolve == tt.nsolve
    np.testing.assert_array_equal(tt.lam, jt.lam)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 6, tt.nsolve))
    fj = jtr.fwd(jt, jnp.asarray(x), axis=-1)
    bj = jtr.bwd(jt, fj, axis=-1, n=tt.nsolve, real_out=True)
    # the port applies them as its solve routes do (poisson.py): the rfft
    # for kind 'fft', the operator matrices for kind 'mat'
    if tt.kind == 'fft':
        ft = torch.fft.rfft(_t(x), dim=-1)
        bt = torch.fft.irfft(ft, n=tt.nsolve, dim=-1)
    else:
        ft = torch.matmul(_t(x), _t(tt.fwd_mat).T)
        bt = torch.matmul(ft, _t(tt.bwd_mat).T)
    np.testing.assert_allclose(_n(ft), _n(fj), rtol=0, atol=1e-12)
    np.testing.assert_allclose(_n(bt), _n(bj), rtol=0, atol=1e-12)
    np.testing.assert_allclose(_n(bt), x, rtol=0, atol=1e-12)


# ---------------------------------------------------------------- poisson

def _laplacian_channel(p, cfg, grid):
    """L p with periodic x/y and homogeneous Neumann z (cell-centered)."""
    dxi, dyi = cfg.dli[0], cfg.dli[1]
    lap = ((np.roll(p, -1, 2) - 2 * p + np.roll(p, 1, 2)) * dxi ** 2
           + (np.roll(p, -1, 1) - 2 * p + np.roll(p, 1, 1)) * dyi ** 2)
    pz = np.concatenate([p[:1], p, p[-1:]], axis=0)       # N ghosts
    nz = p.shape[0]
    dzci, dzfi = grid.dzci, grid.dzfi
    k = np.arange(1, nz + 1)
    lap_z = ((pz[2:] - pz[1:-1]) * dzci[k][:, None, None]
             - (pz[1:-1] - pz[:-2]) * dzci[k - 1][:, None, None]) \
        * dzfi[k][:, None, None]
    return lap + lap_z


def test_poisson_solve_matches_jax_and_residual():
    cfg = _cfg(ptransform='fft')
    grid = make_grid_from_config(cfg)
    cbc = tuple(cfg.cbc_pre(d) for d in range(3))
    js = jpoisson.make_solver(cfg, grid, cbc, ('c', 'c', 'c'))
    ts = tpoisson.make_solver(cfg, grid, cbc, ('c', 'c', 'c'))
    (rhs,) = _fields(21, n=1)
    # solvable: zero dzf-weighted mean
    w = grid.dzf[1:cfg.ng[2] + 1][:, None, None]
    rhs = rhs - (rhs * w).sum() / (w.sum() * NG[0] * NG[1])
    ref = np.asarray(jpoisson.solve(js, jnp.asarray(rhs)))
    got = _n(tpoisson.solve(ts, _t(rhs)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    res = _laplacian_channel(got, cfg, grid) - rhs
    scale = np.abs(rhs).max() + 1.0
    assert np.abs(res).max() < 500 * np.finfo(np.float64).eps * scale * \
        max(cfg.dli[0] ** 2, grid.dzci.max() ** 2)


def test_poisson_outside_slice_raises():
    """Outside the slice, with or without alpha: transforms with an
    excluded row (v face-staggered across y walls) and an FFT along y with
    a matrix along x (x walls, periodic y); the Poisson solve of a field
    face-staggered across a z wall (qz = 1, only its Helmholtz solve
    runs).  The mixed route (an FFT along x, the y-wall matrix along y)
    runs: tests/test_torch_fft_ywalls.py holds it to JAX."""
    cfg = _cfg(ptransform='fft')
    grid = make_grid_from_config(cfg)
    zeros = torch.zeros(NG[::-1], dtype=torch.float64)
    sv = tpoisson.make_solver(cfg, grid, ('PP', 'NN', 'NN'),
                              ('c', 'c', 'c'))
    assert (sv.trx.kind, sv.try_.kind) == ('fft', 'mat')
    for alpha in (None, -0.1):
        assert tpoisson.solve(sv, zeros, alpha=alpha).shape == zeros.shape
    for cbc, c_or_f, match in (
            (('PP', 'DD', 'DD'), ('c', 'f', 'c'), 'excluded rows'),
            (('NN', 'PP', 'NN'), ('c', 'c', 'c'),
             'an FFT along y with a matrix along x')):
        sv = tpoisson.make_solver(cfg, grid, cbc, c_or_f)
        for alpha in (None, -0.1):
            with pytest.raises(NotImplementedError, match=match):
                tpoisson.solve(sv, zeros, alpha=alpha)
    sv = tpoisson.make_solver(_cfg(ptransform='mat'), grid,
                              ('PP', 'PP', 'DD'), ('c', 'c', 'f'))
    with pytest.raises(NotImplementedError, match='face-staggered'):
        tpoisson.solve(sv, zeros)
    assert tpoisson.solve(sv, zeros, alpha=-0.1).shape == zeros.shape


def test_add_rhs_bound_matches_jax():
    cfg = _cfg(cbcpre=(('P', 'P', 'D'), ('P', 'P', 'N')),
               bcpre=((0., 0., 0.7), (0., 0., -0.4)))
    grid = make_grid_from_config(cfg)
    cbc = tuple((cfg.cbcpre[0][d], cfg.cbcpre[1][d]) for d in range(3))
    bv = tuple(tuple(cfg.bcpre[ib][d] for ib in range(2)) for d in range(3))
    jp = jpoisson.rhs_bound_planes(cfg, grid, cbc, ('c', 'c', 'c'), bv)
    tp = tpoisson.rhs_bound_planes(cfg, grid, cbc, ('c', 'c', 'c'), bv)
    assert set(jp) == set(tp)
    (rhs,) = _fields(31, n=1)
    ref = jpoisson.add_rhs_bound(cfg, ('c', 'c', 'c'), cbc,
                                 jnp.asarray(rhs), jp)
    got = tpoisson.add_rhs_bound(cfg, ('c', 'c', 'c'), cbc, _t(rhs), tp)
    np.testing.assert_allclose(_n(got), np.asarray(ref), rtol=0, atol=1e-15)


# -------------------------------------------------------------------- sgs

def test_smag_visct_matches_jax():
    cfg = _cfg(sgstype='smag')
    grid = make_grid_from_config(cfg)
    cbc = effective_cbcvel(cfg)
    up, vp, wp = _padded_inputs(41, n=3)
    ref = jsgs.smag_visct(jsgs.SGSSetup(cfg, grid, cbc), cfg, grid,
                          *map(jnp.asarray, (up, vp, wp)))
    got = tsgs.smag_visct(tsgs.SGSSetup(cfg, grid, cbc), cfg, grid,
                          *map(_t, (up, vp, wp)))
    ref = np.asarray(ref)
    np.testing.assert_allclose(_n(got), ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())
