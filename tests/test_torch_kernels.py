"""The stencil kernel twins of cales_torch/ops/kernels.py against the JAX
Pallas kernels they port, run in interpret mode on the CPU as
tests/test_pallas_kernels.py runs them, fp64, at (nx, ny, nz) =
(128, 32, 16) with random interiors and z-edge stacks.

Tolerances (the formulas and their order are the same; only the
libraries' rounding differs): u, v, w, p 1e-13; the momentum RHS ru, rv,
rw 1e-11 (terms of size dzci^2 ~ 1e3 cancel); nu_t 1e-12 relative to its
maximum (1 - exp(-x) near the wall amplifies an ulp of exp); the pressure
with alpha L(pp) 1e-13 relative to its maximum (the Laplacian's terms are
of size dzci^2 pp).

The CUDA kernels themselves run only on a card: tests/test_torch_cuda.py
holds each against its twin there (and so does chip_smoke.py)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cales_tpu.config import Config, C_SMAG, effective_cbcvel
from cales_tpu.grid import make_grid_from_config
from cales_tpu.ops import pallas_kernels as pk

from cales_torch import sgs as tsgs
from cales_torch.ops import kernels as K

torch.set_num_threads(1)

NG = (128, 32, 16)


def _setup(seed):
    cfg = Config(ng=NG, l=(2 * np.pi, np.pi, 2.0), gtype=1, gr=1.0,
                 visci=1000.0, dtype='float64')
    grid = make_grid_from_config(cfg)
    nx, ny, nz = NG
    rng = np.random.default_rng(seed)
    F = lambda: 0.1 * rng.standard_normal((nz, ny, nx))   # noqa: E731
    E = lambda: 0.1 * rng.standard_normal((3, ny, nx))    # noqa: E731
    d = dict(u=F(), v=F(), w=F(), s=np.abs(F()), p=F(), pp=F(),
             ue=E(), ve=E(), we=E(), se=np.abs(E()), pe=E(), ppe=E(),
             ruo=F(), rvo=F(), rwo=F())
    return cfg, grid, d


def _J(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _T(d):
    return {k: torch.as_tensor(v) for k, v in d.items()}


def _close(got, ref, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0,
                               atol=atol)


@pytest.mark.parametrize('has_ruo', [False, True])
def test_mom_rk_twin_matches_pallas(has_ruo):
    cfg, grid, d = _setup(0)
    J, T = _J(d), _T(d)
    f1, f2, visc = 0.5e-3, (-0.2e-3 if has_ruo else 0.0), cfg.visc
    dxi, dyi = cfg.dli[:2]
    bforce = (0.1, 0.0, 0.02)
    ref = pk.fused_mom_rk(J['u'], J['v'], J['w'], J['s'], J['p'], J['ue'],
                          J['ve'], J['we'], J['se'], J['pe'], J['ruo'],
                          J['rvo'], J['rwo'], grid.dzci, grid.dzfi, f1, f2,
                          visc, dxi, dyi, bforce, interpret=True,
                          has_ruo=has_ruo, sum_flags=(True, True))
    r = (T['ruo'], T['rvo'], T['rwo']) if has_ruo else (None,) * 3
    got = K.mom_rk_plain(T['u'], T['v'], T['w'], T['s'], T['p'], T['ue'],
                         T['ve'], T['we'], T['se'], T['pe'], *r,
                         torch.as_tensor(grid.dzci), torch.as_tensor(grid.dzfi),
                         f1, f2, visc, dxi, dyi, bforce, sums=(True, True))
    for i in range(3):
        _close(got[i], ref[i], 1e-13)
    for i in range(3, 6):
        _close(got[i], ref[i], 1e-11)
    # the per-plane totals of the partial sums (the forcing means' input)
    for g, r_ in zip(got[6:], ref[6:]):
        _close(g.sum(dim=1), np.asarray(r_)[:, ::8, 0].sum(axis=1), 1e-11)


@pytest.mark.parametrize('has_ruo', [False, True])
def test_mom_rk_twin_matches_pallas_cn_fold_without_sgs(has_ruo):
    """split '1d' with the CN fold and no eddy viscosity (the implicit-CN
    DNS's momentum pass, pallas_kernels.py:640-684)."""
    cfg, grid, d = _setup(1)
    J, T = _J(d), _T(d)
    f1, f2, visc = 0.5e-3, (-0.2e-3 if has_ruo else 0.0), cfg.visc
    dxi, dyi = cfg.dli[:2]
    bforce = (0.1, 0.0, 0.02)
    ref = pk.fused_mom_rk(J['u'], J['v'], J['w'], None, J['p'], J['ue'],
                          J['ve'], J['we'], None, J['pe'], J['ruo'],
                          J['rvo'], J['rwo'], grid.dzci, grid.dzfi, f1, f2,
                          visc, dxi, dyi, bforce, interpret=True,
                          has_ruo=has_ruo, sum_flags=(True, True),
                          split='1d', fold_cn=True, has_sgs=False)
    r = (T['ruo'], T['rvo'], T['rwo']) if has_ruo else (None,) * 3
    got = K.mom_rk_plain(T['u'], T['v'], T['w'], None, T['p'], T['ue'],
                         T['ve'], T['we'], None, T['pe'], *r,
                         torch.as_tensor(grid.dzci), torch.as_tensor(grid.dzfi),
                         f1, f2, visc, dxi, dyi, bforce, sums=(True, True),
                         split='1d')
    for i in range(3):
        _close(got[i], ref[i], 1e-13)
    for i in range(3, 6):
        _close(got[i], ref[i], 1e-11)
    for g, r_ in zip(got[6:], ref[6:]):
        _close(g.sum(dim=1), np.asarray(r_)[:, ::8, 0].sum(axis=1), 1e-11)


@pytest.mark.parametrize('has_ruo', [False, True])
def test_mom_rk_twin_matches_pallas_cn_fold_with_sgs(has_ruo):
    """nu_t with split '1d' and the CN fold (the momentum pass of the LES
    with z-implicit diffusion, dsmag or smag): the eddy-viscosity z terms
    stay in the explicit RHS, as in the reference; only the molecular z
    diffusion is implicit."""
    cfg, grid, d = _setup(8)
    J, T = _J(d), _T(d)
    f1, f2, visc = 0.5e-3, (-0.2e-3 if has_ruo else 0.0), cfg.visc
    dxi, dyi = cfg.dli[:2]
    bforce = (0.1, 0.0, 0.02)
    ref = pk.fused_mom_rk(J['u'], J['v'], J['w'], J['s'], J['p'], J['ue'],
                          J['ve'], J['we'], J['se'], J['pe'], J['ruo'],
                          J['rvo'], J['rwo'], grid.dzci, grid.dzfi, f1, f2,
                          visc, dxi, dyi, bforce, interpret=True,
                          has_ruo=has_ruo, sum_flags=(True, True),
                          split='1d', fold_cn=True, has_sgs=True)
    r = (T['ruo'], T['rvo'], T['rwo']) if has_ruo else (None,) * 3
    got = K.mom_rk_plain(T['u'], T['v'], T['w'], T['s'], T['p'], T['ue'],
                         T['ve'], T['we'], T['se'], T['pe'], *r,
                         torch.as_tensor(grid.dzci), torch.as_tensor(grid.dzfi),
                         f1, f2, visc, dxi, dyi, bforce, sums=(True, True),
                         split='1d')
    for i in range(3):
        _close(got[i], ref[i], 1e-13)
    for i in range(3, 6):
        _close(got[i], ref[i], 1e-11)
    for g, r_ in zip(got[6:], ref[6:]):
        _close(g.sum(dim=1), np.asarray(r_)[:, ::8, 0].sum(axis=1), 1e-11)


@pytest.mark.parametrize('imp', ['explicit', 'impdiff_1d', 'impdiff'])
def test_correc_updatep_twin_matches_pallas(imp):
    """fused_correc_updatep with the deferred forcing fu/fv, and the
    alpha L(pp) pressure term (z-only or 3-D)."""
    cfg, grid, d = _setup(2)
    J, T = _J(d), _T(d)
    dxi, dyi = cfg.dli[:2]
    dtrk, fu, fv, alpha = 3.7e-3, 0.05, -0.02, -0.013
    impdiff, imp1d = imp != 'explicit', imp == 'impdiff_1d'
    ref = pk.fused_correc_updatep(
        J['u'], J['v'], J['w'], J['pp'], J['p'], J['we'], J['ppe'], dtrk,
        dxi, dyi, grid.dzci, interpret=True, alpha=alpha, impdiff=impdiff,
        impdiff_1d=imp1d, dzfi=grid.dzfi, fu=fu, fv=fv)
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64))  # noqa: E731
    got = K.correc_updatep_plain(
        T['u'], T['v'], T['w'], T['pp'], T['p'], T['we'], T['ppe'], dtrk,
        dxi, dyi, t(grid.dzci), t(grid.dzfi), t([fu, fv]), alpha=alpha,
        impdiff=impdiff, impdiff_1d=imp1d)
    for i in range(3):
        _close(got[i], ref[i], 1e-13)
    p_ref = np.asarray(ref[3])
    _close(got[3], p_ref, 1e-13 * np.abs(p_ref).max())


def test_fillps_twin_matches_pallas():
    cfg, grid, d = _setup(3)
    J, T = _J(d), _T(d)
    dti = 1.0 / 2.3e-3
    dxi, dyi = cfg.dli[:2]
    ref = pk.fused_fillps(J['u'], J['v'], J['w'], J['ue'], J['ve'], J['we'],
                          grid.dzfi, dti, dxi, dyi, interpret=True)
    got = K.fillps_plain(T['u'], T['v'], T['w'], T['ue'], T['ve'], T['we'],
                         torch.as_tensor(grid.dzfi), dti, dxi, dyi)
    _close(got, ref, 1e-13 * max(1.0, float(np.abs(np.asarray(ref)).max())))


@pytest.mark.parametrize('recipe', ['DD', 'NN', 'EE', 'ED'])
def test_correc_smag_twin_matches_pallas(recipe):
    """First unit-level test of fused_correc_updatep_smag: the deferred
    forcing fu/fv, non-zero wall-shear planes and the z-ghost recipes:
    'D', 'N', and the wall model's 'E' (fac_ex of the grid) on both faces
    or on the lower one beside a 'D' upper face."""
    cfg, grid, d = _setup(4)
    J, T = _J(d), _T(d)
    nx, ny, nz = NG
    dxi, dyi = cfg.dli[:2]
    dz01 = (float(grid.dzc[0]), float(grid.dzc[nz]))
    fac = (float(grid.dzc[0] * grid.dzci[1]),
           float(grid.dzc[nz] * grid.dzci[nz - 1]))
    if recipe == 'DD':
        zrec = (('D', 0.0, dz01[0], 'D', 0.0, dz01[1]),) * 2
    elif recipe == 'NN':
        zrec = (('N', 0.3, dz01[0], 'N', -0.2, dz01[1]),
                ('N', 0.1, dz01[0], 'D', 0.05, dz01[1]))
    elif recipe == 'EE':
        zrec = (('E', fac[0], 0.0, 'E', fac[1], 0.0),) * 2
    else:
        zrec = (('E', fac[0], 0.0, 'D', 0.0, dz01[1]),
                ('E', fac[0], 0.0, 'D', 0.05, dz01[1]))
    setup = tsgs.SGSSetup(cfg, grid, effective_cbcvel(cfg))
    csd2 = (C_SMAG * setup.delta) ** 2
    zc = grid.zc[1:nz + 1]
    dw = np.minimum(zc, cfg.l[2] - zc)
    nearlo = (zc <= cfg.l[2] - zc).astype(np.float64)
    rng = np.random.default_rng(5)
    tlo, thi = np.abs(rng.standard_normal((2, ny, nx)))
    dtrk, fu, fv = 3.7e-3, 0.05, -0.02
    ref = pk.fused_correc_updatep_smag(
        J['u'], J['v'], J['w'], J['pp'], J['p'], J['ue'], J['ve'], J['we'],
        J['ppe'], dtrk, dxi, dyi, grid.dzci, grid.dzfi, cfg.visc, csd2, zrec,
        dw_1d=dw, nearlo_1d=nearlo, tauw_lo=jnp.asarray(tlo),
        tauw_hi=jnp.asarray(thi), interpret=True, fu=fu, fv=fv)
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64))  # noqa: E731
    got = K.correc_smag_plain(
        T['u'], T['v'], T['w'], T['pp'], T['p'], T['ue'], T['ve'], T['we'],
        T['ppe'], dtrk, dxi, dyi, t(grid.dzci), t(grid.dzfi), cfg.visc,
        t(csd2), zrec, t([fu, fv]), t(dw), t(nearlo), t(tlo), t(thi))
    for i in range(4):
        _close(got[i], ref[i], 1e-13)
    s_ref = np.asarray(ref[4])
    _close(got[4], s_ref, 1e-12 * np.abs(s_ref).max())


@pytest.mark.parametrize('zwalls', [True, False])
def test_smag_twin_matches_pallas(zwalls):
    """fused_smag alone: the strain rate of the post-correction fill with
    van Driest damping from non-zero wall-shear planes (z walls), or
    (Cs Delta)^2 |S| without z walls."""
    cfg, grid, d = _setup(9)
    J, T = _J(d), _T(d)
    nx, ny, nz = NG
    dxi, dyi = cfg.dli[:2]
    setup = tsgs.SGSSetup(cfg, grid, effective_cbcvel(cfg))
    csd2 = (C_SMAG * setup.delta) ** 2
    zc = grid.zc[1:nz + 1]
    dw = np.minimum(zc, cfg.l[2] - zc)
    nearlo = (zc <= cfg.l[2] - zc).astype(np.float64)
    rng = np.random.default_rng(11)
    tlo, thi = np.abs(rng.standard_normal((2, ny, nx)))
    walls = (dict(dw_1d=dw, nearlo_1d=nearlo, tauw_lo=jnp.asarray(tlo),
                  tauw_hi=jnp.asarray(thi)) if zwalls else {})
    ref = np.asarray(pk.fused_smag(
        J['u'], J['v'], J['w'], J['ue'], J['ve'], J['we'], grid.dzci,
        grid.dzfi, dxi, dyi, cfg.visc, csd2, interpret=True, **walls))
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64))  # noqa: E731
    got = K.smag_plain(T['u'], T['v'], T['w'], T['ue'], T['ve'], T['we'],
                       t(grid.dzci), t(grid.dzfi), dxi, dyi, cfg.visc,
                       t(csd2), t(dw), t(nearlo), t(tlo), t(thi),
                       have_zwalls=zwalls)
    _close(got, ref, 1e-12 * np.abs(ref).max())


def test_wrappers_take_the_twin_on_cpu_without_launching():
    cfg, grid, d = _setup(6)
    T = _T(d)
    t = torch.as_tensor
    K.reset_launches()
    args = (T['u'], T['v'], T['w'], T['ue'], T['ve'], T['we'],
            t(grid.dzfi), 20.0, *cfg.dli[:2])
    torch.testing.assert_close(K.fillps(*args), K.fillps_plain(*args),
                               rtol=0, atol=0)
    assert K.LAUNCHES == {'mom_rk': 0, 'fillps': 0, 'correc_smag': 0,
                          'correc_updatep': 0, 'smag': 0, 'dsmag': 0,
                          'dsmag_level1': 0, 'dsmag_level2': 0,
                          'wallmodel': 0}


def test_wrapper_rejects_other_devices():
    cfg, grid, d = _setup(7)
    T = {k: v.to('meta') for k, v in _T(d).items()}
    with pytest.raises(ValueError, match='CPU .plain twin. or a CUDA'):
        K.fillps(T['u'], T['v'], T['w'], T['ue'], T['ve'], T['we'],
                 torch.zeros(NG[2] + 2, device='meta', dtype=torch.float64),
                 20.0, *cfg.dli[:2])
