"""FFT eigenfunction-expansion direct Poisson solver.

Counterpart of cales_tpu/poisson.py (reference initsolver.f90:17-169,
solver.f90:20-233, bound.f90:447-617).  The setup (tridmatrix, the z
eigendecomposition, rhs_bound_planes) is numpy, copied from the JAX module,
which imports jax.  The solve is the JAX package's non-Pallas branch with
periodic x and y: rfft along x, fft along y (cuFFT on the card), then the
z stage as two real (nz, nz) matmuls against the eigenvectors of the z
operator, acting on the real and imaginary parts at once, with the
singular constant mode projected out, then the inverse transforms.

Not in this slice (each raises NotImplementedError naming its ROADMAP
item): operator-matrix ('mat') transforms, the Thomas z solver, and the
Helmholtz (alpha) variant of the implicit-diffusion solves.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from cales_tpu.config import Config
from cales_tpu.grid import Grid

from .ops import transforms as tr


def tridmatrix(bc: str, n: int, dzci: np.ndarray, dzfi: np.ndarray,
               c_or_f: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """z tridiagonal coefficients (initsolver.f90:127-169).  dzci/dzfi are
    the (n+2,) inverse-spacing arrays with ghost entries."""
    k = np.arange(1, n + 1)
    if c_or_f == 'c':
        a = dzfi[k] * dzci[k - 1]
        c = dzfi[k] * dzci[k]
    else:
        a = dzfi[k] * dzci[k]
        c = dzfi[k + 1] * dzci[k]
    b = -(a + c)
    factor = {'P': 0.0, 'D': -1.0, 'N': 1.0}
    if c_or_f == 'c':
        b[0] += factor[bc[0]] * a[0]
        b[-1] += factor[bc[1]] * c[-1]
    else:
        if bc[0] == 'N':
            b[0] += factor[bc[0]] * a[0]
        if bc[1] == 'N':
            b[-1] += factor[bc[1]] * c[-1]
    return a, b, c


def _z_eigendecomposition(a, b, c, weights, periodic):
    """Eigendecomposition of the z tridiagonal operator T (matrix
    diagonalization method).  T is similar to a symmetric matrix via
    D^{1/2}, D = diag(weights), so T = D^{-1/2} Q L Q^T D^{1/2} with Q
    orthonormal from eigh; a general eigendecomposition is the fallback.
    Returns (Vl, Vr, lamz) float64 with solve((T + s I) x = r) as
    x = Vr @ (Vl @ r / (lamz + s))."""
    n = len(b)
    T = np.zeros((n, n))
    for k in range(n):
        T[k, k] = b[k]
        if k > 0:
            T[k, k - 1] = a[k]
        if k < n - 1:
            T[k, k + 1] = c[k]
    if periodic:
        T[0, n - 1] = a[0]
        T[n - 1, 0] = c[n - 1]
    d = np.sqrt(weights[1:n + 1])
    M = (d[:, None] * T) / d[None, :]
    if np.allclose(M, M.T, rtol=1e-12, atol=1e-12):
        lamz, Q = np.linalg.eigh(0.5 * (M + M.T))
        Vl = Q.T * d[None, :]          # Q^T D^{1/2}
        Vr = Q / d[:, None]            # D^{-1/2} Q
    else:
        lam_c, V = np.linalg.eig(T)
        if np.abs(lam_c.imag).max() > 1e-10 or np.abs(V.imag).max() > 1e-10:
            raise ValueError(
                "z operator has a complex eigendecomposition (periodic z with "
                "a stretched grid?); use zsolver='thomas' for this config")
        idx = np.argsort(lam_c.real)
        lamz = lam_c.real[idx]
        Vr = V.real[:, idx]
        Vl = np.linalg.inv(Vr)
    return Vl, Vr, lamz


@dataclass(frozen=True)
class DirectSolver:
    """Prebuilt direct solver for one field (numpy setup, float64)."""
    ng: tuple[int, int, int]
    c_or_f: tuple[str, str, str]
    bcx: str
    bcy: str
    bcz: str
    trx: tr.Transform1D
    try_: tr.Transform1D
    a: np.ndarray
    b: np.ndarray
    c: np.ndarray
    lamx: np.ndarray       # scaled by dxi^2, full length
    lamy: np.ndarray       # scaled by dyi^2
    zVl: np.ndarray | None = None
    zVr: np.ndarray | None = None
    lamz: np.ndarray | None = None
    zsolver: str = 'eig'
    # device operators per (dtype, device), built at first use
    _ops: dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def qz(self) -> int:
        # last z plane excluded for face-staggered Dirichlet top (solver.f90:55-56)
        return 1 if (self.c_or_f[2] == 'f' and self.bcz[1] == 'D') else 0


def make_solver(cfg: Config, grid: Grid, cbc, c_or_f,
                zsolver: str = 'eig') -> DirectSolver:
    """cbc: per-direction BC pairs [(lo,hi) x 3] as two-letter strings.
    ptransform 'auto' resolves to 'fft', as it does off a TPU in the JAX
    package."""
    nx, ny, nz = cfg.ng
    dli = cfg.dli
    pp_mat = getattr(cfg, 'ptransform', 'auto') == 'mat'
    trx = tr.make_transform(cbc[0], c_or_f[0], nx, pp_mat=pp_mat)
    try_ = tr.make_transform(cbc[1], c_or_f[1], ny, pp_mat=pp_mat)
    a, b, c = tridmatrix(cbc[2], nz, grid.dzci, grid.dzfi, c_or_f[2])
    lamx = trx.lam * dli[0] ** 2
    lamy = try_.lam * dli[1] ** 2
    qz = 1 if (c_or_f[2] == 'f' and cbc[2][1] == 'D') else 0
    nzs = nz - qz
    weights = grid.dzf if c_or_f[2] == 'c' else grid.dzc
    zVl = zVr = lamz = None
    if zsolver == 'eig':
        zVl, zVr, lamz = _z_eigendecomposition(a[:nzs], b[:nzs], c[:nzs],
                                               weights, cbc[2] == 'PP')
    return DirectSolver(ng=cfg.ng, c_or_f=tuple(c_or_f), bcx=cbc[0], bcy=cbc[1],
                        bcz=cbc[2], trx=trx, try_=try_, a=a, b=b, c=c,
                        lamx=lamx, lamy=lamy, zVl=zVl, zVr=zVr, lamz=lamz,
                        zsolver=zsolver)


def _check_in_slice(sv: DirectSolver, alpha):
    if alpha is not None:
        raise NotImplementedError(
            'Helmholtz solve (implicit diffusion) is not ported yet: '
            'ROADMAP queue 1, implicit CN')
    if sv.zsolver != 'eig':
        raise NotImplementedError(
            "zsolver='thomas' is not ported yet: ROADMAP queue 2, "
            'apply_thomas_z')
    if sv.trx.kind != 'fft' or sv.try_.kind != 'fft':
        raise NotImplementedError(
            "operator-matrix ('mat') transforms are not ported yet: ROADMAP "
            'queue 1, the Poisson kernels and the mat-vs-fft decision '
            '(non-periodic x/y or ptransform=mat)')


def _eig_ops(sv: DirectSolver, rdt: torch.dtype, device: torch.device):
    """(Vl, Vr, inv) on the device in the real dtype rdt: inv = 1/lam over
    the (nz, ny, nx//2+1) spectral grid, zero for the singular mode."""
    key = (rdt, device)
    if key not in sv._ops:
        nx = sv.ng[0]
        lamx_np = sv.lamx[: nx // 2 + 1]
        lamy_np = sv.lamy
        lamxy = (torch.as_tensor(lamy_np, dtype=rdt, device=device)[:, None]
                 + torch.as_tensor(lamx_np, dtype=rdt, device=device)[None, :])
        lamz = torch.as_tensor(sv.lamz, dtype=rdt, device=device)
        lam3 = lamz[:, None, None] + lamxy[None, :, :]
        # project out the (exactly) singular constant mode instead of the
        # reference's eps-regularized pivot (solver.f90:165-169)
        scale = float(np.abs(sv.lamz).max() + np.abs(lamx_np).max()
                      + np.abs(lamy_np).max())
        tol = torch.finfo(rdt).eps * scale * 4.0
        inv = torch.where(lam3.abs() > tol, 1.0 / lam3,
                          torch.zeros_like(lam3))
        sv._ops[key] = (torch.as_tensor(sv.zVl, dtype=rdt, device=device),
                        torch.as_tensor(sv.zVr, dtype=rdt, device=device),
                        inv)
    return sv._ops[key]


def _zmatmul(mat, zc):
    """mat (n, n) @ complex zc (n, ...) along axis 0, the real and
    imaginary parts in one real matmul."""
    zr = torch.view_as_real(zc.contiguous())
    out = torch.matmul(mat, zr.reshape(zr.shape[0], -1))
    return out.reshape(zr.shape)


def solve(sv: DirectSolver, p, alpha=None):
    """Solve L p_new = p for the (nz, ny, nx) RHS p; returns the solution
    in p's dtype."""
    _check_in_slice(sv, alpha)
    nz, ny, nx = p.shape
    rdt = p.dtype
    Vl, Vr, inv = _eig_ops(sv, rdt, p.device)
    body = tr.fwd(sv.trx, p, axis=-1)        # rfft along x
    body = tr.fwd(sv.try_, body, axis=-2)    # fft along y (complex input)
    qz = sv.qz
    zbody = body[: nz - qz]
    hat = _zmatmul(Vl, zbody) * inv[..., None]
    zsol = torch.view_as_complex(_zmatmul(Vr, torch.view_as_complex(hat)))
    body = torch.cat([zsol, body[nz - qz:]], dim=0) if qz else zsol
    body = tr.bwd(sv.try_, body, axis=-2, n=ny, real_out=False)
    body = tr.bwd(sv.trx, body, axis=-1, n=nx, real_out=True)
    return body.to(p.dtype)


# ---------------------------------------------------------------------------
# BC inhomogeneity planes (bound.f90:447-617)
# ---------------------------------------------------------------------------

def rhs_bound_planes(cfg: Config, grid: Grid, cbc, c_or_f, bcvals):
    """Additive RHS boundary planes (cmpt_rhs_b/bc_rhs, bound.f90:447-560).
    bcvals[idir][ibound]: scalars or 2-D arrays.  Returns
    {('x'|'y'|'z', 0|1): plane ndarray}."""
    nx, ny, nz = cfg.ng
    dl = cfg.dl
    dzc, dzf = grid.dzc, grid.dzf
    if c_or_f[2] == 'c':
        dzc01 = (dzc[0], dzc[nz])
        dzf01 = (dzf[1], dzf[nz])
    else:
        dzc01 = (dzc[1], dzc[nz - 1])
        dzf01 = (dzf[1], dzf[nz])
    metr = {
        0: ((dl[0], dl[0]), (dl[0], dl[0])),
        1: ((dl[1], dl[1]), (dl[1], dl[1])),
        2: (dzc01, dzf01),
    }
    out = {}
    for idir, key in ((0, 'x'), (1, 'y'), (2, 'z')):
        dlc, dlf = metr[idir]
        for ib in range(2):
            bcv = np.asarray(bcvals[idir][ib], dtype=np.float64)
            letter = cbc[idir][ib]
            cf = c_or_f[idir]
            if letter == 'P':
                plane = bcv * 0.0
            elif letter == 'D':
                fac = 2.0 if cf == 'c' else 1.0
                plane = -fac * bcv / (dlc[ib] * dlf[ib])
            else:  # 'N'
                sgn = 1.0 if ib == 0 else -1.0
                div = dlf[ib] if cf == 'c' else dlc[ib]
                plane = sgn * bcv / div
            out[(key, ib)] = plane
    return out


def add_rhs_bound(cfg: Config, c_or_f, cbc, rhs, planes):
    """Add the boundary planes onto the solver RHS (updt_rhs_b,
    bound.f90:562-617).  All-zero planes (homogeneous BCs, the channel)
    return rhs unchanged."""
    if all(np.all(np.asarray(p) == 0.0) for p in planes.values()):
        return rhs
    nx, ny, nz = cfg.ng
    q = [0, 0, 0]
    for idir in range(3):
        if c_or_f[idir] == 'f' and cbc[idir][1] == 'D':
            q[idir] = 1

    def t(key):
        return torch.as_tensor(planes[key], dtype=rhs.dtype, device=rhs.device)
    rhs = rhs.clone()
    rhs[:, :, 0] += t(('x', 0))
    rhs[:, :, nx - 1 - q[0]] += t(('x', 1))
    rhs[:, 0, :] += t(('y', 0))
    rhs[:, ny - 1 - q[1], :] += t(('y', 1))
    rhs[0, :, :] += t(('z', 0))
    rhs[nz - 1 - q[2], :, :] += t(('z', 1))
    return rhs
