"""Eigenfunction-expansion direct Poisson and Helmholtz solvers.

Counterpart of cales_tpu/poisson.py (reference initsolver.f90:17-169,
solver.f90:20-233, bound.f90:447-617).  The setup (tridmatrix, the z
eigendecomposition, rhs_bound_planes) is numpy, copied from the JAX module,
which imports jax.  Periodic x takes one of two transform routes:

  'fft'  rfft along x (cuFFT on the card), then the y stage on the
         complex half spectrum: an FFT along y with periodic y, or with y
         walls (the mixed route, the JAX package's XLA solve with
         x_was_fft, poisson.py:414-436) the DCT matrix by the apply_y
         kernel, M alone, on its real view (nz, ny, 2 (nx/2 + 1)), the
         real and imaginary parts as interleaved x lanes; then the z stage
         on the lanes: two real (nz, nz) matmuls against the z
         eigenvectors (zsolver 'eig'), or the Thomas kernel on the real
         view (zsolver 'thomas'); and back;
  'mat'  the JAX kernel path's unfused solve (poisson.solve(pallas=True,
         pre_xformed_x=False)): apply_y with the x operator fused
         (forward), the z stage (z_eig, or thomas_z from nz >= 384 or with
         zsolver 'thomas'), apply_y (backward), all hand-written kernels
         (ops/solve_kernels.py).

With alpha, solve is the Helmholtz solve (I + alpha L) of full-3D
implicit diffusion, one per velocity component: the same transforms
around a z stage on the alpha-scaled rows, Thomas on the 'mat' route
(thomas_z, or thomas_periodic with periodic z, never pinned), the eigen
stage with 1/(1 + alpha lam) or Thomas on the 'fft' route; the
face-staggered Dirichlet tail row (w with z walls) passes through.  With
periodic z the Poisson solve's Thomas stage is the rank-1 periodic kernel
(thomas_periodic, pinned on the constant mode).

solve_z_only is the z-only Crank-Nicolson Helmholtz solve of the
implicit-diffusion path (impdiff_1d) through the Thomas kernel, with the
bulk-forcing shift, the boundary planes and the face-staggered tail row
inside the kernel (the periodic kernel with periodic z).

On a y-slab mesh (dims = (gy, 1), parallel/mesh.py) solve_sharded is the
slab-sharded Poisson solve: on the 'mat' route the JAX package's
kernel-sharded route (poisson.solve_sharded_pallas): apply_x while x is
local, the pencil transpose (split x, gather y), apply_y along y only,
thomas_z on this rank's x columns, apply_y back, the transpose back,
apply_x back; on the 'fft' route the JAX package's sharded XLA solve
(poisson.solve with hints): the rfft along x on the slab, the transpose
of the half spectrum's lanes (split kx, gather y), the y stage and the z
stage of the one-device route on this rank's lanes, and back.  With alpha
the full-3D Helmholtz solve of each velocity component by the same route
(its tail row passing through); the z-only solves (solve_z_only) need no
communication and run on each slab.  On a pencil mesh (dims (gy, gx),
gx > 1) solve_sharded re-slabs: an all-to-all inside the mesh row turns
the pencil into a y slab of gy gx, the slab route runs on those, and one
more turns it back; the z-only solves run on each pencil's columns.

With y walls (homogeneous-Neumann pressure, the duct and cavity classes)
the y operator is a DCT matrix, on the 'mat' route as on the mixed one:
apply_y and the z stages take whatever operator and eigenvalues the
transforms hold, so no kernel changes.

With x walls (the developing channel: pressure 'ND' along x, a DCT-IV;
the closed box, the cavity and the developing duct: 'NN', a DCT-II) the x
operator is a square DCT matrix too, fused into apply_y as MxT, and the
route is 'mat' (there is no FFT along a walled x).

Not in this slice (each raises NotImplementedError naming its ROADMAP
item): transforms with excluded x or y rows (a field face-staggered
across an x or y wall), and an FFT along y with a matrix along x.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .config import Config
from .grid import Grid

from .ops import solve_kernels as sk
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
    package, except with y walls: there the y transform is a matrix
    whatever 'auto' says, and 'auto' takes 'mat' along x too, the all-matrix
    route of apply_y and z_eig, rather than the JAX package's mixed route
    off a TPU (rfft along x and the y matrix, poisson.py:414-430); with x
    walls, where there is no FFT along x and 'auto' takes the matrix along
    y too (the x operator a square DCT, ND or NN for the pressure, through
    apply_y's fused MxT); and on a device mesh (dims), where the sharded
    solve is the all-matrix route, as 'auto' resolves on the TPU
    (poisson.py:138-141).  An explicit 'fft' takes the FFT along every
    periodic direction and the matrix along a walled one, on one device
    and on the mesh: with y walls the mixed route (rfft along x, the y
    DCT matrix)."""
    nx, ny, nz = cfg.ng
    dli = cfg.dli
    mode = getattr(cfg, 'ptransform', 'auto')
    meshed = cfg.dims[0] * cfg.dims[1] > 1
    pp_mat = mode == 'mat' or (mode == 'auto' and (
        cbc[0] != 'PP' or cbc[1] != 'PP' or meshed))
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


def _dev(sv: DirectSolver, name: str, dtype, device, build):
    """Device operand `name` of solver sv in dtype on device, built once."""
    key = (name, dtype, device)
    if key not in sv._ops:
        sv._ops[key] = build()
    return sv._ops[key]


def _t(a, dtype, device):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                           device=device)


def uses_thomas(sv: DirectSolver) -> bool:
    """The z stage of the Poisson solve: the Thomas kernel, or the
    eigendecomposition.  The JAX package's rule: 'mat' transforms take
    Thomas from nz >= 384 (poisson.py:369-393, measured on the TPU) and
    with zsolver 'thomas'; 'fft' transforms take it with zsolver 'thomas'
    only."""
    if sv.zsolver == 'thomas':
        return True
    return sv.trx.kind == 'mat' and sv.ng[2] >= 384


def _check_in_slice(sv: DirectSolver, alpha):
    """The transforms both routes take: square ones (no excluded x or y
    row), an FFT along y only with one along x, and a tail row only with
    alpha."""
    nx, ny, _ = sv.ng
    if (sv.trx.kind, sv.try_.kind) == ('mat', 'fft') \
            or sv.trx.nsolve != nx or sv.try_.nsolve != ny \
            or (sv.qz and alpha is None):
        raise NotImplementedError(
            'transforms with excluded rows or an FFT along y with a matrix '
            'along x, or a Poisson solve of a face-staggered field, are not '
            'ported yet: ROADMAP queue 1, BC topologies')


def _eig_tol(sv: DirectSolver, lamx_np) -> float:
    """Below this |lamz + lamy + lamx| the eigen z stage takes a mode for
    the singular one and zeroes it.  The eigenvalues come from the float64
    setup, so the bound is float64's rounding of the spectrum's scale,
    whatever the working precision.  (The JAX package scales it by the
    working precision's eps, poisson.py:387-389: in float32 on a strongly
    stretched z grid, where the largest lamz is ~1e7, that bound reaches
    ~5 and zeroes dozens of the largest-scale pressure modes, and the
    corrected field keeps a divergence of ~1e-2.)"""
    scale = float(np.abs(sv.lamz).max() + np.abs(lamx_np).max()
                  + np.abs(sv.lamy).max())
    return float(np.finfo(np.float64).eps * scale * 4.0)


def _eig_ops(sv: DirectSolver, rdt: torch.dtype, device: torch.device,
             lamx_np, key):
    """(Vl, Vr, lam3, inv) on the device in the real dtype rdt over the
    (nz - qz, ny, n) spectral grid whose n x lanes carry lamx_np (the
    half spectrum's nx//2+1, or a slab's lanes of it, key naming them in
    the device cache): lam3 = lamz + lamy + lamx, inv = 1/lam3 and zero
    for the singular mode (the Poisson solve), by a tolerance from the
    whole spectrum."""
    nxh = sv.ng[0] // 2 + 1

    def build():
        lamxy = (torch.as_tensor(sv.lamy, dtype=rdt, device=device)[:, None]
                 + torch.as_tensor(lamx_np, dtype=rdt, device=device)[None, :])
        lamz = torch.as_tensor(sv.lamz, dtype=rdt, device=device)
        lam3 = lamz[:, None, None] + lamxy[None, :, :]
        # project out the (exactly) singular constant mode instead of the
        # reference's eps-regularized pivot (solver.f90:165-169)
        tol = _eig_tol(sv, sv.lamx[:nxh])
        inv = torch.where(lam3.abs() > tol, 1.0 / lam3,
                          torch.zeros_like(lam3))
        return (torch.as_tensor(sv.zVl, dtype=rdt, device=device),
                torch.as_tensor(sv.zVr, dtype=rdt, device=device), lam3, inv)
    return _dev(sv, key, rdt, device, build)


def _real_view(spec):
    """The real view (..., 2 n) of a complex (..., n) spectrum: the real
    and imaginary parts of each lane as two interleaved x lanes."""
    return torch.view_as_real(spec.contiguous()).reshape(
        *spec.shape[:-1], 2 * spec.shape[-1])


def _complex_view(re):
    """The complex (..., n) spectrum of a real view (..., 2 n) whose last
    dim lies contiguous."""
    return torch.view_as_complex(re.reshape(*re.shape[:-1],
                                            re.shape[-1] // 2, 2))


def _zmatmul(mat, zc):
    """mat (n, n) @ complex zc (n, ...) along axis 0, the real and
    imaginary parts in one real matmul."""
    zr = torch.view_as_real(zc.contiguous())
    out = torch.matmul(mat, zr.reshape(zr.shape[0], -1))
    return out.reshape(zr.shape)


def _abc(sv: DirectSolver, device):
    """The z tridiagonal rows as float64 tensors on device."""
    return _dev(sv, 'abc', torch.float64, device,
                lambda: tuple(_t(q, torch.float64, device)
                              for q in (sv.a, sv.b, sv.c)))


def _thomas_tol(lamx, lamy, dtype) -> float:
    """Singular-lane tolerance of the pinned Thomas z stage
    (poisson.py:375-376)."""
    scale = float(np.abs(lamx).max() + np.abs(lamy).max())
    return float(torch.finfo(dtype).eps * scale * 4.0)


def _holds_singular(lamx_np, lamy_np, tol) -> bool:
    """Whether the lanes (lamy[j] + lamx[i]) of a spectrum whose x lanes
    carry lamx_np hold the singular one, |lamy + lamx| <= tol: on a slab
    of the sharded solve, the rank whose slice of sv.lamx holds it, in
    whatever order the x transform leaves its eigenvalues."""
    lam = np.asarray(lamx_np)[None, :] + np.asarray(lamy_np)[:, None]
    return bool(np.any(np.abs(lam) <= tol))


def _z_thomas(sv: DirectSolver, body, lamx_np, alpha=None, key='lamx'):
    """Thomas z stage on a real (nz, ny, n) spectrum whose x lanes carry
    the eigenvalues lamx_np (n,) (key names them in the device cache): the
    Poisson solve, its singular lane pinned where z is periodic or
    all-Neumann by a tolerance from the whole spectrum sv.lamx (a slab's
    lanes are a slice of it), or with alpha the Helmholtz
    solve (I + alpha L) on the alpha-scaled rows with the diagonal shift
    (lamy + lamx) alpha (poisson.py:326-338), the face-staggered Dirichlet
    tail row passed through.  The pin flag is set where these lanes hold
    the singular lane (_holds_singular): on one rank of a slab-sharded
    solve."""
    dt, dev = body.dtype, body.device
    lamy = _dev(sv, 'lamy', torch.float64, dev,
                lambda: _t(sv.lamy, torch.float64, dev))
    lamx = _dev(sv, (key, len(lamx_np)), torch.float64, dev,
                lambda: _t(lamx_np, torch.float64, dev))
    # the rows scaled in float64 and rounded once, as the JAX package's
    # host-side numpy scaling rounds them
    if alpha is not None:
        lamy, lamx = lamy * alpha, lamx * alpha
    lamy, lamx = lamy.to(dt), lamx.to(dt)
    a, b, c = _abc(sv, dev)
    tol = _thomas_tol(sv.lamx, sv.lamy, dt)
    pin = (alpha is None and sv.bcz in ('PP', 'NN')
           and _dev(sv, ('pin', key, len(lamx_np)), dt, None,
                    lambda: _holds_singular(lamx_np, sv.lamy, tol)))
    kw = dict(lamy=lamy, lamx=lamx, pin=pin, alpha=alpha,
              tol=tol if pin else 0.0)
    if sv.bcz == 'PP':
        return sk.thomas_periodic_z(body, a, b, c, **kw)
    nz = body.shape[0]
    return sk.thomas_z(body, a, b, c, n_solve=nz - sv.qz if sv.qz else None,
                       **kw)


def _y_stage(sv: DirectSolver, spec, inverse=False):
    """The y stage of the 'fft' route on the complex spectrum spec (nz, ny,
    n) along x: the FFT along y (periodic y), or the y transform's matrix
    by the apply_y kernel on its real view (y walls: the mixed route), the
    real and imaginary lanes alike."""
    if sv.try_.kind == 'fft':
        fft = torch.fft.ifft if inverse else torch.fft.fft
        return fft(spec, dim=1)
    dt, dev = spec.dtype.to_real(), spec.device
    fy, by = _dev(sv, 'ymat', dt, dev, lambda: (
        _t(sv.try_.fwd_mat, dt, dev), _t(sv.try_.bwd_mat, dt, dev)))
    return _complex_view(sk.apply_y(_real_view(spec), by if inverse else fy))


def _z_stage_fft(sv: DirectSolver, spec, lamx_np, alpha=None, key='lamx'):
    """The z stage of the 'fft' route on the complex spectrum spec (nz,
    ny, n) whose x lanes carry lamx_np: the Thomas kernel on its real
    view, each lane's eigenvalue on its real and imaginary lanes, or the z
    eigen matmuls on rows 0 .. nz-qz-1 (the face-staggered Dirichlet tail
    row passes through, poisson.py:446-490); key names the lanes in the
    device cache."""
    if uses_thomas(sv):
        return _complex_view(_z_thomas(sv, _real_view(spec),
                                       np.repeat(lamx_np, 2), alpha,
                                       key=key))
    nzs = spec.shape[0] - sv.qz
    Vl, Vr, lam3, inv = _eig_ops(sv, spec.dtype.to_real(), spec.device,
                                 lamx_np, key=('eig_fft', key))
    if alpha is not None:
        inv = 1.0 / (lam3 * alpha + 1.0)
    hat = _zmatmul(Vl, spec[:nzs]) * inv[..., None]
    zsol = torch.view_as_complex(_zmatmul(Vr, torch.view_as_complex(hat)))
    return torch.cat([zsol, spec[nzs:]]) if sv.qz else zsol


def _solve_fft(sv: DirectSolver, p, alpha=None):
    nx = p.shape[-1]
    spec = torch.fft.rfft(p, dim=-1)
    spec = _y_stage(sv, spec)
    spec = _z_stage_fft(sv, spec, sv.lamx[:nx // 2 + 1], alpha)
    spec = _y_stage(sv, spec, inverse=True)
    return torch.fft.irfft(spec, n=nx, dim=-1).to(p.dtype)


def _solve_mat(sv: DirectSolver, p, alpha=None):
    dt, dev = p.dtype, p.device
    ops = _dev(sv, 'mat', dt, dev, lambda: tuple(_t(m, dt, dev) for m in (
        sv.try_.fwd_mat, sv.trx.fwd_mat.T, sv.try_.bwd_mat,
        sv.trx.bwd_mat.T)))
    fy, fxT, by, bxT = ops
    body = sk.apply_y(p, fy, MxT=fxT)
    if alpha is not None or uses_thomas(sv):
        # the Helmholtz solve takes the Thomas z stage at any nz, as the
        # JAX package's aliased Helmholtz pipeline does (poisson.py:314-340)
        body = _z_thomas(sv, body, sv.lamx, alpha)
    else:
        Vl, Vr, lamz, lamy, lamx = _dev(sv, 'eig_mat', dt, dev, lambda: tuple(
            _t(q, dt, dev) for q in (sv.zVl, sv.zVr, sv.lamz, sv.lamy,
                                     sv.lamx)))
        body = sk.z_eig(body, Vl, Vr, lamz, lamy, lamx,
                        _eig_tol(sv, sv.lamx))
    return sk.apply_y(body, by, MxT=bxT)


def solve(sv: DirectSolver, p, alpha=None):
    """Solve L p_new = p (Poisson) or, with alpha, (I + alpha L) p_new = p
    (the full-3D Crank-Nicolson Helmholtz solve, main.f90:424-443, alpha =
    -nu dt_rk / 2) for the (nz, ny, nx) RHS p; returns the solution in p's
    dtype.  The singular constant mode of the Poisson solve (all-Neumann or
    periodic) is projected out (eig) or pinned (Thomas), so the solution
    is defined up to that gauge.  The face-staggered Dirichlet tail row of
    a Helmholtz solve (qz = 1) passes through."""
    _check_in_slice(sv, alpha)
    if sv.trx.kind == 'mat':
        return _solve_mat(sv, p, alpha)
    return _solve_fft(sv, p, alpha)


def solve_sharded(sv: DirectSolver, p, mesh, alpha=None):
    """The slab-sharded Poisson solve of this rank's (nz, ny/gy, nx) RHS
    slab p on `mesh` (parallel/mesh.SlabMesh), or with alpha the Helmholtz
    solve (I + alpha L) of full-3D implicit diffusion, one per velocity
    component (the JAX package's CN stage on its mesh,
    timeloop.py:2360-2413).  On the 'mat' route
    (poisson.solve_sharded_pallas):

      apply_x forward, written as gy x-column blocks      (nz, ny/gy, nx)
      all-to-all: split x, gather y                       (nz, ny, nx/gy)
      apply_y along y; thomas_z (thomas_periodic with
      periodic z) on this rank's lamx lanes: the
      Poisson solve's singular lane pinned where bcz
      is 'NN' or 'PP' on the rank that holds it; with
      alpha the alpha-scaled rows, the (lamy + lamx)
      alpha shift and no pin, the face-staggered
      Dirichlet tail row (w with z walls) passed
      through; apply_y back
      all-to-all back                                     (nz, ny/gy, nx)
      apply_x backward, reading the blocks in place

    The z stage is Thomas at every nz, as the JAX route takes it, so the
    result matches the single-device solve (z_eig below nz = 384) to
    rounding and, for the Poisson solve, up to the gauge of the constant
    mode.  With periodic z (the triperiodic box) the pinned periodic
    Thomas takes the JAX package's single-device z stage's place
    (thomas_periodic, poisson.py:575-576): the result differs from it by a
    constant.  On the 'fft' route (_solve_fft_sharded) the one-device
    route's stages on this rank's lanes of the half spectrum.  Which
    configurations come here is timeloop.unsupported()'s to say; the
    solver takes what the one-device solve takes (_check_in_slice).

    On a pencil mesh (dims (gy, gx), gx > 1) p is this rank's (nz, ny/gy,
    nx/gx) pencil: one all-to-all inside its mesh row turns it into its y
    slab of the world's P = gy gx (mesh.pencil_to_slab), the slab route
    above runs on those P slabs (mesh.slab: apply_x split P, the world's
    all-to-all, ..., or the 'fft' route's stages on ceil((nx/2 + 1)/P)
    lanes a rank), and one more turns the result back: four all-to-alls a
    solve where the slab takes two, no kernel changed, the singular lane
    rank 0's.  The JAX package takes GSPMD's pencil sequence there
    (poisson.solve with hints); the two agree to rounding and the gauge
    of the constant mode."""
    if mesh.gx > 1:
        return mesh.slab_to_pencil(solve_sharded(
            sv, mesh.pencil_to_slab(p), mesh.slab, alpha=alpha))
    _check_in_slice(sv, alpha)
    if sv.trx.kind == 'fft':
        return _solve_fft_sharded(sv, p, mesh, alpha)
    dt, dev = p.dtype, p.device
    fy, fxT, by, bxT = _dev(sv, 'mat', dt, dev, lambda: tuple(
        _t(m, dt, dev) for m in (sv.try_.fwd_mat, sv.trx.fwd_mat.T,
                                 sv.try_.bwd_mat, sv.trx.bwd_mat.T)))
    nxl = mesh.nxl
    lamx_l = sv.lamx[mesh.rank * nxl:(mesh.rank + 1) * nxl]
    body = mesh.transpose_y_to_x(sk.apply_x(p, fxT, split=mesh.gy))
    body = sk.apply_y(body, fy)
    body = _z_thomas(sv, body, lamx_l, alpha, key=('lamx_slab', mesh.rank))
    body = sk.apply_y(body, by)
    return sk.apply_x(mesh.transpose_x_to_y(body), bxT)


def fft_slab_lamx(sv: DirectSolver, mesh) -> np.ndarray:
    """The x eigenvalues of this rank's kx lanes on the 'fft' route of the
    y-slab mesh: the half spectrum's nxh = nx/2 + 1 lanes padded to gy
    mesh.kx_lanes(nxh) with the Nyquist eigenvalue (dead lanes, never
    singular), this rank's block of them."""
    nx = sv.ng[0]
    nxh = nx // 2 + 1
    nkl = mesh.kx_lanes(nxh)
    lamx = np.concatenate([sv.lamx[:nxh],
                           np.full(mesh.gy * nkl - nxh, sv.lamx[nx // 2])])
    return lamx[mesh.rank * nkl:(mesh.rank + 1) * nkl]


def _solve_fft_sharded(sv: DirectSolver, p, mesh, alpha=None):
    """The 'fft' route on the y-slab mesh (the JAX package's sharded XLA
    solve, poisson.solve with hints; the reference's solver_gpu.f90:80-158
    transposes):

      rfft along x on the slab, its real view           (nz, ny/gy, 2 nxh)
      all-to-all: split the kx lanes, gather y          (nz, ny, 2 nkl)
      the y stage (the FFT along y, or apply_y with the
      DCT matrix: the mixed route), the z stage of the
      one-device route on this rank's lanes, the y
      stage back
      all-to-all back, irfft along x                    (nz, ny/gy, nx)

    The nxh = nx/2 + 1 lanes of the half spectrum are padded to gy nkl,
    nkl = ceil(nxh / gy) a rank (parallel/mesh.SlabMesh.kx_lanes): every
    rank sends and receives blocks of one size, and the dead lanes (zero,
    the Nyquist eigenvalue, never singular) are dropped on the way back.
    The singular lane (kx, ky) = (0, 0) is rank 0's: the eigen stage
    projects it, Thomas pins it, by tolerances from the whole spectrum.
    The result equals the one-device 'fft' solve to rounding, its gauge
    included."""
    nz, nyl, nx = p.shape
    gy, nxh = mesh.gy, nx // 2 + 1
    nkl = mesh.kx_lanes(nxh)
    re = _real_view(torch.fft.rfft(p, dim=-1))
    if gy * nkl > nxh:
        re = torch.nn.functional.pad(re, (0, 2 * (gy * nkl - nxh)))
    blocks = re.reshape(nz, nyl, gy, 2 * nkl).permute(2, 0, 1, 3)
    spec = _complex_view(mesh.transpose_y_to_x(blocks.contiguous()))
    spec = _y_stage(sv, spec)
    spec = _z_stage_fft(sv, spec, fft_slab_lamx(sv, mesh), alpha,
                        key=('lamx_fft_slab', mesh.rank))
    spec = _y_stage(sv, spec, inverse=True)
    back = mesh.transpose_x_to_y(_real_view(spec)).permute(1, 2, 0, 3)
    re = back.reshape(nz, nyl, gy * 2 * nkl)[..., :2 * nxh]
    return torch.fft.irfft(_complex_view(re), n=nx, dim=-1).to(p.dtype)


def solve_z_only(sv: DirectSolver, p, alpha, shift=None, bc_planes=None):
    """z-implicit-only Helmholtz solve (I + alpha*Lz) p_new = p
    (solver_gaussel_z, solver.f90:182-233; the impdiff_1d path) through
    the Thomas kernel, as cales_tpu's solve_z_only(pallas=True) runs it,
    or with periodic z through the periodic Thomas kernel's unshifted
    Helmholtz variant (the JAX package runs thomas_periodic there,
    poisson.py:575-576).

    shift: (1,) tensor added to every RHS row, the pass-through tail
    included (the folded bulk-forcing add); bc_planes: ((ny, nx) lo, hi)
    z-face RHS planes added to rows 0 and nz - qz - 1.  The face-staggered
    Dirichlet row (qz = 1) passes through."""
    nz = p.shape[0]
    a, b, c = _abc(sv, p.device)
    lo, hi = (None, None) if bc_planes is None else bc_planes
    if sv.bcz == 'PP':
        # no z face (qz = 0, the planes are zero); the shift is one add
        if shift is not None:
            p = p + shift
        return sk.thomas_periodic_z(p, a, b, c, alpha=float(alpha))
    return sk.thomas_z(p, a, b, c, alpha=float(alpha), shift=shift,
                       bc_lo=lo, bc_hi=hi,
                       n_solve=nz - sv.qz if sv.qz else None)


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


def rhs_bound_planes_dyn(cfg: Config, grid: Grid, cbc, c_or_f, bc_planes,
                         dtype, device):
    """Tensor variant of rhs_bound_planes for BC values given per substep
    (cales_tpu poisson.rhs_bound_planes_dyn, bound.f90:447-560):
    bc_planes[idir][ibound] is a scalar or a padded-transverse plane
    (cropped to the interior here).  Returns {('x'|'y'|'z', 0|1): plane
    tensor} with x planes (nz, ny), y planes (nz, nx), z planes (ny, nx)."""
    nx, ny, nz = cfg.ng
    dl = cfg.dl
    dzc, dzf = grid.dzc, grid.dzf
    if c_or_f[2] == 'c':
        dzc01 = (dzc[0], dzc[nz])
        dzf01 = (dzf[1], dzf[nz])
    else:
        dzc01 = (dzc[1], dzc[nz - 1])
        dzf01 = (dzf[1], dzf[nz])
    metr = {0: ((dl[0], dl[0]), (dl[0], dl[0])),
            1: ((dl[1], dl[1]), (dl[1], dl[1])),
            2: (dzc01, dzf01)}
    ishape = {0: (nz, ny), 1: (nz, nx), 2: (ny, nx)}
    out = {}
    for idir, key in ((0, 'x'), (1, 'y'), (2, 'z')):
        dlc, dlf = metr[idir]
        for ib in range(2):
            val = bc_planes[idir][ib]
            if getattr(val, 'ndim', 0) == 2:
                bcv = torch.as_tensor(val, dtype=dtype,
                                      device=device)[1:-1, 1:-1]
            else:
                bcv = torch.full(ishape[idir], float(val), dtype=dtype,
                                 device=device)
            letter = cbc[idir][ib]
            cf = c_or_f[idir]
            if letter == 'P':
                plane = torch.zeros_like(bcv)
            elif letter == 'D':
                fac = 2.0 if cf == 'c' else 1.0
                plane = -fac * bcv / (dlc[ib] * dlf[ib])
            else:
                sgn = 1.0 if ib == 0 else -1.0
                div = dlf[ib] if cf == 'c' else dlc[ib]
                plane = sgn * bcv / div
            out[(key, ib)] = plane
    return out


def add_rhs_bound(cfg: Config, c_or_f, cbc, rhs, planes):
    """Add the boundary planes onto the solver RHS (updt_rhs_b,
    bound.f90:562-617).  planes: numpy arrays, or tensors (the CN solves'
    rhs_bound_planes_dyn); all-zero numpy planes (homogeneous BCs, the
    channel's pressure) return rhs unchanged."""
    if all(not torch.is_tensor(p) and np.all(np.asarray(p) == 0.0)
           for p in planes.values()):
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
