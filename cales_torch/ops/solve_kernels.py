"""The Poisson and Helmholtz solve kernels: one wrapper each, with its plain
PyTorch version and a launch counter.

  kernel     CUDA source          replaces (cales_tpu/ops/pallas_solve.py)
  apply_y    csrc/apply_y.cu      apply_y (with the x operator MxT fused)
  apply_x    csrc/apply_x.cu      apply_x (the x operator alone, the
                                  slab-sharded solve's, poisson.solve_sharded)
  z_eig      csrc/z_eig.cu        apply_z_eig
  thomas_z   csrc/thomas_z.cu     _apply_thomas_z: apply_thomas_z and
                                  apply_thomas_helmholtz_z
  thomas_periodic                 apply_thomas_periodic_z
             csrc/thomas_periodic.cu

Fields are (nz, ny, nx), contiguous, float32 or float64, on one device;
the operator matrices and eigenvalue rows are in the field's dtype; the
Thomas coefficients a, b, c are float64 (the kernel scales and rounds
them).  A wrapper takes the plain version only for tensors on the CPU; for
CUDA tensors it launches its kernel or raises.  LAUNCHES counts one per
wrapper call that launches, and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from .. import device as devmod
from . import tridiag
from .kernels import _launch, _ptr, _suffix

LAUNCHES = {'apply_y': 0, 'apply_x': 0, 'z_eig': 0, 'thomas_z': 0,
            'thomas_periodic': 0}
# the largest nz of csrc/thomas_periodic.cu: 32 lanes of at most 32 rows
# in float32, the 227 KB of a block's shared memory in float64
THOMAS_PERIODIC_MAX_NZ = {torch.float32: 1025, torch.float64: 808}
# and of csrc/thomas_z.cu: 32 lanes of at most 40 rows in float32, the 227
# KB of a block in float64
THOMAS_Z_MAX_NZ = {torch.float32: 1280, torch.float64: 808}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def apply_y_plain(arr, M, MxT=None):
    """out[z] = M @ arr[z] (@ MxT), as two fp32/fp64 matmuls (never TF32)."""
    devmod.set_full_fp32()
    if MxT is not None:
        arr = torch.matmul(arr, MxT)
    return torch.matmul(M, arr)


def apply_x_plain(arr, MxT, split=1):
    """out[z, y, :] = arr[z, y, :] @ MxT, one fp32/fp64 matmul (never TF32);
    see apply_x for the chunked layouts."""
    devmod.set_full_fp32()
    if arr.ndim == 4:
        arr = torch.cat(tuple(arr), dim=-1)
    out = torch.matmul(arr, MxT)
    if split > 1:
        nz, ny, nx = out.shape
        out = out.reshape(nz, ny, split, nx // split).permute(
            2, 0, 1, 3).contiguous()
    return out


def z_eig_plain(arr, Vl, Vr, lamz, lamy, lamx, tol):
    """out[:, j, i] = Vr @ (inv * (Vl @ arr[:, j, i])), inv = 1/(lamz +
    lamy[j] + lamx[i]) and zero where |lam| <= tol."""
    devmod.set_full_fp32()
    nz, ny, nx = arr.shape
    hat = torch.matmul(Vl, arr.reshape(nz, ny * nx)).reshape(nz, ny, nx)
    lam = lamz[:, None, None] + (lamy[:, None] + lamx[None, :])[None]
    inv = torch.where(torch.abs(lam) > tol, 1.0 / lam, torch.zeros_like(lam))
    return torch.matmul(Vr, (hat * inv).reshape(nz, ny * nx)).reshape(
        nz, ny, nx)


def _coefs(a, b, c, alpha, dtype):
    """The sweep's rows in the field dtype: a, b, c as given, or the
    Helmholtz rows a*alpha, b*alpha + 1, c*alpha (scaled in float64)."""
    if alpha is not None:
        a, b, c = a * alpha, b * alpha + 1.0, c * alpha
    return a.to(dtype), b.to(dtype), c.to(dtype)


def thomas_z_plain(arr, a, b, c, lamy=None, lamx=None, pin=False, tol=0.0,
                   alpha=None, shift=None, bc_lo=None, bc_hi=None,
                   n_solve=None):
    """tridiag(a, b + lamy[j] + lamx[i], c) solve along z, rows 0 ..
    n_solve-1; see thomas_z."""
    nz = arr.shape[0]
    ns = nz if n_solve is None else int(n_solve)
    a, b, c = _coefs(a[:ns], b[:ns], c[:ns], alpha, arr.dtype)
    rhs = arr[:ns] if shift is None else arr[:ns] + shift
    if bc_lo is not None:
        rhs = torch.cat([(rhs[0] + bc_lo)[None], rhs[1:ns - 1],
                         (rhs[ns - 1] + bc_hi)[None]])
    lam = None
    if lamy is not None:
        lam = lamx[None, :] + lamy[:, None]
    sol = tridiag.thomas(a, b, c, rhs, lam=lam,
                         pin_tol=tol if (pin and lam is not None) else None)
    if ns == nz:
        return sol
    tail = arr[ns:] if shift is None else arr[ns:] + shift
    return torch.cat([sol, tail])


def thomas_periodic_z_plain(arr, a, b, c, lamy=None, lamx=None, pin=False,
                            tol=0.0, alpha=None):
    """Periodic tridiag(a, b + lamy[j] + lamx[i], c) solve along z; see
    thomas_periodic_z."""
    a, b, c = _coefs(a, b, c, alpha, arr.dtype)
    lam = None if lamy is None else lamx[None, :] + lamy[:, None]
    return tridiag.thomas_periodic(
        a, b, c, arr, lam=lam,
        pin_tol=tol if (pin and lam is not None) else None)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check(name, arr, *others, f64=()):
    if arr.device.type != 'cuda':
        raise ValueError(f'{name}: tensors must be on the CPU (plain '
                         f'version) or a CUDA device, got {arr.device}')
    if arr.dtype not in (torch.float32, torch.float64) or arr.ndim != 3:
        raise TypeError(f'{name}: want a (nz, ny, nx) float32/float64 field, '
                        f'got {arr.dtype} {tuple(arr.shape)}')
    for t in (arr, *others, *f64):
        if t is None:
            continue
        want = torch.float64 if any(t is q for q in f64) else arr.dtype
        if t.device != arr.device or t.dtype != want:
            raise ValueError(f'{name}: operand on {t.device} as {t.dtype}, '
                             f'want {arr.device} as {want}')
        if not t.is_contiguous():
            raise ValueError(f'{name}: tensors must be contiguous')


def _shape(name, t, shape):
    if t is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name}: operand shape {tuple(t.shape)}, want '
                         f'{tuple(shape)}')


def apply_y(arr, M, MxT=None):
    """out[z] = M @ arr[z] (@ MxT) for every z plane: the y operator matmul
    of the transform-based solve, with the transposed x operator MxT fused
    in when given (pallas_solve.apply_y)."""
    if arr.device.type == 'cpu':
        return apply_y_plain(arr, M, MxT)
    _check('apply_y', arr, M, MxT)
    nz, ny, nx = arr.shape
    _shape('apply_y', M, (ny, ny))
    _shape('apply_y', MxT, (nx, nx))
    out = torch.empty_like(arr)
    tmp = torch.empty_like(arr) if MxT is not None else None
    _launch('apply_y', f'cales_apply_y_{_suffix(arr)}',
            *map(_ptr, (arr, M, MxT, tmp, out)),
            ctypes.c_int(nz), ctypes.c_int(ny), ctypes.c_int(nx),
            counts=LAUNCHES)
    return out


def apply_x(arr, MxT, split=1):
    """out[z, y, :] = arr[z, y, :] @ MxT for every (z, y) row: the x
    operator matmul of the slab-sharded solve (pallas_solve.apply_x), out of
    place.  arr is (nz, ny, nx), or (g, nz, ny, nx/g): the x columns in g
    chunks, chunk q holding columns q nx/g .., as the all-to-all of the
    backward transpose delivers them.  split = g > 1 returns the result in
    that chunked layout, chunk q the block the forward all-to-all sends to
    rank q; otherwise (nz, ny, nx)."""
    if arr.device.type == 'cpu':
        return apply_x_plain(arr, MxT, split)
    if arr.ndim == 4:
        g_in, nz, ny, nxi = arr.shape
        nx = g_in * nxi
    elif arr.ndim == 3:
        g_in, (nz, ny, nx) = 1, arr.shape
    else:
        raise TypeError(f'apply_x: want (nz, ny, nx) or (g, nz, ny, nx/g), '
                        f'got {tuple(arr.shape)}')
    _check('apply_x', arr if arr.ndim == 3 else arr[0], MxT)
    if not arr.is_contiguous():
        raise ValueError('apply_x: tensors must be contiguous')
    _shape('apply_x', MxT, (nx, nx))
    split = int(split)
    if split < 1 or nx % split:
        raise ValueError(f'apply_x: split {split} does not divide nx = {nx}')
    if nz * ny >= 2 ** 31:
        raise ValueError(f'apply_x: {nz * ny} rows (at most 2^31 - 1)')
    out = arr.new_empty((split, nz, ny, nx // split) if split > 1
                        else (nz, ny, nx))
    _launch('apply_x', f'cales_apply_x_{_suffix(arr)}',
            *map(_ptr, (arr, MxT, out)), ctypes.c_int(nz * ny),
            ctypes.c_int(nx), ctypes.c_int(g_in), ctypes.c_int(split),
            counts=LAUNCHES)
    return out


def z_eig(arr, Vl, Vr, lamz, lamy, lamx, tol):
    """The eigendecomposition z stage of the Poisson solve with the
    singular mode projected out (pallas_solve.apply_z_eig); nz <= 384."""
    if arr.device.type == 'cpu':
        return z_eig_plain(arr, Vl, Vr, lamz, lamy, lamx, tol)
    _check('z_eig', arr, Vl, Vr, lamz, lamy, lamx)
    nz, ny, nx = arr.shape
    if nz > 384:
        raise ValueError(f'z_eig: nz = {nz} > 384 (the Thomas z stage '
                         'takes these)')
    for t, shape in ((Vl, (nz, nz)), (Vr, (nz, nz)), (lamz, (nz,)),
                     (lamy, (ny,)), (lamx, (nx,))):
        _shape('z_eig', t, shape)
    out = torch.empty_like(arr)
    # float32: the scaled hat between the two tensor-core products
    hat = torch.empty_like(arr) if arr.dtype == torch.float32 else None
    _launch('z_eig', f'cales_z_eig_{_suffix(arr)}',
            *map(_ptr, (arr, out, hat, Vl, Vr, lamz, lamy, lamx)),
            ctypes.c_int(nz), ctypes.c_int(ny), ctypes.c_int(nx),
            ctypes.c_double(tol), counts=LAUNCHES)
    return out


def thomas_z(arr, a, b, c, lamy=None, lamx=None, pin=False, tol=0.0,
             alpha=None, shift=None, bc_lo=None, bc_hi=None, n_solve=None):
    """Tridiagonal solve along z (pallas_solve._apply_thomas_z).  Each
    option stands alone and they combine:
      lamy (ny,), lamx (nx,): added to the diagonal, b + lamy[j] + lamx[i];
      pin: the first pivot reciprocal zeroed where |lamy[j] + lamx[i]| <=
           tol (the Poisson system's singular lane);
      alpha: the Helmholtz rows a*alpha, b*alpha + 1, c*alpha (the lam
           rows are taken as given: the full-3D CN solve passes
           lamy*alpha, lamx*alpha);
      shift: a (1,) tensor added to every RHS row, tail included;
      bc_lo / bc_hi: (ny, nx) planes added to rows 0 / n_solve - 1;
      n_solve: rows n_solve .. nz-1 pass through (the face-staggered
           Dirichlet tail).
    a, b, c: (nz,) float64 coefficient rows (rows from n_solve on are not
    read).  On the card a column lives in shared memory: nz up to
    THOMAS_Z_MAX_NZ."""
    if arr.device.type == 'cpu':
        return thomas_z_plain(arr, a, b, c, lamy, lamx, pin, tol, alpha,
                              shift, bc_lo, bc_hi, n_solve)
    _check('thomas_z', arr, lamy, lamx, shift, bc_lo, bc_hi, f64=(a, b, c))
    nz, ny, nx = arr.shape
    ns = nz if n_solve is None else int(n_solve)
    if not 2 <= ns <= nz:
        raise ValueError(f'thomas_z: n_solve = {ns} outside [2, {nz}]')
    nz_max = THOMAS_Z_MAX_NZ[arr.dtype]
    if nz > nz_max:
        raise ValueError(f'thomas_z: nz = {nz} (at most {nz_max} in '
                         f'{arr.dtype}: a column is solved in shared memory)')
    if (lamy is None) != (lamx is None) or (bc_lo is None) != (bc_hi is None):
        raise ValueError('thomas_z: pass lamy with lamx, bc_lo with bc_hi')
    for t, shape in ((a, (nz,)), (b, (nz,)), (c, (nz,)), (lamy, (ny,)),
                     (lamx, (nx,)), (shift, (1,)), (bc_lo, (ny, nx)),
                     (bc_hi, (ny, nx))):
        _shape('thomas_z', t, shape)
    out = torch.empty_like(arr)
    _launch('thomas_z', f'cales_thomas_z_{_suffix(arr)}',
            *map(_ptr, (arr, out, a, b, c, lamy, lamx, shift, bc_lo,
                        bc_hi)),
            ctypes.c_int(nz), ctypes.c_int(ny), ctypes.c_int(nx),
            ctypes.c_int(ns), ctypes.c_int(int(alpha is not None)),
            ctypes.c_double(0.0 if alpha is None else alpha),
            ctypes.c_int(int(bool(pin))), ctypes.c_double(tol),
            counts=LAUNCHES)
    return out


def thomas_periodic_z(arr, a, b, c, lamy=None, lamx=None, pin=False,
                      tol=0.0, alpha=None):
    """Periodic tridiagonal solve along z, the rank-1-corrected two-RHS
    sweep (pallas_solve.apply_thomas_periodic_z), nz >= 3:
      lamy (ny,), lamx (nx,): added to the diagonal, b + lamy[j] + lamx[i]
           (None: no shift);
      pin: the rank-1 coefficient (the last row) pinned to 0 where
           |lamy[j] + lamx[i]| <= tol, the Poisson system's singular lane;
      alpha: the Helmholtz rows a*alpha, b*alpha + 1, c*alpha (the lam
           rows are taken as given, as in thomas_z).
    a, b, c: (nz,) float64 coefficient rows, a[0] and c[nz-1] the periodic
    corners.  On the card a column lives in shared memory: nz up to
    THOMAS_PERIODIC_MAX_NZ."""
    if arr.device.type == 'cpu':
        return thomas_periodic_z_plain(arr, a, b, c, lamy, lamx, pin, tol,
                                       alpha)
    _check('thomas_periodic', arr, lamy, lamx, f64=(a, b, c))
    nz, ny, nx = arr.shape
    nz_max = THOMAS_PERIODIC_MAX_NZ[arr.dtype]
    if not 3 <= nz <= nz_max:
        raise ValueError(f'thomas_periodic: nz = {nz} (3 to {nz_max} in '
                         f'{arr.dtype}: a column is solved in shared memory)')
    if (lamy is None) != (lamx is None):
        raise ValueError('thomas_periodic: pass lamy with lamx')
    for t, shape in ((a, (nz,)), (b, (nz,)), (c, (nz,)), (lamy, (ny,)),
                     (lamx, (nx,))):
        _shape('thomas_periodic', t, shape)
    out = torch.empty_like(arr)
    _launch('thomas_periodic', f'cales_thomas_periodic_{_suffix(arr)}',
            *map(_ptr, (arr, out, a, b, c, lamy, lamx)),
            ctypes.c_int(nz), ctypes.c_int(ny), ctypes.c_int(nx),
            ctypes.c_int(int(alpha is not None)),
            ctypes.c_double(0.0 if alpha is None else alpha),
            ctypes.c_int(int(bool(pin))), ctypes.c_double(tol),
            counts=LAUNCHES)
    return out
