"""1D transforms that diagonalize the second-difference operator per BC pair.

Counterpart of cales_tpu/ops/transforms.py.  ``make_transform`` is a copy of
the JAX package's numpy constructor (that module imports jax, so it is copied
rather than imported); ``fwd``/``bwd`` apply a transform along one axis of a
(z, y, x) tensor: ``torch.fft`` for kind 'fft' (periodic), a matmul with the
precomputed operator matrix for kind 'mat'.  See the JAX module for the
(transform, eigenvalue) table per BC pair and staggering.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Transform1D:
    kind: str          # 'fft' | 'mat'
    n: int             # array length along the axis
    nsolve: int        # number of transformed/solved points (n or n-1)
    lam: np.ndarray    # (nsolve,) eigenvalues for unit spacing, float64
    fwd_mat: np.ndarray | None = None   # (nsolve, nsolve)
    bwd_mat: np.ndarray | None = None   # (nsolve, nsolve)


def _basis_matrix(n: int, func) -> np.ndarray:
    """Rows = basis vectors evaluated at point indices (forward = analysis)."""
    k = np.arange(n, dtype=np.float64)[:, None]
    i = np.arange(n, dtype=np.float64)[None, :]
    return func(k, i)


def make_transform(bc: str, c_or_f: str, n: int,
                   pp_mat: bool = False) -> Transform1D:
    """Transform pair + eigenvalues for one direction.  bc is the BC pair
    ('PP','NN','DD','ND','DN'), c_or_f the staggering ('c' or 'f');
    pp_mat applies the periodic transform as a real half-complex DFT
    matrix instead of an FFT."""
    pi = np.pi
    if bc == 'PP':
        if not pp_mat:
            j = np.arange(n, dtype=np.float64)
            lam = -2.0 * (1.0 - np.cos(2.0 * pi * j / n))
            return Transform1D(kind='fft', n=n, nsolve=n, lam=lam)
        i = np.arange(n, dtype=np.float64)
        kc = np.arange(0, n // 2 + 1, dtype=np.float64)         # cos rows
        ks = np.arange(1, (n - 1) // 2 + 1, dtype=np.float64)   # sin rows
        T = np.vstack([np.cos(2.0 * pi * np.outer(kc, i) / n),
                       np.sin(2.0 * pi * np.outer(ks, i) / n)])
        lam = -2.0 * (1.0 - np.cos(2.0 * pi * np.concatenate([kc, ks]) / n))
        return Transform1D(kind='mat', n=n, nsolve=n, lam=lam,
                           fwd_mat=T, bwd_mat=np.linalg.inv(T))

    if c_or_f == 'c':
        if bc == 'NN':     # DCT-II
            T = _basis_matrix(n, lambda k, i: np.cos(pi * k * (2 * i + 1) / (2 * n)))
            lam = -2.0 * (1.0 - np.cos(pi * np.arange(n) / n))
        elif bc == 'DD':   # DST-II
            T = _basis_matrix(n, lambda k, i: np.sin(pi * (k + 1) * (2 * i + 1) / (2 * n)))
            lam = -2.0 * (1.0 - np.cos(pi * (np.arange(n) + 1.0) / n))
        elif bc == 'ND':   # DCT-IV
            T = _basis_matrix(n, lambda k, i: np.cos(pi * (2 * k + 1) * (2 * i + 1) / (4 * n)))
            lam = -2.0 * (1.0 - np.cos((2 * np.arange(n) + 1.0) * pi / (2 * n)))
        elif bc == 'DN':   # DST-IV
            T = _basis_matrix(n, lambda k, i: np.sin(pi * (2 * k + 1) * (2 * i + 1) / (4 * n)))
            lam = -2.0 * (1.0 - np.cos((2 * np.arange(n) + 1.0) * pi / (2 * n)))
        else:
            raise ValueError(f'unsupported BC pair {bc!r}')
        nsolve = n
    else:  # 'f'
        if bc == 'NN':     # mirror operator -> DCT-II basis
            T = _basis_matrix(n, lambda k, i: np.cos(pi * k * (2 * i + 1) / (2 * n)))
            lam = -2.0 * (1.0 - np.cos(pi * np.arange(n) / n))
            nsolve = n
        elif bc == 'DD':   # DST-I on n-1 interior faces
            m = n - 1
            T = _basis_matrix(m, lambda k, i: np.sin(pi * (k + 1) * (i + 1) / n))
            lam = -2.0 * (1.0 - np.cos(pi * (np.arange(m) + 1.0) / n))
            nsolve = m
        elif bc == 'ND':   # n-1 points, mirror low / Dirichlet node at i=n
            m = n - 1
            theta = (2 * np.arange(m) + 1.0) * pi / (2 * n - 1)
            T = _basis_matrix(m, lambda k, i: np.cos(
                (2 * k + 1) * pi / (2 * n - 1) * (i + 0.5)))
            lam = -2.0 * (1.0 - np.cos(theta))
            nsolve = m
        elif bc == 'DN':   # n points, Dirichlet node at i=0 / mirror high
            theta = (2 * np.arange(n) + 1.0) * pi / (2 * n + 1)
            T = _basis_matrix(n, lambda k, i: np.sin(
                (2 * k + 1) * pi / (2 * n + 1) * (i + 1.0)))
            lam = -2.0 * (1.0 - np.cos(theta))
            nsolve = n
        else:
            raise ValueError(f'unsupported BC pair {bc!r}')

    Tinv = np.linalg.inv(T)
    return Transform1D(kind='mat', n=n, nsolve=nsolve, lam=lam,
                       fwd_mat=T, bwd_mat=Tinv)


def _matmul_axis(arr, mat, axis):
    """Contract `mat` (k_out, k_in) with `arr` along `axis`; a complex
    array has its real and imaginary parts transformed separately."""
    if arr.is_complex():
        return torch.complex(_matmul_axis(arr.real, mat, axis),
                             _matmul_axis(arr.imag, mat, axis))
    m = torch.as_tensor(mat, dtype=arr.dtype, device=arr.device)
    moved = torch.movedim(arr, axis, -1)
    return torch.movedim(torch.matmul(moved, m.T), -1, axis)


def fwd(tr: Transform1D, arr, axis: int):
    """Forward transform along `axis`.  For PP: rfft on real input, fft on
    complex input."""
    if tr.kind == 'fft':
        if arr.is_complex():
            return torch.fft.fft(arr, dim=axis)
        return torch.fft.rfft(arr, dim=axis)
    return _matmul_axis(arr, tr.fwd_mat, axis)


def bwd(tr: Transform1D, arr, axis: int, n: int, real_out: bool):
    """Backward transform along `axis`; `n` is the output length of an
    inverse rfft."""
    if tr.kind == 'fft':
        if real_out:
            return torch.fft.irfft(arr, n=n, dim=axis)
        return torch.fft.ifft(arr, dim=axis)
    return _matmul_axis(arr, tr.bwd_mat, axis)
