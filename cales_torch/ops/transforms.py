"""1D transforms that diagonalize the second-difference operator per BC pair.

Counterpart of cales_tpu/ops/transforms.py.  ``make_transform`` is a copy of
the JAX package's numpy constructor (that module imports jax, so it is copied
rather than imported).  The solve routes apply the transforms themselves
(poisson.py): ``torch.fft`` for kind 'fft' (periodic), the operator matrices
of kind 'mat' through the apply_y and apply_x kernels.  See the JAX module
for the (transform, eigenvalue) table per BC pair and staggering.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


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
