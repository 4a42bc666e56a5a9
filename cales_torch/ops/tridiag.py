"""Batched tridiagonal solve along the leading (z) axis, in plain PyTorch.

Counterpart of cales_tpu/ops/tridiag.thomas (reference dgtsv_homebrewed,
solver.f90:153-179): the sweep the Thomas kernel (csrc/thomas_z.cu) runs,
and its plain version's core.  The singular constant mode of a pure
Poisson system is gauge-fixed the way the TPU kernel fixes it
(pallas_solve._apply_thomas_z): lanes with |lam| <= tol get their first
pivot reciprocal zeroed, so p[0] = 0 there, instead of the reference's
eps-regularized pivots.
"""
from __future__ import annotations

import torch


def thomas(a, b, c, rhs, lam=None, pin_tol=None):
    """Solve tridiag(a, b + lam, c) x = rhs along axis 0.

    a, b, c: (n,) tensors in rhs's dtype and device; rhs: (n, ...); lam:
    None or broadcastable to rhs[0]; pin_tol: None, or the tolerance under
    which a lane of lam is pinned (p[0] = 0)."""
    n = rhs.shape[0]
    shift = 0.0 if lam is None else lam
    zf = 1.0 / (b[0] + shift)
    if pin_tol is not None:
        zf = torch.where(torch.abs(lam) <= pin_tol, torch.zeros_like(zf), zf)
    d = c[0] * zf
    p = rhs[0] * zf
    ds, ps = [d], [p]
    for k in range(1, n):
        zf = 1.0 / (b[k] + shift - a[k] * d)
        d = c[k] * zf
        p = (rhs[k] - a[k] * p) * zf
        ds.append(d)
        ps.append(p)
    out = torch.empty_like(rhs)
    out[n - 1] = p
    for k in range(n - 2, -1, -1):
        p = ps[k] - ds[k] * p
        out[k] = p
    return out
