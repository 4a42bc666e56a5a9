"""Batched tridiagonal solves along the leading (z) axis, in plain PyTorch.

Counterpart of cales_tpu/ops/tridiag.py: `thomas` (reference
dgtsv_homebrewed, solver.f90:153-179) is the sweep the Thomas kernel
(csrc/thomas_z.cu) runs, `thomas_periodic` (reference gaussel_periodic,
solver.f90:109-151) the rank-1-corrected periodic solve of
csrc/thomas_periodic.cu; each is its kernel's plain version's core.  The
singular constant mode of a pure Poisson system is gauge-fixed the way the
TPU kernels fix it instead of by the reference's eps-regularized pivots:
lanes with |lam| <= tol get p[0] = 0 (thomas: the first pivot reciprocal
zeroed, pallas_solve._apply_thomas_z) or p[n-1] = 0 (thomas_periodic: the
rank-1 coefficient pinned, pallas_solve.apply_thomas_periodic_z).
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


def thomas_periodic(a, b, c, rhs, lam=None, pin_tol=None):
    """Solve the periodic tridiagonal system (rows a, b + lam, c, with the
    corners a[0] and c[n-1]) along axis 0, n >= 3: the reduced (n-1)-row
    system swept once for two right-hand sides, the data p1 and the
    correction p2 (e[0] = -a[0], e[n-2] = -c[n-2]), then
      pn = (r[n-1] - c[n-1] p1[0] - a[n-1] p1[n-2])
           / ((b[n-1] + lam) + c[n-1] p2[0] + a[n-1] p2[n-2]),
      x = p1 + p2 pn,  x[n-1] = pn.
    pin_tol: None, or the tolerance under which a lane of lam is pinned
    (pn = 0)."""
    n = rhs.shape[0]
    e = torch.zeros_like(rhs[:n - 1])
    e[0] = -a[0]
    e[n - 2] = -c[n - 2]
    sol = thomas(a[:n - 1], b[:n - 1], c[:n - 1],
                 torch.stack([rhs[:n - 1], e], dim=1),
                 lam=None if lam is None else lam[None])
    p1, p2 = sol[:, 0], sol[:, 1]
    shift = 0.0 if lam is None else lam
    den = (b[n - 1] + shift) + c[n - 1] * p2[0] + a[n - 1] * p2[n - 2]
    pn = (rhs[n - 1] - c[n - 1] * p1[0] - a[n - 1] * p1[n - 2]) / den
    if pin_tol is not None:
        pn = torch.where(torch.abs(lam) <= pin_tol, torch.zeros_like(pn), pn)
    return torch.cat([p1 + p2 * pn, pn[None]])
