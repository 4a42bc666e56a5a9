"""Batched tridiagonal solves along the leading (z) axis, in plain PyTorch.

Counterpart of cales_tpu/ops/tridiag.py: `thomas` (reference
dgtsv_homebrewed, solver.f90:153-179) is the solve of the Thomas kernel
(csrc/thomas_z.cu), `thomas_periodic` (reference gaussel_periodic,
solver.f90:109-151) the rank-1-corrected periodic solve of
csrc/thomas_periodic.cu; each is its kernel's plain version's core, and
`thomas_chunked` and `thomas_periodic_chunked` are the kernels' own
scheme step by step (chunks a lane, cyclic reduction), for the tests.  The
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


def _sweep(ca, bs, cc, rs, lam_, zero, one, pinned=None):
    """A chunk's sweep, as the kernels' tp_sweep: forward, x_k + A_k P +
    C_k x_{k+1} = D_k from the pseudo-row x_{-1} = P, then backward, x_k
    = D_k - A_k P - C_k Q.  ca, bs, cc, rs: the chunk's rows a, b, c and
    right-hand sides; pinned: where row 0's pivot reciprocal is zeroed.
    Returns (A, C, D), the last forward row, the first backward row and
    the last pivot reciprocal."""
    m = len(rs)
    A, C, D = [None] * m, [None] * m, [None] * m
    ap, cp, dp = -one, zero, zero
    for k in range(m):
        zf = 1.0 / (bs[k] + lam_ - ca[k] * cp)
        if k == 0 and pinned is not None:
            zf = torch.where(pinned, zero, zf)
        A[k] = -(ca[k] * ap) * zf
        C[k] = cc[k] * zf
        D[k] = (rs[k] - ca[k] * dp) * zf
        ap, cp, dp, zlast = A[k], C[k], D[k], zf
    last = (A[m - 1], C[m - 1], D[m - 1])
    ar, cr, dr = zero, -one, zero
    for k in range(m - 2, -1, -1):
        D[k] = D[k] - C[k] * dr
        A[k] = A[k] - C[k] * ar
        C[k] = -C[k] * cr
        ar, cr, dr = A[k], C[k], D[k]
    return (A, C, D), last, (ar, cr, dr), zlast


def _pcr(red, lanes, ident):
    """Parallel cyclic reduction of the chunk ends' rows (a, b, c, d..),
    one a lane, as the kernels' over shuffles: lanes 1, 2, 4, .. away,
    identity rows past the warp.  Returns each lane's d / b."""
    def at(q):
        return red[q] if 0 <= q < lanes else ident
    delta = 1
    while delta < lanes:
        inv = [1.0 / r[1] for r in red]

        def nb(q):
            r = at(q)
            return (r[0], 1.0 / r[1] if q < 0 or q >= lanes else inv[q],
                    r[2], *r[3:])
        new = []
        for q in range(lanes):
            r, lo, hi = red[q], nb(q - delta), nb(q + delta)
            k1, k2 = r[0] * lo[1], r[2] * hi[1]
            new.append((-lo[0] * k1, r[1] - lo[2] * k1 - hi[0] * k2,
                        -hi[2] * k2, *(d - dl * k1 - dh * k2 for d, dl, dh
                                        in zip(r[3:], lo[3:], hi[3:]))))
        red = new
        delta *= 2
    return [[d * (1.0 / r[1]) for d in r[3:]] for r in red]


def thomas_chunked(a, b, c, rhs, lam=None, pin_tol=None, lanes=32,
                   min_rows=7):
    """thomas by the steps of its kernel (csrc/thomas_z.cu, the scheme of
    csrc/thomas_common.cuh), each column split over `lanes` lanes (a
    warp).  The n rows go in chunks of at least `min_rows` (and 2)
    consecutive rows, one a lane, on as many lanes as that leaves (at
    least one).  A chunk is swept forward, each row in terms of the next
    and of P, the last unknown of the chunk below (the first chunk has
    none), then backward, each row in terms of P and Q, its own last
    unknown.  The chunks' last rows, with the first row of the chunk above
    substituted, couple only the Q of neighbouring lanes: a tridiagonal
    system of one row a lane, solved by parallel cyclic reduction (lanes
    1, 2, 4, .. away; identity rows past the chunks and the warp).  Then
    each chunk's rows from its P and Q.  pin_tol: a lane with |lam| <=
    pin_tol has its first pivot reciprocal zeroed (x[0] = 0, the identity
    row with right-hand side 0), as thomas.  a[0] and c[n-1] are out of
    the system.  The kernel's arithmetic in plain PyTorch, for the tests;
    the main path never calls it."""
    n = rhs.shape[0]
    nl = max(1, min(lanes, n // max(2, min_rows)))
    base, extra = divmod(n, nl)
    lam_ = torch.zeros_like(rhs[0]) if lam is None else lam + 0 * rhs[0]
    zero, one = torch.zeros_like(rhs[0]), torch.ones_like(rhs[0])
    pinned = None if pin_tol is None else torch.abs(lam_) <= pin_tol
    rows, chunks, first = [], [], []
    for ln in range(nl):
        m, s = base + (ln < extra), ln * base + min(ln, extra)
        ca = [zero + (a[s + k] if s + k > 0 else 0.0) for k in range(m)]
        cc = [zero + (c[s + k] if s + k < n - 1 else 0.0) for k in range(m)]
        acd, last, fst, _ = _sweep(ca, b[s:s + m], cc, rhs[s:s + m], lam_,
                                   zero, one, pinned if ln == 0 else None)
        first.append(fst)
        chunks.append((s, m, *acd))
        rows.append(last)
    ident = (zero, one, zero, zero)
    red = []
    for ln in range(lanes):
        if ln >= nl:
            red.append(ident)
            continue
        am, cm, dm = rows[ln]
        an, cn_, dn = first[ln + 1] if ln + 1 < nl else (zero, zero, zero)
        red.append((zero if ln == 0 else am, 1.0 - cm * an, -cm * cn_,
                    dm - cm * dn))
    q = [r[0] for r in _pcr(red, lanes, ident)]
    out = torch.empty_like(rhs)
    for ln, (s, m, A, C, D) in enumerate(chunks):
        p = zero if ln == 0 else q[ln - 1]
        for k in range(m - 1):
            out[s + k] = D[k] - A[k] * p - C[k] * q[ln]
        out[s + m - 1] = q[ln]
    return out


def thomas_periodic_chunked(a, b, c, rhs, lam=None, pin_tol=None,
                            lanes=32, min_rows=7):
    """thomas_periodic by the steps of its kernel (csrc/thomas_periodic.cu),
    each column split over `lanes` lanes (a warp).  The reduced (n-1)-row
    system goes in chunks of at least `min_rows` (and 2) consecutive rows,
    one a lane, on as many lanes as that leaves (at least one).  A chunk is
    swept forward, each row in terms of the next and of P, the last
    unknown of the chunk below, then backward, each row in terms of P and
    Q, its own last unknown.  The chunks' last rows, with the first row of
    the chunk above substituted, couple only the Q of neighbouring lanes: a
    tridiagonal system of one row a lane, solved by parallel cyclic
    reduction (lanes 1, 2, 4, .. away; identity rows past the chunks and
    the warp).  Then pn, each chunk's rows from its P and Q, and the
    combine.  The correction RHS e (e[0] = -a[0]) rides in the first
    chunk's P coefficients, whose P does not exist (P = 0 for the data,
    -1 for e).  The kernel's arithmetic in plain PyTorch, for the tests;
    the main path never calls it."""
    nz = rhs.shape[0]
    n = nz - 1
    nl = max(1, min(lanes, n // max(2, min_rows)))
    base, extra = divmod(n, nl)
    lam_ = torch.zeros_like(rhs[0]) if lam is None else lam + 0 * rhs[0]
    zero, one = torch.zeros_like(rhs[0]), torch.ones_like(rhs[0])
    ident = (zero, one, zero, zero, zero)
    rows, chunks, first = [], [], []
    for ln in range(nl):
        m, s = base + (ln < extra), ln * base + min(ln, extra)
        # the corners are out of the reduced system: row 0 carries e[0] =
        # -a[0] in its P column, row n-1 has no c
        ca = [zero + (a[s + k] if s + k > 0 else -a[0]) for k in range(m)]
        cc = [zero + (c[s + k] if s + k < n - 1 else 0.0) for k in range(m)]
        acd, last, fst, zlast = _sweep(ca, b[s:s + m], cc, rhs[s:s + m],
                                       lam_, zero, one)
        first.append(fst)
        chunks.append((s, m, *acd))
        e2 = -c[n - 1] * zlast if ln == nl - 1 else zero
        rows.append((last, e2))
    red = []
    for ln in range(lanes):
        if ln >= nl:
            red.append(ident)
            continue
        (am, cm, dm), e2 = rows[ln]
        an, cn_, dn = first[ln + 1] if ln + 1 < nl else (zero, zero, zero)
        red.append((zero if ln == 0 else am, 1.0 - cm * an, -cm * cn_,
                    dm - cm * dn, (am if ln == 0 else zero) + e2))

    q1, q2 = map(list, zip(*_pcr(red, lanes, ident)))
    # the chunks' rows; lane 0's P: 0 for the data, -1 for e
    x1s, x2s = [], []
    for ln, (s, m, A, C, D) in enumerate(chunks):
        p1, p2 = (zero, -one) if ln == 0 else (q1[ln - 1], q2[ln - 1])
        x1s.append([D[k] - A[k] * p1 - C[k] * q1[ln] for k in range(m - 1)]
                   + [q1[ln]])
        x2s.append([-A[k] * p2 - C[k] * q2[ln] for k in range(m - 1)]
                   + [q2[ln]])
    den = (b[n] + lam_) + c[n] * x2s[0][0] + a[n] * q2[nl - 1]
    pn = (rhs[n] - c[n] * x1s[0][0] - a[n] * q1[nl - 1]) / den
    if pin_tol is not None:
        pn = torch.where(torch.abs(lam) <= pin_tol, torch.zeros_like(pn), pn)
    out = torch.empty_like(rhs)
    for ln, (s, m, _, _, _) in enumerate(chunks):
        for k in range(m):
            out[s + k] = x1s[ln][k] + x2s[ln][k] * pn
    out[n] = pn
    return out
