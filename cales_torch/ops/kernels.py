"""The stencil kernels: one wrapper each, with its plain PyTorch twin and
a launch counter.

  kernel          CUDA source           replaces (cales_tpu)
  mom_rk          csrc/mom_rk.cu        ops/pallas_kernels.py fused_mom_rk
  fillps          csrc/fillps.cu        ops/pallas_kernels.py fused_fillps
  correc_smag     csrc/correc_smag.cu   ops/pallas_kernels.py
                                        fused_correc_updatep_smag
  correc_updatep  csrc/correc.cu        ops/pallas_kernels.py
                                        fused_correc_updatep
  smag            csrc/smag.cu          ops/pallas_kernels.py fused_smag
  dsmag           csrc/dsmag.cu         ops/pallas_dsmag.py
                                        fused_dsmag_onepass ('channel',
                                        'duct', 'cavity'; its modes for
                                        periodic z and the 2D filter,
                                        which the JAX package runs in
                                        XLA, sgs.dsmag_visct; its slab
                                        mode, the kernel's ystrips)
  dsmag_level1    csrc/dsmag_level1.cu  ops/pallas_dsmag.py
                                        fused_dsmag_level1
  dsmag_level2    csrc/dsmag_level2.cu  ops/pallas_dsmag.py
                                        fused_dsmag_level2 ('channel',
                                        'duct', 'cavity')
  wallmodel       csrc/wallmodel.cu     no Pallas kernel: wallmodel.py
  (wm_planes)                           y_wall_wm_planes, z_wall_wm_planes
                                        and timeloop.py _wm_bcs_fast, in
                                        XLA

Input contract (the JAX kernels'): interior (nz, ny, nx) fields plus
(3, ny, nx) z-edge stacks [padded row 0, padded row nz, padded row nz+1];
x is periodic and wraps inside the kernel, and so is y unless the field
comes with its y-row stack: a pair (rows (nz, 3, nx), corners (3, 3, nx))
from ops/boundary.yedge_* (the y-walled variants of mom_rk, fillps,
correc_updatep, smag and the three dsmag kernels, the duct and cavity
classes).  With x walls (the developing channel, the closed box, the
lid-driven cavity and the developing duct, and their LES) x does not wrap
either: mom_rk, fillps, correc_updatep and smag take the fields' x stack
pairs (cols (nz, 3, nyc), corners (3, 3, nyc), nyc = ny, or ny + 2 with y
walls) from ops/boundary.xedge_*, and read the columns -1 and nx (and u's
rewrite column nx - 1 in the prediction fill) from them; the wall model's
sampled z rows take their x ghosts from the x faces' values
(wallmodel.WallFace.xfills).
On a slab of a y-sharded mesh (parallel/mesh.py) x wraps and y does not:
mom_rk, fillps, correc_updatep and smag take yh, the halo pairs (rows
(nz, 2, nx), corners (3, 2, nx)) of the fields they read across the slab's
edges (mesh.halo_y), and read rows -1 and ny from them; dsmag and
dsmag_level1 take them two rows deep (rows (nz, 4, nx), corners (3, 4,
nx): rows -2, -1, ny, ny+1), dsmag_level2 the filtered velocity's one row
deep, and the wall model the sampled rows' rows -1 and ny.  With y walls
on the mesh every slab passes its own y-row stack pairs
(boundary.slab_ystack: the wall recipe's rows on the side it owns, the
halo rows elsewhere) as ye, and the y-walled variants run as on the whole
field; dsmag and dsmag_level1 take them with their two-row halo and the
walls the slab owns (ye, yh and yown together), dsmag_level2 with the
walls it owns (ye and yown).  With x walls on the mesh x does not wrap
either: mom_rk and smag, which read the corners where the halo rows meet
the x ghost columns, take x stacks that carry the neighbours' rows -1
and ny (nyc = ny + 2, their rows in the momentum and SGS exchanges; with
y walls the wall recipe's rows on the sides the slab owns,
timeloop._xstacks_on_slab), fillps and correc_updatep the slab's own
(nyc = ny, or ny + 2 with y walls); the wall model's sampled z rows
take their halo rows' x ghosts from the slab's rows of the x faces'
values.
On a pencil of a 2D (gy, gx) mesh (gx > 1) x does not wrap either:
mom_rk, fillps, correc_updatep and smag take xh, the x halo pairs of the
fields they read across the pencil's x edges (mesh.halo_x, in the x
stacks' form: cols (nz, 3, ny + 2), corners (3, 3, ny + 2), column 0 the
lower neighbour's last column, column 2 the upper neighbour's first, the
rows -1 and ny the y exchange's; their x-halo variants, csrc X_HALO),
with the slab's y halos yh or, with gy = 1, periodic y; with y walls
(the duct and cavity classes) with the pencil's y-row stack pairs ye
(boundary.slab_ystack on the pencil's columns) instead, the x halos' rows
-1 and ny on the walls the pencil's mesh row holds the x neighbours' wall
rows (and v's row ny-1 there its rewrite), timeloop._xstacks_on_slab, so
the Y_WALLS x X_HALO variants take the (x ghost, y wall) corners from the
x halos; dsmag takes them with its two-row y halo and the walls the
pencil holds (YW, YH and XH, each average).
z metrics are (nz+2,) tensors with ghost entries, in the fields' dtype and
on their device.

A passive scalar rides mom_rk (its own C entry, cales_mom_rk_scal_*,
counted as mom_rk): one more cell-centred field with its z-edge stack and,
with y or x walls, its y-row or x stack pair, built from its own BC table,
or on a slab its halo pair.

Dispatch: a wrapper takes the twin only for tensors on the CPU.  For CUDA
tensors it launches its kernel or raises; nothing falls back.  LAUNCHES
counts kernel launches only; the twins never touch it.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from . import stencil as st
from .. import wallmodel as wmod

LAUNCHES = {'mom_rk': 0, 'fillps': 0, 'correc_smag': 0, 'correc_updatep': 0,
            'smag': 0, 'dsmag': 0, 'dsmag_level1': 0, 'dsmag_level2': 0,
            'wallmodel': 0}

# z-ghost recipe letters understood by the correction kernel ('E': the
# wall model's one-sided extrapolation)
_LETTER_CODE = {'D': 0, 'N': 1, 'E': 2}
# mom_rk's explicit/implicit diffusion split (csrc/mom_rk.cu SPLIT)
_SPLIT_CODE = {None: 0, '1d': 1, 'xy+z': 2}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# plain PyTorch twins, built from the stencil functions on z-padded,
# periodic-wrapped tensors
# ---------------------------------------------------------------------------

def zpad(q, e):
    """(nz+2, ny, nx) z-padded field from an interior and its edge stack:
    rows [e0, q[0..nz-2], e1, e2]."""
    return torch.cat([e[0:1], q[:-1], e[1:3]], dim=0)


def ypad(a, rows):
    """(n, ny+2, nx) y-padded array from a (n, ny, nx) one and its
    (n, 3, nx) y-row stack: rows [r0, a[:, 0..ny-2], r1, r2], as zpad."""
    return torch.cat([rows[:, 0:1], a[:, :-1], rows[:, 1:3]], dim=1)


def wrap_x(a):
    """Periodic x ghosts around a (n, m, nx) array."""
    return torch.cat([a[:, :, -1:], a, a[:, :, :1]], dim=2)


def wrap_xy(a):
    """Periodic x/y ghosts around a (n, ny, nx) array."""
    return wrap_x(torch.cat([a[:, -1:, :], a, a[:, :1, :]], dim=1))


def xpad(a, x, rewrite=False):
    """(nz+2, ny+2, nx+2) x-padded array from a y- and z-padded (nz+2,
    ny+2, nx) one and the field's x stack pair x = (cols (nz, 3, nyc),
    corners (3, 3, nyc)): columns [c0, a[..., 0..nx-1], c2], or with
    rewrite [c0, a[..., 0..nx-2], c1, c2], as zpad (the fill as
    pad_velocity has it: the face-staggered u's rewrite slot); nyc = ny
    wraps along y, nyc = ny + 2 carries the y ghosts."""
    cols = zpad(*x)
    if cols.shape[2] + 2 == a.shape[1]:
        cols = torch.cat([cols[:, :, -1:], cols, cols[:, :, :1]], dim=2)
    if rewrite:
        return torch.cat([cols[:, 0, :, None], a[..., :-1],
                          cols[:, 1:3].transpose(1, 2)], dim=2)
    return torch.cat([cols[:, 0, :, None], a, cols[:, 2, :, None]], dim=2)


def padded(q, e, y=None, h=None, x=None, rewrite=False):
    """The (nz+2, ny+2, nx+2) ghost-filled field: z ghosts from the edge
    stack e, y ghosts from y = (rows, corners), from the halo pair h =
    (rows (nz, 2, nx), corners (3, 2, nx)) of a slab, or periodic; x
    ghosts from the x stack pair x (x walls; on a slab its columns carry
    the neighbours' rows -1 and ny, nyc = ny + 2, where the corners are
    read), or periodic.  The kernels read the interior's last column from
    the field, as here, save u's in the prediction fill, which they take
    from its x stack's column 1 (rewrite: u's set_bc rewrite slot, which
    the fill puts there)."""
    if h is not None:
        rows, corners = h
        a = torch.cat([zpad(rows[:, :1], corners[:, :1]), zpad(q, e),
                       zpad(rows[:, 1:], corners[:, 1:])], dim=1)
    else:
        zp = zpad(q, e)
        a = (torch.cat([zp[:, -1:], zp, zp[:, :1]], dim=1) if y is None
             else ypad(zp, zpad(*y)))
    return wrap_x(a) if x is None else xpad(a, x, rewrite)


def ghost_row(rec, side, q1, q2=None):
    """Scalar-BC z-ghost plane from the first (side 0) or last (side 1)
    interior plane q1; rec = (lt_lo, b_lo, dr_lo, lt_hi, b_hi, dr_hi).
    'E' (a wall-modelled face, b = fac_ex): the one-sided extrapolation
    (1 + b) q1 - b q2 with q2 the next-inner plane (sgs.f90:682-767)."""
    lt, b, dr = rec[3 * side:3 * side + 3]
    if lt == 'D':
        return 2.0 * b - q1
    if lt == 'E':
        return (1.0 + b) * q1 - b * q2
    return (-dr * b + q1) if side == 0 else (dr * b + q1)


def _six(q):
    """A (u, v, w, visct, p[, sca]) tuple of stack pairs as six entries,
    None for the missing ones."""
    return (None,) * 6 if q is None else (*q, None, None)[:6]


def mom_rk_plain(u, v, w, s, p, ue, ve, we, se, pe, ruo, rvo, rwo,
                 dzci, dzfi, f1, f2, visc, dxi, dyi, bforce,
                 sums=(False, False), split=None, ye=None, yh=None,
                 xe=None, sca=None, scae=None, rso=None, scal=(0.0, 0.0),
                 xh=None):
    nz = u.shape[0]
    yu, yv, yw, ys, yp, ysc = _six(ye)
    hu, hv, hw, hs, hp, hsc = _six(yh)
    # a pencil's x halo pairs pad as x stacks do (no rewrite slot read)
    xu, xv, xw, xs, xp, xsc = _six(xe if xh is None else xh)
    up, vp, wp, ppad = (padded(q, e, y, h, x) for q, e, y, h, x in
                        ((u, ue, yu, hu, xu), (v, ve, yv, hv, xv),
                         (w, we, yw, hw, xw), (p, pe, yp, hp, xp)))
    sp = None if s is None else padded(s, se, ys, hs, xs)
    (eu, exyu, ezu), (ev, exyv, ezv), (ew, exyw, ezw) = st.momentum_rhs(
        up, vp, wp, sp, visc, dxi, dyi, dzci, dzfi, with_sgs=s is not None)
    if split is None:
        ru, rv, rw = eu + exyu + ezu, ev + exyv + ezv, ew + exyw + ezw
    elif split == '1d':
        ru, rv, rw = eu + exyu, ev + exyv, ew + exyw
        rdu, rdv, rdw = ezu, ezv, ezw
    else:
        ru, rv, rw = eu, ev, ew
        rdu, rdv, rdw = exyu + ezu, exyv + ezv, exyw + ezw
    dzci_c = torch.as_tensor(dzci[1:nz + 1], dtype=u.dtype,
                             device=u.device)[:, None, None]
    pc = ppad[1:-1, 1:-1, 1:-1]
    gpx = dxi * (ppad[1:-1, 1:-1, 2:] - pc)
    gpy = dyi * (ppad[1:-1, 2:, 1:-1] - pc)
    gpz = dzci_c * (ppad[2:, 1:-1, 1:-1] - pc)
    f12 = f1 + f2
    un = up[1:-1, 1:-1, 1:-1] + f1 * ru + f12 * (bforce[0] - gpx)
    vn = vp[1:-1, 1:-1, 1:-1] + f1 * rv + f12 * (bforce[1] - gpy)
    wn = wp[1:-1, 1:-1, 1:-1] + f1 * rw + f12 * (bforce[2] - gpz)
    if ruo is not None:
        un = un + f2 * ruo
        vn = vn + f2 * rvo
        wn = wn + f2 * rwo
    su, sv = un, vn
    if split is not None:
        # CN fold: emit the Crank-Nicolson RHS; the sums see the full
        # prediction
        h = 0.5 * f12
        su, sv = un + f12 * rdu, vn + f12 * rdv
        un, vn, wn = un + h * rdu, vn + h * rdv, wn + h * rdw
    usum = su.sum(dim=(1, 2))[:, None] if sums[0] else None
    vsum = sv.sum(dim=(1, 2))[:, None] if sums[1] else None
    if sca is None:
        return un, vn, wn, ru, rv, rw, usum, vsum
    # the passive scalar (scal.f90:14-51, rk.f90:123-195) with the same
    # fill of the velocity
    alpha, ssource = scal
    ds = st.scalar_rhs(up, vp, wp, padded(sca, scae, ysc, hsc, xsc), alpha,
                       dxi, dyi, dzci, dzfi)
    sn = sca + f1 * ds + f12 * ssource
    if rso is not None:
        sn = sn + f2 * rso
    return un, vn, wn, ru, rv, rw, usum, vsum, sn, ds


def fillps_plain(u, v, w, ue, ve, we, dzfi, dti, dxi, dyi, yv=None,
                 yh=None, xu=None, xh=None):
    if xh is not None:
        # a pencil: u's x halo, its last column its own
        return st.fillps(padded(u, ue, x=xh), padded(v, ve, yv, yh),
                         padded(w, we), dti, dxi, dyi, dzfi)
    return st.fillps(padded(u, ue, x=xu, rewrite=True),
                     padded(v, ve, yv, yh), padded(w, we), dti, dxi, dyi,
                     dzfi)


def correc_smag_plain(u, v, w, pp, p, ue, ve, we, ppe, dtrk, dxi, dyi,
                      dzci, dzfi, visc, csd2, zrec, fuv, dw, nearlo,
                      tauw_lo, tauw_hi, have_zwalls=True):
    up = padded(u, ue) + fuv[0]
    vp = padded(v, ve) + fuv[1]
    wp = padded(w, we)
    ppad = padded(pp, ppe)
    uc, vc, wc, vlo = st.correc(up, vp, wp, ppad, dtrk, dxi, dyi, dzci)
    pn = st.updatep(ppad, p, None, False, False, dxi, dyi, dzci, dzfi)
    # post-correction fill for the strain: u, v z ghosts by the BC recipes
    # of the corrected boundary planes (and the next-inner ones for 'E');
    # w's lower wall face is the corrected ghost-range entry
    # (impose_norm_bc=.false.)
    ug = wrap_xy(torch.cat([ghost_row(zrec[0], 0, uc[0], uc[1])[None], uc,
                            ghost_row(zrec[0], 1, uc[-1], uc[-2])[None]]))
    vg = wrap_xy(torch.cat([ghost_row(zrec[1], 0, vc[0], vc[1])[None], vc,
                            ghost_row(zrec[1], 1, vc[-1], vc[-2])[None]]))
    wcw = wrap_xy(wc)
    wg = torch.cat([vlo[2][None], wcw, wcw[-1:]])   # top row never read
    s0 = st.strain_rate(ug, vg, wg, dzci, dzfi, dxi, dyi)
    visct = _van_driest(s0, visc, csd2, dw, nearlo, tauw_lo, tauw_hi,
                        have_zwalls)
    return uc, vc, wc, pn, visct


def _van_driest(s0, visc, csd2, dw, nearlo, tauw_lo, tauw_hi, have_zwalls,
                ywall=None, xwall=None):
    """nu_t = (Cs Delta)^2 fd^2 |S| with the nearest wall's van Driest
    damping fd (sgs.f90:104-152); fd = 1 without walls.  ywall = (dwy,
    nearylo, tauw_ylo, tauw_yhi): with y walls, the (ny,) distance to the
    nearer y wall and 1 where it is the lower one, and the two y walls'
    (nz, nx) shear planes; xwall = (dwx, nearxlo, tauw_xlo, tauw_xhi): with
    x walls (an x face whose u is 'D': an inflow face is one), the same
    along x, the shear planes (nz, ny).  The walls are taken in the order
    x, y, z, and a later one serves a cell only where it is strictly nearer
    than the nearest before it (the running minimum over x-lo, x-hi, y-lo,
    y-hi, z-lo, z-hi, the first minimum winning)."""
    c3 = csd2[:, None, None]
    walls = []
    if xwall is not None:
        dwx, nearxlo, txlo, txhi = xwall
        walls.append((torch.where(nearxlo[None, None, :] > 0.5,
                                  txlo[:, :, None], txhi[:, :, None]),
                      dwx[None, None, :]))
    if ywall is not None:
        dwy, nearylo, tylo, tyhi = ywall
        walls.append((torch.where(nearylo[None, :, None] > 0.5,
                                  tylo[:, None], tyhi[:, None]),
                      dwy[None, :, None]))
    if have_zwalls:
        walls.append((torch.where(nearlo[:, None, None] > 0.5, tauw_lo[None],
                                  tauw_hi[None]), dw[:, None, None]))
    if not walls:
        return c3 * s0
    tauw, dist = walls[0]
    for tauw_n, dist_n in walls[1:]:
        nearer = dist_n < dist
        tauw = torch.where(nearer, tauw_n, tauw)
        dist = torch.where(nearer, dist_n, dist)
    tauw_s = 0.5 * visc * tauw
    dw_plus = dist * torch.sqrt(tauw_s) / visc
    fd = 1.0 - torch.exp(-dw_plus / 25.0)
    return c3 * fd * fd * s0


def smag_plain(u, v, w, ue, ve, we, dzci, dzfi, dxi, dyi, visc, csd2, dw,
               nearlo, tauw_lo, tauw_hi, have_zwalls=True, yh=None, ye=None,
               ywall=None, xe=None, xwall=None, xh=None):
    hu, hv, hw = (None,) * 3 if yh is None else yh
    yu, yv, yw = (None,) * 3 if ye is None else ye
    x = xe if xh is None else xh
    xu, xv, xw = (None,) * 3 if x is None else x
    s0 = st.strain_rate(padded(u, ue, yu, hu, xu), padded(v, ve, yv, hv, xv),
                        padded(w, we, yw, hw, xw), dzci, dzfi, dxi, dyi)
    return _van_driest(s0, visc, csd2, dw, nearlo, tauw_lo, tauw_hi,
                       have_zwalls, ywall, xwall)


def _zext(q, wall_lo, wall_hi, zper=False):
    """z ghost planes of a cell-centred quantity by the dynamic model's
    recipe: linear extrapolation at a wall (extrapolate, fac_cbc = 1),
    the first interior plane elsewhere (a homogeneous-Neumann fill), or
    with zper (periodic z) the planes at the other end."""
    if zper:
        return torch.cat([q[-1:], q, q[:1]])
    lo = 2.0 * q[0] - q[1] if wall_lo else q[0]
    hi = 2.0 * q[-1] - q[-2] if wall_hi else q[-1]
    return torch.cat([lo[None], q, hi[None]])


def _yext(a, yw=(True, True)):
    """y ghost rows of an (n, ny, m) array extrapolated at the y walls yw =
    (lower, upper), wrapped on a side that is none."""
    lo = 2.0 * a[:, :1] - a[:, 1:2] if yw[0] else a[:, -1:]
    hi = 2.0 * a[:, -1:] - a[:, -2:-1] if yw[1] else a[:, :1]
    return torch.cat([lo, a, hi], dim=1)


def _filt(q, wall_lo, wall_hi, yw, zper=False, f2d=False):
    """The 27-point test filter of a cell-centred quantity with the dynamic
    model's ghost recipes: _zext along z, along y _yext at the y walls yw =
    (lower, upper) and the periodic wrap elsewhere, x periodic; with f2d
    the 9-point filter in the x-y planes (no z pass, so the z ghosts go
    unread)."""
    q = _yext(_zext(q, wall_lo, wall_hi, zper), yw)
    return (st.filter2d if f2d else st.filter3d)(wrap_x(q))


def _zwrap_padded(q):
    """The (nz+2, ny+2, nx+2) fill of an interior periodic along x, y and
    z: what the dsmag kernel's periodic-z mode loads (plane indices mod
    nz), whatever the z-edge stack holds."""
    return wrap_xy(torch.cat([q[-1:], q, q[:1]]))


def _slab_ext(u, v, w, ue, ve, we, ye, yh, yown, name):
    """A slab of the y-slab mesh extended by the depth-2 halo pairs yh of
    (u, v, w) (rows (nz, 4, nx), corners (3, 4, nx): rows -2, -1, nyl,
    nyl+1, mesh.halo_y) on the sides it does not own, for a twin that runs
    on the extended field and keeps the slab's rows: its periodic wrap
    reaches the outputs of the extension's rows only (the velocity's
    two-row halo is the dynamic model's reach).  ye with yown: a slab of a
    y-walled mesh, ye its y-row stack pairs (boundary.slab_ystack) and
    yown = (lower, upper) the y walls it holds, whose stack rows are the
    wall's; the extended field's stack pairs take the wall's rows on an
    owned side, the wrap and its own last row elsewhere.  As the kernels'
    YW reads, the rows -1, nyl - 1 and nyl are the stacks' on every side:
    on a side the slab does not own they replace the halo's rows -1 and
    nyl and, on the upper one, the slab's last row.  Returns the
    extended (u, v, w, ue, ve, we), their stack pairs (or None), the y
    walls yw (or None) and the slice of the slab's own rows."""
    if (ye is None) != (yown is None):
        raise ValueError(f"{name}: a slab's y walls take ye and yown "
                         'together')
    lo, hi = yown if ye is not None else (False, False)

    def ext(q, e, h, y):
        rows, corners = h
        if y is not None:
            (r, c), last = y, slice(None, q.shape[1] - (not hi))
            rows, corners = (torch.cat([a[:, :1], s[:, :1], s[:, 2:],
                                        a[:, 3:]], dim=1)
                             for a, s in ((rows, r), (corners, c)))
            q = torch.cat([q[:, last]] + [r[:, 1:2]] * (not hi), dim=1)
            e = torch.cat([e[:, last]] + [c[:, 1:2]] * (not hi), dim=1)
        q = torch.cat([rows[:, :2]] * (not lo) + [q]
                      + [rows[:, 2:]] * (not hi), dim=1)
        e = torch.cat([corners[:, :2]] * (not lo) + [e]
                      + [corners[:, 2:]] * (not hi), dim=1)
        return q, e
    (u, ue), (v, ve), (w, we) = (
        ext(q, e, h, y) for q, e, h, y in
        zip((u, v, w), (ue, ve, we), yh, ye or (None,) * 3))
    yw = None
    if ye is not None:
        def stack(q, e, y):
            r, c = y
            pick = ((r[:, 0], c[:, 0]) if lo else (q[:, -1], e[:, -1]),
                    (r[:, 1], c[:, 1]) if hi else (q[:, -1], e[:, -1]),
                    (r[:, 2], c[:, 2]) if hi else (q[:, 0], e[:, 0]))
            return (torch.stack([a for a, _ in pick], dim=1),
                    torch.stack([b for _, b in pick], dim=1))
        ye = [stack(q, e, y) for q, e, y in
              zip((u, v, w), (ue, ve, we), ye)]
        yw = (bool(lo), bool(hi))
    ny = u.shape[1]
    keep = slice(0 if lo else 2, ny - (0 if hi else 2))
    return (u, v, w, ue, ve, we), ye, yw, keep


def _pencil_xext(fields, edges, xh, yext):
    """A pencil's fields and edge stacks extended along x by their
    two-deep x halo pairs xh (cols (nz, 4, nyl + 4), corners (3, 4,
    nyl + 4): columns -2, -1, nxp, nxp + 1 over the rows -2 .. nyl + 1);
    yext: the fields are already extended along y by two rows a side
    (_slab_ext), else the halos' rows 0 .. nyl - 1 (periodic y on the
    pencil).  Returns the six extended arrays and the slice of the
    pencil's own columns."""
    rows = slice(None) if yext else slice(2, -2)
    out = [_xcat(a, h, rows) for a, h in zip(
        (*fields, *edges), (*(c for c, _ in xh), *(k for _, k in xh)))]
    return out, slice(2, out[0].shape[2] - 2)


def _xcat(a, h, rows):
    """a (n, m, nxp) extended along x by the rows `rows` of its two-deep x
    halo h ((n, 4, nyl + 4), row y at index y + 2)."""
    h = h[..., rows].transpose(1, 2)
    return torch.cat([h[..., :2], a, h[..., 2:]], dim=2)


def dsmag_level1_plain(u, v, w, ue, ve, we, dzci, dzfi, dxi, dyi, wall_lo,
                       wall_hi, ye=None, zper=False, f2d=False, yw=None,
                       yh=None, yown=None, xh=None):
    """The grid level of the Germano-Lilly model (pallas_dsmag._ds1_kernel)
    on interiors + the post-correction fill's edge stacks (and with y walls
    its y-row stack pairs ye of (u, v, w)): the filtered products and the
    wall-parallel velocity extrapolate linearly at a wall (u, v at the z
    walls, u, w at the y walls), each component's own fill elsewhere.
    zper (periodic z, the triperiodic box): every z ghost is the plane at
    the other end, the velocity's included (the edge stacks go unread).
    f2d (the 2D test filter, periodic y): every filter is the x-y one, and
    nothing is extrapolated.  yw: which y faces are walls (lower, upper),
    both where ye is given (dsmag_plain's slab of a y-walled mesh passes
    its own).  yh: a slab of the y-slab mesh (z walls, the 3D filter), the
    depth-2 halo pairs of (u, v, w), with ye and yown on a slab of a
    y-walled mesh: the model runs on the slab extended by them (_slab_ext)
    and keeps the slab's rows (csrc/dsmag_level1.cu modes YH, YW + YH).
    xh: a pencil of a 2D mesh (periodic y or a slab's yh, z walls, the 3D
    filter), the two-deep x halo pairs of (u, v, w) (cols (nz, 4,
    nyl + 4), corners (3, 4, nyl + 4), as dsmag_plain's): the model runs
    on the pencil extended by those columns (after the y extension by yh)
    and keeps the pencil's cells (csrc/dsmag_level1.cu mode XH).
    Returns (fm, fvel, lij, s0): fm = filt(|S| S_ij) (6), fvel the
    filtered velocity (3), lij = filt(uc_i uc_j) - filt(uc_i) filt(uc_j)
    (6) with uc the centred velocity, s0 = |S|."""
    if yh is not None or xh is not None:
        if zper or f2d or (xh is not None and ye is not None):
            raise ValueError('dsmag_level1: a slab or a pencil takes z walls '
                             'and the 3D filter, a pencil no y walls')
        keep = xkeep = slice(None)
        if yh is not None:
            (u, v, w, ue, ve, we), ye, yw, keep = _slab_ext(
                u, v, w, ue, ve, we, ye, yh, yown, 'dsmag_level1')
        if xh is not None:
            (u, v, w, ue, ve, we), xkeep = _pencil_xext(
                (u, v, w), (ue, ve, we), xh, yh is not None)
        fm, fvel, lij, s0 = dsmag_level1_plain(u, v, w, ue, ve, we, dzci,
                                               dzfi, dxi, dyi, wall_lo,
                                               wall_hi, ye=ye, yw=yw)

        def crop(q):
            return q[:, keep, xkeep].contiguous()
        return ([crop(q) for q in fm], [crop(q) for q in fvel],
                [crop(q) for q in lij], crop(s0))
    if yw is None:
        yw = (ye is not None,) * 2
    yu, yv, ywr = (None,) * 3 if ye is None else ye
    if zper:
        up, vp, wp = map(_zwrap_padded, (u, v, w))
    else:
        up, vp, wp = padded(u, ue, yu), padded(v, ve, yv), padded(w, we, ywr)
    s0, sij = st.strain_rate(up, vp, wp, dzci, dzfi, dxi, dyi, with_sij=True)

    def filt(q):
        return _filt(q, wall_lo, wall_hi, yw, zper, f2d)
    fm = [filt(s0 * q) for q in sij]

    def vel_ext(qp, along_z, along_y):
        if f2d:
            return qp
        if along_z:
            q = qp[1:-1]
            lo = 2.0 * q[0] - q[1] if wall_lo else qp[0]
            hi = 2.0 * q[-1] - q[-2] if wall_hi else qp[-1]
            qp = torch.cat([lo[None], q, hi[None]])
        if along_y and any(yw):
            q = _yext(qp[:, 1:-1], yw)
            qp = torch.cat([q[:, :1] if yw[0] else qp[:, :1], q[:, 1:-1],
                            q[:, -1:] if yw[1] else qp[:, -1:]], dim=1)
        return qp
    vfilt = st.filter2d if f2d else st.filter3d
    fvel = [vfilt(vel_ext(up, True, True)),
            vfilt(vel_ext(vp, True, False)),
            vfilt(vel_ext(wp, False, True))]

    uc, vc, wc = st.interp_center(up, vp, wp)
    pairs = [(uc, uc), (vc, vc), (wc, wc), (uc, vc), (uc, wc), (vc, wc)]
    lij = [filt(a * b) for a, b in pairs]
    ucf, vcf, wcf = filt(uc), filt(vc), filt(wc)
    fpairs = [(ucf, ucf), (vcf, vcf), (wcf, wcf), (ucf, vcf), (ucf, wcf),
              (vcf, wcf)]
    lij = [q - a * b for q, (a, b) in zip(lij, fpairs)]
    return fm, fvel, lij, s0


def _contraction(fm, lij, ufp, vfp, wfp, alph2, dzci, dzfi, dxi, dyi, yw):
    """The test level on the filled filtered velocity (ufp, vfp, wfp):
    M_ij = 2 (fm - alpha^2 |S~| S~_ij), alpha^2 = 2.52 on the first and
    last y rows at the y walls yw = (lower, upper); returns num = M_ij L_ij
    and den = M_ij M_ij (off-diagonal pairs twice) by cell."""
    s0f, sijf = st.strain_rate(ufp, vfp, wfp, dzci, dzfi, dxi, dyi,
                               with_sij=True)
    a2 = alph2[:, None, None].expand(s0f.shape[0], s0f.shape[1], 1)
    if any(yw):
        a2 = a2.clone()
        if yw[0]:
            a2[:, 0] = 2.52
        if yw[1]:
            a2[:, -1] = 2.52
    mij = [2.0 * (m - a2 * s0f * sf) for m, sf in zip(fm, sijf)]
    num = (mij[0] * lij[0] + mij[1] * lij[1] + mij[2] * lij[2]
           + 2.0 * (mij[3] * lij[3] + mij[4] * lij[4] + mij[5] * lij[5]))
    den = (mij[0] * mij[0] + mij[1] * mij[1] + mij[2] * mij[2]
           + 2.0 * (mij[3] * mij[3] + mij[4] * mij[4] + mij[5] * mij[5]))
    return num, den


def _averaged(num, den, s0, avg):
    """'cavity': nu_t = max(|S| num / den, 0) by cell; otherwise the sums
    of num and den over each z row, (nz, 1), for 'channel' (and 'dit',
    whose weighted mean over the rows is the caller's), over each (z, y)
    row, (nz, ny, 1), for 'duct'."""
    if avg == 'cavity':
        return torch.clamp_min(s0 * num / den, 0.0)
    if avg == 'duct':
        return num.sum(dim=2, keepdim=True), den.sum(dim=2, keepdim=True)
    return num.sum(dim=(1, 2))[:, None], den.sum(dim=(1, 2))[:, None]


def dsmag_plain(u, v, w, ue, ve, we, alph2, dzci, dzfi, dxi, dyi, wall_lo,
                wall_hi, zvals=(0.0, 0.0, 0.0, 0.0), ye=None,
                yvals=(0.0, 0.0, 0.0, 0.0), avg='channel', zper=False,
                f2d=False, yh=None, yown=None, xh=None):
    """The Germano-Lilly model of sgs.dsmag_visct on interiors + the
    post-correction fill's edge stacks, with every ghost recipe written out
    for the class pallas_dsmag.eligible admits: dsmag_level1_plain, then the
    filtered velocity's fill -+1 times the first plane plus 2b (zvals =
    (u_lo, u_hi, v_lo, v_hi), the 'D' values b), and w 0 on both z faces
    (its lower face and the padded-row-nz rewrite).  ye = (yu, yv, yw), the
    fill's y-row stacks: both y faces are walls, with the same recipes
    along y (yvals = (u_lo, u_hi, w_lo, w_hi); v is 0 on its lower face and
    its padded-ny rewrite) and alpha^2 = 2.52 on the first and last y rows.
    zper: periodic z (the triperiodic box), every z ghost of A, of the
    velocity and of the filtered velocity the plane at the other end; f2d:
    the 2D test filter (periodic y), alpha^2 is the caller's (2.52); see
    dsmag_level1_plain.
    Returns (s0, num, den): |S| and the sums of num = M_ij L_ij and
    den = M_ij M_ij (off-diagonal pairs twice) over each z row, (nz, 1),
    for avg 'channel', over each (z, y) row, (nz, ny, 1), for 'duct'; for
    'cavity' (nu_t, None, None), nu_t = max(|S| num / den, 0) by cell.
    yh: a slab of the y-slab mesh (periodic y, z walls or with zper
    periodic z, the 3D or with f2d the 2D filter), the depth-2 halo pairs
    (rows (nz, 4, nx), corners (3, 4, nx)) of (u, v, w), rows -2, -1, nyl,
    nyl+1 (mesh.halo_y; with zper their corners unread): the model runs on
    the slab extended by those rows and keeps the slab's rows (_slab_ext;
    csrc/dsmag.cu mode YH, with ZP and F2D).  ye with yh: a slab of a
    y-walled mesh (YW and YH, z walls, the 3D filter), ye the slab's y-row
    stack pairs (boundary.slab_ystack) and yown = (lower, upper) the y
    walls it holds: the slab is extended by the halo's two rows on a side
    it does not own (its rows -1 and nyl, and the slab's last row, the
    stacks', as the kernel reads them: _slab_ext) and the wall recipes
    apply on the sides it owns, whose stack rows are the wall's.
    xh: a pencil of a 2D mesh (periodic y or a slab's yh, z walls or with
    zper periodic z, the 3D or with f2d the 2D filter, 'channel' or
    'dit'), the two-deep x halo pairs of (u, v, w) (cols (nz, 4, nyl + 4),
    corners (3, 4, nyl + 4): columns -2, -1, nxp, nxp + 1 over the rows
    -2 .. nyl + 1, mesh.halo_x at depth 2 with its rows from the depth-2
    y exchange): the model runs on the pencil extended by those columns
    (after the y extension by yh; with periodic y their rows 0 .. nyl - 1)
    and keeps the pencil's cells (csrc/dsmag.cu mode XH, with YH, ZP and
    F2D).  xh with ye, yh and yown: a pencil of a y-walled 2D mesh (z
    walls, the 3D filter, any average; mode YW + YH + XH), whose x
    halos carry the wall rows on the walls the pencil holds: the pencil,
    its edge stacks, y halos and y-row stacks are first extended along x
    by the x halos' rows (_pencil_xext_walled), then as a slab of a
    y-walled mesh."""
    yw = keep = xkeep = None
    _dsmag_xh_check('dsmag', xh, ye, yh, avg)
    if xh is not None and ye is not None:
        (u, v, w, ue, ve, we), ye, yh, xkeep = _pencil_xext_walled(
            (u, v, w), (ue, ve, we), ye, yh, xh)
        xh = None
    if yh is not None:
        if (zper or f2d) and ye is not None:
            raise ValueError('dsmag: a slab of a y-walled mesh takes z walls '
                             'and the 3D filter')
        (u, v, w, ue, ve, we), ye, yw, keep = _slab_ext(
            u, v, w, ue, ve, we, ye, yh, yown, 'dsmag')
    if xh is not None:
        (u, v, w, ue, ve, we), xkeep = _pencil_xext(
            (u, v, w), (ue, ve, we), xh, yh is not None)
    s0, num, den = _dsmag_cells(u, v, w, ue, ve, we, alph2, dzci, dzfi, dxi,
                                dyi, wall_lo, wall_hi, zvals, ye, yvals,
                                zper, f2d, yw)
    if keep is not None:
        s0, num, den = (q[:, keep] for q in (s0, num, den))
    if xkeep is not None:
        s0, num, den = (q[..., xkeep] for q in (s0, num, den))
    out = _averaged(num, den, s0, avg)
    return (out, None, None) if avg == 'cavity' else (s0, *out)


def _dsmag_xh_check(name, xh, ye, yh, avg):
    """A pencil's x halos take periodic y or a slab's y halo with the
    'channel' or 'dit' sums, or y walls with the y halo and any
    average."""
    if xh is None:
        return
    if (ye is None and avg not in ('channel', 'dit')) or (
            ye is not None and yh is None):
        raise ValueError(f"{name}: a pencil's x halos take periodic y or a "
                         "slab's y halo and the 'channel' or 'dit' sums, or "
                         "y walls with the y halo")


def _pencil_xext_walled(fields, edges, ye, yh, xh):
    """A pencil of a y-walled mesh extended along x by its two-deep x halo
    pairs xh (cols (nz, 4, nyl + 4), corners (3, 4, nyl + 4): columns -2,
    -1, nxp, nxp + 1 over the rows -2 .. nyl + 1, their wall rows the x
    neighbours' on the walls the pencil holds): the fields and edge stacks
    by the rows 0 .. nyl - 1, the y-row stack pairs ye by the rows -1,
    nyl - 1 and nyl, the depth-2 y halo pairs yh by the rows -2, -1, nyl
    and nyl + 1.  Returns the extended (u, v, w, ue, ve, we), ye and yh,
    and the slice of the pencil's own columns."""
    nyl = fields[0].shape[1]
    out, keep = _pencil_xext(fields, edges, xh, False)
    ye = [tuple(_xcat(a, x[i], [1, nyl + 1, nyl + 2])
                for i, a in enumerate(y)) for y, x in zip(ye, xh)]
    yh = [tuple(_xcat(a, x[i], [0, 1, nyl + 2, nyl + 3])
                for i, a in enumerate(h)) for h, x in zip(yh, xh)]
    return out, ye, yh, keep


def _dsmag_cells(u, v, w, ue, ve, we, alph2, dzci, dzfi, dxi, dyi, wall_lo,
                 wall_hi, zvals, ye, yvals, zper, f2d, yw=None):
    """dsmag_plain's model by cell: (|S|, num, den); yw: the y walls
    (lower, upper), both where ye is given unless it says otherwise."""
    if yw is None:
        yw = (ye is not None,) * 2
    fm, (ufi, vfi, wfi), lij, s0 = dsmag_level1_plain(
        u, v, w, ue, ve, we, dzci, dzfi, dxi, dyi, wall_lo, wall_hi, ye=ye,
        zper=zper, f2d=f2d, yw=yw)

    def yfill(q, c):
        # a face that is no wall wraps
        if c == 1:      # [lower face, v_0 .. v_(ny-2), rewrite, ny-2 copy]
            zero = torch.zeros_like(q[:, :1])
            lo = [zero] if yw[0] else [q[:, -1:]]
            hi = ([q[:, :-1], zero, q[:, -2:-1]] if yw[1]
                  else [q, q[:, :1]])
            return torch.cat(lo + hi, 1)
        blo, bhi = (2.0 * yvals[0], 2.0 * yvals[1]) if c == 0 else \
            (2.0 * yvals[2], 2.0 * yvals[3])
        return torch.cat([-q[:, :1] + blo if yw[0] else q[:, -1:], q,
                          -q[:, -1:] + bhi if yw[1] else q[:, :1]], 1)
    if zper:
        ufp, vfp, wfp = map(_zwrap_padded, (ufi, vfi, wfi))
    else:
        szlo = -1.0 if wall_lo else 1.0
        szhi = -1.0 if wall_hi else 1.0
        offlo = (2.0 * zvals[0] if wall_lo else 0.0,
                 2.0 * zvals[2] if wall_lo else 0.0)
        offhi = (2.0 * zvals[1] if wall_hi else 0.0,
                 2.0 * zvals[3] if wall_hi else 0.0)
        ufp, vfp = (wrap_x(torch.cat([(szlo * q[0] + offlo[c])[None], q,
                                      (szhi * q[-1] + offhi[c])[None]]))
                    for c, q in enumerate((yfill(ufi, 0), yfill(vfi, 1))))
        wy = yfill(wfi, 2)
        zero = torch.zeros_like(wy[:1])
        # rows [lower face, w_0 .. w_(nz-2), top-face rewrite, never read]
        wfp = wrap_x(torch.cat([zero, wy[:-1], zero, zero]))
    num, den = _contraction(fm, lij, ufp, vfp, wfp, alph2, dzci, dzfi, dxi,
                            dyi, yw)
    return s0, num, den


def dsmag_level2_plain(fu, fv, fw, fue, fve, fwe, fm, lij, s0, alph2, dzci,
                       dzfi, dxi, dyi, avg='channel', ye=None, yh=None,
                       yown=None, xh=None):
    """The test level of the Germano-Lilly model (pallas_dsmag._ds2_kernel)
    from dsmag_level1's outputs: the filtered velocity (fu, fv, fw) with the
    edge stacks of its BC fill (the static planes, is_correc=False: w's
    faces carry their values, the upper one in the rewrite row) and with y
    walls the fill's y-row stack pairs ye; fm, lij (6 each) and s0.  yh: a
    slab of the y-slab mesh with periodic y, the depth-1 halo pairs of
    (fu, fv, fw) (mesh.halo_y), their rows -1 and nyl; ye with yown: a slab
    of a y-walled mesh, ye the slab's y-row stack pairs of the fill
    (boundary.slab_ystack), alpha^2 2.52 on the first and last rows of the
    y walls yown = (lower, upper) it holds only (csrc/dsmag_level2.cu modes
    YH, YW + YH).  xh: a pencil of a 2D mesh (periodic y or with yh), the
    depth-1 x halo pairs of (fu, fv, fw) in the x stacks' form (cols (nz,
    3, nyl + 2), corners (3, 3, nyl + 2): columns -1 and nxp over the rows
    -1 .. nyl, mesh.halo_x with its rows from the y exchange), which pad
    as x stacks do (csrc/dsmag_level2.cu mode XH).
    Returns nu_t = max(|S| num / den, 0) for avg 'cavity', else (num, den)
    summed over each z row, (nz, 1), for 'channel', over each (z, y) row,
    (nz, ny, 1), for 'duct'."""
    yu, yv, yw = (None,) * 3 if ye is None else ye
    hu, hv, hw = (None,) * 3 if yh is None else yh
    xu, xv, xw = (None,) * 3 if xh is None else xh
    walls = ((ye is not None,) * 2 if yown is None
             else tuple(bool(q) for q in yown))
    num, den = _contraction(fm, lij, padded(fu, fue, yu, hu, xu),
                            padded(fv, fve, yv, hv, xv),
                            padded(fw, fwe, yw, hw, xw),
                            alph2, dzci, dzfi, dxi, dyi, walls)
    return _averaged(num, den, s0, avg)


def correc_updatep_plain(u, v, w, pp, p, we, ppe, dtrk, dxi, dyi, dzci,
                         dzfi, fuv=None, alpha=0.0, impdiff=False,
                         impdiff_1d=False, ypp=None, yv=None, yh=None,
                         xpp=None, xu=None, xh=None):
    ppad = padded(pp, ppe, ypp, yh, xpp if xh is None else xh)
    if yv is not None:
        # v's wall face: the prediction fill's rewrite row (padded y ny)
        v = torch.cat([v[:, :-1], yv[:, 1:2]], dim=1)
    if xu is not None:
        # u's x wall face: the prediction fill's rewrite column (padded
        # x nx), on the interior rows as the kernel reads them (row nz-1
        # from the corners; with y walls the columns' y index is shifted
        # by the lower y ghost)
        ny = u.shape[1]
        j0 = (xu[0].shape[2] - ny) // 2
        face = zpad(*xu)[1:-1, 1, j0:j0 + ny]
        u = torch.cat([u[..., :-1], face[..., None]], dim=2)
    ppc = ppad[1:-1, 1:-1, 1:-1]
    nz = u.shape[0]
    dzci_c = torch.as_tensor(dzci[1:nz + 1], dtype=u.dtype,
                             device=u.device)[:, None, None]
    fu, fv = (0.0, 0.0) if fuv is None else (fuv[0], fuv[1])
    uc = fu + u - dtrk * dxi * (ppad[1:-1, 1:-1, 2:] - ppc)
    vc = fv + v - dtrk * dyi * (ppad[1:-1, 2:, 1:-1] - ppc)
    wc = zpad(w, we)[1:-1] - dtrk * dzci_c * (ppad[2:, 1:-1, 1:-1] - ppc)
    pn = st.updatep(ppad, p, alpha, impdiff, impdiff_1d, dxi, dyi, dzci,
                    dzfi)
    return uc, vc, wc, pn


# ---------------------------------------------------------------------------
# launch plumbing
# ---------------------------------------------------------------------------

def _on_cpu(ref):
    """The dispatch rule: the plain twin serves tensors on the CPU only."""
    return ref.device.type == 'cpu'


def _check(name, ref, fields, planes=(), edges=(), profiles=(), yrows=(),
           ycorners=(), hrows=(), hcorners=(), xcols=(), xcorners=(),
           nyc=None, h2rows=(), h2corners=(), x2cols=(), x2corners=()):
    """Validate what the kernel takes: one CUDA device, float32/float64,
    contiguous, shapes of the interior (nz, ny, nx); x stacks (nz, 3, nyc)
    and their corners (3, 3, nyc); a pencil's two-deep x halos (nz, 4,
    ny + 4) and their corners (3, 4, ny + 4)."""
    if ref.device.type != 'cuda':
        raise ValueError(f'{name}: tensors must be on the CPU (plain twin) '
                         f'or a CUDA device, got {ref.device}')
    if ref.dtype not in (torch.float32, torch.float64):
        raise TypeError(f'{name}: dtype {ref.dtype} (float32 or float64)')
    nz, ny, nx = ref.shape
    want = {'field': (nz, ny, nx), 'plane': (ny, nx), 'edge': (3, ny, nx),
            'y-row stack': (nz, 3, nx), 'corner stack': (3, 3, nx),
            'halo rows': (nz, 2, nx), 'halo corners': (3, 2, nx),
            'x stack': (nz, 3, nyc), 'x corner stack': (3, 3, nyc),
            'halo-2 rows': (nz, 4, nx), 'halo-2 corners': (3, 4, nx),
            'x halo-2 cols': (nz, 4, ny + 4),
            'x halo-2 corners': (3, 4, ny + 4)}
    for kind, group in (('field', fields), ('plane', planes),
                        ('edge', edges), ('y-row stack', yrows),
                        ('corner stack', ycorners), ('halo rows', hrows),
                        ('halo corners', hcorners), ('x stack', xcols),
                        ('x corner stack', xcorners),
                        ('halo-2 rows', h2rows),
                        ('halo-2 corners', h2corners),
                        ('x halo-2 cols', x2cols),
                        ('x halo-2 corners', x2corners)):
        for t in group:
            if t is None:
                continue
            if tuple(t.shape) != want[kind]:
                raise ValueError(f'{name}: {kind} shape {tuple(t.shape)}, '
                                 f'want {want[kind]}')
    for t, n in profiles:
        if t.ndim != 1 or t.shape[0] != n:
            raise ValueError(f'{name}: profile shape {tuple(t.shape)}, '
                             f'want ({n},)')
    for t in (*fields, *planes, *edges, *yrows, *ycorners, *hrows,
              *hcorners, *xcols, *xcorners, *h2rows, *h2corners, *x2cols,
              *x2corners, *(q for q, _ in profiles)):
        if t is None:
            continue
        if t.device != ref.device or t.dtype != ref.dtype:
            raise ValueError(f'{name}: mixed devices or dtypes '
                             f'({t.device}, {t.dtype})')
        if not t.is_contiguous():
            raise ValueError(f'{name}: tensors must be contiguous')


def _ptr(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _ysplit(ys, halo=False):
    """_check's arguments for (rows, corners) y-row stack pairs, or with
    halo a slab's halo pairs (halo = 2: two rows a side)."""
    ys = [y for y in ys if y is not None]
    rows, corners = {False: ('yrows', 'ycorners'), True: ('hrows', 'hcorners'),
                     2: ('h2rows', 'h2corners')}[halo]
    return {rows: [y[0] for y in ys], corners: [y[1] for y in ys]}


def _xsplit(xs, ny, ywalls):
    """_check's arguments for (cols, corners) x stack pairs: nyc = ny, or
    ny + 2 with y walls (ywalls; also a slab's stacks that carry the rows
    -1 and ny, and a pencil's x halos)."""
    xs = [x for x in xs if x is not None]
    return dict(xcols=[x[0] for x in xs], xcorners=[x[1] for x in xs],
                nyc=ny + 2 if ywalls else ny)


def _yptrs(ys):
    """The (rows, corners) pointers of each y-row stack pair, nulls for a
    missing pair."""
    return [_ptr(q) for y in ys for q in ((None, None) if y is None else y)]


def _suffix(t):
    return 'f32' if t.dtype == torch.float32 else 'f64'


def _launch(name, entry, *args, counts=None):
    """Call C entry `entry` on the current stream, raise on its CUDA error,
    then count one launch of `name` in `counts` (LAUNCHES by default)."""
    from . import build
    lib = build.load()
    fn = getattr(lib, entry)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f'{entry}: CUDA error {rc} '
                           f'({build.error_string(rc)})')
    (LAUNCHES if counts is None else counts)[name] += 1


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def mom_rk(u, v, w, s, p, ue, ve, we, se, pe, ruo, rvo, rwo, dzci, dzfi,
           f1, f2, visc, dxi, dyi, bforce, sums=(False, False), split=None,
           ye=None, yh=None, xe=None, sca=None, scae=None, rso=None,
           scal=(0.0, 0.0), xh=None):
    """Momentum RHS (mom.f90:17-309) + low-storage RK3 update with -grad p
    and bforce (rk.f90:77-94) in one pass.  ruo..rwo = None skips the
    previous-RHS reads (first substep, f2 == 0).  s = se = None: no eddy
    viscosity (sgstype 'none'), its streams are not read.  split: implicit
    diffusion with the CN fold, '1d' (z only: ru..rw are the explicit RHS
    advection + xy diffusion, rud the z diffusion) or 'xy+z' (full-3D: ru
    .. rw the advection, rud all the molecular diffusion); u..w are then
    the Crank-Nicolson RHS u_RK - 1/2 f12 rud (pallas_kernels fused_mom_rk
    fold_cn).  sums: per-(z, part) partial sums of the new (full-
    prediction) u / v for the bulk forcing.  ye: y walls, the (rows,
    corners) y-row stack pairs of (u, v, w, visct, p), visct's None without
    visct; yh: a slab of a y-sharded mesh, the halo pairs of the same five
    fields.  xe: x walls, the (cols, corners) x stack pairs of (u, v, w,
    visct, p), visct's None without visct (with periodic y, y walls or on
    a slab with yh, where the columns carry the neighbours' rows -1 and
    ny, nyc = ny + 2; split '1d' with periodic y or on a slab).  sca: the
    passive scalar (the argument s is nu_t), with its z-edge stack scae,
    its previous RHS rso (None with ruo) and scal = (alpha, ssource), its
    diffusivity visc/pr and source; with y or x walls its stack pair is
    the sixth entry of ye or xe (its own BC letters and values; on a slab
    with x walls its x stack pair carries the neighbours' rows like the
    velocity's), on a slab its halo pair the sixth entry of yh (any
    split).  xh: a pencil of a 2D mesh, the x halo pairs of (u, v, w,
    visct, p) (mesh.halo_x; nyc = ny + 2), visct's None without visct,
    with yh or (gy = 1) periodic y, any split, or explicit with the
    pencil's y-row stack pairs ye (y walls, Y_WALLS x X_HALO); with sca
    the scalar's x halo pair its sixth entry (its halo pair the sixth of
    yh, its y-row stack pair the sixth of ye).
    Returns (u, v,
    w, ru, rv, rw, usum, vsum), and with sca also (s, ds), the scalar and
    its RHS; usum/vsum are None or per-(z, part) partial sums,
    (nz, parts): one part on the CPU, one a (y, x) tile of the kernel on
    the card."""
    if split not in _SPLIT_CODE:
        raise ValueError(f"mom_rk: split {split!r} (None, '1d' or 'xy+z')")
    if _on_cpu(u):
        return mom_rk_plain(u, v, w, s, p, ue, ve, we, se, pe, ruo, rvo, rwo,
                            dzci, dzfi, f1, f2, visc, dxi, dyi, bforce,
                            sums=sums, split=split, ye=ye, yh=yh, xe=xe,
                            sca=sca, scae=scae, rso=rso, scal=scal, xh=xh)
    nz, ny, nx = u.shape
    if ye is not None and yh is not None:
        raise ValueError('mom_rk: y walls or a slab halo, not both')
    xhalo = xh is not None
    if xhalo and (xe is not None or (ye is not None and split is not None)):
        raise ValueError("mom_rk: a pencil's x halos go without x stacks, "
                         'and with y walls explicit')
    if xhalo:
        xe = xh
    has_scal = sca is not None
    ye_sc, xe_sc, yh_sc = _six(ye)[5], _six(xe)[5], _six(yh)[5]
    if has_scal and (scae is None or (rso is None) != (ruo is None)
                     or (ye is not None) != (ye_sc is not None)
                     or (xe is not None) != (xe_sc is not None)
                     or (yh is not None) != (yh_sc is not None)):
        raise ValueError('mom_rk: the scalar takes its edge stack, rso '
                         'with ruo, its y and x stack pairs and slab halo '
                         "with the velocity's")
    if not has_scal and (scae is not None or rso is not None
                         or ye_sc is not None or xe_sc is not None
                         or yh_sc is not None):
        raise ValueError('mom_rk: scalar stacks without the scalar')
    ye = None if ye is None else _six(ye)[:5]
    yh = None if yh is None else _six(yh)[:5]
    xe = (None,) * 5 if xe is None else _six(xe)[:5]
    if xe[0] is not None and (
            any(xe[m] is None for m in (1, 2, 4))
            or (xe[3] is None) != (s is None)
            or (split == 'xy+z' and not xhalo)
            or (split is not None and ye is not None)):
        raise ValueError('mom_rk: x walls (or x halos) take the x stacks of '
                         'u, v, w, p '
                         "and of visct where it is given, with split None "
                         "or '1d' (periodic y or a slab)")
    if (ruo is None) != (rvo is None) or (ruo is None) != (rwo is None):
        raise ValueError('mom_rk: pass all or none of ruo, rvo, rwo')
    if (s is None) != (se is None):
        raise ValueError('mom_rk: pass visct with its edge stack, or neither')
    ye = (None,) * 5 if ye is None else tuple(ye)
    yh = (None,) * 5 if yh is None else tuple(yh)
    for what, q in (('y walls take the y-row stacks', ye),
                    ('a slab takes the halos', yh)):
        if q[0] is not None and (any(q[m] is None for m in (1, 2, 4))
                                 or (q[3] is None) != (s is None)):
            raise ValueError(f'mom_rk: {what} of u, v, w, p and of visct '
                             'where it is given')
    _check('mom_rk', u, (u, v, w, s, p, ruo, rvo, rwo, sca, rso),
           edges=(ue, ve, we, se, pe, scae),
           profiles=((dzci, nz + 2), (dzfi, nz + 2)),
           **_ysplit((*ye, ye_sc)), **_ysplit((*yh, yh_sc), halo=True),
           **_xsplit((*xe, xe_sc), ny,
                     ywalls=(ye[0] is not None or yh[0] is not None
                             or xhalo)))
    halo = yh[0] is not None
    outs = [torch.empty_like(u) for _ in range(8 if has_scal else 6)]
    from . import build
    # the kernel's tiles of a plane
    nb = build.load().cales_mom_rk_blocks(ny, nx,
                                          int(u.dtype == torch.float64))
    usum = u.new_empty((nz, nb)) if sums[0] else None
    vsum = u.new_empty((nz, nb)) if sums[1] else None
    d = ctypes.c_double
    args = (*map(_ptr, (u, v, w, s, p, ue, ve, we, se, pe, ruo, rvo, rwo,
                        dzci, dzfi, *outs[:6], usum, vsum)),
            *_yptrs(yh if halo else ye), *_yptrs(xe))
    dims = (ctypes.c_int(nz), ctypes.c_int(ny), ctypes.c_int(nx),
            ctypes.c_int(_SPLIT_CODE[split]))
    modes = (ctypes.c_int(int(halo)), ctypes.c_int(int(xhalo)))
    coefs = (d(f1), d(f2), d(visc), d(dxi), d(dyi), d(bforce[0]),
             d(bforce[1]), d(bforce[2]))
    if has_scal:
        # the scalar variant: its own entry, one count under mom_rk
        _launch('mom_rk', f'cales_mom_rk_scal_{_suffix(u)}', *args,
                *map(_ptr, (sca, scae, rso, *outs[6:])),
                *_yptrs((yh_sc if halo else ye_sc, xe_sc)), *dims, *modes,
                *coefs, d(scal[0]), d(scal[1]))
        return (*outs[:6], usum, vsum, *outs[6:])
    _launch('mom_rk', f'cales_mom_rk_{_suffix(u)}', *args, *dims, *modes,
            *coefs)
    return (*outs, usum, vsum)


def fillps(u, v, w, ue, ve, we, dzfi, dti, dxi, dyi, yv=None, yh=None,
           xu=None, xh=None):
    """Poisson RHS div(u)/dt_rk (fillps.f90:14-48) in one pass.  yv: y
    walls, v's (rows, corners) y-row stack pair (its lower wall face and
    rewrite row enter the divergence); yh: a slab of a y-sharded mesh, v's
    halo pair (its row -1 enters the divergence); xu: x walls, u's
    prediction-fill x stack pair (its lower x face and rewrite column
    enter the divergence; on a slab the slab's own rows, nyc = ny, as u is
    read in its own row only); xh: a pencil of a 2D mesh, u's x halo pair
    (nyc = ny + 2; its column -1 enters the divergence), with yh, yv or
    periodic y."""
    if _on_cpu(u):
        return fillps_plain(u, v, w, ue, ve, we, dzfi, dti, dxi, dyi, yv=yv,
                            yh=yh, xu=xu, xh=xh)
    nz, ny, nx = u.shape
    if yv is not None and yh is not None:
        raise ValueError('fillps: y walls or a slab halo, not both')
    xhalo = xh is not None
    if xhalo and xu is not None:
        raise ValueError("fillps: a pencil's x halo goes without x stacks")
    if xhalo:
        xu = xh
    _check('fillps', u, (u, v, w), edges=(ue, ve, we),
           profiles=((dzfi, nz + 2),), **_ysplit((yv,)),
           **_ysplit((yh,), halo=True),
           **_xsplit((xu,), ny, ywalls=yv is not None or xhalo))
    rhs = torch.empty_like(u)
    d = ctypes.c_double
    _launch('fillps', f'cales_fillps_{_suffix(u)}',
            *map(_ptr, (u, v, w, ue, ve, we, dzfi, rhs)),
            *_yptrs((yh if yh is not None else yv,)), *_yptrs((xu,)),
            ctypes.c_int(nz), ctypes.c_int(ny), ctypes.c_int(nx),
            ctypes.c_int(int(yh is not None)), ctypes.c_int(int(xhalo)),
            d(dti), d(dxi), d(dyi))
    return rhs


def correc_smag(u, v, w, pp, p, ue, ve, we, ppe, dtrk, dxi, dyi, dzci, dzfi,
                visc, csd2, zrec, fuv, dw, nearlo, tauw_lo, tauw_hi,
                have_zwalls=True):
    """Projection u -= dt grad pp (+ the deferred forcing fuv = (fu, fv)),
    p += pp, and the van Driest static Smagorinsky nu_t of the corrected
    field, in one pass (correc.f90 + updatep.f90 + sgs.f90:69-152).

    ue/ve/we: the PREDICTION fill's edge stacks; zrec: (u, v) z-ghost
    recipes of the post-correction fill ('D', 'N' or, on a wall-modelled
    face, 'E'; see ghost_row); csd2, dw, nearlo: (nz,) profiles
    (Cs Delta)^2, nearest-wall distance, 1 where the lower wall is nearer;
    tauw_lo/hi: (ny, nx) wall-shear planes.  Returns (u, v, w, p, visct)."""
    if _on_cpu(u):
        return correc_smag_plain(u, v, w, pp, p, ue, ve, we, ppe, dtrk, dxi,
                                 dyi, dzci, dzfi, visc, csd2, zrec, fuv, dw,
                                 nearlo, tauw_lo, tauw_hi,
                                 have_zwalls=have_zwalls)
    nz, ny, nx = u.shape
    _check('correc_smag', u, (u, v, w, pp, p), planes=(tauw_lo, tauw_hi),
           edges=(ue, ve, we, ppe),
           profiles=((dzci, nz + 2), (dzfi, nz + 2), (csd2, nz), (dw, nz),
                     (nearlo, nz), (fuv, 2)))
    recs = []
    for rec in zrec:
        for side in range(2):
            lt, b, dr = rec[3 * side:3 * side + 3]
            if lt not in _LETTER_CODE:
                raise ValueError(f'correc_smag: z-ghost letter {lt!r} '
                                 '(D, N or E)')
            if lt == 'E' and nz < 2:
                raise ValueError(f'correc_smag: the E recipe takes nz >= 2, '
                                 f'got {nz}')
            recs += [ctypes.c_int(_LETTER_CODE[lt]), ctypes.c_double(b),
                     ctypes.c_double(dr)]
    outs = [torch.empty_like(u) for _ in range(5)]
    d = ctypes.c_double
    _launch('correc_smag', f'cales_correc_smag_{_suffix(u)}',
            *map(_ptr, (u, v, w, pp, p, ue, ve, we, ppe, dzci, dzfi, csd2,
                        dw, nearlo, tauw_lo, tauw_hi, fuv, *outs)),
            ctypes.c_int(nz), ctypes.c_int(ny), ctypes.c_int(nx),
            ctypes.c_int(int(bool(have_zwalls))), *recs,
            d(dtrk), d(dxi), d(dyi), d(visc))
    return tuple(outs)


def correc_updatep(u, v, w, pp, p, we, ppe, dtrk, dxi, dyi, dzci, dzfi,
                   fuv=None, alpha=0.0, impdiff=False, impdiff_1d=False,
                   ypp=None, yv=None, yh=None, xpp=None, xu=None, xh=None):
    """Projection u -= dt grad pp (+ the deferred forcing fuv = (fu, fv) when
    given) and p += pp (+ alpha L(pp) under implicit diffusion, L the z
    second difference under impdiff_1d) in one pass (correc.f90:14-68,
    updatep.f90:14-50).  we: the PREDICTION fill's w edge stack (row 1 is
    the wall-face rewrite); u, v, p are read from their interiors.  y
    walls: ypp, pp's (rows, corners) y-row stack pair, and yv, v's
    prediction-fill y-row stack (nz, 3, nx), whose row 1 (the set_bc
    rewrite) stands in for v's interior last row.  yh: a slab of a
    y-sharded mesh, pp's halo pair (v's last row is the slab's own).  x
    walls: xpp, pp's (cols, corners) x stack pair, and xu, u's
    prediction-fill pair, whose column 1 (the set_bc rewrite) stands in
    for u's interior last column (on a slab both hold the slab's own
    rows, nyc = ny: pp's x ghosts are read in the cell's own row only).
    xh: a pencil of a 2D mesh, pp's x halo pair (nyc = ny + 2; u's last
    column is its own), with yh, periodic y or y walls (ypp and yv, the
    pencil's).  Returns (u, v, w, p)."""
    if _on_cpu(u):
        return correc_updatep_plain(u, v, w, pp, p, we, ppe, dtrk, dxi, dyi,
                                    dzci, dzfi, fuv, alpha, impdiff,
                                    impdiff_1d, ypp=ypp, yv=yv, yh=yh,
                                    xpp=xpp, xu=xu, xh=xh)
    nz, ny, nx = u.shape
    if (ypp is None) != (yv is None):
        raise ValueError('correc_updatep: y walls take ypp and yv together')
    if ypp is not None and yh is not None:
        raise ValueError('correc_updatep: y walls or a slab halo, not both')
    if (xpp is None) != (xu is None):
        raise ValueError('correc_updatep: x walls take xpp and xu together')
    xhalo = xh is not None
    if xhalo and xpp is not None:
        raise ValueError("correc_updatep: a pencil's x halo goes without x "
                         'stacks')
    if xhalo:
        xpp = xh
    _check('correc_updatep', u, (u, v, w, pp, p), edges=(we, ppe),
           profiles=((dzci, nz + 2), (dzfi, nz + 2))
           + (((fuv, 2),) if fuv is not None else ()),
           yrows=() if yv is None else (ypp[0], yv),
           ycorners=() if yv is None else (ypp[1],),
           **_ysplit((yh,), halo=True),
           **_xsplit((xpp, xu), ny, ywalls=yv is not None or xhalo))
    outs = [torch.empty_like(u) for _ in range(4)]
    d = ctypes.c_double
    _launch('correc_updatep', f'cales_correc_{_suffix(u)}',
            *map(_ptr, (u, v, w, pp, p, we, ppe, dzci, dzfi, fuv, *outs)),
            *_yptrs((yh if yh is not None else ypp,)), _ptr(yv),
            *_yptrs((xpp, xu)),
            ctypes.c_int(nz), ctypes.c_int(ny), ctypes.c_int(nx),
            ctypes.c_int(int(yh is not None)), ctypes.c_int(int(xhalo)),
            ctypes.c_int(int(bool(impdiff))),
            ctypes.c_int(int(bool(impdiff_1d))),
            d(dtrk), d(dxi), d(dyi), d(alpha))
    return tuple(outs)


def smag(u, v, w, ue, ve, we, dzci, dzfi, dxi, dyi, visc, csd2, dw, nearlo,
         tauw_lo, tauw_hi, have_zwalls=True, yh=None, ye=None, ywall=None,
         xe=None, xwall=None, xh=None):
    """Static Smagorinsky nu_t with the nearer z wall's van Driest damping
    (sgs.f90:69-152) from the post-correction fill (interiors + edge
    stacks) in one pass.  csd2, dw, nearlo: (nz,) profiles (Cs Delta)^2,
    nearest-wall distance, 1 where the lower wall is nearer; tauw_lo/hi:
    (ny, nx) wall-shear planes.  yh: a slab of a y-sharded mesh, the halo
    pairs of (u, v, w).  ye: y walls, the (rows, corners) y-row stack
    pairs of (u, v, w) (extrapolated on wall-modelled faces by the
    caller, sgs.extrapolate_stacks), with ywall = (dwy, nearylo,
    tauw_ylo, tauw_yhi): the (ny,) distance to the nearer y wall and 1
    where it is the lower one, the y walls' (nz, nx) shear planes.  xe: x
    walls (periodic y, y walls, or a slab with yh, whose columns carry the
    neighbours' rows -1 and ny, nyc = ny + 2), the (cols, corners) x stack
    pairs of (u, v, w) (extrapolated on wall-modelled z faces by the caller,
    sgs.extrapolate_stacks), with xwall = (dwx, nearxlo, tauw_xlo,
    tauw_xhi), the (nx,) distance to the nearer x wall, 1 where it is the
    lower one, and the x walls' (nz, ny) shear planes, or None where
    neither x face is a wall.  xh: a pencil of a 2D mesh, the x halo pairs
    of (u, v, w) (nyc = ny + 2), with yh, periodic y or y walls (ye and
    ywall: the pencil's stacks and columns of the y walls' shear planes),
    no x wall.  The nearest wall damps (see _van_driest)."""
    if (ye is None) != (ywall is None):
        raise ValueError('smag: y walls take ye and ywall together')
    if ye is not None and yh is not None:
        raise ValueError('smag: y walls or a slab halo, not both')
    if xe is None and xwall is not None:
        raise ValueError('smag: x walls take their x stacks')
    xhalo = xh is not None
    if xhalo and xe is not None:
        raise ValueError("smag: a pencil's x halos go without x stacks")
    if _on_cpu(u):
        return smag_plain(u, v, w, ue, ve, we, dzci, dzfi, dxi, dyi, visc,
                          csd2, dw, nearlo, tauw_lo, tauw_hi,
                          have_zwalls=have_zwalls, yh=yh, ye=ye, ywall=ywall,
                          xe=xe, xwall=xwall, xh=xh)
    if xhalo:
        xe = xh
    nz, ny, nx = u.shape
    ys = (None,) * 3 if yh is None and ye is None else tuple(
        yh if yh is not None else ye)
    if len({q is None for q in ys}) > 1:
        raise ValueError('smag: pass the halos or y-row stacks of u, v and '
                         'w, or none')
    dwy, nearylo, tylo, tyhi = (None,) * 4 if ywall is None else ywall
    dwx, nearxlo, txlo, txhi = (None,) * 4 if xwall is None else xwall
    xs = (None,) * 3 if xe is None else tuple(xe)
    if len({q is None for q in xs}) > 1:
        raise ValueError('smag: pass the x stacks of u, v and w, or none')
    _check('smag', u, (u, v, w), planes=(tauw_lo, tauw_hi),
           edges=(ue, ve, we),
           profiles=((dzci, nz + 2), (dzfi, nz + 2), (csd2, nz), (dw, nz),
                     (nearlo, nz))
           + (() if ywall is None else ((dwy, ny), (nearylo, ny)))
           + (() if xwall is None else ((dwx, nx), (nearxlo, nx))),
           **_ysplit(ys, halo=yh is not None),
           **_xsplit(xs, ny, ywalls=ye is not None or yh is not None
                     or xhalo))
    for what, shape, group in (('y', (nz, nx), (tylo, tyhi)),
                               ('x', (nz, ny), (txlo, txhi))):
        for t in group:
            if t is not None and (
                    tuple(t.shape) != shape or t.device != u.device
                    or t.dtype != u.dtype or not t.is_contiguous()):
                raise ValueError(
                    f'smag: {what}-wall shear planes contiguous {shape} '
                    f'{u.dtype} on {u.device}, got {tuple(t.shape)} '
                    f'{t.dtype} on {t.device}')
    ymode = 2 if yh is not None else 1 if ye is not None else 0
    out = torch.empty_like(u)
    d = ctypes.c_double
    _launch('smag', f'cales_smag_{_suffix(u)}',
            *map(_ptr, (u, v, w, ue, ve, we, dzci, dzfi, csd2, dw, nearlo,
                        tauw_lo, tauw_hi, dwy, nearylo, tylo, tyhi, dwx,
                        nearxlo, txlo, txhi, out)),
            *_yptrs(ys), *_yptrs(xs), ctypes.c_int(nz), ctypes.c_int(ny),
            ctypes.c_int(nx), ctypes.c_int(ymode), ctypes.c_int(int(xhalo)),
            ctypes.c_int(int(bool(have_zwalls))), d(dxi), d(dyi), d(visc))
    return out


# (y, x) cells of one partial sum of dsmag's 'channel' and 'duct' outputs
# (csrc/dsmag.cu DS_SUM_TY, DS_TX): a block of the kernel's taller float32
# tile writes one per 8-row group, so the partial sums keep their layout
DSMAG_TILE = (8, 32)


# the kernels' average codes; 'dit' takes the 'channel' sums, whose
# weighted mean over the rows is the caller's
_DSMAG_AVG = {'channel': 0, 'duct': 1, 'cavity': 2, 'dit': 0}


def dsmag(u, v, w, ue, ve, we, alph2, dzci, dzfi, dxi, dyi, wall_lo, wall_hi,
          zvals=(0.0, 0.0, 0.0, 0.0), ye=None, yvals=(0.0, 0.0, 0.0, 0.0),
          avg='channel', zper=False, f2d=False, yh=None, yown=None,
          xh=None):
    """Dynamic Smagorinsky (the Germano-Lilly model, sgs.f90:153-370) in
    one z-march; no intermediate field goes to device memory.  Inputs: the
    post-correction fill (interiors + edge stacks, and with y walls the
    y-row stack pairs ye of (u, v, w)), alph2 the (nz,) filter-ratio
    profile, wall_lo/hi the z wall flags, zvals and yvals the
    filtered-velocity fill's wall-parallel 'D' values (see dsmag_plain).
    zper: periodic z (the triperiodic box; csrc/dsmag.cu mode ZP), the
    z ghosts the planes at the other end, the edge stacks unread; f2d: the
    2D test filter in the x-y planes (mode F2D; periodic y).  yh: a slab
    of the y-slab mesh (mode YH; periodic y, z walls or with zper periodic
    z (modes ZP and YH), the 3D or with f2d the 2D filter (F2D and YH),
    'channel' or 'dit'), the depth-2
    halo pairs (rows (nz, 4, nx), corners (3, 4, nx)) of (u, v, w) from
    mesh.halo_y, which the velocity tile takes for its rows -2, -1, nyl
    and nyl+1 (with zper the halo's rows of plane t mod nz, its corners
    unread); the sums are the slab's.  yh
    with ye: a slab of a y-walled mesh (modes YW and YH, any average), ye
    the slab's y-row stack pairs (boundary.slab_ystack: the wall's rows on
    the sides it owns, the neighbours' elsewhere), which the tile takes for
    its rows -1, nyl-1 and nyl, the halo its rows -2 and nyl+1, and yown =
    (lower, upper) the y walls the slab holds, where the wall recipes
    apply.  xh: a pencil of a 2D mesh (mode XH; periodic y or with yh, z
    walls or with zper periodic z, the 3D or with f2d the 2D filter,
    'channel' or 'dit'), the two-deep x halo pairs of (u, v, w) (cols
    (nz, 4, ny + 4), corners (3, 4, ny + 4): columns -2, -1, nx, nx + 1
    over the rows -2 .. ny + 1,
    mesh.halo_x at depth 2, its rows from the depth-2 y exchange;
    timeloop._pencil_halos), which the velocity tile takes for its
    columns -2, -1, nx and nx + 1 (with zper the plane t mod nz, the
    corners unread); the sums are the pencil's.  xh with ye, yh and yown:
    a pencil of a y-walled mesh (modes YW, YH and XH; z walls, the 3D
    filter, any average), the x halos' rows -1, ny-1 and ny on the walls
    the pencil holds the x neighbours' wall rows; 'duct' writes the
    pencil's sums, which the caller sums over the mesh row.
    Returns (s0, num, den): |S| and partial sums of num = M_ij L_ij and
    den = M_ij M_ij, which the caller sums over their last dim: per
    (z, block), (nz, nblk), for avg 'channel' or 'dit'; per (z, y, x block),
    (nz, ny, nx/32), for 'duct'.  For 'cavity', (nu_t, None, None).  The
    twin returns the sums whole, (nz, 1) or (nz, ny, 1)."""
    if avg not in _DSMAG_AVG:
        raise ValueError(f'dsmag: avg {avg!r} (dit, channel, duct or '
                         'cavity)')
    if zper and (wall_lo or wall_hi or ye is not None):
        raise ValueError('dsmag: periodic z takes no z or y walls')
    if f2d and ye is not None:
        raise ValueError('dsmag: the 2D test filter takes no y walls')
    if yh is not None and ye is None and _DSMAG_AVG[avg] != 0:
        raise ValueError("dsmag: a slab's halos with periodic y take the "
                         "'channel' or 'dit' sums")
    if (yown is not None) != (yh is not None and ye is not None):
        raise ValueError("dsmag: yown names a slab's y walls, with ye and "
                         'yh')
    _dsmag_xh_check('dsmag', xh, ye, yh, avg)
    if _on_cpu(u):
        return dsmag_plain(u, v, w, ue, ve, we, alph2, dzci, dzfi, dxi, dyi,
                           wall_lo, wall_hi, zvals, ye=ye, yvals=yvals,
                           avg=avg, zper=zper, f2d=f2d, yh=yh, yown=yown,
                           xh=xh)
    nz, ny, nx = u.shape
    if zper and nz < 3:
        raise ValueError(f'dsmag: nz = {nz} with periodic z (at least 3)')
    if yh is not None and ny < 2:
        raise ValueError(f'dsmag: a slab of {ny} row(s) (its two-row halo '
                         'reaches one rank a side)')
    if xh is not None and nx < 2:
        raise ValueError(f'dsmag: a pencil of {nx} column(s) (its two-column '
                         'x halo reaches one rank a side)')
    if yh is None and xh is None:
        ye = _check_dsmag('dsmag', u, ue, ve, we,
                           ((alph2, nz), (dzci, nz + 2), (dzfi, nz + 2)), ye,
                           (u, v, w))
    else:
        ye = (None,) * 3 if ye is None else tuple(ye)
        _check('dsmag', u, (u, v, w), edges=(ue, ve, we),
               profiles=((alph2, nz), (dzci, nz + 2), (dzfi, nz + 2)),
               **_ysplit(ye), **_ysplit(yh or (), halo=2),
               x2cols=[c for c, _ in xh or ()],
               x2corners=[k for _, k in xh or ()])
    lo, hi = (0, 0) if yown is None else (int(bool(q)) for q in yown)
    ty, tx = DSMAG_TILE
    gx = -(-nx // tx)
    s0 = torch.empty_like(u)
    code = _DSMAG_AVG[avg]
    shape = ((nz, -(-ny // ty) * gx), (nz, ny, gx), None)[code]
    num = None if shape is None else u.new_empty(shape)
    den = None if shape is None else u.new_empty(shape)
    d = ctypes.c_double
    _launch('dsmag', f'cales_dsmag_{_suffix(u)}',
            *map(_ptr, (u, v, w, ue, ve, we, alph2, dzci, dzfi, s0, num,
                        den)), *_yptrs(ye), *_yptrs((None,) * 3 if yh is None
                                                    else yh),
            *_yptrs((None,) * 3 if xh is None else xh),
            ctypes.c_int(nz), ctypes.c_int(ny), ctypes.c_int(nx),
            ctypes.c_int(int(bool(wall_lo))), ctypes.c_int(int(bool(wall_hi))),
            ctypes.c_int(code), ctypes.c_int(int(bool(zper))),
            ctypes.c_int(int(bool(f2d))), ctypes.c_int(lo), ctypes.c_int(hi),
            d(dxi), d(dyi), *(d(float(q)) for q in (*zvals, *yvals)))
    return s0, num, den


def _check_dsmag(name, u, ue, ve, we, profiles, ye, fields):
    """The dsmag kernels' shared checks; returns ye as three pairs or
    Nones."""
    nz, ny, _ = u.shape
    if nz < 2:
        raise ValueError(f'{name}: nz = {nz} (at least 2)')
    if ye is not None and ny < 4:
        raise ValueError(f'{name}: ny = {ny} with y walls (at least 4)')
    ye = (None,) * 3 if ye is None else tuple(ye)
    _check(name, u, fields, edges=(ue, ve, we), profiles=profiles,
           **_ysplit(ye))
    return ye


def dsmag_level1(u, v, w, ue, ve, we, dzci, dzfi, dxi, dyi, wall_lo,
                 wall_hi, ye=None, yh=None, yown=None, xh=None):
    """The grid level of the two-pass dynamic Smagorinsky model in one
    z-march (see dsmag_level1_plain): from the post-correction fill
    (interiors + edge stacks, with y walls the y-row stack pairs ye of
    (u, v, w)) to (fm, fvel, lij, s0), 16 fields in the fields' dtype,
    views of one (16, nz, ny, nx) block.  yh: a slab of the y-slab mesh
    (mode YH), the depth-2 halo pairs (rows (nz, 4, nx), corners (3, 4,
    nx)) of (u, v, w) from mesh.halo_y, the velocity tile's rows -2, -1,
    nyl and nyl+1; with ye and yown = (lower, upper) a slab of a y-walled
    mesh (modes YW and YH): ye the slab's y-row stack pairs
    (boundary.slab_ystack) for the rows -1, nyl-1 and nyl, the wall
    recipes on the walls it holds.  xh: a pencil of a 2D mesh (mode XH,
    no y walls, with yh or periodic y), the two-deep x halo pairs of
    (u, v, w) (cols (nz, 4, ny + 4), corners (3, 4, ny + 4): columns -2,
    -1, nx, nx + 1 over the rows -2 .. ny + 1, as kernels.dsmag's), the
    velocity tile's columns -2, -1, nx and nx + 1."""
    if (yown is not None) != (yh is not None and ye is not None):
        raise ValueError("dsmag_level1: yown names a slab's y walls, with ye "
                         'and yh')
    if xh is not None and ye is not None:
        raise ValueError("dsmag_level1: a pencil's x halos take periodic y "
                         "or a slab's y halo")
    lo, hi = (-1, -1) if yown is None else (int(bool(q)) for q in yown)
    if _on_cpu(u):
        return dsmag_level1_plain(u, v, w, ue, ve, we, dzci, dzfi, dxi, dyi,
                                  wall_lo, wall_hi, ye=ye, yh=yh, yown=yown,
                                  xh=xh)
    nz, ny, nx = u.shape
    if xh is not None and nx < 2:
        raise ValueError(f'dsmag_level1: a pencil of {nx} column(s) (its '
                         'two-column x halo reaches one rank a side)')
    if yh is None and xh is None:
        ye = _check_dsmag('dsmag_level1', u, ue, ve, we,
                           ((dzci, nz + 2), (dzfi, nz + 2)), ye, (u, v, w))
    else:
        if nz < 2 or ny < 2:
            raise ValueError(f'dsmag_level1: a slab of {ny} row(s) and nz = '
                             f'{nz} (at least 2 each)')
        ye = (None,) * 3 if ye is None else tuple(ye)
        _check('dsmag_level1', u, (u, v, w), edges=(ue, ve, we),
               profiles=((dzci, nz + 2), (dzfi, nz + 2)), **_ysplit(ye),
               **_ysplit(yh or (), halo=2),
               x2cols=[c for c, _ in xh or ()],
               x2corners=[k for _, k in xh or ()])
    out = u.new_empty((16, nz, ny, nx))
    d = ctypes.c_double
    _launch('dsmag_level1', f'cales_dsmag_level1_{_suffix(u)}',
            *map(_ptr, (u, v, w, ue, ve, we, dzci, dzfi, out)), *_yptrs(ye),
            *_yptrs((None,) * 3 if yh is None else yh),
            *_yptrs((None,) * 3 if xh is None else xh),
            ctypes.c_int(nz), ctypes.c_int(ny), ctypes.c_int(nx),
            ctypes.c_int(int(bool(wall_lo))), ctypes.c_int(int(bool(wall_hi))),
            ctypes.c_int(lo), ctypes.c_int(hi), d(dxi), d(dyi))
    return list(out[0:6]), list(out[6:9]), list(out[9:15]), out[15]


def dsmag_level2(fu, fv, fw, fue, fve, fwe, fm, lij, s0, alph2, dzci, dzfi,
                 dxi, dyi, avg='channel', ye=None, yh=None, yown=None,
                 xh=None):
    """The test level of the two-pass dynamic Smagorinsky model (see
    dsmag_level2_plain), one thread per cell: the filtered velocity with
    its fill's edge stacks (and y-row stack pairs ye), dsmag_level1's fm,
    lij and s0, alph2 the (nz,) filter-ratio profile.  yh: a slab of the
    y-slab mesh with periodic y (mode YH, 'channel' or 'dit'), the depth-1
    halo pairs (rows (nz, 2, nx), corners (3, 2, nx)) of (fu, fv, fw);
    yown = (lower, upper) with ye: a slab of a y-walled mesh (modes YW and
    YH), ye the slab's y-row stack pairs of the fill, alpha^2 2.52 at the
    walls it holds.  xh: a pencil of a 2D mesh (mode XH, 'channel' or
    'dit', with yh or periodic y), the depth-1 x halo pairs of (fu, fv,
    fw) in the x stacks' form (cols (nz, 3, ny + 2), corners (3, 3,
    ny + 2): columns -1 and nx over the rows -1 .. ny, mesh.halo_x with
    its rows from the y exchange), read on the first and last columns.
    Returns nu_t for avg 'cavity'; otherwise partial sums
    (num, den) that the caller sums over their last dim: per (z, block),
    (nz, nblk), for 'channel'; per (z, y, x block of 32), (nz, ny,
    ceil(nx/32)), for 'duct'.  The twin returns the sums whole, (nz, 1) or
    (nz, ny, 1)."""
    if avg not in _DSMAG_AVG:
        raise ValueError(f'dsmag_level2: avg {avg!r} (dit, channel, duct or '
                         'cavity)')
    if yh is not None and (ye is not None or _DSMAG_AVG[avg] != 0):
        raise ValueError("dsmag_level2: a slab's halos take periodic y and "
                         "the 'channel' or 'dit' sums")
    if yown is not None and ye is None:
        raise ValueError("dsmag_level2: yown names a slab's y walls, with "
                         'ye')
    if xh is not None and (ye is not None or _DSMAG_AVG[avg] != 0):
        raise ValueError("dsmag_level2: a pencil's x halos take periodic y "
                         "or a slab's y halo and the 'channel' or 'dit' sums")
    if _on_cpu(fu):
        return dsmag_level2_plain(fu, fv, fw, fue, fve, fwe, fm, lij, s0,
                                  alph2, dzci, dzfi, dxi, dyi, avg=avg, ye=ye,
                                  yh=yh, yown=yown, xh=xh)
    nz, ny, nx = fu.shape
    if xh is not None and nx < 2:
        raise ValueError(f'dsmag_level2: a pencil of {nx} column(s)')
    if len(fm) != 6 or len(lij) != 6:
        raise ValueError('dsmag_level2: fm and lij take 6 fields each')
    lo, hi = (-1, -1) if yown is None else (int(bool(q)) for q in yown)
    if yh is None and yown is None and xh is None:
        ye = _check_dsmag('dsmag_level2', fu, fue, fve, fwe,
                           ((alph2, nz), (dzci, nz + 2), (dzfi, nz + 2)), ye,
                           (fu, fv, fw, *fm, *lij, s0))
    else:
        if nz < 2 or ny < 2:
            raise ValueError(f'dsmag_level2: a slab of {ny} row(s) and nz = '
                             f'{nz} (at least 2 each)')
        ye = (None,) * 3 if ye is None else tuple(ye)
        _check('dsmag_level2', fu, (fu, fv, fw, *fm, *lij, s0),
               edges=(fue, fve, fwe),
               profiles=((alph2, nz), (dzci, nz + 2), (dzfi, nz + 2)),
               **_ysplit(ye), **_ysplit((None,) * 3 if yh is None else yh,
                                        halo=True),
               **_xsplit(xh or (), ny, ywalls=True))
    from . import build
    gx = -(-nx // 32)
    code = _DSMAG_AVG[avg]
    shape = ((nz, -(-(ny * gx * 32) // build.THREADS)), (nz, ny, gx),
             (nz, ny, nx))[code]
    num = fu.new_empty(shape)
    den = None if avg == 'cavity' else fu.new_empty(shape)
    d = ctypes.c_double
    _launch('dsmag_level2', f'cales_dsmag_level2_{_suffix(fu)}',
            *map(_ptr, (fu, fv, fw, fue, fve, fwe, *fm, *lij, s0, alph2,
                        dzci, dzfi, num, den)), *_yptrs(ye),
            *_yptrs((None,) * 3 if yh is None else yh),
            *_yptrs((None,) * 3 if xh is None else xh),
            ctypes.c_int(nz), ctypes.c_int(ny), ctypes.c_int(nx),
            ctypes.c_int(code), ctypes.c_int(lo), ctypes.c_int(hi), d(dxi),
            d(dyi))
    return num if avg == 'cavity' else (num, den)


# the wall-model kernel's plain twin lives with the model (wallmodel.py)
wm_planes_plain = wmod.wm_planes_plain


_WM_FACES = 4     # csrc/wallmodel.cu WM_FACES: two y and two z faces
_I4, _D4 = ctypes.c_int * _WM_FACES, ctypes.c_double * _WM_FACES


class _WmArgs(ctypes.Structure):
    """The wall-model kernel's static arguments (csrc/wallmodel.cu
    WmArgs, the same layout); the slots past nf are unused."""
    _fields_ = [('nf', ctypes.c_int), *((q, _I4) for q in
                                        ('d', 'mtype', 'r1', 'r2')),
                ('ridx', ctypes.c_int * 3 * 2 * _WM_FACES),
                *((q, _D4) for q in ('omc', 'coef', 'sv', 'lam_den',
                                     'lam_c')),
                ('mag', ctypes.c_double * 2 * _WM_FACES),
                ('rs', ctypes.c_double * 3 * 2 * _WM_FACES),
                ('rc', ctypes.c_double * 3 * 2 * _WM_FACES),
                *((q, ctypes.c_double) for q in
                  ('h', 'visc', 'ufloor', 'ikap', 'blog', 'lhv', 'eps')),
                ('xw', ctypes.c_int),
                ('xidx', ctypes.c_int * 3 * 2 * _WM_FACES),
                ('xs', ctypes.c_double * 3 * 2 * _WM_FACES)]


def _wm_recipe(fill):
    """A sampled row's padded rows 0, n and n+1 along its fill's axis as
    (index, s, c): s q[index] + c, index < 0 from the end (wallmodel
    pad_row, boundary._set_centered / _set_face); c is linear in the
    values, which may be arrays (an x face's values along a row)."""
    letters, (b0, b1), (d0, d1), stag = fill
    if letters == 'PP':
        return ((-1, 1.0, 0.0), (-1, 1.0, 0.0), (0, 1.0, 0.0))
    if letters[0] == 'D':
        lo = (0, 0.0, b0) if stag else (0, -1.0, 2.0 * b0)
    else:
        lo = (0, 1.0, -d0 * b0)
    if not stag:
        top = (-1, 1.0, 0.0)
        hi = (-1, -1.0, 2.0 * b1) if letters[1] == 'D' else (-1, 1.0,
                                                              d1 * b1)
    elif letters[1] == 'D':
        top, hi = (-2, 0.0, b1), (-2, 1.0, 0.0)
    else:
        top, hi = (-2, 1.0, d1 * b1), (-1, 1.0, 0.0)
    return lo, top, hi


def _wm_xrows(face, q, ny, ghosts=False):
    """Face's x recipe of component q at its two sampled rows: the
    (index, s) of padded columns 0, nx, nx+1 and their offsets c as a
    (2 rows, 3, ny) float64 array (an x face's plane-valued value at the
    rows' interior y entries), or with ghosts (2 rows, 3, ny + 2), its
    entries at the padded rows 0 .. ny+1 (a slab's, whose rows -1 and ny
    are the neighbours')."""
    n = ny + 2 if ghosts else ny
    rows = []
    for letters, vals, dr, stag in (xf[q] for xf in face.xfills):
        vr = tuple(np.asarray(b if ghosts else b[1:ny + 1])
                   if isinstance(b, tuple) else b for b in vals)
        rows.append(_wm_recipe((letters, vr, dr, stag)))
    c = np.stack([np.stack([np.broadcast_to(np.asarray(t[2], np.float64),
                                            (n,)) for t in rec])
                  for rec in rows])
    return [(t[0], t[1]) for t in rows[0]], c


@functools.cache
def _wm_args(wm, dtype, device, nz, ny, ghosts=False):
    """The static arguments of wm (a wallmodel.WallModel, its own key) for
    fields of dtype on device with nz planes of ny rows: checked and built
    once, so a call passes only its pointers, its mode and dtrk dxi, dtrk
    dyi.  With x walls also the x recipes' offsets on the device (faces, 2
    components, 2 rows, 3 columns, ny, or with ghosts ny + 2: a slab's,
    its halo rows' too), else None."""
    args = _make_wm_args(wm, dtype, nz, ny)
    if wm.faces[0].xfills is None:
        return args, None
    return args, torch.tensor(
        np.stack([np.stack([_wm_xrows(f, q, ny, ghosts)[1]
                            for q in range(2)]) for f in wm.faces]),
        dtype=dtype, device=device)


def _make_wm_args(wm, dtype, nz, ny):
    faces = tuple(wm.faces)
    if not 1 <= len(faces) <= _WM_FACES:
        raise ValueError(f'wm_planes: {len(faces)} faces (one to '
                         f'{_WM_FACES})')
    for f in faces:
        n = {1: ny, 2: nz}.get(f.d)
        if n is None:
            raise ValueError(f'wm_planes: a face of normal {f.d}')
        if not (0 <= f.r1 < n and 0 <= f.r2 < n):
            raise ValueError(f'wm_planes: rows {f.r1}, {f.r2} outside '
                             f'0 .. {n - 1}')
        if f.mtype not in (wmod.WM_LOG, wmod.WM_LAM):
            raise ValueError(f'wm_planes: wall model type {f.mtype}')
        if (nz if f.d == 1 else ny) < 2:
            raise ValueError('wm_planes: sampled rows of fewer than 2 '
                             'cells along their fill')
        if (f.xfills is None) != (faces[0].xfills is None) or (
                f.xfills is not None and f.d != 2):
            raise ValueError('wm_planes: x walls take z faces only')
    a = _WmArgs(nf=len(faces), h=wm.h, visc=wm.visc,
                ufloor=wm.visc / wm.h * wmod.LOG_FLOOR,
                ikap=1.0 / wmod.KAP_LOG, blog=wmod.B_LOG,
                lhv=math.log(wm.h / wm.visc), eps=torch.finfo(dtype).eps)
    for n, f in enumerate(faces):
        dl = 0.5 * f.l1d
        a.d[n], a.mtype[n], a.r1[n], a.r2[n] = f.d, f.mtype, f.r1, f.r2
        a.omc[n], a.coef[n] = 1.0 - f.coef, f.coef
        a.sv[n] = f.sgn * (1.0 / wm.visc)
        a.lam_den[n] = wm.h / dl * (2.0 - wm.h / dl)
        a.lam_c[n] = 2.0 / dl
        for q in range(2):
            a.mag[n][q] = f.mags[q]
            for pos, (idx, rs, rc) in enumerate(_wm_recipe(f.fills[q])):
                a.ridx[n][q][pos], a.rs[n][q][pos], a.rc[n][q][pos] = (
                    idx, rs, rc)
            if f.xfills is not None:
                a.xw = 1
                for pos, (idx, xs) in enumerate(_wm_xrows(f, q, ny)[0]):
                    a.xidx[n][q][pos], a.xs[n][q][pos] = idx, xs
    return a


@functools.cache
def _wm_weights(wei, dtype, device):
    """A y face's (2, nz+2) weights [1 - wei, wei] on the device."""
    w = torch.tensor(wei, dtype=torch.float64)
    return torch.stack([1 - w, w]).to(dtype=dtype, device=device)


def wm_planes(u, v, wm, fuv=None, pp=None, dtrk=0.0, dxi=0.0, dyi=0.0,
              w=None, yh=None, yown=None):
    """The wall model's Neumann planes of every wall-modelled face (wm:
    wallmodel.WallModel, one to four y and z faces) in one launch: one
    (2, n+2, nx+2) tensor a face, [bcu, bcv] on a z face (n = ny), [bcu,
    bcw] on a y face (n = nz), from the interior u, v and (with y faces)
    w, their rows sampled as they are or, on z faces with periodic x and
    y, corrected by pp and the deferred forcing fuv = (fu, fv) (both
    given; see wallmodel.wm_planes_plain).  With x walls (z faces) the
    rows take their x ghosts from the x faces' values.  yh: a slab of the
    y-slab mesh (z faces, periodic y, the rows as they are), the (4 z
    faces, 2, nx) halo rows -1 and nyl of wallmodel.sampled_rows, which
    the rows take along y in place of the wrap (the kernel's slab variant;
    with x walls its XW x YH mode, the halo rows' x ghosts by the x
    recipes at the offsets of those rows, which the slab's wall model
    carries); with yown = (lower, upper) a slab of a y-walled mesh
    (wallmodel.slab_wall_model: its z faces, then the y faces it owns on
    its own rows), the z faces' rows take the y recipe on the sides the
    slab owns and the halo rows elsewhere (the kernel's y-walled slab
    variant, two run-time flags)."""
    if _on_cpu(u):
        return wm_planes_plain(u, v, wm, fuv=fuv, pp=pp, dtrk=dtrk, dxi=dxi,
                               dyi=dyi, w=w, yh=yh, yown=yown)
    wmod._check_mode(wm, w, fuv, pp, yh, yown)
    _check('wallmodel', u, (u, v, w, pp),
           profiles=() if fuv is None else ((fuv, 2),))
    nz, ny, nx = u.shape
    nzf = sum(f.d == 2 for f in wm.faces)
    if yh is not None and (
            tuple(yh.shape) != (4 * nzf, 2, nx)
            or yh.device != u.device or yh.dtype != u.dtype
            or not yh.is_contiguous()):
        raise ValueError(f'wm_planes: halo rows contiguous '
                         f'{(4 * nzf, 2, nx)} {u.dtype} on '
                         f'{u.device}, got {tuple(yh.shape)} {yh.dtype} on '
                         f'{yh.device}')
    if u.numel() >= 2 ** 31:
        raise ValueError(f'wm_planes: {u.numel()} values a field (the '
                         'kernel indexes within a row in 32 bits)')
    args, xc = _wm_args(wm, u.dtype, u.device, nz, ny, yh is not None)
    sizes = [2 * ((nz if f.d == 1 else ny) + 2) * (nx + 2) for f in wm.faces]
    out = u.new_empty(sum(sizes))
    wz = (None if wm.wei is None
          else _wm_weights(wm.wei, u.dtype, u.device))
    if wz is not None and wz.shape[1] != nz + 2:
        raise ValueError(f'wm_planes: weights for nz = {wz.shape[1] - 2}, '
                         f'fields of nz = {nz}')
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    # the slab's y walls: -1 off a y-walled mesh (the periodic slab
    # variant's halo on both sides)
    ylo, yhi = (-1, -1) if yown is None else (int(bool(q)) for q in yown)
    _launch('wallmodel', f'cales_wallmodel_{_suffix(u)}', u.data_ptr(),
            v.data_ptr(), ptr(w), ptr(pp), ptr(fuv), ptr(wz), ptr(xc),
            ptr(yh), out.data_ptr(),
            nz, ny, nx, int(pp is not None), float(dtrk * dxi),
            float(dtrk * dyi), ctypes.addressof(args), ylo, yhi)
    return tuple(q.view(2, -1, nx + 2) for q in torch.split(out, sizes))
