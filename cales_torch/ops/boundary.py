"""Ghost-cell layer, periodic/Dirichlet/Neumann subset.

Counterpart of cales_tpu/ops/boundary.py (set_bc semantics of the
reference's bound.f90:202-399): fields are stored interior-only with shape
(nz, ny, nx); a padded (nz+2, ny+2, nx+2) view is assembled with one
``torch.cat`` per axis, axes in x, y, z order so each ghost plane spans the
earlier axes' ghosts (the corner semantics of the sequential halo sweep).

Kernel input contract (kept from the JAX package): interior arrays plus
(3, ny, nx) z-edge stacks [padded row 0, padded row nz, padded row nz+1].
Padded row nz carries the wall-face rewrite of the z-staggered component
(w), so a kernel never reads the interior's last z row directly.

With y walls (the duct and cavity classes) each field also has a y-row
stack (nz, 3, nx) [padded y 0, padded y ny, padded y ny+1], in the z-edge
stack's order along y: padded y ny carries the set_bc rewrite of the
y-staggered component (v) and is the interior's last y row for the
others.  Its z-edge stack (3, 3, nx), the corners, holds the values the
reference's sequential x->y->z fill puts at (z ghost, y ghost): the z
recipe applied to the y rows (yedge_velocity, yedge_scalar).  The JAX
package's stacks hold the same rows in the order [0, ny+1, ny], packed
into 16-row bundles for the TPU's DMA alignment; the port keeps one stack
per field.

With x walls each field has an x stack in the same way (xedge_velocity,
xedge_scalar): columns (nz, 3, nyc) [padded x 0, padded x nx, padded x
nx+1], padded x nx being u's set_bc rewrite slot, and their corners
(3, 3, nyc); with y walls the columns carry their y ghosts (nyc = ny + 2),
the (y ghost, x ghost) corners of the sequential fill.  Each is built by
three gathers and fused multiply-adds of a recipe made once per field and
fill; a plane-valued value on an x face (an inflow profile) or a z face
(a moving lid, the wall model's Neumann planes) adds its share of the
offsets at run time, with periodic y.

On a slab of a y-walled mesh (dims = (gy, 1)) the stacks are the slab's
(slab_ystack): the wall recipe's rows, built on the slab from its own
rows 0 and nyl-1 with no communication, on a side the slab owns (rank 0
the lower wall, rank gy-1 the upper), the neighbours' halo rows elsewhere,
so the y-walled kernels run on every slab as they do on the whole field.
With x walls as well each slab builds its x stacks with the wall recipe's
y ghosts and v's rewrite row on the sides it owns only (xedge_* with
yown), and takes its rows -1 and nyl elsewhere from the neighbours'
stacks (timeloop._xstacks_on_slab).


BC values are python floats or padded 2-D planes (x-faces (nz+2, ny+2),
y-faces (nz+2, nx+2), z-faces (ny+2, nx+2)).
"""
from __future__ import annotations

import functools

import torch

AX = {'x': 2, 'y': 1, 'z': 0}  # logical direction -> array axis of (z, y, x)


def bc_plane_shapes(ng):
    nx, ny, nz = ng
    return {'x': (nz + 2, ny + 2), 'y': (nz + 2, nx + 2), 'z': (ny + 2, nx + 2)}


def make_bc_values(ng, vals, dtype, device=None):
    """Per-face BC values from namelist scalars (initbc, bound.f90:764-795).
    Scalars stay python floats; a 2-D entry is a plane-valued BC kept as a
    padded tensor on `device`."""
    shapes = bc_plane_shapes(ng)
    axes = ('x', 'y', 'z')
    out = []
    for idir in range(3):
        pair = []
        for ib in range(2):
            v = vals[idir][ib]
            if getattr(v, 'ndim', 0) == 2:
                want = shapes[axes[idir]]
                if tuple(v.shape) != want:
                    raise ValueError(
                        f'plane-valued BC for direction {axes[idir]} must '
                        f'have padded shape {want}, got {tuple(v.shape)}')
                pair.append(torch.as_tensor(v, dtype=dtype, device=device))
            else:
                pair.append(float(v))
        out.append(tuple(pair))
    return tuple(out)


def _fi(axis, i):
    idx = [slice(None)] * 3
    idx[axis] = i
    return tuple(idx)


def _ex(plane, axis):
    return plane.unsqueeze(axis)


def crop_plane(plane, q_shape, axis):
    """Crop a full padded-transverse plane to the ghost-plane shape of a
    (possibly partially padded) array (axes are attached x, y, z)."""
    dims = [d for d in range(3) if d != axis]
    sl = []
    for d_plane, d_arr in enumerate(dims):
        cur, full = q_shape[d_arr], plane.shape[d_plane]
        if cur == full:
            sl.append(slice(None))
        elif cur == full - 2:
            sl.append(slice(1, -1))
        else:
            raise ValueError(f'BC plane shape {tuple(plane.shape)} vs field '
                             f'{tuple(q_shape)}')
    return plane[tuple(sl)]


def _bc_plane(val, like, axis):
    """Broadcast or crop a scalar/2-D BC value to the ghost-plane shape of
    `like`."""
    if getattr(val, 'ndim', 0) == 2:
        return crop_plane(val, like.shape, axis).to(like.dtype)
    shape = list(like.shape)
    del shape[axis]
    return torch.full(shape, float(val), dtype=like.dtype, device=like.device)


def _set_centered(q, axis, letters, bcvals, dr):
    """Both ghost faces along `axis` of a cell-centered variable (set_bc
    centered=.true., bound.f90:232-352)."""
    first = q[_fi(axis, 0)]
    last = q[_fi(axis, -1)]
    if letters[0] == 'P':
        lo, hi = last, first
    else:
        b0 = _bc_plane(bcvals[0], q, axis)
        b1 = _bc_plane(bcvals[1], q, axis)
        lo = 2.0 * b0 - first if letters[0] == 'D' else -dr[0] * b0 + first
        hi = 2.0 * b1 - last if letters[1] == 'D' else dr[1] * b1 + last
    return torch.cat([_ex(lo, axis), q, _ex(hi, axis)], dim=axis)


def _set_face(q, axis, letters, bcvals, dr, lo_keep=None, keep=False):
    """Ghost faces plus the wall-face rewrite along `axis` for the
    face-staggered normal component (set_bc centered=.false.,
    bound.f90:283-318 'D', 354-396 'N').  keep=True (the corrector fill,
    impose_norm_bc=.false.): the lower wall face comes from `lo_keep` and
    the interior wall-face entry keeps its corrected value."""
    first = q[_fi(axis, 0)]
    second_last = q[_fi(axis, -2)]
    last = q[_fi(axis, -1)]
    if letters[0] == 'P':
        return torch.cat([_ex(last, axis), q, _ex(first, axis)], dim=axis)
    if keep:
        hi = second_last if letters[1] == 'D' else last
        lo = crop_plane(lo_keep, q.shape, axis).to(q.dtype)
        return torch.cat([_ex(lo, axis), q, _ex(hi, axis)], dim=axis)
    b0 = _bc_plane(bcvals[0], q, axis)
    b1 = _bc_plane(bcvals[1], q, axis)
    lo = b0 if letters[0] == 'D' else -dr[0] * b0 + first
    trunk = q.narrow(axis, 0, q.shape[axis] - 1)
    if letters[1] == 'D':
        # u(n) = bc; u(n+1) = u(n-1) (unused)   bound.f90:292-293
        newlast, hi = b1, second_last
    else:
        # u(n+1) = old u(n) (unused); u(n) = dr*bc + u(n-1)  bound.f90:365-366
        newlast, hi = dr[1] * b1 + second_last, last
    return torch.cat([_ex(lo, axis), trunk, _ex(newlast, axis),
                      _ex(hi, axis)], dim=axis)


def pad_scalar(p, cbc, bcvals, dl, dzc):
    """Ghost fill for a cell-centered scalar (boundp, bound.f90:156-200)."""
    nz = p.shape[0]
    q = p
    drs = {'x': (dl[0], dl[0]), 'y': (dl[1], dl[1]),
           'z': (float(dzc[0]), float(dzc[nz]))}
    for key, idir in (('x', 0), ('y', 1), ('z', 2)):
        q = _set_centered(q, AX[key], cbc[idir], bcvals[idir], drs[key])
    return q


def _zedge_centered(q, letters, bcvals, dr):
    """(3, ny, nx) z-edge stack [ghost_lo, padded-row-nz, ghost_hi] of a
    z-centered variable; padded row nz is the interior last row."""
    first, last = q[0], q[-1]
    if letters[0] == 'P':
        lo, hi = last, first
    else:
        b0 = _bc_plane(bcvals[0], q, 0)
        b1 = _bc_plane(bcvals[1], q, 0)
        lo = 2.0 * b0 - first if letters[0] == 'D' else -dr[0] * b0 + first
        hi = 2.0 * b1 - last if letters[1] == 'D' else dr[1] * b1 + last
    return torch.stack([lo, last, hi])


def _zedge_face(q, letters, bcvals, dr, lo_keep=None, keep=False):
    """z-edge stack of the z-face-staggered component (w): padded row nz is
    the (possibly rewritten) wall face, so it travels in the stack instead
    of mutating the interior array."""
    first, second_last, last = q[0], q[-2], q[-1]
    if letters[0] == 'P':
        return torch.stack([last, last, first])
    if keep:
        hi = second_last if letters[1] == 'D' else last
        lo = crop_plane(lo_keep, q.shape, 0).to(q.dtype)
        return torch.stack([lo, last, hi])
    b0 = _bc_plane(bcvals[0], q, 0)
    b1 = _bc_plane(bcvals[1], q, 0)
    lo = b0 if letters[0] == 'D' else -dr[0] * b0 + first
    if letters[1] == 'D':
        newlast, hi = b1, second_last
    else:
        newlast, hi = dr[1] * b1 + second_last, last
    return torch.stack([lo, newlast, hi])


def zedge_scalar(p, cbc_z, bcvals_z, dzc):
    """(3, ny, nx) z-edge stack of a cell-centered scalar."""
    nz = p.shape[0]
    dr = (float(dzc[0]), float(dzc[nz]))
    return _zedge_centered(p, cbc_z, bcvals_z, dr)


def zedge_velocity(u, v, w, cbcvel, bcu, bcv, bcw, dzc, dzf,
                   vlo=None, is_correc=False):
    """z-edge stacks (3, ny, nx) of (u, v, w) with pad_velocity's z
    semantics: rows [padded row 0, padded row nz (w: the wall-face
    rewrite), padded row nz+1]."""
    nz = u.shape[0]
    dr_par = (float(dzc[0]), float(dzc[nz]))
    dr_nrm = (float(dzf[0]), float(dzf[nz]))

    def lts(ivel):
        return (cbcvel[0][2][ivel], cbcvel[1][2][ivel])
    ue = _zedge_centered(u, lts(0), bcu[2], dr_par)
    ve = _zedge_centered(v, lts(1), bcv[2], dr_par)
    lw = lts(2)
    keep = is_correc and lw[0] != 'P' and vlo is not None
    we = _zedge_face(w, lw, bcw[2], dr_nrm,
                     lo_keep=vlo[2] if keep else None, keep=keep)
    return ue, ve, we


def _bc_row(val, like):
    """BC value as an interior (nz, nx) y-face row of `like` (nz, ny, nx):
    a scalar broadcast, a padded (nz+2, nx+2) plane cropped."""
    if getattr(val, 'ndim', 0) == 2:
        return val[1:-1, 1:-1].to(like.dtype)
    return torch.full((like.shape[0], like.shape[2]), float(val),
                      dtype=like.dtype, device=like.device)


def _yrows_centered(q, letters, bcvals, dr):
    """(nz, 3, nx) y-row stack [padded y 0, padded y ny, padded y ny+1] of
    a y-centred field (set_bc along y, bound.f90:232-352); padded y ny is
    the interior last row."""
    first, last = q[:, 0], q[:, -1]
    if letters[0] == 'P':
        lo, hi = last, first
    else:
        b0, b1 = _bc_row(bcvals[0], q), _bc_row(bcvals[1], q)
        lo = 2.0 * b0 - first if letters[0] == 'D' else -dr[0] * b0 + first
        hi = 2.0 * b1 - last if letters[1] == 'D' else dr[1] * b1 + last
    return torch.stack([lo, last, hi], dim=1)


def _yrows_face(q, letters, bcvals, dr, lo_keep=None, keep=False):
    """y-row stack of the y-face-staggered component (v): padded y ny is
    the set_bc rewrite slot (bound.f90:292-293 'D', 365-366 'N'); keep=True
    (the corrector fill) takes the lower wall face from the padded plane
    `lo_keep` and leaves the interior wall face as it is."""
    first, second_last, last = q[:, 0], q[:, -2], q[:, -1]
    if letters[0] == 'P':
        return torch.stack([last, last, first], dim=1)
    if keep:
        hi = second_last if letters[1] == 'D' else last
        lo = lo_keep[1:-1, 1:-1].to(q.dtype)
        return torch.stack([lo, last, hi], dim=1)
    b0, b1 = _bc_row(bcvals[0], q), _bc_row(bcvals[1], q)
    lo = b0 if letters[0] == 'D' else -dr[0] * b0 + first
    if letters[1] == 'D':
        newlast, hi = b1, second_last
    else:
        newlast, hi = dr[1] * b1 + second_last, last
    return torch.stack([lo, newlast, hi], dim=1)


def _corner_rows(val, like):
    """z-direction BC value at the y-row stack's rows: a scalar as it is,
    a padded (ny+2, nx+2) plane as its (3, nx) rows [0, ny, ny+1]."""
    if getattr(val, 'ndim', 0) == 2:
        return torch.stack([val[0], val[-2], val[-1]])[:, 1:-1].to(like.dtype)
    return val


def _zedge_of_yrows(rows, letters, bcvals, dr, face=False, vlo_plane=None,
                    keep=False):
    """(3, 3, nx) z-edge stack of a (nz, 3, nx) y-row stack: the z recipe
    of _zedge_centered / _zedge_face applied to the y rows, which is what
    the sequential x->y->z fill leaves in the (z ghost, y ghost) corners.
    keep (w under the corrector fill): the lower face is the padded plane
    vlo_plane's y-ghost rows."""
    first, second_last, last = rows[0], rows[-2], rows[-1]
    b0 = _corner_rows(bcvals[0], rows)
    b1 = _corner_rows(bcvals[1], rows)
    if not face:
        if letters[0] == 'P':
            lo, hi = last, first
        else:
            lo = 2.0 * b0 - first if letters[0] == 'D' else -dr[0] * b0 + first
            hi = 2.0 * b1 - last if letters[1] == 'D' else dr[1] * b1 + last
        return torch.stack([lo, last, hi])
    if letters[0] == 'P':
        return torch.stack([last, last, first])
    if keep:
        lo = torch.stack([vlo_plane[0, 1:-1], vlo_plane[-2, 1:-1],
                          vlo_plane[-1, 1:-1]]).to(rows.dtype)
        hi = second_last if letters[1] == 'D' else last
        return torch.stack([lo, last, hi])
    full = lambda b: torch.broadcast_to(  # noqa: E731
        torch.as_tensor(b, dtype=rows.dtype, device=rows.device), first.shape)
    lo = full(b0) if letters[0] == 'D' else -dr[0] * b0 + first
    if letters[1] == 'D':
        newlast, hi = full(b1), second_last
    else:
        newlast, hi = dr[1] * b1 + second_last, last
    return torch.stack([lo, newlast, hi])


def yedge_velocity(u, v, w, cbcvel, bcu, bcv, bcw, dl, dzc, dzf,
                   vlo=None, is_correc=False):
    """y-row stacks (nz, 3, nx) of (u, v, w) and their corner stacks
    (3, 3, nx), with pad_velocity's y and z semantics.  Returns
    ((yu, yv, yw), (zyu, zyv, zyw))."""
    nz = u.shape[0]
    dr_y = (dl[1], dl[1])
    dr_z_par = (float(dzc[0]), float(dzc[nz]))
    dr_z_nrm = (float(dzf[0]), float(dzf[nz]))

    def ylts(ivel):
        return (cbcvel[0][1][ivel], cbcvel[1][1][ivel])

    def zlts(ivel):
        return (cbcvel[0][2][ivel], cbcvel[1][2][ivel])
    keep_v = is_correc and ylts(1)[0] != 'P' and vlo is not None
    yu = _yrows_centered(u, ylts(0), bcu[1], dr_y)
    yv = _yrows_face(v, ylts(1), bcv[1], dr_y,
                     lo_keep=vlo[1] if keep_v else None, keep=keep_v)
    yw = _yrows_centered(w, ylts(2), bcw[1], dr_y)
    keep_w = is_correc and zlts(2)[0] != 'P' and vlo is not None
    zyu = _zedge_of_yrows(yu, zlts(0), bcu[2], dr_z_par)
    zyv = _zedge_of_yrows(yv, zlts(1), bcv[2], dr_z_par)
    zyw = _zedge_of_yrows(yw, zlts(2), bcw[2], dr_z_nrm, face=True,
                          vlo_plane=vlo[2] if keep_w else None, keep=keep_w)
    return (yu, yv, yw), (zyu, zyv, zyw)


def slab_ystack(q, e, wall, halo, own):
    """The y-row stack pair (rows (nz, 3, nx), corners (3, 3, nx)) of a
    slab of a y-walled field on the y-slab mesh: [row -1, row nyl-1, row
    nyl] and their z-edge entries.  own = (lower, upper), the walls the
    slab holds: there the rows are the wall recipe's, `wall` the stack pair
    of the slab's own fill (yedge_velocity or yedge_scalar on the slab;
    None on a slab that owns neither); elsewhere rows -1 and nyl are the
    neighbours' from `halo` (rows (nz, 2 d, nx), corners (3, 2 d, nx) from
    mesh.halo_y at depth d) and row nyl-1 the slab's own last row and its
    entry of the z-edge stack e: the y-walled kernels read the y-walled
    accessor's rows from one stack on every slab."""
    rows, corners = halo
    d = rows.shape[1] // 2
    mine = (q[:, -1], e[:, -1])
    ends = ((wall[0][:, 0], wall[1][:, 0]) if own[0]
            else (rows[:, d - 1], corners[:, d - 1]),
            (wall[0][:, 1], wall[1][:, 1]) if own[1] else mine,
            (wall[0][:, 2], wall[1][:, 2]) if own[1]
            else (rows[:, d], corners[:, d]))
    return (torch.stack([r for r, _ in ends], dim=1),
            torch.stack([c for _, c in ends], dim=1))


def yedge_scalar(p, cbc, bcvals, dl, dzc):
    """y-row stack and its corner stack of a cell-centred scalar (boundp's
    y and z semantics)."""
    nz = p.shape[0]
    yp = _yrows_centered(p, cbc[1], bcvals[1], (dl[1], dl[1]))
    return yp, _zedge_of_yrows(yp, cbc[2], bcvals[2],
                               (float(dzc[0]), float(dzc[nz])))


def _axis_recipe(letters, bvals, dr, n, face, keep):
    """One axis of the x stacks' fill as (index, scale, offset) triples:
    entry m of the three [ghost lo, padded n (the interior's last, or the
    face-staggered field's set_bc rewrite slot), ghost hi] is
    scale * q[index] + offset (set_bc, bound.f90:232-399, scalar values).
    keep: the corrector fill's lower face, 0 here, which the caller
    overwrites with the kept plane.  The offsets are linear in the values
    (b0, b1)."""
    (lo, hi), (b0, b1), (d0, d1) = letters, bvals, dr
    if lo == 'P':
        return ((n - 1, 1.0, 0.0), (n - 1, 1.0, 0.0), (0, 1.0, 0.0))
    if not face:
        return ((0, -1.0, 2.0 * b0) if lo == 'D' else (0, 1.0, -d0 * b0),
                (n - 1, 1.0, 0.0),
                (n - 1, -1.0, 2.0 * b1) if hi == 'D' else (n - 1, 1.0, d1 * b1))
    hi_ = (n - 2, 1.0, 0.0) if hi == 'D' else (n - 1, 1.0, 0.0)
    if keep:
        return ((0, 0.0, 0.0), (n - 1, 1.0, 0.0), hi_)
    return ((0, 0.0, b0) if lo == 'D' else (0, 1.0, -d0 * b0),
            (n - 1, 0.0, b1) if hi == 'D' else (n - 2, 1.0, d1 * b1), hi_)


@functools.lru_cache(maxsize=256)
def _recipe(lts, bvals, drs, face, keep, ywalls, yown, shape, dtype,
            device):
    """The (index, scale, offset) tensors of _xstack's three passes on
    `device`, built once for each field and fill (bvals: the scalar BC
    values, a plane-valued one as 0.0): along x and z the three entries of
    _axis_recipe; along y (with y walls) the whole padded row range [lo, 0
    .. ny-1, hi], the face-staggered v's row ny-1 its rewrite slot, where
    on a slab of the y-slab mesh a side it does not own (yown = (lower,
    upper)) takes its own first or last row in place of the wall recipe's
    ghost (and v's last row its own), which the caller replaces by the
    neighbour's.  With them, along x and z, the factors (3,) of each
    side's value in the three offsets, which a plane-valued side adds at
    run time.  Every caller shares the tensors, which nothing writes."""
    nz, ny, nx = shape

    def tensors(triples):
        idx, sc, off = zip(*triples)
        return (torch.tensor(idx, device=device),
                torch.tensor(sc, dtype=dtype, device=device),
                torch.tensor(off, dtype=dtype, device=device))

    def factors(d, n):
        # the offsets of unit values on one side and none on the other
        return tuple(torch.tensor(
            [t[2] for t in _axis_recipe(lts[d], unit, drs[d], n, face == d,
                                        keep[d])], dtype=dtype, device=device)
            for unit in ((1.0, 0.0), (0.0, 1.0)))
    xr = tensors(_axis_recipe(lts[0], bvals[0], drs[0], nx, face == 0,
                              keep[0]))
    yr = None
    if ywalls:
        lo, mid, hi = _axis_recipe(lts[1], bvals[1], drs[1], ny, face == 1,
                                   keep[1])
        if not yown[0]:
            lo = (0, 1.0, 0.0)
        if not yown[1]:
            mid = hi = (ny - 1, 1.0, 0.0)
        inner = [(j, 1.0, 0.0) for j in range(ny - (face == 1))]
        yr = tensors([lo, *inner, *([mid] if face == 1 else []), hi])
    zr = tensors(_axis_recipe(lts[2], bvals[2], drs[2], nz, face == 2,
                              keep[2]))
    return xr, yr, zr, (factors(0, nx), factors(2, nz))


def _fma(q, dim, rec):
    """scale * q[index] + offset along dim, the recipe's entries laid
    along dim."""
    idx, sc, off = rec
    shape = [1, 1, 1]
    shape[dim] = -1
    return torch.addcmul(off.view(shape), q.index_select(dim, idx),
                         sc.view(shape))


def _is_plane(b):
    return getattr(b, 'ndim', 0) == 2


def _xstack(q, lts, bcs, drs, face, vlo=None, keep=(False, False, False),
            ywalls=False, yown=None):
    """x-ghost columns of one field and their corners, as the sequential
    x -> y -> z fill leaves them: the x recipe on q, with y walls the y
    recipe on the columns (their y ghosts and the y rewrite slot: the
    columns of the (y ghost, x ghost) corners), then the z recipe on the
    result; each pass one gather and one fused multiply-add of a recipe
    built once (_recipe).  lts, bcs, drs: the (lo, hi) letters, values and
    spacings per direction; face: the direction along which q is
    staggered (0, 1, 2, or None); keep[d]: the corrector fill's kept lower
    face along d, from the padded plane vlo[d].  A value may be a padded
    plane on the x faces ((nz+2, ny+2): an inflow profile, its interior
    (z, y) entries) and on the z faces ((ny+2, nx+2): a moving lid, the
    wall model's Neumann planes, their columns 0, nx and nx+1 at the
    interior y rows, as cales_tpu's boundary._corner_cols takes them), with
    periodic y: its contribution to the offsets is added at run time.
    yown: with y walls on a slab of the y-slab mesh, the walls it holds
    (lower, upper); the stack's rows -1 and nyl on the other sides are its
    own rows 0 and nyl-1, for the caller to replace by the neighbours'
    (timeloop._xstacks_on_slab), and v's row nyl-1 is its own."""
    nz, ny, nx = q.shape
    planes = {(d, ib): b for d, pair in enumerate(bcs)
              for ib, b in enumerate(pair) if _is_plane(b)}
    if any(d == 1 or ywalls for d, _ in planes):
        raise ValueError('x stacks take plane-valued values on the x and z '
                         'faces, with periodic y')
    key = tuple(tuple(0.0 if _is_plane(b) else float(b) for b in pair)
                for pair in bcs)
    xr, yr, zr, (xfac, zfac) = _recipe(
        tuple(tuple(x) for x in lts), key,
        tuple(tuple(map(float, d)) for d in drs), face, tuple(keep), ywalls,
        (True, True) if yown is None else tuple(map(bool, yown)),
        (nz, ny, nx), q.dtype, q.device)
    def xcolumns(plane):
        # the stack's columns [0, nx, nx+1] of a padded plane, by slices
        # (a list index would be a host-to-device copy, which waits for
        # the stream)
        return torch.cat([plane[..., :1], plane[..., nx:nx + 2]], dim=-1)
    cols = _fma(q.transpose(1, 2), 1, xr)
    for ib in range(2):
        if (0, ib) in planes:
            # the profile's interior entries (nz, ny) into the three columns
            b = planes[(0, ib)][1:-1, 1:-1].to(q.dtype)
            cols = torch.addcmul(cols, xfac[ib].view(1, 3, 1), b[:, None])
    if keep[0]:
        cols[:, 0] = vlo[0][1:-1, 1:-1]
    if ywalls:
        cols = _fma(cols, 2, yr)
        if keep[1]:
            cols[:, :, 0] = xcolumns(vlo[1][1:-1])
    corners = _fma(cols, 0, zr)
    for ib in range(2):
        if (2, ib) in planes:
            # the plane's columns [0, nx, nx+1] (3, ny) into the three rows
            b = xcolumns(planes[(2, ib)][1:-1]).T.to(q.dtype)
            corners = torch.addcmul(corners, zfac[ib].view(3, 1, 1), b[None])
    if keep[2]:
        lo = xcolumns(vlo[2]).T
        corners[0] = lo if ywalls else lo[:, 1:-1]
    return cols, corners


def xedge_velocity(u, v, w, cbcvel, bcu, bcv, bcw, dl, dzc, dzf,
                   vlo=None, is_correc=False, ywalls=False,
                   fields=(0, 1, 2), yown=None):
    """x-ghost column stacks of (u, v, w) with pad_velocity's semantics, a
    (cols, corners) pair each: cols (nz, 3, nyc) [padded x 0, padded x nx
    (u's set_bc rewrite slot, the interior's last column for v and w),
    padded x nx+1], corners (3, 3, nyc) their z-edge stack, ordered as the
    fields' own.  nyc = ny with periodic y, which wraps; ny + 2 with y
    walls: the columns' y ghosts at index 0 and ny + 1 and the y rewrite
    slot at index ny, so the (y ghost, x ghost) corners of the sequential
    x -> y -> z fill (cales_tpu timeloop._xye_section) ride in the columns.
    The JAX package's stacks (ops/boundary.xedge_velocity) hold the same
    columns as (nz, ny, 3) in the order [0, nx+1, nx].  is_correc with
    vlo: the corrector fill's kept lower faces, u's x face, v's y face
    (with y walls) and w's z face (impose_norm_bc=.false.).  fields: the
    components to build (the others' pairs are None).  yown: a slab's y
    walls on the y-slab mesh (_xstack)."""
    nz = u.shape[0]
    drs = ((dl[0], dl[0]), (dl[1], dl[1]))
    dz = ((float(dzc[0]), float(dzc[nz])), (float(dzf[0]), float(dzf[nz])))
    out = []
    for iv, (q, bc) in enumerate(((u, bcu), (v, bcv), (w, bcw))):
        if iv not in fields:
            out.append(None)
            continue
        lts = tuple((cbcvel[0][d][iv], cbcvel[1][d][iv]) for d in range(3))
        keep = tuple(d == iv and is_correc and vlo is not None
                     and lts[d][0] != 'P' for d in range(3))
        out.append(_xstack(q, lts, bc, (*drs, dz[iv == 2]), iv, vlo=vlo,
                           keep=keep, ywalls=ywalls, yown=yown))
    return tuple(out)


def xedge_scalar(p, cbc, bcvals, dl, dzc, ywalls=False, yown=None):
    """x-ghost column stack and its corners of a cell-centred scalar
    (boundp's x, y and z semantics), in xedge_velocity's layout."""
    nz = p.shape[0]
    drs = ((dl[0], dl[0]), (dl[1], dl[1]), (float(dzc[0]), float(dzc[nz])))
    return _xstack(p, cbc, bcvals, drs, None, ywalls=ywalls, yown=yown)


@functools.lru_cache(maxsize=64)
def _centred_recipe(lts, bvals, dr, n, dtype, device):
    """_axis_recipe's three entries of a cell-centred field with scalar
    values, as (index, scale, offset) tensors on `device`, built once."""
    idx, sc, off = zip(*_axis_recipe(lts, bvals, dr, n, False, False))
    return (torch.tensor(idx, device=device),
            torch.tensor(sc, dtype=dtype, device=device),
            torch.tensor(off, dtype=dtype, device=device))


def _centred_fill(q, dim, lts, bvals, dr):
    rec = _centred_recipe(tuple(lts), tuple(map(float, bvals)),
                          tuple(map(float, dr)), q.shape[dim], q.dtype,
                          q.device)
    return _fma(q, dim, rec)


def zedge_scalar_fast(p, cbc_z, bcvals_z, dzc):
    """zedge_scalar for scalar values as one gather and one fused
    multiply-add of a recipe built once (a passive scalar's stack, made
    every substep)."""
    nz = p.shape[0]
    return _centred_fill(p, 0, cbc_z, bcvals_z,
                         (float(dzc[0]), float(dzc[nz])))


def yedge_scalar_fast(p, cbc, bcvals, dl, dzc):
    """yedge_scalar for scalar values: the y-row stack and its corners,
    each one gather and one fused multiply-add of a recipe built once."""
    nz = p.shape[0]
    rows = _centred_fill(p, 1, cbc[1], bcvals[1], (dl[1], dl[1]))
    return rows, _centred_fill(rows, 0, cbc[2], bcvals[2],
                               (float(dzc[0]), float(dzc[nz])))


def pad_velocity(u, v, w, cbcvel, bcu, bcv, bcw, dl, dzc, dzf,
                 vlo=None, is_correc=False):
    """Ghost fill of the staggered velocity (bounduvw, bound.f90:18-154).

    vlo: (u_lo, v_lo, w_lo) lower-wall normal-face planes from the state,
    consumed when is_correc.  Returns (up, vp, wp, vlo_new), vlo_new being
    the planes actually placed in the ghost layer."""
    nz = u.shape[0]
    dr_par = {'x': (dl[0], dl[0]), 'y': (dl[1], dl[1]),
              'z': (float(dzc[0]), float(dzc[nz]))}
    dr_nrm = {'x': (dl[0], dl[0]), 'y': (dl[1], dl[1]),
              'z': (float(dzf[0]), float(dzf[nz]))}
    fields = {'u': u, 'v': v, 'w': w}
    bcs = {'u': bcu, 'v': bcv, 'w': bcw}
    face_of = {'u': 'x', 'v': 'y', 'w': 'z'}
    vlo_in = {'u': None, 'v': None, 'w': None}
    if vlo is not None:
        vlo_in = {'u': vlo[0], 'v': vlo[1], 'w': vlo[2]}

    out = {}
    for name, ivel in (('u', 0), ('v', 1), ('w', 2)):
        q = fields[name]
        for key, idir in (('x', 0), ('y', 1), ('z', 2)):
            axis = AX[key]
            lts = (cbcvel[0][idir][ivel], cbcvel[1][idir][ivel])
            bv = bcs[name][idir]
            if key == face_of[name]:
                keep = is_correc and lts[0] != 'P' and vlo_in[name] is not None
                q = _set_face(q, axis, lts, bv, dr_nrm[key],
                              lo_keep=vlo_in[name] if keep else None,
                              keep=keep)
            else:
                q = _set_centered(q, axis, lts, bv, dr_par[key])
        out[name] = q

    vlo_new = (out['u'][:, :, 0], out['v'][:, 0, :], out['w'][0, :, :])
    return out['u'], out['v'], out['w'], vlo_new
