"""Wall models on the y and z faces: log-law (Newton on u_tau) and laminar.

Counterpart of cales_tpu/wallmodel.py (reference wmodel.f90), copied
because that module imports jax: per wall-modelled face, the wall-parallel
velocity is interpolated to the matching height ``hwm`` between the two
bracketing cell rows (wmodel.f90:171-272), made wall-relative, fed to the
log-law Newton iteration (288-326) or the laminar profile (327-333), and
tau_w/visc is the Neumann value of the parallel components on that face.
The Newton iteration runs a fixed N_NEWTON steps with no convergence test,
as the JAX package's does; the kernel lets a warp stop once all its lanes
have converged, and ``newton_steps`` / ``wm_newton_steps`` count the steps
that takes on given inputs.

``wm_planes_plain`` is the plain twin of the wall-model kernel
(ops/kernels.wm_planes, csrc/wallmodel.cu): every modelled face's padded
planes from its sampled rows (u and v at z rows, u and w at y rows), as
they are or, on z faces with periodic y, corrected by the pressure
correction pp and the deferred bulk forcing first.  With x walls (the
developing channel's z faces) a sampled z row takes its x ghosts and u's
rewrite slot from the x faces' values (an inflow profile's at that row)
before it wraps along y.  On a slab of the y-slab mesh a sampled z row
takes its rows -1 and nyl from the neighbours (``sampled_rows`` is what
a slab sends) where one device wraps y (with x walls those rows take
their x ghosts too, from the slab's rows of the x faces' values); with y
walls it takes the wall recipe's rows on the sides the slab owns and the
neighbours' elsewhere,
and a y face is modelled on the slab that owns it alone, from its own
rows (``slab_wall_model``).  The x-face branch of
``update_wallmodel_bcs`` is not ported yet (ROADMAP queue 1).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .config import KAP_LOG, B_LOG, effective_cbcvel
from .ops import boundary as bnd

WM_LOG = 1
WM_LAM = -1
N_NEWTON = 12
# the log law's lower bound on u_tau is visc / h times this
LOG_FLOOR = float(np.exp(-KAP_LOG * B_LOG))


def _newton_start(upar, h, visc):
    """The log law's first u_tau: the laminar estimate, floored."""
    return torch.clamp_min(torch.sqrt(upar / h * visc), visc / h * LOG_FLOOR)


def _newton_step(utau, upar, h, visc):
    """One Newton step on u_tau of the log law (wmodel.f90:288-326)."""
    f = upar / utau - (1.0 / KAP_LOG) * torch.log(h * utau / visc) - B_LOG
    fp = -(1.0 / utau) * (upar / utau + 1.0 / KAP_LOG)
    return torch.abs(utau - f / fp)


def wallmodel_tauw(mtype: int, uh, vh, h: float, l1d: float, visc: float):
    """tau_w components aligned with (uh, vh) (wmodel.f90:288-335)."""
    eps = torch.finfo(uh.dtype).eps
    upar = torch.sqrt(uh * uh + vh * vh)
    if mtype == WM_LOG:
        utau = _newton_start(upar, h, visc)
        for _ in range(N_NEWTON):
            utau = _newton_step(utau, upar, h, visc)
        tauw_tot = utau * utau
    elif mtype == WM_LAM:
        dl = 0.5 * l1d
        umax = upar / (h / dl * (2.0 - h / dl))
        tauw_tot = 2.0 / dl * umax * visc
    else:
        raise ValueError(f'unknown wall model type {mtype}')
    return tauw_tot * uh / (upar + eps), tauw_tot * vh / (upar + eps)


def newton_steps(upar, h: float, visc: float):
    """The Newton steps the log law needs at each |u_par| (an int32 tensor
    of upar's shape): the first step after which |du_tau| <= 4 eps u_tau,
    the wall-model kernel's exit test, on wallmodel_tauw's iteration;
    N_NEWTON where no step passes it.  The work of the kernel's loop on
    given inputs, which chip_smoke.py counts in its bound."""
    eps = torch.finfo(upar.dtype).eps
    utau = _newton_start(upar, h, visc)
    steps = torch.full(upar.shape, N_NEWTON, dtype=torch.int32,
                       device=upar.device)
    for it in range(N_NEWTON):
        new = _newton_step(utau, upar, h, visc)
        hit = ((new - utau).abs() <= 4.0 * eps * new) & (steps == N_NEWTON)
        steps = torch.where(hit, it + 1, steps)
        utau = new
    return steps


def _rel(v1, v2, coef, mag):
    return (1.0 - coef) * v1 + coef * v2 - mag


def find_index_wm(cfg, grid):
    """Interpolation index per wall-modelled face (initbc, bound.f90:812-865):
    the stored index is the cell *further* from the wall.  hwm outside the
    first..last cell-center band is rejected (sanity.f90:233-241 checks all
    wall-normal directions, not just z)."""
    nx, ny, nz = cfg.ng
    dl = cfg.dl
    h = cfg.hwm

    def err(d):
        raise ValueError(f'hwm={h} outside the first..last cell-center band '
                         f'in direction {d} (sanity.f90:233-241)')

    idx = [[0, 0], [0, 0], [0, 0]]
    for ib in range(2):
        if cfg.lwm[ib][0] != 0:
            if not 0.5 * dl[0] < h < (nx - 0.5) * dl[0]:
                err('x')
            i = 1 if ib == 0 else nx
            if ib == 0:
                while (i - 0.5) * dl[0] < h:
                    i += 1
            else:
                while (nx - i + 0.5) * dl[0] < h:
                    i -= 1
            idx[0][ib] = i
        if cfg.lwm[ib][1] != 0:
            idx[1][ib] = y_index_wm(cfg, ib)
        if cfg.lwm[ib][2] != 0:
            if not grid.zc[1] < h < grid.zc[nz]:
                err('z')
            k = 1 if ib == 0 else nz
            if ib == 0:
                while grid.zc[k] < h:
                    k += 1
            else:
                while cfg.l[2] - grid.zc[k] < h:
                    k -= 1
            idx[2][ib] = k
    return tuple(tuple(r) for r in idx)


def y_index_wm(cfg, ib):
    """find_index_wm's index of the y face ib (uniform y: no grid)."""
    ny, dl, h = cfg.ng[1], cfg.dl[1], cfg.hwm
    if not 0.5 * dl < h < (ny - 0.5) * dl:
        raise ValueError(f'hwm={h} outside the first..last cell-center band '
                         'in direction y (sanity.f90:233-241)')
    j = 1 if ib == 0 else ny
    if ib == 0:
        while (j - 0.5) * dl < h:
            j += 1
    else:
        while (ny - j + 0.5) * dl < h:
            j -= 1
    return j


class WallFace(NamedTuple):
    """One wall-modelled face: its normal d (1 a y face, 2 a z face), its
    side ib, the model type, the interior rows r1 (nearer the wall) and r2
    along d that bracket hwm (0-based: the padded rows minus 1), the
    interpolation weight coef, the sign of the wall normal, the static
    wall-parallel values mags of the face's two components (u, v on a z
    face; u, w on a y face), the laminar profile's length l1d (the domain
    along d), and fills: how the sampled rows of the two components take
    their ghosts along the face's other transverse axis (y on a z face,
    z on a y face), each (letters, values, spacings, staggered) with the
    static BC values of the effective letters (cales_tpu
    Simulation._row_pad_xy, _row_pad_xz); 'PP' periodic.  xfills: with x
    walls (z faces only), how the sampled rows r1 and r2 of the two
    components take their x ghosts, in the same form by row and component,
    a value a float or the x face's padded plane at that row, a tuple of
    ny+2 floats, so the face hashes; None where x wraps."""
    d: int
    ib: int
    mtype: int
    r1: int
    r2: int
    coef: float
    sgn: float
    mags: tuple
    l1d: float
    fills: tuple
    xfills: tuple = None


class WallModel(NamedTuple):
    """The faces a configuration models, with hwm and the viscosity, and
    on y faces the weights (zf - zc) / dzc (nz+2) of the z interpolation
    to w's faces (None without a y face)."""
    faces: tuple
    h: float
    visc: float
    wei: tuple = None


def _at_row(b, r):
    """An x face's value at the sampled z row r: a scalar as a float, the
    padded (nz+2, ny+2) plane's row r + 1 as a tuple of ny+2 floats."""
    if getattr(b, 'ndim', 0) != 2:
        return float(b)
    return tuple(torch.as_tensor(b[r + 1]).cpu().double().tolist())


def _fill(cbcvel, vals, d, ivel, dr, stag, row=None):
    """A component's fill along d; with row, an x face's values at the
    sampled z row (_at_row)."""
    val = float if row is None else (lambda b: _at_row(b, row))
    return (cbcvel[0][d][ivel] + cbcvel[1][d][ivel],
            (val(vals[d][0]), val(vals[d][1])), dr, stag)


def wall_face(cfg, grid, d, ib, index_wm, bcs=None, cbcvel=None) -> WallFace:
    """Face (d, ib)'s geometry (y_wall_wm_planes, z_wall_wm_planes,
    cales_tpu/wallmodel.py:204-268: a lower z face interpolates with
    dzc[k1], an upper one with dzc[k2]; the y faces with dy) and its rows'
    fill.  bcs: the static BC values (bcu, bcv, bcw) by direction and
    side, zeros by default; cbcvel: the effective letters
    (config.effective_cbcvel by default)."""
    if cbcvel is None:
        cbcvel = effective_cbcvel(cfg)
    if bcs is None:
        bcs = (((0.0, 0.0),) * 3,) * 3
    bcu, bcv, bcw = bcs
    h = cfg.hwm
    nx, ny, nz = cfg.ng
    i2 = index_wm[d][ib]
    i1 = i2 - 1 if ib == 0 else i2 + 1
    xwalls = cbcvel[0][0][0] + cbcvel[1][0][0] != 'PP'
    xfills = None
    if d == 2:
        zc, dzc = grid.zc, grid.dzc
        coef = ((h - zc[i1]) / dzc[i1] if ib == 0
                else (h - (cfg.l[2] - zc[i1])) / dzc[i2])
        dy = (cfg.dl[1], cfg.dl[1])
        fills = (_fill(cbcvel, bcu, 1, 0, dy, False),
                 _fill(cbcvel, bcv, 1, 1, dy, True))
        mags = (float(bcu[2][ib]), float(bcv[2][ib]))
        if xwalls:
            dx = (cfg.dl[0], cfg.dl[0])
            xfills = tuple((_fill(cbcvel, bcu, 0, 0, dx, True, row=r),
                            _fill(cbcvel, bcv, 0, 1, dx, False, row=r))
                           for r in (i1 - 1, i2 - 1))
    elif d == 1:
        if xwalls:
            raise ValueError('wall_face: a y face with x walls')
        dl = cfg.dl[1]
        coef = ((h - (i1 - 0.5) * dl) / dl if ib == 0
                else (h - (ny - i1 + 0.5) * dl) / dl)
        par = (float(grid.dzc[0]), float(grid.dzc[nz]))
        nrm = (float(grid.dzf[0]), float(grid.dzf[nz]))
        fills = (_fill(cbcvel, bcu, 2, 0, par, False),
                 _fill(cbcvel, bcw, 2, 2, nrm, True))
        mags = (float(bcu[1][ib]), float(bcw[1][ib]))
    else:
        raise ValueError(f'wall_face: no wall model on x faces (d = {d})')
    return WallFace(d=d, ib=ib, mtype=int(cfg.lwm[ib][d]), r1=i1 - 1,
                    r2=i2 - 1, coef=float(coef),
                    sgn=1.0 if ib == 0 else -1.0, mags=mags,
                    l1d=float(cfg.l[d]), fills=fills, xfills=xfills)


def wall_model(cfg, grid, index_wm, bcs=None, cbcvel=None,
               dirs=(2, 1)) -> WallModel:
    """The wall-modelled faces of cfg along dirs (z, then y by default;
    cales_tpu Simulation._wm_bcs_fast's order); bcs, cbcvel as
    wall_face takes them."""
    faces = tuple(wall_face(cfg, grid, d, ib, index_wm, bcs, cbcvel)
                  for d in dirs for ib in range(2) if cfg.lwm[ib][d] != 0)
    wei = None
    if any(f.d == 1 for f in faces):
        wei = tuple(float(q) for q in (grid.zf - grid.zc) / grid.dzc)
    return WallModel(faces=faces, h=float(cfg.hwm), visc=float(cfg.visc),
                     wei=wei)


def z_wall_model(cfg, grid, index_wm, bcu_z=(0.0, 0.0),
                 bcv_z=(0.0, 0.0)) -> WallModel:
    """The wall-modelled z faces of cfg; bcu_z, bcv_z: the static scalar
    values of u and v on the two z faces."""
    zero = (0.0, 0.0)
    bcs = ((zero, zero, tuple(bcu_z)), (zero, zero, tuple(bcv_z)),
           (zero,) * 3)
    return wall_model(cfg, grid, index_wm, bcs, dirs=(2,))


def channel_z_faces(nz, coef=0.3, h=0.1, visc=1.0 / 125_000.0):
    """A wall model of both z faces of an nz-row channel with periodic y,
    log-law, rows 0, 1 and nz-1, nz-2, still walls (bench.py's
    wmles_channel hwm and visci): the probes' inputs at any shape."""
    fills = (('PP', (0.0, 0.0), (0.0, 0.0), False),
             ('PP', (0.0, 0.0), (0.0, 0.0), True))
    return WallModel(faces=tuple(
        WallFace(d=2, ib=ib, mtype=WM_LOG, r1=r1, r2=r2, coef=coef,
                 sgn=1.0 - 2.0 * ib, mags=(0.0, 0.0), l1d=2.0, fills=fills)
        for ib, (r1, r2) in enumerate(((0, 1), (nz - 1, nz - 2)))),
        h=h, visc=visc)


def _face_rel(face, U1, U2, V1, V2, umag, vmag, wei=None):
    """The wall-relative (u, v) at hwm of one face from the padded
    (n+2, nx+2) rows U1, U2 of its first component and V1, V2 of its
    second (v on a z face, w on a y face) and the planes umag, vmag
    (wmodel.f90:171-272): at the first component's points [1:n+1, 0:nx+1]
    and at the second's [0:n+1, 1:nx+1].  wei: on a y face the (n+1, 1)
    weights and their 1 - wei, interpolating u to w's z faces."""
    n, nx = U1.shape[0] - 2, U1.shape[1] - 2
    coef = face.coef
    # bcu over (i=0..nx, j or k=1..n)
    u1 = U1[1:n + 1, 0:nx + 1]
    u2 = U2[1:n + 1, 0:nx + 1]
    v1 = 0.25 * (V1[1:n + 1, 0:nx + 1] + V1[1:n + 1, 1:nx + 2]
                 + V1[0:n, 0:nx + 1] + V1[0:n, 1:nx + 2])
    v2 = 0.25 * (V2[1:n + 1, 0:nx + 1] + V2[1:n + 1, 1:nx + 2]
                 + V2[0:n, 0:nx + 1] + V2[0:n, 1:nx + 2])
    um = umag[1:n + 1, 0:nx + 1]
    vm = 0.25 * (vmag[1:n + 1, 0:nx + 1] + vmag[1:n + 1, 1:nx + 2]
                 + vmag[0:n, 0:nx + 1] + vmag[0:n, 1:nx + 2])
    at_u = (_rel(u1, u2, coef, um), _rel(v1, v2, coef, vm))

    # bcv (z face) or bcw (y face) over (i=1..nx, j or k=0..n)
    def avg(q):
        if wei is None:
            return 0.25 * (q[0:n + 1, 0:nx] + q[0:n + 1, 1:nx + 1]
                           + q[1:n + 2, 0:nx] + q[1:n + 2, 1:nx + 1])
        w, omw = wei
        return 0.5 * (omw * (q[0:n + 1, 0:nx] + q[0:n + 1, 1:nx + 1])
                      + w * (q[1:n + 2, 0:nx] + q[1:n + 2, 1:nx + 1]))
    v1 = V1[0:n + 1, 1:nx + 1]
    v2 = V2[0:n + 1, 1:nx + 1]
    vm = vmag[0:n + 1, 1:nx + 1]
    return at_u, (_rel(avg(U1), avg(U2), coef, avg(umag)),
                  _rel(v1, v2, coef, vm))


def _face_planes(face, U1, U2, V1, V2, umag, vmag, bcu, bcv, h, visc,
                 wei=None):
    """The updated planes of one face's two components from the padded
    (n+2, nx+2) rows and the planes umag, vmag (wmodel.f90:171-272):
    the first over [1:n+1, 0:nx+1], the second over [0:n+1, 1:nx+1], the
    rest kept from bcu, bcv."""
    n, nx = U1.shape[0] - 2, U1.shape[1] - 2
    visci = 1.0 / visc
    at_u, at_v = _face_rel(face, U1, U2, V1, V2, umag, vmag, wei)
    t1, _ = wallmodel_tauw(face.mtype, *at_u, h, face.l1d, visc)
    bcu = bcu.clone()
    bcu[1:n + 1, 0:nx + 1] = face.sgn * visci * t1
    _, t2 = wallmodel_tauw(face.mtype, *at_v, h, face.l1d, visc)
    bcv = bcv.clone()
    bcv[0:n + 1, 1:nx + 1] = face.sgn * visci * t2
    return bcu, bcv


def z_wall_wm_planes(cfg, grid, U1, U2, V1, V2, umag, vmag, bcu_z, bcv_z,
                     ib, index_wm):
    """The z-wall branch of the wall-model BC update on explicit padded
    (ny+2, nx+2) velocity ROWS at (k1, k2) (cales_tpu/wallmodel.py:253-
    296).  Returns the updated (bcu_z, bcv_z) planes for face ib."""
    return _face_planes(wall_face(cfg, grid, 2, ib, index_wm), U1, U2, V1,
                        V2, umag, vmag, bcu_z, bcv_z, cfg.hwm, cfg.visc)


def _wei(wei, n, like):
    """A y face's (n+1, 1) weights wei[0:n+1] and their 1 - wei, in
    like's dtype."""
    w = np.asarray(wei[0:n + 1])[:, None]
    t = lambda a: torch.as_tensor(a, dtype=like.dtype,  # noqa: E731
                                  device=like.device)
    return t(w), t(1 - w)


def pad_row(q, fill, xfill=None, halo=None, own=None):
    """One sampled (n, nx) row padded to (n+2, nx+2): along x periodic, or
    with x walls by xfill (a z face's row, its values the x faces' at that
    row, a padded row of values as a (1, ny+2) tensor, which set_bc crops
    to the row's interior), then the other transverse axis by fill =
    (letters, values, spacings, staggered), as set_bc fills it (cales_tpu
    Simulation._row_pad_xy, _row_pad_xz, the x -> y order of pad_velocity
    on a row).  halo: on a slab of the y-slab mesh (a z face's row), its
    (2, nx) rows -1 and nyl from the neighbours, which take the place of
    the periodic wrap along y, x periodic or with x walls by xfill on all
    nyl + 2 rows (its values the slab's rows of the x faces', their rows
    -1 and nyl too: the x recipes are pointwise along y); with own =
    (lower, upper), the y walls a slab of a y-walled mesh holds (periodic
    x), the fill's rows on the sides it owns (its ghost and, for the
    staggered component, its rewrite row n) and the halo rows and the row
    itself elsewhere."""
    letters, vals, dr, stag = fill
    if halo is not None and own is None:
        s = torch.cat([halo[:1], q, halo[1:]])
        if xfill is not None:
            return _xfill(s, xfill)
        return torch.cat([s[:, -1:], s, s[:, :1]], dim=1)
    if halo is not None:
        full = pad_row(q, fill)
        hx, qx = (torch.cat([a[:, -1:], a, a[:, :1]], dim=1)
                  for a in (halo, q[-1:]))
        return torch.cat([full[:1] if own[0] else hx[:1], full[1:-2],
                          full[-2:] if own[1] else torch.cat([qx, hx[1:]])])
    if xfill is None:
        s = torch.cat([q[:, -1:], q, q[:, :1]], dim=1)
    else:
        s = _xfill(q, xfill)
    s = s[:, None, :]
    s = (bnd._set_face if stag else bnd._set_centered)(s, 0, letters, vals,
                                                        dr)
    return s[:, 0, :]


def _xfill(q, xfill):
    """The (m, nx) rows q padded along x by xfill (pad_row): set_bc along
    x with the x faces' values at those rows, a plane-valued one a tuple
    of m + 2 values (cropped to q's m rows) or of m (q's own rows)."""
    xl, xv, xd, xstag = xfill
    xv = tuple(torch.tensor(b, dtype=q.dtype, device=q.device)[None]
               if isinstance(b, tuple) else b for b in xv)
    return (bnd._set_face if xstag else bnd._set_centered)(
        q[None], 2, xl, xv, xd)[0]


def sampled_rows(u, v, wm):
    """The rows r1 and r2 of u and v of each z face of wm, as one
    (4 z faces, ny, nx) tensor in the order (face, component, row): what a
    slab sends its neighbours for their y halos (mesh.halo_y), and the
    order of the halo rows the slab variant of the wall-model kernel
    takes.  A y face samples its own slab's rows and sends none."""
    return torch.stack([q[r] for f in wm.faces if f.d == 2 for q in (u, v)
                        for r in (f.r1, f.r2)])


def slab_wall_model(wm, y0, nyl, own):
    """The wall model a slab of a y-walled y-slab mesh runs: wm's z faces,
    whose sampled rows take the slab's y halos, and the y faces it owns
    (own = (lower, upper)) with their rows r1, r2 on the slab's rows
    (timeloop.unsupported refuses a wall whose rows leave its owner's
    slab of nyl rows from y0)."""
    faces = []
    for f in wm.faces:
        if f.d == 1:
            if not own[f.ib]:
                continue
            r1, r2 = f.r1 - y0, f.r2 - y0
            if not (0 <= r1 < nyl and 0 <= r2 < nyl):
                raise ValueError(f'slab_wall_model: rows {f.r1}, {f.r2} of '
                                 f'the y face {f.ib} off the slab [{y0}, '
                                 f'{y0 + nyl})')
            f = f._replace(r1=r1, r2=r2)
        faces.append(f)
    return wm._replace(faces=tuple(faces))


def _face_rows(u, v, w, wm, fuv, pp, dtrk, dxi, dyi, yh=None, yown=None):
    """Per face of wm: the face, its padded rows U1, U2 (of u) and V1, V2
    (of v on a z face, w on a y face), sampled as wm_planes_plain says,
    its static planes umag, vmag, and on a y face its weights; yh: a
    slab's halo rows of sampled_rows, (4 z faces, 2, nx); yown: the y
    walls of a slab of a y-walled mesh."""
    ny, nx = u.shape[1:]
    nz = u.shape[0]

    def rows(face, r):
        if face.d == 1:
            return u[:, r], w[:, r]
        uq, vq = u[r], v[r]
        if pp is not None:
            ppq = pp[r]
            uq = fuv[0] + uq - dtrk * dxi * (torch.roll(ppq, -1, 1) - ppq)
            vq = fuv[1] + vq - dtrk * dyi * (torch.roll(ppq, -1, 0) - ppq)
        return uq, vq

    for m, face in enumerate(wm.faces):
        n = nz if face.d == 1 else ny
        xfills = face.xfills or ((None, None),) * 2
        # the halo rows of (u, v) at (r1, r2), or None (a y face's rows
        # are its own slab's; on a slab the z faces come first)
        halos = (((None, None),) * 2 if yh is None or face.d == 1
                 else ((yh[4 * m], yh[4 * m + 2]),
                       (yh[4 * m + 1], yh[4 * m + 3])))
        own = yown if face.d == 2 else None
        (U1, V1), (U2, V2) = ([pad_row(q, f, xf, h, own) for q, f, xf, h in
                               zip(rows(face, r), face.fills, xr, hr)]
                              for r, xr, hr in zip((face.r1, face.r2),
                                                   xfills, halos))
        umag = torch.full((n + 2, nx + 2), face.mags[0], dtype=u.dtype,
                          device=u.device)
        vmag = torch.full_like(umag, face.mags[1])
        wei = _wei(wm.wei, n, u) if face.d == 1 else None
        yield face, (U1, U2, V1, V2, umag, vmag), wei


def _check_mode(wm, w, fuv, pp, yh=None, yown=None):
    if (pp is None) != (fuv is None):
        raise ValueError('wm_planes: the corrected rows take fuv with pp')
    zfaces = [f for f in wm.faces if f.d == 2]
    xw = any(f.xfills is not None for f in wm.faces)
    if yh is not None and (pp is not None or (yown is not None and xw) or (
            yown is None and (len(zfaces) < len(wm.faces)
                              or any(f.fills[0][0] != 'PP'
                                     for f in zfaces)))):
        raise ValueError("wm_planes: a slab's halo rows serve z faces, the "
                         'rows as they are, with periodic y (x periodic or '
                         'x walls) or the y walls a slab holds (yown, '
                         'periodic x)')
    if yown is not None and (yh is None) != (not zfaces):
        raise ValueError("wm_planes: a slab of a y-walled mesh takes its z "
                         "faces' halo rows, and none without z faces")
    if ((yh is not None or yown is not None)
            and wm.faces[:len(zfaces)] != tuple(zfaces)):
        raise ValueError('wm_planes: on a slab the z faces come first')
    if any(f.d == 1 for f in wm.faces) and w is None:
        raise ValueError('wm_planes: a y face samples w')
    if pp is not None and any(f.d != 2 or f.fills[0][0] != 'PP'
                              or f.xfills is not None for f in wm.faces):
        raise ValueError('wm_planes: the corrected rows serve z faces with '
                         'periodic x and y only (the fused correction)')


def wm_planes_plain(u, v, wm: WallModel, fuv=None, pp=None, dtrk=0.0,
                    dxi=0.0, dyi=0.0, w=None, yh=None, yown=None):
    """The wall-modelled faces' padded planes from interior (nz, ny, nx)
    u, v and (with y faces) w: a tuple with one (2, n+2, nx+2) tensor a
    face of wm, [bcu, bcv] on a z face (n = ny), [bcu, bcw] on a y face
    (n = nz).  Each face samples its rows r1 and r2 (of u and v at z rows,
    of u and w at y rows), fills their ghosts along x periodically and
    along the other transverse axis by the face's fills (cales_tpu
    timeloop.py:637-728, without fadd; with x walls along x by the face's
    xfills first), or on z faces with periodic x and y,
    with fuv = (fu, fv) and pp, corrected: fu + u - dtrk dxi (pp(i+1) -
    pp(i)) and likewise v along y, as the fused correction's rows
    (timeloop.py:1314-1342).  The planes off the wall model's ranges keep
    the face's static values.  yh: on a slab of the y-slab mesh (z faces,
    periodic y, the rows as they are; with x walls the halo rows padded
    along x too, by the slab's rows of the x faces' values, pad_row), the
    (4 z faces, 2, nx) halo rows -1 and nyl of sampled_rows, which the
    rows take along y in place of the wrap.  yown: a slab of a y-walled
    mesh (lower, upper), whose wm is slab_wall_model's (its z faces first,
    the y faces it owns on its own rows): the z faces' rows take the y
    recipe's rows on the sides the slab owns and yh's elsewhere
    (pad_row)."""
    _check_mode(wm, w, fuv, pp, yh, yown)
    out = []
    for face, (U1, U2, V1, V2, umag, vmag), wei in _face_rows(
            u, v, w, wm, fuv, pp, dtrk, dxi, dyi, yh, yown):
        out.append(torch.stack(_face_planes(face, U1, U2, V1, V2, umag, vmag,
                                            umag, vmag, wm.h, wm.visc,
                                            wei)))
    return tuple(out)


def wm_newton_steps(u, v, wm: WallModel, fuv=None, pp=None, dtrk=0.0,
                    dxi=0.0, dyi=0.0, w=None, yh=None, yown=None):
    """newton_steps at every point of wm_planes_plain's planes (same
    arguments), as int32 (2, n+2, nx+2) tensors, one a face: 0 off the
    planes' ranges and on laminar faces."""
    _check_mode(wm, w, fuv, pp, yh, yown)
    out = []
    for face, rows, wei in _face_rows(u, v, w, wm, fuv, pp, dtrk, dxi, dyi,
                                      yh, yown):
        n, nx = rows[0].shape[0] - 2, rows[0].shape[1] - 2
        steps = torch.zeros((2, n + 2, nx + 2), dtype=torch.int32,
                            device=u.device)
        if face.mtype == WM_LOG:
            (ur, vr), (uq, vq) = _face_rel(face, *rows, wei)
            steps[0, 1:n + 1, 0:nx + 1] = newton_steps(
                torch.sqrt(ur * ur + vr * vr), wm.h, wm.visc)
            steps[1, 0:n + 1, 1:nx + 1] = newton_steps(
                torch.sqrt(uq * uq + vq * vq), wm.h, wm.visc)
        out.append(steps)
    return tuple(out)
