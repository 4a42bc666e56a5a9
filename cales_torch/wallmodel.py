"""Wall models on the z faces: log-law (Newton on u_tau) and laminar.

Counterpart of cales_tpu/wallmodel.py (reference wmodel.f90), copied
because that module imports jax: per wall-modelled face, the wall-parallel
velocity is interpolated to the matching height ``hwm`` between the two
bracketing cell rows (wmodel.f90:222-272), made wall-relative, fed to the
log-law Newton iteration (288-326) or the laminar profile (327-333), and
tau_w/visc is the Neumann value of the parallel components on that face.
The Newton iteration runs a fixed N_NEWTON steps with no convergence test,
as the JAX package's does; the kernel lets a warp stop once all its lanes
have converged, and ``newton_steps`` / ``wm_newton_steps`` count the steps
that takes on given inputs.

``wm_planes_plain`` is the plain twin of the wall-model kernel
(ops/kernels.wm_planes, csrc/wallmodel.cu): both faces' padded planes from
the sampled rows of u and v, as they are or corrected by the pressure
correction pp and the deferred bulk forcing first.  The y- and x-face
branches (``y_wall_wm_planes``, the x branch of ``update_wallmodel_bcs``)
are not ported yet (ROADMAP queue 1).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .config import KAP_LOG, B_LOG

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
            if not 0.5 * dl[1] < h < (ny - 0.5) * dl[1]:
                err('y')
            j = 1 if ib == 0 else ny
            if ib == 0:
                while (j - 0.5) * dl[1] < h:
                    j += 1
            else:
                while (ny - j + 0.5) * dl[1] < h:
                    j -= 1
            idx[1][ib] = j
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


class ZFace(NamedTuple):
    """One wall-modelled z face: its model type, the interior rows r1
    (nearer the wall) and r2 that bracket hwm (0-based: the padded rows
    k1 - 1, k2 - 1), the interpolation weight coef, the sign of the wall
    normal, and the face's static wall-parallel values umag, vmag."""
    ib: int
    mtype: int
    r1: int
    r2: int
    coef: float
    sgn: float
    umag: float
    vmag: float


class ZWallModel(NamedTuple):
    """The z faces a configuration models, with hwm, the domain height
    (the laminar profile's) and the viscosity."""
    faces: tuple
    h: float
    l1d: float
    visc: float


def z_face(cfg, grid, ib, index_wm, umag=0.0, vmag=0.0) -> ZFace:
    """Face ib's geometry (z_wall_wm_planes, cales_tpu/wallmodel.py:253-
    268): the lower face interpolates with dzc[k1], the upper with
    dzc[k2]."""
    h = cfg.hwm
    zc, dzc = grid.zc, grid.dzc
    k2 = index_wm[2][ib]
    k1 = k2 - 1 if ib == 0 else k2 + 1
    coef = ((h - zc[k1]) / dzc[k1] if ib == 0
            else (h - (cfg.l[2] - zc[k1])) / dzc[k2])
    return ZFace(ib=ib, mtype=int(cfg.lwm[ib][2]), r1=k1 - 1, r2=k2 - 1,
                 coef=float(coef), sgn=1.0 if ib == 0 else -1.0,
                 umag=float(umag), vmag=float(vmag))


def z_wall_model(cfg, grid, index_wm, bcu_z=(0.0, 0.0),
                 bcv_z=(0.0, 0.0)) -> ZWallModel:
    """The wall-modelled z faces of cfg; bcu_z, bcv_z: the static scalar
    values of u and v on the two z faces."""
    faces = tuple(z_face(cfg, grid, ib, index_wm, bcu_z[ib], bcv_z[ib])
                  for ib in range(2) if cfg.lwm[ib][2] != 0)
    return ZWallModel(faces=faces, h=float(cfg.hwm), l1d=float(cfg.l[2]),
                      visc=float(cfg.visc))


def _face_rel(face, U1, U2, V1, V2, umag, vmag):
    """The wall-relative (u, v) at hwm of one face from the padded (ny+2,
    nx+2) rows U1, U2, V1, V2 and the planes umag, vmag
    (wmodel.f90:222-272): at the bcu points [1:ny+1, 0:nx+1] and at the
    bcv points [0:ny+1, 1:nx+1]."""
    ny, nx = U1.shape[0] - 2, U1.shape[1] - 2
    coef = face.coef
    # bcu%z over (i=0..nx, j=1..ny)
    u1 = U1[1:ny + 1, 0:nx + 1]
    u2 = U2[1:ny + 1, 0:nx + 1]
    v1 = 0.25 * (V1[1:ny + 1, 0:nx + 1] + V1[1:ny + 1, 1:nx + 2]
                 + V1[0:ny, 0:nx + 1] + V1[0:ny, 1:nx + 2])
    v2 = 0.25 * (V2[1:ny + 1, 0:nx + 1] + V2[1:ny + 1, 1:nx + 2]
                 + V2[0:ny, 0:nx + 1] + V2[0:ny, 1:nx + 2])
    um = umag[1:ny + 1, 0:nx + 1]
    vm = 0.25 * (vmag[1:ny + 1, 0:nx + 1] + vmag[1:ny + 1, 1:nx + 2]
                 + vmag[0:ny, 0:nx + 1] + vmag[0:ny, 1:nx + 2])
    at_u = (_rel(u1, u2, coef, um), _rel(v1, v2, coef, vm))
    # bcv%z over (i=1..nx, j=0..ny)
    u1 = 0.25 * (U1[0:ny + 1, 0:nx] + U1[0:ny + 1, 1:nx + 1]
                 + U1[1:ny + 2, 0:nx] + U1[1:ny + 2, 1:nx + 1])
    u2 = 0.25 * (U2[0:ny + 1, 0:nx] + U2[0:ny + 1, 1:nx + 1]
                 + U2[1:ny + 2, 0:nx] + U2[1:ny + 2, 1:nx + 1])
    v1 = V1[0:ny + 1, 1:nx + 1]
    v2 = V2[0:ny + 1, 1:nx + 1]
    um = 0.25 * (umag[0:ny + 1, 0:nx] + umag[0:ny + 1, 1:nx + 1]
                 + umag[1:ny + 2, 0:nx] + umag[1:ny + 2, 1:nx + 1])
    vm = vmag[0:ny + 1, 1:nx + 1]
    return at_u, (_rel(u1, u2, coef, um), _rel(v1, v2, coef, vm))


def _face_planes(face, U1, U2, V1, V2, umag, vmag, bcu_z, bcv_z, h, l1d,
                 visc):
    """The updated (bcu_z, bcv_z) planes of one face from the padded
    (ny+2, nx+2) rows U1, U2, V1, V2 and the planes umag, vmag
    (wmodel.f90:222-272): bcu over [1:ny+1, 0:nx+1], bcv over
    [0:ny+1, 1:nx+1], the rest kept from bcu_z, bcv_z."""
    ny, nx = U1.shape[0] - 2, U1.shape[1] - 2
    visci = 1.0 / visc
    at_u, at_v = _face_rel(face, U1, U2, V1, V2, umag, vmag)
    t1, _ = wallmodel_tauw(face.mtype, *at_u, h, l1d, visc)
    bcu_z = bcu_z.clone()
    bcu_z[1:ny + 1, 0:nx + 1] = face.sgn * visci * t1
    _, t2 = wallmodel_tauw(face.mtype, *at_v, h, l1d, visc)
    bcv_z = bcv_z.clone()
    bcv_z[0:ny + 1, 1:nx + 1] = face.sgn * visci * t2
    return bcu_z, bcv_z


def z_wall_wm_planes(cfg, grid, U1, U2, V1, V2, umag, vmag, bcu_z, bcv_z,
                     ib, index_wm):
    """The z-wall branch of the wall-model BC update on explicit padded
    (ny+2, nx+2) velocity ROWS at (k1, k2) (cales_tpu/wallmodel.py:253-
    296).  Returns the updated (bcu_z, bcv_z) planes for face ib."""
    return _face_planes(z_face(cfg, grid, ib, index_wm), U1, U2, V1, V2,
                        umag, vmag, bcu_z, bcv_z, cfg.hwm, cfg.l[2],
                        cfg.visc)


def _wrap_xy(q):
    """Periodic x/y ghosts around one (ny, nx) row: its padded (ny+2,
    nx+2) row (cales_tpu Simulation._row_pad_xy with periodic x and y)."""
    q = torch.cat([q[-1:], q, q[:1]], dim=0)
    return torch.cat([q[:, -1:], q, q[:, :1]], dim=1)


def _face_rows(u, v, wm, fuv, pp, dtrk, dxi, dyi):
    """Per face of wm: the face, its padded rows U1, U2, V1, V2 (sampled
    as wm_planes_plain says) and its static planes umag, vmag."""
    ny, nx = u.shape[1:]

    def rows(r):
        uq, vq = u[r], v[r]
        if pp is not None:
            ppq = pp[r]
            uq = fuv[0] + uq - dtrk * dxi * (torch.roll(ppq, -1, 1) - ppq)
            vq = fuv[1] + vq - dtrk * dyi * (torch.roll(ppq, -1, 0) - ppq)
        return _wrap_xy(uq), _wrap_xy(vq)

    for face in wm.faces:
        (U1, V1), (U2, V2) = rows(face.r1), rows(face.r2)
        umag = torch.full((ny + 2, nx + 2), face.umag, dtype=u.dtype,
                          device=u.device)
        yield face, U1, U2, V1, V2, umag, torch.full_like(umag, face.vmag)


def wm_planes_plain(u, v, wm: ZWallModel, fuv=None, pp=None, dtrk=0.0,
                    dxi=0.0, dyi=0.0):
    """The wall-modelled faces' padded (ny+2, nx+2) bcu and bcv planes
    from interior (nz, ny, nx) u and v, periodic along x and y, as one
    (len(wm.faces), 2, ny+2, nx+2) tensor [face][bcu, bcv].  Each face
    samples its rows r1 and r2 of u and v as they are (cales_tpu
    timeloop.py:677-704 without fadd) or, with fuv = (fu, fv) and pp,
    corrected: fu + u - dtrk dxi (pp(i+1) - pp(i)) and likewise v along
    y, as the fused correction's rows (timeloop.py:1314-1342).
    The planes off the wall model's ranges keep the face's static values."""
    if (pp is None) != (fuv is None):
        raise ValueError('wm_planes: the corrected rows take fuv with pp')
    out = []
    for face, U1, U2, V1, V2, umag, vmag in _face_rows(u, v, wm, fuv, pp,
                                                       dtrk, dxi, dyi):
        out.append(torch.stack(_face_planes(face, U1, U2, V1, V2, umag, vmag,
                                            umag, vmag, wm.h, wm.l1d,
                                            wm.visc)))
    return torch.stack(out)


def wm_newton_steps(u, v, wm: ZWallModel, fuv=None, pp=None, dtrk=0.0,
                    dxi=0.0, dyi=0.0):
    """newton_steps at every point of wm_planes_plain's planes (same
    arguments), as an int32 (len(wm.faces), 2, ny+2, nx+2) tensor: 0 off
    the planes' ranges and on laminar faces."""
    ny, nx = u.shape[1:]
    out = torch.zeros((len(wm.faces), 2, ny + 2, nx + 2), dtype=torch.int32,
                      device=u.device)
    for n, (face, *rows) in enumerate(_face_rows(u, v, wm, fuv, pp, dtrk,
                                                 dxi, dyi)):
        if face.mtype != WM_LOG:
            continue
        (ur, vr), (uq, vq) = _face_rel(face, *rows)
        out[n, 0, 1:ny + 1, 0:nx + 1] = newton_steps(
            torch.sqrt(ur * ur + vr * vr), wm.h, wm.visc)
        out[n, 1, 0:ny + 1, 1:nx + 1] = newton_steps(
            torch.sqrt(uq * uq + vq * vq), wm.h, wm.visc)
    return out
