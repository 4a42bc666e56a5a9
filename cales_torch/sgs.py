"""SGS eddy viscosity: static Smagorinsky with van Driest damping, and
dynamic Smagorinsky (Germano-Lilly) with the 'dit', 'channel', 'duct' and
'cavity' averages and the 3D or the 2D test filter.

Counterpart of cales_tpu/sgs.py (reference sgs.f90:69-380, extrapolate
682-767, cmpt_alph2 769-822).  ``SGSSetup`` is the JAX package's numpy
setup (filter width, wall-distance profiles, wall flags), copied because
that module imports jax.  ``smag_visct`` and ``dsmag_visct`` on padded
fields serve the initial fill; each substep's nu_t comes out of a kernel
(ops/kernels.correc_smag, smag or dsmag), and ``dsmag_visct`` is the model
the dsmag kernel's plain twin is held to.  ``extrapolate_stacks`` is
``extrapolate`` on a field held as edge stacks: the ghosts smag's y-wall
variant reads on wall-modelled faces, and with periodic y the z ghosts
of an x stack pair (its columns and their corners in place of the
interior and its z-edge stack), which smag's x-wall variant reads.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import Config, C_SMAG
from .grid import Grid

from .ops import boundary as bnd
from .ops import stencil as st


def extrapolate(p, iface, flags, factors):
    """Linear extrapolation of ghost planes at flagged walls
    (sgs.f90:682-767).  p: padded field; iface: 0 (cell-centered) or 1/2/3
    (the component's own face direction, skipped); flags[(ib, idir)]: bool;
    factors: (f_lo_z, f_hi_z) z stretching factors."""
    f0, f1 = factors

    def replace(q, axis, lo, do_lo, hi, do_hi):
        n = q.shape[axis]
        start = 1 if do_lo else 0
        stop = n - 1 if do_hi else n
        parts = []
        if do_lo:
            parts.append(lo.unsqueeze(axis))
        parts.append(q.narrow(axis, start, stop - start))
        if do_hi:
            parts.append(hi.unsqueeze(axis))
        return torch.cat(parts, dim=axis) if len(parts) > 1 else q

    if iface != 1 and (flags.get((0, 0)) or flags.get((1, 0))):
        p = replace(p, 2,
                    2.0 * p[:, :, 1] - p[:, :, 2], bool(flags.get((0, 0))),
                    2.0 * p[:, :, -2] - p[:, :, -3], bool(flags.get((1, 0))))
    if iface != 2 and (flags.get((0, 1)) or flags.get((1, 1))):
        p = replace(p, 1,
                    2.0 * p[:, 1, :] - p[:, 2, :], bool(flags.get((0, 1))),
                    2.0 * p[:, -2, :] - p[:, -3, :], bool(flags.get((1, 1))))
    if iface != 3 and (flags.get((0, 2)) or flags.get((1, 2))):
        p = replace(p, 0,
                    (1.0 + f0) * p[1] - f0 * p[2], bool(flags.get((0, 2))),
                    (1.0 + f1) * p[-2] - f1 * p[-3], bool(flags.get((1, 2))))
    return p


def extrapolate_stacks(q, ze, y, iface, flags, factors):
    """extrapolate on a field held as its interior q (nz, ny, nx), its
    z-edge stack ze (3, ny, nx) and its y-row stack pair y = (rows (nz, 3,
    nx), corners (3, 3, nx)) (ops/boundary.zedge_*, yedge_*), or y = None
    with periodic y (then q and ze may be an x stack's columns (nz, 3,
    nyc) and corners (3, 3, nyc), ops/boundary.xedge_*: the z pass is the
    same on them, the x faces carrying no wall model): the ghost rows the
    sequential fill gives, extrapolated along y and then z where flags
    says, as extrapolate does
    on the padded field (so a corner is the z extrapolation of the
    y-extrapolated rows).  Returns (ze, (rows, corners) or None), new
    tensors where anything changed."""
    from .ops.kernels import zpad, ypad
    nz, ny = q.shape[0], q.shape[1]
    if y is None:
        if iface == 3 or not (flags.get((0, 2)) or flags.get((1, 2))):
            return ze, None
        f0, f1 = float(factors[0]), float(factors[1])
        ze = ze.clone()
        if flags.get((0, 2)):
            ze[0] = (1.0 + f0) * q[0] - f0 * q[1]
        if flags.get((1, 2)):
            ze[2] = (1.0 + f1) * ze[1] - f1 * q[-2]
        return ze, None
    rows, corners = y
    zsel = [0, nz, nz + 1]    # padded z rows kept in the corners
    if iface != 2 and (flags.get((0, 1)) or flags.get((1, 1))):
        rows, corners = rows.clone(), corners.clone()
        # padded y rows 0 and ny+1 over the whole padded z range
        if flags.get((0, 1)):
            lo = (2.0 * zpad(q[:, 0], ze[:, 0])
                  - zpad(q[:, 1], ze[:, 1]))
            rows[:, 0], corners[:, 0] = lo[1:nz + 1], lo[zsel]
        if flags.get((1, 1)):
            hi = (2.0 * zpad(y[0][:, 1], y[1][:, 1])
                  - zpad(q[:, -2], ze[:, -2]))
            rows[:, 2], corners[:, 2] = hi[1:nz + 1], hi[zsel]
    if iface != 3 and (flags.get((0, 2)) or flags.get((1, 2))):
        f0, f1 = float(factors[0]), float(factors[1])
        ze, corners = ze.clone(), corners.clone()
        ysel = [0, ny, ny + 1]

        def plane(k):
            # padded z row k (1 .. nz) over the padded y range
            if k == nz:
                return ypad(ze[1:2], corners[1:2])[0]
            return ypad(q[k - 1:k], rows[k - 1:k])[0]
        if flags.get((0, 2)):
            lo = (1.0 + f0) * plane(1) - f0 * plane(2)
            ze[0], corners[0] = lo[1:ny + 1], lo[ysel]
        if flags.get((1, 2)):
            hi = (1.0 + f1) * plane(nz) - f1 * plane(nz - 1)
            ze[2], corners[2] = hi[1:ny + 1], hi[ysel]
    return ze, (rows, corners)


class SGSSetup:
    """Static SGS data derived from config + grid (numpy)."""

    def __init__(self, cfg: Config, grid: Grid, cbcvel_eff):
        nx, ny, nz = cfg.ng
        self.cfg = cfg
        self.cbcvel = cbcvel_eff
        # wall flags: Dirichlet normal-component faces (sgs.f90:76-81)
        self.wall_flags = {}
        self.lwm_flags = {}
        for idir in range(3):
            for ib in range(2):
                self.wall_flags[(ib, idir)] = cbcvel_eff[ib][idir][idir] == 'D'
                self.lwm_flags[(ib, idir)] = cfg.lwm[ib][idir] != 0
        dzci = grid.dzci
        dzc = grid.dzc
        # z extrapolation factors (sgs.f90:705-717)
        self.fac_cbc = (1.0, 1.0)
        self.fac_lwm = (dzc[0] * dzci[1], dzc[nz] * dzci[nz - 1])
        # filter width Delta = (dx dy dzf)^(1/3) (sgs.f90:148)
        self.delta = (cfg.dl[0] * cfg.dl[1] * grid.dzf[1:nz + 1]) ** (1.0 / 3.0)
        # van Driest wall-distance profiles, 1D per wall
        dl = cfg.dl
        i = np.arange(1, nx + 1)
        j = np.arange(1, ny + 1)
        zc = grid.zc[1:nz + 1]
        self.dw1d = [
            (dl[0] * (i - 0.5), 2),          # x-low:  varies along axis 2
            (dl[0] * (nx - i + 0.5), 2),     # x-high
            (dl[1] * (j - 0.5), 1),          # y-low:  varies along axis 1
            (dl[1] * (ny - j + 0.5), 1),     # y-high
            (zc.copy(), 0),                  # z-low:  varies along axis 0
            (cfg.l[2] - zc, 0),              # z-high
        ]
        self.is_wall6 = [self.wall_flags[(ib, idir)]
                         for idir in range(3) for ib in range(2)]
        self.any_wall = any(self.is_wall6)

    def alph2_field(self, shape, dtype, device=None):
        """alpha^2 filter-ratio field (sgs.f90:769-822): of the 3D test
        filter 4.0 inside, 2.52 on the first off-wall layer; of the 2D
        test filter 2.52 everywhere."""
        if self.cfg.filter_2d:
            return torch.full(shape, 2.52, dtype=dtype, device=device)
        a = torch.full(shape, 4.0, dtype=dtype, device=device)
        for (ib, idir), axis in (((0, 0), 2), ((1, 0), 2), ((0, 1), 1),
                                 ((1, 1), 1), ((0, 2), 0), ((1, 2), 0)):
            if self.wall_flags[(ib, idir)]:
                a.select(axis, 0 if ib == 0 else -1).fill_(2.52)
        return a


def _wall_tauw_planes(setup, up, vp, wp, dxi, dyi, dzci, visc):
    """|tau_w| estimate at each of the 6 walls from one-sided gradients
    (sgs.f90:117-143), shaped to broadcast against (nz, ny, nx)."""
    nz = up.shape[0] - 2
    out = []
    # x-low / x-high: gradients of v, w across the first/last x faces
    t1 = vp[1:-1, 1:-1, 1] - vp[1:-1, 1:-1, 0] + vp[1:-1, 0:-2, 1] - vp[1:-1, 0:-2, 0]
    t2 = wp[1:-1, 1:-1, 1] - wp[1:-1, 1:-1, 0] + wp[0:-2, 1:-1, 1] - wp[0:-2, 1:-1, 0]
    out.append(torch.sqrt(t1 ** 2 + t2 ** 2)[:, :, None] * dxi)
    t1 = vp[1:-1, 1:-1, -2] - vp[1:-1, 1:-1, -1] + vp[1:-1, 0:-2, -2] - vp[1:-1, 0:-2, -1]
    t2 = wp[1:-1, 1:-1, -2] - wp[1:-1, 1:-1, -1] + wp[0:-2, 1:-1, -2] - wp[0:-2, 1:-1, -1]
    out.append(torch.sqrt(t1 ** 2 + t2 ** 2)[:, :, None] * dxi)
    # y-low / y-high: gradients of u, w
    t1 = up[1:-1, 1, 1:-1] - up[1:-1, 0, 1:-1] + up[1:-1, 1, 0:-2] - up[1:-1, 0, 0:-2]
    t2 = wp[1:-1, 1, 1:-1] - wp[1:-1, 0, 1:-1] + wp[0:-2, 1, 1:-1] - wp[0:-2, 0, 1:-1]
    out.append(torch.sqrt(t1 ** 2 + t2 ** 2)[:, None, :] * dyi)
    t1 = up[1:-1, -2, 1:-1] - up[1:-1, -1, 1:-1] + up[1:-1, -2, 0:-2] - up[1:-1, -1, 0:-2]
    t2 = wp[1:-1, -2, 1:-1] - wp[1:-1, -1, 1:-1] + wp[0:-2, -2, 1:-1] - wp[0:-2, -1, 1:-1]
    out.append(torch.sqrt(t1 ** 2 + t2 ** 2)[:, None, :] * dyi)
    # z-low / z-high: gradients of u, v, metric dzci(0) / dzci(nz)
    t1 = up[1, 1:-1, 1:-1] - up[0, 1:-1, 1:-1] + up[1, 1:-1, 0:-2] - up[0, 1:-1, 0:-2]
    t2 = vp[1, 1:-1, 1:-1] - vp[0, 1:-1, 1:-1] + vp[1, 0:-2, 1:-1] - vp[0, 0:-2, 1:-1]
    out.append((torch.sqrt(t1 ** 2 + t2 ** 2) * float(dzci[0]))[None, :, :])
    t1 = up[-2, 1:-1, 1:-1] - up[-1, 1:-1, 1:-1] + up[-2, 1:-1, 0:-2] - up[-1, 1:-1, 0:-2]
    t2 = vp[-2, 1:-1, 1:-1] - vp[-1, 1:-1, 1:-1] + vp[-2, 0:-2, 1:-1] - vp[-1, 0:-2, 1:-1]
    out.append((torch.sqrt(t1 ** 2 + t2 ** 2) * float(dzci[nz]))[None, :, :])
    return out


def smag_visct(setup: SGSSetup, cfg, grid, up, vp, wp):
    """Static Smagorinsky with van Driest damping (sgs.f90:69-152) on
    padded fields; returns the interior (nz, ny, nx) nu_t."""
    dxi, dyi = cfg.dli[0], cfg.dli[1]
    visc = cfg.visc
    like = up
    ue = extrapolate(up, 1, setup.lwm_flags, setup.fac_lwm)
    ve = extrapolate(vp, 2, setup.lwm_flags, setup.fac_lwm)
    we = extrapolate(wp, 3, setup.lwm_flags, setup.fac_lwm)
    s0 = st.strain_rate(ue, ve, we, grid.dzci, grid.dzfi, dxi, dyi)

    def prof(a, shape):
        return torch.as_tensor(a, dtype=like.dtype,
                               device=like.device).reshape(shape)
    delta = prof(setup.delta, (-1, 1, 1))
    if not setup.any_wall:
        fd = 1.0
    else:
        tauw6 = _wall_tauw_planes(setup, up, vp, wp, dxi, dyi, grid.dzci, visc)
        active = [m for m in range(6) if setup.is_wall6[m]]
        axes = {setup.dw1d[m][1] for m in active}
        if len(axes) == 1:
            # walls along one direction (channel class): the nearest wall
            # is a static 1D choice along that axis
            ax = axes.pop()
            profs = np.stack([setup.dw1d[m][0] for m in active])
            near = np.argmin(profs, axis=0)
            dw_1d = profs[near, np.arange(profs.shape[1])]
            shape1 = [1, 1, 1]
            shape1[ax] = len(dw_1d)
            dw_min = prof(dw_1d, shape1)
            if len(active) == 1:
                tauw_s = torch.broadcast_to(tauw6[active[0]], s0.shape)
            else:
                mask = torch.as_tensor(near == 0,
                                       device=like.device).reshape(shape1)
                tauw_s = torch.where(mask,
                                     torch.broadcast_to(tauw6[active[0]], s0.shape),
                                     torch.broadcast_to(tauw6[active[1]], s0.shape))
        else:
            # general case (duct/cavity): running minimum over the walls,
            # first minimum wins ties (sgs.f90:104-146)
            dw_min = torch.full_like(s0, 1e30)
            tauw_s = torch.zeros_like(s0)
            for m in active:
                p1, ax = setup.dw1d[m]
                shape1 = [1, 1, 1]
                shape1[ax] = len(p1)
                dw_m = torch.broadcast_to(prof(p1, shape1), s0.shape)
                closer = dw_m < dw_min
                tauw_s = torch.where(closer,
                                     torch.broadcast_to(tauw6[m], s0.shape),
                                     tauw_s)
                dw_min = torch.minimum(dw_min, dw_m)
        tauw_s = 0.5 * visc * tauw_s
        dw_plus = dw_min * torch.sqrt(tauw_s) / visc
        fd = 1.0 - torch.exp(-dw_plus / 25.0)
    return (C_SMAG * delta * fd) ** 2 * s0


def dsmag_unsupported(cfg):
    """The dynamic-model variants this port does not run yet, each with the
    ROADMAP item that brings it."""
    out = []
    ywalls = any(cfg.cbcvel[ib][1][1] == 'D' for ib in range(2))
    if cfg.filter_2d and ywalls:
        out.append('the 2D test filter (filter_2d) with y walls (A\'s y '
                   'ghosts take the SGS fill there, not the dsmag kernels\' '
                   'wall extrapolation): ROADMAP queue 1, dsmag classes, '
                   'filter_2d with y walls')
    return out


def dsmag_visct(setup: SGSSetup, cfg, grid, up, vp, wp, bcs_vals,
                pad_vel_fn):
    """Dynamic Smagorinsky (Germano-Lilly, sgs.f90:153-380) on padded
    fields, with the average of cfg.dsmag_avg: 'dit' the dzf-weighted mean
    over the volume (ave0d_dit, sgs.f90:388-431), 'channel' over each z
    plane (ave1d_channel), 'duct' over x for each (z, y) row (ave2d_duct,
    sgs.f90:540-614), 'cavity' none; the 3D test filter, or with
    cfg.filter_2d the 2D one in the x-y planes (sgs.f90:824-848: no
    extrapolation at the walls, alpha^2 = 2.52); the term order is
    cales_tpu/sgs.py's.

    bcs_vals: the SGS scalar's BC values (boundp of the products);
    pad_vel_fn(u, v, w) applies the filtered-velocity BC fill (bounduvw
    with the static planes, sgs.f90:256-257).  Returns the interior
    (nz, ny, nx) eddy viscosity, clipped at 0."""
    missing = dsmag_unsupported(cfg)
    if missing:
        raise NotImplementedError('; '.join(missing))
    dxi, dyi = cfg.dli[0], cfg.dli[1]
    dzci, dzfi = grid.dzci, grid.dzfi
    dl, dzc = cfg.dl[:2], grid.dzc
    cbcs = tuple((cfg.cbcsgs[0][d], cfg.cbcsgs[1][d]) for d in range(3))
    walls, fac = setup.wall_flags, setup.fac_cbc
    use2d = cfg.filter_2d
    filt = st.filter2d if use2d else st.filter3d

    def boundp(f):
        return bnd.pad_scalar(f, cbcs, bcs_vals, dl, dzc)

    def ext(q, iface=0):
        # the 2D filter reads no ghost across a wall: no extrapolation
        return q if use2d else extrapolate(q, iface, walls, fac)

    # grid-level strain rate (the wall-model extrapolation is the identity
    # without a wall model, which unsupported() refuses with dsmag)
    s0, sij = st.strain_rate(up, vp, wp, dzci, dzfi, dxi, dyi, with_sij=True)

    # filtered |S| Sij (sgs.f90:189-223)
    s0p = boundp(s0)
    mij = [filt(ext(s0p * boundp(q))) for q in sij]

    # filtered velocity, its BC fill and the test-level strain
    # (sgs.f90:225-272)
    ufi = filt(ext(up, 1))
    vfi = filt(ext(vp, 2))
    wfi = filt(ext(wp, 3))
    ufp, vfp, wfp = pad_vel_fn(ufi, vfi, wfi)
    s0f, sijf = st.strain_rate(ufp, vfp, wfp, dzci, dzfi, dxi, dyi,
                               with_sij=True)
    alph2 = setup.alph2_field(s0.shape, s0.dtype, s0.device)
    mij = [2.0 * (m - alph2 * s0f * sf) for m, sf in zip(mij, sijf)]

    # Leonard term Lij (sgs.f90:274-327)
    uc, vc, wc = st.interp_center(up, vp, wp)
    ucp, vcp, wcp = boundp(uc), boundp(vc), boundp(wc)
    pairs = [(ucp, ucp), (vcp, vcp), (wcp, wcp), (ucp, vcp), (ucp, wcp),
             (vcp, wcp)]
    lij = [filt(ext(a * b)) for a, b in pairs]
    ucf, vcf, wcf = (filt(ext(q)) for q in (ucp, vcp, wcp))
    fpairs = [(ucf, ucf), (vcf, vcf), (wcf, wcf), (ucf, vcf), (ucf, wcf),
              (vcf, wcf)]
    lij = [q - a * b for q, (a, b) in zip(lij, fpairs)]

    # contraction + the homogeneous-direction average (sgs.f90:328-370)
    num = sum(m * q for m, q in zip(mij[:3], lij[:3])) \
        + 2.0 * sum(m * q for m, q in zip(mij[3:], lij[3:]))
    den = sum(m * m for m in mij[:3]) + 2.0 * sum(m * m for m in mij[3:])
    if cfg.dsmag_avg == 'dit':
        nz, ny, nx = s0.shape
        wz = torch.as_tensor(grid.dzf[1:nz + 1] / cfg.l[2], dtype=s0.dtype,
                             device=s0.device)[:, None, None] / (ny * nx)
        num = torch.sum(num * wz)
        den = torch.sum(den * wz)
    dims = {'channel': (1, 2), 'duct': (2,)}.get(cfg.dsmag_avg)
    if dims is not None:
        num = torch.mean(num, dim=dims, keepdim=True)
        den = torch.mean(den, dim=dims, keepdim=True)
    return torch.clamp_min(s0 * num / den, 0.0)
