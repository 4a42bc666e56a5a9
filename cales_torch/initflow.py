"""Initial velocity/pressure fields.

Port of reference initflow.f90:17-283: profile menu selected by the
``inivel`` string, reproducible decomposition-invariant noise
(initflow.f90:285-315), bulk-mean rescaling (317-338), and the
Henningson–Kim streamwise vortex pair wall-turbulence trigger (234-282).

Fields are numpy arrays in the (z, y, x) layout; initialization is a
host-side, setup-time operation (like the reference's rank-local loops).
"""
from __future__ import annotations

import numpy as np

from .config import Config
from .grid import Grid


def _couette(zc_n, norm):
    return 0.5 * (1.0 - 2.0 * zc_n) * norm


def _poiseuille(zc_n, norm):
    return 6.0 * zc_n * (1.0 - zc_n) * norm


def _temporal_bl(zc, d, nu, norm):
    theta = 54.0 * nu / norm
    return (0.5 + 0.5 * np.tanh(d / (2.0 * theta) * (1.0 - zc / d))) * norm


def _log_profile(zc_n, reb):
    retau = 0.09 * reb ** 0.88
    z = zc_n * 2.0 * retau
    z = np.where(z >= retau, 2.0 * retau - z, z)
    p = 2.5 * np.log(np.maximum(z, 1e-30)) + 5.5
    return np.where(z <= 11.6, z, p)


def add_noise(ng, seed: int, norm: float, field: np.ndarray) -> np.ndarray:
    """Reproducible seeded noise, decomposition-invariant by iterating the
    global index space (initflow.f90:285-315).  field: (nz, ny, nx)."""
    rng = np.random.default_rng(seed)
    # global draw in the reference's (i fastest, then j, then k) order
    rn = rng.random((ng[2], ng[1], ng[0]))
    return field + 2.0 * (rn - 0.5) * norm


def set_mean(field, w_z, mean):
    """Rescale to the target bulk mean (initflow.f90:317-338); w_z: (nz,)
    volume-ratio weights."""
    old = float((field * w_z[:, None, None]).sum())
    if old != 0.0:
        return field / old * mean
    return field


def initflow(cfg: Config, grid: Grid):
    """Returns (u, v, w, p) numpy arrays of shape (nz, ny, nx)."""
    nx, ny, nz = cfg.ng
    lz = cfg.l[2]
    visc = cfg.visc
    zc = grid.zc[1:nz + 1]
    zf = grid.zf[1:nz + 1]
    dzf = grid.dzf[1:nz + 1]
    xc = (np.arange(nx) + 0.5) * cfg.dl[0]
    xf = (np.arange(nx) + 1.0) * cfg.dl[0]
    yc = (np.arange(ny) + 0.5) * cfg.dl[1]
    yf = (np.arange(ny) + 1.0) * cfg.dl[1]

    u = np.zeros((nz, ny, nx))
    v = np.zeros((nz, ny, nx))
    w = np.zeros((nz, ny, nx))
    p = np.zeros((nz, ny, nx))

    uref = 1.0
    ubulk = cfg.velf[0] if cfg.is_forced[0] else uref
    is_noise = is_mean = False
    name = cfg.inivel.strip()

    def bcast_z(u1d):
        return np.broadcast_to(u1d[:, None, None], (nz, ny, nx)).copy()

    if name == 'cou':
        uref = cfg.bcvel[0][2][0] - cfg.bcvel[1][2][0]
        u = bcast_z(_couette(zc / lz, uref))
        uref = abs(uref)
    elif name == 'poi':
        u = bcast_z(_poiseuille(zc / lz, ubulk))
        is_mean = True
    elif name == 'tbl':
        u = bcast_z(_temporal_bl(zc, 1.0, visc, uref))
        is_noise = True
    elif name == 'iop':
        ubulk = 0.5 * abs(cfg.bcvel[0][2][0] + cfg.bcvel[1][2][0])
        u = bcast_z(_poiseuille(zc / lz, ubulk) - ubulk)
        is_mean = True
    elif name == 'zer':
        pass
    elif name == 'uni':
        u[:] = uref
    elif name == 'log':
        reb = ubulk * lz / visc
        u = bcast_z(_log_profile(zc / lz, reb))
        is_noise = is_mean = True
    elif name in ('hcl', 'hcp'):
        # half-channel: mirror-extended profile (initflow.f90:81-102)
        z2 = zc / (2.0 * lz)
        if name == 'hcl':
            reb = ubulk * 2.0 * lz / visc
            u = bcast_z(_log_profile(z2, reb))
            is_noise = True
        else:
            u = bcast_z(_poiseuille(z2, ubulk))
        is_mean = True
    elif name == 'tgv':
        zcc = (zc / lz * 2 * np.pi)[:, None, None]
        ycc = (yc / cfg.l[1] * 2 * np.pi)[None, :, None]
        yff = (yf / cfg.l[1] * 2 * np.pi)[None, :, None]
        xcc = (xc / cfg.l[0] * 2 * np.pi)[None, None, :]
        xff = (xf / cfg.l[0] * 2 * np.pi)[None, None, :]
        u = np.sin(xff) * np.cos(ycc) * np.cos(zcc) * uref
        v = -np.cos(xcc) * np.sin(yff) * np.cos(zcc) * uref
        w = np.zeros_like(u)
        p = np.zeros_like(u)
        u, v, w = np.broadcast_arrays(u, v, w)
        u, v, w = u.copy(), v.copy(), w.copy()
        p = np.zeros((nz, ny, nx))
    elif name == 'tgw':
        ycc, yff = yc[None, :, None], yf[None, :, None]
        xcc, xff = xc[None, None, :], xf[None, None, :]
        one_z = np.ones((nz, 1, 1))
        u = (np.cos(xff) * np.sin(ycc) * uref) * one_z
        v = (-np.sin(xcc) * np.cos(yff) * uref) * one_z
        w = np.zeros((nz, ny, nx))
        p = (-(np.cos(2 * xcc) + np.cos(2 * ycc)) / 4.0 * uref ** 2) * one_z
    elif name == 'ant':
        # Antuono JFM 890 A23 (initflow.f90:134-156)
        zcc = (zc / lz * 2 * np.pi + 0.5 * np.pi)[:, None, None]
        zff = (zf / lz * 2 * np.pi + 0.5 * np.pi)[:, None, None]
        ycc = (yc / cfg.l[1] * 2 * np.pi + 0.5 * np.pi)[None, :, None]
        yff = (yf / cfg.l[1] * 2 * np.pi + 0.5 * np.pi)[None, :, None]
        xcc = (xc / cfg.l[0] * 2 * np.pi + 0.5 * np.pi)[None, None, :]
        xff = (xf / cfg.l[0] * 2 * np.pi + 0.5 * np.pi)[None, None, :]
        A = 4.0 * np.sqrt(2.0) / (3.0 * np.sqrt(3.0)) * uref
        s, c, pi6 = np.sin, np.cos, np.pi / 6.0
        u = A * (s(xff - 5 * pi6) * c(ycc - pi6) * s(zcc)
                 - s(xff - pi6) * s(ycc) * c(zcc - 5 * pi6))
        v = A * (s(xcc) * s(yff - 5 * pi6) * s(zcc - pi6)
                 - c(xcc - 5 * pi6) * s(yff - pi6) * s(zcc))
        w = A * (c(xcc - pi6) * s(ycc) * s(zff - 5 * pi6)
                 - s(xcc) * c(ycc - 5 * pi6) * s(zff - pi6))
        p = -(u ** 2 + v ** 2 + w ** 2) / 2.0
    elif name in ('pdc', 'hdc'):
        lref = lz / 2.0 if name == 'pdc' else lz
        if cfg.is_wallturb:
            uref = (cfg.bforce[0] * lref) ** 0.5
            retau = uref * lref / visc
            reb = (retau / 0.09) ** (1.0 / 0.88)
            ubulk = reb * visc / (2 * lref)
        else:
            ubulk = cfg.bforce[0] * lref ** 2 / (3.0 * visc)
        zn = zc / lz if name == 'pdc' else zc / (2 * lz)
        u = bcast_z(_poiseuille(zn, ubulk))
        is_mean = True
    elif name == 'duc':
        # laminar duct profile (initflow.f90:181-202)
        ly, lzz = 0.5 * cfg.l[1], 0.5 * lz
        xi = -1.0 + (yc / ly)[None, :, None] * np.ones((nz, 1, 1))
        eta = (-1.0 + zc / lzz)[:, None, None] * np.ones((1, ny, 1))
        ssum = np.zeros((nz, ny, 1))
        for m in range(101):
            cosh_t = np.cosh((2 * m + 1) * np.pi * ly / (2 * lzz) * xi) \
                / np.cosh((2 * m + 1) * np.pi * ly / (2 * lzz))
            cos_t = np.cos((2 * m + 1) * np.pi / 2 * eta)
            ssum += (-1.0) ** m / (2 * m + 1) ** 3 * cosh_t * cos_t
        prof = 0.5 * lzz ** 2 * (1.0 - eta ** 2 - 4.0 * (2.0 / np.pi) ** 3 * ssum)
        u = np.broadcast_to(prof, (nz, ny, nx)).copy()
        is_mean = True
    else:
        raise ValueError(f'unknown initial velocity field {name!r}')

    if is_noise:
        u = add_noise(cfg.ng, 123, 0.05, u)
        v = add_noise(cfg.ng, 456, 0.05, v)
        w = add_noise(cfg.ng, 789, 0.05, w)
    if is_mean and name != 'iop':
        wz = dzf / (lz * nx * ny)  # per-cell weight dzf/lz * (dx/lx) * (dy/ly)
        u = set_mean(u, wz, ubulk)
    if cfg.is_wallturb:
        # streamwise vortex pair (Henningson & Kim, initflow.f90:234-282)
        zcc = (2.0 * zc / lz - 1.0)[:, None, None]
        zff = (2.0 * (zc / lz + 0.5 * dzf / lz) - 1.0)[:, None, None]
        ycn = ((yc - 0.5 * cfg.l[1]) * 2.0 / lz)[None, :, None]
        yfn = ((yf - 0.5 * cfg.l[1]) * 2.0 / lz)[None, :, None]
        xcn = ((xc - 0.5 * cfg.l[0]) * 2.0 / lz)[None, None, :]

        def fz(zc_):
            return (1.0 - zc_ ** 2) ** 2

        def dfz(zc_):
            return -4.0 * zc_ * (1.0 - zc_ ** 2)

        def gxy(x_, y_):
            return y_ * np.exp(-4.0 * (4.0 * x_ ** 2 + y_ ** 2))

        def dgxy(x_, y_):
            return np.exp(-4.0 * (4.0 * x_ ** 2 + y_ ** 2)) * (1.0 - 8.0 * y_ ** 2)

        v = (-gxy(yfn, xcn) * dfz(zcc) * ubulk * 1.5) * np.ones((nz, ny, nx))
        w = (fz(zff) * dgxy(ycn, xcn) * ubulk * 1.5) * np.ones((nz, ny, nx))
        p = np.zeros((nz, ny, nx))
    return u, v, w, p
