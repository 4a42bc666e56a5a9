"""z-grid generation with all six stretching laws of the reference
(reference initgrid.f90:15-196).

Grid arrays are numpy float64 with ghost entries: index k in [0, n+1]
corresponds to the reference's 0:n+1 range.  zf[k] is the k-th cell face
(zf[0] = 0, zf[n] = lz), zc[k] the k-th cell center, dzf[k] = zf[k]-zf[k-1],
dzc[k] = zc[k+1]-zc[k].
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .config import Config


def _cluster_two_end(z0, alpha):
    if alpha != 0.0:
        return 0.5 * (1.0 + np.tanh((z0 - 0.5) * alpha) / np.tanh(alpha / 2.0))
    return z0


def _cluster_one_end(z0, alpha):
    if alpha != 0.0:
        return 1.0 * (1.0 + np.tanh((z0 - 1.0) * alpha) / np.tanh(alpha))
    return z0


def _cluster_one_end_r(z0, alpha):
    if alpha != 0.0:
        return 1.0 - (1.0 + np.tanh(((1.0 - z0) - 1.0) * alpha) / np.tanh(alpha))
    return z0


def _cluster_middle(z0, alpha):
    if alpha == 0.0:
        return z0
    return np.where(
        z0 <= 0.5,
        0.5 * (1.0 - 1.0 + np.tanh(2.0 * alpha * (z0 - 0.0)) / np.tanh(alpha)),
        0.5 * (1.0 + 1.0 + np.tanh(2.0 * alpha * (z0 - 1.0)) / np.tanh(alpha)),
    )


def _cluster_natural(kg, nzg):
    # Pirozzoli & Orlandi JCP 439-110408 (2021); initgrid.f90:165-196
    kb, alpha, c_eta, dyp = 32.0, np.pi / 1.5, 0.8, 0.05
    n = nzg / 2.0
    retau = 1.0 / (1.0 + (n / kb) ** 2) * (
        dyp * n + (0.75 * alpha * c_eta * n) ** (4.0 / 3.0) * (n / kb) ** 2)
    k = np.minimum(kg, nzg - kg).astype(np.float64)
    z = 1.0 / (1.0 + (k / kb) ** 2) * (
        dyp * k + (0.75 * alpha * c_eta * k) ** (4.0 / 3.0) * (k / kb) ** 2) / (2.0 * retau)
    return np.where(kg > nzg - kg, 1.0 - z, z)


def _cluster_wall_model(z0, nzg):
    # Larsson sine formula; initgrid.f90:152-164
    dzc = 0.1 * 32.0 / nzg
    return z0 - (dzc * nzg / 2.0 - 1.0) / (2.0 * np.pi) * np.sin(2.0 * np.pi * z0)


@dataclass(frozen=True)
class Grid:
    """1D z-grid with ghost entries (length n+2 arrays) + uniform x/y metrics."""
    n: int
    lz: float
    zc: np.ndarray    # (n+2,) cell centers, index 0..n+1
    zf: np.ndarray    # (n+2,) cell faces
    dzc: np.ndarray   # (n+2,) center-to-center spacing
    dzf: np.ndarray   # (n+2,) face-to-face spacing

    @property
    def dzci(self):
        return 1.0 / self.dzc

    @property
    def dzfi(self):
        return 1.0 / self.dzf


def make_grid(gtype: int, n: int, gr: float, lz: float) -> Grid:
    """Port of initgrid (initgrid.f90:15-81): faces -> spacings -> centers."""
    kk = np.arange(1, n + 1, dtype=np.float64)
    z0 = kk / n
    if gtype == 1:
        z = _cluster_two_end(z0, gr)
    elif gtype == 2:
        z = _cluster_one_end(z0, gr)
    elif gtype == 3:
        z = _cluster_one_end_r(z0, gr)
    elif gtype == 4:
        z = _cluster_middle(z0, gr)
    elif gtype == 5:
        z = _cluster_natural(kk, n)
    elif gtype == 6:
        z = _cluster_wall_model(z0, n)
    else:
        z = _cluster_two_end(z0, gr)

    zf = np.zeros(n + 2)
    zf[1:n + 1] = z * lz
    # spacings between faces, halo cells mirror first/last (initgrid.f90:60-64)
    dzf = np.zeros(n + 2)
    dzf[1:n + 1] = zf[1:n + 1] - zf[0:n]
    dzf[0] = dzf[1]
    dzf[n + 1] = dzf[n]
    # spacings between centers (initgrid.f90:68-71)
    dzc = np.zeros(n + 2)
    dzc[0:n + 1] = 0.5 * (dzf[0:n + 1] + dzf[1:n + 2])
    dzc[n + 1] = dzc[n]
    # rebuild centers and faces cumulatively (initgrid.f90:75-80)
    zc = np.zeros(n + 2)
    zc[0] = -dzc[0] / 2.0
    zf[0] = 0.0
    for k in range(1, n + 2):
        zc[k] = zc[k - 1] + dzc[k - 1]
        zf[k] = zf[k - 1] + dzf[k]
    return Grid(n=n, lz=lz, zc=zc, zf=zf, dzc=dzc, dzf=dzf)


def make_grid_from_config(cfg: Config) -> Grid:
    return make_grid(cfg.gtype, cfg.ng[2], cfg.gr, cfg.l[2])
