"""Observability outputs: scalar logs, averaged profiles, plane/volume dumps.

Port of reference output.f90:
  * out0d (18-37): append a line of scalars to a log file
  * out1d (50-162): profile of a field averaged over the two homogeneous
    directions, any profile direction
  * out1d_chan (317-404): channel mean/RMS/shear-stress profiles
  * out2d (164-189) / out3d (191-242): raw binary plane / full-field dumps
  * write_log_output (244-272): visu log lines consumed by XDMF generators

Formats are binary-compatible with the reference's outputs so its
post-processing scripts keep working (SURVEY.md §2 "Post-processing & utils").
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from . import native


def out0d(fname, values):
    """Append one row of scalars (out0d, output.f90:18-37)."""
    with open(fname, 'a') as f:
        f.write(' '.join(f'{v:16.7e}' for v in values) + '\n')


def out1d(fname, grid, idir, f, lz=None):
    """Plane-averaged profile along direction idir (0=x,1=y,2=z), weighted by
    dzf for x/y profiles like the reference (output.f90:50-162).
    f: (nz, ny, nx) numpy array."""
    f = np.asarray(f)
    nz, ny, nx = f.shape
    dzf = grid.dzf[1:nz + 1]
    if idir == 2:
        prof = f.mean(axis=(1, 2))
        coord = grid.zc[1:nz + 1]
    elif idir == 1:
        prof = (f * dzf[:, None, None]).sum(axis=(0, 2)) / (nx * grid.lz)
        coord = (np.arange(ny) + 0.5) / ny
    else:
        prof = (f * dzf[:, None, None]).sum(axis=(0, 1)) / (ny * grid.lz)
        coord = (np.arange(nx) + 0.5) / nx
    with open(fname, 'w') as fh:
        for c, v in zip(coord, prof):
            fh.write(f'{c:16.7e} {v:16.7e}\n')


def out1d_chan(fname, grid, l, u, v, w):
    """Channel statistics profile: mean and second moments of u, v, w vs z
    (out1d_chan, output.f90:317-404).  Velocities are face values; u,v
    averaged over x,y planes; w reported at faces."""
    u, v, w = map(np.asarray, (u, v, w))
    nz = u.shape[0]
    zc = grid.zc[1:nz + 1]
    um = u.mean(axis=(1, 2))
    vm = v.mean(axis=(1, 2))
    wm = w.mean(axis=(1, 2))
    u2 = (u ** 2).mean(axis=(1, 2))
    v2 = (v ** 2).mean(axis=(1, 2))
    w2 = (w ** 2).mean(axis=(1, 2))
    # <u'w'> with w interpolated to cell centers
    wc = 0.5 * (w + np.concatenate([w[:1] * 0, w[:-1]], axis=0))
    uc = 0.5 * (u + np.roll(u, 1, axis=2))
    uw = (uc * wc).mean(axis=(1, 2)) - um * wm
    cols = np.stack([zc, um, vm, wm, u2 - um ** 2, v2 - vm ** 2,
                     w2 - wm ** 2, uw], axis=1)
    np.savetxt(fname, cols, fmt='%16.7e')


def write_field_bin(fname, f, nskip=(1, 1, 1)):
    """Raw binary dump in the reference's global Fortran order, keeping every
    nskip-th point per logical (x, y, z) direction (out3d /
    decomp_2d_write_every, output.f90:191-242)."""
    f = np.asarray(f)
    if f.ndim == 3 and tuple(nskip) != (1, 1, 1):
        f = f[::nskip[2], ::nskip[1], ::nskip[0]]
    f = np.ascontiguousarray(f)
    eng = native.engine()
    if eng is not None:
        native.write_fields(eng, fname, [f])
    else:
        f.tofile(fname)


def out2d(fname, f, norm_dir, islice):
    """Plane slice dump (out2d, output.f90:164-189).  norm_dir: 0=x,1=y,2=z
    (logical); islice: 0-based index along that direction."""
    f = np.asarray(f)
    ax = {0: 2, 1: 1, 2: 0}[norm_dir]
    sl = [slice(None)] * 3
    sl[ax] = islice
    write_field_bin(fname, f[tuple(sl)])


def write_log_output(logfile, fname, varname, nmin, nmax, nskip, time, istep):
    """Visu log line for the XDMF generators (output.f90:244-272)."""
    with open(logfile, 'a') as f:
        f.write(f'{fname} {varname} '
                f'{nmin[0]} {nmin[1]} {nmin[2]} '
                f'{nmax[0]} {nmax[1]} {nmax[2]} '
                f'{nskip[0]} {nskip[1]} {nskip[2]} '
                f'{time:15.6e} {istep}\n')


def write_grid_files(datadir, cfg, grid):
    """grid.bin / grid.out / geometry.out once at startup
    (main.f90:246-260)."""
    datadir = Path(datadir)
    nz = cfg.ng[2]
    with open(datadir / 'grid.bin', 'wb') as f:
        for arr in (grid.dzc[1:nz + 1], grid.dzf[1:nz + 1],
                    grid.zc[1:nz + 1], grid.zf[1:nz + 1]):
            np.asarray(arr).tofile(f)
    with open(datadir / 'grid.out', 'w') as f:
        for k in range(nz + 2):
            f.write(f'{0.0:16.7e}{grid.zf[k]:16.7e}{grid.zc[k]:16.7e}'
                    f'{grid.dzf[k]:16.7e}{grid.dzc[k]:16.7e}\n')
    with open(datadir / 'geometry.out', 'w') as f:
        f.write(f' {cfg.ng[0]} {cfg.ng[1]} {cfg.ng[2]}\n')
        f.write(f' {cfg.l[0]} {cfg.l[1]} {cfg.l[2]}\n')
