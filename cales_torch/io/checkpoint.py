"""Checkpoint / restart I/O.

Binary-compatible with the reference's ``fld.bin`` (load.f90:20-153): a raw
stream of u, v, w, p in global Fortran order (x fastest) followed by a
2-real footer (time, istep).  Our (z, y, x) C-order arrays have exactly the
Fortran (x, y, z) column-major memory layout, so fields serialize with a
straight ``tofile``.  Restart validates the file size like the reference
(load.f90:44-52).

A native C++ engine (native/io_engine.cpp, loaded via ctypes) provides
O_DIRECT-free but threaded buffered writes for large fields — the counterpart
of the reference's MPI-IO collective path (load.f90:155-187); it degrades
gracefully to numpy if the shared library is absent.
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from . import native


def save_checkpoint(path, u, v, w, p, time: float, istep: int):
    """Write fld.bin-format checkpoint (load_all 'w', load.f90:101-152)."""
    u = np.asarray(u)
    dtype = u.dtype
    arrs = [np.asarray(a, dtype=dtype) for a in (u, v, w, p)]
    footer = np.array([time, float(istep)], dtype=dtype)
    eng = native.engine()
    if eng is not None:
        native.write_fields(eng, path, arrs + [footer])
        return
    with open(path, 'wb') as f:
        for a in arrs:
            a.tofile(f)
        footer.tofile(f)


def load_checkpoint(path, ng, dtype):
    """Read fld.bin-format checkpoint (load_all 'r'); returns
    (u, v, w, p, time, istep).  ng = (nx, ny, nz)."""
    nx, ny, nz = ng
    n = nx * ny * nz
    itemsize = np.dtype(dtype).itemsize
    expected = (4 * n + 2) * itemsize
    actual = os.path.getsize(path)
    if actual != expected:
        raise ValueError(
            f'checkpoint size mismatch: {actual} bytes, expected {expected} '
            f'for ng={ng} dtype={dtype} (load.f90:44-52 parity check)')
    raw = np.fromfile(path, dtype=dtype)
    fields = [raw[i * n:(i + 1) * n].reshape(nz, ny, nx) for i in range(4)]
    time = float(raw[4 * n])
    # nint() parity (load.f90: istep = nint(fldinfo(2))): float32 checkpoints
    # store istep inexactly beyond 2^24; truncation would restart one step off
    istep = int(round(float(raw[4 * n + 1])))
    return (*fields, time, istep)


def save_scalar(path, s, time: float, istep: int):
    """Sidecar checkpoint for the passive scalar (keeps fld.bin
    reference-compatible; the reference does not transport a scalar in its
    main loop, load.f90:111-151 saves only u,v,w,p)."""
    s = np.asarray(s)
    footer = np.array([time, float(istep)], dtype=s.dtype)
    eng = native.engine()
    if eng is not None:
        native.write_fields(eng, path, [s, footer])
        return
    with open(path, 'wb') as f:
        s.tofile(f)
        footer.tofile(f)


def load_scalar(path, ng, dtype):
    """Read the scalar sidecar; returns (s, time, istep) with the same size
    validation as load_checkpoint."""
    nx, ny, nz = ng
    n = nx * ny * nz
    itemsize = np.dtype(dtype).itemsize
    expected = (n + 2) * itemsize
    actual = os.path.getsize(path)
    if actual != expected:
        raise ValueError(
            f'scalar checkpoint size mismatch: {actual} bytes, expected '
            f'{expected} for ng={ng} dtype={dtype}')
    raw = np.fromfile(path, dtype=dtype)
    s = raw[:n].reshape(nz, ny, nx)
    return s, float(raw[n]), int(round(float(raw[n + 1])))


def gen_alias(datadir, filename, alias='fld.bin'):
    """Symlink alias to the latest checkpoint (output.f90:39-48)."""
    link = Path(datadir) / alias
    if link.is_symlink() or link.exists():
        link.unlink()
    link.symlink_to(filename)


def save_field_hdf5(path, name, f, time=0.0, istep=0, zc=None):
    """Optional HDF5 single-field output with grid/time metadata
    (io_field_hdf5, load.f90:537-673; gated on h5py availability like the
    reference's _USE_HDF5 build flag)."""
    try:
        import h5py
    except ImportError as e:
        raise RuntimeError('h5py not available; HDF5 output disabled') from e
    f = np.asarray(f)
    with h5py.File(path, 'w') as h:
        d = h.create_dataset(name, data=f)
        d.attrs['time'] = time
        d.attrs['istep'] = istep
        if zc is not None:
            h.create_dataset('zc', data=np.asarray(zc))


def load_field_hdf5(path, name):
    try:
        import h5py
    except ImportError as e:
        raise RuntimeError('h5py not available; HDF5 input disabled') from e
    with h5py.File(path, 'r') as h:
        d = h[name]
        return np.asarray(d), float(d.attrs.get('time', 0.0)), \
            int(d.attrs.get('istep', 0))
