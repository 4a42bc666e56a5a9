"""ctypes loader for the native C++ I/O engine (native/io_engine.cpp).

Builds the shared library on first use if the prebuilt one is missing (the
analogue of the reference's `make libs` step for 2decomp/cuDecomp,
dependencies/external.mk).  All users degrade gracefully to pure numpy I/O
when no C++ toolchain is available.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
_SRC = _REPO / 'native' / 'io_engine.cpp'
_SO = _REPO / 'native' / 'build' / 'libcales_io.so'

_engine = None
_tried = False


def _build() -> bool:
    try:
        subprocess.run(['make', '-C', str(_REPO / 'native')], check=True,
                       capture_output=True)
        return _SO.exists()
    except Exception:
        return False


def engine():
    """Return the loaded ctypes library, or None if unavailable."""
    global _engine, _tried
    if _engine is not None or _tried:
        return _engine
    _tried = True
    if not _SO.exists() and _SRC.exists():
        _build()
    if not _SO.exists():
        return None
    try:
        lib = ctypes.CDLL(str(_SO))
        lib.ce_open.restype = ctypes.c_int
        lib.ce_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.ce_pwrite_threaded.restype = ctypes.c_int
        lib.ce_pwrite_threaded.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                           ctypes.c_size_t, ctypes.c_size_t,
                                           ctypes.c_int]
        lib.ce_pread_threaded.restype = ctypes.c_int
        lib.ce_pread_threaded.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                          ctypes.c_size_t, ctypes.c_size_t,
                                          ctypes.c_int]
        lib.ce_close.argtypes = [ctypes.c_int]
        if lib.ce_version() != 1:
            return None
        _engine = lib
    except OSError:
        return None
    return _engine


def write_fields(lib, path, arrays, nthreads: int = 8):
    """Write arrays back-to-back with threaded pwrite."""
    fd = lib.ce_open(str(path).encode(), 1)
    if fd < 0:
        raise OSError(-fd, os.strerror(-fd), str(path))
    try:
        off = 0
        for a in arrays:
            a = np.ascontiguousarray(a)
            rc = lib.ce_pwrite_threaded(
                fd, a.ctypes.data_as(ctypes.c_void_p), a.nbytes, off, nthreads)
            if rc < 0:
                raise OSError(-rc, os.strerror(-rc), str(path))
            off += a.nbytes
    finally:
        lib.ce_close(fd)


def read_into(lib, path, array, offset: int = 0, nthreads: int = 8):
    """Read bytes at `offset` into a preallocated contiguous array."""
    fd = lib.ce_open(str(path).encode(), 0)
    if fd < 0:
        raise OSError(-fd, os.strerror(-fd), str(path))
    try:
        rc = lib.ce_pread_threaded(
            fd, array.ctypes.data_as(ctypes.c_void_p), array.nbytes,
            offset, nthreads)
        if rc < 0:
            raise OSError(-rc, os.strerror(-rc), str(path))
    finally:
        lib.ce_close(fd)
