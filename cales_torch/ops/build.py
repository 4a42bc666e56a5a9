"""Build and load the CUDA kernels of cales_torch/csrc.

Each ``*.cu`` source compiles with its own nvcc process, all started
together, and the objects link into one shared library with a plain C
interface, loaded through ctypes (no PyTorch headers, so a build takes
seconds).  The library lands in ``cales_torch/_build/<hash>/``, keyed by a
hash of the sources and the compiler flags, at first use: a fresh checkout
builds everything on the first launch, later processes reuse the build.
Processes that start together (the ranks of a mesh) take a file lock on
``_build/<hash>.lock``: the first builds, the others wait and load its
library, so two nvcc runs never write one directory.

Each C entry launches on the stream it is given and returns
``cudaGetLastError()``; the wrappers in ops/kernels.py raise on non-zero.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / 'csrc'
BUILD_ROOT = Path(__file__).resolve().parents[1] / '_build'
LIBNAME = 'libcales_kernels.so'
ARCH = 'sm_90a'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC', '-lineinfo')
# threads per block of every kernel (csrc/common.cuh CALES_THREADS)
THREADS = 256

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_SIGNATURES = {
    # the pointers, nz, ny, nx, split, halo, xhalo, 8 coefficients
    'cales_mom_rk': [_P] * 43 + [_I] * 6 + [_D] * 8 + [_P],
    # mom_rk's pointers, the scalar's 9, nz, ny, nx, split, halo, xhalo,
    # 10 coefficients
    'cales_mom_rk_scal': [_P] * 52 + [_I] * 6 + [_D] * 10 + [_P],
    'cales_fillps': [_P] * 12 + [_I] * 5 + [_D] * 3 + [_P],
    'cales_correc_smag': ([_P] * 22 + [_I] * 4 + [_I, _D, _D] * 4
                          + [_D] * 4 + [_P]),
    'cales_correc': [_P] * 21 + [_I] * 7 + [_D] * 4 + [_P],
    'cales_apply_y': [_P] * 5 + [_I] * 3 + [_P],
    'cales_apply_x': [_P] * 3 + [_I] * 4 + [_P],
    'cales_z_eig': [_P] * 8 + [_I] * 3 + [_D] + [_P],
    'cales_thomas_z': [_P] * 10 + [_I] * 5 + [_D, _I, _D] + [_P],
    'cales_thomas_periodic': [_P] * 7 + [_I] * 4 + [_D, _I, _D] + [_P],
    'cales_smag': [_P] * 34 + [_I] * 6 + [_D] * 3 + [_P],
    # ... the y-row stacks, the halos, the x halos, nz, ny, nx, wall_lo,
    # wall_hi, avg, zper, f2d, ylo, yhi, then dxi, dyi, the values
    'cales_dsmag': [_P] * 30 + [_I] * 10 + [_D] * 10 + [_P],
    # ... the y-row stacks, the halos, the x halos, nz, ny, nx, wall_lo,
    # wall_hi, ylo, yhi, then dxi, dyi
    'cales_dsmag_level1': [_P] * 27 + [_I] * 7 + [_D] * 2 + [_P],
    # ... the y-row stacks, the halos, the x halos, nz, ny, nx, avg, ylo,
    # yhi, dxi, dyi
    'cales_dsmag_level2': [_P] * 42 + [_I] * 6 + [_D] * 2 + [_P],
    # the pointers (a slab's halo rows among them), nz, ny, nx, corrected,
    # cx, cy, the static WmArgs, a y-walled slab's walls ylo, yhi
    'cales_wallmodel': ([_P] * 9 + [_I] * 4 + [_D] * 2 + [_P] + [_I] * 2
                        + [_P]),
}


def sources(csrc=CSRC):
    return sorted(csrc.glob('*.cu')) + sorted(csrc.glob('*.cuh'))


def source_hash(csrc=CSRC, flags=()) -> str:
    h = hashlib.sha256(' '.join((*NVCC_FLAGS, *flags)).encode())
    for f in sources(csrc):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    cand = Path(home) / 'bin' / 'nvcc'
    if cand.exists():
        return str(cand)
    raise RuntimeError('nvcc not found (PATH or CUDA_HOME/bin): the CUDA '
                       'kernels of cales_torch build on a machine with the '
                       'CUDA toolkit')


def build(verbose: bool = False, csrc=CSRC, root=BUILD_ROOT,
          flags=()) -> Path:
    """Compile the library of the sources in csrc if their hash has no
    build under root yet; returns its path.  verbose prints nvcc's
    register/spill report; flags are nvcc flags added to NVCC_FLAGS (a
    probe's build, such as fma_probe's -fmad=false).  Concurrent callers
    serialise on a file lock beside the build directory."""
    out_dir = root / source_hash(csrc, flags)
    lib = out_dir / LIBNAME
    if lib.exists():
        return lib
    root.mkdir(parents=True, exist_ok=True)
    with open(out_dir.with_suffix('.lock'), 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib.exists():
            _compile(csrc, out_dir, lib, verbose, flags)
    return lib


def _compile(csrc, out_dir, lib, verbose, flags):
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    work = Path(tempfile.mkdtemp(dir=out_dir))
    try:
        # one nvcc per source, all running at once
        jobs = []
        for src in sorted(csrc.glob('*.cu')):
            obj = work / (src.stem + '.o')
            cmd = [nvcc, *NVCC_FLAGS, *flags, f'-I{csrc}', '-c', str(src),
                   '-o', str(obj)]
            if verbose:
                cmd[1:1] = ['-Xptxas', '-v']
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for cmd, _, proc in jobs:
            out, _ = proc.communicate()
            logs.append(out)
            if proc.returncode != 0:
                failed.append(f'nvcc failed ({proc.returncode}):\n'
                              f'{" ".join(cmd)}\n{out}')
        if failed:
            raise RuntimeError('\n'.join(failed))
        tmp = work / LIBNAME
        cmd = [nvcc, *NVCC_FLAGS, *flags, '-shared', '-o', str(tmp),
               *(str(obj) for _, obj, _ in jobs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f'nvcc link failed ({res.returncode}):\n'
                               f'{" ".join(cmd)}\n{res.stdout}\n'
                               f'{res.stderr}')
        if verbose:
            print(''.join(logs) + res.stdout + res.stderr, flush=True)
            print(f'nvcc build ({len(jobs)} sources in parallel): '
                  f'{time.perf_counter() - t0:.1f} s', flush=True)
        os.replace(tmp, lib)    # atomic: a concurrent build never sees a
    finally:                    # partial file
        shutil.rmtree(work, ignore_errors=True)


def open_library(path) -> ctypes.CDLL:
    """A built kernel library with the argtypes of the entries it has (a
    build of other sources may lack some)."""
    lib = ctypes.CDLL(str(path))
    for base, argtypes in _SIGNATURES.items():
        for suffix in ('f32', 'f64'):
            fn = getattr(lib, f'{base}_{suffix}', None)
            if fn is not None:
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
    fn = getattr(lib, 'cales_mom_rk_blocks', None)
    if fn is not None:
        fn.argtypes = [_I] * 3
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def load() -> ctypes.CDLL:
    """The loaded kernel library (built at first use), with argtypes set."""
    lib = open_library(build())
    lib.cales_threads_per_block.restype = ctypes.c_int
    lib.cales_threads_per_block.argtypes = []
    lib.cales_error_string.restype = ctypes.c_char_p
    lib.cales_error_string.argtypes = [ctypes.c_int]
    if lib.cales_threads_per_block() != THREADS:
        raise RuntimeError('csrc CALES_THREADS and build.THREADS disagree')
    return lib


def error_string(rc: int) -> str:
    return load().cales_error_string(rc).decode()
