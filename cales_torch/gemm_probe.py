"""Where the time of the float32 GEMM of apply_y and apply_x goes
(csrc/gemm.cuh: 3xTF32 on wgmma, a producer warpgroup streaming the tiles
and splitting B, two consumer warpgroups splitting A and multiplying).

    python -m cales_torch.gemm_probe [--ng 512x256x256] [--reps 20]

Builds gemm.cuh with apply_y.cu four times: as it is, and with one part of
its work taken out by an edit of the source at an anchor the probe checks:
'no wgmma' (the tensor cores' products), 'no split' (the split of A and of
B into their TF32 halves; the wgmmas read whatever the split tiles hold),
'no loads' (the producer's cp.async copies; the splits read whatever the
raw stages hold).  The barriers and the epilogue stay in every build.  It
times apply_y with the x operator on random f32 inputs at --ng in each
(CUDA events, the mean of --reps calls after a warm-up; the kernel as it
is timed first and last), and checks the build as it is against cuBLAS.
The outputs of the other builds are meaningless: only their times count.
Prints one JSON line.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from .ops import build

SOURCES = ('common.cuh', 'common.cu', 'gemm.cuh', 'apply_y.cu')
_WGMMA = ('                                           uint64_t bd, int acc) '
          '{\n')
_SPLIT_A = ('  auto split_a = [&](int kt) {\n'
            '    bar_sync(BAR_RAW + (kt & 1), TCONS + TPROD);\n')
_SPLIT_B = ('      // B: (k, n) row-major -> K-major rows n; a lane takes 4 k '
            'of one n,\n')
_SPLIT_B_END = ('      asm volatile("fence.proxy.async.shared::cta;\\n" ::: '
                '"memory");\n      bar_arrive(BAR_FULL + b')
_LOAD = '    auto load = [&](int s, int k0) {\n'
# build -> [(anchor, replacement)]
EDITS = {
    'as is': [],
    'no wgmma': [(_WGMMA, _WGMMA + '  if (acc >= 0) return;\n')],
    'no split': [(_SPLIT_A, _SPLIT_A + '    if (kt >= 0) return;\n'),
                 (_SPLIT_B, '      if (kt >= 0) goto probe_no_split_b;\n'
                  + _SPLIT_B),
                 (_SPLIT_B_END, 'probe_no_split_b:\n' + _SPLIT_B_END)],
    'no loads': [(_LOAD, _LOAD + '      if (k0 >= 0) return;\n')],
}


def _library(name, edits, root):
    csrc = root / name.replace(' ', '_') / 'csrc'
    csrc.mkdir(parents=True)
    for f in SOURCES:
        shutil.copy(build.CSRC / f, csrc / f)
    text = (csrc / 'gemm.cuh').read_text()
    for anchor, new in edits:
        if text.count(anchor) != 1:
            raise RuntimeError(f'gemm_probe {name!r}: the anchor '
                               f'{anchor[:40]!r} is not in gemm.cuh once')
        text = text.replace(anchor, new)
    (csrc / 'gemm.cuh').write_text(text)
    return build.open_library(build.build(csrc=csrc, root=csrc.parent / 'b'))


def _time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main(argv=None):
    ap = argparse.ArgumentParser(prog='cales_torch.gemm_probe')
    ap.add_argument('--ng', default='512x256x256')
    ap.add_argument('--reps', type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('gemm_probe needs a CUDA device', file=sys.stderr)
        return 2
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    nx, ny, nz = (int(x) for x in args.ng.lower().split('x'))
    gen = torch.Generator(device='cuda').manual_seed(20261017)
    x = torch.randn((nz, ny, nx), generator=gen, device='cuda')
    M = torch.randn((ny, ny), generator=gen, device='cuda') / ny ** 0.5
    MxT = torch.randn((nx, nx), generator=gen, device='cuda') / nx ** 0.5
    tmp, out = torch.empty_like(x), torch.empty_like(x)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    res = dict(card=card, ng=(nx, ny, nz), ms={})
    with tempfile.TemporaryDirectory() as tmpdir:
        libs = {name: _library(name, edits, Path(tmpdir))
                for name, edits in EDITS.items()}

        def run(lib):
            rc = lib.cales_apply_y_f32(
                ptr(x), ptr(M), ptr(MxT), ptr(tmp), ptr(out), nz, ny, nx,
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
            if rc != 0:
                raise RuntimeError(f'cales_apply_y_f32: CUDA error {rc}')
        run(libs['as is'])
        torch.backends.cuda.matmul.allow_tf32 = False
        ref = torch.matmul(M, torch.matmul(x, MxT))
        res['as_is_vs_cublas'] = float((out - ref).abs().max()
                                       / ref.abs().max())
        res['cublas_ms'] = _time_ms(
            lambda: torch.matmul(M, torch.matmul(x, MxT)), args.reps)
        for name in (*EDITS, 'as is'):
            res['ms'].setdefault(name, []).append(
                _time_ms(lambda: run(libs[name]), args.reps))
    print(json.dumps({'gemm_probe': res}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
