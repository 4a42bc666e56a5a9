"""The one-pass dsmag kernel of another checkout against this one's, on the
same card in one process: are their outputs bitwise equal, and how long
does each take?

    python -m cales_torch.ab_dsmag --baseline DIR [--ng 512x256x256]
                                   [--reps 10]

DIR holds another checkout's cales_torch/csrc (for example the parent
commit unpacked by git archive); its library builds under
DIR/cales_torch/_build.  Both libraries run through this checkout's
wrapper, kernels.dsmag, on the same seeded random inputs: the 'channel'
average without y walls, 'duct' and 'cavity' with them.  Outputs are
compared in float64 at (nx, ny, nz) = (72, 40, 48) and in float32 at --ng;
times are float32 at --ng, the mean of --reps calls after a warm-up (CUDA
events), taken in the order baseline, this, this, baseline.  Prints one
JSON line.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
from pathlib import Path

import torch

from .ops import build
from .ops import kernels as K


@contextlib.contextmanager
def _library(lib):
    """Launch the wrappers' kernels from `lib` inside the block."""
    saved = build.load
    build.load = lambda: lib
    try:
        yield
    finally:
        build.load = saved


def _inputs(ng, dtype, seed):
    nx, ny, nz = ng
    gen = torch.Generator(device='cuda').manual_seed(seed)

    def rnd(*shape):
        return 0.02 * torch.randn(shape, generator=gen, device='cuda',
                                  dtype=dtype)
    f = [rnd(nz, ny, nx) for _ in range(3)]
    e = [rnd(3, ny, nx) for _ in range(3)]
    ye = [(rnd(nz, 3, nx), rnd(3, 3, nx)) for _ in range(3)]
    alph2 = torch.full((nz,), 4.0, dtype=dtype, device='cuda')
    alph2[0] = alph2[-1] = 2.52
    dz = 1.0 + 0.1 * torch.rand(nz + 2, generator=gen, device='cuda',
                                dtype=dtype)
    return f, e, ye, alph2, dz


def _call(d, avg):
    f, e, ye, alph2, dz = d
    return K.dsmag(*f, *e, alph2, dz, dz, 40.0, 20.0, True, True,
                   (0.0, 0.02, 0.0, -0.01),
                   ye=None if avg == 'channel' else ye,
                   yvals=(0.2, 0.0, -0.1, 0.3), avg=avg)


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
    ap = argparse.ArgumentParser(prog='cales_torch.ab_dsmag')
    ap.add_argument('--baseline', required=True, type=Path)
    ap.add_argument('--ng', default='512x256x256')
    ap.add_argument('--reps', type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('ab_dsmag needs a CUDA device', file=sys.stderr)
        return 2
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    base_dir = args.baseline.resolve()
    libs = {'baseline': build.open_library(build.build(
                csrc=base_dir / 'cales_torch' / 'csrc',
                root=base_dir / 'cales_torch' / '_build')),
            'this': build.load()}
    ng = tuple(int(x) for x in args.ng.lower().split('x'))
    out = dict(card=card, ng=ng, bitwise={}, ms={})
    for dtype, shape in ((torch.float64, (72, 40, 48)),
                         (torch.float32, ng)):
        d = _inputs(shape, dtype, 20261016)
        for avg in ('channel', 'duct', 'cavity'):
            res = {}
            for name, lib in libs.items():
                with _library(lib):
                    res[name] = [q for q in _call(d, avg) if q is not None]
            same = all(torch.equal(a, b)
                       for a, b in zip(res['baseline'], res['this']))
            out['bitwise'][f'{avg} {str(dtype)[6:]}'] = same
            if dtype == torch.float32:
                times = {name: [] for name in libs}
                for name in ('baseline', 'this', 'this', 'baseline'):
                    with _library(libs[name]):
                        times[name].append(_time_ms(
                            lambda: _call(d, avg), args.reps))
                out['ms'][avg] = times
            del res
        del d
        torch.cuda.empty_cache()
    print(json.dumps({'ab_dsmag': out}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
