"""smag's launch shape on the card: csrc/smag.cu built with other float32
tiles (rows TY of the (y, x) tile, rows RPT a thread), other register caps
(the blocks an SM, MINB) and other z chunking (the blocks a launch aims
at, SM_BLOCKS; 1: each tile marches all of z), timed against the build as
it is.

    python -m cales_torch.tile_probe [--ng 512x256x256,512x128x256]
                                     [--reps 20]

Each build edits smag.cu at anchors the probe checks, and builds smag.cu
alone.  Each times smag on the same random f32 inputs at each --ng (the
headline field, and a rank's slab of it on a two-rank y mesh), periodic
in y and with random halos (CUDA events, the mean of --reps calls after a
warm-up; the build as it is first and last), and is checked bitwise
against the build as it is (the arithmetic of a cell depends on neither
the tile nor the chunks).  Prints one JSON line.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from .ops import build
from .ops import kernels as K

SOURCES = ('common.cuh', 'common.cu', 'smag.cu')
_TY = '  static constexpr int TY = sizeof(T) == 4 ? 16 : 8;\n'
_RPT = '  static constexpr int RPT = sizeof(T) == 4 ? 2 : 1;\n'
_MINB = '  static constexpr int MINB = sizeof(T) == 4 ? 1024 / NT : 2;\n'
_BLOCKS = 'constexpr int SM_BLOCKS = 2048;\n'


def _edits(ty=None, rpt=None, minb=None, blocks=None):
    """The (anchor, replacement) pairs of a build: float32 TY, RPT, MINB
    and SM_BLOCKS, each as it is where None."""
    out = []
    for anchor, old, new in ((_TY, '16', ty), (_RPT, '2', rpt),
                             (_MINB, '1024 / NT', minb),
                             (_BLOCKS, '2048', blocks)):
        if new is not None:
            out.append((anchor, anchor.replace(old, str(new), 1)))
    return out


BUILDS = {'as is': [], 'one chunk': _edits(blocks=1),
          'blocks 1024': _edits(blocks=1024),
          'blocks 4096': _edits(blocks=4096),
          '16x32 1': _edits(rpt=1), '8x32 1': _edits(ty=8, rpt=1),
          '16x32 4': _edits(rpt=4), '32x32 2': _edits(ty=32),
          '5 blocks an SM': _edits(minb=5)}


def _library(name, edits, root):
    csrc = root / name.replace(' ', '_') / 'csrc'
    csrc.mkdir(parents=True)
    for f in SOURCES:
        shutil.copy(build.CSRC / f, csrc / f)
    text = (csrc / 'smag.cu').read_text()
    for anchor, new in edits:
        if text.count(anchor) != 1:
            raise RuntimeError(f'tile_probe {name!r}: the anchor '
                               f'{anchor.strip()!r} is not in smag.cu once')
        text = text.replace(anchor, new)
    (csrc / 'smag.cu').write_text(text)
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


def _inputs(ng):
    nx, ny, nz = ng
    gen = torch.Generator(device='cuda').manual_seed(20261017)

    def rnd(*shape):
        return 0.02 * torch.randn(shape, generator=gen, device='cuda')
    dz = 1.0 + 0.1 * torch.rand(nz + 2, generator=gen, device='cuda')
    prof = 1e-3 * (1.0 + torch.rand(nz, generator=gen, device='cuda'))
    return dict(f=[rnd(nz, ny, nx) for _ in range(3)],
                e=[rnd(3, ny, nx) for _ in range(3)],
                yh=[(rnd(nz, 2, nx), rnd(3, 2, nx)) for _ in range(3)],
                dz=dz, prof=prof,
                nearlo=(torch.arange(nz, device='cuda') < nz // 2).float(),
                tauw=[1e-2 * (1.0 + rnd(ny, nx)) for _ in range(2)])


def main(argv=None):
    ap = argparse.ArgumentParser(prog='cales_torch.tile_probe')
    ap.add_argument('--ng', default='512x256x256,512x128x256')
    ap.add_argument('--reps', type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('tile_probe needs a CUDA device', file=sys.stderr)
        return 2
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    res = dict(card=card, ms={}, bitwise={})
    real_load = build.load
    try:
        with tempfile.TemporaryDirectory() as tmpdir:
            libs = {name: _library(name, edits, Path(tmpdir))
                    for name, edits in BUILDS.items()}
            for ngs in args.ng.split(','):
                ng = tuple(int(x) for x in ngs.lower().split('x'))
                d = _inputs(ng)

                def run(name, halo):
                    build.load = lambda: libs[name]   # noqa: E731
                    return K.smag(*d['f'], *d['e'], d['dz'], d['dz'], 40.0,
                                  20.0, 5e-5, d['prof'], d['prof'],
                                  d['nearlo'], *d['tauw'],
                                  yh=d['yh'] if halo else None)
                for halo in (False, True):
                    mode = f'{ngs} {"halo" if halo else "periodic"}'
                    ref = run('as is', halo)
                    for name in BUILDS:
                        res['bitwise'][f'{name} {mode}'] = torch.equal(
                            run(name, halo), ref)
                    for name in (*BUILDS, 'as is'):
                        res['ms'].setdefault(f'{name} {mode}', []).append(
                            _time_ms(lambda: run(name, halo), args.reps))
                del d
    finally:
        build.load = real_load
    print(json.dumps({'tile_probe': res}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
