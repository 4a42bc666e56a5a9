"""Where the wall-model kernel's time goes on the card: csrc/wallmodel.cu
built as it is and with its work cut back (a constant stored, no samples
and no Newton loop: the launch and the store; the samples and no Newton
loop), with its warp exit cut out (12 steps always), with the accurate
float32 logarithm and divisions in the Newton step, and held to 8 blocks
an SM, timed against the build as it is.

    python -m cales_torch.wm_probe [--ng 512x256x256] [--reps 20]

Each build edits wallmodel.cu at anchors the probe checks, and builds it
alone.  Each runs the wall model of both log-law z faces (bench.py's hwm
and visci, interpolation rows 0/1 and nz-1/nz-2) on float32 rows of a
bulk flow (1 + u, u random, 'bulk') and on rows whose |u_par| spans 1e-8
to past Re_h = 1e6 point by point ('mixed'), corrected by pp ('corrected')
and as they are ('rows'); and the four faces of the wall-modelled duct
(examples/turbulent_duct_wmles's walls and hwm at --ng, its y faces
sampling u and w along y) on a bulk flow as it is ('four faces rows').
Times: the device time of a CUDA graph of --reps calls, the build as it
is first and last.  Errors: each build's planes against the float32 and
the float64 twin (wm_planes_plain on the same rows), the worst plane's
max|err| / max|twin|.  Prints one JSON line.  Needs a CUDA device.
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

from . import wallmodel as wmod
from .ab_dsmag import graph_ms
from .ops import build
from .ops import kernels as K

SOURCES = ('common.cuh', 'common.cu', 'wallmodel.cu')
_SAMPLES = ("  // The samples of rows r1, r2 at this lane's column: its own "
            "component\n")
_STORE = ('  if (mine_lane && i < px && j < pn)\n'
          '    out[f.off + (static_cast<int64_t>(comp) * pn + j) * px + i] = '
          'f.mag[comp];\n  return;\n')
_NEWTON = '    const T utau = wm_utau(upar, on, c);\n'
_VOTE = '    if (__all_sync(0xffffffffu, done)) break;\n'
_LOG = 'float wm_log(float x) { return __logf(x); }\n'
_DIV = '  return __fdividef(a, b);\n'
_BOUNDS = ('__global__ void __launch_bounds__(CALES_THREADS)\n'
           '    wallmodel_kernel(')
_ACCURATE = [(_LOG, _LOG.replace('__logf', 'logf')),
             (_DIV, '  return a / b;\n')]
BUILDS = {'as is': [], 'store only': [(_SAMPLES, _STORE + _SAMPLES)],
          'no Newton': [(_NEWTON, '    const T utau = upar;\n')],
          'no exit': [(_VOTE, '')], 'accurate log and div': _ACCURATE,
          '8 blocks an SM': [(_BOUNDS, _BOUNDS.replace(
              '(CALES_THREADS)', '(CALES_THREADS, 8)'))]}


def _library(name, edits, root):
    csrc = root / name.replace(' ', '_') / 'csrc'
    csrc.mkdir(parents=True)
    for f in SOURCES:
        shutil.copy(build.CSRC / f, csrc / f)
    text = (csrc / 'wallmodel.cu').read_text()
    for anchor, new in edits:
        if text.count(anchor) != 1:
            raise RuntimeError(f'wm_probe {name!r}: the anchor '
                               f'{anchor.strip()!r} is not in wallmodel.cu '
                               'once')
        text = text.replace(anchor, new)
    (csrc / 'wallmodel.cu').write_text(text)
    return build.open_library(build.build(csrc=csrc, root=csrc.parent / 'b'))


def _duct_wm(ng):
    """The wall model of the duct WMLES example's four walls at ng."""
    from .config import Config
    from .grid import make_grid_from_config
    bcs = dict(cbcvel=((('P', 'P', 'P'), ('D', 'D', 'D'),
                        ('D', 'D', 'D')),) * 2,
               cbcpre=(('P', 'N', 'N'),) * 2, cbcsgs=(('P', 'D', 'D'),) * 2)
    cfg = Config(ng=ng, l=(12.8, 2.0, 2.0), gtype=1, gr=0.0,
                 visci=20_000.0, sgstype='smag', lwm=((0, 1, 1), (0, 1, 1)),
                 hwm=0.1, **bcs)
    grid = make_grid_from_config(cfg)
    return wmod.wall_model(cfg, grid, wmod.find_index_wm(cfg, grid))


def _inputs(ng, rows):
    nx, ny, nz = ng
    gen = torch.Generator(device='cuda').manual_seed(20261017)

    def rnd(scale=0.02):
        return scale * torch.randn((nz, ny, nx), generator=gen,
                                   device='cuda')
    if rows == 'four faces':
        return dict(u=1.0 + rnd(), v=rnd(), w=rnd(), wm=_duct_wm(ng))

    def spread(lo, hi):
        # magnitudes 10^[lo, hi) point by point, random signs
        mag = 10.0 ** (lo + (hi - lo) * torch.rand(
            (nz, ny, nx), generator=gen, device='cuda'))
        return torch.where(rnd() < 0, -mag, mag)
    if rows == 'bulk':
        u, v = 1.0 + rnd(), rnd()
    else:
        u, v = spread(-8, 2.7), spread(-8, 2.7)
    fuv = torch.tensor([0.05, -0.02], device='cuda')
    return dict(u=u, v=v, w=None, pp=rnd(), fuv=fuv,
                wm=wmod.channel_z_faces(nz))


def _mode(d, mode):
    return (dict(w=d['w']) if mode == 'rows' else
            dict(fuv=d['fuv'], pp=d['pp'], dtrk=0.01, dxi=40.0, dyi=20.0))


def _rel(got, ref):
    return max(float((g.double() - r.double()).abs().max()
                     / r.double().abs().max().clamp_min(1e-300))
               for gf, rf in zip(got, ref) for g, r in zip(gf, rf))


def main(argv=None):
    ap = argparse.ArgumentParser(prog='cales_torch.wm_probe')
    ap.add_argument('--ng', default='512x256x256')
    ap.add_argument('--reps', type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('wm_probe needs a CUDA device', file=sys.stderr)
        return 2
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    ng = tuple(int(x) for x in args.ng.lower().split('x'))
    res = dict(card=card, ng=ng, graph_ms={}, rel_f32_twin={},
               rel_f64_twin={})
    real_load = build.load
    try:
        with tempfile.TemporaryDirectory() as tmpdir:
            libs = {name: _library(name, edits, Path(tmpdir))
                    for name, edits in BUILDS.items()}
            for rows in ('bulk', 'mixed', 'four faces'):
                d = _inputs(ng, rows)
                d64 = {k: q.double() if torch.is_tensor(q) else q
                       for k, q in d.items()}
                modes = (('rows',) if rows == 'four faces'
                         else ('corrected', 'rows'))
                for mode in modes:
                    key = f'{rows} {mode}'
                    kw, kw64 = _mode(d, mode), _mode(d64, mode)
                    twin = wmod.wm_planes_plain(d['u'], d['v'], d['wm'], **kw)
                    twin64 = wmod.wm_planes_plain(d64['u'], d64['v'],
                                                  d['wm'], **kw64)

                    def run(name):
                        build.load = lambda: libs[name]   # noqa: E731
                        return K.wm_planes(d['u'], d['v'], d['wm'], **kw)
                    for name in BUILDS:
                        got = run(name)
                        res['rel_f32_twin'][f'{name} {key}'] = _rel(got, twin)
                        res['rel_f64_twin'][f'{name} {key}'] = _rel(got,
                                                                    twin64)
                    for name in (*BUILDS, 'as is'):
                        res['graph_ms'].setdefault(f'{name} {key}', []).append(
                            graph_ms(lambda: run(name), args.reps))
                del d, d64
    finally:
        build.load = real_load
    print(json.dumps({'wm_probe': res}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
