"""CLI entry point: ``python -m cales_torch [input.nml] [--datadir DIR]
[--dtype float32|float64] [--ptransform auto|fft|mat] [--max-steps N]
[--device cuda|cpu] [--transport nccl|gloo]``.

The default device is cuda; without a card the run stops with an error.
``--device cpu`` runs the kernels' plain PyTorch twins instead.  A
namelist with dims(1:2) = gy, gx runs on a mesh of gy gx ranks, one
process each (y slabs with gx = 1, pencils with gx > 1):

    python -m torch.distributed.run --nproc_per_node <gy gx> -m cales_torch \
        input.nml [--transport gloo]

over NCCL, a card a rank (the default on cuda), or gloo (the default on
the CPU; with cuda it stages the tensors through the host, so that the
ranks can share one card).  A world size that is not gy gx, or NCCL
with fewer cards than ranks, stops the run with an error.  ``--ptransform``
sets the Poisson solve's periodic transform, which the namelist does not
carry ('auto' takes 'mat' on a mesh and with y walls; 'fft' takes the
FFT along every periodic direction there too)."""
from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog='cales_torch',
        description='incompressible DNS/LES solver (CaLES-class), '
                    'PyTorch + CUDA port')
    ap.add_argument('input', nargs='?', default='input.nml',
                    help='namelist input file (reference-compatible)')
    ap.add_argument('--datadir', default='data', help='output directory')
    ap.add_argument('--dtype', default=None, choices=['float32', 'float64'],
                    help='override compute precision')
    ap.add_argument('--ptransform', default=None,
                    choices=['auto', 'fft', 'mat'],
                    help="override the periodic transform of the Poisson "
                         "solve (default: the config's, 'auto')")
    ap.add_argument('--max-steps', type=int, default=None,
                    help='cap the number of steps')
    ap.add_argument('--device', default='cuda',
                    help="torch device: 'cuda' (default, the CUDA kernels), "
                         "'cuda:N', or 'cpu' (the plain twins)")
    ap.add_argument('--transport', default=None, choices=['nccl', 'gloo'],
                    help='collectives of a dims mesh: nccl (a card a rank; '
                         'the default on cuda) or gloo (the default on the '
                         'CPU; CUDA tensors staged through the host)')
    args = ap.parse_args(argv)

    from .nml import config_from_nml
    from .driver import run

    overrides = {}
    if args.dtype:
        overrides['dtype'] = args.dtype
    if args.ptransform:
        overrides['ptransform'] = args.ptransform
    cfg = config_from_nml(args.input, **overrides)
    run(cfg, datadir=args.datadir, device=args.device,
        max_steps=args.max_steps, transport=args.transport)
    return 0


if __name__ == '__main__':
    sys.exit(main())
