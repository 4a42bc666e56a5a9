"""CLI entry point: ``python -m cales_torch [input.nml] [--datadir DIR]
[--dtype float32|float64] [--max-steps N] [--device cuda|cpu]``.

The default device is cuda; without a card the run stops with an error.
``--device cpu`` runs the kernels' plain PyTorch twins instead."""
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
    ap.add_argument('--max-steps', type=int, default=None,
                    help='cap the number of steps')
    ap.add_argument('--device', default='cuda',
                    help="torch device: 'cuda' (default, the CUDA kernels), "
                         "'cuda:N', or 'cpu' (the plain twins)")
    args = ap.parse_args(argv)

    from .nml import config_from_nml
    from .driver import run

    overrides = {}
    if args.dtype:
        overrides['dtype'] = args.dtype
    cfg = config_from_nml(args.input, **overrides)
    run(cfg, datadir=args.datadir, device=args.device,
        max_steps=args.max_steps)
    return 0


if __name__ == '__main__':
    sys.exit(main())
