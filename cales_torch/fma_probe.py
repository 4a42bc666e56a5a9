"""Why do the f32 slab (halo) mom_rk and the periodic one differ from the
plain twin by different amounts on a developed field?  The probe tests
whether FMA contraction explains it.

    python -m cales_torch.fma_probe [--ng 512x256x256] [--steps 5]

Runs the LES headline on one card (static Smagorinsky with van Driest
damping, x-forced, stretched z walls, 'mat', f32: chip_smoke.py's
MESH_CFG without the mesh) for --steps steps from a seeded perturbation.
It then cuts the y slab [0, ny/2) with its halo rows, rows ny - 1 and
ny/2 of the whole field, and calls mom_rk three ways: the halo variant on
the slab, the periodic variant on the whole field, and the plain twin on
both.  The halo variant on the slab rows and the periodic variant on the
same rows of the whole field compute the same function of the same
numbers.  It does this with the library built as usual and with one built
under -fmad=false, which contracts no multiply-add into an FMA.

Prints one JSON line.  For each build and each output it gives:
  halo_edge      the halo variant against its twin, on slab rows 0 and
                 ny/2 - 1 (the rows that read the halos);
  halo_interior  the same on the other rows;
  periodic       the periodic variant against its twin, on the slab rows;
  halo_vs_periodic  the halo and the periodic variant on the slab rows.
Each is the largest |difference| over the output's largest |value|.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys

import numpy as np
import torch

from .config import Config
from .grid import make_grid_from_config
from .initflow import initflow
from .ops import build
from .ops import kernels as K
from .timeloop import Simulation

OUTPUTS = ('u', 'v', 'w', 'ru', 'rv', 'rw')
LES = dict(l=(2 * np.pi, np.pi, 2.0), gtype=1, gr=1.0, visci=20_000.0,
           inivel='log', is_wallturb=True, is_forced=(True, False, False),
           velf=(1.0, 0.0, 0.0), sgstype='smag', dtype='float32',
           ptransform='mat',
           cbcvel=((('P', 'P', 'P'), ('P', 'P', 'P'), ('D', 'D', 'D')),) * 2,
           cbcpre=(('P', 'P', 'N'), ('P', 'P', 'N')),
           cbcsgs=(('P', 'P', 'D'), ('P', 'P', 'D')))


@contextlib.contextmanager
def _library(lib):
    """Launch the wrappers' kernels from `lib` inside the block."""
    saved = build.load
    build.load = lambda: lib
    try:
        yield
    finally:
        build.load = saved


def _state(ng, steps, seed):
    cfg = Config(ng=ng, **LES)
    sim = Simulation(cfg, make_grid_from_config(cfg), device='cuda')
    rng = np.random.default_rng(seed)
    fields = [np.asarray(f) + (1e-2 * rng.standard_normal(np.shape(f))
                               ).astype(np.asarray(f).dtype)
              for f in initflow(cfg, sim.grid)]
    st = sim.initial_state(*fields)
    dt = sim.pick_dt(sim.check(st)[0])
    for _ in range(steps):
        st, _ = sim.step(st, dt)
    return sim, st, dt


def _args(sim, st, dt):
    """mom_rk's arguments on the whole field and on the slab [0, ny/2),
    and the slab's halo pairs, as phase 10 of chip_smoke.py passes them."""
    cfg = sim.cfg
    u, v, w, p, s = st.u, st.v, st.w, st.p, st.visct
    ue, ve, we = st.zq
    pe, se = sim._zedge_p(p), sim._zedge_s(s)
    ny = u.shape[1]
    nyl = ny // 2
    tail = (sim.dzci_t, sim.dzfi_t, 0.5 * dt, -0.2 * dt, cfg.visc,
            cfg.dli[0], cfg.dli[1], cfg.bforce)
    whole = (u, v, w, s, p, ue, ve, we, se, pe, *st.rhs_old)
    slab = tuple(a[:, :nyl].contiguous() for a in whole)
    halo = [tuple(torch.stack([a[:, ny - 1], a[:, nyl]], dim=1)
                  for a in pair)
            for pair in ((u, ue), (v, ve), (w, we), (s, se), (p, pe))]
    return (*whole, *tail), (*slab, *tail), halo, nyl


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _compare(whole, slab, halo, nyl):
    kw = dict(sums=(True, False))
    got_h = K.mom_rk(*slab, yh=halo, **kw)[:6]
    ref_h = K.mom_rk_plain(*slab, yh=halo, **kw)[:6]
    got_p = [q[:, :nyl] for q in K.mom_rk(*whole, **kw)[:6]]
    ref_p = [q[:, :nyl] for q in K.mom_rk_plain(*whole, **kw)[:6]]
    edge = [0, nyl - 1]
    inner = slice(1, nyl - 1)
    out = {}
    for name, gh, rh, gp, rp in zip(OUTPUTS, got_h, ref_h, got_p, ref_p):
        out[name] = dict(
            halo_edge=_rel(gh[:, edge], rh[:, edge]),
            halo_interior=_rel(gh[:, inner], rh[:, inner]),
            periodic=_rel(gp, rp),
            halo_vs_periodic=_rel(gh, gp),
            halo_equals_periodic=bool(torch.equal(gh, gp)))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog='cales_torch.fma_probe')
    ap.add_argument('--ng', default='512x256x256')
    ap.add_argument('--steps', type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('fma_probe needs a CUDA device', file=sys.stderr)
        return 2
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    ng = tuple(int(x) for x in args.ng.lower().split('x'))
    libs = {'fmad': build.load(),
            'no_fmad': build.open_library(build.build(
                flags=('-fmad=false',)))}
    sim, st, dt = _state(ng, args.steps, 20261021)
    whole, slab, halo, nyl = _args(sim, st, dt)
    out = dict(card=card, ng=ng, steps=args.steps)
    for name, lib in libs.items():
        with _library(lib):
            out[name] = _compare(whole, slab, halo, nyl)
    print(json.dumps({'fma_probe': out}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
