"""Smoke run of cales_torch on one NVIDIA GPU: build the CUDA kernels,
hold each against its plain PyTorch twin (the y-walled, full-3D,
periodic and slab variants too), drive the channel-LES slice, the square
duct and the Taylor-Green vortex through the CLI, the channel LES through
cales_torch.driver.run at 512x256x256 (with the cuFFT and the
operator-matrix Poisson solve), drive the implicit-CN channel DNS (z-only
and full-3D), the dynamic-Smagorinsky channel LES, the static-Smagorinsky
LES with z-implicit diffusion, the dynamic-Smagorinsky duct and cavity, the
two-pass dynamic Smagorinsky (the channel with transpiring walls, and the
channel, duct and cavity by both routes), the triperiodic DNS (explicit
and full-3D implicit), the wall-modelled channel LES (the wall-model
kernel, correc_smag's 'E' recipe; its example through the CLI too) and the
wall-modelled duct LES (the wall model on four faces, smag's y-wall
variant; its example at 512x80x80 through the CLI too) through
driver.run at 512x256x256, the Taylor-Green
vortex at 512^3 by both solve routes, the x-walled classes (the four
examples developing_channel, closed_box, lid_driven_cavity and
developing_duct through the CLI, the developing channel and the
lid-driven cavity through driver.run at 512x256x256), the developing-
channel LES (the developing wall-modelled channel with a 1/7-power
inflow profile, the developing channel LES with z-implicit diffusion and
the developing duct LES at 512x256x256: x-walled mom_rk with nu_t and
'1d', smag's x-wall variant, the wall model's x-walled rows), the passive
scalar (mom_rk's scalar variant with z, y and x walls against its twin;
the channel LES headline with a warm and a cold wall at 512x256x256, its
uniform scalar kept, and the duct and the developing channel with a
scalar), compare the card with the CPU step for step, and run the channel
LES on a y-slab mesh of two ranks that
share the card (torch.distributed over gloo, staged through the host):
the headline at 512x256x256 through driver.run, a small f64 case against
the single-device run, and the CLI under torch.distributed.run; then on
the same mesh the channel DNS with z-implicit diffusion, the
wall-modelled channel LES and the dsmag channel ('channel' with
impdiff_1d, one step with 'dit'), each at 512x256x256 with its slab
kernel variant against its twin and a small f64 case against one device,
and the y-walled dsmag duct, cavity and smag duct (their slab variants
timed in phase 2b on the lower and the upper wall's slab; the 'none'
duct's small f64 case too), the wall-modelled duct and the box on the
same mesh, and there the passive scalar (the channel LES and the dsmag
duct with one), the two-pass dynamic Smagorinsky (the transpiring
channel, the duct by the switch) and the 2D test filter (the dsmag
channel and the box), full-3D implicit diffusion (the channel DNS and the
box; the box with impdiff_1d and the scalar channel LES with full-3D as
small f64 cases), x walls (the developing channel and its LES with
impdiff_1d) and x walls with y walls, the wall model and the scalar (the
developing duct LES, the lid-driven cavity, the developing WMLES with its
inflow profile, the developing channel with a scalar; the closed box and
the x+y-walled scalar as small f64 cases), their slab modes timed in
phase 2b; then ptransform 'fft' everywhere the JAX package runs it: the
dsmag duct by the mixed route (the rfft along x, apply_y with the y DCT
on the real view of its lanes, timed in phase 2b) on one device at
512x256x256 (phase 8f), and on the mesh the LES headline and the mixed
dsmag duct at 512x256x256 (10ff, 10yf) and as small f64 cases the box
LES with 'dit', the full-3D channel DNS and the wall-modelled duct (10tdf,
10i3f, 10ywf); then on the 2D pencil mesh dims (2, 2), four ranks that
share the card, the LES headline by 'mat' and by 'fft' and the LES with
impdiff_1d, the dsmag channel (two-deep x halos), the triperiodic DNS
and its dsmag 'dit' LES, and the channel DNS with full-3D implicit
diffusion, the transpiring dsmag channel by two passes, the dsmag
channel and the box's 'dit' LES with the 2D test filter, and the channel
LES with a passive scalar at 512x256x256 (10p, 10pf, 10pi, 10pd, 10pt,
10ptd, 10pi3, 10pb, 10p2d, 10pt2d, 10ps: the x-halo variants of mom_rk
('xy+z' and the scalar too), fillps, correc_updatep, smag, dsmag (with
the 2D filter too), dsmag_level1 and dsmag_level2, timed in phase 2b at
the pencil (256, 128, 256), the Poisson and Helmholtz solves
re-slabbed), their small f64 twins and those of the
'none' channel, the box's smag LES and the box DNS by 'fft' (10pn,
10ptl, 10ptf) against one device, and the LES example through the CLI
with dims(1:2) = 2, 2 (10pc).  Each phase's first line carries the
seconds since the start.

    python3 chip_smoke.py            # all phases, one card

(``chip_smoke.py --mesh-rank DIR`` is one rank of the y-slab mesh's
phases 10 and 10i to 10ywf, ``--pencil-rank DIR`` one of phases 10p to
10ps, which the script starts itself under torch.distributed.run, one
launch each; ``chip_smoke.py --pencil-nccl`` runs the pencil phases alone
on four cards, a card a rank over NCCL.)

Exits non-zero without a CUDA device, or when any phase fails.  The last
line of standard output is {"ok": true, "device": {...}}; the line before
it is the card's name and power limit, and before that one JSON object
with each kernel's launches, error against its twin and times.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 20261016
KERNELS = {
    'mom_rk': ('cales_torch/csrc/mom_rk.cu',
               'cales_tpu/ops/pallas_kernels.py:784'),
    'fillps': ('cales_torch/csrc/fillps.cu',
               'cales_tpu/ops/pallas_kernels.py:1182'),
    'correc_smag': ('cales_torch/csrc/correc_smag.cu',
                    'cales_tpu/ops/pallas_kernels.py:1406'),
    'correc_updatep': ('cales_torch/csrc/correc.cu',
                       'cales_tpu/ops/pallas_kernels.py:1586'),
    'apply_y': ('cales_torch/csrc/apply_y.cu',
                'cales_tpu/ops/pallas_solve.py:87'),
    'z_eig': ('cales_torch/csrc/z_eig.cu',
              'cales_tpu/ops/pallas_solve.py:168'),
    'thomas_z': ('cales_torch/csrc/thomas_z.cu',
                 'cales_tpu/ops/pallas_solve.py:367'),
    'thomas_periodic': ('cales_torch/csrc/thomas_periodic.cu',
                        'cales_tpu/ops/pallas_solve.py:262'),
    'smag': ('cales_torch/csrc/smag.cu',
             'cales_tpu/ops/pallas_kernels.py:1016'),
    'dsmag': ('cales_torch/csrc/dsmag.cu',
              'cales_tpu/ops/pallas_dsmag.py:1168'),
    'dsmag_level1': ('cales_torch/csrc/dsmag_level1.cu',
                     'cales_tpu/ops/pallas_dsmag.py:537'),
    'dsmag_level2': ('cales_torch/csrc/dsmag_level2.cu',
                     'cales_tpu/ops/pallas_dsmag.py:708'),
    'apply_x': ('cales_torch/csrc/apply_x.cu',
                'cales_tpu/ops/pallas_solve.py:141'),
    # no Pallas kernel: the JAX package computes the planes in XLA
    'wallmodel': ('cales_torch/csrc/wallmodel.cu',
                  'cales_tpu/wallmodel.py:253'),
}
# the y-walled, full-3D and Helmholtz variants, each reported as a kernel
# of its own: report name -> (kernel, phase 2 variant)
VARIANT_ROWS = {
    'mom_rk (y walls)': ('mom_rk', 'duct'),
    'fillps (y walls)': ('fillps', 'duct'),
    'correc_updatep (y walls)': ('correc_updatep', 'duct'),
    'dsmag (y walls, duct)': ('dsmag', 'duct'),
    'dsmag (y walls, cavity)': ('dsmag', 'cavity'),
    'mom_rk (xy+z)': ('mom_rk', 'xyz'),
    'correc_updatep (full-3D)': ('correc_updatep', 'impdiff'),
    'thomas_z (Helmholtz, lam shift)': ('thomas_z', 'helmholtz3d'),
    'thomas_periodic (Helmholtz)': ('thomas_periodic', 'helmholtz'),
    'dsmag_level1 (y walls)': ('dsmag_level1', 'duct'),
    'dsmag_level2 (y walls, duct)': ('dsmag_level2', 'duct'),
    'dsmag_level2 (y walls, cavity)': ('dsmag_level2', 'cavity'),
    "correc_smag ('E' recipe, wall model)": ('correc_smag', 'wm'),
    "smag (y walls, 'E' stacks)": ('smag', 'duct_e'),
    'wallmodel (four faces, y and z)': ('wallmodel', 'duct'),
    'mom_rk (x walls)': ('mom_rk', 'xdev'),
    'mom_rk (x and y walls)': ('mom_rk', 'xbox'),
    'fillps (x walls)': ('fillps', 'xdev'),
    'fillps (x and y walls)': ('fillps', 'xbox'),
    'correc_updatep (x walls)': ('correc_updatep', 'xdev'),
    'correc_updatep (x and y walls)': ('correc_updatep', 'xbox'),
    'mom_rk (x walls, nu_t)': ('mom_rk', 'xdev_s'),
    "mom_rk (x walls, nu_t, '1d')": ('mom_rk', 'xdev_1d'),
    'mom_rk (x and y walls, nu_t)': ('mom_rk', 'xbox_s'),
    'smag (x walls)': ('smag', 'xdev'),
    'smag (x and y walls)': ('smag', 'xbox'),
    'wallmodel (x walls, z faces)': ('wallmodel', 'xdev'),
    'mom_rk (scalar)': ('mom_rk', 'les_sc'),
    'mom_rk (y walls, scalar)': ('mom_rk', 'duct_sc'),
    'mom_rk (x walls, scalar)': ('mom_rk', 'xdev_sc'),
    'smag (no walls)': ('smag', 'nowall'),
    'dsmag (periodic z)': ('dsmag', 'zp'),
    'dsmag (2D filter)': ('dsmag', 'f2d'),
}
# the kernels timed at the Taylor-Green vortex's 512^3 in phase 2b, each
# reported as a kernel of its own: report name -> (kernel, variant)
BIG_ROWS = {'mom_rk (512^3, no nu_t)': ('mom_rk', 'tgv'),
            'thomas_periodic (512^3)': ('thomas_periodic', 'poisson'),
            'thomas_z (512^3, Poisson pinned)': ('thomas_z', 'poisson'),
            'smag (512^3, no walls)': ('smag', 'nowall'),
            'dsmag (512^3, periodic z)': ('dsmag', 'zp')}
# the slab variants of the stencil kernels on the y-slab mesh (phase 10),
# each reported as a kernel of its own: report name -> kernel
HALO_ROWS = {'mom_rk (y halo)': 'mom_rk', 'fillps (y halo)': 'fillps',
             'correc_updatep (y halo)': 'correc_updatep',
             'smag (y halo)': 'smag'}
# the y-walled slab of the y-slab mesh (phases 10y, 10yc, 10ys): the
# y-walled variants on a slab's own y-row stacks (the wall recipe's rows
# on the side it owns, halo rows elsewhere; dsmag's YW + YH mode), each
# reported as a kernel of its own, timed in phase 2b at the headline's slab
# on dims (2, 1) (nx, ny/2, nz) on a slab that owns the lower wall and on
# one that owns the upper: report name -> (kernel, dsmag's average)
WALLED_SLAB_NG = (512, 128, 256)
WALLED_SLAB_ROWS = {'mom_rk (y walls, slab)': ('mom_rk', None),
                    'fillps (y walls, slab)': ('fillps', None),
                    'correc_updatep (y walls, slab)': ('correc_updatep',
                                                       None),
                    'smag (y walls, slab)': ('smag', None),
                    'dsmag (y walls, slab, duct)': ('dsmag', 'duct'),
                    'dsmag (y walls, slab, cavity)': ('dsmag', 'cavity')}
# the slab modes of the wall-modelled duct and the periodic box on the
# y-slab mesh (phases 10yw, 10t, 10td), each reported as a kernel of its
# own, timed in phase 2b at the headline's slab on dims (2, 1): the wall
# model's y-walled slab variant on the lower and the upper wall's slab,
# dsmag's ZP + YH mode, thomas_periodic on the pencil (nz, ny, nx/2) of the
# rank that holds the singular lane and of the other: report name ->
# (kernel, the mesh phase whose main path launches it)
SLAB_MODE_ROWS = {'wallmodel (y walls, slab)': ('wallmodel', '10yw'),
                  'dsmag (periodic z, slab)': ('dsmag', '10td'),
                  'thomas_periodic (pencil)': ('thomas_periodic', '10t'),
                  # the passive scalar's, the two-pass dsmag's and the 2D
                  # filter's slab modes (phases 10s, 10b, 10yb, 10f, 10tf;
                  # slab_twopass_rows)
                  'mom_rk (scalar, y halo)': ('mom_rk', '10s'),
                  'dsmag_level1 (y halo)': ('dsmag_level1', '10b'),
                  'dsmag_level1 (y walls, slab)': ('dsmag_level1', '10yb'),
                  'dsmag_level2 (y halo)': ('dsmag_level2', '10b'),
                  'dsmag_level2 (y walls, slab, duct)': ('dsmag_level2',
                                                         '10yb'),
                  'dsmag (2D filter, slab)': ('dsmag', '10f'),
                  'dsmag (2D filter, periodic z, slab)': ('dsmag', '10tf'),
                  # full-3D implicit diffusion's and the x walls' slab
                  # modes (phases 10i3, 10i3s, 10x, 10xb;
                  # slab_imp3d_x_rows)
                  'mom_rk (y halo, split xy+z)': ('mom_rk', '10i3'),
                  'mom_rk (scalar, y halo, split xy+z)': ('mom_rk',
                                                          '10i3s'),
                  'correc_updatep (y halo, full-3D)': ('correc_updatep',
                                                       '10i3'),
                  'mom_rk (x walls, y halo)': ('mom_rk', '10x'),
                  "mom_rk (x walls, y halo, nu_t, '1d')": ('mom_rk', '10xb'),
                  'fillps (x walls, y halo)': ('fillps', '10x'),
                  'correc_updatep (x walls, y halo)': ('correc_updatep',
                                                       '10x'),
                  'smag (x walls, y halo)': ('smag', '10xb'),
                  # x walls with y walls, the scalar and the wall model's
                  # slab modes (phases 10xy, 10xs, 10xw; slab_xy_rows)
                  'mom_rk (x and y walls, slab)': ('mom_rk', '10xy'),
                  'fillps (x and y walls, slab)': ('fillps', '10xy'),
                  'correc_updatep (x and y walls, slab)': ('correc_updatep',
                                                           '10xy'),
                  'smag (x and y walls, slab)': ('smag', '10xy'),
                  'mom_rk (scalar, x walls, y halo)': ('mom_rk', '10xs'),
                  'wallmodel (x walls, y halo)': ('wallmodel', '10xw')}
# the pencil mesh's x-halo variants, timed in phase 2b at the headline's
# pencil of dims (2, 2), (nx/2, ny/2, nz) (pencil_rows): report name ->
# (kernel, the pencil phase whose rank-0 main path launches it)
PENCIL_NG = (256, 128, 256)
PENCIL_ROWS = {'mom_rk (x halo, y halo)': ('mom_rk', '10p'),
               "mom_rk (x halo, y halo, '1d')": ('mom_rk', '10pi'),
               'fillps (x halo, y halo)': ('fillps', '10p'),
               'correc_updatep (x halo, y halo)': ('correc_updatep', '10p'),
               'smag (x halo, y halo)': ('smag', '10p'),
               # the full-3D channel DNS (10pi3), the box's smag LES (its
               # small twin 10ptl: the no-wall run) and the one-pass
               # dsmag's two-deep x halo mode on the channel (10pd) and the
               # box with 'dit' (10ptd)
               "mom_rk (x halo, y halo, 'xy+z')": ('mom_rk', '10pi3'),
               'correc_updatep (x halo, y halo, full-3D)': ('correc_updatep',
                                                            '10pi3'),
               'smag (x halo, y halo, no wall)': ('smag', '10ptl'),
               'dsmag (x halo, y halo)': ('dsmag', '10pd'),
               'dsmag (x halo, y halo, periodic z)': ('dsmag', '10ptd'),
               # the two passes on the transpiring channel (10pb), the 2D
               # test filter on the dsmag channel (10p2d) and the box
               # (10pt2d), the passive scalar on the LES channel (10ps)
               'dsmag_level1 (x halo, y halo)': ('dsmag_level1', '10pb'),
               'dsmag_level2 (x halo, y halo)': ('dsmag_level2', '10pb'),
               'dsmag (2D filter, x halo, y halo)': ('dsmag', '10p2d'),
               'dsmag (2D filter, x halo, periodic z)': ('dsmag', '10pt2d'),
               'mom_rk (scalar, x halo, y halo)': ('mom_rk', '10ps'),
               # the y walls' x-halo variants (Y_WALLS x X_HALO, dsmag's
               # YW + YH x XH) on the duct (10py), the cavity (10pyc),
               # the smag duct (10pys) and the scalar duct (10pysc)
               'mom_rk (x halo, y walls)': ('mom_rk', '10py'),
               'fillps (x halo, y walls)': ('fillps', '10py'),
               'correc_updatep (x halo, y walls)': ('correc_updatep',
                                                    '10py'),
               'smag (x halo, y walls)': ('smag', '10pys'),
               'dsmag (x halo, y walls, duct)': ('dsmag', '10py'),
               'dsmag (x halo, y walls, cavity)': ('dsmag', '10pyc'),
               'mom_rk (scalar, x halo, y walls)': ('mom_rk', '10pysc')}
# the mixed route's y stage (ptransform 'fft' with y walls, phase 8f and
# the mesh classes 10yf, 10ywf): apply_y with the y DCT alone on the real
# view of the rfft's lanes at the headline grid, (nz, ny, 2 (nx/2 + 1)),
# timed in phase 2b: report name -> kernel
REAL_VIEW_SHAPE = (256, 256, 514)
REAL_VIEW_ROWS = {'apply_y (real view, mixed route)': 'apply_y'}
LES_KERNELS = ('mom_rk', 'fillps', 'correc_smag')
# H100 SXM data-sheet rates: HBM
# bytes/s and float32 / float64 FLOP/s outside the tensor cores
PEAK_BPS = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
# the float32 matrix products at fp32 accuracy on the tensor cores: 3xTF32,
# three TF32 products (495 TFLOP/s dense) a product
PEAK_TF32X3 = 495e12 / 3
HEADLINE_NG = (512, 256, 256)
CHAN_BCS = dict(
    cbcvel=((('P', 'P', 'P'), ('P', 'P', 'P'), ('D', 'D', 'D')),) * 2,
    cbcpre=(('P', 'P', 'N'), ('P', 'P', 'N')),
    cbcsgs=(('P', 'P', 'D'), ('P', 'P', 'D')))
# bench.py _matrix_configs((512, 256, 256))['channel_dns_impdiff'] and
# ['channel_les_smag'], written out
DNS_CFG = dict(ng=HEADLINE_NG, l=(2 * np.pi, np.pi, 2.0), gtype=1, gr=1.0,
               inivel='log', is_wallturb=True, is_forced=(True, False, False),
               velf=(1.0, 0.0, 0.0), dtype='float32', ptransform='mat',
               visci=5640.0, sgstype='none', impdiff=True, impdiff_1d=True,
               **CHAN_BCS)
LES_CFG = dict(ng=HEADLINE_NG, l=(2 * np.pi, np.pi, 2.0), gtype=1, gr=1.0,
               visci=20_000.0, inivel='log', is_wallturb=True,
               is_forced=(True, False, False), velf=(1.0, 0.0, 0.0),
               sgstype='smag', dtype='float32', ptransform='fft')
# validation/dsmag_channel.py:77-89 (the dynamic-Smagorinsky channel on the
# manuscript's domain, impdiff_1d), written out at the headline grid
DSMAG_CFG = dict(ng=HEADLINE_NG, l=(12.8, 4.8, 2.0), gtype=1, gr=5.0,
                 visci=10_000.0, inivel='poi', is_wallturb=True,
                 is_forced=(True, False, False), velf=(1.0, 0.0, 0.0),
                 dtype='float32', sgstype='dsmag', dsmag_avg='channel',
                 ptransform='mat', impdiff=True, impdiff_1d=True, **CHAN_BCS)
# the same channel with transpiring walls: w = W blown through the lower
# wall and sucked through the upper one (W ~ 0.05 u_tau at this Re_b, the
# blowing and suction of Sumitani & Kasagi, AIAA J. 33, 1995), which only
# the two-pass dsmag carries
W_BLOW = 0.003
BLOW_FACE = ((0.0,) * 3, (0.0,) * 3, (0.0, 0.0, W_BLOW))
DSMAG_BLOW_CFG = dict(DSMAG_CFG, bcvel=(BLOW_FACE, BLOW_FACE))
# bench.py's channel_les_smag ('mat') with z-implicit diffusion (the
# reference's -D_IMPDIFF_1D wall-resolved LES build)
LES_IMP_CFG = dict(LES_CFG, ptransform='mat', impdiff=True, impdiff_1d=True,
                   **CHAN_BCS)
# bench.py _matrix_configs((512, 256, 256))['duct_les_dsmag'] and
# ['cavity_les_dsmag'], written out
DUCT_BCS = dict(
    cbcvel=((('P', 'P', 'P'), ('D', 'D', 'D'), ('D', 'D', 'D')),) * 2,
    cbcpre=(('P', 'N', 'N'), ('P', 'N', 'N')),
    cbcsgs=(('P', 'D', 'D'), ('P', 'D', 'D')))
DUCT_CFG = dict(ng=HEADLINE_NG, l=(4 * np.pi, 2.0, 2.0), gtype=1, gr=1.0,
                visci=10_000.0, inivel='duc', is_wallturb=True,
                is_forced=(True, False, False), velf=(1.0, 0.0, 0.0),
                sgstype='dsmag', dsmag_avg='duct', dtype='float32',
                ptransform='mat', **DUCT_BCS)
CAVITY_CFG = dict(ng=HEADLINE_NG, l=(1.0, 1.0, 1.0), gtype=1, gr=0.0,
                  visci=5_000.0, inivel='tgv', sgstype='dsmag',
                  dsmag_avg='cavity', dtype='float32', ptransform='mat',
                  bcvel=(((0.0,) * 3,) * 3,
                         ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))),
                  **DUCT_BCS)
# examples/taylor_green_vortex_3d/input.nml (ptransform 'auto' is 'fft';
# phase 9 takes 'mat') and bench.py _matrix_configs((512, 256, 256))
# ['triperiodic_dns'], written out
PERIODIC_BCS = dict(cbcvel=((('P',) * 3,) * 3,) * 2,
                    cbcpre=(('P',) * 3,) * 2, cbcsgs=(('P',) * 3,) * 2)
TGV_CFG = dict(ng=(512, 512, 512), l=(2 * np.pi,) * 3, gtype=1, gr=0.0,
               cfl=0.95, dtmax=1e5, visci=1600.0, inivel='tgv',
               is_wallturb=False, sgstype='none', dtype='float32',
               ptransform='mat', **PERIODIC_BCS)
TRI_CFG = dict(ng=HEADLINE_NG, l=(2 * np.pi,) * 3, gtype=0, gr=0.0,
               visci=1600.0, inivel='tgv', sgstype='none', dtype='float32',
               ptransform='mat', **PERIODIC_BCS)
# the passive scalar of phase 13: phase 4m's LES headline ('mat') with a
# warm and a cold wall (s 0 on the lower z wall, 1 on the upper one), Pr
# 0.71, from s = 0 (profile_step's 'les-scal')
SCALAR = dict(scalar=True, pr=0.71, iniscal='zer',
              cbcscal=(('P', 'P', 'D'), ('P', 'P', 'D')),
              bcscal=((0.0, 0.0, 0.0), (0.0, 0.0, 1.0)))
LES_SC_CFG = dict(LES_CFG, ptransform='mat', **SCALAR)
# phase 13y's dsmag duct with a scalar: 1 at the start, 1 and 0.5 on the y
# walls, N on the z walls, a source 0.02
DUCT_SC_CFG = dict(DUCT_CFG, scalar=True, pr=0.71, iniscal='uni',
                   ssource=0.02, cbcscal=(('P', 'D', 'N'), ('P', 'D', 'N')),
                   bcscal=((0.0, 1.0, 0.0), (0.0, 0.5, 0.0)))
# phase 4m's LES headline ('mat') on a y-slab mesh of two ranks (phase 10)
MESH_CFG = dict(LES_CFG, ptransform='mat', dims=(2, 1), **CHAN_BCS)
# its small f64 twin, held against the single-device 'mat' + Thomas run
MESH_SMALL = dict(MESH_CFG, ng=(64, 32, 32), dtype='float64')
MESH_STEPS = 3
# bench.py _matrix_configs((512, 256, 256))['wmles_channel'], written out:
# the log-law wall model on both z walls at hwm 0.1, visci 125 000
WM_LWM = ((0, 0, 1), (0, 0, 1))
WMLES_CFG = dict(LES_CFG, visci=125_000.0, ptransform='mat', lwm=WM_LWM,
                 hwm=0.1, **CHAN_BCS)
# examples/turbulent_duct_wmles/input.nml at the headline grid (phase 8w):
# the log-law wall model on all four side walls at hwm 0.1, smag, 'mat'
DUCT_WM_LWM = ((0, 1, 1), (0, 1, 1))
DUCT_WMLES_CFG = dict(ng=HEADLINE_NG, l=(12.8, 2.0, 2.0), gtype=1, gr=0.0,
                      visci=20_000.0, inivel='duc', is_wallturb=True,
                      is_forced=(True, False, False), velf=(1.0, 0.0, 0.0),
                      sgstype='smag', dtype='float32', ptransform='mat',
                      lwm=DUCT_WM_LWM, hwm=0.1, **DUCT_BCS)
# examples/developing_channel/input.nml at the headline grid (phase 11):
# inflow u = 1 at x = 0, outflow at x = lx (u 'N', p 'D'), periodic y, z
# walls, sgstype 'none', explicit diffusion, 'auto' (the port takes 'mat')
XDEV_BCS = dict(
    cbcvel=((('D', 'N', 'N'), ('P', 'P', 'P'), ('D', 'D', 'D')),
            (('N', 'N', 'N'), ('P', 'P', 'P'), ('D', 'D', 'D'))),
    cbcpre=(('N', 'P', 'N'), ('D', 'P', 'N')),
    cbcsgs=(('N', 'P', 'D'), ('N', 'P', 'D')))
XDEV_CFG = dict(ng=HEADLINE_NG, l=(1.0, 1.5, 1.0), gtype=1, gr=0.0,
                cfl=0.95, dtmax=1e5, visci=1000.0, inivel='zer',
                is_wallturb=False, sgstype='none', dtype='float32',
                bcvel=(((1.0, 0.0, 0.0), (0.0,) * 3, (0.0,) * 3),
                       ((0.0,) * 3,) * 3), **XDEV_BCS)
# examples/developing_duct/input.nml's x and y faces: the developing
# channel with y walls
XDUCT_BCS = dict(
    cbcvel=((('D', 'N', 'N'), ('D', 'D', 'D'), ('D', 'D', 'D')),
            (('N', 'N', 'N'), ('D', 'D', 'D'), ('D', 'D', 'D'))),
    cbcpre=(('N', 'N', 'N'), ('D', 'N', 'N')),
    cbcsgs=(('N', 'D', 'D'), ('N', 'D', 'D')))
XDUCT_CFG = dict(XDEV_CFG, **XDUCT_BCS)
# the developing channel and duct LES (phases 12b, 12c): static
# Smagorinsky, visci 20 000; 12b with z-implicit diffusion
XLES_IMP_CFG = dict(XDEV_CFG, sgstype='smag', visci=20_000.0, impdiff=True,
                    impdiff_1d=True)
XDUCT_LES_CFG = dict(XDUCT_CFG, sgstype='smag', visci=20_000.0)
# the developing wall-modelled channel LES (phase 12; the physics of
# tests/test_pallas_kernels.py:538, test_pallas_xwalled_wm): 6.4 x 3.2 x 2,
# gtype 6, visci 50 000, smag, the log-law wall model on both z walls at
# hwm 0.1, inflow at x = 0 (xwmles_cfg adds its 1/7-power profile),
# outflow u 'N' / p 'D', periodic y, 'auto' (the port takes 'mat')
XWMLES_CFG = dict(XDEV_CFG, l=(6.4, 3.2, 2.0), gtype=6, gr=0.0,
                  visci=50_000.0, inivel='uni', sgstype='smag',
                  lwm=((0, 0, 1), (0, 0, 1)), hwm=0.1)
# examples/lid_driven_cavity/input.nml at the headline grid (phase 11b):
# walls on all six faces, the top z face moving at u = 1
ALLD = (('D', 'D', 'D'),) * 3
XCAVITY_CFG = dict(ng=HEADLINE_NG, l=(1.0, 1.0, 1.0), gtype=1, gr=0.0,
                   cfl=0.95, dtmax=1e5, visci=1000.0, inivel='zer',
                   is_wallturb=False, sgstype='none', dtype='float32',
                   cbcvel=(ALLD, ALLD), cbcpre=(('N',) * 3,) * 2,
                   cbcsgs=(('D',) * 3,) * 2,
                   bcvel=(((0.0,) * 3,) * 3,
                          ((0.0,) * 3, (0.0,) * 3, (1.0, 0.0, 0.0))))
# phase 13x's passive scalar on the developing channel: 1 at the start, 1
# on the inflow face ('D'), N on the outflow and the z walls, a source 0.02
XDEV_SCALAR = dict(scalar=True, pr=0.71, iniscal='uni', ssource=0.02,
                   cbcscal=(('D', 'P', 'N'), ('N', 'P', 'N')),
                   bcscal=((1.0, 0.0, 0.0), (0.0, 0.0, 0.0)))
# tests/test_sharding_paths.py:735's x+y-walled scalar on the developing
# duct: 1 on the inflow face and 0.5 on the lower y wall ('D'), N elsewhere
XDUCT_SCALAR = dict(XDEV_SCALAR, cbcscal=(('D', 'D', 'N'), ('N', 'N', 'N')),
                    bcscal=((1.0, 0.5, 0.0), (0.0, 0.0, 0.0)))
# moving wall-parallel values on some y and z faces for the y-walled
# kernel inputs: (face, dir, comp)
MOVING = (((0.0,) * 3, (0.2, 0.0, -0.1), (0.0, 0.0, 0.0)),
          ((0.0,) * 3, (0.0, 0.0, 0.3), (0.4, -0.3, 0.0)))


def xwmles_cfg(**change):
    """The developing WMLES as a Config: XWMLES_CFG (with change), its
    inflow a 1/7-power profile u = (8/7) min(z, 2 - z)^(1/7), 0 where
    that is negative, over the padded (nz+2, ny+2) x face at the cell
    centres of its own grid (profile_step.power_law_inflow)."""
    from cales_torch.config import Config
    from cales_torch.profile_step import power_law_inflow
    return power_law_inflow(Config(**{**XWMLES_CFG, **change}))


def card_line():
    res = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True)
    return res.stdout.strip().splitlines()[0]


T0 = time.perf_counter()


def say(msg):
    """Print msg; a phase's first line with the seconds since the start."""
    if msg.startswith(('phase', 'phases')):
        msg = f'[{time.perf_counter() - T0:7.1f} s] {msg}'
    print(msg, flush=True)


class Failure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise Failure(msg)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def kernel_inputs(ng, dtype, dev, seed, big=False):
    """Random interiors, edges and profiles for the stencil kernels, and
    the channel's Poisson and w Helmholtz operators for the solve kernels,
    at (nx, ny, nz) = ng on a stretched channel grid.  Small shapes draw
    from numpy; the headline shape from a seeded torch generator on the
    card (numpy would spend most of the phase making 30 fields on the
    host)."""
    from cales_torch.config import Config, C_SMAG
    from cales_torch.grid import make_grid_from_config
    from cales_torch import poisson
    from cales_torch import sgs as sgsmod
    from cales_torch.config import effective_cbcvel
    from cales_torch.ops import boundary as bnd
    nx, ny, nz = ng
    cfg = Config(ng=ng, l=(2 * np.pi, np.pi, 2.0), gtype=1, gr=1.0,
                 visci=1000.0, ptransform='mat', **CHAN_BCS)
    grid = make_grid_from_config(cfg)
    if big:
        gen = torch.Generator(device=dev).manual_seed(seed)

        def rnd(*shape, scale=0.02):
            return scale * torch.randn(shape, generator=gen, device=dev,
                                       dtype=dtype)
    else:
        rng = np.random.default_rng(seed)

        def rnd(*shape, scale=0.02):
            return torch.as_tensor(scale * rng.standard_normal(shape),
                                   dtype=dtype, device=dev)
    f = lambda: rnd(nz, ny, nx)          # noqa: E731
    e = lambda: rnd(3, ny, nx)           # noqa: E731
    t = lambda a, dt=dtype: torch.as_tensor(  # noqa: E731
        np.ascontiguousarray(a), dtype=dt, device=dev)
    setup = sgsmod.SGSSetup(cfg, grid, effective_cbcvel(cfg))
    zc = grid.zc[1:nz + 1]
    svp = poisson.make_solver(cfg, grid, ('PP', 'PP', 'NN'), ('c', 'c', 'c'))
    svw = poisson.make_solver(cfg, grid, ('PP', 'PP', 'DD'), ('c', 'c', 'f'))
    # the triperiodic box's pressure system (uniform periodic z)
    tcfg = Config(**{**TRI_CFG, 'ng': ng})
    svt = poisson.make_solver(tcfg, make_grid_from_config(tcfg),
                              ('PP', 'PP', 'PP'), ('c', 'c', 'c'))
    eps = float(torch.finfo(dtype).eps)
    d = dict(u=f(), v=f(), w=f(), s=f().abs(), p=f(), ue=e(), ve=e(),
             we=e(), se=e().abs(), pe=e(), ruo=f(), rvo=f(), rwo=f(),
             pp=f(), ppe=e(), tauw_lo=rnd(ny, nx).abs(),
             tauw_hi=rnd(ny, nx).abs(),
             dzci=t(grid.dzci), dzfi=t(grid.dzfi),
             csd2=t((C_SMAG * setup.delta) ** 2),
             dw=t(np.minimum(zc, cfg.l[2] - zc)),
             nearlo=t((zc <= cfg.l[2] - zc).astype(np.float64)),
             fuv=t([0.05, -0.02]), dxi=cfg.dli[0], dyi=cfg.dli[1],
             visc=cfg.visc, dz01=(float(grid.dzc[0]), float(grid.dzc[nz])),
             # solve operators: channel pressure (mat) and the w CN system
             fy=t(svp.try_.fwd_mat), fxT=t(svp.trx.fwd_mat.T),
             Vl=t(svp.zVl), Vr=t(svp.zVr), lamz=t(svp.lamz),
             lamy=t(svp.lamy), lamx=t(svp.lamx),
             eig_tol=eps * 4.0 * float(np.abs(svp.lamz).max()
                                       + np.abs(svp.lamx).max()
                                       + np.abs(svp.lamy).max()),
             th_tol=eps * 4.0 * float(np.abs(svp.lamx).max()
                                      + np.abs(svp.lamy).max()),
             abc_p=tuple(t(q, torch.float64) for q in (svp.a, svp.b, svp.c)),
             abc_w=tuple(t(q, torch.float64) for q in (svw.a, svw.b, svw.c)),
             lam_w3=(t(svw.lamy * ALPHA), t(svw.lamx * ALPHA)),
             abc_t=tuple(t(q, torch.float64) for q in (svt.a, svt.b, svt.c)),
             lam_t=(t(svt.lamy), t(svt.lamx)),
             lam_t3=(t(svt.lamy * ALPHA), t(svt.lamx * ALPHA)),
             th_tol_t=eps * 4.0 * float(np.abs(svt.lamx).max()
                                        + np.abs(svt.lamy).max()),
             shift=t([0.0173]), bc_lo=rnd(ny, nx), bc_hi=rnd(ny, nx))
    # dsmag: the post-correction fill's edge stacks of the interiors (the
    # kernel's ghost recipes assume the channel's walls), a periodic lower
    # w face, and moving-wall values for the filtered fill
    wlo = rnd(ny, nx, scale=1e-3)
    wlo = torch.cat([wlo[-1:], wlo, wlo[:1]])
    wlo = torch.cat([wlo[:, -1:], wlo, wlo[:, :1]], dim=1)
    z3 = ((0.0,) * 3,) * 3
    bc = bnd.make_bc_values(ng, z3, dtype, dev)
    d['ue_c'], d['ve_c'], d['we_c'] = (e.contiguous() for e in
                                       bnd.zedge_velocity(
        d['u'], d['v'], d['w'], effective_cbcvel(cfg), bc, bc, bc, grid.dzc,
        grid.dzf, vlo=(None, None, wlo), is_correc=True))
    a2 = np.full(nz, 4.0)
    a2[0] = a2[-1] = 2.52
    d['alph2'] = t(a2)
    d['zvals'] = (0.0, 0.02, 0.0, -0.01)
    # dsmag's periodic-z mode (the box: alpha^2 4 everywhere; it reads no
    # edge stack) and its 2D filter (alpha^2 2.52 everywhere)
    d['alph2_box'] = t(np.full(nz, 4.0))
    d['alph2_2d'] = t(np.full(nz, 2.52))
    # y walls: the duct's fills of the same interiors as (rows, corners)
    # pairs, with moving wall-parallel values; the post-correction fill
    # (mom_rk, dsmag) keeps random lower faces of v and w
    dcfg = Config(ng=ng, l=(4 * np.pi, 2.0, 2.0), gtype=1, gr=1.0,
                  visci=1000.0, bcvel=MOVING, **DUCT_BCS)
    dgrid = make_grid_from_config(dcfg)
    cbc = effective_cbcvel(dcfg)
    by = lambda iv: tuple(tuple(MOVING[ib][d_][iv] for ib in range(2))  # noqa: E731
                          for d_ in range(3))
    bcv = [bnd.make_bc_values(ng, by(iv), dtype, dev) for iv in range(3)]
    zero = bnd.make_bc_values(ng, ((0.0, 0.0),) * 3, dtype, dev)
    wrapx = lambda a: torch.cat([a[:, -1:], a, a[:, :1]], dim=1)  # noqa: E731
    vlo = (None, wrapx(rnd(nz + 2, nx, scale=1e-3)),
           wrapx(rnd(ny + 2, nx, scale=1e-3)))

    def yvel(is_correc):
        rows, corners = bnd.yedge_velocity(
            d['u'], d['v'], d['w'], cbc, *bcv, dcfg.dl, dgrid.dzc, dgrid.dzf,
            vlo=vlo if is_correc else None, is_correc=is_correc)
        return list(zip(rows, corners))
    cbcp = (('P', 'P'), ('N', 'N'), ('N', 'N'))
    cbcs = (('P', 'P'), ('D', 'D'), ('D', 'D'))
    ysc = lambda q, c: bnd.yedge_scalar(q, c, zero, dcfg.dl, dgrid.dzc)  # noqa: E731
    d['y_mom'] = (*yvel(True), ysc(d['s'], cbcs), ysc(d['p'], cbcp))
    d['y_pred'] = yvel(False)
    d['y_pp'] = ysc(d['pp'], cbcp)
    d['yvals'] = (0.2, 0.0, -0.1, 0.3)
    # dsmag_level2's inputs besides the filtered velocity (u, v, w here,
    # with the prediction fill's stacks as its static fill): fm, lij, s0
    d['ds2'] = [f() for _ in range(13)]
    # apply_x: a slab of half the y rows (one of two ranks), and the same
    # in the x-column blocks the backward transpose delivers
    d['slab'] = d['u'][:, :max(ny // 2, 1)].contiguous()
    nz_, nyl, _ = d['slab'].shape
    d['slab_blocks'] = d['slab'].reshape(nz_, nyl, 2, nx // 2).permute(
        2, 0, 1, 3).contiguous()
    # the wall model on both z faces of this channel (bench.py's hwm and
    # visci), its rows sampled from u + 1, a bulk flow; correc_smag's 'E'
    # recipes with the grid's fac_ex
    from cales_torch import wallmodel as wmod
    wcfg = cfg.replace(lwm=WM_LWM, hwm=0.1, visci=125_000.0)
    d['wm'] = wmod.z_wall_model(wcfg, grid, wmod.find_index_wm(wcfg, grid))
    d['wm_u'] = d['u'] + 1.0
    # the wall model on the four walls of the duct WMLES at this shape,
    # moving wall values (the y faces sample u and w)
    qcfg = Config(**{**DUCT_WMLES_CFG, 'ng': ng, 'bcvel': MOVING})
    qgrid = make_grid_from_config(qcfg)
    d['wm4'] = wmod.wall_model(qcfg, qgrid, wmod.find_index_wm(qcfg, qgrid),
                               bcv, effective_cbcvel(qcfg))
    # smag with y walls: the post-correction fill's y-row stacks, as they
    # are and extrapolated on all four faces ('E'), the nearer y wall's
    # distance profile and the y walls' shear planes
    yc = (np.arange(ny) + 0.5) * dcfg.dl[1]
    d['ywall'] = (t(np.minimum(yc, dcfg.l[1] - yc)),
                  t((yc <= dcfg.l[1] - yc).astype(np.float64)),
                  rnd(nz, nx).abs(), rnd(nz, nx).abs())
    flags = {(ib, dd): dd > 0 for ib in range(2) for dd in range(3)}
    fac = (dgrid.dzc[0] * dgrid.dzci[1], dgrid.dzc[nz] * dgrid.dzci[nz - 1])
    ext = [sgsmod.extrapolate_stacks(q, e, y, iface, flags, fac)
           for q, e, y, iface in zip((d['u'], d['v'], d['w']),
                                     (d['ue'], d['ve'], d['we']),
                                     d['y_mom'][:3], (1, 2, 3))]
    d['e_edges'] = [e.contiguous() for e, _ in ext]
    d['e_stacks'] = [(r.contiguous(), c.contiguous()) for _, (r, c) in ext]
    d['fac_ex'] = (float(grid.dzc[0] * grid.dzci[1]),
                   float(grid.dzc[nz] * grid.dzci[nz - 1]))
    # the passive scalar (mom_rk's scalar variant): a field near 1, its
    # previous RHS, its z-edge stack with phase 13's walls (D 0 and 1) and
    # its y-row stack pair on the duct (D 1.0 and 0.5 on the y walls, N on
    # the z walls)
    d['sca'] = 1.0 + f()
    d['rso'] = f()
    d['scae'] = bnd.zedge_scalar_fast(d['sca'], ('D', 'D'), (0.0, 1.0),
                                      grid.dzc)
    d['scal'] = (cfg.visc / 0.71, 0.02)
    d['y_sca'] = bnd.yedge_scalar_fast(
        d['sca'], (('P', 'P'), ('D', 'D'), ('N', 'N')),
        ((0.0, 0.0), (1.0, 0.5), (0.0, 0.0)), dcfg.dl, dgrid.dzc)
    # x walls: the developing channel's fills of the same interiors
    # (periodic y; 'xdev') and the developing duct's (x and y walls, the
    # columns with their y ghosts; 'xbox'), inflow and moving wall values,
    # random kept lower faces for the corrector fill
    xbc = (((1.0, 0.2, -0.1), (0.1, 0.0, 0.3), (0.2, -0.1, 0.0)),
           ((0.05, 0.1, 0.2), (0.3, 0.0, 0.1), (0.4, 0.2, 0.0)))
    xlo = (rnd(nz + 2, ny + 2, scale=1e-3), rnd(nz + 2, nx + 2, scale=1e-3),
           rnd(ny + 2, nx + 2, scale=1e-3))
    for key, bcs in (('xdev', XDEV_BCS), ('xbox', XDUCT_BCS)):
        xcfg = Config(ng=ng, l=(1.0, 1.5, 1.0), gtype=1, gr=1.0,
                      visci=1000.0, bcvel=xbc, **bcs)
        xgrid = make_grid_from_config(xcfg)
        xcbc = effective_cbcvel(xcfg)
        xby = lambda iv: tuple(tuple(xbc[ib][d_][iv] for ib in range(2))  # noqa: E731
                               for d_ in range(3))
        xbv = [bnd.make_bc_values(ng, xby(iv), dtype, dev) for iv in range(3)]
        yw = key == 'xbox'
        cbcp = tuple((bcs['cbcpre'][0][q], bcs['cbcpre'][1][q])
                     for q in range(3))
        xargs = (xcbc, *xbv, xcfg.dl, xgrid.dzc, xgrid.dzf)
        xsc = lambda q: bnd.xedge_scalar(q, cbcp, zero, xcfg.dl,  # noqa: E731
                                         xgrid.dzc, ywalls=yw)
        d[key + '_mom'] = (*bnd.xedge_velocity(
            d['u'], d['v'], d['w'], *xargs, vlo=xlo, is_correc=True,
            ywalls=yw), None, xsc(d['p']))
        d[key + '_pred'] = bnd.xedge_velocity(d['u'], d['v'], d['w'],
                                              *xargs, ywalls=yw)
        d[key + '_pp'] = xsc(d['pp'])
        # with nu_t: its x stack by the SGS letters; smag's x walls: the
        # inflow face (u 'D') is one, its distance and random shear planes
        cbcs = tuple((bcs['cbcsgs'][0][q], bcs['cbcsgs'][1][q])
                     for q in range(3))
        d[key + '_mom_s'] = (*d[key + '_mom'][:3], bnd.xedge_scalar(
            d['s'], cbcs, zero, xcfg.dl, xgrid.dzc, ywalls=yw),
            d[key + '_mom'][4])
        xc = (np.arange(nx) + 0.5) * xcfg.dl[0]
        d[key + '_xwall'] = (t(xc), t(np.ones(nx)), rnd(nz, ny).abs(),
                             rnd(nz, ny).abs())
        if key == 'xdev':
            # the scalar's x stack pair: D 1 at the inflow, N at the
            # outflow and the z walls
            d['xdev_sca'] = bnd.xedge_scalar(
                d['sca'], (('D', 'N'), ('P', 'P'), ('N', 'N')),
                ((1.0, 0.0), (0.0, 0.0), (0.0, 0.0)), xcfg.dl, xgrid.dzc)
    # the wall model on both z faces of the developing WMLES (x walls: the
    # rows' x ghosts from the x faces' values, the inflow a 1/7-power
    # profile that varies along z), its rows sampled from u + 1
    mcfg = xwmles_cfg(ng=ng)
    mgrid = make_grid_from_config(mcfg)
    mbc = [bnd.make_bc_values(ng, tuple(
        tuple(mcfg.bcvel[ib][d_][iv] for ib in range(2)) for d_ in range(3)),
        dtype, dev) for iv in range(3)]
    d['wmx'] = wmod.wall_model(mcfg, mgrid, wmod.find_index_wm(mcfg, mgrid),
                               mbc, effective_cbcvel(mcfg))
    return d


def call(name, d, twin=False, variant=None, has_ruo=True, zrec=None):
    """One kernel's wrapper (twin=False) or its plain twin (twin=True) on
    the inputs d; returns {output name: tensor}."""
    from cales_torch.ops import kernels as K
    from cales_torch.ops import solve_kernels as SK
    mod = SK if name in SK.LAUNCHES else K
    # the wrapper of each launch-count name
    base = {'thomas_periodic': 'thomas_periodic_z',
            'wallmodel': 'wm_planes'}.get(name, name)
    fn = getattr(mod, f'{base}_plain' if twin else base)
    ywall = variant == 'duct'
    if name == 'mom_rk':
        r = (d['ruo'], d['rvo'], d['rwo']) if has_ruo else (None,) * 3
        # dns: no visct, split '1d' + CN fold; les_split: visct, '1d';
        # xyz: no visct, the full-3D split 'xy+z' (the triperiodic and
        # channel DNS with full-3D implicit diffusion); les_xyz: visct,
        # 'xy+z'; tgv: no visct, explicit (the Taylor-Green vortex)
        # xdev, xbox: no visct, explicit, x walls (the developing channel;
        # the developing duct's x and y walls)
        # xdev_s, xbox_s: visct, explicit, x walls; xdev_1d: visct, '1d',
        # x walls (the developing channel and duct LES)
        # les_sc, duct_sc, xdev_sc: visct, explicit and the passive scalar,
        # with z walls, y walls or x walls (its own stacks)
        dns = variant in ('dns', 'xyz', 'tgv', 'xdev', 'xbox')
        split = {'dns': '1d', 'les_split': '1d', 'xyz': 'xy+z',
                 'les_xyz': 'xy+z', 'xdev_1d': '1d'}.get(variant)
        ye = (d['y_mom'] if ywall or variant in ('xbox_s', 'duct_sc')
              else None)
        if variant == 'xbox':
            ye = (*d['y_mom'][:3], None, d['y_mom'][4])
        xkey = {'xdev': 'xdev_mom', 'xbox': 'xbox_mom',
                'xdev_s': 'xdev_mom_s', 'xdev_1d': 'xdev_mom_s',
                'xbox_s': 'xbox_mom_s', 'xdev_sc': 'xdev_mom_s'}.get(variant)
        xe = None if xkey is None else d[xkey]
        skw = {}
        if variant in ('les_sc', 'duct_sc', 'xdev_sc'):
            skw = dict(sca=d['sca'], scae=d['scae'],
                       rso=d['rso'] if has_ruo else None, scal=d['scal'])
            if variant == 'duct_sc':
                ye = (*ye, d['y_sca'])
            if variant == 'xdev_sc':
                xe = (*xe, d['xdev_sca'])
        out = list(fn(d['u'], d['v'], d['w'], None if dns else d['s'],
                      d['p'], d['ue'], d['ve'], d['we'],
                      None if dns else d['se'], d['pe'], *r, d['dzci'],
                      d['dzfi'], 2.1e-3, -1.1e-3 if has_ruo else 0.0,
                      d['visc'], d['dxi'], d['dyi'], (0.3, 0.0, 0.0),
                      sums=(True, True), split=split, ye=ye, xe=xe, **skw))
        # partial sums: compare the per-plane totals
        out[6], out[7] = out[6].sum(dim=1), out[7].sum(dim=1)
        return dict(zip(('u', 'v', 'w', 'ru', 'rv', 'rw', 'usum', 'vsum',
                         's', 'ds'), out))
    if name == 'smag':
        # duct: y walls, the fill's stacks; duct_e: extrapolated ('E');
        # nowall: the triperiodic box's (no van Driest damping)
        edges, ykw = (d['ue'], d['ve'], d['we']), {}
        if variant == 'nowall':
            ykw = dict(have_zwalls=False)
        elif variant == 'duct':
            ykw = dict(ye=d['y_mom'][:3], ywall=d['ywall'])
        elif variant == 'duct_e':
            edges = d['e_edges']
            ykw = dict(ye=d['e_stacks'], ywall=d['ywall'])
        elif variant in ('xdev', 'xbox'):
            # x walls: the post-correction fill's x stacks, the inflow face
            # a wall; with y walls the y-row stacks and y walls too
            ykw = dict(xe=d[f'{variant}_mom'][:3],
                       xwall=d[f'{variant}_xwall'])
            if variant == 'xbox':
                ykw.update(ye=d['y_mom'][:3], ywall=d['ywall'])
        return {'visct': fn(d['u'], d['v'], d['w'], *edges, d['dzci'],
                            d['dzfi'], d['dxi'], d['dyi'], d['visc'],
                            d['csd2'], d['dw'], d['nearlo'], d['tauw_lo'],
                            d['tauw_hi'], **ykw)}
    if name == 'dsmag':
        # zp: the periodic-z mode (the box: no z wall, the stacks unread);
        # f2d: the 2D test filter on the channel; both 'channel' sums
        yw = variant in ('duct', 'cavity')
        zp, f2d = variant == 'zp', variant == 'f2d'
        a2 = d['alph2_box'] if zp else d['alph2_2d'] if f2d else d['alph2']
        avg = 'channel' if zp or f2d else variant or 'channel'
        s0, num, den = fn(d['u'], d['v'], d['w'], d['ue_c'], d['ve_c'],
                          d['we_c'], a2, d['dzci'], d['dzfi'],
                          d['dxi'], d['dyi'], not zp, not zp, d['zvals'],
                          ye=d['y_mom'][:3] if yw else None,
                          yvals=d['yvals'], avg=avg, zper=zp, f2d=f2d)
        if variant == 'cavity':
            return {'visct': s0}
        # partial sums: compare the per-row totals
        return {'s0': s0, 'num': num.sum(dim=-1), 'den': den.sum(dim=-1)}
    if name == 'dsmag_level1':
        fm, fvel, lij, s0 = fn(d['u'], d['v'], d['w'], d['ue_c'], d['ve_c'],
                               d['we_c'], d['dzci'], d['dzfi'], d['dxi'],
                               d['dyi'], True, True,
                               ye=d['y_mom'][:3] if ywall else None)
        keys = ([f'fm{q}' for q in range(6)] + ['fu', 'fv', 'fw']
                + [f'l{q}' for q in range(6)] + ['s0'])
        return dict(zip(keys, (*fm, *fvel, *lij, s0)))
    if name == 'dsmag_level2':
        yw = variant in ('duct', 'cavity')
        q = d['ds2']
        out = fn(d['u'], d['v'], d['w'], d['ue'], d['ve'], d['we'], q[0:6],
                 q[6:12], q[12], d['alph2'], d['dzci'], d['dzfi'], d['dxi'],
                 d['dyi'], avg=variant or 'channel',
                 ye=d['y_pred'] if yw else None)
        if variant == 'cavity':
            return {'visct': out}
        # partial sums: compare the per-row totals
        return {'num': out[0].sum(dim=-1), 'den': out[1].sum(dim=-1)}
    if name == 'fillps':
        xu = d[f'{variant}_pred'][0] if variant in ('xdev', 'xbox') else None
        return {'rhs': fn(d['u'], d['v'], d['w'], d['ue'], d['ve'], d['we'],
                          d['dzfi'], 1.0, d['dxi'], d['dyi'],
                          yv=d['y_pred'][1] if variant in ('duct', 'xbox')
                          else None, xu=xu)}
    if name == 'correc_updatep':
        xw = variant in ('xdev', 'xbox')
        imp = variant not in ('explicit', 'duct') and not xw
        ykw = (dict(ypp=d['y_pp'], yv=d['y_pred'][1][0])
               if variant in ('duct', 'xbox') else {})
        if xw:
            # explicit, no deferred forcing (x walls run unforced)
            ykw.update(xpp=d[f'{variant}_pp'], xu=d[f'{variant}_pred'][0])
        out = fn(d['u'], d['v'], d['w'], d['pp'], d['p'], d['we'], d['ppe'],
                 0.01, d['dxi'], d['dyi'], d['dzci'], d['dzfi'],
                 None if imp or xw else d['fuv'],
                 alpha=-0.013 if imp else 0.0,
                 impdiff=imp, impdiff_1d=imp and variant != 'impdiff',
                 **ykw)
        return dict(zip(('u', 'v', 'w', 'p'), out))
    if name == 'apply_y':
        return {'out': fn(d['u'], d['fy'],
                          None if variant == 'y_only' else d['fxT'])}
    if name == 'apply_x':
        # slab: the plain layout; split: the forward transpose's x-column
        # blocks written out; chunked: the backward one's read in place
        src = d['slab_blocks'] if variant == 'chunked' else d['slab']
        return {'out': fn(src, d['fxT'],
                          split=2 if variant == 'split' else 1)}
    if name == 'z_eig':
        return {'out': fn(d['u'], d['Vl'], d['Vr'], d['lamz'], d['lamy'],
                          d['lamx'], d['eig_tol'])}
    if name == 'thomas_z':
        nz = d['u'].shape[0]
        if variant == 'poisson':    # lam on the diagonal, singular lane pinned
            out = fn(d['u'], *d['abc_p'], lamy=d['lamy'], lamx=d['lamx'],
                     pin=True, tol=d['th_tol'])
        elif variant == 'helmholtz3d':
            # the full-3D w CN solve: rows and lam alpha-scaled, the tail
            out = fn(d['u'], *d['abc_w'], lamy=d['lam_w3'][0],
                     lamx=d['lam_w3'][1], alpha=ALPHA, n_solve=nz - 1)
        else:                       # the w CN solve of the DNS step
            out = fn(d['u'], *d['abc_w'], alpha=-0.021, shift=d['shift'],
                     bc_lo=d['bc_lo'], bc_hi=d['bc_hi'], n_solve=nz - 1)
        return {'out': out}
    if name == 'wallmodel':
        wm = {'duct': d['wm4'], 'xdev': d['wmx']}.get(variant, d['wm'])
        out = fn(d['wm_u'], d['v'], wm, **wm_kw(d, variant))
        return {f"{('bcu', 'bcv' if f.d == 2 else 'bcw')[i]}_{'xyz'[f.d]}"
                f"{('lo', 'hi')[f.ib]}": q[i]
                for f, q in zip(wm.faces, out) for i in range(2)}
    if name == 'thomas_periodic':
        if variant == 'poisson':    # the TGV's pressure z stage, pinned
            out = fn(d['u'], *d['abc_t'], lamy=d['lam_t'][0],
                     lamx=d['lam_t'][1], pin=True, tol=d['th_tol_t'])
        else:                       # a full-3D CN solve on the box
            out = fn(d['u'], *d['abc_t'], lamy=d['lam_t3'][0],
                     lamx=d['lam_t3'][1], alpha=ALPHA)
        return {'out': out}
    if variant == 'wm':     # the wall model's 'E' recipes on both faces
        fac = d['fac_ex']
        zrec = (('E', fac[0], 0.0, 'E', fac[1], 0.0),) * 2
    zrec = zrec or (('D', 0.0, d['dz01'][0], 'D', 0.0, d['dz01'][1]),) * 2
    out = fn(d['u'], d['v'], d['w'], d['pp'], d['p'], d['ue'], d['ve'],
             d['we'], d['ppe'], 0.01, d['dxi'], d['dyi'], d['dzci'],
             d['dzfi'], d['visc'], d['csd2'], zrec, d['fuv'], d['dw'],
             d['nearlo'], d['tauw_lo'], d['tauw_hi'])
    return dict(zip(('u', 'v', 'w', 'p', 'visct'), out))


def wm_kw(d, variant):
    """The wall model's mode on the inputs d: 'corrected' the fused
    correction's rows; 'rows' the fill's (the initial and check fills, and
    sgstype 'none''s post-correction); 'duct' the fill's rows of the duct's
    four faces (w sampled on the y faces)."""
    if variant in ('rows', 'xdev'):
        return {}
    if variant == 'duct':
        return dict(w=d['w'])
    return dict(fuv=d['fuv'], pp=d['pp'], dtrk=0.01, dxi=d['dxi'],
                dyi=d['dyi'])


def wm_steps(d, variant):
    """The Newton steps each point of the wall model's planes needs on the
    inputs d, counted on the float64 twin's iteration
    (wallmodel.wm_newton_steps; 0 off the planes' ranges)."""
    from cales_torch import wallmodel as wmod
    d64 = {k: d[k].double() if torch.is_tensor(d[k]) else d[k]
           for k in ('wm_u', 'v', 'w', 'pp', 'fuv', 'dxi', 'dyi')}
    return wmod.wm_newton_steps(d64['wm_u'], d64['v'],
                                {'duct': d['wm4'], 'xdev': d['wmx']}.get(
                                    variant, d['wm']),
                                **wm_kw(d64, variant))


def compare(name, d, tol_abs=None, tol_rel=None, **kw):
    """Kernel against its twin, both on the card with the same inputs;
    returns the worst error over the outputs."""
    got = call(name, d, **kw)
    ref = call(name, d, twin=True, **kw)
    torch.cuda.synchronize()
    worst = 0.0
    tag = f'{name}[{kw["variant"]}]' if kw.get('variant') else name
    for key in got:
        err = float((got[key] - ref[key]).abs().max())
        scale = float(ref[key].abs().max())
        worst = max(worst, err)
        bound = tol_abs if tol_abs is not None else tol_rel * scale
        say(f'  {tag:<24s} {key:<5s} max|err| {err:.3e}  '
            f'(max|ref| {scale:.3e}, bound {bound:.1e})')
        require(np.isfinite(err) and err <= bound,
                f'{tag}.{key}: error {err:.3e} above {bound:.1e}')
    return worst


def graph_ms(fn, n=20):
    """Device time of one call of fn: n calls captured in a CUDA graph,
    replayed with CUDA events around, so no host launch cost sits between
    them (a kernel shorter than its wrapper's host time: the wall model)."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def time_ms(fn, n=10):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

# per-kernel variants held against the twins in phase 2; the first is the
# one timed for the report in phase 2b
VARIANTS = {
    'mom_rk': ('les', 'dns', 'les_split', 'duct', 'xyz', 'les_xyz', 'tgv',
               'xdev', 'xbox', 'xdev_s', 'xdev_1d', 'xbox_s', 'les_sc',
               'duct_sc', 'xdev_sc'),
    'fillps': (None, 'duct', 'xdev', 'xbox'), 'correc_smag': (None, 'wm'),
    'correc_updatep': ('impdiff_1d', 'explicit', 'duct', 'impdiff', 'xdev',
                       'xbox'),
    'apply_y': ('x_and_y', 'y_only'), 'z_eig': (None,),
    'thomas_z': ('helmholtz', 'poisson', 'helmholtz3d'),
    'smag': (None, 'duct_e', 'duct', 'xdev', 'xbox', 'nowall'),
    'dsmag': (None, 'duct', 'cavity', 'zp', 'f2d'),
    'thomas_periodic': ('poisson', 'helmholtz'),
    'dsmag_level1': (None, 'duct'), 'dsmag_level2': (None, 'duct', 'cavity'),
    'apply_x': ('slab', 'split', 'chunked'),
    'wallmodel': ('corrected', 'rows', 'duct', 'xdev'),
}
# the report rows of the other variants, by (kernel, variant)
VARIANT_ROW_OF = {kv: row for row, kv in VARIANT_ROWS.items()}
# bounded relative to the output's maximum: sums over many terms
RELATIVE = ('apply_y', 'z_eig', 'thomas_z', 'dsmag', 'thomas_periodic',
            'dsmag_level1', 'dsmag_level2', 'apply_x', 'wallmodel')
# the wall model's planes in float64: within this of their maximum (the
# Newton iteration converges the same way on both; logs and divisions
# round apart); so smag's y-wall variant
WM_TOL64 = 1e-13
REL64 = (('smag', 'duct'), ('smag', 'duct_e'), ('smag', 'xdev'),
         ('smag', 'xbox'), ('mom_rk', 'les_sc'), ('mom_rk', 'duct_sc'),
         ('mom_rk', 'xdev_sc'))
# the kernels whose float32 error is held against their float64 twin in
# phase 2b; for the GEMM kernels (3xTF32) and the reordered Thomas solves
# (chunks and cyclic reduction) it must stay within 4x the error of their
# float32 twin (the library matmul, the sweep) against the same float64
# twin
F64_TWIN = ('dsmag_level1', 'dsmag_level2', 'apply_y', 'apply_x', 'z_eig',
            'thomas_periodic', 'thomas_z', 'wallmodel', 'smag')
FOUR_X = ('apply_y', 'apply_x', 'z_eig', 'thomas_periodic', 'thomas_z')
# their float32 error against their float32 twin is then held to what the
# 4x rule leaves (their own and the twin's against the float64 twin), not
# to 1e-5
REORDERED = ('thomas_periodic', 'thomas_z')
# the full-3D CN solves' alpha in the kernel inputs
ALPHA = -0.043
# (interior fields read, fields written, floating-point operations a cell)
# of each kernel's timed variant, counted from its source (the solve
# kernels' matrix products are added in work()).  dsmag counts what the
# function needs, not its kernel's halo recomputation: the source
# quantities (the strain rate's 92 + 18), 18 separable (1,2,1)/4 filters
# at 3 passes of 4 with each pass shared across the plane, and the test-
# level strain (92) with M_ij, L_ij and the contraction (55); dsmag_level1
# the source quantities and the 18 filters, dsmag_level2 the test level
# (it reads fvel, fm and lij; |S| too for 'cavity', which writes nu_t)
WORK = {'mom_rk': (8, 6, 230), 'fillps': (3, 1, 12),
        'correc_smag': (5, 5, 115), 'correc_updatep': (5, 4, 20),
        'apply_y': (1, 1, 0), 'z_eig': (1, 1, 3), 'thomas_z': (1, 1, 8),
        'smag': (3, 1, 100), 'dsmag': (3, 1, 110 + 18 * 12 + 147),
        # the forward sweep's two right-hand sides (9), both
        # back-substitutions (4), the last row and the combine (2)
        'thomas_periodic': (1, 1, 15),
        'dsmag_level1': (3, 16, 110 + 18 * 12), 'dsmag_level2': (15, 0, 147),
        'apply_x': (1, 1, 0)}
# the wall model's work: a Newton solve a point of each plane's range
# (its start 4, its result 4, its inputs 20: the interpolation to hwm, the
# wall-relative rows, |u_par|), 14 a step for the steps these inputs need
# (two divisions, a logarithm, 8 more and the exit test; wm_steps), and in
# the corrected mode 4 a corrected value, u and v of both rows (16 a cell)
WM_SOLVE_OPS, WM_STEP_OPS, WM_CORRECT_OPS = 28, 14, 16
# variants whose reads or arithmetic differ from their kernel's first
# the scalar variants read s and rso and write s and ds, and add the
# scalar's 58 operations a cell (its six fluxes 18, six gradients 12, the
# RHS 20, the update 8)
WORK_VARIANT = {('mom_rk', 'les_sc'): (10, 8, 288),
                ('mom_rk', 'duct_sc'): (10, 8, 288),
                ('mom_rk', 'xdev_sc'): (10, 8, 288),
                # the scalar without nu_t (phase 10xs's slab)
                ('mom_rk', 'xsc_slab'): (9, 8, 258),
                ('mom_rk', 'xyz'): (7, 6, 200),
                ('mom_rk', 'tgv'): (7, 6, 200),
                ('mom_rk', 'xdev'): (7, 6, 200),
                ('mom_rk', 'xbox'): (7, 6, 200),
                ('correc_updatep', 'impdiff'): (5, 4, 34),
                ('dsmag_level2', 'cavity'): (16, 1, 147),
                # no wall: the strain rate's 92 and (Cs Delta)^2 |S|
                ('smag', 'nowall'): (3, 1, 93),
                # the 2D filter: each of the 18 filters two passes of 4
                ('dsmag', 'f2d'): (3, 1, 110 + 18 * 8 + 147)}
# the matrix-product kernels: their plain twin is a single library product
# (cuBLAS), timed as the yardstick library_ms, and their float32 bound is
# reckoned at PEAK_TF32X3 (the SIMT figure at PEAK_FLOPS beside it)
LIBRARY_TWIN = ('apply_y', 'z_eig', 'apply_x')
# the kernels timed on the device by graph_ms: their wrapper's host time
# exceeds the kernel's, so launches one by one time the host
GRAPH_TIMED = ('wallmodel',)


def ystacks(name, d, variant):
    """The y-row stacks and x stacks a walled variant reads, as tensors."""
    out = []
    if variant in ('duct_sc', 'xdev_sc'):
        # the velocity's, nu_t's and p's stacks, and the scalar's
        pairs = ((*d['y_mom'], d['y_sca']) if variant == 'duct_sc'
                 else (*d['xdev_mom_s'], d['xdev_sca']))
        return [q for pair in pairs for q in pair]
    if variant in ('xdev_s', 'xdev_1d', 'xbox_s'):
        xw = variant[:4]
        out = [q for pair in d[f'{xw}_mom_s'] for q in pair]
        if xw == 'xdev':
            return out
        return out + [q for pair in d['y_mom'] for q in pair]
    if variant in ('xdev', 'xbox'):
        pairs = {'mom_rk': [q for q in d[f'{variant}_mom'] if q is not None],
                 'fillps': [d[f'{variant}_pred'][0]],
                 'correc_updatep': [d[f'{variant}_pp'],
                                    d[f'{variant}_pred'][0]],
                 # the stacks, the x walls' profiles and shear planes
                 'smag': [*d[f'{variant}_mom'][:3],
                          d[f'{variant}_xwall']]}[name]
        out = [q for pair in pairs for q in pair]
        if variant == 'xdev':
            return out
        if name == 'mom_rk':
            return out + [q for m in (0, 1, 2, 4) for q in d['y_mom'][m]]
        if name == 'smag':
            return out + [q for pair in (*d['y_mom'][:3], d['ywall'])
                          for q in pair]
    elif variant not in ('duct', 'cavity', 'duct_e'):
        return []
    pairs = {'mom_rk': d['y_mom'], 'fillps': [d['y_pred'][1]],
             'correc_updatep': [d['y_pp'], (d['y_pred'][1][0],)],
             'dsmag': d['y_mom'][:3], 'dsmag_level1': d['y_mom'][:3],
             'dsmag_level2': d['y_pred'],
             # the stacks, the y walls' profiles and shear planes
             'smag': [*d['y_mom'][:3], d['ywall']]}[name]
    return out + [q for pair in pairs for q in pair]


def work(name, d, variant=None):
    """(bytes, flops) the kernel's variant must move and do on the inputs
    d: each interior field (and y-row stack) read once and each output
    written once, and its arithmetic (the operator products of the solve
    kernels at 2 n^2 per line)."""
    nz, ny, nx = (d['slab'] if name == 'apply_x' else d['u']).shape
    if name == 'wallmodel':
        # two rows of its two components a face (and of pp, corrected), a
        # z face's (ny, nx), a y face's (nz, nx), and the face's two padded
        # planes
        wm = {'duct': d['wm4'], 'xdev': d['wmx']}.get(variant, d['wm'])
        rows = [(nz if f.d == 1 else ny) for f in wm.faces]
        nin = 2 * (3 if variant == 'corrected' else 2)
        nbytes = sum(nin * n * nx + 2 * (n + 2) * (nx + 2)
                     for n in rows) * d['u'].element_size()
        solves = sum(n * (nx + 1) + (n + 1) * nx for n in rows)
        flops = (solves * WM_SOLVE_OPS
                 + sum(int(q.sum()) for q in wm_steps(d, variant))
                 * WM_STEP_OPS)
        if variant == 'corrected':
            flops += len(rows) * ny * nx * WM_CORRECT_OPS
        return nbytes, flops
    cells = nx * ny * nz
    nin, nout, per_cell = WORK_VARIANT.get((name, variant), WORK[name])
    nbytes = (nin + nout) * cells * d['u'].element_size()
    nbytes += sum(q.numel() * q.element_size()
                  for q in ystacks(name, d, variant))
    flops = per_cell * cells
    if name == 'apply_y':
        flops += 2 * ny * cells + 2 * nx * cells
    if name == 'z_eig':
        flops += 2 * 2 * nz * cells
    if name == 'apply_x':
        flops += 2 * nx * cells
        nbytes += nx * nx * d['u'].element_size()
    return nbytes, flops


def bound_ms(name, d, variant=None, simt=False):
    """The least time of the kernel's work: its bytes at PEAK_BPS or its
    arithmetic, at the 3xTF32 rate for the float32 matrix products (or,
    with simt, at the SIMT fp32 rate), else at PEAK_FLOPS."""
    nbytes, flops = work(name, d, variant)
    dtype = d['u'].dtype
    rate = (PEAK_TF32X3 if (name in LIBRARY_TWIN and dtype == torch.float32
                            and not simt) else PEAK_FLOPS[dtype])
    t_bytes = nbytes / PEAK_BPS * 1e3
    t_ops = flops / rate * 1e3
    return max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations'


def f32_vs_f64_twin(name, d, d64, variant):
    """(the float32 kernel's, and its float32 twin's, max|err| / max|ref|
    against the float64 twin on the same inputs, worst output)."""
    got = call(name, d, variant=variant)
    lib = call(name, d, twin=True, variant=variant)
    ref = call(name, d64, twin=True, variant=variant)
    rel = [max(float((a[k].double() - ref[k]).abs().max()
                     / ref[k].abs().max()) for k in a) for a in (got, lib)]
    return tuple(rel)


def phase_kernels(dev, card):
    """Kernel vs twin: small non-aligned shape in f64 and f32 (indexing
    to round-off), then the headline shape in f32 on the card with the
    kernel's and the twin's times.  Solve kernels are bounded relative to
    the output's maximum (sums over up to nx terms)."""
    small = (72, 40, 48)
    for dtype, tol_abs, tol_rel in ((torch.float64, 1e-12, 1e-12),
                                    (torch.float32, None, 1e-5)):
        d = kernel_inputs(small, dtype, dev, SEED)
        say(f'phase 2: kernels vs twins, (nx, ny, nz) = {small}, {dtype}')
        for name, variants in VARIANTS.items():
            for variant in variants:
                rel64 = (name == 'wallmodel' or (name, variant) in REL64)
                ta = None if name in RELATIVE or rel64 else tol_abs
                tr = (WM_TOL64 if rel64 and dtype == torch.float64
                      else tol_rel)
                rounds = (False, True) if name == 'mom_rk' else (True,)
                for has_ruo in rounds:
                    compare(name, d, ta, tr, variant=variant,
                            has_ruo=has_ruo)
        zn = (('N', 0.3, d['dz01'][0], 'N', -0.2, d['dz01'][1]),
              ('D', 0.1, d['dz01'][0], 'N', 0.05, d['dz01'][1]))
        compare('correc_smag', d, tol_abs, tol_rel, zrec=zn)
        del d
    say(f'phase 2b: kernels vs twins on the card at (nx, ny, nz) = '
        f'{HEADLINE_NG}, float32  [{card}]')
    d = kernel_inputs(HEADLINE_NG, torch.float32, dev, SEED + 1, big=True)
    rows, cache = {}, {}
    for name, variants in VARIANTS.items():
        for i, variant in enumerate(variants):
            row = name if i == 0 else VARIANT_ROW_OF.get((name, variant))
            _time_row(rows, row, name, d, variant, card, cache)
            torch.cuda.empty_cache()
    del d, cache
    torch.cuda.empty_cache()
    ng = TGV_CFG['ng']
    say(f'phase 2b: mom_rk without nu_t, thomas_periodic and thomas_z '
        f'pinned at (nx, ny, nz) = {ng}, float32  [{card}]')
    d = kernel_inputs(ng, torch.float32, dev, SEED + 2, big=True)
    for key in ('ds2', 'slab', 'slab_blocks', 'y_mom', 'y_pred', 'y_pp',
                'wm_u'):
        del d[key]
    cache = {}
    for row, (name, variant) in BIG_ROWS.items():
        _time_row(rows, row, name, d, variant, card, cache)
    del d, cache
    torch.cuda.empty_cache()
    rows.update(walled_slab_rows(dev, card))
    rows.update(slab_mode_rows(dev, card))
    rows.update(slab_twopass_rows(dev, card))
    rows.update(slab_imp3d_x_rows(dev, card))
    rows.update(slab_xy_rows(dev, card))
    rows.update(real_view_rows(dev, card))
    rows.update(pencil_rows(dev, card))
    return rows


def walled_slab_inputs(dev, dtype, own, seed):
    """The inputs of the y-walled slab variants on a slab of WALLED_SLAB_NG
    that owns the y walls own = (lower, upper): seeded random interiors,
    z-edge stacks and halo rows (one and two deep) on the card, the wall
    stacks of the duct's fill (DUCT_CFG's letters, MOVING's values) built
    on the slab as the main path builds them, and the slab's y-row stacks
    (boundary.slab_ystack).  Returns (sim, {name: (args, kwargs)}), the
    wrappers' and twins' arguments by kernel ('dsmag duct', 'dsmag
    cavity')."""
    from cales_torch.config import Config
    from cales_torch.grid import make_grid_from_config
    from cales_torch.ops import boundary as bnd
    from cales_torch.timeloop import Simulation
    cfg = Config(**{**DUCT_CFG, 'ng': WALLED_SLAB_NG, 'bcvel': MOVING,
                    'sgstype': 'smag', 'dtype': str(dtype)[6:]})
    sim = Simulation(cfg, make_grid_from_config(cfg), device=dev)
    nx, ny, nz = cfg.ng
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, scale=0.02):
        return scale * torch.randn(shape, generator=gen, device=dev,
                                   dtype=dtype)
    u, v, w, p, pp, ru, rv, rw = (rnd(nz, ny, nx) for _ in range(8))
    s = 1e-3 * torch.rand((nz, ny, nx), generator=gen, device=dev,
                          dtype=dtype)
    bcs = (sim.bcu_vals, sim.bcv_vals, sim.bcw_vals)
    ue, ve, we = sim._zedge_vel(u, v, w, *bcs)
    se, pe, ppe = sim._zedge_s(s), sim._zedge_p(p), sim._zedge_p(pp)

    def halo(q, depth=1):
        return (rnd(q.shape[0], 2 * depth, nx), rnd(3, 2 * depth, nx))

    def slab(fields, edges, walls, depth=1):
        h = [halo(q, depth) for q in fields]
        return [bnd.slab_ystack(q, e, y, hh, own)
                for q, e, y, hh in zip(fields, edges, walls, h)], h
    # the post-correction fill (mom_rk, smag, dsmag) and the prediction
    # fill (fillps, correc_updatep)
    vlo = (None, torch.zeros((nz + 2, nx + 2), dtype=dtype, device=dev),
           torch.zeros((ny + 2, nx + 2), dtype=dtype, device=dev))
    post = sim._yedge_vel(u, v, w, bcs, vlo=vlo, is_correc=True)
    ymom, _ = slab((u, v, w, s, p), (ue, ve, we, se, pe),
                   (*post, sim._yedge_s(s), sim._yedge_p(p)))
    ypred, _ = slab((v,), (ve,), (sim._yedge_vel(u, v, w)[1],))
    (ypp,), _ = slab((pp,), (ppe,), (sim._yedge_p(pp),))
    yds, h2 = slab((u, v, w), (ue, ve, we), post, depth=2)
    dxi, dyi = cfg.dli[0], cfg.dli[1]
    ywall = (sim.dwy_t, sim.nearylo_t, 1e-2 * (1.0 + rnd(nz, nx)),
             1e-2 * (1.0 + rnd(nz, nx)))
    tauw = [1e-2 * (1.0 + rnd(ny, nx)) for _ in range(2)]
    alph2 = torch.full((nz,), 4.0, dtype=dtype, device=dev)
    alph2[0] = alph2[-1] = 2.52
    ds = ((u, v, w, ue, ve, we, alph2, sim.dzci_t, sim.dzfi_t, dxi, dyi,
           True, True, sim.dsmag_zvals),
          dict(ye=yds, yh=h2, yown=own, yvals=sim.dsmag_yvals))
    calls = {
        'mom_rk': ((u, v, w, s, p, ue, ve, we, se, pe, ru, rv, rw,
                    sim.dzci_t, sim.dzfi_t, 0.01, -0.005, cfg.visc, dxi, dyi,
                    cfg.bforce), dict(sums=(True, False), ye=ymom)),
        'fillps': ((u, v, w, ue, ve, we, sim.dzfi_t, 100.0, dxi, dyi),
                   dict(yv=ypred[0])),
        'correc_updatep': ((u, v, w, pp, p, we, ppe, 0.01, dxi, dyi,
                            sim.dzci_t, sim.dzfi_t),
                           dict(ypp=ypp, yv=ypred[0][0])),
        'smag': ((u, v, w, ue, ve, we, sim.dzci_t, sim.dzfi_t, dxi, dyi,
                  cfg.visc, sim.csd2_t, sim.dw_t, sim.nearlo_t, *tauw),
                 dict(ye=ymom[:3], ywall=ywall)),
        'dsmag duct': (ds[0], dict(ds[1], avg='duct')),
        'dsmag cavity': (ds[0], dict(ds[1], avg='cavity'))}
    return sim, calls


def walled_slab_rows(dev, card):
    """Phase 2b's rows of the y-walled slab variants (WALLED_SLAB_ROWS):
    each on a slab that owns the lower wall and on one that owns the upper,
    its float32 kernel against its float32 twin (within 1e-5 of each
    output's maximum, as phase 2b's random inputs hold) and against the
    float64 twin on the same inputs (reported), both timed (CUDA events),
    and its bound: each interior and each stack and halo read once, each
    output written once, or its arithmetic."""
    from cales_torch.ops import kernels as K

    def outputs(res, name):
        res = [q for q in (res if isinstance(res, tuple) else (res,))
               if q is not None]
        if name == 'mom_rk':        # the partial sums: per-plane totals
            res[-1] = res[-1].sum(dim=1)
        if name == 'dsmag' and len(res) == 3:   # per-row totals
            res[1:] = [q.sum(dim=-1) for q in res[1:]]
        return res

    to64 = _to64
    say(f'phase 2b: the y-walled slab variants at (nx, ny, nz) = '
        f'{WALLED_SLAB_NG}, float32, on the lower and the upper wall\'s '
        f'slab  [{card}]')
    rows = {}
    for own, side in (((True, False), 'lower'), ((False, True), 'upper')):
        _, calls = walled_slab_inputs(dev, torch.float32, own,
                                      SEED + (7 if own[0] else 8))
        for row, (name, avg) in WALLED_SLAB_ROWS.items():
            a, kw = calls[name if avg is None else f'{name} {avg}']
            fn, twin = getattr(K, name), getattr(K, f'{name}_plain')
            got, ref = outputs(fn(*a, **kw), name), outputs(twin(*a, **kw),
                                                            name)
            ref64 = outputs(twin(*to64(a), **to64(kw)), name)
            errs = [(float((g - r).abs().max()),
                     float((g - r).abs().max() / r.abs().max()))
                    for g, r in zip(got, ref)]
            rel64 = max(float((g.double() - r).abs().max() / r.abs().max())
                        for g, r in zip(got, ref64))
            worst = max(e[0] for e in errs)
            worst_rel = max(e[1] for e in errs)
            tag = f'{row} [{side} wall]'
            require(all(np.isfinite(e[0]) and e[1] <= 1e-5 for e in errs),
                    f'{tag}: error {worst_rel:.3e} of an output maximum, '
                    'above 1e-5')
            ms = time_ms(lambda: fn(*a, **kw))
            plain_ms = time_ms(lambda: twin(*a, **kw), n=3)
            u = a[0]
            nin, nout, per_cell = ((8, 6, 230) if name == 'mom_rk'
                                   else WORK[name])
            if name == 'dsmag' and avg == 'cavity':
                nout = 1
            stacks = _flat([kw.get(k) for k in ('ye', 'yv', 'ypp', 'yh',
                                                'ywall')])
            nbytes = ((nin + nout) * u.numel() * u.element_size()
                      + sum(q.numel() * q.element_size() for q in stacks))
            t_b = nbytes / PEAK_BPS * 1e3
            t_o = per_cell * u.numel() / PEAK_FLOPS[u.dtype] * 1e3
            say(f'  {tag:<40s} max|err| {worst:.3e} (per output / its '
                f'max|ref|: ' + ' '.join(f'{e[1]:.1e}' for e in errs)
                + f'; float32 against the float64 twin {rel64:.2e}), kernel '
                f'{ms:.4f} ms, plain twin {plain_ms:.3f} ms, bound '
                f'{max(t_b, t_o):.4f} ms by '
                f'{"bytes" if t_b >= t_o else "operations"}  [{card}]')
            if own[0]:
                rows[row] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                                 bound_ms=max(t_b, t_o),
                                 bound_by='bytes' if t_b >= t_o
                                 else 'operations', library_ms=None,
                                 max_rel_err=worst_rel,
                                 f32_vs_f64_twin=rel64,
                                 shape=list(WALLED_SLAB_NG))
            else:
                r = rows[row]
                r.update(ms_upper_wall_slab=ms,
                         plain_ms_upper_wall_slab=plain_ms,
                         max_abs_err=max(r['max_abs_err'], worst),
                         max_rel_err=max(r['max_rel_err'], worst_rel),
                         f32_vs_f64_twin=max(r['f32_vs_f64_twin'], rel64))
        del calls
        torch.cuda.empty_cache()
    return rows


def _to64(x):
    """Tensors (in lists, tuples and dicts too) in float64."""
    if torch.is_tensor(x):
        return x.double() if x.is_floating_point() else x
    if isinstance(x, (list, tuple)) and not hasattr(x, '_fields'):
        return type(x)(_to64(q) for q in x)
    if isinstance(x, dict):
        return {k: _to64(q) for k, q in x.items()}
    return x


def _rel_errs(got, ref):
    """(max|err|, max|err| / max|ref|) of each output."""
    return [(float((g.double() - r.double()).abs().max()),
             float((g.double() - r.double()).abs().max()
                   / r.double().abs().max())) for g, r in zip(got, ref)]


def _slab_row(row, errs, rel64, ms, plain_ms, nbytes, flops, dtype, card,
              **extra):
    """A phase 2b slab-mode row: its errors, times and bound (bytes at
    PEAK_BPS, operations at PEAK_FLOPS), said and returned."""
    t_b = nbytes / PEAK_BPS * 1e3
    t_o = flops / PEAK_FLOPS[dtype] * 1e3
    worst = max(e[0] for e in errs)
    out = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
               bound_ms=max(t_b, t_o),
               bound_by='bytes' if t_b >= t_o else 'operations',
               library_ms=None, max_rel_err=max(e[1] for e in errs),
               f32_vs_f64_twin=rel64, **extra)
    say(f'  {row:<42s} max|err| {worst:.3e} (per output / its max|ref|: '
        + ' '.join(f'{e[1]:.1e}' for e in errs) + f'; float32 against the '
        f'float64 twin {rel64:.2e}), kernel {ms:.4f} ms, plain twin '
        f'{plain_ms:.3f} ms, bound {out["bound_ms"]:.4f} ms by '
        f'{out["bound_by"]}  [{card}]')
    return out


def slab_mode_rows(dev, card):
    """Phase 2b's rows of SLAB_MODE_ROWS at the headline's slab on dims
    (2, 1), float32, each against its float32 twin and the float64 twin on
    the same inputs, timed with its twin, and its bound (each input, halo
    and output moved once, or the arithmetic these inputs need):
      the wall model's y-walled slab variant: DUCT_WMLES_CFG's faces on the
        lower and the upper wall's slab (nx, ny/2, nz) of seeded fields
        (wallmodel.slab_wall_model: the two z faces, their rows' y halos
        cut from the whole field, the y face the slab owns), within 1e-5 of
        each plane's maximum, the float64 kernel within 1e-13 of the
        float64 twin's; timed by a CUDA graph (its wrapper's host time
        exceeds the kernel's);
      dsmag's ZP + YH mode: TRI_CFG's box with 'dit' on a slab, the
        'channel' sums (per-row totals) within 1e-5 of each output's
        maximum;
      thomas_periodic, pinned, on the pencil (nz, ny, nx/2) of TRI_CFG's
        Poisson system, rank 0's lamx lanes and rank 1's, the pin flag
        where the lanes hold the singular one (poisson._holds_singular),
        the singular lane's right-hand side of zero sum as a divergence's;
        within 4x the float32 twin's error against the float64 twin."""
    from cales_torch import poisson
    from cales_torch import wallmodel as wmod
    from cales_torch.config import Config
    from cales_torch.grid import make_grid_from_config
    from cales_torch.ops import kernels as K
    from cales_torch.ops import solve_kernels as SK
    f32 = torch.float32
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev,
                                   dtype=f32)
    nx, ny, nz = HEADLINE_NG
    nyl = ny // 2
    rows = {}
    say(f'phase 2b: the slab modes of the wall-modelled duct and the '
        f'periodic box at the slab (nx, ny/2, nz) = {(nx, nyl, nz)} and the '
        f'pencil (nx/2, ny, nz) = {(nx // 2, ny, nz)}, float32  [{card}]')
    # the wall model's y-walled slab variant
    cfg = Config(**DUCT_WMLES_CFG)
    grid = make_grid_from_config(cfg)
    wm = wmod.wall_model(cfg, grid, wmod.find_index_wm(cfg, grid))
    U = (1.0 + rnd(nz, ny, nx, scale=0.1), rnd(nz, ny, nx, scale=0.1),
         rnd(nz, ny, nx, scale=0.1))
    row = 'wallmodel (y walls, slab)'
    for own in ((True, False), (False, True)):
        y0 = 0 if own[0] else nyl
        wms = wmod.slab_wall_model(wm, y0, nyl, own)
        u, v, w = (q[:, y0:y0 + nyl].contiguous() for q in U)
        yh = wmod.sampled_rows(*U[:2], wms)[
            :, [(y0 - 1) % ny, (y0 + nyl) % ny]].contiguous()
        kw = dict(w=w, yh=yh, yown=own)
        got = K.wm_planes(u, v, wms, **kw)
        ref = K.wm_planes_plain(u, v, wms, **kw)
        d64 = [q.double() for q in (u, v, w, yh)]
        kw64 = dict(w=d64[2], yh=d64[3], yown=own)
        ref64 = K.wm_planes_plain(*d64[:2], wms, **kw64)
        errs = _rel_errs(got, ref)
        rel64 = max(e[1] for e in _rel_errs(got, ref64))
        err64 = max(e[1] for e in _rel_errs(
            K.wm_planes(*d64[:2], wms, **kw64), ref64))
        side = 'lower' if own[0] else 'upper'
        require(all(np.isfinite(e[0]) and e[1] <= 1e-5 for e in errs),
                f'{row} [{side} wall]: error above 1e-5 of a plane maximum')
        require(err64 <= WM_TOL64, f'{row} [{side} wall]: float64 kernel '
                f'{err64:.3e} from its twin, above {WM_TOL64:.0e}')
        ms = graph_ms(lambda: K.wm_planes(u, v, wms, **kw))
        plain_ms = time_ms(lambda: K.wm_planes_plain(u, v, wms, **kw), n=3)
        ns = [nz if f.d == 1 else nyl for f in wms.faces]
        nbytes = (sum(4 * n * nx + 2 * (n + 2) * (nx + 2) for n in ns)
                  * 4 + yh.numel() * 4)
        steps = sum(int(q.sum()) for q in wmod.wm_newton_steps(
            *d64[:2], wms, **kw64))
        flops = (sum(n * (nx + 1) + (n + 1) * nx for n in ns) * WM_SOLVE_OPS
                 + steps * WM_STEP_OPS)
        r = _slab_row(f'{row} [{side} wall]', errs, rel64, ms, plain_ms,
                      nbytes, flops, f32, card, f64_vs_f64_twin=err64,
                      faces=len(ns), shape=[nx, nyl, nz])
        if own[0]:
            rows[row] = r
        else:
            rows[row].update(ms_upper_wall_slab=ms,
                             plain_ms_upper_wall_slab=plain_ms,
                             max_abs_err=max(rows[row]['max_abs_err'],
                                             r['max_abs_err']),
                             max_rel_err=max(rows[row]['max_rel_err'],
                                             r['max_rel_err']),
                             f32_vs_f64_twin=max(rows[row]['f32_vs_f64_twin'],
                                                 rel64))
    del U, u, v, w, got, ref, ref64, d64
    torch.cuda.empty_cache()
    # dsmag's ZP + YH mode on the box's slab
    cfg = Config(**TRI_CFG)
    grid = make_grid_from_config(cfg)
    U = [rnd(nz, ny, nx, scale=0.02) for _ in range(3)]
    y0 = 0
    q = [a[:, y0:y0 + nyl].contiguous() for a in U]
    e = [torch.stack([a[-1], a[-1], a[0]])[:, y0:y0 + nyl].contiguous()
         for a in U]
    hrows = [(y0 + j) % ny for j in (-2, -1, nyl, nyl + 1)]
    yh = [(a[:, hrows].contiguous(),
           torch.stack([a[-1], a[-1], a[0]])[:, hrows].contiguous())
          for a in U]
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=f32,  # noqa: E731
                                  device=dev)
    args = (*q, *e, torch.full((nz,), 4.0, dtype=f32, device=dev),
            t(grid.dzci), t(grid.dzfi), cfg.dli[0], cfg.dli[1], False, False)
    kw = dict(avg='channel', zper=True, yh=yh)

    def totals(res):
        return [res[0], res[1].sum(dim=-1), res[2].sum(dim=-1)]
    got = totals(K.dsmag(*args, **kw))
    ref = totals(K.dsmag_plain(*args, **kw))
    args64 = tuple(a.double() if torch.is_tensor(a) else a for a in args)
    ref64 = totals(K.dsmag_plain(*args64, avg='channel', zper=True,
                                 yh=[(a.double(), b.double())
                                     for a, b in yh]))
    errs = _rel_errs(got, ref)
    rel64 = max(er[1] for er in _rel_errs(got, ref64))
    row = 'dsmag (periodic z, slab)'
    require(all(np.isfinite(er[0]) and er[1] <= 1e-5 for er in errs),
            f'{row}: error above 1e-5 of an output maximum')
    ms = time_ms(lambda: K.dsmag(*args, **kw))
    plain_ms = time_ms(lambda: K.dsmag_plain(*args, **kw), n=3)
    nin, nout, per_cell = WORK['dsmag']
    cells = nz * nyl * nx
    halo = sum(a.numel() + b.numel() for a, b in yh) * 4
    rows[row] = _slab_row(row, errs, rel64, ms, plain_ms,
                          (nin + nout) * cells * 4 + halo, per_cell * cells,
                          f32, card, halo_bytes=halo, shape=[nx, nyl, nz])
    del U, q, e, yh, args, args64, got, ref, ref64
    torch.cuda.empty_cache()
    # thomas_periodic on the pencil of each rank
    sv = poisson.make_solver(cfg, grid, tuple(cfg.cbc_pre(dd)
                                              for dd in range(3)),
                             ('c', 'c', 'c'))
    nxl = nx // 2
    tol = poisson._thomas_tol(sv.lamx, sv.lamy, f32)
    abc = [torch.as_tensor(a, dtype=torch.float64, device=dev)
           for a in (sv.a, sv.b, sv.c)]
    lamy = t(sv.lamy)
    row = 'thomas_periodic (pencil)'
    for rank in range(2):
        lamx_np = sv.lamx[rank * nxl:(rank + 1) * nxl]
        pin = poisson._holds_singular(lamx_np, sv.lamy, tol)
        body = rnd(nz, ny, nxl)
        # the singular lane's column summed to 0 along z, as a divergence's
        # transform is (its volume mean): the main path's right-hand side
        lane = np.abs(lamx_np[None, :] + sv.lamy[:, None]) <= tol
        for j, i in np.argwhere(lane):
            body[:, j, i] -= body[:, j, i].mean()
        kw = dict(lamy=lamy, lamx=t(lamx_np), pin=pin, tol=tol)
        got = SK.thomas_periodic_z(body, *abc, **kw)
        ref = SK.thomas_periodic_z_plain(body, *abc, **kw)
        # the float64 twin on the same (float32) inputs
        ref64 = SK.thomas_periodic_z_plain(
            body.double(), *abc, lamy=lamy.double(),
            lamx=kw['lamx'].double(), pin=pin, tol=tol)
        errs = _rel_errs([got], [ref])
        rel64 = _rel_errs([got], [ref64])[0][1]
        lib64 = _rel_errs([ref], [ref64])[0][1]
        require(np.isfinite(errs[0][0]) and rel64 <= 4.0 * lib64,
                f'{row} [rank {rank}]: {rel64:.3e} against the float64 '
                f'twin, above 4x the float32 twin\'s {lib64:.3e}')
        ms = time_ms(lambda: SK.thomas_periodic_z(body, *abc, **kw))
        plain_ms = time_ms(lambda: SK.thomas_periodic_z_plain(body, *abc,
                                                              **kw), n=3)
        nin, nout, per_cell = WORK['thomas_periodic']
        cells = nz * ny * nxl
        r = _slab_row(f'{row} [rank {rank}, pin {pin}]', errs, rel64, ms,
                      plain_ms, (nin + nout) * cells * 4, per_cell * cells,
                      f32, card, f32_twin_vs_f64_twin=lib64,
                      shape=[nxl, ny, nz])
        if rank == 0:
            rows[row] = dict(r, pinned_rank=0 if pin else None)
        else:
            rows[row].update(ms_rank1=ms, plain_ms_rank1=plain_ms)
            if pin:
                rows[row]['pinned_rank'] = 1
    require(rows[row]['pinned_rank'] is not None,
            f'{row}: no rank holds the singular lane')
    return rows


def _check_row(row, fn, twin, a, kw, totals, work_of, card, shape,
               timer=None):
    """A phase 2b slab-mode row: the float32 kernel against its float32
    twin (within 1e-5 of each output's maximum) and, on the same inputs in
    float64, the float64 kernel against the float64 twin (within 1e-12)
    and the float32 kernel against the float64 twin (reported); timed with
    its twin (CUDA events), its bound from work_of() -> (bytes,
    operations); totals(list of outputs) -> their comparable form (partial
    sums as totals); timer: the kernel's timer (time_ms by default,
    graph_ms for a kernel shorter than its wrapper's host time)."""
    got = totals(_flat(fn(*a, **kw)))
    ref = totals(_flat(twin(*a, **kw)))
    a64, kw64 = _to64(a), _to64(kw)
    ref64 = totals(_flat(twin(*a64, **kw64)))
    err64 = max(e[1] for e in _rel_errs(
        totals(_flat(fn(*a64, **kw64))), ref64))
    errs = _rel_errs(got, ref)
    rel64 = max(e[1] for e in _rel_errs(got, ref64))
    require(all(np.isfinite(e[0]) and e[1] <= 1e-5 for e in errs),
            f'{row}: float32 error above 1e-5 of an output maximum')
    require(err64 <= 1e-12, f'{row}: float64 kernel {err64:.3e} from its '
                            'twin, above 1e-12')
    del a64, kw64, ref64
    ms = (timer or time_ms)(lambda: fn(*a, **kw))
    plain_ms = time_ms(lambda: twin(*a, **kw), n=3)
    nbytes, flops = work_of()
    return _slab_row(row, errs, rel64, ms, plain_ms, nbytes, flops,
                     torch.float32, card, f64_vs_f64_twin=err64,
                     shape=list(shape))


def slab_twopass_rows(dev, card):
    """Phase 2b's rows of the passive scalar's, the two-pass dsmag's and
    the 2D test filter's slab modes (SLAB_MODE_ROWS, phases 10s, 10b,
    10yb, 10f, 10tf) at the headline's slab on dims (2, 1), (nx, ny/2, nz),
    on seeded random fields and halo rows: each float32 kernel against its
    float32 twin (within 1e-5 of each output's maximum), and on the same
    inputs in float64 the float64 kernel against the float64 twin (within
    1e-12 of each output's maximum) and the float32 kernel against the
    float64 twin (reported); timed with its twin (CUDA events), its bound
    the bytes (each input, stack, halo and output once) or the arithmetic:
      mom_rk's scalar variant on a slab (Y_HALO, explicit, with nu_t:
        LES_SC_CFG's channel on the mesh), the six fields' halo rows;
      dsmag_level1 in its YH mode on DSMAG_CFG's channel (the depth-2 halo)
        and in its YW + YH mode on DUCT_CFG's duct (MOVING's values) on the
        lower and the upper wall's slab;
      dsmag_level2 in its YH mode ('channel', the filtered velocity's
        depth-1 halo) and YW + YH mode ('duct') on level1's twin's output;
      dsmag's F2D + YH mode on DSMAG_CFG's channel (alpha^2 2.52), and F2D
        + ZP + YH on TRI_CFG's box."""
    from cales_torch.config import Config
    from cales_torch.grid import make_grid_from_config
    from cales_torch.ops import boundary as bnd
    from cales_torch.ops import kernels as K
    from cales_torch.timeloop import Simulation
    f32 = torch.float32
    nx, ny, nz = HEADLINE_NG
    nyl = ny // 2
    shape = (nx, nyl, nz)
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)

    def rnd(*sz, scale=0.02):
        return scale * torch.randn(sz, generator=gen, device=dev, dtype=f32)

    def halo(depth, n=nz):
        return (rnd(n, 2 * depth, nx), rnd(3, 2 * depth, nx))

    def sim_of(kw):
        cfg = Config(**{**kw, 'ng': shape, 'dims': (1, 1),
                        'dtype': 'float32'})
        return Simulation(cfg, make_grid_from_config(cfg), device=dev)

    def check(row, fn, twin, a, kw, totals, work_of):
        return _check_row(row, fn, twin, a, kw, totals, work_of, card,
                          shape)

    def nbytes_of(nin, nout, extra):
        cells = nx * nyl * nz
        return ((nin + nout) * cells * 4
                + sum(q.numel() * q.element_size() for q in _flat(extra)))
    cells = nx * nyl * nz
    rows = {}
    say(f'phase 2b: the slab modes of the passive scalar, the two-pass '
        f'dsmag and the 2D test filter at the slab (nx, ny/2, nz) = {shape}, '
        f'float32, against their twins in float32 and float64  [{card}]')
    # mom_rk's scalar variant on the channel's slab
    sim = sim_of(LES_SC_CFG)
    u, v, w, p, ru, rv, rw, rso = (rnd(nz, nyl, nx) for _ in range(8))
    s = rnd(nz, nyl, nx, scale=1e-3).abs()
    sca = rnd(nz, nyl, nx, scale=0.3).abs()
    e = [rnd(3, nyl, nx) for _ in range(4)]
    se = rnd(3, nyl, nx, scale=1e-3).abs()
    h = (*(halo(1) for _ in range(3)), (rnd(nz, 2, nx, scale=1e-3).abs(),
                                        rnd(3, 2, nx, scale=1e-3).abs()),
         halo(1), (rnd(nz, 2, nx, scale=0.3).abs(),
                   rnd(3, 2, nx, scale=0.3).abs()))
    cfg = sim.cfg
    a = (u, v, w, s, p, e[0], e[1], e[2], se, e[3], ru, rv, rw, sim.dzci_t,
         sim.dzfi_t, 0.01, -0.005, cfg.visc, cfg.dli[0], cfg.dli[1],
         cfg.bforce)
    kw = dict(sums=(True, False), yh=h, sca=sca, scae=sim._zedge_scal(sca),
              rso=rso, scal=sim.scal_params)

    def mom_totals(res):
        # u, v, w, ru, rv, rw, the usum partial sums, s, ds
        return [*res[:6], res[6].sum(dim=1), *res[7:]]
    nin, nout, per_cell = WORK_VARIANT[('mom_rk', 'les_sc')]
    rows['mom_rk (scalar, y halo)'] = check(
        'mom_rk (scalar, y halo)', K.mom_rk, K.mom_rk_plain, a, kw,
        mom_totals, lambda: (nbytes_of(nin, nout, h), per_cell * cells))
    del sim, a, kw, u, v, w, p, ru, rv, rw, rso, s, sca, e, se, h
    torch.cuda.empty_cache()
    # the two passes on the channel's slab (YH)
    sim = sim_of(DSMAG_CFG)
    cfg = sim.cfg
    U = [rnd(nz, nyl, nx) for _ in range(3)]
    E = sim._zedge_vel(*U, sim.bcu_vals, sim.bcv_vals, sim.bcw_vals)
    h2 = [halo(2) for _ in range(3)]
    lv1 = (*U, *E, sim.dzci_t, sim.dzfi_t, cfg.dli[0], cfg.dli[1], True,
           True)
    nin, nout, per_cell = WORK['dsmag_level1']
    rows['dsmag_level1 (y halo)'] = check(
        'dsmag_level1 (y halo)', K.dsmag_level1, K.dsmag_level1_plain, lv1,
        dict(yh=h2), lambda r: r,
        lambda: (nbytes_of(nin, nout, h2), per_cell * cells))
    fm, fvel, lij, s0 = K.dsmag_level1_plain(*lv1, yh=h2)
    fze = sim._zedge_vel(*fvel, sim.bcu_vals, sim.bcv_vals, sim.bcw_vals)
    h1 = [halo(1) for _ in range(3)]
    lv2 = (*fvel, *fze, fm, lij, s0, sim.alph2_t, sim.dzci_t, sim.dzfi_t,
           cfg.dli[0], cfg.dli[1])

    def sum_totals(res):
        return [q.reshape(q.shape[0], -1).sum(dim=-1) for q in res]
    nin, nout, per_cell = WORK['dsmag_level2']
    rows['dsmag_level2 (y halo)'] = check(
        'dsmag_level2 (y halo)', K.dsmag_level2, K.dsmag_level2_plain, lv2,
        dict(avg='channel', yh=h1), sum_totals,
        lambda: (nbytes_of(nin, nout, h1), per_cell * cells))
    del fm, fvel, lij, s0, lv2, fze, h1
    torch.cuda.empty_cache()
    # the 2D filter on the channel's slab, and on the box's
    nin, nout, per_cell = WORK_VARIANT[('dsmag', 'f2d')]

    def ds_totals(res):
        return [res[0], *sum_totals(res[1:])]
    for row, zper in (('dsmag (2D filter, slab)', False),
                      ('dsmag (2D filter, periodic z, slab)', True)):
        if zper:
            bsim = sim_of({**TRI_CFG, 'sgstype': 'dsmag', 'dsmag_avg': 'dit',
                           'filter_2d': True})
            ds = (*U, *(torch.stack([q[-1], q[-1], q[0]]).contiguous()
                        for q in U), bsim.alph2_t, bsim.dzci_t, bsim.dzfi_t,
                  bsim.cfg.dli[0], bsim.cfg.dli[1], False, False,
                  (0.0,) * 4)
        else:
            a2 = torch.full((nz,), 2.52, dtype=f32, device=dev)
            ds = (*U, *E, a2, sim.dzci_t, sim.dzfi_t, cfg.dli[0], cfg.dli[1],
                  True, True, sim.dsmag_zvals)
        rows[row] = check(row, K.dsmag, K.dsmag_plain, ds,
                          dict(avg='channel', zper=zper, f2d=True, yh=h2),
                          ds_totals,
                          lambda: (nbytes_of(nin, nout, h2),
                                   per_cell * cells))
    del sim, U, E, h2, lv1, ds
    torch.cuda.empty_cache()
    # the two passes on the duct's lower and upper wall's slab (YW + YH)
    for own, side in (((True, False), 'lower'), ((False, True), 'upper')):
        sim = sim_of({**DUCT_CFG, 'bcvel': MOVING})
        cfg = sim.cfg
        bcs = (sim.bcu_vals, sim.bcv_vals, sim.bcw_vals)
        U = [rnd(nz, nyl, nx) for _ in range(3)]
        E = sim._zedge_vel(*U, *bcs)
        h2 = [halo(2) for _ in range(3)]
        ys = [bnd.slab_ystack(q, qe, y, hh, own) for q, qe, y, hh in
              zip(U, E, sim._yedge_vel(*U), h2)]
        lv1 = (*U, *E, sim.dzci_t, sim.dzfi_t, cfg.dli[0], cfg.dli[1], True,
               True)
        kw1 = dict(ye=ys, yh=h2, yown=own)
        fm, fvel, lij, s0 = K.dsmag_level1_plain(*lv1, **kw1)
        fze = sim._zedge_vel(*fvel, *bcs)
        h1 = [halo(1) for _ in range(3)]
        fys = [bnd.slab_ystack(q, qe, y, hh, own) for q, qe, y, hh in
               zip(fvel, fze, sim._yedge_vel(*fvel), h1)]
        lv2 = (*fvel, *fze, fm, lij, s0, sim.alph2_t, sim.dzci_t,
               sim.dzfi_t, cfg.dli[0], cfg.dli[1])
        kw2 = dict(avg='duct', ye=fys, yown=own)
        for row, fn, twin, a, kw, totals, extra, name in (
                ('dsmag_level1 (y walls, slab)', K.dsmag_level1,
                 K.dsmag_level1_plain, lv1, kw1, lambda r: r, (ys, h2),
                 'dsmag_level1'),
                ('dsmag_level2 (y walls, slab, duct)', K.dsmag_level2,
                 K.dsmag_level2_plain, lv2, kw2,
                 lambda r: [q.sum(dim=-1) for q in r], fys, 'dsmag_level2')):
            nin, nout, per_cell = WORK[name]
            r = check(f'{row} [{side} wall]', fn, twin, a, kw, totals,
                      lambda: (nbytes_of(nin, nout, extra),
                               per_cell * cells))
            if own[0]:
                rows[row] = r
            else:
                rows[row].update(
                    ms_upper_wall_slab=r['ms'],
                    plain_ms_upper_wall_slab=r['plain_ms'],
                    **{k: max(rows[row][k], r[k]) for k in (
                        'max_abs_err', 'max_rel_err', 'f32_vs_f64_twin',
                        'f64_vs_f64_twin')})
        del sim, U, E, h2, ys, lv1, kw1, fm, fvel, lij, s0, fze, h1, fys, lv2
        torch.cuda.empty_cache()
    return rows


def slab_imp3d_x_rows(dev, card):
    """Phase 2b's rows of the full-3D and the x-walled slab modes
    (SLAB_MODE_ROWS, phases 10i3, 10i3s, 10x, 10xb) at the headline's slab
    on dims (2, 1), (nx, ny/2, nz), on seeded random fields and halo rows,
    each by _check_row (float32 within 1e-5 of its twin, float64 within
    1e-12), its bound the bytes (each input, stack, halo and output once)
    or the arithmetic:
      mom_rk's 'xy+z' split with the halos (Y_HALO, no nu_t: the full-3D
        channel DNS), and its scalar variant with nu_t (the scalar channel
        LES with full-3D);
      correc_updatep's halo variant with full-3D alpha L(pp);
      with x walls (XDEV_CFG's and XLES_IMP_CFG's x stacks of the slab's
        fields, and random neighbours' rows -1 and nyl where mom_rk and
        smag read them): mom_rk's XW x Y_HALO explicit without nu_t, and
        with nu_t and the '1d' split; fillps's and correc_updatep's on the
        slab's own stacks; smag's with the x walls' van Driest inputs."""
    from cales_torch.config import Config
    from cales_torch.grid import make_grid_from_config
    from cales_torch.ops import kernels as K
    from cales_torch.timeloop import Simulation, _xstacks_on_slab
    f32 = torch.float32
    nx, ny, nz = HEADLINE_NG
    nyl = ny // 2
    shape = (nx, nyl, nz)
    cells = nx * nyl * nz
    gen = torch.Generator(device=dev).manual_seed(SEED + 29)

    def rnd(*sz, scale=0.02):
        return scale * torch.randn(sz, generator=gen, device=dev, dtype=f32)

    def halo(n=nz):
        return (rnd(n, 2, nx), rnd(3, 2, nx))

    def sim_of(kw):
        cfg = Config(**{**kw, 'ng': shape, 'dims': (1, 1),
                        'dtype': 'float32'})
        return Simulation(cfg, make_grid_from_config(cfg), device=dev)

    def nbytes_of(nin, nout, extra):
        return ((nin + nout) * cells * 4
                + sum(q.numel() * q.element_size() for q in _flat(extra)))

    def mom_totals(res):
        # u, v, w, ru, rv, rw, the usum partial sums (per-plane totals),
        # and with the scalar s, ds
        return [*res[:6], res[6].sum(dim=1), *res[7:]]

    def row_of(row, fn, twin, a, kw, totals, work):
        return _check_row(row, fn, twin, a, kw, totals,
                          lambda: (nbytes_of(*work[:2], work[3]),
                                   work[2] * cells), card, shape)
    rows = {}
    say(f'phase 2b: the full-3D and x-walled slab modes at the slab (nx, '
        f'ny/2, nz) = {shape}, float32, against their twins in float32 and '
        f'float64  [{card}]')
    # the full-3D channel DNS's mom_rk on the slab
    sim = sim_of(dict(DNS_CFG, impdiff_1d=False))
    cfg = sim.cfg
    u, v, w, p, ru, rv, rw = (rnd(nz, nyl, nx) for _ in range(7))
    e = [rnd(3, nyl, nx) for _ in range(4)]
    h = [halo() for _ in range(4)]
    a = (u, v, w, None, p, e[0], e[1], e[2], None, e[3], ru, rv, rw,
         sim.dzci_t, sim.dzfi_t, 0.01, -0.005, cfg.visc, cfg.dli[0],
         cfg.dli[1], cfg.bforce)
    kw = dict(sums=(True, False), split='xy+z', yh=(*h[:3], None, h[3]))
    rows['mom_rk (y halo, split xy+z)'] = row_of(
        'mom_rk (y halo, split xy+z)', K.mom_rk, K.mom_rk_plain, a, kw,
        mom_totals, (*WORK_VARIANT[('mom_rk', 'xyz')], h))
    # correc_updatep's halo variant with full-3D alpha L(pp)
    pp, ppe = rnd(nz, nyl, nx), rnd(3, nyl, nx)
    hp = halo()
    a = (u, v, w, pp, p, e[2], ppe, 0.01, cfg.dli[0], cfg.dli[1],
         sim.dzci_t, sim.dzfi_t)
    kw = dict(alpha=ALPHA * 0.01, impdiff=True, impdiff_1d=False, yh=hp)
    rows['correc_updatep (y halo, full-3D)'] = row_of(
        'correc_updatep (y halo, full-3D)', K.correc_updatep,
        K.correc_updatep_plain, a, kw, list,
        (*WORK_VARIANT[('correc_updatep', 'impdiff')], hp))
    del sim, a, kw, u, v, w, p, ru, rv, rw, e, h, pp, ppe, hp
    torch.cuda.empty_cache()
    # the scalar channel LES with full-3D: mom_rk's scalar variant
    sim = sim_of(dict(LES_SC_CFG, impdiff=True))
    cfg = sim.cfg
    u, v, w, p, ru, rv, rw, rso = (rnd(nz, nyl, nx) for _ in range(8))
    s = rnd(nz, nyl, nx, scale=1e-3).abs()
    sca = rnd(nz, nyl, nx, scale=0.3).abs()
    e = [rnd(3, nyl, nx) for _ in range(4)]
    se = rnd(3, nyl, nx, scale=1e-3).abs()
    h = (*(halo() for _ in range(3)), (rnd(nz, 2, nx, scale=1e-3).abs(),
                                       rnd(3, 2, nx, scale=1e-3).abs()),
         halo(), (rnd(nz, 2, nx, scale=0.3).abs(),
                  rnd(3, 2, nx, scale=0.3).abs()))
    a = (u, v, w, s, p, e[0], e[1], e[2], se, e[3], ru, rv, rw, sim.dzci_t,
         sim.dzfi_t, 0.01, -0.005, cfg.visc, cfg.dli[0], cfg.dli[1],
         cfg.bforce)
    kw = dict(sums=(True, False), split='xy+z', yh=h, sca=sca,
              scae=sim._zedge_scal(sca), rso=rso, scal=sim.scal_params)
    rows['mom_rk (scalar, y halo, split xy+z)'] = row_of(
        'mom_rk (scalar, y halo, split xy+z)', K.mom_rk, K.mom_rk_plain, a,
        kw, mom_totals, (*WORK_VARIANT[('mom_rk', 'les_sc')], h))
    del sim, a, kw, u, v, w, p, ru, rv, rw, rso, s, sca, e, se, h
    torch.cuda.empty_cache()
    # x walls on the slab: the developing channel, and its LES with
    # impdiff_1d
    for key, kwc in (('dev', XDEV_CFG), ('les', XLES_IMP_CFG)):
        sim = sim_of(kwc)
        cfg = sim.cfg
        sgs = sim.has_sgs
        dxi, dyi = cfg.dli[0], cfg.dli[1]
        u = 1.0 + rnd(nz, nyl, nx, scale=0.1)
        v, w, p, pp, ru, rv, rw = (rnd(nz, nyl, nx) for _ in range(7))
        s = rnd(nz, nyl, nx, scale=1e-3).abs()
        bcs = (sim.bcu_vals, sim.bcv_vals, sim.bcw_vals)
        zq = sim._zedge_vel(u, v, w, *bcs)
        xq = sim._xedge_vel(u, v, w, bcs)
        xs = (*xq, sim._xedge_s(s) if sgs else None, sim._xedge_p(p))
        # the neighbours' rows of the stacks (the exchange's)
        xh = [(rnd(nz, 2, 3), rnd(3, 2, 3)) for q in xs if q is not None]
        xe = _xstacks_on_slab(xs, xh)
        h = [halo() for _ in range(5)]
        yh = (*h[:3], h[3] if sgs else None, h[4])
        a = (u, v, w, s if sgs else None, p, *zq,
             sim._zedge_s(s) if sgs else None, sim._zedge_p(p), ru, rv, rw,
             sim.dzci_t, sim.dzfi_t, 0.01, -0.005, cfg.visc, dxi, dyi,
             cfg.bforce)
        kw = dict(sums=(False, False), split=sim.split, yh=yh, xe=xe)
        row = ('mom_rk (x walls, y halo)' if key == 'dev'
               else "mom_rk (x walls, y halo, nu_t, '1d')")
        nin, nout, per_cell = (WORK_VARIANT[('mom_rk', 'xdev')] if key ==
                               'dev' else WORK['mom_rk'])
        rows[row] = row_of(row, K.mom_rk, K.mom_rk_plain, a, kw, list,
                           (nin, nout, per_cell, (yh, xe)))
        if key == 'dev':
            # fillps and correc_updatep on the slab's own stacks (the
            # prediction fill's u, pp's)
            xu2 = sim._xedge_vel(u, v, w, fields=(0, 2))[0]
            hv = halo()
            a = (u, v, w, *zq, sim.dzfi_t, 100.0, dxi, dyi)
            rows['fillps (x walls, y halo)'] = row_of(
                'fillps (x walls, y halo)', K.fillps, K.fillps_plain, a,
                dict(yh=hv, xu=xu2), list, (*WORK['fillps'], (hv, xu2)))
            xpp, hp = sim._xedge_p(pp), halo()
            a = (u, v, w, pp, p, zq[2], sim._zedge_p(pp), 0.01, dxi, dyi,
                 sim.dzci_t, sim.dzfi_t)
            kw = dict(alpha=ALPHA * 0.01, impdiff=True, impdiff_1d=True,
                      yh=hp, xpp=xpp, xu=xu2)
            rows['correc_updatep (x walls, y halo)'] = row_of(
                'correc_updatep (x walls, y halo)', K.correc_updatep,
                K.correc_updatep_plain, a, kw, list,
                (*WORK['correc_updatep'], (hp, xpp, xu2)))
        else:
            # smag with the x walls' van Driest inputs (random shear
            # planes; the z walls' too)
            planes = tuple(1e-2 * (1.0 + rnd(nz, nyl).abs())
                           for _ in range(2))
            tz = tuple(1e-2 * (1.0 + rnd(nyl, nx).abs()) for _ in range(2))
            xwall = (*sim.xwall_prof, *planes)
            a = (u, v, w, *zq, sim.dzci_t, sim.dzfi_t, dxi, dyi, cfg.visc,
                 sim.csd2_t, sim.dw_t, sim.nearlo_t, *tz)
            kw = dict(yh=h[:3], xe=xe[:3], xwall=xwall)
            rows['smag (x walls, y halo)'] = row_of(
                'smag (x walls, y halo)', K.smag, K.smag_plain, a, kw, list,
                (*WORK['smag'], (h[:3], xe[:3], xwall, tz)))
        del sim, a, kw, u, v, w, p, pp, ru, rv, rw, s, zq, xq, xs, xh, xe, h
        torch.cuda.empty_cache()
    return rows


def pencil_rows(dev, card):
    """Phase 2b's rows of the pencil mesh's x-halo variants (PENCIL_ROWS,
    the mesh phase 10p, dims (2, 2)) at the headline's pencil, (nx/2,
    ny/2, nz), on seeded random fields, y halos and x halos (their rows
    -1 and nyl too), each by _check_row (float32 within 1e-5 of its twin,
    float64 within 1e-12), its bound the bytes (each input, halo and
    output once) or the arithmetic: mom_rk's X_HALO x Y_HALO explicit with
    nu_t, with the '1d' split (the LES with impdiff_1d) and with the 'xy+z'
    split (full-3D implicit diffusion), fillps's, correc_updatep's
    (impdiff_1d's p update and the full-3D one) and smag's with the z
    walls' van Driest and without a wall (the box); mom_rk's scalar
    variant (SCAL x X_HALO x Y_HALO, explicit, with nu_t: the scalar's
    halos the sixth pairs); dsmag's XH x YH mode (two-deep x halos (nz, 4,
    ny/2 + 4) and depth-2 y halos, its z rows' sums as totals) on the
    z-walled channel and, with ZP, on the box, each with the 3D and with
    the 2D test filter (F2D x XH); dsmag_level1's XH x YH mode on the
    channel (its 16 fields) and dsmag_level2's on its twin's output (the
    filtered velocity's depth-1 y and x halos, the z rows' sums as
    totals); the y walls' x-halo variants (Y_WALLS x X_HALO: mom_rk
    explicit with nu_t and with the scalar, fillps, correc_updatep with
    the deferred forcing, smag with the y walls' van Driest; dsmag's YW +
    YH x XH with 'duct' (its (z, y) rows' sums as totals) and 'cavity')
    on the y-row stacks of a pencil of the lower wall (yown (True,
    False)).  Each row's time is also taken on the device alone
    (graph_ms, 'graph_ms'), and so is its kernel's periodic variant on the
    same pencil ('periodic_variant_graph_ms': with y walls the whole
    field's y-walled variant) and, for the y walls' rows, the X_HALO
    variant of the periodic-y classes with the y halo in place of the
    stacks ('x_halo_periodic_y_graph_ms')."""
    from cales_torch.config import Config
    from cales_torch.grid import make_grid_from_config
    from cales_torch.ops import kernels as K
    from cales_torch.timeloop import Simulation
    f32 = torch.float32
    nx, nyl, nz = PENCIL_NG
    cells = nx * nyl * nz
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)

    def rnd(*sz, scale=0.02):
        return scale * torch.randn(sz, generator=gen, device=dev, dtype=f32)

    def yhalo():
        return (rnd(nz, 2, nx), rnd(3, 2, nx))

    def xhalo():
        return (rnd(nz, 3, nyl + 2), rnd(3, 3, nyl + 2))

    def row_of(row, fn, twin, a, kw, totals, work, plain_kw=None,
               xhalo_kw=None):
        nbytes = ((work[0] + work[1]) * cells * 4
                  + sum(q.numel() * q.element_size()
                        for q in _flat([kw.get(k) for k in (
                            'yh', 'xh', 'ye', 'yv', 'ypp')])))
        r = _check_row(row, fn, twin, a, kw, totals,
                       lambda: (nbytes, work[2] * cells), card, PENCIL_NG)
        # the device time alone (a CUDA graph of the calls): at the
        # pencil's quarter of the cells the wrapper's host time (its
        # checks of every halo) may exceed a kernel's; and the same
        # kernel's periodic variant on the same pencil, no halo read
        # (plain_kw), and the x-halo variant of the periodic-y classes
        # (xhalo_kw, the y walls' rows)
        r['graph_ms'] = graph_ms(lambda: fn(*a, **kw), n=10)
        if plain_kw is None:
            plain_kw = {k: q for k, q in kw.items() if k not in ('yh', 'xh')}
        r['periodic_variant_graph_ms'] = graph_ms(
            lambda: fn(*a, **plain_kw), n=10)
        more = ''
        if xhalo_kw is not None:
            r['x_halo_periodic_y_graph_ms'] = graph_ms(
                lambda: fn(*a, **xhalo_kw), n=10)
            more = (', the periodic-y x-halo variant '
                    f'{r["x_halo_periodic_y_graph_ms"]:.4f} ms')
        say(f'  {row:<42s} on the device alone (a CUDA graph of 10 calls) '
            f'{r["graph_ms"]:.4f} ms, its periodic variant on the pencil '
            f'{r["periodic_variant_graph_ms"]:.4f} ms{more}  [{card}]')
        return r
    cfg = Config(**{**LES_IMP_CFG, 'ng': PENCIL_NG, 'dims': (1, 1),
                    'dtype': 'float32'})
    sim = Simulation(cfg, make_grid_from_config(cfg), device=dev)
    dxi, dyi = cfg.dli[0], cfg.dli[1]
    say(f'phase 2b: the pencil mesh\'s x-halo variants at the pencil (nx/2, '
        f'ny/2, nz) = {PENCIL_NG} of dims (2, 2), float32, against their '
        f'twins in float32 and float64  [{card}]')
    rows = {}
    u, v, w, p, pp, ru, rv, rw = (rnd(nz, nyl, nx) for _ in range(8))
    s = rnd(nz, nyl, nx, scale=1e-3).abs()
    e = [rnd(3, nyl, nx) for _ in range(3)]
    se, pe, ppe = rnd(3, nyl, nx, scale=1e-3).abs(), rnd(3, nyl, nx), \
        rnd(3, nyl, nx)
    yh = [yhalo() for _ in range(5)]
    xh = [xhalo() for _ in range(5)]

    def mom_totals(res):
        return [*res[:6], res[6].sum(dim=1)]
    for row, split in (('mom_rk (x halo, y halo)', None),
                       ("mom_rk (x halo, y halo, '1d')", '1d'),
                       ("mom_rk (x halo, y halo, 'xy+z')", 'xy+z')):
        a = (u, v, w, s, p, *e, se, pe, ru, rv, rw, sim.dzci_t, sim.dzfi_t,
             0.01, -0.005, cfg.visc, dxi, dyi, cfg.bforce)
        kw = dict(sums=(True, False), split=split, yh=tuple(yh),
                  xh=tuple(xh))
        rows[row] = row_of(row, K.mom_rk, K.mom_rk_plain, a, kw, mom_totals,
                           WORK['mom_rk'])
    a = (u, v, w, *e, sim.dzfi_t, 100.0, dxi, dyi)
    rows['fillps (x halo, y halo)'] = row_of(
        'fillps (x halo, y halo)', K.fillps, K.fillps_plain, a,
        dict(yh=yh[1], xh=xh[0]), list, WORK['fillps'])
    a = (u, v, w, pp, p, e[2], ppe, 0.01, dxi, dyi, sim.dzci_t, sim.dzfi_t)
    kw = dict(alpha=ALPHA * 0.01, impdiff=True, impdiff_1d=True,
              yh=yhalo(), xh=xhalo())
    rows['correc_updatep (x halo, y halo)'] = row_of(
        'correc_updatep (x halo, y halo)', K.correc_updatep,
        K.correc_updatep_plain, a, kw, list,
        WORK_VARIANT[('correc_updatep', 'impdiff')])
    row = 'correc_updatep (x halo, y halo, full-3D)'
    rows[row] = row_of(row, K.correc_updatep, K.correc_updatep_plain, a,
                       dict(kw, impdiff_1d=False), list,
                       WORK_VARIANT[('correc_updatep', 'impdiff')])
    tz = tuple(1e-2 * (1.0 + rnd(nyl, nx).abs()) for _ in range(2))
    a = (u, v, w, *e, sim.dzci_t, sim.dzfi_t, dxi, dyi, cfg.visc,
         sim.csd2_t, sim.dw_t, sim.nearlo_t, *tz)
    rows['smag (x halo, y halo)'] = row_of(
        'smag (x halo, y halo)', K.smag, K.smag_plain, a,
        dict(yh=tuple(yh[:3]), xh=tuple(xh[:3])), list, WORK['smag'])
    rows['smag (x halo, y halo, no wall)'] = row_of(
        'smag (x halo, y halo, no wall)', K.smag, K.smag_plain, a,
        dict(yh=tuple(yh[:3]), xh=tuple(xh[:3]), have_zwalls=False), list,
        WORK_VARIANT[('smag', 'nowall')])
    # mom_rk's scalar variant on the pencil (SCAL x X_HALO x Y_HALO,
    # explicit, with nu_t: LES_SC_CFG's channel), the scalar's halo and x
    # halo the sixth pairs
    scfg = Config(**{**LES_SC_CFG, 'ng': PENCIL_NG, 'dims': (1, 1),
                     'dtype': 'float32'})
    sca = rnd(nz, nyl, nx, scale=0.3).abs()
    rso = rnd(nz, nyl, nx)
    row = 'mom_rk (scalar, x halo, y halo)'
    a = (u, v, w, s, p, *e, se, pe, ru, rv, rw, sim.dzci_t, sim.dzfi_t,
         0.01, -0.005, scfg.visc, dxi, dyi, scfg.bforce)
    # its edge stack as the fill leaves it: row 1 (the rewrite slot of the
    # z-staggered w) is the last plane, which the kernel reads there
    scae = torch.stack([rnd(nyl, nx, scale=0.3), sca[-1],
                        rnd(nyl, nx, scale=0.3)])
    kw = dict(sums=(True, False), yh=(*yh, yhalo()), xh=(*xh, xhalo()),
              sca=sca, scae=scae, rso=rso,
              scal=(scfg.visc / scfg.pr, float(scfg.ssource)))
    rows[row] = row_of(row, K.mom_rk, K.mom_rk_plain, a, kw,
                       lambda res: [*mom_totals(res), *res[7:]],
                       WORK_VARIANT[('mom_rk', 'les_sc')])
    del sim, p, pp, ru, rv, rw, s, se, pe, ppe, yh, xh, sca, scae, rso, a, kw
    torch.cuda.empty_cache()
    # dsmag's XH x YH mode: the channel (z walls, alpha^2 2.52 on the
    # walls' rows) and the box (ZP, uniform z); two-deep x halos over the
    # rows -2 .. nyl+1 and depth-2 y halos

    def dsmag_totals(res):
        return [res[0], res[1].sum(dim=-1), res[2].sum(dim=-1)]
    yh2 = [(rnd(nz, 4, nx), rnd(3, 4, nx)) for _ in range(3)]
    xh2 = [(rnd(nz, 4, nyl + 4), rnd(3, 4, nyl + 4)) for _ in range(3)]
    for row, kw0 in (('dsmag (x halo, y halo)', DSMAG_CFG),
                     ('dsmag (x halo, y halo, periodic z)', TRI_CFG)):
        cfg = Config(**{**kw0, 'ng': PENCIL_NG, 'dims': (1, 1),
                        'dtype': 'float32'})
        grid = make_grid_from_config(cfg)
        zper = cfg.cbc_vel(2, 0) == 'PP'
        a2 = torch.full((nz,), 4.0, dtype=f32, device=dev)
        if not zper:
            a2[0] = a2[-1] = 2.52
        a = (u, v, w, *e, a2,
             torch.as_tensor(grid.dzci, dtype=f32, device=dev),
             torch.as_tensor(grid.dzfi, dtype=f32, device=dev),
             cfg.dli[0], cfg.dli[1], not zper, not zper)
        rows[row] = row_of(row, K.dsmag, K.dsmag_plain, a,
                           dict(avg='channel', zper=zper, yh=yh2, xh=xh2),
                           dsmag_totals, WORK['dsmag'])
        # the 2D test filter on the same pencil (F2D x XH; alpha^2 2.52,
        # the caller's profile)
        f2d = ('dsmag (2D filter, x halo, periodic z)' if zper
               else 'dsmag (2D filter, x halo, y halo)')
        a2d = (*a[:6], torch.full((nz,), 2.52, dtype=f32, device=dev),
               *a[7:])
        rows[f2d] = row_of(f2d, K.dsmag, K.dsmag_plain, a2d,
                           dict(avg='channel', zper=zper, f2d=True,
                                yh=yh2, xh=xh2),
                           dsmag_totals, WORK_VARIANT[('dsmag', 'f2d')])
    # the two passes' XH x YH modes on the channel (DSMAG_CFG's z walls):
    # dsmag_level1 with the two-deep halos, dsmag_level2 on its twin's
    # output with the filtered velocity's depth-1 y and x halos
    cfg = Config(**{**DSMAG_CFG, 'ng': PENCIL_NG, 'dims': (1, 1),
                    'dtype': 'float32'})
    grid = make_grid_from_config(cfg)
    dz = [torch.as_tensor(q, dtype=f32, device=dev)
          for q in (grid.dzci, grid.dzfi)]
    lv1 = (u, v, w, *e, *dz, cfg.dli[0], cfg.dli[1], True, True)
    row = 'dsmag_level1 (x halo, y halo)'
    rows[row] = row_of(row, K.dsmag_level1, K.dsmag_level1_plain, lv1,
                       dict(yh=yh2, xh=xh2), lambda res: res,
                       WORK['dsmag_level1'])
    fm, fvel, lij, s0 = K.dsmag_level1_plain(*lv1, yh=yh2, xh=xh2)
    a2 = torch.full((nz,), 4.0, dtype=f32, device=dev)
    a2[0] = a2[-1] = 2.52
    lv2 = (*fvel, *(rnd(3, nyl, nx) for _ in range(3)), fm, lij, s0, a2,
           *dz, cfg.dli[0], cfg.dli[1])
    row = 'dsmag_level2 (x halo, y halo)'
    rows[row] = row_of(
        row, K.dsmag_level2, K.dsmag_level2_plain, lv2,
        dict(avg='channel', yh=[yhalo() for _ in range(3)],
             xh=[xhalo() for _ in range(3)]),
        lambda res: [q.reshape(q.shape[0], -1).sum(dim=-1) for q in res],
        WORK['dsmag_level2'])
    del yh2, xh2, lv1, fm, fvel, lij, s0, lv2
    torch.cuda.empty_cache()
    rows.update(_pencil_ywall_rows(dev, rnd, row_of, (u, v, w, e),
                                   yhalo, xhalo))
    del u, v, w, e
    torch.cuda.empty_cache()
    return rows


def _pencil_ywall_rows(dev, rnd, row_of, vel, yhalo, xhalo):
    """pencil_rows' rows of the y walls' x-halo variants (see there): the
    duct's (DUCT_CFG at the pencil, with smag for the y walls' van
    Driest inputs) mom_rk, fillps, correc_updatep, smag, dsmag ('duct'
    and 'cavity') and mom_rk's scalar variant on a lower-wall pencil's
    seeded y-row stacks, x halos and (dsmag) depth-2 y halos, by
    row_of."""
    from cales_torch.config import Config
    from cales_torch.grid import make_grid_from_config
    from cales_torch.ops import boundary as bnd
    from cales_torch.ops import kernels as K
    from cales_torch.timeloop import Simulation
    f32 = torch.float32
    nx, nyl, nz = PENCIL_NG
    u, v, w, e = vel
    cfg = Config(**{**DUCT_CFG, 'ng': PENCIL_NG, 'dims': (1, 1),
                    'dtype': 'float32', 'sgstype': 'smag'})
    sim = Simulation(cfg, make_grid_from_config(cfg), device=dev)
    dxi, dyi = cfg.dli[0], cfg.dli[1]

    def ystack(scale=0.02):
        return (rnd(nz, 3, nx, scale=scale), rnd(3, 3, nx, scale=scale))
    p, pp, ru, rv, rw = (rnd(nz, nyl, nx) for _ in range(5))
    s = rnd(nz, nyl, nx, scale=1e-3).abs()
    se, pe, ppe = (rnd(3, nyl, nx, scale=1e-3).abs(), rnd(3, nyl, nx),
                   rnd(3, nyl, nx))
    ys = [ystack() for _ in range(5)]
    ys[3] = tuple(0.05 * q.abs() for q in ys[3])     # nu_t's, positive
    yh = [yhalo() for _ in range(5)]
    xh = [xhalo() for _ in range(5)]
    rows = {}

    def mom_totals(res):
        return [*res[:6], res[6].sum(dim=1)]
    a = (u, v, w, s, p, *e, se, pe, ru, rv, rw, sim.dzci_t, sim.dzfi_t,
         0.01, -0.005, cfg.visc, dxi, dyi, cfg.bforce)
    sums = dict(sums=(True, False))
    row = 'mom_rk (x halo, y walls)'
    rows[row] = row_of(row, K.mom_rk, K.mom_rk_plain, a,
                       dict(sums, ye=tuple(ys), xh=tuple(xh)), mom_totals,
                       WORK['mom_rk'], plain_kw=dict(sums, ye=tuple(ys)),
                       xhalo_kw=dict(sums, yh=tuple(yh), xh=tuple(xh)))
    sca = rnd(nz, nyl, nx, scale=0.3).abs()
    scae = torch.stack([rnd(nyl, nx, scale=0.3), sca[-1],
                        rnd(nyl, nx, scale=0.3)])
    sc = dict(sca=sca, scae=scae, rso=rnd(nz, nyl, nx),
              scal=(cfg.visc / 0.71, 0.02))
    # the scalar's y-row stack as a fill leaves it: its row 1 the last
    # row, which the update reads there (the twin from the interior)
    ysc, yhsc, xhsc = ystack(0.3), yhalo(), xhalo()
    ysc[0][:, 1], ysc[1][:, 1] = sca[:, -1], scae[:, -1]
    row = 'mom_rk (scalar, x halo, y walls)'
    rows[row] = row_of(
        row, K.mom_rk, K.mom_rk_plain, a,
        dict(sums, ye=(*ys, ysc), xh=(*xh, xhsc), **sc),
        lambda res: [*mom_totals(res), *res[7:]],
        WORK_VARIANT[('mom_rk', 'duct_sc')],
        plain_kw=dict(sums, ye=(*ys, ysc), **sc),
        xhalo_kw=dict(sums, yh=(*yh, yhsc), xh=(*xh, xhsc), **sc))
    a = (u, v, w, *e, sim.dzfi_t, 100.0, dxi, dyi)
    row = 'fillps (x halo, y walls)'
    rows[row] = row_of(row, K.fillps, K.fillps_plain, a,
                       dict(yv=ys[1], xh=xh[0]), list, WORK['fillps'],
                       plain_kw=dict(yv=ys[1]),
                       xhalo_kw=dict(yh=yh[1], xh=xh[0]))
    fuv = torch.tensor([0.01, 0.0], dtype=f32, device=dev)
    a = (u, v, w, pp, p, e[2], ppe, 0.01, dxi, dyi, sim.dzci_t, sim.dzfi_t,
         fuv)
    ypp = ystack()
    row = 'correc_updatep (x halo, y walls)'
    rows[row] = row_of(row, K.correc_updatep, K.correc_updatep_plain, a,
                       dict(ypp=ypp, yv=ys[1][0], xh=xh[4]), list,
                       WORK['correc_updatep'],
                       plain_kw=dict(ypp=ypp, yv=ys[1][0]),
                       xhalo_kw=dict(yh=yh[4], xh=xh[4]))
    tz = tuple(1e-2 * (1.0 + rnd(nyl, nx).abs()) for _ in range(2))
    ty = tuple(1e-2 * (1.0 + rnd(nz, nx).abs()) for _ in range(2))
    a = (u, v, w, *e, sim.dzci_t, sim.dzfi_t, dxi, dyi, cfg.visc,
         sim.csd2_t, sim.dw_t, sim.nearlo_t, *tz)
    yw = dict(ye=tuple(ys[:3]), ywall=(sim.dwy_t, sim.nearylo_t, *ty))
    row = 'smag (x halo, y walls)'
    rows[row] = row_of(row, K.smag, K.smag_plain, a,
                       dict(yw, xh=tuple(xh[:3])), list, WORK['smag'],
                       plain_kw=yw,
                       xhalo_kw=dict(yh=tuple(yh[:3]), xh=tuple(xh[:3])))
    del p, pp, ru, rv, rw, s, se, pe, ppe, sca, scae, sc, a
    torch.cuda.empty_cache()
    # dsmag's YW + YH x XH: the depth-2 y halos and two-deep x halos, the
    # lower wall's pencil
    yh2 = [(rnd(nz, 4, nx), rnd(3, 4, nx)) for _ in range(3)]
    xh2 = [(rnd(nz, 4, nyl + 4), rnd(3, 4, nyl + 4)) for _ in range(3)]
    a2 = torch.full((nz,), 4.0, dtype=f32, device=dev)
    a2[0] = a2[-1] = 2.52
    a = (u, v, w, *e, a2, sim.dzci_t, sim.dzfi_t, dxi, dyi, True, True)
    # the pencil's y-row stacks as the step composes them
    # (boundary.slab_ystack: the lower wall's rows, the y halo's above)
    yds = tuple(bnd.slab_ystack(q, qe, y, h, (True, False))
                for q, qe, y, h in zip((u, v, w), e, ys[:3], yh2))
    for avg in ('duct', 'cavity'):
        row = f'dsmag (x halo, y walls, {avg})'
        totals = ((lambda res: [res[0], res[1].sum(dim=-1),
                                res[2].sum(dim=-1)]) if avg == 'duct'
                  else list)
        rows[row] = row_of(row, K.dsmag, K.dsmag_plain, a,
                           dict(ye=yds, yh=yh2, yown=(True, False),
                                xh=xh2, avg=avg), totals, WORK['dsmag'],
                           plain_kw=dict(ye=yds, avg=avg),
                           xhalo_kw=dict(yh=yh2, xh=xh2, avg='channel'))
    del sim, yh2, xh2, a, ys, yds, yh, xh
    torch.cuda.empty_cache()
    return rows


def slab_xy_rows(dev, card):
    """Phase 2b's rows of the x-walled slab modes (SLAB_MODE_ROWS,
    phases 10xy, 10xs, 10xw) at the headline's slab on dims (2, 1), (nx,
    ny/2, nz), on seeded random fields, halo rows and neighbours' stack
    rows, each by _check_row (float32 within 1e-5 of its twin, float64
    within 1e-12), its bound the bytes (each input, stack, halo and
    output once) or the arithmetic:
      with x and y walls (XDUCT_LES_CFG's stacks on the lower wall's slab:
        its y-row stacks by boundary.slab_ystack, its x stacks with the
        wall recipe's rows on the lower side and the neighbour's rows
        above, timeloop._xstacks_on_slab): mom_rk's XW x Y_WALLS with nu_t,
        fillps's and correc_updatep's on the slab's own x stacks, smag's
        with the y and x walls' van Driest inputs;
      mom_rk's SCAL x XW x Y_HALO without nu_t (phase 13x's developing
        channel with a scalar: its x stacks with the neighbours' rows);
      the wall model's XW x YH mode on the developing WMLES's z faces at
        the slab (the slab's rows of its 1/7-power inflow profile), timed
        by a CUDA graph, its bound counting the Newton steps these rows
        need (the float64 twin's count)."""
    from cales_torch import wallmodel as wmod
    from cales_torch.config import Config
    from cales_torch.grid import make_grid_from_config
    from cales_torch.ops import boundary as bnd
    from cales_torch.ops import kernels as K
    from cales_torch.timeloop import (Simulation, _slab_planes,
                                      _xstacks_on_slab)
    f32 = torch.float32
    nx, ny, nz = HEADLINE_NG
    nyl = ny // 2
    shape = (nx, nyl, nz)
    cells = nx * nyl * nz
    own = (True, False)
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)

    def rnd(*sz, scale=0.02):
        return scale * torch.randn(sz, generator=gen, device=dev, dtype=f32)

    def halo(n=nz):
        return (rnd(n, 2, nx), rnd(3, 2, nx))

    def xhalo():
        return (rnd(nz, 2, 3), rnd(3, 2, 3))

    def sim_of(kw, ng=shape):
        cfg = Config(**{**kw, 'ng': ng, 'dims': (1, 1), 'dtype': 'float32'})
        return Simulation(cfg, make_grid_from_config(cfg), device=dev)

    def nbytes_of(nin, nout, extra):
        return ((nin + nout) * cells * 4
                + sum(q.numel() * q.element_size() for q in _flat(extra)))

    def row_of(row, fn, twin, a, kw, totals, work, timer=None):
        return _check_row(row, fn, twin, a, kw, totals,
                          lambda: (nbytes_of(*work[:2], work[3]),
                                   work[2] * cells), card, shape,
                          timer=timer)

    def mom_totals(res):
        return [*res[:6], res[6].sum(dim=1), *res[8:]]
    rows = {}
    say(f'phase 2b: the x-walled slab modes of x and y walls, the scalar and '
        f'the wall model at the slab (nx, ny/2, nz) = {shape}, float32, '
        f'against their twins in float32 and float64  [{card}]')
    # x and y walls on the lower wall's slab: the developing duct LES
    sim = sim_of(XDUCT_LES_CFG)
    sim.yown = own
    cfg = sim.cfg
    dxi, dyi = cfg.dli[0], cfg.dli[1]
    u = 1.0 + rnd(nz, nyl, nx, scale=0.1)
    v, w, p, pp, ru, rv, rw = (rnd(nz, nyl, nx) for _ in range(7))
    s = rnd(nz, nyl, nx, scale=1e-3).abs()
    bcs = (sim.bcu_vals, sim.bcv_vals, sim.bcw_vals)
    vlo = (torch.zeros((nz + 2, nyl + 2), dtype=f32, device=dev),
           torch.zeros((nz + 2, nx + 2), dtype=f32, device=dev),
           torch.zeros((nyl + 2, nx + 2), dtype=f32, device=dev))
    zq = sim._zedge_vel(u, v, w, *bcs, vlo=vlo, is_correc=True)
    se, pe, ppe = sim._zedge_s(s), sim._zedge_p(p), sim._zedge_p(pp)
    walls = (*sim._yedge_vel(u, v, w, bcs, vlo=vlo, is_correc=True),
             sim._yedge_s(s), sim._yedge_p(p))
    ye = [bnd.slab_ystack(q, e, y, halo(), own) for q, e, y in
          zip((u, v, w, s, p), (*zq, se, pe), walls)]
    xe = _xstacks_on_slab((*sim._xedge_vel(u, v, w, bcs, vlo=vlo,
                                           is_correc=True),
                           sim._xedge_s(s), sim._xedge_p(p)),
                          [xhalo() for _ in range(5)], own)
    a = (u, v, w, s, p, *zq, se, pe, ru, rv, rw, sim.dzci_t, sim.dzfi_t,
         0.01, -0.005, cfg.visc, dxi, dyi, cfg.bforce)
    row = 'mom_rk (x and y walls, slab)'
    rows[row] = row_of(row, K.mom_rk, K.mom_rk_plain, a,
                       dict(sums=(False, False), ye=ye, xe=xe),
                       lambda res: list(res[:6]),
                       (*WORK['mom_rk'], (ye, xe)))
    ze2 = sim._zedge_vel(u, v, w, *bcs)
    yv2 = bnd.slab_ystack(v, ze2[1], sim._yedge_vel(u, v, w)[1], halo(), own)
    xu2 = sim._xedge_vel(u, v, w, fields=(0,))[0]
    row = 'fillps (x and y walls, slab)'
    rows[row] = row_of(row, K.fillps, K.fillps_plain,
                       (u, v, w, *ze2, sim.dzfi_t, 100.0, dxi, dyi),
                       dict(yv=yv2, xu=xu2), list,
                       (*WORK['fillps'], (yv2, xu2)))
    ypp = bnd.slab_ystack(pp, ppe, sim._yedge_p(pp), halo(), own)
    xpp = sim._xedge_p(pp)
    row = 'correc_updatep (x and y walls, slab)'
    rows[row] = row_of(row, K.correc_updatep, K.correc_updatep_plain,
                       (u, v, w, pp, p, ze2[2], ppe, 0.01, dxi, dyi,
                        sim.dzci_t, sim.dzfi_t),
                       dict(ypp=ypp, yv=yv2[0], xpp=xpp, xu=xu2), list,
                       (*WORK['correc_updatep'], (ypp, yv2[0], xpp, xu2)))
    ywall = (sim.dwy_t, sim.nearylo_t,
             *(1e-2 * (1.0 + rnd(nz, nx).abs()) for _ in range(2)))
    xwall = (*sim.xwall_prof,
             *(1e-2 * (1.0 + rnd(nz, nyl).abs()) for _ in range(2)))
    tz = tuple(1e-2 * (1.0 + rnd(nyl, nx).abs()) for _ in range(2))
    row = 'smag (x and y walls, slab)'
    rows[row] = row_of(row, K.smag, K.smag_plain,
                       (u, v, w, *zq, sim.dzci_t, sim.dzfi_t, dxi, dyi,
                        cfg.visc, sim.csd2_t, sim.dw_t, sim.nearlo_t, *tz),
                       dict(ye=ye[:3], ywall=ywall, xe=xe[:3], xwall=xwall),
                       list, (*WORK['smag'], (ye[:3], ywall, xe[:3], xwall,
                                              tz)))
    del sim, a, u, v, w, p, pp, ru, rv, rw, s, zq, ye, xe, ze2, yv2, xu2
    del ypp, xpp, walls
    torch.cuda.empty_cache()
    # the scalar with x walls and periodic y: phase 13x's developing
    # channel, no nu_t
    sim = sim_of(dict(XDEV_CFG, **XDEV_SCALAR))
    cfg = sim.cfg
    dxi, dyi = cfg.dli[0], cfg.dli[1]
    u = 1.0 + rnd(nz, nyl, nx, scale=0.1)
    v, w, p, ru, rv, rw, rso = (rnd(nz, nyl, nx) for _ in range(7))
    sca = rnd(nz, nyl, nx, scale=0.3).abs()
    bcs = (sim.bcu_vals, sim.bcv_vals, sim.bcw_vals)
    zq = sim._zedge_vel(u, v, w, *bcs)
    xs = (*sim._xedge_vel(u, v, w, bcs), None, sim._xedge_p(p),
          sim._xedge_scal(sca))
    xe = _xstacks_on_slab(xs, [xhalo() for _ in range(5)])
    h = (*(halo() for _ in range(3)), None, halo(),
         (rnd(nz, 2, nx, scale=0.3).abs(), rnd(3, 2, nx, scale=0.3).abs()))
    a = (u, v, w, None, p, *zq, None, sim._zedge_p(p), ru, rv, rw,
         sim.dzci_t, sim.dzfi_t, 0.01, -0.005, cfg.visc, dxi, dyi,
         cfg.bforce)
    kw = dict(sums=(False, False), yh=h, xe=xe, sca=sca,
              scae=sim._zedge_scal(sca), rso=rso, scal=sim.scal_params)
    row = 'mom_rk (scalar, x walls, y halo)'
    rows[row] = row_of(row, K.mom_rk, K.mom_rk_plain, a, kw,
                       lambda res: [*res[:6], *res[8:]],
                       (*WORK_VARIANT[('mom_rk', 'xsc_slab')], (h, xe)))
    del sim, a, kw, u, v, w, p, ru, rv, rw, rso, sca, zq, xs, xe, h
    torch.cuda.empty_cache()
    # the wall model's XW x YH mode: the developing WMLES's z faces on the
    # slab [0, nyl), its rows of the inflow profile
    cfg = xwmles_cfg(ng=HEADLINE_NG, dims=(1, 1), dtype='float32')
    grid = make_grid_from_config(cfg)
    sim = Simulation(cfg, grid, device=dev)
    wm = wmod.wall_model(cfg, grid, sim.index_wm, tuple(
        _slab_planes(b, 0, nyl, ny)
        for b in (sim.bcu_vals, sim.bcv_vals, sim.bcw_vals)), sim.cbcvel)
    u = 1.0 + rnd(nz, nyl, nx, scale=0.1)
    v = rnd(nz, nyl, nx, scale=0.1)
    yh = rnd(4 * len(wm.faces), 2, nx, scale=0.1)
    yh.view(-1, 2, 2, 2, nx)[:, 0] += 1.0      # u's rows

    def wm_work():
        nf = len(wm.faces)
        nbytes = ((nf * 4 * nyl * nx + nf * 2 * (nyl + 2) * (nx + 2)) * 4
                  + yh.numel() * 4)
        solves = nf * (nyl * (nx + 1) + (nyl + 1) * nx)
        steps = sum(int(q.sum()) for q in wmod.wm_newton_steps(
            u.double(), v.double(), wm, yh=yh.double()))
        return nbytes, solves * WM_SOLVE_OPS + steps * WM_STEP_OPS
    row = 'wallmodel (x walls, y halo)'
    rows[row] = _check_row(row, K.wm_planes, wmod.wm_planes_plain,
                           (u, v, wm), dict(yh=yh), list, wm_work, card,
                           shape, timer=graph_ms)
    del sim, u, v, yh, wm
    torch.cuda.empty_cache()
    return rows


def real_view_rows(dev, card):
    """apply_y on the mixed route's real view (ptransform 'fft' with y
    walls): the y DCT alone on the rfft's lanes, their real and imaginary
    parts interleaved, (nz, ny, 2 (nx/2 + 1)) = REAL_VIEW_SHAPE at the
    headline grid, against its twin (one torch.matmul, the library call
    too) within 1e-5 of the output's maximum, float32 against the float64
    twin within 4x the float32 twin's error; its time, the twin's, the
    same product with the width padded to a multiple of 4 (gemm.cuh's
    16-byte copies; 514 takes 4-byte ones), and its bound: the field read
    and written once and the operator (bytes), 2 ny flops a lane (at the
    3xTF32 rate).  Also the y FFT of the 'fft' route along dim 1 of the
    (nz, ny, nx/2 + 1) spectrum and of a slab rank's lanes at dims (2, 1),
    as it runs and through a contiguous y-last copy."""
    from cales_torch.ops import solve_kernels as SK
    from cales_torch.ops import transforms as tr
    nz, ny, lanes = REAL_VIEW_SHAPE
    row = 'apply_y (real view, mixed route)'
    say(f'phase 2b: {row} at (nz, ny, lanes) = {REAL_VIEW_SHAPE}, float32 '
        f'[{card}]')
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    x = torch.randn((nz, ny, lanes), generator=gen, device=dev)
    m = torch.as_tensor(tr.make_transform('NN', 'c', ny).fwd_mat,
                        dtype=torch.float32, device=dev)
    got = SK.apply_y(x, m)
    twin = SK.apply_y_plain(x, m)
    ref = SK.apply_y_plain(x.double(), m.double())
    scale = float(ref.abs().max())
    rel = float((got.double() - ref).abs().max()) / scale
    lib_rel = float((twin.double() - ref).abs().max()) / scale
    err = float((got - twin).abs().max())
    say(f'  {row}: max|err| against the twin {err:.3e} (max|ref| '
        f'{scale:.3e}, bound {1e-5 * scale:.1e}); float32 against the '
        f'float64 twin {rel:.3e}, the float32 twin {lib_rel:.3e}  [{card}]')
    require(err <= 1e-5 * scale, f'{row}: {err:.3e} against its twin')
    require(rel <= 4.0 * lib_rel, f'{row}: {rel:.3e} against the float64 '
            f'twin, above 4x the float32 twin\'s {lib_rel:.3e}')
    ms = time_ms(lambda: SK.apply_y(x, m))
    plain_ms = time_ms(lambda: SK.apply_y_plain(x, m))
    wide = torch.nn.functional.pad(x, (0, -lanes % 4))
    wide_ms = time_ms(lambda: SK.apply_y(wide, m))
    cells = nz * ny * lanes
    nbytes = (2 * cells + ny * ny) * 4
    flops = 2 * ny * cells
    t_b, t_o = nbytes / PEAK_BPS * 1e3, flops / PEAK_TF32X3 * 1e3
    out = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
               bound_ms=max(t_b, t_o),
               bound_by='bytes' if t_b >= t_o else 'operations',
               library_ms=plain_ms,
               bound_simt_ms=max(t_b, flops / PEAK_FLOPS[torch.float32]
                                 * 1e3),
               f32_vs_f64_twin=rel, f32_twin_vs_f64_twin=lib_rel,
               padded_width=lanes + (-lanes % 4), padded_ms=wide_ms)
    say(f'  {row}: kernel {ms:.4f} ms, plain twin (torch.matmul) '
        f'{plain_ms:.4f} ms, the width padded to {out["padded_width"]} '
        f'{wide_ms:.4f} ms; bound {out["bound_ms"]:.4f} ms by '
        f'{out["bound_by"]} (SIMT fp32 {out["bound_simt_ms"]:.4f})  '
        f'[{card}]')
    del x, got, twin, ref, wide
    ffts = {}
    for tag, nk in (('one device', lanes // 2), ('slab rank, dims (2, 1)',
                                                 -(-(lanes // 2) // 2))):
        c = torch.complex(torch.randn((nz, ny, nk), generator=gen,
                                      device=dev),
                          torch.randn((nz, ny, nk), generator=gen,
                                      device=dev))
        strided = time_ms(lambda: torch.fft.fft(c, dim=1))
        moved = time_ms(lambda: torch.fft.fft(
            c.transpose(1, 2).contiguous(), dim=-1).transpose(
                1, 2).contiguous())
        ffts[tag] = dict(lanes=nk, strided_ms=strided, moved_ms=moved)
        say(f'  the y FFT of the {tag} spectrum (nz, ny, {nk}) complex64: '
            f'along dim 1 as it lies {strided:.4f} ms, through a y-last '
            f'copy and back {moved:.4f} ms  [{card}]')
        del c
    out['y_fft'] = ffts
    torch.cuda.empty_cache()
    return {row: out}


def _time_row(rows, row, name, d, variant, card, cache):
    """One kernel variant on the inputs d against its twin (and, for
    F64_TWIN, its float32 error against the float64 twin, from d in
    float64 made once into cache), its time and the twin's; with a report
    row, its bound into rows[row]."""
    tag = f'{name}[{variant}]' if variant else name
    rel = lib_rel = None
    if name in F64_TWIN:
        # the float32 kernel (and its twin) against the float64 twin on the
        # same inputs, relative to each output's maximum
        if 'd64' not in cache:
            cache['d64'] = _as_double(d)
        rel, lib_rel = f32_vs_f64_twin(name, d, cache['d64'], variant)
        say(f'  {tag:<24s} float32 against the float64 twin: '
            f'max|err| / max|ref| kernel {rel:.3e}, float32 twin '
            f'{lib_rel:.3e} (worst output)  [{card}]')
        if name in FOUR_X:
            require(rel <= 4.0 * lib_rel,
                    f'{tag}: {rel:.3e} against the float64 twin, '
                    f'above 4x the float32 twin\'s {lib_rel:.3e}')
    worst = compare(name, d, tol_rel=(5.0 * lib_rel if name in REORDERED
                                      else 1e-5), variant=variant)
    if name == 'wallmodel' or (name, variant) in REL64:
        # the float64 kernel against its twin, and the float32 kernel
        # against the float64 twin, on these inputs
        if 'd64' not in cache:
            cache['d64'] = _as_double(d)
        compare(name, cache['d64'], tol_rel=WM_TOL64, variant=variant)
        if rel is not None:
            require(rel <= 1e-5, f'{tag}: {rel:.3e} against the float64 '
                    'twin')
    ms = time_ms(lambda: call(name, d, variant=variant))
    plain_ms = time_ms(lambda: call(name, d, twin=True, variant=variant))
    say(f'  {tag:<24s} kernel {ms:.3f} ms, plain twin {plain_ms:.3f} '
        f'ms per call  [{card}]')
    eager_ms = None
    if name in GRAPH_TIMED:
        eager_ms, ms = ms, graph_ms(lambda: call(name, d, variant=variant))
        say(f'  {tag:<24s} kernel {ms:.4f} ms per call on the device (a '
            f'CUDA graph of 20 calls; called one by one {eager_ms:.4f}, '
            f'the wrapper\'s host time)  [{card}]')
    if row is None:
        return
    bms, by = bound_ms(name, d, variant)
    rows[row] = dict(
        max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=plain_ms if name in LIBRARY_TWIN else None)
    if eager_ms is not None:
        rows[row]['eager_ms'] = eager_ms
    if name == 'wallmodel':
        rows[row].update(wm_step_counts(d, variant, tag, card))
    say(f'  {tag:<24s} bound {bms:.3f} ms ({by})')
    if name in LIBRARY_TWIN:
        simt, _ = bound_ms(name, d, variant, simt=True)
        rows[row]['bound_simt_ms'] = simt
        say(f'  {tag:<24s} bound at the 3xTF32 rate '
            f'{bms:.3f} ms, at the SIMT fp32 rate {simt:.3f} ms')
    if rel is not None:
        rows[row]['f32_vs_f64_twin'] = rel
        rows[row]['f32_twin_vs_f64_twin'] = lib_rel


def wm_step_counts(d, variant, tag, card):
    """The Newton steps of the wall model on the inputs d: a solve's mean
    and most, and the mean of what the kernel's warps run (31 points of a
    plane's row from i = 0, each its lanes' most; warps with a point in
    range), from the float64 twin's iteration."""
    per_face = wm_steps(d, variant)
    px = per_face[0].shape[-1]
    lanes = [torch.nn.functional.pad(q, (0, -px % 31)) for q in per_face]
    warps = torch.cat([q.reshape(*q.shape[:-1], -1, 31).amax(-1).flatten()
                       for q in lanes])
    warps = warps[warps > 0].double()
    steps = torch.cat([q.flatten() for q in per_face])
    solved = steps[steps > 0].double()
    out = dict(newton_steps_mean=float(solved.mean()),
               newton_steps_max=int(solved.max()),
               warp_steps_mean=float(warps.mean()))
    say(f'  {tag:<24s} Newton steps on these inputs (the float64 twin): '
        f'{out["newton_steps_mean"]:.3f} a solve on average, at most '
        f'{out["newton_steps_max"]}; the kernel\'s warps '
        f'{out["warp_steps_mean"]:.3f} on average  [{card}]')
    return out


def _as_double(d):
    """The kernel inputs d in float64."""
    def cv(x):
        if torch.is_tensor(x):
            return x.double()
        if isinstance(x, (list, tuple)) and not hasattr(x, '_fields'):
            return type(x)(cv(q) for q in x)
        return x
    return {k: cv(v) for k, v in d.items()}


def reset_counts():
    from cales_torch.ops import kernels as K
    from cales_torch.ops import solve_kernels as SK
    K.reset_launches()
    SK.reset_launches()


def counts():
    from cales_torch.ops import kernels as K
    from cales_torch.ops import solve_kernels as SK
    return {**K.LAUNCHES, **SK.LAUNCHES}


def phase_clis(card, runs):
    """Examples through the CLI, each in a subprocess of its own, all
    started together (they share the card, each with its own datadir):
    runs = [(tag, example, steps, kernels), ...]; each must exit 0, name
    its kernels on its Execution path line and write its fld.bin."""
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        t0 = time.perf_counter()
        for tag, example, steps, kernels in runs:
            data = Path(tmp) / tag.replace(' ', '_')
            data.mkdir()
            nml = ROOT / 'examples' / example / 'input.nml'
            cmd = [sys.executable, '-m', 'cales_torch', str(nml),
                   '--max-steps', str(steps), '--datadir', str(data)]
            say(f'{tag}: {" ".join(cmd[1:])}  [{card}]')
            out, err = data / 'stdout.txt', data / 'stderr.txt'
            with open(out, 'w') as fo, open(err, 'w') as fe:
                procs.append((tag, kernels, data, out, err, subprocess.Popen(
                    cmd, stdout=fo, stderr=fe, text=True, cwd=ROOT)))
        for tag, kernels, data, out, err, proc in procs:
            rc = proc.wait(timeout=600)
            say(f'  {tag}: exit {rc} after {time.perf_counter() - t0:.1f} s '
                'since all started')
            lines = out.read_text().splitlines()
            for line in lines[:3] + lines[-3:]:
                say(f'  | {line}')
            require(rc == 0, f'{tag}: CLI failed:\n'
                             f'{err.read_text()[-3000:]}')
            path = [ln for ln in lines if 'Execution path' in ln]
            require(path and all(k in path[0] for k in kernels),
                    f'{tag}: the Execution path line does not name '
                    f'{kernels}')
            require((data / 'fld.bin').exists(), f'{tag}: no fld.bin')


def drive(tag, cfg, dev, card, nsteps, per_step, ntime=10, hooks=None,
          keep=None, outside=None):
    """driver.run on cfg for nsteps steps with every launch count set to 0
    just before and read just after (each kernel of per_step must have
    launched exactly per_step[name] times a step, plus outside[name]
    times outside the steps (the initial fill, the checks), every other
    kernel never), then a timed loop of ntime steps; nu_t must be >= 0
    and not zero everywhere where an SGS model runs, w on z walls their face
    values with no net flux through the two.  hooks: the driver's output
    hooks; keep: a dict that receives the final state.  Returns (sim,
    launches, result dict)."""
    from cales_torch import driver
    from cales_torch.ops.stencil import bulk_mean
    nx, ny, nz = cfg.ng
    say(f'{tag}: driver.run, {cfg.ng} {cfg.dtype}, {nsteps} steps  [{card}]')
    torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        t0 = time.perf_counter()
        sim, state = driver.run(cfg, datadir=tmp, device=dev,
                                max_steps=nsteps, verbose=False, hooks=hooks)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts()
    say(f'  driver.run: {wall:.1f} s host wall (setup, checks and I/O '
        f'included); launches {launches}')
    say(f'  path: {sim.exec_path()}')
    for name, n in launches.items():
        want = per_step.get(name, 0) * nsteps + (outside or {}).get(name, 0)
        require(n == want, f'{tag}: {name} launched {n} times, want {want}')
    dt_cfl, divtot, divmax = sim.check(state)
    dt = sim.pick_dt(dt_cfl)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(ntime):
        state, _ = sim.step(state, dt)
    b.record()
    torch.cuda.synchronize()
    ms = a.elapsed_time(b) / ntime
    ns = ms * 1e6 / (nx * ny * nz * 3)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    dt_cfl, divtot, divmax = sim.check(state)
    ub = float(bulk_mean(state.u, sim.gvr_f))
    small = float(np.sqrt(np.finfo(np.float32).eps) * 10)
    say(f'  {ms:.3f} ms/step, {ns:.4f} ns/cell/RK3-substep over {ntime} '
        f'steps (CUDA events)  [{card}]')
    say(f'  peak memory {peak:.2f} GiB (max_memory_allocated)  [{card}]')
    say(f'  after {nsteps + ntime} steps: divmax {divmax:.3e} (abort bound '
        f'{small:.3e}), bulk u {ub:.7f}, dt {dt:.4e}')
    fields = [state.u, state.v, state.w, state.p, state.visct]
    require(all(bool(torch.isfinite(f).all()) for f in fields),
            f'{tag}: non-finite field')
    require(divmax <= small, f'{tag}: divmax {divmax:.3e} above {small:.3e}')
    if cfg.is_forced[0]:
        require(abs(ub - 1.0) <= 1e-4, f'{tag}: bulk u {ub:.7f}, want 1')
    faces = {}
    if sim.ywalled:
        # no flow through the walls: v on both y walls (the kept lower
        # face and the interior's last row)
        faces['v at y walls'] = (state.vlo[1][1:-1, 1:-1], state.v[:, -1])
    if sim.xwalled:
        # u on each x face where it is set (an inflow or a wall): its value
        # there (the kept lower face and the interior's last column), a
        # plane-valued one's interior entries (an inflow profile)
        def value(b):
            if np.ndim(b) == 0:
                return float(b)
            return torch.as_tensor(np.asarray(b)[1:-1, 1:-1],
                                   dtype=state.u.dtype, device=state.u.device)
        faces['u at the set x faces'] = tuple(
            q - value(cfg.bcvel[ib][0][0]) for ib, q in
            ((0, state.vlo[0][1:-1, 1:-1]), (1, state.u[:, :, -1]))
            if sim.cbcvel[ib][0][0] == 'D')
    if sim.have_zwalls:
        # and w on both z walls: their face values (0, or W through
        # transpiring walls)
        faces['w at z walls'] = (
            state.vlo[2][1:-1, 1:-1] - float(cfg.bcvel[0][2][2]),
            state.w[-1] - float(cfg.bcvel[1][2][2]))
        # the net flux through the two z walls (the grid is uniform in x, y)
        flux = float(state.vlo[2][1:-1, 1:-1].double().mean()
                     - state.w[-1].double().mean())
        say(f'  net flux through the z walls {flux:.3e}')
        require(abs(flux) <= 1e-6, f'{tag}: net z-wall flux {flux:.3e}')
    for what, planes in faces.items():
        worst = max(float(q.abs().max()) for q in planes)
        say(f'  max |{what} - its face value| {worst:.3e}')
        require(worst <= 1e-6, f'{tag}: {what} off by {worst:.3e}')
    for iv in (0, 1):
        lid = float(cfg.bcvel[1][2][iv])
        if lid:
            # the lid's u or v on the z-top face: the mean of the last row
            # and its ghost in the post-correction fill
            face = 0.5 * ((state.u, state.v)[iv][-1] + state.zq[iv][2])
            err = float((face - lid).abs().max())
            say(f'  max |{"uv"[iv]} - {lid}| on the lid {err:.3e}')
            require(err <= 1e-5, f'{tag}: lid {"uv"[iv]} off by {err:.3e}')
    if cfg.sgstype != 'none':
        nmin, nmax = float(state.visct.min()), float(state.visct.max())
        say(f'  nu_t in [{nmin:.4e}, {nmax:.4e}]')
        require(nmin >= 0.0 and nmax > 0.0,
                f'{tag}: nu_t in [{nmin:.3e}, {nmax:.3e}], want >= 0 and '
                'not zero everywhere')
    if keep is not None:
        keep['state'] = state
    return sim, launches, dict(ng=cfg.ng, ms_per_step=ms,
                               ns_per_cell_substep=ns, peak_gib=peak,
                               divmax=divmax, bulk_u=ub, card=card)


def phase_les(dev, card):
    """The channel-LES headline at 512x256x256 f32 by both transform routes:
    'fft' (cuFFT + z eigen-matmuls) and 'mat' (bench.py's own setting:
    apply_y + z_eig), then the Poisson solve alone by both routes."""
    from cales_torch.config import Config
    from cales_torch import poisson
    les = dict(mom_rk=3, fillps=3, correc_smag=3)
    sim_f, launches, res_f = drive('phase 4: LES, fft', Config(**LES_CFG),
                                   dev, card, 31, les)
    print(json.dumps({'headline': res_f}), flush=True)
    sim_m, _, res_m = drive(
        'phase 4m: LES, mat', Config(**{**LES_CFG, 'ptransform': 'mat'}),
        dev, card, 11, {**les, 'apply_y': 6, 'z_eig': 3})
    print(json.dumps({'headline_mat': res_m}), flush=True)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    rhs = torch.randn(tuple(HEADLINE_NG[::-1]), generator=gen, device=dev)
    rhs = rhs - rhs.mean()
    times = {}
    for route, sim in (('fft', sim_f), ('mat', sim_m)):
        times[route] = time_ms(lambda: poisson.solve(sim.solver_p, rhs),
                               n=20)
    say(f'  Poisson solve at {HEADLINE_NG} float32: fft {times["fft"]:.3f} '
        f'ms, mat {times["mat"]:.3f} ms per solve (CUDA events)  [{card}]')
    return launches


def phase_wmles(dev, card):
    """bench.py's wmles_channel (the log-law wall model on both z walls)
    at 512x256x256 f32 through driver.run: the wall-model kernel once a
    substep (the fused correction's corrected rows, whose planes the
    post-correction fill takes), and once more for the initial fill and
    at each check; then the
    wall model's planes of the final state: finite, the lower face's bcu of
    the sign of the mean u next to it."""
    from cales_torch.config import Config
    from cales_torch.ops import kernels as K
    cfg = Config(**WMLES_CFG)
    nsteps = 11
    per_step = dict(mom_rk=3, fillps=3, correc_smag=3, apply_y=6, z_eig=3,
                    wallmodel=3)
    keep = {}
    sim, launches, res = drive(
        'phase 4w: wall-modelled channel LES', cfg, dev, card, nsteps,
        per_step, keep=keep,
        outside={'wallmodel': 2 + nsteps // cfg.icheck})
    path = sim.exec_path()
    require('wallmodel' in path and "'E' z-ghost recipe" in path,
            f'phase 4w: the path does not name the wall model: {path}')
    st = keep.pop('state')
    planes = torch.stack(K.wm_planes(st.u, st.v, sim.wm))
    require(bool(torch.isfinite(planes).all()),
            'phase 4w: non-finite wall-model planes')
    lo = [n for n, f in enumerate(sim.wm.faces) if f.ib == 0][0]
    bcu_lo = float(planes[lo, 0, 1:-1, 1:-1].double().mean())
    u_lo = float(st.u[0].double().mean())
    say(f'  lower face: mean bcu {bcu_lo:.5e} (tau_w/visc), mean u of the '
        f'first row {u_lo:.5f}; planes in [{float(planes.min()):.4e}, '
        f'{float(planes.max()):.4e}]')
    require(bcu_lo * u_lo > 0, 'phase 4w: the lower face\'s bcu is not of '
            'the sign of the mean u next to it')
    res.update(bcu_lo_mean=bcu_lo, u_first_row_mean=u_lo)
    print(json.dumps({'wmles': res}), flush=True)
    return launches, nsteps


def phase_wmles_duct(dev, card):
    """The wall-modelled duct (examples/turbulent_duct_wmles's physics) at
    512x256x256 f32 through driver.run: the wall-model kernel on its four
    faces once a substep (the post-correction fill, whose y-row stacks
    serve the next substep's mom_rk) and once more for the initial fill
    and at each check, smag's y-wall variant on its 'E' stacks; then the
    wall model's planes of the final state: finite, and on each face the
    wall shear along the flow next to it (sgn bcu of the sign of the mean
    u of the face's first row)."""
    from cales_torch.config import Config
    from cales_torch.ops import kernels as K
    cfg = Config(**DUCT_WMLES_CFG)
    nsteps = 11
    per_step = dict(mom_rk=3, fillps=3, correc_updatep=3, smag=3, apply_y=6,
                    z_eig=3, wallmodel=3)
    keep = {}
    sim, launches, res = drive(
        'phase 8w: wall-modelled duct LES', cfg, dev, card, nsteps,
        per_step, keep=keep,
        outside={'wallmodel': 2 + nsteps // cfg.icheck})
    path = sim.exec_path()
    require(all(k in path for k in ('wallmodel', 'lower y', 'upper z',
                                    'y-wall variant', "'E' ghost stacks")),
            f'phase 8w: the path does not name the wall model: {path}')
    st = keep.pop('state')
    planes = K.wm_planes(st.u, st.v, sim.wm, w=st.w)
    require(all(bool(torch.isfinite(q).all()) for q in planes),
            'phase 8w: non-finite wall-model planes')
    next_u = {(2, 0): st.u[0], (2, 1): st.u[-1], (1, 0): st.u[:, 0],
              (1, 1): st.u[:, -1]}
    for f, q in zip(sim.wm.faces, planes):
        bcu = float(q[0, 1:-1, 1:-1].double().mean())
        un = float(next_u[(f.d, f.ib)].double().mean())
        side = f"{('lower', 'upper')[f.ib]} {'xyz'[f.d]}"
        say(f'  {side} face: mean bcu {bcu:.5e} (sgn tau_w/visc), mean u of '
            f'the first row {un:.5f}')
        require(f.sgn * bcu * un > 0, f'phase 8w: the {side} face\'s bcu '
                'is not along the flow next to it')
        res[f'bcu_mean_{side.replace(" ", "_")}'] = bcu
    print(json.dumps({'wmles_duct': res}), flush=True)
    return launches, nsteps


def phase_dns(dev, card):
    """The implicit-CN channel DNS at 512x256x256 f32 through driver.run."""
    from cales_torch.config import Config
    per_step = dict(mom_rk=3, fillps=3, correc_updatep=3, apply_y=6,
                    z_eig=3, thomas_z=9)
    _, launches, res = drive('phase 5: implicit-CN channel DNS',
                             Config(**DNS_CFG), dev, card, 11, per_step)
    print(json.dumps({'dns': res}), flush=True)
    return launches


def phase_dsmag(dev, card):
    """The dynamic-Smagorinsky channel (validation/dsmag_channel.py) at
    512x256x256 f32 through driver.run, then the static-Smagorinsky LES
    with z-implicit diffusion."""
    from cales_torch.config import Config
    per_step = dict(mom_rk=3, fillps=3, thomas_z=9, apply_y=6, z_eig=3,
                    correc_updatep=3, dsmag=3)
    _, launches, res = drive('phase 7: dynamic-Smagorinsky channel',
                             Config(**DSMAG_CFG), dev, card, 5, per_step)
    print(json.dumps({'dsmag_channel': res}), flush=True)
    per_step_imp = dict(per_step, dsmag=0, smag=3)
    _, launches_imp, res_imp = drive('phase 7b: static-Smagorinsky LES, '
                                     'impdiff_1d', Config(**LES_IMP_CFG), dev,
                                     card, 5, per_step_imp)
    print(json.dumps({'les_impdiff': res_imp}), flush=True)
    return launches, launches_imp, res


def phase_dsmag_dit(dev, card):
    """Phase 7e: phase 7's dynamic-Smagorinsky channel with the 'dit'
    average (one dzf-weighted ratio for the volume) and with the 2D test
    filter (the dsmag kernel's F2D mode, alpha^2 2.52, 'channel'), 3 steps
    each through driver.run.  Returns the 2D filter's launches."""
    from cales_torch.config import Config
    per_step = dict(mom_rk=3, fillps=3, thomas_z=9, apply_y=6, z_eig=3,
                    correc_updatep=3, dsmag=3)
    out = {}
    for key, change, word in (('dit', dict(dsmag_avg='dit'), "'dit'"),
                              ('filter_2d', dict(filter_2d=True),
                               '2D test filter')):
        sim, launches, res = drive(f'phase 7e: dsmag channel, {key}',
                                   Config(**{**DSMAG_CFG, **change}), dev,
                                   card, 3, per_step, ntime=10)
        require(word in sim.exec_path(),
                f'phase 7e {key}: the path does not name {word}')
        print(json.dumps({f'dsmag_channel_{key}': res}), flush=True)
        out[key] = launches
    return out['filter_2d']


def _single_ratio(sim, state, tag, card):
    """'dit': nu_t / |S| one value for the volume (where |S| is not
    small), |S| from the dsmag kernel on the state's fill."""
    from cales_torch.ops import kernels as K
    cfg = sim.cfg
    ue, ve, we = state.zq
    s0 = K.dsmag(state.u, state.v, state.w, ue, ve, we, sim.alph2_t,
                 sim.dzci_t, sim.dzfi_t, cfg.dli[0], cfg.dli[1], False,
                 False, zper=True, avg='dit')[0]
    keep = s0 > 1e-3 * s0.max()
    r = (state.visct[keep] / s0[keep]).double()
    lo, hi = float(r.min()), float(r.max())
    spread = (hi - lo) / max(abs(hi), 1e-300)
    say(f'  nu_t / |S| over the cells: [{lo:.7e}, {hi:.7e}], spread '
        f'{spread:.3e} of its maximum (one ratio: float32 rounding, bound '
        f'1e-5)  [{card}]')
    require(hi > 0 and spread <= 1e-5,
            f'{tag}: nu_t / |S| in [{lo:.3e}, {hi:.3e}], not one ratio')
    return hi


def phase_box_les(dev, card):
    """The triperiodic LES: the Taylor-Green vortex of
    examples/taylor_green_vortex_3d at 512^3 f32 on the example's 'auto'
    route ('fft') through driver.run with static Smagorinsky (the smag
    kernel without walls: no van Driest; phase 14, 5 steps) and with
    dynamic Smagorinsky and the 'dit' average (the dsmag kernel's
    periodic-z mode, one ratio for the volume; phase 14d, 3 steps), each
    with its ms/step and the device's busy and idle time under
    torch.profiler; the kinetic energy falls at every step.  Phase 14f:
    the box at 256^3 with smag forced along z to a bulk w of 0.1, 3 steps.
    Returns the three runs' launches."""
    from cales_torch.config import Config
    from cales_torch.ops.stencil import bulk_mean
    from cales_torch.profile_step import device_profile
    base = dict(mom_rk=3, fillps=3, correc_updatep=3)
    out = {}
    for key, tag, change, nsteps, per_step, word in (
            ('smag', 'phase 14: TGV LES, smag', dict(sgstype='smag'), 5,
             dict(base, smag=3), 'no van Driest'),
            ('dsmag', "phase 14d: TGV LES, dsmag 'dit'",
             dict(sgstype='dsmag', dsmag_avg='dit'), 3,
             dict(base, dsmag=3), 'periodic-z mode')):
        cfg = Config(**{**TGV_CFG, 'ptransform': 'auto', 'iout1d': 1,
                        **change})
        ke, keep = [], {}

        def record(sim, state, istep, ke=ke):
            ke.append(_kinetic_energy(state))
        sim, launches, res = drive(tag, cfg, dev, card, nsteps, per_step,
                                   ntime=10, hooks={'out1d': record},
                                   keep=keep)
        path = sim.exec_path()
        require(word in path, f'{tag}: the path does not name {word}')
        say('  kinetic energy by step: ' + ' '.join(f'{e:.9f}' for e in ke))
        require(len(ke) == nsteps and ke[0] < 0.125 and all(
            b < a for a, b in zip(ke, ke[1:])),
            f'{tag}: the kinetic energy does not fall at every step')
        state = keep['state']
        if key == 'dsmag':
            res['ratio'] = _single_ratio(sim, state, tag, card)
        dt = sim.pick_dt(sim.check(state)[0])
        step_ms, per_kernel, state = device_profile(sim, state, dt, 3)
        busy = sum(ms for ms, _ in per_kernel.values())
        nlaunch = sum(n for _, n in per_kernel.values())
        sgs_ms = sum(ms for name, (ms, _) in per_kernel.items()
                     if ('dsmag_kernel' if key == 'dsmag'
                         else 'cales::smag_kernel') in name)
        say(f'  profiled: {step_ms:.3f} ms/step (CUDA events), device busy '
            f'{busy:.3f} ms, idle {step_ms - busy:.3f} ms '
            f'({1 - busy / step_ms:.3f} of the step), {key} kernel '
            f'{sgs_ms:.3f} ms a step, {nlaunch} launches a step '
            f'(torch.profiler)  [{card}]')
        res.update(kinetic_energy=ke, busy_ms=busy, profiled_step_ms=step_ms,
                   idle_share=1 - busy / step_ms, sgs_kernel_ms=sgs_ms,
                   launches_per_step=nlaunch)
        print(json.dumps({f'tgv_les_{key}': res}), flush=True)
        out[key] = launches
        del sim, state, keep
        torch.cuda.empty_cache()
    cfg = Config(**{**TGV_CFG, 'ng': (256, 256, 256), 'ptransform': 'auto',
                    'sgstype': 'smag', 'is_forced': (False, False, True),
                    'velf': (0.0, 0.0, 0.1)})
    keep = {}
    sim, out['forced'], res = drive(
        'phase 14f: the box forced along z, smag', cfg, dev, card, 3,
        dict(base, smag=3), ntime=10, keep=keep)
    wb = float(bulk_mean(keep['state'].w, sim.gvr_c_t))
    say(f'  bulk w {wb:.7f} (velf 0.1, bound 1e-4)  [{card}]')
    require(abs(wb - 0.1) <= 1e-4, f'phase 14f: bulk w {wb:.7f}, want 0.1')
    res['bulk_w'] = wb
    print(json.dumps({'box_forced_z': res}), flush=True)
    return out['smag'], out['dsmag'], out['forced']


def phase_ywalls(dev, card):
    """The dynamic-Smagorinsky square duct and spanwise-periodic cavity
    (bench.py duct_les_dsmag, cavity_les_dsmag) at 512x256x256 f32 through
    driver.run, the y-walled variants of the kernels."""
    from cales_torch.config import Config
    per_step = dict(mom_rk=3, fillps=3, apply_y=6, z_eig=3,
                    correc_updatep=3, dsmag=3)
    _, duct, res_d = drive('phase 8: dynamic-Smagorinsky duct',
                           Config(**DUCT_CFG), dev, card, 5, per_step)
    print(json.dumps({'duct': res_d}), flush=True)
    _, cavity, res_c = drive('phase 8b: dynamic-Smagorinsky cavity',
                             Config(**CAVITY_CFG), dev, card, 5, per_step)
    print(json.dumps({'cavity': res_c}), flush=True)
    return duct, cavity, res_d, res_c


def phase_mixed(dev, card, res_duct):
    """Phase 8f: phase 8's dynamic-Smagorinsky duct by ptransform 'fft',
    the mixed Poisson route (rfft along x, apply_y with the y DCT alone on
    the real view of its lanes, the z eigen matmuls, and back), at
    512x256x256 f32 through driver.run with phase 8's gates and exact
    launches (apply_y 6 a step, no z_eig); its ms/step beside phase 8's
    in this call (res_duct), and the Poisson solve alone by both routes on
    the same RHS.  Returns its launches."""
    from cales_torch import poisson
    from cales_torch.config import Config
    from cales_torch.timeloop import Simulation
    per_step = dict(mom_rk=3, fillps=3, apply_y=6, correc_updatep=3,
                    dsmag=3)
    cfg = Config(**{**DUCT_CFG, 'ptransform': 'fft'})
    sim, launches, res = drive("phase 8f: dynamic-Smagorinsky duct, 'fft' "
                               '(the mixed route)', cfg, dev, card, 5,
                               per_step)
    path = sim.exec_path()
    require('mixed route' in path, f'phase 8f: not the mixed route: {path}')
    mat = Simulation(Config(**DUCT_CFG), sim.grid, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    rhs = torch.randn(tuple(HEADLINE_NG[::-1]), generator=gen, device=dev)
    rhs = rhs - rhs.mean()
    sol = {route: poisson.solve(s_.solver_p, rhs)
           for route, s_ in (('fft', sim), ('mat', mat))}
    diff = float(((sol['fft'] - sol['fft'].mean())
                  - (sol['mat'] - sol['mat'].mean())).abs().max()
                 / sol['mat'].abs().max())
    times = {route: time_ms(lambda: poisson.solve(s_.solver_p, rhs), n=20)
             for route, s_ in (('fft', sim), ('mat', mat))}
    say(f'  {res["ms_per_step"]:.3f} ms/step against phase 8\'s (\'mat\') '
        f'{res_duct["ms_per_step"]:.3f} in this call; the Poisson solve at '
        f'{HEADLINE_NG} float32: mixed {times["fft"]:.3f} ms, mat '
        f'{times["mat"]:.3f} ms (CUDA events), the two solutions apart by '
        f'{diff:.3e} of the maximum after removing their means  [{card}]')
    require(diff <= 1e-3, f'phase 8f: the routes\' solves apart by {diff}')
    res.update(solve_ms_mixed=times['fft'], solve_ms_mat=times['mat'],
               solve_rel_diff=diff, mat_ms_per_step=res_duct['ms_per_step'])
    print(json.dumps({'duct_mixed': res}), flush=True)
    del sim, mat, sol, rhs
    torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def twopass():
    """CALES_DSMAG_TWOPASS=1 for the Simulations made inside the block:
    the two-pass dynamic Smagorinsky where the one pass would run."""
    old = os.environ.get('CALES_DSMAG_TWOPASS')
    os.environ['CALES_DSMAG_TWOPASS'] = '1'
    try:
        yield
    finally:
        if old is None:
            del os.environ['CALES_DSMAG_TWOPASS']
        else:
            os.environ['CALES_DSMAG_TWOPASS'] = old


def phase_twopass(dev, card, onepass):
    """The two-pass dynamic Smagorinsky (dsmag_level1, the filtered
    velocity's fill, dsmag_level2) at 512x256x256 f32 through driver.run:
    the transpiring channel dsmag_blow, which only the two passes carry
    (phase 7c); then the dsmag channel, duct and cavity by two passes
    (CALES_DSMAG_TWOPASS=1, phase 7d) beside their one-pass runs of phases
    7, 8 and 8b in this call (onepass: their result dicts), with nu_t of
    both routes on the same state.  The f32 bound on nu_t, 1e-4 of its
    maximum: the routes differ only by the order of the sums and by FMA
    contraction.  Returns the launches of the two-pass runs."""
    from cales_torch.config import Config
    from cales_torch.timeloop import Simulation
    base = dict(mom_rk=3, fillps=3, apply_y=6, z_eig=3, correc_updatep=3,
                dsmag_level1=3, dsmag_level2=3)
    chan = dict(base, thomas_z=9)
    sim, blow, res = drive('phase 7c: dsmag_blow, the transpiring dsmag '
                           'channel', Config(**DSMAG_BLOW_CFG), dev, card, 5,
                           chan)
    require(sim.dsmag_twopass, 'phase 7c: not on the two-pass route')
    print(json.dumps({'dsmag_blow': res}), flush=True)
    out = {'blow': blow}
    for key, kw, per_step in (('channel', DSMAG_CFG, chan),
                              ('duct', DUCT_CFG, base),
                              ('cavity', CAVITY_CFG, base)):
        keep = {}
        with twopass():
            sim, launches, res = drive(f'phase 7d: dsmag {key}, two passes',
                                       Config(**kw), dev, card, 5, per_step,
                                       keep=keep)
        require(sim.dsmag_twopass, f'phase 7d {key}: not on two passes')
        one = Simulation(sim.cfg, sim.grid, device=dev)
        require(not one.dsmag_twopass, f'phase 7d {key}: one pass expected')
        st = keep.pop('state')
        nu1, nu2 = (s_._sgs_stage(st.u, st.v, st.w, st.zq, st.vlo)
                    for s_ in (one, sim))
        rel = float((nu1 - nu2).abs().max() / nu1.abs().max())
        one_res = onepass[key]
        say(f'  {key}: one pass {one_res["ms_per_step"]:.3f} ms/step, '
            f'{one_res["peak_gib"]:.2f} GiB; two passes '
            f'{res["ms_per_step"]:.3f} ms/step, {res["peak_gib"]:.2f} GiB; '
            f'nu_t of the two routes on one state apart by {rel:.3e} of '
            f'its maximum (bound 1e-4)  [{card}]')
        require(rel <= 1e-4, f'phase 7d {key}: nu_t apart by {rel:.3e}')
        res['nu_t_one_vs_two_rel'] = rel
        print(json.dumps({f'dsmag_twopass_{key}': res}), flush=True)
        out[key] = launches
        del sim, one, st, nu1, nu2
    return out


def _kinetic_energy(state):
    """1/2 the mean of u^2 + v^2 + w^2 over the cells, float64 sums."""
    return 0.5 * sum(float((q.double() ** 2).mean())
                     for q in (state.u, state.v, state.w))


def phase_tgv(dev, card):
    """The Taylor-Green vortex of examples/taylor_green_vortex_3d at 512^3
    f32 through driver.run: 'mat' (apply_y and the periodic Thomas z stage,
    nz >= 384; phase 9), then the example's 'auto' route 'fft' (cuFFT and
    the z eigen-matmuls; phase 9f), then the Poisson solve alone by both.
    The kinetic energy starts at 1/8 and falls at every step."""
    from cales_torch import poisson
    from cales_torch.config import Config
    from cales_torch.grid import make_grid_from_config
    from cales_torch.initflow import initflow
    cfg = Config(**TGV_CFG)
    t0 = time.perf_counter()
    u, v, w, _ = initflow(cfg, make_grid_from_config(cfg))
    t_init = time.perf_counter() - t0
    ke0 = 0.5 * float(np.mean(u ** 2) + np.mean(v ** 2) + np.mean(w ** 2))
    del u, v, w
    say(f'phase 9: the Taylor-Green vortex at {cfg.ng}, initial kinetic '
        f'energy {ke0:.9f}; the host-side numpy initial field took '
        f'{t_init:.1f} s')
    require(abs(ke0 - 0.125) <= 1e-6, f'TGV initial energy {ke0}, want 1/8')
    sims, out = {}, {}
    for route, tag, per_step in (
            ('mat', 'phase 9: TGV, mat',
             dict(mom_rk=3, fillps=3, apply_y=6, thomas_periodic=3,
                  correc_updatep=3)),
            ('fft', 'phase 9f: TGV, fft',
             dict(mom_rk=3, fillps=3, correc_updatep=3))):
        ke = []

        def record(sim, state, istep, ke=ke):
            ke.append(_kinetic_energy(state))
        sim, launches, res = drive(
            tag, cfg.replace(ptransform=route, iout1d=1), dev, card, 5,
            per_step, ntime=10, hooks={'out1d': record})
        say(f'  kinetic energy by step: {ke0:.9f} ' + ' '.join(
            f'{e:.9f}' for e in ke))
        require(len(ke) == 5 and all(b < a for a, b in zip([ke0] + ke, ke)),
                f'{tag}: the kinetic energy does not fall at every step')
        res['kinetic_energy'] = [ke0] + ke
        sims[route], out[route] = sim, (launches, res)
        print(json.dumps({f'tgv_{route}': res}), flush=True)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    rhs = torch.randn(tuple(cfg.ng[::-1]), generator=gen, device=dev)
    rhs = rhs - rhs.mean()
    times = {route: time_ms(lambda: poisson.solve(sim.solver_p, rhs), n=10)
             for route, sim in sims.items()}
    say(f'  Poisson solve at {cfg.ng} float32: mat {times["mat"]:.3f} ms, '
        f'fft {times["fft"]:.3f} ms per solve (CUDA events)  [{card}]')
    # each route's float32 solve against its own float64 solve (means
    # removed): the periodic Thomas z stage against the z eigen-matmuls
    for route, sim in sims.items():
        p32 = poisson.solve(sim.solver_p, rhs).double()
        p64 = poisson.solve(sim.solver_p, rhs.double())
        p32, p64 = p32 - p32.mean(), p64 - p64.mean()
        rel = float((p32 - p64).abs().max() / p64.abs().max())
        say(f'  {route} solve, float32 against float64: max|err| / max|ref| '
            f'{rel:.3e}  [{card}]')
        del p32, p64
    _tgv_solve_kernels(sims['mat'].solver_p, rhs, card)
    return out['mat'][0]


def _tgv_solve_kernels(sv, rhs, card):
    """The 'mat' solve's kernels at the TGV's 512^3: apply_y at ny = nx =
    512 against its twin; the pinned periodic Thomas z stage in float32
    against its float64 twin on the same input (the singular lane's
    tolerance must pin the (0, 0) lane and no other).  The bound 1e-3:
    the sweep's float32 error grows with the reduced z system's condition
    number, ~(2 nz / pi)^2 ~ 1e5 at nz = 512, on the lanes of small lam;
    the float32 sweep (the twin) is held to it beside the kernel."""
    from cales_torch import poisson
    from cales_torch.ops import solve_kernels as SK
    t = lambda a, dt=torch.float32: torch.as_tensor(  # noqa: E731
        np.ascontiguousarray(a), dtype=dt, device=rhs.device)
    fy, fxT = t(sv.try_.fwd_mat), t(sv.trx.fwd_mat.T)
    got = SK.apply_y(rhs, fy, MxT=fxT)
    ref = SK.apply_y_plain(rhs, fy, MxT=fxT)
    err = float((got - ref).abs().max() / ref.abs().max())
    ms = time_ms(lambda: SK.apply_y(rhs, fy, MxT=fxT))
    plain = time_ms(lambda: SK.apply_y_plain(rhs, fy, MxT=fxT))
    nz, ny, nx = rhs.shape
    flops = 2.0 * nz * ny * nx * (nx + ny)
    bound, simt = (flops / rate * 1e3 for rate in (PEAK_TF32X3,
                                                   PEAK_FLOPS[rhs.dtype]))
    say(f'  apply_y at {tuple(rhs.shape)}: kernel {ms:.3f} ms, plain '
        f'(cuBLAS) {plain:.3f} ms, bound {bound:.3f} ms at the 3xTF32 rate '
        f'({simt:.3f} at the SIMT fp32 rate); max|err| / max|ref| '
        f'{err:.3e} (bound 1e-5)  [{card}]')
    print(json.dumps({'apply_y_512cubed': dict(
        ms=ms, library_ms=plain, bound_ms=bound, bound_simt_ms=simt,
        max_rel_err=err, card=card)}), flush=True)
    require(err <= 1e-5, f'apply_y at 512^3: {err:.3e}')
    lamy, lamx = t(sv.lamy), t(sv.lamx)
    tol = poisson._thomas_tol(sv.lamx, sv.lamy, torch.float32)
    pinned = int(((lamx[None, :] + lamy[:, None]).abs() <= tol).sum())
    lone = float((lamx[0] + lamy[0]).abs()) <= tol
    say(f'  thomas_periodic pin tolerance {tol:.3e}: {pinned} lane(s) '
        f'pinned, lane (0, 0) {"among them" if lone else "not pinned"}')
    require(pinned == 1 and lone, 'the pin must take lane (0, 0) alone')
    abc = tuple(t(q, torch.float64) for q in (sv.a, sv.b, sv.c))
    x = got
    got = SK.thomas_periodic_z(x, *abc, lamy=lamy, lamx=lamx, pin=True,
                               tol=tol)
    require(float(got[-1, 0, 0]) == 0.0,
            'thomas_periodic: the pinned lane\'s last row is not 0')
    ref = SK.thomas_periodic_z_plain(
        x.double(), *abc, lamy=lamy.double(), lamx=lamx.double(), pin=True,
        tol=tol).float()
    twin = SK.thomas_periodic_z_plain(x, *abc, lamy=lamy, lamx=lamx,
                                      pin=True, tol=tol)
    for what, q in (('kernel', got), ('twin (the sweep)', twin)):
        diff = (q - ref).abs()
        err = float(diff.max() / ref.abs().max())
        lane = float((diff.amax(0) / ref.abs().amax(0).clamp_min(1e-30))
                     .max())
        say(f'  thomas_periodic float32 {what} against the float64 twin at '
            f'{tuple(got.shape)}: max|err| / max|ref| {err:.3e}, worst '
            f'lane (max over z of |err| / |ref|) {lane:.3e}  [{card}]')
        require(err <= 1e-3, f'thomas_periodic f32 {what} against f64: '
                f'{err:.3e}')


def phase_triperiodic(dev, card):
    """bench.py's triperiodic_dns at 512x256x256 f32 'mat' (z_eig with
    periodic z; phase 9b), the same with full-3D implicit diffusion (a
    Helmholtz solve per component by apply_y and thomas_periodic; phase
    9i), and the implicit-CN channel DNS with full-3D implicit diffusion
    (thomas_z with the lam shift and w's tail row; phase 5f)."""
    from cales_torch.config import Config
    base = dict(mom_rk=3, fillps=3, correc_updatep=3)
    sim, _, res = drive('phase 9b: triperiodic DNS', Config(**TRI_CFG),
                        dev, card, 5, dict(base, apply_y=6, z_eig=3))
    print(json.dumps({'triperiodic_dns': res}), flush=True)
    # the z stage at nz = 256: z_eig (the rule's choice below nz = 384)
    # against the periodic Thomas kernel on the same right-hand side
    from cales_torch import poisson
    from cales_torch.grid import make_grid_from_config
    cfg = Config(**TRI_CFG, zsolver='thomas')
    svt = poisson.make_solver(cfg, make_grid_from_config(cfg),
                              ('PP', 'PP', 'PP'), ('c', 'c', 'c'),
                              zsolver='thomas')
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    rhs = torch.randn(tuple(cfg.ng[::-1]), generator=gen, device=dev)
    rhs = rhs - rhs.mean()
    sols, times = {}, {}
    for zstage, sv in (('z_eig', sim.solver_p), ('thomas_periodic', svt)):
        sols[zstage] = poisson.solve(sv, rhs)
        sols[zstage] = sols[zstage] - sols[zstage].mean()
        times[zstage] = time_ms(lambda: poisson.solve(sv, rhs), n=10)
    rel = float((sols['z_eig'] - sols['thomas_periodic']).abs().max()
                / sols['z_eig'].abs().max())
    say(f'  Poisson solve at {cfg.ng} float32 by mat: z_eig '
        f'{times["z_eig"]:.3f} ms, thomas_periodic '
        f'{times["thomas_periodic"]:.3f} ms per solve; solutions apart by '
        f'{rel:.3e} of their maximum (means removed)  [{card}]')
    require(rel <= 1e-4, f'z_eig and thomas_periodic apart by {rel:.3e}')
    _, tri3, res = drive('phase 9i: triperiodic DNS, full-3D implicit',
                         Config(**TRI_CFG, impdiff=True), dev, card, 5,
                         dict(base, apply_y=24, z_eig=3, thomas_periodic=9))
    print(json.dumps({'triperiodic_dns_impdiff3d': res}), flush=True)
    _, dns3, res = drive('phase 5f: channel DNS, full-3D implicit',
                         Config(**{**DNS_CFG, 'impdiff_1d': False}), dev,
                         card, 5, dict(base, apply_y=24, z_eig=3,
                                       thomas_z=9))
    print(json.dumps({'dns_impdiff3d': res}), flush=True)
    return tri3, dns3


def phase_xwalls(dev, card):
    """Phase 11: the developing channel (examples/developing_channel's
    physics) at 512x256x256 f32 through driver.run: the x-walled mom_rk,
    fillps and correc_updatep, apply_y with the DCT-IV x operator, z_eig;
    u at 1 on the inflow face, w at 0 on both z walls, the outflow's flux
    the inflow's.  Phase 11b: the lid-driven cavity
    (examples/lid_driven_cavity's physics) at 512x256x256 f32: the x- and
    y-walled variants, the DCT-II x and y operators; no flow through the
    six walls, the lid's u at 1.  Returns both runs' launches."""
    from cales_torch.config import Config
    per_step = dict(mom_rk=3, fillps=3, correc_updatep=3, apply_y=6,
                    z_eig=3)
    keep = {}
    sim, xdev, res = drive('phase 11: developing channel',
                           Config(**XDEV_CFG), dev, card, 5, per_step,
                           keep=keep)
    require(sim.xwalled and not sim.ywalled and 'x-walled variants' in
            sim.exec_path(), 'phase 11: not on the x-walled path')
    st = keep['state']
    # the flux through the outflow face (the interior's last column of u)
    # against the inflow's (the kept lower face); the grid is uniform in y
    # and z
    f_in = float(st.vlo[0][1:-1, 1:-1].double().mean())
    f_out = float(st.u[:, :, -1].double().mean())
    say(f'  flux through the inflow face {f_in:.7f}, the outflow face '
        f'{f_out:.7f} (a unit area)')
    require(abs(f_out - f_in) <= 1e-4 * abs(f_in),
            f'phase 11: outflow flux {f_out:.7f}, inflow {f_in:.7f}')
    res.update(flux_in=f_in, flux_out=f_out)
    print(json.dumps({'developing_channel': res}), flush=True)
    sim, xcav, res = drive('phase 11b: lid-driven cavity',
                           Config(**XCAVITY_CFG), dev, card, 5, per_step)
    require(sim.xwalled and sim.ywalled, 'phase 11b: not x- and y-walled')
    print(json.dumps({'lid_driven_cavity': res}), flush=True)
    return xdev, xcav


def phase_xles(dev, card):
    """Phase 12: the developing wall-modelled channel LES at 512x256x256
    f32 through driver.run: the x-walled mom_rk with nu_t, smag's x-wall
    variant on the 'E' x stacks, the wall model's x-walled sampling, the
    1/7-power inflow profile as the x stacks' offsets; the inflow face at
    the profile, the outflow's flux the inflow's, w at 0 on the z walls,
    nu_t finite and >= 0.  Phase 12b: the developing channel LES with
    z-implicit diffusion (mom_rk's x-walled '1d' split, 9 thomas_z a
    step); 12c the developing duct LES (smag's x- and y-wall variant).
    Returns each run's launches and steps."""
    from cales_torch.config import Config
    from cales_torch.ops import kernels as K
    per_step = dict(mom_rk=3, fillps=3, correc_updatep=3, smag=3, apply_y=6,
                    z_eig=3)
    cfg = xwmles_cfg()
    nsteps = 11
    keep = {}
    sim, wmx, res = drive(
        'phase 12: developing wall-modelled channel LES', cfg, dev, card,
        nsteps, dict(per_step, wallmodel=3), keep=keep,
        outside={'wallmodel': 2 + nsteps // cfg.icheck})
    path = sim.exec_path()
    require(sim.xwalled and all(k in path for k in (
        'x-walled variants', 'wallmodel', 'x-wall variant',
        "x faces' values", 'plane-valued values')),
        f'phase 12: not on the x-walled WMLES path: {path}')
    st = keep.pop('state')
    # the flux through the outflow face (u's last column) against the
    # inflow's (the kept lower face), weighted by the cells' dz
    dzf = torch.as_tensor(sim.grid.dzf[1:-1], dtype=torch.float64,
                          device=st.u.device)[:, None]
    f_in = float((st.vlo[0][1:-1, 1:-1].double() * dzf).sum())
    f_out = float((st.u[:, :, -1].double() * dzf).sum())
    say(f'  flux through the inflow face {f_in:.7f}, the outflow face '
        f'{f_out:.7f} (sum over the face of u dz)')
    require(abs(f_out - f_in) <= 1e-4 * abs(f_in),
            f'phase 12: outflow flux {f_out:.7f}, inflow {f_in:.7f}')
    planes = K.wm_planes(st.u, st.v, sim.wm)
    require(all(bool(torch.isfinite(q).all()) for q in planes),
            'phase 12: non-finite wall-model planes')
    res.update(flux_in=f_in, flux_out=f_out)
    print(json.dumps({'developing_wmles': res}), flush=True)
    _, ximp, res = drive('phase 12b: developing channel LES, impdiff_1d',
                         Config(**XLES_IMP_CFG), dev, card, 5,
                         dict(per_step, thomas_z=9))
    print(json.dumps({'developing_les_impdiff': res}), flush=True)
    sim, xduct, res = drive('phase 12c: developing duct LES',
                            Config(**XDUCT_LES_CFG), dev, card, 5, per_step)
    require(sim.xwalled and sim.ywalled and 'x-wall variant' in
            sim.exec_path(), 'phase 12c: not on the x- and y-walled smag')
    print(json.dumps({'developing_duct_les': res}), flush=True)
    return (wmx, nsteps), (ximp, 5), (xduct, 5)


def phase_scalar(dev, card):
    """Phase 13: the passive scalar in the channel LES headline ('mat',
    512x256x256 f32) with a warm and a cold wall through driver.run:
    mom_rk 3 a step (its scalar variant), the step's ms, the device's busy
    and idle time and launches a step under torch.profiler, and s's
    minimum, maximum and volume mean; then 10 steps of the same flow from a
    uniform scalar with N walls, no source and no forcing: s within 1e-5
    of 1 everywhere.  Phases 13y and 13x: the dsmag duct (y walls) and the
    developing channel (x walls) with a scalar, its stacks from its own
    letters.  Returns the three runs' launches."""
    from cales_torch.config import Config
    from cales_torch.ops.stencil import bulk_mean
    from cales_torch.profile_step import device_profile
    from cales_torch.timeloop import Simulation
    les = dict(mom_rk=3, fillps=3, correc_smag=3, apply_y=6, z_eig=3)
    keep = {}
    nsteps = 11
    sim, launches, res = drive(
        'phase 13: channel LES with a passive scalar, mat',
        Config(**LES_SC_CFG), dev, card, nsteps, les, keep=keep)
    require('passive scalar' in sim.exec_path(),
            'phase 13: the path does not name the scalar')
    state = keep['state']
    s = state.s
    smin, smax = float(s.min()), float(s.max())
    smean = float(bulk_mean(s, sim.gvr_f_t))
    say(f'  s in [{smin:.6e}, {smax:.6e}], volume mean {smean:.6e}')
    require(bool(torch.isfinite(s).all()) and 0.0 < smean < 1.0,
            f'phase 13: s in [{smin:.3e}, {smax:.3e}], mean {smean:.3e}')
    dt = sim.pick_dt(sim.check(state)[0])
    step_ms, per_kernel, state = device_profile(sim, state, dt, 3)
    busy = sum(ms for ms, _ in per_kernel.values())
    nlaunch = sum(n for _, n in per_kernel.values())
    say(f'  profiled: {step_ms:.3f} ms/step (CUDA events), device busy '
        f'{busy:.3f} ms, idle {step_ms - busy:.3f} ms '
        f'({1 - busy / step_ms:.3f} of the step), {nlaunch} launches a '
        f'step (torch.profiler)  [{card}]')
    res.update(s_min=smin, s_max=smax, s_mean=smean, busy_ms=busy,
               profiled_step_ms=step_ms, idle_share=1 - busy / step_ms,
               launches_per_step=nlaunch)
    # a uniform scalar through the developed flow stays uniform
    # (tests/test_timeloop.py:131's constant, on the card)
    ucfg = Config(**{**LES_SC_CFG, 'iniscal': 'uni',
                     'cbcscal': (('P', 'P', 'N'),) * 2,
                     'bcscal': ((0.0,) * 3,) * 2, 'ssource': 0.0,
                     'is_sforced': False})
    usim = Simulation(ucfg, sim.grid, device=dev)
    ust = usim.initial_state(*(q.cpu().numpy() for q in
                               (state.u, state.v, state.w, state.p)))
    for _ in range(10):
        ust, _ = usim.step(ust, dt)
    err = float((ust.s - 1.0).abs().max())
    say(f'  uniform scalar after 10 steps: max|s - 1| {err:.3e} (bound '
        f'1e-5)  [{card}]')
    require(err <= 1e-5, f'phase 13: a uniform scalar moved by {err:.3e}')
    res['uniform_err'] = err
    print(json.dumps({'les_scalar': res}), flush=True)
    del usim, ust, state
    torch.cuda.empty_cache()
    _, duct, res = drive(
        'phase 13y: dsmag duct with a passive scalar', Config(**DUCT_SC_CFG),
        dev, card, 3, dict(mom_rk=3, fillps=3, apply_y=6, z_eig=3,
                           correc_updatep=3, dsmag=3), ntime=10)
    print(json.dumps({'duct_scalar': res}), flush=True)
    _, xdev, res = drive(
        'phase 13x: developing channel with a passive scalar',
        Config(**XDEV_CFG, **XDEV_SCALAR),
        dev, card, 3, dict(mom_rk=3, fillps=3, correc_updatep=3, apply_y=6,
                           z_eig=3), ntime=10)
    print(json.dumps({'developing_channel_scalar': res}), flush=True)
    return (launches, nsteps), (duct, 3), (xdev, 3)


# phase 6's steps, on the card and on the CPU
CARD_CPU_STEPS = 3


def _card_vs_cpu(tag, cfg, dev, names, rel=(), two=False, fields=None):
    from cales_torch.grid import make_grid_from_config
    from cales_torch.initflow import initflow
    from cales_torch.timeloop import Simulation
    grid = make_grid_from_config(cfg)
    u, v, w, p = fields if fields is not None else initflow(cfg, grid)
    say(f'{tag}: card vs CPU, {cfg.ng} float64, {CARD_CPU_STEPS} steps')
    with twopass() if two else contextlib.nullcontext():
        sims = [Simulation(cfg, grid, device=dv) for dv in (dev, 'cpu')]
        s32 = Simulation(cfg.replace(dtype='float32'), grid, device=dev)
    if two:
        require(all(s.dsmag_twopass for s in (*sims, s32)),
                f'{tag}: not on the two-pass route')
    states = [s.initial_state(u, v, w, p) for s in sims]
    dt = sims[1].pick_dt(sims[1].check(states[1])[0])
    for _ in range(CARD_CPU_STEPS):
        states = [s.step(st, dt)[0] for s, st in zip(sims, states)]
    g, c = states
    for name, tol in names:
        a = getattr(g, name)
        b = getattr(c, name)
        if name == 'vlo':    # the kept u, v and w wall planes
            a, b = (torch.cat([q.flatten() for q in x]) for x in (a, b))
        a = a.cpu()
        if name == 'p':
            a, b = a - a.mean(), b - b.mean()
        err = float((a - b).abs().max())
        if name in rel:
            err /= float(b.abs().max())
        say(f'  {name:<5s} max|card - cpu|{" / max|cpu|" if name in rel else ""}'
            f' {err:.3e} (bound {tol:.0e})')
        require(err <= tol, f'card vs CPU {name}: {err:.3e} above {tol:.0e}')
    # the working precision: float32 on the card against the float64 CPU
    # run, relative to each field's maximum (f32 rounding over the
    # substeps)
    st32 = s32.initial_state(u, v, w, p)
    for _ in range(CARD_CPU_STEPS):
        st32, _ = s32.step(st32, dt)
    for name, _ in names:
        if name == 'vlo':
            continue        # zero under the homogeneous-Neumann pressure
        a = getattr(st32, name).double().cpu()
        b = getattr(c, name)
        if name == 'p':
            a, b = a - a.mean(), b - b.mean()
        rel = float((a - b).abs().max() / b.abs().max())
        say(f'  {name:<5s} max|card f32 - cpu f64| / max|cpu| {rel:.3e} '
            '(bound 1e-4)')
        require(rel <= 1e-4, f'f32 card vs f64 CPU {name}: {rel:.3e}')


def phase_card_vs_cpu(dev):
    """CARD_CPU_STEPS steps of a small f64 channel on the card (kernels)
    and on the CPU (twins), then the same in f32 on the card: the LES and
    the DNS."""
    from cales_torch.config import Config
    small = dict(ng=(64, 32, 32), dtype='float64')
    _card_vs_cpu('phase 6', Config(**{**LES_CFG, **small}), dev,
                 (('u', 1e-11), ('v', 1e-11), ('w', 1e-11), ('p', 1e-10),
                  ('visct', 1e-12)))
    _card_vs_cpu('phase 6b', Config(**{**DNS_CFG, **small}), dev,
                 (('u', 1e-11), ('v', 1e-11), ('w', 1e-11), ('p', 1e-10)))
    # the wall-modelled channel: the wall-model kernel, the 'E' recipe
    _card_vs_cpu('phase 6w (WMLES)', Config(**{**WMLES_CFG, **small}), dev,
                 (('u', 1e-11), ('v', 1e-11), ('w', 1e-11), ('p', 1e-10),
                  ('visct', 1e-12)))
    # the wall-modelled duct: the wall model on four faces, smag's y-wall
    # variant on its 'E' stacks
    _card_vs_cpu('phase 6x (duct WMLES)',
                 Config(**{**DUCT_WMLES_CFG, **small}), dev,
                 (('u', 1e-11), ('v', 1e-11), ('w', 1e-11), ('p', 1e-10),
                  ('visct', 1e-10), ('vlo', 1e-11)), rel=('visct',))
    # nu_t relative to its maximum: the dynamic model's plane ratio sums
    # the rows in another order on the card
    for tag, cfg in (('phase 6c (dsmag channel)', DSMAG_CFG),
                     ('phase 6d (smag, impdiff_1d)', LES_IMP_CFG)):
        _card_vs_cpu(tag, Config(**{**cfg, **small}), dev,
                     (('u', 1e-11), ('v', 1e-11), ('w', 1e-11), ('p', 1e-10),
                      ('visct', 1e-10)), rel=('visct',))
    # the y-walled duct and cavity, their kept wall planes included; the
    # duct by two passes too
    for tag, cfg, two in (('phase 6e (dsmag duct)', DUCT_CFG, False),
                          ('phase 6f (dsmag cavity)', CAVITY_CFG, False),
                          ('phase 6k (dsmag duct, two passes)', DUCT_CFG,
                           True)):
        _card_vs_cpu(tag, Config(**{**cfg, **small}), dev,
                     (('u', 1e-11), ('v', 1e-11), ('w', 1e-11), ('p', 1e-10),
                      ('visct', 1e-10), ('vlo', 1e-11)), rel=('visct',),
                     two=two)
    # the transpiring channel (the two passes by the route rule)
    _card_vs_cpu('phase 6l (dsmag_blow, two passes)',
                 Config(**{**DSMAG_BLOW_CFG, **small}), dev,
                 (('u', 1e-11), ('v', 1e-11), ('w', 1e-11), ('p', 1e-10),
                  ('visct', 1e-10)), rel=('visct',))
    # the Taylor-Green vortex by 'mat' with the periodic Thomas z stage and
    # by 'fft', full-3D implicit diffusion on the box and the channel
    uvwp = (('u', 1e-11), ('v', 1e-11), ('w', 1e-11), ('p', 1e-10))
    tgv = dict(TGV_CFG, ng=(32, 16, 24), dtype='float64')
    for tag, cfg in (('phase 6g (TGV, mat, thomas_periodic)',
                      dict(tgv, zsolver='thomas')),
                     ('phase 6h (TGV, fft)', dict(tgv, ptransform='fft')),
                     ('phase 6i (triperiodic, full-3D implicit)',
                      dict(tgv, impdiff=True)),
                     ('phase 6j (channel DNS, full-3D implicit)',
                      {**DNS_CFG, **small, 'impdiff_1d': False})):
        _card_vs_cpu(tag, Config(**cfg), dev, uvwp)
    # the x-walled classes, their kept wall planes included, from
    # perturbed initial fields (the examples' rest state keeps v at 0;
    # the inflow classes start from the inflow's u = 1, not from rest, so
    # that the first projection's f32 solve is not of an O(1/dt) jump)
    for tag, cfg, ini in (('phase 6m (developing channel)', XDEV_CFG, 'uni'),
                          ('phase 6n (developing duct)', XDUCT_CFG, 'uni'),
                          ('phase 6o (lid-driven cavity)', XCAVITY_CFG,
                           'zer')):
        cfg = Config(**{**cfg, **small})
        _card_vs_cpu(tag, cfg, dev, uvwp + (('vlo', 1e-11),),
                     fields=_perturbed_fields(cfg.replace(inivel=ini),
                                              SEED + 7))
    # the x-walled LES and the plane-valued values, from perturbed fields:
    # the developing channel with smag, with smag + impdiff_1d, the
    # developing duct with smag, the developing WMLES with its inflow
    # profile, and a periodic smag channel whose upper z face moves with
    # an x-varying plane (tests/test_pallas_kernels.py:584's lid)
    nx, ny, _ = small['ng']
    lid = 1.0 + 0.3 * np.sin(2 * np.pi * np.arange(nx + 2) / nx)
    lid_cfg = dict(LES_CFG, l=(2 * np.pi, np.pi, 1.0), gr=0.0, visci=2000.0,
                   inivel='uni', is_wallturb=False,
                   is_forced=(False, False, False), velf=(0.0, 0.0, 0.0),
                   ptransform='mat', bcvel=(((0.0,) * 3,) * 3, (
                       (0.0,) * 3, (0.0,) * 3,
                       (np.repeat(lid[None], ny + 2, axis=0), 0.0, 0.0))),
                   **CHAN_BCS)
    tight = (('u', 1e-11), ('v', 1e-11), ('w', 1e-11), ('p', 1e-11),
             ('visct', 1e-11), ('vlo', 1e-11))
    for tag, cfg in (
            ('phase 6p (developing channel LES)',
             Config(**{**XDEV_CFG, 'sgstype': 'smag', 'visci': 20_000.0,
                       **small})),
            ('phase 6q (developing channel LES, impdiff_1d)',
             Config(**{**XLES_IMP_CFG, **small})),
            ('phase 6r (developing duct LES)',
             Config(**{**XDUCT_LES_CFG, **small})),
            ('phase 6s (developing WMLES, inflow profile)',
             xwmles_cfg(**small)),
            ('phase 6t (lid plane, smag channel)',
             Config(**{**lid_cfg, **small}))):
        _card_vs_cpu(tag, cfg, dev, tight, rel=('visct',),
                     fields=_perturbed_fields(cfg.replace(inivel='uni'),
                                              SEED + 8))
    # the triperiodic LES (the smag kernel without walls, dsmag's
    # periodic-z mode with 'dit'), the box forced along x and z with
    # impdiff_1d, and the dsmag channel with the 2D test filter, from
    # perturbed fields
    les_cases = (
        ('phase 6y (box LES, smag)', dict(tgv, sgstype='smag')),
        ("phase 6z (box LES, dsmag 'dit')",
         dict(tgv, sgstype='dsmag', dsmag_avg='dit')),
        ('phase 6za (box forced along x and z, smag, impdiff_1d)',
         dict(tgv, sgstype='smag', impdiff=True, impdiff_1d=True,
              is_forced=(True, False, True), velf=(0.05, 0.0, 0.1))),
        ('phase 6zb (dsmag channel, filter_2d)',
         {**DSMAG_CFG, **small, 'filter_2d': True}))
    for tag, kw in les_cases:
        cfg = Config(**kw)
        _card_vs_cpu(tag, cfg, dev,
                     (('u', 1e-11), ('v', 1e-11), ('w', 1e-11), ('p', 1e-10),
                      ('visct', 1e-11)), rel=('visct',),
                     fields=_perturbed_fields(cfg, SEED + 10))
    # the passive scalar: phase 13's channel LES, and the developing duct
    # of tests/test_pallas_kernels.py:655 (x and y walls: the scalar's x
    # stack carries its (y ghost, x ghost) corners) from perturbed fields
    # (6s is the developing WMLES's)
    sc = (('u', 1e-11), ('v', 1e-11), ('w', 1e-11), ('s', 1e-11),
          ('p', 1e-10))
    _card_vs_cpu('phase 6u (scalar channel LES)',
                 Config(**{**LES_SC_CFG, **small}), dev,
                 sc + (('visct', 1e-10),), rel=('visct',))
    xyd = Config(**{**XDUCT_CFG, **small, 'l': (2.0, 1.0, 1.0),
                    'visci': 2000.0, 'scalar': True, 'pr': 0.71,
                    'iniscal': 'uni', 'ssource': 0.02,
                    'cbcscal': (('D', 'D', 'N'), ('N', 'N', 'N')),
                    'bcscal': ((1.0, 0.5, 0.0), (0.0, 0.0, 0.0))})
    _card_vs_cpu('phase 6v (scalar developing duct)', xyd, dev,
                 sc + (('vlo', 1e-11),),
                 fields=_perturbed_fields(xyd.replace(inivel='uni'),
                                          SEED + 9))


def _perturbed_fields(cfg, seed):
    """initflow plus a seeded perturbation that breaks the flow's y
    symmetry (a symmetric start hides faults at the slab edges)."""
    from cales_torch.grid import make_grid_from_config
    from cales_torch.initflow import initflow
    rng = np.random.default_rng(seed)
    return [np.asarray(f) + (1e-2 * rng.standard_normal(np.shape(f))
                             ).astype(np.asarray(f).dtype)
            for f in initflow(cfg, make_grid_from_config(cfg))]


def _timed(fn, mesh, n):
    """Host-clock ms of fn on every rank of the mesh, synchronised."""
    fn()
    torch.cuda.synchronize()
    mesh.barrier()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    mesh.barrier()
    return (time.perf_counter() - t0) * 1e3 / n


def _flat(x):
    """The tensors of a nest of tuples and lists, Nones and other values
    left out."""
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, (list, tuple)):
        return [q for y in x for q in _flat(y)]
    return []


def _halo_kernel_rows(sim, state, mesh, dt, card):
    """Rank 0's check of the slab (halo) variants on the main path's own
    state and halos, at the slab's shape: each kernel against its twin
    and both timed (CUDA events), while the other ranks wait.  The f32
    bound, 1e-4 of each output's maximum (phase 2b's random inputs hold
    1e-5): on the developed field the momentum RHS is a difference of
    fluxes far larger than itself, and FMA contraction alone moves it by
    some 1e-5 of its maximum (python -m cales_torch.fma_probe: the halo
    and periodic mom_rk err alike against the twin, and under -fmad=false
    they equal each other and the twin's RHS bit for bit); a wrong halo
    row moves it by O(1).  The witness on the mesh, printed and reported:
    each output's error on the rows that read the halos (0 and nyl - 1)
    and on the others, over the same maximum, and the y row of the
    largest."""
    from cales_torch.ops import kernels as K
    cfg = sim.cfg
    u, v, w, p, s = state.u, state.v, state.w, state.p, state.visct
    ue, ve, we = state.zq
    pe, se = sim._zedge_p(p), sim._zedge_s(s)
    h = mesh.halo_y([(u, ue), (v, ve), (w, we), (s, se), (p, pe)])
    rows = {}
    if mesh.rank == 0:
        dxi, dyi = cfg.dli[0], cfg.dli[1]
        tauw = s[0].contiguous()
        args = {
            'mom_rk': ((u, v, w, s, p, ue, ve, we, se, pe, *state.rhs_old,
                        sim.dzci_t, sim.dzfi_t, 0.5 * dt, -0.2 * dt,
                        cfg.visc, dxi, dyi, cfg.bforce),
                       dict(sums=(True, False), yh=h)),
            # the components swapped (v's place taken by w, and so its
            # halo): the divergence of the projected field is rounding
            # noise, which would make the error bound meaningless
            'fillps': ((u, w, v, ue, we, ve, sim.dzfi_t, 1.0 / dt, dxi,
                        dyi), dict(yh=h[2])),
            'correc_updatep': ((u, v, w, p, p, we, pe, dt, dxi, dyi,
                                sim.dzci_t, sim.dzfi_t), dict(yh=h[4])),
            'smag': ((u, v, w, ue, ve, we, sim.dzci_t, sim.dzfi_t, dxi, dyi,
                      cfg.visc, sim.csd2_t, sim.dw_t, sim.nearlo_t, tauw,
                      tauw), dict(yh=h[:3])),
        }
        cells = u.numel()

        def outputs(res, name):
            res = [q for q in (res if isinstance(res, tuple) else (res,))
                   if q is not None]
            if name == 'mom_rk':       # the partial sums: per-plane totals
                res[-1] = res[-1].sum(dim=1)
            return res

        def errors(got, ref):
            """Per output: (max abs error, it over max|ref|, its y row,
            the same over max|ref| on the edge rows 0 and nyl - 1, and on
            the others); the rows are None for an output without y."""
            out = []
            for g, r in zip(got, ref):
                d = (g - r).abs()
                err, scale = float(d.max()), float(r.abs().max())
                if g.ndim != 3:
                    out.append((err, err / scale, None, None, None))
                    continue
                yrow = (int(d.argmax()) // g.shape[-1]) % g.shape[1]
                edge = float(d[:, [0, -1]].max()) / scale
                inner = float(d[:, 1:-1].max()) / scale
                out.append((err, err / scale, yrow, edge, inner))
            return out

        for row, name in HALO_ROWS.items():
            a, kw = args[name]
            fn, twin = getattr(K, name), getattr(K, f'{name}_plain')
            errs = errors(outputs(fn(*a, **kw), name),
                          outputs(twin(*a, **kw), name))
            for err, rel, *_ in errs:
                require(np.isfinite(err) and rel <= 1e-4,
                        f'{row}: error {rel:.3e} of the output maximum, '
                        'above 1e-4')
            worst = max(e[0] for e in errs)
            # the worst output (relative to its maximum) and its y row
            _, worst_rel, worst_y, _, _ = max(errs, key=lambda e: e[1])
            edge = max(e[3] for e in errs if e[3] is not None)
            inner = max(e[4] for e in errs if e[4] is not None)
            ms = time_ms(lambda: fn(*a, **kw))
            plain_ms = time_ms(lambda: twin(*a, **kw))
            # the kernel's periodic variant on the same slab: what the
            # halo reads cost
            periodic_ms = time_ms(lambda: fn(*a, **{
                k: q for k, q in kw.items() if k != 'yh'}))
            nin, nout, per_cell = WORK[name]
            # the halo pairs this kernel reads, and no other
            halo_bytes = sum(q.numel() * q.element_size()
                             for q in _flat(kw['yh']))
            nbytes = (nin + nout) * cells * u.element_size() + halo_bytes
            t_b = nbytes / PEAK_BPS * 1e3
            t_o = per_cell * cells / PEAK_FLOPS[u.dtype] * 1e3
            rows[row] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                             bound_ms=max(t_b, t_o),
                             bound_by='bytes' if t_b >= t_o else 'operations',
                             library_ms=None, periodic_variant_ms=periodic_ms,
                             max_rel_err=worst_rel, max_err_y_row=worst_y,
                             max_rel_err_edge_rows=edge,
                             max_rel_err_other_rows=inner)
            say(f'  {row:<24s} at {tuple(u.shape)}: max|err| {worst:.3e} '
                f'(per output / its max|ref|: '
                + ' '.join(f'{e[1]:.1e}' for e in errs) + f'; the worst at '
                f'y row {worst_y} of 0..{u.shape[1] - 1}; on the halo-reading '
                f'rows 0 and {u.shape[1] - 1} {edge:.1e}, on the others '
                f'{inner:.1e}), kernel {ms:.3f} ms (its periodic variant on '
                f'the slab {periodic_ms:.3f}), plain twin {plain_ms:.3f} ms, '
                f'bound {rows[row]["bound_ms"]:.3f} ms ({halo_bytes} halo '
                f'bytes)  [{card}]')
    mesh.barrier()
    return rows


def mesh_rank(out_dir):
    """mesh_rank_body, with a failure's traceback written to
    DIR/rank<r>.err for the parent to show."""
    try:
        return mesh_rank_body(out_dir)
    except BaseException:
        import traceback
        rank = os.environ.get('RANK', '?')
        (Path(out_dir) / f'rank{rank}.err').write_text(traceback.format_exc())
        raise


def mesh_rank_body(out_dir):
    """One rank of the two-rank runner of the y-slab mesh (started under
    torch.distributed.run, two ranks on the one card over gloo, staged
    through pinned host buffers): phase 10 (sharded_rank_work), then the
    classes of phases 10i .. 10ywf (sharded_les_work), on one process
    group, so that the ranks reach the card once."""
    from cales_torch.config import Config
    from cales_torch.parallel import mesh as meshmod
    out_dir = Path(out_dir)
    cfg = Config(**MESH_CFG)
    mesh, dev = meshmod.from_env(cfg.dims, cfg.ng, 'cuda', 'gloo')
    t0 = time.perf_counter()
    sharded_rank_work(mesh, dev, out_dir)
    t1 = time.perf_counter()
    sharded_les_work(mesh, dev, out_dir)
    if mesh.rank == 0:
        say(f'  phase 10 took {t1 - t0:.1f} s of the runner, phases '
            f'10i-10ywf {time.perf_counter() - t1:.1f} s')
    mesh.barrier()
    torch.distributed.destroy_process_group()
    return 0


def sharded_rank_work(mesh, dev, out_dir):
    """Phase 10's work on a rank of the y-slab mesh (mesh_rank_body): the
    headline on the y-slab mesh through driver.run with every launch count
    set to 0 just before and read just after, the correctness gates, the
    step and the collectives timed; the slab variants against their twins;
    then the small f64 case, whose gathered fields rank 0 writes for the
    parent to hold against the single-device run (p10_rank<r>.json,
    small.npz)."""
    from cales_torch import driver
    from cales_torch.config import Config
    from cales_torch.grid import make_grid_from_config
    from cales_torch.parallel import mesh as meshmod
    from cales_torch.timeloop import Simulation
    cfg = Config(**MESH_CFG)
    card = card_line()
    rank = mesh.rank
    res = {'rank': rank, 'card': card}
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    # one datadir for the ranks: the checkpoint is one file, slab by slab
    sim, state = driver.run(cfg, datadir=out_dir / 'data', device=dev,
                            mesh=mesh, max_steps=MESH_STEPS, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res['launches'] = counts()
    if rank == 0:
        say(f'  path: {sim.exec_path()}')
        say(f'  driver.run, {MESH_STEPS} steps: {wall:.1f} s host wall '
            f'(setup, checks and I/O included); rank 0 launches '
            f'{res["launches"]}')
    dt = sim.pick_dt(sim.check(state)[0])
    ntime = 3
    torch.cuda.synchronize()
    mesh.barrier()
    t0 = time.perf_counter()
    for _ in range(ntime):
        state, _ = sim.step(state, dt)
    torch.cuda.synchronize()
    mesh.barrier()
    ms = (time.perf_counter() - t0) * 1e3 / ntime
    dt_cfl, divtot, divmax = sim.check(state)
    ub = sim.bulk_mean(state.u, sim.gvr_f)
    fields = (state.u, state.v, state.w, state.p, state.visct)
    finite = mesh.reduce_scalar(
        float(all(bool(torch.isfinite(f).all()) for f in fields)), 'min')
    numin = mesh.reduce_scalar(float(state.visct.min()), 'min')
    numax = mesh.reduce_scalar(float(state.visct.max()), 'max')
    wwall = mesh.reduce_scalar(max(
        float(state.vlo[2][1:-1, 1:-1].abs().max()),
        float(state.w[-1].abs().max())), 'max')
    res.update(ms_per_step=ms, divmax=divmax, bulk_u=ub, finite=finite,
               nu_t_min=numin, nu_t_max=numax, w_walls=wwall,
               steps=MESH_STEPS + ntime,
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
    # the collectives alone at the main path's shapes
    nz, nyl, nx = state.u.shape
    ue, ve, we = state.zq
    pairs = [(state.u, ue), (state.v, ve), (state.w, we),
             (state.visct, sim._zedge_s(state.visct)),
             (state.p, sim._zedge_p(state.p))]
    blocks = torch.randn((mesh.gy, nz, nyl, mesh.nxl), device=dev)
    vec = torch.ones(nz, device=dev)
    res['comm_ms'] = {
        'halo_y (5 fields, mom_rk)': _timed(lambda: mesh.halo_y(pairs),
                                            mesh, 5),
        f'all_to_all {tuple(blocks.shape)} f32': _timed(
            lambda: mesh.comm.all_to_all(blocks), mesh, 3),
        f'all_reduce ({nz},) f32': _timed(lambda: mesh.all_reduce(vec),
                                          mesh, 20)}
    del blocks
    res['halo_rows'] = _halo_kernel_rows(sim, state, mesh, dt, card)
    del sim, state, fields, pairs
    torch.cuda.empty_cache()
    # the small f64 case on the slabs, MESH_SMALL_STEPS steps from the
    # perturbed start
    cfg64 = Config(**MESH_SMALL)
    m64 = meshmod.SlabMesh(mesh.comm, cfg64.dims, cfg64.ng)
    sim = Simulation(cfg64, make_grid_from_config(cfg64), device=dev,
                     mesh=m64)
    st = sim.initial_state(*_perturbed_fields(cfg64, SEED + 5))
    dt = sim.pick_dt(sim.check(st)[0])
    for _ in range(MESH_SMALL_STEPS):
        st, _ = sim.step(st, dt)
    small = {q: m64.gather(getattr(st, q))
             for q in ('u', 'v', 'w', 'p', 'visct')}
    if rank == 0:
        np.savez(out_dir / 'small.npz', dt=dt, **small)
    (out_dir / f'p10_rank{rank}.json').write_text(json.dumps(res))
    del sim, st
    torch.cuda.empty_cache()
    mesh.barrier()


def run_mesh_ranks(card):
    """The two-rank runner of the y-slab mesh (mesh_rank_body), one launch
    of torch.distributed.run for phase 10 and phases 10i .. 10ywf; returns
    phase 10's (ranks' results, small f64 fields) and the classes' (ranks'
    results, small f64 fields by key)."""
    torch.cuda.empty_cache()
    env = dict(os.environ)
    # gloo's pairs on the loopback interface: the ranks share one host
    env.setdefault('GLOO_SOCKET_IFNAME', 'lo')
    keys = [k for k, *_ in (*MESH_CLASSES, *MESH_SMALL_ONLY)]
    say(f'phases 10, {", ".join(keys)}: the LES headline and the channel, '
        f'duct, cavity and box classes on a y-slab mesh, dims (2, 1), '
        f'{HEADLINE_NG} float32, two ranks on one card (gloo, staged '
        f'through the host), one launch  [{card}]')
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, '-m', 'torch.distributed.run', '--standalone',
               '--nproc_per_node', '2', str(ROOT / 'chip_smoke.py'),
               '--mesh-rank', tmp]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                             timeout=1000, env=env)
        say(f'  torch.distributed.run exit {res.returncode} after '
            f'{time.perf_counter() - t0:.1f} s (limit 1000 s)')
        for line in res.stdout.splitlines():
            say(f'  | {line}')
        errs = ''.join(f'rank {r}:\n{q.read_text()}' for r in range(2)
                       for q in [Path(tmp) / f'rank{r}.err'] if q.exists())
        require(res.returncode == 0,
                f'a rank of the y-slab mesh runner failed:\n'
                f'{errs or res.stderr[-4000:]}')
        p10 = ([json.loads((Path(tmp) / f'p10_rank{r}.json').read_text())
                for r in range(2)], dict(np.load(Path(tmp) / 'small.npz')))
        les = ([json.loads((Path(tmp) / f'les_rank{r}.json').read_text())
                for r in range(2)],
               {key: dict(np.load(Path(tmp) / f'small_{key}.npz'))
                for key in keys})
    return p10, les


def phase_sharded(dev, card, p10):
    """Phase 10: the channel LES on a y-slab mesh, dims = (2, 1), two ranks
    sharing the one card through torch.distributed over gloo with the CUDA
    tensors staged through pinned host buffers (NCCL refuses two ranks on
    one card; its transport for one card a rank is not exercised here).
    The headline at 512x256x256 f32 with phase 4's gates, its launches and
    ms/step (a correctness run: the staging through the host and the two
    ranks' time-sharing of the card make it no scaling figure); the slab
    kernels against their twins; the small f64 case against the
    single-device 'mat' + Thomas run on the card within 1e-11; then the
    LES example through the CLI under torch.distributed.run.  p10: the
    two-rank runner's results (run_mesh_ranks).  Returns (rank 0's
    launches, the halo variants' report rows)."""
    from cales_torch.config import Config
    from cales_torch.grid import make_grid_from_config
    from cales_torch.timeloop import Simulation
    ranks, small = p10
    say(f'phase 10: the LES on a y-slab mesh, dims (2, 1), {MESH_CFG["ng"]} '
        f'float32, two ranks on one card (gloo, staged through the host)  '
        f'[{card}]')
    r0 = ranks[0]
    per_step = dict(mom_rk=3, fillps=3, correc_updatep=3, smag=3, apply_x=6,
                    apply_y=6, thomas_z=3)
    for rk in ranks:
        for name, n in rk['launches'].items():
            want = per_step.get(name, 0) * MESH_STEPS
            require(n == want, f'phase 10 rank {rk["rank"]}: {name} launched '
                               f'{n} times, want {want}')
    small_eps = float(np.sqrt(np.finfo(np.float32).eps) * 10)
    say(f'  {r0["ms_per_step"]:.3f} ms/step over 5 steps (host clock; two '
        f'ranks time-share the card and stage every collective through the '
        f'host: a correctness run, not a scaling figure)  [{card}]')
    say(f'  peak memory a rank: ' + ', '.join(
        f'rank {rk["rank"]} {rk["peak_gib"]:.2f} GiB' for rk in ranks)
        + f' (max_memory_allocated)  [{card}]')
    say(f'  after {r0["steps"]} steps: divmax {r0["divmax"]:.3e} (abort '
        f'bound {small_eps:.3e}), bulk u {r0["bulk_u"]:.7f}, nu_t in '
        f'[{r0["nu_t_min"]:.4e}, {r0["nu_t_max"]:.4e}], max |w| on the z '
        f'walls {r0["w_walls"]:.3e}')
    for what, t in r0['comm_ms'].items():
        say(f'  {what}: {t:.3f} ms (host clock, staged gloo)  [{card}]')
    require(r0['finite'] == 1.0, 'phase 10: non-finite field')
    require(r0['divmax'] <= small_eps, f'phase 10: divmax {r0["divmax"]:.3e}')
    require(abs(r0['bulk_u'] - 1.0) <= 1e-4,
            f'phase 10: bulk u {r0["bulk_u"]:.7f}, want 1')
    require(r0['nu_t_min'] >= 0.0 and r0['nu_t_max'] > 0.0,
            f'phase 10: nu_t in [{r0["nu_t_min"]}, {r0["nu_t_max"]}]')
    require(r0['w_walls'] <= 1e-6, f'phase 10: w on the walls '
                                   f'{r0["w_walls"]:.3e}')
    print(json.dumps({'les_mesh_2x1': {
        k: r0[k] for k in ('ms_per_step', 'divmax', 'bulk_u', 'comm_ms')}
        | {'peak_gib_per_rank': [rk['peak_gib'] for rk in ranks],
           'card': card}}), flush=True)
    # the small f64 case against the single-device 'mat' + Thomas run
    cfg1 = Config(**{**MESH_SMALL, 'dims': (1, 1), 'zsolver': 'thomas'})
    sim = Simulation(cfg1, make_grid_from_config(cfg1), device=dev)
    st = sim.initial_state(*_perturbed_fields(cfg1, SEED + 5))
    for _ in range(MESH_SMALL_STEPS):
        st, _ = sim.step(st, float(small['dt']))
    say(f'  gy = 2 against one device, {cfg1.ng} float64, '
        f'{MESH_SMALL_STEPS} steps, on the card:')
    for name in ('u', 'v', 'w', 'p', 'visct'):
        a, b = small[name], getattr(st, name).cpu().numpy()
        if name == 'p':
            a, b = a - a.mean(), b - b.mean()
        err = float(np.abs(a - b).max())
        say(f'    {name:<5s} max|err| {err:.3e} (bound 1e-11)')
        require(err <= 1e-11, f'phase 10 f64 {name}: {err:.3e}')
    phase_cli_mesh(card)
    return r0['launches'], r0['halo_rows']


def phase_cli_mesh(card, dims=(2, 1), transport='gloo',
                   example='turbulent_channel_les'):
    """The LES example (or the duct example, y walls and dsmag
    'channel': phase 10pcy on the pencils) through the CLI under
    torch.distributed.run with dims(1:2) = gy, gx on a temporary copy of
    its namelist (phase 10c on the y slabs, 10pc on the pencils), over
    `transport`."""
    gy, gx = dims
    duct = example == 'turbulent_duct_les'
    nml = (ROOT / 'examples' / example / 'input.nml').read_text()
    require('dims(1:2) = 0, 0' in nml, f'the {example} example lost its '
                                       'dims line')
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / 'input.nml'
        path.write_text(nml.replace('dims(1:2) = 0, 0',
                                    f'dims(1:2) = {gy}, {gx}'))
        cmd = [sys.executable, '-m', 'torch.distributed.run', '--standalone',
               '--nproc_per_node', str(gy * gx), '-m', 'cales_torch',
               str(path), '--transport', transport, '--max-steps', '3',
               '--datadir', str(Path(tmp) / 'data')]
        tag = ('phase 10c' if gx == 1 else 'phase 10pcy' if duct
               else 'phase 10pc')
        say(f'{tag}: {" ".join(cmd[1:])}  [{card}]')
        env = dict(os.environ)
        env.setdefault('GLOO_SOCKET_IFNAME', 'lo')
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                             timeout=600, env=env)
        say(f'  exit {res.returncode} after {time.perf_counter() - t0:.1f} s')
        lines = res.stdout.splitlines()
        for line in lines[:3] + lines[-3:]:
            say(f'  | {line}')
        require(res.returncode == 0, f'CLI on the mesh failed:\n'
                                     f'{res.stderr[-3000:]}')
        path_line = [ln for ln in lines if 'Execution path' in ln]
        want = ('apply_x', 'dsmag' if duct else 'smag',
                f'dims = ({gy}, {gx})',
                'staged' if transport == 'gloo' else 'nccl') + (
            () if gx == 1 else ('x halos', 're-slabbed')) + (
            ('Y_WALLS x X_HALO',) if duct else ())
        require(len(path_line) == 1 and all(k in path_line[0] for k in want),
                'the Execution path line (rank 0 alone) does not name the '
                'mesh path')
        require((Path(tmp) / 'data' / 'fld.bin').exists(), 'no fld.bin')


# the channel classes on the y-slab mesh (phases 10i, 10w, 10d): each at
# the headline grid on dims (2, 1) in float32 through driver.run, with its
# launches a step (and outside the steps: the initial fill's and the
# checks' wall model, the initial nu_t's dsmag), the slab kernel variant
# it brings held against its twin on its own state, and a small float64
# twin on the mesh held against the single-device run.  (key, title,
# config, report row, per step, outside); one step of driver.run each,
# so that the script, with the pencil mesh's four-rank phases, stays near
# half its time limit
MESH_LES_STEPS = 1
# the mesh classes' timed steps after their driver.run (host clock)
MESH_TIMED = 1
MESH_CLASSES = (
    ('10i', 'channel DNS, impdiff_1d (channel_dns_impdiff)',
     dict(DNS_CFG, dims=(2, 1)), 'mom_rk (y halo, split 1d)',
     dict(mom_rk=3, fillps=3, correc_updatep=3, apply_x=6, apply_y=6,
          thomas_z=12), {}),
    ('10w', 'wall-modelled channel LES (wmles_channel)',
     dict(WMLES_CFG, dims=(2, 1)), 'wallmodel (y halo)',
     dict(mom_rk=3, fillps=3, correc_updatep=3, smag=3, apply_x=6,
          apply_y=6, thomas_z=3, wallmodel=3), 'wm'),
    ('10d', "dsmag channel, 'channel', impdiff_1d",
     dict(DSMAG_CFG, dims=(2, 1)), 'dsmag (y halo)',
     dict(mom_rk=3, fillps=3, correc_updatep=3, dsmag=3, apply_x=6,
          apply_y=6, thomas_z=12), {'dsmag': 1}),
    # the y-walled classes (their slab variants' rows are phase 2b's,
    # WALLED_SLAB_ROWS; the initial nu_t is a kernel's launch on a slab)
    ('10y', "dsmag duct, 'duct' (duct_les_dsmag)",
     dict(DUCT_CFG, dims=(2, 1)), None,
     dict(mom_rk=3, fillps=3, correc_updatep=3, dsmag=3, apply_x=6,
          apply_y=6, thomas_z=3), {'dsmag': 1}),
    ('10yc', "dsmag cavity, 'cavity' (cavity_les_dsmag)",
     dict(CAVITY_CFG, dims=(2, 1)), None,
     dict(mom_rk=3, fillps=3, correc_updatep=3, dsmag=3, apply_x=6,
          apply_y=6, thomas_z=3), {'dsmag': 1}),
    ('10ys', 'static-Smagorinsky duct (duct_les_dsmag with smag)',
     dict(DUCT_CFG, sgstype='smag', dims=(2, 1)), None,
     dict(mom_rk=3, fillps=3, correc_updatep=3, smag=3, apply_x=6,
          apply_y=6, thomas_z=3), {'smag': 1}),
    # the wall-modelled duct: the wall model on the four walls, the y
    # faces' on their owners (its slab rows are phase 2b's)
    ('10yw', 'wall-modelled duct (turbulent_duct_wmles at the headline '
     'grid)', dict(DUCT_WMLES_CFG, dims=(2, 1)), None,
     dict(mom_rk=3, fillps=3, correc_updatep=3, smag=3, apply_x=6,
          apply_y=6, thomas_z=3, wallmodel=3), {'smag': 1, 'wm': 1}),
    # the triperiodic box: the pinned periodic Thomas on the pencil, dsmag
    # in its ZP + YH mode (phase 2b's rows); smag's no-wall halo variant
    ('10t', 'triperiodic DNS (triperiodic_dns)', dict(TRI_CFG, dims=(2, 1)),
     None, dict(mom_rk=3, fillps=3, correc_updatep=3, apply_x=6, apply_y=6,
                thomas_periodic=3), {}),
    ('10tl', 'box LES, static Smagorinsky (triperiodic_dns with smag)',
     dict(TRI_CFG, sgstype='smag', dims=(2, 1)), None,
     dict(mom_rk=3, fillps=3, correc_updatep=3, smag=3, apply_x=6,
          apply_y=6, thomas_periodic=3), {}),
    ('10td', "box LES, dynamic Smagorinsky 'dit' (triperiodic_dns with "
     'dsmag)', dict(TRI_CFG, sgstype='dsmag', dsmag_avg='dit', dims=(2, 1)),
     None, dict(mom_rk=3, fillps=3, correc_updatep=3, dsmag=3, apply_x=6,
                apply_y=6, thomas_periodic=3), {'dsmag': 1}),
    # the passive scalar (mom_rk's scalar variant on the slab: Y_HALO, and
    # with y walls Y_WALLS on the slab's stacks), the two passes (YH, YW +
    # YH) and the 2D filter (F2D + YH, with ZP too): their rows are phase
    # 2b's (slab_twopass_rows)
    ('10s', "channel LES with a passive scalar (phase 13's LES_SC_CFG)",
     dict(LES_SC_CFG, dims=(2, 1)), None,
     dict(mom_rk=3, fillps=3, correc_updatep=3, smag=3, apply_x=6,
          apply_y=6, thomas_z=3), {}),
    ('10ysc', "dsmag duct with a passive scalar (phase 13y's)",
     dict(DUCT_SC_CFG, dims=(2, 1)), None,
     dict(mom_rk=3, fillps=3, correc_updatep=3, dsmag=3, apply_x=6,
          apply_y=6, thomas_z=3), {'dsmag': 1}),
    ('10b', 'transpiring dsmag channel (dsmag_blow), two passes',
     dict(DSMAG_BLOW_CFG, dims=(2, 1)), None,
     dict(mom_rk=3, fillps=3, correc_updatep=3, dsmag_level1=3,
          dsmag_level2=3, apply_x=6, apply_y=6, thomas_z=12),
     {'dsmag_level1': 1, 'dsmag_level2': 1}),
    ('10yb', "dsmag duct by two passes ('duct', CALES_DSMAG_TWOPASS=1)",
     dict(DUCT_CFG, dims=(2, 1)), None,
     dict(mom_rk=3, fillps=3, correc_updatep=3, dsmag_level1=3,
          dsmag_level2=3, apply_x=6, apply_y=6, thomas_z=3),
     {'dsmag_level1': 1, 'dsmag_level2': 1}),
    ('10f', "dsmag channel with the 2D test filter ('channel', impdiff_1d)",
     dict(DSMAG_CFG, filter_2d=True, dims=(2, 1)), None,
     dict(mom_rk=3, fillps=3, correc_updatep=3, dsmag=3, apply_x=6,
          apply_y=6, thomas_z=12), {'dsmag': 1}),
    ('10tf', "box LES, dsmag 'dit' with the 2D test filter",
     dict(TRI_CFG, sgstype='dsmag', dsmag_avg='dit', filter_2d=True,
          dims=(2, 1)), None,
     dict(mom_rk=3, fillps=3, correc_updatep=3, dsmag=3, apply_x=6,
          apply_y=6, thomas_periodic=3), {'dsmag': 1}),
    # full-3D implicit diffusion (three sharded Helmholtz solves a substep
    # beside the Poisson solve: apply_x and apply_y 8 and the Thomas kernel
    # 4 a substep) and x walls with periodic y (the x stacks' rows in the
    # exchanges): their rows are phase 2b's (slab_imp3d_x_rows)
    ('10i3', 'channel DNS, full-3D implicit diffusion (phase 5f)',
     dict(DNS_CFG, impdiff_1d=False, dims=(2, 1)), None,
     dict(mom_rk=3, fillps=3, correc_updatep=3, apply_x=24, apply_y=24,
          thomas_z=12), {}),
    ('10t3', 'triperiodic DNS, full-3D implicit diffusion (phase 9i)',
     dict(TRI_CFG, impdiff=True, dims=(2, 1)), None,
     dict(mom_rk=3, fillps=3, correc_updatep=3, apply_x=24, apply_y=24,
          thomas_periodic=12), {}),
    ('10x', 'developing channel (phase 11, examples/developing_channel)',
     dict(XDEV_CFG, dims=(2, 1)), None,
     dict(mom_rk=3, fillps=3, correc_updatep=3, apply_x=6, apply_y=6,
          thomas_z=3), {}),
    ('10xb', 'developing channel LES, impdiff_1d (phase 12b)',
     dict(XLES_IMP_CFG, dims=(2, 1)), None,
     dict(mom_rk=3, fillps=3, correc_updatep=3, smag=3, apply_x=6,
          apply_y=6, thomas_z=12), {'smag': 1}),
    # x walls with y walls, the wall model and the scalar (their rows are
    # phase 2b's, slab_xy_rows): the developing duct LES, the
    # lid-driven cavity, the developing WMLES with its 1/7-power inflow
    # ('_inflow': _class_cfg), the developing channel with phase 13x's
    # scalar
    ('10xy', 'developing duct LES (phase 12c)',
     dict(XDUCT_LES_CFG, dims=(2, 1)), None,
     dict(mom_rk=3, fillps=3, correc_updatep=3, smag=3, apply_x=6,
          apply_y=6, thomas_z=3), {'smag': 1}),
    ('10xc', 'lid-driven cavity (phase 11b)', dict(XCAVITY_CFG, dims=(2, 1)),
     None, dict(mom_rk=3, fillps=3, correc_updatep=3, apply_x=6, apply_y=6,
                thomas_z=3), {}),
    ('10xw', 'developing WMLES with its 1/7-power inflow (phase 12)',
     dict(XWMLES_CFG, dims=(2, 1), _inflow=True), None,
     dict(mom_rk=3, fillps=3, correc_updatep=3, smag=3, apply_x=6,
          apply_y=6, thomas_z=3, wallmodel=3), {'smag': 1, 'wm': 1}),
    ('10xs', "developing channel with a passive scalar (phase 13x's)",
     dict(XDEV_CFG, dims=(2, 1), **XDEV_SCALAR), None,
     dict(mom_rk=3, fillps=3, correc_updatep=3, apply_x=6, apply_y=6,
          thomas_z=3), {}),
    # ptransform 'fft' on the mesh (poisson._solve_fft_sharded: the rfft
    # along x, the half spectrum's lanes through the all-to-all, the y
    # stage and the z eigen matmuls on a rank's lanes): the LES headline
    # (bench.py:273-279, phase 4's route; no apply_x, no apply_y) and the
    # dsmag duct by the mixed route (apply_y with the y DCT on the lanes,
    # phase 2b's real-view row)
    ('10ff', "LES headline by 'fft' (bench.py channel_les_smag, phase 4)",
     dict(LES_CFG, dims=(2, 1), **CHAN_BCS), None,
     dict(mom_rk=3, fillps=3, correc_updatep=3, smag=3), {}),
    ('10yf', "dsmag duct by 'fft', the mixed route (phase 8f)",
     dict(DUCT_CFG, ptransform='fft', dims=(2, 1)), None,
     dict(mom_rk=3, fillps=3, correc_updatep=3, dsmag=3, apply_y=6),
     {'dsmag': 1}))
# the classes that run under CALES_DSMAG_TWOPASS=1 (twopass), their small
# twin and its one-device reference too: the duct by two passes
MESH_TWOPASS = ('10yb',)
# report row -> kernel
MESH_LES_ROWS = {'mom_rk (y halo, split 1d)': 'mom_rk',
                 'wallmodel (y halo)': 'wallmodel', 'dsmag (y halo)': 'dsmag'}
# the classes run only as their small float64 twin on the mesh, with
# their launches a step there: the duct with sgstype 'none', the box with
# impdiff_1d (the slabs' periodic z-only solves) and the scalar channel
# LES with full-3D implicit diffusion (mom_rk's scalar 'xy+z' variant on
# the slab)
MESH_SMALL_ONLY = (
    ('10yn', "'none' duct", dict(DUCT_CFG, sgstype='none', dims=(2, 1)),
     dict(mom_rk=3, fillps=3, correc_updatep=3, apply_x=6, apply_y=6,
          thomas_z=3)),
    ('10t1', 'triperiodic DNS, impdiff_1d',
     dict(TRI_CFG, impdiff=True, impdiff_1d=True, dims=(2, 1)),
     dict(mom_rk=3, fillps=3, correc_updatep=3, apply_x=6, apply_y=6,
          thomas_periodic=12)),
    ('10i3s', 'scalar channel LES, full-3D implicit diffusion',
     dict(LES_SC_CFG, impdiff=True, dims=(2, 1)),
     dict(mom_rk=3, fillps=3, correc_updatep=3, smag=3, apply_x=24,
          apply_y=24, thomas_z=12)),
    # the closed box (examples/closed_box: six still walls) and the x+y
    # walled scalar of tests/test_sharding_paths.py:735
    ('10xk', 'closed box', dict(XCAVITY_CFG, bcvel=((((0.0,) * 3,) * 3,) * 2),
                                dims=(2, 1)),
     dict(mom_rk=3, fillps=3, correc_updatep=3, apply_x=6, apply_y=6,
          thomas_z=3)),
    ('10xysc', 'developing duct with a passive scalar (x and y walls)',
     dict(XDUCT_CFG, l=(2.0, 1.0, 1.0), visci=2000.0, inivel='uni',
          dims=(2, 1), **XDUCT_SCALAR),
     dict(mom_rk=3, fillps=3, correc_updatep=3, apply_x=6, apply_y=6,
          thomas_z=3)),
    # ptransform 'fft' on the mesh: the box LES with dsmag 'dit', the
    # channel DNS with full-3D implicit diffusion (the Helmholtz solves by
    # the same route) and the wall-modelled duct by the mixed route
    ('10tdf', "box LES, dsmag 'dit', by 'fft'",
     dict(TRI_CFG, sgstype='dsmag', dsmag_avg='dit', ptransform='fft',
          dims=(2, 1)),
     dict(mom_rk=3, fillps=3, correc_updatep=3, dsmag=3)),
    ('10i3f', "channel DNS, full-3D implicit diffusion, by 'fft'",
     dict(DNS_CFG, impdiff_1d=False, ptransform='fft', dims=(2, 1)),
     dict(mom_rk=3, fillps=3, correc_updatep=3)),
    ('10ywf', "wall-modelled duct by 'fft', the mixed route",
     dict(DUCT_WMLES_CFG, ptransform='fft', dims=(2, 1)),
     dict(mom_rk=3, fillps=3, correc_updatep=3, smag=3, apply_y=6,
          wallmodel=3)))
# the small-only classes' launches outside their steps: the initial nu_t's
# SGS kernel on a slab with walls or with dsmag, the wall model's at the
# initial fill and the one check
MESH_SMALL_OUTSIDE = {'10tdf': {'dsmag': 1},
                      '10ywf': {'smag': 1, 'wallmodel': 2}}
# the small runs' steps
MESH_SMALL_STEPS = 2
# the y-walled slab rows of phase 2b -> the mesh phase whose main path
# launches them
WALLED_SLAB_PHASE = {'mom_rk (y walls, slab)': '10y',
                     'fillps (y walls, slab)': '10y',
                     'correc_updatep (y walls, slab)': '10y',
                     'smag (y walls, slab)': '10ys',
                     'dsmag (y walls, slab, duct)': '10y',
                     'dsmag (y walls, slab, cavity)': '10yc'}


def _mesh_env(key):
    """twopass() for a class of MESH_TWOPASS."""
    return twopass() if key in MESH_TWOPASS else contextlib.nullcontext()


def _scalar_range(cfg, time):
    """The bounds a passive scalar keeps: its start and the values of its
    'D' faces, the upper one raised by ssource * time; None without a
    scalar."""
    if not cfg.scalar:
        return None
    if cfg.inivel == 'zer' and any(
            cfg.cbcvel[ib][0][0] == 'D'
            and np.any(np.asarray(cfg.bcvel[ib][0][0]) != 0.0)
            for ib in range(2)):
        # an impulsive start (at rest, an inflow on an x face: phase 13x's
        # developing channel) is no solenoidal field with its values, and
        # the central scheme at cell Peclet numbers above 2 keeps no bound
        # from it, on one device as on the mesh (the f64 twin holds the
        # two to each other): its range is reported, not gated
        return None
    vals = [1.0 if cfg.iniscal == 'uni' else 0.0] + [
        float(cfg.bcscal[ib][d]) for ib in range(2) for d in range(3)
        if cfg.cbcscal[ib][d] == 'D']
    return min(vals), max(vals) + max(cfg.ssource, 0.0) * time


def _outside(outside, cfg, nsteps):
    """The launches outside the steps: with 'wm' (alone, or a key of the
    dict) the wall model's at the initial fill, the initial check and
    every icheck-th step's check."""
    if outside == 'wm':
        return {'wallmodel': 2 + nsteps // cfg.icheck}
    if 'wm' in outside:
        return {**{k: n for k, n in outside.items() if k != 'wm'},
                'wallmodel': 2 + nsteps // cfg.icheck}
    return outside


def _class_cfg(kw, **change):
    """A mesh class's Config from its dict (with change); '_inflow' (the
    developing WMLES) gives it its 1/7-power inflow profile at the cell
    centres of its own grid (profile_step.power_law_inflow)."""
    from cales_torch.config import Config
    from cales_torch.profile_step import power_law_inflow
    kw = {**kw, **change}
    inflow = kw.pop('_inflow', False)
    cfg = Config(**kw)
    return power_law_inflow(cfg) if inflow else cfg


def _small(kw):
    """A class's small float64 twin on the mesh (MESH_SMALL's grid)."""
    return dict(kw, ng=MESH_SMALL['ng'], dtype='float64')


def _mesh_gates(sim, state, mesh):
    """The PERF.md section 2 gates on the slabs, reduced over the ranks:
    (finite (the passive scalar too), divmax, bulk u, nu_t min and max,
    with a scalar its minimum and maximum and the time, max |w - its
    value| on the z walls
    (None with periodic z), max |v| on the y walls (each on its owner: the
    kept lower face, the upper face's row), v on the upper z face against
    its value b, the fill's mean of the last row and the ghost, where that
    face is a wall without a wall model: the cavity's lid; None elsewhere),
    and the kinetic energy (the box's must fall)."""
    _, _, divmax = sim.check(state)
    fields = (state.u, state.v, state.w, state.p, state.visct)
    vy = 0.0
    if sim.yown is not None:
        if sim.yown[0]:
            vy = float(state.vlo[1][1:-1, 1:-1].abs().max())
        if sim.yown[1]:
            vy = max(vy, float(state.v[:, -1].abs().max()))
    lid = u_lid = None
    if sim.cbcvel[1][2][1] == 'D' and sim.cfg.lwm[1][2] == 0:
        lid = mesh.reduce_scalar(float((0.5 * (state.v[-1] + state.zq[1][2])
                                        - sim.bcv_vals[2][1]).abs().max()),
                                 'max')
    if (sim.cbcvel[1][2][0] == 'D' and sim.cfg.lwm[1][2] == 0
            and np.ndim(sim.cfg.bcvel[1][2][0]) == 0
            and float(sim.cfg.bcvel[1][2][0]) != 0.0):
        # a lid moving along x (the cavity's): u on the upper z face
        u_lid = mesh.reduce_scalar(float(
            (0.5 * (state.u[-1] + state.zq[0][2])
             - float(sim.cfg.bcvel[1][2][0])).abs().max()), 'max')
    w_walls = None
    if sim.cbcvel[0][2][2] == 'D':
        # against the faces' values (w through a transpiring wall)
        blo, bhi = sim.bcw_vals[2]
        w_walls = mesh.reduce_scalar(max(
            float((state.vlo[2][1:-1, 1:-1] - blo).abs().max()),
            float((state.w[-1] - bhi).abs().max())), 'max')
    scal = {}
    if state.s is not None:
        fields += (state.s,)
        scal = dict(s_min=mesh.reduce_scalar(float(state.s.min()), 'min'),
                    s_max=mesh.reduce_scalar(float(state.s.max()), 'max'),
                    time=state.time)
    if sim.xwalled:
        # u on the inflow face (the kept lower face's rows of the slab)
        # against its value, and the flux through the outflow face (u's
        # last column) against the inflow's, sums of u dz over the ranks
        dzf = torch.as_tensor(sim.grid.dzf[1:-1], dtype=torch.float64,
                              device=state.u.device)[:, None]
        face = state.vlo[0][1:-1, 1:-1].double()
        # its value: a scalar, or the slab's rows of an inflow profile
        b = sim.bcu_vals[0][0]
        val = b[1:-1, 1:-1].double() if torch.is_tensor(b) else float(b)
        scal.update(
            u_inflow=mesh.reduce_scalar(float(
                (face - val).abs().max()), 'max'),
            flux_in=mesh.reduce_scalar(float((face * dzf).sum()), 'sum'),
            flux_out=mesh.reduce_scalar(float(
                (state.u[:, :, -1].double() * dzf).sum()), 'sum'))
    return dict(**scal,
        energy=mesh.reduce_scalar(
            0.5 * float(sum((q.double() ** 2).sum()
                            for q in (state.u, state.v, state.w))), 'sum'),
        v_ywalls=mesh.reduce_scalar(vy, 'max'), v_lid=lid, u_lid=u_lid,
        finite=mesh.reduce_scalar(
            float(all(bool(torch.isfinite(f).all()) for f in fields)),
            'min'),
        divmax=divmax, bulk_u=sim.bulk_mean(state.u, sim.gvr_f),
        nu_t_min=mesh.reduce_scalar(float(state.visct.min()), 'min'),
        nu_t_max=mesh.reduce_scalar(float(state.visct.max()), 'max'),
        w_walls=w_walls)


def _mesh_les_row(row, sim, state, mesh, dt, card):
    """Rank 0's check of the slab variant a class brings, on its own
    state and halos at the slab's shape, against its twin (float32 within
    1e-4 of each output's maximum, as phase 10's halo rows: FMA
    contraction on the developed field; a wrong halo row moves an output
    by O(1)), timed with its twin and its periodic variant on the same
    slab, and its bound: the bytes (each input and halo once, each output
    once) or the operations this run's inputs need."""
    from cales_torch import wallmodel as wmod
    from cales_torch.ops import kernels as K
    cfg = sim.cfg
    u, v, w, p, s = state.u, state.v, state.w, state.p, state.visct
    ue, ve, we = state.zq
    dxi, dyi = cfg.dli[0], cfg.dli[1]
    name = MESH_LES_ROWS[row]
    if name == 'mom_rk':
        pe = sim._zedge_p(p)
        h = mesh.halo_y([(u, ue), (v, ve), (w, we), (p, pe)])
        yh = (*h[:3], None, h[3])
        args = ((u, v, w, None, p, ue, ve, we, None, pe,
                 *state.rhs_old, sim.dzci_t, sim.dzfi_t, 0.5 * dt, -0.2 * dt,
                 cfg.visc, dxi, dyi, cfg.bforce),
                dict(sums=(True, False), split='1d', yh=yh))
        halo = h
    elif name == 'dsmag':
        yh = mesh.halo_y([(u, ue), (v, ve), (w, we)], depth=2)
        args = ((u, v, w, ue, ve, we, sim.alph2_t, sim.dzci_t, sim.dzfi_t,
                 dxi, dyi, sim.lo_wall, sim.hi_wall, sim.dsmag_zvals),
                dict(yh=yh))
        halo = yh
    else:
        (yh, _), = mesh.halo_y([(wmod.sampled_rows(u, v, sim.wm), None)])
        args = ((u, v, sim.wm), dict(yh=yh))
        halo = (yh,)
    rows = {}
    if mesh.rank == 0:
        a, kw = args
        fname = 'wm_planes' if name == 'wallmodel' else name
        fn, twin = getattr(K, fname), getattr(K, f'{fname}_plain')

        def outputs(res):
            res = [q for q in (res if isinstance(res, tuple) else (res,))
                   if q is not None]
            if name == 'mom_rk':       # the partial sums: per-plane totals
                res[-1] = res[-1].sum(dim=1)
            if name == 'dsmag':        # the partial sums: per-row totals
                res[1:] = [q.sum(dim=-1) for q in res[1:]]
            return res
        got, ref = outputs(fn(*a, **kw)), outputs(twin(*a, **kw))
        errs = []
        for g, r in zip(got, ref):
            d = (g - r).abs()
            errs.append((float(d.max()), float(d.max() / r.abs().max())))
        worst = max(e[0] for e in errs)
        worst_rel = max(e[1] for e in errs)
        tol = 1e-5 if name == 'wallmodel' else 1e-4
        require(all(np.isfinite(e[0]) and e[1] <= tol for e in errs),
                f'{row}: error {worst_rel:.3e} of an output maximum, above '
                f'{tol:.0e}')
        timer = graph_ms if name in GRAPH_TIMED else time_ms
        ms = timer(lambda: fn(*a, **kw))
        plain_ms = time_ms(lambda: twin(*a, **kw), n=3)
        periodic_ms = timer(lambda: fn(*a, **{
            k: q for k, q in kw.items() if k != 'yh'}))
        esize = u.element_size()
        halo_bytes = sum(q.numel() * q.element_size() for q in _flat(halo))
        nz, nyl, nx = u.shape
        if name == 'wallmodel':
            # the sampled rows (two of u and v a face), their halo rows and
            # the faces' planes; a Newton solve a point and the steps these
            # rows need (the float64 twin's count)
            nf = len(sim.wm.faces)
            nbytes = (nf * 4 * nyl * nx + nf * 2 * (nyl + 2) * (nx + 2)
                      ) * esize + halo_bytes
            solves = nf * (nyl * (nx + 1) + (nyl + 1) * nx)
            steps = sum(int(q.sum()) for q in wmod.wm_newton_steps(
                u.double(), v.double(), sim.wm, yh=yh.double()))
            flops = solves * WM_SOLVE_OPS + steps * WM_STEP_OPS
        else:
            nin, nout, per_cell = ((7, 6, 200) if name == 'mom_rk'
                                   else WORK[name])
            nbytes = (nin + nout) * u.numel() * esize + halo_bytes
            flops = per_cell * u.numel()
        t_b = nbytes / PEAK_BPS * 1e3
        t_o = flops / PEAK_FLOPS[u.dtype] * 1e3
        rows[row] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                         bound_ms=max(t_b, t_o),
                         bound_by='bytes' if t_b >= t_o else 'operations',
                         library_ms=None, periodic_variant_ms=periodic_ms,
                         max_rel_err=worst_rel, halo_bytes=halo_bytes,
                         shape=[nx, nyl, nz])
        say(f'  {row} at the slab {(nx, nyl, nz)}: max|err| {worst:.3e} '
            f'(per output / its max|ref|: '
            + ' '.join(f'{e[1]:.1e}' for e in errs) + f'), kernel '
            f'{ms:.4f} ms (its periodic variant on the slab '
            f'{periodic_ms:.4f}), plain twin {plain_ms:.3f} ms, bound '
            f'{rows[row]["bound_ms"]:.4f} ms by {rows[row]["bound_by"]} '
            f'({halo_bytes} halo bytes)  [{card}]')
    mesh.barrier()
    return rows


def _mesh_small(key, kw, mesh, dev, out_dir):
    """A class's small float64 twin on the slabs, MESH_SMALL_STEPS steps
    from the perturbed start; rank 0 writes the gathered fields (and the
    kept wall planes, vlo[1] its own, vlo[2] over the slabs' rows, vlo[0]
    over the slabs' interior rows) for the parent."""
    from cales_torch.grid import make_grid_from_config
    from cales_torch.parallel import mesh as meshmod
    from cales_torch.timeloop import Simulation
    cfg64 = _class_cfg(_small(kw))
    m64 = meshmod.SlabMesh(mesh.comm, cfg64.dims, cfg64.ng)
    sim = Simulation(cfg64, make_grid_from_config(cfg64), device=dev,
                     mesh=m64)
    st = sim.initial_state(*_perturbed_fields(cfg64, SEED + 5))
    dt = sim.pick_dt(sim.check(st)[0])
    for _ in range(MESH_SMALL_STEPS):
        st, _ = sim.step(st, dt)
    small = {q: m64.gather(getattr(st, q))
             for q in ('u', 'v', 'w', 'p', 'visct')
             + (('s',) if st.s is not None else ())}
    if m64.gx > 1:
        # on pencils the kept planes' interior columns (their x ghost
        # columns a pencil's own wrap): v's lower y face of the pencils of
        # iy = 0, w's lower z face with its y ghost rows from the
        # wall-owning pencils
        small['vlo1'] = m64.gather(st.vlo[1][:, None, 1:-1].contiguous())[
            :, 0]
        mid = m64.gather(st.vlo[2][None, 1:-1, 1:-1].contiguous())[0]
        ends = m64.gather(st.vlo[2][None, [0, -1], 1:-1].contiguous())[0]
        small['vlo2'] = np.concatenate([ends[:1], mid, ends[-1:]])
        if mesh.rank == 0:
            np.savez(out_dir / f'small_{key}.npz', dt=dt, **small)
        del sim, st
        return
    w2 = [q.cpu().numpy()
          for q in m64.comm.all_gather(st.vlo[2].contiguous())]
    small['vlo2'] = np.concatenate([w2[0][:1]] + [q[1:-1] for q in w2]
                                   + [w2[-1][-1:]])
    small['vlo1'] = st.vlo[1].cpu().numpy()
    small['vlo0'] = np.concatenate(
        [q.cpu().numpy()[:, 1:-1] for q in m64.comm.all_gather(
            st.vlo[0].contiguous())], axis=1)
    if mesh.rank == 0:
        np.savez(out_dir / f'small_{key}.npz', dt=dt, **small)
    del sim, st


def sharded_les_work(mesh, dev, out_dir):
    """The work of phases 10i .. 10ywf on a rank of the y-slab mesh
    (mesh_rank_body): each class at the headline grid through
    driver.run with every launch count set to 0 just before and read just
    after, its gates, its ms/step over MESH_TIMED steps, its slab variant
    against its twin (the
    channel classes'), and its small f64 twin, whose gathered fields rank
    0 writes for the parent (les_rank<r>.json, small_<key>.npz); 10d also
    takes one step with 'dit', and the classes of MESH_SMALL_ONLY run
    their small twin only, their launches counted there; the classes of
    MESH_TWOPASS under CALES_DSMAG_TWOPASS=1."""
    from cales_torch import driver
    from cales_torch.parallel import mesh as meshmod
    card = card_line()
    rank = mesh.rank
    res = {'rank': rank, 'card': card}
    runs = [(key, kw) for key, _, kw, *_ in MESH_CLASSES]
    runs.append(('10d dit', dict(MESH_CLASSES[2][2], dsmag_avg='dit')))
    runs += [(key, kw) for key, _, kw, _ in MESH_SMALL_ONLY]
    small_only = {key for key, *_ in MESH_SMALL_ONLY}
    for key, kw in runs:
        with _mesh_env(key):
            if key in small_only:
                reset_counts()
                _mesh_small(key, kw, mesh, dev, out_dir)
                torch.cuda.synchronize()
                res[key] = {'launches': counts(), 'steps': MESH_SMALL_STEPS}
                continue
            cfg = _class_cfg(kw)
            m = meshmod.SlabMesh(mesh.comm, cfg.dims, cfg.ng)
            nsteps = 1 if key == '10d dit' else MESH_LES_STEPS
            torch.cuda.reset_peak_memory_stats(dev)
            reset_counts()
            t0 = time.perf_counter()
            sim, state = driver.run(
                cfg, datadir=out_dir / key.replace(' ', '_'), device=dev,
                mesh=m, max_steps=nsteps, verbose=False)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            r = {'launches': counts(), 'steps': nsteps, 'wall_s': wall}
            if rank == 0:
                say(f'  phase {key} path: {sim.exec_path()}')
            dt = sim.pick_dt(sim.check(state)[0])
            ntime = 0 if key == '10d dit' else MESH_TIMED
            energy0 = _mesh_gates(sim, state, m)['energy']
            torch.cuda.synchronize()
            m.barrier()
            t0 = time.perf_counter()
            for _ in range(ntime):
                state, _ = sim.step(state, dt)
            torch.cuda.synchronize()
            m.barrier()
            r['ms_per_step'] = ((time.perf_counter() - t0) * 1e3 / ntime
                                if ntime else None)
            r.update(_mesh_gates(sim, state, m))
            r['energy_before'] = energy0
            r['peak_gib'] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if sim.has_wm:
                planes = sim._wm_planes(state.u, state.v, state.w)
                r['wm_finite'] = m.reduce_scalar(
                    float(all(bool(torch.isfinite(q).all()) for q in planes)),
                    'min')
            if key == '10d dit':
                res[key] = r
                del sim, state
                continue
            row = [c[3] for c in MESH_CLASSES if c[0] == key][0]
            if row is not None:
                r['halo_rows'] = _mesh_les_row(row, sim, state, m, dt, card)
            del sim, state
            torch.cuda.empty_cache()
            _mesh_small(key, kw, mesh, dev, out_dir)
            res[key] = r
    (out_dir / f'les_rank{rank}.json').write_text(json.dumps(res))
    mesh.barrier()


def _small_vs_one_device(tag, kw, small, dev):
    """A class's small f64 twin on the mesh (small: rank 0's gathered
    fields) against the single-device run on the card within 1e-11, p
    without its mean ('mat' + Thomas for the 'mat' classes, whose mesh
    route takes Thomas at every nz; a 'fft' class on its own route); with
    y walls the kept planes vlo[1] and vlo[2] too, with x walls vlo[0] on
    the interior y rows and vlo[2] (with periodic y on the interior y
    rows: their periodic y ghost rows no fill reads); on pencils the kept
    planes' interior columns.  Returns the errors by name."""
    from cales_torch.grid import make_grid_from_config
    from cales_torch.timeloop import Simulation
    route = {} if kw.get('ptransform') == 'fft' else {'zsolver': 'thomas'}
    cfg1 = _class_cfg(_small(kw), dims=(1, 1), **route)
    sim = Simulation(cfg1, make_grid_from_config(cfg1), device=dev)
    st = sim.initial_state(*_perturbed_fields(cfg1, SEED + 5))
    for _ in range(MESH_SMALL_STEPS):
        st, _ = sim.step(st, float(small['dt']))
    say(f'  {tag}: dims {tuple(kw["dims"])} against one device, {cfg1.ng} '
        f'float64, {MESH_SMALL_STEPS} steps, on the card:')
    names = (('u', 'v', 'w', 'p', 'visct')
             + (('s',) if cfg1.scalar else ())
             + (('vlo0',) if sim.xwalled else ())
             + (('vlo1',) if sim.ywalled else ())
             + (('vlo2',) if sim.ywalled or sim.xwalled else ()))
    out = {}
    for name in names:
        ref = (st.vlo[int(name[-1])] if name.startswith('vlo')
               else getattr(st, name))
        a, b = small[name], ref.cpu().numpy()
        if sim.xwalled and name == 'vlo0':
            b = b[:, 1:-1]
        if sim.xwalled and not sim.ywalled and name == 'vlo2':
            a, b = a[1:-1], b[1:-1]
        if kw['dims'][1] > 1 and name in ('vlo1', 'vlo2'):
            b = b[:, 1:-1]
        if name == 'p':
            a, b = a - a.mean(), b - b.mean()
        err = float(np.abs(a - b).max())
        say(f'    {name:<5s} max|err| {err:.3e} (bound 1e-11)')
        require(err <= 1e-11, f'{tag} f64 {name}: {err:.3e}')
        out[f'f64_{name}_err'] = err
    return out


def phase_sharded_les(dev, card, les):
    """Phases 10i, 10w and 10d: the channel DNS with impdiff_1d, the
    wall-modelled channel LES and the dsmag channel ('channel', impdiff_1d;
    then one step with 'dit'); 10y, 10yc and 10ys: the y-walled dsmag duct
    ('duct'), dsmag cavity ('cavity', the lid on v) and static-Smagorinsky
    duct; 10yw: the wall-modelled duct (the wall model on its four walls);
    10t, 10tl and 10td: the triperiodic box as DNS, with static
    Smagorinsky and with dsmag 'dit'; 10s and 10ysc: the channel LES and
    the dsmag duct with a passive scalar (its range gated: within its
    start's and walls' values); 10b and 10yb: the two-pass dsmag on the
    transpiring channel (dsmag_blow) and on the duct under
    CALES_DSMAG_TWOPASS=1; 10f and 10tf: the 2D test filter on the dsmag
    channel and on the box with 'dit'; 10i3 and 10t3: the channel DNS and the box with full-3D implicit
    diffusion, 10x and 10xb: the developing channel and its LES with
    impdiff_1d (u at its value on the inflow face, the outflow's flux the
    inflow's), 10xy, 10xc, 10xw and 10xs: the developing duct LES, the
    lid-driven cavity (the lid's u), the developing WMLES with its
    1/7-power inflow and the developing channel with a scalar, and the
    small f64 cases alone of 10t1 (the box with impdiff_1d), 10i3s (the
    scalar channel LES with full-3D), 10xk (the closed box) and 10xysc
    (the x+y-walled scalar), their launches counted on their own steps;
    on a y-slab mesh, dims = (2, 1), two
    ranks sharing the one card over gloo staged through the host (as phase
    10: its ms/step is a correctness run's, no scaling figure), each at
    512x256x256 f32 with the PERF.md section 2 gates (with y walls v on
    them, each on its owner; v on the cavity's lid; the box's kinetic
    energy falling over the timed steps) and exact launches,
    the channel classes' slab kernel variant against its twin, and each
    class's small f64 twin (the 'none' duct's alone, 10yn) against the
    single-device run on the card within 1e-11 (with y walls the kept
    planes too); and with ptransform 'fft' 10ff and
    10yf: the LES headline and the dsmag duct by the mixed route, and the
    small f64 cases alone of 10tdf (the box LES with 'dit'), 10i3f (the
    full-3D channel DNS) and 10ywf (the wall-modelled duct, mixed).
    les: the two-rank runner's results (run_mesh_ranks).
    Returns ({key: rank 0's launches}, the report rows)."""
    ranks, smalls = les
    small_eps = float(np.sqrt(np.finfo(np.float32).eps) * 10)
    launches, rows = {}, {}
    per = {c[0]: c for c in MESH_CLASSES}
    per['10d dit'] = ('10d dit', "dsmag channel, 'dit', impdiff_1d",
                      dict(per['10d'][2], dsmag_avg='dit'), None,
                      per['10d'][4], per['10d'][5])
    report = {}
    for key, (_, title, kw, row, per_step, outside) in per.items():
        cfg = _class_cfg(kw)
        ywalled = cfg.cbc_vel(1, 1) != 'PP'
        for rk in ranks:
            r = rk[key]
            want_out = _outside(outside, cfg, r['steps'])
            for name, n in r['launches'].items():
                want = per_step.get(name, 0) * r['steps'] + want_out.get(
                    name, 0)
                require(n == want, f'phase {key} rank {rk["rank"]}: {name} '
                                   f'launched {n} times, want {want}')
        r0 = ranks[0][key]
        launches[key] = r0['launches']
        tag = f'phase {key}: {title}'
        ms = ('' if r0['ms_per_step'] is None else
              f'{r0["ms_per_step"]:.3f} ms/step over {MESH_TIMED} step(s) '
              '(host clock; '
              'two ranks time-share the card and stage every collective '
              'through the host: a correctness run, not a scaling figure), ')
        say(f'{tag}: {ms}{r0["steps"]} steps through driver.run in '
            f'{r0["wall_s"]:.1f} s; rank 0 launches {r0["launches"]}  '
            f'[{card}]')
        say(f'  divmax {r0["divmax"]:.3e} (abort bound {small_eps:.3e}), '
            f'bulk u {r0["bulk_u"]:.7f}, nu_t in [{r0["nu_t_min"]:.4e}, '
            f'{r0["nu_t_max"]:.4e}], '
            + ('' if r0['w_walls'] is None else
               f'max |w - its value| on the z walls {r0["w_walls"]:.3e}, ')
            + f'max |v| on the y walls {r0["v_ywalls"]:.3e}, kinetic '
            f'energy {r0["energy_before"]:.6e} -> {r0["energy"]:.6e} over '
            f'the {MESH_TIMED} timed step(s)'
            + ('' if r0['v_lid'] is None else
               f', v on the upper z face against its value '
               f'{cfg.bcvel[1][2][1]} {r0["v_lid"]:.3e}')
            + ', peak memory a rank '
            + ', '.join(f'{rk[key]["peak_gib"]:.2f}' for rk in ranks)
            + f' GiB  [{card}]')
        require(r0['finite'] == 1.0, f'{tag}: non-finite field')
        require(r0['divmax'] <= small_eps, f'{tag}: divmax '
                                           f'{r0["divmax"]:.3e}')
        if any(cfg.is_forced):
            require(abs(r0['bulk_u'] - 1.0) <= 1e-4,
                    f'{tag}: bulk u {r0["bulk_u"]:.7f}, want 1')
        if ywalled:
            require(r0['v_ywalls'] <= 1e-6, f'{tag}: v on the y walls '
                                            f'{r0["v_ywalls"]:.3e}')
        if r0['v_lid'] is not None:
            require(r0['v_lid'] <= 1e-5, f'{tag}: v on the upper z face '
                                         f'{r0["v_lid"]:.3e} from its value')
        if r0.get('u_lid') is not None:
            say(f'  max |u - {cfg.bcvel[1][2][0]}| on the lid '
                f'{r0["u_lid"]:.3e}  [{card}]')
            require(r0['u_lid'] <= 1e-5, f"{tag}: the lid's u "
                                         f'{r0["u_lid"]:.3e} from its value')
        require(r0['nu_t_min'] >= 0.0, f'{tag}: nu_t min {r0["nu_t_min"]}')
        require((r0['nu_t_max'] > 0.0) == (cfg.sgstype != 'none'),
                f'{tag}: nu_t max {r0["nu_t_max"]}')
        if r0['w_walls'] is not None:
            require(r0['w_walls'] <= 1e-6, f'{tag}: w on the walls '
                                           f'{r0["w_walls"]:.3e} from its '
                                           'value')
        if cfg.cbc_vel(2, 0) == 'PP' and r0['ms_per_step'] is not None:
            # the box: no forcing, the energy decays
            require(r0['energy'] < r0['energy_before'],
                    f'{tag}: kinetic energy {r0["energy_before"]:.6e} -> '
                    f'{r0["energy"]:.6e}, not falling')
        if 'wm_finite' in r0:
            require(r0['wm_finite'] == 1.0, f'{tag}: non-finite wall-model '
                                            'planes')
        if 'u_inflow' in r0:
            # x walls: u at its value on the inflow face, the outflow's
            # flux the inflow's
            say(f'  max |u - its value| on the inflow face '
                f'{r0["u_inflow"]:.3e}; flux through the inflow face '
                f'{r0["flux_in"]:.7f}, the outflow face {r0["flux_out"]:.7f}'
                f' (sum over the face of u dz)  [{card}]')
            require(r0['u_inflow'] <= 1e-6, f'{tag}: u on the inflow face '
                                            f'off by {r0["u_inflow"]:.3e}')
            # (x walls without an inflow, the cavity's: no flux through
            # either face, to 1e-6)
            require(abs(r0['flux_out'] - r0['flux_in'])
                    <= 1e-4 * max(abs(r0['flux_in']), 1e-2),
                    f'{tag}: outflow flux {r0["flux_out"]:.7f}, inflow '
                    f'{r0["flux_in"]:.7f}')
        bounds = _scalar_range(cfg, r0.get('time', 0.0))
        if bounds is None and 's_min' in r0:
            say(f'  s in [{r0["s_min"]:.6e}, {r0["s_max"]:.6e}] at t = '
                f'{r0["time"]:.6e} (an impulsive start: not gated)  '
                f'[{card}]')
        if bounds is not None:
            # within its start's and walls' values, to 1e-2 of their range:
            # the central scheme is not bounded (phase 13 reads s down to
            # -4.8e-5 after 11 steps; the duct's at 32x16x16 and dt 0.13
            # overshoots its start by 0.064)
            lo, hi = bounds
            slack = 1e-2 * max(hi - lo, 1.0)
            say(f'  s in [{r0["s_min"]:.6e}, {r0["s_max"]:.6e}] at t = '
                f'{r0["time"]:.6e} (bounds [{lo:.4f}, {hi:.6f}])  [{card}]')
            require(lo - slack <= r0['s_min'] and r0['s_max'] <= hi + slack,
                    f'{tag}: s in [{r0["s_min"]:.6e}, {r0["s_max"]:.6e}], '
                    f'outside [{lo}, {hi}]')
        report[key] = {k: r0[k] for k in ('ms_per_step', 'divmax', 'bulk_u',
                                           'nu_t_min', 'nu_t_max',
                                           'w_walls', 'v_ywalls',
                                           'v_lid', 'u_lid',
                                           'energy_before', 'energy',
                                           's_min', 's_max',
                                           'u_inflow', 'flux_in',
                                           'flux_out', 'wall_s')
                       if k in r0} | {'card': card}
        rows.update(r0.get('halo_rows', {}))
        if key in smalls:
            with _mesh_env(key):
                report[key].update(_small_vs_one_device(
                    tag, kw, smalls[key], dev))
    for key, title, kw, per_step in MESH_SMALL_ONLY:
        # its launches on the small twin's steps, each rank's
        for rk in ranks:
            r = rk[key]
            for name, n in r['launches'].items():
                want = (per_step.get(name, 0) * r['steps']
                        + MESH_SMALL_OUTSIDE.get(key, {}).get(name, 0))
                require(n == want, f'phase {key} rank {rk["rank"]}: {name} '
                                   f'launched {n} times, want {want}')
        launches[key] = ranks[0][key]['launches']
        tag = f'phase {key}: {title}'
        say(f'{tag}: rank 0 launches {launches[key]} in {MESH_SMALL_STEPS} '
            f'steps of its small twin  [{card}]')
        report[key] = _small_vs_one_device(tag, kw, smalls[key], dev)
        report[key]['card'] = card
    print(json.dumps({'mesh_classes_2x1': report}), flush=True)
    return launches, rows


# the classes on the 2D pencil mesh dims (2, 2) (phases 10p, 10pf, 10pi,
# 10pd, 10pt, 10ptd, 10pi3, 10pb, 10p2d, 10pt2d, 10ps): four ranks on the
# one card over gloo, each class at the headline grid in float32 through
# driver.run with exact launches a rank (the x-halo variants of mom_rk
# (with the scalar too), fillps, correc_updatep, smag, dsmag (with the 2D
# filter too), dsmag_level1 and dsmag_level2, the re-slab around the slab
# route's kernels on 4 y slabs, full-3D implicit diffusion's Helmholtz
# solves through it), the
# PERF.md section 2 gates and one timed step; and the small float64 twins
# of those classes, of the 'none' channel, the box's smag LES and the box
# DNS by 'fft' against one device on the card within 1e-11.  (key, title,
# config, per step, outside the steps: the initial nu_t's dsmag)
PENCIL_DIMS = (2, 2)
PENCIL_STEPS = 2
PENCIL_CLASSES = (
    ('10p', "LES headline by 'mat' (phase 10's)", dict(MESH_CFG,
                                                     dims=PENCIL_DIMS),
     dict(mom_rk=3, fillps=3, correc_updatep=3, smag=3, apply_x=6,
          apply_y=6, thomas_z=3), {}),
    ('10pf', "LES headline by 'fft' (bench.py channel_les_smag, phase 4)",
     dict(LES_CFG, dims=PENCIL_DIMS, **CHAN_BCS),
     dict(mom_rk=3, fillps=3, correc_updatep=3, smag=3), {}),
    ('10pi', 'LES with impdiff_1d (phase 5\'s LES_IMP_CFG)',
     dict(LES_IMP_CFG, dims=PENCIL_DIMS),
     dict(mom_rk=3, fillps=3, correc_updatep=3, smag=3, apply_x=6,
          apply_y=6, thomas_z=12), {}),
    ('10pd', "dsmag channel, 'channel', impdiff_1d (phase 10d's)",
     dict(DSMAG_CFG, dims=PENCIL_DIMS),
     dict(mom_rk=3, fillps=3, correc_updatep=3, dsmag=3, apply_x=6,
          apply_y=6, thomas_z=12), {'dsmag': 1}),
    ('10pt', 'triperiodic DNS (triperiodic_dns)',
     dict(TRI_CFG, dims=PENCIL_DIMS),
     dict(mom_rk=3, fillps=3, correc_updatep=3, apply_x=6, apply_y=6,
          thomas_periodic=3), {}),
    ('10ptd', "box LES, dynamic Smagorinsky 'dit'",
     dict(TRI_CFG, sgstype='dsmag', dsmag_avg='dit', dims=PENCIL_DIMS),
     dict(mom_rk=3, fillps=3, correc_updatep=3, dsmag=3, apply_x=6,
          apply_y=6, thomas_periodic=3), {'dsmag': 1}),
    # three Helmholtz solves a substep beside the Poisson solve, each
    # through the re-slab: 16 all-to-alls a substep
    ('10pi3', 'channel DNS, full-3D implicit diffusion (phase 5f)',
     dict(DNS_CFG, impdiff_1d=False, dims=PENCIL_DIMS),
     dict(mom_rk=3, fillps=3, correc_updatep=3, apply_x=24, apply_y=24,
          thomas_z=12), {}),
    # the two passes (dsmag_level1's two-deep x halo, then the filtered
    # velocity's one-deep after its fill for dsmag_level2: two x
    # exchanges a substep), the 2D test filter (dsmag F2D x XH) and the
    # passive scalar (its columns in the momentum exchange)
    ('10pb', 'transpiring dsmag channel (dsmag_blow), two passes',
     dict(DSMAG_BLOW_CFG, dims=PENCIL_DIMS),
     dict(mom_rk=3, fillps=3, correc_updatep=3, dsmag_level1=3,
          dsmag_level2=3, apply_x=6, apply_y=6, thomas_z=12),
     {'dsmag_level1': 1, 'dsmag_level2': 1}),
    ('10p2d', "dsmag channel with the 2D test filter ('channel', "
     'impdiff_1d)', dict(DSMAG_CFG, filter_2d=True, dims=PENCIL_DIMS),
     dict(mom_rk=3, fillps=3, correc_updatep=3, dsmag=3, apply_x=6,
          apply_y=6, thomas_z=12), {'dsmag': 1}),
    ('10pt2d', "box LES, dsmag 'dit' with the 2D test filter",
     dict(TRI_CFG, sgstype='dsmag', dsmag_avg='dit', filter_2d=True,
          dims=PENCIL_DIMS),
     dict(mom_rk=3, fillps=3, correc_updatep=3, dsmag=3, apply_x=6,
          apply_y=6, thomas_periodic=3), {'dsmag': 1}),
    ('10ps', "channel LES with a passive scalar (phase 13's LES_SC_CFG)",
     dict(LES_SC_CFG, dims=PENCIL_DIMS),
     dict(mom_rk=3, fillps=3, correc_updatep=3, smag=3, apply_x=6,
          apply_y=6, thomas_z=3), {}),
    # the y-walled classes (the Y_WALLS x X_HALO variants, dsmag's YW + YH
    # x XH; the initial nu_t a kernel's launch on a walled pencil): the
    # dsmag duct and cavity (bench.py duct_les_dsmag, cavity_les_dsmag),
    # the smag and 'none' ducts, the dsmag duct with phase 13y's scalar,
    # and the dsmag duct by 'fft' (the mixed route: apply_y with the y DCT
    # on the rfft's lanes, no apply_x)
    ('10py', "dsmag duct, 'duct' (duct_les_dsmag)",
     dict(DUCT_CFG, dims=PENCIL_DIMS),
     dict(mom_rk=3, fillps=3, correc_updatep=3, dsmag=3, apply_x=6,
          apply_y=6, thomas_z=3), {'dsmag': 1}),
    ('10pyc', "dsmag cavity, 'cavity' (cavity_les_dsmag)",
     dict(CAVITY_CFG, dims=PENCIL_DIMS),
     dict(mom_rk=3, fillps=3, correc_updatep=3, dsmag=3, apply_x=6,
          apply_y=6, thomas_z=3), {'dsmag': 1}),
    ('10pys', 'static-Smagorinsky duct (duct_les_dsmag with smag)',
     dict(DUCT_CFG, sgstype='smag', dims=PENCIL_DIMS),
     dict(mom_rk=3, fillps=3, correc_updatep=3, smag=3, apply_x=6,
          apply_y=6, thomas_z=3), {'smag': 1}),
    ('10pyn', "'none' duct (duct_les_dsmag with sgstype 'none')",
     dict(DUCT_CFG, sgstype='none', dims=PENCIL_DIMS),
     dict(mom_rk=3, fillps=3, correc_updatep=3, apply_x=6, apply_y=6,
          thomas_z=3), {}),
    ('10pysc', "dsmag duct with a passive scalar (phase 13y's)",
     dict(DUCT_SC_CFG, dims=PENCIL_DIMS),
     dict(mom_rk=3, fillps=3, correc_updatep=3, dsmag=3, apply_x=6,
          apply_y=6, thomas_z=3), {'dsmag': 1}),
    ('10pyf', "dsmag duct by 'fft', the mixed route (phase 8f)",
     dict(DUCT_CFG, ptransform='fft', dims=PENCIL_DIMS),
     dict(mom_rk=3, fillps=3, correc_updatep=3, dsmag=3, apply_y=6),
     {'dsmag': 1}))
# the small float64 twins: the classes', the 'none' channel's, the box's
# smag LES (its launches counted: the no-wall smag's main path) and the
# box DNS by 'fft'
PENCIL_SMALL = tuple(c[:3] for c in PENCIL_CLASSES) + (
    ('10pn', "'none' channel by 'mat'",
     dict(MESH_CFG, sgstype='none', dims=PENCIL_DIMS)),
    ('10ptl', 'box LES, static Smagorinsky (no wall)',
     dict(TRI_CFG, sgstype='smag', dims=PENCIL_DIMS)),
    ('10ptf', "triperiodic DNS by 'fft'",
     dict(TRI_CFG, ptransform='fft', dims=PENCIL_DIMS)))
# the small twins whose launches phase 2b's rows read, and what they
# launch: a step's, and outside the steps the initial nu_t's smag
PENCIL_SMALL_COUNTED = {'10ptl': (dict(mom_rk=3, fillps=3, correc_updatep=3,
                                       smag=3, apply_x=6, apply_y=6,
                                       thomas_periodic=3), {})}


def pencil_rank(out_dir, transport='gloo'):
    """pencil_rank_body, with a failure's traceback written to
    DIR/rank<r>.err for the parent to show."""
    try:
        return pencil_rank_body(out_dir, transport)
    except BaseException:
        import traceback
        rank = os.environ.get('RANK', '?')
        (Path(out_dir) / f'rank{rank}.err').write_text(traceback.format_exc())
        raise


def pencil_rank_body(out_dir, transport='gloo'):
    """One rank of the phases of PENCIL_CLASSES (started under
    torch.distributed.run, four ranks on the one card over gloo, staged
    through pinned host buffers, or with transport 'nccl' a card a rank):
    each class at the headline grid through
    driver.run with every launch count set to 0 just before and read just
    after, its gates, its ms/step over MESH_TIMED steps, then the small
    f64 twins (PENCIL_SMALL), whose gathered fields rank 0 writes for the
    parent (the launches of those of PENCIL_SMALL_COUNTED counted)."""
    from cales_torch import driver
    from cales_torch.parallel import mesh as meshmod
    out_dir = Path(out_dir)
    first = _class_cfg(PENCIL_CLASSES[0][2])
    mesh, dev = meshmod.from_env(first.dims, first.ng, 'cuda', transport)
    card = card_line()
    rank = mesh.rank
    res = {'rank': rank, 'card': card}
    for key, _, kw, _, _ in PENCIL_CLASSES:
        cfg = _class_cfg(kw)
        m = meshmod.SlabMesh(mesh.comm, cfg.dims, cfg.ng)
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        t0 = time.perf_counter()
        sim, state = driver.run(cfg, datadir=out_dir / key, device=dev,
                                mesh=m, max_steps=PENCIL_STEPS,
                                verbose=False)
        torch.cuda.synchronize()
        r = {'launches': counts(), 'steps': PENCIL_STEPS,
             'wall_s': time.perf_counter() - t0}
        if rank == 0:
            say(f'  phase {key} path: {sim.exec_path()}')
        dt = sim.pick_dt(sim.check(state)[0])
        energy0 = _mesh_gates(sim, state, m)['energy']
        torch.cuda.synchronize()
        m.barrier()
        t0 = time.perf_counter()
        for _ in range(MESH_TIMED):
            state, _ = sim.step(state, dt)
        torch.cuda.synchronize()
        m.barrier()
        r['ms_per_step'] = (time.perf_counter() - t0) * 1e3 / MESH_TIMED
        r.update(_mesh_gates(sim, state, m))
        r['energy_before'] = energy0
        r['peak_gib'] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        res[key] = r
        del sim, state
        torch.cuda.empty_cache()
    for key, _, kw in PENCIL_SMALL:
        reset_counts()
        _mesh_small(key, kw, mesh, dev, out_dir)
        torch.cuda.synchronize()
        if key in PENCIL_SMALL_COUNTED:
            res[key] = {'launches': counts(), 'steps': MESH_SMALL_STEPS}
    (out_dir / f'rank{rank}.json').write_text(json.dumps(res))
    mesh.barrier()
    torch.distributed.destroy_process_group()
    return 0


def phase_pencil(dev, card, transport='gloo'):
    """Phases 10p, 10pf and 10pi: the LES headline by 'mat' and by 'fft'
    and the LES with impdiff_1d; 10pd: the dsmag channel ('channel',
    impdiff_1d); 10pt and 10ptd: the triperiodic DNS and its dsmag 'dit'
    LES; 10pi3: the channel DNS with full-3D implicit diffusion; 10pb: the
    transpiring dsmag channel by two passes (dsmag_blow); 10p2d and
    10pt2d: the 2D test filter on the dsmag channel and on the box's 'dit'
    LES; 10ps: the channel LES with a passive scalar (its range gated as
    on the y-slab mesh); the y-walled classes (the Y_WALLS x X_HALO
    variants, dsmag's YW + YH x XH; v on the y walls and the cavity's lid
    gated as on the y-slab mesh): 10py and 10pyc, the dsmag duct ('duct')
    and cavity ('cavity'), 10pys and 10pyn, the smag and 'none' ducts,
    10pysc, the dsmag duct with a scalar, and 10pyf, the dsmag duct by
    'fft' (the mixed route); on the 2D pencil mesh dims (2, 2), four
    ranks sharing the one card over gloo staged through the host (a
    correctness run: the staging and the four ranks' time-sharing of the
    card make its ms/step no scaling figure), each at 512x256x256 f32 with
    exact launches a rank and the PERF.md section 2 gates (the box's
    kinetic energy falling over the timed step); the small f64 twins of
    the seventeen (with y walls the kept planes vlo[1] and vlo[2] on the
    pencils' interior columns too), of the 'none' channel (10pn), the
    box's smag LES (10ptl,
    its launches counted) and the box DNS by 'fft' (10ptf) against one
    device on the card within 1e-11; then the LES example through the CLI
    with dims(1:2) = 2, 2 (10pc), and the duct example (y walls, dsmag
    'channel') the same way (10pcy).  With transport
    'nccl' (`chip_smoke.py --pencil-nccl`, four cards) the same on a card a
    rank, its ms/step a scaling figure.  Returns {key: rank 0's
    launches}."""
    torch.cuda.empty_cache()
    env = dict(os.environ)
    env.setdefault('GLOO_SOCKET_IFNAME', 'lo')
    nr = PENCIL_DIMS[0] * PENCIL_DIMS[1]
    keys = [k for k, *_ in PENCIL_CLASSES]
    where = ('ranks on one card (gloo, staged through the host)'
             if transport == 'gloo' else 'ranks, a card each (NCCL)')
    say(f'phases {", ".join(keys)}: the channel classes on the pencil mesh '
        f'dims {PENCIL_DIMS}, {HEADLINE_NG} float32, {nr} {where}  [{card}]')
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, '-m', 'torch.distributed.run', '--standalone',
               '--nproc_per_node', str(nr), str(ROOT / 'chip_smoke.py'),
               '--pencil-rank', tmp, transport]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                             timeout=900, env=env)
        say(f'  torch.distributed.run exit {res.returncode} after '
            f'{time.perf_counter() - t0:.1f} s (limit 900 s)')
        for line in res.stdout.splitlines():
            say(f'  | {line}')
        errs = ''.join(f'rank {r}:\n{q.read_text()}' for r in range(nr)
                       for q in [Path(tmp) / f'rank{r}.err'] if q.exists())
        require(res.returncode == 0, f'a rank of phases 10p-10ps failed:\n'
                                     f'{errs or res.stderr[-4000:]}')
        ranks = [json.loads((Path(tmp) / f'rank{r}.json').read_text())
                 for r in range(nr)]
        smalls = {key: dict(np.load(Path(tmp) / f'small_{key}.npz'))
                  for key, *_ in PENCIL_SMALL}
    small_eps = float(np.sqrt(np.finfo(np.float32).eps) * 10)
    launches, report = {}, {}
    for key, title, kw, per_step, outside in PENCIL_CLASSES:
        tag = f'phase {key}: {title}, dims {PENCIL_DIMS}'
        cfg = _class_cfg(kw)
        for rk in ranks:
            for name, n in rk[key]['launches'].items():
                want = per_step.get(name, 0) * PENCIL_STEPS + outside.get(
                    name, 0)
                require(n == want, f'{tag} rank {rk["rank"]}: {name} '
                                   f'launched {n} times, want {want}')
        r0 = ranks[0][key]
        launches[key] = r0['launches']
        say(f'{tag}: rank 0 launches {r0["launches"]} in {PENCIL_STEPS} '
            f'steps; {r0["ms_per_step"]:.3f} ms/step over {MESH_TIMED} '
            + (f'(host clock; {nr} ranks time-share the card and stage '
               'every collective through the host)' if transport == 'gloo'
               else '(host clock; a card a rank, NCCL)')
            + f', driver.run {r0["wall_s"]:.1f} s'
            f'; divmax {r0["divmax"]:.3e}, bulk u {r0["bulk_u"]:.7f}, nu_t '
            f'in [{r0["nu_t_min"]:.4e}, {r0["nu_t_max"]:.4e}], '
            + ('' if r0['w_walls'] is None else
               f'max |w| on the z walls {r0["w_walls"]:.3e}, ')
            + f'kinetic energy {r0["energy_before"]:.6e} -> '
            f'{r0["energy"]:.6e} over the timed step; peak memory a rank '
            + ', '.join(f'{rk[key]["peak_gib"]:.2f}' for rk in ranks)
            + f' GiB  [{card}]')
        require(r0['finite'] == 1.0, f'{tag}: non-finite field')
        require(r0['divmax'] <= small_eps, f'{tag}: divmax '
                                           f'{r0["divmax"]:.3e}')
        if any(cfg.is_forced):
            require(abs(r0['bulk_u'] - 1.0) <= 1e-4,
                    f'{tag}: bulk u {r0["bulk_u"]:.7f}, want 1')
        require(r0['nu_t_min'] >= 0.0, f'{tag}: nu_t min {r0["nu_t_min"]}')
        require((r0['nu_t_max'] > 0.0) == (cfg.sgstype != 'none'),
                f'{tag}: nu_t max {r0["nu_t_max"]}')
        if cfg.cbc_pre(1) != 'PP':
            # y walls: v on them (the owners' kept lower face and upper
            # row) and the cavity's lid
            say(f'  max |v| on the y walls {r0["v_ywalls"]:.3e}'
                + ('' if r0['v_lid'] is None else
                   f', v on the lid against its value {r0["v_lid"]:.3e}')
                + f'  [{card}]')
            require(r0['v_ywalls'] <= 1e-6, f'{tag}: v on the y walls '
                                            f'{r0["v_ywalls"]:.3e}')
            if r0['v_lid'] is not None:
                require(r0['v_lid'] <= 1e-5, f'{tag}: v on the upper z '
                                             f'face {r0["v_lid"]:.3e} from '
                                             'its value')
        if r0['w_walls'] is not None:
            require(r0['w_walls'] <= 1e-6, f'{tag}: w on the walls '
                                           f'{r0["w_walls"]:.3e}')
        else:
            # the box: no forcing, the energy decays
            require(r0['energy'] < r0['energy_before'],
                    f'{tag}: kinetic energy {r0["energy_before"]:.6e} -> '
                    f'{r0["energy"]:.6e}, not falling')
        bounds = _scalar_range(cfg, r0.get('time', 0.0))
        if bounds is not None:
            # within its start's and walls' values, to 1e-2 of their
            # range, as on the y-slab mesh (phase_sharded_les)
            lo, hi = bounds
            slack = 1e-2 * max(hi - lo, 1.0)
            say(f'  s in [{r0["s_min"]:.6e}, {r0["s_max"]:.6e}] at t = '
                f'{r0["time"]:.6e} (bounds [{lo:.4f}, {hi:.6f}])  [{card}]')
            require(lo - slack <= r0['s_min'] and r0['s_max'] <= hi + slack,
                    f'{tag}: s in [{r0["s_min"]:.6e}, {r0["s_max"]:.6e}], '
                    f'outside [{lo}, {hi}]')
        report[key] = {k: r0[k] for k in ('ms_per_step', 'divmax', 'bulk_u',
                                           'nu_t_min', 'nu_t_max',
                                           'w_walls', 'v_ywalls', 'v_lid',
                                           'energy_before',
                                           'energy', 's_min', 's_max',
                                           'wall_s') if k in r0} | {
            'peak_gib_per_rank': [rk[key]['peak_gib'] for rk in ranks],
            'card': card}
    for key, (per_step, outside) in PENCIL_SMALL_COUNTED.items():
        # its launches on the small twin's steps, each rank's
        for rk in ranks:
            for name, n in rk[key]['launches'].items():
                want = per_step.get(name, 0) * MESH_SMALL_STEPS + \
                    outside.get(name, 0)
                require(n == want, f'phase {key} rank {rk["rank"]}: {name} '
                                   f'launched {n} times, want {want}')
        launches[key] = ranks[0][key]['launches']
    for key, title, kw in PENCIL_SMALL:
        tag = f'phase {key}: {title}'
        report.setdefault(key, {'card': card}).update(_small_vs_one_device(
            tag, kw, smalls[key], dev))
    print(json.dumps({'pencil_classes_2x2': report | {
        'transport': transport}}), flush=True)
    phase_cli_mesh(card, PENCIL_DIMS, transport)
    phase_cli_mesh(card, PENCIL_DIMS, transport, 'turbulent_duct_les')
    return launches


def main():
    if len(sys.argv) == 3 and sys.argv[1] == '--mesh-rank':
        sys.path.insert(0, str(ROOT))
        return mesh_rank(sys.argv[2])
    if len(sys.argv) in (3, 4) and sys.argv[1] == '--pencil-rank':
        sys.path.insert(0, str(ROOT))
        return pencil_rank(sys.argv[2], *sys.argv[3:])
    say(f'python {sys.version.split()[0]}, torch {torch.__version__}, '
        f'CUDA {torch.version.cuda}, cuda available: '
        f'{torch.cuda.is_available()}')
    if not torch.cuda.is_available():
        say('no CUDA device: chip_smoke needs an NVIDIA GPU')
        return 2
    card = card_line()
    say(f'phase 0: {card}')
    sys.path.insert(0, str(ROOT))
    from cales_torch import device as devmod
    from cales_torch.ops import build
    dev = devmod.resolve('cuda')
    t0 = time.perf_counter()
    build.build(verbose=True)
    build.load()
    say(f'phase 1: kernels built and loaded in {time.perf_counter() - t0:.1f} s '
        f'({build.BUILD_ROOT / build.source_hash()})')
    if sys.argv[1:] == ['--pencil-nccl']:
        # the pencil phase alone on four cards, a card a rank over NCCL
        require(torch.cuda.device_count() >= 4, '--pencil-nccl needs four '
                                                'cards')
        phase_pencil(dev, card, 'nccl')
        print(card_line(), flush=True)
        return 0
    rows = phase_kernels(dev, card)
    # the examples through the CLI, all at once: the channel LES, the duct
    # LES, the Taylor-Green vortex, the wall-modelled channel and duct, and
    # the x-walled examples at their own 64^3
    xwalled = ('mom_rk', 'fillps', 'correc_updatep', 'apply_y',
               'x-ghost column stacks')
    phase_clis(card, [
        ('phase 3', 'turbulent_channel_les', 5, LES_KERNELS),
        ('phase 3b', 'turbulent_duct_les', 5,
         ('mom_rk', 'fillps', 'correc_updatep', 'dsmag', 'y-walled')),
        ('phase 3c', 'taylor_green_vortex_3d', 3,
         ('mom_rk', 'fillps', 'correc_updatep')),
        ('phase 3d', 'turbulent_channel_wmles', 5,
         ('mom_rk', 'fillps', 'correc_smag', 'wallmodel',
          "'E' z-ghost recipe")),
        ('phase 3e', 'turbulent_duct_wmles', 5,
         ('mom_rk', 'fillps', 'correc_updatep', 'smag', 'wallmodel',
          'y-wall variant', 'lower y')),
        ('phase 3f', 'developing_channel', 5, (*xwalled, '(x-walled')),
        ('phase 3g', 'closed_box', 5, (*xwalled, '(x-y-walled')),
        ('phase 3h', 'lid_driven_cavity', 5, (*xwalled, '(x-y-walled')),
        ('phase 3i', 'developing_duct', 5, (*xwalled, '(x-y-walled'))])
    les = phase_les(dev, card)
    wmles, wm_steps = phase_wmles(dev, card)
    wmduct, wmduct_steps = phase_wmles_duct(dev, card)
    phase_dns(dev, card)
    dsm, les_imp, res_dsm = phase_dsmag(dev, card)
    dsm_2d = phase_dsmag_dit(dev, card)
    duct, cavity, res_duct, res_cav = phase_ywalls(dev, card)
    mixed = phase_mixed(dev, card, res_duct)
    two = phase_twopass(dev, card, {'channel': res_dsm, 'duct': res_duct,
                                    'cavity': res_cav})
    tgv = phase_tgv(dev, card)
    box_smag, box_dsmag, box_forced = phase_box_les(dev, card)
    tri3, dns3 = phase_triperiodic(dev, card)
    xdev, xcav = phase_xwalls(dev, card)
    xwm, ximp, xduct = phase_xles(dev, card)
    scal, scal_y, scal_x = phase_scalar(dev, card)
    phase_card_vs_cpu(dev)
    p10, mesh_les = run_mesh_ranks(card)
    mesh_launches, halo_rows = phase_sharded(dev, card, p10)
    rows.update(halo_rows)
    les_mesh, les_mesh_rows = phase_sharded_les(dev, card, mesh_les)
    rows.update(les_mesh_rows)
    pencil = phase_pencil(dev, card)
    # each kernel's launches on the main path that runs it: the dsmag
    # channel (5 steps), or the LES (31 steps) for correc_smag, or the
    # smag + impdiff_1d LES (5 steps) for smag, or the TGV by 'mat' (5
    # steps) for thomas_periodic, or dsmag_blow (5 steps) for the two-pass
    # kernels; the y-walled variants' on the duct (5 steps), the cavity's
    # dsmag on the cavity (5 steps), the two-pass ones' on the two-pass
    # duct and cavity of phase 7d (5 steps each); the full-3D
    # variants' on the triperiodic DNS with full-3D implicit diffusion (5
    # steps), thomas_z's on the channel DNS with it (5 steps)
    paths = {name: (dsm, 5, name) for name in KERNELS}
    paths['correc_smag'] = (les, 31, 'correc_smag')
    # the wall model and the 'E' recipe on the wall-modelled channel (phase
    # 4w; the wall model's launches there include the initial fill's and
    # the checks')
    paths['wallmodel'] = (wmles, wm_steps, 'wallmodel')
    paths['smag'] = (les_imp, 5, 'smag')
    paths['thomas_periodic'] = (tgv, 5, 'thomas_periodic')
    for row, (name, variant) in BIG_ROWS.items():
        # thomas_z at 512^3 (a 'mat' channel from nz >= 384) counts on its
        # kernel's path, the LES kernels on the TGV LES's, the others on
        # the TGV's
        paths[row] = (paths[name] if name == 'thomas_z'
                      else (box_smag, 5, name) if name == 'smag'
                      else (box_dsmag, 3, name) if name == 'dsmag'
                      else (tgv, 5, name))
    paths['dsmag_level1'] = (two['blow'], 5, 'dsmag_level1')
    paths['dsmag_level2'] = (two['blow'], 5, 'dsmag_level2')
    # apply_x and the slab variants on the y-slab mesh (rank 0,
    # MESH_STEPS steps)
    paths['apply_x'] = (mesh_launches, MESH_STEPS, 'apply_x')
    for row, name in HALO_ROWS.items():
        paths[row] = (mesh_launches, MESH_STEPS, name)
    # the channel classes' slab variants on their mesh phases (rank 0,
    # MESH_LES_STEPS steps; the wall model's launches there include the
    # initial fill's and the checks', dsmag's the initial nu_t's)
    for key, _, _, row, _, _ in MESH_CLASSES:
        if row is not None:
            paths[row] = (les_mesh[key], MESH_LES_STEPS, MESH_LES_ROWS[row])
    # the y-walled slab variants on the duct, cavity and smag duct mesh
    # phases (rank 0, the lower wall's slab, MESH_LES_STEPS steps; dsmag's
    # and smag's launches there include the initial nu_t's)
    for row, (name, _) in WALLED_SLAB_ROWS.items():
        paths[row] = (les_mesh[WALLED_SLAB_PHASE[row]], MESH_LES_STEPS, name)
    # the wall-modelled duct's and the box's slab modes on phases 10yw, 10t
    # and 10td and the later slab modes (rank 0, MESH_LES_STEPS steps,
    # MESH_SMALL_STEPS for the small-only classes; the wall model's
    # launches there include the initial fill's and the checks', dsmag's
    # and smag's the initial nu_t's)
    small_only = {key for key, *_ in MESH_SMALL_ONLY}
    for row, (name, key) in SLAB_MODE_ROWS.items():
        paths[row] = (les_mesh[key], MESH_SMALL_STEPS if key in small_only
                      else MESH_LES_STEPS, name)
    # the pencil mesh's x-halo variants on its phases (rank 0,
    # PENCIL_STEPS steps)
    for row, (name, key) in PENCIL_ROWS.items():
        paths[row] = (pencil[key], MESH_SMALL_STEPS
                      if key in PENCIL_SMALL_COUNTED else PENCIL_STEPS, name)
    # apply_y on the mixed route's real view: on the one-device duct by
    # 'fft' (phase 8f, 5 steps)
    for row, name in REAL_VIEW_ROWS.items():
        paths[row] = (mixed, 5, name)
    # the x-walled variants' on the developing channel (phase 11, 5 steps)
    # and the lid-driven cavity (phase 11b, 5 steps)
    variant_path = {'duct': duct, 'cavity': cavity, 'helmholtz3d': dns3,
                    'xdev': xdev, 'xbox': xcav}
    # the x-walled LES variants: on the developing WMLES (phase 12, 11
    # steps; the wall model's launches there include the initial fill's
    # and the checks'), the developing channel LES with impdiff_1d (12b)
    # and the developing duct LES (12c)
    x_les_path = {('mom_rk', 'xdev_s'): xwm, ('smag', 'xdev'): xwm,
                  ('wallmodel', 'xdev'): xwm, ('mom_rk', 'xdev_1d'): ximp,
                  ('mom_rk', 'xbox_s'): xduct, ('smag', 'xbox'): xduct,
                  # the scalar variants: on the channel LES with a scalar
                  # (phase 13, 11 steps), the duct (13y) and the developing
                  # channel (13x) with one, 3 steps each
                  ('mom_rk', 'les_sc'): scal, ('mom_rk', 'duct_sc'): scal_y,
                  ('mom_rk', 'xdev_sc'): scal_x}
    # the triperiodic LES's: the no-wall smag on the TGV LES (phase 14, 5
    # steps), dsmag's periodic-z mode on the TGV with 'dit' (14d, 3
    # steps) and its 2D filter on the dsmag channel (7e, 3 steps)
    box_path = {('smag', 'nowall'): (box_smag, 5),
                ('dsmag', 'zp'): (box_dsmag, 3),
                ('dsmag', 'f2d'): (dsm_2d, 3)}
    for row, (name, variant) in VARIANT_ROWS.items():
        if (name, variant) in box_path:
            run, nsteps = box_path[(name, variant)]
            paths[row] = (run, nsteps, name)
        elif (name, variant) in x_les_path:
            run, nsteps = x_les_path[(name, variant)]
            paths[row] = (run, nsteps, name)
        elif name in ('dsmag_level1', 'dsmag_level2'):
            # the two-pass duct and cavity of phase 7d
            paths[row] = (two[variant], 5, name)
        elif variant == 'wm':
            paths[row] = (wmles, wm_steps, name)
        elif name in ('smag', 'wallmodel'):
            # smag's y-wall variant and the four-face wall model on the
            # wall-modelled duct (phase 8w; the wall model's launches
            # there include the initial fill's and the checks')
            paths[row] = (wmduct, wmduct_steps, name)
        else:
            paths[row] = (variant_path.get(variant, tri3), 5, name)
    sources = {**{n: KERNELS[n] for n in KERNELS},
               **{row: KERNELS[n] for row, (n, _) in VARIANT_ROWS.items()},
               **{row: KERNELS[n] for row, (n, _) in BIG_ROWS.items()},
               **{row: KERNELS[n] for row, n in HALO_ROWS.items()},
               **{row: KERNELS[n] for row, n in MESH_LES_ROWS.items()},
               **{row: KERNELS[n] for row, (n, _) in WALLED_SLAB_ROWS.items()},
               **{row: KERNELS[n] for row, (n, _) in SLAB_MODE_ROWS.items()},
               **{row: KERNELS[n] for row, n in REAL_VIEW_ROWS.items()},
               **{row: KERNELS[n] for row, (n, _) in PENCIL_ROWS.items()}}
    report = {'kernels': [
        dict(name=row, route='cuda', source=sources[row][0],
             replaces=sources[row][1], launches=run[name],
             launches_per_step=run[name] / nsteps, **rows[row])
        for row, (run, nsteps, name) in paths.items()]}
    for k in report['kernels']:
        require(k['launches'] > 0, f'{k["name"]}: no launch on its main path')
    print(json.dumps(report), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
