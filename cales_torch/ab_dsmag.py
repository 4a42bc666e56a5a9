"""Kernels of another checkout against this one's, on the same card in one
process: are their outputs bitwise equal (or how far apart), and how long
does each take?  The kernels whose code moved: thomas_z (a column a warp
in shared memory) and smag (a z-march through shared memory, both y modes
filled as a plane is loaded), beside thomas_periodic and correc_smag,
whose column code and strain step they share; mom_rk (a z-march through
shared memory, its y modes filled as a plane is loaded) and
thomas_periodic (a column a warp in shared memory), dsmag_level1 (on the
one-pass dsmag's test filter, shared across the plane: dsmag_common.cuh's
separable passes), correc_smag (a z-march over corrected planes in shared
memory), the one-pass dsmag and dsmag_level2 (beside those shared stages),
z_eig, apply_y and apply_x (their float32 GEMM in gemm.cuh, 3xTF32 on the
tensor cores), the periodic and y-walled variants of fillps,
correc_updatep and smag (their y reads through common.cuh's y mode,
beside the slab's halo mode), and the wall model (one Newton solve a
thread, the warp's early exit).

    python -m cales_torch.ab_dsmag --baseline DIR [--ng 512x256x256]
                                   [--reps 10] [--cases wallmodel,...]

DIR holds another checkout (for example the parent commit unpacked by git
archive).  Its cales_torch is imported beside this one under another
name, so each checkout's wrappers drive its own library (built under
DIR/cales_torch/_build): the C interfaces may differ, the Python calls
compared here do not.  Both run on the same seeded random inputs: dsmag's
'channel' average without y walls, 'duct' and 'cavity' with them, and
each the other way ('channel y walls', 'duct periodic y', 'cavity
periodic y': the six instantiations of its z-walled class); z_eig
on random operators and eigenvalues with the singular lane (0, 0) at
lamz[0]; dsmag_level1, and dsmag_level2 'channel', without y walls and
with them ('duct' for dsmag_level2); apply_y with the x operator fused and
y only; apply_x on a slab of half the y rows
(plain, its output split in two x-column blocks, its input read from two
such blocks); mom_rk (with nu_t, the previous RHS and the bulk sums)
periodic, with y walls, on a slab with random halos, and with the
splits '1d' and 'xy+z'; thomas_periodic on the uniform periodic
second difference, pinned on the singular lane and with the alpha-scaled
Helmholtz rows; thomas_z on the uniform second difference with Neumann
ends, pinned on the singular lane ('thomas_z poisson'), with the
alpha-scaled rows, a shift, boundary planes and the tail row ('thomas_z
helmholtz') and with the lam alpha shift and the tail row ('thomas_z lam
alpha'); fillps and correc_updatep periodic and with y walls; smag
periodic and on a slab with random halos ('smag halo'); correc_smag
with z walls and the deferred forcing, by the 'D' recipes on both faces
and by mixed 'N' and 'D' ones ('correc_smag N'); and, in float32
only, at ng = (512, 512, 512): apply_y with the x operator, mom_rk
without nu_t (the Taylor-Green vortex's), thomas_periodic pinned and
thomas_z pinned; the wall model on both log-law z faces (bench.py's hwm
and visci) from the rows of a bulk flow (1 + u) corrected by pp
('wallmodel') and as they are ('wallmodel rows'), and on the four walls
of the duct WMLES example ('wallmodel duct'); mom_rk with x walls and
periodic y or y walls on random x stacks, without nu_t ('mom_rk x
walls', 'mom_rk x+y walls') and with it ('mom_rk x walls nu_t', 'mom_rk x
1d' with the '1d' split, 'mom_rk x+y walls nu_t'); smag with y walls on
random y-row stacks, distances and shear planes ('smag y walls');
dsmag's periodic-z mode, its 2D test filter and both ('dsmag zp', 'dsmag
f2d', 'dsmag zp f2d', the 'channel' sums); mom_rk on a slab with the '1d'
split ('mom_rk halo 1d'); dsmag's slab mode with periodic y on random
two-deep halos ('dsmag halo', the 'channel' sums); dsmag's slab of a
y-walled mesh (YW + YH,
'dsmag slab duct', 'dsmag slab cavity', 'dsmag slab channel'): this
checkout's kernel on two slabs of the field, the lower wall's and the
upper wall's (the lower of (ny/2 rounded down to 16) rows, so the
'channel' sums' 8-row groups and the tiles fall as on the whole field),
their y-row stacks the whole field's wall rows and their halos its rows,
the outputs joined along y, against the baseline's y-walled kernel on the
whole field; the wall model's slab variant with periodic y ('wallmodel
halo': the channel's z faces on the rows of the lower half of the field,
their y halos its rows, both checkouts' slab variant) and the y-walled
slab variant ('wallmodel slab duct': this checkout's on the lower and the
upper half of the field, the duct's z faces' rows each slab makes and
each y face on its owner, joined, against the baseline's four-face
kernel on the whole field); dsmag's periodic-z mode on a slab ('dsmag
slab zp': this checkout's ZP + YH on the two halves, |S| joined, against
the baseline's ZP on the whole field); mom_rk's scalar variant (the
scalar, its stacks and previous RHS random) periodic and with y walls
('mom_rk scal', 'mom_rk scal y walls'); and the slab modes of the
passive scalar, the two-pass dsmag and the 2D filter, each this
checkout's on the two slabs of the field (cut as 'dsmag slab duct''s;
their halos the field's rows, with y walls their y-row stacks the whole
field's wall rows on the owned sides), joined along y, against the
baseline's kernel on the whole field: 'mom_rk halo scal' (the scalar's
Y_HALO variant against the periodic one), 'dsmag_level1 halo' (YH) and
'dsmag_level1 slab' (YW + YH against the y-walled kernel), 'dsmag_level2
halo' (YH, its 'channel' partial sums joined) and 'dsmag_level2 slab duct'
(YW + YH), 'dsmag f2d halo' and 'dsmag zp f2d halo' (F2D + YH, with ZP
too; |S| and the 'channel' partial sums joined); and the slab modes of
full-3D implicit diffusion and of x walls on the mesh (SLAB_3D_X, cut and
joined as those, against the baseline's periodic-y kernel on the whole
field; 'fillps x walls', 'correc_updatep x walls' and 'smag x walls' the
x-walled variants of periodic y, both on the whole field): 'mom_rk halo
xy+z' and 'mom_rk halo scal xy+z' (Y_HALO with the
'xy+z' split, without and with the scalar), 'correc_updatep halo full3d'
(alpha L(pp) in 3-D on the halo), and on random x stacks of periodic y
'mom_rk halo x walls' (XW x Y_HALO, no nu_t), 'mom_rk halo x 1d' (with
nu_t and the '1d' split), 'fillps halo x walls', 'correc_updatep halo x
walls' (the slab's own stacks' rows) and 'smag halo x walls' (random x
walls' van Driest inputs; mom_rk's and smag's stacks with the rows -1 and
nyl); and the slab modes of x walls with y walls, of the scalar with x
walls and of the wall model with x walls (SLAB_XY, cut and joined as
those, against the baseline's whole-field kernel): 'mom_rk slab x+y
walls' and 'mom_rk slab x+y walls nu_t' (XW x Y_WALLS on a slab's y-row
stacks, without and with nu_t), 'fillps slab x+y walls', 'correc_updatep
slab x+y walls' and 'smag slab x+y walls' (random x stacks of nyc = ny +
2, a slab's its columns lo .. hi + 1: the wall rows on the side it owns,
the neighbour's rows elsewhere; smag with random y and x walls' van
Driest inputs), 'mom_rk halo scal x walls' (SCAL x XW x Y_HALO against
the whole field's SCAL x XW of periodic y) and 'wallmodel halo x walls'
(the developing WMLES's z faces with its 1/7-power inflow profile, each
slab's XW x YH mode with its y halos and its rows of the profile, against
the whole field's XW mode); and the x-halo modes of the pencil mesh
(PENCIL: this checkout's on the four pencils of dims (2, 2), their halos
the field's rows and columns, joined, against the baseline's whole-field
kernel): 'dsmag pencil' and 'dsmag pencil zp' (dsmag XH x YH, with ZP
too, against the periodic 'channel' and ZP modes: |S|) and 'mom_rk
pencil xy+z' (X_HALO x Y_HALO with nu_t and the 'xy+z' split against the
periodic 'xy+z'; its partial sums as per-plane totals), 'dsmag pencil
f2d' and 'dsmag pencil zp f2d' (F2D x XH x YH, with ZP too, against the
periodic F2D modes: |S|), 'dsmag_level1 pencil' (XH x YH against the
z-walled periodic kernel: its 16 fields), 'dsmag_level2 pencil' (XH x YH,
the filtered velocity's depth-1 halos, against the periodic 'channel'
sums: per-plane totals only) and 'mom_rk pencil scal' (SCAL x X_HALO x
Y_HALO with nu_t, explicit, against the periodic scalar variant); and the
y walls' x-halo modes (PENCIL_YW, the same four pencils, each with the
y-row stacks, y halos and x halos the step composes: the whole field's
wall rows on the sides a pencil's mesh row holds, at its columns and in
its x halos' rows -1, nyl - 1 and nyl, the field's rows elsewhere)
against the baseline's whole-field y-walled kernels: 'mom_rk pencil y
walls' (Y_WALLS x X_HALO with nu_t, explicit), 'mom_rk pencil scal y
walls' (its scalar variant), 'fillps pencil y walls', 'correc_updatep
pencil y walls', 'smag pencil y walls' (the y walls' van Driest) and
'dsmag pencil duct' and 'dsmag pencil cavity' (YW + YH x XH: |S| and the
'duct' sums per (z, y) row and x block of 32, or 'cavity''s nu_t).
Outputs are compared in float64 at (nx, ny, nz) = (72, 40, 48) and in
float32 at --ng (bitwise, and max|this - baseline| / max|baseline|, the
worst output); mom_rk's partial sums, whose parts differ (blocks of 256
cells, tiles of 8 x 32), as per-plane totals apart ('sums_rel'), and so
are those of 'dsmag_level2 pencil', which has no other output;
times are float32 at --ng, the mean of --reps calls after a warm-up (CUDA
events), taken in the order baseline, this, this, baseline; the wall
model's also as the device time of a CUDA graph of --reps calls ('graph
ms': its wrapper's host time exceeds the kernel's).  --cases runs only
the cases named.  Prints one JSON line.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import functools
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

from .ops import kernels as K
from .ops import solve_kernels as SK

# the x-halo modes of a pencil mesh: this checkout's on the four pencils of
# dims (2, 2), joined, against the baseline's whole-field kernel (_pencils)
PENCIL = ('dsmag pencil', 'dsmag pencil zp', 'mom_rk pencil xy+z',
          'dsmag_level1 pencil', 'dsmag_level2 pencil', 'dsmag pencil f2d',
          'dsmag pencil zp f2d', 'mom_rk pencil scal')
# the y walls' x-halo modes on the same four pencils against the
# baseline's whole-field y-walled kernels (_pencils_yw)
PENCIL_YW = ('mom_rk pencil y walls', 'mom_rk pencil scal y walls',
             'fillps pencil y walls', 'correc_updatep pencil y walls',
             'smag pencil y walls', 'dsmag pencil duct',
             'dsmag pencil cavity')
CASES = ('channel', 'duct', 'cavity', 'channel y walls', 'duct periodic y',
         'cavity periodic y', 'z_eig', 'dsmag_level1',
         'dsmag_level1 y walls', 'dsmag_level2', 'dsmag_level2 y walls',
         'apply_y x+y', 'apply_y y',
         'apply_x', 'apply_x split', 'apply_x chunked', 'apply_y x+y 512^3',
         'mom_rk', 'mom_rk y walls', 'mom_rk halo', 'mom_rk 1d',
         'mom_rk xy+z', 'mom_rk 512^3', 'thomas_periodic',
         'thomas_periodic helmholtz', 'thomas_periodic 512^3',
         'thomas_z helmholtz', 'thomas_z poisson', 'thomas_z lam alpha',
         'thomas_z 512^3', 'fillps', 'fillps y walls', 'correc_updatep',
         'correc_updatep y walls', 'smag', 'smag halo', 'correc_smag',
         'correc_smag N', 'wallmodel', 'wallmodel rows', 'wallmodel duct',
         'mom_rk x walls', 'mom_rk x+y walls', 'smag y walls',
         'mom_rk x walls nu_t', 'mom_rk x 1d', 'mom_rk x+y walls nu_t',
         'dsmag zp', 'dsmag f2d', 'dsmag zp f2d', 'mom_rk halo 1d',
         'dsmag halo', 'dsmag slab duct', 'dsmag slab cavity',
         'dsmag slab channel', 'wallmodel halo', 'wallmodel slab duct',
         'dsmag slab zp', 'mom_rk scal', 'mom_rk scal y walls',
         'mom_rk halo scal', 'dsmag_level1 halo', 'dsmag_level1 slab',
         'dsmag_level2 halo', 'dsmag_level2 slab duct', 'dsmag f2d halo',
         'dsmag zp f2d halo', *('fillps x walls', 'correc_updatep x walls',
                                'smag x walls', 'mom_rk halo xy+z',
                                'mom_rk halo scal xy+z',
                                'correc_updatep halo full3d',
                                'mom_rk halo x walls', 'mom_rk halo x 1d',
                                'fillps halo x walls',
                                'correc_updatep halo x walls',
                                'smag halo x walls'),
         *('mom_rk slab x+y walls', 'mom_rk slab x+y walls nu_t',
           'fillps slab x+y walls', 'correc_updatep slab x+y walls',
           'smag slab x+y walls', 'mom_rk halo scal x walls',
           'wallmodel halo x walls'),
         *PENCIL, *PENCIL_YW)
# the x-walled fillps, correc_updatep and smag with periodic y (both
# checkouts on the whole field), and the slab modes of full-3D implicit
# diffusion and of x walls on the mesh ('halo': this checkout's on two
# slabs, joined, against the baseline's whole-field kernel)
SLAB_3D_X = CASES[-18 - len(PENCIL) - len(PENCIL_YW):
                  -7 - len(PENCIL) - len(PENCIL_YW)]
# the slab modes of x walls with y walls, the scalar with x walls and the
# wall model with x walls on the mesh: this checkout's on two slabs,
# joined, against the baseline's whole-field kernel (_slab_xy)
SLAB_XY = CASES[-7 - len(PENCIL) - len(PENCIL_YW):
                -len(PENCIL) - len(PENCIL_YW)]
# the cases at their own shape, in float32 only
BIG = {'apply_y x+y 512^3': (512, 512, 512), 'mom_rk 512^3': (512, 512, 512),
       'thomas_periodic 512^3': (512, 512, 512),
       'thomas_z 512^3': (512, 512, 512)}
# the cases whose last two outputs are partial sums, compared as totals
# (by their first word), and those whose only outputs are such sums
SUMS = ('mom_rk',)
SUMS_ONLY = ('dsmag_level2 pencil',)
# the cases timed on the device by a CUDA graph too
GRAPH = ('wallmodel', 'wallmodel rows', 'wallmodel duct', 'wallmodel halo',
         'wallmodel halo x walls')


def _baseline(root: Path):
    """(kernels, solve_kernels) of the checkout at root, imported as the
    package cales_torch_baseline."""
    name = 'cales_torch_baseline'
    pkg = root / 'cales_torch'
    spec = importlib.util.spec_from_file_location(
        name, pkg / '__init__.py', submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return (importlib.import_module(f'{name}.ops.kernels'),
            importlib.import_module(f'{name}.ops.solve_kernels'))


def _inputs(ng, dtype, seed):
    nx, ny, nz = ng
    gen = torch.Generator(device='cuda').manual_seed(seed)

    def rnd(*shape):
        return 0.02 * torch.randn(shape, generator=gen, device='cuda',
                                  dtype=dtype)
    f = [rnd(nz, ny, nx) for _ in range(8)]
    e = [rnd(3, ny, nx) for _ in range(5)]
    ye = [(rnd(nz, 3, nx), rnd(3, 3, nx)) for _ in range(5)]
    alph2 = torch.full((nz,), 4.0, dtype=dtype, device='cuda')
    alph2[0] = alph2[-1] = 2.52
    dz = 1.0 + 0.1 * torch.rand(nz + 2, generator=gen, device='cuda',
                                dtype=dtype)
    nx_op = 0.1 * torch.randn((nx, nx), generator=gen, device='cuda',
                              dtype=dtype)
    ny_op = 0.1 * torch.randn((ny, ny), generator=gen, device='cuda',
                              dtype=dtype)
    prof = 1e-3 * (1.0 + torch.rand(nz, generator=gen, device='cuda',
                                    dtype=dtype))
    nearlo = (torch.arange(nz, device='cuda') < nz // 2).to(dtype)
    # z_eig: operators, and eigenvalues in [-4.1, -0.1] but the singular
    # lane lamz[0] + lamy[0] + lamx[0] = 0
    vz = [0.1 * torch.randn((nz, nz), generator=gen, device='cuda',
                            dtype=dtype) for _ in range(2)]
    lam = []
    for n in (nz, ny, nx):
        q = -(0.1 + 4.0 * torch.rand(n, generator=gen, device='cuda',
                                     dtype=dtype))
        q[0] = 0.0
        lam.append(q)
    tauw = [1e-2 * (1.0 + rnd(ny, nx)) for _ in range(2)]
    # apply_x: a slab of half the y rows, and the same as two x-column
    # blocks (the backward transpose's delivery)
    slab = f[0][:, :max(ny // 2, 1)].contiguous()
    blocks = slab.reshape(nz, slab.shape[1], 2, nx // 2).permute(
        2, 0, 1, 3).contiguous()
    fuv = torch.tensor([0.05, -0.02], dtype=dtype, device='cuda')
    yh = [(rnd(nz, 2, nx), rnd(3, 2, nx)) for _ in range(5)]
    # x stacks (cols, corners) of u, v, w, visct, p: periodic y (nyc = ny)
    # and with y walls (ny + 2); the y walls' distance, side and shear
    # planes
    xe = {n: [(rnd(nz, 3, n), rnd(3, 3, n)) for _ in range(5)]
          for n in (ny, ny + 2)}
    yc = (torch.arange(ny, device='cuda', dtype=dtype) + 0.5) / ny
    ywall = (torch.minimum(yc, 1.0 - yc), (yc <= 0.5).to(dtype),
             1e-2 * (1.0 + rnd(nz, nx)), 1e-2 * (1.0 + rnd(nz, nx)))
    d = dict(f=f, e=e, ye=ye, yh=yh, xe=xe, ywall=ywall, alph2=alph2,
             dz=dz, ny_op=ny_op,
             nx_op=nx_op, prof=prof, nearlo=nearlo, tauw=tauw, fuv=fuv,
             slab=slab, wm_u=1.0 + f[0],
             blocks=blocks, vz=vz, lam=lam, tri=_tri_inputs(ng, dtype),
             ds2=rnd(13, nz, ny, nx))
    # dsmag's two-deep halos, drawn last so the inputs above keep their
    # values
    d['yh2'] = [(rnd(nz, 4, nx), rnd(3, 4, nx)) for _ in range(3)]
    return d


def _tri_inputs(ng, dtype):
    """The periodic second difference on a uniform grid of 2 pi: rows a,
    b, c (float64) along z, and the same with Neumann ends (abc_n), the
    eigenvalues along y and x (lane (0, 0) singular) and the pin's
    tolerance; thomas_z's shift and boundary planes."""
    nx, ny, nz = ng
    h = (2 * torch.pi / nz) ** -2
    abc = tuple(torch.full((nz,), q * h, dtype=torch.float64, device='cuda')
                for q in (1.0, -2.0, 1.0))
    bn = abc[1].clone()
    bn[0] = bn[-1] = -h
    gen = torch.Generator(device='cuda').manual_seed(nz)
    bc = [torch.randn((ny, nx), generator=gen, device='cuda', dtype=dtype)
          for _ in range(2)]

    def eig(n):
        k = torch.arange(n, dtype=torch.float64, device='cuda')
        return -(2.0 - 2.0 * torch.cos(2 * torch.pi * k / n)) * (
            n / (2 * torch.pi)) ** 2
    lamy, lamx = eig(ny), eig(nx)
    tol = float(torch.finfo(dtype).eps * 4.0 * float(lamx.abs().max()
                                                     + lamy.abs().max()))
    return dict(abc=abc, abc_n=(abc[0], bn, abc[2]), lamy=lamy.to(dtype),
                lamx=lamx.to(dtype), tol=tol, bc=bc,
                shift=torch.tensor([0.0173], dtype=dtype, device='cuda'))


def _big_inputs(ng, dtype, seed, case):
    """What the case takes at ng: apply_y's field and operators, mom_rk's
    fields, edge stacks and spacings, or thomas_periodic's and thomas_z's
    field and rows."""
    nx, ny, nz = ng
    gen = torch.Generator(device='cuda').manual_seed(seed)

    def rnd(*shape, scale=0.02):
        return scale * torch.randn(shape, generator=gen, device='cuda',
                                   dtype=dtype)
    if case.startswith('mom_rk'):
        return dict(f=[rnd(nz, ny, nx) for _ in range(8)],
                    e=[rnd(3, ny, nx) for _ in range(5)],
                    dz=1.0 + 0.1 * torch.rand(nz + 2, generator=gen,
                                              device='cuda', dtype=dtype))
    if case.startswith('thomas'):
        return dict(f=[rnd(nz, ny, nx)], tri=_tri_inputs(ng, dtype))
    return dict(f=[rnd(nz, ny, nx)], ny_op=rnd(ny, ny, scale=0.1),
                nx_op=rnd(nx, nx, scale=0.1))


def _channel_wm(Km, nz):
    """The wall model on both z faces at bench.py's hwm and visci, as the
    checkout of kernels module Km builds it (wallmodel.channel_z_faces;
    a checkout from before it: ZWallModel of two ZFace records)."""
    wm = importlib.import_module(Km.__name__.rsplit('.', 2)[0]
                                 + '.wallmodel')
    if hasattr(wm, 'channel_z_faces'):
        return wm.channel_z_faces(nz)
    return wm.ZWallModel(faces=(
        wm.ZFace(0, wm.WM_LOG, 0, 1, 0.3, 1.0, 0.0, 0.0),
        wm.ZFace(1, wm.WM_LOG, nz - 1, nz - 2, 0.3, -1.0, 0.0, 0.0)),
        h=0.1, l1d=2.0, visc=1.0 / 125_000.0)


def _duct_wm(Km, ng):
    """The wall model on the four walls of the duct WMLES example at ng,
    as the checkout of kernels module Km builds it."""
    base = Km.__name__.rsplit('.', 2)[0]
    mod = {q: importlib.import_module(f'{base}.{q}')
           for q in ('config', 'grid', 'wallmodel')}
    bcs = dict(cbcvel=((('P', 'P', 'P'), ('D', 'D', 'D'),
                        ('D', 'D', 'D')),) * 2,
               cbcpre=(('P', 'N', 'N'),) * 2, cbcsgs=(('P', 'D', 'D'),) * 2)
    cfg = mod['config'].Config(ng=ng, l=(12.8, 2.0, 2.0), gtype=1, gr=0.0,
                               visci=20_000.0, sgstype='smag',
                               lwm=((0, 1, 1), (0, 1, 1)), hwm=0.1, **bcs)
    grid = mod['grid'].make_grid_from_config(cfg)
    wm = mod['wallmodel']
    return wm.wall_model(cfg, grid, wm.find_index_wm(cfg, grid))


def _slabs(f, e, ye, depth, call):
    """call(fields, edges, halos, stacks, own) on the lower and the upper
    slab of the whole-field inputs (the fields f with their edge stacks
    e; cut at ny/2 rounded down to 16 rows), their halos the field's rows
    depth deep, with y-row stacks ye (None for a field without one) their
    slab's y-row stacks (boundary.slab_ystack: the whole field's wall rows
    on the side each owns), else None; the outputs joined along y."""
    from .ops import boundary as bnd
    ny = f[0].shape[1]
    cut = ny // 2 // 16 * 16
    outs = []
    for lo, hi, own in ((0, cut, (True, False)), (cut, ny, (False, True))):
        q = [a[:, lo:hi].contiguous() for a in f]
        qe = [a[:, lo:hi].contiguous() for a in e]
        rows = [(lo + j) % ny for j in range(-depth, 0)] + [
            (hi + j) % ny for j in range(depth)]
        h = [(a[:, rows].contiguous(), b[:, rows].contiguous())
             for a, b in zip(f, e)]
        ys = None if ye is None else [
            None if y is None else bnd.slab_ystack(a, b, y, hh, own)
            for a, b, y, hh in zip(q, qe, ye, h)]
        outs.append(call(q, qe, h, ys, own))
    return tuple(None if a is None else torch.cat([a, b], dim=1)
                 for a, b in zip(*outs))


def _dsmag_slabs(f, e, ye, args, kw):
    """dsmag's slab mode with y walls on the lower and the upper wall's
    slabs of the whole-field inputs (f, e and the y-row stacks ye of u, v,
    w), the outputs joined along y."""
    return _slabs(f, e, ye, 2, lambda q, qe, h, ys, own: K.dsmag(
        *q, *qe, *args, ye=ys, yh=h, yown=own, **kw))


def _wm_slabs(u, v, w, wm):
    """This checkout's wall model on the lower and the upper half of the
    fields as slabs of a y-walled mesh (wallmodel.slab_wall_model, their
    z faces' y halos the field's rows), joined: each z face's bcu and bcv
    rows the lower slab makes (padded 0 .. ny/2) and the upper's past
    them, then each y face from its owner."""
    from . import wallmodel as wmod
    ny = u.shape[1]
    cut = ny // 2
    outs = {}
    for y0, nyl, own in ((0, cut, (True, False)),
                         (cut, ny - cut, (False, True))):
        wms = wmod.slab_wall_model(wm, y0, nyl, own)
        q = [a[:, y0:y0 + nyl].contiguous() for a in (u, v, w)]
        rows = wmod.sampled_rows(u, v, wms)
        yh = torch.stack([rows[:, (y0 - 1) % ny], rows[:, (y0 + nyl) % ny]],
                         dim=1)
        for f, p in zip(wms.faces, K.wm_planes(*q[:2], wms, w=q[2], yh=yh,
                                               yown=own)):
            outs.setdefault((f.d, f.ib), []).append(p)
    return tuple(torch.cat([p[0][:, :cut + 1], p[1][:, 1:]], dim=1)
                 if d == 2 else p[0] for (d, _), p in outs.items())


def _slab_3d_x(Km, d, case):
    """The cases of SLAB_3D_X: the baseline (Km not this checkout's K) on
    the whole field, periodic y ('xy+z' with and without the scalar,
    correc_updatep with full-3D alpha L(pp), the x-walled variants on the
    x stacks of periodic y); this checkout on the lower and the upper slab
    (cut as _slabs cuts), their halos the field's rows, the x stacks of
    mom_rk and smag the field's with the rows -1 and nyl (nyc = nyl + 2),
    fillps's and correc_updatep's the slab's rows, the outputs joined
    along y (mom_rk's partial sums as per-plane totals)."""
    f, e, dz = d['f'], d['e'], d['dz']
    ny = f[0].shape[1]
    xe = d['xe'][ny]
    xw = 'x walls' in case or case == 'mom_rk halo x 1d'
    # correc_updatep: full-3D alpha L(pp) on the halo, impdiff_1d's with x
    # walls
    sgs = case in ('mom_rk halo xy+z', 'mom_rk halo scal xy+z',
                   'mom_rk halo x 1d')
    split = ('xy+z' if 'xy+z' in case else '1d' if case.endswith('1d')
             else None)
    scal = 'scal' in case
    mom = (dz, dz, 0.01, -0.005, 5e-5, 40.0, 20.0, (0.1, 0.0, 0.0))
    xwall = (d['prof'][:1].expand(f[0].shape[2]).contiguous(),
             (torch.arange(f[0].shape[2], device='cuda')
              < f[0].shape[2] // 2).to(f[0].dtype),
             *(1e-2 * (1.0 + q.abs()) for q in (f[6][:, :, 0], f[7][:, :, 0])))

    def run(kern, q, qe, h, x, xq, tw, xw_planes):
        """One call: q, qe the fields and edges, h their halos (None on
        the whole field), x the x stacks with the rows -1 and nyl or the
        whole field's, xq the slab's own rows of them."""
        if case.startswith('mom_rk'):
            kw = dict(sums=(True, True), split=split)
            if h is not None:
                kw['yh'] = (*h[:3], h[3] if sgs else None, h[4],
                            *((h[5],) if scal else ()))
            if xw:
                kw['xe'] = (*x[:3], x[3] if sgs else None, x[4])
            if scal:
                kw.update(sca=q[5], scae=qe[5], rso=q[6], scal=(2e-4, 0.05))
            ruo = q[7:10] if scal else q[5:8]
            out = kern.mom_rk(q[0], q[1], q[2], q[3] if sgs else None, q[4],
                              qe[0], qe[1], qe[2], qe[3] if sgs else None,
                              qe[4], *ruo, *mom, **kw)
            return (*out[:6], *out[8:], out[6], out[7])
        if case.startswith('fillps'):
            return (kern.fillps(*q[:3], *qe[:3], dz, 100.0, 40.0, 20.0,
                                yh=None if h is None else h[1],
                                xu=xq[0]),)
        if case.startswith('correc_updatep'):
            full3d = not xw
            # pp (q[3]) with its edge stack qe[3] and halo h[3]
            return kern.correc_updatep(
                *q[:5], qe[2], qe[3], 0.01, 40.0, 20.0, dz, dz,
                alpha=-3e-4, impdiff=True, impdiff_1d=not full3d,
                yh=None if h is None else h[3],
                xpp=xq[3] if xw else None, xu=xq[0] if xw else None)
        return (kern.smag(*q[:3], *qe[:3], dz, dz, 40.0, 20.0, 5e-5,
                          d['prof'], d['prof'], d['nearlo'], *tw,
                          yh=None if h is None else h[:3], xe=x[:3],
                          xwall=(*xwall[:2], *xw_planes)),)
    # the fields: u, v, w, nu_t, p, the previous RHS (or the scalar, its
    # previous RHS and the velocity's), with their edge stacks (zeros for
    # the pointwise ones)
    zero = torch.zeros_like(e[0])
    if scal:
        F = [*f[:5], f[5], f[6], *f[5:8]]
        E = [*e[:5], e[3], zero, zero, zero, zero]
    else:
        F = [*f[:5], *f[5:8]]
        E = [*e[:5], zero, zero, zero]
    if Km is not K or 'halo' not in case:
        out = run(Km, F, E, None, xe, xe, d['tauw'], xwall[2:])
        return tuple(q.sum(dim=1) if m >= len(out) - 2 and
                     case.startswith('mom_rk') else q
                     for m, q in enumerate(out))
    cut = ny // 2 // 16 * 16
    outs = []
    for lo, hi in ((0, cut), (cut, ny)):
        q = [a[:, lo:hi].contiguous() for a in F]
        qe = [a[:, lo:hi].contiguous() for a in E]
        rows = [(lo - 1) % ny, hi % ny]
        h = [(a[:, rows].contiguous(), b[:, rows].contiguous())
             for a, b in zip(F, E)]
        ext = list(range(lo, hi))
        xx = [tuple(a[..., [rows[0], *ext, rows[1]]].contiguous()
                    for a in x) for x in xe]
        xq = [tuple(a[..., lo:hi].contiguous() for a in x) for x in xe]
        tw = [t[lo:hi].contiguous() for t in d['tauw']]
        xwp = [t[:, lo:hi].contiguous() for t in xwall[2:]]
        outs.append(run(K, q, qe, h, xx, xq, tw, xwp))
    out = [torch.cat([a, b], dim=1) for a, b in zip(*outs)]
    if case.startswith('mom_rk'):
        out[-2:] = [q.sum(dim=1) for q in out[-2:]]
    return tuple(out)


@functools.lru_cache(maxsize=8)
def _xwm(base, ng):
    """The developing WMLES's wall model at ng (the log law on both z
    walls, x walls with a 1/7-power inflow profile, periodic y) as the
    checkout whose package is `base` builds it, built once (no host work
    where a CUDA graph captures the calls): the whole field's, and with
    this checkout the lower and the upper half's slab models (their rows
    of the profile, timeloop._slab_planes)."""
    mod = {q: importlib.import_module(f'{base}.{q}')
           for q in ('config', 'grid', 'wallmodel', 'profile_step',
                     'ops.boundary')}
    cfg = mod['config'].Config(
        ng=ng, l=(6.4, 3.2, 2.0), gtype=6, gr=0.0, visci=50_000.0,
        sgstype='smag', lwm=((0, 0, 1), (0, 0, 1)), hwm=0.1,
        cbcvel=((('D', 'N', 'N'), ('P', 'P', 'P'), ('D', 'D', 'D')),
                (('N', 'N', 'N'), ('P', 'P', 'P'), ('D', 'D', 'D'))),
        cbcpre=(('N', 'P', 'N'), ('D', 'P', 'N')),
        cbcsgs=(('N', 'P', 'D'), ('N', 'P', 'D')))
    cfg = mod['profile_step'].power_law_inflow(cfg)
    grid = mod['grid'].make_grid_from_config(cfg)
    wm = mod['wallmodel']
    index = wm.find_index_wm(cfg, grid)
    bcs = tuple(mod['ops.boundary'].make_bc_values(
        ng, tuple(tuple(cfg.bcvel[ib][dd][iv] for ib in range(2))
                  for dd in range(3)), torch.float64)
        for iv in range(3))
    whole = wm.wall_model(cfg, grid, index, bcs)
    if base != K.__name__.rsplit('.', 2)[0]:
        return whole, ()
    from .timeloop import _slab_planes
    ny = ng[1]
    cut = ny // 2
    return whole, tuple(
        wm.wall_model(cfg, grid, index, tuple(
            _slab_planes(b, y0, nyl, ny) for b in bcs))
        for y0, nyl in ((0, cut), (cut, ny - cut)))


def _slab_xy(Km, d, case):
    """The cases of SLAB_XY: the baseline (Km not this checkout's K) on the
    whole field, this checkout on the lower and the upper slab (cut as
    _slabs cuts), joined along y: with x and y walls (the y-row stacks
    random, the slabs' by boundary.slab_ystack with the whole field's
    wall rows on the side each owns; the x stacks (nyc = ny + 2) random,
    a slab's its columns lo .. hi + 1: the whole field's wall rows on the
    owned side, the neighbour's rows elsewhere) mom_rk without and with
    nu_t, fillps, correc_updatep and smag with the y and x walls' van
    Driest inputs; mom_rk's scalar variant with x walls and periodic y
    (its halos the field's rows, the x stacks with the rows -1 and nyl);
    and the wall model of the developing WMLES (x walls, an inflow
    profile) on the rows as they are, the slabs' with their y halos and
    their rows of the profile (XW x YH), joined as _wm_slabs joins."""
    f, e, ye, dz = d['f'], d['e'], d['ye'], d['dz']
    nz, ny, nx = f[0].shape
    mom = (dz, dz, 0.01, -0.005, 5e-5, 40.0, 20.0, (0.1, 0.0, 0.0))
    tw = d['tauw']
    yplanes = d['ywall'][2:]
    xwall = (d['prof'][:1].expand(nx).contiguous(),
             (torch.arange(nx, device='cuda') < nx // 2).to(f[0].dtype),
             *(1e-2 * (1.0 + q.abs()) for q in (f[6][:, :, 0],
                                                f[7][:, :, 0])))
    if case == 'wallmodel halo x walls':
        whole, slabs = _xwm(Km.__name__.rsplit('.', 2)[0], (nx, ny, nz))
        u, v = d['wm_u'], f[1]
        if Km is not K:
            return tuple(Km.wm_planes(u, v, whole))
        from .wallmodel import sampled_rows
        cut = ny // 2
        outs = []
        rows = sampled_rows(u, v, whole)
        for (y0, nyl), slab in zip(((0, cut), (cut, ny - cut)), slabs):
            yh = torch.stack([rows[:, (y0 - 1) % ny],
                              rows[:, (y0 + nyl) % ny]], dim=1)
            outs.append(K.wm_planes(u[:, y0:y0 + nyl].contiguous(),
                                    v[:, y0:y0 + nyl].contiguous(), slab,
                                    yh=yh))
        return tuple(torch.cat([a[:, :cut + 1], b[:, 1:]], dim=1)
                     for a, b in zip(*outs))
    if case == 'mom_rk halo scal x walls':
        xe = d['xe'][ny]
        # the scalar f[5] with the edge stack e[3], its previous RHS f[6],
        # its x stack nu_t's (random all the same)
        kw = dict(sums=(True, True), scal=(2e-4, 0.05))
        if Km is not K:
            out = Km.mom_rk(*f[:5], *e[:5], *f[5:8], *mom,
                            xe=(*xe, xe[3]), sca=f[5], scae=e[3], rso=f[6],
                            **kw)
            return (*out[:6], *out[8:], out[6].sum(dim=1),
                    out[7].sum(dim=1))
        cut = ny // 2 // 16 * 16
        outs = []
        F = [*f[:5], f[5], f[6], *f[5:8]]
        E = [*e[:5], e[3]] + [torch.zeros_like(e[0])] * 4
        for lo, hi in ((0, cut), (cut, ny)):
            q = [a[:, lo:hi].contiguous() for a in F]
            qe = [a[:, lo:hi].contiguous() for a in E]
            rows = [(lo - 1) % ny, hi % ny]
            h = [(a[:, rows].contiguous(), b[:, rows].contiguous())
                 for a, b in zip(F[:6], E[:6])]
            idx = [rows[0], *range(lo, hi), rows[1]]
            xx = [tuple(a[..., idx].contiguous() for a in x)
                  for x in (*xe, xe[3])]
            out = K.mom_rk(*q[:5], *qe[:5], *q[7:10], *mom, yh=tuple(h),
                           xe=tuple(xx), sca=q[5], scae=qe[5], rso=q[6],
                           **kw)
            outs.append((*out[:6], *out[8:], out[6], out[7]))
        out = [torch.cat([a, b], dim=1) for a, b in zip(*outs)]
        out[-2:] = [q.sum(dim=1) for q in out[-2:]]
        return tuple(out)
    # x and y walls: the whole field's stacks, or a slab's
    xe = d['xe'][ny + 2]
    sgs = case.endswith('nu_t') or case.startswith('smag')

    def run(kern, q, qe, ys, x, lo, hi):
        if case.startswith('mom_rk'):
            return kern.mom_rk(
                q[0], q[1], q[2], q[3] if sgs else None, q[4], qe[0], qe[1],
                qe[2], qe[3] if sgs else None, qe[4], *q[5:8], *mom,
                sums=(True, True),
                ye=(*ys[:3], ys[3] if sgs else None, ys[4]),
                xe=(*x[:3], x[3] if sgs else None, x[4]))
        if case.startswith('fillps'):
            return (kern.fillps(*q[:3], *qe[:3], dz, 100.0, 40.0, 20.0,
                                yv=ys[1], xu=x[0]),)
        if case.startswith('correc_updatep'):
            # pp q[3], its y-row stack ys[3], its x stack x[3]
            return kern.correc_updatep(*q[:5], qe[2], qe[3], 0.01, 40.0,
                                       20.0, dz, dz, ypp=ys[3],
                                       yv=ys[1][0], xpp=x[3], xu=x[0])
        ywall = (d['ywall'][0][lo:hi].contiguous(),
                 d['ywall'][1][lo:hi].contiguous(), *yplanes)
        return (kern.smag(*q[:3], *qe[:3], dz, dz, 40.0, 20.0, 5e-5,
                          d['prof'], d['prof'], d['nearlo'],
                          *(t[lo:hi].contiguous() for t in tw), ye=ys[:3],
                          ywall=ywall, xe=x[:3],
                          xwall=(*xwall[:2], *(t[:, lo:hi].contiguous()
                                               for t in xwall[2:]))),)
    cut = ny // 2 // 16 * 16
    if Km is not K:
        out = list(run(Km, f, e, ye, xe, 0, ny))
    else:
        def slab(q, qe, h, ys, own):
            lo, hi = (0, cut) if own[0] else (cut, ny)
            x = [tuple(a[..., lo:hi + 2].contiguous() for a in xx)
                 for xx in xe]
            return run(K, q, qe, ys, x, lo, hi)
        out = list(_slabs(f, e, ye, 1, slab))
    if case.startswith('mom_rk'):
        # the partial sums (of the two slabs, joined) as per-plane totals
        out[6:8] = [q.sum(dim=1) for q in out[6:8]]
    return tuple(out)


def _pencils(Km, d, case):
    """The cases of PENCIL: the baseline on the whole field (the periodic
    'channel' dsmag, its ZP mode, with the 2D filter too; mom_rk with nu_t
    and the 'xy+z' split, and explicit with the scalar; dsmag_level1 with
    z walls; dsmag_level2's 'channel' sums), this checkout's XH x YH modes
    (X_HALO x Y_HALO for mom_rk) on the four pencils of a (2, 2) mesh (cut
    at ny/2 rounded down to 16 rows and nx/2 to 32 columns, so that the
    tiles fall as on the whole field), their halos the field's rows and
    columns (dsmag's and dsmag_level1's two deep, the x halos over the rows
    -2 .. nyl + 1; mom_rk's and dsmag_level2's one deep, the x halos in the
    x stacks' form, the scalar's the sixth), the outputs joined (dsmag's
    |S|; dsmag_level1's 16 fields; mom_rk's fields, the scalar and its RHS,
    and its partial sums as per-plane totals; dsmag_level2's sums as
    per-plane totals, which the tiles' other grouping keeps from being
    bitwise)."""
    f, e, dz = d['f'], d['e'], d['dz']
    nz, ny, nx = f[0].shape
    lv1 = case.startswith('dsmag_level1')
    lv2 = case.startswith('dsmag_level2')
    dsmag = case.startswith('dsmag ')
    scal = case.endswith('scal')
    zper = ' zp' in case
    f2d = case.endswith('f2d')
    mom = (dz, dz, 0.01, -0.005, 5e-5, 40.0, 20.0, (0.1, 0.0, 0.0))
    ds_args = (d['alph2'], dz, dz, 40.0, 20.0, not zper, not zper,
               (0.0, 0.02, 0.0, -0.01))
    zero = torch.zeros_like(e[0])
    # the fields (those with a halo first, nh of them) and their edge
    # stacks; the pointwise fields after them
    if dsmag or lv1:
        nh, F, E = 3, f[:3], e[:3]
    elif lv2:
        nh, F, E = 3, [*f[:3], *d['ds2']], [*e[:3], *[zero] * 13]
    elif scal:
        # u, v, w, nu_t, p, the scalar (f[5], e[3]); the previous RHS
        # f[5:8] and the scalar's f[6]
        nh, F, E = 6, [*f[:5], f[5], *f[5:8], f[6]], [*e[:5], e[3],
                                                       *[zero] * 4]
    else:
        nh, F, E = 5, f[:8], [*e[:5], zero, zero, zero]

    def call(km, q, qe, **kw):
        if dsmag:
            return km.dsmag(*q, *qe, *ds_args, avg='channel', zper=zper,
                            f2d=f2d, **kw)[:1]
        if lv1:
            fm, fvel, lij, s0 = km.dsmag_level1(*q, *qe, dz, dz, 40.0, 20.0,
                                                True, True, **kw)
            return (*fm, *fvel, *lij, s0)
        if lv2:
            out = km.dsmag_level2(*q[:3], *qe[:3], q[3:9], q[9:15], q[15],
                                  d['alph2'], dz, dz, 40.0, 20.0,
                                  avg='channel', **kw)
            return tuple(t.sum(dim=1) for t in out)
        if scal:
            kw = dict(kw, sca=q[5], scae=qe[5], rso=q[9], scal=(2e-4, 0.05))
            if 'yh' in kw:
                kw['yh'], kw['xh'] = kw['yh'][:6], kw['xh'][:6]
            out = km.mom_rk(*q[:5], *qe[:5], *q[6:9], *mom,
                            sums=(True, True), **kw)
            return (*out[:6], *out[8:], out[6].sum(dim=1),
                    out[7].sum(dim=1))
        out = km.mom_rk(*q[:5], *qe[:5], *q[5:8], *mom, sums=(True, True),
                        split='xy+z', **{k: v[:5] for k, v in kw.items()})
        return (*out[:6], out[6].sum(dim=1), out[7].sum(dim=1))
    if Km is not K:
        return call(Km, F, E)
    dep = 2 if dsmag or lv1 else 1
    cy, cx = ny // 2 // 16 * 16, nx // 2 // 32 * 32
    grid = []
    for y0, y1 in ((0, cy), (cy, ny)):
        row = []
        for x0, x1 in ((0, cx), (cx, nx)):
            ends = [(y0 + j) % ny for j in range(-dep, 0)] + [
                (y1 + j) % ny for j in range(dep)]
            ys = [j % ny for j in range(y0 - dep, y1 + dep)]
            cols = ([(x0 + j) % nx for j in range(-dep, 0)]
                    + ([x1 - 1] if dep == 1 else [])
                    + [(x1 + j) % nx for j in range(dep)])
            q = [a[:, y0:y1, x0:x1].contiguous() for a in F]
            qe = [a[:, y0:y1, x0:x1].contiguous() for a in E]
            yh = [(a[:, ends, x0:x1].contiguous(),
                   b[:, ends, x0:x1].contiguous())
                  for a, b in zip(F[:nh], E)]
            xh = [tuple(t[:, ys][:, :, cols].transpose(1, 2).contiguous()
                        for t in (a, b)) for a, b in zip(F[:nh], E)]
            row.append(call(K, q, qe, yh=yh, xh=xh))
        grid.append(row)
    # the pointwise outputs joined, the per-plane totals summed
    nf = 0 if lv2 else 1 if dsmag else 16 if lv1 else 8 if scal else 6
    out = [torch.cat([torch.cat([r[m] for r in row], dim=2)
                      for row in grid], dim=1) for m in range(nf)]
    return (*out, *(sum(r[m] for row in grid for r in row)
                    for m in range(nf, len(grid[0][0]))))


def walled_rows(a, y, rows):
    """The whole array a (n, ny, nx) at the global rows `rows` as the
    y-walled pencils see them: the y-row stack y's rows at -1, ny-1 and
    ny, the periodic wrap of a elsewhere."""
    ny = a.shape[1]
    at = {-1: 0, ny - 1: 1, ny: 2}
    return torch.stack([y[:, at[g]] if g in at else a[:, g % ny]
                        for g in rows], dim=1)


def cut_walled(q, e, y, ys, xs, depth=1):
    """The pencil (rows ys, columns xs) of a y-walled field q cut from the
    whole field as the step composes its inputs: its block, its edge
    stack's, its y-row stack pair (the wall rows on the walls it holds,
    the y halo's rows elsewhere, boundary.slab_ystack), its raw y halo
    pair (depth rows a side, the periodic wrap) and its x halo pair of
    depth 1 (cols (nz, 3, nyl + 2): columns -1, nxp - 1, nxp) or 2 (cols
    (nz, 4, nyl + 4): columns -2, -1, nxp, nxp + 1) over the padded rows,
    whose wall rows are the whole field's (timeloop._pencil_halos)."""
    ny, nx = q.shape[1], q.shape[2]
    (y0, y1), (x0, x1) = (ys.start, ys.stop), (xs.start, xs.stop)
    stack = tuple(walled_rows(a, w, [y0 - 1, y1 - 1, y1])[..., xs]
                  .contiguous() for a, w in zip((q, e), y))
    ends = [(y0 + j) % ny for j in range(-depth, 0)] + [
        (y1 + j) % ny for j in range(depth)]
    halo = tuple(a[:, ends, xs].contiguous() for a in (q, e))
    cols = ([(x0 + j) % nx for j in range(-depth, 0)]
            + ([x1 - 1] if depth == 1 else [])
            + [(x1 + j) % nx for j in range(depth)])
    prow = list(range(y0 - depth, y1 + depth))
    xh = tuple(walled_rows(a, w, prow)[..., cols].transpose(1, 2)
               .contiguous() for a, w in zip((q, e), y))
    return (q[:, ys, xs].contiguous(), e[:, ys, xs].contiguous(), stack,
            halo, xh)


def _pencils_yw(Km, d, case):
    """The cases of PENCIL_YW: the baseline's y-walled kernel on the whole
    field (the y-row stacks d['ye']; with the scalar its stack the fourth
    pair's), this checkout's Y_WALLS x X_HALO modes (dsmag's YW + YH x XH)
    on the four pencils of _pencils' cut, each with its y-row stacks (the
    whole field's rows -1, ny-1 and ny on the sides it holds, the field's
    rows elsewhere), its y halos (dsmag's two deep) and its x halos over
    its padded rows (the whole field's wall rows there), the outputs
    joined (mom_rk's partial sums as per-plane totals; dsmag's 'duct'
    sums per (z, y) row and x block of 32, whose blocks the cut keeps)."""
    f, e, ye, dz = d['f'], d['e'], d['ye'], d['dz']
    nz, ny, nx = f[0].shape
    kind = case.split()[0]
    scal = ' scal' in case
    avg = case.split()[-1]
    mom = (dz, dz, 0.01, -0.005, 5e-5, 40.0, 20.0, (0.1, 0.0, 0.0))
    ds_args = (d['alph2'], dz, dz, 40.0, 20.0, True, True,
               (0.0, 0.02, 0.0, -0.01))
    dwy, nearylo, tylo, tyhi = d['ywall']
    # the fields with a y-row stack (u, v, w, nu_t, p; pp is f[3] with p's
    # stack in correc_updatep; the scalar f[5] with nu_t's stack)
    if scal:
        nh, F, E, Y = 6, [*f[:5], f[5]], [*e[:5], e[3]], [*ye, ye[3]]
    elif kind == 'correc_updatep':
        nh, F, E, Y = 5, [f[0], f[1], f[2], f[3], f[4]], e[:5], \
            [ye[0], ye[1], ye[2], ye[4], ye[4]]
    else:
        nh, F, E, Y = 5, f[:5], e[:5], ye
    # a centred field's stack row 1 is its last row (v's, the second, its
    # rewrite slot), as a fill leaves it: the x halos' row nyl - 1 is the
    # field's own but v's

    def last_row(a, b, y):
        r, c = y[0].clone(), y[1].clone()
        r[:, 1], c[:, 1] = a[:, -1], b[:, -1]
        return r, c
    Y = [y if i == 1 else last_row(a, b, y)
         for i, (a, b, y) in enumerate(zip(F, E, Y))]

    def call(km, q, qe, ys, yh=None, xh=None, own=None, cut=None):
        ys_, xs_ = cut or (slice(None), slice(None))
        if kind == 'mom_rk':
            kw = dict(ye=tuple(ys), xh=None if xh is None else tuple(xh))
            if scal:
                kw.update(sca=q[5], scae=qe[5], rso=f[6][:, ys_, xs_]
                          .contiguous(), scal=(2e-4, 0.05))
            out = km.mom_rk(*q[:5], *qe[:5],
                            *(a[:, ys_, xs_].contiguous() for a in f[5:8]),
                            *mom, sums=(True, True), **kw)
            return (*out[:6], *out[8:], out[6].sum(dim=1),
                    out[7].sum(dim=1))
        if kind == 'fillps':
            return (km.fillps(*q[:3], *qe[:3], dz, 100.0, 40.0, 20.0,
                              yv=ys[1], xh=None if xh is None else xh[0]),)
        if kind == 'correc_updatep':
            return km.correc_updatep(*q[:5], qe[2], qe[3], 0.01, 40.0, 20.0,
                                     dz, dz, ypp=ys[3], yv=ys[1][0],
                                     xh=None if xh is None else xh[3])
        if kind == 'smag':
            return (km.smag(*q[:3], *qe[:3], dz, dz, 40.0, 20.0, 5e-5,
                            d['prof'], d['prof'], d['nearlo'],
                            *(t[ys_, xs_].contiguous() for t in d['tauw']),
                            ye=tuple(ys[:3]),
                            ywall=(dwy[ys_].contiguous(),
                                   nearylo[ys_].contiguous(),
                                   tylo[:, xs_].contiguous(),
                                   tyhi[:, xs_].contiguous()),
                            xh=None if xh is None else tuple(xh[:3])),)
        out = km.dsmag(*q[:3], *qe[:3], *ds_args, ye=tuple(ys[:3]),
                       yvals=(0.2, 0.0, -0.1, 0.3), avg=avg,
                       yh=None if yh is None else yh[:3], yown=own,
                       xh=None if xh is None else xh[:3])
        return out[:1] if avg == 'cavity' else out
    if Km is not K:
        return call(Km, F, E, Y[:nh])
    dep = 2 if kind == 'dsmag' else 1
    cy, cx = ny // 2 // 16 * 16, nx // 2 // 32 * 32
    grid = []
    for y0, y1 in ((0, cy), (cy, ny)):
        row = []
        for x0, x1 in ((0, cx), (cx, nx)):
            cut = [cut_walled(a, b, y, slice(y0, y1), slice(x0, x1), dep)
                   for a, b, y in zip(F, E, Y)]
            q, qe, ys, yh, xh = ([c[i] for c in cut] for i in range(5))
            row.append(call(K, q, qe, ys, yh, xh, (y0 == 0, y1 == ny),
                            (slice(y0, y1), slice(x0, x1))))
        grid.append(row)
    # the pointwise outputs (and dsmag's 'duct' sums) joined, the
    # per-plane totals summed
    nf = {'mom_rk': 8 if scal else 6}.get(kind, len(grid[0][0]))
    out = [torch.cat([torch.cat([r[m] for r in row], dim=2)
                      for row in grid], dim=1) for m in range(nf)]
    return (*out, *(sum(r[m] for row in grid for r in row)
                    for m in range(nf, len(grid[0][0]))))


def _call(mods, d, case):
    Km, SKm = mods
    if case in PENCIL:
        return _pencils(Km, d, case)
    if case in PENCIL_YW:
        return _pencils_yw(Km, d, case)
    if case in SLAB_3D_X:
        return _slab_3d_x(Km, d, case)
    if case in SLAB_XY:
        return _slab_xy(Km, d, case)
    if case.startswith('apply_y'):
        return (SKm.apply_y(d['f'][0], d['ny_op'],
                            d['nx_op'] if 'x+y' in case else None),)
    if case == 'wallmodel slab duct':
        f = d['f']
        nz, ny, nx = f[0].shape
        if Km is K:
            return _wm_slabs(d['wm_u'], f[1], f[2],
                             _duct_wm(Km, (nx, ny, nz)))
        return tuple(Km.wm_planes(d['wm_u'], f[1], _duct_wm(Km, (nx, ny, nz)),
                                  w=f[2]))
    if case == 'wallmodel halo':
        # the slab variant with periodic y on the lower half of the rows
        f = d['f']
        ny = f[1].shape[1]
        wm = _channel_wm(Km, f[1].shape[0])
        rows = torch.stack([q[r] for face in wm.faces
                            for q in (d['wm_u'], f[1])
                            for r in (face.r1, face.r2)])
        yh = torch.stack([rows[:, ny - 1], rows[:, ny // 2]], dim=1)
        q = [a[:, :ny // 2].contiguous() for a in (d['wm_u'], f[1])]
        return tuple(Km.wm_planes(*q, wm, yh=yh))
    if case == 'wallmodel duct':
        f = d['f']
        nz, ny, nx = f[0].shape
        return tuple(Km.wm_planes(d['wm_u'], f[1], _duct_wm(Km, (nx, ny, nz)),
                                  w=f[2]))
    if case.startswith('wallmodel'):
        f = d['f']
        kw = ({} if case == 'wallmodel rows' else
              dict(fuv=d['fuv'], pp=f[4], dtrk=0.01, dxi=40.0, dyi=20.0))
        return tuple(Km.wm_planes(d['wm_u'], f[1],
                                  _channel_wm(Km, f[1].shape[0]), **kw))
    if case.startswith('apply_x'):
        src = d['blocks'] if case == 'apply_x chunked' else d['slab']
        return (SKm.apply_x(src, d['nx_op'],
                            split=2 if case == 'apply_x split' else 1),)
    if case == 'z_eig':
        return (SKm.z_eig(d['f'][0], *d['vz'], *d['lam'], 1e-9),)
    if case.startswith('thomas_periodic'):
        t = d['tri']
        if case == 'thomas_periodic helmholtz':
            kw = dict(lamy=t['lamy'] * -0.043, lamx=t['lamx'] * -0.043,
                      alpha=-0.043)
        else:
            kw = dict(lamy=t['lamy'], lamx=t['lamx'], pin=True,
                      tol=t['tol'])
        return (SKm.thomas_periodic_z(d['f'][0], *t['abc'], **kw),)
    if case.startswith('thomas_z'):
        t, x = d['tri'], d['f'][0]
        if case == 'thomas_z helmholtz':
            kw = dict(alpha=-0.043, shift=t['shift'], bc_lo=t['bc'][0],
                      bc_hi=t['bc'][1], n_solve=x.shape[0] - 1)
        elif case == 'thomas_z lam alpha':
            kw = dict(lamy=t['lamy'] * -0.043, lamx=t['lamx'] * -0.043,
                      alpha=-0.043, n_solve=x.shape[0] - 1)
        else:
            kw = dict(lamy=t['lamy'], lamx=t['lamx'], pin=True,
                      tol=t['tol'])
        return (SKm.thomas_z(x, *t['abc_n'], **kw),)
    f, e, ye, dz = d['f'], d['e'], d.get('ye'), d['dz']
    walls = case.endswith('y walls')
    if case in ('dsmag_level1 halo', 'dsmag_level1 slab'):
        # the slab modes (this checkout, two slabs joined) against the
        # whole field's periodic or y-walled kernel (the baseline)
        walls = case.endswith('slab')
        args = (dz, dz, 40.0, 20.0, True, True)
        if Km is not K:
            fm, fvel, lij, s0 = Km.dsmag_level1(
                *f[:3], *e[:3], *args, ye=ye[:3] if walls else None)
            return (*fm, *fvel, *lij, s0)

        def level1(q, qe, h, ys, own):
            fm, fvel, lij, s0 = K.dsmag_level1(
                *q, *qe, *args, ye=ys, yh=h, yown=own if walls else None)
            return (*fm, *fvel, *lij, s0)
        return _slabs(f[:3], e[:3], ye[:3] if walls else None, 2, level1)
    if case in ('dsmag_level2 halo', 'dsmag_level2 slab duct'):
        q = d['ds2']
        walls = case.endswith('duct')
        args = (d['alph2'], dz, dz, 40.0, 20.0)
        avg = 'duct' if walls else 'channel'
        if Km is not K:
            return Km.dsmag_level2(*f[:3], *e[:3], q[0:6], q[6:12], q[12],
                                   *args, avg=avg,
                                   ye=ye[:3] if walls else None)

        def level2(qq, qe, h, ys, own):
            return K.dsmag_level2(
                *qq[:3], *qe[:3], qq[3:9], qq[9:15], qq[15], *args, avg=avg,
                ye=ys[:3] if walls else None, yh=None if walls else h[:3],
                yown=own if walls else None)
        # the per-cell inputs ride the cut as fields with a stack of zeros
        zero = torch.zeros_like(e[0])
        return _slabs([*f[:3], *q], [*e[:3], *[zero] * 13],
                      [*ye[:3], *[None] * 13] if walls else None, 1, level2)
    if case in ('dsmag f2d halo', 'dsmag zp f2d halo'):
        zper = case.startswith('dsmag zp')
        args = (d['alph2'], dz, dz, 40.0, 20.0, not zper, not zper,
                (0.0, 0.02, 0.0, -0.01))
        kw = dict(avg='channel', zper=zper, f2d=True)
        if Km is not K:
            return Km.dsmag(*f[:3], *e[:3], *args, **kw)
        return _slabs(f[:3], e[:3], None, 2, lambda q, qe, h, ys, own:
                      K.dsmag(*q, *qe, *args, yh=h, **kw))
    if case.startswith('mom_rk') and 'scal' in case:
        # the scalar variant: u, v, w, nu_t, p (f[0:5], e[0:5]), the
        # previous RHS f[5:8]; the scalar f[5] with the edge stack e[3],
        # its previous RHS f[6], with y walls its stack pair ye[3]
        mom = (dz, dz, 0.01, -0.005, 5e-5, 40.0, 20.0, (0.1, 0.0, 0.0))
        scal = (2e-4, 0.05)

        def outputs(out, sums):
            return (*out[:6], *out[8:], *sums(out[6]), *sums(out[7]))
        if case == 'mom_rk halo scal' and Km is K:
            def slab(q, qe, h, ys, own):
                return outputs(K.mom_rk(
                    *q[:5], *qe[:5], *q[6:9], *mom, sums=(True, True),
                    yh=tuple(h[:6]), sca=q[5], scae=qe[5], rso=q[9],
                    scal=scal), lambda t: (t,))
            # u, v, w, nu_t, p, the scalar, the previous RHS, the
            # scalar's
            zero = torch.zeros_like(e[0])
            out = _slabs([*f[:5], f[5], *f[5:8], f[6]],
                         [*e[:5], e[3], *[zero] * 4], None, 1, slab)
            return (*out[:8], out[8].sum(dim=1), out[9].sum(dim=1))
        walls = case.endswith('y walls')
        return outputs(Km.mom_rk(
            *f[:5], *e[:5], *f[5:8], *mom, sums=(True, True),
            ye=(*ye, ye[3]) if walls else None, sca=f[5], scae=e[3],
            rso=f[6], scal=scal), lambda t: (t.sum(dim=1),))
    if case.startswith('dsmag_level1'):
        fm, fvel, lij, s0 = Km.dsmag_level1(
            *f[:3], *e[:3], dz, dz, 40.0, 20.0, True, True,
            ye=ye[:3] if walls else None)
        return (*fm, *fvel, *lij, s0)
    if case.startswith('dsmag_level2'):
        q = d['ds2']
        return Km.dsmag_level2(*f[:3], *e[:3], q[0:6], q[6:12], q[12],
                               d['alph2'], dz, dz, 40.0, 20.0,
                               avg='duct' if walls else 'channel',
                               ye=ye[:3] if walls else None)
    if case.startswith(('mom_rk x walls', 'mom_rk x+y walls',
                        'mom_rk x 1d')):
        # x walls without nu_t (its x stack and visct absent), or with it
        # ('nu_t', and the '1d' split with periodic y)
        yw = case.startswith('mom_rk x+y walls')
        sgs = case.endswith(('nu_t', '1d'))
        ny = f[0].shape[1]
        xe = d['xe'][ny + 2 if yw else ny]
        s, se = (f[3], e[3]) if sgs else (None, None)
        out = Km.mom_rk(f[0], f[1], f[2], s, f[4], e[0], e[1], e[2], se,
                        e[4], *f[5:8], dz, dz, 0.01, -0.005, 5e-5, 40.0,
                        20.0, (0.1, 0.0, 0.0), sums=(True, True),
                        split='1d' if case == 'mom_rk x 1d' else None,
                        ye=(*ye[:3], ye[3] if sgs else None, ye[4]) if yw
                        else None,
                        xe=(*xe[:3], xe[3] if sgs else None, xe[4]))
        return (*out[:6], out[6].sum(dim=1), out[7].sum(dim=1))
    if case.startswith('mom_rk'):
        # 512^3: the Taylor-Green vortex's, no nu_t and explicit
        big = case == 'mom_rk 512^3'
        s, se = (None, None) if big else (f[3], e[3])
        out = Km.mom_rk(f[0], f[1], f[2], s, f[4], e[0], e[1], e[2], se,
                        e[4], *f[5:8], dz, dz, 0.01, -0.005, 5e-5, 40.0,
                        20.0, (0.1, 0.0, 0.0), sums=(True, True),
                        split={'mom_rk 1d': '1d', 'mom_rk halo 1d': '1d',
                               'mom_rk xy+z': 'xy+z'}.get(case),
                        ye=ye if walls else None,
                        yh=d['yh'] if case.startswith('mom_rk halo')
                        else None)
        return (*out[:6], out[6].sum(dim=1), out[7].sum(dim=1))
    if case.startswith('fillps'):
        return (Km.fillps(*f[:3], *e[:3], dz, 100.0, 40.0, 20.0,
                          yv=ye[1] if walls else None),)
    if case.startswith('correc_updatep'):
        return Km.correc_updatep(*f[:5], e[2], e[4], 0.01, 40.0, 20.0, dz,
                                 dz, ypp=ye[4] if walls else None,
                                 yv=ye[1][0] if walls else None)
    if case == 'smag y walls':
        return (Km.smag(*f[:3], *e[:3], dz, dz, 40.0, 20.0, 5e-5, d['prof'],
                        d['prof'], d['nearlo'], *d['tauw'], ye=ye[:3],
                        ywall=d['ywall']),)
    if case.startswith('smag'):
        return (Km.smag(*f[:3], *e[:3], dz, dz, 40.0, 20.0, 5e-5, d['prof'],
                        d['prof'], d['nearlo'], *d['tauw'],
                        yh=d['yh'][:3] if case == 'smag halo' else None),)
    if case.startswith('correc_smag'):
        # the z ghosts' recipes: 'D' on both faces of u and v (no-slip
        # walls), or 'N' and 'D' mixed, with spacings dr that round
        zrec = ((('D', 0.0, 0.07, 'D', 0.0, 0.09),) * 2 if case ==
                'correc_smag' else (('N', 0.3, 0.07, 'N', -0.2, 0.09),
                                    ('D', 0.1, 0.07, 'N', 0.05, 0.09)))
        return Km.correc_smag(*f[:5], *e[:4], 0.01, 40.0, 20.0, dz, dz,
                              5e-5, d['prof'], zrec, d['fuv'], d['prof'],
                              d['nearlo'], *d['tauw'])
    if case == 'dsmag halo':
        return Km.dsmag(*f[:3], *e[:3], d['alph2'], dz, dz, 40.0, 20.0, True,
                        True, (0.0, 0.02, 0.0, -0.01), avg='channel',
                        yh=d['yh2'])
    if case == 'dsmag slab zp':
        # the periodic-z mode on two slabs (this checkout) against the
        # whole field's (the baseline): |S|
        args = (d['alph2'], dz, dz, 40.0, 20.0, False, False,
                (0.0, 0.0, 0.0, 0.0))
        if Km is not K:
            return Km.dsmag(*f[:3], *e[:3], *args, avg='channel',
                            zper=True)[:1]
        ny = f[0].shape[1]
        cut = ny // 2 // 16 * 16
        out = []
        for lo, hi in ((0, cut), (cut, ny)):
            rows = [(lo - 2) % ny, (lo - 1) % ny, hi % ny, (hi + 1) % ny]
            q = [a[:, lo:hi].contiguous() for a in f[:3]]
            qe = [a[:, lo:hi].contiguous() for a in e[:3]]
            yh = [(a[:, rows].contiguous(), b[:, rows].contiguous())
                  for a, b in zip(f[:3], e[:3])]
            out.append(K.dsmag(*q, *qe, *args, avg='channel', zper=True,
                               yh=yh)[0])
        return (torch.cat(out, dim=1),)
    if case.startswith('dsmag slab'):
        # the slab mode with y walls (this checkout) against the whole
        # field's y-walled kernel (the baseline)
        args = (d['alph2'], dz, dz, 40.0, 20.0, True, True,
                (0.0, 0.02, 0.0, -0.01))
        kw = dict(yvals=(0.2, 0.0, -0.1, 0.3), avg=case.split()[-1])
        if Km is K:
            return _dsmag_slabs(f[:3], e[:3], ye[:3], args, kw)
        return Km.dsmag(*f[:3], *e[:3], *args, ye=ye[:3], **kw)
    if case.startswith('dsmag '):
        # the one-pass dsmag's modes, the 'channel' sums: periodic z (no
        # wall), the 2D test filter (z walls), both
        zper = 'zp' in case
        return Km.dsmag(*f[:3], *e[:3], d['alph2'], dz, dz, 40.0, 20.0,
                        not zper, not zper, (0.0, 0.02, 0.0, -0.01),
                        avg='channel', zper=zper, f2d='f2d' in case)
    # the one-pass dsmag: each average with y walls and without
    avg = case.split()[0]
    ywalls = case in ('duct', 'cavity', 'channel y walls')
    return Km.dsmag(*f[:3], *e[:3], d['alph2'], dz, dz, 40.0, 20.0, True,
                    True, (0.0, 0.02, 0.0, -0.01),
                    ye=ye[:3] if ywalls else None,
                    yvals=(0.2, 0.0, -0.1, 0.3), avg=avg)


def _rel(res):
    """The worst max|this - baseline| / max|baseline| over the outputs."""
    return max(float((a.double() - b.double()).abs().max()
                     / b.double().abs().max().clamp_min(1e-300))
               for a, b in zip(res['this'], res['baseline']))


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


def graph_ms(fn, reps):
    """Device time of one call of fn: reps calls captured in a CUDA
    graph, replayed between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main(argv=None):
    ap = argparse.ArgumentParser(prog='cales_torch.ab_dsmag')
    ap.add_argument('--baseline', required=True, type=Path)
    ap.add_argument('--ng', default='512x256x256')
    ap.add_argument('--reps', type=int, default=10)
    ap.add_argument('--cases', default=','.join(CASES))
    args = ap.parse_args(argv)
    cases = args.cases.split(',')
    unknown = set(cases) - set(CASES)
    if unknown:
        ap.error(f'unknown cases {sorted(unknown)}')
    if not torch.cuda.is_available():
        print('ab_dsmag needs a CUDA device', file=sys.stderr)
        return 2
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    mods = {'baseline': _baseline(args.baseline.resolve()),
            'this': (K, SK)}
    ng = tuple(int(x) for x in args.ng.lower().split('x'))
    out = dict(card=card, ng=ng, bitwise={}, rel={}, ms={})
    for dtype, shape in ((torch.float64, (72, 40, 48)),
                         (torch.float32, ng)):
        d = _inputs(shape, dtype, 20261016)
        for case in cases:
            if case in BIG and dtype == torch.float64:
                continue
            dc = (_big_inputs(BIG[case], dtype, 20261017, case)
                  if case in BIG else d)
            res = {name: [q for q in _call(m, dc, case) if q is not None]
                   for name, m in mods.items()}
            key = f'{case} {str(dtype)[6:]}'
            if case.split()[0] in SUMS or case in SUMS_ONLY:
                sums = {name: r[-2:] for name, r in res.items()}
                res = {name: r[:-2] for name, r in res.items()}
                out.setdefault('sums_rel', {})[key] = _rel(sums)
            if res['this']:
                out['bitwise'][key] = len(res['baseline']) == len(
                    res['this']) and all(
                    torch.equal(a, b)
                    for a, b in zip(res['baseline'], res['this']))
                out['rel'][key] = _rel(res)
            if dtype == torch.float32:
                times = {name: [] for name in mods}
                for name in ('baseline', 'this', 'this', 'baseline'):
                    times[name].append(_time_ms(
                        lambda: _call(mods[name], dc, case), args.reps))
                out['ms'][case] = times
                if case in GRAPH:
                    graph = {name: [] for name in mods}
                    for name in ('baseline', 'this', 'this', 'baseline'):
                        graph[name].append(graph_ms(
                            lambda: _call(mods[name], dc, case), args.reps))
                    out.setdefault('graph_ms', {})[case] = graph
            del res, dc
        del d
        torch.cuda.empty_cache()
    print(json.dumps({'ab_dsmag': out}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
