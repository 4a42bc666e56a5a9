"""Time integration: RK3 + pressure projection on one torch device.

Counterpart of cales_tpu/timeloop.py on its single-device kernel path for
the channel classes with periodic x/y and z walls (reference
rk.f90:17-121, main.f90:417-507): the LES with static or dynamic
Smagorinsky, and the DNS (sgstype 'none'), each with explicit, z-implicit
(impdiff_1d) or full-3D implicit diffusion; the triperiodic box (the
Taylor-Green vortex), explicit or implicit, as DNS or as LES with static
Smagorinsky (no wall: the smag kernel without van Driest, the fused
correction off as in cales_tpu) or dynamic Smagorinsky ('dit' or
'channel': the dsmag kernel's periodic-z mode), forced along x, y and z
(the bulk mean of w one reduction of the momentum kernel's output); and
for the y-walled classes, the square duct and the
spanwise-periodic cavity, with dynamic Smagorinsky ('duct', 'cavity',
'channel' or 'dit' averaging) or none, explicit diffusion.  The dynamic
model averages 'dit' (one dzf-weighted ratio for the volume) wherever it
runs, and takes the 2D test filter (filter_2d, the dsmag kernel's F2D
mode) with periodic y on the one-pass route.  z walls may transpire
(a uniform w through them).  The y-walled duct also runs static
Smagorinsky (the smag kernel's y-wall variant).  The channel's z walls,
and the duct's y and z walls, may carry the wall model (log-law or
laminar, cales_tpu's _wm_fast route) with static Smagorinsky and explicit
diffusion, or with sgstype 'none': its Neumann planes come from
kernels.wm_planes (csrc/wallmodel.cu, every modelled face in one launch)
once a substep, at the post-correction fill, whose edge stacks carry them
to the next substep's momentum kernel; with the channel's fused correction
its planes serve that fill.
One RK substep runs:
  1. kernels.mom_rk          momentum RHS + RK3 update (+ forcing partial
                             sums; with implicit diffusion the explicit/
                             implicit split, '1d' or 'xy+z', and the
                             Crank-Nicolson fold)
  2. bulk forcing from the partial sums (rk.f90:197-222 reordered);
     along z from the bulk mean of w
  3. implicit diffusion, per velocity component: impdiff_1d
     poisson.solve_z_only (the Thomas kernel; the forcing enters as its RHS
     shift), full-3D poisson.solve with alpha (the forcing added first;
     on a mesh poisson.solve_sharded with alpha)
  4. kernels.fillps          div(u)/dt_rk of the prediction
  5. poisson.solve           'fft': cuFFT x/y + z stage; 'mat': apply_y,
                             z_eig, thomas_z or (periodic z)
                             thomas_periodic, apply_y
  6. kernels.correc_smag     projection, p += pp and nu_t (smag, explicit
                             diffusion), or
     kernels.correc_updatep  projection, p += pp (+ alpha Lz(pp))
  7. the SGS stage on the post-correction fill, where 6 did not make nu_t:
     kernels.smag (smag with impdiff_1d, on the box, or with y walls on
     the 'E' ghost stacks, sgs.extrapolate_stacks), or kernels.dsmag
     (dsmag: |S| and partial num/den sums, then nu_t = max(|S| num/den, 0)
     with one ratio per z row ('channel'), per (z, y) row ('duct') or for
     the volume ('dit'); 'cavity' makes nu_t cell by cell in the kernel),
     or where the one pass cannot
     carry the BC values (transpiring z walls) the two passes
     kernels.dsmag_level1, the filtered velocity's fill, and
     kernels.dsmag_level2, with the same finish
with the z-edge stacks (ops/boundary.zedge_*) as the glue, and with y walls
the y-row stacks (ops/boundary.yedge_*) of the same three fills: the
carried post-correction fill for mom_rk (State.yq), the prediction fill
for fillps and correc_updatep (with pp's after the solve), the new
post-correction fill for smag and dsmag (and the filtered velocity's
static fill for dsmag_level2).  On a CUDA device the kernels are the
hand-written ones of cales_torch/csrc; on the CPU their plain PyTorch
twins.

On a y-slab mesh (dims = (gy, 1), parallel/mesh.SlabMesh) each rank steps
its slab, the counterpart of the JAX package's kernel-sharded route
(Simulation with _kernel_sharded and use_pallas_solve_sharded), for the
channel classes: sgstype 'none', static Smagorinsky (with the z walls'
wall model too) or the dynamic Smagorinsky ('channel', 'dit'; one pass
with the 3D or the 2D filter, or the two passes: transpiring z walls,
CALES_DSMAG_TWOPASS=1), explicit diffusion, impdiff_1d or full-3D
implicit diffusion; for the y-walled duct and cavity classes as one
device runs them (sgstype 'none', static Smagorinsky, the dynamic
Smagorinsky with any average by one or two passes, explicit diffusion;
the wall model on the y and z walls, the wall-modelled duct); for the
triperiodic box (sgstype 'none', static Smagorinsky, the one-pass dynamic
Smagorinsky in its periodic-z mode with either filter, explicit, z-only
or full-3D implicit diffusion, forced along z too); each with or without
the passive scalar; and for the x-walled classes as one device runs
them (the developing channel and its LES, the developing WMLES with its
inflow profile, the closed box, the lid-driven cavity and the developing
duct; sgstype 'none' or static Smagorinsky, explicit diffusion or with
periodic y impdiff_1d, a passive scalar, plane-valued values).  The
halos of the fields each stencil kernel reads at +-1 in y come from the
neighbours before it runs (mesh.halo_y; two rows deep for the velocity
tiles of dsmag and dsmag_level1, one row of the filtered velocity for
dsmag_level2; the scalar's rows ride the momentum kernel's exchange),
the Poisson solve is poisson.solve_sharded (apply_x, the pencil
transposes, apply_y, thomas_z or with periodic z thomas_periodic, pinned
on the rank that holds the singular lane), and so is each full-3D CN
solve (with alpha: no pin, w's tail row passed through; the CN planes
the slab's rows), the z-only CN solves run on each slab, the correction
and nu_t run as correc_updatep and smag or
dsmag (the fused correc_smag is off, as under the JAX mesh), the wall
model takes its sampled rows' y halos, and the bulk forcing (the
scalar's too), dsmag's z sums, the CFL dt and the divergence reduce over
the ranks.  The van
Driest wall-shear planes of the z walls stay on their slab (z is never
split) with the halo's row below.  With y walls every slab runs the y-walled kernel
variants on its own y-row stacks (boundary.slab_ystack): the wall recipe's
rows on the side a slab owns (rank 0 the lower wall, rank gy-1 the upper),
built there from its own rows with no communication, the halo rows
elsewhere (the JAX package's per-shard wall flags, _ywf_shard; the
scalar's from its own recipe); dsmag and dsmag_level1 take them with their
two-row halo (csrc/dsmag.cu, dsmag_level1.cu YW + YH), dsmag_level2 the
filtered velocity's (YW + YH), the y walls'
shear planes of smag's van Driest are made on their owners and summed
over the ranks (one all_reduce of two (nz, nx) planes a substep), the kept
v and w wall planes advance on the owners, and the pressure's y-face RHS
planes land on the owners' rows only (slab_rhs_planes).  With the wall
model a y face's planes are made on its owner from its own rows
(wallmodel.slab_wall_model; unsupported() refuses sampled rows off that
slab), the z faces' sampled rows take the y recipe on the sides a slab
owns and the neighbours' rows elsewhere (one exchange of those rows), the
owner's y-row stacks carry the planes (they are the fill's of
_dynamic_bcs), and smag's 'E' stacks extrapolate the slab's y-row stacks
on the walls it owns, y first, then z.  With x walls (periodic y) each
slab makes its x stacks from its own rows (the x recipes are pointwise
along y) and the neighbours' stacks' rows -1 and nyl ride the momentum
and SGS exchanges (the JAX package's y-sharded xe bundles), so mom_rk
and smag read the corners where the halo rows meet the x ghost columns
(their XW x Y_HALO variants); fillps and correc_updatep read the slab's
own stacks; the x walls' shear planes of van Driest take v's halo row,
and the kept inflow face advances on the slab's rows.  With x and y walls
a slab's x stacks carry the wall recipe's rows -1 and nyl (and v's
rewrite row) on the sides it owns and the neighbours' rows elsewhere
(boundary.xedge_* with yown, _xstacks_on_slab: the JAX package's xe
bundles with the corner section on the ye bundle), so the XW x Y_WALLS
variants run on the slab's y-row and x stacks; the scalar's x stack rides
the momentum exchange (mom_rk's SCAL x XW x Y_HALO with periodic y); the
z walls' wall model with x walls takes its sampled rows' halo rows and
applies the x recipe to them at their own rows' offsets (wallmodel.cu's
XW x YH mode); and plane-valued values (an inflow profile, a lid plane)
are cut to the slab's rows, their y ghosts the periodic wrap's
(_slab_planes).

On a 2D pencil mesh (dims = (gy, gx), gx > 1; the JAX package's
_gx_sharded route) each rank steps its pencil of y rows and x columns,
for the classes whose x and y sides are periodic, with z walls or
periodic z (the triperiodic box), with no wall model or plane values
(sgstype 'none', static Smagorinsky or the dynamic Smagorinsky 'channel'
or 'dit' by one pass, with the 3D or the 2D filter, or by two passes;
explicit diffusion, impdiff_1d or full-3D implicit diffusion; with or
without the passive scalar; 'mat' or 'fft'), and for the y-walled duct
and cavity classes (sgstype 'none', static Smagorinsky or the one-pass
dynamic Smagorinsky with any average, explicit, with or without the
passive scalar, 'mat' or the mixed 'fft' route; _pencil_refuse names the
rest): before each stencil kernel the x neighbours' columns of the
fields it reads arrive as x stacks (mesh.halo_x), whose rows -1 and nyl
ride the y exchange of the rows (_pencil_halos), so mom_rk (the
scalar's columns in the same exchange), fillps, correc_updatep and smag
run their x-halo variants (with the y halo variants, or periodic y with
gy = 1); dsmag and dsmag_level1 take two columns and two rows a side,
the corners by the same two hops (their XH modes), dsmag_level2 one of
the filtered velocity after its own fill, and the z rows' sums reduce
over all the ranks; the z walls' van Driest planes take u's column -1
from its x halo; the Poisson solve and full-3D
implicit diffusion's three Helmholtz solves re-slab
(poisson.solve_sharded), and the z-only CN solves run on the pencil's
columns.  With y walls the pencils of the mesh row iy = 0 hold the lower
wall and those of iy = gy - 1 the upper (yown): each pencil's y-row
stacks are the slab's (boundary.slab_ystack on its columns), its y-row
stacks of the fill ride the x exchange beside the fields (a stack has x
last, and the y recipes are pointwise along x), so the x halos' rows -1
and nyl on the walls the pencil holds are the x neighbours' wall rows and
v's row nyl - 1 there its rewrite (_xstacks_on_slab with walls; the JAX
package's _xe_wall_rows and _ystag_rw_gx): the kernels' Y_WALLS x X_HALO
variants read the (x ghost, y wall) corners from the x halos; the y
walls' van Driest shear planes are summed over the mesh column (the
pencils of one ix), the 'duct' average's sums over the mesh row (the
pencils of one iy), the y faces' pressure RHS planes are the owners' on
their columns, and the kept v and w wall planes advance on the owners'
columns.

With x walls (inflow and outflow faces, or walls: the developing channel,
and with y walls the closed box, the lid-driven cavity and the developing
duct; sgstype 'none' or static Smagorinsky, explicit diffusion or, with
periodic y, impdiff_1d; on one device and on the y-slab mesh as
above) mom_rk, fillps and correc_updatep take
the fields' x stacks (ops/boundary.xedge_*) of the same fills: the
post-correction fill's columns carried in State.xq (and nu_t's), the
prediction fill's u columns (u's set_bc rewrite, which the kernels read in
place of u's last column) and pp's; the kept inflow face vlo[0] advances
with the other kept planes.  smag runs in its x-wall variant on the
post-correction fill's x stacks, the inflow face (u 'D') a van Driest
wall.  With periodic y the z walls may carry the wall model (the
developing WMLES): its sampled rows take their x ghosts from the x faces'
values, its planes reach the x stacks' corners as plane-valued offsets,
and smag reads the 'E' stacks (sgs.extrapolate_stacks).  Plane-valued
static velocity values (an inflow profile on an x face, a moving lid on a
z face) ride the same offsets with periodic y (_planes_refuse), on one
device and on the mesh.

With a passive scalar (cfg.scalar; every route above) the
scalar advances in mom_rk's scalar stream (csrc/mom_rk.cu SCAL: its RHS
from the substep's velocity, explicit with alpha = visc/pr, and its RK3
update), its z-edge, y-row and x stacks from its own BC table, made by
recipes built once; with is_sforced its bulk forcing follows the kernel.
The velocity's bulk forcing stays deferred into the correction: the
scalar reads the substep's starting velocity, which already carries the
previous substep's forcing either way.

The port and the JAX package carry the same state (State below), so a
JAX state can be carried across (params.py).  Configurations outside this
slice raise NotImplementedError naming the missing piece.
"""
from __future__ import annotations

import os
from typing import Any, NamedTuple

import numpy as np
import torch

from .config import Config, RK_COEFF, C_SMAG, effective_cbcvel
from .grid import Grid

from . import device as devmod
from . import poisson
from . import sgs as sgsmod
from . import wallmodel as wmod
from .ops import boundary as bnd
from .ops import kernels
from .ops import stencil as st


# the staggering of u, v, w along (x, y, z): face ('f') or centre ('c')
_C_OR_F = (('f', 'c', 'c'), ('c', 'f', 'c'), ('c', 'c', 'f'))


class State(NamedTuple):
    u: Any
    v: Any
    w: Any
    p: Any
    visct: Any
    vlo: Any          # (u_lo, v_lo, w_lo) lower-wall normal-face planes
    rhs_old: Any      # (du, dv, dw) previous-substep explicit RHS
    time: float
    istep: int
    zq: Any = None    # (ue, ve, we) z-edge stacks of the post-correction
                      # fill, carried to the next substep's momentum kernel
    yq: Any = None    # with y walls, the same fill's (rows, corners) y-row
                      # stack pairs of (u, v, w), carried likewise
    xq: Any = None    # with x walls, the same fill's (cols, corners) x
                      # stack pairs of (u, v, w), carried likewise
    s: Any = None         # the passive scalar (scal.f90), None without
    dsdt_old: Any = None  # its previous-substep RHS (rk.f90:149-150)


def _periodic(cfg: Config, d: int) -> bool:
    return (all(cfg.cbc_vel(d, iv) == 'PP' for iv in range(3))
            and cfg.cbc_pre(d) == 'PP'
            and cfg.cbcsgs[0][d] + cfg.cbcsgs[1][d] == 'PP')


def _ywalls_refuse(cfg: Config) -> list[str]:
    """What this slice does not run with non-periodic y: y faces other than
    walls (velocity 'D', pressure 'N', SGS 'D' or 'N'), a wall-normal
    velocity through a y wall, and the models and routes with y walls
    that the duct and cavity classes do not use."""
    out = []
    if not (all(cfg.cbc_vel(1, iv) == 'DD' for iv in range(3))
            and cfg.cbc_pre(1) == 'NN'
            and all(cfg.cbcsgs[ib][1] in ('D', 'N') for ib in range(2))):
        out.append('non-periodic y other than walls (velocity D, pressure '
                   'N, SGS D or N on both y faces): ROADMAP queue 1, BC '
                   'topologies')
    elif any(np.ndim(cfg.bcvel[ib][1][1]) == 0
             and float(cfg.bcvel[ib][1][1]) != 0.0 for ib in range(2)):
        out.append('a non-zero v through a y wall: ROADMAP queue 1, BC '
                   'topologies')
    if cfg.sgstype == 'smag' and (cfg.impdiff
                                  or cfg.cbc_vel(2, 0)[0] == 'P'):
        out.append('static Smagorinsky with y walls runs with explicit '
                   'diffusion and z walls (smag with y walls beside impdiff '
                   'or periodic z): ROADMAP queue 1, impdiff with y walls, '
                   'BC topologies')
    if cfg.impdiff:
        kind = 'impdiff_1d' if cfg.impdiff_1d else \
            'full-3D implicit diffusion'
        out.append(f'{kind} with y walls (the duct and cavity classes run '
                   'explicit): ROADMAP queue 1, impdiff with y walls')
    if cfg.cbc_vel(2, 0)[0] == 'P':
        out.append('periodic z with y walls: ROADMAP queue 1, BC '
                   'topologies')
    return out


def _xwalls_refuse(cfg: Config) -> list[str]:
    """What this slice does not run with non-periodic x: it runs x faces
    of letters D and N for every field (walls, inflow, outflow) with
    sgstype 'none' or static Smagorinsky, explicit diffusion or (with
    periodic y) impdiff_1d, z walls, with periodic y or the y walls that
    _ywalls_refuse admits, on the all-matrix Poisson route (the
    developing channel, the closed box, the lid-driven cavity and the
    developing duct, and their LES); with periodic y also the wall model
    on the z walls (the developing WMLES) and plane-valued velocity values
    (an inflow profile, _planes_refuse).  On one device and on the y-slab
    mesh (_mesh_refuse)."""
    out = []
    item = 'ROADMAP queue 1, x walls'
    letters = ([cfg.cbc_vel(0, iv) for iv in range(3)]
               + [cfg.cbc_pre(0), cfg.cbcsgs[0][0] + cfg.cbcsgs[1][0]])
    if any('P' in q for q in letters):
        out.append('non-periodic x with a periodic x face on some field '
                   '(every field D or N on both x faces): ' + item)
    if cfg.sgstype == 'dsmag':
        out.append('non-periodic x with dynamic Smagorinsky (the x-walled '
                   "channel, box, cavity and duct run sgstype 'none' or "
                   'static Smagorinsky; the test filters need two-deep x '
                   'ghosts, x modes of the dsmag kernels; the JAX package '
                   f'runs XLA dsmag there): {item} with dsmag')
    if cfg.impdiff and not cfg.impdiff_1d:
        out.append('non-periodic x with full-3D implicit diffusion (an x '
                   f'operator a velocity component): {item} with full-3D '
                   'implicit diffusion')
    if (any(cfg.lwm[ib][d] != 0 for ib in range(2) for d in range(3))
            and not _periodic(cfg, 1)):
        out.append('non-periodic x with a wall model and y walls (the JAX '
                   f'kernel path refuses it too): {item} with a wall model '
                   'and y walls')
    if cfg.cbc_vel(2, 0)[0] == 'P':
        out.append(f'non-periodic x with periodic z: {item}, BC topologies')
    if cfg.ptransform == 'fft':
        out.append("non-periodic x with ptransform 'fft' (no FFT along a "
                   f"walled x; 'auto' takes 'mat'): {item}")
    if any(cfg.is_forced):
        out.append(f'non-periodic x with bulk forcing: {item}')
    return out


def unsupported(cfg: Config) -> list[str]:
    """What of `cfg` this slice does not run yet, each with the ROADMAP
    item that brings it; empty when the config is in the slice."""
    out = []
    cbc = effective_cbcvel(cfg)
    if any(cfg.lwm[ib][d] != 0 for ib in range(2) for d in range(3)):
        out += _wm_refuse(cfg)
    if cfg.sgstype == 'dsmag':
        out += sgsmod.dsmag_unsupported(cfg)
        out += _dsmag_kernel_refuses(cfg, cbc)
    if not _periodic(cfg, 0):
        out += _xwalls_refuse(cfg)
    if not _periodic(cfg, 1):
        out += _ywalls_refuse(cfg)
    if (cbc[0][2][0] == 'P' and cfg.sgstype != 'none'
            and not _periodic(cfg, 2)):
        out.append('an SGS model with a periodic z velocity and a '
                   'non-periodic z pressure or SGS fill: ROADMAP queue 1, '
                   'BC topologies')
    if cfg.is_forced[2] and not _periodic(cfg, 2):
        out.append('bulk forcing along z (is_forced(3)) with z walls (it '
                   'runs where z is periodic): ROADMAP queue 1, forcing '
                   'along z with z walls')
    if cfg.scalar:
        out += _scalar_refuse(cfg)
    if cfg.dims[0] * cfg.dims[1] > 1:
        out += _mesh_refuse(cfg)
    out += _planes_refuse(cfg)
    return out


def _scalar_refuse(cfg: Config) -> list[str]:
    """What this slice does not run with a passive scalar: it runs the
    scalar on every route the velocity runs, on one device and on the
    y-slab mesh (_mesh_refuse says which), any of the letters D, N, P on
    its z faces, and on its x and y faces where the velocity has walls
    there (its ghosts ride the x and y stacks; cales_tpu's own gate,
    timeloop.py:266-273)."""
    out = []
    for d, name in ((0, 'x'), (1, 'y')):
        if _periodic(cfg, d) and any(cfg.cbcscal[ib][d] != 'P'
                                     for ib in range(2)):
            out.append(f'a non-periodic scalar along {name}, where the '
                       'velocity is periodic (no stack carries its '
                       f'{name} ghosts): ROADMAP queue 1, BC topologies')
    return out


def plane_faces(cfg: Config) -> list[tuple[int, int]]:
    """The (side, direction) faces where some velocity BC value is a
    plane."""
    return [(ib, d) for ib in range(2) for d in range(3)
            if any(np.ndim(cfg.bcvel[ib][d][iv]) != 0 for iv in range(3))]


def _planes_refuse(cfg: Config) -> list[str]:
    """What this slice does not run with plane-valued BC values: it runs
    static plane-valued velocity values on the x faces (an inflow profile,
    with x walls) and the z faces (a moving lid, the wall model's
    Neumann planes' path) with periodic y, sgstype 'none' or static
    Smagorinsky, explicit diffusion, off the wall-modelled faces, on one
    device and on the y-slab mesh (each slab its rows of the planes,
    _slab_planes); they ride the edge and x stacks' recipes as
    offsets."""
    item = 'ROADMAP queue 1, BC topologies'
    out = []
    if any(np.ndim(b[ib][d]) != 0 for b in (cfg.bcpre, cfg.bcsgs)
           for ib in range(2) for d in range(3)):
        out.append(f'plane-valued pressure or SGS BC values: {item}')
    faces = plane_faces(cfg)
    if not faces:
        return out
    if not _periodic(cfg, 1):
        out.append('plane-valued values with y walls (the x and y stacks\' '
                   f'corners take scalars): {item}, plane-valued values '
                   'with y walls')
    elif any(d == 1 for _, d in faces):
        out.append(f'plane-valued values on the periodic y faces: {item}')
    if cfg.sgstype == 'dsmag':
        out.append('plane-valued velocity values with dynamic Smagorinsky: '
                   f'{item}, plane-valued values with dsmag')
    if cfg.impdiff:
        out.append('plane-valued velocity values with implicit diffusion '
                   f'(the CN stage\'s boundary planes): {item}, '
                   'plane-valued values with implicit diffusion')
    zplanes = [np.asarray(cfg.bcvel[ib][2][iv]) for ib in range(2)
               for iv in range(3) if np.ndim(cfg.bcvel[ib][2][iv]) != 0]
    if _periodic(cfg, 1) and not all(
            np.array_equal(q[0], q[-2]) and np.array_equal(q[-1], q[1])
            for q in zplanes):
        out.append('a z-face plane whose y ghost rows are not the periodic '
                   'copies of its rows ny and 1 (the stacks wrap along y): '
                   f'{item}')
    if any(np.ndim(cfg.bcvel[ib][2][2]) != 0 for ib in range(2)):
        out.append('a plane-valued w on the z faces (the kept lower face\'s '
                   f'ghosts are the plane\'s own): {item}')
    if any(cfg.lwm[ib][d] != 0 for ib, d in faces):
        out.append('plane-valued velocity values on a wall-modelled face '
                   f'(its static wall velocity is a scalar): {item}')
    return out


def _wm_refuse(cfg: Config) -> list[str]:
    """What this slice does not run with a wall model: it runs the log-law
    or laminar model on the y and z walls with static Smagorinsky and
    explicit diffusion, or with sgstype 'none' (cales_tpu's _wm_fast
    route; x walls are checked by _xwalls_refuse, plane-valued values by
    _planes_refuse, the y walls by _ywalls_refuse, a mesh by _mesh_refuse:
    the y and z faces run on the y-slab mesh)."""
    out = []
    lwm = [cfg.lwm[ib][d] for ib in range(2) for d in range(3)]
    if any(m not in (0, wmod.WM_LOG, wmod.WM_LAM) for m in lwm):
        out.append(f'wall model type lwm = {cfg.lwm} (1 log-law, -1 '
                   'laminar)')
    if any(cfg.lwm[ib][0] != 0 for ib in range(2)):
        out.append('a wall model on x faces: ROADMAP queue 1, x walls with '
                   'a wall model on the x faces')
    for d, name in ((1, 'y'), (2, 'z')):
        if any(cfg.lwm[ib][d] != 0 and cfg.cbcvel[ib][d][d] != 'D'
               for ib in range(2)):
            out.append(f'a wall model on {name} faces that are not walls '
                       '(lwm on a face whose normal velocity is not D; '
                       'sanity.f90:221-230)')
    if cfg.sgstype == 'dsmag':
        out.append('a wall model with dynamic Smagorinsky (the JAX kernel '
                   'path refuses it too): ROADMAP queue 1, wall model with '
                   'dsmag')
    if cfg.impdiff:
        out.append('a wall model with implicit diffusion (the CN stage\'s '
                   'boundary planes would change every substep): ROADMAP '
                   'queue 1, wall model with implicit diffusion')
    return out


def _mesh_refuse(cfg: Config) -> list[str]:
    """What this slice does not run on a device mesh (dims): the y-slab
    mesh dims = (gy, 1) runs, on the all-matrix Poisson route and (with
    periodic x) on the 'fft' route ('fft' with y walls: the mixed route,
    the y DCT matrix on the rfft's lanes), the channel
    classes with periodic x and y: sgstype 'none', static Smagorinsky (the
    z walls may carry the wall model) or the dynamic Smagorinsky
    ('channel' or 'dit', one pass with the 3D or the 2D filter, or two
    passes: transpiring z walls, CALES_DSMAG_TWOPASS=1), explicit
    diffusion, impdiff_1d or full-3D implicit diffusion (a sharded
    Helmholtz solve a component); with the y walls _ywalls_refuse admits
    (the duct and cavity classes) what one device runs there, on slabs of
    at least 2 rows, the wall model on the y and z faces too (the
    wall-modelled duct) where each y face's sampled rows lie on its
    owner's slab; with periodic z (the triperiodic box) sgstype 'none',
    static Smagorinsky or the one-pass dynamic Smagorinsky (the 3D or 2D
    filter), each diffusion; and with x walls and periodic y (the
    developing channel and its LES), and with x and y walls (the closed
    box, the lid-driven cavity and the developing duct), what one device
    runs there: sgstype 'none' or static Smagorinsky, explicit diffusion or
    with periodic y impdiff_1d, with periodic y the z walls' wall model
    (the developing WMLES) and plane-valued values (an inflow profile).
    The passive scalar and plane-valued values run on each of these
    routes as one device runs them.  A 2D pencil mesh (gx > 1) runs what
    _pencil_refuse admits."""
    gy, gx = int(cfg.dims[0]), int(cfg.dims[1])
    nx, ny, _ = cfg.ng
    out = []
    if gx > 1:
        out += _pencil_refuse(cfg)
    elif ny % gy or nx % gy:
        out.append(f'dims = ({gy}, {gx}) with ny = {ny}, nx = {nx} not '
                   f'divisible by gy')
    if cfg.sgstype == 'dsmag':
        if ny % gy == 0 and ny // gy < 2:
            out.append(f'dims = ({gy}, {gx}) with dsmag: slabs of {ny // gy} '
                       "y row(s), thinner than the dsmag kernel's two-row y "
                       'halo (a rank two away is not reached)')
    if not _periodic(cfg, 1):
        if gx == 1 and ny % gy == 0 and ny // gy < 2:
            out.append(f'dims = ({gy}, {gx}) with y walls: slabs of '
                       f'{ny // gy} y row, thinner than a wall-owning slab '
                       "reads (v's upper-wall recipe takes row nyl-2; the "
                       "dsmag kernel's y-wall mode extrapolates A and the "
                       'velocity from the two rows next to the wall): at '
                       'least 2')
        out += _wm_slab_refuse(cfg, gy)
    return out


def _pencil_refuse(cfg: Config) -> list[str]:
    """What a pencil mesh (dims = (gy, gx), gx > 1) does not run yet: it
    runs the classes whose x and y sides are periodic, with z walls or
    periodic z (the triperiodic box), sgstype 'none', static Smagorinsky
    or the dynamic Smagorinsky ('channel' or 'dit'; one pass with the 3D
    or the 2D filter, dsmag.cu's two-deep x halo mode with F2D, or two
    passes where a face value or CALES_DSMAG_TWOPASS=1 asks for them,
    dsmag_level1's two-deep and dsmag_level2's depth-1 x halo modes),
    explicit diffusion, impdiff_1d or full-3D implicit diffusion (the
    Helmholtz solves through the re-slab), with or without the passive
    scalar (mom_rk's scalar x halo mode), by 'mat' or 'fft'; and with y
    walls the duct and cavity classes _ywalls_refuse admits, explicit,
    sgstype 'none', static Smagorinsky or the one-pass dynamic
    Smagorinsky with any average (the Y_WALLS x X_HALO variants,
    dsmag.cu's YW + YH x XH), with or without the scalar, by
    'mat' or the mixed 'fft' route, on pencils of at least 2 rows; on ny
    and nx divisible by gy gx (the Poisson solve's re-slab); every other
    configuration names its item of ROADMAP queue 1, multi-device."""
    gy, gx = int(cfg.dims[0]), int(cfg.dims[1])
    nx, ny, _ = cfg.ng
    item = 'ROADMAP queue 1, multi-device'
    what = []
    ywalled = not _periodic(cfg, 1)
    if ywalled:
        if dsmag_twopass(cfg):
            what.append('the two-pass dynamic Smagorinsky with y walls '
                        "(dsmag_level1's and dsmag_level2's y-walled x-halo "
                        'modes; the two passes on y-walled pencils)')
        if ny % gy == 0 and ny // gy < 2:
            what.append(f'y walls on pencils of {ny // gy} y row (a '
                        "wall-owning pencil reads its two rows next to the "
                        'wall): at least 2')
    if not _periodic(cfg, 0):
        what.append('x walls (run-time x-wall owner flags)')
    if cfg.sgstype == 'dsmag':
        if not ywalled and cfg.dsmag_avg not in ('channel', 'dit'):
            what.append(f'the {cfg.dsmag_avg!r} dsmag average')
        if nx % gx == 0 and nx // gx < 2:
            kind = ('the two-pass dynamic Smagorinsky' if dsmag_twopass(cfg)
                    else 'dynamic Smagorinsky')
            what.append(f'{kind} on pencils of {nx // gx} x column(s), '
                        "thinner than the dsmag kernel's two-column x halo "
                        '(a rank two away is not reached)')
    if any(cfg.lwm[ib][d] != 0 for ib in range(2) for d in range(3)):
        what.append("the wall model (wallmodel.cu's x halo)")
    if plane_faces(cfg) or any(
            np.ndim(b[ib][d]) != 0 for b in (cfg.bcpre, cfg.bcsgs)
            for ib in range(2) for d in range(3)):
        what.append('plane-valued values')
    out = [f'{q} on a pencil mesh (dims = ({gy}, {gx}), gx > 1): {item}'
           for q in what]
    if ny % (gy * gx) or nx % (gy * gx):
        out.append(f'dims = ({gy}, {gx}) with ny = {ny}, nx = {nx} not '
                   f'divisible by gy gx = {gy * gx} (the Poisson solve\'s '
                   f're-slab on a pencil mesh, gx > 1): {item}')
    return out


def _wm_slab_refuse(cfg: Config, gy: int) -> list[str]:
    """A y face's wall model runs on the slab that owns the wall, from its
    own rows: refused where its sampled rows r1, r2 (wallmodel
    find_index_wm) leave that slab (r2 >= nyl rows from the wall)."""
    nyl = cfg.ng[1] // gy
    out = []
    for ib, side in ((0, 'lower'), (1, 'upper')):
        if cfg.lwm[ib][1] == 0 or cfg.ng[1] % gy:
            continue
        try:
            r2 = wmod.y_index_wm(cfg, ib) - 1
        except ValueError:
            continue        # hwm off the grid: the Simulation says so
        depth = r2 if ib == 0 else cfg.ng[1] - 1 - r2
        if depth >= nyl:
            out.append(f'a sampled y row off its owning slab: the {side} '
                       "y wall's wall model on a device mesh of dims = "
                       f'({gy}, 1) samples row {r2}, {depth} rows from the '
                       f'wall, on slabs of {nyl} rows (y walls under a '
                       'device mesh model each y face on the slab that '
                       'owns it): ROADMAP queue 1, multi-device, the y '
                       "faces' wall model off the wall's slab")
    return out


def _dsmag_kernel_refuses(cfg: Config, cbc) -> list[str]:
    """The limits of the dsmag kernels' ghost recipes, which are those of
    cales_tpu's (pallas_dsmag.eligible face_ok): each z face, and each y
    face with y walls, a wall (Dirichlet normal velocity) or a
    homogeneous-Neumann fill with zero values, or z periodic (the one-pass
    kernel's periodic-z mode; the JAX package runs its XLA model there);
    the 2D test filter by the one pass only."""
    out = []
    faces = ((() if _periodic(cfg, 2) else ((2, 'z'),))
             + (() if _periodic(cfg, 1) else ((1, 'y'),)))
    for d, face in faces:
        for ib in range(2):
            if cbc[ib][d][d] == 'D':
                continue
            ok = (cfg.cbcsgs[ib][d] == 'N'
                  and float(cfg.bcsgs[ib][d]) == 0.0
                  and all(cfg.cbcvel[ib][d][iv] == ('D' if iv == d else 'N')
                          and float(cfg.bcvel[ib][d][iv]) == 0.0
                          for iv in range(3)))
            if not ok:
                out.append(f'dsmag with a {face} face that is neither a '
                           'wall nor a homogeneous-Neumann fill: ROADMAP '
                           'queue 1, dsmag classes')
    if ((_periodic(cfg, 2) or cfg.filter_2d)
            and cfg.dsmag_avg not in ('dit', 'channel')):
        out.append(f'the {cfg.dsmag_avg!r} average with periodic z or the '
                   "2D test filter (the kernel's modes for them take the "
                   "'dit' and 'channel' sums): ROADMAP queue 1, dsmag "
                   'classes')
    if cfg.filter_2d and not dsmag_onepass_vals_ok(cfg, not _periodic(cfg, 1)):
        out.append('the 2D test filter where a face value forces the two '
                   'passes (the two-pass kernels have no 2D filter): '
                   'ROADMAP queue 1, dsmag classes, filter_2d by two passes')
    return out


def dsmag_onepass_vals_ok(cfg: Config, ywalled: bool) -> bool:
    """Whether the one-pass dsmag kernel can carry the BC values
    (cales_tpu Simulation._dsmag_onepass_vals_ok): it makes the filtered
    velocity's fill in registers from scalar recipes, with the wall-parallel
    'D' values as 2b - q offsets, so each wall-normal face value (w on the
    z faces, v on the y faces with y walls) must be 0 and every value a
    scalar.  Otherwise the two passes run, whose fill is built as edge
    stacks that carry the values (transpiring walls)."""
    for ib in range(2):
        checks = [(2, 2)] + ([(1, 1)] if ywalled else [])
        for d, iv in checks:
            if (not np.isscalar(cfg.bcvel[ib][d][iv])
                    or float(cfg.bcvel[ib][d][iv]) != 0.0):
                return False
        for d, ivs in ((2, (0, 1)), (1, (0, 2))):
            if any(not np.isscalar(cfg.bcvel[ib][d][iv]) for iv in ivs):
                return False
    return True


def dsmag_twopass(cfg: Config) -> bool:
    """Whether dsmag takes the two passes (dsmag_level1, the filtered
    fill, dsmag_level2): where the one-pass kernel cannot carry the BC
    values, or when CALES_DSMAG_TWOPASS=1 (cales_tpu's own switch)."""
    return cfg.sgstype == 'dsmag' and (
        not dsmag_onepass_vals_ok(cfg, not _periodic(cfg, 1))
        or os.environ.get('CALES_DSMAG_TWOPASS', '') == '1')


def slab_rhs_planes(planes, own, xs=None):
    """The pressure's add_rhs_bound planes for a slab or pencil of a
    y-walled mesh, which adds them on its local grid (cfg_local): the y
    faces' planes on the slab that owns the face (own = (lower, upper))
    and zero on the others, whose first and last rows are no wall; on a
    pencil (xs its x columns) a y face's (nz, nx) plane cut to them."""
    def cut(q):
        return q[:, xs] if xs is not None and np.ndim(q) == 2 else q
    return {k: (q if k[0] != 'y' else cut(q) if own[k[1]] else
                0.0 * cut(q)) for k, q in planes.items()}


def _slab_planes(vals, y0, nyl, ny):
    """A slab's rows of the plane-valued BC values vals (make_bc_values's
    layout): the x faces' (nz+2, ny+2) and the z faces' (ny+2, nx+2)
    planes at the padded rows of the slab's rows y0-1 .. y0+nyl, taken
    from the planes' interior rows with the periodic wrap (_planes_refuse
    admits planes with periodic y only); scalars as they are."""
    rows = (y0 - 1 + torch.arange(nyl + 2)) % ny + 1

    def cut(b, d):
        if not bnd._is_plane(b) or d == 1:
            return b
        return b.index_select(1 if d == 0 else 0, rows.to(b.device))
    return tuple(tuple(cut(b, d) for b in pair)
                 for d, pair in enumerate(vals))


def _dsmag_ratio(s0, num, den, avg, wz=None, reduce=None):
    """nu_t = max(|S| ratio, 0) from a dsmag kernel's partial sums of num
    and den (summed over their last dim here): one ratio per z row
    ('channel', ave1d_channel, sgs.f90:433-538), per (z, y) row ('duct',
    ave2d_duct, sgs.f90:540-614), or one for the volume ('dit', ave0d_dit,
    sgs.f90:388-431: the rows' sums weighted by wz = dzf / l_z, as
    cales_tpu timeloop.py:1512-1514 weighs them).  reduce: on a mesh the
    sum of the rows' sums of num and den over the ranks that share the
    rows, in one call (Simulation._dsmag_reduce)."""
    if avg == 'duct':
        num1, den1 = num.sum(dim=-1), den.sum(dim=-1)
    else:
        num1, den1 = num.sum(dim=1), den.sum(dim=1)
    if reduce is not None:
        num1, den1 = reduce(torch.stack([num1, den1]))
    if avg == 'duct':
        return torch.clamp_min(s0 * (num1 / den1)[:, :, None], 0.0)
    if avg == 'dit':
        ratio = torch.sum(num1 * wz) / torch.sum(den1 * wz)
        return torch.clamp_min(s0 * ratio, 0.0)
    ratio = num1 / den1
    return torch.clamp_min(s0 * ratio[:, None, None], 0.0)


def _xstack_halo_pairs(xs, ywalls=False):
    """The x stack pairs xs (cols (nz, 3, nyl), corners (3, 3, nyl), or
    with y walls their rows 0 .. nyl-1 of (nz, 3, nyl+2), (3, 3, nyl+2);
    None entries skipped) of a slab as mesh.halo_y pairs, y along dim 1."""
    def rows(a):
        return (a[..., 1:-1] if ywalls else a).transpose(1, 2)
    return [(rows(c), rows(k)) for c, k in (x for x in xs if x is not None)]


def _xstacks_on_slab(xs, halos, own=None, walls=None):
    """The x stack pairs xs of a slab with the neighbours' rows -1 and nyl
    (halos: mesh.halo_y's pairs of _xstack_halo_pairs(xs), in order):
    cols (nz, 3, nyl+2), corners (3, 3, nyl+2), row j at index j + 1, the
    layout of the y-walled stacks, which mom_rk and smag read where the
    halo rows meet the x ghost columns (the JAX package's y-sharded xe
    bundles, cales_tpu timeloop.py:169-183).  The x recipes are pointwise
    along y, so the neighbours' rows are their own stacks' rows.  A
    pencil's two-deep x halos (mesh.halo_x depth 2, cols (nz, 4, nyl))
    with the depth-2 y exchange's rows: cols (nz, 4, nyl+4), row j at
    index j + 2 (the dsmag kernel's form).  own: with
    y walls the walls the slab holds (lower, upper), xs the slab's own
    y-walled stacks (boundary.xedge_* with yown): the wall recipe's rows
    -1 and nyl (and v's rewrite row) on the sides it owns, the neighbours'
    rows elsewhere, the x counterpart of boundary.slab_ystack (the JAX
    package's xe bundles with their corner section on the ye bundle,
    cales_tpu timeloop.py:160-199).  own with walls: a pencil of a
    y-walled mesh, xs its x halos (mesh.halo_x, rows 0 .. nyl-1) and walls
    for each of them (w, face): w the x halo pair of the field's y-row
    stack pair of the pencil's own fill (mesh.halo_x of the (nz, 3, nxp)
    stack: cols (nz, C, 3)), face whether the field is v.  On the walls
    the pencil holds the rows -1 and nyl are the x neighbours' stack rows
    0 and 2 (their wall recipe's: the y recipes are pointwise along x),
    and v's row nyl-1 on the upper wall its rewrite, the stack's row 1
    (the JAX package's _xe_wall_rows and _ystag_rw_gx,
    cales_tpu timeloop.py:963-996); elsewhere, and the rows -2 and nyl+1
    of a two-deep halo, the y exchange's."""
    def ext(a, h):
        h = h.transpose(1, 2)
        if own is None:
            d = h.shape[-1] // 2
            return torch.cat([h[..., :d], a, h[..., d:]], dim=2).contiguous()
        return torch.cat([a[..., :1] if own[0] else h[..., :1], a[..., 1:-1],
                          a[..., -1:] if own[1] else h[..., 1:]],
                         dim=2).contiguous()

    def ext_walls(a, h, w, face):
        h = h.transpose(1, 2)
        d = h.shape[-1] // 2
        lo = (torch.cat([h[..., :d - 1], w[..., :1]], dim=2) if own[0]
              else h[..., :d])
        hi = (torch.cat([w[..., 2:], h[..., d + 1:]], dim=2) if own[1]
              else h[..., d:])
        if face and own[1]:
            a = torch.cat([a[..., :-1], w[..., 1:2]], dim=2)
        return torch.cat([lo, a, hi], dim=2).contiguous()
    it = iter(halos)
    if walls is None:
        return tuple(None if x is None else tuple(map(ext, x, next(it)))
                     for x in xs)
    return tuple(None if x is None else tuple(
        ext_walls(a, h, wq, face) for a, h, wq in zip(x, next(it), w))
        for x, (w, face) in zip(xs, walls))


class Simulation:
    """Static solver setup + the step function on one torch device, or on
    one rank of a device mesh (mesh: parallel/mesh.SlabMesh, which the
    namelist's dims asks for), where every field is this rank's slab or
    pencil."""

    def __init__(self, cfg: Config, grid: Grid, device='cuda', mesh=None):
        missing = unsupported(cfg)
        if missing:
            raise NotImplementedError(
                'configuration outside the ported slice: ' + '; '.join(missing))
        meshed = cfg.dims[0] * cfg.dims[1] > 1
        if meshed != (mesh is not None):
            raise ValueError(
                f'dims = {tuple(cfg.dims)} ' + (
                    'needs a device mesh (parallel/mesh.from_env)' if meshed
                    else 'runs on one device; a mesh was given'))
        if mesh is not None and (
                (mesh.gy, mesh.gx) != tuple(int(d) for d in cfg.dims[:2])
                or tuple(mesh.ng) != tuple(cfg.ng)):
            raise ValueError(f'mesh of dims ({mesh.gy}, {mesh.gx}) on '
                             f'{mesh.ng}, config dims {tuple(cfg.dims)} ng '
                             f'{tuple(cfg.ng)}')
        self.cfg = cfg
        self.grid = grid
        self.mesh = mesh
        self.device = devmod.resolve(device)
        if mesh is not None and mesh.comm.device != self.device:
            raise ValueError(f'mesh on {mesh.comm.device}, simulation on '
                             f'{self.device}')
        self.dtype = devmod.torch_dtype(cfg.dtype)
        self.cbcvel = effective_cbcvel(cfg)
        self.cbcpre = tuple((cfg.cbcpre[0][d], cfg.cbcpre[1][d])
                            for d in range(3))
        # y walls on both faces (unsupported() admits no other non-periodic
        # y): the kernels take the y-row stacks of their fills; x walls
        # (or inflow and outflow faces): the x stacks of their fills
        self.ywalled = not _periodic(cfg, 1)
        self.xwalled = not _periodic(cfg, 0)
        nx, ny, nz = cfg.ng
        # this rank's slab or pencil: the local shape the fields, the face
        # planes and add_rhs_bound's row indices take
        self.nyl = ny if mesh is None else mesh.nyl
        self.nxp = nx if mesh is None else mesh.nxp
        self.cfg_local = cfg if mesh is None else cfg.replace(
            ng=(self.nxp, self.nyl, nz))
        # a pencil of a 2D mesh (gx > 1): the kernels' x-halo variants on
        # the x neighbours' columns (mesh.halo_x)
        self.xhalo = mesh is not None and mesh.gx > 1
        # a slab or pencil of a y-walled mesh: the y walls it holds (the
        # mesh row iy = 0 the lower, iy = gy-1 the upper), where its y-row
        # stacks take the wall recipe's rows (boundary.slab_ystack); None
        # elsewhere
        self.yown = ((mesh.iy == 0, mesh.iy == mesh.gy - 1)
                     if mesh is not None and self.ywalled else None)

        self.solver_p = poisson.make_solver(
            cfg, grid, tuple(cfg.cbc_pre(d) for d in range(3)),
            ('c', 'c', 'c'), zsolver=cfg.zsolver)
        self.has_sgs = cfg.sgstype != 'none'
        # where nu_t comes from: the fused correction (smag, explicit
        # diffusion; cales_tpu's _fuse_correc_smag), or a separate SGS
        # kernel on the post-correction fill
        # (off with x walls and with plane-valued velocity values, as
        # cales_tpu's _fuse_correc_smag: its z-ghost recipes take scalars)
        # (off with periodic z too, as cales_tpu's: the box has no wall and
        # runs the smag kernel without van Driest)
        self.zper = self.cbcvel[0][2][0] == 'P'
        self.fused_smag = (cfg.sgstype == 'smag' and not cfg.impdiff
                           and mesh is None and not self.ywalled
                           and not self.xwalled and not plane_faces(cfg)
                           and not self.zper)
        self.sgs_kernel = ({'smag': 'smag', 'dsmag': 'dsmag'}
                           .get(cfg.sgstype) if not self.fused_smag else None)
        # dsmag: the one-pass kernel where it can carry the BC values, the
        # two passes (dsmag_level1, the filtered fill, dsmag_level2)
        # elsewhere or when CALES_DSMAG_TWOPASS=1 (cales_tpu's own switch)
        self.dsmag_twopass = dsmag_twopass(cfg)
        if self.dsmag_twopass and (self.zper or cfg.filter_2d):
            # the two-pass kernels have neither the periodic-z mode nor the
            # 2D filter: no silent one-pass run under the A/B switch
            raise NotImplementedError(
                'CALES_DSMAG_TWOPASS=1 with '
                + ('periodic z (the triperiodic box)' if self.zper
                   else 'the 2D test filter')
                + ': the two-pass dsmag kernels run the z-walled classes '
                'with the 3D filter; unset it to take the one-pass kernel '
                '(ROADMAP queue 1, dsmag classes)')
        # implicit diffusion: the momentum kernel's split ('1d' z only,
        # 'xy+z' full-3D) + CN fold (rd streams elided, timeloop.py:227-229
        # and 295-306 of the JAX package)
        self.split = (None if not cfg.impdiff
                      else '1d' if cfg.impdiff_1d else 'xy+z')

        def by_dir(vals):
            return tuple(tuple(vals[ib][idir] for ib in range(2))
                         for idir in range(3))

        def bcvel_by_dir(ivel):
            return tuple(tuple(cfg.bcvel[ib][idir][ivel] for ib in range(2))
                         for idir in range(3))
        mk = lambda vals: bnd.make_bc_values(cfg.ng, vals, self.dtype,  # noqa: E731
                                             self.device)
        self.bcp_vals = mk(by_dir(cfg.bcpre))
        self.bcs_vals = mk(by_dir(cfg.bcsgs))
        self.bcu_vals = mk(bcvel_by_dir(0))
        self.bcv_vals = mk(bcvel_by_dir(1))
        self.bcw_vals = mk(bcvel_by_dir(2))
        if mesh is not None:
            self.bcu_vals, self.bcv_vals, self.bcw_vals = (
                _slab_planes(q, mesh.y0, mesh.nyl, ny)
                for q in (self.bcu_vals, self.bcv_vals, self.bcw_vals))
        # the wall model on the z and y faces (unsupported() admits no
        # other): the faces' interpolation rows and weights, their static
        # wall-parallel values and their sampled rows' static fills
        self.has_wm = any(cfg.lwm[ib][d] != 0 for ib in range(2)
                          for d in range(3))
        self.index_wm = (wmod.find_index_wm(cfg, grid) if self.has_wm
                         else None)
        self.wm = (wmod.wall_model(cfg, grid, self.index_wm,
                                   (self.bcu_vals, self.bcv_vals,
                                    self.bcw_vals), self.cbcvel)
                   if self.has_wm else None)
        # the faces this rank models: on a slab of a y-walled mesh the z
        # faces and the y faces it owns, on its own rows
        self.wm_run = self.wm
        if self.has_wm and self.yown is not None:
            self.wm_run = wmod.slab_wall_model(self.wm, mesh.y0, mesh.nyl,
                                               self.yown)
        self.rhsb_p = poisson.rhs_bound_planes(
            cfg, grid, self.cbcpre, ('c', 'c', 'c'), by_dir(cfg.bcpre))
        if self.yown is not None:
            self.rhsb_p = slab_rhs_planes(
                self.rhsb_p, self.yown,
                slice(mesh.x0, mesh.x0 + mesh.nxp) if self.xhalo else None)
        self.sgs_setup = sgsmod.SGSSetup(cfg, grid, self.cbcvel)
        # the wall-modelled faces smag's 'E' stacks extrapolate: on a slab
        # of a y-walled mesh the y faces it owns only (its other sides'
        # rows are the neighbours')
        self.ext_flags = self.sgs_setup.lwm_flags
        if self.yown is not None:
            self.ext_flags = {k: on and (k[1] != 1 or self.yown[k[0]])
                              for k, on in self.ext_flags.items()}
        vol = cfg.l[0] * cfg.l[1] * cfg.l[2]
        self.gvr_c = cfg.dl[0] * cfg.dl[1] * grid.dzc[1:nz + 1] / vol
        self.gvr_f = cfg.dl[0] * cfg.dl[1] * grid.dzf[1:nz + 1] / vol

        # post-correction z-ghost recipes of u and v: the scalar BC letters,
        # or 'E' (the one-sided extrapolation, sgs.f90:682-767) on a
        # wall-modelled face (cales_tpu timeloop.py:326-345)
        dz01 = (float(grid.dzc[0]), float(grid.dzc[nz]))
        fac_ex = (float(grid.dzc[0] * grid.dzci[1]),
                  float(grid.dzc[nz] * grid.dzci[nz - 1]))

        def rec_for(iv, bvals):
            out = []
            for ib in range(2):
                if cfg.lwm[ib][2] != 0:
                    out += ['E', fac_ex[ib], 0.0]
                else:
                    out += [self.cbcvel[ib][2][iv], float(bvals[2][ib]),
                            dz01[ib]]
            return tuple(out)
        self.zrec_uv = ((rec_for(0, self.bcu_vals), rec_for(1, self.bcv_vals))
                        if self.fused_smag else None)

        # Crank-Nicolson Helmholtz solvers per velocity component
        # (main.f90:318-334; w is face-staggered in z, qz = 1 with z walls):
        # z-only (impdiff_1d) or full-3D; and their RHS boundary planes,
        # which are static here: the z-face planes for the z-only solves,
        # all of them for the full-3D ones, None when zero
        self.solver_vel, self.cn_planes = [], []
        if cfg.impdiff:
            bvals = (self.bcu_vals, self.bcv_vals, self.bcw_vals)
            for ivel in range(3):
                cbc = tuple((self.cbcvel[0][d][ivel], self.cbcvel[1][d][ivel])
                            for d in range(3))
                self.solver_vel.append(poisson.make_solver(
                    cfg, grid, tuple(a + b for a, b in cbc), _C_OR_F[ivel],
                    zsolver=cfg.zsolver))
                planes = poisson.rhs_bound_planes_dyn(
                    cfg, grid, cbc, _C_OR_F[ivel], bvals[ivel], self.dtype,
                    self.device)
                if cfg.impdiff_1d:
                    planes = {k: q for k, q in planes.items()
                              if k[0] == 'z'}
                if mesh is not None:
                    # on a slab its rows of the z faces' (ny, nx) planes and
                    # the x faces' (nz, ny) ones, on a pencil its columns of
                    # the z and y faces' too, which add_rhs_bound adds on
                    # the local grid (z is never split)
                    ys = slice(mesh.y0, mesh.y0 + mesh.nyl)
                    xs = slice(mesh.x0, mesh.x0 + mesh.nxp)
                    planes = {k: (q[ys, xs] if k[0] == 'z' else q[:, ys]
                                  if k[0] == 'x' else q[:, xs]).contiguous()
                              for k, q in planes.items()}
                zero = all(bool((q == 0).all()) for q in planes.values())
                self.cn_planes.append(None if zero else planes)

        # device-resident metrics and profiles
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=self.dtype,  # noqa: E731
                                      device=self.device)
        self.dzci_t = t(grid.dzci)
        self.dzfi_t = t(grid.dzfi)
        self.gvr_f_t = t(self.gvr_f)
        setup = self.sgs_setup
        self.csd2_t = t((C_SMAG * setup.delta) ** 2)
        self.lo_wall, self.hi_wall = setup.is_wall6[4], setup.is_wall6[5]
        zc = grid.zc[1:nz + 1]
        dw_lo = zc if self.lo_wall else np.full(nz, np.inf)
        dw_hi = (cfg.l[2] - zc) if self.hi_wall else np.full(nz, np.inf)
        self.have_zwalls = bool(self.lo_wall or self.hi_wall)
        self.nearlo_t = t((dw_lo <= dw_hi).astype(np.float64))
        self.dw_t = t(np.minimum(dw_lo, dw_hi) if self.have_zwalls
                      else np.zeros(nz))
        # smag with y walls: the distance to the nearer y wall and 1 where
        # it is the lower one (both y faces are walls), which van Driest
        # weighs against the z walls' (sgs.f90:104-146)
        # (on a slab its rows of them)
        if self.ywalled and cfg.sgstype == 'smag':
            (dy_lo, _), (dy_hi, _) = setup.dw1d[2], setup.dw1d[3]
            ys = (slice(None) if mesh is None
                  else slice(mesh.y0, mesh.y0 + mesh.nyl))
            self.dwy_t = t(np.minimum(dy_lo, dy_hi)[ys])
            self.nearylo_t = t((dy_lo <= dy_hi).astype(np.float64)[ys])
        # smag with x walls: the x faces whose u is 'D' are walls (an
        # inflow face too, sgs.f90:76-81), the distance to the nearer one
        # and 1 where it is the lower one (None where neither is a wall)
        self.xwall_sides = tuple(ib for ib in range(2) if setup.is_wall6[ib])
        self.xwall_prof = None
        if self.xwalled and cfg.sgstype == 'smag' and self.xwall_sides:
            d_lo, d_hi = (setup.dw1d[ib][0] if ib in self.xwall_sides
                          else np.full(nx, np.inf) for ib in range(2))
            self.xwall_prof = (t(np.minimum(d_lo, d_hi)),
                               t((d_lo <= d_hi).astype(np.float64)))
        # dsmag: the filter-ratio profile alpha^2 along z (2.52 on a z
        # wall's first row; the kernel sets the y walls' rows itself) and
        # the filtered-velocity fill's wall-parallel z and y values
        # (2.52 everywhere with the 2D filter, SGSSetup.alph2_field), and
        # the 'dit' average's plane weights dzf / l_z
        alph2 = np.full(nz, 4.0)
        if self.lo_wall:
            alph2[0] = 2.52
        if self.hi_wall:
            alph2[-1] = 2.52
        if cfg.filter_2d:
            alph2[:] = 2.52
        self.alph2_t = t(alph2)
        self.dit_w_t = t(grid.dzf[1:nz + 1] / cfg.l[2])
        self.gvr_c_t = t(self.gvr_c)
        self.dsmag_zvals = (self.bcu_vals[2][0], self.bcu_vals[2][1],
                            self.bcv_vals[2][0], self.bcv_vals[2][1])
        self.dsmag_yvals = (self.bcu_vals[1][0], self.bcu_vals[1][1],
                            self.bcw_vals[1][0], self.bcw_vals[1][1])
        # deferred bulk forcing along the periodic x / y (along z it is
        # taken after the momentum kernel, _bulk_forcing)
        self.sum_flags = (bool(cfg.is_forced[0]), bool(cfg.is_forced[1]))
        # the passive scalar: its BC letters and values by direction, its
        # diffusivity visc/pr and source (mom_rk's scalar stream)
        self.has_scal = bool(cfg.scalar)
        self.cbcscal = tuple((cfg.cbcscal[0][d], cfg.cbcscal[1][d])
                             for d in range(3))
        self.bcscal = tuple(tuple(float(cfg.bcscal[ib][d]) for ib in range(2))
                            for d in range(3))
        self.scal_params = (cfg.visc / cfg.pr, float(cfg.ssource))

    # ------------------------------------------------------------------
    def kernel_names(self) -> list[str]:
        """The kernels one step of this configuration launches, by their
        launch-count names (the y-walled variants count under their
        kernel's name; exec_path says which variant runs)."""
        cfg = self.cfg
        mat = self.solver_p.trx.kind == 'mat'
        # the sharded 'mat' solve takes Thomas at every nz
        # (poisson.solve_sharded); the 'fft' route the one-device z stage
        thomas = poisson.uses_thomas(self.solver_p) or (
            self.mesh is not None and mat)
        zthomas = ('thomas_periodic' if self.solver_p.bcz == 'PP'
                   else 'thomas_z')
        names = ['mom_rk', 'fillps',
                 'correc_smag' if self.fused_smag else 'correc_updatep']
        if self.dsmag_twopass:
            names += ['dsmag_level1', 'dsmag_level2']
        elif self.sgs_kernel:
            names.append(self.sgs_kernel)
        # apply_y: the 'mat' route's x and y operators, or the mixed
        # route's y DCT on the rfft's lanes
        if mat or self.solver_p.try_.kind == 'mat':
            names.append('apply_y')
        if self.mesh is not None and mat:
            names.append('apply_x')
        if mat and not thomas:
            names.append('z_eig')
        # the Thomas kernel of the z stage: the Poisson solve's, and the
        # CN solves' (all of impdiff_1d's; full-3D: on the 'mat' route or
        # with zsolver 'thomas')
        cn_thomas = cfg.impdiff and (cfg.impdiff_1d or mat
                                     or cfg.zsolver == 'thomas')
        if thomas or cn_thomas:
            names.append(zthomas)
        if self.has_wm and self.wm_run.faces:
            names.append('wallmodel')
        # the passive scalar runs in mom_rk (its SCAL variant, counted as
        # mom_rk): exec_path names it
        return names

    def exec_path(self) -> str:
        """One-line description of the execution path (logged at start)."""
        names = '+'.join(self.kernel_names())
        walled = [a for a, on in (('x', self.xwalled), ('y', self.ywalled))
                  if on]
        if walled:
            names += f" ({'-'.join(walled)}-walled variants)"
        if self.device.type == 'cuda':
            where = (f'{self.device} ({torch.cuda.get_device_name(self.device)})'
                     f', kernels: {names} (CUDA, cales_torch/csrc)')
        else:
            where = f'cpu, kernels: {names} (plain PyTorch twins)'
        periodic_z = self.solver_p.bcz == 'PP'
        zthomas = 'thomas_periodic' if periodic_z else 'thomas_z'
        fft = self.solver_p.trx.kind == 'fft'
        zstage = (zthomas if poisson.uses_thomas(self.solver_p)
                  or (self.mesh is not None and not fft)
                  else 'z eigen-matmul' if fft else 'z_eig')
        ystage = ('torch.fft y' if self.solver_p.try_.kind == 'fft'
                  else 'apply_y y DCT on the lanes (mixed route)')
        xy = (f'torch.fft x, {ystage}' if fft and self.mesh is None
              else f'torch.fft x, the kx<->y all-to-all, {ystage} '
                   '(slab-sharded)' if fft
              else 'apply_y x/y operator matmuls' if self.mesh is None
              else 'apply_x, the y<->x all-to-all, apply_y (slab-sharded)')
        diff = ('explicit' if not self.cfg.impdiff
                else f'z-implicit Crank-Nicolson ({zthomas} per component)'
                if self.cfg.impdiff_1d
                else 'full-3D implicit Crank-Nicolson (a Helmholtz solve per '
                     'component, the Poisson route with the alpha-scaled '
                     'Thomas or eigen z stage)')
        if periodic_z:
            diff += '; periodic z'
        sgs = ('smag fused in correc_smag' if self.fused_smag
               else 'smag kernel on the post-correction fill'
               if self.sgs_kernel == 'smag'
               else f'dsmag {"two-pass" if self.dsmag_twopass else "kernel"}'
                    f', {self.cfg.dsmag_avg!r} average'
               if self.sgs_kernel == 'dsmag' else 'none')
        if self.sgs_kernel == 'smag' and not (
                self.have_zwalls or self.ywalled or self.xwall_sides):
            sgs += ' (no wall: no van Driest damping)'
        if self.sgs_kernel == 'dsmag':
            modes = ([' its periodic-z mode'] if self.zper else []) + (
                [' the 2D test filter'] if self.cfg.filter_2d else [])
            if modes:
                sgs += ' in' + ' and'.join(modes)
        if self.ywalled:
            sgs += '; y walls: y-row ghost stacks'
        if self.xwalled:
            sgs += ('; x walls: x-ghost column stacks'
                    + (' with their y ghosts' if self.ywalled else ''))
            if plane_faces(self.cfg):
                sgs += ', plane-valued values as their offsets'
        if self.xwalled and self.sgs_kernel == 'smag':
            sgs += ', the smag kernel in its x-wall variant'
        if self.ywalled and self.sgs_kernel == 'smag':
            sgs += ', the smag kernel in its y-wall variant'
        if self.has_wm:
            kinds = sorted({'log-law' if f.mtype == wmod.WM_LOG
                            else 'laminar' for f in self.wm.faces})
            sides = '+'.join(f"{('lower', 'upper')[f.ib]} {'xyz'[f.d]}"
                             for f in self.wm.faces)
            sgs += (f"; wall model: {'/'.join(kinds)} on the {sides} "
                    'face(s), wallmodel kernel planes'
                    + (", correc_smag's 'E' z-ghost recipe"
                       if self.fused_smag else '')
                    + (", smag's 'E' ghost stacks"
                       if self.sgs_kernel == 'smag' else '')
                    + (', its rows\' x ghosts from the x faces\' values'
                       if self.xwalled else ''))
        mesh = ('' if self.mesh is None
                else f'; mesh: {self.mesh.describe()}, y halos'
                if not self.xhalo
                else f'; mesh: {self.mesh.describe()}, '
                     + ('y halos and ' if self.mesh.gy > 1 else '')
                     + "x halos (the x-halo kernel variants; the x halos' "
                     'rows -1 and nyl in the y exchange), the Poisson solve '
                     're-slabbed (an all-to-all in the mesh row each way '
                     f'around the slab route on {self.mesh.gy * self.mesh.gx} '
                     'y slabs)')
        if self.mesh is not None and self.sgs_kernel == 'dsmag':
            mesh += (" (dsmag_level1's two rows and two columns deep, with "
                     "their corners; then the filtered velocity's one row "
                     'and one column deep, after its own fill, for '
                     'dsmag_level2: two x exchanges a substep)'
                     if self.dsmag_twopass and self.xhalo
                     else " (dsmag_level1's two rows deep, the filtered "
                          "velocity's one row deep for dsmag_level2)"
                     if self.dsmag_twopass
                     else " (dsmag's two rows and two columns deep, with "
                          'their corners)' if self.xhalo
                     else " (dsmag's two rows deep)")
            mesh += ', the dsmag sums reduced over the ranks'
        if self.mesh is not None and self.has_scal:
            mesh += ((", the scalar's halo rows and x halo columns in the "
                      'momentum exchange') if self.xhalo
                     else ", the scalar's halo rows in the momentum exchange")
            if self.cfg.is_sforced:
                mesh += ', its forcing summed over the ranks'
        if self.mesh is not None and self.has_wm:
            mesh += ", the wall model's sampled rows' halos"
            if self.yown is not None:
                mesh += ", the y faces' planes on their owners"
        if self.mesh is not None and self.cfg.impdiff_1d:
            mesh += ', the z-only CN solves on the slab'
        elif self.mesh is not None and self.cfg.impdiff:
            mesh += (', the full-3D CN solves slab-sharded (apply_x, the '
                     f'y<->x all-to-all, apply_y, {zthomas} on the rank\'s '
                     'lamx lanes, a component each'
                     + (', re-slabbed as the Poisson solve' if self.xhalo
                        else '') + ')')
        if self.mesh is not None and self.xwalled:
            mesh += (", the x stacks' rows -1 and nyl in the momentum and "
                     'SGS exchanges'
                     + (" (the wall recipe's on the walls the slab owns)"
                        if self.yown is not None else ''))
        if self.yown is not None:
            owns = [n for n, on in zip(('lower', 'upper'), self.yown) if on]
            mesh += ("; y walls: the slab's y-row stacks ("
                     + (' and '.join(owns) + ' wall recipe' if owns
                        else 'no wall') + ', halo rows elsewhere)')
            if self.xhalo:
                mesh += (", the x halos' wall rows the x neighbours' y-row "
                         'stacks\' (in the x exchange), the Y_WALLS x X_HALO '
                         'variants')
            if self.sgs_kernel == 'smag':
                mesh += (", the y walls' shear planes summed over the "
                         + ('mesh column' if self.xhalo else 'ranks'))
            if self.xhalo and self.cfg.dsmag_avg == 'duct' and (
                    self.sgs_kernel == 'dsmag'):
                mesh += ", the 'duct' sums summed over the mesh row"
        scal = ''
        if self.has_scal:
            scal = ("; passive scalar: mom_rk's scalar stream (alpha = "
                    'visc/pr, explicit, its own BC stacks'
                    + (', forced' if self.cfg.is_sforced else '') + ')')
        return (f'{where}; poisson: {xy} + {zstage} ({self.cfg.dtype}); '
                f'diffusion: {diff}; sgs: {sgs}{mesh}{scal}')

    # ------------------------------------------------------------------
    def _t(self, a):
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    def initial_state(self, u, v, w, p, s=None) -> State:
        """State from (nz, ny, nx) initial fields (numpy or tensors); on a
        mesh the global fields or this rank's slabs.  s: the passive
        scalar's field (a restart's), else its initial field."""
        if self.mesh is not None:
            u, v, w, p = (self.mesh.local(a) for a in (u, v, w, p))
            if s is not None:
                s = self.mesh.local(s)
        u, v, w, p = (self._t(a) for a in (u, v, w, p))
        zeros = torch.zeros_like(u)
        nx, ny, nz = self.cfg_local.ng
        z2 = lambda a, b: torch.zeros((a, b), dtype=self.dtype,  # noqa: E731
                                      device=self.device)
        vlo = (z2(nz + 2, ny + 2), z2(nz + 2, nx + 2), z2(ny + 2, nx + 2))
        dsdt = None
        if self.has_scal:
            # iniscal: 'uni' 1 everywhere, else 0 (cales_tpu
            # timeloop.py:587-590)
            s = (self._t(s) if s is not None
                 else torch.ones_like(u) if self.cfg.iniscal == 'uni'
                 else torch.zeros_like(u))
            dsdt = torch.zeros_like(u)
        st0 = State(u=u, v=v, w=w, p=p, visct=zeros, vlo=vlo,
                    rhs_old=(zeros, zeros, zeros), time=0.0, istep=0,
                    s=s, dsdt_old=dsdt)
        return self._init_impl(st0)

    def _init_impl(self, st0: State) -> State:
        """Initial BC fill + SGS (main.f90:370-375)."""
        u, v, w = st0.u, st0.v, st0.w
        bcu, bcv, bcw = self._dynamic_bcs(u, v, w)
        up, vp, wp, vlo = self._pad_vel(u, v, w, bcu, bcv, bcw)
        if self.mesh is not None:
            # the y ghosts from the neighbours (vlo's y ghost rows, wrapped
            # on the slab, are never read: every fill crops them); with y
            # walls the wall recipe's on the sides the slab owns (and v's
            # rewrite row on the upper wall's slab), vlo's y-ghost rows read
            # there only; with x walls the x stacks (u's last column its
            # rewrite slot)
            up, vp, wp = self._halo_padded(
                (u, v, w), self._zedge_vel(u, v, w, bcu, bcv, bcw),
                self._yedge_vel(u, v, w, (bcu, bcv, bcw))
                if self.yown is not None else None,
                self._xedge_vel(u, v, w, (bcu, bcv, bcw))
                if self.xwalled else None)
        if self.mesh is not None and (self.ywalled or self.xwalled) \
                and self.has_sgs:
            # on a slab of a y-walled or x-walled mesh the SGS kernel on
            # the fill's interiors and stacks, as after a correction
            # (below)
            visct = None
        elif self.cfg.sgstype == 'smag':
            visct = sgsmod.smag_visct(self.sgs_setup, self.cfg, self.grid,
                                      up, vp, wp).to(self.dtype)
        elif self.cfg.sgstype == 'dsmag' and self.mesh is not None:
            # on a slab the kernels on the same fill, whose y halo is two
            # rows deep (the padded fields carry one)
            stage = (self._dsmag_twopass if self.dsmag_twopass
                     else self._dsmag_onepass)
            visct = stage(u, v, w, self._zedge_vel(u, v, w, bcu, bcv, bcw))
        elif self.cfg.sgstype == 'dsmag':
            # the filtered velocity's fill: the static planes, not the
            # corrector's (sgs.f90:256-257)
            def pad_filtered(uf, vf, wf):
                return self._pad_vel(uf, vf, wf, self.bcu_vals,
                                     self.bcv_vals, self.bcw_vals)[:3]
            visct = sgsmod.dsmag_visct(self.sgs_setup, self.cfg, self.grid,
                                       up, vp, wp, self.bcs_vals,
                                       pad_filtered).to(self.dtype)
        else:
            visct = torch.zeros_like(u)
        u_i, v_i, w_i = (up[1:-1, 1:-1, 1:-1].contiguous(),
                         vp[1:-1, 1:-1, 1:-1].contiguous(),
                         wp[1:-1, 1:-1, 1:-1].contiguous())
        zq = self._zedge_vel(u_i, v_i, w_i, bcu, bcv, bcw, is_correc=False)
        yq = (self._yedge_vel(u_i, v_i, w_i, (bcu, bcv, bcw))
              if self.ywalled else None)
        xq = (self._xedge_vel(u_i, v_i, w_i, (bcu, bcv, bcw))
              if self.xwalled else None)
        if visct is None:
            visct = self._sgs_stage(u_i, v_i, w_i, zq, vlo, yq, xq)
        return st0._replace(u=u_i, v=v_i, w=w_i, vlo=vlo, visct=visct, zq=zq,
                            yq=yq, xq=xq)

    # ------------------------------------------------------------------
    def _dynamic_bcs(self, u, v, w, planes=None):
        """Velocity BC values: the static ones, and on each wall-modelled
        face the wall model's Neumann planes of its wall-parallel
        components, u and v on a z face, u and w on a y face (bounduvw's
        is_updt_wm path, bound.f90:120-123): `planes`, the planes already
        made from this u and v (kernels.wm_planes, one (2, n+2, nx+2) pair
        a face), or else made here from the current u, v and w."""
        if not self.has_wm:
            return self.bcu_vals, self.bcv_vals, self.bcw_vals
        if planes is None:
            planes = self._wm_planes(u, v, w)
        bcs = [[list(q) for q in b] for b in (self.bcu_vals, self.bcv_vals,
                                              self.bcw_vals)]
        for face, pair in zip(self.wm_run.faces, planes):
            bcs[0][face.d][face.ib] = pair[0]
            # the second wall-parallel component: v on a z face, w on y
            bcs[1 if face.d == 2 else 2][face.d][face.ib] = pair[1]
        return tuple(tuple(tuple(q) for q in b) for b in bcs)

    def _wm_planes(self, u, v, w):
        """The wall model's planes of the rows as they are
        (kernels.wm_planes); on a slab the z faces' sampled rows' y halos
        (their rows -1 and nyl, where one device wraps them) come from the
        neighbours, one exchange of those rows alone (cales_tpu
        _wm_bcs_fast on its mesh), and with y walls the y faces' planes
        are made on their owners from their own rows."""
        wm = self.wm_run
        if not wm.faces:
            return ()
        yh = None
        if self.mesh is not None and any(f.d == 2 for f in wm.faces):
            (yh, _), = self.mesh.halo_y([(wmod.sampled_rows(u, v, wm),
                                          None)])
        return kernels.wm_planes(u, v, wm, w=w, yh=yh, yown=self.yown)

    def _pad_vel(self, u, v, w, bcu, bcv, bcw, vlo=None, is_correc=False):
        return bnd.pad_velocity(u, v, w, self.cbcvel, bcu, bcv, bcw,
                                self.cfg.dl, self.grid.dzc, self.grid.dzf,
                                vlo=vlo, is_correc=is_correc)

    def _pad_p(self, p):
        return bnd.pad_scalar(p, self.cbcpre, self.bcp_vals, self.cfg.dl,
                              self.grid.dzc)

    def _pad_s(self, s):
        cbcs = tuple((self.cfg.cbcsgs[0][d], self.cfg.cbcsgs[1][d])
                     for d in range(3))
        return bnd.pad_scalar(s, cbcs, self.bcs_vals, self.cfg.dl,
                              self.grid.dzc)

    def _zedge_vel(self, u, v, w, bcu, bcv, bcw, vlo=None, is_correc=False):
        return tuple(e.contiguous() for e in bnd.zedge_velocity(
            u, v, w, self.cbcvel, bcu, bcv, bcw, self.grid.dzc, self.grid.dzf,
            vlo=vlo, is_correc=is_correc))

    def _zedge_p(self, p):
        return bnd.zedge_scalar(p, self.cbcpre[2], self.bcp_vals[2],
                                self.grid.dzc).contiguous()

    def _zedge_s(self, s):
        cbc_z = (self.cfg.cbcsgs[0][2], self.cfg.cbcsgs[1][2])
        return bnd.zedge_scalar(s, cbc_z, self.bcs_vals[2],
                                self.grid.dzc).contiguous()

    def _zedge_scal(self, s):
        """The passive scalar's z-edge stack, by its own BC table
        (cales_tpu timeloop.py:1119-1124), from a recipe made once."""
        return bnd.zedge_scalar_fast(s, self.cbcscal[2], self.bcscal[2],
                                     self.grid.dzc)

    def _yedge_scal(self, s):
        """Its (rows, corners) y-row stack pair with y walls (cales_tpu
        _ybundle_scal, timeloop.py:1168-1175)."""
        return bnd.yedge_scalar_fast(s, self.cbcscal, self.bcscal,
                                     self.cfg.dl, self.grid.dzc)

    def _xedge_scal(self, s):
        """Its (cols, corners) x stack pair with x walls, the (y ghost, x
        ghost) corners with y walls (cales_tpu timeloop.py:1904-1911,
        _xye_entries has_scal)."""
        return bnd.xedge_scalar(s, self.cbcscal, self.bcscal, self.cfg.dl,
                                self.grid.dzc, ywalls=self.ywalled,
                                yown=self.yown)

    def _halo_padded(self, fields, edges, walls=None, xs=None):
        """The (nz+2, nyl+2, nx+2) ghost-filled slabs of `fields` on a
        mesh: z ghosts from their edge stacks, y ghosts from the
        neighbours' rows (one exchange), x periodic; with y walls (walls:
        the stack pairs of the slab's own fill) the slab's y-row stacks,
        the wall recipe's rows on the sides it owns; with x walls (xs: the
        x stack pairs of the slab's own fill) the x ghosts from them, their
        rows -1 and nyl from the neighbours in the same exchange, and the
        first field's (u's) last column its set_bc rewrite slot, as the
        fill leaves it; with x and y walls the x stacks' rows -1 and nyl
        the wall recipe's on the sides the slab owns (_xstacks_on_slab).
        On a pencil (gx > 1) the x ghosts from the x neighbours' columns
        (_pencil_halos), the y ghosts from the y halo or, with gy = 1,
        periodic; with y walls from the pencil's y-row stacks, the x
        halos' wall rows the x neighbours' (the second field, v, is the
        face-staggered one)."""
        pairs = list(zip(fields, edges))
        if self.xhalo:
            yh, xh = self._pencil_halos(pairs, pairs, walls=walls)
            if walls is not None:
                ys = self._yslab(fields, edges, walls, yh)
                return [kernels.padded(q, e, y=y, x=x)
                        for q, e, y, x in zip(fields, edges, ys, xh)]
            return [kernels.padded(q, e, h=None if yh is None else yh[i],
                                   x=xh[i])
                    for i, (q, e) in enumerate(pairs)]
        halos = self.mesh.halo_y(pairs + _xstack_halo_pairs(
            xs or (), walls is not None))
        xs = (_xstacks_on_slab(xs, halos[len(pairs):], self.yown)
              if xs is not None else (None,) * len(pairs))
        halos = halos[:len(pairs)]
        if walls is None:
            return [kernels.padded(q, e, h=h, x=x, rewrite=i == 0)
                    for i, (q, e, h, x) in enumerate(zip(fields, edges,
                                                         halos, xs))]
        return [kernels.padded(q, e, y=y, x=x, rewrite=i == 0)
                for i, (q, e, y, x) in enumerate(zip(
                    fields, edges, self._yslab(fields, edges, walls, halos),
                    xs))]

    def _pencil_halos(self, ypairs, xpairs, depth=1, walls=None):
        """On a pencil mesh (gx > 1): (yh, xh), the y halo pairs of ypairs
        (mesh.halo_y; None with gy = 1, where y is periodic on the pencil)
        and the x halo pairs of xpairs (mesh.halo_x; None for a pair whose
        field is None), whose rows -1 and nyl ride the same y exchange
        (_xstacks_on_slab: x stacks of nyc = nyl + 2, so the (x +-1, y +-1)
        corners arrive by two hops, as cales_tpu's _xe_pack bundles are
        completed by _halo_y, timeloop.py:998-1015).  depth 2 (the dsmag
        kernel): two rows and two columns a side, the x halos (nz, 4,
        nyl + 4) with the (x +-1..2, y +-1..2) corners, by the same two
        hops (cales_tpu timeloop.py:1003-1005).  walls (y walls): for
        each of xpairs the y-row stack pair of the pencil's own fill of
        its field, the second v's (the face-staggered one); the stacks'
        edge columns ride the x exchange beside the fields, and the x
        halos take their rows on the walls the pencil holds
        (_xstacks_on_slab); with y walls the y halo is made with gy = 1
        too (the local wrap: the stacks compose it with the walls)."""
        m = self.mesh
        present = [i for i, q in enumerate(xpairs) if q[0] is not None]
        xq = [xpairs[i] for i in present]
        if walls is not None:
            xq += [walls[i] for i in present]
        xs = m.halo_x(xq, depth=depth)
        xs, wx = xs[:len(present)], xs[len(present):]
        ypairs = list(ypairs) if m.gy > 1 or walls is not None else []
        h = m.halo_y(ypairs + _xstack_halo_pairs(xs), depth=depth)
        it = iter(_xstacks_on_slab(
            xs, h[len(ypairs):], None if walls is None else self.yown,
            None if walls is None else [(w, i == 1)
                                        for w, i in zip(wx, present)]))
        xh = [None if q is None else next(it) for q, _ in xpairs]
        return (h[:len(ypairs)] if ypairs else None), xh

    def _yslab(self, fields, edges, walls, halos):
        """The y-row stack pairs of fields on a slab of a y-walled mesh
        (boundary.slab_ystack) from the stack pairs of the slab's own fill
        (walls) and the halo pairs; None for a field given as None."""
        return tuple(None if q is None else bnd.slab_ystack(
            q, e, y, h, self.yown)
            for q, e, y, h in zip(fields, edges, walls, halos))

    def bulk_mean(self, f, weights):
        """Volume-weighted mean of a field (st.bulk_mean), over the whole
        domain on a mesh."""
        return float(self._bulk_mean_t(f, weights))

    def _bulk_mean_t(self, f, weights):
        """bulk_mean as a tensor on f's device; on a mesh the slabs' plane
        sums reduced over the ranks."""
        if self.mesh is None:
            return st.bulk_mean(f, weights)
        plane = self.mesh.all_reduce(torch.sum(f, dim=(1, 2)))
        return torch.dot(plane, torch.as_tensor(weights, dtype=f.dtype,
                                                device=f.device))

    def _yedge_vel(self, u, v, w, bcs=None, vlo=None, is_correc=False):
        """The (rows, corners) y-row stack pairs of u, v, w with the BC
        values bcs = (bcu, bcv, bcw), the static ones by default."""
        bcu, bcv, bcw = bcs or (self.bcu_vals, self.bcv_vals, self.bcw_vals)
        rows, corners = bnd.yedge_velocity(
            u, v, w, self.cbcvel, bcu, bcv, bcw, self.cfg.dl, self.grid.dzc,
            self.grid.dzf, vlo=vlo, is_correc=is_correc)
        return tuple((r.contiguous(), c.contiguous())
                     for r, c in zip(rows, corners))

    def _xedge_vel(self, u, v, w, bcs=None, vlo=None, is_correc=False,
                   fields=(0, 1, 2)):
        """The (cols, corners) x stack pairs of u, v, w (of the components
        in fields, None for the others) with the BC values bcs = (bcu,
        bcv, bcw), the static ones by default; with y walls the columns
        carry their y ghosts (on a slab of a y-walled mesh the wall
        recipe's on the sides it owns only: _xstacks_on_slab)."""
        bcu, bcv, bcw = bcs or (self.bcu_vals, self.bcv_vals, self.bcw_vals)
        return bnd.xedge_velocity(
            u, v, w, self.cbcvel, bcu, bcv, bcw, self.cfg.dl, self.grid.dzc,
            self.grid.dzf, vlo=vlo, is_correc=is_correc,
            ywalls=self.ywalled, fields=fields, yown=self.yown)

    def _xedge_p(self, p):
        return bnd.xedge_scalar(p, self.cbcpre, self.bcp_vals, self.cfg.dl,
                                self.grid.dzc, ywalls=self.ywalled,
                                yown=self.yown)

    def _xedge_s(self, s):
        """nu_t's x stack pair, by the SGS letters (cales_tpu
        timeloop.py:1898-1905)."""
        cbcs = tuple((self.cfg.cbcsgs[0][d], self.cfg.cbcsgs[1][d])
                     for d in range(3))
        return bnd.xedge_scalar(s, cbcs, self.bcs_vals, self.cfg.dl,
                                self.grid.dzc, ywalls=self.ywalled,
                                yown=self.yown)

    def _yedge_p(self, p):
        return bnd.yedge_scalar(p, self.cbcpre, self.bcp_vals, self.cfg.dl,
                                self.grid.dzc)

    def _yedge_s(self, s):
        cbcs = tuple((self.cfg.cbcsgs[0][d], self.cfg.cbcsgs[1][d])
                     for d in range(3))
        return bnd.yedge_scalar(s, cbcs, self.bcs_vals, self.cfg.dl,
                                self.grid.dzc)

    # ------------------------------------------------------------------
    def _bulk_forcing(self, sums, w):
        """Bulk-velocity forcing (rk.f90:197-222, mom.f90:311-335) from the
        momentum kernel's partial sums along x and y.  Explicit diffusion
        defers their constants into the correction kernel (forcing along a
        periodic direction cancels in the divergence); impdiff_1d adds them
        as the CN solves' RHS shift, full-3D implicit diffusion to the CN
        RHS before its solves (timeloop.py:2339-2345).  Along z (periodic:
        unsupported() refuses it with z walls) the bulk mean of w with the
        gvr_c weights is one reduction of the kernel's w (cales_tpu
        timeloop.py:2350-2356), and explicit diffusion adds f_z to w here,
        before fillps.  With implicit diffusion that w carries the CN fold
        (-1/2 f12 of the implicit term); on a periodic z the fold's volume
        mean vanishes (the dzc-weighted sum of a second difference of w
        telescopes to zero, and so do the x and y sums of the periodic x
        and y terms), so the mean is the unfolded prediction's, to
        rounding, as cales_tpu takes it.  Returns the (3,) forcing tensor,
        the (2,) (fu, fv) the corrector adds and w."""
        cfg = self.cfg
        f = torch.zeros(3, dtype=self.dtype, device=self.device)
        for d, s in enumerate(sums):
            if s is not None:
                tot = s.sum(dim=1)
                if self.mesh is not None:
                    tot = self.mesh.all_reduce(tot)
                f[d] = cfg.velf[d] - torch.dot(tot, self.gvr_f_t)
        if cfg.is_forced[2]:
            f[2] = cfg.velf[2] - self._bulk_mean_t(w, self.gvr_c_t)
            if not cfg.impdiff:
                w = w + f[2]
        return f, f[:2].contiguous(), w

    def _correc_smag_fused(self, u, v, w, pp, p, ue2, ve2, we2, ppe, dtrk,
                           fuv):
        """Projection + pressure update + smag nu_t in one kernel.  The
        van Driest wall-shear planes come from the corrected wall-adjacent
        planes, computed here as (ny, nx) expressions; on a wall-modelled
        face from the wall model's planes of the corrected rows (cales_tpu
        timeloop.py:1318-1356): there the jump across the face is dz times
        the Neumann value.  Returns (u, v, w, p, visct, planes): the
        planes (None without a wall model) are those of the corrected u
        and v, which the post-correction fill takes."""
        cfg = self.cfg
        nz = cfg.ng[2]
        dxi, dyi = cfg.dli[0], cfg.dli[1]
        fu, fv = fuv[0], fuv[1]
        wm_faces, planes = {}, None
        if self.has_wm:
            planes = kernels.wm_planes(u, v, self.wm, fuv=fuv, pp=pp,
                                       dtrk=dtrk, dxi=dxi, dyi=dyi)
            wm_faces = {f.ib: q for f, q in zip(self.wm.faces, planes)}

        def face(side):
            if side in wm_faces:
                dz = float(self.grid.dzc[0 if side == 0 else nz])
                bu, bv = wm_faces[side]
                return dz * bu[1:-1, 1:-1], dz * bv[1:-1, 1:-1]
            krow = 0 if side == 0 else nz - 1
            ppq = pp[krow]
            u_c = fu + u[krow] - dtrk * dxi * (torch.roll(ppq, -1, 1) - ppq)
            v_c = fv + v[krow] - dtrk * dyi * (torch.roll(ppq, -1, 0) - ppq)
            return (u_c - kernels.ghost_row(self.zrec_uv[0], side, u_c),
                    v_c - kernels.ghost_row(self.zrec_uv[1], side, v_c))

        tauw_lo, tauw_hi = self._wall_shear_planes(face, u)
        out = kernels.correc_smag(
            u, v, w, pp, p, ue2, ve2, we2, ppe, dtrk, dxi, dyi, self.dzci_t,
            self.dzfi_t, cfg.visc, self.csd2_t, self.zrec_uv, fuv, self.dw_t,
            self.nearlo_t, tauw_lo, tauw_hi, have_zwalls=self.have_zwalls)
        return (*out, planes)

    @staticmethod
    def _shear(A, B, bprev, scale, aprev=None):
        """|grad u_par| on a wall face from the jumps A, B of its two
        wall-parallel components across it (interior row minus ghost row),
        each averaged onto the cell centres along the plane's last axis
        (A: its column -1 is aprev, or A's last column where that axis is
        periodic) and along its first (B: its row -1 is bprev, or B's last
        row where that axis is periodic), times the inverse spacing across
        the face (sgs.f90:117-143)."""
        if aprev is None:
            t1 = A + torch.roll(A, 1, 1)
        else:
            t1 = A + torch.cat([aprev[:, None], A[:, :-1]], dim=1)
        if bprev is None:
            t2 = B + torch.roll(B, 1, 0)
        else:
            t2 = B + torch.cat([bprev[None], B[:-1]])
        return (torch.sqrt(t1 ** 2 + t2 ** 2) * scale).contiguous()

    def _wall_shear_planes(self, face, like, bprev=None, aprev=None):
        """The van Driest wall-shear planes (tauw_lo, tauw_hi), (ny, nx):
        |grad u_par| at each z wall (sgs.f90:117-143 z rows) from
        face(side) -> (A, B), the jumps of u and v across the wall face
        (interior row minus ghost row).  A face that is no wall takes the
        other wall's plane; without z walls both are zero, shaped `like`.
        bprev(side): B's row -1 (nx,), from the halo on a slab or the
        y-row stacks with y walls, where the periodic roll along y would
        take the plane's own last row; aprev(side): A's column -1 (ny,),
        from the x stacks with x walls."""
        if not self.have_zwalls:
            z = torch.zeros_like(like[0])
            return z, z
        nz = self.cfg.ng[2]

        def plane(side):
            A, B = face(side)
            return self._shear(A, B, None if bprev is None else bprev(side),
                               float(self.grid.dzci[0 if side == 0 else nz]),
                               None if aprev is None else aprev(side))
        lo = plane(0) if self.lo_wall else None
        hi = plane(1) if self.hi_wall else None
        return (hi if lo is None else lo), (lo if hi is None else hi)

    def _ywall_shear_planes(self, u, w, we, yq, xq=None):
        """The y walls' van Driest shear planes (tauw_ylo, tauw_yhi),
        (nz, nx), from the post-correction fill's y-row stacks yq (as the
        z walls' from its z-edge stacks): the jumps of u and w across each
        y face, w's row below z = 0 from its z-edge stack and corners; with
        x walls u's column x = -1 from its x stack xq[0] (whose columns
        carry the y ghosts).  On a slab of a y-walled mesh (yq the slab's
        own fill's) each plane is made on the slab that owns its wall and
        is zero on the others, and one all_reduce gives every slab both:
        van Driest weighs the nearer wall, which a slab may not hold.  On a
        pencil the planes are its columns', the jumps' column -1 from u's
        x halo xq (whose rows carry the y ghosts), and the sum runs over
        the mesh column (the pencils of its x columns)."""
        (yu, _), _, (yw, cw) = yq
        dyi = self.cfg.dli[1]

        def plane(side):
            r, g = (0, 0) if side == 0 else (-1, 2)
            aprev = None
            if xq is not None:
                xu = xq[0][0]
                # padded y rows r and its ghost, at index row + 1
                jr, jg = (1, 0) if side == 0 else (-2, -1)
                aprev = xu[:, 0, jr] - xu[:, 0, jg]
            return self._shear(u[:, r] - yu[:, g], w[:, r] - yw[:, g],
                               we[0][r] - cw[0, g], dyi, aprev)
        if self.yown is None:
            return plane(0), plane(1)
        both = torch.stack([plane(side) if self.yown[side]
                            else torch.zeros_like(u[:, 0])
                            for side in range(2)])
        both = self.mesh.column_sum(both)
        return both[0], both[1]

    def _xwall_shear_planes(self, v, w, we, xq, vrow=None):
        """The x walls' van Driest shear planes (tauw_xlo, tauw_xhi),
        (nz, ny), from the post-correction fill's x stacks xq: the jumps of
        v and w across each x face (the interior's first or last column
        minus the ghost column, sgs.f90:117-143 x rows), v's row -1 wrapped,
        or where the stacks carry the rows -1 and ny (y walls, a slab) from
        vrow (nz, nx), v's row -1 (its y-row stack's, or on a slab its
        halo's) and the x stack's y ghost, w's row below z = 0 from its
        z-edge stack and the x stack's corners.  A face that is no wall
        takes the other's plane.  On a slab each plane is its rows' (x is
        never split: no reduction)."""
        (xv, _), (xw, cw) = xq[1], xq[2]
        js = slice(1, -1) if xv.shape[2] == v.shape[1] + 2 else slice(None)
        dxi = self.cfg.dli[0]

        def plane(side):
            i, c = (0, 0) if side == 0 else (-1, 2)
            aprev = None
            if vrow is not None:
                aprev = vrow[:, i] - xv[:, c, 0]
            return self._shear(v[:, :, i] - xv[:, c, js],
                               w[:, :, i] - xw[:, c, js],
                               we[0][:, i] - cw[0, c, js], dxi, aprev)
        sides = self.xwall_sides
        lo = plane(0) if 0 in sides else None
        hi = plane(1) if 1 in sides else None
        return (hi if lo is None else lo), (lo if hi is None else hi)

    def _sgs_stage(self, u, v, w, zq, vlo, yq=None, xq=None):
        """nu_t of the post-correction fill (main.f90:504-506), its z-edge
        stacks zq, with y walls its y-row stack pairs yq (made here from
        vlo when not given) and with x walls its x stack pairs xq, by the
        smag or dsmag kernel, or by dsmag's two passes."""
        cfg = self.cfg
        ue, ve, we = zq
        if self.ywalled and yq is None:
            yq = self._yedge_vel(u, v, w, self._dynamic_bcs(u, v, w),
                                 vlo=vlo, is_correc=True)
        dxi, dyi = cfg.dli[0], cfg.dli[1]
        if self.sgs_kernel == 'smag':
            # the post-correction fill's ghost rows (cales_tpu
            # _compute_sgs_kernel); on a slab the halos of u, v, w, with y
            # walls their y-row stacks, and v's wall jump on the row below
            # from either.  With a wall model the strain reads the one-sided
            # extrapolation on the wall-modelled faces (sgs.extrapolate,
            # cales_tpu sgs.smag_visct), the fill's own ghosts elsewhere;
            # with x walls the x stacks' corners too, and on a slab the
            # halos of the extrapolated stacks (the neighbours' 'E' ghosts),
            # while the wall jump keeps the fill's.  With y walls on a slab
            # the slab's y-row stacks of the fill (its own wall rows, the
            # neighbours' rows elsewhere: boundary.slab_ystack) take the
            # extrapolation, y first, then z, on the walls the slab owns
            # only (ext_flags), so that the halo rows' 'E' z ghosts are the
            # neighbours' own
            setup = self.sgs_setup
            slab_y = self.yown is not None and not self.xhalo
            if slab_y:
                # with x walls the x stacks' rows -1 and nyl ride the same
                # exchange
                h = self.mesh.halo_y(list(zip((u, v, w), zq))
                                     + _xstack_halo_pairs(xq or (), True))
                yq = self._yslab((u, v, w), zq, yq, h[:3])
                if self.xwalled:
                    xq = _xstacks_on_slab(xq, h[3:], self.yown)
            ext = None
            if self.has_wm:
                ext = [sgsmod.extrapolate_stacks(q, e, y, iface,
                                                 self.ext_flags,
                                                 setup.fac_lwm)
                       for q, e, y, iface in zip((u, v, w), zq,
                                                 yq or (None,) * 3,
                                                 (1, 2, 3))]
            yh = ye = ywall = xh = None
            rows = corners = None
            if self.xhalo:
                # a pencil: the y halos of u, v, w (with gy = 1 y is
                # periodic) and their x halos, whose u serves the z walls'
                # shear planes' column x = -1 (and with y walls the y
                # walls'); with y walls the pencil's y-row stacks, the x
                # halos' wall rows the x neighbours'
                pairs = list(zip((u, v, w), zq))
                yh, xh = self._pencil_halos(pairs, pairs, walls=yq)
                if yq is not None:
                    yq = ye = self._yslab((u, v, w), zq, yq, yh)
                    yh = None
                    rows, corners = yq[1]
                elif yh is not None:
                    rows, corners = yh[1]
            elif self.mesh is not None and not slab_y:
                strain_e = zq if ext is None else [e for e, _ in ext]
                pairs = list(zip((u, v, w), strain_e))
                if ext is not None:
                    pairs.append((ve, None))
                # with x walls the x stacks' rows -1 and nyl ride the
                # exchange (the fill's: a wall model's 'E' corners are
                # extrapolated from them below)
                h = self.mesh.halo_y(pairs + _xstack_halo_pairs(xq or ()))
                if self.xwalled:
                    xq = _xstacks_on_slab(xq, h[len(pairs):])
                yh = h[:3]
                # v's rows, and its fill's corners (the fourth pair's
                # rows with a wall model)
                rows = yh[1][0]
                corners = yh[1][1] if ext is None else h[3][0]
            elif self.ywalled:
                rows, corners = yq[1]
                ye = yq

            def bprev(side):
                k, e = (0, 0) if side == 0 else (-1, 2)
                return rows[k, 0] - corners[e, 0]
            aprev = xe = xwall = None
            if xh is not None:
                # u's column x = -1 at the z walls from its x halo
                xu, cu = xh[0]

                def aprev(side):
                    k, e = (0, 0) if side == 0 else (-1, 2)
                    return xu[k, 0, 1:-1] - cu[e, 0, 1:-1]
            if self.xwalled:
                # u's column x = -1 at the z walls from its x stack, the
                # x walls' shear planes from the x stacks (v's row -1 from
                # its y-row stack or, on a slab, its halo)
                xu, cu = xq[0]
                js = (slice(1, -1) if xu.shape[2] == u.shape[1] + 2
                      else slice(None))

                def aprev(side):
                    k, e = (0, 0) if side == 0 else (-1, 2)
                    return xu[k, 0, js] - cu[e, 0, js]
                if self.xwall_prof is not None:
                    vrow = None if rows is None else rows[:, 0]
                    xwall = (*self.xwall_prof, *self._xwall_shear_planes(
                        v, w, we, xq, vrow))
                xe = xq
            tauw_lo, tauw_hi = self._wall_shear_planes(
                lambda side: ((u[0] - ue[0], v[0] - ve[0]) if side == 0
                              else (u[-1] - ue[2], v[-1] - ve[2])), u,
                bprev=None if rows is None else bprev, aprev=aprev)
            if self.ywalled:
                ywall = (self.dwy_t, self.nearylo_t,
                         *self._ywall_shear_planes(u, w, we, yq,
                                                   xq if self.xwalled
                                                   else xh))
            if ext is not None:
                (ue, ve, we), ye_ext = zip(*ext)
                if self.ywalled:
                    ye = ye_ext
                if xe is not None:
                    xe = [(c, sgsmod.extrapolate_stacks(
                        c, e, None, iface, setup.lwm_flags,
                        setup.fac_lwm)[0]) for (c, e), iface in
                        zip(xq, (1, 2, 3))]
            return kernels.smag(u, v, w, ue, ve, we, self.dzci_t,
                                self.dzfi_t, dxi, dyi, cfg.visc,
                                self.csd2_t, self.dw_t, self.nearlo_t,
                                tauw_lo, tauw_hi,
                                have_zwalls=self.have_zwalls, yh=yh, ye=ye,
                                ywall=ywall, xe=xe, xwall=xwall, xh=xh)
        if self.dsmag_twopass:
            return self._dsmag_twopass(u, v, w, zq, yq)
        return self._dsmag_onepass(u, v, w, zq, yq)

    def _dsmag_reduce(self):
        """The reduction of the dsmag sums over the ranks that share their
        rows: none on one device; 'duct''s (z, y) rows over the mesh row
        (a slab's are its own), the z rows over the world."""
        if self.mesh is None:
            return None
        if self.cfg.dsmag_avg == 'duct':
            return self.mesh.row_sum
        return self.mesh.all_reduce

    def _dsmag_onepass(self, u, v, w, zq, yq=None):
        """The one-pass dynamic model on the post-correction fill (its
        z-edge stacks zq, with y walls its y-row stack pairs yq): |S| and
        the partial sums of num and den from kernels.dsmag, then the
        average.  On a slab the kernel reads two y rows a side of u, v, w
        from the neighbours (its velocity tile's halo; cales_tpu's
        fused_dsmag_onepass ystrips), and the z rows' sums of num and den
        are reduced over the ranks before the ratio, one all_reduce of
        2 nz values; with y walls the kernel takes the slab's y-row stacks
        too and applies the wall recipes on the sides the slab owns.  On a
        pencil (gx > 1) it reads two columns a side too, with their
        (x +-1..2, y +-1..2) corners (_pencil_halos at depth 2: the x halo
        then its rows in the y exchange; cales_tpu _dsmag_xext,
        timeloop.py:486-509), and the z rows' sums are reduced over all
        gy gx ranks in that one all_reduce (mesh.all_reduce is the
        world's)."""
        cfg = self.cfg
        yh = xh = None
        reduce = self._dsmag_reduce()
        if self.xhalo:
            # with y walls the pencil's y-row stacks beside the two-row y
            # halo, the x halos' wall rows the x neighbours'; 'duct' sums
            # over the mesh row, 'cavity' stays on the pencil
            pairs = list(zip((u, v, w), zq))
            yh, xh = self._pencil_halos(pairs, pairs, depth=2, walls=yq)
            if yq is not None:
                yq = self._yslab((u, v, w), zq, yq, yh)
        elif self.mesh is not None:
            yh = self.mesh.halo_y(list(zip((u, v, w), zq)), depth=2)
            if self.yown is not None:
                # y walls: the slab's stacks (rows -1, nyl-1, nyl) beside
                # the halo's rows -2 and nyl+1; 'duct' and 'cavity' stay on
                # the slab, 'channel' and 'dit' reduce as with periodic y
                yq = self._yslab((u, v, w), zq, yq, yh)
        avg = cfg.dsmag_avg
        s0, num, den = kernels.dsmag(u, v, w, *zq, self.alph2_t,
                                     self.dzci_t, self.dzfi_t, cfg.dli[0],
                                     cfg.dli[1], self.lo_wall, self.hi_wall,
                                     self.dsmag_zvals, ye=yq,
                                     yvals=self.dsmag_yvals, avg=avg,
                                     zper=self.zper, f2d=cfg.filter_2d, yh=yh,
                                     yown=self.yown, xh=xh)
        return s0 if avg == 'cavity' else _dsmag_ratio(
            s0, num, den, avg, self.dit_w_t, reduce=reduce)

    def _dsmag_twopass(self, u, v, w, zq, ye=None):
        """The two-pass dynamic model (cales_tpu _compute_dsmag_kernel):
        dsmag_level1 on the post-correction fill, the filtered velocity's
        BC fill with the static planes (sgs.f90:256-257) as edge stacks,
        which carry the wall-normal face values, then dsmag_level2.  On a
        slab (cales_tpu's fused_dsmag_level1 / level2 under shard_map,
        timeloop.py:1429-1500) level1 reads two y rows a side of u, v, w
        from the neighbours (the exchange of the one pass), the filtered
        velocity's fill is the slab's own (z-edge stacks; with y walls its
        y-row stacks on the sides the slab owns), level2 reads one y row a
        side of it (one more exchange), and the z rows' sums of num and den
        are reduced over the ranks before the ratio ('channel', 'dit'); with
        y walls both levels take the slab's y-row stacks and the wall
        recipes on the walls it owns.  On a pencil (gx > 1) level1 reads
        two columns a side too (_pencil_halos at depth 2, as the one
        pass), level2 one column a side of the filtered velocity with its
        (x +-1, y +-1) corners (_pencil_halos at depth 1, after the
        filtered velocity's own fill, so that the halos' z-edge entries
        are that fill's), and the z rows' sums reduce over all gy gx
        ranks in the one all_reduce."""
        cfg = self.cfg
        dxi, dyi = cfg.dli[0], cfg.dli[1]
        yh = xh = yown = None
        reduce = self._dsmag_reduce()
        if self.xhalo:
            pairs = list(zip((u, v, w), zq))
            yh, xh = self._pencil_halos(pairs, pairs, depth=2)
        elif self.mesh is not None:
            yh = self.mesh.halo_y(list(zip((u, v, w), zq)), depth=2)
            if self.yown is not None:
                ye = self._yslab((u, v, w), zq, ye, yh)
                yown = self.yown
        fm, (fu, fv, fw), lij, s0 = kernels.dsmag_level1(
            u, v, w, *zq, self.dzci_t, self.dzfi_t, dxi, dyi, self.lo_wall,
            self.hi_wall, ye=ye, yh=yh, yown=yown, xh=xh)
        fze = self._zedge_vel(fu, fv, fw, self.bcu_vals, self.bcv_vals,
                              self.bcw_vals, is_correc=False)
        fye = self._yedge_vel(fu, fv, fw) if self.ywalled else None
        fyh = fxh = None
        if self.xhalo:
            fpairs = list(zip((fu, fv, fw), fze))
            fyh, fxh = self._pencil_halos(fpairs, fpairs)
        elif self.mesh is not None:
            fyh = self.mesh.halo_y(list(zip((fu, fv, fw), fze)))
            if self.yown is not None:
                fye = self._yslab((fu, fv, fw), fze, fye, fyh)
                fyh = None
        avg = cfg.dsmag_avg
        out = kernels.dsmag_level2(fu, fv, fw, *fze, fm, lij, s0,
                                   self.alph2_t, self.dzci_t, self.dzfi_t,
                                   dxi, dyi, avg=avg, ye=fye, yh=fyh,
                                   yown=yown, xh=fxh)
        return out if avg == 'cavity' else _dsmag_ratio(
            s0, *out, avg, self.dit_w_t, reduce=reduce)

    def _cn_stage(self, u, v, w, f, alpha):
        """Crank-Nicolson Helmholtz solves (main.f90:423-491): the momentum
        kernel already emitted u_RK - 1/2 f12 rd.  impdiff_1d: z-only
        solves, the forcing rides the Thomas pass as its RHS shift and the
        z-face planes (scaled by alpha) enter rows 0 / n_solve - 1.
        Full-3D: the forcing is added to the CN RHS, then add_rhs_bound with
        the alpha-scaled planes and poisson.solve with alpha per component
        (cales_tpu timeloop.py:2339-2345, 2374-2413); on a slab the planes'
        rows on the local grid and poisson.solve_sharded with alpha (the
        forcing is the mean over the ranks, _bulk_forcing's).  The z-only
        solves need no communication: on a slab they run on its rows."""
        cfg = self.cfg
        if not cfg.impdiff_1d:
            out = []
            for ivel, fld in enumerate((u, v, w)):
                if cfg.is_forced[ivel]:
                    fld = fld + f[ivel]
                if self.cn_planes[ivel] is not None:
                    cbc = tuple((self.cbcvel[0][d][ivel],
                                 self.cbcvel[1][d][ivel]) for d in range(3))
                    planes = {k: alpha * q
                              for k, q in self.cn_planes[ivel].items()}
                    fld = poisson.add_rhs_bound(self.cfg_local,
                                                _C_OR_F[ivel], cbc, fld,
                                                planes)
                sv = self.solver_vel[ivel]
                out.append(poisson.solve(sv, fld, alpha=alpha)
                           if self.mesh is None else
                           poisson.solve_sharded(sv, fld, self.mesh,
                                                 alpha=alpha))
            return out
        out = []
        for ivel, fld in enumerate((u, v, w)):
            shift = f[ivel:ivel + 1] if self.cfg.is_forced[ivel] else None
            zp = self.cn_planes[ivel]
            bc = None if zp is None else (alpha * zp[('z', 0)],
                                          alpha * zp[('z', 1)])
            out.append(poisson.solve_z_only(self.solver_vel[ivel], fld, alpha,
                                            shift=shift, bc_planes=bc))
        return out

    def _advance_wall_planes(self, state, pp, ppe, we2, dtrk, ypred=None,
                             ypp=None, xpred=None, xpp=None):
        """The kept wall-face planes through the padded correc sweep
        (correc.f90:45-67), each over its whole padded plane as the JAX
        package's expression path leaves it (stencil.correc): w's lower z
        face, and with y walls v's lower y face, with x walls u's lower x
        face (cales_tpu timeloop.py:1680-1850).  Interior entries are the
        prediction fill's face minus the pressure gradient across it;
        ghost entries the same of the fill's ghost rows and columns (the
        y-row and x stacks and their corners), or the periodic wrap.  With
        periodic z the w plane is the corrected periodic ghost row, which
        no fill reads (the JAX package carries it the same way).  ypred,
        xpred: the prediction fill's (rows, corners) and (cols, corners)
        pairs of (u, v, w); ypp, xpp: pp's.  The x and y planes are unused
        under periodic x and y."""
        dzci0 = float(self.grid.dzci[0])
        wlo = we2[0] - dtrk * dzci0 * (pp[0] - ppe[0])
        if self.ywalled:
            (_, _), (yv, zyv), (_, zyw) = ypred
            yp, zyp = ypp
            # w's lower face at padded y 0 and ny+1: the corner stacks' rows
            w_y = [zyw[0, r] - dtrk * dzci0 * (yp[0, r] - zyp[0, r])
                   for r in (0, 2)]
            wlo = torch.cat([w_y[0][None], wlo, w_y[1][None]], dim=0)
        else:
            wlo = torch.cat([wlo[-1:], wlo, wlo[:1]], dim=0)

        def wrap_y(a):
            # an x stack's (..., ny) entries with the periodic y ghosts;
            # with y walls they carry their own
            return a if self.ywalled else torch.cat(
                [a[..., -1:], a, a[..., :1]], dim=-1)

        def xcols(a, lo, hi):
            # a's x ghost columns (..., ny+2, nx) -> (..., ny+2, nx+2)
            if lo is None:
                return torch.cat([a[..., -1:], a, a[..., :1]], dim=-1)
            return torch.cat([lo[..., None], a, hi[..., None]], dim=-1)
        w_x = (None, None)
        if self.xwalled:
            zxw = xpred[2][1]
            xp, zxp = xpp
            # w's lower face at padded x 0 and nx+1: the corner stacks'
            # columns over the padded y rows
            w_x = [wrap_y(zxw[0, r] - dtrk * dzci0 * (xp[0, r] - zxp[0, r]))
                   for r in (0, 2)]
        wlo = xcols(wlo, *w_x)
        if not self.ywalled and not self.xwalled:
            return (state.vlo[0], state.vlo[1], wlo)
        vlo_v = state.vlo[1]
        if self.ywalled:
            dyi = self.cfg.dli[1]
            # v's lower y face (padded y 0): the prediction's face minus
            # dt dyi (pp's first row - its ghost row), its z ghosts from the
            # corner stacks
            vlo_i = yv[:, 0] - dtrk * dyi * (pp[:, 0, :] - yp[:, 0])
            v_zlo = zyv[0, 0] - dtrk * dyi * (ppe[0][0] - zyp[0, 0])
            v_zhi = zyv[2, 0] - dtrk * dyi * (ppe[2][0] - zyp[2, 0])
            vlo_v = torch.cat([v_zlo[None], vlo_i, v_zhi[None]], dim=0)
            v_x = (None, None)
            if self.xwalled:
                # its x ghost columns: the x stacks' y ghost row 0 (v's
                # lower face at x = -1, nx) over the padded z rows
                Xv = kernels.zpad(*xpred[1])
                Xp = kernels.zpad(*xpp)
                v_x = [Xv[:, r, 0] - dtrk * dyi * (Xp[:, r, 1] - Xp[:, r, 0])
                       for r in (0, 2)]
            vlo_v = xcols(vlo_v, *v_x)
        ulo = state.vlo[0]
        if self.xwalled:
            dxi = self.cfg.dli[0]
            # u's lower x face (padded x 0) over the padded (z, y) plane:
            # the prediction's face column minus dt dxi (pp at x = 0 - its
            # ghost column)
            Xu = wrap_y(kernels.zpad(*xpred[0])[:, 0])
            Xp = wrap_y(kernels.zpad(*xpp)[:, 0])
            p0 = kernels.zpad(pp[:, :, 0], ppe[:, :, 0])
            if self.ywalled:
                p0 = kernels.ypad(p0[:, :, None], kernels.zpad(
                    yp[:, :, :1], zyp[:, :, :1]))[..., 0]
            else:
                p0 = wrap_y(p0)
            ulo = Xu - dtrk * dxi * (p0 - Xp)
        return (ulo, vlo_v, wlo)

    def _kept_xface(self, xu, bcu_z):
        """u's lower x face over the padded (z, y) plane as the fill leaves
        it, from u's x stack pair xu of that fill: the column x = 0 wrapped
        along y (plane-valued values run with periodic y), its z ghost rows
        by u's z recipe with the values bcu_z, a plane's own y-ghost
        entries at the (z ghost, y ghost) corners (the sequential x -> y ->
        z fill's z pass)."""
        nz = xu[0].shape[0]
        col = xu[0][:, 0]
        col = torch.cat([col[:, -1:], col, col[:, :1]], dim=1)
        vals = tuple(b[:, :1] if bnd._is_plane(b) else b for b in bcu_z)
        return bnd._set_centered(
            col[:, :, None], 0, (self.cbcvel[0][2][0], self.cbcvel[1][2][0]),
            vals, (float(self.grid.dzc[0]), float(self.grid.dzc[nz])))[..., 0]

    def _substep(self, state: State, f1, f2, first=False):
        """One RK3 substep.  first=True: f2 == 0 exactly (RK_COEFF[0][1]),
        so the previous-RHS fields are not read."""
        cfg, grid = self.cfg, self.grid
        dxi, dyi = cfg.dli[0], cfg.dli[1]
        dtrk = f1 + f2
        u, v, w, p, visct = state.u, state.v, state.w, state.p, state.visct
        ru_o, rv_o, rw_o = state.rhs_old

        # momentum + RK: the edge stacks of the previous post-correction
        # fill are the kernel input (rebuilt from vlo for a carried state;
        # cales_tpu runs the wall model again here, timeloop.py:1877-1882,
        # to the same planes)
        zq, yq, xq = state.zq, state.yq, state.xq
        if (zq is None or (self.ywalled and yq is None)
                or (self.xwalled and xq is None)):
            bcs0 = self._dynamic_bcs(u, v, w)
            if zq is None:
                zq = self._zedge_vel(u, v, w, *bcs0, vlo=state.vlo,
                                     is_correc=True)
            if self.ywalled:
                yq = self._yedge_vel(u, v, w, bcs0, vlo=state.vlo,
                                     is_correc=True)
            if self.xwalled:
                xq = self._xedge_vel(u, v, w, bcs0, vlo=state.vlo,
                                     is_correc=True)
        ue, ve, we = zq
        pe = self._zedge_p(p)
        s, se = (visct, self._zedge_s(visct)) if self.has_sgs else (None, None)
        # the passive scalar with the same velocity (rk_scal with the
        # beginning-of-substep velocity, rk.f90:123-195): its stacks from
        # its own BC table, the wall model's planes never among them
        # (cales_tpu timeloop.py:252-258)
        sca = scae = None
        if self.has_scal:
            sca = state.s
            scae = self._zedge_scal(sca)
        ye = yh = xh = None
        if self.ywalled:
            # the y rows of the same (post-correction) fill
            ye = (*yq, self._yedge_s(visct) if self.has_sgs else None,
                  self._yedge_p(p))
            if self.has_scal:
                ye = (*ye, self._yedge_scal(sca))
        # with x walls the x columns of the same fill (and the scalar's)
        xe = ((*xq, self._xedge_s(visct) if self.has_sgs else None,
               self._xedge_p(p)) if self.xwalled else None)
        if xe is not None and self.has_scal:
            xe = (*xe, self._xedge_scal(sca))
        if self.xhalo:
            # a pencil: the x neighbours' columns of the same fill and of
            # the scalar, their rows -1 and nyl in the y exchange of the
            # rows; with y walls the pencil's stacks (the y-walled
            # variant), the x halos' wall rows the x neighbours' stacks'
            fields, edges = (u, v, w, s, p, sca), (ue, ve, we, se, pe, scae)
            hy, xh = self._pencil_halos(
                [(q, e) for q, e in zip(fields, edges) if q is not None],
                list(zip(fields, edges)),
                walls=None if ye is None else (*ye, None, None)[:6])
            if hy is not None:
                h = iter(hy)
                yh = tuple(None if q is None else next(h) for q in fields)
            if ye is not None:
                ye = self._yslab(fields, edges, ye, yh)
                yh = None
        elif self.mesh is not None:
            # the neighbours' rows of the same fill and of the scalar, one
            # exchange; with x walls their x stacks' rows ride it
            fields, edges = (u, v, w, s, p, sca), (ue, ve, we, se, pe, scae)
            pairs = [(q, e) for q, e in zip(fields, edges) if q is not None]
            h = self.mesh.halo_y(pairs + _xstack_halo_pairs(
                xe or (), self.ywalled))
            if xe is not None:
                xe = _xstacks_on_slab(xe, h[len(pairs):], self.yown)
            h = iter(h[:len(pairs)])
            yh = tuple(None if q is None else next(h) for q in fields)
            if self.yown is not None:
                # with y walls the slab's stacks, the y-walled variant
                ye = self._yslab(fields, edges, ye, yh)
                yh = None
        scal_kw = {}
        if self.has_scal:
            scal_kw = dict(sca=sca, scae=scae,
                           rso=None if first else state.dsdt_old,
                           scal=self.scal_params)
        outs = kernels.mom_rk(
            u, v, w, s, p, ue, ve, we, se, pe,
            None if first else ru_o, None if first else rv_o,
            None if first else rw_o, self.dzci_t, self.dzfi_t, f1, f2,
            cfg.visc, dxi, dyi, cfg.bforce, sums=self.sum_flags,
            split=self.split, ye=ye, yh=yh, xe=xe, xh=xh, **scal_kw)
        u, v, w, ru, rv, rw, usum, vsum = outs[:8]
        scal = {}
        if self.has_scal:
            s_new, dsdt = outs[8:]
            if cfg.is_sforced:
                # the scalar's bulk forcing, weighted by gvr_f as cales_tpu
                # weighs it (timeloop.py:2285, 2536); on a mesh over the
                # ranks
                s_new = s_new + (cfg.scalf
                                 - self._bulk_mean_t(s_new, self.gvr_f_t))
            scal = dict(s=s_new, dsdt_old=dsdt)
        f, fuv, w = self._bulk_forcing((usum, vsum), w)
        alpha = 0.0
        if cfg.impdiff:
            alpha = -0.5 * cfg.visc * dtrk
            u, v, w = self._cn_stage(u, v, w, f, alpha)
            fuv = None      # the forcing went into the CN solves

        # projection: prediction fill as edge stacks (w's wall-face rewrite
        # in row 1 of we2; with y walls v's in row 1 of its y rows),
        # fillps, solve, fused correction.  The fill takes the static
        # values: the wall model's planes would set only the wall-parallel
        # ghosts (u's and v's z ghost rows, u's and w's y ghost rows),
        # which no kernel reads here (fillps takes div u, so v's y rows,
        # and w's; correc_smag and correc_updatep the interior rows of u
        # and v, w's stack and v's y rows; v and w stay 'D' on their own
        # faces), so it is not run (cales_tpu runs it with the deferred
        # forcing, timeloop.py:2568-2569, to the same state).  Only the
        # kept v plane's z-ghost rows (vlo[1], from v's corner stacks)
        # differ from cales_tpu's, and every fill crops them; with x walls
        # the kept u plane's (vlo[0]) are taken from the post-correction
        # fill below.  With x walls u's rewrite column (padded x nx)
        # rides in its x stack,
        # which fillps and correc_updatep read in place of u's last
        # column (cales_tpu patches a copy of u instead).
        ue2, ve2, we2 = self._zedge_vel(u, v, w, self.bcu_vals,
                                        self.bcv_vals, self.bcw_vals,
                                        is_correc=False)
        ypred = self._yedge_vel(u, v, w) if self.ywalled else None
        yv2 = None if ypred is None else ypred[1]
        # (v's only for its lower y face's x ghosts, with y walls).  With
        # a wall model the fill takes its planes here, whose columns x =
        # 0 and nx reach u's x stack's corners and so the kept inflow
        # face's z ghost rows (vlo[0]; cales_tpu runs the wall model in
        # every fill, timeloop.py:2572-2583)
        xpred = (self._xedge_vel(u, v, w, fields=(0, 1, 2) if self.ywalled
                                 else (0, 2)) if self.xwalled else None)
        xu2 = None if xpred is None else xpred[0]
        hv2 = hu2 = None
        if self.xhalo:
            # a pencil: v's y halo and u's x halo (with y walls its rows
            # -1 and nyl on the walls the pencil holds the neighbours'
            # wall rows)
            hy, (hu2,) = self._pencil_halos(
                [(v, ve2)], [(u, ue2)],
                walls=None if ypred is None else ypred[:1])
            hv2 = None if hy is None else hy[0]
        elif self.mesh is not None:
            hv2 = self.mesh.halo_y([(v, ve2)])[0]
        if self.yown is not None:
            yv2 = bnd.slab_ystack(v, ve2, yv2, hv2, self.yown)
            hv2 = None
        rhs = kernels.fillps(u, v, w, ue2, ve2, we2, self.dzfi_t, 1.0 / dtrk,
                             dxi, dyi, yv=yv2, yh=hv2, xu=xu2, xh=hu2)
        rhs = poisson.add_rhs_bound(self.cfg_local, ('c', 'c', 'c'),
                                    self.cbcpre, rhs, self.rhsb_p)
        if self.mesh is None:
            pp = poisson.solve(self.solver_p, rhs)
        else:
            pp = poisson.solve_sharded(self.solver_p, rhs, self.mesh)
        ppe = self._zedge_p(pp)
        ypp = self._yedge_p(pp) if self.ywalled else None
        xpp = self._xedge_p(pp) if self.xwalled else None
        hpp = xhpp = None
        if self.xhalo:
            # a pencil: pp's y and x halos
            hy, (xhpp,) = self._pencil_halos(
                [(pp, ppe)], [(pp, ppe)],
                walls=None if ypp is None else (ypp,))
            hpp = None if hy is None else hy[0]
        elif self.mesh is not None:
            hpp = self.mesh.halo_y([(pp, ppe)])[0]
        # the kernels' pp stack: on a slab of a y-walled mesh the slab's
        # (the kept planes below take the wall recipe's, on its owner)
        ypp_k = ypp
        if self.yown is not None:
            ypp_k = bnd.slab_ystack(pp, ppe, ypp, hpp, self.yown)
            hpp = None
        planes = None
        if self.fused_smag:
            u, v, w, p, visct, planes = self._correc_smag_fused(
                u, v, w, pp, p, ue2, ve2, we2, ppe, dtrk, fuv)
        else:
            u, v, w, p = kernels.correc_updatep(
                u, v, w, pp, p, we2, ppe, dtrk, dxi, dyi, self.dzci_t,
                self.dzfi_t, fuv, alpha=alpha, impdiff=cfg.impdiff,
                impdiff_1d=cfg.impdiff_1d, ypp=ypp_k,
                yv=None if yv2 is None else yv2[0], yh=hpp, xpp=xpp,
                xu=xu2, xh=xhpp)
        vlo = self._advance_wall_planes(state, pp, ppe, we2, dtrk,
                                        ypred=ypred, ypp=ypp, xpred=xpred,
                                        xpp=xpp)
        # post-correction fill (main.f90:500-501, is_correc=.true.): the
        # wall model runs here, once a substep; with the fused correction
        # its planes are the fused correction's, made from the same
        # corrected rows (cales_tpu makes them again)
        bcs = self._dynamic_bcs(u, v, w, planes)
        zq = self._zedge_vel(u, v, w, *bcs, vlo=vlo, is_correc=True)
        yq = (self._yedge_vel(u, v, w, bcs, vlo=vlo, is_correc=True)
              if self.ywalled else None)
        xq = (self._xedge_vel(u, v, w, bcs, vlo=vlo, is_correc=True)
              if self.xwalled else None)
        if self.xwalled and any(bnd._is_plane(b) for b in bcs[0][2]):
            # u's z values are planes (the wall model's, a moving lid): the
            # kept inflow face's z ghost rows are the post-correction
            # fill's, as cales_tpu's fill leaves them (the prediction's
            # wall-model planes differ, and so, at the (z ghost, y ghost)
            # corners, does the y wrap)
            vlo = (self._kept_xface(xq[0], bcs[0][2]), *vlo[1:])
        if self.sgs_kernel:
            visct = self._sgs_stage(u, v, w, zq, vlo, yq, xq)
        return state._replace(u=u, v=v, w=w, p=p, visct=visct, vlo=vlo,
                              rhs_old=(ru, rv, rw), zq=zq, yq=yq, xq=xq,
                              **scal), f

    def _step_impl(self, state: State, dt: float):
        """One time step = 3 RK substeps (main.f90:417-507)."""
        dpdl = torch.zeros(3, dtype=self.dtype, device=self.device)
        for irk in range(3):
            f1 = RK_COEFF[irk][0] * dt
            f2 = RK_COEFF[irk][1] * dt
            state, f = self._substep(state, f1, f2,
                                     first=(RK_COEFF[irk][1] == 0.0))
            dpdl = dpdl + f
        state = state._replace(time=state.time + dt, istep=state.istep + 1)
        return state, -dpdl / dt

    def step(self, state: State, dt):
        """Advance one step; returns (state, dpdl).  Queues device work and
        returns without waiting for it."""
        return self._step_impl(state, float(dt))

    def multi_step(self, state: State, dt, nsteps: int) -> State:
        """Advance `nsteps` steps."""
        for _ in range(nsteps):
            state, _ = self._step_impl(state, float(dt))
        return state

    # ------------------------------------------------------------------
    def _chk_impl(self, state: State):
        """dt limit + divergence diagnostics (chkdt.f90, chkdiv.f90); on a
        mesh each rank's slab with its halos, reduced over the ranks."""
        cfg = self.cfg
        up, vp, wp, _, sp = self._padded(state, with_p=False)
        eps = float(torch.finfo(self.dtype).eps)
        dt_cfl = st.cfl_dt(up, vp, wp, sp, cfg.visc, cfg.dl, self.grid.dzci,
                           self.grid.dzfi, cfg.impdiff, cfg.impdiff_1d, eps)
        mask = (False,) * 3
        if cfg.mask_divergence_check:
            mask = tuple(cfg.cbc_pre(d) != 'PP' for d in range(3))
        if self.yown is not None and mask[1]:
            # the masked y-wall cell rows are the owners' first or last:
            # drop them from the padded slabs (their ghost the next row)
            ys = slice(int(self.yown[0]), up.shape[1] - int(self.yown[1]))
            up, vp, wp = (q[:, ys] for q in (up, vp, wp))
            mask = (mask[0], False, mask[2])
        divtot, divmax = st.divergence(up, vp, wp, cfg.dli[0], cfg.dli[1],
                                       self.grid.dzfi, mask=mask)
        if self.mesh is not None:
            red = self.mesh.reduce_scalar
            return (red(dt_cfl, 'min'), red(divtot, 'sum'),
                    red(divmax, 'max'))
        return dt_cfl, divtot, divmax

    def _padded(self, state: State, with_p=True):
        """(up, vp, wp, ppad or None, sppad): the ghost-filled fields with
        the solver's BC semantics (the post-correction fill); on a mesh
        this rank's slabs, their y ghosts the neighbours' rows."""
        bcu, bcv, bcw = self._dynamic_bcs(state.u, state.v, state.w)
        if self.mesh is None:
            up, vp, wp, _ = self._pad_vel(state.u, state.v, state.w, bcu,
                                          bcv, bcw, vlo=state.vlo,
                                          is_correc=True)
            return (up, vp, wp, self._pad_p(state.p) if with_p else None,
                    self._pad_s(state.visct))
        fields = [state.u, state.v, state.w, state.visct]
        edges = [*self._zedge_vel(state.u, state.v, state.w, bcu, bcv, bcw,
                                  vlo=state.vlo, is_correc=True),
                 self._zedge_s(state.visct)]
        walls = xs = None
        if self.yown is not None:
            walls = [*self._yedge_vel(state.u, state.v, state.w,
                                      (bcu, bcv, bcw), vlo=state.vlo,
                                      is_correc=True),
                     self._yedge_s(state.visct)]
        if self.xwalled:
            xs = [*self._xedge_vel(state.u, state.v, state.w,
                                   (bcu, bcv, bcw), vlo=state.vlo,
                                   is_correc=True),
                  self._xedge_s(state.visct)]
        if with_p:
            fields.append(state.p)
            edges.append(self._zedge_p(state.p))
            if walls is not None:
                walls.append(self._yedge_p(state.p))
            if xs is not None:
                xs.append(self._xedge_p(state.p))
        out = self._halo_padded(fields, edges, walls, xs)
        return (*out[:3], out[4] if with_p else None, out[3])

    def check(self, state: State):
        """(dt_cfl, divtot, divmax) as python floats."""
        return tuple(float(x) for x in self._chk_impl(state))

    def global_numpy(self, f):
        """A field as a global (nz, ny, nx) numpy array: on a mesh gathered
        from the ranks (every rank takes part)."""
        if self.mesh is None:
            return f.detach().cpu().numpy()
        return self.mesh.gather(f)

    def padded_state(self, state: State):
        """Ghost-filled (up, vp, wp, ppad, sppad) numpy arrays with the
        solver's BC semantics, for the statistics layer (io/stats.py)."""
        return tuple(a.cpu().numpy() for a in self._padded(state))

    def pick_dt(self, dt_cfl: float) -> float:
        cfg = self.cfg
        if cfg.dt_f > 0:
            return cfg.dt_f
        return min(cfg.cfl * dt_cfl, cfg.dtmax)
