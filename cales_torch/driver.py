"""Simulation driver: counterpart of cales_tpu/driver.py (reference
main.f90:28-632) on one torch device, or on a y-slab mesh when the
namelist's dims asks for one (dims(1:2) = gy, 1: one process a rank,
launched by ``python -m torch.distributed.run --nproc_per_node gy -m
cales_torch input.nml``).

Config validation -> grid -> solver setup -> initial condition or restart
-> time loop with the stopping rules (nstep / time_max / tw_max), cadenced
stability and divergence checks with hard aborts (main.f90:523-544),
scalar logs (time.out, forcing.out), channel statistics, plane/volume
outputs, checkpoint rotation (a passive scalar's in the scal.bin
sidecar) and per-step wall time (main.f90:613-618).
Output formats are the JAX package's (the copies in cales_torch/io), fed
numpy arrays.  On a mesh every rank steps its slab; the checks, the bulk
means and the statistics reduce over the ranks, the checkpoint is written
slab by slab into one fld.bin (io/sharded.py), the plane and volume
outputs gather the fields, and rank 0 alone logs and writes files.  A
world size that is not gy, or a transport that cannot serve the ranks,
raises: the driver never retries on one device.
"""
from __future__ import annotations

import math
import time as _time
from functools import reduce
from pathlib import Path

import numpy as np
import torch

from .config import Config, validate
from .grid import make_grid_from_config
from .initflow import initflow
from .io import checkpoint as ckpt
from .io import output as out
from .io import sharded as shio

from .timeloop import Simulation


class SimulationAborted(RuntimeError):
    pass


def _np(a):
    return a.detach().cpu().numpy()


def run(cfg: Config, datadir='data', device='cuda', verbose=True,
        max_steps=None, hooks=None, mesh=None, transport=None):
    """Run a full simulation on `device`.  Returns (sim, state).

    hooks: optional {'out1d' | 'out2d' | 'out3d': fn(sim, state, istep)}
    replacing the default outputs at their cadences.  With dims > 1 the
    run is one rank of a device mesh, y slabs (gx = 1) or pencils (gx >
    1): `mesh` (parallel/mesh.SlabMesh), or
    one started here from the torch.distributed.run environment over
    `transport` ('nccl': a card a rank, the default on cuda; 'gloo': the
    CPU, or CUDA tensors staged through the host so that ranks can share
    a card); the state is then this rank's slabs or pencils."""
    validate(cfg)
    datadir = Path(datadir)
    own_mesh = False
    if cfg.dims[0] * cfg.dims[1] > 1 and mesh is None:
        from .parallel import mesh as meshmod
        transport = transport or ('nccl' if torch.device(device).type ==
                                  'cuda' else 'gloo')
        mesh, device = meshmod.from_env(cfg.dims, cfg.ng, device, transport)
        own_mesh = True
    verbose = verbose and (mesh is None or mesh.rank == 0)
    datadir.mkdir(parents=True, exist_ok=True)
    grid = make_grid_from_config(cfg)
    sim = Simulation(cfg, grid, device=device, mesh=mesh)
    try:
        return _run(sim, cfg, grid, datadir, verbose, max_steps, hooks or {})
    finally:
        if own_mesh:
            torch.distributed.destroy_process_group()


def _run(sim, cfg, grid, datadir, verbose, max_steps, hooks):
    mesh = sim.mesh
    rank0 = mesh is None or mesh.rank == 0
    log(verbose, f'*** Execution path: {sim.exec_path()} ***')
    if rank0:
        out.write_grid_files(datadir, cfg, grid)

    if cfg.restart:
        if mesh is not None:
            # each rank reads its slabs (the MPI-IO subarray analogue)
            u, v, w, p, t0, istep0 = shio.load_checkpoint_sharded(
                datadir / 'fld.bin', cfg.ng, cfg.np_dtype, mesh)
        else:
            u, v, w, p, t0, istep0 = ckpt.load_checkpoint(
                datadir / 'fld.bin', cfg.ng, cfg.np_dtype)
        s = None
        if cfg.scalar:
            # the scalar lives in a sidecar (fld.bin stays the reference's);
            # restarting without it would reset s to its initial field
            spath = datadir / 'scal.bin'
            if not spath.exists():
                raise FileNotFoundError(
                    'restart with scalar=True requires data/scal.bin '
                    '(scalar sidecar checkpoint)')
            if mesh is not None:
                s, _, _ = shio.load_checkpoint_sharded(
                    spath, cfg.ng, cfg.np_dtype, mesh, nfields=1)
            else:
                s, _, _ = ckpt.load_scalar(spath, cfg.ng, cfg.np_dtype)
        state = sim.initial_state(u, v, w, p, s)
        state = state._replace(time=state.time + t0,
                               istep=state.istep + istep0)
        log(verbose, f'*** Checkpoint loaded at time = {t0}, step = {istep0} ***')
    else:
        u, v, w, p = initflow(cfg, grid)
        state = sim.initial_state(u, v, w, p)
        log(verbose, '*** Initial condition successfully set ***')

    dt_cfl, divtot, divmax = sim.check(state)
    dt = sim.pick_dt(dt_cfl)
    log(verbose, f'dt_cfl = {dt_cfl:.6e}, dt = {dt:.6e}')

    small = math.sqrt(np.finfo(cfg.np_dtype).eps) * 10
    twi = _time.perf_counter()
    savecounter = 0
    kill = False
    is_done = False
    nsteps_done = 0
    averager = None
    if cfg.stats_avg:
        from .io.averaging import RunningMean
        averager = RunningMean()

    # advance between host-side events in one multi_step call: chunk = gcd
    # of the active cadences, so no cadence is skipped
    cadences = [c for c in (cfg.icheck, cfg.iout0d, cfg.iout1d, cfg.iout2d,
                            cfg.iout3d, cfg.isave) if c > 0]
    if cfg.stop_type[0]:
        cadences.append(max(cfg.nstep, 1))
    chunk = max(reduce(math.gcd, cadences) if cadences else 1, 1)
    if max_steps is not None:
        chunk = max(math.gcd(chunk, max_steps), 1)

    dpdl = None
    while not is_done:
        t_step = _time.perf_counter()
        chunk_now = chunk
        if cfg.stop_type[1] and dt > 0:
            steps_left = max(int(math.ceil((cfg.time_max - state.time)
                                           / dt - 1e-9)), 1)
            if steps_left < chunk_now:
                chunk_now = 1
        if chunk_now > 1:
            state = sim.multi_step(state, dt, chunk_now - 1)
            nsteps_done += chunk_now - 1
        state, dpdl = sim.step(state, dt)
        istep = state.istep
        tnow = state.time
        nsteps_done += 1

        # stopping criteria (main.f90:513-522)
        if cfg.stop_type[0] and istep >= cfg.nstep:
            is_done = True
        if cfg.stop_type[1] and tnow >= cfg.time_max:
            is_done = True
        if cfg.stop_type[2]:
            hours = (_time.perf_counter() - twi) / 3600.0
            if mesh is not None:
                # the ranks' clocks differ: they stop together, on the
                # slowest one (the reference's MPI_ALLREDUCE of the wall
                # time with MAX), or their collectives fall out of step
                hours = mesh.reduce_scalar(hours, 'max')
            if hours >= cfg.tw_max:
                is_done = True
        if max_steps is not None and nsteps_done >= max_steps:
            is_done = True

        # stability & divergence checks (main.f90:523-544)
        if cfg.icheck > 0 and istep % max(cfg.icheck, 1) == 0:
            dt_cfl, divtot, divmax = sim.check(state)
            dt = sim.pick_dt(dt_cfl)
            if dt_cfl < small:
                log(verbose, 'ERROR: time step is too small. Aborting...')
                is_done, kill = True, True
            if divmax > small or math.isnan(divtot):
                log(verbose, f'ERROR: maximum divergence too large '
                             f'({divmax:.3e}). Aborting...')
                is_done, kill = True, True

        # scalar logs (main.f90:548-573)
        if cfg.iout0d > 0 and istep % max(cfg.iout0d, 1) == 0:
            if rank0:
                out.out0d(datadir / 'time.out', [istep, dt, tnow])
            if any(cfg.is_forced) or any(abs(b) > 0 for b in cfg.bforce):
                mv = [0.0, 0.0, 0.0]
                if cfg.is_forced[0] or abs(cfg.bforce[0]) > 0:
                    mv[0] = sim.bulk_mean(state.u, sim.gvr_f)
                if cfg.is_forced[1] or abs(cfg.bforce[1]) > 0:
                    mv[1] = sim.bulk_mean(state.v, sim.gvr_f)
                if cfg.is_forced[2] or abs(cfg.bforce[2]) > 0:
                    mv[2] = sim.bulk_mean(state.w, sim.gvr_c)
                dp = _np(dpdl)
                if not any(cfg.is_forced):
                    dp = -np.asarray(cfg.bforce)
                if rank0:
                    out.out0d(datadir / 'forcing.out',
                              [tnow, dp[0], dp[1], dp[2], mv[0], mv[1],
                               mv[2]])

        # profile / plane / volume outputs (main.f90:574-589)
        if cfg.iout1d > 0 and istep % max(cfg.iout1d, 1) == 0:
            if 'out1d' in hooks:
                hooks['out1d'](sim, state, istep)
            else:
                # the reference's out1d.h90 channel statistics; the padded
                # fields come from the solver, so io.stats never needs jax
                from .io import stats as st_io
                padded = sim.padded_state(state)
                u_, v_, w_, p_, s_ = (_np(a) for a in (state.u, state.v,
                                                       state.w, state.p,
                                                       state.visct))
                # on a mesh: the slabs' plane means, averaged over the ranks
                kw = dict(padded=padded, write=rank0,
                          reduce=None if mesh is None else mesh.mean_of_ranks)
                sp = st_io.single_point_chan(
                    datadir / f'stats_{istep:07d}', cfg, grid, u_, v_, w_,
                    p_, s_, **kw)
                bu = st_io.reystr_budget_chan(
                    datadir / f'stats_{istep:07d}', cfg, grid, u_, v_, w_,
                    p_, **kw)
                if averager is not None and rank0:
                    from .io import averaging as avg_io
                    averager.add('sp', sp)
                    averager.add('budget', bu)
                    averager.tick()
                    avg_io.write_profile(datadir / 'stats_avg_chan.out',
                                         grid, averager.mean('sp'),
                                         averager.n)
                    avg_io.write_profile(
                        datadir / 'stats_avg_chan_reystr_budget.out',
                        grid, averager.mean('budget'), averager.n)
        if cfg.iout2d > 0 and istep % max(cfg.iout2d, 1) == 0:
            if 'out2d' in hooks:
                hooks['out2d'](sim, state, istep)
            else:
                ny = cfg.ng[1]
                for name, f in (('u', state.u), ('v', state.v),
                                ('w', state.w), ('p', state.p)):
                    f = sim.global_numpy(f)
                    if not rank0:
                        continue
                    fn = datadir / f'{name}_2d_{istep:07d}.bin'
                    out.out2d(fn, f, 1, ny // 2)
                    out.write_log_output(datadir / 'log_visu_2d_slice_1.out',
                                         fn.name, name, (1, ny // 2, 1),
                                         (cfg.ng[0], ny // 2, cfg.ng[2]),
                                         (1, 1, 1), tnow, istep)
        if cfg.iout3d > 0 and istep % max(cfg.iout3d, 1) == 0:
            if 'out3d' in hooks:
                hooks['out3d'](sim, state, istep)
            else:
                nskip = tuple(cfg.nskip_out3d)
                for name, f in (('u', state.u), ('v', state.v),
                                ('w', state.w), ('p', state.p)):
                    f = sim.global_numpy(f)
                    if not rank0:
                        continue
                    fn = datadir / f'{name}_{istep:07d}.bin'
                    out.write_field_bin(fn, f, nskip=nskip)
                    out.write_log_output(datadir / 'log_visu_3d.out', fn.name,
                                         name, (1, 1, 1), cfg.ng, nskip,
                                         tnow, istep)

        # checkpoint (main.f90:590-611)
        if (cfg.isave > 0 and istep % max(cfg.isave, 1) == 0) or \
                (is_done and not kill):
            if cfg.is_overwrite_save:
                filename = 'fld.bin'
            else:
                if cfg.nsaves_max > 0:
                    if savecounter >= cfg.nsaves_max:
                        savecounter = 0
                    savecounter += 1
                    filename = f'fld_{savecounter:04d}.bin'
                    if rank0:
                        out.out0d(datadir / 'log_checkpoints.out',
                                  [istep, tnow, savecounter])
                else:
                    filename = f'fld_{istep:07d}.bin'
            if mesh is not None:
                    shio.save_checkpoint_sharded(
                    datadir / filename, (state.u, state.v, state.w, state.p),
                    mesh, tnow, istep)
            else:
                ckpt.save_checkpoint(datadir / filename, _np(state.u),
                                     _np(state.v), _np(state.w),
                                     _np(state.p), tnow, istep)
            if cfg.scalar:
                # the scalar's sidecar beside it, slab by slab on a mesh
                sname = filename.replace('fld', 'scal')
                if mesh is not None:
                    shio.save_checkpoint_sharded(datadir / sname, (state.s,),
                                                 mesh, tnow, istep)
                else:
                    ckpt.save_scalar(datadir / sname, _np(state.s), tnow,
                                     istep)
                if not cfg.is_overwrite_save and rank0:
                    ckpt.gen_alias(datadir, sname, alias='scal.bin')
            if not cfg.is_overwrite_save and rank0:
                ckpt.gen_alias(datadir, filename)
            log(verbose, f'*** Checkpoint saved at time = {tnow}, '
                         f'step = {istep} ***')

        if sim.device.type == 'cuda':
            torch.cuda.synchronize(sim.device)
        dt_wall = _time.perf_counter() - t_step
        log(verbose, f'step {istep}  t = {tnow:.6e}  dt = {dt:.3e}  '
                     f'wall = {dt_wall:.3f}s'
                     + (f' ({chunk_now} steps/call)' if chunk_now > 1 else ''))

    if kill:
        raise SimulationAborted('simulation aborted (see log)')
    log(verbose, '*** Fim ***')
    return sim, state


def log(verbose, msg):
    if verbose:
        print(msg, flush=True)
