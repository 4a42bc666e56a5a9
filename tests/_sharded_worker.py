"""One rank of the device-mesh checks of tests/test_torch_sharded.py and
tests/test_torch_pencil*.py.

    python tests/_sharded_worker.py <workdir> <rank> <world_size>

Starts a gloo process group on a ``file://`` store in <workdir>, reads the
cases of <workdir>/cases.json with their inputs in <workdir>/in.npz, runs
them (each with the environment variables of its 'env', if any) on this
rank's slabs, or with a case's 'dims' (gy, gx) its pencils, on the CPU
(the kernels' plain twins) and, on
rank 0, writes what the test compares to <workdir>/out.npz.  It imports
torch and cales_torch only: the JAX references stay in the test process.
"""
from __future__ import annotations

import json
import os
import sys
import types
from pathlib import Path

import numpy as np
import torch

torch.set_num_threads(1)


def _mesh(work, rank, world):
    from cales_torch.parallel import comm, mesh
    comm.init_process_group('gloo', rank, world,
                            init_method=f'file://{work}/store')
    c = comm.Comm('gloo', torch.device('cpu'))
    return lambda ng, dims=None: mesh.SlabMesh(
        c, tuple(dims) if dims else (world, 1), ng)


def case_comm(m, inp, out, key):
    """halo_y and both transposes of a global field, and the sums."""
    g = torch.as_tensor(inp[f'{key}.field'])
    e = torch.as_tensor(inp[f'{key}.edge'])
    loc, eloc = m.local(g), m.local(e)
    (rows, corners), = m.halo_y([(loc, eloc)])
    blocks = loc.reshape(*loc.shape[:2], m.gy, m.nxl).permute(2, 0, 1, 3)
    xcols = m.transpose_y_to_x(blocks.contiguous())
    back = m.transpose_x_to_y(xcols)
    total = m.all_reduce(loc.sum(dim=(1, 2)))
    peak = m.reduce_scalar(float(loc.abs().max()), 'max')
    parts = {'rows': rows, 'corners': corners, 'xcols': xcols,
             'back': back.permute(1, 2, 0, 3).reshape(loc.shape),
             'total': total,
             'peak': torch.tensor(peak, dtype=torch.float64)}
    for name, t in parts.items():
        gathered = m.comm.all_gather(t.contiguous())
        out[f'{key}.{name}'] = np.stack([q.numpy() for q in gathered])


def case_pencil_comm(m, inp, out, key):
    """On a pencil mesh: a global field's x halo (mesh.halo_x) with its
    rows -1 and nyl from the y exchange (timeloop._pencil_halos' path), its
    y halo, and the re-slab of the Poisson solve there and back."""
    from cales_torch.timeloop import _xstack_halo_pairs, _xstacks_on_slab
    g = torch.as_tensor(inp[f'{key}.field'])
    e = torch.as_tensor(inp[f'{key}.edge'])
    loc, eloc = m.local(g), m.local(e)
    xs = m.halo_x([(loc, eloc)])
    h = m.halo_y([(loc, eloc)] + _xstack_halo_pairs(xs))
    (cols, corners), = _xstacks_on_slab(xs, h[1:])
    slab = m.pencil_to_slab(loc)
    parts = {'xcols': cols, 'xcorners': corners, 'rows': h[0][0],
             'corners': h[0][1], 'slab': slab,
             'back': m.slab_to_pencil(slab)}
    for name, t in parts.items():
        gathered = m.comm.all_gather(t.contiguous())
        out[f'{key}.{name}'] = np.stack([q.numpy() for q in gathered])


def case_pencil_halo2(m, inp, out, key):
    """On a pencil mesh: a global field's two-deep x halo (mesh.halo_x at
    depth 2) with its rows -2, -1, nyl and nyl+1 from the depth-2 y
    exchange (timeloop._pencil_halos at depth 2, the dsmag kernel's
    path), and that exchange's rows."""
    from cales_torch.timeloop import _xstack_halo_pairs, _xstacks_on_slab
    g = torch.as_tensor(inp[f'{key}.field'])
    e = torch.as_tensor(inp[f'{key}.edge'])
    loc, eloc = m.local(g), m.local(e)
    xs = m.halo_x([(loc, eloc)], depth=2)
    h = m.halo_y([(loc, eloc)] + _xstack_halo_pairs(xs), depth=2)
    (cols, corners), = _xstacks_on_slab(xs, h[1:])
    parts = {'xcols2': cols, 'xcorners2': corners, 'rows2': h[0][0],
             'corners2': h[0][1]}
    for name, t in parts.items():
        gathered = m.comm.all_gather(t.contiguous())
        out[f'{key}.{name}'] = np.stack([q.numpy() for q in gathered])


def case_halo2(m, inp, out, key):
    """halo_y at depth 2 of a global field and its edge stack, and of a
    field without one."""
    g = torch.as_tensor(inp[f'{key}.field'])
    e = torch.as_tensor(inp[f'{key}.edge'])
    (rows, corners), (rows_b, none) = m.halo_y(
        [(m.local(g), m.local(e)), (m.local(g)[:2], None)], depth=2)
    assert none is None
    for name, t in (('rows2', rows), ('corners2', corners),
                    ('rows2b', rows_b)):
        gathered = m.comm.all_gather(t.contiguous())
        out[f'{key}.{name}'] = np.stack([q.numpy() for q in gathered])


def _config(kw):
    from cales_torch.config import Config
    kw = dict(kw)
    for name in ('l', 'ng', 'is_forced', 'velf', 'dims', 'stop_type'):
        if name in kw:
            kw[name] = tuple(kw[name])
    for name in ('cbcvel', 'cbcpre', 'cbcsgs', 'bcvel', 'lwm', 'cbcscal',
                 'bcscal'):
        if name in kw:
            kw[name] = json_tuple(kw[name])
    if 'bcvel' in kw:
        # a plane-valued value (an inflow profile, a lid) came as nested
        # lists
        kw['bcvel'] = tuple(tuple(tuple(
            np.asarray(b) if isinstance(b, tuple) else b for b in comps)
            for comps in face) for face in kw['bcvel'])
    return Config(**kw)


def json_tuple(x):
    return tuple(json_tuple(q) for q in x) if isinstance(x, list) else x


def case_solve(m, inp, out, key, kw, ivel=None, alpha=None):
    """The slab-sharded Poisson solve of a global RHS, or with ivel and
    alpha velocity component ivel's Helmholtz solve (I + alpha L) (the
    full-3D CN stage's), each solver as the Simulation makes it (its
    ptransform and zsolver the config's)."""
    from cales_torch import poisson
    from cales_torch.config import effective_cbcvel
    from cales_torch.grid import make_grid_from_config
    from cales_torch.timeloop import _C_OR_F
    cfg = _config(kw)
    grid = make_grid_from_config(cfg)
    if ivel is None:
        sv = poisson.make_solver(cfg, grid, tuple(cfg.cbc_pre(d) for d in
                                                 range(3)), ('c', 'c', 'c'),
                                 zsolver=cfg.zsolver)
    else:
        cbc = effective_cbcvel(cfg)
        sv = poisson.make_solver(cfg, grid, tuple(
            cbc[0][d][ivel] + cbc[1][d][ivel] for d in range(3)),
            _C_OR_F[ivel], zsolver=cfg.zsolver)
    rhs = torch.as_tensor(m.local(inp[f'{key}.rhs']))
    out[f'{key}.p'] = m.gather(poisson.solve_sharded(sv, rhs, m,
                                                     alpha=alpha))


def case_steps(m, inp, out, key, kw, nsteps):
    """nsteps steps of the Simulation on the slabs from global fields,
    then the sharded checkpoint written and read back (and with a passive
    scalar its scal.bin sidecar written slab by slab)."""
    from cales_torch.grid import make_grid_from_config
    from cales_torch.io import sharded
    from cales_torch.timeloop import Simulation
    cfg = _config(kw)
    sim = Simulation(cfg, make_grid_from_config(cfg), device='cpu', mesh=m)
    st = sim.initial_state(*(inp[f'{key}.{q}'] for q in 'uvwp'))
    dt = float(inp[f'{key}.dt'])
    for _ in range(nsteps):
        st, _ = sim.step(st, dt)
    for name in ('u', 'v', 'w', 'p', 'visct'):
        out[f'{key}.{name}'] = m.gather(getattr(st, name))
    if st.s is not None:
        out[f'{key}.s'] = m.gather(st.s)
        sharded.save_checkpoint_sharded(
            Path(inp['workdir'].item()) / f'{key}.scal.bin', (st.s,), m,
            st.time, st.istep)
    # the kept wall planes: v's lower y face from rank 0 (the lower y
    # wall's owner), w's lower z face over the slabs' rows, its y ghost
    # rows from the ranks that own the y walls; on a pencil mesh w's
    # lower z face's interior, and with y walls (vlo1p, vlo2p) v's lower
    # y face over the interior columns of the pencils of iy = 0 and w's
    # lower z face with its y ghost rows from the wall-owning pencils
    # (the x ghost columns of a pencil's planes are its own wrap)
    if m.gx > 1:
        out[f'{key}.vlo2i'] = m.gather(
            st.vlo[2][None, 1:-1, 1:-1].contiguous())[0]
        if not cfg.cbc_pre(1) == 'PP':
            out[f'{key}.vlo1p'] = m.gather(
                st.vlo[1][:, None, 1:-1].contiguous())[:, 0]
            ends = m.gather(st.vlo[2][None, [0, -1], 1:-1].contiguous())[0]
            out[f'{key}.vlo2p'] = np.concatenate(
                [ends[:1], out[f'{key}.vlo2i'], ends[-1:]])
    out[f'{key}.vlo1'] = st.vlo[1].numpy()
    # u's lower x face over the slabs' rows (its y ghost rows, periodic
    # copies that no fill reads, stay out)
    out[f'{key}.vlo0'] = np.concatenate(
        [q.numpy()[:, 1:-1] for q in m.comm.all_gather(
            st.vlo[0].contiguous())], axis=1)
    w2 = [q.numpy() for q in m.comm.all_gather(st.vlo[2].contiguous())]
    out[f'{key}.vlo2'] = np.concatenate(
        [w2[0][:1]] + [q[1:-1] for q in w2] + [w2[-1][-1:]])
    out[f'{key}.check'] = np.array(sim.check(st))
    out[f'{key}.bulk'] = np.array(sim.bulk_mean(st.u, sim.gvr_f))
    out[f'{key}.names'] = np.array(sim.kernel_names())
    path = Path(inp['workdir'].item()) / f'{key}.fld.bin'
    sharded.save_checkpoint_sharded(path, (st.u, st.v, st.w, st.p), m,
                                    st.time, st.istep)
    u, v, w, p, t, istep = sharded.load_checkpoint_sharded(
        path, cfg.ng, cfg.np_dtype, m)
    same = all(np.array_equal(a, b.numpy()) for a, b in
               zip((u, v, w, p), (st.u, st.v, st.w, st.p)))
    ok = m.reduce_scalar(float(same and t == st.time and istep == st.istep),
                         'min')
    out[f'{key}.readback'] = np.array(ok)


def case_wmplanes(m, inp, out, key, kw):
    """The wall model's planes of global fields on this rank's slab, as
    the step makes them (Simulation._wm_planes: the z faces' sampled rows'
    halos through the mesh, the y faces on their owners), gathered: the
    face (d, ib) of rank r as {key}.r{r}.f{d}{ib}."""
    from cales_torch.grid import make_grid_from_config
    from cales_torch.timeloop import Simulation
    cfg = _config(kw)
    sim = Simulation(cfg, make_grid_from_config(cfg), device='cpu', mesh=m)
    u, v, w = (torch.as_tensor(m.local(inp[f'{key}.{q}'])) for q in 'uvw')
    mine = {f'{f.d}{f.ib}': q.numpy() for f, q in
            zip(sim.wm_run.faces, sim._wm_planes(u, v, w))}
    every = [None] * m.gy
    torch.distributed.all_gather_object(every, mine)
    for r, faces in enumerate(every):
        for name, q in faces.items():
            out[f'{key}.r{r}.f{name}'] = q


def case_driver(m, out, key, kw, datadir):
    """driver.run on the slabs under the wall-time stop rule, with rank 0's
    clock two hours ahead of the others' after its first reading: the
    ranks must agree to stop, at the same step, and write one fld.bin."""
    from cales_torch import driver
    real = driver._time
    readings = []

    def clock():
        readings.append(None)
        skew = 7200.0 if m.rank == 0 and len(readings) > 1 else 0.0
        return real.perf_counter() + skew
    driver._time = types.SimpleNamespace(perf_counter=clock)
    try:
        _, st = driver.run(_config(kw), datadir=datadir, device='cpu',
                           verbose=False, mesh=m)
    finally:
        driver._time = real
    out[f'{key}.istep'] = np.array(
        [int(q) for q in m.comm.all_gather(torch.tensor([st.istep]))])


def case_scal_restart(m, out, key, kw, datadir):
    """driver.run on the slabs (with a passive scalar or without) to
    nstep, its last step saved (fld.bin and with a scalar the scal.bin
    sidecar, slab by slab), then a restart from those files for one step
    more: the gathered scalar after the first run (u without a scalar),
    its time, and u (and s) after the restart go to the parent."""
    import shutil
    from cales_torch import driver
    cfg = _config(kw)
    first, again = datadir / 'first', datadir / 'restart'
    _, st = driver.run(cfg, datadir=first, device='cpu', verbose=False,
                       mesh=m)
    names = ('u', 's') if st.s is not None else ('u',)
    out[f'{key}.{names[-1]}1'] = m.gather(getattr(st, names[-1]))
    out[f'{key}.t1'] = np.array(st.time)
    if m.rank == 0:
        again.mkdir()
        for name in ('fld.bin', 'scal.bin')[:len(names)]:
            shutil.copy(first / name, again / name)
    m.barrier()
    _, st = driver.run(cfg.replace(restart=True, nstep=cfg.nstep + 1),
                       datadir=again, device='cpu', verbose=False, mesh=m)
    for name in names:
        out[f'{key}.{name}2'] = m.gather(getattr(st, name))


def main(work, rank, world):
    work = Path(work)
    make = _mesh(work, rank, world)
    cases = json.loads((work / 'cases.json').read_text())
    inp = dict(np.load(work / 'in.npz'))
    inp['workdir'] = np.array(str(work))
    out = {}
    for case in cases:
        # a case's environment (CALES_DSMAG_TWOPASS) for its run only
        saved = {k: os.environ.get(k) for k in case.get('env', {})}
        os.environ.update(case.get('env', {}))
        m = make(tuple(case['ng']), case.get('dims'))
        kind = case['kind']
        if kind == 'comm':
            case_comm(m, inp, out, case['key'])
        elif kind == 'pencil_comm':
            case_pencil_comm(m, inp, out, case['key'])
        elif kind == 'pencil_halo2':
            case_pencil_halo2(m, inp, out, case['key'])
        elif kind == 'halo2':
            case_halo2(m, inp, out, case['key'])
        elif kind == 'solve':
            case_solve(m, inp, out, case['key'], case['cfg'],
                       case.get('ivel'), case.get('alpha'))
        elif kind == 'wmplanes':
            case_wmplanes(m, inp, out, case['key'], case['cfg'])
        elif kind == 'driver':
            case_driver(m, out, case['key'], case['cfg'],
                        work / case['key'])
        elif kind in ('scal_restart', 'restart'):
            case_scal_restart(m, out, case['key'], case['cfg'],
                              work / case['key'])
        else:
            case_steps(m, inp, out, case['key'], case['cfg'],
                       case['nsteps'])
        for k, val in saved.items():
            if val is None:
                os.environ.pop(k)
            else:
                os.environ[k] = val
    if rank == 0:
        np.savez(work / 'out.npz', **out)
    torch.distributed.destroy_process_group()


if __name__ == '__main__':
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
