"""cales_torch on a y-slab mesh (dims = (gy, 1)) on the CPU: ranks spawned
as processes on a gloo process group with a ``file://`` store under the
test's tmp_path, each running tests/_sharded_worker.py on its slabs with
the kernels' plain twins; the references are the JAX package's, computed
here.  One spawn runs several cases.

  * apply_x's plain version against JAX pallas_solve.apply_x (interpret
    mode) at (nz, ny, nx) = (8, 8, 128), f64, within 1e-12;
  * halo_y, the two pencil transposes and the reductions at gy = 2 and 4
    against slicing of the global array, exactly;
  * solve_sharded at gy = 2 and 4 against JAX poisson.solve (XLA, one
    device), f64, within 1e-11 after removing the mean (the constant mode's
    gauge: the sharded z stage is Thomas, pinned, the single-device one the
    eigen stage, projected);
  * 2 steps of the static-Smagorinsky channel and the 'none' channel at
    gy = 2 (and the smag channel at gy = 4) against JAX
    Simulation(use_pallas=False), f64: u, v, w, nu_t within 1e-11, p
    within 1e-11 after removing its mean; the CFL dt and divmax;
  * the sharded checkpoint byte-identical to the single-process writer,
    and read back;
  * driver.run's wall-time stop rule: ranks whose clocks disagree stop at
    the same step and write one checkpoint;
  * mom_rk's halo twin on a slab whose halos are cut from the whole field
    equals the periodic twin on the whole field's rows (the construction
    of python -m cales_torch.fma_probe);
  * the mesh's refusals: unsupported() for what stays refused (x and y
    walls with the wall model, x walls with dsmag, the 2D test filter
    with y walls, a slab thinner than the dsmag kernel's halo, ...),
    a world size that is not gy, a transport the ranks cannot use; what
    runs on the mesh (the impdiff_1d, wall-modelled and dsmag channels, the
    passive scalar, the two-pass dsmag and the 2D test filter too, full-3D
    implicit diffusion, the developing channel, x walls with y walls, the
    wall model, the scalar and an inflow profile, whose steps
    tests/test_torch_sharded_imp.py, test_torch_sharded_les.py,
    test_torch_sharded_scalar.py, test_torch_sharded_twopass.py,
    test_torch_sharded_imp3d.py, test_torch_sharded_xwalls.py,
    test_torch_sharded_xywalls.py and test_torch_sharded_xwm.py hold).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cales_tpu import poisson as jpoisson
from cales_tpu.config import Config as JaxConfig
from cales_tpu.grid import make_grid_from_config as jax_grid
from cales_tpu.initflow import initflow
from cales_tpu.ops import pallas_solve
from cales_tpu.timeloop import Simulation as JaxSimulation

from cales_torch.config import Config
from cales_torch.io import checkpoint as ckpt
from cales_torch.ops import solve_kernels as SK
from cales_torch.parallel import comm, mesh
from cales_torch.timeloop import unsupported

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / '_sharded_worker.py'
CHAN_BCS = dict(
    cbcvel=((('P', 'P', 'P'), ('P', 'P', 'P'), ('D', 'D', 'D')),) * 2,
    cbcpre=(('P', 'P', 'N'), ('P', 'P', 'N')),
    cbcsgs=(('P', 'P', 'D'), ('P', 'P', 'D')))
# the LES headline (bench.py channel_les_smag, chip_smoke.py phase 4m) at a
# test size: static Smagorinsky + van Driest, bulk forcing along x,
# stretched z walls, the all-matrix solve
SMAG = dict(ng=(64, 32, 16), l=(2 * np.pi, np.pi, 2.0), gtype=1, gr=1.0,
            visci=20_000.0, inivel='log', is_wallturb=True,
            is_forced=(True, False, False), velf=(1.0, 0.0, 0.0),
            sgstype='smag', dtype='float64', ptransform='mat', **CHAN_BCS)
NONE = dict(SMAG, sgstype='none')
TOL = {'u': 1e-11, 'v': 1e-11, 'w': 1e-11, 'p': 1e-11, 'visct': 1e-11}
# the developing channel's x faces (inflow u = 1 at x = 0, outflow at x =
# lx: u 'N', p 'D'), periodic y, z walls; XDUCT_BCS the developing duct's,
# with y walls
XDEV_BCS = dict(
    cbcvel=((('D', 'N', 'N'), ('P', 'P', 'P'), ('D', 'D', 'D')),
            (('N', 'N', 'N'), ('P', 'P', 'P'), ('D', 'D', 'D'))),
    bcvel=(((1.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 0.0, 0.0)),) * 2,
    cbcpre=(('N', 'P', 'N'), ('D', 'P', 'N')),
    cbcsgs=(('N', 'P', 'D'), ('N', 'P', 'D')), is_forced=(False,) * 3)
XDUCT_BCS = dict(
    XDEV_BCS,
    cbcvel=((('D', 'N', 'N'), ('D', 'D', 'D'), ('D', 'D', 'D')),
            (('N', 'N', 'N'), ('D', 'D', 'D'), ('D', 'D', 'D'))),
    cbcpre=(('N', 'N', 'N'), ('D', 'N', 'N')),
    cbcsgs=(('N', 'D', 'D'), ('N', 'D', 'D')))


def _spawn(tmp_path, gy, cases, inputs):
    """Run the cases on gy ranks; returns rank 0's out.npz as a dict."""
    work = tmp_path / f'gy{gy}'
    work.mkdir()
    (work / 'cases.json').write_text(json.dumps(cases))
    np.savez(work / 'in.npz', **inputs)
    env = dict(os.environ, OMP_NUM_THREADS='1')
    env['PYTHONPATH'] = str(ROOT) + os.pathsep + env.get('PYTHONPATH', '')
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(work),
                               str(r), str(gy)], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(gy)]
    errs = []
    for r, proc in enumerate(procs):
        try:
            _, err = proc.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        if proc.returncode != 0:
            errs.append(f'rank {r} exit {proc.returncode}:\n{err[-3000:]}')
    assert not errs, '\n'.join(errs)
    return dict(np.load(work / 'out.npz')), work


def _perturbed(kw, seed=20261017, scale=1e-2):
    """initflow of the JAX package plus a seeded, x/y/z-asymmetric
    perturbation (the symmetric start hides halo faults)."""
    jcfg = JaxConfig(**kw, use_pallas=False)
    grid = jax_grid(jcfg)
    rng = np.random.default_rng(seed)
    fields = [np.asarray(f) + scale * rng.standard_normal(np.shape(f))
              for f in initflow(jcfg, grid)]
    return jcfg, grid, fields


def _jax_steps(kw, nsteps):
    jcfg, grid, fields = _perturbed(kw)
    sim = JaxSimulation(jcfg, grid)
    st = sim.initial_state(*fields)
    dt = sim.pick_dt(sim.check(st)[0])
    for _ in range(nsteps):
        st, _ = sim.step(st, dt)
    return fields, dt, st, sim.check(st)


def _jax_solve(kw, rhs):
    jcfg = JaxConfig(**kw, use_pallas=False)
    grid = jax_grid(jcfg)
    sv = jpoisson.make_solver(jcfg, grid, tuple(jcfg.cbc_pre(d)
                                                for d in range(3)),
                              ('c', 'c', 'c'))
    return np.asarray(jpoisson.solve(sv, rhs))


def _gauge(a):
    return a - a.mean()


def _comm_inputs(key, ng, rng):
    nx, ny, nz = ng
    return {f'{key}.field': rng.standard_normal((nz, ny, nx)),
            f'{key}.edge': rng.standard_normal((3, ny, nx))}


def _check_comm(out, inputs, key, gy):
    g, e = inputs[f'{key}.field'], inputs[f'{key}.edge']
    nz, ny, nx = g.shape
    nyl, nxl = ny // gy, nx // gy
    for r in range(gy):
        lo, hi = (r * nyl - 1) % ny, ((r + 1) * nyl) % ny
        np.testing.assert_array_equal(out[f'{key}.rows'][r][:, 0], g[:, lo])
        np.testing.assert_array_equal(out[f'{key}.rows'][r][:, 1], g[:, hi])
        np.testing.assert_array_equal(out[f'{key}.corners'][r][:, 0],
                                      e[:, lo])
        np.testing.assert_array_equal(out[f'{key}.corners'][r][:, 1],
                                      e[:, hi])
        np.testing.assert_array_equal(out[f'{key}.xcols'][r],
                                      g[:, :, r * nxl:(r + 1) * nxl])
        np.testing.assert_array_equal(out[f'{key}.back'][r],
                                      g[:, r * nyl:(r + 1) * nyl])
        assert out[f'{key}.peak'][r] == np.abs(g).max()
    # the plane sums over the ranks (torch and numpy sum in other orders)
    np.testing.assert_allclose(out[f'{key}.total'][0], g.sum(axis=(1, 2)),
                               rtol=1e-13, atol=1e-13)


def _check_steps(out, key, jst, jchk, kw, work, nsteps, bulk=1.0,
                 zthomas='thomas_z'):
    """The fields of 2 steps on the slabs against the JAX package's, the
    checks, the bulk velocity (the forced value with explicit diffusion;
    the reference's own with implicit diffusion, whose CN solves take the
    forcing as a shift and diffuse it), the kernels named (the z stage
    zthomas, thomas_periodic with periodic z) and the sharded
    checkpoint."""
    for name, tol in TOL.items():
        a = np.asarray(getattr(jst, name))
        b = out[f'{key}.{name}']
        if name == 'p':
            a, b = _gauge(a), _gauge(b)
        err = np.abs(a - b).max()
        assert err <= tol, f'{key} {name}: {err:.3e} > {tol:.0e}'
    dt_cfl, _, divmax = out[f'{key}.check']
    assert abs(dt_cfl - jchk[0]) <= 1e-12 * jchk[0]
    assert divmax <= 1e-10 and abs(divmax - jchk[2]) <= 1e-12
    assert abs(out[f'{key}.bulk'] - bulk) <= 1e-12
    names = list(out[f'{key}.names'])
    assert 'apply_x' in names and zthomas in names and 'z_eig' not in names
    assert ('smag' in names) == (kw['sgstype'] == 'smag')
    assert 'correc_smag' not in names
    assert out[f'{key}.readback'] == 1.0
    # the bytes of the single-process writer on the gathered fields
    ref = work / f'{key}.ref.bin'
    fields = [out[f'{key}.{q}'] for q in 'uvwp']
    ckpt.save_checkpoint(ref, *fields, float(np.asarray(jst.time)), nsteps)
    assert (work / f'{key}.fld.bin').read_bytes() == ref.read_bytes()


def test_apply_x_plain_matches_pallas():
    rng = np.random.default_rng(7)
    arr = rng.standard_normal((8, 8, 128))
    mxt = rng.standard_normal((128, 128))
    ref = np.asarray(pallas_solve.apply_x(arr, mxt, interpret=True))
    got = SK.apply_x_plain(torch.as_tensor(arr), torch.as_tensor(mxt))
    assert np.abs(got.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()
    # the chunked layouts are the same product, split or gathered along x
    t, m = torch.as_tensor(arr), torch.as_tensor(mxt)
    split = SK.apply_x(t, m, split=4)
    assert split.shape == (4, 8, 8, 32)
    np.testing.assert_array_equal(torch.cat(tuple(split), -1).numpy(),
                                  got.numpy())
    np.testing.assert_array_equal(SK.apply_x(split, torch.eye(
        128, dtype=torch.float64)).numpy(), got.numpy())


def _solve_case(kw, rng):
    """A random RHS in the range of the singular pressure operator: zero
    dzf-weighted mean, as a divergence has (the pinned and the projected
    solves then differ by a constant only)."""
    nx, ny, nz = kw['ng']
    rhs = rng.standard_normal((nz, ny, nx))
    dzf = np.asarray(jax_grid(JaxConfig(**kw)).dzf)[1:nz + 1]
    return rhs - rhs.mean(axis=(1, 2)) @ dzf / dzf.sum()


def _cfg_json(kw, gy):
    return {**kw, 'dims': (gy, 1)}


def test_two_ranks_comm_solve_steps_and_checkpoint(tmp_path):
    rng = np.random.default_rng(11)
    cases, inputs, refs = [], {}, {}
    cases.append({'kind': 'comm', 'key': 'c', 'ng': (12, 6, 5)})
    inputs.update(_comm_inputs('c', (12, 6, 5), rng))
    rhs = _solve_case(SMAG, rng)
    inputs['s.rhs'] = rhs
    cases.append({'kind': 'solve', 'key': 's', 'ng': SMAG['ng'],
                  'cfg': _cfg_json(SMAG, 2)})
    for key, kw in (('smag', SMAG), ('none', NONE)):
        fields, dt, jst, jchk = _jax_steps(kw, 2)
        refs[key] = (jst, jchk, kw)
        for q, f in zip('uvwp', fields):
            inputs[f'{key}.{q}'] = f
        inputs[f'{key}.dt'] = np.array(dt)
        cases.append({'kind': 'steps', 'key': key, 'ng': kw['ng'],
                      'cfg': _cfg_json(kw, 2), 'nsteps': 2})
    out, work = _spawn(tmp_path, 2, cases, inputs)
    _check_comm(out, inputs, 'c', 2)
    p = _jax_solve(SMAG, rhs)
    assert np.abs(_gauge(out['s.p']) - _gauge(p)).max() <= 1e-11
    for key, (jst, jchk, kw) in refs.items():
        _check_steps(out, key, jst, jchk, kw, work, 2)


def test_four_ranks_comm_solve_and_a_step(tmp_path):
    rng = np.random.default_rng(12)
    kw = dict(SMAG, ng=(32, 32, 16))
    inputs = _comm_inputs('c', (16, 8, 3), rng)
    rhs = _solve_case(kw, rng)
    inputs['s.rhs'] = rhs
    fields, dt, jst, jchk = _jax_steps(kw, 1)
    for q, f in zip('uvwp', fields):
        inputs[f'smag.{q}'] = f
    inputs['smag.dt'] = np.array(dt)
    cases = [{'kind': 'comm', 'key': 'c', 'ng': (16, 8, 3)},
             {'kind': 'solve', 'key': 's', 'ng': kw['ng'],
              'cfg': _cfg_json(kw, 4)},
             {'kind': 'steps', 'key': 'smag', 'ng': kw['ng'],
              'cfg': _cfg_json(kw, 4), 'nsteps': 1}]
    out, work = _spawn(tmp_path, 4, cases, inputs)
    _check_comm(out, inputs, 'c', 4)
    p = _jax_solve(kw, rhs)
    assert np.abs(_gauge(out['s.p']) - _gauge(p)).max() <= 1e-11
    _check_steps(out, 'smag', jst, jchk, kw, work, 1)


def test_ranks_stop_together_on_the_wall_time_limit(tmp_path):
    """Rank 0's clock runs two hours ahead of rank 1's, the limit is one
    hour: both stop after the first step (not at nstep) and write one
    fld.bin of that step."""
    kw = dict(SMAG, stop_type=(True, False, True), nstep=6, tw_max=1.0,
              icheck=1, iout0d=0, iout1d=0, iout2d=0, iout3d=0, isave=0)
    out, work = _spawn(tmp_path, 2, [{'kind': 'driver', 'key': 'drv',
                                      'ng': kw['ng'],
                                      'cfg': _cfg_json(kw, 2)}], {})
    assert list(out['drv.istep']) == [1, 1]
    *_, istep = ckpt.load_checkpoint(work / 'drv' / 'fld.bin', kw['ng'],
                                     np.float64)
    assert istep == 1


def test_slab_with_cut_halos_is_the_whole_fields_rows():
    """fma_probe's construction: mom_rk's halo twin on the slab [0, ny/2),
    its halo rows cut from the whole field, equals the periodic twin on the
    same rows of the whole field, every output exactly."""
    from cales_torch import fma_probe
    from cales_torch.grid import make_grid_from_config
    from cales_torch.timeloop import Simulation
    cfg = Config(ng=(32, 16, 16), **{**fma_probe.LES, 'dtype': 'float64'})
    sim = Simulation(cfg, make_grid_from_config(cfg), device='cpu')
    _, _, fields = _perturbed({**fma_probe.LES, 'ng': (32, 16, 16),
                               'dtype': 'float64'})
    st = sim.initial_state(*fields)
    dt = sim.pick_dt(sim.check(st)[0])
    st, _ = sim.step(st, dt)
    res = fma_probe._compare(*fma_probe._args(sim, st, dt))
    assert set(res) == set(fma_probe.OUTPUTS)
    for name, r in res.items():
        assert r['halo_equals_periodic'], name
        assert r['halo_edge'] == r['halo_interior'] == r['periodic'] == 0.0


@pytest.mark.parametrize('change, needle', [
    # a pencil mesh (gx > 1) runs the two-pass dsmag (transpiring z
    # walls) too; on pencils of one x column it stays refused (its
    # two-column x halo would reach a rank two away)
    (dict(dims=(1, 4), ng=(4, 16, 16), sgstype='dsmag',
          dsmag_avg='channel',
          bcvel=(((0.0,) * 3, (0.0,) * 3, (0.0, 0.0, 0.003)),) * 2),
     'the two-pass dynamic Smagorinsky'),
    (dict(dims=(3, 1)), 'not divisible by gy'),
    # x and y walls with the z walls' wall model, and x walls with dsmag
    # (refused on one device too)
    (dict(XDUCT_BCS, lwm=((0, 0, 1), (0, 0, 1)), hwm=0.1),
     'x walls with a wall model and y walls'),
    (dict(XDEV_BCS, sgstype='dsmag', dsmag_avg='channel'),
     'non-periodic x with dynamic Smagorinsky'),
    # the 2D test filter with y walls (refused on one device too)
    (dict(sgstype='dsmag', dsmag_avg='channel', filter_2d=True,
          cbcvel=((('P', 'P', 'P'), ('D', 'D', 'D'), ('D', 'D', 'D')),) * 2,
          cbcpre=(('P', 'N', 'N'), ('P', 'N', 'N')),
          cbcsgs=(('P', 'D', 'D'), ('P', 'D', 'D'))),
     'the 2D test filter (filter_2d) with y walls'),
    (dict(sgstype='dsmag', dsmag_avg='channel', ng=(64, 2, 16)),
     "thinner than the dsmag kernel's two-row y halo"),
    # 'fft' runs on the mesh with periodic x (test_torch_sharded_fft.py);
    # there is no FFT along a walled x
    (dict(XDEV_BCS, ptransform='fft'), "non-periodic x with ptransform "
                                       "'fft'"),
    # the duct WMLES whose y faces sample row 16 from each wall (hwm 1.6)
    # on slabs of 16 rows
    (dict(cbcvel=((('P', 'P', 'P'), ('D', 'D', 'D'), ('D', 'D', 'D')),) * 2,
          cbcpre=(('P', 'N', 'N'), ('P', 'N', 'N')),
          cbcsgs=(('P', 'D', 'D'), ('P', 'D', 'D')),
          lwm=((0, 1, 1), (0, 1, 1)), hwm=1.6),
     'y walls under a device mesh'),
])
def test_mesh_refusals(change, needle):
    kw = {**SMAG, 'dims': (2, 1), **change}
    missing = unsupported(Config(**kw))
    assert any(needle in m for m in missing), missing


def test_mesh_slice_is_supported():
    assert unsupported(Config(**SMAG, dims=(2, 1))) == []
    assert unsupported(Config(**NONE, dims=(4, 1))) == []
    # the channel on a pencil mesh (gx > 1), with the one-pass dynamic
    # Smagorinsky and with full-3D implicit diffusion too
    assert unsupported(Config(**SMAG, dims=(2, 2))) == []
    for change in (dict(sgstype='dsmag', dsmag_avg='channel'),
                   dict(sgstype='dsmag', dsmag_avg='dit', impdiff=True,
                        impdiff_1d=True),
                   dict(impdiff=True), dict(sgstype='none', impdiff=True)):
        assert unsupported(Config(**{**SMAG, **change},
                                  dims=(2, 2))) == [], change
    # the channel DNS and LES with impdiff_1d, the wall-modelled channel,
    # the one-pass dynamic Smagorinsky channel ('channel' and 'dit',
    # explicit and impdiff_1d), with the 2D test filter and by the two
    # passes (transpiring z walls), the LES with a passive scalar, the
    # channel DNS and LES with full-3D implicit diffusion (with a scalar
    # too), and the developing channel (x walls, periodic y) and its LES
    # with impdiff_1d
    imp = dict(impdiff=True, impdiff_1d=True)
    blow = (((0.0,) * 3, (0.0,) * 3, (0.0, 0.0, 0.003)),) * 2
    for change in (dict(sgstype='none', **imp), imp,
                   dict(lwm=((0, 0, 1), (0, 0, 1)), hwm=0.1),
                   dict(sgstype='dsmag', dsmag_avg='channel'),
                   dict(sgstype='dsmag', dsmag_avg='dit', **imp),
                   dict(sgstype='dsmag', dsmag_avg='channel', filter_2d=True),
                   dict(sgstype='dsmag', dsmag_avg='channel', bcvel=blow),
                   dict(scalar=True, is_sforced=True, scalf=0.5, **imp),
                   dict(sgstype='none', impdiff=True), dict(impdiff=True),
                   dict(scalar=True, impdiff=True),
                   dict(XDEV_BCS, sgstype='none'), dict(XDEV_BCS, **imp),
                   # x and y walls (the developing duct, 'none' and smag),
                   # the developing WMLES, x walls with a scalar, with
                   # periodic y and with y walls
                   dict(XDUCT_BCS, sgstype='none'), XDUCT_BCS,
                   dict(XDEV_BCS, lwm=((0, 0, 1), (0, 0, 1)), hwm=0.1),
                   dict(XDEV_BCS, scalar=True),
                   dict(XDUCT_BCS, scalar=True),
                   # ptransform 'fft' with periodic x, and with y walls
                   # (the mixed route)
                   dict(ptransform='fft'),
                   dict(ptransform='fft', impdiff=True),
                   dict(ptransform='fft',
                        cbcvel=((('P', 'P', 'P'), ('D', 'D', 'D'),
                                 ('D', 'D', 'D')),) * 2,
                        cbcpre=(('P', 'N', 'N'),) * 2,
                        cbcsgs=(('P', 'D', 'D'),) * 2, sgstype='dsmag',
                        dsmag_avg='duct')):
        for gy in (2, 4):
            assert unsupported(Config(**{**SMAG, **change},
                                      dims=(gy, 1))) == [], change
    # 'auto' resolves to the all-matrix route under a mesh
    assert unsupported(Config(**{**SMAG, 'ptransform': 'auto'},
                              dims=(2, 1))) == []


def test_world_size_and_transport_refusals(monkeypatch):
    monkeypatch.setenv('RANK', '0')
    monkeypatch.setenv('WORLD_SIZE', '1')
    with pytest.raises(ValueError, match='needs 2 ranks, WORLD_SIZE is 1'):
        mesh.from_env((2, 1), (16, 8, 4), 'cpu', 'gloo')
    monkeypatch.delenv('WORLD_SIZE')
    with pytest.raises(RuntimeError, match='torch.distributed.run'):
        mesh.from_env((2, 1), (16, 8, 4), 'cpu', 'gloo')
    with pytest.raises(ValueError, match="use 'gloo'"):
        comm.rank_device('cpu', 'nccl', 0, 2)
    with pytest.raises(ValueError, match='one of'):
        comm.rank_device('cpu', 'mpi', 0, 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='is_available'):
            comm.rank_device('cuda', 'gloo', 0, 2)
