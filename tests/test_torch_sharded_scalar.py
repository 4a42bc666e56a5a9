"""The passive scalar on a y-slab mesh (dims = (gy, 1)) on the CPU, on gloo
ranks of tests/_sharded_worker.py (the kernels' plain twins), against the
JAX package's single-device Simulation(use_pallas=False), f64, from the
seeded asymmetric start of tests/test_torch_sharded.py, at nx = 32:

  * 2 steps of the scalar channel LES of tests/test_sharding_paths.py:445
    (static Smagorinsky, ssource 0.05; here with its z walls' scalar
    values 0 and 1 and the scalar's bulk forcing on, so that s is not
    uniform and its sum over the ranks is read) and of the y-walled scalar
    duct of tests/test_sharding_paths.py:824 (s 1 and 0.5 on the y walls,
    'uni'), at gy = 2, and the duct at gy = 4 (its middle slabs own no
    wall): u, v, w, nu_t and s within 1e-11, p within 1e-11 after removing
    its mean, the duct's kept planes vlo[1] and vlo[2], the checks and the
    checkpoint as tests/test_torch_sharded.py holds them; each scal.bin
    written slab by slab byte-for-byte the single-process writer's on the
    gathered field;
  * driver.run on two ranks writes scal.bin beside fld.bin, byte-for-byte
    io/checkpoint.save_scalar's, and a restart from them on the two ranks
    matches one device's restart from the same files (u and s within
    1e-11);
  * mom_rk_plain with the scalar and the slab's halos (its sixth halo pair)
    on each of two slabs equals the whole field's twin cut to the slab,
    every output exactly, and the wrapper takes the same inputs to it.
"""
import shutil

import numpy as np
import pytest
import torch

from cales_torch import driver
from cales_torch.config import Config
from cales_torch.grid import make_grid_from_config
from cales_torch.io import checkpoint as ckpt
from cales_torch.ops import boundary as bnd
from cales_torch.ops import kernels as K
from cales_torch.timeloop import Simulation, unsupported

from test_torch_sharded import (CHAN_BCS, _check_steps, _jax_steps,
                                _perturbed, _spawn)
from test_torch_sharded_les import _halo, _slab_of

torch.set_num_threads(1)

# tests/test_sharding_paths.py:445's scalar channel at nx = 32, the
# scalar's z walls at 0 and 1 (D), bulk-forced to 0.3
CHAN_SC = dict(ng=(32, 32, 16), l=(2 * np.pi, np.pi, 2.0), gtype=1, gr=0.9,
               visci=2000.0, inivel='log', is_wallturb=True, dtype='float64',
               is_forced=(True, False, False), velf=(1.0, 0.0, 0.0),
               sgstype='smag', ptransform='mat', scalar=True, pr=0.71,
               iniscal='zer', ssource=0.05,
               cbcscal=(('P', 'P', 'D'), ('P', 'P', 'D')),
               bcscal=((0.0, 0.0, 0.0), (0.0, 0.0, 1.0)), is_sforced=True,
               scalf=0.3, **CHAN_BCS)
# tests/test_sharding_paths.py:824's y-walled scalar duct at nx = 32
DUCT_SC = dict(ng=(32, 32, 16), l=(2 * np.pi, 2.0, 2.0), gtype=1, gr=0.5,
               visci=2000.0, inivel='duc', is_wallturb=False,
               dtype='float64', is_forced=(True, False, False),
               velf=(1.0, 0.0, 0.0), sgstype='smag', ptransform='mat',
               scalar=True, pr=0.71, iniscal='uni', ssource=0.02,
               cbcscal=(('P', 'D', 'N'), ('P', 'D', 'N')),
               bcscal=((0.0, 1.0, 0.0), (0.0, 0.5, 0.0)),
               cbcvel=((('P', 'P', 'P'), ('D', 'D', 'D'),
                        ('D', 'D', 'D')),) * 2,
               cbcpre=(('P', 'N', 'N'),) * 2, cbcsgs=(('P', 'N', 'N'),) * 2)
CASES = {'chan_sc': CHAN_SC, 'duct_sc': DUCT_SC}
# driver.run to step 2 at a fixed dt, the last step saved
RESTART = dict(CHAN_SC, dt_f=1e-3, stop_type=(True, False, False), nstep=2,
               icheck=1, iout0d=0, iout1d=0, iout2d=0, iout3d=0, isave=0)
TOL = 1e-11


@pytest.fixture(scope='module')
def refs():
    return {key: (kw, _jax_steps(kw, 2)) for key, kw in CASES.items()}


def _run(tmp_path, gy, refs, cases=(), inputs=None):
    cases, inputs = list(cases), dict(inputs or {})
    for key, (kw, (fields, dt, _, _)) in refs.items():
        assert unsupported(Config(**kw, dims=(gy, 1))) == [], key
        for q, f in zip('uvwp', fields):
            inputs[f'{key}.{q}'] = f
        inputs[f'{key}.dt'] = np.array(dt)
        cases.append({'kind': 'steps', 'key': key, 'ng': kw['ng'],
                      'cfg': {**kw, 'dims': (gy, 1)}, 'nsteps': 2})
    out, work = _spawn(tmp_path, gy, cases, inputs)
    for key, (kw, (_, _, jst, jchk)) in refs.items():
        _check_steps(out, key, jst, jchk, kw, work, 2)
        err = np.abs(out[f'{key}.s'] - np.asarray(jst.s)).max()
        assert err <= TOL, f'{key} s: {err:.3e}'
        if kw['cbcvel'][0][1][1] == 'D':
            for m in (1, 2):
                err = np.abs(out[f'{key}.vlo{m}']
                             - np.asarray(jst.vlo[m])).max()
                assert err <= TOL, f'{key} vlo[{m}]: {err:.3e}'
        ref = work / f'{key}.scal.ref.bin'
        ckpt.save_scalar(ref, out[f'{key}.s'], float(np.asarray(jst.time)),
                         2)
        assert (work / f'{key}.scal.bin').read_bytes() == ref.read_bytes()
    return out, work


def test_scalar_steps_and_restart_on_two_slabs(tmp_path, refs):
    out, work = _run(tmp_path, 2, refs, [
        {'kind': 'scal_restart', 'key': 'rs', 'ng': RESTART['ng'],
         'cfg': {**RESTART, 'dims': (2, 1)}}])
    # the driver's scal.bin: the single-process writer's bytes
    data = work / 'rs' / 'first'
    ref = work / 'rs.scal.ref.bin'
    ckpt.save_scalar(ref, out['rs.s1'], float(out['rs.t1']), 2)
    assert (data / 'scal.bin').read_bytes() == ref.read_bytes()
    # one device restarted from the same files
    one = tmp_path / 'one'
    one.mkdir()
    for name in ('fld.bin', 'scal.bin'):
        shutil.copy(data / name, one / name)
    cfg = Config(**RESTART).replace(restart=True, nstep=3)
    _, st = driver.run(cfg, datadir=one, device='cpu', verbose=False)
    for name in ('u', 's'):
        err = np.abs(out[f'rs.{name}2'] - getattr(st, name).numpy()).max()
        assert err <= TOL, f'restart {name}: {err:.3e}'
    assert st.istep == 3


def test_scalar_duct_steps_on_four_slabs(tmp_path, refs):
    _run(tmp_path, 4, {'duct_sc': refs['duct_sc']})


@pytest.mark.parametrize('key', ['chan_sc', 'duct_sc'])
def test_mom_rk_scalar_twin_on_slabs_is_the_whole_fields_rows(key):
    """The periodic channel's slab takes the halo pairs (the scalar's the
    sixth); the duct's slab its y-row stacks (boundary.slab_ystack, the
    scalar's from its own recipe), the scalar's the sixth pair."""
    kw = CASES[key]
    cfg = Config(**kw)
    sim = Simulation(cfg, make_grid_from_config(cfg), device='cpu')
    _, _, fields = _perturbed(kw, seed=31)
    u, v, w, p = (torch.as_tensor(f) for f in fields)
    rng = np.random.default_rng(32)
    nz, ny, nx = u.shape
    sca = torch.as_tensor(rng.uniform(0.0, 1.0, (nz, ny, nx)))
    s = torch.as_tensor(rng.uniform(0.0, 1e-3, (nz, ny, nx)))
    rso, ru, rv, rw = (torch.as_tensor(rng.standard_normal((nz, ny, nx)))
                       for _ in range(4))
    ue, ve, we = sim._zedge_vel(u, v, w, sim.bcu_vals, sim.bcv_vals,
                                sim.bcw_vals)
    pe, se, sce = sim._zedge_p(p), sim._zedge_s(s), sim._zedge_scal(sca)
    coef = (sim.dzci_t, sim.dzfi_t, 0.3, -0.1, cfg.visc, cfg.dli[0],
            cfg.dli[1], cfg.bforce)
    walled = sim.ywalled
    fields, edges = (u, v, w, s, p, sca), (ue, ve, we, se, pe, sce)
    ye = None
    if walled:
        ye = (*sim._yedge_vel(u, v, w), sim._yedge_s(s), sim._yedge_p(p),
              sim._yedge_scal(sca))
    scal = dict(sca=sca, scae=sce, rso=rso, scal=sim.scal_params)
    whole = K.mom_rk_plain(u, v, w, s, p, ue, ve, we, se, pe, ru, rv, rw,
                           *coef, sums=(True, False), ye=ye, **scal)
    gy = 2
    nyl = ny // gy
    for r in range(gy):
        y0 = r * nyl
        c = lambda a: _slab_of(a, y0, nyl)  # noqa: E731
        q = [c(a) for a in fields]
        e = [c(a) for a in edges]
        h = [_halo(a, b, y0, nyl, 1) for a, b in zip(fields, edges)]
        kwargs = dict(yh=tuple(h))
        if walled:
            own = (r == 0, r == gy - 1)
            walls = (*sim._yedge_vel(*q[:3]), sim._yedge_s(q[3]),
                     sim._yedge_p(q[4]), sim._yedge_scal(q[5]))
            kwargs = dict(ye=tuple(bnd.slab_ystack(a, b, y, hh, own)
                                   for a, b, y, hh in zip(q, e, walls, h)))
        args = (*q[:3], q[3], q[4], *e[:5], c(ru), c(rv), c(rw), *coef)
        sk = dict(sca=q[5], scae=e[5], rso=c(rso), scal=sim.scal_params)
        got = K.mom_rk_plain(*args, sums=(True, False), **kwargs, **sk)
        for m, (a, b) in enumerate(zip(got, whole)):
            if m == 6:       # usum: the slab's plane sums
                continue
            if b is not None:
                assert torch.equal(a, c(b)), (key, r, m)
        same = K.mom_rk(*args, sums=(True, False), **kwargs, **sk)
        assert all(a is b or torch.equal(a, b) for a, b in zip(got, same))
