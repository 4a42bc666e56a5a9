"""The passive scalar on a 2D pencil mesh (dims = (gy, gx), gx > 1) on the
CPU: mom_rk's scalar x-halo twin in process, and 2 steps on gloo ranks of
tests/_sharded_worker.py (the kernels' plain twins) from the seeded
asymmetric start of tests/test_torch_sharded.py, against the JAX
package's single-device Simulation(use_pallas=False), f64:

  * mom_rk_plain with the scalar on the four pencils of dims (2, 2) and
    the two of (1, 2), their y halos (the scalar's the sixth pair) and x
    halos in the x stacks' form (the scalar's the sixth) cut from the
    whole field, equals the whole field's twin on the pencil's block,
    every output exactly (with and without nu_t, each split); the wrapper
    takes the same inputs to the twin;
  * 2 steps of tests/test_torch_sharded_scalar.py's scalar channel LES
    (its z walls' scalar values 0 and 1, ssource 0.05, the scalar's bulk
    forcing on) at the pencils' grid, explicit and with impdiff_1d on
    (2, 2) and explicit on (1, 2): u, v, w, nu_t and s within 1e-11, p
    within 1e-11 after removing its mean, the checks and the checkpoint as
    tests/test_torch_sharded.py holds them, and scal.bin written pencil by
    pencil byte-for-byte the single-process writer's on the gathered
    field;
  * driver.run on the (2, 2) pencils writes scal.bin beside fld.bin,
    byte-for-byte io/checkpoint.save_scalar's, and a restart from them on
    the pencils matches one device's restart from the same files (u and s
    within 1e-11).
"""
import shutil

import numpy as np
import pytest
import torch

from cales_torch import driver
from cales_torch.config import Config
from cales_torch.io import checkpoint as ckpt
from cales_torch.ops import kernels as K
from cales_torch.timeloop import unsupported

from test_torch_pencil import _cut, _rand
from test_torch_pencil_dsmag import NG
from test_torch_sharded import _check_steps, _jax_steps, _spawn
from test_torch_sharded_imp import _bulk
from test_torch_sharded_scalar import CHAN_SC

torch.set_num_threads(1)

SC = dict(CHAN_SC, ng=NG)
SC_IMP = dict(SC, impdiff=True, impdiff_1d=True)
CASES = {'sc': SC, 'sc_imp': SC_IMP}
# driver.run to step 2 at a fixed dt, the last step saved
RESTART = dict(SC, dt_f=1e-3, stop_type=(True, False, False), nstep=2,
               icheck=1, iout0d=0, iout1d=0, iout2d=0, iout3d=0, isave=0)
TOL = 1e-11


@pytest.fixture(scope='module')
def refs():
    return {key: (kw, _jax_steps(kw, 2)) for key, kw in CASES.items()}


def _run(tmp_path, dims, refs, keys, cases=()):
    cases, inputs = list(cases), {}
    for key in keys:
        kw, (fields, dt, _, _) = refs[key]
        assert unsupported(Config(**kw, dims=dims)) == [], key
        for q, f in zip('uvwp', fields):
            inputs[f'{key}.{q}'] = f
        inputs[f'{key}.dt'] = np.array(dt)
        cases.append({'kind': 'steps', 'key': key, 'ng': kw['ng'],
                      'dims': dims, 'cfg': {**kw, 'dims': dims},
                      'nsteps': 2})
    out, work = _spawn(tmp_path, dims[0] * dims[1], cases, inputs)
    for key in keys:
        kw, (_, _, jst, jchk) = refs[key]
        _check_steps(out, key, jst, jchk, kw, work, 2,
                     bulk=_bulk(kw, jst) if kw.get('impdiff') else 1.0)
        err = np.abs(out[f'{key}.s'] - np.asarray(jst.s)).max()
        assert err <= TOL, f'{key} s: {err:.3e}'
        ref = work / f'{key}.scal.ref.bin'
        ckpt.save_scalar(ref, out[f'{key}.s'], float(np.asarray(jst.time)),
                         2)
        assert (work / f'{key}.scal.bin').read_bytes() == ref.read_bytes()
    return out, work


def test_scalar_steps_and_restart_on_2x2_pencils(tmp_path, refs):
    dims = (2, 2)
    out, work = _run(tmp_path, dims, refs, ('sc', 'sc_imp'), [
        {'kind': 'scal_restart', 'key': 'rs', 'ng': RESTART['ng'],
         'dims': dims, 'cfg': {**RESTART, 'dims': dims}}])
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


def test_scalar_steps_on_1x2_pencils(tmp_path, refs):
    _run(tmp_path, (1, 2), refs, ('sc',))


@pytest.mark.parametrize('yhalo', [True, False], ids=['2x2', '1x2'])
def test_mom_rk_scalar_x_halo_twin_on_cut_pencils_is_the_whole_field(yhalo):
    rng = np.random.default_rng(97 + yhalo)
    nz, ny, nx = 6, 8, 12
    gy, gx = (2, 2) if yhalo else (1, 2)
    nyl, nxp = ny // gy, nx // gx
    fld = {n: _rand(rng, nz, ny, nx) for n in ('u', 'v', 'w', 's', 'p',
                                                 'c', 'ru', 'rv', 'rw',
                                                 'rc')}
    edg = {n: _rand(rng, 3, ny, nx) for n in ('u', 'v', 'w', 's', 'p', 'c')}
    dzci, dzfi = (1.0 + 0.1 * _rand(rng, nz + 2) for _ in range(2))
    coef = (dzci, dzfi, 0.3, -0.1, 1e-3, 2.0, 3.0, (0.1, 0.0, 0.0))
    scal = (1e-3 / 0.71, 0.05)
    for sgs in (True, False):
        names = ('u', 'v', 'w', 's' if sgs else None, 'p', 'c')
        for split in (None, '1d', 'xy+z'):
            ref = K.mom_rk_plain(
                *(None if n is None else fld[n] for n in names[:5]),
                *(None if n is None else edg[n] for n in names[:5]),
                fld['ru'], fld['rv'], fld['rw'], *coef, sums=(True, True),
                split=split, sca=fld['c'], scae=edg['c'], rso=fld['rc'],
                scal=scal)
            for iy in range(gy):
                for ix in range(gx):
                    ys = slice(iy * nyl, (iy + 1) * nyl)
                    xs = slice(ix * nxp, (ix + 1) * nxp)
                    cut = {n: _cut(fld[n], edg[n], ys, xs, yhalo)
                           for n in names if n is not None}

                    def blk(n):
                        return fld[n][:, ys, xs].contiguous()
                    args = (*(None if n is None else cut[n][0]
                              for n in names[:5]),
                            *(None if n is None else cut[n][1]
                              for n in names[:5]),
                            blk('ru'), blk('rv'), blk('rw'), *coef)
                    kw = dict(sums=(True, True), split=split,
                              sca=cut['c'][0], scae=cut['c'][1],
                              rso=blk('rc'), scal=scal,
                              yh=tuple(None if n is None else cut[n][2]
                                       for n in names) if yhalo else None,
                              xh=tuple(None if n is None else cut[n][3]
                                       for n in names))
                    got = K.mom_rk_plain(*args, **kw)
                    what = (sgs, split, iy, ix)
                    for m, (a, b) in enumerate(zip(got, ref)):
                        if m in (6, 7):     # the pencil's plane sums
                            continue
                        assert torch.equal(a, b[:, ys, xs]), (what, m)
                    same = K.mom_rk(*args, **kw)
                    assert all(a is b or torch.equal(a, b)
                               for a, b in zip(got, same)), what
