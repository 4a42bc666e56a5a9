"""Full-3D implicit diffusion on a 2D pencil mesh (dims = (gy, gx), gx > 1)
on the CPU, on gloo ranks of tests/_sharded_worker.py (the kernels' plain
twins), against the JAX package's single-device Simulation(use_pallas=
False), f64, from the seeded asymmetric start of tests/test_torch_sharded.py:

  * solve_sharded with alpha (the CN stage's Helmholtz solve (I + alpha
    L), through the re-slab) for u, v and w (w's face-staggered Dirichlet
    tail row passed through) at dims (2, 2) against JAX poisson.solve with
    alpha on the whole field within 1e-11;
  * mom_rk's x-halo twin with the 'xy+z' split (with and without nu_t) on
    a pencil whose halos are cut from the whole field (with y halos, and
    with gy = 1 periodic y) equals the periodic twin on the whole field's
    block, every output exactly; the wrapper takes the twin on the CPU;
  * 2 steps at dims (2, 2) of the full-3D channel DNS of
    tests/test_sharding_paths.py:128 and its static-Smagorinsky LES, and
    of the triperiodic DNS with full-3D implicit diffusion: u, v, w, nu_t
    within 1e-11, p within 1e-11 after removing its mean, the CFL dt,
    divmax, bulk u (the reference's), the kernels named and w's kept
    lower face.
"""
import numpy as np
import pytest
import torch

from cales_torch.config import Config
from cales_torch.ops import kernels as K
from cales_torch.timeloop import unsupported

from test_torch_pencil import _cut, _rand
from test_torch_sharded import _check_steps, _jax_steps, _spawn
from test_torch_sharded_box import BOX
from test_torch_sharded_imp import _bulk
from test_torch_sharded_imp3d import ALPHA, CHAN3D, _jax_helmholtz

torch.set_num_threads(1)

CASES = {'chan3d': CHAN3D, 'chan3d_les': dict(CHAN3D, sgstype='smag'),
         'box3d': dict(BOX, impdiff=True)}
DIMS = (2, 2)


@pytest.fixture(scope='module')
def refs():
    return {key: (kw, _jax_steps(kw, 2)) for key, kw in CASES.items()}


def test_full3d_steps_and_helmholtz_on_2x2_pencils(tmp_path, refs):
    rng = np.random.default_rng(101)
    nx, ny, nz = CHAN3D['ng']
    cases, inputs = [], {}
    for ivel in range(3):
        key = f'h{ivel}'
        inputs[f'{key}.rhs'] = rng.standard_normal((nz, ny, nx))
        cases.append({'kind': 'solve', 'key': key, 'ng': CHAN3D['ng'],
                      'dims': DIMS, 'cfg': {**CHAN3D, 'dims': DIMS},
                      'ivel': ivel, 'alpha': ALPHA})
    for key, (kw, (fields, dt, _, _)) in refs.items():
        assert unsupported(Config(**kw, dims=DIMS)) == [], key
        for q, f in zip('uvwp', fields):
            inputs[f'{key}.{q}'] = f
        inputs[f'{key}.dt'] = np.array(dt)
        cases.append({'kind': 'steps', 'key': key, 'ng': kw['ng'],
                      'dims': DIMS, 'cfg': {**kw, 'dims': DIMS},
                      'nsteps': 2})
    out, work = _spawn(tmp_path, DIMS[0] * DIMS[1], cases, inputs)
    for ivel in range(3):
        key = f'h{ivel}'
        ref = _jax_helmholtz(CHAN3D, ivel, inputs[f'{key}.rhs'])
        err = np.abs(out[f'{key}.p'] - ref).max()
        assert err <= 1e-11, f'solve_sharded alpha, component {ivel}: ' \
                             f'{err:.3e}'
    tail = np.abs(out['h2.p'][-1] - inputs['h2.rhs'][-1]).max()
    assert tail <= 1e-12, f'the tail row: {tail:.3e}'
    for key, (kw, (_, _, jst, jchk)) in refs.items():
        zper = kw['cbcvel'][0][2][0] == 'P'
        _check_steps(out, key, jst, jchk, kw, work, 2, bulk=_bulk(kw, jst),
                     zthomas='thomas_periodic' if zper else 'thomas_z')
        err = np.abs(out[f'{key}.vlo2i']
                     - np.asarray(jst.vlo[2])[1:-1, 1:-1]).max()
        assert err <= 1e-11, f'{key} vlo[2]: {err:.3e}'


@pytest.mark.parametrize('yhalo', [True, False], ids=['2x2', '1x2'])
@pytest.mark.parametrize('sgs', [True, False], ids=['nu_t', 'no_nu_t'])
def test_mom_rk_xyz_x_halo_twin_on_cut_pencils(yhalo, sgs):
    rng = np.random.default_rng(102)
    nz, ny, nx = 6, 8, 12
    gy, gx = (2, 2) if yhalo else (1, 2)
    nyl, nxp = ny // gy, nx // gx
    names = ('u', 'v', 'w', 's' if sgs else None, 'p')
    fld = {n: _rand(rng, nz, ny, nx) for n in ('u', 'v', 'w', 's', 'p',
                                                 'ru', 'rv', 'rw')}
    edg = {n: _rand(rng, 3, ny, nx) for n in ('u', 'v', 'w', 's', 'p')}
    dzci, dzfi = (1.0 + 0.1 * _rand(rng, nz + 2) for _ in range(2))
    coef = (dzci, dzfi, 0.3, -0.1, 1e-3, 2.0, 3.0, (0.1, 0.0, 0.0))

    def args(get, old):
        return (*(None if n is None else get(n, 0) for n in names),
                *(None if n is None else get(n, 1) for n in names),
                *old, *coef)
    ref = K.mom_rk_plain(*args(lambda n, i: (fld, edg)[i][n],
                               (fld['ru'], fld['rv'], fld['rw'])),
                         sums=(True, True), split='xy+z')
    sums = [torch.zeros_like(ref[6]), torch.zeros_like(ref[7])]
    for r in range(gy * gx):
        iy, ix = divmod(r, gx)
        ys = slice(iy * nyl, (iy + 1) * nyl)
        xs = slice(ix * nxp, (ix + 1) * nxp)
        cut = {n: _cut(fld[n], edg[n], ys, xs, yhalo) for n in edg}
        blk = [fld[n][:, ys, xs].contiguous() for n in ('ru', 'rv', 'rw')]
        kw = dict(sums=(True, True), split='xy+z',
                  yh=(tuple(None if n is None else cut[n][2] for n in names)
                      if yhalo else None),
                  xh=tuple(None if n is None else cut[n][3] for n in names))
        got = K.mom_rk_plain(*args(lambda n, i: cut[n][i], blk), **kw)
        for m, (g, q) in enumerate(zip(got[:6], ref[:6])):
            assert torch.equal(g, q[:, ys, xs]), (r, m)
        sums[0].add_(got[6])
        sums[1].add_(got[7])
        same = K.mom_rk(*args(lambda n, i: cut[n][i], blk), **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, same))
    # the partial sums of the full prediction, over the pencils
    for a, b in zip(sums, ref[6:8]):
        torch.testing.assert_close(a, b, rtol=1e-13, atol=1e-13)
