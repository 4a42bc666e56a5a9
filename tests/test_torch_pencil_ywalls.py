"""The y-walled duct on a 2D pencil mesh (dims = (gy, gx), gx > 1) on the
CPU: the Y_WALLS x X_HALO twins on pencils cut from the whole field in
process, the owner flags, and 2 steps on gloo ranks of
tests/_sharded_worker.py (the kernels' plain twins) from the seeded
asymmetric start of tests/test_torch_sharded.py, against the JAX
package's single-device Simulation(use_pallas=False), f64:

  * mom_rk (with and without nu_t), fillps, correc_updatep and smag (the
    y walls' van Driest) in their y-walled x-halo modes on the four
    pencils of dims (2, 2) and the two of (1, 2), each pencil's y-row
    stacks and x halos cut from the whole field as the step composes
    them (the wall rows on the sides its mesh row holds, v's row nyl - 1
    there its rewrite, the y halo's rows elsewhere), equal the whole
    field's y-walled twins on the pencil's block, exactly; the wrappers
    take the same inputs to the twins;
  * Simulation.yown, the y walls a pencil holds, is its mesh row's (iy =
    0 the lower, iy = gy - 1 the upper) on every rank of (2, 2), (4, 2)
    and (1, 2): on (2, 2) rank 1 is (iy 0, ix 1);
  * 2 steps of the 'none' and the static-Smagorinsky duct (bench.py's
    duct class at the test grid) on (2, 2), (1, 2) and (4, 2): u, v, w,
    nu_t within 1e-11, p within 1e-11 after removing its mean, the kept
    planes vlo[1] (v's lower y face) and vlo[2] (w's lower z face, its y
    ghost rows the owners'), the CFL dt, divmax, the bulk velocity, the
    kernels named and the checkpoint as tests/test_torch_sharded.py holds
    them (smag's van Driest reads the y walls' shear planes summed over
    the mesh column: at (4, 2) the middle pencils hold no wall);
  * driver.run of the smag duct on the (2, 2) pencils to step 2 and a
    restart from its fld.bin on the pencils, against one device's restart
    from the same file (u within 1e-11).
"""
import shutil
import types

import numpy as np
import pytest
import torch

from cales_torch import driver
from cales_torch.ab_dsmag import cut_walled
from cales_torch.config import Config
from cales_torch.grid import make_grid_from_config
from cales_torch.ops import kernels as K
from cales_torch.parallel import mesh as meshmod
from cales_torch.timeloop import Simulation, unsupported

from test_torch_pencil import _rand
from test_torch_sharded import _check_steps, _jax_steps, _spawn
from test_torch_sharded_fft import _check_fft_steps
from test_torch_sharded_imp import _bulk
from test_torch_ywalls import DUCT

torch.set_num_threads(1)

# the duct at a grid whose ny and nx divide by gy gx = 8 (dims (4, 2))
NG = (16, 16, 10)
CASES = {'ynone': dict(DUCT, ng=NG, sgstype='none'),
         'ysmag': dict(DUCT, ng=NG, sgstype='smag')}
RESTART = dict(CASES['ysmag'], dt_f=1e-3, stop_type=(True, False, False),
               nstep=2, icheck=1, iout0d=0, iout1d=0, iout2d=0, iout3d=0,
               isave=0)
TOL = 1e-11


@pytest.fixture(scope='module')
def refs():
    return {key: (kw, _jax_steps(kw, 2)) for key, kw in CASES.items()}


def run_pencils(tmp_path, dims, refs, keys, cases=()):
    """Spawn the ranks of dims on the cases refs[key] (and the other
    cases given) and hold each to its reference, the kept planes on the
    pencils' interior columns too; returns the worker's output."""
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
        if kw['ptransform'] == 'fft':
            _check_fft_steps(out, key, kw, jst, jchk, work)
        else:
            _check_steps(out, key, jst, jchk, kw, work, 2,
                         bulk=1.0 if any(kw.get('is_forced', ()))
                         else _bulk(kw, jst))
        for m in (1, 2):
            ref = np.asarray(jst.vlo[m])[:, 1:-1]
            err = np.abs(out[f'{key}.vlo{m}p'] - ref).max()
            assert err <= TOL, f'{key} vlo[{m}]: {err:.3e}'
        if f'{key}.s' in out:
            err = np.abs(out[f'{key}.s'] - np.asarray(jst.s)).max()
            assert err <= TOL, f'{key} s: {err:.3e}'
    return out, work


def test_duct_steps_and_restart_on_2x2_pencils(tmp_path, refs):
    dims = (2, 2)
    out, work = run_pencils(tmp_path, dims, refs, ('ynone', 'ysmag'), [
        {'kind': 'restart', 'key': 'rs', 'ng': RESTART['ng'], 'dims': dims,
         'cfg': {**RESTART, 'dims': dims}}])
    # one device restarted from the pencils' fld.bin
    one = tmp_path / 'one'
    one.mkdir()
    shutil.copy(work / 'rs' / 'first' / 'fld.bin', one / 'fld.bin')
    cfg = Config(**RESTART).replace(restart=True, nstep=3)
    _, st = driver.run(cfg, datadir=one, device='cpu', verbose=False)
    err = np.abs(out['rs.u2'] - st.u.numpy()).max()
    assert err <= TOL, f'restart u: {err:.3e}'
    assert st.istep == 3


@pytest.mark.parametrize('dims', [(1, 2), (4, 2)], ids=['1x2', '4x2'])
def test_duct_steps_on_pencils(tmp_path, refs, dims):
    run_pencils(tmp_path, dims, refs, ('ynone', 'ysmag'))


def _fake_mesh(rank, dims, ng):
    """A rank's SlabMesh without a process group (its groups local)."""
    comm = types.SimpleNamespace(rank=rank, size=dims[0] * dims[1],
                                 device=torch.device('cpu'),
                                 group=lambda ranks: (None, len(ranks)))
    return meshmod.SlabMesh(comm, dims, ng)


@pytest.mark.parametrize('dims', [(2, 2), (4, 2), (1, 2)])
def test_pencil_owner_flags_are_the_mesh_rows(dims):
    kw = CASES['ysmag']
    cfg = Config(**kw, dims=dims)
    grid = make_grid_from_config(cfg)
    for rank in range(dims[0] * dims[1]):
        m = _fake_mesh(rank, dims, cfg.ng)
        sim = Simulation(cfg, grid, device='cpu', mesh=m)
        assert sim.yown == (m.iy == 0, m.iy == dims[0] - 1), (rank, dims)


# ---------------------------------------------------------------------------
# the Y_WALLS x X_HALO twins on pencils cut from the whole field
# ---------------------------------------------------------------------------

def walled_inputs(rng, names, ny, nx, nz, face='v'):
    """Seeded whole fields, their z-edge stacks and y-row stack pairs: the
    centred fields' row 1 their last row (and its edge entries), the
    face-staggered field's (face) its own (the rewrite slot)."""
    fld = {n: _rand(rng, nz, ny, nx) for n in names}
    edg = {n: _rand(rng, 3, ny, nx) for n in names}
    ys = {}
    for n in names:
        rows, corners = _rand(rng, nz, 3, nx), _rand(rng, 3, 3, nx)
        if n != face:
            rows[:, 1], corners[:, 1] = fld[n][:, -1], edg[n][:, -1]
        ys[n] = (rows, corners)
    return fld, edg, ys


def pencils(gy, gx, ny, nx):
    nyl, nxp = ny // gy, nx // gx
    for iy in range(gy):
        for ix in range(gx):
            yield (iy, slice(iy * nyl, (iy + 1) * nyl),
                   slice(ix * nxp, (ix + 1) * nxp))


@pytest.mark.parametrize('dims', [(2, 2), (1, 2)], ids=['2x2', '1x2'])
def test_ywalled_x_halo_twins_on_cut_pencils_are_the_whole_field(dims):
    rng = np.random.default_rng(301)
    nz, ny, nx = 6, 12, 16
    gy, gx = dims
    names = ('u', 'v', 'w', 's', 'p', 'pp')
    fld, edg, ysk = walled_inputs(rng, names, ny, nx, nz)
    old = {n: _rand(rng, nz, ny, nx) for n in ('ru', 'rv', 'rw')}
    dzci, dzfi = (1.0 + 0.1 * _rand(rng, nz + 2) for _ in range(2))
    f1, f2, visc, dxi, dyi = 0.3, -0.1, 1e-3, 2.0, 3.0
    fuv = torch.tensor([0.01, -0.02], dtype=torch.float64)
    csd2, dw = (0.01 + 0.001 * _rand(rng, nz).abs() for _ in range(2))
    nearlo = torch.as_tensor((np.arange(nz) < nz // 2).astype(float))
    tlo, thi = (_rand(rng, ny, nx).abs() for _ in range(2))
    tylo, tyhi = (_rand(rng, nz, nx).abs() for _ in range(2))
    dwy = 0.05 + 0.01 * _rand(rng, ny).abs()
    nearylo = torch.as_tensor((np.arange(ny) < ny // 2).astype(float))

    def mom_args(get, sgs, ruo):
        names5 = ('u', 'v', 'w', 's' if sgs else None, 'p')
        return (*(None if n is None else get(n, 0) for n in names5),
                *(None if n is None else get(n, 1) for n in names5),
                *ruo, dzci, dzfi, f1, f2, visc, dxi, dyi, (0.1, 0.0, 0.0))
    whole = {}
    for sgs in (True, False):
        ye = tuple(ysk[n] if n else None
                   for n in ('u', 'v', 'w', 's' if sgs else None, 'p'))
        whole[('mom', sgs)] = K.mom_rk_plain(
            *mom_args(lambda n, i: (fld, edg)[i][n], sgs,
                      (old['ru'], old['rv'], old['rw'])),
            sums=(True, True), ye=ye)
    whole['fillps'] = K.fillps_plain(fld['u'], fld['v'], fld['w'], edg['u'],
                                     edg['v'], edg['w'], dzfi, 7.0, dxi, dyi,
                                     yv=ysk['v'])
    whole['correc'] = K.correc_updatep_plain(
        fld['u'], fld['v'], fld['w'], fld['pp'], fld['p'], edg['w'],
        edg['pp'], 0.2, dxi, dyi, dzci, dzfi, fuv, ypp=ysk['pp'],
        yv=ysk['v'][0])
    whole['smag'] = K.smag_plain(
        fld['u'], fld['v'], fld['w'], edg['u'], edg['v'], edg['w'], dzci,
        dzfi, dxi, dyi, visc, csd2, dw, nearlo, tlo, thi,
        ye=tuple(ysk[n] for n in 'uvw'), ywall=(dwy, nearylo, tylo, tyhi))
    for iy, ys, xs in pencils(gy, gx, ny, nx):
        cut = {n: cut_walled(fld[n], edg[n], ysk[n], ys, xs)
               for n in names}

        def blk(a):
            return a[:, ys, xs].contiguous()

        def same(got, ref, what):
            for g, r in zip(got, ref):
                if g is not None and r is not None and r.ndim == 3:
                    assert torch.equal(g, blk(r)), (what, iy, xs)
        for sgs in (True, False):
            n5 = ('u', 'v', 'w', 's' if sgs else None, 'p')
            kw = dict(sums=(True, True),
                      ye=tuple(cut[n][2] if n else None for n in n5),
                      xh=tuple(cut[n][4] if n else None for n in n5))
            a = mom_args(lambda n, i: cut[n][i], sgs,
                         tuple(blk(old[n]) for n in ('ru', 'rv', 'rw')))
            got = K.mom_rk_plain(*a, **kw)
            same(got[:6], whole[('mom', sgs)][:6], f'mom_rk sgs={sgs}')
            assert all(torch.equal(g, h) for g, h in
                       zip(got[:6], K.mom_rk(*a, **kw)[:6]))
        a = (cut['u'][0], cut['v'][0], cut['w'][0], cut['u'][1],
             cut['v'][1], cut['w'][1], dzfi, 7.0, dxi, dyi)
        kw = dict(yv=cut['v'][2], xh=cut['u'][4])
        got = K.fillps_plain(*a, **kw)
        same((got,), (whole['fillps'],), 'fillps')
        assert torch.equal(got, K.fillps(*a, **kw))
        a = (cut['u'][0], cut['v'][0], cut['w'][0], cut['pp'][0],
             cut['p'][0], cut['w'][1], cut['pp'][1], 0.2, dxi, dyi, dzci,
             dzfi, fuv)
        kw = dict(ypp=cut['pp'][2], yv=cut['v'][2][0], xh=cut['pp'][4])
        got = K.correc_updatep_plain(*a, **kw)
        same(got, whole['correc'], 'correc_updatep')
        assert all(torch.equal(g, h) for g, h in
                   zip(got, K.correc_updatep(*a, **kw)))
        a = (cut['u'][0], cut['v'][0], cut['w'][0], cut['u'][1],
             cut['v'][1], cut['w'][1], dzci, dzfi, dxi, dyi, visc, csd2, dw,
             nearlo, tlo[ys, xs].contiguous(), thi[ys, xs].contiguous())
        kw = dict(ye=tuple(cut[n][2] for n in 'uvw'),
                  ywall=(dwy[ys].contiguous(), nearylo[ys].contiguous(),
                         tylo[:, xs].contiguous(), tyhi[:, xs].contiguous()),
                  xh=tuple(cut[n][4] for n in 'uvw'))
        got = K.smag_plain(*a, **kw)
        same((got,), (whole['smag'],), 'smag')
        assert torch.equal(got, K.smag(*a, **kw))
