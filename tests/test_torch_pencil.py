"""cales_torch on a 2D pencil mesh (dims = (gy, gx), gx > 1) on the CPU:
the mesh's exchanges and the Poisson solve's re-slab on gloo ranks of
tests/_sharded_worker.py, and the kernels' x-halo twins in process.

  * halo_x with its corners (the x halo's rows -1 and nyl by the y
    exchange), halo_y and the re-slab (pencil_to_slab, slab_to_pencil) at
    dims (2, 2) and (1, 2) against plain slicing of the global array,
    exactly;
  * solve_sharded at dims (2, 2) and (1, 2) by 'mat' and by 'fft' against
    JAX poisson.solve on one device within 1e-11 after removing the mean,
    and against the port's one-device solve;
  * the x-halo twins of mom_rk (split None and '1d', with and without
    nu_t), fillps, correc_updatep (explicit, impdiff_1d, full-3D's p
    update) and smag, on a pencil whose halos are cut from the whole field
    (with y halos, and with gy = 1 periodic y), equal the periodic twins on
    the whole field's block, bitwise (python -m cales_torch.fma_probe's
    construction); the wrappers take the twins on CPU tensors;
  * the pencil mesh's slice in unsupported() (the channel classes, full-3D
    implicit diffusion, the triperiodic box, the dynamic Smagorinsky by
    one pass with either filter and by two passes, the passive scalar;
    the y-walled duct and cavity classes: 'none', smag, dsmag 'duct' and
    'cavity', the scalar duct, by 'mat' and 'fft') and what stays refused
    (the two passes with y walls, the wall model, x walls, pencils of one
    row with y walls, pencils thinner than dsmag's x halo, ...).
"""
import numpy as np
import pytest
import torch

from cales_torch import poisson
from cales_torch.config import Config
from cales_torch.grid import make_grid_from_config
from cales_torch.ops import kernels as K
from cales_torch.timeloop import unsupported

from test_torch_sharded import (SMAG, XDEV_BCS, _gauge, _jax_solve,
                                _solve_case, _spawn)

torch.set_num_threads(1)

# the solves' grid: nx and ny divisible by gy gx = 4 (the re-slab); 'fft'
# with nx = 16 has 9 kx lanes, 3 a rank of the world's 4 slabs
SOLVE = dict(SMAG, ng=(16, 8, 8))


def _pencil_comm_inputs(key, ng, rng):
    nx, ny, nz = ng
    return {f'{key}.field': rng.standard_normal((nz, ny, nx)),
            f'{key}.edge': rng.standard_normal((3, ny, nx))}


def _check_pencil_comm(out, inputs, key, gy, gx):
    g, e = inputs[f'{key}.field'], inputs[f'{key}.edge']
    nz, ny, nx = g.shape
    nyl, nxp, nys = ny // gy, nx // gx, ny // (gy * gx)
    for r in range(gy * gx):
        iy, ix = divmod(r, gx)
        y0, x0 = iy * nyl, ix * nxp
        rows = (y0 - 1 + np.arange(nyl + 2)) % ny
        for a, src in (('xcols', g), ('xcorners', e)):
            got = out[f'{key}.{a}'][r]
            np.testing.assert_array_equal(got[:, 0],
                                          src[:, rows, (x0 - 1) % nx])
            np.testing.assert_array_equal(got[:, 2],
                                          src[:, rows, (x0 + nxp) % nx])
            np.testing.assert_array_equal(got[:, 1, 1:-1],
                                          src[:, y0:y0 + nyl, x0 + nxp - 1])
        for a, src in (('rows', g), ('corners', e)):
            got = out[f'{key}.{a}'][r]
            np.testing.assert_array_equal(
                got[:, 0], src[:, (y0 - 1) % ny, x0:x0 + nxp])
            np.testing.assert_array_equal(
                got[:, 1], src[:, (y0 + nyl) % ny, x0:x0 + nxp])
        np.testing.assert_array_equal(out[f'{key}.slab'][r],
                                      g[:, r * nys:(r + 1) * nys])
        np.testing.assert_array_equal(out[f'{key}.back'][r],
                                      g[:, y0:y0 + nyl, x0:x0 + nxp])


def _port_solve(kw, rhs):
    cfg = Config(**kw)
    sv = poisson.make_solver(cfg, make_grid_from_config(cfg),
                             tuple(cfg.cbc_pre(d) for d in range(3)),
                             ('c', 'c', 'c'), zsolver=cfg.zsolver)
    return poisson.solve(sv, torch.as_tensor(rhs)).numpy()


def _comm_and_solves(tmp_path, gy, gx, seed):
    rng = np.random.default_rng(seed)
    dims = (gy, gx)
    cases = [{'kind': 'pencil_comm', 'key': 'c', 'ng': (16, 8, 3),
              'dims': dims}]
    inputs = _pencil_comm_inputs('c', (16, 8, 3), rng)
    solves = {}
    for route in ('mat', 'fft'):
        kw = dict(SOLVE, ptransform=route)
        assert unsupported(Config(**kw, dims=dims)) == [], route
        rhs = _solve_case(kw, rng)
        inputs[f's_{route}.rhs'] = rhs
        solves[route] = (kw, rhs)
        cases.append({'kind': 'solve', 'key': f's_{route}', 'ng': kw['ng'],
                      'dims': dims, 'cfg': {**kw, 'dims': dims}})
    out, _ = _spawn(tmp_path, gy * gx, cases, inputs)
    _check_pencil_comm(out, inputs, 'c', gy, gx)
    for route, (kw, rhs) in solves.items():
        got = _gauge(out[f's_{route}.p'])
        err = np.abs(got - _gauge(_jax_solve(kw, rhs))).max()
        assert err <= 1e-11, f'{route} against JAX: {err:.3e}'
        # the 'fft' route's stages are the one-device route's, its gauge
        # too; the 'mat' route's z stage is Thomas, pinned (one device:
        # the eigen stage below nz = 384, projected)
        one = _gauge(_port_solve(kw, rhs))
        err = np.abs(got - one).max()
        assert err <= (1e-13 if route == 'fft' else 1e-11), \
            f'{route} against one device: {err:.3e}'


def test_pencil_comm_and_solves_on_2x2(tmp_path):
    _comm_and_solves(tmp_path, 2, 2, 71)


def test_pencil_comm_and_solves_on_1x2(tmp_path):
    _comm_and_solves(tmp_path, 1, 2, 72)


# ---------------------------------------------------------------------------
# the x-halo twins on a pencil cut from the whole field
# ---------------------------------------------------------------------------

def _rand(rng, *shape):
    return torch.as_tensor(rng.standard_normal(shape))


def _cut(q, e, ys, xs, yhalo):
    """A pencil's block of field q (nz, ny, nx) and edge stack e, its y
    halo pair (None without yhalo: periodic y on a pencil of all the rows)
    and its x halo pair (cols (nz, 3, nyl + 2), corners (3, 3, nyl + 2)),
    cut from the whole arrays as mesh.halo_x and the y exchange give
    them."""
    ny, nx = q.shape[1], q.shape[2]
    y0, nyl = ys.start, ys.stop - ys.start
    x0, nxp = xs.start, xs.stop - xs.start
    rows = torch.as_tensor((y0 - 1 + np.arange(nyl + 2)) % ny)
    cols = torch.as_tensor([(x0 - 1) % nx, x0 + nxp - 1, (x0 + nxp) % nx])

    def xstack(a):
        return a[:, rows][:, :, cols].transpose(1, 2).contiguous()
    yh = None
    if yhalo:
        ends = torch.as_tensor([(y0 - 1) % ny, (y0 + nyl) % ny])
        yh = (q[:, ends, xs].contiguous(), e[:, ends, xs].contiguous())
    return (q[:, ys, xs].contiguous(), e[:, ys, xs].contiguous(), yh,
            (xstack(q), xstack(e)))


@pytest.mark.parametrize('yhalo', [True, False], ids=['2x2', '1x2'])
def test_x_halo_twins_on_a_cut_pencil_equal_the_whole_field(yhalo):
    rng = np.random.default_rng(73)
    nz, ny, nx = 6, 8, 12
    ys = slice(4, 8) if yhalo else slice(0, ny)
    xs = slice(6, 12)
    fld = {n: _rand(rng, nz, ny, nx) for n in ('u', 'v', 'w', 's', 'p',
                                                 'pp', 'ru', 'rv', 'rw')}
    edg = {n: _rand(rng, 3, ny, nx) for n in ('u', 'v', 'w', 's', 'p', 'pp')}
    dzci, dzfi = (1.0 + 0.1 * _rand(rng, nz + 2) for _ in range(2))
    cut = {n: _cut(fld[n], edg[n], ys, xs, yhalo) for n in edg}
    blk = {n: fld[n][:, ys, xs].contiguous() for n in ('ru', 'rv', 'rw')}

    def same(got, ref, what):
        for g, r in zip(got, ref):
            if g is None:
                continue
            assert torch.equal(g, r[:, ys, xs] if r.ndim == 3 else r), what
    f1, f2, visc, dxi, dyi = 0.3, -0.1, 1e-3, 2.0, 3.0
    for sgs in (True, False):
        for split in (None, '1d'):
            names = ('u', 'v', 'w', 's', 'p') if sgs else ('u', 'v', 'w',
                                                           None, 'p')

            def args(get, old):
                return (*(None if n is None else get(n, 0) for n in names),
                        *(None if n is None else get(n, 1) for n in names),
                        *old, dzci, dzfi, f1, f2, visc, dxi, dyi,
                        (0.1, 0.0, 0.0))
            ref = K.mom_rk_plain(*args(lambda n, i: (fld, edg)[i][n],
                                       (fld['ru'], fld['rv'], fld['rw'])),
                                 sums=(True, True), split=split)
            halo = tuple(None if n is None else cut[n][2] for n in names)
            got = K.mom_rk(*args(lambda n, i: cut[n][i],
                                 (blk['ru'], blk['rv'], blk['rw'])),
                           sums=(True, True), split=split,
                           yh=halo if yhalo else None,
                           xh=tuple(None if n is None else cut[n][3]
                                    for n in names))
            same(got[:6], ref[:6], f'mom_rk sgs={sgs} split={split}')
            if split is None:
                # the partial sums: the block's new u and v, summed
                for g, r in zip(got[6:8], ref[:2]):
                    np.testing.assert_allclose(
                        g[:, 0].numpy(), r[:, ys, xs].sum(dim=(1, 2)).numpy(),
                        rtol=1e-13, atol=1e-13)
    # fillps: v's y halo, u's x halo
    ref = K.fillps_plain(fld['u'], fld['v'], fld['w'], edg['u'], edg['v'],
                         edg['w'], dzfi, 7.0, dxi, dyi)
    got = K.fillps(cut['u'][0], cut['v'][0], cut['w'][0], cut['u'][1],
                   cut['v'][1], cut['w'][1], dzfi, 7.0, dxi, dyi,
                   yh=cut['v'][2], xh=cut['u'][3])
    same((got,), (ref,), 'fillps')
    # correc_updatep: pp's y and x halos, explicit, impdiff_1d and the
    # full-3D p update (pp's x neighbours on both sides)
    for imp, imp1 in ((False, False), (True, True), (True, False)):
        fuv = torch.tensor([0.01, -0.02], dtype=torch.float64)
        ref = K.correc_updatep_plain(
            fld['u'], fld['v'], fld['w'], fld['pp'], fld['p'], edg['w'],
            edg['pp'], 0.2, dxi, dyi, dzci, dzfi, fuv, alpha=-0.05,
            impdiff=imp, impdiff_1d=imp1)
        got = K.correc_updatep(
            cut['u'][0], cut['v'][0], cut['w'][0], cut['pp'][0],
            cut['p'][0], cut['w'][1], cut['pp'][1], 0.2, dxi, dyi, dzci,
            dzfi, fuv, alpha=-0.05, impdiff=imp, impdiff_1d=imp1,
            yh=cut['pp'][2], xh=cut['pp'][3])
        same(got, ref, f'correc_updatep impdiff={imp} 1d={imp1}')
    # smag with the z walls' van Driest (the shear planes the block's)
    csd2, dw = (0.01 + 0.001 * _rand(rng, nz).abs() for _ in range(2))
    nearlo = torch.as_tensor((np.arange(nz) < nz // 2).astype(float))
    tlo, thi = (_rand(rng, ny, nx).abs() for _ in range(2))
    ref = K.smag_plain(fld['u'], fld['v'], fld['w'], edg['u'], edg['v'],
                       edg['w'], dzci, dzfi, dxi, dyi, visc, csd2, dw,
                       nearlo, tlo, thi)
    got = K.smag(cut['u'][0], cut['v'][0], cut['w'][0], cut['u'][1],
                 cut['v'][1], cut['w'][1], dzci, dzfi, dxi, dyi, visc, csd2,
                 dw, nearlo, tlo[ys, xs].contiguous(),
                 thi[ys, xs].contiguous(),
                 yh=tuple(cut[n][2] for n in 'uvw') if yhalo else None,
                 xh=tuple(cut[n][3] for n in 'uvw'))
    same((got,), (ref,), 'smag')


def test_pencil_slice_and_refusals(monkeypatch):
    monkeypatch.delenv('CALES_DSMAG_TWOPASS', raising=False)
    blow = (((0.0,) * 3, (0.0,) * 3, (0.0, 0.0, 0.003)),) * 2
    # a scalar with its z walls' values 0 and 1, forced (phase 13's)
    scal = dict(pr=0.71, iniscal='zer', ssource=0.05,
                cbcscal=(('P', 'P', 'D'), ('P', 'P', 'D')),
                bcscal=((0.0, 0.0, 0.0), (0.0, 0.0, 1.0)), is_sforced=True,
                scalf=0.3)
    periodic = dict(cbcvel=((('P',) * 3,) * 3,) * 2,
                    cbcpre=(('P',) * 3,) * 2, cbcsgs=(('P',) * 3,) * 2,
                    is_forced=(False,) * 3)
    dsmag = dict(sgstype='dsmag', dsmag_avg='channel')
    imp1 = dict(impdiff=True, impdiff_1d=True)
    for dims in ((2, 2), (1, 2), (4, 2)):
        for change in ({}, dict(sgstype='none'), imp1,
                       dict(sgstype='none', **imp1),
                       # full-3D implicit diffusion ('none' and smag)
                       dict(impdiff=True),
                       dict(sgstype='none', impdiff=True),
                       # the triperiodic box: DNS, smag and dsmag 'dit'
                       # LES, the DNS with full-3D implicit diffusion
                       dict(periodic, sgstype='none'), periodic,
                       dict(periodic, sgstype='dsmag', dsmag_avg='dit'),
                       dict(periodic, sgstype='none', impdiff=True),
                       # the one-pass dsmag channel, explicit and
                       # impdiff_1d, 'channel' and 'dit'
                       dsmag, dict(dsmag, **imp1),
                       dict(dsmag, dsmag_avg='dit'),
                       # the two passes (dsmag_blow, impdiff_1d; and by
                       # CALES_DSMAG_TWOPASS=1 below), the 2D test filter
                       # on the channel and the box ('dit')
                       dict(dsmag, bcvel=blow, **imp1),
                       dict(dsmag, filter_2d=True),
                       dict(periodic, sgstype='dsmag', dsmag_avg='dit',
                            filter_2d=True),
                       # the passive scalar: les_scalar's class (phase
                       # 13's), the box, the dsmag channel, full-3D
                       dict(scalar=True, **scal), dict(periodic,
                                                       scalar=True),
                       dict(dsmag, scalar=True, **scal),
                       dict(impdiff=True, scalar=True, **scal)):
            for route in ('mat', 'fft'):
                kw = {**SMAG, 'ng': (512, 256, 256), **change,
                      'ptransform': route}
                assert unsupported(Config(**kw, dims=dims)) == [], \
                    (dims, change, route)
        # the 'channel' two passes under CALES_DSMAG_TWOPASS=1
        with monkeypatch.context() as mp:
            mp.setenv('CALES_DSMAG_TWOPASS', '1')
            kw = {**SMAG, 'ng': (512, 256, 256), **dsmag}
            assert unsupported(Config(**kw, dims=dims)) == [], dims
        # the y-walled classes: bench.py's duct_les_dsmag ('duct') and
        # cavity_les_dsmag ('cavity'), the duct example's 'channel' and
        # 'dit', the 'none' and smag ducts and the scalar duct, by 'mat'
        # and by 'fft' (the mixed route)
        import bench
        mats = bench._matrix_configs((512, 256, 256))
        duct = mats['duct_les_dsmag']
        for kw in (duct, mats['cavity_les_dsmag'],
                   dict(duct, dsmag_avg='channel'),
                   dict(duct, dsmag_avg='dit'),
                   dict(duct, sgstype='none'), dict(duct, sgstype='smag'),
                   dict(duct, sgstype='smag', scalar=True, pr=0.71,
                        cbcscal=(('P', 'D', 'N'), ('P', 'D', 'N')),
                        bcscal=((0.0, 1.0, 0.0), (0.0, 0.5, 0.0)))):
            for route in ('mat', 'fft'):
                assert unsupported(Config(**{**kw, 'ptransform': route},
                                          dims=dims)) == [], (dims, kw)
    wall_y = dict(cbcvel=((('P', 'P', 'P'), ('D', 'D', 'D'),
                           ('D', 'D', 'D')),) * 2,
                  cbcpre=(('P', 'N', 'N'),) * 2,
                  cbcsgs=(('P', 'D', 'D'),) * 2)
    for change, needle in (
            # the two passes and the 2D filter on pencils of one column
            (dict(dsmag, bcvel=blow, ng=(4, 16, 16), dims=(1, 4)),
             'the two-pass dynamic Smagorinsky on pencils of 1'),
            (dict(dsmag, filter_2d=True, ng=(4, 16, 16), dims=(1, 4)),
             "thinner than the dsmag kernel's two-column x halo"),
            # the two passes with y walls: CALES_DSMAG_TWOPASS=1 below
            (dict(dsmag, ng=(4, 16, 16), dims=(1, 4)),
             "thinner than the dsmag kernel's two-column x halo"),
            # pencils of one row with y walls
            (dict(wall_y, sgstype='none', ng=(16, 4, 16), dims=(4, 2)),
             'y walls on pencils of 1 y row'),
            (dict(lwm=((0, 0, 1), (0, 0, 1)), hwm=0.1), 'the wall model'),
            # the wall model with y walls (the duct WMLES)
            (dict(wall_y, lwm=((0, 1, 1), (0, 1, 1)), hwm=0.2),
             'the wall model'),
            (dict(XDEV_BCS, sgstype='none'), 'x walls'),
            (dict(ng=(18, 16, 16)), 'not divisible by gy gx')):
        missing = unsupported(Config(**{**SMAG, 'dims': (2, 2), **change}))
        assert any(needle in m and 'gx > 1' in m
                   and 'ROADMAP queue 1, multi-device' in m
                   for m in missing), (needle, missing)
    # the two passes with y walls, under CALES_DSMAG_TWOPASS=1
    monkeypatch.setenv('CALES_DSMAG_TWOPASS', '1')
    missing = unsupported(Config(**{**SMAG, 'dims': (2, 2), **wall_y,
                                    'sgstype': 'dsmag',
                                    'dsmag_avg': 'duct'}))
    assert any('the two-pass dynamic Smagorinsky with y walls' in m
               and 'gx > 1' in m and 'ROADMAP queue 1, multi-device' in m
               for m in missing), missing
