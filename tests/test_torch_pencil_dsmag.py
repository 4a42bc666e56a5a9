"""The one-pass dynamic Smagorinsky on a 2D pencil mesh (dims = (gy, gx),
gx > 1) on the CPU: the two-deep x halo on gloo ranks of
tests/_sharded_worker.py, dsmag's x-halo twin in process, and 2 steps of
the dsmag channel (validation/dsmag_channel.py's, at a test size) on the
pencils (the kernels' plain twins) from the seeded asymmetric start of
tests/test_torch_sharded.py, against JAX Simulation(use_pallas=False) on
one device, f64:

  * halo_x at depth 2 with its corners (its rows -2, -1, nyl and nyl+1 by
    the depth-2 y exchange: timeloop._pencil_halos' two hops) and halo_y
    at depth 2, at dims (2, 2) and (1, 2), against slicing of the global
    array, exactly;
  * dsmag_plain(xh=...) on a pencil whose halos are cut from the whole
    field (with y halos, and with gy = 1 periodic y; z walls, and the
    box's periodic z) against the periodic twin on the whole field: |S|
    exactly, the four pencils' 'channel' sums summed within 1e-13; the
    wrapper takes the twin on CPU tensors;
  * 2 steps of the dsmag channel ('channel') explicit and with impdiff_1d
    at dims (2, 2), explicit at (1, 2): u, v, w and nu_t within 1e-11, p
    within 1e-11 after removing its mean, the CFL dt, divmax, bulk u and
    the kernels named (tests/test_torch_sharded.py _check_steps).
"""
import numpy as np
import pytest
import torch

from cales_torch.config import Config
from cales_torch.grid import make_grid_from_config
from cales_torch.ops import kernels as K
from cales_torch.timeloop import Simulation, unsupported

from test_torch_sharded import _check_steps, _jax_steps, _perturbed, _spawn
from test_torch_sharded_box import BOX
from test_torch_sharded_imp import DSMAG, DSMAG_IMP, _bulk

torch.set_num_threads(1)

# the pencils' grid: nx and ny divisible by gy gx = 4 (the re-slab)
NG = (32, 16, 16)
CASES = {'dsmag': dict(DSMAG, ng=NG),
         'dsmag_imp': dict(DSMAG_IMP, ng=NG)}
HALO_NG = (16, 8, 3)


@pytest.fixture(scope='module')
def refs():
    return {key: (kw, _jax_steps(kw, 2)) for key, kw in CASES.items()}


def _check_halo2(out, inputs, key, gy, gx):
    g, e = inputs[f'{key}.field'], inputs[f'{key}.edge']
    nz, ny, nx = g.shape
    nyl, nxp = ny // gy, nx // gx
    for r in range(gy * gx):
        iy, ix = divmod(r, gx)
        y0, x0 = iy * nyl, ix * nxp
        rows = (y0 - 2 + np.arange(nyl + 4)) % ny
        cols = [(x0 + j) % nx for j in (-2, -1, nxp, nxp + 1)]
        ends = [(y0 + j) % ny for j in (-2, -1, nyl, nyl + 1)]
        for a, src in (('xcols2', g), ('xcorners2', e)):
            got = out[f'{key}.{a}'][r]
            assert got.shape == (src.shape[0], 4, nyl + 4)
            for c, x in enumerate(cols):
                np.testing.assert_array_equal(got[:, c], src[:, rows, x])
        for a, src in (('rows2', g), ('corners2', e)):
            np.testing.assert_array_equal(out[f'{key}.{a}'][r],
                                          src[:, ends, x0:x0 + nxp])


def _run(tmp_path, dims, refs, keys, seed):
    rng = np.random.default_rng(seed)
    nx, ny, nz = HALO_NG
    inputs = {'c.field': rng.standard_normal((nz, ny, nx)),
              'c.edge': rng.standard_normal((3, ny, nx))}
    cases = [{'kind': 'pencil_halo2', 'key': 'c', 'ng': HALO_NG,
              'dims': dims}]
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
    _check_halo2(out, inputs, 'c', *dims)
    for key in keys:
        kw, (_, _, jst, jchk) = refs[key]
        bulk = _bulk(kw, jst) if kw.get('impdiff') else 1.0
        _check_steps(out, key, jst, jchk, kw, work, 2, bulk=bulk)
        assert 'dsmag' in list(out[f'{key}.names'])


def test_halo2_and_dsmag_channel_on_2x2_pencils(tmp_path, refs):
    _run(tmp_path, (2, 2), refs, ('dsmag', 'dsmag_imp'), 81)


def test_halo2_and_dsmag_channel_on_1x2_pencils(tmp_path, refs):
    _run(tmp_path, (1, 2), refs, ('dsmag',), 82)


def _cut(q, e, ys, xs, yhalo):
    """A pencil's block of field q and edge stack e, its depth-2 y halo
    pair (None without yhalo: periodic y on a pencil of all the rows) and
    its two-deep x halo pair (cols (nz, 4, nyl + 4), corners (3, 4,
    nyl + 4)), cut from the whole arrays as _pencil_halos gives them."""
    ny, nx = q.shape[1], q.shape[2]
    y0, nyl = ys.start, ys.stop - ys.start
    x0, nxp = xs.start, xs.stop - xs.start
    rows = torch.as_tensor((y0 - 2 + np.arange(nyl + 4)) % ny)
    cols = torch.as_tensor([(x0 + j) % nx for j in (-2, -1, nxp, nxp + 1)])

    def xhalo(a):
        return a[:, rows][:, :, cols].transpose(1, 2).contiguous()
    yh = None
    if yhalo:
        ends = torch.as_tensor([(y0 + j) % ny for j in (-2, -1, nyl,
                                                        nyl + 1)])
        yh = (q[:, ends, xs].contiguous(), e[:, ends, xs].contiguous())
    return (q[:, ys, xs].contiguous(), e[:, ys, xs].contiguous(), yh,
            (xhalo(q), xhalo(e)))


@pytest.mark.parametrize('yhalo', [True, False], ids=['2x2', '1x2'])
@pytest.mark.parametrize('box', [False, True], ids=['channel', 'box_dit'])
def test_dsmag_x_halo_twin_on_cut_pencils_is_the_whole_fields(yhalo, box):
    kw = (dict(BOX, sgstype='dsmag', dsmag_avg='dit') if box
          else dict(DSMAG, ng=NG))
    cfg = Config(**kw)
    sim = Simulation(cfg, make_grid_from_config(cfg), device='cpu')
    _, _, fields = _perturbed(kw, seed=83 + box, scale=0.05)
    st = sim.initial_state(*fields)
    u, v, w, edges = st.u, st.v, st.w, st.zq
    args = (sim.alph2_t, sim.dzci_t, sim.dzfi_t, cfg.dli[0], cfg.dli[1],
            sim.lo_wall, sim.hi_wall, sim.dsmag_zvals)
    mode = dict(avg=cfg.dsmag_avg, zper=sim.zper)
    whole = K.dsmag_plain(u, v, w, *edges, *args, **mode)
    nz, ny, nx = u.shape
    gy, gx = (2, 2) if yhalo else (1, 2)
    nyl, nxp = ny // gy, nx // gx
    sums = [torch.zeros_like(whole[1]), torch.zeros_like(whole[2])]
    for r in range(gy * gx):
        iy, ix = divmod(r, gx)
        ys = slice(iy * nyl, (iy + 1) * nyl)
        xs = slice(ix * nxp, (ix + 1) * nxp)
        cut = [_cut(q, e, ys, xs, yhalo) for q, e in zip((u, v, w), edges)]
        q = [c[0] for c in cut]
        e = [c[1] for c in cut]
        yh = [c[2] for c in cut] if yhalo else None
        xh = [c[3] for c in cut]
        s0, num, den = K.dsmag_plain(*q, *e, *args, **mode, yh=yh, xh=xh)
        assert torch.equal(s0, whole[0][:, ys, xs]), r
        sums[0].add_(num)
        sums[1].add_(den)
        got = K.dsmag(*q, *e, *args, **mode, yh=yh, xh=xh)
        assert all(torch.equal(a, b) for a, b in zip(got, (s0, num, den)))
    for a, b in zip(sums, whole[1:]):
        torch.testing.assert_close(a, b, rtol=1e-13, atol=1e-13)
