"""The two-pass dynamic Smagorinsky and the 2D test filter on a 2D pencil
mesh (dims = (gy, gx), gx > 1) on the CPU: the kernels' x-halo twins in
process, and 2 steps on gloo ranks of tests/_sharded_worker.py (the
kernels' plain twins) from the seeded asymmetric start of
tests/test_torch_sharded.py, against JAX Simulation(use_pallas=False) on
one device, f64:

  * dsmag_level1_plain(xh=...) (its two-deep x halo, with the depth-2 y
    halo or with gy = 1 periodic y), dsmag_level2_plain(xh=...) (the
    filtered velocity's depth-1 x halo in the x stacks' form, with the
    depth-1 y halo or periodic y) and dsmag_plain(f2d=True, xh=...) (z
    walls and the box's periodic z) on pencils of dims (2, 2) and (1, 2)
    whose halos are cut from the whole field, against the whole field's
    twins: every pointwise output exactly (level1's 16 fields, level2's
    'cavity' nu_t, |S|), the pencils' 'channel' sums summed within 1e-13;
    the wrappers take the same inputs to the twins;
  * 2 steps on dims (2, 2) of the transpiring dsmag channel (chip_smoke.py's
    dsmag_blow at a test size: w = 0.003 through both z walls,
    impdiff_1d; two passes by the route rule), the dsmag channel by two
    passes under CALES_DSMAG_TWOPASS=1, the dsmag channel with the 2D
    test filter and the box with the 2D filter and 'dit', and the
    transpiring channel on (1, 2): u, v, w and nu_t within 1e-11, p within
    1e-11 after removing its mean, the CFL dt, divmax, the bulk velocity,
    the checkpoint and the kernels named (tests/test_torch_sharded.py
    _check_steps).
"""
import numpy as np
import pytest
import torch

from cales_torch.config import Config
from cales_torch.grid import make_grid_from_config
from cales_torch.ops import kernels as K
from cales_torch.timeloop import Simulation, unsupported

from test_torch_pencil import _cut as _cut_depth1
from test_torch_pencil_dsmag import NG, _cut
from test_torch_sharded import _check_steps, _jax_steps, _perturbed, _spawn
from test_torch_sharded_box import BOX
from test_torch_sharded_imp import DSMAG, DSMAG_IMP, _bulk

torch.set_num_threads(1)

W_BLOW = 0.003
BLOW = (((0.0,) * 3, (0.0,) * 3, (0.0, 0.0, W_BLOW)),) * 2
TWOPASS = {'CALES_DSMAG_TWOPASS': '1'}
# key: (config, environment, two passes)
CASES = {'blow': (dict(DSMAG_IMP, ng=NG, bcvel=BLOW), {}, True),
         'chan_twopass': (dict(DSMAG, ng=NG), TWOPASS, True),
         'chan_f2d': (dict(DSMAG, ng=NG, filter_2d=True), {}, False),
         'box_f2d': (dict(BOX, sgstype='dsmag', dsmag_avg='dit',
                          filter_2d=True), {}, False)}


@pytest.fixture(scope='module')
def refs():
    return {key: _jax_steps(kw, 2) for key, (kw, _, _) in CASES.items()}


def _run(tmp_path, dims, refs, keys, monkeypatch):
    cases, inputs = [], {}
    for key in keys:
        kw, env, _ = CASES[key]
        with monkeypatch.context() as mp:
            for k, val in env.items():
                mp.setenv(k, val)
            assert unsupported(Config(**kw, dims=dims)) == [], key
        fields, dt, _, _ = refs[key]
        for q, f in zip('uvwp', fields):
            inputs[f'{key}.{q}'] = f
        inputs[f'{key}.dt'] = np.array(dt)
        cases.append({'kind': 'steps', 'key': key, 'ng': kw['ng'],
                      'dims': dims, 'cfg': {**kw, 'dims': dims},
                      'nsteps': 2, 'env': env})
    out, work = _spawn(tmp_path, dims[0] * dims[1], cases, inputs)
    for key in keys:
        kw, _, two = CASES[key]
        _, _, jst, jchk = refs[key]
        forced = any(kw.get('is_forced', ())) and not kw.get('impdiff')
        _check_steps(out, key, jst, jchk, kw, work, 2,
                     bulk=1.0 if forced else _bulk(kw, jst),
                     zthomas=('thomas_periodic'
                              if kw['cbcvel'][0][2][0] == 'P'
                              else 'thomas_z'))
        names = list(out[f'{key}.names'])
        assert ('dsmag_level1' in names) == two, key
        assert ('dsmag_level2' in names) == two, key
        assert ('dsmag' in names) != two, key


def test_two_pass_and_2d_filter_steps_on_2x2_pencils(tmp_path, refs,
                                                     monkeypatch):
    _run(tmp_path, (2, 2), refs, tuple(CASES), monkeypatch)


def test_two_pass_steps_on_1x2_pencils(tmp_path, refs, monkeypatch):
    _run(tmp_path, (1, 2), refs, ('blow',), monkeypatch)


def _pencils(gy, gx, ny, nx):
    """The (y, x) slices of the pencils of dims (gy, gx), rank order."""
    nyl, nxp = ny // gy, nx // gx
    return [(slice(iy * nyl, (iy + 1) * nyl), slice(ix * nxp, (ix + 1) * nxp))
            for iy in range(gy) for ix in range(gx)]


def _channel(seed):
    kw = dict(DSMAG, ng=NG, bcvel=BLOW)
    cfg = Config(**kw)
    sim = Simulation(cfg, make_grid_from_config(cfg), device='cpu')
    _, _, fields = _perturbed(kw, seed=seed, scale=0.05)
    st = sim.initial_state(*fields)
    return cfg, sim, st


@pytest.mark.parametrize('yhalo', [True, False], ids=['2x2', '1x2'])
def test_level_twins_on_cut_pencils_are_the_whole_fields(yhalo):
    cfg, sim, st = _channel(91 + yhalo)
    u, v, w, zq = st.u, st.v, st.w, st.zq
    lv1 = (sim.dzci_t, sim.dzfi_t, cfg.dli[0], cfg.dli[1], True, True)
    fm, fvel, lij, s0 = K.dsmag_level1_plain(u, v, w, *zq, *lv1)
    whole1 = [*fm, *fvel, *lij, s0]
    # the filtered velocity's fill (its values: w 0.003 on the z walls)
    fze = sim._zedge_vel(*fvel, sim.bcu_vals, sim.bcv_vals, sim.bcw_vals)
    lv2 = (sim.alph2_t, sim.dzci_t, sim.dzfi_t, cfg.dli[0], cfg.dli[1])
    nu_ref = K.dsmag_level2_plain(*fvel, *fze, fm, lij, s0, *lv2,
                                  avg='cavity')
    ch_ref = K.dsmag_level2_plain(*fvel, *fze, fm, lij, s0, *lv2,
                                  avg='channel')
    nz, ny, nx = u.shape
    gy, gx = (2, 2) if yhalo else (1, 2)
    sums = [torch.zeros_like(ch_ref[0]), torch.zeros_like(ch_ref[1])]
    for ys, xs in _pencils(gy, gx, ny, nx):
        cut = [_cut(q, e, ys, xs, yhalo) for q, e in zip((u, v, w), zq)]
        q = [c[0] for c in cut]
        e = [c[1] for c in cut]
        kw1 = dict(yh=[c[2] for c in cut] if yhalo else None,
                   xh=[c[3] for c in cut])
        got = K.dsmag_level1_plain(*q, *e, *lv1, **kw1)
        flat = [*got[0], *got[1], *got[2], got[3]]
        for a, b in zip(flat, whole1):
            assert torch.equal(a, b[:, ys, xs]), (ys, xs)
        same = K.dsmag_level1(*q, *e, *lv1, **kw1)
        assert all(torch.equal(a, b) for a, b in
                   zip(flat, [*same[0], *same[1], *same[2], same[3]]))
        # level2 on the pencil's cut of level1's outputs and of the fill
        cut2 = [_cut_depth1(a, b, ys, xs, yhalo) for a, b in zip(fvel, fze)]
        kw2 = dict(yh=[c[2] for c in cut2] if yhalo else None,
                   xh=[c[3] for c in cut2])
        args2 = (*(c[0] for c in cut2), *(c[1] for c in cut2),
                 [a[:, ys, xs] for a in fm], [a[:, ys, xs] for a in lij],
                 s0[:, ys, xs], *lv2)
        nu = K.dsmag_level2_plain(*args2, avg='cavity', **kw2)
        assert torch.equal(nu, nu_ref[:, ys, xs]), (ys, xs)
        out = K.dsmag_level2_plain(*args2, avg='channel', **kw2)
        same = K.dsmag_level2(*args2, avg='channel', **kw2)
        assert all(torch.equal(a, b) for a, b in zip(out, same))
        for acc, a in zip(sums, out):
            acc.add_(a)
    for a, b in zip(sums, ch_ref):
        torch.testing.assert_close(a, b, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize('yhalo', [True, False], ids=['2x2', '1x2'])
@pytest.mark.parametrize('box', [False, True], ids=['channel', 'box_dit'])
def test_dsmag_2d_filter_twin_on_cut_pencils_is_the_whole_fields(yhalo,
                                                                  box):
    kw = (dict(BOX, sgstype='dsmag', dsmag_avg='dit', filter_2d=True) if box
          else dict(DSMAG, ng=NG, filter_2d=True))
    cfg = Config(**kw)
    sim = Simulation(cfg, make_grid_from_config(cfg), device='cpu')
    _, _, fields = _perturbed(kw, seed=95 + box, scale=0.05)
    st = sim.initial_state(*fields)
    u, v, w, edges = st.u, st.v, st.w, st.zq
    args = (sim.alph2_t, sim.dzci_t, sim.dzfi_t, cfg.dli[0], cfg.dli[1],
            sim.lo_wall, sim.hi_wall, sim.dsmag_zvals)
    mode = dict(avg=cfg.dsmag_avg, zper=sim.zper, f2d=True)
    whole = K.dsmag_plain(u, v, w, *edges, *args, **mode)
    nz, ny, nx = u.shape
    gy, gx = (2, 2) if yhalo else (1, 2)
    sums = [torch.zeros_like(whole[1]), torch.zeros_like(whole[2])]
    for ys, xs in _pencils(gy, gx, ny, nx):
        cut = [_cut(q, e, ys, xs, yhalo) for q, e in zip((u, v, w), edges)]
        q = [c[0] for c in cut]
        e = [c[1] for c in cut]
        yh = [c[2] for c in cut] if yhalo else None
        xh = [c[3] for c in cut]
        s0, num, den = K.dsmag_plain(*q, *e, *args, **mode, yh=yh, xh=xh)
        assert torch.equal(s0, whole[0][:, ys, xs]), (ys, xs)
        sums[0].add_(num)
        sums[1].add_(den)
        got = K.dsmag(*q, *e, *args, **mode, yh=yh, xh=xh)
        assert all(torch.equal(a, b) for a, b in zip(got, (s0, num, den)))
    for a, b in zip(sums, whole[1:]):
        torch.testing.assert_close(a, b, rtol=1e-13, atol=1e-13)
