"""The two-pass dynamic Smagorinsky and the 2D test filter on a y-slab mesh
(dims = (gy, 1)) on the CPU, on gloo ranks of tests/_sharded_worker.py
(the kernels' plain twins), against the JAX package's single-device
Simulation(use_pallas=False), f64, from the seeded asymmetric start of
tests/test_torch_sharded.py:

  * 2 steps at gy = 2 of the transpiring dsmag channel (chip_smoke.py's
    dsmag_blow at nx = 32: w = 0.003 through both z walls, impdiff_1d; two
    passes by the route rule), the dsmag duct ('duct') by two passes under
    CALES_DSMAG_TWOPASS=1, the dsmag channel with the 2D test filter
    ('channel', explicit) and the box with the 2D filter and 'dit': u, v,
    w, nu_t within 1e-11, p within 1e-11 after removing its mean, the
    duct's kept planes vlo[1] and vlo[2], the checks and the checkpoint as
    tests/test_torch_sharded.py holds them, and the kernels named;
  * dsmag_level1_plain with the depth-2 halo and dsmag_level2_plain with
    the filtered velocity's depth-1 halo on each of two slabs equal the
    whole field's twins cut to the slab, every output exactly (level2's
    'cavity' nu_t and 'duct' sums; its 'channel' sums summed over the
    slabs within 1e-13), with periodic y and with moving y and z walls
    (the slab's y-row stacks, boundary.slab_ystack); dsmag_plain with the
    2D filter on the slab (F2D and YH, with and without periodic z) the
    same way; the wrappers take the same inputs to the twins.
"""
import numpy as np
import pytest
import torch

from cales_torch.config import Config
from cales_torch.grid import make_grid_from_config
from cales_torch.ops import boundary as bnd
from cales_torch.ops import kernels as K
from cales_torch.timeloop import Simulation, unsupported

from test_torch_sharded import _check_steps, _jax_steps, _perturbed, _spawn
from test_torch_sharded_box import BOX
from test_torch_sharded_imp import DSMAG, DSMAG_IMP, _bulk
from test_torch_sharded_les import _halo, _slab_of
from test_torch_sharded_ywalls_twins import Slab, _setup
from test_torch_ywalls import DUCT

torch.set_num_threads(1)

W_BLOW = 0.003
BLOW = (((0.0,) * 3, (0.0,) * 3, (0.0, 0.0, W_BLOW)),) * 2
TWOPASS = {'CALES_DSMAG_TWOPASS': '1'}
# key: (config, environment, two passes)
CASES = {'blow': (dict(DSMAG_IMP, ng=(32, 32, 16), bcvel=BLOW), {}, True),
         'duct_twopass': (DUCT, TWOPASS, True),
         'chan_f2d': (dict(DSMAG, ng=(32, 32, 16), filter_2d=True), {},
                      False),
         'box_f2d': (dict(BOX, sgstype='dsmag', dsmag_avg='dit',
                          filter_2d=True), {}, False)}
TOL = 1e-11


@pytest.fixture(scope='module')
def refs():
    return {key: _jax_steps(kw, 2) for key, (kw, _, _) in CASES.items()}


def test_two_pass_and_2d_filter_steps_match_one_device(tmp_path, refs,
                                                       monkeypatch):
    gy = 2
    cases, inputs = [], {}
    for key, (kw, env, _) in CASES.items():
        with monkeypatch.context() as mp:
            for k, val in env.items():
                mp.setenv(k, val)
            assert unsupported(Config(**kw, dims=(gy, 1))) == [], key
        fields, dt, _, _ = refs[key]
        for q, f in zip('uvwp', fields):
            inputs[f'{key}.{q}'] = f
        inputs[f'{key}.dt'] = np.array(dt)
        cases.append({'kind': 'steps', 'key': key, 'ng': kw['ng'],
                      'cfg': {**kw, 'dims': (gy, 1)}, 'nsteps': 2,
                      'env': env})
    out, work = _spawn(tmp_path, gy, cases, inputs)
    for key, (kw, _, two) in CASES.items():
        _, _, jst, jchk = refs[key]
        forced = any(kw.get('is_forced', ())) and not kw.get('impdiff')
        _check_steps(out, key, jst, jchk, kw, work, 2,
                     bulk=1.0 if forced else _bulk(kw, jst),
                     zthomas=('thomas_periodic'
                              if kw['cbcvel'][0][2][0] == 'P'
                              else 'thomas_z'))
        if kw['cbcvel'][0][1][1] == 'D':
            for m in (1, 2):
                err = np.abs(out[f'{key}.vlo{m}']
                             - np.asarray(jst.vlo[m])).max()
                assert err <= TOL, f'{key} vlo[{m}]: {err:.3e}'
        names = list(out[f'{key}.names'])
        assert ('dsmag_level1' in names) == two, key
        assert ('dsmag_level2' in names) == two, key
        assert ('dsmag' in names) != two, key


@pytest.mark.parametrize('walled', [False, True])
def test_level_twins_on_slabs_are_the_whole_fields_rows(walled):
    gy = 2
    if walled:
        cfg, sim, f = _setup()
        u, v, w = (0.05 * f[q] for q in ('u', 'v', 'w'))
        zq = sim._zedge_vel(u, v, w, sim.bcu_vals, sim.bcv_vals,
                            sim.bcw_vals)
        ye = sim._yedge_vel(u, v, w)
        avgs = ('duct', 'cavity', 'channel')
    else:
        kw = dict(DSMAG, ng=(32, 16, 12))
        cfg = Config(**kw)
        sim = Simulation(cfg, make_grid_from_config(cfg), device='cpu')
        _, _, fields = _perturbed(kw, seed=41, scale=0.05)
        st = sim.initial_state(*fields)
        u, v, w, zq, ye = st.u, st.v, st.w, st.zq, None
        avgs = ('cavity', 'channel')
    # the whole field's level1, the filtered velocity's fill (its edge
    # stacks, with y walls its y-row stacks) and level2's inputs
    fm, fvel, lij, s0 = K.dsmag_level1_plain(
        u, v, w, *zq, sim.dzci_t, sim.dzfi_t, cfg.dli[0], cfg.dli[1], True,
        True, ye=ye)
    fze = sim._zedge_vel(*fvel, sim.bcu_vals, sim.bcv_vals, sim.bcw_vals)
    fye = sim._yedge_vel(*fvel) if walled else None
    lvl2 = (sim.alph2_t, sim.dzci_t, sim.dzfi_t, cfg.dli[0], cfg.dli[1])
    sums = {}
    for r in range(gy):
        sl = Slab(sim, gy, r)
        c = sl.cut
        q = [c(a) for a in (u, v, w)]
        e = [c(a) for a in zq]
        if walled:
            ys, h = sl.stacks((u, v, w), zq, lambda t: sim._yedge_vel(*t),
                              depth=2)
            slab = dict(ye=ys, yh=h, yown=sl.own)
        else:
            slab = dict(yh=[_halo(a, b, sl.y0, sl.nyl, 2)
                            for a, b in zip((u, v, w), zq)])
        got = K.dsmag_level1_plain(*q, *e, sim.dzci_t, sim.dzfi_t,
                                   cfg.dli[0], cfg.dli[1], True, True,
                                   **slab)
        flat = [*got[0], *got[1], *got[2], got[3]]
        for a, b in zip(flat, [*fm, *fvel, *lij, s0]):
            assert torch.equal(a, c(b)), r
        same = K.dsmag_level1(*q, *e, sim.dzci_t, sim.dzfi_t, cfg.dli[0],
                              cfg.dli[1], True, True, **slab)
        assert all(torch.equal(a, b) for a, b in
                   zip(flat, [*same[0], *same[1], *same[2], same[3]]))
        # level2 on the slab's cut of level1's outputs
        fq, fe = [c(a) for a in fvel], [c(a) for a in fze]
        h1 = [_halo(a, b, sl.y0, sl.nyl, 1) for a, b in zip(fvel, fze)]
        if walled:
            fys = [bnd.slab_ystack(a, b, y, hh, sl.own) for a, b, y, hh in
                   zip(fq, fe, sim._yedge_vel(*fq), h1)]
            kw2 = dict(ye=fys, yown=sl.own)
        else:
            kw2 = dict(yh=h1)
        args2 = (*fq, *fe, [c(a) for a in fm], [c(a) for a in lij], c(s0),
                 *lvl2)
        for avg in avgs:
            ref = K.dsmag_level2_plain(*fvel, *fze, fm, lij, s0, *lvl2,
                                       avg=avg, ye=fye)
            out = K.dsmag_level2_plain(*args2, avg=avg, **kw2)
            # (the kernel's periodic slab takes the 'channel' sums alone;
            # the twin's nu_t by cell is the exact check there)
            same = (K.dsmag_level2(*args2, avg=avg, **kw2)
                    if walled or avg == 'channel' else out)
            if avg == 'cavity':
                assert torch.equal(out, c(ref)) and torch.equal(out, same)
                continue
            assert all(torch.equal(a, b) for a, b in zip(out, same))
            if avg == 'duct':
                assert all(torch.equal(a, c(b)) for a, b in zip(out, ref))
            else:
                sums[avg] = [a + b for a, b in zip(sums.get(avg, (0, 0)),
                                                   out)]
                sums[avg + '_ref'] = ref
    for a, b in zip(sums['channel'], sums['channel_ref']):
        torch.testing.assert_close(a, b, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize('zper', [False, True])
def test_dsmag_2d_filter_twin_on_slabs_is_the_whole_fields_rows(zper):
    kw = (dict(BOX, sgstype='dsmag', dsmag_avg='dit', filter_2d=True)
          if zper else dict(DSMAG, ng=(32, 16, 12), filter_2d=True))
    cfg = Config(**kw)
    sim = Simulation(cfg, make_grid_from_config(cfg), device='cpu')
    _, _, fields = _perturbed(kw, seed=43, scale=0.05)
    st = sim.initial_state(*fields)
    u, v, w, zq = st.u, st.v, st.w, st.zq
    args = (sim.alph2_t, sim.dzci_t, sim.dzfi_t, cfg.dli[0], cfg.dli[1],
            sim.lo_wall, sim.hi_wall, sim.dsmag_zvals)
    mode = dict(zper=zper, f2d=True)
    whole = K.dsmag_plain(u, v, w, *zq, *args, **mode)
    gy, (nz, ny, _) = 2, u.shape
    nyl = ny // gy
    sums = [0.0, 0.0]
    for r in range(gy):
        y0 = r * nyl
        q = [_slab_of(a, y0, nyl) for a in (u, v, w, *zq)]
        yh = [_halo(a, b, y0, nyl, 2) for a, b in zip((u, v, w), zq)]
        s0, num, den = K.dsmag_plain(*q, *args, yh=yh, **mode)
        assert torch.equal(s0, _slab_of(whole[0], y0, nyl))
        got = K.dsmag(*q, *args, yh=yh, **mode)
        assert all(torch.equal(a, b) for a, b in zip(got, (s0, num, den)))
        sums = [sums[0] + num, sums[1] + den]
    for a, b in zip(sums, whole[1:]):
        torch.testing.assert_close(a, b, rtol=1e-13, atol=1e-13)
