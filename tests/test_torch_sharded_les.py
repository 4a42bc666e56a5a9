"""cales_torch's wall-modelled and dynamic-Smagorinsky channel LES on a
y-slab mesh (dims = (gy, 1)) on the CPU, on gloo ranks of
tests/_sharded_worker.py (the kernels' plain twins), against the JAX
package's single-device Simulation(use_pallas=False), f64, from the seeded
asymmetric start of tests/test_torch_sharded.py:

  * 2 steps of bench.py's wmles_channel (the log-law wall model on both z
    walls, static Smagorinsky on the 'E' stacks, whose slab halos are the
    neighbours' extrapolated ghosts) and of the dynamic-Smagorinsky channel
    (validation/dsmag_channel.py's) explicit with 'channel' and with
    impdiff_1d with 'dit' (impdiff_1d with 'channel' is in
    test_torch_sharded_imp.py), at gy = 2 and gy = 4: u, v, w,
    nu_t within 1e-11, p within 1e-11 after removing its mean, the CFL dt,
    divmax and bulk u as tests/test_torch_sharded.py holds them;
  * the plain twins' slab modes against the whole field's twin on the cut
    slab: dsmag_plain with the depth-2 halo (|S| and the 'cavity' nu_t by
    cell exactly, the slabs' 'channel' sums summed within 1e-13) and
    wm_planes_plain with the sampled rows' halo rows (exactly);
  * what the slab still refuses with these models.
"""
import numpy as np
import pytest
import torch

from cales_torch import wallmodel as wmod
from cales_torch.config import Config
from cales_torch.grid import make_grid_from_config
from cales_torch.ops import kernels as K
from cales_torch.timeloop import Simulation, unsupported

from test_torch_sharded import (SMAG, _check_steps, _jax_steps, _perturbed,
                                _spawn)
from test_torch_sharded_imp import DSMAG, DSMAG_IMP, _bulk

# bench.py's wmles_channel (chip_smoke.py WMLES_CFG) at the mesh tests'
# size: the log-law wall model on both z walls at hwm 0.1
WMLES = dict(SMAG, visci=125_000.0, lwm=((0, 0, 1), (0, 0, 1)), hwm=0.1)
CASES = {'wmles': WMLES, 'dsmag': DSMAG,
         'dsmag_imp_dit': dict(DSMAG_IMP, dsmag_avg='dit')}


@pytest.fixture(scope='module')
def refs():
    out = {}
    for key, kw in CASES.items():
        fields, dt, jst, jchk = _jax_steps(kw, 2)
        out[key] = (kw, fields, dt, jst, jchk)
    return out


@pytest.mark.parametrize('gy', [2, 4])
def test_les_steps_match_one_device(tmp_path, refs, gy):
    cases, inputs = [], {}
    for key, (kw, fields, dt, _, _) in refs.items():
        assert unsupported(Config(**kw, dims=(gy, 1))) == [], key
        for q, f in zip('uvwp', fields):
            inputs[f'{key}.{q}'] = f
        inputs[f'{key}.dt'] = np.array(dt)
        cases.append({'kind': 'steps', 'key': key, 'ng': kw['ng'],
                      'cfg': {**kw, 'dims': (gy, 1)}, 'nsteps': 2})
    out, work = _spawn(tmp_path, gy, cases, inputs)
    for key, (kw, _, _, jst, jchk) in refs.items():
        bulk = 1.0 if not kw.get('impdiff') else _bulk(kw, jst)
        _check_steps(out, key, jst, jchk, kw, work, 2, bulk=bulk)
        names = list(out[f'{key}.names'])
        assert ('wallmodel' in names) == (key == 'wmles')
        assert ('dsmag' in names) == key.startswith('dsmag')


def _slab_of(a, y0, nyl):
    return a[:, y0:y0 + nyl].contiguous()


def _halo(g, e, y0, nyl, depth):
    """The halo pair halo_y gives a slab: rows -depth .. -1 and nyl ..
    nyl + depth - 1 of g and of its edge stack e."""
    ny = g.shape[1]
    rows = [(y0 + j) % ny for j in (*range(-depth, 0),
                                    *range(nyl, nyl + depth))]
    return g[:, rows].contiguous(), e[:, rows].contiguous()


@pytest.mark.parametrize('gy', [2, 4])
def test_dsmag_twin_on_a_slab_is_the_whole_fields_rows(gy):
    cfg = Config(**DSMAG)
    sim = Simulation(cfg, make_grid_from_config(cfg), device='cpu')
    _, _, fields = _perturbed(DSMAG, seed=gy, scale=0.05)
    st = sim.initial_state(*fields)
    u, v, w = st.u, st.v, st.w
    edges = st.zq
    args = (sim.alph2_t, sim.dzci_t, sim.dzfi_t, cfg.dli[0], cfg.dli[1],
            True, True, sim.dsmag_zvals)
    whole = K.dsmag_plain(u, v, w, *edges, *args)
    cav = K.dsmag_plain(u, v, w, *edges, *args, avg='cavity')[0]
    nyl = cfg.ng[1] // gy
    sums = torch.zeros_like(whole[1]), torch.zeros_like(whole[2])
    for r in range(gy):
        y0 = r * nyl
        q = [_slab_of(f, y0, nyl) for f in (u, v, w)]
        e = [_slab_of(f, y0, nyl) for f in edges]
        yh = [_halo(f, fe, y0, nyl, 2) for f, fe in zip((u, v, w), edges)]
        s0, num, den = K.dsmag_plain(*q, *e, *args, yh=yh)
        assert torch.equal(s0, _slab_of(whole[0], y0, nyl))
        nut = K.dsmag_plain(*q, *e, *args, avg='cavity', yh=yh)[0]
        assert torch.equal(nut, _slab_of(cav, y0, nyl))
        sums[0].add_(num)
        sums[1].add_(den)
        # the wrapper takes the same halos to its twin on the CPU
        got = K.dsmag(*q, *e, *args, yh=yh)
        assert all(torch.equal(a, b) for a, b in zip(got, (s0, num, den)))
    for a, b in zip(sums, whole[1:]):
        torch.testing.assert_close(a, b, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize('gy', [2, 4])
def test_wm_twin_on_a_slab_is_the_whole_fields_rows(gy):
    cfg = Config(**WMLES)
    sim = Simulation(cfg, make_grid_from_config(cfg), device='cpu')
    _, _, fields = _perturbed(WMLES, seed=10 + gy, scale=0.05)
    u, v, w = (torch.as_tensor(f) for f in fields[:3])
    wm = sim.wm
    whole = wmod.wm_planes_plain(u, v, wm, w=w)
    rows = wmod.sampled_rows(u, v, wm)
    nyl = cfg.ng[1] // gy
    for r in range(gy):
        y0 = r * nyl
        yh, _ = _halo(rows, rows[:3], y0, nyl, 1)
        q = [_slab_of(f, y0, nyl) for f in (u, v, w)]
        got = wmod.wm_planes_plain(*q[:2], wm, w=q[2], yh=yh)
        assert torch.equal(K.wm_planes(*q[:2], wm, w=q[2], yh=yh)[0],
                           got[0])
        for a, b in zip(got, whole):
            # bcu over the slab's rows 1 .. nyl, bcv over 0 .. nyl: the
            # whole plane's rows y0 .. y0 + nyl (its padded row y0 is the
            # slab's row -1), the y ghost rows of bcu the static values
            assert torch.equal(a[0, 1:nyl + 1], b[0, y0 + 1:y0 + nyl + 1])
            assert torch.equal(a[1, 0:nyl + 1], b[1, y0:y0 + nyl + 1])


@pytest.mark.parametrize('change, env, needle', [
    # the 2D filter where transpiring walls force the two passes
    (dict(DSMAG, filter_2d=True,
          bcvel=(((0.0,) * 3, (0.0,) * 3, (0.0, 0.0, 0.003)),) * 2), {},
     'the 2D test filter where a face value forces the two passes'),
    (dict(DSMAG, ng=(64, 4, 16)), {}, "thinner than the dsmag kernel's"),
    (dict(WMLES, impdiff=True, impdiff_1d=True), {},
     'a wall model with implicit diffusion'),
    (dict(WMLES, sgstype='dsmag', dsmag_avg='channel'), {},
     'a wall model with dynamic Smagorinsky'),
])
def test_mesh_refuses_what_the_slab_does_not_run(monkeypatch, change, env,
                                                 needle):
    for k, val in env.items():
        monkeypatch.setenv(k, val)
    missing = unsupported(Config(**change, dims=(4, 1)))
    assert any(needle in m for m in missing), missing
