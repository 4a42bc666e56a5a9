"""cales_torch's z-implicit diffusion (impdiff_1d) on a y-slab mesh
(dims = (gy, 1)) on the CPU, on gloo ranks of tests/_sharded_worker.py
(the kernels' plain twins), against the JAX package's single-device
Simulation(use_pallas=False), f64, from the seeded asymmetric start of
tests/test_torch_sharded.py:

  * 2 steps of the channel DNS with impdiff_1d (bench.py's
    channel_dns_impdiff, sgstype 'none'), of the static-Smagorinsky LES
    with impdiff_1d (chip_smoke.py phase 7b's class) and of the
    dynamic-Smagorinsky channel with impdiff_1d and the 'channel' average
    (validation/dsmag_channel.py's, chip_smoke.py phase 10d) at gy = 2 and
    gy = 4:
    u, v, w, nu_t within 1e-11, p within 1e-11 after removing its mean, the
    CFL dt and divmax as tests/test_torch_sharded.py holds them, the bulk
    u the reference's (the CN solves diffuse the forcing's shift);
  * halo_y at depth 2 (the dsmag kernel's halo) against slicing of the
    global array, exactly, at gy = 2 and 4.
"""
import numpy as np
import pytest

from cales_tpu.config import Config as JaxConfig
from cales_tpu.grid import make_grid_from_config as jax_grid

from cales_torch.config import Config
from cales_torch.timeloop import unsupported

from test_torch_sharded import CHAN_BCS, _check_steps, _jax_steps, _spawn

# bench.py's channel_dns_impdiff (chip_smoke.py DNS_CFG) at the mesh
# tests' size: sgstype 'none', z-implicit diffusion, bulk forcing along x
DNS_IMP = dict(ng=(64, 32, 16), l=(2 * np.pi, np.pi, 2.0), gtype=1, gr=1.0,
               visci=5640.0, inivel='log', is_wallturb=True,
               is_forced=(True, False, False), velf=(1.0, 0.0, 0.0),
               sgstype='none', impdiff=True, impdiff_1d=True,
               dtype='float64', ptransform='mat', **CHAN_BCS)
# the LES headline with z-implicit diffusion (chip_smoke.py LES_IMP_CFG)
LES_IMP = dict(DNS_IMP, visci=20_000.0, sgstype='smag')
# validation/dsmag_channel.py:77-89 (chip_smoke.py DSMAG_CFG) at the same
# size, with impdiff_1d as it runs; explicit in test_torch_sharded_les.py
DSMAG_IMP = dict(ng=(64, 32, 16), l=(12.8, 4.8, 2.0), gtype=1, gr=5.0,
                 visci=10_000.0, inivel='poi', is_wallturb=True,
                 is_forced=(True, False, False), velf=(1.0, 0.0, 0.0),
                 dtype='float64', sgstype='dsmag', dsmag_avg='channel',
                 ptransform='mat', impdiff=True, impdiff_1d=True, **CHAN_BCS)
DSMAG = dict(DSMAG_IMP, impdiff=False, impdiff_1d=False)
CASES = {'dns_imp': DNS_IMP, 'les_imp': LES_IMP, 'dsmag_imp': DSMAG_IMP}


def _bulk(kw, jst):
    """The reference's bulk u: the plane means weighted by dzf / l_z."""
    nz = kw['ng'][2]
    dzf = np.asarray(jax_grid(JaxConfig(**kw)).dzf)[1:nz + 1]
    return float(np.asarray(jst.u).mean(axis=(1, 2)) @ dzf / kw['l'][2])


def _run(tmp_path, gy, refs):
    cases, inputs = [], {}
    for key, (kw, fields, dt, _, _) in refs.items():
        for q, f in zip('uvwp', fields):
            inputs[f'{key}.{q}'] = f
        inputs[f'{key}.dt'] = np.array(dt)
        cases.append({'kind': 'steps', 'key': key, 'ng': kw['ng'],
                      'cfg': {**kw, 'dims': (gy, 1)}, 'nsteps': 2})
    return _spawn(tmp_path, gy, cases, inputs)


@pytest.fixture(scope='module')
def refs():
    out = {}
    for key, kw in CASES.items():
        fields, dt, jst, jchk = _jax_steps(kw, 2)
        out[key] = (kw, fields, dt, jst, jchk)
    return out


@pytest.mark.parametrize('gy', [2, 4])
def test_impdiff_1d_steps_match_one_device(tmp_path, refs, gy):
    for kw in CASES.values():
        assert unsupported(Config(**kw, dims=(gy, 1))) == []
    out, work = _run(tmp_path, gy, refs)
    for key, (kw, _, _, jst, jchk) in refs.items():
        _check_steps(out, key, jst, jchk, kw, work, 2, bulk=_bulk(kw, jst))
        # the CN solves' Thomas kernel, and no z eigen stage
        names = list(out[f'{key}.names'])
        assert 'thomas_z' in names
        assert ('dsmag' in names) == (key == 'dsmag_imp')


@pytest.mark.parametrize('gy', [2, 4])
def test_halo_depth_two_is_the_global_rows(tmp_path, gy):
    rng = np.random.default_rng(30 + gy)
    nz, ny, nx = 5, 4 * gy, 12
    g = rng.standard_normal((nz, ny, nx))
    e = rng.standard_normal((3, ny, nx))
    out, _ = _spawn(tmp_path, gy, [{'kind': 'halo2', 'key': 'h',
                                    'ng': (nx, ny, nz)}],
                    {'h.field': g, 'h.edge': e})
    nyl = ny // gy
    for r in range(gy):
        rows = [(r * nyl + j) % ny for j in (-2, -1, nyl, nyl + 1)]
        np.testing.assert_array_equal(out['h.rows2'][r], g[:, rows])
        np.testing.assert_array_equal(out['h.corners2'][r], e[:, rows])
        np.testing.assert_array_equal(out['h.rows2b'][r], g[:2, rows])
