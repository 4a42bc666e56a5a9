"""The wall-modelled duct (examples/turbulent_duct_wmles: the log-law wall
model on the four y and z walls, static Smagorinsky on its 'E' stacks, x
forcing) on a y-slab mesh (dims = (gy, 1)) on the CPU, on gloo ranks of
tests/_sharded_worker.py (the kernels' plain twins), against the JAX
package's single-device Simulation(use_pallas=False), f64, from the seeded
asymmetric start of tests/test_torch_sharded.py, at the physics of the
JAX package's own slab test of this class
(tests/test_sharding_paths.py:604-626) with nx cut to 32:

  * 2 steps at gy = 2 and at gy = 4 (slabs of 16 and 8 rows; the y faces'
    sampled rows, rows 2 and 3 from each wall at hwm 0.2, lie on the
    walls' slabs): u, v, w, nu_t within 1e-11, p within 1e-11 after
    removing its mean, the kept planes vlo[1] and vlo[2], the CFL dt,
    divmax and bulk u as tests/test_torch_sharded.py holds them;
  * in the same spawn, each slab's wall-model planes as the step makes
    them (Simulation._wm_planes: the z faces' sampled rows with the y
    recipe on the sides the slab owns and the neighbours' halo rows
    elsewhere, the y faces on their owners) against one device's planes
    (wallmodel.wm_planes_plain) sliced to the slab, bitwise: bcu over the
    slab's rows, bcv over its rows and the one below, and the plane's
    ghost row on a side the slab owns; the y faces whole on their owners;
  * the refusals: the new "sampled y row off its owning slab" and what a
    wall model still refuses.
"""
import numpy as np
import pytest
import torch

from cales_torch import wallmodel as wmod
from cales_torch.config import Config
from cales_torch.grid import make_grid_from_config
from cales_torch.timeloop import Simulation, unsupported

from test_torch_sharded import _jax_steps, _perturbed
from test_torch_sharded_ywalls import run_cases

torch.set_num_threads(1)

DUCT_BCS = dict(
    cbcvel=((('P', 'P', 'P'), ('D', 'D', 'D'), ('D', 'D', 'D')),) * 2,
    cbcpre=(('P', 'N', 'N'),) * 2, cbcsgs=(('P', 'D', 'D'),) * 2)
# tests/test_sharding_paths.py's duct WMLES, nx 128 -> 32
WMDUCT = dict(ng=(32, 32, 16), l=(2 * np.pi, 2.0, 2.0), gtype=1, gr=0.0,
              visci=20_000.0, inivel='duc', is_wallturb=False,
              dtype='float64', is_forced=(True, False, False),
              velf=(1.0, 0.0, 0.0), sgstype='smag', ptransform='mat',
              lwm=((0, 1, 1), (0, 1, 1)), hwm=0.2, **DUCT_BCS)


@pytest.fixture(scope='module')
def ref():
    return _jax_steps(WMDUCT, 2)


def _planes_case(key, gy):
    """The worker's wall-model case at gy on seeded random fields."""
    _, _, fields = _perturbed(WMDUCT, seed=30 + gy, scale=0.05)
    return ({'kind': 'wmplanes', 'key': key, 'ng': WMDUCT['ng'],
             'cfg': {**WMDUCT, 'dims': (gy, 1)}},
            {f'{key}.{q}': f for q, f in zip('uvw', fields[:3])}, fields)


def _check_planes(out, key, gy, fields):
    cfg = Config(**WMDUCT)
    sim = Simulation(cfg, make_grid_from_config(cfg), device='cpu')
    u, v, w = (torch.as_tensor(f) for f in fields[:3])
    whole = {f'{f.d}{f.ib}': q.numpy() for f, q in zip(
        sim.wm.faces, wmod.wm_planes_plain(u, v, sim.wm, w=w))}
    nyl = cfg.ng[1] // gy
    for r in range(gy):
        y0, own = r * nyl, (r == 0, r == gy - 1)
        for name, b in whole.items():
            a = out.get(f'{key}.r{r}.f{name}')
            if name[0] == '1':
                # a y face: on its owner alone, its whole plane
                assert (a is not None) == own[int(name[1])], (r, name)
                if a is not None:
                    np.testing.assert_array_equal(a, b)
                continue
            # a z face: bcu over the slab's rows 1 .. nyl, bcv over 0 ..
            # nyl (its row 0 the lower neighbour's last), and on an owned
            # side the ghost row too
            lo = 0 if own[0] else 1
            hi = nyl + 2 if own[1] else nyl + 1
            np.testing.assert_array_equal(a[0, lo:hi], b[0, y0 + lo:y0 + hi])
            np.testing.assert_array_equal(a[1, 0:hi], b[1, y0:y0 + hi])


@pytest.mark.parametrize('gy', [2, 4])
def test_wm_duct_steps_and_planes_match_one_device(tmp_path, ref, gy):
    case, inputs, fields = _planes_case('planes', gy)
    out = run_cases(tmp_path, gy, {'wmduct': (WMDUCT, ref)}, [case], inputs)
    names = list(out['wmduct.names'])
    assert 'wallmodel' in names and 'smag' in names
    _check_planes(out, 'planes', gy, fields)


@pytest.mark.parametrize('change, gy, needle', [
    # hwm 0.5 samples row 8 of 32 from each y wall: off slabs of 8 rows
    (dict(hwm=0.5), 4, 'a sampled y row off its owning slab'),
    (dict(hwm=0.5, lwm=((0, 1, 0), (0, 0, 0))), 4,
     'a sampled y row off its owning slab'),
    (dict(impdiff=True, impdiff_1d=True), 2,
     'a wall model with implicit diffusion'),
    # the mixed route runs on the mesh; the slab rule holds on it too
    (dict(ptransform='fft', hwm=0.5), 4,
     'a sampled y row off its owning slab'),
])
def test_wm_duct_mesh_refusals(change, gy, needle):
    missing = unsupported(Config(**{**WMDUCT, **change}, dims=(gy, 1)))
    assert any(needle in m for m in missing), missing


def test_wm_duct_rows_on_the_walls_slabs():
    # the rows stay on the walls' slabs at hwm 0.5 on two slabs of 16
    assert unsupported(Config(**{**WMDUCT, 'hwm': 0.5}, dims=(2, 1))) == []
    cfg = Config(**{**WMDUCT, 'hwm': 0.5})
    wm = wmod.wall_model(cfg, make_grid_from_config(cfg),
                         wmod.find_index_wm(cfg, make_grid_from_config(cfg)))
    yfaces = [f for f in wm.faces if f.d == 1]
    assert [(f.r1, f.r2) for f in yfaces] == [(7, 8), (24, 23)]
    with pytest.raises(ValueError, match='off the slab'):
        wmod.slab_wall_model(wm, 0, 8, (True, False))
