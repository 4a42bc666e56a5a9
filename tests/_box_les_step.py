"""Shared by tests/test_torch_box_les_step.py,
tests/test_torch_box_forcing_step.py and
tests/test_torch_dsmag_dit_step.py: a case stepped 3 steps at fp64 by
cales_torch's Simulation on the CPU (the kernels' plain twins) and by
cales_tpu's on its XLA expression path (use_pallas=False) from the same
seeded start: the case's initflow plus seeded random low modes (the
Taylor-Green vortex alone keeps w's bulk mean and the box's dynamic ratio
trivial).

Tolerances: u, v, w 1e-11, p 1e-11 after removing its mean, nu_t 1e-11
relative to its maximum (the same formulas, sums in another order); the
forcing dpdl 1e-11."""
import numpy as np
import torch

from cales_tpu.config import Config as JConfig
from cales_tpu.grid import make_grid_from_config as j_make_grid
from cales_tpu.initflow import initflow
from cales_tpu.timeloop import Simulation as JaxSimulation

from cales_torch.config import Config
from cales_torch.grid import make_grid_from_config
from cales_torch.timeloop import Simulation, unsupported

PER = dict(cbcvel=((('P',) * 3,) * 3,) * 2, cbcpre=(('P',) * 3,) * 2,
           cbcsgs=(('P',) * 3,) * 2)
# examples/taylor_green_vortex_3d at chip_smoke.py's small card-vs-CPU grid
TGV = dict(ng=(32, 16, 24), l=(2 * np.pi,) * 3, gtype=1, gr=0.0,
           visci=1600.0, inivel='tgv', is_wallturb=False, dtype='float64',
           ptransform='mat', **PER)


def start(jcfg, jgrid, seed):
    """initflow's start plus seeded random low modes."""
    u, v, w, p = initflow(jcfg, jgrid)
    nx, ny, nz = jcfg.ng
    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid(*(2 * np.pi * (np.arange(n) + 0.5) / n
                            for n in (nz, ny, nx)), indexing='ij')
    out = []
    for q in (u, v, w):
        a, b, c = rng.standard_normal(3)
        out.append(q + 0.2 * a * np.sin(2 * x + c) * np.cos(y + b)
                   + 0.2 * b * np.cos(3 * z + a) * np.sin(2 * y + c)
                   + 0.02 * rng.standard_normal((nz, ny, nx)))
    return (*out, p)


def step_pair(kw, nsteps=3, seed=5):
    """(JAX state, port state, JAX dpdl, port dpdl, port simulation) after
    nsteps steps from the same start."""
    jcfg = JConfig(**kw, use_pallas=False)
    jgrid = j_make_grid(jcfg)
    tcfg = Config(**kw)
    assert unsupported(tcfg) == []
    jsim = JaxSimulation(jcfg, jgrid)
    tsim = Simulation(tcfg, make_grid_from_config(tcfg), device='cpu')
    fields = start(jcfg, jgrid, seed)
    jst, tst = jsim.initial_state(*fields), tsim.initial_state(*fields)
    dt = jsim.pick_dt(jsim.check(jst)[0])
    for _ in range(nsteps):
        jst, jd = jsim.step(jst, dt)
        tst, td = tsim.step(tst, dt)
    return jst, tst, jd, td, tsim


def compare(jst, tst, jd, td, sgs, tol=1e-11):
    for name in ('u', 'v', 'w', 'p', 'visct'):
        a, b = np.asarray(getattr(jst, name)), getattr(tst, name).numpy()
        if name == 'p':
            a, b = a - a.mean(), b - b.mean()
        err = np.abs(a - b).max()
        if name == 'visct' and sgs:
            assert a.max() > 0, 'nu_t zero everywhere'
            err /= np.abs(a).max()
        assert err <= tol, f'{name}: {err:.3e}'
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=tol)
