"""Shared by tests/test_torch_scalar_step.py and
tests/test_torch_scalar_walls_step.py: a scalar-carrying case stepped by
cales_torch's Simulation on the CPU (the kernels' plain twins) and by
cales_tpu's on its XLA expression path (use_pallas=False), fp64, from
seeded perturbed initial fields and a seeded perturbation of the case's
own initial scalar.

Tolerances: u, v, w and s 1e-11, p 1e-11 after removing its mean (the
pressure is all-Neumann on some of the cases), nu_t 1e-11 of its maximum;
the kept wall planes vlo along the walled directions 1e-11 (a periodic
direction's plane is never read, and the JAX expression path refills it
while the port keeps it)."""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from cales_tpu.config import Config as JConfig
from cales_tpu.grid import make_grid_from_config as j_make_grid
from cales_tpu.initflow import initflow
from cales_tpu.timeloop import Simulation as JaxSimulation

from cales_torch import params
from cales_torch.config import Config
from cales_torch.grid import make_grid_from_config
from cales_torch.timeloop import Simulation, unsupported

NG = (32, 8, 8)


def sims(kw, seed=17):
    """(JAX simulation, port simulation, initial fields) of a case."""
    jcfg, tcfg = JConfig(**kw, use_pallas=False), Config(**kw)
    assert unsupported(tcfg) == []
    jgrid = j_make_grid(jcfg)
    rng = np.random.default_rng(seed)
    fields = [np.asarray(f) + 0.05 * rng.standard_normal(np.shape(f))
              for f in initflow(jcfg, jgrid)]
    return (JaxSimulation(jcfg, jgrid),
            Simulation(tcfg, make_grid_from_config(tcfg), device='cpu'),
            fields)


def compare(jst, tst, tsim, tol=1e-11):
    cfg = tsim.cfg
    all_n = 'D' not in ''.join(cfg.cbcpre[ib][d] for ib in range(2)
                               for d in range(3))
    for name in ('u', 'v', 'w', 's', 'p', 'visct'):
        a, b = np.asarray(getattr(jst, name)), getattr(tst, name).numpy()
        if name == 'p' and all_n:
            a, b = a - a.mean(), b - b.mean()
        err = np.abs(a - b).max()
        if name == 'visct':
            err /= max(float(np.abs(a).max()), 1e-300)
        assert err <= tol, f'{name}: {err:.3e}'
    for m in range(3):
        if tsim.cbcvel[0][m][m] == 'P':
            continue
        err = np.abs(np.asarray(jst.vlo[m]) - tst.vlo[m].numpy()).max()
        assert err <= tol, f'vlo[{m}]: {err:.3e}'


def run(kw, nsteps=3):
    """Step a case nsteps steps on both sides, comparing after each; the
    port's final state, its simulation and the JAX pair."""
    jsim, tsim, fields = sims(kw)
    jst, tst = jsim.initial_state(*fields), tsim.initial_state(*fields)
    compare(jst, tst, tsim)
    # a seeded perturbation of the initial scalar, so that every term of
    # its stencil moves it
    rng = np.random.default_rng(23)
    s0 = np.asarray(jst.s) + 0.1 * rng.standard_normal(np.shape(jst.s))
    jst, tst = jst._replace(s=jnp.asarray(s0)), tst._replace(
        s=torch.as_tensor(s0))
    dt = jsim.pick_dt(jsim.check(jst)[0])
    for _ in range(nsteps):
        jst, _ = jsim.step(jst, dt)
        tst, _ = tsim.step(tst, dt)
        compare(jst, tst, tsim)
    assert 'passive scalar' in tsim.exec_path()
    return tst, tsim, (jsim, jst, dt)


def carried(jsim, jst, tsim, dt):
    """A JAX state after its steps (its scalar and the scalar's previous
    RHS included) carried into the port by params.state_from_jax_numpy,
    stepped once more on both sides."""
    leaves = dict(u=jst.u, v=jst.v, w=jst.w, p=jst.p, visct=jst.visct,
                  vlo=jst.vlo, rhs_old=jst.rhs_old, zq=jst.zq,
                  time=jst.time, istep=jst.istep, s=jst.s,
                  dsdt_old=jst.dsdt_old)
    tst = params.state_from_jax_numpy(
        jax.tree_util.tree_map(np.asarray, leaves), 'cpu', torch.float64)
    back = params.state_to_numpy(tst)
    np.testing.assert_array_equal(back['s'], np.asarray(jst.s))
    np.testing.assert_array_equal(back['dsdt_old'], np.asarray(jst.dsdt_old))
    jst, _ = jsim.step(jst, dt)
    tst, _ = tsim.step(tst, dt)
    compare(jst, tst, tsim)
