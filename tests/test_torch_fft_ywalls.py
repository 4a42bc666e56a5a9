"""The mixed Poisson route on one device, fp64 on the CPU: ptransform
'fft' with y walls takes the rfft along x and the y transform's DCT matrix
(the apply_y kernel's plain twin on the real view of the rfft's lanes),
as the JAX package's XLA solve does off a TPU (x_was_fft).

  * the Poisson solve with Neumann y and Neumann or Dirichlet-top z ('NN',
    'ND'), by the eigen and the Thomas z stage, and w's Helmholtz solve
    with its face-staggered tail row, against JAX poisson.solve (XLA, its
    eigen z stage) within 1e-11, p after removing its mean where the
    operator is singular;
  * 2 steps of the dsmag and the static-Smagorinsky duct by 'fft' against
    JAX Simulation(use_pallas=False) with ptransform 'fft', as
    tests/test_torch_ywalls.py holds the 'mat' route: u, v, w and the kept
    wall planes within 1e-11, p after removing its mean, nu_t relative to
    its maximum; the kernels named (apply_y, no z_eig).
"""
import numpy as np
import pytest
import torch

from cales_tpu import poisson as jpoisson
from cales_tpu.config import Config as JConfig
from cales_tpu.grid import make_grid_from_config as j_make_grid

from cales_torch import poisson as tpoisson
from cales_torch.config import Config
from cales_torch.grid import make_grid_from_config
from cales_torch.timeloop import unsupported

from test_torch_ywalls import DUCT, _close, _compare, _sims

torch.set_num_threads(1)

FFT_DUCT = dict(DUCT, ptransform='fft')
TOL = 1e-11


@pytest.mark.parametrize('cbc, cf, alpha', [
    (('PP', 'NN', 'NN'), ('c', 'c', 'c'), None),
    (('PP', 'NN', 'ND'), ('c', 'c', 'c'), None),
    (('PP', 'DD', 'DD'), ('c', 'c', 'f'), -0.03)])
@pytest.mark.parametrize('zsolver', ['eig', 'thomas'])
def test_mixed_route_solve_matches_jax(cbc, cf, alpha, zsolver):
    jcfg = JConfig(**FFT_DUCT, use_pallas=False)
    tcfg = Config(**FFT_DUCT)
    jsv = jpoisson.make_solver(jcfg, j_make_grid(jcfg), cbc, cf)
    tsv = tpoisson.make_solver(tcfg, make_grid_from_config(tcfg), cbc, cf,
                               zsolver=zsolver)
    assert (jsv.trx.kind, jsv.try_.kind) == ('fft', 'mat')
    assert (tsv.trx.kind, tsv.try_.kind) == ('fft', 'mat')
    nx, ny, nz = FFT_DUCT['ng']
    rng = np.random.default_rng(71)
    rhs = rng.standard_normal((nz, ny, nx))
    singular = alpha is None and cbc[2] == 'NN'
    if singular:
        dzf = np.asarray(j_make_grid(jcfg).dzf)[1:nz + 1]
        rhs = rhs - rhs.mean(axis=(1, 2)) @ dzf / dzf.sum()
    ref = np.asarray(jpoisson.solve(jsv, rhs, alpha=alpha))
    got = tpoisson.solve(tsv, torch.as_tensor(rhs), alpha=alpha).numpy()
    if singular:
        ref, got = ref - ref.mean(), got - got.mean()
    err = np.abs(got - ref).max()
    assert err <= TOL * max(1.0, np.abs(ref).max()), err
    if alpha is not None:
        # w's tail row passes through the z stage
        assert np.abs(got[-1] - rhs[-1]).max() <= 1e-13


@pytest.mark.parametrize('sgs', ['dsmag', 'smag'])
def test_fft_duct_matches_jax_for_two_steps(sgs):
    kw = dict(FFT_DUCT, sgstype=sgs)
    jsim, tsim, fields = _sims(kw)
    assert unsupported(tsim.cfg) == []
    sv = tsim.solver_p
    assert (sv.trx.kind, sv.try_.kind) == ('fft', 'mat')
    names = tsim.kernel_names()
    assert 'apply_y' in names and 'z_eig' not in names, names
    assert not {'thomas_z', 'thomas_periodic', 'apply_x'} & set(names)
    assert sgs in names
    assert 'apply_y y DCT on the lanes (mixed route)' in tsim.exec_path()
    jst, tst = jsim.initial_state(*fields), tsim.initial_state(*fields)
    dt = jsim.pick_dt(jsim.check(jst)[0])
    for _ in range(2):
        jst, jd = jsim.step(jst, dt)
        tst, td = tsim.step(tst, dt)
        _compare(jst, tst)
        _close(td, jd, TOL)
