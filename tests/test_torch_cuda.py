"""cales_torch's CUDA kernels on the card: each against its plain twin, and
the slice on the card against the slice on the CPU, step for step, fp64.

These tests need an NVIDIA GPU and skip without one.  The file imports no
jax, so it runs on a machine that has torch and the CUDA toolkit only:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: kernel vs twin 1e-12 (the same formulas; FMA contraction and
the order of a few sums differ); card vs CPU after 3 steps u, v, w 1e-11,
p 1e-10 after removing its mean, nu_t 1e-12."""
import numpy as np
import pytest
import torch

from cales_tpu.config import Config
from cales_tpu.grid import make_grid_from_config
from cales_tpu.initflow import initflow

from cales_torch.ops import kernels as K
from cales_torch.timeloop import Simulation

torch.set_num_threads(1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the CUDA kernels have no CPU mode)')
    return torch.device('cuda')


@pytest.mark.cuda
def test_cuda_kernels_match_twins_on_card(dev):
    ng = (72, 40, 24)     # (nx, ny, nz): no dimension a power of two
    nx, ny, nz = ng
    cfg = Config(ng=ng, l=(2 * np.pi, np.pi, 2.0), gtype=1, gr=1.0,
                 visci=1000.0, dtype='float64')
    grid = make_grid_from_config(cfg)
    rng = np.random.default_rng(8)

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev)
    F = lambda: t(0.05 * rng.standard_normal((nz, ny, nx)))   # noqa: E731
    E = lambda: t(0.05 * rng.standard_normal((3, ny, nx)))    # noqa: E731
    u, v, w, s, p, pp, ruo, rvo, rwo = (F() for _ in range(9))
    s = s.abs()
    ue, ve, we, se, pe, ppe = (E() for _ in range(6))
    se = se.abs()
    dxi, dyi = cfg.dli[0], cfg.dli[1]
    dzci, dzfi = t(grid.dzci), t(grid.dzfi)

    mom = (u, v, w, s, p, ue, ve, we, se, pe, ruo, rvo, rwo, dzci, dzfi,
           5e-4, -2e-4, cfg.visc, dxi, dyi, (0.1, 0.0, 0.0))
    K.reset_launches()
    got = K.mom_rk(*mom, sums=(True, False))
    ref = K.mom_rk_plain(*mom, sums=(True, False))
    for g, r in zip(got[:6], ref[:6]):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-12)
    torch.testing.assert_close(got[6].sum(1), ref[6][:, 0], rtol=0,
                               atol=1e-12)
    assert got[7] is None

    fp = (u, v, w, ue, ve, we, dzfi, 20.0, dxi, dyi)
    torch.testing.assert_close(K.fillps(*fp), K.fillps_plain(*fp), rtol=0,
                               atol=1e-12)

    dz01 = (float(grid.dzc[0]), float(grid.dzc[nz]))
    zc = grid.zc[1:nz + 1]
    for zrec in ((('D', 0.0, dz01[0], 'D', 0.0, dz01[1]),) * 2,
                 (('N', 0.3, dz01[0], 'N', -0.2, dz01[1]),
                  ('D', 0.1, dz01[0], 'N', 0.05, dz01[1]))):
        cs = (u, v, w, pp, p, ue, ve, we, ppe, 3.7e-3, dxi, dyi, dzci, dzfi,
              cfg.visc, t(np.full(nz, 1e-4)), zrec, t([0.05, -0.02]),
              t(np.minimum(zc, 2.0 - zc)), t((zc <= 1.0).astype(float)),
              s[0].contiguous(), s[1].contiguous())
        for g, r in zip(K.correc_smag(*cs), K.correc_smag_plain(*cs)):
            torch.testing.assert_close(g, r, rtol=0, atol=1e-12)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {'mom_rk': 1, 'fillps': 1, 'correc_smag': 2}


@pytest.mark.cuda
def test_card_matches_cpu_step_for_step(dev):
    cfg = Config(ng=(32, 16, 16), l=(2 * np.pi, np.pi, 2.0), gtype=1, gr=1.0,
                 visci=20_000.0, inivel='log', is_wallturb=True,
                 is_forced=(True, False, False), velf=(1.0, 0.0, 0.0),
                 sgstype='smag', dtype='float64', ptransform='fft')
    grid = make_grid_from_config(cfg)
    fields = initflow(cfg, grid)
    sims = [Simulation(cfg, grid, device=d) for d in (dev, 'cpu')]
    states = [s.initial_state(*fields) for s in sims]
    dt = sims[1].pick_dt(sims[1].check(states[1])[0])
    K.reset_launches()
    for _ in range(3):
        states = [s.step(st, dt)[0] for s, st in zip(sims, states)]
    assert K.LAUNCHES == {'mom_rk': 9, 'fillps': 9, 'correc_smag': 9}
    g, c = states
    for name, tol in (('u', 1e-11), ('v', 1e-11), ('w', 1e-11), ('p', 1e-10),
                      ('visct', 1e-12)):
        a, b = getattr(g, name).cpu(), getattr(c, name)
        if name == 'p':
            a, b = a - a.mean(), b - b.mean()
        assert float((a - b).abs().max()) <= tol, name
