"""The two-pass dynamic Smagorinsky model of cales_torch against cales_tpu's
Pallas kernels in interpret mode (as tests/test_pallas_kernels.py runs
them), fp64 on the CPU, at (nx, ny, nz) = (128, 16, 16):

  * dsmag_level1_plain against fused_dsmag_level1, all 16 outputs, on the
    post-correction fill of a transpiring channel (w = W through both z
    walls) after one step;
  * dsmag_level2_plain against fused_dsmag_level2 for the 'channel', 'duct'
    and 'cavity' averages, both fed the same DS1 output and the filtered
    velocity's static fill built by each package;
  * with y walls, the port's two-pass SGS stage against the JAX package's
    _compute_dsmag_kernel (CALES_PALLAS_INTERPRET=1,
    CALES_DSMAG_TWOPASS=1) on the duct with transpiring z walls and on the
    cavity.

Interpret mode takes about 10 s a kernel call on one core, so the file
makes eight of them.  Tolerance: 1e-12 of each output's maximum (the same
operations; the sums of the averages run in another order)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cales_tpu.config import Config as JConfig
from cales_tpu.grid import make_grid_from_config as j_make_grid
from cales_tpu.ops import boundary as jbnd
from cales_tpu.ops import pallas_dsmag as pds
from cales_tpu.timeloop import Simulation as JaxSimulation

from cales_torch.config import Config
from cales_torch.grid import make_grid_from_config
from cales_torch.initflow import initflow
from cales_torch.ops import kernels as K
from cales_torch.timeloop import Simulation

torch.set_num_threads(1)

W = 0.003
TRANSPIRING = (((0.0,) * 3, (0.0,) * 3, (0.0, 0.0, W)),
               ((0.0,) * 3, (0.0,) * 3, (0.0, 0.0, W)))
CHAN_BCS = dict(
    cbcvel=((('P', 'P', 'P'), ('P', 'P', 'P'), ('D', 'D', 'D')),) * 2,
    cbcpre=(('P', 'P', 'N'),) * 2, cbcsgs=(('P', 'P', 'D'),) * 2)
DUCT_BCS = dict(
    cbcvel=((('P', 'P', 'P'), ('D', 'D', 'D'), ('D', 'D', 'D')),) * 2,
    cbcpre=(('P', 'N', 'N'),) * 2, cbcsgs=(('P', 'D', 'D'),) * 2)
NG = (128, 16, 16)
# chip_smoke.py's dsmag_blow (validation/dsmag_channel.py's channel with w
# = W through both z walls), the duct_les_dsmag duct with the same walls,
# and cavity_les_dsmag, at the Pallas kernels' smallest tile
BLOW = dict(ng=NG, l=(12.8, 4.8, 2.0), gtype=1, gr=5.0, visci=10_000.0,
            inivel='poi', is_wallturb=True, is_forced=(True, False, False),
            velf=(1.0, 0.0, 0.0), dtype='float64', sgstype='dsmag',
            dsmag_avg='channel', ptransform='mat', impdiff=True,
            impdiff_1d=True, bcvel=TRANSPIRING, **CHAN_BCS)
DUCT_BLOW = dict(ng=NG, l=(4 * np.pi, 2.0, 2.0), gtype=1, gr=1.0,
                 visci=10_000.0, inivel='duc', is_wallturb=True,
                 is_forced=(True, False, False), velf=(1.0, 0.0, 0.0),
                 sgstype='dsmag', dsmag_avg='duct', dtype='float64',
                 ptransform='mat', bcvel=TRANSPIRING, **DUCT_BCS)
CAVITY = dict(ng=NG, l=(1.0, 1.0, 1.0), gtype=1, gr=0.0, visci=5_000.0,
              inivel='tgv', sgstype='dsmag', dsmag_avg='cavity',
              dtype='float64', ptransform='mat',
              bcvel=(((0.0,) * 3,) * 3,
                     ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))),
              **DUCT_BCS)


def _rel_close(got, ref, rtol=1e-12):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rtol * np.abs(ref).max())


def _stepped(kw):
    """The port's Simulation on the CPU and its state after one step."""
    cfg = Config(**kw)
    grid = make_grid_from_config(cfg)
    sim = Simulation(cfg, grid, device='cpu')
    st = sim.initial_state(*initflow(cfg, grid))
    st, _ = sim.step(st, sim.pick_dt(sim.check(st)[0]))
    return sim, st


@pytest.fixture(scope='module')
def blow():
    """The transpiring channel after one step and fused_dsmag_level1 on
    its post-correction fill."""
    sim, st = _stepped(BLOW)
    assert sim.dsmag_twopass
    grid, dli = sim.grid, sim.cfg.dli
    ref = pds.fused_dsmag_level1(
        *(jnp.asarray(q.numpy()) for q in (st.u, st.v, st.w, *st.zq)),
        grid.dzci, grid.dzfi, dli[0], dli[1], True, True, interpret=True)
    return sim, st, [np.asarray(q) for q in (*ref[0], *ref[1], *ref[2],
                                              ref[3])]


def test_level1_twin_matches_pallas(blow):
    sim, st, ref = blow
    dli = sim.cfg.dli
    fm, fvel, lij, s0 = K.dsmag_level1_plain(
        st.u, st.v, st.w, *st.zq, sim.dzci_t, sim.dzfi_t, dli[0], dli[1],
        True, True)
    got = [*fm, *fvel, *lij, s0]
    assert len(got) == len(ref) == 16
    for g, r in zip(got, ref):
        _rel_close(g, r)
    # the transpiring walls reach the filtered w
    assert abs(float(fvel[2][0].mean()) - W) < 0.1 * W


@pytest.mark.parametrize('avg', ['channel', 'duct', 'cavity'])
def test_level2_twin_matches_pallas(blow, avg):
    """The same DS1 output into both; each package builds the filtered
    velocity's static fill (w's faces carry W)."""
    sim, _, ref1 = blow
    grid, dli, nz = sim.grid, sim.cfg.dli, NG[2]
    fm, fvel, lij, s0 = ref1[0:6], ref1[6:9], ref1[9:15], ref1[15]
    jb = [jbnd.make_bc_values(NG, tuple(tuple(TRANSPIRING[ib][d][iv]
                                              for ib in range(2))
                                        for d in range(3)), np.float64)
          for iv in range(3)]
    fze = jbnd.zedge_velocity(*map(jnp.asarray, fvel), sim.cbcvel, *jb,
                              grid.dzc, grid.dzf, is_correc=False)
    alph2 = sim.alph2_t.numpy()
    ref = pds.fused_dsmag_level2(
        *map(jnp.asarray, fvel), *fze, [jnp.asarray(q) for q in fm],
        [jnp.asarray(q) for q in lij], jnp.asarray(s0), alph2, grid.dzci,
        grid.dzfi, dli[0], dli[1], avg, interpret=True)
    t = torch.tensor
    tfvel = [t(q) for q in fvel]
    tze = sim._zedge_vel(*tfvel, sim.bcu_vals, sim.bcv_vals, sim.bcw_vals,
                         is_correc=False)
    got = K.dsmag_level2_plain(*tfvel, *tze, [t(q) for q in fm],
                               [t(q) for q in lij], t(s0), sim.alph2_t,
                               sim.dzci_t, sim.dzfi_t, dli[0], dli[1],
                               avg=avg)
    if avg == 'cavity':
        assert float(got.min()) >= 0.0 and float(got.max()) > 0.0
        _rel_close(got, ref)
        return
    numr, denr = (np.asarray(q) for q in ref)
    if avg == 'channel':        # per-(z, y tile) sums in (8, 128) tiles
        numr = numr[:, ::8, 0].sum(axis=1)[:, None]
        denr = denr[:, ::8, 0].sum(axis=1)[:, None]
    assert got[0].shape == numr.shape and numr.shape[0] == nz
    _rel_close(got[0], numr)
    _rel_close(got[1], denr)


@pytest.mark.parametrize('case', ['duct_blow', 'cavity'])
def test_ywalled_twopass_stage_matches_jax(case, monkeypatch):
    """The port's _sgs_stage (two passes: the transpiring duct by the
    route rule, the cavity by CALES_DSMAG_TWOPASS=1) against the JAX
    package's two-pass _compute_dsmag_kernel on the port's state after one
    step (its post-correction fill and kept wall planes)."""
    monkeypatch.setenv('CALES_PALLAS_INTERPRET', '1')
    monkeypatch.setenv('CALES_DSMAG_TWOPASS', '1')
    kw = DUCT_BLOW if case == 'duct_blow' else CAVITY
    sim, st = _stepped(kw)
    assert sim.dsmag_twopass and sim.ywalled
    jcfg = JConfig(**kw, use_pallas=True)
    jsim = JaxSimulation(jcfg, j_make_grid(jcfg))
    assert jsim.use_pallas_dsmag and not jsim._dsmag_onepass
    J = lambda q: jnp.asarray(q.numpy())  # noqa: E731
    ref = jsim._compute_dsmag_kernel(
        *map(J, (st.u, st.v, st.w, *st.zq)), vlo=tuple(map(J, st.vlo)))
    got = sim._sgs_stage(st.u, st.v, st.w, st.zq, st.vlo)
    assert float(got.min()) >= 0.0 and float(got.max()) > 0.0
    _rel_close(got, ref)
