"""The wall-modelled channel LES (bench.py's wmles_channel class): the port's
wallmodel.py and the wall-model kernel's twin against cales_tpu/wallmodel.py
and the planes cales_tpu's Simulation makes from sampled rows, the slice
step for step against cales_tpu's Simulation(use_pallas=False), fp64.

Tolerances: tau_w 1e-13 relative (the same operations in the same order;
only the libraries' log differs); the planes 1e-13 of their maximum; the
slice as tests/test_torch_step.py holds its slices (u, v, w 1e-11; p 1e-10
after removing its mean; nu_t 1e-12, made by the projection kernel)."""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cales_tpu import wallmodel as jwm
from cales_tpu.config import Config as JaxConfig
from cales_tpu.grid import make_grid_from_config as jax_grid
from cales_tpu.initflow import initflow
from cales_tpu.nml import config_from_nml as jax_nml
from cales_tpu.timeloop import Simulation as JaxSimulation

from cales_torch import wallmodel as twm
from cales_torch.config import Config
from cales_torch.grid import make_grid_from_config
from cales_torch.nml import config_from_nml
from cales_torch.ops import kernels as K
from cales_torch.timeloop import Simulation, unsupported

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CHAN_BCS = dict(
    cbcvel=((('P', 'P', 'P'), ('P', 'P', 'P'), ('D', 'D', 'D')),) * 2,
    cbcpre=(('P', 'P', 'N'), ('P', 'P', 'N')),
    cbcsgs=(('P', 'P', 'D'), ('P', 'P', 'D')))
# bench.py _matrix_configs 'wmles_channel' at a test size
WMLES = dict(ng=(32, 16, 16), l=(2 * np.pi, np.pi, 2.0), gtype=1, gr=1.0,
             inivel='log', is_wallturb=True, is_forced=(True, False, False),
             velf=(1.0, 0.0, 0.0), dtype='float64', ptransform='mat',
             visci=125_000.0, sgstype='smag', lwm=((0, 0, 1), (0, 0, 1)),
             hwm=0.1, **CHAN_BCS)
TOL = {'u': 1e-11, 'v': 1e-11, 'w': 1e-11, 'p': 1e-10, 'visct': 1e-12}


def _tt(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


# ------------------------------------------------------------- tau_w

@pytest.mark.parametrize('mtype', [twm.WM_LOG, twm.WM_LAM])
def test_wallmodel_tauw_matches_jax(mtype):
    """Random wall-relative rows, some with u_par near 0 (the Newton
    start at its lower bound, the eps in the direction)."""
    rng = np.random.default_rng(31)
    uh, vh = 0.8 * rng.standard_normal((2, 24, 40))
    uh[0, :8] = 1e-14 * rng.standard_normal(8)
    vh[0, :8] = 0.0
    uh[1, :4] = vh[1, :4] = 0.0
    args = (0.1, 2.0, 1.0 / 125_000.0)
    ref = jwm.wallmodel_tauw(mtype, jnp.asarray(uh), jnp.asarray(vh), *args)
    got = twm.wallmodel_tauw(mtype, _tt(uh), _tt(vh), *args)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-13,
                                   atol=1e-13 * np.abs(r).max())
    assert np.abs(np.asarray(ref[0])).max() > 0


# --------------------------------------- the kernel's Newton iteration

H, L1D, VISC = 0.1, 2.0, 1.0 / 125_000.0    # bench.py's wmles_channel
# |u_par| bands of the sweep: 0; below the floor's scale (u_tau starts at
# its floor); the laminar start (Re_h = 1) up to Re_h = 1e6; past Re_h =
# 1e6, where 12 steps do not reach the root in float64
BANDS = ('zero', 'below the floor', 'Re_h 1 to 1e6', 'past Re_h 1e6')


def _sweep(rng):
    """(uh, vh, band of each lane): runs of neighbouring magnitudes of one
    band, then lanes drawn from every band, so the kernel's warps of 31
    points hold one band or mix them."""
    re = VISC / H
    mags = [np.zeros(31 * 4), np.logspace(-20, -6, 31 * 12),
            re * np.logspace(0, 6, 31 * 24), re * np.logspace(6, 7.5, 31 * 4)]
    band = np.concatenate([np.full(m.size, b) for b, m in enumerate(mags)])
    mag = np.concatenate(mags)
    mixed = rng.permutation(mag.size)[:31 * 12]     # 12 mixed warps
    mag, band = np.concatenate([mag, mag[mixed]]), np.concatenate(
        [band, band[mixed]])
    ang = rng.uniform(-np.pi, np.pi, mag.size)      # both signs of each
    return mag * np.cos(ang), mag * np.sin(ang), band


def _kernel_tauw(mtype, uh, vh, h, l1d, visc):
    """csrc/wallmodel.cu's arithmetic per thread, in torch on flat (uh, vh):
    the points in warps of 31 neighbours (the 32nd lane owns none and
    votes done), the rearranged Newton step, a lane done once |du_tau| <=
    4 eps u_tau (then frozen), a warp out of the loop when all its lanes
    are done, at most N_NEWTON steps (float32's fast logarithm and
    divisions on the card are not emulated: the card test holds them to
    the twin).  Returns tau_w's two components and the steps each point's
    warp ran."""
    eps = torch.finfo(uh.dtype).eps
    upar = torch.sqrt(uh * uh + vh * vh)
    n = upar.numel()
    nw = -(-n // 31)
    steps = torch.zeros(nw, dtype=torch.int64)
    if mtype == twm.WM_LAM:
        dl = 0.5 * l1d
        tot = 2.0 / dl * (upar / (h / dl * (2.0 - h / dl))) * visc
        return (tot * uh / (upar + eps), tot * vh / (upar + eps),
                steps.repeat_interleave(31)[:n])
    # (warp, lane): lane 31 and the lanes past the sweep only vote
    up = upar.new_zeros((nw, 32))
    up[:, :31] = torch.cat([upar, upar.new_zeros(nw * 31 - n)]).view(nw, 31)
    owner = torch.zeros((nw, 32), dtype=torch.bool)
    owner[:, :31] = (torch.arange(nw * 31) < n).view(nw, 31)
    up, owner = up.flatten(), owner.flatten()
    ikap, lhv = 1.0 / twm.KAP_LOG, float(np.log(h / visc))
    utau = torch.clamp_min(torch.sqrt(up / h * visc),
                           visc / h * twm.LOG_FLOOR)
    done = ~owner
    for _ in range(twm.N_NEWTON):
        going = ~done.view(nw, 32).all(1)
        if not going.any():
            break
        steps += going
        a = up / utau
        f = a - ikap * (torch.log(utau) + lhv) - twm.B_LOG
        nxt = torch.abs(utau * (1.0 + f / (a + ikap)))
        run = going.repeat_interleave(32) & ~done
        done = torch.where(run, (nxt - utau).abs() <= 4.0 * eps * nxt, done)
        utau = torch.where(run, nxt, utau)
    tot = (utau * utau).view(nw, 32)[:, :31].flatten()[:n]
    return (tot * uh / (upar + eps), tot * vh / (upar + eps),
            steps.repeat_interleave(31)[:n])


@pytest.mark.parametrize('mtype', [twm.WM_LOG, twm.WM_LAM])
@pytest.mark.parametrize('dtype', ['float64', 'float32'])
def test_kernel_newton_iteration_matches_tauw(dtype, mtype):
    """The wall-model kernel's iteration (the rearranged step, the warp's
    exit, the 12-step cap), emulated, against wallmodel_tauw's 12 fixed
    steps over the sweep: each band within 1e-13 (float64) or 1e-5
    (float32) of its own maximum; prints the steps the warps ran."""
    dt = getattr(torch, dtype)
    uh, vh, band = _sweep(np.random.default_rng(14))
    uh, vh = (torch.as_tensor(q).to(dt) for q in (uh, vh))
    got_u, got_v, steps = _kernel_tauw(mtype, uh, vh, H, L1D, VISC)
    ref_u, ref_v = twm.wallmodel_tauw(mtype, uh, vh, H, L1D, VISC)
    tol = 1e-13 if dt == torch.float64 else 1e-5
    for b, name in enumerate(BANDS):
        m = torch.as_tensor(band == b)
        for g, r in ((got_u, ref_u), (got_v, ref_v)):
            err = float((g[m] - r[m]).abs().max())
            assert np.isfinite(err) and err <= tol * float(r[m].abs().max()), \
                (name, err)
    warps = steps[::31].double()
    print(f'{dtype} mtype {mtype}: warps ran at most {int(warps.max())} '
          f'steps, {float(warps.mean()):.2f} on average')
    if mtype == twm.WM_LAM:
        assert int(warps.max()) == 0
        return
    # the cap binds past Re_h = 1e6 in float64; converged warps exit early
    if dt == torch.float64:
        assert int(steps[torch.as_tensor(band == 3)].max()) == twm.N_NEWTON
    assert 0 < float(warps.mean()) < twm.N_NEWTON


def test_newton_steps_counts_the_exit_test():
    """wallmodel.newton_steps: the kernel's exit test on the twin's
    iteration, per lane: 1 at u_par = 0 (the floor is the root), 12 past
    Re_h = 1e6, fewer in between, the same counts as the emulation's
    warps of one point within a step (the arithmetic rounds apart)."""
    re = VISC / H
    upar = torch.as_tensor(np.concatenate([[0.0], re * np.logspace(0, 5, 6),
                                           [re * 1e7]]))
    steps = twm.newton_steps(upar, H, VISC)
    assert steps.dtype == torch.int32
    assert int(steps[0]) == 1 and int(steps[-1]) == twm.N_NEWTON
    assert all(1 <= int(s) < twm.N_NEWTON for s in steps[1:-1])
    for q, s in zip(upar, steps):
        *_, ran = _kernel_tauw(twm.WM_LOG, q.view(1), q.new_zeros(1), H, L1D,
                               VISC)
        assert abs(int(ran[0]) - int(s)) <= 1


# ------------------------------------------------------ find_index_wm

@pytest.mark.parametrize('change', [
    dict(), dict(gtype=6, gr=0.0), dict(gtype=6, gr=2.0, ng=(32, 16, 48)),
    dict(lwm=((0, 0, 1), (0, 0, 0))), dict(lwm=((0, 0, 0), (0, 0, -1))),
    dict(hwm=0.05), dict(hwm=1.95),
    dict(lwm=((0, 1, 0), (0, 1, 0)), hwm=0.3),
    dict(lwm=((1, 0, 0), (1, 0, 0)), hwm=0.5),
    dict(lwm=((1, 0, 0), (1, 0, 0)), hwm=0.1)])
def test_find_index_wm_matches_jax(change):
    """The interpolation indices on gtype 1 and gtype 6 grids, and the same
    ValueError on an hwm outside the first..last cell-centre band."""
    kw = {**WMLES, **change}
    jcfg, tcfg = JaxConfig(**kw), Config(**kw)
    jgrid, tgrid = jax_grid(jcfg), make_grid_from_config(tcfg)
    try:
        ref = jwm.find_index_wm(jcfg, jgrid)
    except ValueError as e:
        with pytest.raises(ValueError, match='outside the first..last'):
            twm.find_index_wm(tcfg, tgrid)
        assert 'hwm=' in str(e)
        return
    assert twm.find_index_wm(tcfg, tgrid) == ref


# ------------------------------------------- the planes from sampled rows

@pytest.mark.parametrize('ib', [0, 1])
def test_z_wall_wm_planes_matches_jax(ib):
    """One face's planes from random padded rows and moving wall values,
    beside static planes that are not the wall values: the staggered
    ranges written, the rest kept (wallmodel.py:253-296)."""
    nx, ny, _ = WMLES['ng']
    kw = dict(WMLES, lwm=((0, 0, 1), (0, 0, -1)))
    jcfg, tcfg = JaxConfig(**kw), Config(**kw)
    jgrid, tgrid = jax_grid(jcfg), make_grid_from_config(tcfg)
    index = jwm.find_index_wm(jcfg, jgrid)
    rng = np.random.default_rng(17 + ib)
    rows = 0.5 * rng.standard_normal((4, ny + 2, nx + 2)) + 0.8
    mags = 0.05 * rng.standard_normal((4, ny + 2, nx + 2))
    ref = jwm.z_wall_wm_planes(jcfg, jgrid, *map(jnp.asarray, rows),
                               *map(jnp.asarray, mags), ib, index)
    got = twm.z_wall_wm_planes(tcfg, tgrid, *map(_tt, rows),
                               *map(_tt, mags), ib, index)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=1e-13 * np.abs(r).max())


FACES = {'both': ((0, 0, 1), (0, 0, 1)), 'lower': ((0, 0, 1), (0, 0, 0)),
         'upper laminar': ((0, 0, 0), (0, 0, -1))}


def _jax_corrected_planes(jsim, u, v, pp, dtrk, fu, fv):
    """cales_tpu Simulation._correc_smag_fused's wall-model planes from the
    host-corrected rows (timeloop.py:1318-1342), faces by index."""
    cfg = jsim.cfg
    dxi, dyi = cfg.dli[0], cfg.dli[1]
    out = {}
    for ib in range(2):
        if cfg.lwm[ib][2] == 0:
            continue
        k2 = jsim.index_wm[2][ib]
        k1 = k2 - 1 if ib == 0 else k2 + 1
        rows = {}
        for kp in (k1, k2):
            uq, vq, ppq = u[kp - 1], v[kp - 1], pp[kp - 1]
            uq = fu + uq - dtrk * dxi * (jnp.roll(ppq, -1, axis=1) - ppq)
            vq = fv + vq - dtrk * dyi * (jnp.roll(ppq, -1, axis=0) - ppq)
            rows[kp] = (jsim._row_pad_xy(uq, 0), jsim._row_pad_xy(vq, 1))
        umag = jnp.full((cfg.ng[1] + 2, cfg.ng[0] + 2),
                        float(cfg.bcvel[ib][2][0]))
        vmag = jnp.full_like(umag, float(cfg.bcvel[ib][2][1]))
        out[ib] = jwm.z_wall_wm_planes(
            cfg, jsim.grid, rows[k1][0], rows[k2][0], rows[k1][1],
            rows[k2][1], umag, vmag, umag, vmag, ib, jsim.index_wm)
    return out


@pytest.mark.parametrize('faces', sorted(FACES))
def test_wm_planes_plain_matches_jax(faces):
    """wm_planes_plain in its two modes against cales_tpu: the rows as
    they are (Simulation._wm_bcs_fast) and corrected by pp (the fused
    correction's planes); moving wall-parallel values on the modelled
    faces."""
    nx, ny, nz = WMLES['ng']
    bcvel = (((0.0,) * 3, (0.0,) * 3, (0.03, -0.02, 0.0)),
             ((0.0,) * 3, (0.0,) * 3, (-0.01, 0.04, 0.0)))
    kw = dict(WMLES, lwm=FACES[faces], bcvel=bcvel)
    jcfg = JaxConfig(**kw, use_pallas=False)
    jsim = JaxSimulation(jcfg, jax_grid(jcfg))
    tcfg = Config(**kw)
    tsim = Simulation(tcfg, make_grid_from_config(tcfg), device='cpu')
    assert tsim.index_wm == jsim.index_wm
    rng = np.random.default_rng(7)
    u, v, w, pp = 0.3 * rng.standard_normal((4, nz, ny, nx))
    u += 1.0
    fu, fv, dtrk = 0.013, -0.007, 2.3e-3
    J = {k: jnp.asarray(a) for k, a in dict(u=u, v=v, w=w, pp=pp).items()}
    T = {k: _tt(a) for k, a in dict(u=u, v=v, w=w, pp=pp).items()}
    fuv = _tt([fu, fv])
    cases = {
        'rows': (jsim._wm_bcs_fast(J['u'], J['v'], J['w']), {}),
        'corrected': (_jax_corrected_planes(jsim, J['u'], J['v'], J['pp'],
                                            dtrk, fu, fv),
                      dict(fuv=fuv, pp=T['pp'], dtrk=dtrk,
                           dxi=tcfg.dli[0], dyi=tcfg.dli[1]))}
    for mode, (ref, kw_) in cases.items():
        got = K.wm_planes(T['u'], T['v'], tsim.wm, **kw_)
        assert len(got) == len(tsim.wm.faces)
        assert all(q.shape == (2, ny + 2, nx + 2) for q in got)
        for n, face in enumerate(tsim.wm.faces):
            if mode == 'corrected':
                r = ref[face.ib]
            else:
                r = (ref[0][2][face.ib], ref[1][2][face.ib])
            for c in range(2):
                rc = np.asarray(r[c])
                scale = np.abs(rc).max()
                assert scale > 0
                np.testing.assert_allclose(got[n][c].numpy(), rc, rtol=0,
                                           atol=1e-13 * scale,
                                           err_msg=f'{mode} face {face.ib}')


# ----------------------------------------------------------- the slice

def _compare(jst, tst):
    for name, tol in TOL.items():
        a = np.asarray(getattr(jst, name))
        b = getattr(tst, name).numpy()
        if name == 'p':
            a, b = a - a.mean(), b - b.mean()
        err = np.abs(a - b).max()
        assert err <= tol, f'{name}: {err:.3e} > {tol:.0e}'
    np.testing.assert_allclose(tst.vlo[2].numpy(), np.asarray(jst.vlo[2]),
                               rtol=0, atol=1e-11)


def _example(ng=(32, 16, 16)):
    nml = ROOT / 'examples' / 'turbulent_channel_wmles' / 'input.nml'
    return (jax_nml(nml, dtype='float64').replace(use_pallas=False, ng=ng),
            config_from_nml(nml, dtype='float64').replace(ng=ng))


SLICE = {'bench mat': dict(WMLES), 'bench fft': dict(WMLES, ptransform='fft')}


@pytest.mark.parametrize('case', sorted(SLICE) + ['example gtype 6'])
def test_wmles_matches_jax_for_three_steps(case):
    """bench.py's wmles_channel at (32, 16, 16) by 'mat' and 'fft', and the
    example's gtype 6 grid: 3 steps against cales_tpu's XLA path; and for
    the bench class check() and padded_state() (the wall model's ghosts).
    tests/test_torch_step.py runs the variants (one face, the laminar
    model, sgstype 'none')."""
    if case == 'example gtype 6':
        jcfg, tcfg = _example()
    else:
        jcfg = JaxConfig(**SLICE[case], use_pallas=False)
        tcfg = Config(**SLICE[case])
    assert unsupported(tcfg) == []
    jgrid = jax_grid(jcfg)
    jsim = JaxSimulation(jcfg, jgrid)
    tsim = Simulation(tcfg, make_grid_from_config(tcfg), device='cpu')
    fields = initflow(jcfg, jgrid)
    jst, tst = jsim.initial_state(*fields), tsim.initial_state(*fields)
    _compare(jst, tst)
    dt = jsim.pick_dt(jsim.check(jst)[0])
    for _ in range(3):
        jst, jd = jsim.step(jst, dt)
        tst, td = tsim.step(tst, dt)
        _compare(jst, tst)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0,
                                   atol=1e-11)
    names = tsim.kernel_names()
    assert 'wallmodel' in names
    assert ('correc_smag' in names) == (tcfg.sgstype == 'smag')
    if tcfg.sgstype == 'smag':
        assert float(tst.visct.min()) >= 0 and float(tst.visct.max()) > 0
        assert "'E' z-ghost recipe" in tsim.exec_path()
    if case == 'bench mat':
        for a, b in zip(tsim.check(tst), jsim.check(jst)):
            assert abs(a - b) <= 1e-12 * max(1.0, abs(b))
        tols = {'up': 1e-11, 'vp': 1e-11, 'wp': 1e-11, 'ppad': 1e-10,
                'sppad': 1e-12}
        for (name, tol), a, b in zip(tols.items(), tsim.padded_state(tst),
                                     jsim.padded_state(jst)):
            if name == 'ppad':
                a, b = a - a.mean(), b - b.mean()
            np.testing.assert_allclose(a, b, rtol=0, atol=tol,
                                       err_msg=name)


def test_prediction_fill_uv_ghosts_are_not_read():
    """Why the port runs no wall model on the prediction fill: fillps and
    correc_smag give the same outputs whatever the prediction fill's u and
    v z ghost rows (edge rows 0 and 2) hold (correc_updatep takes no u or
    v edge stack).  tests/test_torch_cuda.py holds the kernels to the
    same."""
    nx, ny, nz = 16, 8, 6
    rng = np.random.default_rng(3)
    F = lambda: _tt(0.1 * rng.standard_normal((nz, ny, nx)))  # noqa: E731
    E = lambda: _tt(0.1 * rng.standard_normal((3, ny, nx)))   # noqa: E731
    u, v, w, pp, p = F(), F(), F(), F(), F()
    ue, ve, we, ppe = E(), E(), E(), E()
    junk = lambda e: torch.stack([e[0] + 5.0, e[1], e[2] - 3.0])  # noqa: E731
    ue2, ve2 = junk(ue), junk(ve)
    one = torch.ones(nz + 2, dtype=torch.float64)
    prof = torch.linspace(0.1, 0.5, nz, dtype=torch.float64)
    fuv = _tt([0.02, -0.01])
    zrec = (('E', 0.4, 0.0, 'N', 0.1, 0.2), ('E', 0.3, 0.0, 'D', 0.0, 0.2))
    t = _tt(np.abs(rng.standard_normal((2, ny, nx))))
    assert torch.equal(K.fillps(u, v, w, ue, ve, we, one, 3.0, 1.5, 2.0),
                       K.fillps(u, v, w, ue2, ve2, we, one, 3.0, 1.5, 2.0))
    for a, b in zip(
            K.correc_smag(u, v, w, pp, p, ue, ve, we, ppe, 1e-3, 1.5, 2.0,
                          one, one, 1e-4, prof, zrec, fuv, prof, prof, t[0],
                          t[1]),
            K.correc_smag(u, v, w, pp, p, ue2, ve2, we, ppe, 1e-3, 1.5, 2.0,
                          one, one, 1e-4, prof, zrec, fuv, prof, prof, t[0],
                          t[1])):
        assert torch.equal(a, b)


def test_example_namelists_of_the_wall_model():
    """turbulent_channel_wmles and turbulent_duct_wmles (a wall model on
    the y faces, static Smagorinsky with y walls) are in the slice; the
    duct with dynamic Smagorinsky or implicit diffusion is not."""
    ex = ROOT / 'examples'
    cfg = config_from_nml(ex / 'turbulent_channel_wmles' / 'input.nml')
    assert unsupported(cfg) == []
    duct = config_from_nml(ex / 'turbulent_duct_wmles' / 'input.nml')
    assert unsupported(duct) == []
    assert unsupported(duct.replace(lwm=((0, 0, 0), (0, 0, 0)))) == []
    assert any('wall model with dynamic Smagorinsky' in m for m in
               unsupported(duct.replace(sgstype='dsmag')))
    assert any('smag with y walls' in m for m in unsupported(
        duct.replace(impdiff=True, impdiff_1d=True)))
