"""x walls with the wall model, the passive scalar and plane-valued values
on a y-slab mesh (dims = (gy, 1)) on the CPU, on gloo ranks of
tests/_sharded_worker.py (the kernels' plain twins), against the JAX
package's single-device Simulation(use_pallas=False), f64, from the seeded
asymmetric start of tests/test_torch_sharded.py:

  * 2 steps at gy = 2 of the developing WMLES with its 1/7-power inflow
    profile (profile_step.power_law_inflow; the wall model on both z walls,
    static Smagorinsky, gtype 6: tests/test_torch_xwalls_les_step.py's
    'developing WMLES' at 16 x 8 x 8), of the developing channel with a
    passive scalar (tests/test_torch_scalar_walls_step.py's), of the x+y
    walled scalar of tests/test_sharding_paths.py:735 (test_xywalled_
    scalar_kernel_sharded_matches_single: the developing duct with a
    scalar, D on the inflow and y faces) and of the periodic smag channel
    with a moving lid plane varying along x
    (tests/test_torch_xwalls_les_step.py's 'lid plane, smag'): u, v, w,
    nu_t, s within 1e-11, p within 1e-11 after removing its mean, the
    checks, bulk u, the kernels named and the sharded checkpoint as
    tests/test_torch_sharded.py holds them, and the kept planes along the
    walled directions on the slabs' rows (vlo[1] rank 0's with y walls);
  * the wall model's planes of each of two slabs of the developing WMLES
    (its XW x YH mode: the sampled rows' halo rows take the x recipe at
    their own rows' offsets, the slab's rows of the inflow profile) equal
    the whole field's rows, exactly;
  * mom_rk's scalar twin with x walls on each of two slabs (the slab's
    halos, its x stacks with the neighbours' rows -1 and nyl, the
    scalar's too; explicit and '1d', with and without nu_t) equals the
    whole field's cut to the slab, every output exactly.
"""
import numpy as np
import pytest
import torch

from cales_torch import wallmodel as wmod
from cales_torch.config import Config
from cales_torch.grid import make_grid_from_config
from cales_torch.ops import kernels as K
from cales_torch.profile_step import power_law_inflow
from cales_torch.timeloop import (Simulation, _slab_planes, _xstacks_on_slab,
                                  unsupported)

from test_torch_sharded import _check_steps, _jax_steps, _perturbed, _spawn
from test_torch_sharded_imp import _bulk
from test_torch_sharded_les import _halo, _slab_of
from test_torch_sharded_xwalls import _xcut, _xhalo

torch.set_num_threads(1)

NG = (16, 8, 8)
XBCS = dict(cbcvel=((('D', 'N', 'N'), ('P', 'P', 'P'), ('D', 'D', 'D')),
                    (('N', 'N', 'N'), ('P', 'P', 'P'), ('D', 'D', 'D'))),
            bcvel=(((1.0, 0.0, 0.0), (0.0,) * 3, (0.0,) * 3),) * 2,
            cbcpre=(('N', 'P', 'N'), ('D', 'P', 'N')),
            cbcsgs=(('N', 'P', 'D'), ('N', 'P', 'D')))
XWM = dict(ng=NG, l=(6.4, 3.2, 2.0), gtype=6, gr=0.0, visci=50_000.0,
           inivel='uni', is_wallturb=False, dtype='float64', ptransform='mat',
           sgstype='smag', lwm=((0, 0, 1), (0, 0, 1)), hwm=0.1, **XBCS)
XWM['bcvel'] = power_law_inflow(Config(**XWM)).bcvel
XSC = dict(ng=NG, l=(2.0, 1.5, 1.0), gtype=1, gr=0.0, visci=5000.0,
           inivel='uni', is_wallturb=False, dtype='float64',
           ptransform='mat', sgstype='none', scalar=True, pr=0.71,
           iniscal='uni', ssource=0.02,
           cbcscal=(('D', 'P', 'N'), ('N', 'P', 'N')),
           bcscal=((1.0, 0.0, 0.0), (0.0, 0.0, 0.0)), **XBCS)
# tests/test_sharding_paths.py:735 at nx = 16
XYSC = dict(XSC, l=(2.0, 1.0, 1.0), visci=2000.0,
            cbcscal=(('D', 'D', 'N'), ('N', 'N', 'N')),
            bcscal=((1.0, 0.5, 0.0), (0.0, 0.0, 0.0)),
            cbcvel=((('D', 'N', 'N'), ('D', 'D', 'D'), ('D', 'D', 'D')),
                    (('N', 'N', 'N'), ('D', 'D', 'D'), ('D', 'D', 'D'))),
            cbcpre=(('N', 'N', 'N'), ('D', 'N', 'N')),
            cbcsgs=(('N', 'D', 'D'), ('N', 'D', 'D')))
# a padded (ny+2, nx+2) moving lid, sinusoidal in x
LID = 1.0 + 0.3 * np.sin(2 * np.pi * np.arange(NG[0] + 2) / NG[0])[None, :] \
    * np.ones((NG[1] + 2, 1))
CHAN = dict(ng=NG, l=(2 * np.pi, np.pi, 1.0), gtype=1, gr=0.0, visci=2000.0,
            inivel='uni', is_wallturb=False, dtype='float64', sgstype='smag',
            ptransform='mat',
            cbcvel=((('P', 'P', 'P'), ('P', 'P', 'P'), ('D', 'D', 'D')),) * 2,
            bcvel=(((0.0,) * 3,) * 3,
                   ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (LID, 0.0, 0.0))),
            cbcpre=(('P', 'P', 'N'), ('P', 'P', 'N')),
            cbcsgs=(('P', 'P', 'D'), ('P', 'P', 'D')))
CASES = {'xwm': XWM, 'xsc': XSC, 'xysc': XYSC, 'lid': CHAN}
TOL = 1e-11


def _json(kw):
    """kw for the worker's cases.json: plane-valued values as lists."""
    return {**kw, 'bcvel': [[[b.tolist() if hasattr(b, 'tolist') else b
                              for b in comps] for comps in face]
                            for face in kw['bcvel']]}


def test_xwalled_models_and_planes_step_on_two_slabs(tmp_path):
    gy = 2
    refs = {key: (kw, _jax_steps(kw, 2)) for key, kw in CASES.items()}
    cases, inputs = [], {}
    for key, (kw, (fields, dt, _, _)) in refs.items():
        assert unsupported(Config(**kw, dims=(gy, 1))) == [], key
        for q, f in zip('uvwp', fields):
            inputs[f'{key}.{q}'] = f
        inputs[f'{key}.dt'] = np.array(dt)
        cases.append({'kind': 'steps', 'key': key, 'ng': kw['ng'],
                      'cfg': {**_json(kw), 'dims': (gy, 1)}, 'nsteps': 2})
    out, work = _spawn(tmp_path, gy, cases, inputs)
    for key, (kw, (_, _, jst, jchk)) in refs.items():
        _check_steps(out, key, jst, jchk, kw, work, 2, bulk=_bulk(kw, jst))
        if kw.get('scalar'):
            err = np.abs(out[f'{key}.s'] - np.asarray(jst.s)).max()
            assert err <= TOL, f'{key} s: {err:.3e}'
        ywalled = kw['cbcvel'][0][1][1] != 'P'
        for m in range(3):
            if kw['cbcvel'][0][m][m] == 'P':
                continue        # a periodic direction's plane is never read
            ref, got = np.asarray(jst.vlo[m]), out[f'{key}.vlo{m}']
            if m == 0:
                ref = ref[:, 1:-1]
            if m == 2 and not ywalled:
                # w's lower face over the slabs' rows: its periodic y
                # ghost rows no fill reads
                ref, got = ref[1:-1], got[1:-1]
            err = np.abs(got - ref).max()
            assert err <= TOL, f'{key} vlo[{m}]: {err:.3e}'


def _whole_and_slabs(kw, gy, seed):
    cfg = Config(**kw)
    grid = make_grid_from_config(cfg)
    sim = Simulation(cfg, grid, device='cpu')
    _, _, fields = _perturbed(kw, seed=seed, scale=0.05)
    return cfg, grid, sim, [torch.as_tensor(f) for f in fields]


@pytest.mark.parametrize('gy', [2, 4])
def test_xwalled_wall_model_on_slabs_is_the_whole_fields(gy):
    cfg, grid, sim, (u, v, w, _) = _whole_and_slabs(XWM, gy, 81)
    wm = sim.wm
    assert all(f.xfills is not None for f in wm.faces)
    whole = wmod.wm_planes_plain(u, v, wm)
    rows = wmod.sampled_rows(u, v, wm)
    ny = cfg.ng[1]
    nyl = ny // gy
    bcs = (sim.bcu_vals, sim.bcv_vals, sim.bcw_vals)
    for r in range(gy):
        y0 = r * nyl
        # the slab's wall model: its rows of the inflow profile (their
        # periodic neighbours' too) in the sampled rows' x fills
        slab = wmod.wall_model(cfg, grid, sim.index_wm, tuple(
            _slab_planes(b, y0, nyl, ny) for b in bcs), sim.cbcvel)
        yh, _ = _halo(rows, rows[:3], y0, nyl, 1)
        q = [_slab_of(f, y0, nyl) for f in (u, v)]
        got = wmod.wm_planes_plain(*q, slab, yh=yh)
        assert all(torch.equal(a, b) for a, b in
                   zip(K.wm_planes(*q, slab, yh=yh), got))
        for a, b in zip(got, whole):
            # bcu over the slab's rows 1 .. nyl, bcv over 0 .. nyl (its
            # row 0 from the lower neighbour's rows), every column
            assert torch.equal(a[0, 1:nyl + 1], b[0, y0 + 1:y0 + nyl + 1])
            assert torch.equal(a[1, 0:nyl + 1], b[1, y0:y0 + nyl + 1])


@pytest.mark.parametrize('split', [None, '1d'])
def test_xwalled_scalar_twin_on_slabs_is_the_whole_fields_rows(split):
    kw = dict(XSC, sgstype='smag', visci=20_000.0)
    if split == '1d':
        kw.update(impdiff=True, impdiff_1d=True)
    cfg, _, sim, fields = _whole_and_slabs(kw, 2, 91)
    st = sim.initial_state(*fields)
    u, v, w, p = st.u, st.v, st.w, st.p
    rng = np.random.default_rng(92)
    nz, ny, nx = u.shape
    s = torch.as_tensor(rng.uniform(0.0, 1e-3, (nz, ny, nx)))
    sca = torch.as_tensor(rng.uniform(0.0, 1.0, (nz, ny, nx)))
    ru, rv, rw, rso = (torch.as_tensor(rng.standard_normal((nz, ny, nx)))
                       for _ in range(4))
    ue, ve, we = st.zq
    pe, se, sce = sim._zedge_p(p), sim._zedge_s(s), sim._zedge_scal(sca)
    xq = st.xq
    xs, xp, xsc = sim._xedge_s(s), sim._xedge_p(p), sim._xedge_scal(sca)
    coef = (sim.dzci_t, sim.dzfi_t, 0.3, -0.1, cfg.visc, cfg.dli[0],
            cfg.dli[1], cfg.bforce)
    for sgs in (True, False):
        scal = dict(sca=sca, scae=sce, rso=rso, scal=sim.scal_params)
        mom = K.mom_rk_plain(u, v, w, s if sgs else None, p, ue, ve, we,
                             se if sgs else None, pe, ru, rv, rw, *coef,
                             split=split,
                             xe=(*xq, xs if sgs else None, xp, xsc), **scal)
        gy = 2
        nyl = ny // gy
        for r in range(gy):
            y0 = r * nyl
            c = lambda a: _slab_of(a, y0, nyl)  # noqa: E731
            h = [_halo(a, b, y0, nyl, 1) for a, b in
                 zip((u, v, w, s, p, sca), (ue, ve, we, se, pe, sce))]
            whole_x = (*xq, xs if sgs else None, xp, xsc)
            xe = _xstacks_on_slab(tuple(_xcut(x, y0, nyl) for x in whole_x),
                                  _xhalo(whole_x, y0, nyl))
            got = K.mom_rk_plain(
                c(u), c(v), c(w), c(s) if sgs else None, c(p),
                *(c(e) for e in (ue, ve, we)), c(se) if sgs else None,
                c(pe), c(ru), c(rv), c(rw), *coef, split=split,
                yh=(*h[:3], h[3] if sgs else None, h[4], h[5]), xe=xe,
                sca=c(sca), scae=c(sce), rso=c(rso), scal=sim.scal_params)
            for m, (a, b) in enumerate(zip(got, mom)):
                if b is not None and m not in (6, 7):
                    assert torch.equal(a, c(b)), (split, sgs, r, m)
