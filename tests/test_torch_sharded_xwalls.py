"""x walls with periodic y on a y-slab mesh (dims = (gy, 1)) on the CPU, on
gloo ranks of tests/_sharded_worker.py (the kernels' plain twins), against
the JAX package's single-device Simulation(use_pallas=False), f64, from the
seeded asymmetric start of tests/test_torch_sharded.py:

  * 2 steps at gy = 2 of the developing channel of
    tests/test_sharding_paths.py:646 (test_xwalled_kernel_sharded_matches_
    single: inflow u = 1, outflow, periodic y, z walls; nx cut to 32),
    explicit and with impdiff_1d, sgstype 'none', and of its
    static-Smagorinsky LES with impdiff_1d (chip_smoke.py's XLES_IMP_CFG):
    u, v, w, nu_t within 1e-11, p within 1e-11 after removing its mean,
    the CFL dt, divmax, bulk u (the reference's), the kernels named and
    the sharded checkpoint as tests/test_torch_sharded.py holds them, and
    the kept planes vlo[0] (u's inflow face) and vlo[2] on the slabs' rows
    (their periodic y ghost rows, which no fill reads, stay out);
  * the twins with x stacks on each of two slabs equal the whole field's
    twins cut to the slab, every output exactly: mom_rk (explicit without
    nu_t, and with nu_t and the '1d' split) and smag on the slab's halos
    and its x stacks with the neighbours' rows -1 and nyl
    (timeloop._xstacks_on_slab, the rows the exchange brings), fillps and
    correc_updatep on the slab's halos and its own x stacks; the x walls'
    van Driest shear planes of a slab (v's row -1 from its halo) are the
    whole field's rows.
"""
import numpy as np
import pytest
import torch

from cales_torch.config import Config
from cales_torch.grid import make_grid_from_config
from cales_torch.ops import kernels as K
from cales_torch.timeloop import (Simulation, _xstack_halo_pairs,
                                  _xstacks_on_slab, unsupported)

from test_torch_sharded import _check_steps, _jax_steps, _perturbed, _spawn
from test_torch_sharded_imp import _bulk
from test_torch_sharded_les import _halo, _slab_of

torch.set_num_threads(1)

# tests/test_sharding_paths.py:646's developing channel at nx = 32
DEV = dict(ng=(32, 32, 16), l=(2.0, 1.5, 1.0), gtype=1, gr=0.0,
           visci=5000.0, inivel='uni', is_wallturb=False, dtype='float64',
           sgstype='none', ptransform='mat',
           cbcvel=((('D', 'N', 'N'), ('P', 'P', 'P'), ('D', 'D', 'D')),
                   (('N', 'N', 'N'), ('P', 'P', 'P'), ('D', 'D', 'D'))),
           bcvel=(((1.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 0.0, 0.0)),) * 2,
           cbcpre=(('N', 'P', 'N'), ('D', 'P', 'N')),
           cbcsgs=(('N', 'P', 'D'), ('N', 'P', 'D')))
IMP = dict(impdiff=True, impdiff_1d=True)
CASES = {'dev': DEV, 'dev_imp': dict(DEV, **IMP),
         'dev_les_imp': dict(DEV, sgstype='smag', visci=20_000.0, **IMP)}
TOL = 1e-11


@pytest.fixture(scope='module')
def refs():
    return {key: (kw, _jax_steps(kw, 2)) for key, kw in CASES.items()}


def test_developing_channel_steps_on_two_slabs(tmp_path, refs):
    gy = 2
    cases, inputs = [], {}
    for key, (kw, (fields, dt, _, _)) in refs.items():
        assert unsupported(Config(**kw, dims=(gy, 1))) == [], key
        for q, f in zip('uvwp', fields):
            inputs[f'{key}.{q}'] = f
        inputs[f'{key}.dt'] = np.array(dt)
        cases.append({'kind': 'steps', 'key': key, 'ng': kw['ng'],
                      'cfg': {**kw, 'dims': (gy, 1)}, 'nsteps': 2})
    out, work = _spawn(tmp_path, gy, cases, inputs)
    for key, (kw, (_, _, jst, jchk)) in refs.items():
        _check_steps(out, key, jst, jchk, kw, work, 2, bulk=_bulk(kw, jst))
        for m, got in ((0, out[f'{key}.vlo0']), (2, out[f'{key}.vlo2'])):
            ref = np.asarray(jst.vlo[m])
            ref = ref[:, 1:-1] if m == 0 else ref[1:-1]
            got = got if m == 0 else got[1:-1]
            err = np.abs(got - ref).max()
            assert err <= TOL, f'{key} vlo[{m}]: {err:.3e}'


def _xhalo(xs, y0, nyl):
    """The halo pairs that mesh.halo_y gives a slab for the transposed x
    stack pairs of _xstack_halo_pairs: the whole field's stacks' rows
    y0 - 1 and y0 + nyl (the neighbours' own stacks' rows)."""
    out = []
    for c, k in _xstack_halo_pairs(xs):
        ny = c.shape[1]
        rows = [(y0 - 1) % ny, (y0 + nyl) % ny]
        out.append((c[:, rows].contiguous(), k[:, rows].contiguous()))
    return out


def _xcut(x, y0, nyl):
    return None if x is None else tuple(
        a[..., y0:y0 + nyl].contiguous() for a in x)


@pytest.mark.parametrize('key', ['dev', 'dev_les_imp'])
def test_xwalled_twins_on_slabs_are_the_whole_fields_rows(key):
    kw = CASES[key]
    cfg = Config(**kw)
    sim = Simulation(cfg, make_grid_from_config(cfg), device='cpu')
    _, _, fields = _perturbed(kw, seed=51, scale=0.05)
    st = sim.initial_state(*fields)
    u, v, w, p = st.u, st.v, st.w, st.p
    rng = np.random.default_rng(52)
    nz, ny, nx = u.shape
    s = torch.as_tensor(rng.uniform(0.0, 1e-3, (nz, ny, nx)))
    pp = torch.as_tensor(rng.standard_normal((nz, ny, nx)))
    ru, rv, rw = (torch.as_tensor(rng.standard_normal((nz, ny, nx)))
                  for _ in range(3))
    ue, ve, we = st.zq
    pe, se, ppe = sim._zedge_p(p), sim._zedge_s(s), sim._zedge_p(pp)
    xq = st.xq
    xs, xp, xpp = sim._xedge_s(s), sim._xedge_p(p), sim._xedge_p(pp)
    # the prediction fill's stacks (fillps, correc_updatep)
    ue2, ve2, we2 = sim._zedge_vel(u, v, w, sim.bcu_vals, sim.bcv_vals,
                                   sim.bcw_vals)
    xu2 = sim._xedge_vel(u, v, w, fields=(0, 2))[0]
    coef = (sim.dzci_t, sim.dzfi_t, 0.3, -0.1, cfg.visc, cfg.dli[0],
            cfg.dli[1], cfg.bforce)
    sgs = sim.has_sgs
    split = sim.split
    mom = K.mom_rk_plain(u, v, w, s if sgs else None, p, ue, ve, we,
                         se if sgs else None, pe, ru, rv, rw, *coef,
                         split=split,
                         xe=(*xq, xs if sgs else None, xp))
    fil = K.fillps_plain(u, v, w, ue2, ve2, we2, sim.dzfi_t, 40.0,
                         cfg.dli[0], cfg.dli[1], xu=xu2)
    cor = K.correc_updatep_plain(u, v, w, pp, p, we2, ppe, 0.025,
                                 cfg.dli[0], cfg.dli[1], sim.dzci_t,
                                 sim.dzfi_t, alpha=-0.01,
                                 impdiff=cfg.impdiff,
                                 impdiff_1d=cfg.impdiff_1d, xpp=xpp, xu=xu2)
    xplanes = sim._xwall_shear_planes(v, w, we, xq)
    prof = sim.xwall_prof
    tz = [torch.as_tensor(rng.uniform(0.0, 1.0, (ny, nx))) for _ in range(2)]
    if sgs:
        smag_args = (sim.dzci_t, sim.dzfi_t, cfg.dli[0], cfg.dli[1],
                     cfg.visc, sim.csd2_t, sim.dw_t, sim.nearlo_t)
        smg = K.smag_plain(u, v, w, ue, ve, we, *smag_args, *tz,
                           xe=xq, xwall=(*prof, *xplanes))
    gy = 2
    nyl = ny // gy
    for r in range(gy):
        y0 = r * nyl
        c = lambda a: _slab_of(a, y0, nyl)  # noqa: E731
        q = [c(a) for a in (u, v, w, s, p, pp)]
        e = [c(a) for a in (ue, ve, we, se, pe, ppe, ue2, ve2, we2)]
        h = [_halo(a, b, y0, nyl, 1) for a, b in
             zip((u, v, w, s, p, pp, v), (ue, ve, we, se, pe, ppe, ve2))]
        # the slab's own x stacks, made from its rows (the carried
        # post-correction fill's cut: its kept inflow face is the
        # state's), and with the neighbours' rows
        xs_l, xp_l, xpp_l = (sim._xedge_s(q[3]), sim._xedge_p(q[4]),
                             sim._xedge_p(q[5]))
        xu2_l = sim._xedge_vel(*q[:3], fields=(0, 2))[0]
        for a, b in ((xs_l, xs), (xp_l, xp), (xpp_l, xpp), (xu2_l, xu2)):
            assert all(torch.equal(m, n) for m, n in
                       zip(a, _xcut(b, y0, nyl))), (key, r)
        xe_l = (*(_xcut(x, y0, nyl) for x in xq), xs_l if sgs else None,
                xp_l)
        xe_x = _xstacks_on_slab(xe_l, _xhalo((*xq, xs if sgs else None, xp),
                                             y0, nyl))
        got = K.mom_rk_plain(q[0], q[1], q[2], q[3] if sgs else None, q[4],
                             e[0], e[1], e[2], e[3] if sgs else None, e[4],
                             c(ru), c(rv), c(rw), *coef, split=split,
                             yh=(*h[:3], h[3] if sgs else None, h[4]),
                             xe=xe_x)
        for m, (a, b) in enumerate(zip(got, mom)):
            if b is not None and m < 6:
                assert torch.equal(a, c(b)), (key, 'mom_rk', r, m)
        assert torch.equal(K.fillps_plain(
            q[0], q[1], q[2], e[6], e[7], e[8], sim.dzfi_t, 40.0,
            cfg.dli[0], cfg.dli[1], yh=h[6], xu=xu2_l), c(fil)), (key, r)
        got = K.correc_updatep_plain(
            q[0], q[1], q[2], q[5], q[4], e[8], e[5], 0.025, cfg.dli[0],
            cfg.dli[1], sim.dzci_t, sim.dzfi_t, alpha=-0.01,
            impdiff=cfg.impdiff, impdiff_1d=cfg.impdiff_1d, yh=h[5],
            xpp=xpp_l, xu=xu2_l)
        for a, b in zip(got, cor):
            assert torch.equal(a, c(b)), (key, 'correc_updatep', r)
        if not sgs:
            continue
        # v's row -1 from its halo: the whole field's x walls' planes
        planes = sim._xwall_shear_planes(q[1], q[2], e[2], xe_x[:3],
                                         vrow=h[1][0][:, 0])
        for a, b in zip(planes, xplanes):
            assert torch.equal(a, b[:, y0:y0 + nyl]), (key, 'planes', r)
        got = K.smag_plain(q[0], q[1], q[2], e[0], e[1], e[2], *smag_args,
                           *(t[y0:y0 + nyl] for t in tz), yh=h[:3],
                           xe=xe_x[:3], xwall=(*prof, *planes))
        assert torch.equal(got, c(smg)), (key, 'smag', r)
        # the wrappers take the same inputs to the same outputs
        assert torch.equal(K.smag(q[0], q[1], q[2], e[0], e[1], e[2],
                                  *smag_args,
                                  *(t[y0:y0 + nyl] for t in tz), yh=h[:3],
                                  xe=xe_x[:3], xwall=(*prof, *planes)),
                           got)
