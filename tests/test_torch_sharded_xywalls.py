"""x walls with y walls on a y-slab mesh (dims = (gy, 1)) on the CPU, on
gloo ranks of tests/_sharded_worker.py (the kernels' plain twins), against
the JAX package's single-device Simulation(use_pallas=False), f64, from the
seeded asymmetric start of tests/test_torch_sharded.py:

  * 2 steps at gy = 2 of the developing duct of
    tests/test_sharding_paths.py:707 (test_xywalled_kernel_sharded_matches_
    single: inflow u = 1, outflow, y and z walls; nx cut to 16) with
    sgstype 'none' and with static Smagorinsky, of the lid-driven cavity
    (walls on all six faces, u = 1 on the upper z face) and of the closed
    box; the cavity at gy = 4 too (slabs of 2 rows): u, v, w, nu_t within
    1e-11, p within 1e-11 after removing its mean, the CFL dt, divmax,
    bulk u (the reference's), the kernels named and the sharded checkpoint
    as tests/test_torch_sharded.py holds them, and the kept planes vlo[0]
    (u's lower x face, on the slabs' rows), vlo[1] (v's lower y face, rank
    0's) and vlo[2] (w's lower z face, its y ghost rows the owners');
  * the x stacks of each of two and four slabs (each made from the slab's
    own rows with the wall recipe on the sides it owns, the neighbours'
    rows -1 and nyl from their own slabs' stacks, as the exchange brings
    them: timeloop._xstacks_on_slab) joined equal the whole field's,
    corners and v's rewrite slot included, for the post-correction fill
    with kept planes and for the prediction fill, exactly;
  * the twins with these stacks on each of two slabs equal the whole
    field's twins cut to the slab, every output exactly: mom_rk (XW x
    Y_WALLS on the slab's y-row stacks, with nu_t), fillps and
    correc_updatep (on the slab's own x stacks), and smag with the y and x
    walls' van Driest inputs.
"""
import copy

import numpy as np
import pytest
import torch

from cales_torch.config import Config
from cales_torch.grid import make_grid_from_config
from cales_torch.ops import boundary as bnd
from cales_torch.ops import kernels as K
from cales_torch.timeloop import (Simulation, _xstack_halo_pairs,
                                  _xstacks_on_slab, unsupported)

from test_torch_sharded import _check_steps, _jax_steps, _perturbed, _spawn
from test_torch_sharded_imp import _bulk
from test_torch_sharded_les import _halo, _slab_of

torch.set_num_threads(1)

ALLD = (('D', 'D', 'D'),) * 3
# tests/test_sharding_paths.py:707's developing duct at nx = 16
DDUCT = dict(ng=(16, 8, 8), l=(2.0, 1.0, 1.0), gtype=1, gr=0.0,
             visci=2000.0, inivel='uni', is_wallturb=False, dtype='float64',
             sgstype='none', ptransform='mat',
             cbcvel=((('D', 'N', 'N'), ('D', 'D', 'D'), ('D', 'D', 'D')),
                     (('N', 'N', 'N'), ('D', 'D', 'D'), ('D', 'D', 'D'))),
             bcvel=(((1.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 0.0, 0.0)),)
             * 2,
             cbcpre=(('N', 'N', 'N'), ('D', 'N', 'N')),
             cbcsgs=(('N', 'D', 'D'), ('N', 'D', 'D')))
# the closed box and the lid-driven cavity (examples/closed_box,
# examples/lid_driven_cavity at 16 x 8 x 8)
BOX = dict(ng=(16, 8, 8), l=(1.0, 1.0, 1.0), gtype=1, gr=0.0, visci=1000.0,
           inivel='zer', is_wallturb=False, dtype='float64', sgstype='none',
           ptransform='mat', cbcvel=(ALLD, ALLD), cbcpre=(('N',) * 3,) * 2,
           cbcsgs=(('D',) * 3,) * 2)
CAVITY = dict(BOX, bcvel=(((0.0,) * 3,) * 3,
                          ((0.0,) * 3, (0.0,) * 3, (1.0, 0.0, 0.0))))
CASES = {'dduct': DDUCT,
         'dduct_smag': dict(DDUCT, sgstype='smag', visci=20_000.0),
         'cavity': CAVITY, 'box': BOX}
TOL = 1e-11


@pytest.fixture(scope='module')
def refs():
    return {key: (kw, _jax_steps(kw, 2)) for key, kw in CASES.items()}


def _run(tmp_path, gy, refs):
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
        for m in range(3):
            ref = np.asarray(jst.vlo[m])
            # u's lower x face over the interior y rows (its y ghost rows
            # no fill reads)
            ref = ref[:, 1:-1] if m == 0 else ref
            err = np.abs(out[f'{key}.vlo{m}'] - ref).max()
            assert err <= TOL, f'{key} vlo[{m}]: {err:.3e}'


def test_xywalled_classes_step_on_two_slabs(tmp_path, refs):
    _run(tmp_path, 2, refs)


def test_cavity_steps_on_four_slabs_of_two_rows(tmp_path, refs):
    _run(tmp_path, 4, {'cavity': refs['cavity']})


def _slab_vlo(vlo, y0, nyl):
    """A slab's rows of the kept planes (padded rows y0 .. y0 + nyl + 1 of
    the x and z faces'; v's y face whole)."""
    return (vlo[0][:, y0:y0 + nyl + 2].contiguous(), vlo[1],
            vlo[2][y0:y0 + nyl + 2].contiguous())


def _joined(sim, stacks_of, gy):
    """Each slab's x stack pairs (stacks_of(slab, own, y0, nyl) -> tuple of
    pairs on the slab's own rows), their rows -1 and nyl from the
    neighbours' own stacks as mesh.halo_y brings them (each neighbour's
    stack rows 0 .. nyl-1), joined by _xstacks_on_slab: {slab: pairs}."""
    ny = sim.cfg.ng[1]
    nyl = ny // gy
    own = [(r == 0, r == gy - 1) for r in range(gy)]
    mine = [stacks_of(r, own[r], r * nyl, nyl) for r in range(gy)]
    sent = [_xstack_halo_pairs(m, True) for m in mine]
    out = {}
    for r in range(gy):
        lo, hi = sent[(r - 1) % gy], sent[(r + 1) % gy]
        halos = [(torch.cat([a[0][:, -1:], b[0][:, :1]], dim=1),
                  torch.cat([a[1][:, -1:], b[1][:, :1]], dim=1))
                 for a, b in zip(lo, hi)]
        out[r] = _xstacks_on_slab(mine[r], halos, own[r])
    return out


@pytest.mark.parametrize('gy', [2, 4])
@pytest.mark.parametrize('fill', ['post-correction', 'prediction'])
def test_slab_xstacks_join_to_the_whole_fields(gy, fill):
    """The slabs' x stacks with the wall recipe on the owned sides and the
    neighbours' rows elsewhere are the whole field's columns, the (y
    ghost, x ghost) corners and v's y rewrite slot at padded y ny
    included: post-correction with random kept planes (u's x face, v's y
    face and w's z face), prediction with the static values; p's and
    nu_t's too."""
    cfg = Config(**dict(DDUCT, sgstype='smag'))
    sim = Simulation(cfg, make_grid_from_config(cfg), device='cpu')
    _, _, fields = _perturbed(DDUCT, seed=61, scale=0.05)
    u, v, w, p = (torch.as_tensor(f) for f in fields)
    nx, ny, nz = cfg.ng
    rng = np.random.default_rng(62)
    vlo = tuple(torch.as_tensor(1e-2 * rng.standard_normal(s)) for s in
                ((nz + 2, ny + 2), (nz + 2, nx + 2), (ny + 2, nx + 2)))
    s = torch.as_tensor(rng.uniform(0.0, 1e-3, (nz, ny, nx)))
    correc = fill == 'post-correction'

    def stacks(q, y0=0, nyl=ny, own=None, vl=vlo):
        """u, v, w, nu_t and p's x stack pairs of the rows y0 .. y0+nyl."""
        c = [_slab_of(a, y0, nyl) for a in q]
        vel = bnd.xedge_velocity(
            *c[:3], sim.cbcvel, sim.bcu_vals, sim.bcv_vals, sim.bcw_vals,
            cfg.dl, sim.grid.dzc, sim.grid.dzf, vlo=vl if correc else None,
            is_correc=correc, ywalls=True, yown=own)
        cbcs = tuple((cfg.cbcsgs[0][d], cfg.cbcsgs[1][d]) for d in range(3))
        return (*vel, bnd.xedge_scalar(c[3], cbcs, sim.bcs_vals, cfg.dl,
                                       sim.grid.dzc, True, own),
                bnd.xedge_scalar(c[4], sim.cbcpre, sim.bcp_vals, cfg.dl,
                                 sim.grid.dzc, True, own))
    whole = stacks((u, v, w, s, p))
    joined = _joined(sim, lambda r, own, y0, nyl: stacks(
        (u, v, w, s, p), y0, nyl, own, _slab_vlo(vlo, y0, nyl)), gy)
    nyl = ny // gy
    for r, pairs in joined.items():
        y0 = r * nyl
        for m, (a, b) in enumerate(zip(pairs, whole)):
            for x, y in zip(a, b):
                assert torch.equal(x, y[..., y0:y0 + nyl + 2]), (r, m)


def test_xywalled_twins_on_slabs_are_the_whole_fields_rows():
    """mom_rk (with nu_t), fillps, correc_updatep and smag on each of two
    slabs of the developing duct LES, with the slabs' y-row stacks
    (boundary.slab_ystack) and x stacks (_xstacks_on_slab on the post-
    correction fill; the slab's own stacks for the prediction fill and
    pp's), equal the whole field's twins on the slab's rows; the y and x
    walls' van Driest shear planes of a slab (made from its stacks) are
    the whole field's on the walls it owns and rows."""
    kw = CASES['dduct_smag']
    cfg = Config(**kw)
    sim = Simulation(cfg, make_grid_from_config(cfg), device='cpu')
    _, _, fields = _perturbed(kw, seed=71, scale=0.05)
    st = sim.initial_state(*fields)
    u, v, w, p = st.u, st.v, st.w, st.p
    rng = np.random.default_rng(72)
    nz, ny, nx = u.shape
    s = torch.as_tensor(rng.uniform(0.0, 1e-3, (nz, ny, nx)))
    pp = torch.as_tensor(rng.standard_normal((nz, ny, nx)))
    ru, rv, rw = (torch.as_tensor(rng.standard_normal((nz, ny, nx)))
                  for _ in range(3))
    # the post-correction fill with the state's kept planes
    vlo = st.vlo
    bcs = (sim.bcu_vals, sim.bcv_vals, sim.bcw_vals)
    ue, ve, we = sim._zedge_vel(u, v, w, *bcs, vlo=vlo, is_correc=True)
    pe, se, ppe = sim._zedge_p(p), sim._zedge_s(s), sim._zedge_p(pp)
    yq = sim._yedge_vel(u, v, w, bcs, vlo=vlo, is_correc=True)
    xq = sim._xedge_vel(u, v, w, bcs, vlo=vlo, is_correc=True)
    ys, yp, ypp = sim._yedge_s(s), sim._yedge_p(p), sim._yedge_p(pp)
    xs, xp, xpp = sim._xedge_s(s), sim._xedge_p(p), sim._xedge_p(pp)
    # the prediction fill's stacks (fillps, correc_updatep)
    ue2, ve2, we2 = sim._zedge_vel(u, v, w, sim.bcu_vals, sim.bcv_vals,
                                   sim.bcw_vals)
    yv2 = sim._yedge_vel(u, v, w)[1]
    xu2 = sim._xedge_vel(u, v, w)[0]
    coef = (sim.dzci_t, sim.dzfi_t, 0.3, -0.1, cfg.visc, cfg.dli[0],
            cfg.dli[1], cfg.bforce)
    mom = K.mom_rk_plain(u, v, w, s, p, ue, ve, we, se, pe, ru, rv, rw,
                         *coef, ye=(*yq, ys, yp), xe=(*xq, xs, xp))
    fil = K.fillps_plain(u, v, w, ue2, ve2, we2, sim.dzfi_t, 40.0,
                         cfg.dli[0], cfg.dli[1], yv=yv2, xu=xu2)
    cor = K.correc_updatep_plain(u, v, w, pp, p, we2, ppe, 0.025,
                                 cfg.dli[0], cfg.dli[1], sim.dzci_t,
                                 sim.dzfi_t, ypp=ypp, yv=yv2[0], xpp=xpp,
                                 xu=xu2)
    yplanes = sim._ywall_shear_planes(u, w, we, yq, xq)
    xplanes = sim._xwall_shear_planes(v, w, we, xq, vrow=yq[1][0][:, 0])
    tz = [torch.as_tensor(rng.uniform(0.0, 1.0, (ny, nx))) for _ in range(2)]
    sargs = (sim.dzci_t, sim.dzfi_t, cfg.dli[0], cfg.dli[1], cfg.visc,
             sim.csd2_t, sim.dw_t, sim.nearlo_t)
    smg = K.smag_plain(u, v, w, ue, ve, we, *sargs, *tz, ye=yq,
                       ywall=(sim.dwy_t, sim.nearylo_t, *yplanes), xe=xq,
                       xwall=(*sim.xwall_prof, *xplanes))
    gy = 2
    nyl = ny // gy

    def slab_sim(r):
        # rank r's slab: the walls it owns (the x and y recipes are made
        # on the slab's own rows)
        sl = copy.copy(sim)
        sl.yown = (r == 0, r == gy - 1)
        return sl

    def own_stacks(r, own, y0, nyl):
        c = lambda a: _slab_of(a, y0, nyl)  # noqa: E731
        sl = slab_sim(r)
        vel = sl._xedge_vel(c(u), c(v), c(w), bcs,
                            vlo=_slab_vlo(vlo, y0, nyl), is_correc=True)
        return (*vel, sl._xedge_s(c(s)), sl._xedge_p(c(p)))
    joined = _joined(sim, own_stacks, gy)
    for r in range(gy):
        y0, own = r * nyl, (r == 0, r == gy - 1)
        sl = slab_sim(r)
        c = lambda a: _slab_of(a, y0, nyl)  # noqa: E731
        q = [c(a) for a in (u, v, w, s, p, pp)]
        e = [c(a) for a in (ue, ve, we, se, pe, ppe, ue2, ve2, we2)]
        h = [_halo(a, b, y0, nyl, 1) for a, b in
             zip((u, v, w, s, p, pp, v), (ue, ve, we, se, pe, ppe, ve2))]
        # the slab's own fills' y-row stacks, joined with the halo rows
        walls = [sl._yedge_vel(*q[:3], vlo=_slab_vlo(vlo, y0, nyl),
                               is_correc=True)]
        yown = [bnd.slab_ystack(a, b, y, hh, own) for a, b, y, hh in zip(
            q[:5], e[:5], (*walls[0], sl._yedge_s(q[3]), sl._yedge_p(q[4])),
            h[:5])]
        ypred = bnd.slab_ystack(q[1], e[7], sl._yedge_vel(*q[:3])[1], h[6],
                                own)
        ypp_l = bnd.slab_ystack(q[5], e[5], sl._yedge_p(q[5]), h[5], own)
        xe = joined[r]
        got = K.mom_rk_plain(*q[:5], *e[:5], c(ru), c(rv), c(rw), *coef,
                             ye=yown, xe=xe)
        for m, (a, b) in enumerate(zip(got[:6], mom[:6])):
            assert torch.equal(a, c(b)), ('mom_rk', r, m)
        xu2_l = sl._xedge_vel(*q[:3])[0]
        assert torch.equal(K.fillps_plain(
            *q[:3], *e[6:9], sim.dzfi_t, 40.0, cfg.dli[0], cfg.dli[1],
            yv=ypred, xu=xu2_l), c(fil)), ('fillps', r)
        got = K.correc_updatep_plain(
            q[0], q[1], q[2], q[5], q[4], e[8], e[5], 0.025, cfg.dli[0],
            cfg.dli[1], sim.dzci_t, sim.dzfi_t, ypp=ypp_l, yv=ypred[0],
            xpp=sl._xedge_p(q[5]), xu=xu2_l)
        for a, b in zip(got, cor):
            assert torch.equal(a, c(b)), ('correc_updatep', r)
        # the van Driest planes: the y walls' on their owner (the others
        # take the other slab's through the mesh's all_reduce), the x
        # walls' on the slab's rows
        xw = sl._xwall_shear_planes(q[1], q[2], e[2], xe[:3],
                                    vrow=yown[1][0][:, 0])
        for a, b in zip(xw, xplanes):
            assert torch.equal(a, b[:, y0:y0 + nyl]), ('x planes', r)
        sl.mesh = None
        sl.yown = None
        yw = Simulation._ywall_shear_planes(sl, q[0], q[2], e[2],
                                            yown[:3], xe[:3])
        for side in range(2):
            if own[side]:
                assert torch.equal(yw[side], yplanes[side]), ('y planes', r)
        ys_l = (sim.dwy_t[y0:y0 + nyl].contiguous(),
                sim.nearylo_t[y0:y0 + nyl].contiguous(), *yplanes)
        got = K.smag_plain(*q[:3], *e[:3], *sargs,
                           *(t[y0:y0 + nyl] for t in tz), ye=yown[:3],
                           ywall=ys_l, xe=xe[:3],
                           xwall=(*sim.xwall_prof, *xw))
        assert torch.equal(got, c(smg)), ('smag', r)
