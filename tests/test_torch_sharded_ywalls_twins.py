"""The y-walled slab of a y-slab mesh (dims = (gy, 1)) on the CPU:

  * 2 steps of the static-Smagorinsky duct at gy = 4 on gloo ranks of
    tests/_sharded_worker.py against the JAX package's single-device
    Simulation(use_pallas=False), f64 (as tests/test_torch_sharded_ywalls.py
    holds gy = 2): its middle slabs own no wall, and their van Driest
    damping reads the y walls' shear planes, which only ranks 0 and 3 make;
    divmax masked on the walls' cell rows (mask_divergence_check);
  * the plain twins on a slab's y-row stacks (boundary.slab_ystack: the
    wall recipe's rows built on the slab on the sides it owns, the halo
    rows cut from the whole field elsewhere) against the whole field's
    twin on its own stacks, cut to the slab, exactly, on the lower, the
    middle and the upper slabs at gy = 2 and 4, with moving y and z walls:
    mom_rk (with nu_t), fillps, correc_updatep, smag, dsmag in its slab
    mode with y walls ('duct', 'cavity', 'channel'), and add_rhs_bound's
    pressure planes with non-zero y values, which land on the owners'
    rows only (timeloop.slab_rhs_planes).
"""
import numpy as np
import pytest
import torch

from cales_torch import poisson
from cales_torch.config import Config
from cales_torch.grid import make_grid_from_config
from cales_torch.ops import boundary as bnd
from cales_torch.ops import kernels as K
from cales_torch.timeloop import Simulation, slab_rhs_planes

from test_torch_sharded import _jax_steps
from test_torch_sharded_les import _halo, _slab_of
from test_torch_sharded_ywalls import CASES, run_cases
from test_torch_ywalls import DUCT, MOVING

torch.set_num_threads(1)


def test_smag_duct_steps_on_four_slabs(tmp_path):
    # with the divergence check masked on the walls' cell rows, which on
    # the mesh are the first row of rank 0 and the last of rank 3
    kw = dict(CASES['duct_smag'], mask_divergence_check=True)
    run_cases(tmp_path, 4, {'duct_smag': (kw, _jax_steps(kw, 2))})


def _setup(avg='duct'):
    """A duct with moving y and z walls and random fields (seeded)."""
    kw = dict(DUCT, bcvel=MOVING, dsmag_avg=avg)
    cfg = Config(**kw)
    sim = Simulation(cfg, make_grid_from_config(cfg), device='cpu')
    rng = np.random.default_rng(21)
    nx, ny, nz = cfg.ng
    f = {q: torch.as_tensor(rng.standard_normal((nz, ny, nx)))
         for q in ('u', 'v', 'w', 'p', 'pp', 'ru', 'rv', 'rw')}
    f['s'] = torch.as_tensor(rng.uniform(0.0, 1e-3, (nz, ny, nx)))
    return cfg, sim, f


class Slab:
    """Slab r of gy of the whole-field inputs: its fields and z-edge
    stacks cut, the wall stacks of its own fill, the halos cut from the
    whole field and its y-row stacks (boundary.slab_ystack)."""

    def __init__(self, sim, gy, r):
        self.ny = sim.cfg.ng[1]
        self.nyl = self.ny // gy
        self.y0 = r * self.nyl
        self.own = (r == 0, r == gy - 1)

    def cut(self, a):
        return _slab_of(a, self.y0, self.nyl)

    def stacks(self, fields, edges, walls, depth=1):
        """(the slab's stack pairs, the halo pairs) of the whole-field
        fields with their edge stacks; walls(slab fields) -> the stack
        pairs of the slab's own fill."""
        q = [self.cut(a) for a in fields]
        e = [self.cut(a) for a in edges]
        h = [_halo(a, b, self.y0, self.nyl, depth)
             for a, b in zip(fields, edges)]
        ys = [bnd.slab_ystack(a, b, y, hh, self.own)
              for a, b, y, hh in zip(q, e, walls(q), h)]
        return ys, h


def _vel_edges(sim, u, v, w):
    return sim._zedge_vel(u, v, w, sim.bcu_vals, sim.bcv_vals,
                          sim.bcw_vals)


@pytest.mark.parametrize('gy', [2, 4])
def test_stencil_twins_on_walled_slabs_are_the_whole_fields_rows(gy):
    cfg, sim, f = _setup()
    u, v, w, p, s, pp = (f[q] for q in ('u', 'v', 'w', 'p', 's', 'pp'))
    ue, ve, we = _vel_edges(sim, u, v, w)
    pe, se, ppe = sim._zedge_p(p), sim._zedge_s(s), sim._zedge_p(pp)
    ye_g = (*sim._yedge_vel(u, v, w), sim._yedge_s(s), sim._yedge_p(p))
    dxi, dyi = cfg.dli[0], cfg.dli[1]
    coef = (sim.dzci_t, sim.dzfi_t, 0.3, -0.1, cfg.visc, dxi, dyi,
            cfg.bforce)
    mom = K.mom_rk_plain(u, v, w, s, p, ue, ve, we, se, pe, f['ru'], f['rv'],
                         f['rw'], *coef, ye=ye_g)
    fill = K.fillps_plain(u, v, w, ue, ve, we, sim.dzfi_t, 7.0, dxi, dyi,
                          yv=ye_g[1])
    ypp_g = sim._yedge_p(pp)
    cor = K.correc_updatep_plain(u, v, w, pp, p, we, ppe, 0.2, dxi, dyi,
                                 sim.dzci_t, sim.dzfi_t, ypp=ypp_g,
                                 yv=ye_g[1][0])
    # smag with the y walls' damping: the slab takes its rows of the
    # profiles and both walls' shear planes
    setup = sim.sgs_setup
    (dy_lo, _), (dy_hi, _) = setup.dw1d[2], setup.dw1d[3]
    dwy = torch.as_tensor(np.minimum(dy_lo, dy_hi))
    nearylo = torch.as_tensor((dy_lo <= dy_hi).astype(np.float64))
    planes = sim._ywall_shear_planes(u, w, we, ye_g[:3])
    tz = torch.full_like(u[0], 0.4), torch.full_like(u[0], 0.7)
    smag_args = (sim.dzci_t, sim.dzfi_t, dxi, dyi, cfg.visc, sim.csd2_t,
                 sim.dw_t, sim.nearlo_t)
    nut = K.smag_plain(u, v, w, ue, ve, we, *smag_args, *tz, ye=ye_g[:3],
                       ywall=(dwy, nearylo, *planes))

    for r in range(gy):
        sl = Slab(sim, gy, r)
        c = sl.cut

        def vel_walls(q):
            return sim._yedge_vel(*q)
        ys, _ = sl.stacks((u, v, w), (ue, ve, we), vel_walls)
        (ysc, ypc), _ = sl.stacks(
            (s, p), (se, pe), lambda q: (sim._yedge_s(q[0]),
                                         sim._yedge_p(q[1])))
        got = K.mom_rk_plain(*map(c, (u, v, w, s, p, ue, ve, we, se, pe,
                                      f['ru'], f['rv'], f['rw'])), *coef,
                             ye=(*ys, ysc, ypc))
        for a, b in zip(got[:6], mom[:6]):
            assert torch.equal(a, c(b))
        got = K.fillps_plain(*map(c, (u, v, w, ue, ve, we)), sim.dzfi_t,
                             7.0, dxi, dyi, yv=ys[1])
        assert torch.equal(got, c(fill))
        (ypp,), _ = sl.stacks((pp,), (ppe,),
                              lambda q: (sim._yedge_p(q[0]),))
        got = K.correc_updatep_plain(*map(c, (u, v, w, pp, p, we, ppe)), 0.2,
                                     dxi, dyi, sim.dzci_t, sim.dzfi_t,
                                     ypp=ypp, yv=ys[1][0])
        for a, b in zip(got, cor):
            assert torch.equal(a, c(b))
        ywall = (dwy[sl.y0:sl.y0 + sl.nyl], nearylo[sl.y0:sl.y0 + sl.nyl],
                 *planes)
        got = K.smag_plain(*map(c, (u, v, w, ue, ve, we)), *smag_args,
                           *(q[sl.y0:sl.y0 + sl.nyl] for q in tz), ye=ys,
                           ywall=ywall)
        assert torch.equal(got, c(nut))


@pytest.mark.parametrize('gy', [2, 4])
@pytest.mark.parametrize('avg', ['duct', 'cavity', 'channel'])
def test_dsmag_twin_on_walled_slabs_is_the_whole_fields_rows(gy, avg):
    cfg, sim, f = _setup(avg)
    u, v, w = (0.05 * f[q] for q in ('u', 'v', 'w'))
    # the post-correction fill, as the SGS stage takes it
    vlo = tuple(torch.zeros_like(q) for q in (
        torch.empty(cfg.ng[2] + 2, cfg.ng[1] + 2),
        torch.empty(cfg.ng[2] + 2, cfg.ng[0] + 2),
        torch.empty(cfg.ng[1] + 2, cfg.ng[0] + 2)))
    bcs = (sim.bcu_vals, sim.bcv_vals, sim.bcw_vals)
    edges = sim._zedge_vel(u, v, w, *bcs, vlo=vlo, is_correc=True)
    ye_g = sim._yedge_vel(u, v, w, bcs, vlo=vlo, is_correc=True)
    args = (sim.alph2_t, sim.dzci_t, sim.dzfi_t, cfg.dli[0], cfg.dli[1],
            True, True, sim.dsmag_zvals)
    kw = dict(yvals=sim.dsmag_yvals, avg=avg)
    whole = K.dsmag_plain(u, v, w, *edges, *args, ye=ye_g, **kw)
    sums = None
    for r in range(gy):
        sl = Slab(sim, gy, r)
        c = sl.cut
        nyl, y0 = sl.nyl, sl.y0

        def walls(q):
            # the slab's own post-correction fill: vlo's w plane its rows
            wv = vlo[:2] + (vlo[2][y0:y0 + nyl + 2],)
            return sim._yedge_vel(*q, bcs, vlo=wv, is_correc=True)
        ys, h = sl.stacks((u, v, w), edges, walls, depth=2)
        q = [c(a) for a in (u, v, w, *edges)]
        got = K.dsmag_plain(*q, *args, ye=ys, yh=h, yown=sl.own, **kw)
        # the wrapper takes the same inputs to its twin on the CPU
        same = K.dsmag(*q, *args, ye=ys, yh=h, yown=sl.own, **kw)
        assert all(a is b or torch.equal(a, b) for a, b in zip(got, same))
        assert torch.equal(got[0], c(whole[0]))
        if avg == 'duct':
            for a, b in zip(got[1:], whole[1:]):
                assert torch.equal(a, c(b))
        elif avg == 'channel':
            sums = got[1:] if sums is None else [
                a + b for a, b in zip(sums, got[1:])]
    if avg == 'channel':
        for a, b in zip(sums, whole[1:]):
            torch.testing.assert_close(a, b, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize('gy', [2, 4])
def test_rhs_planes_land_on_the_owners_rows(gy):
    """add_rhs_bound on the slab's grid with the owners' y planes (here
    non-zero Neumann values of the pressure on both y faces) is the whole
    field's add_rhs_bound cut to the slab."""
    cfg, sim, f = _setup()
    bcpre = ((0.0, 0.3, 0.0), (0.0, -0.2, 0.0))
    planes = poisson.rhs_bound_planes(
        cfg, sim.grid, sim.cbcpre, ('c', 'c', 'c'),
        tuple(tuple(bcpre[ib][d] for ib in range(2)) for d in range(3)))
    assert all(np.any(planes[('y', ib)] != 0.0) for ib in range(2))
    rhs = f['pp']
    whole = poisson.add_rhs_bound(cfg, ('c', 'c', 'c'), sim.cbcpre, rhs,
                                  planes)
    for r in range(gy):
        sl = Slab(sim, gy, r)
        local = cfg.replace(ng=(cfg.ng[0], sl.nyl, cfg.ng[2]))
        got = poisson.add_rhs_bound(local, ('c', 'c', 'c'), sim.cbcpre,
                                    sl.cut(rhs),
                                    slab_rhs_planes(planes, sl.own))
        assert torch.equal(got, sl.cut(whole))
