"""The y-walled classes of cales_torch against cales_tpu, fp64 on the CPU:
the square duct and the spanwise-periodic lid-driven cavity (both y faces
and both z faces walls, x periodic), with dynamic Smagorinsky or none.

  * the y-row ghost stacks and their corners (ops/boundary.yedge_*) against
    the JAX package's, which hold the same rows in another order;
  * the y-walled plain twins of mom_rk, fillps and correc_updatep against
    the JAX Pallas kernels with their ye bundles, in interpret mode as
    tests/test_pallas_kernels.py runs them, at (nx, ny, nz) = (128, 16, 16);
  * the dsmag twin's 'duct' and 'cavity' averages against
    fused_dsmag_onepass (interpret mode) and against the port's own model
    sgs.dsmag_visct;
  * the Poisson solve with y-Neumann pressure against JAX's poisson.solve;
  * the duct (sgstype 'none' and 'dsmag') and the cavity stepped 3 steps by
    cales_torch against cales_tpu's Simulation(use_pallas=False), and a
    JAX duct state carried into the port;
  * what unsupported() still refuses with y walls.

Tolerances: the stacks copy values and apply the same two-term recipes,
1e-14; kernel twins against the Pallas kernels: u, v, w, p 1e-13, the
momentum RHS ru, rv, rw and the forcing sums 1e-12 (terms of size
dzci^2 ~ 1e3 cancel), the Poisson RHS 1e-13 relative to its maximum, |S|,
nu_t and the dynamic model's row sums 1e-12 relative to their maximum
(sums in another order); the steps: u, v, w and the kept wall planes
1e-11, p 1e-11 after removing its mean, nu_t 1e-11 relative to its
maximum."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cales_tpu.config import Config as JConfig
from cales_tpu.config import effective_cbcvel as j_effective_cbcvel
from cales_tpu.grid import make_grid_from_config as j_make_grid
from cales_tpu.initflow import initflow
from cales_tpu import poisson as jpoisson
from cales_tpu import sgs as jsgs
from cales_tpu.ops import boundary as jbnd
from cales_tpu.ops import pallas_dsmag as pds
from cales_tpu.ops import pallas_kernels as pk
from cales_tpu.timeloop import Simulation as JaxSimulation

from cales_torch import params
from cales_torch import poisson as tpoisson
from cales_torch import sgs as tsgs
from cales_torch.config import Config, effective_cbcvel
from cales_torch.grid import make_grid_from_config
from cales_torch.ops import boundary as tbnd
from cales_torch.ops import kernels as K
from cales_torch.timeloop import Simulation, unsupported

torch.set_num_threads(1)

DUCT_BCS = dict(
    cbcvel=((('P', 'P', 'P'), ('D', 'D', 'D'), ('D', 'D', 'D')),) * 2,
    cbcpre=(('P', 'N', 'N'),) * 2, cbcsgs=(('P', 'D', 'D'),) * 2)
# bench.py _matrix_configs 'duct_les_dsmag' and 'cavity_les_dsmag' at a
# test size
DUCT = dict(ng=(16, 12, 10), l=(4 * np.pi, 2.0, 2.0), gtype=1, gr=1.0,
            visci=10_000.0, inivel='duc', is_wallturb=True,
            is_forced=(True, False, False), velf=(1.0, 0.0, 0.0),
            sgstype='dsmag', dsmag_avg='duct', dtype='float64',
            ptransform='mat', **DUCT_BCS)
CAVITY = dict(ng=(16, 12, 10), l=(1.0, 1.0, 1.0), gtype=1, gr=0.0,
              visci=5_000.0, inivel='tgv', sgstype='dsmag',
              dsmag_avg='cavity', dtype='float64', ptransform='mat',
              bcvel=(((0.0,) * 3,) * 3,
                     ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))),
              **DUCT_BCS)
# y and z walls with moving wall-parallel values on some faces (normal
# components 0, as the dsmag kernel's class needs): (face, dir, comp)
MOVING = (((0.0,) * 3, (0.2, 0.0, -0.1), (0.0, 0.0, 0.0)),
          ((0.0,) * 3, (0.0, 0.0, 0.3), (0.4, -0.3, 0.0)))
# JAX's y-row order [0, ny+1, ny] -> the port's [0, ny, ny+1]
PERM = [0, 2, 1]


def _t(a):
    return torch.as_tensor(np.array(a))


def _n(a):
    return a.numpy() if torch.is_tensor(a) else np.asarray(a)


def _close(got, ref, atol):
    np.testing.assert_allclose(_n(got), np.asarray(ref), rtol=0, atol=atol)


def _rel_close(got, ref, rtol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(_n(got), ref, rtol=0,
                               atol=rtol * np.abs(ref).max())


def _by(bcvel, ivel):
    return tuple(tuple(bcvel[ib][d][ivel] for ib in range(2))
                 for d in range(3))


class _Fills:
    """Random interiors on a duct grid with each package's ghost inputs:
    JAX's z-edge stacks and packed ye bundles, and the same y rows in the
    port's order (rows, corners) pairs."""

    def __init__(self, ng, seed, bcvel=MOVING, bcpre=0.1):
        nx, ny, nz = ng
        self.cfg = JConfig(ng=ng, l=(2 * np.pi, 2.0, 2.0), gtype=1, gr=1.0,
                           visci=1000.0, dtype='float64', bcvel=bcvel,
                           bcpre=((0.0, bcpre, 0.0), (0.0, -bcpre, 0.0)),
                           **DUCT_BCS)
        self.grid = j_make_grid(self.cfg)
        self.cbc = j_effective_cbcvel(self.cfg)
        rng = np.random.default_rng(seed)
        self.F = lambda: 0.1 * rng.standard_normal((nz, ny, nx))  # noqa: E731
        self.bc = [jbnd.make_bc_values(ng, _by(bcvel, iv), np.float64)
                   for iv in range(3)]
        cfg = self.cfg
        self.bcp = tuple(tuple(cfg.bcpre[ib][d] for ib in range(2))
                         for d in range(3))
        self.cbcp = tuple((cfg.cbcpre[0][d], cfg.cbcpre[1][d])
                          for d in range(3))
        self.cbcs = tuple((cfg.cbcsgs[0][d], cfg.cbcsgs[1][d])
                          for d in range(3))
        # kept wall planes, periodic in x as a state carries them
        wrapx = lambda a: np.concatenate(  # noqa: E731
            [a[:, -1:], a, a[:, :1]], axis=1)
        self.vlo = (np.zeros((nz + 2, ny + 2)),
                    wrapx(1e-2 * rng.standard_normal((nz + 2, nx))),
                    wrapx(1e-2 * rng.standard_normal((ny + 2, nx))))

    def vel(self, u, v, w, is_correc):
        J = [jnp.asarray(q) for q in (u, v, w)]
        vlo = tuple(map(jnp.asarray, self.vlo)) if is_correc else None
        g = self.grid
        z = jbnd.zedge_velocity(*J, self.cbc, *self.bc, g.dzc, g.dzf,
                                vlo=vlo, is_correc=is_correc)
        y, zy = jbnd.yedge_velocity(*J, self.cbc, *self.bc, self.cfg.dl,
                                    g.dzc, g.dzf, vlo=vlo,
                                    is_correc=is_correc)
        return z, y, zy

    def scal(self, p, cbc, bcv):
        jp = jnp.asarray(p)
        z = jbnd.zedge_scalar(jp, cbc[2], bcv[2], self.grid.dzc)
        y, zy = jbnd.yedge_scalar(jp, cbc, bcv, self.cfg.dl, self.grid.dzc)
        return z, y, zy

    @staticmethod
    def pair(y, zy):
        """The port's (rows, corners) pair of one JAX stack."""
        return (_t(np.asarray(y)[:, PERM]).contiguous(),
                _t(np.asarray(zy)[:, PERM]).contiguous())

    @staticmethod
    def bundle(ys, zys):
        return JaxSimulation._pack_ybundle(None, list(ys), list(zys))


# ----------------------------------------------------------- the y rows

@pytest.mark.parametrize('fill', ['prediction', 'correc', 'correc_no_vlo'])
def test_yedge_stacks_match_jax(fill):
    """Rows and corners of u, v, w (with v's rewrite slot and the kept
    lower faces of v and w) and of two scalars, against the JAX package's
    stacks with the rows reordered."""
    f = _Fills((12, 10, 8), 1)
    cfg, grid = f.cfg, f.grid
    u, v, w, p = f.F(), f.F(), f.F(), f.F()
    is_correc = fill != 'prediction'
    vlo = f.vlo if fill == 'correc' else None
    jy, jzy = jbnd.yedge_velocity(
        *map(jnp.asarray, (u, v, w)), f.cbc, *f.bc, cfg.dl, grid.dzc,
        grid.dzf, vlo=None if vlo is None else tuple(map(jnp.asarray, vlo)),
        is_correc=is_correc)
    tb = [tbnd.make_bc_values(cfg.ng, _by(MOVING, iv), torch.float64)
          for iv in range(3)]
    ty, tzy = tbnd.yedge_velocity(
        *map(_t, (u, v, w)), effective_cbcvel(cfg), *tb, cfg.dl, grid.dzc,
        grid.dzf, vlo=None if vlo is None else tuple(map(_t, vlo)),
        is_correc=is_correc)
    for a, b in zip((*ty, *tzy), (*jy, *jzy)):
        _close(a, np.asarray(b)[:, PERM], 1e-14)
    for cbc, vals in ((f.cbcp, f.bcp), (f.cbcs, ((0.0, 0.0, 0.0),) * 3)):
        jp, jzp = jbnd.yedge_scalar(jnp.asarray(p), cbc, vals, cfg.dl,
                                    grid.dzc)
        tp, tzp = tbnd.yedge_scalar(
            _t(p), cbc, tbnd.make_bc_values(cfg.ng, vals, torch.float64),
            cfg.dl, grid.dzc)
        _close(tp, np.asarray(jp)[:, PERM], 1e-14)
        _close(tzp, np.asarray(jzp)[:, PERM], 1e-14)
    # the twins' y padding puts every row where pad_velocity does
    up, vp, wp, _ = tbnd.pad_velocity(
        *map(_t, (u, v, w)), effective_cbcvel(cfg), *tb, cfg.dl, grid.dzc,
        grid.dzf, vlo=None if vlo is None else tuple(map(_t, vlo)),
        is_correc=is_correc)
    ze = tbnd.zedge_velocity(
        *map(_t, (u, v, w)), effective_cbcvel(cfg), *tb, grid.dzc, grid.dzf,
        vlo=None if vlo is None else tuple(map(_t, vlo)),
        is_correc=is_correc)
    for q, e, y, z, ref in zip(map(_t, (u, v, w)), ze, ty, tzy,
                               (up, vp, wp)):
        _close(K.padded(q, e, (y, z)), ref, 1e-14)


# ---------------------------------------------- the kernel twins (Pallas)

NG = (128, 16, 16)


@pytest.mark.parametrize('sgs', [True, False])
def test_ywalled_mom_rk_twin_matches_pallas(sgs):
    """The post-correction fill's rows of u, v, w, visct and p (the kept
    lower faces of v and w), partial forcing sums along x."""
    f = _Fills(NG, 2)
    u, v, w, p = f.F(), f.F(), f.F(), f.F()
    s = np.abs(f.F()) if sgs else None
    ruo, rvo, rwo = f.F(), f.F(), f.F()
    (ue, ve, we), (yu, yv, yw), zy = f.vel(u, v, w, True)
    pe, yp, zyp = f.scal(p, f.cbcp, f.bcp)
    ys, zys = [yu, yv, yw], list(zy)
    se = None
    if sgs:
        se, ysg, zysg = f.scal(s, f.cbcs, ((0.0, 0.0, 0.0),) * 3)
        ys.append(ysg)
        zys.append(zysg)
    ys.append(yp)
    zys.append(zyp)
    ye, yze = f.bundle(ys, zys)
    cfg, grid = f.cfg, f.grid
    f1, f2, bforce = 0.5e-3, -0.2e-3, (0.1, 0.0, 0.02)
    J = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    ref = pk.fused_mom_rk(
        *map(J, (u, v, w, s, p, ue, ve, we, se, pe, ruo, rvo, rwo)),
        grid.dzci, grid.dzfi, f1, f2, cfg.visc, cfg.dli[0], cfg.dli[1],
        bforce, interpret=True, ye=ye, yze=yze, ywalls=(True, True),
        sum_flags=(True, False), has_sgs=sgs)
    T = lambda a: None if a is None else _t(a)  # noqa: E731
    pairs = [f.pair(y, z) for y, z in zip(ys, zys)]
    tye = (*pairs[:3], pairs[3] if sgs else None, pairs[-1])
    got = K.mom_rk_plain(
        *map(T, (u, v, w, s, p, ue, ve, we, se, pe, ruo, rvo, rwo)),
        _t(grid.dzci), _t(grid.dzfi), f1, f2, cfg.visc, cfg.dli[0],
        cfg.dli[1], bforce, sums=(True, False), ye=tye)
    for i in range(3):
        _close(got[i], ref[i], 1e-13)
    for i in range(3, 6):
        _close(got[i], ref[i], 1e-12)
    _close(got[6].sum(dim=1), np.asarray(ref[6])[:, ::8, 0].sum(axis=1),
           1e-12)


def test_ywalled_fillps_twin_matches_pallas():
    """The prediction fill: v's lower wall face and its rewrite row enter
    the divergence."""
    f = _Fills(NG, 3)
    u, v, w = f.F(), f.F(), f.F()
    (ue, ve, we), ys, zys = f.vel(u, v, w, False)
    ye, yze = f.bundle(ys, zys)
    cfg, grid = f.cfg, f.grid
    dti = 1.0 / 2.3e-3
    ref = pk.fused_fillps(*map(jnp.asarray, (u, v, w, ue, ve, we)),
                          grid.dzfi, dti, cfg.dli[0], cfg.dli[1],
                          interpret=True, ye=ye, yze=yze,
                          ywalls=(True, True))
    got = K.fillps_plain(*map(_t, (u, v, w, ue, ve, we)), _t(grid.dzfi), dti,
                         cfg.dli[0], cfg.dli[1], yv=f.pair(ys[1], zys[1]))
    _close(got, ref, 1e-13 * float(np.abs(np.asarray(ref)).max()))


def test_ywalled_correc_twin_matches_pallas():
    """pp's y rows and v's rewrite row (the wall face) in the correction,
    with the deferred forcing."""
    f = _Fills(NG, 4)
    u, v, w, pp, p = f.F(), f.F(), f.F(), f.F(), f.F()
    (_, _, we), ys, zys = f.vel(u, v, w, False)
    ppe, ypp, zypp = f.scal(pp, f.cbcp, f.bcp)
    ycor, yzcor = f.bundle([ys[2], ypp, ys[1]], [zys[2], zypp, zys[1]])
    cfg, grid = f.cfg, f.grid
    dtrk, fu, fv = 3.7e-3, 0.05, -0.02
    ref = pk.fused_correc_updatep(
        *map(jnp.asarray, (u, v, w, pp, p, we, ppe)), dtrk, cfg.dli[0],
        cfg.dli[1], grid.dzci, interpret=True, ye=ycor, yze=yzcor,
        ywalls=(True, True), fu=fu, fv=fv, dzfi=grid.dzfi)
    got = K.correc_updatep_plain(
        *map(_t, (u, v, w, pp, p, we, ppe)), dtrk, cfg.dli[0], cfg.dli[1],
        _t(grid.dzci), _t(grid.dzfi), _t([fu, fv]),
        ypp=f.pair(ypp, zypp), yv=f.pair(ys[1], zys[1])[0])
    for i in range(4):
        _close(got[i], ref[i], 1e-13)


def _alph2(nz):
    a = np.full(nz, 4.0)
    a[0] = a[-1] = 2.52
    return a


def _dsmag_inputs(ng, seed):
    """The post-correction fill of random interiors with moving
    wall-parallel values (zvals, yvals as the filtered fill's)."""
    f = _Fills(ng, seed)
    u, v, w = f.F(), f.F(), f.F()
    z, ys, zys = f.vel(u, v, w, True)
    zvals = (MOVING[0][2][0], MOVING[1][2][0], MOVING[0][2][1],
             MOVING[1][2][1])
    yvals = (MOVING[0][1][0], MOVING[1][1][0], MOVING[0][1][2],
             MOVING[1][1][2])
    return f, (u, v, w), z, ys, zys, zvals, yvals


@pytest.mark.parametrize('avg', ['duct', 'cavity'])
def test_dsmag_ywalled_twin_matches_pallas_onepass(avg):
    """fused_dsmag_onepass with its ye bundle (interpret mode): |S| and the
    per-(z, y) row sums for 'duct', nu_t for 'cavity'."""
    f, fields, z, ys, zys, zvals, yvals = _dsmag_inputs(NG, 5)
    ye, yze = f.bundle(ys, zys)
    grid, dli = f.grid, f.cfg.dli
    nz = NG[2]
    ref = pds.fused_dsmag_onepass(
        *map(jnp.asarray, (*fields, *z)), _alph2(nz), grid.dzci, grid.dzfi,
        dli[0], dli[1], True, True, avg, interpret=True, ye=ye, yze=yze,
        ywalls=(True, True), zvals=zvals, yvals=yvals)
    got = K.dsmag_plain(
        *map(_t, (*fields, *z)), _t(_alph2(nz)), _t(grid.dzci),
        _t(grid.dzfi), dli[0], dli[1], True, True, zvals,
        ye=[f.pair(y, zy) for y, zy in zip(ys, zys)], yvals=yvals, avg=avg)
    if avg == 'cavity':
        assert got[1] is None and float(got[0].min()) >= 0.0
        _rel_close(got[0], ref, 1e-12)
        return
    s0r, numr, denr = ref
    _rel_close(got[0], s0r, 1e-12)
    _rel_close(got[1], numr, 1e-12)
    _rel_close(got[2], denr, 1e-12)


@pytest.mark.parametrize('avg', ['duct', 'cavity', 'channel'])
def test_dsmag_ywalled_twin_matches_the_model(avg):
    """The twin's written-out recipes against sgs.dsmag_visct on the
    post-correction fill (with kept lower faces of v and w), nu_t by
    dsmag_avg; 'channel' with y walls is the duct example namelist's."""
    ng = (16, 12, 10)
    f, fields, z, ys, zys, zvals, yvals = _dsmag_inputs(ng, 6)
    tcfg = Config(ng=ng, l=f.cfg.l, gtype=1, gr=1.0, visci=1000.0,
                  dtype='float64', bcvel=MOVING, sgstype='dsmag',
                  dsmag_avg=avg, **DUCT_BCS)
    grid = make_grid_from_config(tcfg)
    cbc = effective_cbcvel(tcfg)
    tb = [tbnd.make_bc_values(ng, _by(MOVING, iv), torch.float64)
          for iv in range(3)]
    tp = tbnd.pad_velocity(*map(_t, fields), cbc, *tb, tcfg.dl, grid.dzc,
                           grid.dzf, vlo=tuple(map(_t, f.vlo)),
                           is_correc=True)

    def pad_filtered(uf, vf, wf):
        return tbnd.pad_velocity(uf, vf, wf, cbc, *tb, tcfg.dl, grid.dzc,
                                 grid.dzf)[:3]
    ref = tsgs.dsmag_visct(
        tsgs.SGSSetup(tcfg, grid, cbc), tcfg, grid, *tp[:3],
        tbnd.make_bc_values(ng, ((0.0,) * 2,) * 3, torch.float64),
        pad_filtered)
    s0, num, den = K.dsmag(
        *map(_t, (*fields, *z)), _t(_alph2(ng[2])), _t(grid.dzci),
        _t(grid.dzfi), tcfg.dli[0], tcfg.dli[1], True, True, zvals,
        ye=[f.pair(y, zy) for y, zy in zip(ys, zys)], yvals=yvals, avg=avg)
    if avg == 'cavity':
        got = s0
    elif avg == 'duct':
        got = torch.clamp_min(s0 * (num.sum(-1) / den.sum(-1))[:, :, None],
                              0.0)
    else:
        got = torch.clamp_min(s0 * (num.sum(1) / den.sum(1))[:, None, None],
                              0.0)
    assert float(got.max()) > 0
    _rel_close(got, ref, 1e-12)


def test_dsmag_visct_duct_and_cavity_match_jax():
    """The initial-nu_t path: sgs.dsmag_visct with 'duct' and 'cavity'
    against cales_tpu's."""
    ng = (16, 12, 10)
    f = _Fills(ng, 7)
    fields = (f.F(), f.F(), f.F())
    for avg in ('duct', 'cavity'):
        kw = dict(ng=ng, l=f.cfg.l, gtype=1, gr=1.0, visci=1000.0,
                  dtype='float64', bcvel=MOVING, sgstype='dsmag',
                  dsmag_avg=avg, **DUCT_BCS)
        jcfg, tcfg = JConfig(**kw), Config(**kw)
        jgrid, tgrid = j_make_grid(jcfg), make_grid_from_config(tcfg)
        jcbc, tcbc = j_effective_cbcvel(jcfg), effective_cbcvel(tcfg)
        jb = [jbnd.make_bc_values(ng, _by(MOVING, iv), np.float64)
              for iv in range(3)]
        tb = [tbnd.make_bc_values(ng, _by(MOVING, iv), torch.float64)
              for iv in range(3)]
        jp = jbnd.pad_velocity(*map(jnp.asarray, fields), jcbc, *jb,
                               jcfg.dl, jgrid.dzc, jgrid.dzf)
        tp = tbnd.pad_velocity(*map(_t, fields), tcbc, *tb, tcfg.dl,
                               tgrid.dzc, tgrid.dzf)
        zero = ((0.0,) * 2,) * 3
        ref = jsgs.dsmag_visct(
            jsgs.SGSSetup(jcfg, jgrid, jcbc), jcfg, jgrid, *jp[:3],
            jbnd.make_bc_values(ng, zero, np.float64), None,
            lambda a, b, c: jbnd.pad_velocity(a, b, c, jcbc, *jb, jcfg.dl,
                                              jgrid.dzc, jgrid.dzf)[:3])
        got = tsgs.dsmag_visct(
            tsgs.SGSSetup(tcfg, tgrid, tcbc), tcfg, tgrid, *tp[:3],
            tbnd.make_bc_values(ng, zero, torch.float64),
            lambda a, b, c: tbnd.pad_velocity(a, b, c, tcbc, *tb, tcfg.dl,
                                              tgrid.dzc, tgrid.dzf)[:3])
        assert float(got.max()) > 0
        _rel_close(got, ref, 1e-12)


# ------------------------------------------------------------- the solve

@pytest.mark.parametrize('ptransform', ['mat', 'auto'])
def test_ywalled_poisson_solve_matches_jax(ptransform):
    """y-Neumann pressure: the y operator is a DCT matrix; 'auto' takes the
    all-matrix route in the port (apply_y, z_eig), the mixed route (rfft
    along x) in the JAX package off a TPU: the same solution."""
    ng = (16, 12, 10)
    kw = dict(DUCT, ng=ng, ptransform=ptransform)
    jcfg, tcfg = JConfig(**kw), Config(**kw)
    jgrid, tgrid = j_make_grid(jcfg), make_grid_from_config(tcfg)
    cbc = tuple(tcfg.cbc_pre(d) for d in range(3))
    js = jpoisson.make_solver(jcfg, jgrid, cbc, ('c', 'c', 'c'))
    ts = tpoisson.make_solver(tcfg, tgrid, cbc, ('c', 'c', 'c'))
    assert ts.trx.kind == ts.try_.kind == 'mat'
    rhs = np.random.default_rng(8).standard_normal(ng[::-1])
    wz = tgrid.dzf[1:ng[2] + 1][:, None, None]
    rhs = rhs - (rhs * wz).sum() / (wz.sum() * ng[0] * ng[1])
    ref = np.asarray(jpoisson.solve(js, jnp.asarray(rhs)))
    got = _n(tpoisson.solve(ts, _t(rhs)))
    _close(got - got.mean(), ref - ref.mean(), 1e-12)


# -------------------------------------------------------- the slice, steps

STEP_CASES = {
    'duct_none': dict(DUCT, sgstype='none'),
    'duct_none_moving_walls': dict(DUCT, sgstype='none', bcvel=MOVING),
    'duct_dsmag': DUCT,
    'cavity_dsmag': CAVITY,
}


def _sims(kw):
    jcfg = JConfig(**kw, use_pallas=False)
    jgrid = j_make_grid(jcfg)
    tcfg = Config(**kw)
    return (JaxSimulation(jcfg, jgrid),
            Simulation(tcfg, make_grid_from_config(tcfg), device='cpu'),
            initflow(jcfg, jgrid))


def _compare(jst, tst):
    for name in ('u', 'v', 'w', 'p', 'visct'):
        a, b = np.asarray(getattr(jst, name)), getattr(tst, name).numpy()
        if name == 'p':
            a, b = a - a.mean(), b - b.mean()
        err = np.abs(a - b).max()
        if name == 'visct':
            err /= max(np.abs(a).max(), 1e-300)
        assert err <= 1e-11, f'{name}: {err:.3e}'
    # the kept wall planes: v's lower y face and w's lower z face
    for m in (1, 2):
        _close(tst.vlo[m], jst.vlo[m], 1e-11)


@pytest.mark.parametrize('case', sorted(STEP_CASES))
def test_ywalled_slice_matches_jax_for_three_steps(case):
    jsim, tsim, fields = _sims(STEP_CASES[case])
    assert unsupported(tsim.cfg) == []
    jst, tst = jsim.initial_state(*fields), tsim.initial_state(*fields)
    _compare(jst, tst)
    dt = jsim.pick_dt(jsim.check(jst)[0])
    for _ in range(3):
        jst, jd = jsim.step(jst, dt)
        tst, td = tsim.step(tst, dt)
        _compare(jst, tst)
        _close(td, jd, 1e-11)
    for a, b in zip(tsim.check(tst), jsim.check(jst)):
        assert abs(a - b) <= 1e-10 * max(1.0, abs(b))
    nu = tst.visct
    assert bool(torch.isfinite(nu).all()) and float(nu.min()) >= 0.0
    path = tsim.exec_path()
    assert 'y-walled variants' in path and 'apply_y' in path
    if STEP_CASES[case]['sgstype'] == 'dsmag':
        assert 'dsmag' in tsim.kernel_names()
        assert repr(STEP_CASES[case]['dsmag_avg']) in path


def test_duct_state_carried_across_from_jax():
    """A JAX duct state after 2 steps (its kept v and w wall planes
    included) steps on in the port to the same state."""
    jsim, tsim, fields = _sims(DUCT)
    jst = jsim.initial_state(*fields)
    dt = jsim.pick_dt(jsim.check(jst)[0])
    for _ in range(2):
        jst, _ = jsim.step(jst, dt)
    leaves = dict(u=jst.u, v=jst.v, w=jst.w, p=jst.p, visct=jst.visct,
                  vlo=jst.vlo, rhs_old=jst.rhs_old, zq=jst.zq,
                  time=jst.time, istep=jst.istep)
    tst = params.state_from_jax_numpy(
        jax.tree_util.tree_map(np.asarray, leaves), 'cpu', torch.float64)
    assert tuple(tst.vlo[1].shape) == (DUCT['ng'][2] + 2, DUCT['ng'][0] + 2)
    for _ in range(2):
        jst, _ = jsim.step(jst, dt)
        tst, _ = tsim.step(tst, dt)
    _compare(jst, tst)
    back = params.state_to_numpy(tst)
    np.testing.assert_array_equal(back['vlo'][1], tst.vlo[1].numpy())


# ------------------------------------------------------------ the gates

@pytest.mark.parametrize('change,missing', [
    (dict(cbcvel=((('D', 'D', 'D'), ('D', 'D', 'D'), ('D', 'D', 'D')),) * 2,
          cbcpre=(('N', 'N', 'N'),) * 2, cbcsgs=(('D', 'D', 'D'),) * 2,
          is_forced=(False, False, False)), 'non-periodic x'),
    (dict(sgstype='smag', impdiff=True, impdiff_1d=True),
     'smag with y walls'),
    (dict(lwm=((0, 1, 0), (0, 1, 0)), hwm=0.1), 'wall model'),
    (dict(impdiff=True, impdiff_1d=True), 'impdiff with y walls'),
    # the mixed route runs (test_torch_fft_ywalls.py); with x walls there
    # is no FFT along x
    (dict(cbcvel=((('D', 'D', 'D'), ('D', 'D', 'D'), ('D', 'D', 'D')),) * 2,
          cbcpre=(('N', 'N', 'N'),) * 2, cbcsgs=(('D', 'D', 'D'),) * 2,
          is_forced=(False, False, False), ptransform='fft'),
     "non-periodic x with ptransform 'fft'"),
    (dict(bcvel=(((0.0,) * 3, (0.0, 0.1, 0.0), (0.0,) * 3),
                 ((0.0,) * 3,) * 3)), 'non-zero v through a y wall'),
    (dict(cbcsgs=(('P', 'P', 'D'),) * 2), 'non-periodic y other than walls'),
])
def test_ywalled_configs_outside_the_slice_raise(change, missing):
    cfg = Config(**{**DUCT, **change})
    assert any(missing in m for m in unsupported(cfg)), unsupported(cfg)
    with pytest.raises(NotImplementedError, match='outside the ported slice'):
        Simulation(cfg, make_grid_from_config(cfg), device='cpu')


def test_duct_example_namelist_matches_jax():
    """examples/turbulent_duct_les/input.nml ('channel' averaging with y
    walls, ptransform 'auto'), at (32, 12, 10), 2 steps against
    cales_tpu's XLA path."""
    from pathlib import Path
    from cales_tpu.nml import config_from_nml as jax_nml
    from cales_torch.nml import config_from_nml
    nml = (Path(__file__).resolve().parents[1] / 'examples'
           / 'turbulent_duct_les' / 'input.nml')
    change = dict(ng=(32, 12, 10))
    jcfg = jax_nml(nml, dtype='float64').replace(use_pallas=False, **change)
    tcfg = config_from_nml(nml, dtype='float64').replace(**change)
    assert unsupported(tcfg) == [] and tcfg.dsmag_avg == 'channel'
    jgrid = j_make_grid(jcfg)
    fields = initflow(jcfg, jgrid)
    jsim = JaxSimulation(jcfg, jgrid)
    tsim = Simulation(tcfg, make_grid_from_config(tcfg), device='cpu')
    assert tsim.solver_p.trx.kind == 'mat'
    jst, tst = jsim.initial_state(*fields), tsim.initial_state(*fields)
    dt = jsim.pick_dt(jsim.check(jst)[0])
    for _ in range(2):
        jst, _ = jsim.step(jst, dt)
        tst, _ = tsim.step(tst, dt)
    _compare(jst, tst)


def test_ywalled_wrappers_take_the_twins_on_cpu():
    """On CPU tensors the wrappers return the twins' results and launch
    nothing."""
    f, fields, z, ys, zys, zvals, yvals = _dsmag_inputs((16, 12, 10), 9)
    grid, dli = f.grid, f.cfg.dli
    pairs = [f.pair(y, zy) for y, zy in zip(ys, zys)]
    K.reset_launches()
    args = (*map(_t, (*fields, *z)), _t(_alph2(10)), _t(grid.dzci),
            _t(grid.dzfi), dli[0], dli[1], True, True, zvals)
    for a, b in zip(K.dsmag(*args, ye=pairs, yvals=yvals, avg='duct'),
                    K.dsmag_plain(*args, ye=pairs, yvals=yvals, avg='duct')):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(
        K.fillps(*map(_t, (*fields, *z)), _t(grid.dzfi), 20.0, *dli[:2],
                 yv=pairs[1]),
        K.fillps_plain(*map(_t, (*fields, *z)), _t(grid.dzfi), 20.0,
                       *dli[:2], yv=pairs[1]), rtol=0, atol=0)
    assert all(n == 0 for n in K.LAUNCHES.values())
