"""The x-walled classes' parts in cales_torch against cales_tpu, fp64 on
the CPU: the developing channel (inflow/outflow x, periodic y, z walls),
and with y walls the closed box, the lid-driven cavity and the developing
duct.

  * the x-ghost column stacks and their corners (ops/boundary.xedge_*),
    for the prediction fill and the corrector fill (the kept lower faces
    of u, v and w), with D and N letters and moving wall values, against
    the JAX package's xedge_* (the same columns in another order) and,
    with y walls, the columns' y ghosts against its x+y corner section
    (Simulation._xye_section); the twins' padding against pad_velocity;
  * the x-walled plain twins of mom_rk, fillps and correc_updatep
    against the JAX package's XLA stencils (ops/stencil) on pad_velocity
    fields (its own tests hold the Pallas kernels to that path,
    tests/test_pallas_kernels.py:374 and :429);
  * the Poisson solve with an ND (DCT-IV) and an NN (DCT-II) x operator
    against JAX's poisson.solve, p gauge-free;
  * what unsupported() admits and refuses with x walls.

Tolerances: the stacks copy values and apply the same two-term recipes,
1e-14; the twins: u, v, w, p 1e-13, the momentum RHS ru, rv, rw 1e-12
(terms of size dzci^2 cancel), the Poisson RHS 1e-13 of its maximum; the
solve 1e-12 after removing the mean."""
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cales_tpu.config import Config as JConfig
from cales_tpu.config import effective_cbcvel as j_effective_cbcvel
from cales_tpu.grid import make_grid_from_config as j_make_grid
from cales_tpu import poisson as jpoisson
from cales_tpu.ops import boundary as jbnd
from cales_tpu.ops import stencil as jst
from cales_tpu.timeloop import Simulation as JaxSimulation

from cales_torch import poisson as tpoisson
from cales_torch.config import Config, effective_cbcvel
from cales_torch.grid import make_grid_from_config
from cales_torch.ops import boundary as tbnd
from cales_torch.ops import kernels as K
from cales_torch.timeloop import Simulation, unsupported

torch.set_num_threads(1)

# inflow (u D) and outflow (N) x faces; the developing channel with
# periodic y, the developing duct with y walls
DEV_BCS = dict(
    cbcvel=((('D', 'N', 'N'), ('P', 'P', 'P'), ('D', 'D', 'D')),
            (('N', 'N', 'N'), ('P', 'P', 'P'), ('D', 'D', 'D'))),
    cbcpre=(('N', 'P', 'N'), ('D', 'P', 'N')),
    cbcsgs=(('N', 'P', 'D'), ('N', 'P', 'D')))
DDUCT_BCS = dict(
    cbcvel=((('D', 'N', 'N'), ('D', 'D', 'D'), ('D', 'D', 'D')),
            (('N', 'N', 'N'), ('D', 'D', 'D'), ('D', 'D', 'D'))),
    cbcpre=(('N', 'N', 'N'), ('D', 'N', 'N')),
    cbcsgs=(('N', 'D', 'D'), ('N', 'D', 'D')))
ALLD = (('D', 'D', 'D'),) * 3
BOX_BCS = dict(cbcvel=(ALLD, ALLD), cbcpre=(('N',) * 3,) * 2,
               cbcsgs=(('D',) * 3,) * 2)
# moving wall values on every face (x: the inflow's u, wall-parallel
# values elsewhere), normal components too where the face is 'N'
MOVING = (((1.0, 0.2, -0.1), (0.1, 0.0, 0.3), (0.2, -0.1, 0.0)),
          ((0.05, 0.1, 0.2), (0.3, 0.0, 0.1), (0.4, 0.2, 0.0)))
BCLASS = {'dev': DEV_BCS, 'dduct': DDUCT_BCS, 'box': BOX_BCS}
# JAX's column order [0, nx+1, nx] -> the port's [0, nx, nx+1]
PERM = [0, 2, 1]


def _t(a):
    return torch.as_tensor(np.array(a))


def _n(a):
    return a.numpy() if torch.is_tensor(a) else np.asarray(a)


def _close(got, ref, atol):
    np.testing.assert_allclose(_n(got), np.asarray(ref), rtol=0, atol=atol)


def _by(bcvel, ivel):
    return tuple(tuple(bcvel[ib][d][ivel] for ib in range(2))
                 for d in range(3))


class _Fills:
    """Random interiors of one class with each package's BC values and
    random kept lower faces (padded planes, as a state carries them)."""

    def __init__(self, kind, ng, seed, bcpre=0.0):
        nx, ny, nz = ng
        self.ywalls = kind != 'dev'
        self.cfg = JConfig(ng=ng, l=(2.0, 1.5, 1.0), gtype=1, gr=1.0,
                           visci=1000.0, dtype='float64', bcvel=MOVING,
                           bcpre=((bcpre, 0.0, 0.0), (-bcpre, 0.0, 0.0)),
                           **BCLASS[kind])
        self.grid = j_make_grid(self.cfg)
        self.cbc = j_effective_cbcvel(self.cfg)
        rng = np.random.default_rng(seed)
        self.F = lambda: 0.1 * rng.standard_normal((nz, ny, nx))  # noqa: E731
        self.jbc = [jbnd.make_bc_values(ng, _by(MOVING, iv), np.float64)
                    for iv in range(3)]
        self.tbc = [tbnd.make_bc_values(ng, _by(MOVING, iv), torch.float64)
                    for iv in range(3)]
        cfg = self.cfg
        self.cbcp = tuple((cfg.cbcpre[0][d], cfg.cbcpre[1][d])
                          for d in range(3))
        self.bcp = tuple(tuple(cfg.bcpre[ib][d] for ib in range(2))
                         for d in range(3))
        # kept lower faces; with periodic y their y ghosts wrap, as a state
        # carries them
        vlo = [1e-2 * rng.standard_normal(s)
               for s in ((nz + 2, ny + 2), (nz + 2, nx + 2), (ny + 2, nx + 2))]
        if not self.ywalls:
            vlo[0][:, 0], vlo[0][:, -1] = vlo[0][:, -2], vlo[0][:, 1]
            vlo[2][0], vlo[2][-1] = vlo[2][-2], vlo[2][1]
        self.vlo = tuple(vlo)

    def args(self):
        g = self.grid
        return self.cfg.dl, g.dzc, g.dzf

    def jvel(self, U, is_correc):
        """JAX's padded fields and x columns of U."""
        J = [jnp.asarray(q) for q in U]
        vlo = tuple(map(jnp.asarray, self.vlo)) if is_correc else None
        dl, dzc, dzf = self.args()
        pads = jbnd.pad_velocity(*J, self.cbc, *self.jbc, dl, dzc, dzf,
                                 vlo=vlo, is_correc=is_correc)[:3]
        cols = jbnd.xedge_velocity(*J, self.cbc, *self.jbc, dl, dzc, dzf,
                                   vlo=vlo, is_correc=is_correc)
        return pads, cols

    def tvel(self, U, is_correc):
        """The port's z-edge stacks, y-row stack pairs and x stack pairs."""
        T = [_t(q) for q in U]
        vlo = tuple(map(_t, self.vlo)) if is_correc else None
        dl, dzc, dzf = self.args()
        cbc = effective_cbcvel(self.cfg)
        ze = tbnd.zedge_velocity(*T, cbc, *self.tbc, dzc, dzf, vlo=vlo,
                                 is_correc=is_correc)
        ye = None
        if self.ywalls:
            rows, corners = tbnd.yedge_velocity(*T, cbc, *self.tbc, dl, dzc,
                                                dzf, vlo=vlo,
                                                is_correc=is_correc)
            ye = list(zip(rows, corners))
        xe = tbnd.xedge_velocity(*T, cbc, *self.tbc, dl, dzc, dzf, vlo=vlo,
                                 is_correc=is_correc, ywalls=self.ywalls)
        return T, ze, ye, xe

    def tscal(self, p):
        dl, dzc, _ = self.args()
        tb = tbnd.make_bc_values(self.cfg.ng, self.bcp, torch.float64)
        P = _t(p)
        ze = tbnd.zedge_scalar(P, self.cbcp[2], tb[2], dzc)
        ye = (tbnd.yedge_scalar(P, self.cbcp, tb, dl, dzc) if self.ywalls
              else None)
        return P, ze, ye, tbnd.xedge_scalar(P, self.cbcp, tb, dl, dzc,
                                            ywalls=self.ywalls)

    def jpad_p(self, p):
        dl, dzc, _ = self.args()
        return jbnd.pad_scalar(jnp.asarray(p), self.cbcp, self.bcp, dl, dzc)


# ------------------------------------------------------------ the stacks

@pytest.mark.parametrize('kind,fill', [
    ('dev', 'prediction'), ('dev', 'correc'), ('dduct', 'prediction'),
    ('dduct', 'correc'), ('box', 'correc')])
def test_xedge_stacks_match_jax(kind, fill):
    """Columns and corners of u, v, w (u's rewrite slot, the kept lower
    faces) and of the pressure against the JAX package's xedge_*; with y
    walls the columns' y ghosts against its x+y corner section; the
    twins' padding against pad_velocity and pad_scalar, every entry."""
    f = _Fills(kind, (12, 10, 8), 1, bcpre=0.1 if kind == 'dev' else 0.0)
    nx, ny, nz = f.cfg.ng
    is_correc = fill == 'correc'
    U = (f.F(), f.F(), f.F())
    p = f.F()
    (jpads, (jcols, jcorners)) = f.jvel(U, is_correc)
    T, ze, ye, xe = f.tvel(U, is_correc)
    yi = slice(1, -1) if f.ywalls else slice(None)
    for m, ((cols, corners), jc, jz) in enumerate(zip(xe, jcols, jcorners)):
        assert tuple(cols.shape) == (nz, 3, ny + 2 * f.ywalls)
        ref = (np.asarray(jc)[:, :, PERM].transpose(0, 2, 1),
               np.asarray(jz)[:, :, PERM].transpose(0, 2, 1))
        if f.ywalls and m == 1:
            # v's row ny-1 with y walls is the y rewrite slot (the corner
            # section's, below); the JAX stacks hold the interior row
            _close(cols[:, :, 1:ny], ref[0][..., :-1], 1e-14)
            _close(corners[:, :, 1:ny], ref[1][..., :-1], 1e-14)
            continue
        _close(cols[:, :, yi], ref[0], 1e-14)
        _close(corners[:, :, yi], ref[1], 1e-14)
    for iv, (q, e, y, x, ref) in enumerate(zip(T, ze, ye or (None,) * 3,
                                               xe, jpads)):
        # u's padded x nx is its rewrite slot in the prediction fill
        _close(K.padded(q, e, y, x=x, rewrite=iv == 0), ref, 1e-14)
    P, pe, pye, pxe = f.tscal(p)
    jxp, jzxp = jbnd.xedge_scalar(jnp.asarray(p), f.cbcp, f.bcp, f.cfg.dl,
                                  f.grid.dzc)
    _close(pxe[0][:, :, yi], np.asarray(jxp)[:, :, PERM].transpose(0, 2, 1),
           1e-14)
    _close(pxe[1][:, :, yi], np.asarray(jzxp)[:, :, PERM].transpose(0, 2, 1),
           1e-14)
    _close(K.padded(P, pe, pye, x=pxe), f.jpad_p(p), 1e-14)
    if not f.ywalls:
        return
    # the y ghosts of the lower and upper ghost columns: JAX's x+y corner
    # section, lanes 2m / 2m + 1 of field m, rows [y 0, y ny+1, y ny]
    sim = types.SimpleNamespace(cfg=f.cfg, grid=f.grid, cbcvel=f.cbc,
                                bcu_vals=f.jbc[0], bcv_vals=f.jbc[1],
                                bcw_vals=f.jbc[2], cbcpre=f.cbcp,
                                bcp_vals=f.bcp)
    stk = [np.asarray(c) for c in jcols]
    ent = JaxSimulation._xye_entries(sim, stk + [np.asarray(jxp)],
                                     with_p=True)
    rows, zrows = JaxSimulation._xye_section(
        sim, ent, vlo=tuple(map(jnp.asarray, f.vlo)) if is_correc else None,
        is_correc=is_correc)
    rows, zrows = np.asarray(rows), np.asarray(zrows)
    for m, (cols, corners) in enumerate((*xe, pxe)):
        for side, r in ((0, 0), (1, 2)):
            ref = rows[:, :, 2 * m + side][:, PERM]         # (nz, 3 y rows)
            got = cols[:, r][:, [0, ny, ny + 1]]
            _close(got, ref, 1e-14)
            zref = zrows[:, :, 2 * m + side][:, PERM]
            _close(corners[:, r][:, [0, ny, ny + 1]], zref, 1e-14)


# ---------------------------------------------- the twins (XLA stencils)

NG = (24, 10, 8)


@pytest.mark.parametrize('kind', ['dev', 'dduct'])
def test_xwalled_mom_rk_twin_matches_xla(kind):
    """The corrector fill's columns of u, v, w and p (the kept lower
    faces), the y rows with y walls, partial forcing sums along x."""
    f = _Fills(kind, NG, 2)
    U = (f.F(), f.F(), f.F())
    p, ruo, rvo, rwo = f.F(), f.F(), f.F(), f.F()
    (jup, jvp, jwp), _ = f.jvel(U, True)
    ppad = f.jpad_p(p)
    cfg, g = f.cfg, f.grid
    f1, f2, bforce = 0.5e-3, -0.2e-3, (0.1, 0.0, 0.02)
    dxi, dyi = cfg.dli[0], cfg.dli[1]
    (eu, exyu, ezu), (ev, exyv, ezv), (ew, exyw, ezw) = jst.momentum_rhs(
        jup, jvp, jwp, None, cfg.visc, dxi, dyi, g.dzci, g.dzfi,
        with_sgs=False)
    ru, rv, rw = eu + exyu + ezu, ev + exyv + ezv, ew + exyw + ezw
    nz = NG[2]
    dzci_c = jnp.asarray(g.dzci[1:nz + 1])[:, None, None]
    c = ppad[1:-1, 1:-1, 1:-1]
    un = U[0] + f1 * ru + (f1 + f2) * (bforce[0] - dxi * (ppad[1:-1, 1:-1, 2:]
                                                          - c)) + f2 * ruo
    vn = U[1] + f1 * rv + (f1 + f2) * (bforce[1] - dyi * (ppad[1:-1, 2:, 1:-1]
                                                          - c)) + f2 * rvo
    wn = U[2] + f1 * rw + (f1 + f2) * (bforce[2] - dzci_c * (ppad[2:, 1:-1,
                                                                  1:-1] - c)) \
        + f2 * rwo
    T, ze, ye, xe = f.tvel(U, True)
    P, pe, pye, pxe = f.tscal(p)
    got = K.mom_rk(*T, None, P, *ze, None, pe, *map(_t, (ruo, rvo, rwo)),
                   _t(g.dzci), _t(g.dzfi), f1, f2, cfg.visc, dxi, dyi,
                   bforce, sums=(True, False),
                   ye=None if ye is None else (*ye, None, pye),
                   xe=(*xe, None, pxe))
    for i, ref in enumerate((un, vn, wn)):
        _close(got[i], ref, 1e-13)
    for i, ref in enumerate((ru, rv, rw)):
        _close(got[3 + i], ref, 1e-12)
    _close(got[6][:, 0], np.asarray(un).sum(axis=(1, 2)), 1e-12)


@pytest.mark.parametrize('kind', ['dev', 'dduct'])
def test_xwalled_fillps_twin_matches_xla(kind):
    """The prediction fill: u's lower face and its rewrite column (and
    with y walls v's) enter the divergence."""
    f = _Fills(kind, NG, 3)
    U = (f.F(), f.F(), f.F())
    (jup, jvp, jwp), _ = f.jvel(U, False)
    cfg, g = f.cfg, f.grid
    dti = 1.0 / 2.3e-3
    ref = np.asarray(jst.fillps(jup, jvp, jwp, dti, cfg.dli[0], cfg.dli[1],
                                g.dzfi))
    T, ze, ye, xe = f.tvel(U, False)
    K.reset_launches()
    got = K.fillps(*T, *ze, _t(g.dzfi), dti, cfg.dli[0], cfg.dli[1],
                   yv=None if ye is None else ye[1], xu=xe[0])
    assert K.LAUNCHES['fillps'] == 0      # the twin serves the CPU
    _close(got, ref, 1e-13 * float(np.abs(ref).max()))


@pytest.mark.parametrize('kind', ['dev', 'dduct'])
def test_xwalled_correc_twin_matches_xla(kind):
    """pp's x columns and u's rewrite column (the outflow face) in the
    correction, p += pp; with y walls pp's y rows and v's wall face."""
    f = _Fills(kind, NG, 4)
    U = (f.F(), f.F(), f.F())
    pp, p = f.F(), f.F()
    (jup, jvp, jwp), _ = f.jvel(U, False)
    ppad = f.jpad_p(pp)
    cfg, g = f.cfg, f.grid
    dtrk = 3.7e-3
    ju, jv, jw, _ = jst.correc(jup, jvp, jwp, ppad, dtrk, cfg.dli[0],
                               cfg.dli[1], g.dzci)
    jpn = jst.updatep(ppad, jnp.asarray(p), 0.0, False, False, cfg.dli[0],
                      cfg.dli[1], g.dzci, g.dzfi)
    T, ze, ye, xe = f.tvel(U, False)
    PP, ppe, ypp, xpp = f.tscal(pp)
    ykw = {} if ye is None else dict(ypp=ypp, yv=ye[1][0])
    got = K.correc_updatep(*T, PP, _t(p), ze[2], ppe, dtrk, cfg.dli[0],
                           cfg.dli[1], _t(g.dzci), _t(g.dzfi), xpp=xpp,
                           xu=xe[0], **ykw)
    for a, b in zip(got, (ju, jv, jw, jpn)):
        _close(a, b, 1e-13)


# ------------------------------------------------------------- the solve

@pytest.mark.parametrize('kind', ['dev', 'box'])
def test_xwalled_poisson_solve_matches_jax(kind):
    """Pressure 'ND' along x (the outflow: a DCT-IV x operator, no
    singular mode) and 'NN' (the box: a DCT-II, the all-Neumann singular
    mode projected out): 'auto' takes the all-matrix route in the port
    (apply_y with the x operator fused, z_eig)."""
    ng = (16, 12, 10)
    kw = dict(ng=ng, l=(2.0, 1.5, 1.0), gtype=1, gr=1.0, visci=1000.0,
              dtype='float64', **BCLASS[kind])
    jcfg, tcfg = JConfig(**kw), Config(**kw)
    jgrid, tgrid = j_make_grid(jcfg), make_grid_from_config(tcfg)
    cbc = tuple(tcfg.cbc_pre(d) for d in range(3))
    js = jpoisson.make_solver(jcfg, jgrid, cbc, ('c', 'c', 'c'))
    ts = tpoisson.make_solver(tcfg, tgrid, cbc, ('c', 'c', 'c'))
    assert ts.trx.kind == ts.try_.kind == 'mat' and ts.trx.nsolve == ng[0]
    rhs = np.random.default_rng(8).standard_normal(ng[::-1])
    if kind == 'box':
        wz = tgrid.dzf[1:ng[2] + 1][:, None, None]
        rhs = rhs - (rhs * wz).sum() / (wz.sum() * ng[0] * ng[1])
    ref = np.asarray(jpoisson.solve(js, jnp.asarray(rhs)))
    got = _n(tpoisson.solve(ts, _t(rhs)))
    _close(got - got.mean(), ref - ref.mean(), 1e-12)
    if kind == 'dev':
        # no mode is singular: the eigen z stage zeroes nothing
        assert float(np.abs(np.asarray(ts.lamx)).min()) > 1e3 * \
            tpoisson._eig_tol(ts, ts.lamx)


# ------------------------------------------------------------ the gates

BOX = dict(ng=(16, 12, 10), l=(1.0, 1.0, 1.0), gtype=1, gr=0.0,
           visci=1000.0, inivel='zer', dtype='float64', sgstype='none',
           **BOX_BCS)
DEV = dict(BOX, l=(1.0, 1.5, 1.0), bcvel=(((1.0, 0.0, 0.0), (0.0,) * 3,
                                           (0.0,) * 3), ((0.0,) * 3,) * 3),
           **{**BOX_BCS, **DEV_BCS})


@pytest.mark.parametrize('base', ['dev', 'box'])
def test_xwalled_configs_in_the_slice(base):
    kw = DEV if base == 'dev' else BOX
    cfg = Config(**kw)
    assert unsupported(cfg) == []
    for mode in ('mat', 'auto'):
        sim = Simulation(cfg.replace(ptransform=mode),
                         make_grid_from_config(cfg), device='cpu')
        assert sim.xwalled and sim.solver_p.trx.kind == 'mat'
        path = sim.exec_path()
        assert 'x-ghost column stacks' in path
        assert ('x-y-walled' if base == 'box' else 'x-walled') in path


# the x-walled changes of each base: None where the slice runs it, else
# the ROADMAP item its refusal names (the developing channel DEV has
# periodic y, the box BOX y walls)
_BOTH = {'dsmag': 'x walls with dsmag',
         'full-3D implicit': 'x walls with full-3D implicit diffusion',
         'fft': "ptransform 'fft'", 'bulk forcing': 'bulk forcing'}
OUTCOMES = {
    'smag': {'dev': None, 'box': None},
    # the y-slab mesh runs x walls with periodic y and with y walls (the
    # box's case: an x-split pencil mesh, gx > 1)
    'mesh': {'dev': None, 'box': 'gx > 1'},
    'scalar': {'dev': None, 'box': None},
    'impdiff_1d': {'dev': None, 'box': 'impdiff with y walls'},
    'z-wall model': {'dev': None,
                     'box': 'x walls with a wall model and y walls'},
    'inflow profile': {'dev': None,
                       'box': 'plane-valued values with y walls'},
    **{k: {'dev': item, 'box': item} for k, item in _BOTH.items()},
}


def _change(name, base='dev'):
    if name == 'mesh':
        return dict(dims=(2, 1) if base == 'dev' else (2, 2))
    if name == 'inflow profile':
        # plane-valued BC values: a profile of u on the lower x face
        prof = np.ones((BOX['ng'][2] + 2, BOX['ng'][1] + 2))
        return dict(bcvel=(((prof, 0.0, 0.0), (0.0,) * 3, (0.0,) * 3),
                           ((0.0,) * 3,) * 3))
    return {'smag': dict(sgstype='smag'),
            'impdiff_1d': dict(impdiff=True, impdiff_1d=True),
            'z-wall model': dict(lwm=((0, 0, 1), (0, 0, 1)), hwm=0.1),
            'dsmag': dict(sgstype='dsmag', dsmag_avg='cavity'),
            'full-3D implicit': dict(impdiff=True),
            'scalar': dict(scalar=True),
            'fft': dict(ptransform='fft'),
            'bulk forcing': dict(is_forced=(True, False, False),
                                 velf=(1.0, 0.0, 0.0))}[name]


@pytest.mark.parametrize('change,base', [
    (c, b) for c in OUTCOMES for b in ('dev', 'box')])
def test_xwalled_configs_outside_the_slice_raise(change, base):
    """Each x-walled change either runs (the slice's: static Smagorinsky,
    a passive scalar, impdiff_1d, the z-wall model and an inflow profile,
    the last three with periodic y) or raises with a message that names
    its ROADMAP item."""
    item = OUTCOMES[change][base]
    cfg = Config(**{**(DEV if base == 'dev' else BOX),
                    **_change(change, base)})
    if item is None:
        assert unsupported(cfg) == []
        if cfg.dims[0] * cfg.dims[1] > 1:
            # a mesh's Simulation takes the mesh (its steps:
            # tests/test_torch_sharded_xwalls.py)
            with pytest.raises(ValueError, match='needs a device mesh'):
                Simulation(cfg, make_grid_from_config(cfg), device='cpu')
            return
        sim = Simulation(cfg, make_grid_from_config(cfg), device='cpu')
        assert sim.xwalled and 'x-ghost column stacks' in sim.exec_path()
        return
    msgs = unsupported(cfg)
    assert any(item in m and 'ROADMAP queue 1' in m for m in msgs), msgs
    with pytest.raises(NotImplementedError, match='outside the ported slice'):
        Simulation(cfg, make_grid_from_config(cfg), device='cpu')


def test_xwalled_periodic_z_raises():
    cfg = Config(**{**DEV, 'cbcvel': tuple(
        (c[0], c[1], ('P', 'P', 'P')) for c in DEV['cbcvel']),
        'cbcpre': tuple((c[0], c[1], 'P') for c in DEV['cbcpre']),
        'cbcsgs': tuple((c[0], c[1], 'P') for c in DEV['cbcsgs'])})
    assert any('non-periodic x with periodic z' in m
               for m in unsupported(cfg)), unsupported(cfg)
