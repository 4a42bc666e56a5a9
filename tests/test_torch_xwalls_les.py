"""The x-walled LES's parts in cales_torch against cales_tpu, fp64 on the
CPU: static Smagorinsky with x walls (the developing channel with periodic
y, the closed box with y walls, the developing channel with the wall
model's 'E' z faces), mom_rk's x-walled twins with nu_t and with the '1d'
split, the x stacks with plane-valued values (an inflow profile on the
x face, the wall model's Neumann planes on the z faces), and the wall
model's x-walled sampling.

  * the port's SGS stage (Simulation._sgs_stage: the x stacks, the x
    walls' shear planes, the 'E' x stacks, kernels.smag's twin) on the
    post-correction fill's stacks against cales_tpu.sgs.smag_visct on
    pad_velocity's fields of the same interiors, BC values and kept
    planes (the running minimum over the six faces: the inflow face, whose
    u is 'D', is a van Driest wall);
  * mom_rk_plain with nu_t (its x stack by the SGS letters) and with the
    '1d' split against the JAX package's XLA stencil
    (ops/stencil.momentum_rhs(..., with_sgs=True)) on pad_velocity fields,
    as tests/test_torch_xwalls.py holds the variant without nu_t;
  * xedge_velocity with a plane-valued inflow profile and plane-valued z
    values against the JAX package's xedge_velocity (the same columns in
    another order), and the twins' padding against pad_velocity;
  * wallmodel.wm_planes_plain and kernels.wm_planes (its CPU twin) on the
    developing channel's z faces against cales_tpu's Simulation.
    _wm_bcs_fast (scalar values) and Simulation._dynamic_bcs (with the
    inflow profile, its full-pad route): every column of both planes,
    padded x 0, nx and nx+1 included.

Tolerances: nu_t 1e-12 of its maximum; the momentum update 1e-13, its RHS
1e-12; the stacks 1e-14 (copies and the same two-term recipes); the wall
model's planes 1e-13 of their maximum."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cales_tpu import sgs as jsgs
from cales_tpu.config import Config as JConfig
from cales_tpu.config import effective_cbcvel as j_effective_cbcvel
from cales_tpu.grid import make_grid_from_config as j_make_grid
from cales_tpu.ops import boundary as jbnd
from cales_tpu.ops import stencil as jst
from cales_tpu.timeloop import Simulation as JaxSimulation

from cales_torch import wallmodel as wmod
from cales_torch.config import Config
from cales_torch.grid import make_grid_from_config
from cales_torch.ops import boundary as tbnd
from cales_torch.ops import kernels as K
from cales_torch.timeloop import Simulation

torch.set_num_threads(1)

NG = (24, 10, 8)
# inflow (u D) and outflow (N) x faces, periodic y, z walls
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
# wall values: the inflow's u; wall-parallel values on the y and z faces
MOVING = (((1.0, 0.0, 0.0), (0.1, 0.0, 0.3), (0.2, -0.1, 0.0)),
          ((0.0, 0.0, 0.0), (0.3, 0.0, 0.1), (0.4, 0.2, 0.0)))
# JAX's column order [0, nx+1, nx] -> the port's [0, nx, nx+1]
PERM = [0, 2, 1]


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, ref, atol):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=atol)


def _by(bcvel, ivel):
    return tuple(tuple(bcvel[ib][d][ivel] for ib in range(2))
                 for d in range(3))


def _profile(ng, seed):
    """A padded (nz+2, ny+2) x-face plane that varies along z and y."""
    nx, ny, nz = ng
    rng = np.random.default_rng(seed)
    return 1.0 + 0.2 * rng.standard_normal((nz + 2, ny + 2))


def _zplane(ng, seed):
    """A padded (ny+2, nx+2) z-face plane (the wall model's, a lid's),
    its y ghost rows the periodic copies (as the wall model's v planes
    are: the sequential fill reads them at the (z ghost, y ghost) corners,
    where the port's stacks wrap)."""
    nx, ny, nz = ng
    rng = np.random.default_rng(seed)
    q = 0.3 * rng.standard_normal((ny + 2, nx + 2))
    q[0], q[-1] = q[-2], q[1]
    return q


def _fields(ng, seed, n=3):
    nx, ny, nz = ng
    rng = np.random.default_rng(seed)
    return [0.1 * rng.standard_normal((nz, ny, nx)) for _ in range(n)]


def _vlo(ng, seed, ywalls):
    """Random kept lower faces, their y ghosts wrapped with periodic y."""
    nx, ny, nz = ng
    rng = np.random.default_rng(seed)
    vlo = [1e-2 * rng.standard_normal(s)
           for s in ((nz + 2, ny + 2), (nz + 2, nx + 2), (ny + 2, nx + 2))]
    if not ywalls:
        vlo[0][:, 0], vlo[0][:, -1] = vlo[0][:, -2], vlo[0][:, 1]
        vlo[2][0], vlo[2][-1] = vlo[2][-2], vlo[2][1]
    return tuple(vlo)


# --------------------------------------------------- smag with x walls

def _smag_case(kind):
    kw = dict(ng=NG, l=(2.0, 1.5, 1.0), gtype=1, gr=1.0, visci=3000.0,
              dtype='float64', sgstype='smag', bcvel=MOVING,
              **{'dev': DEV_BCS, 'box': BOX_BCS, 'wm': DEV_BCS}[kind])
    if kind == 'wm':
        kw.update(lwm=((0, 0, 1), (0, 0, 1)), hwm=0.1, gtype=6, gr=0.0,
                  l=(6.4, 3.2, 2.0), bcvel=((MOVING[0][0],) + ((0.0,) * 3,)
                                            * 2, ((0.0,) * 3,) * 3))
    return kw


@pytest.mark.parametrize('kind', ['dev', 'box', 'wm'])
def test_xwalled_smag_stage_matches_smag_visct(kind):
    """nu_t of the post-correction fill: the port's x stacks, shear planes
    and (wm) 'E' stacks into smag's twin, against smag_visct on the
    padded fields.  wm: random Neumann planes of u and v on both z faces
    in place of the wall model's, extrapolated ('E') on those faces."""
    kw = _smag_case(kind)
    jcfg, tcfg = JConfig(**kw), Config(**kw)
    jgrid, tgrid = j_make_grid(jcfg), make_grid_from_config(tcfg)
    sim = Simulation(tcfg, tgrid, device='cpu')
    ywalls = kind == 'box'
    u, v, w = _fields(NG, 7)
    vlo = _vlo(NG, 8, ywalls)
    jbc = [list(list(q) for q in jbnd.make_bc_values(NG, _by(jcfg.bcvel, iv),
                                                     np.float64))
           for iv in range(3)]
    tbc = [list(list(q) for q in b) for b in (sim.bcu_vals, sim.bcv_vals,
                                              sim.bcw_vals)]
    if kind == 'wm':
        for iv in range(2):
            for ib in range(2):
                plane = _zplane(NG, 10 + 2 * iv + ib)
                jbc[iv][2][ib] = jnp.asarray(plane)
                tbc[iv][2][ib] = _t(plane)
    cbc = j_effective_cbcvel(jcfg)
    dl, dzc, dzf = jcfg.dl, jgrid.dzc, jgrid.dzf
    up, vp, wp, _ = jbnd.pad_velocity(
        *map(jnp.asarray, (u, v, w)), cbc, *jbc, dl, dzc, dzf,
        vlo=tuple(map(jnp.asarray, vlo)), is_correc=True)
    setup = jsgs.SGSSetup(jcfg, jgrid, cbc)
    ref = np.asarray(jsgs.smag_visct(setup, jcfg, jgrid, up, vp, wp))
    T = [_t(q) for q in (u, v, w)]
    bcs = tuple(tuple(tuple(q) for q in b) for b in tbc)
    tvlo = tuple(map(_t, vlo))
    zq = sim._zedge_vel(*T, *bcs, vlo=tvlo, is_correc=True)
    yq = (sim._yedge_vel(*T, bcs, vlo=tvlo, is_correc=True) if ywalls
          else None)
    xq = sim._xedge_vel(*T, bcs, vlo=tvlo, is_correc=True)
    assert sim.sgs_kernel == 'smag' and not sim.fused_smag
    assert sim.xwall_sides == ((0, 1) if kind == 'box' else (0,))
    got = sim._sgs_stage(*T, zq, tvlo, yq, xq)
    _close(got, ref, 1e-12 * float(np.abs(ref).max()))
    # the inflow face damps: where its shear vanishes (v, w 'N' there),
    # fd = 0 on the column nearest it, unless a z wall is nearer
    if kind != 'box':
        assert float(np.abs(ref).max()) > 0.0


# ------------------------------------------- mom_rk's x-walled twins

@pytest.mark.parametrize('kind,split', [('dev', None), ('box', None),
                                        ('dev', '1d'), ('dev', '1d none')])
def test_xwalled_mom_rk_twin_with_visct_and_split(kind, split):
    """The corrector fill's x stacks of u, v, w, p and nu_t (its letters
    the SGS ones), the '1d' split's Crank-Nicolson fold ('1d none':
    without nu_t), against the XLA stencil on pad_velocity fields."""
    kw = dict(ng=NG, l=(2.0, 1.5, 1.0), gtype=1, gr=1.0, visci=1000.0,
              dtype='float64', bcvel=MOVING,
              **(BOX_BCS if kind == 'box' else DEV_BCS))
    jcfg = JConfig(**kw)
    g = j_make_grid(jcfg)
    cbc = j_effective_cbcvel(jcfg)
    ywalls = kind == 'box'
    with_s = split != '1d none'
    u, v, w, p, s, ruo, rvo, rwo = _fields(NG, 3, 8)
    s = np.abs(s) * 1e-2
    vlo = _vlo(NG, 4, ywalls)
    jbc = [jbnd.make_bc_values(NG, _by(MOVING, iv), np.float64)
           for iv in range(3)]
    tbc = [tbnd.make_bc_values(NG, _by(MOVING, iv), torch.float64)
           for iv in range(3)]
    dl, dzc, dzf = jcfg.dl, g.dzc, g.dzf
    jup, jvp, jwp, _ = jbnd.pad_velocity(
        *map(jnp.asarray, (u, v, w)), cbc, *jbc, dl, dzc, dzf,
        vlo=tuple(map(jnp.asarray, vlo)), is_correc=True)
    cbcp = tuple((jcfg.cbcpre[0][d], jcfg.cbcpre[1][d]) for d in range(3))
    cbcs = tuple((jcfg.cbcsgs[0][d], jcfg.cbcsgs[1][d]) for d in range(3))
    zero = ((0.0, 0.0),) * 3
    ppad = jbnd.pad_scalar(jnp.asarray(p), cbcp, zero, dl, dzc)
    spad = jbnd.pad_scalar(jnp.asarray(s), cbcs, zero, dl, dzc)
    f1, f2, bforce = 0.5e-3, -0.2e-3, (0.1, 0.0, 0.02)
    dxi, dyi = jcfg.dli[0], jcfg.dli[1]
    (eu, exyu, ezu), (ev, exyv, ezv), (ew, exyw, ezw) = jst.momentum_rhs(
        jup, jvp, jwp, spad if with_s else None, jcfg.visc, dxi, dyi,
        g.dzci, g.dzfi, with_sgs=with_s)
    if split is None:
        rhs = (eu + exyu + ezu, ev + exyv + ezv, ew + exyw + ezw)
        rd = (0.0, 0.0, 0.0)
    else:
        rhs = (eu + exyu, ev + exyv, ew + exyw)
        rd = (ezu, ezv, ezw)
    nz = NG[2]
    dzci_c = jnp.asarray(g.dzci[1:nz + 1])[:, None, None]
    c = ppad[1:-1, 1:-1, 1:-1]
    grad = (dxi * (ppad[1:-1, 1:-1, 2:] - c), dyi * (ppad[1:-1, 2:, 1:-1] - c),
            dzci_c * (ppad[2:, 1:-1, 1:-1] - c))
    f12 = f1 + f2
    ref = [q + f1 * r + f12 * (b - gq) + f2 * o + 0.5 * f12 * d_
           for q, r, b, gq, o, d_ in zip((u, v, w), rhs, bforce, grad,
                                         (ruo, rvo, rwo), rd)]
    T = [_t(q) for q in (u, v, w)]
    tvlo = tuple(map(_t, vlo))
    tcbc = cbc
    ze = tbnd.zedge_velocity(*T, tcbc, *tbc, dzc, dzf, vlo=tvlo,
                             is_correc=True)
    tzero = tbnd.make_bc_values(NG, zero, torch.float64)
    P, S = _t(p), _t(s)
    pe, se = (tbnd.zedge_scalar(q, c_[2], tzero[2], dzc)
              for q, c_ in ((P, cbcp), (S, cbcs)))
    xe = tbnd.xedge_velocity(*T, tcbc, *tbc, dl, dzc, dzf, vlo=tvlo,
                             is_correc=True, ywalls=ywalls)
    xp, xs = (tbnd.xedge_scalar(q, c_, tzero, dl, dzc, ywalls=ywalls)
              for q, c_ in ((P, cbcp), (S, cbcs)))
    ye = None
    if ywalls:
        rows, corners = tbnd.yedge_velocity(*T, tcbc, *tbc, dl, dzc, dzf,
                                            vlo=tvlo, is_correc=True)
        ye = (*zip(rows, corners), tbnd.yedge_scalar(S, cbcs, tzero, dl, dzc),
              tbnd.yedge_scalar(P, cbcp, tzero, dl, dzc))
    got = K.mom_rk(*T, S if with_s else None, P, *ze,
                   se if with_s else None, pe, *map(_t, (ruo, rvo, rwo)),
                   _t(g.dzci), _t(g.dzfi), f1, f2, jcfg.visc, dxi, dyi,
                   bforce, sums=(True, True),
                   split=None if split is None else '1d', ye=ye,
                   xe=(*xe, xs if with_s else None, xp))
    for i in range(3):
        _close(got[i], ref[i], 1e-13)
        _close(got[3 + i], rhs[i], 1e-12)
    # the sums see the full prediction u + f12 rd
    _close(got[6][:, 0], np.asarray(ref[0] + 0.5 * f12 * rd[0]).sum(
        axis=(1, 2)), 1e-12)


# ------------------------------------------ the stacks with plane values

@pytest.mark.parametrize('fill', ['prediction', 'correc'])
def test_xedge_stacks_with_plane_values_match_jax(fill):
    """An inflow profile on the lower x face (u) and planes on both z
    faces (u and v, as the wall model's): the x stacks' columns and
    corners against JAX's xedge_velocity, the twins' padding against
    pad_velocity save at the eight (z ghost, y ghost, x ghost) corners,
    which the sequential fill takes from the planes' own ghost rows and
    no kernel reads (the port wraps the columns along y)."""
    nx, ny, nz = NG
    cfg = JConfig(ng=NG, l=(2.0, 1.5, 1.0), gtype=1, gr=1.0, visci=1000.0,
                  dtype='float64', bcvel=MOVING, **DEV_BCS)
    g = j_make_grid(cfg)
    cbc = j_effective_cbcvel(cfg)
    vals = [[list(q) for q in _by(MOVING, iv)] for iv in range(3)]
    vals[0][0][0] = _profile(NG, 1)
    for iv in range(2):
        for ib in range(2):
            vals[iv][2][ib] = _zplane(NG, 20 + 2 * iv + ib)
    jbc = [jbnd.make_bc_values(NG, v_, np.float64) for v_ in vals]
    tbc = [tbnd.make_bc_values(NG, v_, torch.float64) for v_ in vals]
    is_correc = fill == 'correc'
    vlo = _vlo(NG, 5, False)
    U = _fields(NG, 6)
    jvlo = tuple(map(jnp.asarray, vlo)) if is_correc else None
    tvlo = tuple(map(_t, vlo)) if is_correc else None
    dl, dzc, dzf = cfg.dl, g.dzc, g.dzf
    J = [jnp.asarray(q) for q in U]
    jcols, jcorners = jbnd.xedge_velocity(*J, cbc, *jbc, dl, dzc, dzf,
                                          vlo=jvlo, is_correc=is_correc)
    pads = jbnd.pad_velocity(*J, cbc, *jbc, dl, dzc, dzf, vlo=jvlo,
                             is_correc=is_correc)[:3]
    T = [_t(q) for q in U]
    xe = tbnd.xedge_velocity(*T, cbc, *tbc, dl, dzc, dzf, vlo=tvlo,
                             is_correc=is_correc)
    ze = tbnd.zedge_velocity(*T, cbc, *tbc, dzc, dzf, vlo=tvlo,
                             is_correc=is_correc)
    for (cols, corners), jc, jz in zip(xe, jcols, jcorners):
        _close(cols, np.asarray(jc)[:, :, PERM].transpose(0, 2, 1), 1e-14)
        _close(corners, np.asarray(jz)[:, :, PERM].transpose(0, 2, 1), 1e-14)
    for iv, (q, e, x, ref) in enumerate(zip(T, ze, xe, pads)):
        got = K.padded(q, e, x=x, rewrite=iv == 0 and not is_correc).numpy()
        ref = np.array(ref)
        for a in (got, ref):
            a[np.ix_([0, -1], [0, -1], [0, -1])] = 0.0
        _close(got, ref, 1e-14)


# ------------------------------------------------ the wall model's rows

WM = dict(ng=(24, 10, 8), l=(6.4, 3.2, 2.0), gtype=6, gr=0.0,
          visci=50000.0, dtype='float64', sgstype='smag',
          lwm=((0, 0, 1), (0, 0, 1)), hwm=0.1, **DEV_BCS)


@pytest.mark.parametrize('inflow', ['scalar', 'profile'])
def test_xwalled_wall_model_planes_match_jax(inflow):
    """The developing WMLES's two z faces: each sampled row's x ghosts and
    u's rewrite slot from the x faces' values (an inflow profile's at the
    row), then wrapped along y; both planes whole against cales_tpu's
    fast row fill (scalar values) or its full-pad route (the profile)."""
    nx, ny, nz = WM['ng']
    bcvel = [[list(q) for q in side] for side in
             (((1.0, 0.0, 0.0), (0.0,) * 3, (0.0,) * 3), ((0.0,) * 3,) * 3)]
    if inflow == 'profile':
        bcvel[0][0][0] = _profile(WM['ng'], 2)
    bcvel = tuple(tuple(tuple(q) for q in side) for side in bcvel)
    jcfg = JConfig(**WM, bcvel=bcvel, use_pallas=False)
    tcfg = Config(**WM, bcvel=bcvel)
    jsim = JaxSimulation(jcfg, j_make_grid(jcfg))
    assert jsim._wm_fast == (inflow == 'scalar')
    sim = Simulation(tcfg, make_grid_from_config(tcfg), device='cpu')
    assert all(f.xfills is not None for f in sim.wm.faces)
    rng = np.random.default_rng(9)
    u, v, w = (1.0 + 0.1 * rng.standard_normal((nz, ny, nx)),
               0.1 * rng.standard_normal((nz, ny, nx)),
               0.1 * rng.standard_normal((nz, ny, nx)))
    J = [jnp.asarray(q) for q in (u, v, w)]
    jb = (jsim._wm_bcs_fast(*J) if inflow == 'scalar'
          else jsim._dynamic_bcs(*J))
    T = [_t(q) for q in (u, v, w)]
    for planes in (wmod.wm_planes_plain(T[0], T[1], sim.wm),
                   K.wm_planes(T[0], T[1], sim.wm)):
        for f, pair in zip(sim.wm.faces, planes):
            for c in range(2):
                ref = np.asarray(jb[c][2][f.ib])
                assert ref.shape == (ny + 2, nx + 2)
                _close(pair[c], ref, 1e-13 * float(np.abs(ref).max()))
    # the columns the x recipe feeds: bcu's 0 and nx, bcv's 1 and nx
    assert float(np.abs(np.asarray(jb[0][2][0])[1:-1, [0, nx]]).min()) > 0
