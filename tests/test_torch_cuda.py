"""cales_torch's CUDA kernels on the card: each against its plain twin (the
slab variants with y halos and apply_x too), and the slices (channel LES,
implicit-CN channel DNS, dynamic-Smagorinsky channel, static-Smagorinsky
LES with impdiff_1d, the y-walled duct and cavity, the two-pass dynamic
Smagorinsky, the triperiodic Taylor-Green
vortex and full-3D implicit diffusion, the wall-modelled channel LES, the
x-walled LES: the developing channel, duct and wall-modelled channel, the
passive scalar: mom_rk's scalar variant with z, y, x and x and y walls,
the slab modes of the y-slab mesh, ptransform 'fft' with y walls: the
mixed Poisson route)
on the card against the same slices on the CPU, step for step, fp64.

These tests need an NVIDIA GPU and skip without one.  The file imports
neither jax nor cales_tpu, so it runs on a machine that has torch and the
CUDA toolkit only:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: kernel vs twin 1e-12 (the same formulas; FMA contraction and
the order of a few sums differ), relative to the output's maximum for the
solve kernels (sums of up to nx terms); card vs CPU after 3 steps u, v, w
1e-11, p 1e-10 after removing its mean, nu_t 1e-12 (1e-10 relative to its
maximum where the smag or dsmag stage makes it); dsmag's |S| 1e-12 and
its per-row sums 1e-12 relative to their maximum."""
import numpy as np
import pytest
import torch

from cales_torch.config import Config
from cales_torch.grid import make_grid_from_config
from cales_torch.initflow import initflow

from cales_torch.ops import kernels as K
from cales_torch.ops import solve_kernels as SK
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
    assert K.LAUNCHES == {'mom_rk': 1, 'fillps': 1, 'correc_smag': 2,
                          'correc_updatep': 0, 'smag': 0,
                          'dsmag': 0,
                          'dsmag_level1': 0, 'dsmag_level2': 0,
                          'wallmodel': 0}


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
    assert K.LAUNCHES == {'mom_rk': 9, 'fillps': 9, 'correc_smag': 9,
                          'correc_updatep': 0, 'smag': 0,
                          'dsmag': 0,
                          'dsmag_level1': 0, 'dsmag_level2': 0,
                          'wallmodel': 0}
    g, c = states
    for name, tol in (('u', 1e-11), ('v', 1e-11), ('w', 1e-11), ('p', 1e-10),
                      ('visct', 1e-12)):
        a, b = getattr(g, name).cpu(), getattr(c, name)
        if name == 'p':
            a, b = a - a.mean(), b - b.mean()
        assert float((a - b).abs().max()) <= tol, name


def _rel_close(got, ref, rtol):
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    assert err <= rtol * max(scale, 1e-300), (err, scale)


@pytest.mark.cuda
def test_cuda_dns_kernels_match_twins_on_card(dev):
    """mom_rk with split '1d' + fold and without visct, and
    correc_updatep with and without alpha L(pp), against their twins."""
    ng = (72, 40, 24)
    nx, ny, nz = ng
    cfg = Config(ng=ng, l=(2 * np.pi, np.pi, 2.0), gtype=1, gr=1.0,
                 visci=1000.0, dtype='float64')
    grid = make_grid_from_config(cfg)
    rng = np.random.default_rng(9)

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev)
    F = lambda: t(0.05 * rng.standard_normal((nz, ny, nx)))   # noqa: E731
    E = lambda: t(0.05 * rng.standard_normal((3, ny, nx)))    # noqa: E731
    u, v, w, p, pp, ruo, rvo, rwo = (F() for _ in range(8))
    ue, ve, we, pe, ppe = (E() for _ in range(5))
    dxi, dyi = cfg.dli[0], cfg.dli[1]
    dzci, dzfi = t(grid.dzci), t(grid.dzfi)
    K.reset_launches()
    for r in ((ruo, rvo, rwo), (None,) * 3):
        mom = (u, v, w, None, p, ue, ve, we, None, pe, *r, dzci, dzfi,
               5e-4, -2e-4 if r[0] is not None else 0.0, cfg.visc, dxi, dyi,
               (0.1, 0.0, 0.0))
        got = K.mom_rk(*mom, sums=(True, True), split='1d')
        ref = K.mom_rk_plain(*mom, sums=(True, True), split='1d')
        for g, q in zip(got[:6], ref[:6]):
            torch.testing.assert_close(g, q, rtol=0, atol=1e-12)
        for g, q in zip(got[6:], ref[6:]):
            torch.testing.assert_close(g.sum(1), q[:, 0], rtol=0, atol=1e-11)
    for imp in ((False, False), (True, True), (True, False)):
        cu = (u, v, w, pp, p, we, ppe, 3.7e-3, dxi, dyi, dzci, dzfi,
              t([0.05, -0.02]), -0.013, *imp)
        for g, q in zip(K.correc_updatep(*cu), K.correc_updatep_plain(*cu)):
            _rel_close(g, q, 1e-13)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {'mom_rk': 2, 'fillps': 0, 'correc_smag': 0,
                          'correc_updatep': 3, 'smag': 0,
                          'dsmag': 0,
                          'dsmag_level1': 0, 'dsmag_level2': 0,
                          'wallmodel': 0}


@pytest.mark.cuda
def test_cuda_solve_kernels_match_twins_on_card(dev):
    """apply_y with and without MxT, z_eig, and both Thomas variants, on a
    shape that fits no tile (nx, ny, nz) = (72, 40, 24)."""
    from cales_torch import poisson
    ng = (72, 40, 24)
    nx, ny, nz = ng
    cfg = Config(ng=ng, l=(2 * np.pi, np.pi, 2.0), gtype=1, gr=1.0,
                 dtype='float64', ptransform='mat')
    grid = make_grid_from_config(cfg)
    rng = np.random.default_rng(10)

    def t(a, dt=torch.float64):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)
    x = t(rng.standard_normal((nz, ny, nx)))
    sv = poisson.make_solver(cfg, grid, ('PP', 'PP', 'NN'), ('c', 'c', 'c'))
    SK.reset_launches()
    for mxt in (None, t(sv.trx.fwd_mat.T)):
        _rel_close(SK.apply_y(x, t(sv.try_.fwd_mat), MxT=mxt),
                   SK.apply_y_plain(x, t(sv.try_.fwd_mat), MxT=mxt), 1e-13)
    eig = (t(sv.zVl), t(sv.zVr), t(sv.lamz), t(sv.lamy), t(sv.lamx), 1e-9)
    _rel_close(SK.z_eig(x, *eig), SK.z_eig_plain(x, *eig), 1e-12)
    abc = (t(sv.a), t(sv.b), t(sv.c))
    pois = dict(lamy=t(sv.lamy), lamx=t(sv.lamx), pin=True, tol=1e-9)
    _rel_close(SK.thomas_z(x, *abc, **pois),
               SK.thomas_z_plain(x, *abc, **pois), 1e-12)
    svw = poisson.make_solver(cfg, grid, ('PP', 'PP', 'DD'), ('c', 'c', 'f'))
    abcw = (t(svw.a), t(svw.b), t(svw.c))
    helm = dict(alpha=-0.043, shift=t([0.017]), n_solve=nz - 1,
                bc_lo=t(rng.standard_normal((ny, nx))),
                bc_hi=t(rng.standard_normal((ny, nx))))
    _rel_close(SK.thomas_z(x, *abcw, **helm),
               SK.thomas_z_plain(x, *abcw, **helm), 1e-12)
    torch.cuda.synchronize()
    assert SK.LAUNCHES == {'apply_y': 2, 'apply_x': 0, 'z_eig': 1,
                           'thomas_z': 2, 'thomas_periodic': 0}


@pytest.mark.cuda
def test_card_matches_cpu_dns_step_for_step(dev):
    """The implicit-CN channel DNS (bench.py's channel_dns_impdiff) at
    (32, 16, 16), f64, 3 steps: card against CPU."""
    cfg = Config(ng=(32, 16, 16), l=(2 * np.pi, np.pi, 2.0), gtype=1,
                 gr=1.0, visci=5640.0, inivel='log', is_wallturb=True,
                 is_forced=(True, False, False), velf=(1.0, 0.0, 0.0),
                 sgstype='none', impdiff=True, impdiff_1d=True,
                 dtype='float64', ptransform='mat',
                 cbcsgs=(('P', 'P', 'D'), ('P', 'P', 'D')))
    grid = make_grid_from_config(cfg)
    fields = initflow(cfg, grid)
    sims = [Simulation(cfg, grid, device=d) for d in (dev, 'cpu')]
    states = [s.initial_state(*fields) for s in sims]
    dt = sims[1].pick_dt(sims[1].check(states[1])[0])
    K.reset_launches()
    SK.reset_launches()
    for _ in range(3):
        states = [s.step(st, dt)[0] for s, st in zip(sims, states)]
    assert K.LAUNCHES == {'mom_rk': 9, 'fillps': 9, 'correc_smag': 0,
                          'correc_updatep': 9, 'smag': 0,
                          'dsmag': 0,
                          'dsmag_level1': 0, 'dsmag_level2': 0,
                          'wallmodel': 0}
    assert SK.LAUNCHES == {'apply_y': 18, 'apply_x': 0, 'z_eig': 9,
                           'thomas_z': 27, 'thomas_periodic': 0}
    g, c = states
    for name, tol in (('u', 1e-11), ('v', 1e-11), ('w', 1e-11), ('p', 1e-10)):
        a, b = getattr(g, name).cpu(), getattr(c, name)
        if name == 'p':
            a, b = a - a.mean(), b - b.mean()
        assert float((a - b).abs().max()) <= tol, name


def _sgs_inputs(dev, ng, seed):
    """Random interiors on a stretched channel grid with the post-correction
    fill's edge stacks (the dsmag kernel's ghost recipes assume the
    channel's walls), and the smag profiles."""
    from cales_torch import sgs as sgsmod
    from cales_torch.config import C_SMAG, effective_cbcvel
    from cales_torch.ops import boundary as bnd
    nx, ny, nz = ng
    cfg = Config(ng=ng, l=(2 * np.pi, np.pi, 2.0), gtype=1, gr=1.2,
                 visci=1000.0, dtype='float64',
                 cbcvel=((('P', 'P', 'P'), ('P', 'P', 'P'),
                          ('D', 'D', 'D')),) * 2,
                 cbcpre=(('P', 'P', 'N'),) * 2, cbcsgs=(('P', 'P', 'D'),) * 2)
    grid = make_grid_from_config(cfg)
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev)
    u, v, w = (t(0.1 * rng.standard_normal((nz, ny, nx))) for _ in range(3))
    wlo = t(np.pad(1e-3 * rng.standard_normal((ny, nx)), 1, mode='wrap'))
    bc = bnd.make_bc_values(ng, ((0.0,) * 3,) * 3, torch.float64, dev)
    edges = [e.contiguous() for e in bnd.zedge_velocity(
        u, v, w, effective_cbcvel(cfg), bc, bc, bc, grid.dzc, grid.dzf,
        vlo=(None, None, wlo), is_correc=True)]
    setup = sgsmod.SGSSetup(cfg, grid, effective_cbcvel(cfg))
    zc = grid.zc[1:nz + 1]
    a2 = np.full(nz, 4.0)
    a2[0] = a2[-1] = 2.52
    return dict(
        cfg=cfg, grid=grid,
        fields=(u, v, w), edges=edges, dzci=t(grid.dzci), dzfi=t(grid.dzfi),
        dxi=cfg.dli[0], dyi=cfg.dli[1], visc=cfg.visc, alph2=t(a2),
        csd2=t((C_SMAG * setup.delta) ** 2), dw=t(np.minimum(zc, 2.0 - zc)),
        nearlo=t((zc <= 1.0).astype(float)),
        tauw=[t(np.abs(rng.standard_normal((ny, nx)))) for _ in range(2)])


@pytest.mark.cuda
def test_cuda_sgs_kernels_match_twins_on_card(dev):
    """smag and dsmag against their plain twins on a shape that fits no
    tile; dsmag's per-block sums against the twin's per-row sums."""
    d = _sgs_inputs(dev, (72, 40, 24), 11)
    K.reset_launches()
    sm = (*d['fields'], *d['edges'], d['dzci'], d['dzfi'], d['dxi'],
          d['dyi'], d['visc'], d['csd2'], d['dw'], d['nearlo'], *d['tauw'])
    torch.testing.assert_close(K.smag(*sm), K.smag_plain(*sm), rtol=0,
                               atol=1e-12)
    ds = (*d['fields'], *d['edges'], d['alph2'], d['dzci'], d['dzfi'],
          d['dxi'], d['dyi'], True, True, (0.0, 0.3, 0.0, -0.2))
    s0, num, den = K.dsmag(*ds)
    s0r, numr, denr = K.dsmag_plain(*ds)
    _rel_close(s0, s0r, 1e-12)
    _rel_close(num.sum(1), numr[:, 0], 1e-12)
    _rel_close(den.sum(1), denr[:, 0], 1e-12)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {'mom_rk': 0, 'fillps': 0, 'correc_smag': 0,
                          'correc_updatep': 0, 'smag': 1, 'dsmag': 1,
                          'dsmag_level1': 0, 'dsmag_level2': 0,
                          'wallmodel': 0}


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['dsmag', 'smag_impdiff_1d'])
def test_card_matches_cpu_sgs_step_for_step(dev, case):
    """The dynamic-Smagorinsky channel (validation/dsmag_channel.py) and
    the static-Smagorinsky LES with impdiff_1d at (32, 16, 16), f64, 3
    steps: card against CPU."""
    base = dict(ng=(32, 16, 16), gtype=1, is_wallturb=True,
                is_forced=(True, False, False), velf=(1.0, 0.0, 0.0),
                impdiff=True, impdiff_1d=True, dtype='float64',
                ptransform='mat', cbcsgs=(('P', 'P', 'D'), ('P', 'P', 'D')))
    if case == 'dsmag':
        kw = dict(l=(12.8, 4.8, 2.0), gr=5.0, visci=10_000.0, inivel='poi',
                  sgstype='dsmag', dsmag_avg='channel')
    else:
        kw = dict(l=(2 * np.pi, np.pi, 2.0), gr=1.0, visci=20_000.0,
                  inivel='log', sgstype='smag')
    cfg = Config(**base, **kw)
    grid = make_grid_from_config(cfg)
    fields = initflow(cfg, grid)
    sims = [Simulation(cfg, grid, device=d) for d in (dev, 'cpu')]
    states = [s.initial_state(*fields) for s in sims]
    dt = sims[1].pick_dt(sims[1].check(states[1])[0])
    K.reset_launches()
    for _ in range(3):
        states = [s.step(st, dt)[0] for s, st in zip(sims, states)]
    sgs = 'dsmag' if case == 'dsmag' else 'smag'
    assert K.LAUNCHES == {'mom_rk': 9, 'fillps': 9, 'correc_smag': 0,
                          'correc_updatep': 9, 'smag': 0, 'dsmag': 0,
                          'dsmag_level1': 0, 'dsmag_level2': 0,
                          'wallmodel': 0, sgs: 9}
    g, c = states
    for name, tol in (('u', 1e-11), ('v', 1e-11), ('w', 1e-11), ('p', 1e-10)):
        a, b = getattr(g, name).cpu(), getattr(c, name)
        if name == 'p':
            a, b = a - a.mean(), b - b.mean()
        assert float((a - b).abs().max()) <= tol, name
    _rel_close(g.visct.cpu(), c.visct, 1e-10)


DUCT_BCS = dict(
    cbcvel=((('P', 'P', 'P'), ('D', 'D', 'D'), ('D', 'D', 'D')),) * 2,
    cbcpre=(('P', 'N', 'N'),) * 2, cbcsgs=(('P', 'D', 'D'),) * 2)
# moving wall-parallel values on some y and z faces: (face, dir, comp)
MOVING = (((0.0,) * 3, (0.2, 0.0, -0.1), (0.0, 0.0, 0.0)),
          ((0.0,) * 3, (0.0, 0.0, 0.3), (0.4, -0.3, 0.0)))


def _ywall_inputs(dev, ng, seed):
    """Random interiors on a duct grid with the ghost stacks of each fill
    the y-walled kernels take: the post-correction fill (kept lower faces
    of v and w) and the prediction fill of the velocity, visct's and p's,
    as (rows, corners) pairs."""
    from cales_torch.config import effective_cbcvel
    from cales_torch.ops import boundary as bnd
    nx, ny, nz = ng
    cfg = Config(ng=ng, l=(2 * np.pi, 2.0, 2.0), gtype=1, gr=1.0,
                 visci=1000.0, dtype='float64', bcvel=MOVING,
                 bcpre=((0.0, 0.1, 0.0), (0.0, -0.1, 0.0)), **DUCT_BCS)
    grid = make_grid_from_config(cfg)
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev)

    def wrapx(a):
        return torch.cat([a[:, -1:], a, a[:, :1]], dim=1)
    F = lambda: t(0.05 * rng.standard_normal((nz, ny, nx)))   # noqa: E731
    cbc = effective_cbcvel(cfg)
    by = lambda iv: tuple(tuple(MOVING[ib][d][iv] for ib in range(2))  # noqa: E731
                          for d in range(3))
    bc = [bnd.make_bc_values(ng, by(iv), torch.float64, dev)
          for iv in range(3)]
    bcp = bnd.make_bc_values(ng, ((0.0, 0.0), (0.1, -0.1), (0.0, 0.0)),
                             torch.float64, dev)
    bcs = bnd.make_bc_values(ng, ((0.0, 0.0),) * 3, torch.float64, dev)
    cbcp = tuple((cfg.cbcpre[0][d], cfg.cbcpre[1][d]) for d in range(3))
    cbcs = tuple((cfg.cbcsgs[0][d], cfg.cbcsgs[1][d]) for d in range(3))
    vlo = (None, wrapx(t(1e-2 * rng.standard_normal((nz + 2, nx)))),
           wrapx(t(1e-2 * rng.standard_normal((ny + 2, nx)))))
    u, v, w, p, pp = (F() for _ in range(5))
    s = F().abs()

    def fill(is_correc):
        kw = dict(vlo=vlo if is_correc else None, is_correc=is_correc)
        z = [e.contiguous() for e in bnd.zedge_velocity(
            u, v, w, cbc, *bc, grid.dzc, grid.dzf, **kw)]
        rows, corners = bnd.yedge_velocity(u, v, w, cbc, *bc, cfg.dl,
                                           grid.dzc, grid.dzf, **kw)
        return z, list(zip(rows, corners))

    def scal(q, cbcq, bq):
        return (bnd.zedge_scalar(q, cbcq[2], bq[2], grid.dzc).contiguous(),
                bnd.yedge_scalar(q, cbcq, bq, cfg.dl, grid.dzc))
    zc, yc = fill(True)
    zp, yp = fill(False)
    return dict(cfg=cfg, grid=grid, fields=(u, v, w), s=s, p=p, pp=pp,
                zc=zc, yc=yc, zp=zp, yp=yp, sq=scal(s, cbcs, bcs),
                pq=scal(p, cbcp, bcp), ppq=scal(pp, cbcp, bcp),
                rk=[F() for _ in range(3)], dzci=t(grid.dzci),
                dzfi=t(grid.dzfi), dxi=cfg.dli[0], dyi=cfg.dli[1])


@pytest.mark.cuda
def test_cuda_ywalled_kernels_match_twins_on_card(dev):
    """The y-walled variants of mom_rk (with and without visct), fillps,
    correc_updatep and dsmag ('duct', 'cavity', and 'channel' with y
    walls) against their twins on a shape that fits no tile."""
    d = _ywall_inputs(dev, (72, 40, 24), 12)
    (u, v, w), dzci, dzfi, dxi, dyi = (d['fields'], d['dzci'], d['dzfi'],
                                       d['dxi'], d['dyi'])
    K.reset_launches()
    for sgs in (True, False):
        se, ys = d['sq'] if sgs else (None, None)
        mom = (u, v, w, d['s'] if sgs else None, d['p'], *d['zc'], se,
               d['pq'][0], *d['rk'], dzci, dzfi, 5e-4, -2e-4, 1e-3, dxi, dyi,
               (0.1, 0.0, 0.0))
        ye = (*d['yc'], ys, d['pq'][1])
        got = K.mom_rk(*mom, sums=(True, False), ye=ye)
        ref = K.mom_rk_plain(*mom, sums=(True, False), ye=ye)
        for g, r in zip(got[:6], ref[:6]):
            _rel_close(g, r, 1e-12)
        torch.testing.assert_close(got[6].sum(1), ref[6][:, 0], rtol=0,
                                   atol=1e-11)
    fp = (u, v, w, *d['zp'], dzfi, 20.0, dxi, dyi)
    _rel_close(K.fillps(*fp, yv=d['yp'][1]),
               K.fillps_plain(*fp, yv=d['yp'][1]), 1e-13)
    cu = (u, v, w, d['pp'], d['p'], d['zp'][2], d['ppq'][0], 3.7e-3, dxi,
          dyi, dzci, dzfi, torch.tensor([0.05, -0.02], dtype=u.dtype,
                                        device=dev))
    ykw = dict(ypp=d['ppq'][1], yv=d['yp'][1][0])
    for g, r in zip(K.correc_updatep(*cu, **ykw),
                    K.correc_updatep_plain(*cu, **ykw)):
        _rel_close(g, r, 1e-13)
    a2 = np.full(24, 4.0)
    a2[0] = a2[-1] = 2.52
    ds = (u, v, w, *d['zc'], torch.as_tensor(a2, device=dev), dzci, dzfi,
          dxi, dyi, True, True, (0.0, 0.4, 0.0, -0.3))
    dkw = dict(ye=d['yc'], yvals=(0.2, 0.0, -0.1, 0.3))
    for avg in ('duct', 'cavity', 'channel'):
        s0, num, den = K.dsmag(*ds, avg=avg, **dkw)
        s0r, numr, denr = K.dsmag_plain(*ds, avg=avg, **dkw)
        _rel_close(s0, s0r, 1e-12)
        if avg != 'cavity':
            _rel_close(num.sum(-1), numr[..., 0], 1e-12)
            _rel_close(den.sum(-1), denr[..., 0], 1e-12)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {'mom_rk': 2, 'fillps': 1, 'correc_smag': 0,
                          'correc_updatep': 1, 'smag': 0, 'dsmag': 3,
                          'dsmag_level1': 0, 'dsmag_level2': 0,
                          'wallmodel': 0}


@pytest.mark.cuda
@pytest.mark.parametrize('ywall', [False, True])
def test_cuda_twopass_dsmag_kernels_match_twins_on_card(dev, ywall):
    """dsmag_level1 and dsmag_level2 ('channel', 'duct', 'cavity') against
    their twins on a shape that fits no tile, without and with y walls:
    the post-correction fill carries a non-zero lower w face, the filtered
    velocity's static fill w = W on both z faces (transpiring walls)."""
    from cales_torch.config import effective_cbcvel
    from cales_torch.ops import boundary as bnd
    ng = (72, 40, 24)
    nz = ng[2]
    if ywall:
        d = _ywall_inputs(dev, ng, 13)
        edges, ye = d['zc'], d['yc']
    else:
        d = _sgs_inputs(dev, ng, 14)
        edges, ye = d['edges'], None
    cfg, grid = d['cfg'], d['grid']
    a2 = np.full(nz, 4.0)
    a2[0] = a2[-1] = 2.52
    alph2 = torch.as_tensor(a2, device=dev)
    K.reset_launches()
    l1 = (*d['fields'], *edges, d['dzci'], d['dzfi'], d['dxi'], d['dyi'],
          True, True)
    got = K.dsmag_level1(*l1, ye=ye)
    ref = K.dsmag_level1_plain(*l1, ye=ye)
    for g, r in zip((*got[0], *got[1], *got[2], got[3]),
                    (*ref[0], *ref[1], *ref[2], ref[3])):
        _rel_close(g, r, 1e-12)
    fm, (fu, fv, fw), lij, s0 = ref
    zero = bnd.make_bc_values(ng, ((0.0, 0.0),) * 3, torch.float64, dev)
    bcw = bnd.make_bc_values(ng, ((0.0, 0.0), (0.0, 0.0), (3e-3, 3e-3)),
                             torch.float64, dev)
    cbc = effective_cbcvel(cfg)
    fze = [e.contiguous() for e in bnd.zedge_velocity(
        fu, fv, fw, cbc, zero, zero, bcw, grid.dzc, grid.dzf)]
    fye = None
    if ywall:
        fye = list(zip(*bnd.yedge_velocity(fu, fv, fw, cbc, zero, zero, bcw,
                                           cfg.dl, grid.dzc, grid.dzf)))
    l2 = (fu, fv, fw, *fze, fm, lij, s0, alph2, d['dzci'], d['dzfi'],
          d['dxi'], d['dyi'])
    for avg in ('channel', 'duct', 'cavity'):
        got2 = K.dsmag_level2(*l2, avg=avg, ye=fye)
        ref2 = K.dsmag_level2_plain(*l2, avg=avg, ye=fye)
        if avg == 'cavity':
            _rel_close(got2, ref2, 1e-12)
            continue
        for g, r in zip(got2, ref2):
            _rel_close(g.sum(-1), r[..., 0], 1e-12)
    torch.cuda.synchronize()
    assert K.LAUNCHES['dsmag_level1'] == 1
    assert K.LAUNCHES['dsmag_level2'] == 3 and K.LAUNCHES['dsmag'] == 0


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['blow_channel', 'duct_twopass'])
def test_card_matches_cpu_twopass_step_for_step(dev, case, monkeypatch):
    """The two-pass dynamic Smagorinsky at (32, 16, 16), f64, 3 steps: the
    channel with transpiring walls (two passes by the route rule) and the
    duct under CALES_DSMAG_TWOPASS=1, card against CPU."""
    monkeypatch.setenv('CALES_DSMAG_TWOPASS', '1' if case == 'duct_twopass'
                       else '')
    if case == 'blow_channel':
        face = ((0.0,) * 3, (0.0,) * 3, (0.0, 0.0, 3e-3))
        kw = dict(l=(12.8, 4.8, 2.0), gr=5.0, visci=10_000.0, inivel='poi',
                  dsmag_avg='channel', impdiff=True, impdiff_1d=True,
                  bcvel=(face, face),
                  cbcvel=((('P', 'P', 'P'), ('P', 'P', 'P'),
                           ('D', 'D', 'D')),) * 2,
                  cbcpre=(('P', 'P', 'N'),) * 2,
                  cbcsgs=(('P', 'P', 'D'),) * 2)
    else:
        kw = dict(l=(4 * np.pi, 2.0, 2.0), gr=1.0, visci=10_000.0,
                  inivel='duc', dsmag_avg='duct', **DUCT_BCS)
    cfg = Config(ng=(32, 16, 16), gtype=1, is_wallturb=True,
                 is_forced=(True, False, False), velf=(1.0, 0.0, 0.0),
                 sgstype='dsmag', dtype='float64', ptransform='mat', **kw)
    grid = make_grid_from_config(cfg)
    fields = initflow(cfg, grid)
    sims = [Simulation(cfg, grid, device=d) for d in (dev, 'cpu')]
    assert all(s.dsmag_twopass for s in sims)
    states = [s.initial_state(*fields) for s in sims]
    dt = sims[1].pick_dt(sims[1].check(states[1])[0])
    K.reset_launches()
    for _ in range(3):
        states = [s.step(st, dt)[0] for s, st in zip(sims, states)]
    assert K.LAUNCHES['dsmag_level1'] == K.LAUNCHES['dsmag_level2'] == 9
    assert K.LAUNCHES['dsmag'] == 0
    g, c = states
    for name, tol in (('u', 1e-11), ('v', 1e-11), ('w', 1e-11), ('p', 1e-10)):
        a, b = getattr(g, name).cpu(), getattr(c, name)
        if name == 'p':
            a, b = a - a.mean(), b - b.mean()
        assert float((a - b).abs().max()) <= tol, name
    _rel_close(g.visct.cpu(), c.visct, 1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['duct_none', 'duct_dsmag', 'cavity_dsmag',
                                  'duct_smag', 'duct_wmles'])
def test_card_matches_cpu_ywalled_step_for_step(dev, case):
    """The duct (bench.py's duct_les_dsmag, and with sgstype 'none' and
    'smag'), the cavity (cavity_les_dsmag) and the duct WMLES
    (examples/turbulent_duct_wmles) at (32, 16, 16), f64, 3 steps: card
    against CPU, the kept v and w wall planes included."""
    if case in ('duct_smag', 'duct_wmles'):
        kw = {k: q for k, q in DUCT_WMLES.items()
              if k not in ('ng', 'dtype', 'ptransform', 'gtype', 'cbcvel',
                           'cbcpre', 'cbcsgs')}
        if case == 'duct_smag':
            kw['lwm'] = ((0, 0, 0), (0, 0, 0))
    elif case.startswith('duct'):
        kw = dict(l=(4 * np.pi, 2.0, 2.0), gr=1.0, visci=10_000.0,
                  inivel='duc', is_wallturb=True,
                  is_forced=(True, False, False), velf=(1.0, 0.0, 0.0),
                  sgstype='none' if case == 'duct_none' else 'dsmag',
                  dsmag_avg='duct')
    else:
        kw = dict(l=(1.0, 1.0, 1.0), gr=0.0, visci=5_000.0, inivel='tgv',
                  sgstype='dsmag', dsmag_avg='cavity',
                  bcvel=(((0.0,) * 3,) * 3,
                         ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))))
    cfg = Config(ng=(32, 16, 16), gtype=1, dtype='float64', ptransform='mat',
                 **DUCT_BCS, **kw)
    grid = make_grid_from_config(cfg)
    fields = initflow(cfg, grid)
    sims = [Simulation(cfg, grid, device=d) for d in (dev, 'cpu')]
    states = [s.initial_state(*fields) for s in sims]
    dt = sims[1].pick_dt(sims[1].check(states[1])[0])
    K.reset_launches()
    for _ in range(3):
        states = [s.step(st, dt)[0] for s, st in zip(sims, states)]
    smag = case in ('duct_smag', 'duct_wmles')
    assert K.LAUNCHES == {'mom_rk': 9, 'fillps': 9, 'correc_smag': 0,
                          'correc_updatep': 9, 'smag': 9 if smag else 0,
                          'dsmag': 0 if case == 'duct_none' or smag else 9,
                          'dsmag_level1': 0, 'dsmag_level2': 0,
                          'wallmodel': 9 if case == 'duct_wmles' else 0}
    g, c = states
    for name, tol in (('u', 1e-11), ('v', 1e-11), ('w', 1e-11), ('p', 1e-10)):
        a, b = getattr(g, name).cpu(), getattr(c, name)
        if name == 'p':
            a, b = a - a.mean(), b - b.mean()
        assert float((a - b).abs().max()) <= tol, name
    for m in (1, 2):
        assert float((g.vlo[m].cpu() - c.vlo[m]).abs().max()) <= 1e-11
    if case != 'duct_none':
        _rel_close(g.visct.cpu(), c.visct, 1e-10)


@pytest.mark.cuda
def test_cuda_triperiodic_kernels_match_twins_on_card(dev):
    """thomas_periodic pinned (Poisson) and with the alpha-scaled rows and
    shift (Helmholtz), mom_rk's 'xy+z' split with and without nu_t,
    thomas_z's Helmholtz rows with the lam shift and the tail row, and
    correc_updatep's full-3D alpha L(pp), at (nx, ny, nz) = (72, 40, 24)."""
    from cales_torch import poisson
    ng = (72, 40, 24)
    nx, ny, nz = ng
    cfg = Config(ng=ng, l=(2 * np.pi,) * 3, gtype=1, gr=0.0,
                 dtype='float64', ptransform='mat')
    grid = make_grid_from_config(cfg)
    rng = np.random.default_rng(12)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float64),
                               device=dev)
    F = lambda: t(0.05 * rng.standard_normal((nz, ny, nx)))   # noqa: E731
    E = lambda: t(0.05 * rng.standard_normal((3, ny, nx)))    # noqa: E731
    x = F()
    SK.reset_launches()
    K.reset_launches()
    sv = poisson.make_solver(cfg, grid, ('PP', 'PP', 'PP'), ('c', 'c', 'c'))
    abc = (t(sv.a), t(sv.b), t(sv.c))
    alpha = -0.043
    for kw in (dict(lamy=t(sv.lamy), lamx=t(sv.lamx), pin=True, tol=1e-9),
               dict(lamy=t(sv.lamy * alpha), lamx=t(sv.lamx * alpha),
                    alpha=alpha)):
        got = SK.thomas_periodic_z(x, *abc, **kw)
        _rel_close(got, SK.thomas_periodic_z_plain(x, *abc, **kw), 1e-12)
    assert float(got.abs().max()) > 0
    svw = poisson.make_solver(cfg.replace(gr=1.0), grid,
                              ('PP', 'PP', 'DD'), ('c', 'c', 'f'))
    abcw = (t(svw.a), t(svw.b), t(svw.c))
    helm = dict(lamy=t(svw.lamy * alpha), lamx=t(svw.lamx * alpha),
                alpha=alpha, n_solve=nz - 1)
    _rel_close(SK.thomas_z(x, *abcw, **helm),
               SK.thomas_z_plain(x, *abcw, **helm), 1e-12)
    u, v, w, s, p, pp, ruo, rvo, rwo = (F() for _ in range(9))
    s = s.abs()
    ue, ve, we, se, pe, ppe = (E() for _ in range(6))
    se = se.abs()
    dxi, dyi = cfg.dli[0], cfg.dli[1]
    dzci, dzfi = t(grid.dzci), t(grid.dzfi)
    for visct in ((s, se), (None, None)):
        mom = (u, v, w, visct[0], p, ue, ve, we, visct[1], pe, ruo, rvo,
               rwo, dzci, dzfi, 5e-4, -2e-4, cfg.visc, dxi, dyi,
               (0.1, 0.0, 0.0))
        got = K.mom_rk(*mom, sums=(True, True), split='xy+z')
        ref = K.mom_rk_plain(*mom, sums=(True, True), split='xy+z')
        for g, q in zip(got[:6], ref[:6]):
            torch.testing.assert_close(g, q, rtol=0, atol=1e-12)
        for g, q in zip(got[6:], ref[6:]):
            torch.testing.assert_close(g.sum(1), q[:, 0], rtol=0, atol=1e-11)
    cu = (u, v, w, pp, p, we, ppe, 3.7e-3, dxi, dyi, dzci, dzfi, None,
          -0.013, True, False)
    for g, q in zip(K.correc_updatep(*cu), K.correc_updatep_plain(*cu)):
        _rel_close(g, q, 1e-13)
    torch.cuda.synchronize()
    assert SK.LAUNCHES == {'apply_y': 0, 'apply_x': 0, 'z_eig': 0,
                           'thomas_z': 1, 'thomas_periodic': 2}
    assert K.LAUNCHES['mom_rk'] == 2 and K.LAUNCHES['correc_updatep'] == 1


TRIPERIODIC = dict(l=(2 * np.pi,) * 3, gtype=1, gr=0.0, visci=1600.0,
                   inivel='tgv', is_wallturb=False, sgstype='none',
                   dtype='float64',
                   cbcvel=((('P',) * 3,) * 3,) * 2, cbcpre=(('P',) * 3,) * 2,
                   cbcsgs=(('P',) * 3,) * 2)


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['tgv_mat_thomas', 'tgv_fft',
                                  'tgv_impdiff', 'channel_impdiff'])
def test_card_matches_cpu_triperiodic_step_for_step(dev, case):
    """3 steps, fp64, card against CPU: the Taylor-Green vortex by 'mat'
    with the periodic Thomas z stage and by 'fft'; full-3D implicit
    diffusion on the triperiodic box ('mat') and on the channel DNS."""
    cfg = Config(**{
        'tgv_mat_thomas': dict(TRIPERIODIC, ng=(16, 16, 24), ptransform='mat',
                               zsolver='thomas'),
        'tgv_fft': dict(TRIPERIODIC, ng=(16, 16, 24), ptransform='fft'),
        'tgv_impdiff': dict(TRIPERIODIC, ng=(16, 16, 24), ptransform='mat',
                            impdiff=True),
        'channel_impdiff': dict(
            ng=(32, 16, 16), l=(2 * np.pi, np.pi, 2.0), gtype=1, gr=1.0,
            visci=5640.0, inivel='log', is_wallturb=True,
            is_forced=(True, False, False), velf=(1.0, 0.0, 0.0),
            sgstype='none', impdiff=True, dtype='float64', ptransform='mat',
            cbcsgs=(('P', 'P', 'D'), ('P', 'P', 'D')))}[case])
    grid = make_grid_from_config(cfg)
    fields = initflow(cfg, grid)
    sims = [Simulation(cfg, grid, device=d) for d in (dev, 'cpu')]
    states = [s.initial_state(*fields) for s in sims]
    dt = sims[1].pick_dt(sims[1].check(states[1])[0])
    SK.reset_launches()
    for _ in range(3):
        states = [s.step(st, dt)[0] for s, st in zip(sims, states)]
    want = {'tgv_mat_thomas': dict(apply_y=18, thomas_periodic=9),
            'tgv_fft': {},
            'tgv_impdiff': dict(apply_y=72, z_eig=9, thomas_periodic=27),
            'channel_impdiff': dict(apply_y=72, z_eig=9, thomas_z=27)}[case]
    assert SK.LAUNCHES == {k: want.get(k, 0) for k in SK.LAUNCHES}
    g, c = states
    for name, tol in (('u', 1e-11), ('v', 1e-11), ('w', 1e-11), ('p', 1e-10)):
        a, b = getattr(g, name).cpu(), getattr(c, name)
        if name == 'p':
            a, b = a - a.mean(), b - b.mean()
        assert float((a - b).abs().max()) <= tol, name


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(256, 128, 512), (6, 10, 200)])
def test_cuda_apply_x_matches_twin_on_card(dev, shape):
    """apply_x against its twin at the slab shape of the 512x256x256
    channel on two ranks and at an odd shape (nx not a multiple of 128),
    f64 within 1e-12 and f32 within 1e-5 of the output's maximum, with the
    chunked layouts of the sharded solve (split output, chunked input)."""
    nz, ny, nx = shape
    gen = torch.Generator(device=dev).manual_seed(17)
    SK.reset_launches()
    for dtype, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        arr = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
        mxt = torch.randn((nx, nx), generator=gen, device=dev, dtype=dtype)
        ref = SK.apply_x_plain(arr, mxt)
        _rel_close(SK.apply_x(arr, mxt), ref, rtol)
        split = SK.apply_x(arr, mxt, split=2)
        _rel_close(split, SK.apply_x_plain(arr, mxt, split=2), rtol)
        _rel_close(SK.apply_x(split, mxt), SK.apply_x_plain(split, mxt),
                   rtol)
    torch.cuda.synchronize()
    assert SK.LAUNCHES['apply_x'] == 6


def _gemm_calls(arr, M, mxt, twin):
    """name -> the call of apply_y (with and without MxT) or apply_x
    (plain, split output, chunked input) on arr (nz, ny, nx), by the
    kernel's wrapper or (twin) by its plain version."""
    g = 2
    nz, ny, nx = arr.shape
    blocks = arr.reshape(nz, ny, g, nx // g).permute(2, 0, 1, 3).contiguous()
    ay = SK.apply_y_plain if twin else SK.apply_y
    ax = SK.apply_x_plain if twin else SK.apply_x
    return {'apply_y x+y': lambda: ay(arr, M, MxT=mxt),
            'apply_y y': lambda: ay(arr, M),
            'apply_x': lambda: ax(arr, mxt),
            'apply_x split': lambda: ax(arr, mxt, split=g),
            'apply_x chunked': lambda: ax(blocks, mxt)}


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(24, 40, 72), (6, 10, 200), (200, 10, 6),
                                   (7, 13, 42), (256, 128, 512)])
def test_cuda_f32_gemm_on_tensor_cores(dev, shape):
    """The GEMM of apply_y and apply_x (csrc/gemm.cuh: 3xTF32 on the tensor
    cores in float32, the SIMT FMA body in float64) on the channel's own
    operators, at (nz, ny, nx) shapes that fit no tile, one whose nx is not
    a multiple of 4 (no 16-byte copies: the same kernel copies 4 bytes at a
    time; the chunks of 21 columns too), and the y slab (256, 128, 512) of
    the 512x256x256 channel on two ranks.  float32: within 1e-5 of the
    output's maximum of the float32 twin, and against the float64 twin on
    the same float32 data no worse than 4x the float32 twin's own error
    against it (the twin is the library matmul, cuBLAS in full fp32);
    float64 within 1e-13 of its twin."""
    from cales_torch import poisson
    nz, ny, nx = shape
    cfg = Config(ng=(nx, ny, nz), l=(2 * np.pi, np.pi, 2.0), gtype=1,
                 gr=1.0, ptransform='mat')
    sv = poisson.make_solver(cfg, make_grid_from_config(cfg),
                             ('PP', 'PP', 'NN'), ('c', 'c', 'c'))
    x = np.random.default_rng(23).standard_normal(shape)

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)
    SK.reset_launches()
    data = {dt: (t(x, dt), t(sv.try_.fwd_mat, dt), t(sv.trx.fwd_mat.T, dt))
            for dt in (torch.float64, torch.float32)}
    kern64, twin64 = (_gemm_calls(*data[torch.float64], twin=w)
                      for w in (False, True))
    for name, call in kern64.items():
        _rel_close(call(), twin64[name](), 1e-13)
    kern32, twin32 = (_gemm_calls(*data[torch.float32], twin=w)
                      for w in (False, True))
    # the float64 twin on the float32 data
    exact = _gemm_calls(*(q.double() for q in data[torch.float32]), twin=True)
    for name, call in kern32.items():
        got, ref, r64 = call(), twin32[name](), exact[name]()
        _rel_close(got, ref, 1e-5)
        scale = float(r64.abs().max())
        err = float((got.double() - r64).abs().max()) / scale
        lib = float((ref.double() - r64).abs().max()) / scale
        assert err <= 4.0 * lib, (name, err, lib)
    torch.cuda.synchronize()
    assert SK.LAUNCHES == {'apply_y': 4, 'apply_x': 6, 'z_eig': 0,
                           'thomas_z': 0, 'thomas_periodic': 0}


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(24, 13, 42), (40, 10, 37), (200, 11, 30)])
def test_cuda_z_eig_on_tensor_cores(dev, shape):
    """z_eig (csrc/z_eig.cu: float32 as two 3xTF32 products of gemm.cuh,
    the first leaving through the inverse-eigenvalue epilogue; float64 the
    SIMT body) on the channel's own z operators and spectra, at (nz, ny,
    nx) shapes whose nz and ny nx fit no tile (37 x 10: no 16-byte copies
    or 8-byte stores), the singular lane (0, 0) zeroed at the solver's own
    bound.  float32: within 1e-5 of the output's maximum of the float32
    twin, and against the float64 twin on the same float32 data no worse
    than 4x the float32 twin's own error against it (the twin is two
    library matmuls in full fp32); float64 within 1e-13 of its twin."""
    from cales_torch import poisson
    nz, ny, nx = shape
    cfg = Config(ng=(nx, ny, nz), l=(2 * np.pi, np.pi, 2.0), gtype=1,
                 gr=1.0, ptransform='mat')
    sv = poisson.make_solver(cfg, make_grid_from_config(cfg),
                             ('PP', 'PP', 'NN'), ('c', 'c', 'c'))
    tol = poisson._eig_tol(sv, sv.lamx)
    # one singular mode, in lane (0, 0)
    lam = sv.lamz[:, None, None] + (sv.lamy[:, None] + sv.lamx[None, :])[None]
    zeroed = np.argwhere(np.abs(lam) <= tol)
    assert zeroed.shape[0] == 1 and tuple(zeroed[0, 1:]) == (0, 0), zeroed
    x = np.random.default_rng(24).standard_normal(shape)

    def args(dtype):
        return tuple(torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                     device=dev)
                     for a in (x, sv.zVl, sv.zVr, sv.lamz, sv.lamy, sv.lamx))
    SK.reset_launches()
    a64 = args(torch.float64)
    _rel_close(SK.z_eig(*a64, tol), SK.z_eig_plain(*a64, tol), 1e-13)
    a32 = args(torch.float32)
    got, ref = SK.z_eig(*a32, tol), SK.z_eig_plain(*a32, tol)
    r64 = SK.z_eig_plain(*(q.double() for q in a32), tol)
    _rel_close(got, ref, 1e-5)
    scale = float(r64.abs().max())
    err = float((got.double() - r64).abs().max()) / scale
    lib = float((ref.double() - r64).abs().max()) / scale
    assert err <= 4.0 * lib, (err, lib)
    torch.cuda.synchronize()
    assert SK.LAUNCHES == {'apply_y': 0, 'apply_x': 0, 'z_eig': 2,
                           'thomas_z': 0, 'thomas_periodic': 0}


@pytest.mark.cuda
@pytest.mark.parametrize('ywall', [False, True])
@pytest.mark.parametrize('dtype, shape', [
    ('float64', (40, 25, 9)), ('float64', (36, 37, 6)),
    ('float32', (40, 33, 9)), ('float32', (36, 37, 6))])
def test_cuda_dsmag_ragged_tiles(dev, ywall, dtype, shape):
    """The one-pass dsmag (its test filter shared across the plane, a
    tile of 16 rows in float32 and 8 in float64) against its twin, all
    three averages, on (nx, ny, nz) shapes whose nx is no multiple of 32
    and whose ny is no multiple of the tile's rows, with a tile that holds
    only the y rewrite row's neighbours (ny = 25 in float64, 33 in
    float32), with y walls and without.  float64 in the tolerances of the
    tests above (|S| or nu_t and the per-row sums 1e-12 of their maximum),
    float32 within 1e-5 of the output's maximum, as chip_smoke.py holds
    its kernels to their float32 twins."""
    nx, ny, nz = shape
    dt = getattr(torch, dtype)
    tol = 1e-12 if dt == torch.float64 else 1e-5

    def c(q):
        return q.to(dt).contiguous()
    if ywall:
        d = _ywall_inputs(dev, shape, 13)
        edges, dkw = d['zc'], dict(ye=[tuple(map(c, p)) for p in d['yc']],
                                   yvals=(0.2, 0.0, -0.1, 0.3))
    else:
        d = _sgs_inputs(dev, shape, 14)
        edges, dkw = d['edges'], {}
    a2 = np.full(nz, 4.0)
    a2[0] = a2[-1] = 2.52
    ds = (*map(c, d['fields']), *map(c, edges),
          c(torch.as_tensor(a2, device=dev)), c(d['dzci']), c(d['dzfi']),
          d['dxi'], d['dyi'], True, True, (0.0, 0.4, 0.0, -0.3))
    K.reset_launches()
    for avg in ('channel', 'duct', 'cavity'):
        s0, num, den = K.dsmag(*ds, avg=avg, **dkw)
        s0r, numr, denr = K.dsmag_plain(*ds, avg=avg, **dkw)
        _rel_close(s0, s0r, tol)
        if avg != 'cavity':
            _rel_close(num.sum(-1), numr[..., 0], tol)
            _rel_close(den.sum(-1), denr[..., 0], tol)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {'mom_rk': 0, 'fillps': 0, 'correc_smag': 0,
                          'correc_updatep': 0, 'smag': 0, 'dsmag': 3,
                          'dsmag_level1': 0, 'dsmag_level2': 0,
                          'wallmodel': 0}


@pytest.mark.cuda
@pytest.mark.parametrize('dtype, shape', [
    ('float64', (40, 25, 2)), ('float64', (36, 37, 3)),
    ('float64', (33, 17, 17)), ('float32', (40, 33, 2)),
    ('float32', (36, 37, 3)), ('float32', (33, 17, 17))])
def test_cuda_correc_smag_ragged_tiles(dev, dtype, shape):
    """correc_smag (a z-march over corrected planes in shared memory, a
    tile of 16 rows in float32 and 8 in float64) against its twin on
    (nx, ny, nz) shapes whose nx is no multiple of 32 and whose ny is no
    multiple of the tile's rows, with nz = 2, 3 and 17: both z-ghost recipe
    sets of the first test ('D' on both faces; 'N' and 'D' mixed), with and
    without z walls.  float64 within 1e-12 as there, float32 within 1e-5
    of each output's maximum, as chip_smoke.py holds its kernels to their
    float32 twins."""
    nx, ny, nz = shape
    dt = getattr(torch, dtype)
    cfg = Config(ng=shape, l=(2 * np.pi, np.pi, 2.0), gtype=1, gr=1.0,
                 visci=1000.0, dtype='float64')
    grid = make_grid_from_config(cfg)
    rng = np.random.default_rng(10)

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64),
                               device=dev).to(dt)
    F = lambda: t(0.05 * rng.standard_normal((nz, ny, nx)))   # noqa: E731
    E = lambda: t(0.05 * rng.standard_normal((3, ny, nx)))    # noqa: E731
    u, v, w, pp, p = (F() for _ in range(5))
    ue, ve, we, ppe = (E() for _ in range(4))
    tauw = [t(np.abs(rng.standard_normal((ny, nx)))) for _ in range(2)]
    dz01 = (float(grid.dzc[0]), float(grid.dzc[nz]))
    zc = grid.zc[1:nz + 1]
    K.reset_launches()
    for zrec in ((('D', 0.0, dz01[0], 'D', 0.0, dz01[1]),) * 2,
                 (('N', 0.3, dz01[0], 'N', -0.2, dz01[1]),
                  ('D', 0.1, dz01[0], 'N', 0.05, dz01[1]))):
        cs = (u, v, w, pp, p, ue, ve, we, ppe, 3.7e-3, cfg.dli[0],
              cfg.dli[1], t(grid.dzci), t(grid.dzfi), cfg.visc,
              t(np.full(nz, 1e-4)), zrec, t([0.05, -0.02]),
              t(np.minimum(zc, 2.0 - zc)), t((zc <= 1.0).astype(float)),
              *tauw)
        for zwalls in (True, False):
            got = K.correc_smag(*cs, have_zwalls=zwalls)
            ref = K.correc_smag_plain(*cs, have_zwalls=zwalls)
            for g, r in zip(got, ref):
                if dt == torch.float64:
                    torch.testing.assert_close(g, r, rtol=0, atol=1e-12)
                else:
                    _rel_close(g, r, 1e-5)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {'mom_rk': 0, 'fillps': 0, 'correc_smag': 4,
                          'correc_updatep': 0, 'smag': 0, 'dsmag': 0,
                          'dsmag_level1': 0, 'dsmag_level2': 0,
                          'wallmodel': 0}


@pytest.mark.cuda
@pytest.mark.parametrize('ywall', [False, True])
@pytest.mark.parametrize('dtype, shape', [
    ('float64', (40, 25, 9)), ('float64', (36, 37, 2)),
    ('float32', (40, 33, 9)), ('float32', (36, 37, 3))])
def test_cuda_dsmag_level1_ragged_tiles(dev, ywall, dtype, shape):
    """dsmag_level1 (dsmag's z-march and shared test filter, a tile of 16
    rows in float32 and 8 in float64) against its twin on (nx, ny, nz)
    shapes whose nx is no multiple of 32 and whose ny is no multiple of the
    tile's rows, with a tile that holds only the y rewrite row's neighbours
    (ny = 25 in float64, 33 in float32), nz down to 2, with y walls and
    without, and with z walls on both faces, one or none (A's and the
    filtered velocity's z ghosts extrapolated or copied).  All 16 fields,
    float64 within 1e-12 of each field's maximum as the two-pass test
    above, float32 within 1e-5."""
    nx, ny, nz = shape
    dt = getattr(torch, dtype)
    tol = 1e-12 if dt == torch.float64 else 1e-5

    def c(q):
        return q.to(dt).contiguous()
    if ywall:
        d = _ywall_inputs(dev, shape, 13)
        edges, ye = d['zc'], [tuple(map(c, q)) for q in d['yc']]
    else:
        d = _sgs_inputs(dev, shape, 14)
        edges, ye = d['edges'], None
    l1 = (*map(c, d['fields']), *map(c, edges), c(d['dzci']), c(d['dzfi']),
          d['dxi'], d['dyi'])
    K.reset_launches()
    for walls in ((True, True), (True, False), (False, False)):
        got = K.dsmag_level1(*l1, *walls, ye=ye)
        ref = K.dsmag_level1_plain(*l1, *walls, ye=ye)
        for g, r in zip((*got[0], *got[1], *got[2], got[3]),
                        (*ref[0], *ref[1], *ref[2], ref[3])):
            _rel_close(g, r, tol)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {'mom_rk': 0, 'fillps': 0, 'correc_smag': 0,
                          'correc_updatep': 0, 'smag': 0, 'dsmag': 0,
                          'dsmag_level1': 3, 'dsmag_level2': 0,
                          'wallmodel': 0}


@pytest.mark.cuda
def test_cuda_halo_kernels_match_twins_on_card(dev):
    """The slab (halo) variants of mom_rk, fillps, correc_updatep and smag
    against their twins on random halo rows and corners, f64 within
    1e-12."""
    ng = (72, 12, 24)     # (nx, ny, nz): a slab of 12 rows
    nx, ny, nz = ng
    cfg = Config(ng=ng, l=(2 * np.pi, np.pi, 2.0), gtype=1, gr=1.0,
                 visci=1000.0, dtype='float64')
    grid = make_grid_from_config(cfg)
    rng = np.random.default_rng(21)

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev)
    F = lambda: t(0.05 * rng.standard_normal((nz, ny, nx)))   # noqa: E731
    E = lambda: t(0.05 * rng.standard_normal((3, ny, nx)))    # noqa: E731
    H = lambda: (t(0.05 * rng.standard_normal((nz, 2, nx))),  # noqa: E731
                 t(0.05 * rng.standard_normal((3, 2, nx))))
    u, v, w, s, p, pp, ruo, rvo, rwo = (F() for _ in range(9))
    s = s.abs()
    ue, ve, we, se, pe, ppe = (E() for _ in range(6))
    yh = tuple(H() for _ in range(5))
    dxi, dyi = cfg.dli[0], cfg.dli[1]
    dzci, dzfi = t(grid.dzci), t(grid.dzfi)
    K.reset_launches()
    for sgs in (True, False):
        mom = (u, v, w, s if sgs else None, p, ue, ve, we,
               se if sgs else None, pe, ruo, rvo, rwo, dzci, dzfi, 5e-4,
               -2e-4, cfg.visc, dxi, dyi, (0.1, 0.0, 0.0))
        h = yh if sgs else (*yh[:3], None, yh[4])
        got = K.mom_rk(*mom, sums=(True, False), yh=h)
        ref = K.mom_rk_plain(*mom, sums=(True, False), yh=h)
        for g, r in zip(got[:6], ref[:6]):
            torch.testing.assert_close(g, r, rtol=0, atol=1e-12)
        torch.testing.assert_close(got[6].sum(1), ref[6][:, 0], rtol=0,
                                   atol=1e-12)
    fp = (u, v, w, ue, ve, we, dzfi, 20.0, dxi, dyi)
    torch.testing.assert_close(K.fillps(*fp, yh=yh[1]),
                               K.fillps_plain(*fp, yh=yh[1]), rtol=0,
                               atol=1e-12)
    cu = (u, v, w, pp, p, we, ppe, 3.7e-3, dxi, dyi, dzci, dzfi,
          t([0.05, -0.02]))
    for g, r in zip(K.correc_updatep(*cu, yh=yh[4]),
                    K.correc_updatep_plain(*cu, yh=yh[4])):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-12)
    zc = grid.zc[1:nz + 1]
    sm = (u, v, w, ue, ve, we, dzci, dzfi, dxi, dyi, cfg.visc,
          t(np.full(nz, 1e-4)), t(np.minimum(zc, 2.0 - zc)),
          t((zc <= 1.0).astype(float)), s[0].contiguous(),
          s[1].contiguous())
    torch.testing.assert_close(K.smag(*sm, yh=yh[:3]),
                               K.smag_plain(*sm, yh=yh[:3]), rtol=0,
                               atol=1e-12)
    torch.cuda.synchronize()
    assert (K.LAUNCHES['mom_rk'], K.LAUNCHES['fillps'],
            K.LAUNCHES['correc_updatep'], K.LAUNCHES['smag']) == (2, 1, 1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize('ymode', ['periodic', 'walls', 'halo'])
@pytest.mark.parametrize('dtype, shape', [
    ('float64', (72, 40, 48)), ('float64', (33, 17, 5)),
    ('float32', (72, 40, 48)), ('float32', (33, 17, 5))])
def test_cuda_mom_rk_ragged_tiles(dev, ymode, dtype, shape):
    """mom_rk (a z-march through shared memory, a tile of 8 x 32 cells)
    against its twin on (nx, ny, nz) shapes whose nx is no multiple of 32
    and whose ny is no multiple of the tile's rows, in each y mode (the
    y-walled variant with its y-row stacks, the slab's with random halos),
    with and without visct, with split None, '1d' and 'xy+z', with the
    previous RHS and without it (the first substep): the six fields
    float64 within 1e-12 of their maximum and float32 within 1e-5, as
    chip_smoke.py holds its kernels to their float32 twins, and the
    per-plane totals of the partial sums within 1e-11 in float64 (1e-5 of
    their maximum in float32): the kernel sums per (z, tile), the twin per
    plane."""
    nx, ny, nz = shape
    dt = getattr(torch, dtype)
    tol = 1e-12 if dt == torch.float64 else 1e-5
    d = _ywall_inputs(dev, shape, 15)
    rng = np.random.default_rng(16)

    def c(q):
        return None if q is None else q.to(dt).contiguous()

    def halo():
        return tuple(c(torch.as_tensor(0.05 * rng.standard_normal(sh),
                                       device=dev)) for sh in
                     ((nz, 2, nx), (3, 2, nx)))
    yh = [halo() for _ in range(5)]
    K.reset_launches()
    n = 0
    for sgs in (True, False):
        se, ys = d['sq'] if sgs else (None, None)
        stacks = (*d['yc'], ys, d['pq'][1])
        ykw = {'walls': dict(ye=[None if q is None else tuple(map(c, q))
                                 for q in stacks]),
               'halo': dict(yh=yh if sgs else [*yh[:3], None, yh[4]]),
               'periodic': {}}[ymode]
        for split in (None, '1d', 'xy+z'):
            for rk in (d['rk'], (None,) * 3):
                mom = (*map(c, d['fields']), c(d['s']) if sgs else None,
                       c(d['p']), *map(c, d['zc']), c(se), c(d['pq'][0]),
                       *map(c, rk), c(d['dzci']), c(d['dzfi']), 5e-4,
                       -2e-4 if rk[0] is not None else 0.0, 1e-3, d['dxi'],
                       d['dyi'], (0.1, 0.0, 0.0))
                got = K.mom_rk(*mom, sums=(True, True), split=split, **ykw)
                ref = K.mom_rk_plain(*mom, sums=(True, True), split=split,
                                     **ykw)
                n += 1
                for g, r in zip(got[:6], ref[:6]):
                    _rel_close(g, r, tol)
                for g, r in zip(got[6:], ref[6:]):
                    if dt == torch.float64:
                        torch.testing.assert_close(g.sum(1), r[:, 0], rtol=0,
                                                   atol=1e-11)
                    else:
                        _rel_close(g.sum(1), r[:, 0], 1e-5)
    torch.cuda.synchronize()
    assert K.LAUNCHES['mom_rk'] == n == 12


@pytest.mark.cuda
@pytest.mark.parametrize('variant', ['poisson', 'helmholtz'])
@pytest.mark.parametrize('dtype', ['float64', 'float32'])
@pytest.mark.parametrize('nz', [3, 4, 7, 256, 512])
def test_cuda_thomas_periodic_columns(dev, nz, dtype, variant):
    """thomas_periodic (a column a warp, solved in shared memory: chunks
    of at least 7 rows a lane, the chunk ends by cyclic reduction) on
    (nx, ny) = (40, 5) columns, pinned on the singular lane (its last row
    exactly 0) or on the alpha-scaled Helmholtz rows, against both twins:
    the sweep (solve_kernels.thomas_periodic_z_plain) and the kernel's
    scheme step by step (tridiag.thomas_periodic_chunked).  float64 within
    1e-12 of the maximum of each; float32 against the float64 sweep within
    4x the larger error of the two float32 twins against it."""
    from cales_torch import poisson
    from cales_torch.ops import tridiag
    nx, ny = 40, 5
    dt = getattr(torch, dtype)
    cfg = Config(ng=(nx, ny, nz), l=(2 * np.pi,) * 3, gtype=1, gr=0.0,
                 dtype='float64', ptransform='mat')
    sv = poisson.make_solver(cfg, make_grid_from_config(cfg),
                             ('PP', 'PP', 'PP'), ('c', 'c', 'c'))
    rng = np.random.default_rng(nz)

    def t(a, to=dt):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=to,
                               device=dev)
    abc = tuple(t(q, torch.float64) for q in (sv.a, sv.b, sv.c))
    alpha = -0.043

    def args(to):
        if variant == 'poisson':
            tol = float(np.finfo(np.dtype(dtype)).eps * 4.0
                        * (np.abs(sv.lamx).max() + np.abs(sv.lamy).max()))
            return dict(lamy=t(sv.lamy, to), lamx=t(sv.lamx, to), pin=True,
                        tol=tol)
        return dict(lamy=t(sv.lamy * alpha, to), lamx=t(sv.lamx * alpha, to),
                    alpha=alpha)

    def chunked(x, kw):
        a, b, c = SK._coefs(*abc, kw.get('alpha'), x.dtype)
        lam = kw['lamx'][None, :] + kw['lamy'][:, None]
        return tridiag.thomas_periodic_chunked(
            a, b, c, x, lam=lam, pin_tol=kw['tol'] if kw.get('pin') else None)
    x = t(rng.standard_normal((nz, ny, nx)))
    kw = args(dt)
    SK.reset_launches()
    got = SK.thomas_periodic_z(x, *abc, **kw)
    torch.cuda.synchronize()
    assert SK.LAUNCHES['thomas_periodic'] == 1
    if variant == 'poisson':
        assert float(got[-1, 0, 0]) == 0.0       # the pinned gauge
    if dt == torch.float64:
        _rel_close(got, SK.thomas_periodic_z_plain(x, *abc, **kw), 1e-12)
        _rel_close(got, chunked(x, kw), 1e-12)
        return
    kw64 = args(torch.float64)
    ref = SK.thomas_periodic_z_plain(x.double(), *abc, **kw64)

    def rel(q):
        return float((q.double() - ref).abs().max() / ref.abs().max())
    twins = rel(SK.thomas_periodic_z_plain(x, *abc, **kw)), rel(chunked(x, kw))
    assert rel(got) <= 4.0 * max(twins), (rel(got), twins)


def _thomas_z_chunked(x, a, b, c, lamy=None, lamx=None, pin=False, tol=0.0,
                      alpha=None, shift=None, bc_lo=None, bc_hi=None,
                      n_solve=None):
    """thomas_z's plain version with the kernel's scheme step by step
    (tridiag.thomas_chunked) in place of the sweep."""
    from cales_torch.ops import tridiag
    nz = x.shape[0]
    ns = nz if n_solve is None else n_solve
    a, b, c = SK._coefs(a[:ns], b[:ns], c[:ns], alpha, x.dtype)
    rhs = x[:ns] if shift is None else x[:ns] + shift
    if bc_lo is not None:
        rhs = torch.cat([(rhs[0] + bc_lo)[None], rhs[1:ns - 1],
                         (rhs[ns - 1] + bc_hi)[None]])
    lam = None if lamy is None else lamx[None, :] + lamy[:, None]
    sol = tridiag.thomas_chunked(a, b, c, rhs, lam=lam,
                                 pin_tol=tol if pin and lam is not None
                                 else None)
    tail = x[ns:] if shift is None else x[ns:] + shift
    return torch.cat([sol, tail])


@pytest.mark.cuda
@pytest.mark.parametrize('variant', ['poisson', 'helmholtz', 'lam_alpha',
                                     'slab'])
@pytest.mark.parametrize('dtype', ['float64', 'float32'])
@pytest.mark.parametrize('nz', [3, 4, 7, 256, 512])
def test_cuda_thomas_z_columns(dev, nz, dtype, variant):
    """thomas_z (a column a warp, solved in shared memory: chunks of at
    least 7 rows a lane, the chunk ends by cyclic reduction) on (nx, ny) =
    (40, 5) columns of a stretched channel: the pressure rows with lam on
    the diagonal, pinned on the singular lane (its row 0 exactly 0); w's
    alpha-scaled rows with a shift, boundary planes and the tail row
    passed through shifted; w's rows with the lam alpha shift and the tail
    row (full-3D implicit diffusion); the pressure rows pinned on the
    second half of lamx, a rank's slab of 20 columns.  Against both twins,
    the sweep (solve_kernels.thomas_z_plain) and the kernel's scheme step
    by step (tridiag.thomas_chunked): float64 within 1e-12 of the maximum
    of each; float32 against the float64 sweep within 4x the larger error
    of the two float32 twins against it."""
    from cales_torch import poisson
    nx, ny = 40, 5
    dt = getattr(torch, dtype)
    cfg = Config(ng=(nx, ny, nz), l=(2 * np.pi, np.pi, 2.0), gtype=1,
                 gr=1.0, dtype='float64', ptransform='mat')
    grid = make_grid_from_config(cfg)
    svp = poisson.make_solver(cfg, grid, ('PP', 'PP', 'NN'), ('c', 'c', 'c'))
    svw = poisson.make_solver(cfg, grid, ('PP', 'PP', 'DD'), ('c', 'c', 'f'))
    rng = np.random.default_rng(nz)

    def t(a, to=dt):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=to,
                               device=dev)
    sv = svp if variant in ('poisson', 'slab') else svw
    abc = tuple(t(q, torch.float64) for q in (sv.a, sv.b, sv.c))
    alpha = -0.043
    xs = 20 if variant == 'slab' else 0
    x = t(rng.standard_normal((nz, ny, nx - xs)))
    bcs = rng.standard_normal((2, ny, nx))

    def args(to):
        eps = np.finfo(np.dtype(dtype)).eps
        if variant in ('poisson', 'slab'):
            tol = float(eps * 4.0 * (np.abs(sv.lamx).max()
                                     + np.abs(sv.lamy).max()))
            return dict(lamy=t(sv.lamy, to), lamx=t(sv.lamx[xs:], to),
                        pin=True, tol=tol)
        if variant == 'helmholtz':
            return dict(alpha=-0.021, shift=t([0.0173], to),
                        bc_lo=t(bcs[0], to), bc_hi=t(bcs[1], to),
                        n_solve=nz - 1)
        return dict(lamy=t(sv.lamy * alpha, to),
                    lamx=t(sv.lamx * alpha, to), alpha=alpha,
                    n_solve=nz - 1)
    kw = args(dt)
    SK.reset_launches()
    got = SK.thomas_z(x, *abc, **kw)
    torch.cuda.synchronize()
    assert SK.LAUNCHES['thomas_z'] == 1
    if variant == 'poisson':
        assert float(got[0, 0, 0]) == 0.0       # the pinned gauge
    if dt == torch.float64:
        _rel_close(got, SK.thomas_z_plain(x, *abc, **kw), 1e-12)
        _rel_close(got, _thomas_z_chunked(x, *abc, **kw), 1e-12)
        return
    ref = SK.thomas_z_plain(x.double(), *abc, **args(torch.float64))

    def rel(q):
        return float((q.double() - ref).abs().max() / ref.abs().max())
    twins = (rel(SK.thomas_z_plain(x, *abc, **kw)),
             rel(_thomas_z_chunked(x, *abc, **kw)))
    assert rel(got) <= 4.0 * max(twins), (rel(got), twins)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float64', 'float32'])
def test_cuda_thomas_z_raises_past_its_nz_limit(dev, dtype):
    """A column is solved in shared memory: past THOMAS_Z_MAX_NZ the
    wrapper raises (and launches nothing); at the limit it solves."""
    dt = getattr(torch, dtype)
    nz_max = SK.THOMAS_Z_MAX_NZ[dt]
    SK.reset_launches()
    for nz in (nz_max, nz_max + 1):
        x = torch.ones((nz, 1, 32), dtype=dt, device=dev)
        abc = (torch.ones(nz, dtype=torch.float64, device=dev),
               torch.full((nz,), -4.0, dtype=torch.float64, device=dev),
               torch.ones(nz, dtype=torch.float64, device=dev))
        if nz > nz_max:
            with pytest.raises(ValueError, match='at most'):
                SK.thomas_z(x, *abc)
        else:
            got = SK.thomas_z(x, *abc)
            _rel_close(got, SK.thomas_z_plain(x, *abc),
                       1e-12 if dt == torch.float64 else 1e-5)
    torch.cuda.synchronize()
    assert SK.LAUNCHES['thomas_z'] == 1


@pytest.mark.cuda
@pytest.mark.parametrize('ymode', ['periodic', 'halo'])
@pytest.mark.parametrize('dtype, shape', [
    ('float64', (72, 40, 48)), ('float64', (33, 17, 5)),
    ('float64', (40, 9, 70)), ('float32', (72, 40, 48)),
    ('float32', (33, 17, 5)), ('float32', (40, 9, 70))])
def test_cuda_smag_ragged_tiles(dev, ymode, dtype, shape):
    """smag (a z-march through shared memory, a tile of 16 x 32 cells in
    float32 and 8 x 32 in float64, z cut into chunks of at least 16 planes
    where the tiles are few) against its twin on (nx, ny, nz) shapes whose
    nx is no multiple of 32 and whose ny is no multiple of the tile's rows:
    three chunks of 16 planes at nz = 48, one at nz = 5, and four of 18
    with a ragged last one at nz = 70; periodic in y or on a slab with
    random halos, with and without z walls: float64 within 1e-12 of nu_t's
    maximum, float32 within 1e-5, as chip_smoke.py holds its kernels to
    their float32 twins."""
    nx, ny, nz = shape
    dt = getattr(torch, dtype)
    cfg = Config(ng=shape, l=(2 * np.pi, np.pi, 2.0), gtype=1, gr=1.0,
                 visci=1000.0, dtype='float64')
    grid = make_grid_from_config(cfg)
    rng = np.random.default_rng(17)

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64),
                               device=dev).to(dt)
    u, v, w = (t(0.05 * rng.standard_normal((nz, ny, nx))) for _ in range(3))
    ue, ve, we = (t(0.05 * rng.standard_normal((3, ny, nx)))
                  for _ in range(3))
    yh = None
    if ymode == 'halo':
        yh = [tuple(t(0.05 * rng.standard_normal(sh))
                    for sh in ((nz, 2, nx), (3, 2, nx))) for _ in range(3)]
    zc = grid.zc[1:nz + 1]
    tauw = [t(np.abs(rng.standard_normal((ny, nx)))) for _ in range(2)]
    args = (u, v, w, ue, ve, we, t(grid.dzci), t(grid.dzfi), cfg.dli[0],
            cfg.dli[1], cfg.visc, t(1e-4 * (1.0 + rng.random(nz))),
            t(np.minimum(zc, 2.0 - zc)), t((zc <= 1.0).astype(float)), *tauw)
    tol = 1e-12 if dt == torch.float64 else 1e-5
    K.reset_launches()
    for zwalls in (True, False):
        got = K.smag(*args, have_zwalls=zwalls, yh=yh)
        ref = K.smag_plain(*args, have_zwalls=zwalls, yh=yh)
        _rel_close(got, ref, tol)
    torch.cuda.synchronize()
    assert K.LAUNCHES['smag'] == 2


# bench.py's wmles_channel at a test size
WMLES = dict(ng=(32, 16, 16), l=(2 * np.pi, np.pi, 2.0), gtype=1, gr=1.0,
             inivel='log', is_wallturb=True, is_forced=(True, False, False),
             velf=(1.0, 0.0, 0.0), dtype='float64', ptransform='mat',
             visci=125_000.0, sgstype='smag', lwm=((0, 0, 1), (0, 0, 1)),
             hwm=0.1)


@pytest.mark.cuda
@pytest.mark.parametrize('rows', ['bulk', 'near 0', 'mixed'])
@pytest.mark.parametrize('lwm', [((0, 0, 1), (0, 0, 1)),
                                 ((0, 0, 0), (0, 0, -1))])
@pytest.mark.parametrize('dtype, shape', [
    ('float64', (40, 25, 12)), ('float64', (33, 17, 16)),
    ('float32', (40, 25, 12)), ('float32', (33, 17, 16))])
def test_cuda_wallmodel_matches_twin(dev, dtype, shape, lwm, rows):
    """The wall-model kernel against wallmodel.wm_planes_plain (12 fixed
    Newton steps) in its two modes (the rows as they are, corrected by
    pp), one face or both, on (nx, ny, nz) shapes no block fits: float64
    within 1e-13 of each plane's maximum, float32 within 1e-5.  Rows:
    'bulk' a bulk flow with moving wall values; 'near 0' |u_par| from 0
    to below the floor's scale (u_tau starts at its floor), still walls;
    'mixed' |u_par| from 1e-8 to past Re_h = 1e6 drawn point by point,
    so each warp's lanes converge at different steps and some not in 12."""
    from cales_torch import wallmodel as wmod
    nx, ny, nz = shape
    dt = getattr(torch, dtype)
    still = rows == 'near 0'
    umag, vmag = ((0.0, 0.0),) * 2 if still else ((0.03, -0.01),
                                                  (-0.02, 0.04))
    bcvel = (((0.0,) * 3, (0.0,) * 3, (umag[0], vmag[0], 0.0)),
             ((0.0,) * 3, (0.0,) * 3, (umag[1], vmag[1], 0.0)))
    cfg = Config(**dict(WMLES, ng=shape, lwm=lwm, bcvel=bcvel))
    grid = make_grid_from_config(cfg)
    wm = wmod.z_wall_model(cfg, grid, wmod.find_index_wm(cfg, grid), umag,
                           vmag)
    rng = np.random.default_rng(21)

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64),
                               device=dev).to(dt)

    def field(lo, hi):
        # magnitudes 10^[lo, hi) point by point, random signs
        return t(rng.choice((-1.0, 1.0), (nz, ny, nx))
                 * 10.0 ** rng.uniform(lo, hi, (nz, ny, nx)))
    if rows == 'bulk':
        u, v, pp = (t(0.3 * rng.standard_normal((nz, ny, nx)))
                    for _ in range(3))
        u = u + 1.0
        fuv = t([0.013, -0.007])
    elif rows == 'near 0':
        u, v = field(-16, -5), field(-16, -5)
        u[:, ::3] = 0.0
        v[:, ::3] = 0.0
        pp = field(-16, -12)
        fuv = t([0.0, 0.0])
    else:
        u, v, pp = field(-8, 2.7), field(-8, 2.7), field(-6, -2)
        fuv = t([0.013, -0.007])
    K.reset_launches()
    for kw in ({}, dict(fuv=fuv, pp=pp, dtrk=2.3e-3, dxi=cfg.dli[0],
                    dyi=cfg.dli[1])):
        got = K.wm_planes(u, v, wm, **kw)
        ref = wmod.wm_planes_plain(u, v, wm, **kw)
        assert len(got) == len(ref) == len(wm.faces)
        for gf, rf in zip(got, ref):
            assert gf.shape == rf.shape == (2, ny + 2, nx + 2)
            for g, r in zip(gf, rf):
                _rel_close(g, r, 1e-13 if dt == torch.float64 else 1e-5)
    torch.cuda.synchronize()
    assert K.LAUNCHES['wallmodel'] == 2
    assert sum(K.LAUNCHES.values()) == 2


# the duct WMLES (examples/turbulent_duct_wmles) at a test size: the
# log-law wall model on all four side walls, static Smagorinsky
DUCT_WMLES = dict(ng=(32, 16, 16), l=(12.8, 2.0, 2.0), gtype=1, gr=0.0,
                  visci=20_000.0, inivel='duc', is_wallturb=True,
                  is_forced=(True, False, False), velf=(1.0, 0.0, 0.0),
                  dtype='float64', ptransform='mat', sgstype='smag',
                  lwm=((0, 1, 1), (0, 1, 1)), hwm=0.1, **DUCT_BCS)


@pytest.mark.cuda
@pytest.mark.parametrize('rows', ['bulk', 'mixed'])
@pytest.mark.parametrize('lwm', [((0, 1, 1), (0, 1, 1)),
                                 ((0, -1, 1), (0, 1, 0))])
@pytest.mark.parametrize('dtype, shape', [
    ('float64', (40, 25, 12)), ('float64', (33, 17, 20)),
    ('float32', (40, 25, 12)), ('float32', (33, 17, 20))])
def test_cuda_wallmodel_y_faces_match_twin(dev, dtype, shape, lwm, rows):
    """The wall-model kernel with y faces (the duct WMLES: up to four
    faces in one launch, the y faces' rows of u and w filled along z by
    the static recipes, the z faces' rows along y by theirs, not
    wrapped) against wallmodel.wm_planes_plain, moving wall values on
    every face, on (nx, ny, nz) shapes with ny != nz that no block fits:
    float64 within 1e-13 of each plane's maximum, float32 within 1e-5.
    Rows 'bulk' a bulk flow; 'mixed' |u_par| from 1e-8 to past Re_h =
    1e6 point by point."""
    from cales_torch import wallmodel as wmod
    from cales_torch.config import effective_cbcvel
    from cales_torch.ops import boundary as bnd
    nx, ny, nz = shape
    dt = getattr(torch, dtype)
    bcvel = (((0.0,) * 3, (0.03, 0.0, -0.02), (0.01, 0.02, 0.0)),
             ((0.0,) * 3, (-0.01, 0.0, 0.04), (0.05, -0.03, 0.0)))
    cfg = Config(**dict(DUCT_WMLES, l=(2 * np.pi, 2.0, 2.0), gr=1.0,
                        ng=shape, lwm=lwm, bcvel=bcvel))
    grid = make_grid_from_config(cfg)
    bcs = [bnd.make_bc_values(cfg.ng, tuple(
        tuple(bcvel[ib][d][iv] for ib in range(2)) for d in range(3)), dt)
        for iv in range(3)]
    wm = wmod.wall_model(cfg, grid, wmod.find_index_wm(cfg, grid), bcs,
                         effective_cbcvel(cfg))
    assert {f.d for f in wm.faces} == {1, 2}
    rng = np.random.default_rng(23)

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64),
                               device=dev).to(dt)

    def field(lo, hi):
        return t(rng.choice((-1.0, 1.0), (nz, ny, nx))
                 * 10.0 ** rng.uniform(lo, hi, (nz, ny, nx)))
    if rows == 'bulk':
        u, v, w = (t(0.3 * rng.standard_normal((nz, ny, nx)))
                   for _ in range(3))
        u = u + 1.0
    else:
        u, v, w = field(-8, 2.7), field(-8, 2.7), field(-8, 2.7)
    K.reset_launches()
    got = K.wm_planes(u, v, wm, w=w)
    ref = wmod.wm_planes_plain(u, v, wm, w=w)
    torch.cuda.synchronize()
    assert K.LAUNCHES['wallmodel'] == 1
    assert len(got) == len(ref) == len(wm.faces)
    for face, gf, rf in zip(wm.faces, got, ref):
        n = nz if face.d == 1 else ny
        assert gf.shape == rf.shape == (2, n + 2, nx + 2)
        for g, r in zip(gf, rf):
            _rel_close(g, r, 1e-13 if dt == torch.float64 else 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize('wm', ['none', 'E'])
@pytest.mark.parametrize('dtype, shape', [
    ('float64', (40, 25, 17)), ('float64', (33, 9, 40)),
    ('float32', (40, 25, 17)), ('float32', (33, 17, 40))])
def test_cuda_smag_ywalls_matches_twin(dev, dtype, shape, wm):
    """smag's y-wall variant (the y-row stacks read as a plane is loaded,
    van Driest over the nearest of four walls) against the twin on ragged
    tiles and z chunks, the post-correction fill's stacks as they are
    ('none') or extrapolated on all four faces ('E', sgs.extrapolate_
    stacks): float64 within 1e-12, float32 within 1e-5 of nu_t's
    maximum."""
    from cales_torch import sgs as sgsmod
    nx, ny, nz = shape
    dt = getattr(torch, dtype)
    d = _ywall_inputs(dev, shape, 31)
    u, v, w = d['fields']
    zq, yq = d['zc'], d['yc']
    if wm == 'E':
        flags = {(ib, dd): dd > 0 for ib in range(2) for dd in range(3)}
        grid = d['grid']
        fac = (grid.dzc[0] * grid.dzci[1], grid.dzc[nz] * grid.dzci[nz - 1])
        ext = [sgsmod.extrapolate_stacks(q, e, y, iface, flags, fac)
               for q, e, y, iface in zip((u, v, w), zq, yq, (1, 2, 3))]
        zq, yq = [e for e, _ in ext], [y for _, y in ext]
    rng = np.random.default_rng(5)

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64),
                               device=dev).to(dt).contiguous()
    zc = d['grid'].zc[1:nz + 1]
    yc = (np.arange(ny) + 0.5) * d['cfg'].dl[1]
    c = lambda q: q.to(dt).contiguous()   # noqa: E731
    args = (*(c(q) for q in (u, v, w)), *(c(q) for q in zq), c(d['dzci']),
            c(d['dzfi']), d['dxi'], d['dyi'], 1e-4,
            t(np.full(nz, 2e-4)), t(np.minimum(zc, 2.0 - zc)),
            t((zc <= 1.0).astype(float)),
            *(t(np.abs(rng.standard_normal((ny, nx)))) for _ in range(2)))
    kw = dict(ye=[(c(r), c(q)) for r, q in yq],
              ywall=(t(np.minimum(yc, 2.0 - yc)),
                     t((yc <= 1.0).astype(float)),
                     *(t(np.abs(rng.standard_normal((nz, nx))))
                       for _ in range(2))))
    K.reset_launches()
    got = K.smag(*args, **kw)
    ref = K.smag_plain(*args, **kw)
    torch.cuda.synchronize()
    assert K.LAUNCHES['smag'] == 1
    if dt == torch.float64:
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-12)
    else:
        _rel_close(got, ref, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype, shape', [
    ('float64', (40, 25, 2)), ('float64', (33, 17, 17)),
    ('float32', (40, 33, 2)), ('float32', (33, 17, 17))])
def test_cuda_correc_smag_e_recipe_ragged_tiles(dev, dtype, shape):
    """correc_smag's 'E' z-ghost recipe (the wall model's one-sided
    extrapolation from the corrected boundary plane and the next-inner one)
    on both faces and on the lower face beside a 'D' upper face, against
    the twin on ragged tiles with nz = 2 and 17: float64 within 1e-12,
    float32 within 1e-5 of each output's maximum."""
    nx, ny, nz = shape
    dt = getattr(torch, dtype)
    cfg = Config(ng=shape, l=(2 * np.pi, np.pi, 2.0), gtype=1, gr=1.0,
                 visci=1000.0, dtype='float64')
    grid = make_grid_from_config(cfg)
    rng = np.random.default_rng(12)

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64),
                               device=dev).to(dt)
    F = lambda: t(0.05 * rng.standard_normal((nz, ny, nx)))   # noqa: E731
    E = lambda: t(0.05 * rng.standard_normal((3, ny, nx)))    # noqa: E731
    u, v, w, pp, p = (F() for _ in range(5))
    ue, ve, we, ppe = (E() for _ in range(4))
    tauw = [t(np.abs(rng.standard_normal((ny, nx)))) for _ in range(2)]
    dz01 = (float(grid.dzc[0]), float(grid.dzc[nz]))
    fac = (float(grid.dzc[0] * grid.dzci[1]),
           float(grid.dzc[nz] * grid.dzci[nz - 1]))
    zc = grid.zc[1:nz + 1]
    K.reset_launches()
    for zrec in ((('E', fac[0], 0.0, 'E', fac[1], 0.0),) * 2,
                 (('E', fac[0], 0.0, 'D', 0.0, dz01[1]),
                  ('E', fac[0], 0.0, 'D', 0.05, dz01[1]))):
        cs = (u, v, w, pp, p, ue, ve, we, ppe, 3.7e-3, cfg.dli[0],
              cfg.dli[1], t(grid.dzci), t(grid.dzfi), cfg.visc,
              t(np.full(nz, 1e-4)), zrec, t([0.05, -0.02]),
              t(np.minimum(zc, 2.0 - zc)), t((zc <= 1.0).astype(float)),
              *tauw)
        got = K.correc_smag(*cs)
        ref = K.correc_smag_plain(*cs)
        for g, r in zip(got, ref):
            if dt == torch.float64:
                torch.testing.assert_close(g, r, rtol=0, atol=1e-12)
            else:
                _rel_close(g, r, 1e-5)
    torch.cuda.synchronize()
    assert K.LAUNCHES['correc_smag'] == 2


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_cuda_prediction_fill_uv_ghosts_are_not_read(dev, dtype):
    """Why the port runs no wall model on the prediction fill: the fillps
    and correc_smag kernels give bitwise the same outputs whatever the
    prediction fill's u and v z ghost rows (edge rows 0 and 2) hold, with
    the 'E', 'N' and 'D' recipes, on ragged tiles."""
    nx, ny, nz = 33, 17, 6
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(3)

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64),
                               device=dev).to(dt)
    F = lambda: t(0.1 * rng.standard_normal((nz, ny, nx)))    # noqa: E731
    E = lambda: t(0.1 * rng.standard_normal((3, ny, nx)))     # noqa: E731
    u, v, w, pp, p = (F() for _ in range(5))
    ue, ve, we, ppe = (E() for _ in range(4))
    junk = lambda e: torch.stack([e[0] + 5.0, e[1], e[2] - 3.0])  # noqa: E731
    ue2, ve2 = junk(ue), junk(ve)
    one = t(np.ones(nz + 2))
    prof = t(np.linspace(0.1, 0.5, nz))
    fuv = t([0.02, -0.01])
    zrec = (('E', 0.4, 0.0, 'N', 0.1, 0.2), ('E', 0.3, 0.0, 'D', 0.0, 0.2))
    tw = t(np.abs(rng.standard_normal((2, ny, nx))))
    K.reset_launches()
    assert torch.equal(K.fillps(u, v, w, ue, ve, we, one, 3.0, 1.5, 2.0),
                       K.fillps(u, v, w, ue2, ve2, we, one, 3.0, 1.5, 2.0))
    for a, b in zip(
            K.correc_smag(u, v, w, pp, p, ue, ve, we, ppe, 1e-3, 1.5, 2.0,
                          one, one, 1e-4, prof, zrec, fuv, prof, prof, tw[0],
                          tw[1]),
            K.correc_smag(u, v, w, pp, p, ue2, ve2, we, ppe, 1e-3, 1.5, 2.0,
                          one, one, 1e-4, prof, zrec, fuv, prof, prof, tw[0],
                          tw[1])):
        assert torch.equal(a, b)
    torch.cuda.synchronize()
    assert K.LAUNCHES['fillps'] == 2 and K.LAUNCHES['correc_smag'] == 2


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['smag', 'none'])
def test_card_matches_cpu_wmles_step_for_step(dev, case):
    """The wall-modelled channel (bench.py's wmles_channel, and its
    sgstype 'none' variant) on the card against the CPU, 3 steps, fp64,
    with the launches of the steps: the wall model once a substep (with
    smag the fused correction's corrected rows, whose planes the
    post-correction fill takes; with 'none' the post-correction fill)."""
    cfg = Config(**dict(WMLES, sgstype=case))
    grid = make_grid_from_config(cfg)
    fields = initflow(cfg, grid)
    sims = [Simulation(cfg, grid, device=d) for d in (dev, 'cpu')]
    states = [s.initial_state(*fields) for s in sims]
    dt = sims[1].pick_dt(sims[1].check(states[1])[0])
    K.reset_launches()
    for _ in range(3):
        states = [s.step(st, dt)[0] for s, st in zip(sims, states)]
    smag = case == 'smag'
    assert K.LAUNCHES['wallmodel'] == 9
    assert K.LAUNCHES['correc_smag'] == (9 if smag else 0)
    assert K.LAUNCHES['correc_updatep'] == (0 if smag else 9)
    g, c = states
    for name, tol in (('u', 1e-11), ('v', 1e-11), ('w', 1e-11), ('p', 1e-10),
                      ('visct', 1e-12)):
        a, b = getattr(g, name).cpu(), getattr(c, name)
        if name == 'p':
            a, b = a - a.mean(), b - b.mean()
        assert float((a - b).abs().max()) <= tol, name


def _xles_sim(dev, kind, ng, dtype='float64'):
    """A port Simulation on the card of the developing channel LES (periodic
    y), the developing duct LES (y walls) or the developing WMLES with an
    inflow profile (the wall model on both z walls)."""
    from cales_torch.profile_step import power_law_inflow
    xbcs = dict(cbcvel=((('D', 'N', 'N'), ('P', 'P', 'P'), ('D', 'D', 'D')),
                        (('N', 'N', 'N'), ('P', 'P', 'P'), ('D', 'D', 'D'))),
                cbcpre=(('N', 'P', 'N'), ('D', 'P', 'N')),
                cbcsgs=(('N', 'P', 'D'), ('N', 'P', 'D')))
    if kind == 'duct':
        xbcs = dict(
            cbcvel=((('D', 'N', 'N'), ('D', 'D', 'D'), ('D', 'D', 'D')),
                    (('N', 'N', 'N'), ('D', 'D', 'D'), ('D', 'D', 'D'))),
            cbcpre=(('N', 'N', 'N'), ('D', 'N', 'N')),
            cbcsgs=(('N', 'D', 'D'), ('N', 'D', 'D')))
    kw = dict(ng=ng, l=(1.0, 1.5, 1.0), gtype=1, gr=1.0, visci=20_000.0,
              inivel='uni', is_wallturb=False, sgstype='smag', dtype=dtype,
              is_forced=(False,) * 3, velf=(0.0,) * 3,
              bcvel=(((1.0, 0.0, 0.0), (0.0,) * 3, (0.0,) * 3),
                     ((0.0,) * 3,) * 3), **xbcs)
    if kind == 'wm':
        kw.update(l=(6.4, 3.2, 2.0), gtype=6, gr=0.0, visci=50_000.0,
                  lwm=((0, 0, 1), (0, 0, 1)), hwm=0.1)
    cfg = Config(**kw)
    if kind == 'wm':
        cfg = power_law_inflow(cfg)
    grid = make_grid_from_config(cfg)
    return cfg, grid, Simulation(cfg, grid, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize('kind', ['dev', 'duct', 'wm'])
@pytest.mark.parametrize('dtype, shape', [
    ('float64', (40, 25, 11)), ('float32', (33, 17, 17))])
def test_cuda_xwalled_les_kernels_match_twins(dev, dtype, shape, kind):
    """The x-walled LES's kernel variants on ragged tiles against their
    twins, on the post-correction fill's stacks of random interiors: mom_rk
    with nu_t (and, with periodic y, the '1d' split), smag's x-wall variant
    (on the 'E' stacks with the wall model) and the wall model's x-walled
    rows with an inflow profile: float64 within 1e-12 (the wall model's
    planes 1e-13 of their maximum), float32 within 1e-5 of each output's
    maximum."""
    cfg, grid, sim = _xles_sim(dev, kind, shape, dtype)
    nx, ny, nz = shape
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(29)
    F = lambda: 0.05 * torch.randn((nz, ny, nx), generator=gen,  # noqa: E731
                                   device=dev, dtype=dt)
    u, v, w, p, ruo, rvo, rwo = (F() for _ in range(7))
    u = u + 1.0
    s = F().abs() * 1e-3
    bcs = sim._dynamic_bcs(u, v, w)
    vlo = tuple(1e-3 * torch.randn(q, generator=gen, device=dev, dtype=dt)
                for q in ((nz + 2, ny + 2), (nz + 2, nx + 2),
                          (ny + 2, nx + 2)))
    zq = sim._zedge_vel(u, v, w, *bcs, vlo=vlo, is_correc=True)
    yq = (sim._yedge_vel(u, v, w, bcs, vlo=vlo, is_correc=True)
          if sim.ywalled else None)
    xq = sim._xedge_vel(u, v, w, bcs, vlo=vlo, is_correc=True)
    dxi, dyi = cfg.dli[0], cfg.dli[1]
    ye = None if yq is None else (*yq, sim._yedge_s(s), sim._yedge_p(p))
    xe = (*xq, sim._xedge_s(s), sim._xedge_p(p))
    tol = dict(rtol=0, atol=1e-12)

    def close(got, ref):
        if dt == torch.float64:
            torch.testing.assert_close(got, ref, **tol)
        else:
            _rel_close(got, ref, 1e-5)
    for split in (None, '1d') if yq is None else (None,):
        mom = (u, v, w, s, p, *zq, sim._zedge_s(s), sim._zedge_p(p), ruo,
               rvo, rwo, sim.dzci_t, sim.dzfi_t, 5e-4, -2e-4, cfg.visc, dxi,
               dyi, (0.0, 0.0, 0.0))
        K.reset_launches()
        got = K.mom_rk(*mom, sums=(True, True), split=split, ye=ye, xe=xe)
        ref = K.mom_rk_plain(*mom, sums=(True, True), split=split, ye=ye,
                             xe=xe)
        assert K.LAUNCHES['mom_rk'] == 1
        for g, r in zip(got[:6], ref[:6]):
            close(g, r)
    # smag: the stage's own glue (the shear planes, the 'E' stacks), its
    # kernel call against the twin on the same arguments
    calls = []
    real = K.smag

    def spy(*a, **k):
        calls.append((a, k))
        return real(*a, **k)
    K.smag = spy
    try:
        sim._sgs_stage(u, v, w, zq, vlo, yq, xq)
    finally:
        K.smag = real
    (a, k), = calls
    assert k['xe'] is not None and (k['xwall'] is not None)
    close(K.smag(*a, **k), K.smag_plain(*a, **k))
    if kind == 'wm':
        K.reset_launches()
        got = K.wm_planes(u, v, sim.wm)
        ref = K.wm_planes_plain(u, v, sim.wm)
        assert K.LAUNCHES['wallmodel'] == 1
        for g, r in zip(got, ref):
            if dt == torch.float64:
                _rel_close(g, r, 1e-13)
            else:
                _rel_close(g, r, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize('kind', ['dev', 'duct', 'wm'])
def test_card_matches_cpu_xwalled_les_step_for_step(dev, kind):
    """3 steps of the x-walled LES on the card and on the CPU (twins),
    fp64: u, v, w and the kept planes within 1e-11, p within 1e-10 after
    removing its mean, nu_t within 1e-10 of its maximum."""
    cfg, grid, sim = _xles_sim(dev, kind, (48, 24, 16))
    cpu = Simulation(cfg, grid, device='cpu')
    fields = [np.asarray(f) for f in initflow(cfg, grid)]
    rng = np.random.default_rng(3)
    fields = [f + 1e-2 * rng.standard_normal(f.shape) for f in fields]
    a, b = sim.initial_state(*fields), cpu.initial_state(*fields)
    dt = cpu.pick_dt(cpu.check(b)[0])
    K.reset_launches()
    for _ in range(3):
        a, _ = sim.step(a, dt)
        b, _ = cpu.step(b, dt)
    assert K.LAUNCHES['smag'] == 9 and K.LAUNCHES['mom_rk'] == 9
    if kind == 'wm':
        assert K.LAUNCHES['wallmodel'] == 9
    for name in ('u', 'v', 'w', 'p', 'visct'):
        x, y = getattr(a, name).cpu(), getattr(b, name)
        if name == 'p':
            x, y = x - x.mean(), y - y.mean()
        err = float((x - y).abs().max())
        if name == 'visct':
            err /= float(y.abs().max())
        assert err <= (1e-10 if name in ('p', 'visct') else 1e-11), name
    for m in range(3):
        assert float((a.vlo[m].cpu() - b.vlo[m]).abs().max()) <= 1e-11, m


# the passive scalar's stacks: z walls (the channel), y walls (the duct),
# x walls (the developing channel) and x and y walls (the developing duct),
# each scalar face of its own letter and value
SCAL_WALLS = {
    'z': dict(cbcvel=((('P', 'P', 'P'), ('P', 'P', 'P'),
                       ('D', 'D', 'D')),) * 2,
              cbcpre=(('P', 'P', 'N'), ('P', 'P', 'N')),
              cbcsgs=(('P', 'P', 'D'), ('P', 'P', 'D')),
              cbcscal=(('P', 'P', 'D'), ('P', 'P', 'N')),
              bcscal=((0.0, 0.0, 0.3), (0.0, 0.0, -0.2))),
    'y': dict(cbcvel=((('P', 'P', 'P'), ('D', 'D', 'D'),
                       ('D', 'D', 'D')),) * 2,
              cbcpre=(('P', 'N', 'N'), ('P', 'N', 'N')),
              cbcsgs=(('P', 'D', 'D'), ('P', 'D', 'D')),
              cbcscal=(('P', 'D', 'N'), ('P', 'N', 'D')),
              bcscal=((0.0, 1.0, 0.1), (0.0, -0.3, 0.5))),
    'x': dict(cbcvel=((('D', 'N', 'N'), ('P', 'P', 'P'), ('D', 'D', 'D')),
                      (('N', 'N', 'N'), ('P', 'P', 'P'), ('D', 'D', 'D'))),
              bcvel=(((1.0, 0.0, 0.0), (0.0,) * 3, (0.0,) * 3),
                     ((0.0,) * 3,) * 3),
              cbcpre=(('N', 'P', 'N'), ('D', 'P', 'N')),
              cbcsgs=(('N', 'P', 'D'), ('N', 'P', 'D')),
              cbcscal=(('D', 'P', 'N'), ('N', 'P', 'D')),
              bcscal=((1.0, 0.0, 0.2), (0.1, 0.0, 0.4))),
    'xy': dict(cbcvel=((('D', 'N', 'N'), ('D', 'D', 'D'), ('D', 'D', 'D')),
                       (('N', 'N', 'N'), ('D', 'D', 'D'), ('D', 'D', 'D'))),
               bcvel=(((1.0, 0.0, 0.0), (0.0,) * 3, (0.0,) * 3),
                      ((0.0,) * 3,) * 3),
               cbcpre=(('N', 'N', 'N'), ('D', 'N', 'N')),
               cbcsgs=(('N', 'D', 'D'), ('N', 'D', 'D')),
               cbcscal=(('D', 'D', 'N'), ('N', 'N', 'D')),
               bcscal=((1.0, 0.5, 0.2), (0.1, -0.2, 0.4))),
}


def _scal_sim(dev, walls, ng, dtype='float64', **kw):
    """A port Simulation on `dev` of a scalar-carrying flow with the walls
    of SCAL_WALLS[walls]: smag, explicit, 'mat' (kw overrides)."""
    base = dict(ng=ng, l=(2.0, 1.5, 1.0), gtype=1, gr=1.0, visci=20_000.0,
                inivel='uni', is_wallturb=False, sgstype='smag',
                dtype=dtype, is_forced=(False,) * 3, velf=(0.0,) * 3,
                ptransform='mat', scalar=True, pr=0.71, iniscal='uni',
                ssource=0.02)
    cfg = Config(**{**base, **SCAL_WALLS[walls], **kw})
    grid = make_grid_from_config(cfg)
    return cfg, grid, Simulation(cfg, grid, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize('walls', ['z', 'y', 'x', 'xy'])
@pytest.mark.parametrize('dtype, shape', [
    ('float64', (40, 25, 11)), ('float32', (33, 17, 17))])
def test_cuda_mom_rk_scal_ragged_tiles(dev, walls, dtype, shape):
    """mom_rk's scalar variant (cales_mom_rk_scal_*) against its twin on
    ragged tiles, on the post-correction fill's stacks of random interiors
    and the scalar's own stacks: with and without nu_t, with each split
    the route admits (periodic y: None, '1d' and, without x walls, 'xy+z';
    y walls: None), the first substep and a later one: the velocity's six
    fields and the scalar's s and ds float64 within 1e-13 of each output's
    maximum, float32 within 1e-5 (row 1's bound in chip_smoke.py)."""
    cfg, grid, sim = _scal_sim(dev, walls, shape, dtype)
    nx, ny, nz = shape
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(31)
    F = lambda: 0.05 * torch.randn((nz, ny, nx), generator=gen,  # noqa: E731
                                   device=dev, dtype=dt)
    u, v, w, p, ruo, rvo, rwo, rso = (F() for _ in range(8))
    u = u + 1.0
    sca = 1.0 + F()
    nut = F().abs() * 1e-3
    vlo = tuple(1e-3 * torch.randn(q, generator=gen, device=dev, dtype=dt)
                for q in ((nz + 2, ny + 2), (nz + 2, nx + 2),
                          (ny + 2, nx + 2)))
    bcs = sim._dynamic_bcs(u, v, w)
    zq = sim._zedge_vel(u, v, w, *bcs, vlo=vlo, is_correc=True)
    yq = (sim._yedge_vel(u, v, w, bcs, vlo=vlo, is_correc=True)
          if sim.ywalled else None)
    xq = (sim._xedge_vel(u, v, w, bcs, vlo=vlo, is_correc=True)
          if sim.xwalled else None)
    splits = ((None,) if sim.ywalled else
              (None, '1d') if sim.xwalled else (None, '1d', 'xy+z'))
    rtol = 1e-13 if dt == torch.float64 else 1e-5
    K.reset_launches()
    n = 0
    for sgs in (True, False):
        s = nut if sgs else None
        se = sim._zedge_s(nut) if sgs else None
        ye = xe = None
        if yq is not None:
            ye = (*yq, sim._yedge_s(nut) if sgs else None, sim._yedge_p(p),
                  sim._yedge_scal(sca))
        if xq is not None:
            xe = (*xq, sim._xedge_s(nut) if sgs else None, sim._xedge_p(p),
                  sim._xedge_scal(sca))
        for split in splits:
            for first in (True, False):
                r = (None,) * 4 if first else (ruo, rvo, rwo, rso)
                mom = (u, v, w, s, p, *zq, se, sim._zedge_p(p), *r[:3],
                       sim.dzci_t, sim.dzfi_t, 5e-4, 0.0 if first else -2e-4,
                       cfg.visc, cfg.dli[0], cfg.dli[1], (0.0, 0.0, 0.0))
                kw = dict(sums=(True, True), split=split, ye=ye, xe=xe,
                          sca=sca, scae=sim._zedge_scal(sca), rso=r[3],
                          scal=sim.scal_params)
                got = K.mom_rk(*mom, **kw)
                ref = K.mom_rk_plain(*mom, **kw)
                n += 1
                assert len(got) == len(ref) == 10
                for g, q in zip(got[:6] + got[8:], ref[:6] + ref[8:]):
                    _rel_close(g, q, rtol)
    torch.cuda.synchronize()
    assert K.LAUNCHES['mom_rk'] == n


@pytest.mark.cuda
@pytest.mark.parametrize('walls', ['z', 'xy'])
def test_card_matches_cpu_scalar_step_for_step(dev, walls):
    """3 steps of a scalar-carrying LES on the card and on the CPU (twins),
    fp64: the channel (z walls, forced scalar) and the developing duct (x
    and y walls): u, v, w and s within 1e-11, p within 1e-10 after
    removing its mean, nu_t within 1e-10 of its maximum; mom_rk 3 a step,
    its scalar variant."""
    kw = (dict(is_forced=(True, False, False), velf=(1.0, 0.0, 0.0),
               inivel='log', is_wallturb=True, l=(2 * np.pi, np.pi, 2.0),
               is_sforced=True, scalf=1.0) if walls == 'z' else {})
    cfg, grid, sim = _scal_sim(dev, walls, (48, 24, 16), **kw)
    cpu = Simulation(cfg, grid, device='cpu')
    fields = [np.asarray(f) for f in initflow(cfg, grid)]
    rng = np.random.default_rng(5)
    fields = [f + 1e-2 * rng.standard_normal(f.shape) for f in fields]
    a, b = sim.initial_state(*fields), cpu.initial_state(*fields)
    dt = cpu.pick_dt(cpu.check(b)[0])
    K.reset_launches()
    for _ in range(3):
        a, _ = sim.step(a, dt)
        b, _ = cpu.step(b, dt)
    assert K.LAUNCHES['mom_rk'] == 9
    for name in ('u', 'v', 'w', 's', 'p', 'visct'):
        x, y = getattr(a, name).cpu(), getattr(b, name)
        if name == 'p':
            x, y = x - x.mean(), y - y.mean()
        err = float((x - y).abs().max())
        if name == 'visct':
            err /= float(y.abs().max())
        assert err <= (1e-10 if name in ('p', 'visct') else 1e-11), name


def _box_sgs_inputs(dev, ng, seed):
    """Random periodic fields on the triperiodic box (their Fourier
    amplitudes falling as 1/k), as interiors with the wrap's z-edge stacks,
    and the box's metrics."""
    nx, ny, nz = ng
    cfg = Config(ng=ng, l=(2 * np.pi, 1.7, 2.3), gtype=1, gr=0.0,
                 visci=1600.0, dtype='float64',
                 cbcvel=((('P',) * 3,) * 3,) * 2, cbcpre=(('P',) * 3,) * 2,
                 cbcsgs=(('P',) * 3,) * 2)
    grid = make_grid_from_config(cfg)
    rng = np.random.default_rng(seed)
    kz, ky, kx = np.meshgrid(*(np.fft.fftfreq(n) * n for n in (nz, ny, nx)),
                             indexing='ij')
    k = np.sqrt(kx ** 2 + ky ** 2 + kz ** 2)
    k[0, 0, 0] = np.inf
    fields = []
    for _ in range(3):
        q = np.real(np.fft.ifftn(
            np.fft.fftn(rng.standard_normal((nz, ny, nx))) / k))
        fields.append(torch.as_tensor(q / np.abs(q).max(), device=dev))
    edges = [torch.stack([q[-1], q[-1], q[0]]).contiguous() for q in fields]
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64),  # noqa: E731
                                  device=dev)
    return dict(fields=fields, edges=edges, dzci=t(grid.dzci),
                dzfi=t(grid.dzfi), dxi=cfg.dli[0], dyi=cfg.dli[1])


@pytest.mark.cuda
@pytest.mark.parametrize('mode', ['zp', 'f2d', 'zp_f2d'])
@pytest.mark.parametrize('dtype, shape', [
    ('float64', (40, 25, 9)), ('float64', (36, 37, 6)),
    ('float32', (40, 33, 9)), ('float32', (36, 37, 3))])
def test_cuda_dsmag_modes_match_twins(dev, mode, dtype, shape):
    """dsmag's periodic-z mode (ZP: the box, the planes -1 and nz made
    from the planes at the other end, the edge stacks unread) and its 2D
    test filter (F2D: the channel's walls, alpha^2 2.52, and with ZP the
    box) against the twin on ragged tiles, 'channel' sums (those 'dit'
    weighs): |S| and the per-row sums 1e-12 of their maximum in float64,
    1e-5 in float32."""
    nx, ny, nz = shape
    dt = getattr(torch, dtype)
    tol = 1e-12 if dt == torch.float64 else 1e-5
    zper, f2d = 'zp' in mode, 'f2d' in mode

    def c(q):
        return q.to(dt).contiguous()
    d = (_box_sgs_inputs(dev, shape, 21) if zper
         else _sgs_inputs(dev, shape, 22))
    edges = d['edges']
    if zper:
        # garbage in the stacks: the mode must not read them
        edges = [torch.full_like(e, 9.0) for e in edges]
    a2 = np.full(nz, 2.52 if f2d else 4.0)
    walls = not zper
    ds = (*map(c, d['fields']), *map(c, edges),
          c(torch.as_tensor(a2, device=dev)), c(d['dzci']), c(d['dzfi']),
          d['dxi'], d['dyi'], walls, walls, (0.0, 0.4, 0.0, -0.3))
    K.reset_launches()
    for avg in ('channel', 'dit'):
        s0, num, den = K.dsmag(*ds, avg=avg, zper=zper, f2d=f2d)
        s0r, numr, denr = K.dsmag_plain(*ds, avg=avg, zper=zper, f2d=f2d)
        _rel_close(s0, s0r, tol)
        _rel_close(num.sum(-1), numr[..., 0], tol)
        _rel_close(den.sum(-1), denr[..., 0], tol)
    torch.cuda.synchronize()
    assert K.LAUNCHES['dsmag'] == 2
    for bad in (dict(avg='duct'), dict(avg='cavity')):
        with pytest.raises(RuntimeError, match='invalid argument'):
            K.dsmag(*ds, zper=zper, f2d=f2d, **bad)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float64', 'float32'])
def test_cuda_smag_without_walls_matches_twin(dev, dtype):
    """The smag kernel's no-wall mode (have_zwalls False: no van Driest
    damping), the triperiodic LES's, at the box's 512^3 TGV cell's tile
    edges (a ragged shape)."""
    shape = (40, 33, 9)
    dt = getattr(torch, dtype)
    tol = 1e-12 if dt == torch.float64 else 1e-5
    d = _box_sgs_inputs(dev, shape, 23)
    nx, ny, nz = shape
    c = lambda q: q.to(dt).contiguous()  # noqa: E731
    z = torch.zeros((ny, nx), dtype=dt, device=dev)
    args = (*map(c, d['fields']), *map(c, d['edges']), c(d['dzci']),
            c(d['dzfi']), d['dxi'], d['dyi'], 1e-3,
            torch.full((nz,), 0.01, dtype=dt, device=dev),
            torch.zeros(nz, dtype=dt, device=dev),
            torch.ones(nz, dtype=dt, device=dev), z, z)
    K.reset_launches()
    got = K.smag(*args, have_zwalls=False)
    ref = K.smag_plain(*args, have_zwalls=False)
    _rel_close(got, ref, tol)
    assert K.LAUNCHES['smag'] == 1


BOX_PER = dict(cbcvel=((('P',) * 3,) * 3,) * 2, cbcpre=(('P',) * 3,) * 2,
               cbcsgs=(('P',) * 3,) * 2)
BOX_TGV = dict(ng=(32, 16, 24), l=(2 * np.pi,) * 3, gtype=1, gr=0.0,
               visci=1600.0, inivel='tgv', is_wallturb=False,
               dtype='float64', ptransform='mat', **BOX_PER)
BOX_CASES = {
    'box_smag': (dict(BOX_TGV, sgstype='smag'), 'smag'),
    'box_dsmag_dit': (dict(BOX_TGV, sgstype='dsmag', dsmag_avg='dit'),
                      'dsmag'),
    'box_forced_z': (dict(BOX_TGV, sgstype='smag', impdiff=True,
                          impdiff_1d=True, is_forced=(True, False, True),
                          velf=(0.05, 0.0, 0.1)), 'smag'),
    'channel_filter_2d': (dict(
        ng=(32, 16, 16), l=(12.8, 4.8, 2.0), gtype=1, gr=5.0,
        visci=10_000.0, inivel='poi', is_wallturb=True,
        is_forced=(True, False, False), velf=(1.0, 0.0, 0.0),
        dtype='float64', sgstype='dsmag', dsmag_avg='dit', filter_2d=True,
        ptransform='mat',
        cbcvel=((('P', 'P', 'P'), ('P', 'P', 'P'), ('D', 'D', 'D')),) * 2,
        cbcpre=(('P', 'P', 'N'),) * 2, cbcsgs=(('P', 'P', 'D'),) * 2),
        'dsmag'),
}


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(BOX_CASES))
def test_card_matches_cpu_box_les_step_for_step(dev, case):
    """3 steps on the card and on the CPU (twins), fp64, from perturbed
    fields: the box with smag (the smag kernel without walls), with dsmag
    'dit' (dsmag's ZP mode), forced along x and z with impdiff_1d, and the
    channel with the 2D test filter (F2D): u, v, w within 1e-11, p within
    1e-10 after removing its mean, nu_t within 1e-10 of its maximum; the
    SGS kernel 3 a step."""
    kw, sgs = BOX_CASES[case]
    cfg = Config(**kw)
    grid = make_grid_from_config(cfg)
    sims = [Simulation(cfg, grid, device=d) for d in (dev, 'cpu')]
    rng = np.random.default_rng(31)
    fields = [np.asarray(f) + 0.05 * rng.standard_normal(np.shape(f))
              for f in initflow(cfg, grid)]
    states = [s.initial_state(*fields) for s in sims]
    dt = sims[1].pick_dt(sims[1].check(states[1])[0])
    K.reset_launches()
    for _ in range(3):
        states = [s.step(st, dt)[0] for s, st in zip(sims, states)]
    torch.cuda.synchronize()
    assert K.LAUNCHES[sgs] == 9 and K.LAUNCHES['correc_smag'] == 0
    g, c = states
    for name, tol in (('u', 1e-11), ('v', 1e-11), ('w', 1e-11), ('p', 1e-10)):
        a, b = getattr(g, name).cpu(), getattr(c, name)
        if name == 'p':
            a, b = a - a.mean(), b - b.mean()
        assert float((a - b).abs().max()) <= tol, name
    assert float(c.visct.max()) > 0
    _rel_close(g.visct.cpu(), c.visct, 1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype, shape', [
    ('float64', (40, 13, 9)), ('float64', (36, 2, 12)),
    ('float32', (40, 21, 9)), ('float32', (33, 2, 12))])
def test_cuda_slab_les_kernels_match_twins(dev, dtype, shape):
    """The slab variants of the y-slab mesh's channel classes against their
    twins on random halos, on (nx, nyl, nz) shapes no tile fits and on
    slabs of 2 rows (a tile's rows past nyl + 1 wrap): dsmag's YH mode
    (the depth-2 halo, 'channel' sums, |S| and the per-row sums), the wall
    model's slab rows (both z faces, the sampled rows' halo rows) and
    mom_rk's halo variant with the '1d' split (with and without nu_t).
    float64 within 1e-12 (the wall model 1e-13) of each output's maximum,
    float32 within 1e-5."""
    from cales_torch import wallmodel as wmod
    nx, ny, nz = shape
    dt = getattr(torch, dtype)
    tol = 1e-12 if dt == torch.float64 else 1e-5
    rng = np.random.default_rng(23)

    def c(q):
        return q.to(dt).contiguous()

    def r(*s, scale=0.1):
        return c(torch.as_tensor(scale * rng.standard_normal(s), device=dev))
    d = _sgs_inputs(dev, shape, 24)
    fields, edges = [c(q) for q in d['fields']], [c(e) for e in d['edges']]
    h2 = [(r(nz, 4, nx), r(3, 4, nx)) for _ in range(3)]
    ds = (*fields, *edges, c(d['alph2']), c(d['dzci']), c(d['dzfi']),
          d['dxi'], d['dyi'], True, True, (0.0, 0.4, 0.0, -0.3))
    K.reset_launches()
    for avg in ('channel', 'dit'):
        s0, num, den = K.dsmag(*ds, avg=avg, yh=h2)
        s0r, numr, denr = K.dsmag_plain(*ds, avg=avg, yh=h2)
        _rel_close(s0, s0r, tol)
        _rel_close(num.sum(-1), numr[..., 0], tol)
        _rel_close(den.sum(-1), denr[..., 0], tol)
    # the wall model's slab rows: a bulk flow, moving wall values
    bcvel = (((0.0,) * 3, (0.0,) * 3, (0.03, -0.02, 0.0)),
             ((0.0,) * 3, (0.0,) * 3, (-0.01, 0.04, 0.0)))
    cfg = Config(**dict(WMLES, ng=shape, bcvel=bcvel))
    grid = make_grid_from_config(cfg)
    wm = wmod.z_wall_model(cfg, grid, wmod.find_index_wm(cfg, grid),
                           (0.03, -0.01), (-0.02, 0.04))
    u, v = r(nz, ny, nx, scale=0.3) + 1.0, r(nz, ny, nx, scale=0.3)
    yh = r(4 * len(wm.faces), 2, nx, scale=0.3)
    got = K.wm_planes(u, v, wm, yh=yh)
    ref = wmod.wm_planes_plain(u, v, wm, yh=yh)
    for gf, rf in zip(got, ref):
        for g, q in zip(gf, rf):
            _rel_close(g, q, 1e-13 if dt == torch.float64 else 1e-5)
    # mom_rk's halo variant with the '1d' split (the CN fold)
    s = r(nz, ny, nx).abs()
    H = lambda: (r(nz, 2, nx), r(3, 2, nx))   # noqa: E731
    h1 = tuple(H() for _ in range(5))
    for sgs in (True, False):
        mom = (*fields, s if sgs else None, r(nz, ny, nx), *edges,
               r(3, ny, nx) if sgs else None, r(3, ny, nx),
               *(r(nz, ny, nx) for _ in range(3)), c(d['dzci']),
               c(d['dzfi']), 5e-4, -2e-4, d['visc'], d['dxi'], d['dyi'],
               (0.1, 0.0, 0.0))
        h = h1 if sgs else (*h1[:3], None, h1[4])
        got = K.mom_rk(*mom, sums=(True, False), split='1d', yh=h)
        ref = K.mom_rk_plain(*mom, sums=(True, False), split='1d', yh=h)
        for g, q in zip(got[:6], ref[:6]):
            _rel_close(g, q, tol)
        _rel_close(got[6].sum(1), ref[6][:, 0], tol)
    torch.cuda.synchronize()
    assert (K.LAUNCHES['dsmag'], K.LAUNCHES['wallmodel'],
            K.LAUNCHES['mom_rk']) == (2, 1, 2)


# the y-walled classes' letters (bench.py's duct and cavity), with moving
# wall-parallel values on some y and z faces: (face, dir, comp)
_DUCT_BCS = dict(
    cbcvel=((('P', 'P', 'P'), ('D', 'D', 'D'), ('D', 'D', 'D')),) * 2,
    cbcpre=(('P', 'N', 'N'),) * 2, cbcsgs=(('P', 'D', 'D'),) * 2,
    bcvel=(((0.0,) * 3, (0.2, 0.0, -0.1), (0.0, 0.0, 0.0)),
           ((0.0,) * 3, (0.0, 0.0, 0.3), (0.4, -0.3, 0.0))))


@pytest.mark.cuda
@pytest.mark.parametrize('own', [(True, False), (False, False),
                                 (False, True)])
@pytest.mark.parametrize('dtype, shape', [
    ('float64', (40, 10, 12)), ('float32', (72, 19, 24)),
    ('float64', (40, 2, 12))])
def test_cuda_walled_slab_kernels_match_twins(dev, dtype, shape, own):
    """The y-walled slab of the y-slab mesh: each kernel on a slab's own
    y-row stacks (boundary.slab_ystack: the wall recipe's rows on the
    side it owns, random halo rows elsewhere) against its twin, on the
    lower, a middle and the upper slab, on (nx, nyl, nz) shapes no tile
    fits and on a slab of 2 rows: mom_rk with nu_t, fillps,
    correc_updatep, smag with the y walls' damping, and dsmag's YW + YH
    mode with the 'duct', 'cavity' and 'channel' averages.  float64
    within 1e-12 of each output's maximum (smag 1e-13 relative), float32
    within 1e-5."""
    from cales_torch.ops import boundary as bnd
    nx, ny, nz = shape
    dt = getattr(torch, dtype)
    tol = 1e-12 if dt == torch.float64 else 1e-5
    cfg = Config(ng=shape, l=(4 * np.pi, 2.0, 2.0), gtype=1, gr=1.0,
                 visci=10_000.0, sgstype='smag', dtype=dtype,
                 ptransform='mat', **_DUCT_BCS)
    sim = Simulation(cfg, make_grid_from_config(cfg), device=dev)
    rng = np.random.default_rng(31)

    def r(*s, scale=0.05):
        return torch.as_tensor(scale * rng.standard_normal(s), device=dev,
                               dtype=dt)
    u, v, w, p, pp, ru, rv, rw = (r(nz, ny, nx) for _ in range(8))
    s = r(nz, ny, nx, scale=1e-3).abs()
    bcs = (sim.bcu_vals, sim.bcv_vals, sim.bcw_vals)
    ue, ve, we = sim._zedge_vel(u, v, w, *bcs)
    se, pe, ppe = sim._zedge_s(s), sim._zedge_p(p), sim._zedge_p(pp)

    def slab(fields, edges, walls, depth=1):
        h = [(r(nz, 2 * depth, nx), r(3, 2 * depth, nx)) for _ in fields]
        return [bnd.slab_ystack(q, e, y, hh, own)
                for q, e, y, hh in zip(fields, edges, walls, h)], h
    vlo = (None, torch.zeros((nz + 2, nx + 2), dtype=dt, device=dev),
           torch.zeros((ny + 2, nx + 2), dtype=dt, device=dev))
    post = sim._yedge_vel(u, v, w, bcs, vlo=vlo, is_correc=True)
    ymom, _ = slab((u, v, w, s, p), (ue, ve, we, se, pe),
                   (*post, sim._yedge_s(s), sim._yedge_p(p)))
    (ypv,), _ = slab((v,), (ve,), (sim._yedge_vel(u, v, w)[1],))
    (ypp,), _ = slab((pp,), (ppe,), (sim._yedge_p(pp),))
    yds, h2 = slab((u, v, w), (ue, ve, we), post, depth=2)
    dxi, dyi = cfg.dli[0], cfg.dli[1]
    K.reset_launches()
    mom = (u, v, w, s, p, ue, ve, we, se, pe, ru, rv, rw, sim.dzci_t,
           sim.dzfi_t, 5e-4, -2e-4, cfg.visc, dxi, dyi, (0.1, 0.0, 0.0))
    got = K.mom_rk(*mom, sums=(True, False), ye=ymom)
    ref = K.mom_rk_plain(*mom, sums=(True, False), ye=ymom)
    for g, q in zip(got[:6], ref[:6]):
        _rel_close(g, q, tol)
    _rel_close(got[6].sum(1), ref[6][:, 0], tol)
    fp = (u, v, w, ue, ve, we, sim.dzfi_t, 100.0, dxi, dyi)
    _rel_close(K.fillps(*fp, yv=ypv), K.fillps_plain(*fp, yv=ypv), tol)
    cp = (u, v, w, pp, p, we, ppe, 0.01, dxi, dyi, sim.dzci_t, sim.dzfi_t)
    for g, q in zip(K.correc_updatep(*cp, ypp=ypp, yv=ypv[0]),
                    K.correc_updatep_plain(*cp, ypp=ypp, yv=ypv[0])):
        _rel_close(g, q, tol)
    ywall = (sim.dwy_t, sim.nearylo_t, r(nz, nx, scale=1e-2).abs() + 1e-2,
             r(nz, nx, scale=1e-2).abs() + 1e-2)
    tauw = [r(ny, nx, scale=1e-2).abs() + 1e-2 for _ in range(2)]
    sm = (u, v, w, ue, ve, we, sim.dzci_t, sim.dzfi_t, dxi, dyi, cfg.visc,
          sim.csd2_t, sim.dw_t, sim.nearlo_t, *tauw)
    _rel_close(K.smag(*sm, ye=ymom[:3], ywall=ywall),
               K.smag_plain(*sm, ye=ymom[:3], ywall=ywall),
               1e-13 if dt == torch.float64 else tol)
    alph2 = torch.full((nz,), 4.0, dtype=dt, device=dev)
    alph2[0] = alph2[-1] = 2.52
    ds = (u, v, w, ue, ve, we, alph2, sim.dzci_t, sim.dzfi_t, dxi, dyi,
          True, True, sim.dsmag_zvals)
    kw = dict(ye=yds, yh=h2, yown=own, yvals=sim.dsmag_yvals)
    for avg in ('duct', 'cavity', 'channel'):
        got = K.dsmag(*ds, avg=avg, **kw)
        ref = K.dsmag_plain(*ds, avg=avg, **kw)
        _rel_close(got[0], ref[0], tol)
        if avg != 'cavity':
            _rel_close(got[1].sum(-1), ref[1].reshape(ref[1].shape[0], -1)
                       .sum(-1) if avg == 'channel' else ref[1][..., 0], tol)
            _rel_close(got[2].sum(-1), ref[2].reshape(ref[2].shape[0], -1)
                       .sum(-1) if avg == 'channel' else ref[2][..., 0], tol)
    torch.cuda.synchronize()
    assert (K.LAUNCHES['mom_rk'], K.LAUNCHES['fillps'],
            K.LAUNCHES['correc_updatep'], K.LAUNCHES['smag'],
            K.LAUNCHES['dsmag']) == (1, 1, 1, 1, 3)


@pytest.mark.cuda
@pytest.mark.parametrize('own', [(True, False), (False, False),
                                 (False, True)])
@pytest.mark.parametrize('dtype, shape', [
    ('float64', (40, 32, 12)), ('float32', (72, 38, 17)),
    ('float64', (33, 24, 20))])
def test_cuda_wallmodel_ywalled_slab_matches_twin(dev, dtype, shape, own):
    """The wall model's y-walled slab variant (the duct WMLES on the y-slab
    mesh, wallmodel.slab_wall_model): the z faces' rows with the y recipe
    on the sides the slab owns and halo rows cut from the whole field
    elsewhere, the y face it owns on its own rows, in one launch, on the
    lower, a middle and the upper slab of (nx, ny, nz) shapes no block
    fits, moving wall values on every face: float64 within 1e-13 of each
    plane's maximum (the libraries' log differs), float32 within 1e-5; and
    the slab's planes against the whole field's cut to the slab (the rows
    the slab makes), within the same bounds."""
    from cales_torch import wallmodel as wmod
    from cales_torch.config import effective_cbcvel
    from cales_torch.ops import boundary as bnd
    nx, ny, nz = shape
    dt = getattr(torch, dtype)
    tol = 1e-13 if dt == torch.float64 else 1e-5
    bcvel = (((0.0,) * 3, (0.03, 0.0, -0.02), (0.01, 0.02, 0.0)),
             ((0.0,) * 3, (-0.01, 0.0, 0.04), (0.05, -0.03, 0.0)))
    cfg = Config(**dict(DUCT_WMLES, l=(2 * np.pi, 2.0, 2.0), gr=1.0,
                        ng=shape, bcvel=bcvel, hwm=0.2))
    grid = make_grid_from_config(cfg)
    bcs = [bnd.make_bc_values(cfg.ng, tuple(
        tuple(bcvel[ib][d][iv] for ib in range(2)) for d in range(3)), dt)
        for iv in range(3)]
    wm = wmod.wall_model(cfg, grid, wmod.find_index_wm(cfg, grid), bcs,
                         effective_cbcvel(cfg))
    rng = np.random.default_rng(29)
    u, v, w = (torch.as_tensor(0.3 * rng.standard_normal((nz, ny, nx)),
                               device=dev).to(dt) for _ in range(3))
    u = u + 1.0
    nyl = ny // 4
    y0 = {(True, False): 0, (False, False): nyl,
          (False, True): ny - nyl}[own]
    wms = wmod.slab_wall_model(wm, y0, nyl, own)
    q = [a[:, y0:y0 + nyl].contiguous() for a in (u, v, w)]
    yh = wmod.sampled_rows(u, v, wms)[
        :, [(y0 - 1) % ny, (y0 + nyl) % ny]].contiguous()
    K.reset_launches()
    got = K.wm_planes(*q[:2], wms, w=q[2], yh=yh, yown=own)
    ref = wmod.wm_planes_plain(*q[:2], wms, w=q[2], yh=yh, yown=own)
    whole = dict(zip(wm.faces, wmod.wm_planes_plain(u, v, wm, w=w)))
    torch.cuda.synchronize()
    assert K.LAUNCHES['wallmodel'] == 1
    assert len(got) == len(wms.faces) == 2 + sum(own)
    for face, g, r in zip(wms.faces, got, ref):
        _rel_close(g, r, tol)
        if face.d == 1:
            b = [p for f, p in whole.items() if f.d == 1
                 and f.ib == face.ib][0]
            _rel_close(g, b, tol)
            continue
        b = whole[face]
        _rel_close(g[0, 1:nyl + 1], b[0, y0 + 1:y0 + nyl + 1], tol)
        _rel_close(g[1, 0:nyl + 1], b[1, y0:y0 + nyl + 1], tol)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype, shape', [
    ('float64', (40, 10, 12)), ('float32', (72, 19, 24)),
    ('float64', (40, 2, 7))])
def test_cuda_dsmag_periodic_z_slab_matches_twin(dev, dtype, shape):
    """dsmag's ZP + YH mode (the box LES with 'dit' on the y-slab mesh:
    the velocity's planes mod nz, the two-row halo's rows of the same
    plane) against its twin and against the whole field's ZP kernel cut
    to the slab, on shapes no tile fits and a slab of 2 rows: |S| within
    1e-12 (f64) or 1e-5 (f32) of its maximum, the 'channel' sums' row
    totals the same relative to their maximum."""
    nx, nyl, nz = shape
    dt = getattr(torch, dtype)
    tol = 1e-12 if dt == torch.float64 else 1e-5
    rng = np.random.default_rng(37)
    ny = 3 * nyl
    U = [torch.as_tensor(0.05 * rng.standard_normal((nz, ny, nx)),
                         device=dev).to(dt) for _ in range(3)]
    E = [torch.stack([a[-1], a[-1], a[0]]) for a in U]
    dz = torch.full((nz + 2,), nz / 2.0, dtype=dt, device=dev)
    alph2 = torch.full((nz,), 4.0, dtype=dt, device=dev)
    args = (alph2, dz, dz, 40.0, 20.0, False, False)
    whole = K.dsmag(*U, *E, *args, avg='channel', zper=True)
    for y0 in (0, nyl, 2 * nyl):
        rows = [(y0 + j) % ny for j in (-2, -1, nyl, nyl + 1)]
        q = [a[:, y0:y0 + nyl].contiguous() for a in U]
        e = [a[:, y0:y0 + nyl].contiguous() for a in E]
        yh = [(a[:, rows].contiguous(), b[:, rows].contiguous())
              for a, b in zip(U, E)]
        K.reset_launches()
        got = K.dsmag(*q, *e, *args, avg='channel', zper=True, yh=yh)
        ref = K.dsmag_plain(*q, *e, *args, avg='channel', zper=True, yh=yh)
        torch.cuda.synchronize()
        assert K.LAUNCHES['dsmag'] == 1
        _rel_close(got[0], ref[0], tol)
        _rel_close(got[0], whole[0][:, y0:y0 + nyl], tol)
        for g, r in zip(got[1:], ref[1:]):
            _rel_close(g.sum(-1), r[:, 0], tol)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float64', 'float32'])
@pytest.mark.parametrize('gy', [2, 4])
def test_cuda_thomas_periodic_on_the_pencil(dev, dtype, gy):
    """thomas_periodic on each rank's pencil (nz, ny, nx/gy) of the box's
    Poisson system (the sharded solve with periodic z): its lamx lanes a
    slice of the spectrum, pinned on the rank whose slice holds the
    singular lane (poisson._holds_singular), against the twin within
    1e-12 (f64) or 1e-5 (f32) of the maximum, and the pinned lane's last
    row 0."""
    from cales_torch import poisson
    dt = getattr(torch, dtype)
    cfg = Config(ng=(64, 24, 20), l=(2 * np.pi,) * 3, gtype=1, gr=0.0,
                 visci=1600.0, inivel='tgv', sgstype='none', dtype=dtype,
                 ptransform='mat', cbcvel=((('P',) * 3,) * 3,) * 2,
                 cbcpre=(('P',) * 3,) * 2, cbcsgs=(('P',) * 3,) * 2)
    sv = poisson.make_solver(cfg, make_grid_from_config(cfg),
                             tuple(cfg.cbc_pre(d) for d in range(3)),
                             ('c', 'c', 'c'))
    nx, ny, nz = cfg.ng
    nxl = nx // gy
    tol = poisson._thomas_tol(sv.lamx, sv.lamy, dt)
    abc = [torch.as_tensor(a, dtype=torch.float64, device=dev)
           for a in (sv.a, sv.b, sv.c)]
    rng = np.random.default_rng(41)
    pinned = []
    for rank in range(gy):
        lamx = sv.lamx[rank * nxl:(rank + 1) * nxl]
        pin = poisson._holds_singular(lamx, sv.lamy, tol)
        pinned.append(pin)
        body = torch.as_tensor(rng.standard_normal((nz, ny, nxl)),
                               device=dev).to(dt)
        kw = dict(lamy=torch.as_tensor(sv.lamy, device=dev).to(dt),
                  lamx=torch.as_tensor(lamx, device=dev).to(dt), pin=pin,
                  tol=tol)
        got = SK.thomas_periodic_z(body, *abc, **kw)
        ref = SK.thomas_periodic_z_plain(body, *abc, **kw)
        _rel_close(got, ref, 1e-12 if dt == torch.float64 else 1e-5)
        if pin:
            lane = np.argwhere(np.abs(lamx[None, :] + sv.lamy[:, None])
                               <= tol)
            for j, i in lane:
                assert float(got[-1, j, i]) == 0.0
    assert sum(pinned) == 1


@pytest.mark.cuda
@pytest.mark.parametrize('split', [None, '1d'])
@pytest.mark.parametrize('dtype, shape', [
    ('float64', (40, 13, 9)), ('float64', (36, 2, 12)),
    ('float32', (40, 21, 9)), ('float32', (33, 2, 12))])
def test_cuda_slab_scalar_and_2d_filter_match_twins(dev, dtype, shape,
                                                    split):
    """The periodic slab of the y-slab mesh (random halos) on (nx, nyl, nz)
    shapes no tile fits and slabs of 2 rows: mom_rk's scalar variant with
    the halos (Y_HALO, the scalar's halo pair the sixth; explicit and
    '1d', with and without nu_t), dsmag_level1's YH mode (the depth-2
    halo), dsmag_level2's YH mode (the filtered velocity's depth-1 halo,
    'channel' sums) and dsmag's 2D filter on the slab (F2D + YH, with ZP
    too), each against its twin: float64 within 1e-12 of each output's
    maximum, float32 within 1e-5."""
    nx, ny, nz = shape
    dt = getattr(torch, dtype)
    tol = 1e-12 if dt == torch.float64 else 1e-5
    rng = np.random.default_rng(41)

    def c(q):
        return q.to(dt).contiguous()

    def r(*s, scale=0.1):
        return c(torch.as_tensor(scale * rng.standard_normal(s), device=dev))
    d = _sgs_inputs(dev, shape, 42)
    fields, edges = [c(q) for q in d['fields']], [c(e) for e in d['edges']]
    dzci, dzfi = c(d['dzci']), c(d['dzfi'])
    H = lambda depth: (r(nz, 2 * depth, nx), r(3, 2 * depth, nx))  # noqa
    K.reset_launches()
    # mom_rk with the scalar on the slab
    s = r(nz, ny, nx).abs()
    sca, rso = r(nz, ny, nx, scale=1.0), r(nz, ny, nx)
    h1 = tuple(H(1) for _ in range(6))
    for sgs in (True, False):
        mom = (*fields, s if sgs else None, r(nz, ny, nx), *edges,
               r(3, ny, nx) if sgs else None, r(3, ny, nx),
               *(r(nz, ny, nx) for _ in range(3)), dzci, dzfi, 5e-4, -2e-4,
               d['visc'], d['dxi'], d['dyi'], (0.1, 0.0, 0.0))
        h = h1 if sgs else (*h1[:3], None, *h1[4:])
        # the scalar's z-edge stack: its row 1 the interior's last row, as
        # a cell-centred field's (the kernel reads it there, the twin's
        # update the interior)
        scae = torch.stack([r(ny, nx, scale=1.0), sca[-1],
                            r(ny, nx, scale=1.0)])
        sc = dict(sca=sca, scae=scae, rso=rso, scal=(2e-4, 0.05))
        got = K.mom_rk(*mom, sums=(True, False), split=split, yh=h, **sc)
        ref = K.mom_rk_plain(*mom, sums=(True, False), split=split, yh=h,
                             **sc)
        for g, q in zip((*got[:6], *got[8:]), (*ref[:6], *ref[8:])):
            _rel_close(g, q, tol)
        _rel_close(got[6].sum(1), ref[6][:, 0], tol)
    # the two passes on the slab
    h2 = [H(2) for _ in range(3)]
    lv1 = (*fields, *edges, dzci, dzfi, d['dxi'], d['dyi'], True, True)
    got = K.dsmag_level1(*lv1, yh=h2)
    ref = K.dsmag_level1_plain(*lv1, yh=h2)
    for g, q in zip((*got[0], *got[1], *got[2], got[3]),
                    (*ref[0], *ref[1], *ref[2], ref[3])):
        _rel_close(g, q, tol)
    fm, fvel, lij, s0 = ref
    fe = [r(3, ny, nx) for _ in range(3)]
    lv2 = (*fvel, *fe, fm, lij, s0, c(d['alph2']), dzci, dzfi, d['dxi'],
           d['dyi'])
    fh = [H(1) for _ in range(3)]
    num, den = K.dsmag_level2(*lv2, avg='channel', yh=fh)
    numr, denr = K.dsmag_level2_plain(*lv2, avg='channel', yh=fh)
    _rel_close(num.sum(-1), numr[..., 0], tol)
    _rel_close(den.sum(-1), denr[..., 0], tol)
    # the 2D filter on the slab, with z walls and with periodic z
    for zper in (False, True):
        a2 = torch.full((nz,), 2.52, dtype=dt, device=dev)
        ds = (*fields, *edges, a2, dzci, dzfi, d['dxi'], d['dyi'],
              not zper, not zper, (0.0, 0.4, 0.0, -0.3))
        got = K.dsmag(*ds, avg='channel', zper=zper, f2d=True, yh=h2)
        ref = K.dsmag_plain(*ds, avg='channel', zper=zper, f2d=True, yh=h2)
        _rel_close(got[0], ref[0], tol)
        for g, q in zip(got[1:], ref[1:]):
            _rel_close(g.sum(-1), q[..., 0], tol)
    torch.cuda.synchronize()
    assert (K.LAUNCHES['mom_rk'], K.LAUNCHES['dsmag_level1'],
            K.LAUNCHES['dsmag_level2'], K.LAUNCHES['dsmag']) == (2, 1, 1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize('own', [(True, False), (False, False),
                                 (False, True)])
@pytest.mark.parametrize('dtype, shape', [
    ('float64', (40, 12, 12)), ('float32', (72, 19, 17)),
    ('float64', (36, 2, 10))])
def test_cuda_walled_slab_scalar_and_twopass_match_twins(dev, dtype, shape,
                                                         own):
    """The y-walled slab of the y-slab mesh (its y-row stacks from
    boundary.slab_ystack: the wall recipe's rows on the side it owns,
    random halo rows elsewhere), on the lower, a middle and the upper slab
    of shapes no tile fits and of 2 rows: mom_rk's y-walled scalar variant
    on the slab's stacks (the scalar's from its own recipe), and the two
    passes' YW + YH modes, dsmag_level1 (the depth-2 halo, the wall
    recipes on the owned sides) and dsmag_level2 ('duct', 'cavity',
    'channel'; alpha^2 2.52 on the owned walls' rows), each against its
    twin: float64 within 1e-12 of each output's maximum, float32 within
    1e-5."""
    from cales_torch.ops import boundary as bnd
    nx, ny, nz = shape
    dt = getattr(torch, dtype)
    tol = 1e-12 if dt == torch.float64 else 1e-5
    cfg = Config(ng=shape, l=(4 * np.pi, 2.0, 2.0), gtype=1, gr=1.0,
                 visci=10_000.0, sgstype='dsmag', dsmag_avg='duct',
                 dtype=dtype, ptransform='mat', scalar=True, pr=0.71,
                 cbcscal=(('P', 'D', 'N'), ('P', 'D', 'N')),
                 bcscal=((0.0, 1.0, 0.0), (0.0, 0.5, 0.0)), **_DUCT_BCS)
    sim = Simulation(cfg, make_grid_from_config(cfg), device=dev)
    rng = np.random.default_rng(43)

    def r(*s, scale=0.05):
        return torch.as_tensor(scale * rng.standard_normal(s), device=dev,
                               dtype=dt)
    u, v, w, p, ru, rv, rw, rso = (r(nz, ny, nx) for _ in range(8))
    s = r(nz, ny, nx, scale=1e-3).abs()
    sca = 0.5 + r(nz, ny, nx, scale=0.2)
    bcs = (sim.bcu_vals, sim.bcv_vals, sim.bcw_vals)
    ue, ve, we = sim._zedge_vel(u, v, w, *bcs)
    se, pe, sce = sim._zedge_s(s), sim._zedge_p(p), sim._zedge_scal(sca)

    def slab(fields, edges, walls, depth=1):
        h = [(r(nz, 2 * depth, nx), r(3, 2 * depth, nx)) for _ in fields]
        return [bnd.slab_ystack(q, e, y, hh, own)
                for q, e, y, hh in zip(fields, edges, walls, h)], h
    K.reset_launches()
    ymom, _ = slab((u, v, w, s, p, sca), (ue, ve, we, se, pe, sce),
                   (*sim._yedge_vel(u, v, w), sim._yedge_s(s),
                    sim._yedge_p(p), sim._yedge_scal(sca)))
    mom = (u, v, w, s, p, ue, ve, we, se, pe, ru, rv, rw, sim.dzci_t,
           sim.dzfi_t, 5e-4, -2e-4, cfg.visc, cfg.dli[0], cfg.dli[1],
           (0.1, 0.0, 0.0))
    sc = dict(sca=sca, scae=sce, rso=rso, scal=sim.scal_params)
    got = K.mom_rk(*mom, sums=(True, False), ye=ymom, **sc)
    ref = K.mom_rk_plain(*mom, sums=(True, False), ye=ymom, **sc)
    for g, q in zip((*got[:6], *got[8:]), (*ref[:6], *ref[8:])):
        _rel_close(g, q, tol)
    yds, h2 = slab((u, v, w), (ue, ve, we), sim._yedge_vel(u, v, w),
                   depth=2)
    lv1 = (u, v, w, ue, ve, we, sim.dzci_t, sim.dzfi_t, cfg.dli[0],
           cfg.dli[1], True, True)
    got = K.dsmag_level1(*lv1, ye=yds, yh=h2, yown=own)
    ref = K.dsmag_level1_plain(*lv1, ye=yds, yh=h2, yown=own)
    for g, q in zip((*got[0], *got[1], *got[2], got[3]),
                    (*ref[0], *ref[1], *ref[2], ref[3])):
        _rel_close(g, q, tol)
    fm, fvel, lij, s0 = ref
    fze = sim._zedge_vel(*fvel, *bcs)
    fye, _ = slab(fvel, fze, sim._yedge_vel(*fvel))
    alph2 = torch.full((nz,), 4.0, dtype=dt, device=dev)
    alph2[0] = alph2[-1] = 2.52
    lv2 = (*fvel, *fze, fm, lij, s0, alph2, sim.dzci_t, sim.dzfi_t,
           cfg.dli[0], cfg.dli[1])
    for avg in ('duct', 'cavity', 'channel'):
        got = K.dsmag_level2(*lv2, avg=avg, ye=fye, yown=own)
        ref = K.dsmag_level2_plain(*lv2, avg=avg, ye=fye, yown=own)
        if avg == 'cavity':
            _rel_close(got, ref, tol)
            continue
        for g, q in zip(got, ref):
            _rel_close(g.sum(-1), q.reshape(q.shape[0], -1).sum(-1)
                       if avg == 'channel' else q[..., 0], tol)
    torch.cuda.synchronize()
    assert (K.LAUNCHES['mom_rk'], K.LAUNCHES['dsmag_level1'],
            K.LAUNCHES['dsmag_level2']) == (1, 1, 3)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype, shape', [
    ('float64', (40, 13, 9)), ('float64', (36, 2, 12)),
    ('float32', (40, 21, 9)), ('float32', (33, 2, 12))])
def test_cuda_slab_full3d_and_xwalled_match_twins(dev, dtype, shape):
    """The slab of the y-slab mesh (random halos) on (nx, nyl, nz) shapes
    no tile fits and slabs of 2 rows: mom_rk's 'xy+z' split with the
    halos (Y_HALO, with and without nu_t, and the scalar variant),
    correc_updatep's halo variant with full-3D alpha L(pp); with x walls
    (the developing channel LES's x stacks of random interiors, and random
    neighbours' rows -1 and nyl for the stacks that carry them) mom_rk's
    XW x Y_HALO (explicit and '1d', with and without nu_t), fillps's and
    correc_updatep's on the slab's own stacks, and smag's with the x
    walls' van Driest inputs, each against its twin: float64 within 1e-12
    of each output's maximum, float32 within 1e-5."""
    from cales_torch.timeloop import _xstacks_on_slab
    nx, ny, nz = shape
    dt = getattr(torch, dtype)
    tol = 1e-12 if dt == torch.float64 else 1e-5
    rng = np.random.default_rng(47)

    def c(q):
        return q.to(dt).contiguous()

    def r(*s, scale=0.1):
        return c(torch.as_tensor(scale * rng.standard_normal(s), device=dev))
    d = _sgs_inputs(dev, shape, 48)
    fields, edges = [c(q) for q in d['fields']], [c(e) for e in d['edges']]
    dzci, dzfi = c(d['dzci']), c(d['dzfi'])
    H = lambda: (r(nz, 2, nx), r(3, 2, nx))  # noqa: E731
    K.reset_launches()
    # full-3D on the slab: mom_rk 'xy+z' (+ the scalar), correc_updatep
    s = r(nz, ny, nx).abs()
    sca, rso = r(nz, ny, nx, scale=1.0), r(nz, ny, nx)
    h1 = tuple(H() for _ in range(6))
    for sgs in (True, False):
        mom = (*fields, s if sgs else None, r(nz, ny, nx), *edges,
               r(3, ny, nx) if sgs else None, r(3, ny, nx),
               *(r(nz, ny, nx) for _ in range(3)), dzci, dzfi, 5e-4, -2e-4,
               d['visc'], d['dxi'], d['dyi'], (0.1, 0.0, 0.0))
        h = h1[:5] if sgs else (*h1[:3], None, h1[4])
        got = K.mom_rk(*mom, sums=(True, False), split='xy+z', yh=h)
        ref = K.mom_rk_plain(*mom, sums=(True, False), split='xy+z', yh=h)
        for g, q in zip(got[:6], ref[:6]):
            _rel_close(g, q, tol)
        _rel_close(got[6].sum(1), ref[6][:, 0], tol)
        scae = torch.stack([r(ny, nx, scale=1.0), sca[-1],
                            r(ny, nx, scale=1.0)])
        sc = dict(sca=sca, scae=scae, rso=rso, scal=(2e-4, 0.05))
        h = h1 if sgs else (*h1[:3], None, *h1[4:])
        got = K.mom_rk(*mom, sums=(True, False), split='xy+z', yh=h, **sc)
        ref = K.mom_rk_plain(*mom, sums=(True, False), split='xy+z', yh=h,
                             **sc)
        for g, q in zip((*got[:6], *got[8:]), (*ref[:6], *ref[8:])):
            _rel_close(g, q, tol)
    pp, p = r(nz, ny, nx), r(nz, ny, nx)
    cor = (*fields, pp, p, edges[2], r(3, ny, nx), 5e-4, d['dxi'], d['dyi'],
           dzci, dzfi)
    ckw = dict(alpha=-3e-4, impdiff=True, impdiff_1d=False, yh=H())
    for g, q in zip(K.correc_updatep(*cor, **ckw),
                    K.correc_updatep_plain(*cor, **ckw)):
        _rel_close(g, q, tol)
    # x walls on the slab
    cfg, _, sim = _xles_sim(dev, 'dev', shape, dtype)
    u, v, w = (1.0 + r(nz, ny, nx)), r(nz, ny, nx), r(nz, ny, nx)
    bcs = sim._dynamic_bcs(u, v, w)
    zq = sim._zedge_vel(u, v, w, *bcs)
    xq = sim._xedge_vel(u, v, w, bcs)
    xs, xp = sim._xedge_s(s), sim._xedge_p(p)
    # the stacks with random neighbours' rows (mom_rk, smag)
    xh = [(r(nz, 2, 3), r(3, 2, 3)) for _ in range(5)]
    xe = _xstacks_on_slab((*xq, xs, xp), xh)
    dxi, dyi = cfg.dli[0], cfg.dli[1]
    for sgs in (True, False):
        for split in (None, '1d'):
            mom = (u, v, w, s if sgs else None, p, *zq,
                   sim._zedge_s(s) if sgs else None, sim._zedge_p(p),
                   *(r(nz, ny, nx) for _ in range(3)), sim.dzci_t,
                   sim.dzfi_t, 5e-4, -2e-4, cfg.visc, dxi, dyi,
                   (0.0, 0.0, 0.0))
            h = h1[:5] if sgs else (*h1[:3], None, h1[4])
            x = xe if sgs else (*xe[:3], None, xe[4])
            got = K.mom_rk(*mom, sums=(True, True), split=split, yh=h, xe=x)
            ref = K.mom_rk_plain(*mom, sums=(True, True), split=split,
                                 yh=h, xe=x)
            for g, q in zip(got[:6], ref[:6]):
                _rel_close(g, q, tol)
    xu2 = sim._xedge_vel(u, v, w, fields=(0, 2))[0]
    fil = (u, v, w, *zq, sim.dzfi_t, 40.0, dxi, dyi)
    hv = H()
    _rel_close(K.fillps(*fil, yh=hv, xu=xu2),
               K.fillps_plain(*fil, yh=hv, xu=xu2), tol)
    cor = (u, v, w, pp, p, zq[2], sim._zedge_p(pp), 5e-4, dxi, dyi,
           sim.dzci_t, sim.dzfi_t)
    ckw = dict(alpha=-3e-4, impdiff=True, impdiff_1d=True, yh=H(),
               xpp=sim._xedge_p(pp), xu=xu2)
    for g, q in zip(K.correc_updatep(*cor, **ckw),
                    K.correc_updatep_plain(*cor, **ckw)):
        _rel_close(g, q, tol)
    planes = tuple(r(nz, ny, scale=1.0).abs() for _ in range(2))
    tz = tuple(r(ny, nx, scale=1.0).abs() for _ in range(2))
    smg = (u, v, w, *zq, sim.dzci_t, sim.dzfi_t, dxi, dyi, cfg.visc,
           sim.csd2_t, sim.dw_t, sim.nearlo_t, *tz)
    skw = dict(yh=h1[:3], xe=xe[:3], xwall=(*sim.xwall_prof, *planes))
    _rel_close(K.smag(*smg, **skw), K.smag_plain(*smg, **skw), tol)
    torch.cuda.synchronize()
    assert (K.LAUNCHES['mom_rk'], K.LAUNCHES['fillps'],
            K.LAUNCHES['correc_updatep'], K.LAUNCHES['smag']) == (8, 1, 2, 1)


@pytest.mark.cuda
@pytest.mark.parametrize('own', [(True, False), (False, False),
                                 (False, True)])
@pytest.mark.parametrize('dtype, shape', [
    ('float64', (40, 13, 9)), ('float64', (36, 2, 12)),
    ('float32', (40, 21, 9)), ('float32', (33, 2, 12))])
def test_cuda_slab_xywalled_scalar_and_wallmodel_match_twins(dev, dtype,
                                                             shape, own):
    """x walls on the y-slab mesh, on (nx, nyl, nz) shapes no tile fits and
    slabs of 2 rows: with y walls (the developing duct LES's stacks of
    random interiors on a slab that owns the walls own: its y-row stacks
    by boundary.slab_ystack, its x stacks by _xstacks_on_slab with random
    neighbours' rows where it owns no wall) mom_rk's XW x Y_WALLS with nu_t,
    fillps, correc_updatep and smag with the y and x walls' van Driest
    inputs; with periodic y mom_rk's SCAL x XW x Y_HALO (explicit and '1d',
    with and without nu_t), and the wall model's XW x YH mode (the
    developing WMLES with its inflow profile, the slab's rows of it, random
    halo rows), each against its twin: float64 within 1e-12 of each
    output's maximum, float32 within 1e-5."""
    from cales_torch import wallmodel as wmod
    from cales_torch.ops import boundary as bnd
    from cales_torch.timeloop import _slab_planes, _xstacks_on_slab
    nx, ny, nz = shape
    dt = getattr(torch, dtype)
    tol = 1e-12 if dt == torch.float64 else 1e-5
    rng = np.random.default_rng(53)

    def r(*s, scale=0.1):
        return torch.as_tensor(scale * rng.standard_normal(s),
                               device=dev).to(dt).contiguous()
    H = lambda: (r(nz, 2, nx), r(3, 2, nx))  # noqa: E731
    K.reset_launches()
    # x and y walls on a slab that owns the walls `own`
    cfg, _, sim = _xles_sim(dev, 'duct', shape, dtype)
    sim.yown = own
    u, v, w = (1.0 + r(nz, ny, nx)), r(nz, ny, nx), r(nz, ny, nx)
    s, p, pp = r(nz, ny, nx).abs(), r(nz, ny, nx), r(nz, ny, nx)
    bcs = (sim.bcu_vals, sim.bcv_vals, sim.bcw_vals)
    z2 = lambda a, b: torch.zeros((a, b), dtype=dt, device=dev)  # noqa: E731
    vlo = (z2(nz + 2, ny + 2), z2(nz + 2, nx + 2), z2(ny + 2, nx + 2))
    zq = sim._zedge_vel(u, v, w, *bcs, vlo=vlo, is_correc=True)
    se, pe, ppe = sim._zedge_s(s), sim._zedge_p(p), sim._zedge_p(pp)
    fields = (u, v, w, s, p)
    edges = (*zq, se, pe)
    walls = (*sim._yedge_vel(u, v, w, bcs, vlo=vlo, is_correc=True),
             sim._yedge_s(s), sim._yedge_p(p))
    ye = [bnd.slab_ystack(q, e, y, H(), own)
          for q, e, y in zip(fields, edges, walls)]
    xown = (*sim._xedge_vel(u, v, w, bcs, vlo=vlo, is_correc=True),
            sim._xedge_s(s), sim._xedge_p(p))
    xe = _xstacks_on_slab(xown, [(r(nz, 2, 3), r(3, 2, 3))
                                 for _ in range(5)], own)
    dxi, dyi = cfg.dli[0], cfg.dli[1]
    mom = (*fields[:3], s, p, *edges, *(r(nz, ny, nx) for _ in range(3)),
           sim.dzci_t, sim.dzfi_t, 5e-4, -2e-4, cfg.visc, dxi, dyi,
           (0.0, 0.0, 0.0))
    got = K.mom_rk(*mom, sums=(True, False), ye=ye, xe=xe)
    ref = K.mom_rk_plain(*mom, sums=(True, False), ye=ye, xe=xe)
    for g, q in zip(got[:6], ref[:6]):
        _rel_close(g, q, tol)
    ze2 = sim._zedge_vel(u, v, w, *bcs)
    yv2 = bnd.slab_ystack(v, ze2[1], sim._yedge_vel(u, v, w)[1], H(), own)
    xu2 = sim._xedge_vel(u, v, w)[0]
    fil = (u, v, w, *ze2, sim.dzfi_t, 40.0, dxi, dyi)
    _rel_close(K.fillps(*fil, yv=yv2, xu=xu2),
               K.fillps_plain(*fil, yv=yv2, xu=xu2), tol)
    ypp = bnd.slab_ystack(pp, ppe, sim._yedge_p(pp), H(), own)
    cor = (u, v, w, pp, p, ze2[2], ppe, 5e-4, dxi, dyi, sim.dzci_t,
           sim.dzfi_t)
    ckw = dict(ypp=ypp, yv=yv2[0], xpp=sim._xedge_p(pp), xu=xu2)
    for g, q in zip(K.correc_updatep(*cor, **ckw),
                    K.correc_updatep_plain(*cor, **ckw)):
        _rel_close(g, q, tol)
    ywall = (sim.dwy_t, sim.nearylo_t, r(nz, nx, scale=1.0).abs(),
             r(nz, nx, scale=1.0).abs())
    xwall = (*sim.xwall_prof, r(nz, ny, scale=1.0).abs(),
             r(nz, ny, scale=1.0).abs())
    tz = tuple(r(ny, nx, scale=1.0).abs() for _ in range(2))
    smg = (u, v, w, *zq, sim.dzci_t, sim.dzfi_t, dxi, dyi, cfg.visc,
           sim.csd2_t, sim.dw_t, sim.nearlo_t, *tz)
    skw = dict(ye=ye[:3], ywall=ywall, xe=xe[:3], xwall=xwall)
    _rel_close(K.smag(*smg, **skw), K.smag_plain(*smg, **skw), tol)
    # the scalar with x walls and periodic y on a slab
    cfg, _, sim = _xles_sim(dev, 'dev', shape, dtype)
    bcs = (sim.bcu_vals, sim.bcv_vals, sim.bcw_vals)
    zq = sim._zedge_vel(u, v, w, *bcs)
    sca, rso = r(nz, ny, nx, scale=1.0), r(nz, ny, nx)
    sce = torch.stack([r(ny, nx, scale=1.0), sca[-1], r(ny, nx, scale=1.0)])
    xsc = bnd.xedge_scalar(sca, (('D', 'N'), ('P', 'P'), ('N', 'N')),
                           ((1.0, 0.0), (0.0, 0.0), (0.0, 0.0)), cfg.dl,
                           sim.grid.dzc)
    h1 = tuple(H() for _ in range(6))
    xs = (*sim._xedge_vel(u, v, w, bcs), sim._xedge_s(s), sim._xedge_p(p),
          xsc)
    xe = _xstacks_on_slab(xs, [(r(nz, 2, 3), r(3, 2, 3)) for _ in range(6)])
    for sgs in (True, False):
        for split in (None, '1d'):
            mom = (u, v, w, s if sgs else None, p, *zq,
                   se if sgs else None, pe,
                   *(r(nz, ny, nx) for _ in range(3)), sim.dzci_t,
                   sim.dzfi_t, 5e-4, -2e-4, cfg.visc, dxi, dyi,
                   (0.0, 0.0, 0.0))
            h = h1 if sgs else (*h1[:3], None, *h1[4:])
            x = xe if sgs else (*xe[:3], None, *xe[4:])
            sc = dict(sca=sca, scae=sce, rso=rso, scal=(2e-4, 0.05))
            got = K.mom_rk(*mom, sums=(True, True), split=split, yh=h, xe=x,
                           **sc)
            ref = K.mom_rk_plain(*mom, sums=(True, True), split=split,
                                 yh=h, xe=x, **sc)
            for g, q in zip((*got[:6], *got[8:]), (*ref[:6], *ref[8:])):
                _rel_close(g, q, tol)
    # the wall model's XW x YH mode: the slab [0, nyl) of a field of 2 nyl
    # rows, its rows of the inflow profile
    cfg, grid, sim = _xles_sim(dev, 'wm', (nx, 2 * ny, nz), dtype)
    bcs = tuple(_slab_planes(b, 0, ny, 2 * ny)
                for b in (sim.bcu_vals, sim.bcv_vals, sim.bcw_vals))
    wm = wmod.wall_model(cfg, grid, sim.index_wm, bcs, sim.cbcvel)
    uq, vq = 1.0 + r(nz, ny, nx), r(nz, ny, nx)
    yh = r(4 * len(wm.faces), 2, nx)
    yh.view(-1, 2, 2, 2, nx)[:, 0] += 1.0      # u's rows
    got = K.wm_planes(uq, vq, wm, yh=yh)
    ref = wmod.wm_planes_plain(uq, vq, wm, yh=yh)
    for g, q in zip(got, ref):
        _rel_close(g, q, 1e-13 if dt == torch.float64 else tol)
    torch.cuda.synchronize()
    assert (K.LAUNCHES['mom_rk'], K.LAUNCHES['fillps'],
            K.LAUNCHES['correc_updatep'], K.LAUNCHES['smag'],
            K.LAUNCHES['wallmodel']) == (5, 1, 1, 1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['mixed_solve', 'duct_dsmag_fft',
                                  'duct_smag_fft'])
def test_card_matches_cpu_fft_routes(dev, case):
    """ptransform 'fft' with y walls (the mixed route: the rfft along x,
    apply_y with the y DCT alone on the real view of its lanes): apply_y
    on the ragged real-view widths 2 (nx/2 + 1) of one device and 2 nkl of
    a slab rank (not multiples of 4: gemm.cuh's 4-byte copies), float64
    within 1e-13 of its twin and float32 within 1e-5 and the 4x rule of
    test_cuda_f32_gemm_on_tensor_cores; the Poisson and w's Helmholtz
    solve on the card against the CPU within 1e-12 of their maximum; the
    dsmag and smag duct at (32, 16, 16), f64, 3 steps: card against CPU as
    test_card_matches_cpu_ywalled_step_for_step holds the 'mat' route."""
    from cales_torch import poisson
    from cales_torch.ops import transforms as tr
    if case == 'mixed_solve':
        ny = 12
        m = tr.make_transform('NN', 'c', ny).fwd_mat
        rng = np.random.default_rng(29)
        for lanes in (2 * (36 // 2 + 1), 2 * 10):
            x = rng.standard_normal((10, ny, lanes))
            xs = {d: torch.as_tensor(x, dtype=d, device=dev)
                  for d in (torch.float64, torch.float32)}
            ms = {d: torch.as_tensor(m, dtype=d, device=dev) for d in xs}
            _rel_close(SK.apply_y(xs[torch.float64], ms[torch.float64]),
                       SK.apply_y_plain(xs[torch.float64],
                                        ms[torch.float64]), 1e-13)
            got = SK.apply_y(xs[torch.float32], ms[torch.float32])
            ref = SK.apply_y_plain(xs[torch.float32], ms[torch.float32])
            _rel_close(got, ref, 1e-5)
            r64 = SK.apply_y_plain(xs[torch.float32].double(),
                                   ms[torch.float32].double())
            assert (float((got.double() - r64).abs().max())
                    <= 4.0 * float((ref.double() - r64).abs().max())), lanes
        cfg = Config(ng=(36, ny, 10), l=(4 * np.pi, 2.0, 2.0), gtype=1,
                     gr=1.0, dtype='float64', ptransform='fft', **DUCT_BCS)
        grid = make_grid_from_config(cfg)
        rhs = rng.standard_normal((10, ny, 36))
        for cbc, cf, alpha in ((('PP', 'NN', 'NN'), ('c', 'c', 'c'), None),
                               (('PP', 'DD', 'DD'), ('c', 'c', 'f'), -0.03)):
            sv = poisson.make_solver(cfg, grid, cbc, cf)
            assert (sv.trx.kind, sv.try_.kind) == ('fft', 'mat')
            got = poisson.solve(sv, torch.as_tensor(rhs, device=dev),
                                alpha=alpha).cpu()
            ref = poisson.solve(sv, torch.as_tensor(rhs), alpha=alpha)
            _rel_close(got - got.mean(), ref - ref.mean(), 1e-12)
        return
    kw = dict(l=(4 * np.pi, 2.0, 2.0), gr=1.0, visci=10_000.0, inivel='duc',
              is_wallturb=True, is_forced=(True, False, False),
              velf=(1.0, 0.0, 0.0), dsmag_avg='duct',
              sgstype='dsmag' if case == 'duct_dsmag_fft' else 'smag')
    cfg = Config(ng=(32, 16, 16), gtype=1, dtype='float64', ptransform='fft',
                 **DUCT_BCS, **kw)
    grid = make_grid_from_config(cfg)
    fields = initflow(cfg, grid)
    sims = [Simulation(cfg, grid, device=d) for d in (dev, 'cpu')]
    states = [s.initial_state(*fields) for s in sims]
    dt = sims[1].pick_dt(sims[1].check(states[1])[0])
    SK.reset_launches()
    for _ in range(3):
        states = [s.step(st, dt)[0] for s, st in zip(sims, states)]
    torch.cuda.synchronize()
    assert SK.LAUNCHES == {'apply_y': 18, 'apply_x': 0, 'z_eig': 0,
                           'thomas_z': 0, 'thomas_periodic': 0}
    g, c = states
    for name, tol in (('u', 1e-11), ('v', 1e-11), ('w', 1e-11), ('p', 1e-10)):
        a, b = getattr(g, name).cpu(), getattr(c, name)
        if name == 'p':
            a, b = a - a.mean(), b - b.mean()
        assert float((a - b).abs().max()) <= tol, name
    for m in (1, 2):
        assert float((g.vlo[m].cpu() - c.vlo[m]).abs().max()) <= 1e-11
    _rel_close(g.visct.cpu(), c.visct, 1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize('yhalo', [True, False], ids=['y halo', 'periodic y'])
@pytest.mark.parametrize('dtype, shape', [
    ('float64', (37, 13, 9)), ('float64', (34, 2, 12)),
    ('float32', (37, 21, 9)), ('float32', (33, 2, 12))])
def test_cuda_pencil_x_halo_variants_match_twins(dev, dtype, shape, yhalo):
    """A pencil of the 2D mesh (random x halos with random rows -1 and nyl,
    and random y halos or, with gy = 1, periodic y) on (nxp, nyl, nz)
    shapes no tile fits and slabs of 2 rows: the x-halo variants (X_HALO)
    of mom_rk (explicit, '1d' and 'xy+z', with and without nu_t), fillps,
    correc_updatep (explicit, impdiff_1d and the full-3D p update, which
    reads pp's x halo on both sides) and smag (z walls' van Driest, and
    the box's no-wall run), each against its twin: float64 within 1e-12
    of each output's maximum, float32 within 1e-5."""
    nx, ny, nz = shape
    dt = getattr(torch, dtype)
    tol = 1e-12 if dt == torch.float64 else 1e-5
    rng = np.random.default_rng(53)

    def c(q):
        return q.to(dt).contiguous()

    def r(*s, scale=0.1):
        return c(torch.as_tensor(scale * rng.standard_normal(s), device=dev))
    d = _sgs_inputs(dev, shape, 54)
    fields, edges = [c(q) for q in d['fields']], [c(e) for e in d['edges']]
    dzci, dzfi = c(d['dzci']), c(d['dzfi'])

    def H():
        return (r(nz, 2, nx), r(3, 2, nx)) if yhalo else None

    def X():
        return (r(nz, 3, ny + 2), r(3, 3, ny + 2))
    K.reset_launches()
    s, p, pp = r(nz, ny, nx).abs(), r(nz, ny, nx), r(nz, ny, nx)
    hy, hx = [H() for _ in range(5)], [X() for _ in range(5)]
    for sgs in (True, False):
        for split in (None, '1d', 'xy+z'):
            mom = (*fields, s if sgs else None, p, *edges,
                   r(3, ny, nx) if sgs else None, r(3, ny, nx),
                   *(r(nz, ny, nx) for _ in range(3)), dzci, dzfi, 5e-4,
                   -2e-4, d['visc'], d['dxi'], d['dyi'], (0.1, 0.0, 0.0))
            yh = None if not yhalo else (
                tuple(hy) if sgs else (*hy[:3], None, hy[4]))
            xh = tuple(hx) if sgs else (*hx[:3], None, hx[4])
            kw = dict(sums=(True, True), split=split, yh=yh, xh=xh)
            got, ref = K.mom_rk(*mom, **kw), K.mom_rk_plain(*mom, **kw)
            for g, q in zip(got[:6], ref[:6]):
                _rel_close(g, q, tol)
            _rel_close(got[6].sum(1), ref[6][:, 0], tol)
            _rel_close(got[7].sum(1), ref[7][:, 0], tol)
    fil = (*fields, *edges, dzfi, 40.0, d['dxi'], d['dyi'])
    fkw = dict(yh=H(), xh=X())
    _rel_close(K.fillps(*fil, **fkw), K.fillps_plain(*fil, **fkw), tol)
    cor = (*fields, pp, p, edges[2], r(3, ny, nx), 5e-4, d['dxi'], d['dyi'],
           dzci, dzfi)
    for imp, imp1 in ((False, False), (True, True), (True, False)):
        ckw = dict(alpha=-3e-4, impdiff=imp, impdiff_1d=imp1, yh=H(),
                   xh=X(), fuv=c(torch.tensor([0.01, -0.02], device=dev)))
        for g, q in zip(K.correc_updatep(*cor, **ckw),
                        K.correc_updatep_plain(*cor, **ckw)):
            _rel_close(g, q, tol)
    tz = tuple(r(ny, nx, scale=1.0).abs() for _ in range(2))
    smg = (*fields, *edges, dzci, dzfi, d['dxi'], d['dyi'], d['visc'],
           c(d['csd2']), c(d['dw']), c(d['nearlo']), *tz)
    skw = dict(yh=tuple(H() for _ in range(3)) if yhalo else None,
               xh=tuple(X() for _ in range(3)))
    _rel_close(K.smag(*smg, **skw), K.smag_plain(*smg, **skw), tol)
    skw['have_zwalls'] = False
    _rel_close(K.smag(*smg, **skw), K.smag_plain(*smg, **skw), tol)
    torch.cuda.synchronize()
    assert (K.LAUNCHES['mom_rk'], K.LAUNCHES['fillps'],
            K.LAUNCHES['correc_updatep'], K.LAUNCHES['smag']) == (6, 1, 3, 2)


@pytest.mark.cuda
@pytest.mark.parametrize('zper', [False, True], ids=['z walls', 'periodic z'])
@pytest.mark.parametrize('yhalo', [True, False], ids=['y halo', 'periodic y'])
@pytest.mark.parametrize('dtype, shape', [
    ('float64', (37, 13, 9)), ('float64', (34, 2, 12)),
    ('float32', (37, 21, 9)), ('float32', (33, 2, 12))])
def test_cuda_pencil_dsmag_x_halo_matches_twin(dev, dtype, shape, yhalo,
                                               zper):
    """dsmag's XH mode (a pencil of the 2D mesh: random two-deep x halos
    (nz, 4, nyl + 4) with their random rows -2, -1, nyl and nyl + 1, and
    random depth-2 y halos or, with gy = 1, periodic y; z walls or the
    box's periodic z, 'channel' and 'dit') on shapes no tile fits and
    slabs of 2 rows against its twin: |S| and the z rows' sums, float64
    within 1e-12 of each output's maximum, float32 within 1e-5."""
    nx, ny, nz = shape
    dt = getattr(torch, dtype)
    tol = 1e-12 if dt == torch.float64 else 1e-5
    rng = np.random.default_rng(55)

    def c(q):
        return q.to(dt).contiguous()

    def r(*s, scale=0.1):
        return c(torch.as_tensor(scale * rng.standard_normal(s), device=dev))
    d = _sgs_inputs(dev, shape, 56)
    fields, edges = [c(q) for q in d['fields']], [c(e) for e in d['edges']]
    a2 = c(torch.full((nz,), 4.0, dtype=torch.float64, device=dev))
    yh = [(r(nz, 4, nx), r(3, 4, nx)) for _ in range(3)] if yhalo else None
    xh = [(r(nz, 4, ny + 4), r(3, 4, ny + 4)) for _ in range(3)]
    K.reset_launches()
    for avg in ('channel', 'dit'):
        args = (*fields, *edges, a2, c(d['dzci']), c(d['dzfi']), d['dxi'],
                d['dyi'], not zper, not zper, (0.01, -0.02, 0.0, 0.03))
        kw = dict(avg=avg, zper=zper, yh=yh, xh=xh)
        got, ref = K.dsmag(*args, **kw), K.dsmag_plain(*args, **kw)
        _rel_close(got[0], ref[0], tol)
        _rel_close(got[1].sum(1), ref[1][:, 0], tol)
        _rel_close(got[2].sum(1), ref[2][:, 0], tol)
    torch.cuda.synchronize()
    assert K.LAUNCHES['dsmag'] == 2


@pytest.mark.cuda
@pytest.mark.parametrize('yhalo', [True, False], ids=['y halo', 'periodic y'])
@pytest.mark.parametrize('dtype, shape', [
    ('float64', (37, 13, 9)), ('float64', (34, 2, 12)),
    ('float32', (37, 21, 9)), ('float32', (33, 2, 12))])
def test_cuda_pencil_twopass_and_2d_filter_x_halo_match_twins(dev, dtype,
                                                              shape, yhalo):
    """The x-halo modes of the two passes and of the 2D test filter on a
    pencil of the 2D mesh (random halos, random y halos or, with gy = 1,
    periodic y; shapes no tile fits and slabs of 2 rows): dsmag_level1's
    XH (two-deep x halos (nz, 4, nyl + 4) over the rows -2 .. nyl + 1;
    its 16 fields), dsmag_level2's XH (the filtered velocity's depth-1 x
    halos in the x stacks' form (nz, 3, nyl + 2); the 'channel' sums) and
    dsmag's F2D x XH (z walls and periodic z; |S| and the sums), each
    against its twin: float64 within 1e-12 of each output's maximum,
    float32 within 1e-5."""
    nx, ny, nz = shape
    dt = getattr(torch, dtype)
    tol = 1e-12 if dt == torch.float64 else 1e-5
    rng = np.random.default_rng(57)

    def c(q):
        return q.to(dt).contiguous()

    def r(*s, scale=0.1):
        return c(torch.as_tensor(scale * rng.standard_normal(s), device=dev))
    d = _sgs_inputs(dev, shape, 58)
    fields, edges = [c(q) for q in d['fields']], [c(e) for e in d['edges']]
    dzci, dzfi = c(d['dzci']), c(d['dzfi'])
    yh2 = [(r(nz, 4, nx), r(3, 4, nx)) for _ in range(3)] if yhalo else None
    xh2 = [(r(nz, 4, ny + 4), r(3, 4, ny + 4)) for _ in range(3)]
    K.reset_launches()
    lv1 = (*fields, *edges, dzci, dzfi, d['dxi'], d['dyi'], True, True)
    kw1 = dict(yh=yh2, xh=xh2)
    got, ref = K.dsmag_level1(*lv1, **kw1), K.dsmag_level1_plain(*lv1, **kw1)
    for g, q in zip([*got[0], *got[1], *got[2], got[3]],
                    [*ref[0], *ref[1], *ref[2], ref[3]]):
        _rel_close(g, q, tol)
    fm = [r(nz, ny, nx) for _ in range(6)]
    lij = [r(nz, ny, nx) for _ in range(6)]
    s0 = r(nz, ny, nx).abs()
    a2 = c(torch.full((nz,), 4.0, dtype=torch.float64, device=dev))
    lv2 = (*(r(nz, ny, nx) for _ in range(3)), *(r(3, ny, nx)
                                                 for _ in range(3)),
           fm, lij, s0, a2, dzci, dzfi, d['dxi'], d['dyi'])
    kw2 = dict(avg='channel',
               yh=[(r(nz, 2, nx), r(3, 2, nx)) for _ in range(3)]
               if yhalo else None,
               xh=[(r(nz, 3, ny + 2), r(3, 3, ny + 2)) for _ in range(3)])
    got, ref = K.dsmag_level2(*lv2, **kw2), K.dsmag_level2_plain(*lv2, **kw2)
    for g, q in zip(got, ref):
        _rel_close(g.sum(1), q[:, 0], tol)
    a252 = c(torch.full((nz,), 2.52, dtype=torch.float64, device=dev))
    for zper in (False, True):
        args = (*fields, *edges, a252, dzci, dzfi, d['dxi'], d['dyi'],
                not zper, not zper, (0.01, -0.02, 0.0, 0.03))
        kw = dict(avg='dit' if zper else 'channel', zper=zper, f2d=True,
                  yh=yh2, xh=xh2)
        got, ref = K.dsmag(*args, **kw), K.dsmag_plain(*args, **kw)
        _rel_close(got[0], ref[0], tol)
        _rel_close(got[1].sum(1), ref[1][:, 0], tol)
        _rel_close(got[2].sum(1), ref[2][:, 0], tol)
    torch.cuda.synchronize()
    assert (K.LAUNCHES['dsmag_level1'], K.LAUNCHES['dsmag_level2'],
            K.LAUNCHES['dsmag']) == (1, 1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize('own', [(True, False), (False, True), (False, False),
                                 (True, True)],
                         ids=['lower', 'upper', 'middle', 'both'])
@pytest.mark.parametrize('dtype, shape', [
    ('float64', (37, 13, 9)), ('float64', (34, 2, 12)),
    ('float32', (37, 21, 9)), ('float32', (33, 2, 12))])
def test_cuda_pencil_ywalled_x_halo_variants_match_twins(dev, dtype, shape,
                                                         own):
    """The y walls' x-halo modes on a pencil of the 2D mesh (random y-row
    stacks, random x halos with random rows -1 and nyl, and for dsmag
    random depth-2 y halos, two-deep x halos and the walls the pencil
    holds; shapes no tile fits and pencils of 2 rows): mom_rk's Y_WALLS x
    X_HALO (explicit, with and without nu_t, and its scalar variant),
    fillps's, correc_updatep's (the deferred forcing) and smag's (the y
    walls' van Driest), and dsmag's YW + YH x XH ('duct', 'cavity',
    'channel'), each against its twin: float64 within 1e-12 of each
    output's maximum, float32 within 1e-5."""
    from cales_torch.ops import boundary as bnd
    nx, ny, nz = shape
    dt = getattr(torch, dtype)
    tol = 1e-12 if dt == torch.float64 else 1e-5
    rng = np.random.default_rng(61)

    def c(q):
        return q.to(dt).contiguous()

    def r(*s, scale=0.1):
        return c(torch.as_tensor(scale * rng.standard_normal(s), device=dev))
    d = _sgs_inputs(dev, shape, 62)
    fields, edges = [c(q) for q in d['fields']], [c(e) for e in d['edges']]
    dzci, dzfi = c(d['dzci']), c(d['dzfi'])

    def Y(scale=0.1):
        return (r(nz, 3, nx, scale=scale), r(3, 3, nx, scale=scale))

    def X():
        return (r(nz, 3, ny + 2), r(3, 3, ny + 2))
    K.reset_launches()
    s, p, pp = r(nz, ny, nx).abs(), r(nz, ny, nx), r(nz, ny, nx)
    ys, xs = [Y() for _ in range(5)], [X() for _ in range(5)]
    ys[3] = tuple(q.abs() for q in ys[3])
    # the scalar's edge stack and y-row stack as a fill leaves them: their
    # row 1 its last plane and last row (the update reads them there)
    sca = r(nz, ny, nx, scale=0.3).abs()
    scae = torch.stack([r(ny, nx, scale=0.3), sca[-1],
                        r(ny, nx, scale=0.3)])
    ysc = Y(0.3)
    ysc[0][:, 1], ysc[1][:, 1] = sca[:, -1], scae[:, -1]
    for sgs in (True, False):
        for scal in (False, True):
            mom = (*fields, s if sgs else None, p, *edges,
                   r(3, ny, nx) if sgs else None, r(3, ny, nx),
                   *(r(nz, ny, nx) for _ in range(3)), dzci, dzfi, 5e-4,
                   -2e-4, d['visc'], d['dxi'], d['dyi'], (0.1, 0.0, 0.0))
            ye = tuple(ys) if sgs else (*ys[:3], None, ys[4])
            xh = tuple(xs) if sgs else (*xs[:3], None, xs[4])
            kw = dict(sums=(True, True), ye=ye, xh=xh)
            if scal:
                kw.update(ye=(*ye, ysc), xh=(*xh, X()), sca=sca,
                          scae=scae, rso=r(nz, ny, nx),
                          scal=(d['visc'] / 0.71, 0.02))
            got, ref = K.mom_rk(*mom, **kw), K.mom_rk_plain(*mom, **kw)
            for g, q in zip((*got[:6], *got[8:]), (*ref[:6], *ref[8:])):
                _rel_close(g, q, tol)
            _rel_close(got[6].sum(1), ref[6][:, 0], tol)
    fil = (*fields, *edges, dzfi, 40.0, d['dxi'], d['dyi'])
    fkw = dict(yv=ys[1], xh=xs[0])
    _rel_close(K.fillps(*fil, **fkw), K.fillps_plain(*fil, **fkw), tol)
    cor = (*fields, pp, p, edges[2], r(3, ny, nx), 5e-4, d['dxi'], d['dyi'],
           dzci, dzfi, c(torch.tensor([0.01, -0.02], device=dev)))
    ckw = dict(ypp=Y(), yv=ys[1][0], xh=X())
    for g, q in zip(K.correc_updatep(*cor, **ckw),
                    K.correc_updatep_plain(*cor, **ckw)):
        _rel_close(g, q, tol)
    tz = tuple(r(ny, nx, scale=1.0).abs() for _ in range(2))
    ty = tuple(r(nz, nx, scale=1.0).abs() for _ in range(2))
    smg = (*fields, *edges, dzci, dzfi, d['dxi'], d['dyi'], d['visc'],
           c(d['csd2']), c(d['dw']), c(d['nearlo']), *tz)
    skw = dict(ye=tuple(ys[:3]), xh=tuple(xs[:3]),
               ywall=(c(0.05 + r(ny).abs()),
                      c(torch.as_tensor((np.arange(ny) < ny / 2) * 1.0,
                                        device=dev)), *ty))
    _rel_close(K.smag(*smg, **skw), K.smag_plain(*smg, **skw), tol)
    a2 = c(torch.full((nz,), 4.0, dtype=torch.float64, device=dev))
    yh2 = [(r(nz, 4, nx), r(3, 4, nx)) for _ in range(3)]
    xh2 = [(r(nz, 4, ny + 4), r(3, 4, ny + 4)) for _ in range(3)]
    args = (*fields, *edges, a2, dzci, dzfi, d['dxi'], d['dyi'], True, True,
            (0.01, -0.02, 0.0, 0.03))
    # the pencil's y-row stacks as the step composes them: the wall rows on
    # the sides it holds, the y halo's rows and its own last row elsewhere
    yds = tuple(bnd.slab_ystack(q, e, y, h, own)
                for q, e, y, h in zip(fields, edges, ys[:3], yh2))
    for avg in ('duct', 'cavity', 'channel'):
        kw = dict(ye=yds, yh=yh2, yown=own, xh=xh2, avg=avg,
                  yvals=(0.02, -0.01, 0.0, 0.01))
        got, ref = K.dsmag(*args, **kw), K.dsmag_plain(*args, **kw)
        _rel_close(got[0], ref[0], tol)
        if avg == 'duct':
            _rel_close(got[1].sum(-1), ref[1][..., 0], tol)
            _rel_close(got[2].sum(-1), ref[2][..., 0], tol)
        elif avg == 'channel':
            _rel_close(got[1].sum(1), ref[1][:, 0], tol)
            _rel_close(got[2].sum(1), ref[2][:, 0], tol)
    torch.cuda.synchronize()
    assert (K.LAUNCHES['mom_rk'], K.LAUNCHES['fillps'],
            K.LAUNCHES['correc_updatep'], K.LAUNCHES['smag'],
            K.LAUNCHES['dsmag']) == (4, 1, 1, 1, 3)


@pytest.mark.cuda
@pytest.mark.parametrize('yhalo', [True, False], ids=['y halo', 'periodic y'])
@pytest.mark.parametrize('dtype, shape', [
    ('float64', (37, 13, 9)), ('float64', (34, 2, 12)),
    ('float32', (37, 21, 9)), ('float32', (33, 2, 12))])
def test_cuda_pencil_scalar_x_halo_matches_twin(dev, dtype, shape, yhalo):
    """mom_rk's SCAL x X_HALO variants on a pencil of the 2D mesh (random x
    halos with random rows -1 and nyl, the scalar's the sixth pair; random
    y halos or, with gy = 1, periodic y), each split, with and without
    nu_t, on the first substep and a later one, against the twin: float64
    within 1e-12 of each output's maximum, float32 within 1e-5."""
    nx, ny, nz = shape
    dt = getattr(torch, dtype)
    tol = 1e-12 if dt == torch.float64 else 1e-5
    rng = np.random.default_rng(59)

    def c(q):
        return q.to(dt).contiguous()

    def r(*s, scale=0.1):
        return c(torch.as_tensor(scale * rng.standard_normal(s), device=dev))
    d = _sgs_inputs(dev, shape, 60)
    fields, edges = [c(q) for q in d['fields']], [c(e) for e in d['edges']]
    dzci, dzfi = c(d['dzci']), c(d['dzfi'])
    s, p = r(nz, ny, nx).abs(), r(nz, ny, nx)
    sca = r(nz, ny, nx, scale=1.0).abs()
    hy = [(r(nz, 2, nx), r(3, 2, nx)) for _ in range(6)]
    hx = [(r(nz, 3, ny + 2), r(3, 3, ny + 2)) for _ in range(6)]
    K.reset_launches()
    n = 0
    for sgs in (True, False):
        for split in (None, '1d', 'xy+z'):
            for first in (True, False):
                old = ((None,) * 3 if first
                       else tuple(r(nz, ny, nx) for _ in range(3)))
                mom = (*fields, s if sgs else None, p, *edges,
                       r(3, ny, nx) if sgs else None, r(3, ny, nx), *old,
                       dzci, dzfi, 5e-4, 0.0 if first else -2e-4,
                       d['visc'], d['dxi'], d['dyi'], (0.1, 0.0, 0.0))
                keep = (lambda q: q) if sgs else (
                    lambda q: (*q[:3], None, *q[4:]))
                # the scalar's edge stack as a fill leaves it: row 1 (the
                # rewrite slot of the z-staggered w) is the last plane,
                # which the update reads in place of the field's
                scae = torch.stack([r(ny, nx, scale=1.0), sca[-1],
                                    r(ny, nx, scale=1.0)])
                kw = dict(sums=(True, True), split=split,
                          yh=keep(tuple(hy)) if yhalo else None,
                          xh=keep(tuple(hx)), sca=sca, scae=scae,
                          rso=None if first else r(nz, ny, nx),
                          scal=(d['visc'] / 0.71, 0.05))
                got = K.mom_rk(*mom, **kw)
                ref = K.mom_rk_plain(*mom, **kw)
                for g, q in zip((*got[:6], *got[8:]), (*ref[:6], *ref[8:])):
                    _rel_close(g, q, tol)
                _rel_close(got[6].sum(1), ref[6][:, 0], tol)
                n += 1
    torch.cuda.synchronize()
    assert K.LAUNCHES['mom_rk'] == n
