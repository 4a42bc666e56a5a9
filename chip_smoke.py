"""Smoke run of cales_torch on one NVIDIA GPU: build the CUDA kernels,
hold each against its plain PyTorch twin, drive the channel-LES slice
through the CLI and through cales_torch.driver.run at 512x256x256, and
compare the card with the CPU step for step.

    python3 chip_smoke.py            # all phases, one card

Exits non-zero without a CUDA device, or when any phase fails.  The last
line of standard output is {"ok": true, "device": {...}}; the line before
it is the card's name and power limit, and before that one JSON object
with each kernel's launches, error against its twin and times.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 20261016
KERNELS = {
    'mom_rk': ('cales_torch/csrc/mom_rk.cu',
               'cales_tpu/ops/pallas_kernels.py:784'),
    'fillps': ('cales_torch/csrc/fillps.cu',
               'cales_tpu/ops/pallas_kernels.py:1182'),
    'correc_smag': ('cales_torch/csrc/correc_smag.cu',
                    'cales_tpu/ops/pallas_kernels.py:1406'),
}
HEADLINE_NG = (512, 256, 256)


def card_line():
    res = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def say(msg):
    print(msg, flush=True)


class Failure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise Failure(msg)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def kernel_inputs(ng, dtype, dev, seed, big=False):
    """Random interiors, edges and profiles for the three kernels at
    (nx, ny, nz) = ng, on a stretched channel grid.  Small shapes draw from
    numpy; the headline shape from a seeded torch generator on the card
    (numpy would spend most of the phase making 30 fields on the host)."""
    from cales_tpu.config import Config, C_SMAG
    from cales_tpu.grid import make_grid_from_config
    from cales_torch import sgs as sgsmod
    from cales_tpu.config import effective_cbcvel
    nx, ny, nz = ng
    cfg = Config(ng=ng, l=(2 * np.pi, np.pi, 2.0), gtype=1, gr=1.0,
                 visci=1000.0)
    grid = make_grid_from_config(cfg)
    if big:
        gen = torch.Generator(device=dev).manual_seed(seed)

        def rnd(*shape, scale=0.02):
            return scale * torch.randn(shape, generator=gen, device=dev,
                                       dtype=dtype)
    else:
        rng = np.random.default_rng(seed)

        def rnd(*shape, scale=0.02):
            return torch.as_tensor(scale * rng.standard_normal(shape),
                                   dtype=dtype, device=dev)
    f = lambda: rnd(nz, ny, nx)          # noqa: E731
    e = lambda: rnd(3, ny, nx)           # noqa: E731
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,  # noqa: E731
                                  device=dev)
    setup = sgsmod.SGSSetup(cfg, grid, effective_cbcvel(cfg))
    zc = grid.zc[1:nz + 1]
    d = dict(u=f(), v=f(), w=f(), s=f().abs(), p=f(), ue=e(), ve=e(),
             we=e(), se=e().abs(), pe=e(), ruo=f(), rvo=f(), rwo=f(),
             pp=f(), ppe=e(), tauw_lo=rnd(ny, nx).abs(),
             tauw_hi=rnd(ny, nx).abs(),
             dzci=t(grid.dzci), dzfi=t(grid.dzfi),
             csd2=t((C_SMAG * setup.delta) ** 2),
             dw=t(np.minimum(zc, cfg.l[2] - zc)),
             nearlo=t((zc <= cfg.l[2] - zc).astype(np.float64)),
             fuv=t([0.05, -0.02]), dxi=cfg.dli[0], dyi=cfg.dli[1],
             visc=cfg.visc, dz01=(float(grid.dzc[0]), float(grid.dzc[nz])))
    return d


def call(name, d, twin=False, has_ruo=True, zrec=None):
    """One kernel's wrapper (twin=False) or its plain twin (twin=True) on
    the inputs d; returns {output name: tensor}."""
    from cales_torch.ops import kernels as K
    fn = getattr(K, f'{name}_plain' if twin else name)
    if name == 'mom_rk':
        r = (d['ruo'], d['rvo'], d['rwo']) if has_ruo else (None,) * 3
        out = list(fn(d['u'], d['v'], d['w'], d['s'], d['p'], d['ue'],
                      d['ve'], d['we'], d['se'], d['pe'], *r, d['dzci'],
                      d['dzfi'], 2.1e-3, -1.1e-3, d['visc'], d['dxi'],
                      d['dyi'], (0.3, 0.0, 0.0), sums=(True, True)))
        # partial sums: compare the per-plane totals
        out[6], out[7] = out[6].sum(dim=1), out[7].sum(dim=1)
        return dict(zip(('u', 'v', 'w', 'ru', 'rv', 'rw', 'usum', 'vsum'),
                        out))
    if name == 'fillps':
        return {'rhs': fn(d['u'], d['v'], d['w'], d['ue'], d['ve'], d['we'],
                          d['dzfi'], 1.0, d['dxi'], d['dyi'])}
    zrec = zrec or (('D', 0.0, d['dz01'][0], 'D', 0.0, d['dz01'][1]),) * 2
    out = fn(d['u'], d['v'], d['w'], d['pp'], d['p'], d['ue'], d['ve'],
             d['we'], d['ppe'], 0.01, d['dxi'], d['dyi'], d['dzci'],
             d['dzfi'], d['visc'], d['csd2'], zrec, d['fuv'], d['dw'],
             d['nearlo'], d['tauw_lo'], d['tauw_hi'])
    return dict(zip(('u', 'v', 'w', 'p', 'visct'), out))


def compare(name, d, tol_abs=None, tol_rel=None, **kw):
    """Kernel against its twin, both on the card with the same inputs;
    returns the worst error over the outputs."""
    got = call(name, d, **kw)
    ref = call(name, d, twin=True, **kw)
    torch.cuda.synchronize()
    worst = 0.0
    for key in got:
        err = float((got[key] - ref[key]).abs().max())
        scale = float(ref[key].abs().max())
        worst = max(worst, err)
        bound = tol_abs if tol_abs is not None else tol_rel * scale
        say(f'  {name:<12s} {key:<5s} max|err| {err:.3e}  '
            f'(max|ref| {scale:.3e}, bound {bound:.1e})')
        require(np.isfinite(err) and err <= bound,
                f'{name}.{key}: error {err:.3e} above {bound:.1e}')
    return worst


def time_ms(fn, n=10):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_kernels(dev, card):
    """Kernel vs twin: small non-aligned shape in f64 and f32 (indexing
    to round-off), then the headline shape in f32 on the card with the
    kernel's and the twin's times."""
    from cales_torch.ops import kernels as K
    small = (72, 40, 48)
    for dtype, tol_abs, tol_rel in ((torch.float64, 1e-12, None),
                                    (torch.float32, None, 1e-5)):
        d = kernel_inputs(small, dtype, dev, SEED)
        say(f'phase 2: kernels vs twins, (nx, ny, nz) = {small}, {dtype}')
        for has_ruo in (False, True):
            compare('mom_rk', d, tol_abs, tol_rel, has_ruo=has_ruo)
        compare('fillps', d, tol_abs, tol_rel)
        compare('correc_smag', d, tol_abs, tol_rel)
        zn = (('N', 0.3, d['dz01'][0], 'N', -0.2, d['dz01'][1]),
              ('D', 0.1, d['dz01'][0], 'N', 0.05, d['dz01'][1]))
        compare('correc_smag', d, tol_abs, tol_rel, zrec=zn)
    say(f'phase 2b: kernels vs twins on the card at (nx, ny, nz) = '
        f'{HEADLINE_NG}, float32  [{card}]')
    d = kernel_inputs(HEADLINE_NG, torch.float32, dev, SEED + 1, big=True)
    rows = {}
    for name in K.LAUNCHES:
        worst = compare(name, d, tol_rel=1e-5)
        ms = time_ms(lambda: call(name, d))
        plain_ms = time_ms(lambda: call(name, d, twin=True))
        say(f'  {name:<12s} kernel {ms:.3f} ms, plain twin {plain_ms:.3f} ms '
            f'per call  [{card}]')
        rows[name] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms)
        torch.cuda.empty_cache()
    return rows


def phase_cli(card):
    """The example case through the CLI, in a subprocess."""
    nml = ROOT / 'examples' / 'turbulent_channel_les' / 'input.nml'
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, '-m', 'cales_torch', str(nml), '--max-steps',
               '20', '--datadir', tmp]
        say(f'phase 3: {" ".join(cmd[1:])}  [{card}]')
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                             timeout=600)
        say(f'  exit {res.returncode} after {time.perf_counter() - t0:.1f} s')
        lines = res.stdout.splitlines()
        for line in lines[:3] + lines[-3:]:
            say(f'  | {line}')
        require(res.returncode == 0, f'CLI failed:\n{res.stderr[-3000:]}')
        path = [ln for ln in lines if 'Execution path' in ln]
        require(path and all(k in path[0] for k in KERNELS),
                'the Execution path line does not name the three kernels')
        require((Path(tmp) / 'fld.bin').exists(), 'no fld.bin written')


def phase_headline(dev, card):
    """The slice at 512x256x256 f32 through cales_torch.driver.run, then a
    timed loop of steps."""
    from cales_tpu.config import Config
    from cales_torch import driver
    from cales_torch.ops import kernels as K
    from cales_torch.ops.stencil import bulk_mean
    cfg = Config(ng=HEADLINE_NG, l=(2 * np.pi, np.pi, 2.0), gtype=1, gr=1.0,
                 visci=20_000.0, inivel='log', is_wallturb=True,
                 is_forced=(True, False, False), velf=(1.0, 0.0, 0.0),
                 sgstype='smag', dtype='float32', ptransform='fft')
    nsteps = 31     # one warm-up step + 30
    nx, ny, nz = HEADLINE_NG
    say(f'phase 4: driver.run, {HEADLINE_NG} float32, {nsteps} steps  '
        f'[{card}]')
    torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory() as tmp:
        K.reset_launches()
        t0 = time.perf_counter()
        sim, state = driver.run(cfg, datadir=tmp, device=dev,
                                max_steps=nsteps, verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
    say(f'  driver.run: {wall:.1f} s host wall (setup, checks and I/O '
        f'included); launches {launches}')
    for name in KERNELS:
        require(launches[name] == 3 * nsteps,
                f'{name}: {launches[name]} launches, want {3 * nsteps}')
    dt_cfl, divtot, divmax = sim.check(state)
    dt = sim.pick_dt(dt_cfl)
    n = 30
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(n):
        state, _ = sim.step(state, dt)
    b.record()
    torch.cuda.synchronize()
    ms = a.elapsed_time(b) / n
    ns = ms * 1e6 / (nx * ny * nz * 3)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    dt_cfl, divtot, divmax = sim.check(state)
    ub = float(bulk_mean(state.u, sim.gvr_f))
    small = float(np.sqrt(np.finfo(np.float32).eps) * 10)
    say(f'  {ms:.3f} ms/step, {ns:.4f} ns/cell/RK3-substep over {n} steps '
        f'(CUDA events)  [{card}]')
    say(f'  peak memory {peak:.2f} GiB (max_memory_allocated)  [{card}]')
    say(f'  after {nsteps + n} steps: divmax {divmax:.3e} (abort bound '
        f'{small:.3e}), bulk u {ub:.6f}, dt {dt:.4e}')
    fields = [state.u, state.v, state.w, state.p, state.visct]
    require(all(bool(torch.isfinite(f).all()) for f in fields),
            'non-finite field after the headline run')
    require(divmax <= small, f'divmax {divmax:.3e} above {small:.3e}')
    print(json.dumps({'headline': dict(
        ng=HEADLINE_NG, ms_per_step=ms, ns_per_cell_substep=ns,
        peak_gib=peak, divmax=divmax, bulk_u=ub, card=card)}), flush=True)
    return launches


def phase_card_vs_cpu(dev):
    """3 steps of a small f64 channel on the card (kernels) and on the CPU
    (twins), then the same in f32 on the card."""
    from cales_tpu.config import Config
    from cales_tpu.grid import make_grid_from_config
    from cales_tpu.initflow import initflow
    from cales_torch.timeloop import Simulation
    cfg = Config(ng=(64, 32, 32), l=(2 * np.pi, np.pi, 2.0), gtype=1, gr=1.0,
                 visci=20_000.0, inivel='log', is_wallturb=True,
                 is_forced=(True, False, False), velf=(1.0, 0.0, 0.0),
                 sgstype='smag', dtype='float64', ptransform='fft')
    grid = make_grid_from_config(cfg)
    u, v, w, p = initflow(cfg, grid)
    sims = [Simulation(cfg, grid, device=dv) for dv in (dev, 'cpu')]
    states = [s.initial_state(u, v, w, p) for s in sims]
    dt = sims[1].pick_dt(sims[1].check(states[1])[0])
    for _ in range(3):
        states = [s.step(st, dt)[0] for s, st in zip(sims, states)]
    say('phase 5: card vs CPU, (64, 32, 32) float64, 3 steps')
    g, c = states
    for name, tol in (('u', 1e-11), ('v', 1e-11), ('w', 1e-11),
                      ('p', 1e-10), ('visct', 1e-12)):
        a = getattr(g, name).cpu()
        b = getattr(c, name)
        if name == 'p':
            a, b = a - a.mean(), b - b.mean()
        err = float((a - b).abs().max())
        say(f'  {name:<5s} max|card - cpu| {err:.3e} (bound {tol:.0e})')
        require(err <= tol, f'card vs CPU {name}: {err:.3e} above {tol:.0e}')
    # the working precision: float32 on the card against the float64 CPU
    # run, relative to each field's maximum (f32 rounding over 9 substeps)
    s32 = Simulation(cfg.replace(dtype='float32'), grid, device=dev)
    st32 = s32.initial_state(u, v, w, p)
    for _ in range(3):
        st32, _ = s32.step(st32, dt)
    for name in ('u', 'v', 'w', 'p', 'visct'):
        a = getattr(st32, name).double().cpu()
        b = getattr(c, name)
        if name == 'p':
            a, b = a - a.mean(), b - b.mean()
        rel = float((a - b).abs().max() / b.abs().max())
        say(f'  {name:<5s} max|card f32 - cpu f64| / max|cpu| {rel:.3e} '
            '(bound 1e-4)')
        require(rel <= 1e-4, f'f32 card vs f64 CPU {name}: {rel:.3e}')


def main():
    say(f'python {sys.version.split()[0]}, torch {torch.__version__}, '
        f'CUDA {torch.version.cuda}, cuda available: '
        f'{torch.cuda.is_available()}')
    if not torch.cuda.is_available():
        say('no CUDA device: chip_smoke needs an NVIDIA GPU')
        return 2
    card = card_line()
    say(f'phase 0: {card}')
    sys.path.insert(0, str(ROOT))
    from cales_torch import device as devmod
    from cales_torch.ops import build
    dev = devmod.resolve('cuda')
    t0 = time.perf_counter()
    build.build(verbose=True)
    build.load()
    say(f'phase 1: kernels built and loaded in {time.perf_counter() - t0:.1f} s '
        f'({build.BUILD_ROOT / build.source_hash()})')
    rows = phase_kernels(dev, card)
    phase_cli(card)
    launches = phase_headline(dev, card)
    phase_card_vs_cpu(dev)
    report = {'kernels': [
        dict(name=name, route='cuda', source=KERNELS[name][0],
             replaces=KERNELS[name][1], launches=launches[name], **rows[name])
        for name in KERNELS]}
    print(json.dumps(report), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
