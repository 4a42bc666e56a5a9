"""Where the time of one RK3 step goes on the card.

    python -m cales_torch.profile_step
        [--case les|les-mat|les-imp|dns|dns-imp3d|dsmag|dsmag-blow|duct|
                cavity|duct-fft|tgv|tgv-fft|tri|tri-imp3d|wmles|wmles-duct|
                xchannel|xcavity|xwmles|xles-imp|xduct-les|les-scal|
                tgv-les|tgv-dsmag]
        [--ng NXxNYxNZ]
        [--steps 3]

Steps one of the channel configurations under torch.profiler and prints
the device time per kernel and per stage: the CUDA kernels, the Poisson
solve, and the torch glue (edge stacks, wall-shear planes, forcing).
Cases: 'les' bench.py's channel-LES headline with ptransform='fft' (cuFFT
and z eigen-matmuls); 'les-mat' the same with bench.py's own
ptransform='mat' (apply_y + z_eig); 'les-imp' the same with z-implicit
diffusion (impdiff_1d: thomas_z CN solves, nu_t from the smag kernel);
'dns' the implicit-CN channel DNS (channel_dns_impdiff: apply_y + z_eig,
thomas_z CN solves); 'dsmag' the dynamic-Smagorinsky channel of
validation/dsmag_channel.py (impdiff_1d, 'mat', the dsmag kernel); 'duct'
and 'cavity' bench.py's duct_les_dsmag and cavity_les_dsmag (y and z
walls, explicit diffusion, 'mat', the y-walled kernel variants and the
dsmag kernel's 'duct' and 'cavity' averages); 'dsmag-blow' the 'dsmag'
channel with transpiring walls (w = 0.003 through both z walls, which
only the two-pass dsmag carries: dsmag_level1, dsmag_level2); with
CALES_DSMAG_TWOPASS=1 in the environment 'dsmag', 'duct' and 'cavity'
take the two passes too; 'duct-fft' the 'duct' by ptransform 'fft', the
mixed Poisson route (cuFFT along x, apply_y with the y DCT alone on the
real view of the rfft's lanes, the z eigen-matmuls); 'dns-imp3d' the
channel DNS
with full-3D implicit diffusion (a Helmholtz solve per component, thomas_z
with the lam shift); 'tgv' the Taylor-Green vortex of
examples/taylor_green_vortex_3d at 512^3 with ptransform='mat' (apply_y and
the periodic Thomas kernel from nz >= 384), 'tgv-fft' the same by 'fft'
(the example's 'auto'); 'tri' bench.py's triperiodic_dns ('mat', z_eig)
and 'tri-imp3d' the same with full-3D implicit diffusion (thomas_periodic
Helmholtz solves); 'wmles' bench.py's wmles_channel (the log-law wall model
on both z walls, hwm 0.1, visci 125 000, smag, 'mat': the wallmodel kernel
and correc_smag's 'E' z-ghost recipe); 'wmles-duct' the physics of
examples/turbulent_duct_wmles (the log-law wall model on all four side
walls, hwm 0.1, visci 20 000, smag, 'mat': the wallmodel kernel on four
faces, smag's y-wall variant with its 'E' ghost stacks, the y-walled
mom_rk, fillps and correc_updatep); 'xchannel' the physics of
examples/developing_channel (inflow u = 1 at x = 0, outflow at x = lx,
periodic y, z walls, sgstype 'none', 'auto' -> 'mat': the x-walled mom_rk,
fillps and correc_updatep on the x stacks, apply_y with the DCT-IV x
operator) and 'xcavity' examples/lid_driven_cavity's (walls on all six
faces, the top z face moving at u = 1: the x- and y-walled variants, the
DCT-II x and y operators); 'xwmles' the developing wall-modelled channel
LES (6.4 x 3.2 x 2, gtype 6, visci 50 000, smag, the log-law wall model on
both z walls at hwm 0.1, a 1/7-power inflow profile, outflow, periodic y:
the x-walled mom_rk with nu_t, smag's x-wall variant on the 'E' x
stacks, the wall model's x-walled sampling; the physics of
tests/test_pallas_kernels.py:538), 'xles-imp' the developing channel LES
with z-implicit diffusion (visci 20 000, smag, impdiff_1d: mom_rk's
x-walled '1d' split, thomas_z CN solves) and 'xduct-les' the developing
duct LES (smag's x- and y-wall variant); 'les-scal' the 'les-mat'
headline with a passive scalar (Pr 0.71, s 0 on the lower z wall and 1 on
the upper one, from s = 0: mom_rk's scalar variant); 'tgv-les' and
'tgv-dsmag' the Taylor-Green vortex's LES on the example's 'auto' route
('fft'): static Smagorinsky (the smag kernel without walls: no van
Driest) and dynamic Smagorinsky with the 'dit' average (the dsmag
kernel's periodic-z mode, one ratio for the volume).  The grid is
512x256x256, 512^3 for the tgv cases, unless --ng says otherwise.  The
device's idle share is 1 - (device busy time / wall time of the profiled
window).
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

STAGES = (
    ('mom_rk', ('mom_rk_kernel',)),
    ('fillps', ('fillps_kernel',)),
    ('correc_smag', ('correc_smag_kernel',)),
    ('correc_updatep', ('cales::correc_kernel',)),
    # z_eig's float32 products are gemm.cuh's with its ZEig epilogues, so
    # it is matched first
    ('solve: z_eig', ('z_eig_kernel', 'ZEig')),
    # gemm.cuh: the float32 tensor-core body and the float64 SIMT one
    ('solve: apply_y', ('gemm_tf32x3_kernel<', 'gemm_kernel<')),
    ('thomas_z', ('thomas_z_kernel',)),
    ('thomas_periodic', ('thomas_periodic_kernel',)),
    ('smag', ('cales::smag_kernel',)),
    ('dsmag_level1', ('dsmag_level1_kernel',)),
    ('dsmag_level2', ('dsmag_level2_kernel',)),
    ('dsmag', ('dsmag_kernel',)),
    ('wallmodel', ('wallmodel_kernel',)),
    ('solve: fft', ('fft', 'FFT', 'regular_fft', 'vector_fft', 'radix')),
    ('solve: z matmul', ('gemm', 'Gemm', 'sm90_', 'cutlass', 'ampere_sgemm',
                         'sgemm')),
)
CHAN_BCS = dict(
    cbcvel=((('P', 'P', 'P'), ('P', 'P', 'P'), ('D', 'D', 'D')),) * 2,
    cbcpre=(('P', 'P', 'N'), ('P', 'P', 'N')),
    cbcsgs=(('P', 'P', 'D'), ('P', 'P', 'D')))
DUCT_BCS = dict(
    cbcvel=((('P', 'P', 'P'), ('D', 'D', 'D'), ('D', 'D', 'D')),) * 2,
    cbcpre=(('P', 'N', 'N'), ('P', 'N', 'N')),
    cbcsgs=(('P', 'D', 'D'), ('P', 'D', 'D')))
# examples/developing_channel and examples/lid_driven_cavity (unforced,
# from rest)
XDEV_BCS = dict(
    cbcvel=((('D', 'N', 'N'), ('P', 'P', 'P'), ('D', 'D', 'D')),
            (('N', 'N', 'N'), ('P', 'P', 'P'), ('D', 'D', 'D'))),
    cbcpre=(('N', 'P', 'N'), ('D', 'P', 'N')),
    cbcsgs=(('N', 'P', 'D'), ('N', 'P', 'D')))
XDUCT_BCS = dict(
    cbcvel=((('D', 'N', 'N'), ('D', 'D', 'D'), ('D', 'D', 'D')),
            (('N', 'N', 'N'), ('D', 'D', 'D'), ('D', 'D', 'D'))),
    cbcpre=(('N', 'N', 'N'), ('D', 'N', 'N')),
    cbcsgs=(('N', 'D', 'D'), ('N', 'D', 'D')))
ALLD = (('D', 'D', 'D'),) * 3
XBOX_BCS = dict(cbcvel=(ALLD, ALLD), cbcpre=(('N',) * 3,) * 2,
                cbcsgs=(('D',) * 3,) * 2)
REST = dict(gr=0.0, visci=1000.0, inivel='zer', is_wallturb=False,
            is_forced=(False, False, False), velf=(0.0, 0.0, 0.0),
            sgstype='none')
# w = 0.003 through a z wall: blowing through the lower, suction through the
# upper one
BLOW_FACE = ((0.0,) * 3, (0.0,) * 3, (0.0, 0.0, 0.003))
PERIODIC_BCS = dict(cbcvel=((('P',) * 3,) * 3,) * 2,
                    cbcpre=(('P',) * 3,) * 2, cbcsgs=(('P',) * 3,) * 2)
# examples/taylor_green_vortex_3d/input.nml and bench.py's triperiodic_dns
TGV = dict(ng=(512, 512, 512), l=(2 * np.pi,) * 3, gtype=1, gr=0.0,
           visci=1600.0, inivel='tgv', is_wallturb=False,
           is_forced=(False,) * 3, velf=(0.0,) * 3, sgstype='none',
           **PERIODIC_BCS)
TRI = dict(TGV, ng=(512, 256, 256), gtype=0)
# a passive scalar in a channel with a warm and a cold wall: s 0 on the
# lower z wall, 1 on the upper one, periodic x and y, Pr 0.71, from s = 0
SCALAR = dict(scalar=True, pr=0.71, iniscal='zer',
              cbcscal=(('P', 'P', 'D'), ('P', 'P', 'D')),
              bcscal=((0.0, 0.0, 0.0), (0.0, 0.0, 1.0)))
# bench.py _matrix_configs: the channel-LES headline, channel_dns_impdiff,
# duct_les_dsmag, cavity_les_dsmag and wmles_channel;
# examples/turbulent_duct_wmles/input.nml for the wall-modelled duct;
# validation/dsmag_channel.py:77-89
# for the dynamic model in the channel
CASES = {
    'les': dict(visci=20_000.0, sgstype='smag', ptransform='fft'),
    'les-mat': dict(visci=20_000.0, sgstype='smag', ptransform='mat'),
    'les-imp': dict(visci=20_000.0, sgstype='smag', ptransform='mat',
                    impdiff=True, impdiff_1d=True, **CHAN_BCS),
    'dns': dict(visci=5640.0, sgstype='none', impdiff=True, impdiff_1d=True,
                ptransform='mat', **CHAN_BCS),
    'dns-imp3d': dict(visci=5640.0, sgstype='none', impdiff=True,
                      impdiff_1d=False, ptransform='mat', **CHAN_BCS),
    'tgv': dict(TGV, ptransform='mat'),
    'tgv-fft': dict(TGV, ptransform='fft'),
    'tri': dict(TRI, ptransform='mat'),
    'tri-imp3d': dict(TRI, ptransform='mat', impdiff=True),
    'dsmag': dict(l=(12.8, 4.8, 2.0), gr=5.0, visci=10_000.0, inivel='poi',
                  sgstype='dsmag', dsmag_avg='channel', ptransform='mat',
                  impdiff=True, impdiff_1d=True, **CHAN_BCS),
    'dsmag-blow': dict(l=(12.8, 4.8, 2.0), gr=5.0, visci=10_000.0,
                       inivel='poi', sgstype='dsmag', dsmag_avg='channel',
                       ptransform='mat', impdiff=True, impdiff_1d=True,
                       bcvel=(BLOW_FACE, BLOW_FACE), **CHAN_BCS),
    'duct': dict(l=(4 * np.pi, 2.0, 2.0), visci=10_000.0, inivel='duc',
                 sgstype='dsmag', dsmag_avg='duct', ptransform='mat',
                 **DUCT_BCS),
    'duct-fft': dict(l=(4 * np.pi, 2.0, 2.0), visci=10_000.0, inivel='duc',
                     sgstype='dsmag', dsmag_avg='duct', ptransform='fft',
                     **DUCT_BCS),
    'cavity': dict(l=(1.0, 1.0, 1.0), gr=0.0, visci=5_000.0, inivel='tgv',
                   is_wallturb=False, is_forced=(False, False, False),
                   velf=(0.0, 0.0, 0.0), sgstype='dsmag', dsmag_avg='cavity',
                   ptransform='mat',
                   bcvel=(((0.0,) * 3,) * 3,
                          ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0),
                           (0.0, 1.0, 0.0))), **DUCT_BCS),
    'wmles': dict(visci=125_000.0, sgstype='smag', ptransform='mat',
                  lwm=((0, 0, 1), (0, 0, 1)), hwm=0.1, **CHAN_BCS),
    'wmles-duct': dict(l=(12.8, 2.0, 2.0), gr=0.0, visci=20_000.0,
                       inivel='duc', sgstype='smag', ptransform='mat',
                       lwm=((0, 1, 1), (0, 1, 1)), hwm=0.1, **DUCT_BCS),
    'xchannel': dict(REST, l=(1.0, 1.5, 1.0),
                     bcvel=(((1.0, 0.0, 0.0), (0.0,) * 3, (0.0,) * 3),
                            ((0.0,) * 3,) * 3), **XDEV_BCS),
    'xcavity': dict(REST, l=(1.0, 1.0, 1.0),
                    bcvel=(((0.0,) * 3,) * 3,
                           ((0.0,) * 3, (0.0,) * 3, (1.0, 0.0, 0.0))),
                    **XBOX_BCS),
    # the inflow profile is added from the grid (power_law_inflow)
    'xwmles': dict(REST, l=(6.4, 3.2, 2.0), gtype=6, visci=50_000.0,
                   inivel='uni', sgstype='smag', lwm=((0, 0, 1), (0, 0, 1)),
                   hwm=0.1, **XDEV_BCS),
    'xles-imp': dict(REST, l=(1.0, 1.5, 1.0), visci=20_000.0,
                     sgstype='smag', impdiff=True, impdiff_1d=True,
                     bcvel=(((1.0, 0.0, 0.0), (0.0,) * 3, (0.0,) * 3),
                            ((0.0,) * 3,) * 3), **XDEV_BCS),
    'xduct-les': dict(REST, l=(1.0, 1.5, 1.0), visci=20_000.0,
                      sgstype='smag',
                      bcvel=(((1.0, 0.0, 0.0), (0.0,) * 3, (0.0,) * 3),
                             ((0.0,) * 3,) * 3), **XDUCT_BCS),
    'les-scal': dict(visci=20_000.0, sgstype='smag', ptransform='mat',
                     **CHAN_BCS, **SCALAR),
    'tgv-les': dict(TGV, sgstype='smag', ptransform='auto'),
    'tgv-dsmag': dict(TGV, sgstype='dsmag', dsmag_avg='dit',
                      ptransform='auto'),
}


def power_law_inflow(cfg):
    """cfg with a 1/7-power inflow profile on its lower x face: u = (8/7)
    min(z, lz - z)^(1/7) (0 where that is negative) at the cell centres of
    cfg's own grid, over the padded (nz+2, ny+2) face; a developing
    turbulent channel's mean inflow of unit bulk velocity for lz = 2."""
    from .grid import make_grid_from_config
    zc = make_grid_from_config(cfg).zc
    prof = (8.0 / 7.0) * np.clip(np.minimum(zc, cfg.l[2] - zc), 0.0,
                                 None) ** (1.0 / 7.0)
    face = np.repeat(prof[:, None], cfg.ng[1] + 2, axis=1)
    return cfg.replace(bcvel=((((face, 0.0, 0.0),) + ((0.0,) * 3,) * 2),
                              ((0.0,) * 3,) * 3))


def device_profile(sim, state, dt, steps):
    """(ms/step by CUDA events with the profiler off, {kernel: (device
    ms/step, launches/step)} under torch.profiler, the state after both
    windows) of `steps` steps from state."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(steps):
        state, _ = sim.step(state, dt)
    b.record()
    torch.cuda.synchronize()
    step_ms = a.elapsed_time(b) / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state, _ = sim.step(state, dt)
        torch.cuda.synchronize()
    per_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue    # host-side ops; their kernels are listed themselves
        dev_us = getattr(ev, 'self_device_time_total',
                         getattr(ev, 'self_cuda_time_total', 0.0))
        if dev_us > 0:
            per_kernel[ev.key] = (dev_us / 1e3 / steps, ev.count // steps)
    return step_ms, per_kernel, state


def stage_of(name: str) -> str:
    for stage, keys in STAGES:
        if any(k in name for k in keys):
            return stage
    return 'glue (torch elementwise, copies, reductions)'


def main(argv=None):
    ap = argparse.ArgumentParser(prog='cales_torch.profile_step')
    ap.add_argument('--case', default='les', choices=sorted(CASES))
    ap.add_argument('--ng', default=None,
                    help='nx x ny x nz (default: the case\'s grid)')
    ap.add_argument('--steps', type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('profile_step needs a CUDA device', file=sys.stderr)
        return 2
    from .config import Config
    from .grid import make_grid_from_config
    from .initflow import initflow
    from .timeloop import Simulation

    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    base = dict(ng=(512, 256, 256), l=(2 * np.pi, np.pi, 2.0), gtype=1,
                gr=1.0, inivel='log', is_wallturb=True,
                is_forced=(True, False, False), velf=(1.0, 0.0, 0.0),
                dtype='float32')
    kw = {**base, **CASES[args.case]}
    if args.ng:
        kw['ng'] = tuple(int(x) for x in args.ng.lower().split('x'))
    cfg = Config(**kw)
    if args.case == 'xwmles':
        cfg = power_law_inflow(cfg)
    ng = cfg.ng
    grid = make_grid_from_config(cfg)
    sim = Simulation(cfg, grid, device='cuda')
    state = sim.initial_state(*initflow(cfg, grid))
    dt = sim.pick_dt(sim.check(state)[0])
    for _ in range(2):
        state, _ = sim.step(state, dt)
    step_ms, per_kernel, state = device_profile(sim, state, dt, args.steps)
    busy = sum(ms for ms, _ in per_kernel.values())
    by_stage = {}
    for name, (ms, _) in per_kernel.items():
        s = stage_of(name)
        by_stage[s] = by_stage.get(s, 0.0) + ms
    route = ('' if cfg.sgstype != 'dsmag' else
             ', dsmag two-pass' if sim.dsmag_twopass else ', dsmag one-pass')
    print(f'{card}; case {args.case}{route}, ng={ng} float32; {args.steps} '
          f'profiled steps')
    print(f'{step_ms:.3f} ms/step (CUDA events, profiler off), device busy '
          f'{busy:.3f} ms/step (profiler), idle share {1 - busy / step_ms:.3f}')
    for s, ms in sorted(by_stage.items(), key=lambda kv: -kv[1]):
        print(f'  {ms:8.3f} ms/step  {100 * ms / busy:5.1f}%  {s}')
    print('top kernels (device ms/step, launches/step):')
    for name, (ms, n) in sorted(per_kernel.items(),
                                key=lambda kv: -kv[1][0])[:20]:
        print(f'  {ms:8.3f}  {n:4d}  {name[:110]}')
    print(json.dumps({'profile': dict(
        card=card, case=args.case + route, ng=ng, step_ms=step_ms,
        busy_ms=busy,
        idle_share=1 - busy / step_ms,
        stages={k: round(v, 4) for k, v in by_stage.items()},
        launches_per_step=sum(n for _, n in per_kernel.values()))}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
