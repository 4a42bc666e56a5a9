"""cales_torch's driver and CLI on the CPU: the example channel-LES
namelist at a reduced grid through ``python -m cales_torch --device cpu``,
a restart, the refusal to run without a card unless asked, and the
package's independence from jax."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cales_tpu.io import checkpoint as ckpt
from cales_tpu.nml import config_from_nml

from cales_torch import driver

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
EXAMPLE = ROOT / 'examples' / 'turbulent_channel_les' / 'input.nml'


def _small_nml(tmp_path, **subs):
    """The example namelist with ng reduced and the output cadences
    shortened so a 2-step run writes every output kind."""
    text = EXAMPLE.read_text()
    text = text.replace('ng(1:3) = 128, 96, 96', 'ng(1:3) = 32, 16, 16')
    text = text.replace('icheck = 10, iout0d = 10, iout1d = 100, '
                        'iout2d = 1000', 'icheck = 1, iout0d = 1, iout1d = 2, '
                        'iout2d = 2')
    for a, b in subs.items():
        text = text.replace(a, b)
    path = tmp_path / 'input.nml'
    path.write_text(text)
    return path


def _env():
    env = dict(os.environ, OMP_NUM_THREADS='1')
    env['PYTHONPATH'] = str(ROOT) + os.pathsep + env.get('PYTHONPATH', '')
    return env


def _run(args, cwd=ROOT):
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, cwd=cwd, env=_env(), timeout=300)


def test_cli_runs_the_example_on_cpu(tmp_path):
    nml = _small_nml(tmp_path)
    out = tmp_path / 'data'
    res = _run(['-m', 'cales_torch', str(nml), '--device', 'cpu', '--dtype',
                'float64', '--max-steps', '2', '--datadir', str(out)])
    assert res.returncode == 0, res.stderr[-2000:]
    path = [ln for ln in res.stdout.splitlines() if 'Execution path' in ln]
    assert path and path[0].count('cpu') and 'mom_rk' in path[0]
    for name in ('fld.bin', 'time.out', 'forcing.out', 'grid.bin',
                 'stats_0000002.out', 'stats_0000002_reystr_budget.out',
                 'u_2d_0000002.bin'):
        assert (out / name).exists(), name
    u, v, w, p, t, istep = ckpt.load_checkpoint(out / 'fld.bin',
                                                (32, 16, 16), np.float64)
    assert istep == 2 and t > 0
    assert np.isfinite(u).all() and abs(u.mean() - 1.0) < 0.1


def test_cli_without_a_card_refuses_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: cuda is the right default')
    nml = _small_nml(tmp_path)
    res = _run(['-m', 'cales_torch', str(nml), '--max-steps', '1',
                '--datadir', str(tmp_path / 'data')])
    assert res.returncode != 0
    assert 'torch.cuda.is_available() is False' in res.stderr


def test_driver_restart_continues_the_run(tmp_path):
    nml = _small_nml(tmp_path)
    cfg = config_from_nml(nml, dtype='float64')
    data = tmp_path / 'data'
    sim, st1 = driver.run(cfg, datadir=data, device='cpu', max_steps=2,
                          verbose=False)
    u, _, _, _, t, istep = ckpt.load_checkpoint(data / 'fld.bin', cfg.ng,
                                                np.float64)
    np.testing.assert_array_equal(u, st1.u.numpy())
    sim, st2 = driver.run(cfg.replace(restart=True), datadir=data,
                          device='cpu', max_steps=1, verbose=False)
    assert st2.istep == istep + 1 and st2.time > t


def test_port_imports_no_jax():
    code = ('import sys, cales_torch, cales_torch.driver, '
            'cales_torch.timeloop, cales_torch.params, cales_torch.poisson, '
            'cales_torch.sgs, cales_torch.ops.kernels, cales_torch.ops.build, '
            'cales_torch.__main__\n'
            'bad = sorted(m for m in sys.modules if m == "jax" '
            'or m.startswith("jax."))\n'
            'assert not bad, bad\nprint("ok")')
    res = _run(['-c', code])
    assert res.returncode == 0 and res.stdout.strip() == 'ok', res.stderr


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    res = _run([str(ROOT / 'chip_smoke.py')])
    assert res.returncode != 0 and '"ok"' not in res.stdout
    alone = tmp_path / 'alone'
    alone.mkdir()
    shutil.copy(ROOT / 'chip_smoke.py', alone)
    env = dict(os.environ, OMP_NUM_THREADS='1', PYTHONPATH='')
    res = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=alone,
                         capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode != 0 and '"ok"' not in res.stdout


def _scalar_cfg(**kw):
    from cales_torch.config import Config
    return Config(ng=(12, 8, 8), l=(2 * np.pi, np.pi, 2.0), visci=200.0,
                  inivel='log', is_wallturb=True, dtype='float64',
                  is_forced=(True, False, False), velf=(1.0, 0.0, 0.0),
                  scalar=True, iniscal='uni', pr=0.7, ssource=0.1,
                  cbcscal=(('P', 'P', 'D'), ('P', 'P', 'N')),
                  bcscal=((0.0, 0.0, 0.5), (0.0, 0.0, 0.0)), dt_f=1e-3,
                  **kw)


def test_driver_scalar_restart_continues_the_run(tmp_path):
    """4 steps straight against 2, a restart from fld.bin and the scal.bin
    sidecar, and 2 more (tests/test_round2_fixes.py:17 in the port): s and
    u agree within 1e-13; the JAX package's load_scalar reads the port's
    sidecar."""
    cfg = _scalar_cfg()
    _, straight = driver.run(cfg, datadir=tmp_path / 'a', device='cpu',
                             max_steps=4, verbose=False)
    data = tmp_path / 'b'
    _, half = driver.run(cfg, datadir=data, device='cpu', max_steps=2,
                         verbose=False)
    s, t, istep = ckpt.load_scalar(data / 'scal.bin', cfg.ng, np.float64)
    np.testing.assert_array_equal(s, half.s.numpy())
    assert (t, istep) == (half.time, half.istep) and istep == 2
    _, resumed = driver.run(cfg.replace(restart=True), datadir=data,
                            device='cpu', max_steps=2, verbose=False)
    assert resumed.istep == straight.istep == 4
    for name in ('s', 'u'):
        np.testing.assert_allclose(getattr(resumed, name).numpy(),
                                   getattr(straight, name).numpy(),
                                   rtol=0, atol=1e-13, err_msg=name)


def test_driver_scalar_restart_requires_the_sidecar(tmp_path):
    """A restart with scalar=True and no scal.bin raises, naming it
    (tests/test_round2_fixes.py:59 in the port)."""
    from cales_torch.io import checkpoint as tckpt
    cfg = _scalar_cfg(restart=True)
    z = np.zeros(cfg.ng[::-1])
    tckpt.save_checkpoint(tmp_path / 'fld.bin', z, z, z, z, 0.0, 0)
    with pytest.raises(FileNotFoundError, match='scal.bin'):
        driver.run(cfg, datadir=tmp_path, device='cpu', max_steps=1,
                   verbose=False)
