"""cales_torch's own copies of the JAX package's numpy-only modules
(config, grid, initflow, nml) against the originals, for every namelist
under examples/: the same Config fields and defaults, the same grid arrays
and the same initial fields (exact; the copies run the same numpy code).
The grids and fields are built at a small (nx, ny, nz) = (16, 8, 12).

And the rule that makes the copies necessary: importing the port's
modules, its CLI, its profiler and chip_smoke.py leaves cales_tpu and jax
out of sys.modules (each in a fresh interpreter)."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from cales_tpu import config as jconfig
from cales_tpu.grid import make_grid_from_config as jax_grid
from cales_tpu.initflow import initflow as jax_initflow
from cales_tpu.nml import config_from_nml as jax_nml

from cales_torch import config as tconfig
from cales_torch.grid import make_grid_from_config
from cales_torch.initflow import initflow
from cales_torch.nml import config_from_nml

ROOT = Path(__file__).resolve().parents[1]
NAMELISTS = sorted(p.parent.name for p in (ROOT / 'examples').glob('*/input.nml'))
SMALL = (16, 8, 12)


def _same(a, b, where):
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f'{where}[{i}]')
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=where)
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def _same_config(jc, tc):
    jf = [f.name for f in dataclasses.fields(jc)]
    assert jf == [f.name for f in dataclasses.fields(tc)]
    for name in jf:
        _same(getattr(jc, name), getattr(tc, name), name)


def test_config_fields_and_defaults_match():
    jf, tf = dataclasses.fields(jconfig.Config), dataclasses.fields(
        tconfig.Config)
    assert [(f.name, f.default, f.type) for f in jf] == \
        [(f.name, f.default, f.type) for f in tf]
    args = dict(ng=(8, 8, 8), l=(1.0, 1.0, 1.0))
    _same_config(jconfig.Config(**args), tconfig.Config(**args))
    assert jconfig.RK_COEFF == tconfig.RK_COEFF
    assert jconfig.C_SMAG == tconfig.C_SMAG


@pytest.mark.parametrize('name', NAMELISTS)
def test_namelist_gives_the_same_config_grid_and_fields(name):
    nml = ROOT / 'examples' / name / 'input.nml'
    jc, tc = jax_nml(nml), config_from_nml(nml)
    _same_config(jc, tc)
    _same(jconfig.effective_cbcvel(jc), tconfig.effective_cbcvel(tc),
          'effective_cbcvel')
    for prop in ('dl', 'dli', 'visc', 'shape_zyx'):
        _same(getattr(jc, prop), getattr(tc, prop), prop)
    jc, tc = jc.replace(ng=SMALL), tc.replace(ng=SMALL)
    jerr = terr = None
    try:
        jconfig.validate(jc)
    except Exception as e:          # noqa: BLE001 -- compared below
        jerr = (type(e).__name__, str(e))
    try:
        tconfig.validate(tc)
    except Exception as e:          # noqa: BLE001
        terr = (type(e).__name__, str(e))
    assert jerr == terr
    jg, tg = jax_grid(jc), make_grid_from_config(tc)
    for f in dataclasses.fields(jg):
        _same(getattr(jg, f.name), getattr(tg, f.name), f'grid.{f.name}')
    for i, (a, b) in enumerate(zip(jax_initflow(jc, jg), initflow(tc, tg))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f'initflow[{i}]')


# a module that imports cales_torch by its entry points, as a user would
ENTRY_POINTS = ['cales_torch', 'cales_torch.driver', 'cales_torch.__main__',
                'cales_torch.profile_step', 'chip_smoke',
                'cales_torch.parallel.mesh', 'cales_torch.parallel.comm',
                'cales_torch.io.sharded']


def _all_port_modules():
    import pkgutil
    import cales_torch
    return sorted(m.name for m in pkgutil.walk_packages(
        cales_torch.__path__, 'cales_torch.'))


@pytest.mark.parametrize('module', ENTRY_POINTS + ['every cales_torch module'])
def test_port_imports_neither_jax_nor_cales_tpu(module):
    mods = _all_port_modules() if module.startswith('every') else [module]
    code = ('import importlib, sys\n'
            f'for m in {mods!r}:\n'
            '    importlib.import_module(m)\n'
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'cales_tpu'))\n"
            'print(bad)\n'
            'sys.exit(1 if bad else 0)\n')
    res = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr[-3000:]
