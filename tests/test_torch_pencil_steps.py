"""The channel classes on a 2D pencil mesh (dims = (gy, gx), gx > 1) on the
CPU: 2 steps on gloo ranks of tests/_sharded_worker.py (the kernels'
plain twins, the x-halo variants' on the pencils) from the seeded
asymmetric start of tests/test_torch_sharded.py, against JAX
Simulation(use_pallas=False) on one device, f64:

  * at dims (2, 2) the static-Smagorinsky channel LES and the 'none'
    channel by 'mat', the LES with impdiff_1d, and the LES by 'fft' (the
    headline's route, bench.py:273-279); at dims (1, 2) the LES by 'mat';
  * u, v, w and nu_t within 1e-11, p within 1e-11 after removing its mean,
    w's lower wall face, the CFL dt, divmax, the bulk velocity and the
    kernels named;
  * the sharded checkpoint byte-identical to the single-process writer on
    the gathered fields, and read back.
"""
import numpy as np

from cales_torch.config import Config
from cales_torch.timeloop import unsupported

from test_torch_sharded import NONE, SMAG, _check_steps, _jax_steps, _spawn
from test_torch_sharded_fft import _check_fft_steps
from test_torch_sharded_imp import _bulk

# the pencils' grid: nx and ny divisible by gy gx = 4 (the re-slab)
NG = (32, 16, 16)
CASES = {'smag': dict(SMAG, ng=NG),
         'none': dict(NONE, ng=NG),
         'smag_imp': dict(SMAG, ng=NG, impdiff=True, impdiff_1d=True),
         'les_fft': dict(SMAG, ng=NG, ptransform='fft')}


def _run(tmp_path, dims, keys):
    cases, inputs, refs = [], {}, {}
    for key in keys:
        kw = CASES[key]
        assert unsupported(Config(**kw, dims=dims)) == [], key
        fields, dt, jst, jchk = _jax_steps(kw, 2)
        refs[key] = (kw, jst, jchk)
        for q, f in zip('uvwp', fields):
            inputs[f'{key}.{q}'] = f
        inputs[f'{key}.dt'] = np.array(dt)
        cases.append({'kind': 'steps', 'key': key, 'ng': kw['ng'],
                      'dims': dims, 'cfg': {**kw, 'dims': dims},
                      'nsteps': 2})
    out, work = _spawn(tmp_path, dims[0] * dims[1], cases, inputs)
    for key, (kw, jst, jchk) in refs.items():
        if kw['ptransform'] == 'fft':
            _check_fft_steps(out, key, kw, jst, jchk, work)
        else:
            bulk = _bulk(kw, jst) if kw.get('impdiff') else 1.0
            _check_steps(out, key, jst, jchk, kw, work, 2, bulk=bulk)
        # w's lower wall face (the kept plane's interior, gathered)
        err = np.abs(out[f'{key}.vlo2i']
                     - np.asarray(jst.vlo[2])[1:-1, 1:-1]).max()
        assert err <= 1e-11, f'{key} vlo[2]: {err:.3e}'


def test_channel_classes_on_2x2_pencils(tmp_path):
    _run(tmp_path, (2, 2), ('smag', 'none', 'smag_imp', 'les_fft'))


def test_les_on_1x2_pencils(tmp_path):
    _run(tmp_path, (1, 2), ('smag',))
