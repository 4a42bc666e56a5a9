"""The passive scalar with y walls on a 2D pencil mesh (dims = (gy, gx),
gx > 1) on the CPU: mom_rk's scalar twin in its y-walled x-halo mode on
pencils cut from the whole field in process, and 2 steps on gloo ranks of
tests/_sharded_worker.py (the kernels' plain twins) from the seeded
asymmetric start of tests/test_torch_sharded.py, against the JAX
package's single-device Simulation(use_pallas=False), f64:

  * mom_rk_plain with the scalar (SCAL x Y_WALLS x X_HALO, explicit, with
    and without nu_t) on the four pencils of dims (2, 2), each pencil's
    y-row stacks and x halos (the scalar's the sixth, its wall rows from
    its own recipe's stack) cut from the whole field as the step composes
    them, equals the whole field's y-walled twin on the pencil's block,
    every output exactly; the wrapper takes the same inputs to the twin;
  * 2 steps of the scalar duct of the JAX package's
    test_scalar_ywalled_kernel_2d_mesh_matches_single (static
    Smagorinsky, the scalar 'D' 1 and 0.5 on the y walls, 'N' on the z
    walls, ssource 0.02) at the test grid on (2, 2): u, v, w, nu_t and s
    within 1e-11, p within 1e-11 after removing its mean, the kept planes,
    the checks and the checkpoint as tests/test_torch_sharded.py holds
    them.
"""
import numpy as np
import pytest
import torch

from cales_torch.ab_dsmag import cut_walled
from cales_torch.ops import kernels as K

from test_torch_pencil import _rand
from test_torch_pencil_ywalls import (NG, pencils, run_pencils,
                                      walled_inputs)
from test_torch_sharded import _jax_steps
from test_torch_ywalls import DUCT

torch.set_num_threads(1)

YSC = dict(DUCT, ng=NG, sgstype='smag', scalar=True, pr=0.71,
           iniscal='uni', ssource=0.02,
           cbcscal=(('P', 'D', 'N'), ('P', 'D', 'N')),
           bcscal=((0.0, 1.0, 0.0), (0.0, 0.5, 0.0)))


@pytest.fixture(scope='module')
def refs():
    return {'ysc': (YSC, _jax_steps(YSC, 2))}


def test_scalar_duct_on_2x2_pencils(tmp_path, refs):
    out, _ = run_pencils(tmp_path, (2, 2), refs, ('ysc',))
    assert 'ysc.s' in out


def test_mom_rk_scalar_ywalled_x_halo_twin_on_cut_pencils():
    rng = np.random.default_rng(311)
    nz, ny, nx = 6, 12, 16
    gy, gx = 2, 2
    names = ('u', 'v', 'w', 's', 'p', 'c')
    fld, edg, ysk = walled_inputs(rng, names, ny, nx, nz)
    old = {n: _rand(rng, nz, ny, nx) for n in ('ru', 'rv', 'rw', 'rc')}
    coef = (*(1.0 + 0.1 * _rand(rng, nz + 2) for _ in range(2)), 0.3, -0.1,
            1e-3, 2.0, 3.0, (0.1, 0.0, 0.0))
    scal = (1e-3 / 0.71, 0.02)
    for sgs in (True, False):
        n6 = ('u', 'v', 'w', 's' if sgs else None, 'p', 'c')
        ref = K.mom_rk_plain(
            *(None if n is None else fld[n] for n in n6[:5]),
            *(None if n is None else edg[n] for n in n6[:5]),
            old['ru'], old['rv'], old['rw'], *coef, sums=(True, True),
            ye=tuple(None if n is None else ysk[n] for n in n6),
            sca=fld['c'], scae=edg['c'], rso=old['rc'], scal=scal)
        for iy, ys, xs in pencils(gy, gx, ny, nx):
            cut = {n: cut_walled(fld[n], edg[n], ysk[n], ys, xs)
                   for n in n6 if n is not None}

            def blk(n):
                return old[n][:, ys, xs].contiguous()
            a = (*(None if n is None else cut[n][0] for n in n6[:5]),
                 *(None if n is None else cut[n][1] for n in n6[:5]),
                 blk('ru'), blk('rv'), blk('rw'), *coef)
            kw = dict(sums=(True, True), sca=cut['c'][0], scae=cut['c'][1],
                      rso=blk('rc'), scal=scal,
                      ye=tuple(None if n is None else cut[n][2] for n in n6),
                      xh=tuple(None if n is None else cut[n][4] for n in n6))
            got = K.mom_rk_plain(*a, **kw)
            for m, (g, r) in enumerate(zip(got, ref)):
                if m in (6, 7):     # the pencil's plane sums
                    continue
                assert torch.equal(g, r[:, ys, xs]), (sgs, iy, xs, m)
            same = K.mom_rk(*a, **kw)
            assert all(g is h or torch.equal(g, h)
                       for g, h in zip(got, same)), (sgs, iy, xs)
