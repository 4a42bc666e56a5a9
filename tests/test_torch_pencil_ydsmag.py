"""The one-pass dynamic Smagorinsky with y walls on a 2D pencil mesh
(dims = (gy, gx), gx > 1) on the CPU: the dsmag twin's y-walled x-halo
mode on pencils cut from the whole field in process, and 2 steps on gloo
ranks of tests/_sharded_worker.py (the kernels' plain twins) from the
seeded asymmetric start of tests/test_torch_sharded.py, against the JAX
package's single-device Simulation(use_pallas=False), f64:

  * dsmag_plain with y walls (YW, YH and XH: each pencil's y-row stacks,
    its two-row y halo, the walls its mesh row holds and its two-deep x
    halos, their wall rows the x neighbours', cut from the whole field as
    the step composes them) on the four pencils of dims (2, 2): |S| and
    'cavity''s nu_t equal the whole field's on the pencil's block,
    exactly, and the pencils' 'duct' sums, summed over the mesh row (the
    'channel' sums over all four), the whole field's within 1e-13 of
    their largest; the wrapper takes the same inputs to the twin;
  * 2 steps of bench.py's duct_les_dsmag ('duct') and cavity_les_dsmag
    ('cavity', the moving lid) at the test grid on (2, 2) and (1, 2), the
    'duct' class on (4, 2) (its sums over a mesh row of pencils that hold
    no wall), the duct example's 'channel' average and the 'duct' class
    by 'fft' (the mixed route: the rfft along x, the y DCT on its lanes)
    on (2, 2): u, v, w, nu_t within
    1e-11, p within 1e-11 after removing its mean, the kept planes vlo[1]
    and vlo[2], the checks and the checkpoint as
    tests/test_torch_sharded.py holds them.
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
from test_torch_ywalls import CAVITY, DUCT

torch.set_num_threads(1)

CASES = {'ydsmag': dict(DUCT, ng=NG), 'ycavity': dict(CAVITY, ng=NG),
         'ydsmag_ch': dict(DUCT, ng=NG, dsmag_avg='channel'),
         'ydsmag_fft': dict(DUCT, ng=NG, ptransform='fft')}


@pytest.fixture(scope='module')
def refs():
    return {key: (kw, _jax_steps(kw, 2)) for key, kw in CASES.items()}


def test_dsmag_ducts_on_2x2_pencils(tmp_path, refs):
    run_pencils(tmp_path, (2, 2), refs, ('ydsmag', 'ycavity', 'ydsmag_ch',
                                         'ydsmag_fft'))


def test_dsmag_ducts_on_1x2_pencils(tmp_path, refs):
    run_pencils(tmp_path, (1, 2), refs, ('ydsmag', 'ycavity'))


def test_dsmag_duct_on_4x2_pencils(tmp_path, refs):
    run_pencils(tmp_path, (4, 2), refs, ('ydsmag',))


@pytest.mark.parametrize('avg', ['duct', 'cavity', 'channel'])
def test_ywalled_dsmag_x_halo_twin_on_cut_pencils_is_the_whole_field(avg):
    rng = np.random.default_rng(307)
    nz, ny, nx = 6, 12, 16
    gy, gx = 2, 2
    fld, edg, ysk = walled_inputs(rng, 'uvw', ny, nx, nz)
    fld = {n: 0.1 * q for n, q in fld.items()}
    edg = {n: 0.1 * q for n, q in edg.items()}
    ysk = {n: tuple(0.1 * q for q in y) for n, y in ysk.items()}
    dzci, dzfi = (1.0 + 0.1 * _rand(rng, nz + 2) for _ in range(2))
    alph2 = torch.full((nz,), 4.0, dtype=torch.float64)
    alph2[0] = alph2[-1] = 2.52
    coef = (alph2, dzci, dzfi, 2.0, 3.0, True, True)
    yvals = (0.0, 0.0, 0.0, 0.0)
    s0, num, den = K.dsmag_plain(*(fld[n] for n in 'uvw'),
                                 *(edg[n] for n in 'uvw'), *coef,
                                 ye=tuple(ysk[n] for n in 'uvw'),
                                 yvals=yvals, avg=avg)
    sums = {}
    for iy, ys, xs in pencils(gy, gx, ny, nx):
        cut = {n: cut_walled(fld[n], edg[n], ysk[n], ys, xs, depth=2)
               for n in 'uvw'}
        a = (*(cut[n][0] for n in 'uvw'), *(cut[n][1] for n in 'uvw'),
             *coef)
        kw = dict(ye=tuple(cut[n][2] for n in 'uvw'), yvals=yvals, avg=avg,
                  yh=tuple(cut[n][3] for n in 'uvw'),
                  yown=(iy == 0, iy == gy - 1),
                  xh=tuple(cut[n][4] for n in 'uvw'))
        got = K.dsmag_plain(*a, **kw)
        assert torch.equal(got[0], s0[:, ys, xs]), (iy, xs)
        same = K.dsmag(*a, **kw)
        assert all(g is h or torch.equal(g, h) for g, h in zip(got, same))
        if avg == 'duct':
            part = torch.stack([got[1][..., 0], got[2][..., 0]])
            sums[iy] = sums.get(iy, 0.0) + part
        elif avg == 'channel':
            sums[0] = sums.get(0, 0.0) + torch.stack([got[1], got[2]])
    if avg == 'cavity':
        return
    for iy, ys, _ in pencils(gy if avg == 'duct' else 1, 1, ny, nx):
        whole = torch.stack([num[:, ys, 0], den[:, ys, 0]] if avg == 'duct'
                            else [num, den])
        err = (sums[iy] - whole).abs().max() / whole.abs().max()
        assert err <= 1e-13, (iy, float(err))


@pytest.mark.parametrize('gx', [1, 2], ids=['slab', 'pencil'])
def test_ywalled_dsmag_twin_reads_the_stacks_rows_on_every_side(gx):
    """The contract of the y-walled twin (and of dsmag.cu's YW reads): the
    rows -1, nyl - 1 and nyl come from the y-row stacks on every side, the
    y halo gives the rows -2 and nyl + 1 alone.  Inputs whose stacks
    disagree with the halo on the side a slab or pencil does not hold:
    the halo's rows -1 and nyl there change nothing, the stacks' change
    the output."""
    rng = np.random.default_rng(311)
    nz, ny, nx = 6, 12, 16
    fld, edg, ysk = walled_inputs(rng, 'uvw', ny, nx, nz)
    fld = {n: 0.1 * q for n, q in fld.items()}
    edg = {n: 0.1 * q for n, q in edg.items()}
    ysk = {n: tuple(0.1 * q for q in y) for n, y in ysk.items()}
    dzci, dzfi = (1.0 + 0.1 * _rand(rng, nz + 2) for _ in range(2))
    alph2 = torch.full((nz,), 4.0, dtype=torch.float64)
    coef = (alph2, dzci, dzfi, 2.0, 3.0, True, True)
    iy, ys, xs = next(pencils(2, gx, ny, nx))
    cut = {n: cut_walled(fld[n], edg[n], ysk[n], ys, xs, depth=2)
           for n in 'uvw'}
    a = (*(cut[n][0] for n in 'uvw'), *(cut[n][1] for n in 'uvw'), *coef)

    def twin(ye, yh):
        kw = dict(ye=ye, yh=yh, yown=(True, False), avg='cavity',
                  yvals=(0.0, 0.0, 0.0, 0.0))
        if gx > 1:
            kw['xh'] = tuple(cut[n][4] for n in 'uvw')
        return K.dsmag_plain(*a, **kw)[0]

    ye = tuple(cut[n][2] for n in 'uvw')
    yh = tuple(cut[n][3] for n in 'uvw')
    ref = twin(ye, yh)

    def bumped(pairs, rows):
        out = []
        for r, c in pairs:
            r, c = r.clone(), c.clone()
            r[:, rows] += 0.05
            c[:, rows] += 0.05
            out.append((r, c))
        return tuple(out)
    assert torch.equal(twin(ye, bumped(yh, [2])), ref)
    for row in (1, 2):
        assert not torch.equal(twin(bumped(ye, [row]), yh), ref), row
