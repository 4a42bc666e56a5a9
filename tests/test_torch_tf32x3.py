"""The arithmetic of the float32 GEMM of cales_torch/csrc/gemm.cuh (the
transform kernels apply_y and apply_x), emulated in numpy on the CPU: no
card needed.

The kernel splits each float32 element x into big = tf32(x) and small =
tf32(x - big), with tf32() the PTX conversion cvt.rna.tf32.f32 (round to
nearest, ties away from zero, to 10 mantissa bits).  For each tile of 32
along k it sums, into a zeroed fragment, the tile's small.big and
big.small products (each step of 8 in turn), then its big.big ones; the
fragment then joins the running float32 sum.
(The emulation rounds every sum to nearest; the tensor cores truncate
theirs, which the per-tile fragment keeps away from the running sum.)
Here:
  * the emulated conversion against hand-made values (ties, signs, zeros,
    denormals, the carry into the next binade) and against an independent
    formulation (scaling by the binade's quantum) on random bit patterns;
  * on the port's own operators (poisson.make_solver: the x operator 512
    wide, the y operator 256), the emulated 3xTF32 product within 2x of the
    float32 matmul's error against float64, and one TF32 product at least
    100x worse: why the card's bound on the kernel against its float64 twin
    is what it is, and why one TF32 product stays barred;
  * the z stage of the eigen solve (z_eig's float32 body: two such
    products with the inverse eigenvalues between them, the singular mode
    zeroed) on the port's own z operators, nz = 256, of the DNS channel's
    grid and of the dynamic-Smagorinsky channel's (gr = 5): the same two
    bounds.
Errors are max |C - C64| / max |C64|, C64 the float64 product of the same
float32 inputs."""
import numpy as np
import pytest

from cales_torch import poisson
from cales_torch.config import Config
from cales_torch.grid import make_grid_from_config

LOW13 = np.uint32(0x1FFF)


def tf32_rna(x):
    """cvt.rna.tf32.f32 on a float32 array: round the magnitude's bits at
    bit 13, halves away from zero (adding half of the dropped quantum to
    the sign-magnitude bits carries into the exponent where it must).
    Infinities and NaNs pass through unchanged."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    r = (u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    finite = (u & np.uint32(0x7F800000)) != np.uint32(0x7F800000)
    return np.where(finite, r, u).view(np.float32)


def split(x):
    """(big, small) of the kernel's split_tf32, in float32."""
    x = np.asarray(x, dtype=np.float32)
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def tf32x3_matmul(a, b, tile=32):
    """a @ b as the kernel sums it: into a float32 part zeroed at each tile
    of k, the tile's small.big and big.small products step by step of 8,
    then its big.big ones; the part then added to the float32 sum."""
    (ab, as_), (bb, bs) = split(a), split(b)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], tile):
        steps = [slice(k, k + 8)
                 for k in range(k0, min(k0 + tile, a.shape[1]), 8)]
        part = np.zeros_like(acc)
        for s in steps:
            part = part + as_[:, s] @ bb[s]
            part = part + ab[:, s] @ bs[s]
        for s in steps:
            part = part + ab[:, s] @ bb[s]
        acc = acc + part
    return acc


def rel_err(c, ref):
    return float(np.abs(c.astype(np.float64) - ref).max() / np.abs(ref).max())


def _bits(*v):
    return np.array(v, dtype=np.uint32).view(np.float32)


# (input bits, cvt.rna.tf32.f32 bits)
HAND_MADE = {
    'one': (0x3F800000, 0x3F800000),
    'tie above one rounds away': (0x3F801000, 0x3F802000),
    'tie below minus one rounds away': (0xBF801000, 0xBF802000),
    'just below a tie': (0x3F800FFF, 0x3F800000),
    'just above a tie': (0x3F801001, 0x3F802000),
    'tie from an even last bit rounds away, not to even': (0x3F805000,
                                                           0x3F806000),
    'tie carries into the next binade': (0x3FFFF000, 0x40000000),
    'zero': (0x00000000, 0x00000000),
    'minus zero keeps its sign': (0x80000000, 0x80000000),
    'smallest denormal to zero': (0x00000001, 0x00000000),
    'denormal tie rounds away': (0x00001000, 0x00002000),
    'negative denormal below a tie to minus zero': (0x80000FFF, 0x80000000),
    'largest denormal to the smallest normal': (0x007FFFFF, 0x00800000),
    'infinity': (0x7F800000, 0x7F800000),
}


@pytest.mark.parametrize('case', sorted(HAND_MADE))
def test_tf32_rna_hand_made_values(case):
    x, want = HAND_MADE[case]
    got = tf32_rna(_bits(x)).view(np.uint32)[0]
    assert got == np.uint32(want), f'{case}: {got:#010x}, want {want:#010x}'


def test_tf32_rna_matches_rounding_by_the_binade_quantum():
    """On random finite bit patterns: tf32(x) = sign(x) floor(|x| / q +
    1/2) q with q = 2^(max(e, -126) - 10) the TF32 quantum of x's binade e,
    exact in float64; its 13 low bits are zero and it lies within half a
    quantum of x."""
    rng = np.random.default_rng(8)
    u = rng.integers(0, 2 ** 32, 200_000, dtype=np.uint64).astype(np.uint32)
    u = u[(u & np.uint32(0x7F800000)) != np.uint32(0x7F800000)]
    x = u.view(np.float32)
    got = tf32_rna(x)
    a = np.abs(x.astype(np.float64))
    _, ex = np.frexp(a)
    q = np.ldexp(1.0, np.maximum(ex - 1, -126) - 10)
    want = np.copysign(np.floor(a / q + 0.5) * q, x).astype(np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert not np.any(got.view(np.uint32) & LOW13)
    fin = np.isfinite(got)
    assert np.all(np.abs(got[fin].astype(np.float64) - a[fin] * np.sign(
        x[fin])) <= 0.5 * q[fin])


def test_split_keeps_all_but_the_last_bits_of_x():
    """big + small gives x back within 2^-22 of |x| (normal x), both
    halves TF32 (13 low bits zero), and small within 2^-11 of |x|."""
    rng = np.random.default_rng(9)
    x = (rng.standard_normal(100_000)
         * np.exp2(rng.integers(-60, 60, 100_000))).astype(np.float32)
    big, small = split(x)
    x64 = x.astype(np.float64)
    assert not np.any(big.view(np.uint32) & LOW13)
    assert not np.any(small.view(np.uint32) & LOW13)
    assert np.all(np.abs(small.astype(np.float64)) <= 2.0 ** -11 * np.abs(x64))
    back = big.astype(np.float64) + small.astype(np.float64)
    assert np.all(np.abs(back - x64) <= 2.0 ** -22 * np.abs(x64))


@pytest.fixture(scope='module')
def products():
    """The float32 matmul, the emulated 3xTF32 and one TF32 product, each
    with its error against float64, for the x operator (pass 1 of apply_y,
    apply_x: rows @ MxT, K = 512) and the y operator (pass 2: M @ plane,
    K = 256) of the channel's pressure solver at 512 x 256."""
    cfg = Config(ng=(512, 256, 8), l=(2 * np.pi, np.pi, 2.0), gtype=1,
                 gr=1.0, ptransform='mat')
    sv = poisson.make_solver(cfg, make_grid_from_config(cfg),
                             ('PP', 'PP', 'NN'), ('c', 'c', 'c'))
    rng = np.random.default_rng(20261017)
    out = {}
    for name, (a, b) in {
            'x': (rng.standard_normal((512, 512)), sv.trx.fwd_mat.T),
            'y': (sv.try_.fwd_mat, rng.standard_normal((256, 512)))}.items():
        a, b = (np.ascontiguousarray(q, dtype=np.float32) for q in (a, b))
        ref = a.astype(np.float64) @ b.astype(np.float64)
        out[name] = dict(
            fp32=rel_err(a @ b, ref), tf32x3=rel_err(tf32x3_matmul(a, b), ref),
            tf32=rel_err(tf32_rna(a) @ tf32_rna(b), ref))
    return out


@pytest.mark.parametrize('op', ['x', 'y'])
def test_tf32x3_product_keeps_fp32_accuracy(products, op):
    e = products[op]
    assert e['tf32x3'] <= 2.0 * e['fp32'], e


@pytest.mark.parametrize('op', ['x', 'y'])
def test_one_tf32_product_is_far_worse(products, op):
    e = products[op]
    assert e['tf32'] >= 100.0 * e['fp32'], e


# the z grids of chip_smoke.py's DNS_CFG and DSMAG_CFG, at their full x and
# y widths (the spectra lamx, lamy) and nz = 256
Z_GRIDS = {'dns': dict(l=(2 * np.pi, np.pi, 2.0), gr=1.0),
           'dsmag': dict(l=(12.8, 4.8, 2.0), gr=5.0)}


def z_stage(vl, vr, lam, x, tol, matmul):
    """Vr (inv * (Vl x)) with the products by matmul, inv = 1 / lam and 0
    where |lam| <= tol, in lam's precision (z_eig's ZEigScale)."""
    hat = matmul(vl, x)
    inv = np.where(np.abs(lam) > tol, 1 / lam, 0).astype(lam.dtype)
    return matmul(vr, (hat * inv).astype(hat.dtype))


@pytest.fixture(scope='module')
def z_products():
    """The z stage by the float32 matmul, the emulated 3xTF32 and one TF32
    product, each with its error against float64 on the same float32
    inputs, on 1024 columns (y, x) of each grid, lane (0, 0) among them."""
    out = {}
    for name, kw in Z_GRIDS.items():
        cfg = Config(ng=(512, 256, 256), gtype=1, ptransform='mat', **kw)
        sv = poisson.make_solver(cfg, make_grid_from_config(cfg),
                                 ('PP', 'PP', 'NN'), ('c', 'c', 'c'))
        rng = np.random.default_rng(20261018)
        j = np.concatenate([[0, 0, 1], rng.integers(0, 256, 1021)])
        i = np.concatenate([[0, 1, 0], rng.integers(0, 512, 1021)])
        f32 = np.float32
        vl, vr = (np.ascontiguousarray(q, dtype=f32) for q in (sv.zVl, sv.zVr))
        # inv as the kernel forms it: lamy[j] + lamx[i] first, in float32
        lxy = sv.lamy.astype(f32)[j] + sv.lamx.astype(f32)[i]
        lam = sv.lamz.astype(f32)[:, None] + lxy[None, :]
        tol = f32(poisson._eig_tol(sv, sv.lamx))
        x = rng.standard_normal((256, j.size)).astype(f32)
        lam64 = (sv.lamz.astype(f32).astype(np.float64)[:, None]
                 + (sv.lamy.astype(f32).astype(np.float64)[j]
                    + sv.lamx.astype(f32).astype(np.float64)[i])[None, :])
        ref = z_stage(vl.astype(np.float64), vr.astype(np.float64), lam64,
                      x.astype(np.float64), tol, np.matmul)
        # one mode zeroed, in lane (0, 0), in both precisions
        for q in (lam, lam64):
            zeroed = np.argwhere(np.abs(q) <= tol)
            assert zeroed.shape[0] == 1 and zeroed[0, 1] == 0, zeroed
        out[name] = dict(
            fp32=rel_err(z_stage(vl, vr, lam, x, tol, np.matmul), ref),
            tf32x3=rel_err(z_stage(vl, vr, lam, x, tol, tf32x3_matmul), ref),
            tf32=rel_err(z_stage(vl, vr, lam, x, tol,
                                 lambda a, b: tf32_rna(a) @ tf32_rna(b)),
                         ref))
    return out


@pytest.mark.parametrize('grid', sorted(Z_GRIDS))
def test_tf32x3_z_stage_keeps_fp32_accuracy(z_products, grid):
    e = z_products[grid]
    assert e['tf32x3'] <= 2.0 * e['fp32'], e


@pytest.mark.parametrize('grid', sorted(Z_GRIDS))
def test_one_tf32_product_z_stage_is_far_worse(z_products, grid):
    e = z_products[grid]
    assert e['tf32'] >= 100.0 * e['fp32'], e
