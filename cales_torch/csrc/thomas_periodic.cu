// Batched periodic tridiagonal solve along z, one warp per (y, x) column.
//
// Replaces: cales_tpu/ops/pallas_solve.py apply_thomas_periodic_z, the z
// stage of the triperiodic Poisson solve on the 'mat' route from nz >= 384
// (pinned) and of every periodic-z Helmholtz solve of full-3D implicit
// diffusion (rows a*alpha, b*alpha + 1, c*alpha; not pinned).  The algebra
// is ops/tridiag.thomas_periodic (reference gaussel_periodic,
// solver.f90:109-151), the rank-1-corrected two-RHS solve:
//   1. the reduced (nz-1)-row system tridiag(a, b + lam, c) is solved for
//      two right-hand sides sharing its factors: the data p1 and the
//      correction p2 (e[0] = -a[0], e[nz-2] = -c[nz-2]);
//   2. pn = (r[n] - c[n] p1[0] - a[n] p1[n-1])
//           / ((b[n] + lam) + c[n] p2[0] + a[n] p2[n-1]),  n = nz - 1,
//      pinned to 0 where |lam| <= tol and pin is set (the constant mode's
//      gauge, pallas_solve.py:337-338);
//   3. out = p1 + p2 pn, out[n] = pn.
// lam = lamy[j] + lamx[i], or 0 without the rows.  The coefficient rows
// arrive in float64 and are scaled and rounded here, as the JAX package
// rounds them on the host (T(a * alpha), ...).
//
// Bound on the H100: memory, two field streams (each value read once and
// written once; no scratch field).  A block solves 32 columns in shared
// memory, a column a warp, by thomas_common.cuh's chunks and cyclic
// reduction, applied to the reduced system:
//   a. its rows 0 .. n-1 go in the chunks, one a lane;
//   b. a lane sweeps its chunk for p1 and p2 at once: p2's right-hand side
//      e is zero but in rows 0 and n-1: e[0] = -a[0] rides in the first
//      chunk's P coefficients (that chunk has no P: P = 0 for p1, -1 for
//      p2), e[n-1] in the last chunk's last row;
//   c. the chunk ends' system has the two right-hand sides;
//   d. pn is formed in every lane from lane 0's first rows and lane L-1's
//      Q (shuffles), and each lane forms and combines its rows into the
//      tile.
// Shared memory: the tile, nz x 32 values, and the coefficient table, 3 x
// R x 32 (R the rows a lane may hold: 4, 8, 16 or 32), and the owner
// keys: 36,096 bytes at nz = 256 and 72,192 at nz = 512 in float32.  The
// largest nz: 1025 in float32 (R = 32), 808 in float64 (the 227 KB of a
// block).  Measured on an NVIDIA H100 80GB HBM3 at 700 W
// (cales_torch.ab_dsmag, f32): 0.188 ms at 512x256x256 (bound 0.080;
// a thread a column with two scratch fields took 0.663), 0.667 ms at
// 512^3 (bound 0.320; 2.733).
#include "thomas_common.cuh"

namespace cales {

// rows of a tile, coefficient table and owner keys, in bytes
template <typename T>
size_t tp_smem(int nz, int R) {
  return (static_cast<size_t>(nz) * 32 + 3 * static_cast<size_t>(R) * 32) *
             sizeof(T) + static_cast<size_t>(nz);
}

template <typename T, int R>
__global__ void __launch_bounds__(TP_NT, (tp_min_blocks<T, R>()))
    thomas_periodic_kernel(const T* __restrict__ in, T* __restrict__ out,
                           const double* __restrict__ a,
                           const double* __restrict__ b,
                           const double* __restrict__ c,
                           const T* __restrict__ lamy,
                           const T* __restrict__ lamx, int nz, int ny,
                           int nx, int helm, double alpha, int pin, T tol) {
  extern __shared__ __align__(16) unsigned char psmem[];
  T* const tile = reinterpret_cast<T*>(psmem);        // [nz][32], swizzled
  T* const ta = tile + static_cast<int64_t>(nz) * 32; // [R][32]: row k of
  T* const tb = ta + R * 32;                          // lane l at k*32 + l
  T* const tc = tb + R * 32;
  unsigned char* const key = reinterpret_cast<unsigned char*>(tc + R * 32);
  const int n = nz - 1;
  const TpChunks ch(n);                               // the reduced rows'
  const int nl = ch.nl;                               // lanes with a chunk
  const int gx = (nx + 31) / 32;
  const int x0 = (blockIdx.x % gx) * 32;
  const int j = blockIdx.x / gx;
  const int tid = threadIdx.x;
  const int64_t plane = static_cast<int64_t>(ny) * nx;
  const int64_t off = static_cast<int64_t>(j) * nx + x0;

  // the owner lane of each tile row (its swizzle key) and the chunks'
  // coefficients; the corners a[0] and c[n-1] are out of the reduced
  // system
  for (int r = tid; r < nz; r += TP_NT)
    key[r] = static_cast<unsigned char>(ch.owner(r) & 31);
  for (int e = tid; e < R * 32; e += TP_NT) {
    const int k = e >> 5, l = e & 31;
    const int row = ch.start(l) + k;
    const bool have = k < ch.rows(l);
    // row 0: e[0] = -a[0] in the P slot of the first chunk (its P is -1
    // for p2)
    const T ar = have ? coef<T>(a, row, helm, alpha, 0.0) : T(0);
    ta[e] = row > 0 ? ar : -ar;
    tb[e] = have ? coef<T>(b, row, helm, alpha, 1.0) : T(1);
    tc[e] = have && row < n - 1 ? coef<T>(c, row, helm, alpha, 0.0) : T(0);
  }
  __syncthreads();
  tp_copy_in(tile, key, in, nz, plane, off, nx - x0);

  const int lane = tid & 31, warp = tid >> 5;
  const bool active = lane < nl;
  const int m = ch.rows(lane);
  const int s = ch.start(lane);
  const T clast = coef<T>(c, n - 1, helm, alpha, 0.0);
  const T an = coef<T>(a, n, helm, alpha, 0.0);
  const T bn = coef<T>(b, n, helm, alpha, 1.0);
  const T cn = coef<T>(c, n, helm, alpha, 0.0);
  const int keyn = key[n];
  const unsigned all = 0xffffffffu;
  for (int col = warp; col < 32; col += TP_WARPS) {
    if (x0 + col >= nx) break;
    const T lam = lamy != nullptr ? lamx[x0 + col] + lamy[j] : T(0);
    const int sw = col ^ lane;
    const T rn = tile[n * 32 + (col ^ keyn)];
    // b. the chunk, for p1 (the data) and p2 (its e[0] in A)
    T A[R], C[R], D[R];
    T ap, cp, dp, zlast, ar, cr, dr;
    tp_sweep<T, R>(
        ta, tc, lane, m,
        [&](int k, T ak, T cpv) {
          return T(1) / (tb[k * 32 + lane] + lam - ak * cpv);
        },
        [&](int k) { return tile[(s + k) * 32 + sw]; }, A, C, D, ap, cp, dp,
        zlast, ar, cr, dr);
    // c. the chunk ends, p2's e[0] in lane 0's P column and e[n-1] in the
    // last chunk's last row
    TpRow<T, 2> q = tp_coupling<T, 2>(active, lane == 0, ap, cp, dp, ar, cr,
                                      dr);
    if (active)
      q.d[1] = (lane == 0 ? ap : T(0)) +
               (lane == nl - 1 ? -clast * zlast : T(0));
    tp_pcr(q, lane);
    const T ib = T(1) / q.b;
    const T q1 = q.d[0] * ib, q2 = q.d[1] * ib;
    // d. the chunk below's Q is this chunk's P (lane 0: 0 and -1)
    T p1 = __shfl_up_sync(all, q1, 1), p2 = __shfl_up_sync(all, q2, 1);
    if (lane == 0) {
      p1 = T(0);
      p2 = T(-1);
    }
    const T x1_0 = __shfl_sync(all, D[0] - A[0] * p1 - C[0] * q1, 0);
    const T x2_0 = __shfl_sync(all, -A[0] * p2 - C[0] * q2, 0);
    const T q1_n = __shfl_sync(all, q1, nl - 1);
    const T q2_n = __shfl_sync(all, q2, nl - 1);
    const T num = rn - cn * x1_0 - an * q1_n;
    const T den = (bn + lam) + cn * x2_0 + an * q2_n;
    T pn = num / den;
    if (pin && cabs(lam) <= tol) pn = T(0);
    __syncwarp();
    if (active) {
#pragma unroll
      for (int k = 0; k < R - 1; ++k) {
        if (k <= m - 2) {
          const T x1 = D[k] - A[k] * p1 - C[k] * q1;
          const T x2 = -A[k] * p2 - C[k] * q2;
          tile[(s + k) * 32 + sw] = x1 + x2 * pn;
        }
      }
      tile[(s + m - 1) * 32 + sw] = q1 + q2 * pn;
    }
    if (lane == 0) tile[n * 32 + (col ^ keyn)] = pn;
  }
  __syncthreads();
  tp_copy_out(out, tile, key, nz, plane, off, nx - x0,
              [](int, T v) { return v; });
}

template <typename T, int R>
int launch_tp(const T* in, T* out, const double* a, const double* b,
              const double* c, const T* lamy, const T* lamx, int nz, int ny,
              int nx, int helm, double alpha, int pin, double tol,
              void* stream) {
  const size_t smem = tp_smem<T>(nz, R);
  if (smem > TP_SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = &thomas_periodic_kernel<T, R>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(((nx + 31) / 32) * ny));
  kern<<<grid, TP_NT, smem, static_cast<cudaStream_t>(stream)>>>(
      in, out, a, b, c, lamy, lamx, nz, ny, nx, helm, alpha, pin, T(tol));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_thomas_periodic(const T* in, T* out, const double* a,
                           const double* b, const double* c, const T* lamy,
                           const T* lamx, int nz, int ny, int nx, int helm,
                           double alpha, int pin, double tol, void* stream) {
  if (nz < 3 || (lamy == nullptr) != (lamx == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (tp_rows(nz - 1)) {
    case 4:
      return launch_tp<T, 4>(in, out, a, b, c, lamy, lamx, nz, ny, nx, helm,
                             alpha, pin, tol, stream);
    case 8:
      return launch_tp<T, 8>(in, out, a, b, c, lamy, lamx, nz, ny, nx, helm,
                             alpha, pin, tol, stream);
    case 16:
      return launch_tp<T, 16>(in, out, a, b, c, lamy, lamx, nz, ny, nx,
                              helm, alpha, pin, tol, stream);
    case 32:
      return launch_tp<T, 32>(in, out, a, b, c, lamy, lamx, nz, ny, nx,
                              helm, alpha, pin, tol, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace cales

#define CALES_THOMAS_PERIODIC_ENTRY(NAME, T)                                 \
  extern "C" int NAME(const T* in, T* out, const double* a,                  \
                      const double* b, const double* c, const T* lamy,       \
                      const T* lamx, int nz, int ny, int nx, int helm,       \
                      double alpha, int pin, double tol, void* stream) {     \
    return cales::launch_thomas_periodic<T>(in, out, a, b, c, lamy, lamx,    \
                                            nz, ny, nx, helm, alpha, pin,    \
                                            tol, stream);                    \
  }

CALES_THOMAS_PERIODIC_ENTRY(cales_thomas_periodic_f32, float)
CALES_THOMAS_PERIODIC_ENTRY(cales_thomas_periodic_f64, double)
