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
// written once; no scratch field).  A block owns 32 x-adjacent columns of
// one y row over the whole z extent: it copies the (nz, 32) tile into
// shared memory a z row at a time (128 contiguous bytes in float32,
// cp.async), solves it there and stores it the same way.  A thread a
// column would run 3 nz dependent steps; here the 32 lanes of a warp
// split a column (the hybrid Thomas-PCR scheme of Laszlo, Giles &
// Appleyard, ACM TOMS 42(4), 2016), as ops/tridiag.thomas_periodic_chunked
// does step by step:
//   a. the reduced system's rows 0 .. n-1 go in L = min(32, n/7) chunks
//      (at least one) of m = n/L or n/L + 1 consecutive rows, one a lane;
//      chunks of at least 7 rows, because the chunk's sweep is more
//      accurate than the cyclic reduction on the pinned lane's nearly
//      singular system;
//   b. a lane sweeps its chunk in registers: forward, each row in terms of
//      the next and of P, the last unknown of the chunk below, then
//      backward, each row in terms of P and Q, its own last unknown:
//      x_k = D_k - A_k P - C_k Q;
//   c. a chunk's last row, with the first row of the chunk above put in,
//      couples only the Q of neighbouring lanes: a tridiagonal system of
//      one row a lane, solved by parallel cyclic reduction over shuffles
//      (lanes 1, 2, 4, 8, 16 away; lanes past L hold identity rows);
//   d. p2's right-hand side e is zero but in rows 0 and n-1: e[0] = -a[0]
//      rides in the first chunk's P coefficients (that chunk has no P:
//      P = 0 for p1, -1 for p2), e[n-1] in the last chunk's last row;
//      pn is formed in every lane from lane 0's first rows and lane L-1's
//      Q (shuffles), and each lane forms and combines its rows into the
//      tile.
// A lane at step k touches row s_l + k; the tile's column index is
// swizzled by the owner lane of the row (col ^ owner), so the 32 lanes
// hit 32 banks, and a z row is still a permutation of the banks for the
// coalesced copies.  The chunk's coefficients are laid out [k][lane] in
// shared memory for the same reason.  Shared memory: the tile, nz x 32
// values, and the coefficient table, 3 x R x 32 (R the rows a lane may
// hold: 4, 8, 16 or 32), and the owner keys: 36,096 bytes at nz = 256 and
// 72,192 at nz = 512 in float32.  The largest nz: 1025 in float32 (R = 32), 808 in float64 (the
// 227 KB of a block).  Measured on an NVIDIA H100 80GB HBM3 at 700 W
// (cales_torch.ab_dsmag, f32): 0.188 ms at 512x256x256 (bound 0.080;
// a thread a column with two scratch fields took 0.663), 0.667 ms at
// 512^3 (bound 0.320; 2.733).
#include "common.cuh"

namespace cales {

constexpr int TP_WARPS = 8;              // a block's warps
constexpr int TP_NT = 32 * TP_WARPS;     // its threads; 32 columns a block
constexpr size_t TP_SMEM_MAX = 232448;   // shared memory of a block

// the lanes that hold a chunk of the n reduced rows: chunks of at least
// TP_MIN_ROWS rows, at least one lane, at most 32
constexpr int TP_MIN_ROWS = 7;
__host__ __device__ inline int tp_lanes(int n) {
  const int l = n / TP_MIN_ROWS;
  return l < 1 ? 1 : l > 32 ? 32 : l;
}

// rows of a tile, coefficient table and owner keys, in bytes
template <typename T>
size_t tp_smem(int nz, int R) {
  return (static_cast<size_t>(nz) * 32 + 3 * static_cast<size_t>(R) * 32) *
             sizeof(T) + static_cast<size_t>(nz);
}

// One row of the reduced system: a Q_below + b Q + c Q_above = d, for the
// two right-hand sides.
template <typename T>
struct Row {
  T a, b, c, d1, d2;
};

// Row r of the lane `src` (1 / its b in place of b), or the identity row
// where src is past the warp's ends.
template <typename T>
__device__ __forceinline__ Row<T> neighbour(const Row<T>& r, T ib, int src) {
  const unsigned all = 0xffffffffu;
  const bool in = src >= 0 && src < 32;
  const int q = in ? src : 0;
  const Row<T> o{__shfl_sync(all, r.a, q), __shfl_sync(all, ib, q),
                 __shfl_sync(all, r.c, q), __shfl_sync(all, r.d1, q),
                 __shfl_sync(all, r.d2, q)};
  return in ? o : Row<T>{T(0), T(1), T(0), T(0), T(0)};
}

template <typename T>
__device__ __forceinline__ T coef(const double* q, int k, int helm,
                                  double alpha, double add) {
  return helm ? T(q[k] * alpha + add) : T(q[k]);
}

// Blocks an SM the float32 register count is held to: 4 up to 8 rows a
// lane (64 registers, no spills), 3 at 16 (80, a few spilled words), 2
// at 32; float64 takes what it needs.
template <typename T, int R>
constexpr int tp_min_blocks() {
  return sizeof(T) != 4 ? 1 : R <= 8 ? 4 : R <= 16 ? 3 : 2;
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
  const int nl = tp_lanes(n);                         // lanes with a chunk
  const int base = n / nl, extra = n - base * nl;
  const int gx = (nx + 31) / 32;
  const int x0 = (blockIdx.x % gx) * 32;
  const int j = blockIdx.x / gx;
  const int tid = threadIdx.x;
  const int64_t plane = static_cast<int64_t>(ny) * nx;
  const int64_t off = static_cast<int64_t>(j) * nx + x0;

  // the owner lane of each tile row (its swizzle key) and the chunks'
  // coefficients; the corners a[0] and c[n-1] are out of the reduced
  // system
  const int split = extra * (base + 1);
  for (int r = tid; r < nz; r += TP_NT) {
    const int own = r < split ? r / (base + 1) : extra + (r - split) / base;
    key[r] = static_cast<unsigned char>(own & 31);
  }
  for (int e = tid; e < R * 32; e += TP_NT) {
    const int k = e >> 5, l = e & 31;
    const int m = base + (l < extra), row = l * base + min(l, extra) + k;
    const bool have = l < nl && k < m;
    // row 0: e[0] = -a[0] in the P slot of the first chunk (its P is -1
    // for p2)
    const T ar = have ? coef<T>(a, row, helm, alpha, 0.0) : T(0);
    ta[e] = row > 0 ? ar : -ar;
    tb[e] = have ? coef<T>(b, row, helm, alpha, 1.0) : T(1);
    tc[e] = have && row < n - 1 ? coef<T>(c, row, helm, alpha, 0.0) : T(0);
  }
  __syncthreads();
  for (int e = tid; e < nz * 32; e += TP_NT) {
    const int r = e >> 5, col = e & 31;
    if (x0 + col < nx)
      cp_async(tile + r * 32 + (col ^ key[r]),
               in + static_cast<int64_t>(r) * plane + off + col);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  const bool active = lane < nl;
  const int m = active ? base + (lane < extra) : 0;
  const int s = lane * base + min(lane, extra);
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
    // b. forward: x_k + A_k P + C_k x_{k+1} = D_k
    T A[R], C[R], D[R];
    T ap = T(-1), cp = T(0), dp = T(0), zlast = T(0);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      A[k] = C[k] = D[k] = T(0);
      if (k < m) {
        const T ak = ta[k * 32 + lane];
        const T zf = T(1) / (tb[k * 32 + lane] + lam - ak * cp);
        A[k] = -(ak * ap) * zf;
        C[k] = tc[k * 32 + lane] * zf;
        D[k] = (tile[(s + k) * 32 + sw] - ak * dp) * zf;
        ap = A[k];
        cp = C[k];
        dp = D[k];
        zlast = zf;
      }
    }
    // backward: x_k = D_k - A_k P - C_k Q (k = m-2 .. 0); (ar, cr, dr)
    // end as the first row's
    T ar = T(0), cr = T(-1), dr = T(0);
#pragma unroll
    for (int k = R - 2; k >= 0; --k) {
      if (k <= m - 2) {
        D[k] = D[k] - C[k] * dr;
        A[k] = A[k] - C[k] * ar;
        C[k] = -C[k] * cr;
        ar = A[k];
        cr = C[k];
        dr = D[k];
      }
    }
    if (!active) ar = cr = dr = T(0);
    // c. the last row with the first row of the chunk above put in
    const T au = __shfl_down_sync(all, ar, 1);
    const T cu = __shfl_down_sync(all, cr, 1);
    const T du = __shfl_down_sync(all, dr, 1);
    Row<T> q{T(0), T(1), T(0), T(0), T(0)};
    if (active)
      q = Row<T>{lane == 0 ? T(0) : ap, T(1) - cp * au, -cp * cu,
                 dp - cp * du,
                 (lane == 0 ? ap : T(0)) +
                     (lane == nl - 1 ? -clast * zlast : T(0))};
#pragma unroll
    for (int delta = 1; delta < 32; delta <<= 1) {
      const T ib = T(1) / q.b;
      const Row<T> lo = neighbour(q, ib, lane - delta);
      const Row<T> hi = neighbour(q, ib, lane + delta);
      const T k1 = q.a * lo.b, k2 = q.c * hi.b;
      q = Row<T>{-lo.a * k1, q.b - lo.c * k1 - hi.a * k2, -hi.c * k2,
                 q.d1 - lo.d1 * k1 - hi.d1 * k2,
                 q.d2 - lo.d2 * k1 - hi.d2 * k2};
    }
    const T ib = T(1) / q.b;
    const T q1 = q.d1 * ib, q2 = q.d2 * ib;
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
  for (int e = tid; e < nz * 32; e += TP_NT) {
    const int r = e >> 5, col = e & 31;
    if (x0 + col < nx)
      out[static_cast<int64_t>(r) * plane + off + col] =
          tile[r * 32 + (col ^ key[r])];
  }
}

// rows a lane may hold for nz: R in {4, 8, 16, 32}, 0 past them
inline int tp_rows(int nz) {
  const int n = nz - 1, nl = tp_lanes(n);
  const int m = (n + nl - 1) / nl;
  return m <= 4 ? 4 : m <= 8 ? 8 : m <= 16 ? 16 : m <= 32 ? 32 : 0;
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
  switch (tp_rows(nz)) {
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
