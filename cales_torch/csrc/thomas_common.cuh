// The column solvers' shared parts: csrc/thomas_z.cu (tridiagonal) and
// csrc/thomas_periodic.cu (periodic, rank-1 corrected).
//
// A block owns 32 x-adjacent columns of one y row over the whole z extent:
// it copies the (nz, 32) tile into shared memory a z row at a time (128
// contiguous bytes in float32, cp.async), its warps solve the columns
// there, and it stores the tile the same way.  A thread a column would run
// a dependent chain of 2 n steps; here the 32 lanes of a warp split a
// column by the hybrid Thomas-PCR scheme of Laszlo, Giles & Appleyard
// (ACM TOMS 42(4), 2016), as ops/tridiag.thomas_chunked and
// thomas_periodic_chunked do step by step:
//   a. the n rows of the system go in L = min(32, n/7) chunks (at least
//      one) of m = n/L or n/L + 1 consecutive rows, one a lane (TpChunks);
//      chunks of at least 7 rows, because a chunk's sweep is more accurate
//      than the cyclic reduction on a pinned lane's nearly singular rows;
//   b. a lane sweeps its chunk in registers (tp_sweep): forward, each row
//      in terms of the next and of P, the last unknown of the chunk below,
//      then backward, each row in terms of P and Q, its own last unknown:
//      x_k = D_k - A_k P - C_k Q;
//   c. a chunk's last row, with the first row of the chunk above put in,
//      couples only the Q of neighbouring lanes (tp_coupling): a
//      tridiagonal system of one row a lane, solved by parallel cyclic
//      reduction over shuffles (tp_pcr: lanes 1, 2, 4, 8, 16 away; lanes
//      past L hold identity rows);
//   d. each lane recovers its rows from P and Q into the tile.
// A lane at step k touches row s_l + k; the tile's column index is
// swizzled by the owner lane of the row (col ^ owner), so the 32 lanes hit
// 32 banks, and a z row is still a permutation of the banks for the
// coalesced copies.  The chunks' coefficients are laid out [k][lane] in
// shared memory for the same reason.
#pragma once

#include "common.cuh"

namespace cales {

constexpr int TP_WARPS = 8;              // a block's warps
constexpr int TP_NT = 32 * TP_WARPS;     // its threads; 32 columns a block
constexpr size_t TP_SMEM_MAX = 232448;   // shared memory of a block

// the lanes that hold a chunk of n rows: chunks of at least TP_MIN_ROWS
// rows, at least one lane, at most 32
constexpr int TP_MIN_ROWS = 7;
__host__ __device__ inline int tp_lanes(int n) {
  const int l = n / TP_MIN_ROWS;
  return l < 1 ? 1 : l > 32 ? 32 : l;
}

// rows a lane may hold for n rows: R in {4, 8, 16, 32, 40}, 0 past them
inline int tp_rows(int n) {
  const int nl = tp_lanes(n);
  const int m = (n + nl - 1) / nl;
  return m <= 4 ? 4 : m <= 8 ? 8 : m <= 16 ? 16 : m <= 32 ? 32
         : m <= 40 ? 40 : 0;
}

// Blocks an SM the float32 register count is held to: 4 up to 8 rows a
// lane (64 registers), 3 at 16 (80), 2 beyond, at the cost of a few
// spilled words in the periodic solve; float64 takes what it needs.
template <typename T, int R>
constexpr int tp_min_blocks() {
  return sizeof(T) != 4 ? 1 : R <= 8 ? 4 : R <= 16 ? 3 : 2;
}

// The chunks of n rows: lane l holds rows(l) rows from start(l).
struct TpChunks {
  int nl, base, extra;
  __host__ __device__ explicit TpChunks(int n)
      : nl(tp_lanes(n)), base(n / tp_lanes(n)),
        extra(n - (n / tp_lanes(n)) * tp_lanes(n)) {}
  __device__ __forceinline__ int rows(int l) const {
    return l < nl ? base + (l < extra) : 0;
  }
  __device__ __forceinline__ int start(int l) const {
    return l * base + min(l, extra);
  }
  __host__ __device__ int longest() const { return base + (extra > 0); }
  // the lane of row r (r may pass the last row: a lane past nl)
  __device__ __forceinline__ int owner(int r) const {
    const int split = extra * (base + 1);
    return r < split ? r / (base + 1) : extra + (r - split) / base;
  }
};

template <typename T>
__device__ __forceinline__ T coef(const double* q, int k, int helm,
                                  double alpha, double add) {
  return helm ? T(q[k] * alpha + add) : T(q[k]);
}

// The block's copy of its tile of nz rows (rows of 32 columns from off,
// ncol of them in range) into shared memory, swizzled by key; visible to
// the block on return.
template <typename T>
__device__ __forceinline__ void tp_copy_in(T* tile, const unsigned char* key,
                                           const T* in, int nz,
                                           int64_t plane, int64_t off,
                                           int ncol) {
  for (int e = threadIdx.x; e < nz * 32; e += TP_NT) {
    const int r = e >> 5, col = e & 31;
    if (col < ncol)
      cp_async(tile + r * 32 + (col ^ key[r]),
               in + static_cast<int64_t>(r) * plane + off + col);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// The tile back to device memory, fix(r, value) applied to row r's values.
template <typename T, class Fix>
__device__ __forceinline__ void tp_copy_out(T* out, const T* tile,
                                            const unsigned char* key, int nz,
                                            int64_t plane, int64_t off,
                                            int ncol, const Fix& fix) {
  for (int e = threadIdx.x; e < nz * 32; e += TP_NT) {
    const int r = e >> 5, col = e & 31;
    if (col < ncol)
      out[static_cast<int64_t>(r) * plane + off + col] =
          fix(r, tile[r * 32 + (col ^ key[r])]);
  }
}

// b. The lane's chunk of m rows (m = 0 on a lane without one) in
// registers.  ta and tc hold the rows' a and c ([k][lane]); pivot(k, a_k,
// C_{k-1}) is row k's pivot reciprocal, rhs(k) its right-hand side.
// Forward: x_k + A_k P + C_k x_{k+1} = D_k, from the pseudo-row x_{-1} =
// P; (ap, cp, dp) end as the last row's and zlast as its reciprocal.
// Backward: x_k = D_k - A_k P - C_k Q (k = m-2 .. 0); (ar, cr, dr) end as
// the first row's, zero on a lane without a chunk.
template <typename T, int R, class Pivot, class Rhs>
__device__ __forceinline__ void tp_sweep(const T* ta, const T* tc, int lane,
                                         int m, const Pivot& pivot,
                                         const Rhs& rhs, T (&A)[R],
                                         T (&C)[R], T (&D)[R], T& ap, T& cp,
                                         T& dp, T& zlast, T& ar, T& cr,
                                         T& dr) {
  ap = T(-1);
  cp = dp = zlast = T(0);
#pragma unroll
  for (int k = 0; k < R; ++k) {
    A[k] = C[k] = D[k] = T(0);
    if (k < m) {
      const T ak = ta[k * 32 + lane];
      const T zf = pivot(k, ak, cp);
      A[k] = -(ak * ap) * zf;
      C[k] = tc[k * 32 + lane] * zf;
      D[k] = (rhs(k) - ak * dp) * zf;
      ap = A[k];
      cp = C[k];
      dp = D[k];
      zlast = zf;
    }
  }
  ar = T(0);
  cr = T(-1);
  dr = T(0);
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
  if (m == 0) ar = cr = dr = T(0);
}

// One row of the chunk ends' system: a Q_below + b Q + c Q_above = d, for
// NR right-hand sides.
template <typename T, int NR>
struct TpRow {
  T a, b, c, d[NR];
};

// c. A lane's row: its chunk's last row with the first row of the chunk
// above put in (that lane's ar, cr, dr, by shuffle); the identity row on
// a lane without a chunk.  first: the lane of the first chunk, which has
// no P.  d[1 ..] are zero, for the caller to set.
template <typename T, int NR>
__device__ __forceinline__ TpRow<T, NR> tp_coupling(bool active, bool first,
                                                    T ap, T cp, T dp, T ar,
                                                    T cr, T dr) {
  const unsigned all = 0xffffffffu;
  const T au = __shfl_down_sync(all, ar, 1);
  const T cu = __shfl_down_sync(all, cr, 1);
  const T du = __shfl_down_sync(all, dr, 1);
  TpRow<T, NR> q;
  q.a = T(0);
  q.b = T(1);
  q.c = T(0);
#pragma unroll
  for (int r = 0; r < NR; ++r) q.d[r] = T(0);
  if (active) {
    q.a = first ? T(0) : ap;
    q.b = T(1) - cp * au;
    q.c = -cp * cu;
    q.d[0] = dp - cp * du;
  }
  return q;
}

// Row r of the lane `src` (1 / its b in place of b), or the identity row
// where src is past the warp's ends.
template <typename T, int NR>
__device__ __forceinline__ TpRow<T, NR> tp_neighbour(const TpRow<T, NR>& r,
                                                     T ib, int src) {
  const unsigned all = 0xffffffffu;
  const bool in = src >= 0 && src < 32;
  const int q = in ? src : 0;
  TpRow<T, NR> o;
  o.a = __shfl_sync(all, r.a, q);
  o.b = __shfl_sync(all, ib, q);
  o.c = __shfl_sync(all, r.c, q);
#pragma unroll
  for (int k = 0; k < NR; ++k) o.d[k] = __shfl_sync(all, r.d[k], q);
  if (!in) {
    o.a = o.c = T(0);
    o.b = T(1);
#pragma unroll
    for (int k = 0; k < NR; ++k) o.d[k] = T(0);
  }
  return o;
}

// c. Parallel cyclic reduction over the warp: each lane's row ends
// decoupled, b Q = d.
template <typename T, int NR>
__device__ __forceinline__ void tp_pcr(TpRow<T, NR>& q, int lane) {
#pragma unroll
  for (int delta = 1; delta < 32; delta <<= 1) {
    const T ib = T(1) / q.b;
    const TpRow<T, NR> lo = tp_neighbour(q, ib, lane - delta);
    const TpRow<T, NR> hi = tp_neighbour(q, ib, lane + delta);
    const T k1 = q.a * lo.b, k2 = q.c * hi.b;
    TpRow<T, NR> n;
    n.a = -lo.a * k1;
    n.b = q.b - lo.c * k1 - hi.a * k2;
    n.c = -hi.c * k2;
#pragma unroll
    for (int r = 0; r < NR; ++r) n.d[r] = q.d[r] - lo.d[r] * k1 - hi.d[r] * k2;
    q = n;
  }
}

}  // namespace cales
