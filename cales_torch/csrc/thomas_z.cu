// Batched tridiagonal solve along z, one warp per (y, x) column.
//
// Replaces: cales_tpu/ops/pallas_solve.py _apply_thomas_z, the body of both
//   apply_thomas_z            (Poisson z stage: diagonal b + lamy[j] +
//                              lamx[i], singular lanes pinned), and
//   apply_thomas_helmholtz_z  (z-only Crank-Nicolson solve: rows a*alpha,
//                              b*alpha + 1, c*alpha; a constant RHS shift;
//                              n_solve < nz passes the tail rows through;
//                              boundary planes added to rows 0, n_solve-1).
// The system is ops/tridiag.thomas's (reference dgtsv_homebrewed,
// solver.f90:153-179): rows 0 .. ns-1 of tridiag(a, b + lam, c), a[0] and
// c[ns-1] out of it, the right-hand side in + shift with bc_lo added to
// row 0 and bc_hi to row ns-1; rows ns .. nz-1 are in + shift.  With pin,
// a lane with |lam| <= tol has its first pivot reciprocal zeroed, as the
// sweep's zfac[0] (pallas_solve.py:437-441): row 0 reads x_0 = 0, the
// identity row with right-hand side 0, and the other rows are solved with
// it, so p[0] = 0 exactly (the singular constant mode's gauge).
//
// The coefficient rows arrive in float64 and are scaled and rounded here
// as the JAX package rounds them on the host (T(a * alpha), ...).
//
// Bound on the H100: memory, two field streams (each value read once and
// written once; no scratch field).  A block solves 32 columns in shared
// memory, a column a warp, by thomas_common.cuh's chunks of >= 7 rows a
// lane, swept in registers, and cyclic reduction over shuffles of the
// chunk ends (one right-hand side; the first chunk has no P, the last
// chunk's Q is row ns-1).  With lam each column's pivots are its own and
// are formed in the sweep; without it (the Helmholtz rows) they depend on
// z alone: the first warp's lanes form their chunks' reciprocals once a
// block, in parallel, into the coefficient table.  Shared memory: the
// tile, nz x 32 values, the coefficient table, 3 x (rows of the longest
// chunk) x 32, the boundary planes' 2 x 32 values and the owner keys:
// 36,352 bytes at nz = 256 in float32.  The largest nz: 1280 in float32
// (40 rows a lane), 808 in float64 (the 227 KB of a block).  float32 is
// held to four blocks an SM up to 8 rows a lane (60-62 registers, no
// spills), three at 16 (80, a few spilled words).  Measured on an NVIDIA
// H100 80GB HBM3 at 700 W (cales_torch.ab_dsmag, f32, 512x256x256; bound
// 0.080): 0.169 ms Helmholtz, 0.177 Poisson pinned, 0.185 with lam alpha
// and the tail row (0.334, 0.372, 0.378 for a thread a column through
// device memory, with a scratch field where lam is given); 0.621 at
// 512^3 pinned (1.580; bound 0.320).
#include "thomas_common.cuh"

namespace cales {

// rows of a tile, coefficient table, boundary values and owner keys, in
// bytes
template <typename T>
size_t tz_smem(int nz, int ns) {
  return (static_cast<size_t>(nz) * 32 +
          3 * static_cast<size_t>(TpChunks(ns).longest()) * 32 + 64) *
             sizeof(T) + static_cast<size_t>(nz);
}

template <typename T, int R, bool LAM>
__global__ void __launch_bounds__(TP_NT, (tp_min_blocks<T, R>()))
    thomas_z_kernel(const T* __restrict__ in, T* __restrict__ out,
                    const double* __restrict__ a,
                    const double* __restrict__ b,
                    const double* __restrict__ c, const T* __restrict__ lamy,
                    const T* __restrict__ lamx, const T* __restrict__ shift,
                    const T* __restrict__ bclo, const T* __restrict__ bchi,
                    int nz, int ny, int nx, int ns, int helm, double alpha,
                    int pin, T tol) {
  extern __shared__ __align__(16) unsigned char zsmem[];
  const TpChunks ch(ns);
  const int mr = ch.longest();
  T* const tile = reinterpret_cast<T*>(zsmem);        // [nz][32], swizzled
  T* const ta = tile + static_cast<int64_t>(nz) * 32; // [mr][32]: row k of
  T* const tb = ta + mr * 32;                         // lane l at k*32 + l
  T* const tc = tb + mr * 32;
  T* const bnd = tc + mr * 32;                        // [2][32]: bc_lo, hi
  unsigned char* const key = reinterpret_cast<unsigned char*>(bnd + 64);
  const int gx = (nx + 31) / 32;
  const int x0 = (blockIdx.x % gx) * 32;
  const int j = blockIdx.x / gx;
  const int tid = threadIdx.x;
  const int64_t plane = static_cast<int64_t>(ny) * nx;
  const int64_t off = static_cast<int64_t>(j) * nx + x0;
  const bool bc = bclo != nullptr;

  // the owner lane of each solved row (its swizzle key; the tail rows keep
  // their column), the chunks' rows with a[0] and c[ns-1] out of the
  // system, and the boundary planes' values at the tile's columns
  for (int r = tid; r < nz; r += TP_NT)
    key[r] = static_cast<unsigned char>(r < ns ? ch.owner(r) & 31 : 0);
  for (int e = tid; e < mr * 32; e += TP_NT) {
    const int k = e >> 5, l = e & 31;
    const int row = ch.start(l) + k;
    const bool have = k < ch.rows(l);
    ta[e] = have && row > 0 ? coef<T>(a, row, helm, alpha, 0.0) : T(0);
    tb[e] = have ? coef<T>(b, row, helm, alpha, 1.0) : T(1);
    tc[e] = have && row < ns - 1 ? coef<T>(c, row, helm, alpha, 0.0) : T(0);
  }
  for (int e = tid; e < 64; e += TP_NT) {
    const int col = e & 31;
    bnd[e] = bc && x0 + col < nx ? (e < 32 ? bclo : bchi)[off + col] : T(0);
  }
  __syncthreads();
  const int lane = tid & 31, warp = tid >> 5;
  const int m = ch.rows(lane);
  if (!LAM && warp == 0) {
    // the pivot reciprocals of the lane's chunk, the same in every column
    T cp = T(0);
    for (int k = 0; k < m; ++k) {
      const T ak = ta[k * 32 + lane];
      const T zf = T(1) / (tb[k * 32 + lane] - ak * cp);
      tb[k * 32 + lane] = zf;
      cp = tc[k * 32 + lane] * zf;
    }
  }
  tp_copy_in(tile, key, in, nz, plane, off, nx - x0);

  const int nl = ch.nl;
  const bool active = lane < nl;
  const int s = ch.start(lane);
  const T sh = shift != nullptr ? *shift : T(0);
  const unsigned all = 0xffffffffu;
  for (int col = warp; col < 32; col += TP_WARPS) {
    if (x0 + col >= nx) break;
    T lam = T(0);
    bool pin0 = false;        // this lane's row 0 pinned
    if (LAM) {
      lam = lamx[x0 + col] + lamy[j];
      pin0 = lane == 0 && pin && cabs(lam) <= tol;
    }
    const int sw = col ^ lane;
    const T blo = bnd[col], bhi = bnd[32 + col];
    // b. the chunk
    T A[R], C[R], D[R];
    T ap, cp, dp, zlast, ar, cr, dr;
    tp_sweep<T, R>(
        ta, tc, lane, m,
        [&](int k, T ak, T cpv) {
          if (!LAM) return tb[k * 32 + lane];
          const T zf = T(1) / (tb[k * 32 + lane] + lam - ak * cpv);
          return k == 0 && pin0 ? T(0) : zf;
        },
        [&](int k) {
          T r = tile[(s + k) * 32 + sw] + sh;
          if (bc && k == 0 && lane == 0) r = r + blo;
          if (bc && k == m - 1 && lane == nl - 1) r = r + bhi;
          return r;
        },
        A, C, D, ap, cp, dp, zlast, ar, cr, dr);
    // c. the chunk ends
    TpRow<T, 1> q = tp_coupling<T, 1>(active, lane == 0, ap, cp, dp, ar, cr,
                                      dr);
    tp_pcr(q, lane);
    const T q1 = q.d[0] * (T(1) / q.b);
    // d. the chunk below's Q is this chunk's P (lane 0 has none)
    T p1 = __shfl_up_sync(all, q1, 1);
    if (lane == 0) p1 = T(0);
    if (active) {
#pragma unroll
      for (int k = 0; k < R - 1; ++k)
        if (k <= m - 2) tile[(s + k) * 32 + sw] = D[k] - A[k] * p1 - C[k] * q1;
      tile[(s + m - 1) * 32 + sw] = q1;
    }
  }
  __syncthreads();
  // the tail rows pass through, shifted
  tp_copy_out(out, tile, key, nz, plane, off, nx - x0,
              [&](int r, T v) { return r < ns ? v : v + sh; });
}

template <typename T, int R, bool LAM>
int launch_tz(const T* in, T* out, const double* a, const double* b,
              const double* c, const T* lamy, const T* lamx, const T* shift,
              const T* bclo, const T* bchi, int nz, int ny, int nx, int ns,
              int helm, double alpha, int pin, double tol, void* stream) {
  const size_t smem = tz_smem<T>(nz, ns);
  if (smem > TP_SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = &thomas_z_kernel<T, R, LAM>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(((nx + 31) / 32) * ny));
  kern<<<grid, TP_NT, smem, static_cast<cudaStream_t>(stream)>>>(
      in, out, a, b, c, lamy, lamx, shift, bclo, bchi, nz, ny, nx, ns, helm,
      alpha, pin, T(tol));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int R>
int launch_tz_rows(const T* in, T* out, const double* a, const double* b,
                   const double* c, const T* lamy, const T* lamx,
                   const T* shift, const T* bclo, const T* bchi, int nz,
                   int ny, int nx, int ns, int helm, double alpha, int pin,
                   double tol, void* stream) {
  auto go = lamy != nullptr ? &launch_tz<T, R, true> : &launch_tz<T, R, false>;
  return go(in, out, a, b, c, lamy, lamx, shift, bclo, bchi, nz, ny, nx, ns,
            helm, alpha, pin, tol, stream);
}

template <typename T>
int launch_thomas_z(const T* in, T* out, const double* a, const double* b,
                    const double* c, const T* lamy, const T* lamx,
                    const T* shift, const T* bclo, const T* bchi, int nz,
                    int ny, int nx, int ns, int helm, double alpha, int pin,
                    double tol, void* stream) {
  if (ns < 2 || ns > nz || (lamy == nullptr) != (lamx == nullptr) ||
      (bclo == nullptr) != (bchi == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto go = &launch_tz_rows<T, 4>;
  switch (tp_rows(ns)) {
    case 4: break;
    case 8: go = &launch_tz_rows<T, 8>; break;
    case 16: go = &launch_tz_rows<T, 16>; break;
    case 32: go = &launch_tz_rows<T, 32>; break;
    case 40:   // float32 past 1024 rows; float64 has no room for them
      if constexpr (sizeof(T) == 4) {
        go = &launch_tz_rows<T, 40>;
        break;
      }
      return static_cast<int>(cudaErrorInvalidValue);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return go(in, out, a, b, c, lamy, lamx, shift, bclo, bchi, nz, ny, nx, ns,
            helm, alpha, pin, tol, stream);
}

}  // namespace cales

#define CALES_THOMAS_Z_ENTRY(NAME, T)                                        \
  extern "C" int NAME(const T* in, T* out, const double* a,                  \
                      const double* b, const double* c, const T* lamy,       \
                      const T* lamx, const T* shift, const T* bclo,          \
                      const T* bchi, int nz, int ny, int nx, int ns,         \
                      int helm, double alpha, int pin, double tol,           \
                      void* stream) {                                        \
    return cales::launch_thomas_z<T>(in, out, a, b, c, lamy, lamx, shift,    \
                                     bclo, bchi, nz, ny, nx, ns, helm,       \
                                     alpha, pin, tol, stream);               \
  }

CALES_THOMAS_Z_ENTRY(cales_thomas_z_f32, float)
CALES_THOMAS_Z_ENTRY(cales_thomas_z_f64, double)
