// Batched periodic tridiagonal solve along z, one thread per (y, x) column.
//
// Replaces: cales_tpu/ops/pallas_solve.py apply_thomas_periodic_z, the z
// stage of the triperiodic Poisson solve on the 'mat' route from nz >= 384
// (pinned) and of every periodic-z Helmholtz solve of full-3D implicit
// diffusion (rows a*alpha, b*alpha + 1, c*alpha; not pinned).  The algorithm
// is ops/tridiag.thomas_periodic (reference gaussel_periodic,
// solver.f90:109-151), the rank-1-corrected two-RHS Thomas sweep:
//   1. the reduced (nz-1)-row system tridiag(a, b + lam, c) is swept forward
//      once for two right-hand sides sharing its factors: the data p1 and
//      the correction p2 (e[0] = -a[0], e[nz-2] = -c[nz-2]);
//   2. both back-substitute;
//   3. pn = (r[n] - c[n] p1[0] - a[n] p1[n-1])
//           / ((b[n] + lam) + c[n] p2[0] + a[n] p2[n-1]),  n = nz - 1,
//      pinned to 0 where |lam| <= tol and pin is set (the constant mode's
//      gauge, pallas_solve.py:337-338);
//   4. out = p1 + p2 pn, out[n] = pn.
// lam = lamy[j] + lamx[i], or 0 without the rows.  The coefficient rows
// arrive in float64 and are scaled and rounded into shared memory here, as
// the JAX package rounds them on the host (T(a * alpha), ...).
//
// Bound on the H100: memory.  Threads of a warp own x-adjacent columns, so
// every z step reads and writes coalesced rows.  The factors d = c zfac and
// p2 depend on the column's lam and not on the data; the wrapper's two
// scratch fields hold d and p2, and out holds p1 between the sweeps.  Field
// streams: forward 1 read + 3 writes, backward 3 reads + 2 writes, the
// combine 2 reads + 1 write.  Caching d and p2 per lam (they do not change
// between calls) is later work.
#include "common.cuh"

namespace cales {

template <typename T>
__global__ void __launch_bounds__(CALES_THREADS) thomas_periodic_kernel(
    const T* __restrict__ in, T* __restrict__ out, T* __restrict__ wscr,
    T* __restrict__ qscr, const double* __restrict__ a,
    const double* __restrict__ b, const double* __restrict__ c,
    const T* __restrict__ lamy, const T* __restrict__ lamx, int nz, int ny,
    int nx, int helm, double alpha, int pin, T tol) {
  extern __shared__ __align__(16) unsigned char psmem[];
  T* sa = reinterpret_cast<T*>(psmem);
  T* sb = sa + nz;
  T* sc = sb + nz;
  for (int k = threadIdx.x; k < nz; k += blockDim.x) {
    sa[k] = helm ? T(a[k] * alpha) : T(a[k]);
    sb[k] = helm ? T(b[k] * alpha + 1.0) : T(b[k]);
    sc[k] = helm ? T(c[k] * alpha) : T(c[k]);
  }
  __syncthreads();
  const int64_t plane = static_cast<int64_t>(ny) * nx;
  const int64_t col =
      static_cast<int64_t>(blockIdx.x) * CALES_THREADS + threadIdx.x;
  if (col >= plane) return;
  T lam = T(0);
  if (lamy != nullptr) {
    const int j = static_cast<int>(col / nx);
    const int i = static_cast<int>(col - static_cast<int64_t>(j) * nx);
    lam = lamx[i] + lamy[j];
  }
  const int n = nz - 1;
  // forward sweep of the reduced system, row 0 peeled
  T zf = T(1) / (sb[0] + lam);
  T d = sc[0] * zf;
  T p1 = in[col] * zf;
  T p2 = -sa[0] * zf;
  wscr[col] = d;
  out[col] = p1;
  qscr[col] = p2;
  for (int k = 1; k < n; ++k) {
    const int64_t o = static_cast<int64_t>(k) * plane + col;
    const T ak = sa[k];
    zf = T(1) / (sb[k] + lam - ak * d);
    d = sc[k] * zf;
    const T e = k == n - 1 ? -sc[n - 1] : T(0);
    p1 = (in[o] - ak * p1) * zf;
    p2 = (e - ak * p2) * zf;
    wscr[o] = d;
    out[o] = p1;
    qscr[o] = p2;
  }
  // back-substitution of both; p1, p2 end as their row-0 values
  const T p1_last = p1, p2_last = p2;
  for (int k = n - 2; k >= 0; --k) {
    const int64_t o = static_cast<int64_t>(k) * plane + col;
    const T dk = wscr[o];
    p1 = out[o] - dk * p1;
    p2 = qscr[o] - dk * p2;
    out[o] = p1;
    qscr[o] = p2;
  }
  // the last row closes the periodic system
  const int64_t on = static_cast<int64_t>(n) * plane + col;
  const T num = in[on] - sc[n] * p1 - sa[n] * p1_last;
  const T den = (sb[n] + lam) + sc[n] * p2 + sa[n] * p2_last;
  T pn = num / den;
  if (pin && cabs(lam) <= tol) pn = T(0);
  for (int k = 0; k < n; ++k) {
    const int64_t o = static_cast<int64_t>(k) * plane + col;
    out[o] = out[o] + qscr[o] * pn;
  }
  out[on] = pn;
}

template <typename T>
int launch_thomas_periodic(const T* in, T* out, T* wscr, T* qscr,
                           const double* a, const double* b, const double* c,
                           const T* lamy, const T* lamx, int nz, int ny,
                           int nx, int helm, double alpha, int pin, double tol,
                           void* stream) {
  if (nz < 3 || (lamy == nullptr) != (lamx == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 3 * static_cast<size_t>(nz) * sizeof(T);
  auto kern = &thomas_periodic_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t plane = static_cast<int64_t>(ny) * nx;
  const dim3 grid(
      static_cast<unsigned>((plane + CALES_THREADS - 1) / CALES_THREADS));
  kern<<<grid, CALES_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      in, out, wscr, qscr, a, b, c, lamy, lamx, nz, ny, nx, helm, alpha, pin,
      T(tol));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cales

#define CALES_THOMAS_PERIODIC_ENTRY(NAME, T)                                 \
  extern "C" int NAME(const T* in, T* out, T* wscr, T* qscr,                 \
                      const double* a, const double* b, const double* c,     \
                      const T* lamy, const T* lamx, int nz, int ny, int nx,  \
                      int helm, double alpha, int pin, double tol,           \
                      void* stream) {                                        \
    return cales::launch_thomas_periodic<T>(in, out, wscr, qscr, a, b, c,    \
                                            lamy, lamx, nz, ny, nx, helm,    \
                                            alpha, pin, tol, stream);        \
  }

CALES_THOMAS_PERIODIC_ENTRY(cales_thomas_periodic_f32, float)
CALES_THOMAS_PERIODIC_ENTRY(cales_thomas_periodic_f64, double)
