// Batched tridiagonal solve along z, one thread per (y, x) column.
//
// Replaces: cales_tpu/ops/pallas_solve.py _apply_thomas_z, the body of both
//   apply_thomas_z            (Poisson z stage: diagonal b + lamy[j] +
//                              lamx[i], singular lanes pinned), and
//   apply_thomas_helmholtz_z  (z-only Crank-Nicolson solve: rows a*alpha,
//                              b*alpha + 1, c*alpha; a constant RHS shift;
//                              n_solve < nz passes the tail rows through;
//                              boundary planes added to rows 0, n_solve-1).
// The sweep is ops/tridiag.thomas (reference dgtsv_homebrewed,
// solver.f90:153-179): zfac = 1 / (b + lam - a d_prev), d = c zfac,
// p = (rhs - a p_prev) zfac forward, then p -= d p_next backward.  With
// pin, lanes with |lam| <= tol get the first zfac zeroed (p[0] = 0: the
// exactly singular constant mode's gauge, pallas_solve.py:437-441).
//
// Coefficients a, b, c arrive in float64 and are scaled and rounded here
// as the JAX package rounds them on the host (T(a * alpha), ...).
//
// Bound on the H100: memory.  Threads of a warp own x-adjacent columns, so
// every z step reads and writes one coalesced row.  The forward sweep
// reads the RHS and writes p; the backward sweep reads p and rewrites it:
// four field streams.  Without lam (the Helmholtz variant) the factors d
// and zfac depend on z alone: thread 0 of each block computes them into
// shared memory and every column reads them from there.  With lam they
// differ per column and the wrapper's scratch field holds d.
//
// The solve may run in place (out == in): each thread reads row k of its
// column before it writes it.
#include "common.cuh"

namespace cales {

template <typename T>
__global__ void __launch_bounds__(CALES_THREADS) thomas_z_kernel(
    const T* in, T* out, T* __restrict__ wscr, const double* __restrict__ a,
    const double* __restrict__ b, const double* __restrict__ c,
    const T* __restrict__ lamy, const T* __restrict__ lamx,
    const T* __restrict__ shift, const T* __restrict__ bclo,
    const T* __restrict__ bchi, int nz, int ny, int nx, int ns, int helm,
    double alpha, int pin, T tol) {
  extern __shared__ __align__(16) unsigned char tsmem[];
  T* dtab = reinterpret_cast<T*>(tsmem);  // [ns] c zfac   (no lam)
  T* ztab = dtab + ns;                    // [ns] zfac     (no lam)
  const bool has_lam = lamy != nullptr;
  auto coef = [&](const double* q, int k, double add) -> T {
    return helm ? T(q[k] * alpha + add) : T(q[k]);
  };
  if (!has_lam) {
    if (threadIdx.x == 0) {
      T d_prev = T(0);
      for (int k = 0; k < ns; ++k) {
        const T ak = coef(a, k, 0.0), bk = coef(b, k, 1.0);
        const T zf = k == 0 ? T(1) / (bk + T(0))
                            : T(1) / (bk + T(0) - ak * d_prev);
        d_prev = coef(c, k, 0.0) * zf;
        dtab[k] = d_prev;
        ztab[k] = zf;
      }
    }
    __syncthreads();
  }
  const int64_t plane = static_cast<int64_t>(ny) * nx;
  const int64_t col =
      static_cast<int64_t>(blockIdx.x) * CALES_THREADS + threadIdx.x;
  if (col >= plane) return;
  const T sh = shift != nullptr ? *shift : T(0);
  T lam = T(0);
  if (has_lam) {
    const int j = static_cast<int>(col / nx);
    const int i = static_cast<int>(col - static_cast<int64_t>(j) * nx);
    lam = lamx[i] + lamy[j];
  }
  // forward sweep (row 0 peeled: the pin and the lower boundary plane)
  T zf, d, p;
  if (has_lam) {
    zf = T(1) / (coef(b, 0, 1.0) + lam);
    if (pin && cabs(lam) <= tol) zf = T(0);
    d = coef(c, 0, 0.0) * zf;
    wscr[col] = d;
  } else {
    zf = ztab[0];
  }
  T rhs = in[col] + sh;
  if (bclo != nullptr) rhs = rhs + bclo[col];
  p = rhs * zf;
  out[col] = p;
  for (int k = 1; k < ns; ++k) {
    const int64_t o = static_cast<int64_t>(k) * plane + col;
    const T ak = coef(a, k, 0.0);
    if (has_lam) {
      zf = T(1) / (coef(b, k, 1.0) + lam - ak * d);
      d = coef(c, k, 0.0) * zf;
      wscr[o] = d;
    } else {
      zf = ztab[k];
    }
    rhs = in[o] + sh;
    if (bchi != nullptr && k == ns - 1) rhs = rhs + bchi[col];
    p = (rhs - ak * p) * zf;
    out[o] = p;
  }
  // backward sweep
  for (int k = ns - 2; k >= 0; --k) {
    const int64_t o = static_cast<int64_t>(k) * plane + col;
    const T dk = has_lam ? wscr[o] : dtab[k];
    p = out[o] - dk * p;
    out[o] = p;
  }
  // pass-through tail (the face-staggered Dirichlet row), shifted too
  for (int k = ns; k < nz; ++k) {
    const int64_t o = static_cast<int64_t>(k) * plane + col;
    out[o] = in[o] + sh;
  }
}

template <typename T>
int launch_thomas_z(const T* in, T* out, T* wscr, const double* a,
                    const double* b, const double* c, const T* lamy,
                    const T* lamx, const T* shift, const T* bclo,
                    const T* bchi, int nz, int ny, int nx, int ns, int helm,
                    double alpha, int pin, double tol, void* stream) {
  if (ns < 2 || ns > nz) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = lamy != nullptr ? 0 : 2 * static_cast<size_t>(ns) *
                                                sizeof(T);
  auto kern = &thomas_z_kernel<T>;
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
      in, out, wscr, a, b, c, lamy, lamx, shift, bclo, bchi, nz, ny, nx, ns,
      helm, alpha, pin, T(tol));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cales

#define CALES_THOMAS_Z_ENTRY(NAME, T)                                        \
  extern "C" int NAME(const T* in, T* out, T* wscr, const double* a,         \
                      const double* b, const double* c, const T* lamy,       \
                      const T* lamx, const T* shift, const T* bclo,          \
                      const T* bchi, int nz, int ny, int nx, int ns,         \
                      int helm, double alpha, int pin, double tol,           \
                      void* stream) {                                        \
    return cales::launch_thomas_z<T>(in, out, wscr, a, b, c, lamy, lamx,     \
                                     shift, bclo, bchi, nz, ny, nx, ns,      \
                                     helm, alpha, pin, tol, stream);         \
  }

CALES_THOMAS_Z_ENTRY(cales_thomas_z_f32, float)
CALES_THOMAS_Z_ENTRY(cales_thomas_z_f64, double)
