// Projection + pressure update, one pass.
//
// Replaces: cales_tpu/ops/pallas_kernels.py fused_correc_updatep (body
// _correc_kernel), without the x-spectral (xopi) variant.  Per output cell:
//   u = fu + u - dt dxi (pp(i+1) - pp),  v = fv + v - dt dyi (pp(j+1) - pp)
//   w = w - dt dzci(k) (pp(k+1) - pp)                      (correc.f90:14-68)
//   p = p + pp [+ alpha L(pp)]                             (updatep.f90:14-50)
// with L the z second difference under impdiff_1d, the full 3-D one under
// impdiff.  u, v and p are read pointwise from their interiors; w and pp
// through the z-edge accessor (csrc/common.cuh), as the TPU kernel reads
// them through its window: w's row nz-1 is the prediction fill's wall-face
// rewrite (edge row 1), and every pp read, the k+1 / k-1 neighbours of
// L(pp) on the first and last rows included, takes the edge rows.
// fuv (nullable): the deferred bulk-forcing constants (fu, fv).
//
// Bound on the H100: memory.  About 8 field streams per call (read u, v,
// w, pp, p; write u, v, w, p): 1.07 GB at 512x256x256 f32, a 0.32 ms
// floor at the data sheet's 3.35 TB/s.  pp's neighbour reuse is left to
// L1/L2.
#include "common.cuh"

namespace cales {

template <typename T>
__global__ void __launch_bounds__(CALES_THREADS) correc_kernel(
    const T* __restrict__ u, const T* __restrict__ v, const T* __restrict__ w,
    const T* __restrict__ pp, const T* __restrict__ p,
    const T* __restrict__ we, const T* __restrict__ ppe,
    const T* __restrict__ dzci, const T* __restrict__ dzfi,
    const T* __restrict__ fuv, T* __restrict__ uo, T* __restrict__ vo,
    T* __restrict__ wo, T* __restrict__ po, int nz, int ny, int nx,
    int impdiff, int impdiff_1d, T dtrk, T cx, T cy, T dxi, T dyi,
    T alpha) {
  const int k = blockIdx.y;
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * CALES_THREADS + threadIdx.x;
  const int64_t plane = static_cast<int64_t>(ny) * nx;
  if (idx >= plane) return;
  const Cell c(k, idx, nz, ny, nx);
  const int64_t o = static_cast<int64_t>(k) * plane + idx;
  const T fu = fuv != nullptr ? fuv[0] : T(0);
  const T fv = fuv != nullptr ? fuv[1] : T(0);
  const T ppc = at(pp, ppe, c, 0, 0, 0);
  const T ppk = at(pp, ppe, c, 1, 0, 0);
  const T dzci_c = dzci[k + 1];
  uo[o] = fu + u[o] - cx * (at(pp, ppe, c, 0, 0, 1) - ppc);
  vo[o] = fv + v[o] - cy * (at(pp, ppe, c, 0, 1, 0) - ppc);
  wo[o] = at(w, we, c, 0, 0, 0) - dtrk * dzci_c * (ppk - ppc);
  T pn = p[o] + ppc;
  if (impdiff) {
    // p += alpha L(pp) (updatep.f90:26-50)
    T lap = ((ppk - ppc) * dzci_c -
             (ppc - at(pp, ppe, c, -1, 0, 0)) * dzci[k]) *
            dzfi[k + 1];
    if (!impdiff_1d) {
      lap = lap +
            (at(pp, ppe, c, 0, 0, 1) - T(2) * ppc + at(pp, ppe, c, 0, 0, -1)) *
                dxi * dxi +
            (at(pp, ppe, c, 0, 1, 0) - T(2) * ppc + at(pp, ppe, c, 0, -1, 0)) *
                dyi * dyi;
    }
    pn = pn + alpha * lap;
  }
  po[o] = pn;
}

template <typename T>
int launch_correc(const T* u, const T* v, const T* w, const T* pp,
                  const T* p, const T* we, const T* ppe, const T* dzci,
                  const T* dzfi, const T* fuv, T* uo, T* vo, T* wo, T* po,
                  int nz, int ny, int nx, int impdiff, int impdiff_1d,
                  double dtrk, double dxi, double dyi, double alpha,
                  void* stream) {
  correc_kernel<T><<<plane_grid(nz, ny, nx), CALES_THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      u, v, w, pp, p, we, ppe, dzci, dzfi, fuv, uo, vo, wo, po, nz, ny, nx,
      impdiff, impdiff_1d, T(dtrk), T(dtrk * dxi), T(dtrk * dyi), T(dxi),
      T(dyi), T(alpha));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cales

#define CALES_CORREC_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const T* u, const T* v, const T* w, const T* pp,       \
                      const T* p, const T* we, const T* ppe, const T* dzci,  \
                      const T* dzfi, const T* fuv, T* uo, T* vo, T* wo,      \
                      T* po, int nz, int ny, int nx, int impdiff,            \
                      int impdiff_1d, double dtrk, double dxi, double dyi,   \
                      double alpha, void* stream) {                          \
    return cales::launch_correc<T>(u, v, w, pp, p, we, ppe, dzci, dzfi, fuv, \
                                   uo, vo, wo, po, nz, ny, nx, impdiff,      \
                                   impdiff_1d, dtrk, dxi, dyi, alpha,        \
                                   stream);                                  \
  }

CALES_CORREC_ENTRY(cales_correc_f32, float)
CALES_CORREC_ENTRY(cales_correc_f64, double)
