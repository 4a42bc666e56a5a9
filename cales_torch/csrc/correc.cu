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
// The y-walled variant (YW, the duct and cavity classes) reads pp's y
// ghost rows from its y-row stack and v's wall face (interior row ny-1)
// from v's: the prediction fill's set_bc rewrite enters the correction
// there, as in the reference's padded sweep (pallas_kernels.py:1557-1563).
//
// Bound on the H100: memory.  About 8 field streams per call (read u, v,
// w, pp, p; write u, v, w, p): 1.07 GB at 512x256x256 f32, a 0.32 ms
// floor at the data sheet's 3.35 TB/s.  pp's neighbour reuse is left to
// L1/L2.
#include "common.cuh"

namespace cales {

template <typename T, bool YW>
__global__ void __launch_bounds__(CALES_THREADS) correc_kernel(
    const T* __restrict__ u, const T* __restrict__ v, const T* __restrict__ w,
    const T* __restrict__ pp, const T* __restrict__ p,
    const T* __restrict__ we, const T* __restrict__ ppe,
    const T* __restrict__ dzci, const T* __restrict__ dzfi,
    const T* __restrict__ fuv, T* __restrict__ uo, T* __restrict__ vo,
    T* __restrict__ wo, T* __restrict__ po, YRows<T> ypp,
    const T* __restrict__ yvr, int nz, int ny, int nx, int impdiff,
    int impdiff_1d, T dtrk, T cx, T cy, T dxi, T dyi, T alpha) {
  const int k = blockIdx.y;
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * CALES_THREADS + threadIdx.x;
  const int64_t plane = static_cast<int64_t>(ny) * nx;
  if (idx >= plane) return;
  const Cell c(k, idx, nz, ny, nx);
  const int64_t o = static_cast<int64_t>(k) * plane + idx;
  const T fu = fuv != nullptr ? fuv[0] : T(0);
  const T fv = fuv != nullptr ? fuv[1] : T(0);
  // Y: the cell's row reads a y-wall row of pp or v (common.cuh y_edge)
  auto update = [&](auto ytag) {
    constexpr bool Y = decltype(ytag)::value;
#define PP(dk, dj, di) at<Y>(pp, ppe, ypp, c, dk, dj, di)
    const T ppc = PP(0, 0, 0);
    const T ppk = PP(1, 0, 0);
    const T dzci_c = dzci[k + 1];
    const T vin = (Y && c.j == ny - 1)
                      ? yvr[(static_cast<int64_t>(k) * 3 + 1) * nx + c.i]
                      : v[o];
    uo[o] = fu + u[o] - cx * (PP(0, 0, 1) - ppc);
    vo[o] = fv + vin - cy * (PP(0, 1, 0) - ppc);
    wo[o] = at(w, we, c, 0, 0, 0) - dtrk * dzci_c * (ppk - ppc);
    T pn = p[o] + ppc;
    if (impdiff) {
      // p += alpha L(pp) (updatep.f90:26-50)
      T lap = ((ppk - ppc) * dzci_c - (ppc - PP(-1, 0, 0)) * dzci[k]) *
              dzfi[k + 1];
      if (!impdiff_1d) {
        lap = lap + (PP(0, 0, 1) - T(2) * ppc + PP(0, 0, -1)) * dxi * dxi +
              (PP(0, 1, 0) - T(2) * ppc + PP(0, -1, 0)) * dyi * dyi;
      }
      pn = pn + alpha * lap;
    }
    po[o] = pn;
#undef PP
  };
  if constexpr (YW) {
    if (y_edge(c.j, ny))
      update(std::true_type{});
    else
      update(std::false_type{});
  } else {
    update(std::false_type{});
  }
}

// yppr, yppc: pp's y-row stack and corners; yvr: v's y-row stack (its
// row 1 is the wall face); all three null without y walls
template <typename T>
int launch_correc(const T* u, const T* v, const T* w, const T* pp,
                  const T* p, const T* we, const T* ppe, const T* dzci,
                  const T* dzfi, const T* fuv, T* uo, T* vo, T* wo, T* po,
                  const T* yppr, const T* yppc, const T* yvr, int nz, int ny,
                  int nx, int impdiff, int impdiff_1d, double dtrk,
                  double dxi, double dyi, double alpha, void* stream) {
  const bool yw = yppr != nullptr;
  if (yw != (yppc != nullptr) || yw != (yvr != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const YRows<T> ypp{yppr, yppc};
  auto kern = yw ? &correc_kernel<T, true> : &correc_kernel<T, false>;
  kern<<<plane_grid(nz, ny, nx), CALES_THREADS, 0,
         static_cast<cudaStream_t>(stream)>>>(
      u, v, w, pp, p, we, ppe, dzci, dzfi, fuv, uo, vo, wo, po, ypp, yvr, nz,
      ny, nx, impdiff, impdiff_1d, T(dtrk), T(dtrk * dxi), T(dtrk * dyi),
      T(dxi), T(dyi), T(alpha));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cales

#define CALES_CORREC_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const T* u, const T* v, const T* w, const T* pp,       \
                      const T* p, const T* we, const T* ppe, const T* dzci,  \
                      const T* dzfi, const T* fuv, T* uo, T* vo, T* wo,      \
                      T* po, const T* yppr, const T* yppc, const T* yvr,     \
                      int nz, int ny, int nx, int impdiff, int impdiff_1d,   \
                      double dtrk, double dxi, double dyi, double alpha,     \
                      void* stream) {                                        \
    return cales::launch_correc<T>(u, v, w, pp, p, we, ppe, dzci, dzfi, fuv, \
                                   uo, vo, wo, po, yppr, yppc, yvr, nz, ny,  \
                                   nx, impdiff, impdiff_1d, dtrk, dxi, dyi,  \
                                   alpha, stream);                           \
  }

CALES_CORREC_ENTRY(cales_correc_f32, float)
CALES_CORREC_ENTRY(cales_correc_f64, double)
