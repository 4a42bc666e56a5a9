// Projection + pressure update + van Driest static Smagorinsky, one pass.
//
// Replaces: cales_tpu/ops/pallas_kernels.py fused_correc_updatep_smag
// (body _correc_smag_kernel), without the x-spectral (xopi) variant.
// Per output cell:
//   u -= dt dxi (pp(i+1) - pp(i)), v likewise, w -= dt dzci (pp(k+1)-pp(k))
//   (correc.f90:14-68), plus the deferred bulk-forcing constants fuv;
//   p += pp (updatep.f90:14-24);
//   nu_t = (Cs Delta)^2 fd^2 |S| of the CORRECTED field (sgs.f90:69-152),
//   the strain (sgs.f90:1019-1110) taken from corrected values rebuilt
//   here at every neighbour.  u and v at the z ghost rows follow the
//   post-correction fill's recipe (zrec: 'D' -> 2b - q, 'N' -> -+dr b + q,
//   q the corrected boundary plane); w's lower wall face keeps its
//   corrected value (impose_norm_bc=.false.), so its generic correction is
//   the post-fill value.
//
// Bound on the H100: memory.  About 9 field streams per call (read u, v,
// w, pp, p; write u, v, w, p, nu_t): 1.2 GB at 512x256x256 f32, a
// 0.36 ms floor at the data sheet's 3.35 TB/s.  Measured 3.608 ms per
// call there (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase 2b): the
// simple design recomputes each of the 30 corrected neighbour values the
// strain needs (about 60 loads per cell, served by L1/L2) instead of
// staging corrected planes in shared memory, which is later work.
#include "common.cuh"

namespace cales {

template <typename T>
struct ZRec {  // one face's z-ghost recipe of the post-correction fill
  int letter;  // 0: 'D', 1: 'N'
  T b, dr;
};

template <typename T>
__device__ __forceinline__ T ghost(const ZRec<T>& r, int side, T q1) {
  if (r.letter == 0) return T(2) * r.b - q1;
  return side == 0 ? (-r.dr * r.b + q1) : (r.dr * r.b + q1);
}

template <typename T>
__global__ void __launch_bounds__(CALES_THREADS) correc_smag_kernel(
    const T* __restrict__ u, const T* __restrict__ v, const T* __restrict__ w,
    const T* __restrict__ pp, const T* __restrict__ p,
    const T* __restrict__ ue, const T* __restrict__ ve,
    const T* __restrict__ we, const T* __restrict__ ppe,
    const T* __restrict__ dzci, const T* __restrict__ dzfi,
    const T* __restrict__ csd2, const T* __restrict__ dw,
    const T* __restrict__ nearlo, const T* __restrict__ tauw_lo,
    const T* __restrict__ tauw_hi, const T* __restrict__ fuv,
    T* __restrict__ uo, T* __restrict__ vo, T* __restrict__ wo,
    T* __restrict__ po, T* __restrict__ so, int nz, int ny, int nx,
    int have_zwalls, ZRec<T> ru_lo, ZRec<T> ru_hi, ZRec<T> rv_lo,
    ZRec<T> rv_hi, T dtrk, T cx, T cy, T dxi, T dyi, T visc) {
  const int k = blockIdx.y;
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * CALES_THREADS + threadIdx.x;
  const int64_t plane = static_cast<int64_t>(ny) * nx;
  if (idx >= plane) return;
  const Cell c(k, idx, nz, ny, nx);
  const T fu = fuv[0], fv = fuv[1];

  // corrected u / v at interior-or-edge row kz (0 .. nz-1)
  auto cu_row = [&](int kz, int dj, int di) -> T {
    const T* ur = zrow(u, ue, kz, nz, plane);
    const T* pr = zrow(pp, ppe, kz, nz, plane);
    const int64_t row = static_cast<int64_t>(c.jj(dj)) * nx;
    const int i0 = c.ii(di);
    const int i1 = i0 == nx - 1 ? 0 : i0 + 1;
    return fu + __ldg(ur + row + i0) - cx * (__ldg(pr + row + i1) -
                                             __ldg(pr + row + i0));
  };
  auto cv_row = [&](int kz, int dj, int di) -> T {
    const T* vr = zrow(v, ve, kz, nz, plane);
    const T* pr = zrow(pp, ppe, kz, nz, plane);
    const int j0 = c.jj(dj);
    const int j1 = j0 == ny - 1 ? 0 : j0 + 1;
    const int i0 = c.ii(di);
    const int64_t o0 = static_cast<int64_t>(j0) * nx + i0;
    const int64_t o1 = static_cast<int64_t>(j1) * nx + i0;
    return fv + __ldg(vr + o0) - cy * (__ldg(pr + o1) - __ldg(pr + o0));
  };
  // with the global z ghost rows synthesized from the corrected boundary
  // planes
  auto CU = [&](int dk, int dj, int di) -> T {
    const int kz = k + dk;
    if (kz < 0) return ghost(ru_lo, 0, cu_row(0, dj, di));
    if (kz > nz - 1) return ghost(ru_hi, 1, cu_row(nz - 1, dj, di));
    return cu_row(kz, dj, di);
  };
  auto CV = [&](int dk, int dj, int di) -> T {
    const int kz = k + dk;
    if (kz < 0) return ghost(rv_lo, 0, cv_row(0, dj, di));
    if (kz > nz - 1) return ghost(rv_hi, 1, cv_row(nz - 1, dj, di));
    return cv_row(kz, dj, di);
  };
  // corrected w at row k+dk (dk in {-1, 0}: rows -1 .. nz-1)
  auto CW = [&](int dk, int dj, int di) -> T {
    const int kz = k + dk;
    const int64_t o = c.off(dj, di);
    const T* wr = zrow(w, we, kz, nz, plane);
    const T pk = __ldg(zrow(pp, ppe, kz, nz, plane) + o);
    const T pk1 = __ldg(zrow(pp, ppe, kz + 1, nz, plane) + o);
    return __ldg(wr + o) - dtrk * dzci[kz + 1] * (pk1 - pk);
  };

  const int64_t o = static_cast<int64_t>(k) * plane + idx;
  uo[o] = CU(0, 0, 0);
  vo[o] = CV(0, 0, 0);
  wo[o] = CW(0, 0, 0);
  po[o] = p[o] + at(pp, ppe, c, 0, 0, 0);  // row nz-1 from the edge stack

  // strain rate of the corrected field (common.cuh strain_rate)
  const T s0 = strain_rate<T>(CU, CV, CW, dxi, dyi, dzci[k + 1], dzci[k],
                              dzfi[k + 1]);
  if (have_zwalls) {
    // van Driest damping with the nearer z wall's shear (sgs.f90:104-149)
    const T tauw = nearlo[k] > T(0.5) ? tauw_lo[idx] : tauw_hi[idx];
    so[o] = van_driest_nut(s0, csd2[k], dw[k], tauw, visc);
  } else {
    so[o] = csd2[k] * s0;
  }
}

template <typename T>
int launch_correc_smag(const T* u, const T* v, const T* w, const T* pp,
                       const T* p, const T* ue, const T* ve, const T* we,
                       const T* ppe, const T* dzci, const T* dzfi,
                       const T* csd2, const T* dw, const T* nearlo,
                       const T* tauw_lo, const T* tauw_hi, const T* fuv,
                       T* uo, T* vo, T* wo, T* po, T* so, int nz, int ny,
                       int nx, int have_zwalls, int lt_ulo, double b_ulo,
                       double dr_ulo, int lt_uhi, double b_uhi, double dr_uhi,
                       int lt_vlo, double b_vlo, double dr_vlo, int lt_vhi,
                       double b_vhi, double dr_vhi, double dtrk, double dxi,
                       double dyi, double visc, void* stream) {
  const ZRec<T> ru_lo{lt_ulo, T(b_ulo), T(dr_ulo)};
  const ZRec<T> ru_hi{lt_uhi, T(b_uhi), T(dr_uhi)};
  const ZRec<T> rv_lo{lt_vlo, T(b_vlo), T(dr_vlo)};
  const ZRec<T> rv_hi{lt_vhi, T(b_vhi), T(dr_vhi)};
  correc_smag_kernel<T><<<plane_grid(nz, ny, nx), CALES_THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      u, v, w, pp, p, ue, ve, we, ppe, dzci, dzfi, csd2, dw, nearlo, tauw_lo,
      tauw_hi, fuv, uo, vo, wo, po, so, nz, ny, nx, have_zwalls, ru_lo,
      ru_hi, rv_lo, rv_hi, T(dtrk), T(dtrk * dxi), T(dtrk * dyi), T(dxi),
      T(dyi), T(visc));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cales

#define CALES_CORREC_SMAG_ENTRY(NAME, T)                                       \
  extern "C" int NAME(                                                         \
      const T* u, const T* v, const T* w, const T* pp, const T* p,             \
      const T* ue, const T* ve, const T* we, const T* ppe, const T* dzci,      \
      const T* dzfi, const T* csd2, const T* dw, const T* nearlo,              \
      const T* tauw_lo, const T* tauw_hi, const T* fuv, T* uo, T* vo, T* wo,   \
      T* po, T* so, int nz, int ny, int nx, int have_zwalls, int lt_ulo,       \
      double b_ulo, double dr_ulo, int lt_uhi, double b_uhi, double dr_uhi,    \
      int lt_vlo, double b_vlo, double dr_vlo, int lt_vhi, double b_vhi,       \
      double dr_vhi, double dtrk, double dxi, double dyi, double visc,         \
      void* stream) {                                                          \
    return cales::launch_correc_smag<T>(                                       \
        u, v, w, pp, p, ue, ve, we, ppe, dzci, dzfi, csd2, dw, nearlo,         \
        tauw_lo, tauw_hi, fuv, uo, vo, wo, po, so, nz, ny, nx, have_zwalls,    \
        lt_ulo, b_ulo, dr_ulo, lt_uhi, b_uhi, dr_uhi, lt_vlo, b_vlo, dr_vlo,   \
        lt_vhi, b_vhi, dr_vhi, dtrk, dxi, dyi, visc, stream);                  \
  }

CALES_CORREC_SMAG_ENTRY(cales_correc_smag_f32, float)
CALES_CORREC_SMAG_ENTRY(cales_correc_smag_f64, double)
