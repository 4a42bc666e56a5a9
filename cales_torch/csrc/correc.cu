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
// The halo variant (a slab of a y-sharded mesh, cales_tpu _correc_sharded)
// reads pp's rows -1 and ny from its halo; v's last row is the slab's own.
// The x-walled variant (X_WALLS, with periodic y or y walls, and on a slab
// with the halo variant) reads pp's x ghost columns from its x stack and
// u's wall face (interior column nx-1) from u's prediction-fill x stack,
// the set_bc rewrite, where the TPU kernel reads its xe bundle and the
// patched copy of u (cales_tpu timeloop.py:823-830): the reads of the
// first and last column's cells, patched in place.  pp's x ghosts are
// read in the cell's own row only, so on a slab the stacks hold the
// slab's rows and no corner of a halo row is read.
// The x-halo variant (X_HALO, a pencil of a 2D mesh, with the y halo
// variant, periodic y or y walls) reads pp's columns -1 and nx from its x
// halo stack (common.cuh XMode), in the cell's own row; u's last column
// is its own (no wall face, no rewrite read).  With y walls pp's wall
// rows and v's rewrite row (the upper wall's pencils') come from their
// y-row stacks in the cell's own column: no (x ghost, y wall) corner is
// read.
//
// Bound on the H100: memory.  About 8 field streams per call (read u, v,
// w, pp, p; write u, v, w, p): 1.07 GB at 512x256x256 f32, a 0.32 ms
// floor at the data sheet's 3.35 TB/s.  pp's neighbour reuse is left to
// L1/L2.
#include "common.cuh"

namespace cales {

// The f32 halo variant holds to the 8 blocks an SM that the plain one
// reaches with its 32 registers (its edge-row path would take 46).  The
// others, the x-walled and x-halo variants among them, take 0, no
// minimum, as a bare __launch_bounds__(CALES_THREADS): a minimum of 1
// makes ptxas spend registers (the f32 plain variant 32 -> 47).
template <typename T, int YM, int XM>
__global__ void __launch_bounds__(
    CALES_THREADS, YM == Y_HALO && XM == X_PERIODIC && sizeof(T) == 4 ? 8 : 0)
    correc_kernel(
    const T* __restrict__ u, const T* __restrict__ v, const T* __restrict__ w,
    const T* __restrict__ pp, const T* __restrict__ p,
    const T* __restrict__ we, const T* __restrict__ ppe,
    const T* __restrict__ dzci, const T* __restrict__ dzfi,
    const T* __restrict__ fuv, T* __restrict__ uo, T* __restrict__ vo,
    T* __restrict__ wo, T* __restrict__ po, YRows<T> ypp,
    const T* __restrict__ yvr, YRows<T> xpp, YRows<T> xu, int nz, int ny,
    int nx, int impdiff,
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
  // Y: the y mode of the reads, YM where the cell's row reads a y-wall row
  // of pp or v, or a halo row of pp (common.cuh y_edge_of)
  auto update = [&](auto ytag) {
    constexpr int Y = decltype(ytag)::value;
#define PP(dk, dj, di) aty<Y>(pp, ppe, ypp, c, dk, dj, di)
    // pp at x offset di = +-1 in this cell's row; with x walls columns
    // -1 and nx from pp's x stack, on a pencil from its x halo
    auto ppx = [&](int di) {
      if (XM != X_PERIODIC) {
        const int ix = c.i + di;
        if (ix < 0 || ix >= nx)
          return __ldg(xcol<YM, XM>(xpp, k, ix < 0 ? 0 : 2, c.j, nz, ny));
      }
      return PP(0, 0, di);
    };
    const T ppc = PP(0, 0, 0);
    const T ppk = PP(1, 0, 0);
    const T ppi = ppx(1);
    const T dzci_c = dzci[k + 1];
    const T vin = (Y == Y_WALLS && c.j == ny - 1)
                      ? yvr[(static_cast<int64_t>(k) * 3 + 1) * nx + c.i]
                      : v[o];
    // u's wall face at x walls: the prediction fill's rewrite column
    const T uin = (XM == X_WALLS && c.i == nx - 1)
                      ? __ldg(xcol<YM>(xu, k, 1, c.j, nz, ny))
                      : u[o];
    uo[o] = fu + uin - cx * (ppi - ppc);
    vo[o] = fv + vin - cy * (PP(0, 1, 0) - ppc);
    wo[o] = at(w, we, c, 0, 0, 0) - dtrk * dzci_c * (ppk - ppc);
    T pn = p[o] + ppc;
    if (impdiff) {
      // p += alpha L(pp) (updatep.f90:26-50)
      T lap = ((ppk - ppc) * dzci_c - (ppc - PP(-1, 0, 0)) * dzci[k]) *
              dzfi[k + 1];
      if (!impdiff_1d) {
        lap = lap + (ppi - T(2) * ppc + ppx(-1)) * dxi * dxi +
              (PP(0, 1, 0) - T(2) * ppc + PP(0, -1, 0)) * dyi * dyi;
      }
      pn = pn + alpha * lap;
    }
    po[o] = pn;
#undef PP
  };
  using Plain = std::integral_constant<int, Y_PERIODIC>;
  if constexpr (YM != Y_PERIODIC) {
    if (y_edge_of<YM>(c.j, ny))
      update(std::integral_constant<int, YM>{});
    else
      update(Plain{});
  } else {
    update(Plain{});
  }
}

// yppr, yppc: pp's y-row stack and corners; yvr: v's y-row stack (its
// row 1 is the wall face); all three null with periodic y.  halo: yppr,
// yppc are pp's halo rows and corners on a slab, and yvr is null.  xppr,
// xppc, xur, xuc: pp's x stack and corners and u's prediction-fill ones
// (x walls; nyc = ny + 2 with y walls, ny with periodic y and on a slab),
// all four null with periodic x.  xhalo: xppr, xppc are pp's x halo
// stack and corners on a pencil (nyc = ny + 2; with periodic y, the y
// halo or y walls), xur and xuc null.
template <typename T>
int launch_correc(const T* u, const T* v, const T* w, const T* pp,
                  const T* p, const T* we, const T* ppe, const T* dzci,
                  const T* dzfi, const T* fuv, T* uo, T* vo, T* wo, T* po,
                  const T* yppr, const T* yppc, const T* yvr,
                  const T* xppr, const T* xppc, const T* xur,
                  const T* xuc, int nz, int ny, int nx, int halo,
                  int xhalo, int impdiff, int impdiff_1d, double dtrk,
                  double dxi, double dyi, double alpha, void* stream) {
  const bool ys = yppr != nullptr;
  const bool xw = xppr != nullptr;
  // the x stacks of u go with pp's at x walls, never in the halo mode
  const bool with_xu = xw && !xhalo;
  if (ys != (yppc != nullptr) || (halo && !ys) ||
      (yvr != nullptr) != (ys && !halo) || xw != (xppc != nullptr) ||
      with_xu != (xur != nullptr) || with_xu != (xuc != nullptr) ||
      (xhalo && !xw))
    return static_cast<int>(cudaErrorInvalidValue);
  const YRows<T> ypp{yppr, yppc}, xpp{xppr, xppc}, xu{xur, xuc};
  using K = void (*)(const T*, const T*, const T*, const T*, const T*,
                     const T*, const T*, const T*, const T*, const T*, T*,
                     T*, T*, T*, YRows<T>, const T*, YRows<T>, YRows<T>,
                     int, int, int, int, int, T, T, T, T, T, T);
  const K kern = xhalo ? (halo ? &correc_kernel<T, Y_HALO, X_HALO>
                          : ys ? &correc_kernel<T, Y_WALLS, X_HALO>
                               : &correc_kernel<T, Y_PERIODIC, X_HALO>)
                 : !ys  ? (xw ? &correc_kernel<T, Y_PERIODIC, X_WALLS>
                              : &correc_kernel<T, Y_PERIODIC, X_PERIODIC>)
                 : halo ? (xw ? &correc_kernel<T, Y_HALO, X_WALLS>
                              : &correc_kernel<T, Y_HALO, X_PERIODIC>)
                 : xw   ? &correc_kernel<T, Y_WALLS, X_WALLS>
                        : &correc_kernel<T, Y_WALLS, X_PERIODIC>;
  kern<<<plane_grid(nz, ny, nx), CALES_THREADS, 0,
         static_cast<cudaStream_t>(stream)>>>(
      u, v, w, pp, p, we, ppe, dzci, dzfi, fuv, uo, vo, wo, po, ypp, yvr,
      xpp, xu, nz, ny, nx, impdiff, impdiff_1d, T(dtrk), T(dtrk * dxi),
      T(dtrk * dyi), T(dxi), T(dyi), T(alpha));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cales

#define CALES_CORREC_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const T* u, const T* v, const T* w, const T* pp,       \
                      const T* p, const T* we, const T* ppe, const T* dzci,  \
                      const T* dzfi, const T* fuv, T* uo, T* vo, T* wo,      \
                      T* po, const T* yppr, const T* yppc, const T* yvr,     \
                      const T* xppr, const T* xppc, const T* xur,            \
                      const T* xuc, int nz, int ny, int nx, int halo,        \
                      int xhalo, int impdiff, int impdiff_1d, double dtrk,   \
                      double dxi, double dyi, double alpha, void* stream) {  \
    return cales::launch_correc<T>(u, v, w, pp, p, we, ppe, dzci, dzfi, fuv, \
                                   uo, vo, wo, po, yppr, yppc, yvr, xppr,    \
                                   xppc, xur, xuc, nz, ny, nx, halo, xhalo,  \
                                   impdiff, impdiff_1d, dtrk, dxi, dyi,      \
                                   alpha, stream);                           \
  }

CALES_CORREC_ENTRY(cales_correc_f32, float)
CALES_CORREC_ENTRY(cales_correc_f64, double)
