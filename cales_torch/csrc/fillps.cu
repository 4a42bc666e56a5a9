// Poisson RHS div(u)/dt_rk, one pass.
//
// Replaces: cales_tpu/ops/pallas_kernels.py fused_fillps (body
// _fillps_kernel), the plain variant (no x/y transform fusion, no wall
// bundles).  Formula: cales_torch/ops/stencil.fillps (reference
// fillps.f90:14-48).  The prediction fill's w wall-face rewrite enters
// through the edge stack's row 1.  The y-walled variant (YW, the duct and
// cavity classes) reads v's lower wall face and its rewrite row from v's
// y-row stack (pallas_kernels.py:1144-1155: v is the one field read at
// j-1); u and w are read at their own row only.  The halo variant (a slab
// of a y-sharded mesh, cales_tpu _fillps_sharded) reads v's row -1 from
// its halo (common.cuh aty<Y_HALO>).  The x-walled variant (X_WALLS, the
// developing channel, the closed box, the lid-driven cavity and the
// developing duct; with periodic y or y walls; the developing channel on
// a slab, with the halo variant, whose x stack holds the slab's rows)
// reads u's lower x face and its rewrite column (padded x nx) from u's x
// stack (common.cuh xcol), as the TPU kernel takes them from its xe
// bundle and the patched copy of u (cales_tpu timeloop.py:2574-2586): two
// reads of the cells of the first and last column, patched in place; u
// is read in its own row only, so no x ghost of a halo row is read.
// The x-halo variant (X_HALO, a pencil of a 2D mesh, with the y halo
// variant, periodic y or y walls) reads u's column -1 from its x halo
// stack (common.cuh XMode): the one read of the first column's cells; u's
// last column is its own (no wall face, no rewrite).  With y walls v's
// wall rows come from its y-row stack in the cell's own column, and u is
// read in its own row only, so no (x ghost, y wall) corner is read.
//
// Bound on the H100: memory.  About 5 field streams per call (read u, v,
// w at their backward neighbours; write the RHS): 0.67 GB at 512x256x256
// f32, a 0.2 ms floor at the data sheet's 3.35 TB/s.  Measured 0.284 ms
// per call there (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase 2b).
// Neighbour reuse is left to L1/L2.
#include "common.cuh"

namespace cales {

template <typename T, int YM, int XM>
__global__ void __launch_bounds__(CALES_THREADS) fillps_kernel(
    const T* __restrict__ u, const T* __restrict__ v, const T* __restrict__ w,
    const T* __restrict__ ue, const T* __restrict__ ve,
    const T* __restrict__ we, const T* __restrict__ dzfi,
    T* __restrict__ rhs, YRows<T> yv, YRows<T> xu, int nz, int ny, int nx,
    T dti, T cy, T cx) {
  const int k = blockIdx.y;
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * CALES_THREADS + threadIdx.x;
  const int64_t plane = static_cast<int64_t>(ny) * nx;
  if (idx >= plane) return;
  const Cell c(k, idx, nz, ny, nx);
  // u at the cell and the one below in x; with x walls u's rewrite
  // column nx-1 and lower face x = -1 from its x stack, on a pencil its
  // column -1 from the x halo
  T uc = at(u, ue, c, 0, 0, 0), um = at(u, ue, c, 0, 0, -1);
  if (XM == X_WALLS) {
    if (c.i == nx - 1) uc = __ldg(xcol<YM>(xu, k, 1, c.j, nz, ny));
    if (c.i == 0) um = __ldg(xcol<YM>(xu, k, 0, c.j, nz, ny));
  } else if (XM == X_HALO) {
    if (c.i == 0) um = __ldg(xcol<YM, X_HALO>(xu, k, 0, c.j, nz, ny));
  }
  // Y: the y mode of v's reads, YM where the cell's row reads a y-wall or
  // halo row of v (common.cuh y_edge_of)
  auto div = [&](auto ytag) {
    constexpr int Y = decltype(ytag)::value;
    return (at(w, we, c, 0, 0, 0) - at(w, we, c, -1, 0, 0)) * dti *
               dzfi[k + 1] +
           (aty<Y>(v, ve, yv, c, 0, 0, 0) -
            aty<Y>(v, ve, yv, c, 0, -1, 0)) *
               cy +
           (uc - um) * cx;
  };
  T r;
  using Plain = std::integral_constant<int, Y_PERIODIC>;
  if constexpr (YM != Y_PERIODIC) {
    r = y_edge_of<YM>(c.j, ny) ? div(std::integral_constant<int, YM>{})
                               : div(Plain{});
  } else {
    r = div(Plain{});
  }
  rhs[static_cast<int64_t>(k) * plane + idx] = r;
}

// yvr, yvc: v's y-row stack and corners, both null with periodic y; with
// halo set, v's halo rows and corners on a slab.  xur, xuc: u's x stack
// and corners (x walls; nyc = ny + 2 with y walls, ny with periodic y and
// on a slab), both null with periodic x; with xhalo set u's x halo stack
// and corners on a pencil (nyc = ny + 2), with periodic y, the y halo or
// y walls
template <typename T>
int launch_fillps(const T* u, const T* v, const T* w, const T* ue,
                  const T* ve, const T* we, const T* dzfi, T* rhs,
                  const T* yvr, const T* yvc, const T* xur, const T* xuc,
                  int nz, int ny, int nx, int halo, int xhalo, double dti,
                  double dxi, double dyi, void* stream) {
  const bool xw = xur != nullptr;
  if ((yvr == nullptr) != (yvc == nullptr) || (halo && yvr == nullptr) ||
      xw != (xuc != nullptr) ||
      (xhalo && !xw))
    return static_cast<int>(cudaErrorInvalidValue);
  const YRows<T> yv{yvr, yvc}, xu{xur, xuc};
  using K = void (*)(const T*, const T*, const T*, const T*, const T*,
                     const T*, const T*, T*, YRows<T>, YRows<T>, int, int,
                     int, T, T, T);
  const K kern =
      xhalo          ? (halo ? &fillps_kernel<T, Y_HALO, X_HALO>
                        : yvr != nullptr ? &fillps_kernel<T, Y_WALLS, X_HALO>
                                         : &fillps_kernel<T, Y_PERIODIC, X_HALO>)
      : yvr == nullptr ? (xw ? &fillps_kernel<T, Y_PERIODIC, X_WALLS>
                             : &fillps_kernel<T, Y_PERIODIC, X_PERIODIC>)
      : halo           ? (xw ? &fillps_kernel<T, Y_HALO, X_WALLS>
                             : &fillps_kernel<T, Y_HALO, X_PERIODIC>)
      : xw             ? &fillps_kernel<T, Y_WALLS, X_WALLS>
                       : &fillps_kernel<T, Y_WALLS, X_PERIODIC>;
  kern<<<plane_grid(nz, ny, nx), CALES_THREADS, 0,
         static_cast<cudaStream_t>(stream)>>>(
      u, v, w, ue, ve, we, dzfi, rhs, yv, xu, nz, ny, nx, T(dti),
      T(dti * dyi), T(dti * dxi));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cales

#define CALES_FILLPS_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const T* u, const T* v, const T* w, const T* ue,       \
                      const T* ve, const T* we, const T* dzfi, T* rhs,       \
                      const T* yvr, const T* yvc, const T* xur,              \
                      const T* xuc, int nz, int ny, int nx, int halo,        \
                      int xhalo, double dti, double dxi, double dyi,         \
                      void* stream) {                                        \
    return cales::launch_fillps<T>(u, v, w, ue, ve, we, dzfi, rhs, yvr, yvc, \
                                   xur, xuc, nz, ny, nx, halo, xhalo, dti,   \
                                   dxi, dyi, stream);                        \
  }

CALES_FILLPS_ENTRY(cales_fillps_f32, float)
CALES_FILLPS_ENTRY(cales_fillps_f64, double)
