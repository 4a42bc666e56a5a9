// Static Smagorinsky eddy viscosity with van Driest damping, one pass.
//
// Replaces: cales_tpu/ops/pallas_kernels.py fused_smag (body _smag_kernel)
// on the single-device z-walls path, the nu_t stage of the channel LES with
// z-implicit diffusion (impdiff_1d), where the projection cannot carry the
// strain (cales_tpu/timeloop.py _compute_sgs_kernel).  Per output cell:
//   nu_t = (Cs Delta)^2 fd^2 |S| (sgs.f90:69-152), |S| of the
//   post-correction fill (interiors + z-edge stacks), fd from the nearer z
//   wall's shear plane; fd = 1 without z walls.
// One thread per cell, as the nu_t part of correc_smag.cu; the strain rate
// and the damping are common.cuh's.  The halo variant (a slab of a
// y-sharded mesh, the shard branch of cales_tpu _compute_sgs_kernel) reads
// the rows -1 and ny of u, v, w from their halos (common.cuh aty<Y_HALO>).
//
// Bound on the H100: memory.  It reads u, v, w once and writes nu_t: 4
// field streams, 0.54 GB at 512x256x256 f32, a 0.16 ms floor at the data
// sheet's 3.35 TB/s (about 60 flops a cell, far from the 67 TFLOP/s f32
// rate).  The stencil takes its 30 neighbour values straight from global
// memory (__ldg) and relies on L1/L2 for their reuse.
#include "common.cuh"

namespace cales {

// The f32 halo variant holds to the 6 blocks an SM that the plain one
// reaches with its 40 registers: its edge-row path would otherwise set the
// register count (68), and halve the occupancy, of every row.  The others
// take 0, no minimum, as a bare __launch_bounds__(CALES_THREADS): a
// minimum of 1 makes ptxas spend registers (the f32 plain variant 40 ->
// 56, 14% slower).
template <typename T, int YM>
__global__ void __launch_bounds__(CALES_THREADS,
                                  YM == Y_HALO && sizeof(T) == 4 ? 6 : 0)
    smag_kernel(
    const T* __restrict__ u, const T* __restrict__ v, const T* __restrict__ w,
    const T* __restrict__ ue, const T* __restrict__ ve,
    const T* __restrict__ we, const T* __restrict__ dzci,
    const T* __restrict__ dzfi, const T* __restrict__ csd2,
    const T* __restrict__ dw, const T* __restrict__ nearlo,
    const T* __restrict__ tauw_lo, const T* __restrict__ tauw_hi,
    T* __restrict__ so, YRows<T> hu, YRows<T> hv, YRows<T> hw, int nz,
    int ny, int nx, int have_zwalls, T dxi, T dyi, T visc) {
  const int k = blockIdx.y;
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * CALES_THREADS + threadIdx.x;
  const int64_t plane = static_cast<int64_t>(ny) * nx;
  if (idx >= plane) return;
  const Cell c(k, idx, nz, ny, nx);
  // Y: the y mode of the reads, YM on a row next to a slab edge
  auto strain = [&](auto ytag) {
    constexpr int Y = decltype(ytag)::value;
    auto U = [&](int dk, int dj, int di) {
      return aty<Y>(u, ue, hu, c, dk, dj, di);
    };
    auto V = [&](int dk, int dj, int di) {
      return aty<Y>(v, ve, hv, c, dk, dj, di);
    };
    auto W = [&](int dk, int dj, int di) {
      return aty<Y>(w, we, hw, c, dk, dj, di);
    };
    return strain_rate<T>(U, V, W, dxi, dyi, dzci[k + 1], dzci[k],
                          dzfi[k + 1]);
  };
  using Plain = std::integral_constant<int, Y_PERIODIC>;
  T s0;
  if constexpr (YM != Y_PERIODIC) {
    s0 = y_edge_of<YM>(c.j, ny) ? strain(std::integral_constant<int, YM>{})
                                : strain(Plain{});
  } else {
    s0 = strain(Plain{});
  }
  const int64_t o = static_cast<int64_t>(k) * plane + idx;
  if (have_zwalls) {
    const T tauw = nearlo[k] > T(0.5) ? tauw_lo[idx] : tauw_hi[idx];
    so[o] = van_driest_nut(s0, csd2[k], dw[k], tauw, visc);
  } else {
    so[o] = csd2[k] * s0;
  }
}

template <typename T>
int launch_smag(const T* u, const T* v, const T* w, const T* ue, const T* ve,
                const T* we, const T* dzci, const T* dzfi, const T* csd2,
                const T* dw, const T* nearlo, const T* tauw_lo,
                const T* tauw_hi, T* so, const T* const* h, int nz, int ny,
                int nx, int have_zwalls, double dxi, double dyi, double visc,
                void* stream) {
  const bool halo = h[0] != nullptr;
  for (int m = 1; m < 6; ++m)
    if ((h[m] != nullptr) != halo)
      return static_cast<int>(cudaErrorInvalidValue);
  const YRows<T> hu{h[0], h[1]}, hv{h[2], h[3]}, hw{h[4], h[5]};
  auto kern = halo ? &smag_kernel<T, Y_HALO> : &smag_kernel<T, Y_PERIODIC>;
  kern<<<plane_grid(nz, ny, nx), CALES_THREADS, 0,
         static_cast<cudaStream_t>(stream)>>>(
      u, v, w, ue, ve, we, dzci, dzfi, csd2, dw, nearlo, tauw_lo, tauw_hi,
      so, hu, hv, hw, nz, ny, nx, have_zwalls, T(dxi), T(dyi), T(visc));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cales

#define CALES_SMAG_ENTRY(NAME, T)                                             \
  extern "C" int NAME(const T* u, const T* v, const T* w, const T* ue,        \
                      const T* ve, const T* we, const T* dzci,                \
                      const T* dzfi, const T* csd2, const T* dw,              \
                      const T* nearlo, const T* tauw_lo, const T* tauw_hi,    \
                      T* so, const T* hur, const T* huc, const T* hvr,        \
                      const T* hvc, const T* hwr, const T* hwc, int nz,       \
                      int ny, int nx, int have_zwalls, double dxi,            \
                      double dyi, double visc, void* stream) {                \
    const T* const h[6] = {hur, huc, hvr, hvc, hwr, hwc};                     \
    return cales::launch_smag<T>(u, v, w, ue, ve, we, dzci, dzfi, csd2, dw,   \
                                 nearlo, tauw_lo, tauw_hi, so, h, nz, ny, nx, \
                                 have_zwalls, dxi, dyi, visc, stream);        \
  }

CALES_SMAG_ENTRY(cales_smag_f32, float)
CALES_SMAG_ENTRY(cales_smag_f64, double)
