// Dynamic Smagorinsky, the test level of the two passes (DS2).
//
// Replaces: cales_tpu/ops/pallas_dsmag.py fused_dsmag_level2 (body
// _ds2_kernel) on the single-device path, with its three averages
// (sgs.f90:198-272, ave1d_channel 433-538, ave2d_duct 540-614).  Per cell:
// the test-level strain S~_ij, |S~| of the filtered velocity fvel, read
// with its BC fill (the static planes: z-edge stacks, with y walls the
// y-row stacks, whose rows carry the wall-normal face values of
// transpiring walls), then in registers
//   M_ij = 2 (fm_ij - alpha^2 |S~| S~_ij), alpha^2 = alph2[k], 2.52 on the
//          first and last y rows with y walls;
//   num = M_ij L_ij, den = M_ij M_ij (off-diagonal pairs twice);
// and the output by average:
//   'channel'  per (z row, block) partial sums of num and den;
//   'duct'     per (z, y) row and x block of 32 (one warp) partial sums;
//   'cavity'   nu_t = max(|S| num / den, 0).
// The caller sums the partials and forms nu_t = max(|S| ratio, 0).  Plain
// twin: cales_torch/ops/kernels dsmag_level2_plain.
// Two slab modes for the y-slab mesh (the JAX package's fused_dsmag_level2
// with ystrips, pallas_dsmag.py:606-781, which haloes the filtered velocity
// alone: fm, lij and s0 are read pointwise), template switches:
//   YH       a slab with periodic y: the filtered velocity's rows -1 and ny
//            (and their z-edge entries) from its depth-1 halo
//            (parallel/mesh.halo_y), through the halo accessor aty<Y_HALO>
//            on the first and last rows;
//   YW + YH  a slab of a y-walled mesh: the reads of YW on the slab's y-row
//            stacks (boundary.slab_ystack: the fill's wall rows on a side it
//            owns, the halo rows elsewhere), alpha^2 2.52 on the first and
//            last rows of the sides it owns only (run-time flags ylo, yhi).
// The sums are the slab's: the caller reduces 'channel' over the ranks,
// 'duct' stays on the slab and 'cavity' is pointwise.
// A third mode, XH, is a pencil of the 2D (gy, gx) mesh (the 'channel'
// sums; with YH on gy > 1, periodic y on gy = 1): the filtered velocity's
// columns -1 and nx, with their (x +-1, y +-1) corners and z-edge entries,
// from its depth-1 x halo in the x stacks' form (parallel/mesh.halo_x,
// its rows -1 and ny by the y exchange), read through the X_HALO accessor
// (common.cuh xcol) on the first and last columns, as aty<Y_HALO> reads
// the rows; the caller reduces the sums over all gy gx ranks.
//
// Design: one thread per output cell, as smag.cu; the strain is
// common.cuh's on the y-walled accessor at<YW> (rows that read a y-wall row
// take the branch, common.cuh y_edge).  A block is 8 warps, each warp 32
// consecutive x of one y row, so a warp's cells share their (z, y) row for
// the 'duct' shuffle; blockIdx.y is the z plane.
//
// Bound on the H100: bytes.  It reads fvel (3), fm (6), lij (6) and s0: 16
// field streams, 2.15 GB at 512x256x256 f32, 0.641 ms at 3.35 TB/s (17,
// 0.681 ms, with 'cavity''s nu_t written).  About 147 operations a cell
// (the strain's 92 + M_ij and the contraction), 0.074 ms at 67 TFLOP/s.
// The stencil's neighbour reads go to L1/L2.
#include "common.cuh"

namespace cales {

enum { DS2_CHANNEL = 0, DS2_DUCT = 1, DS2_CAVITY = 2 };

// the 13 per-cell inputs of dsmag_level1: fm[6], lij[6], s0
template <typename T>
struct Ds2In {
  const T* fm[6];
  const T* lij[6];
  const T* s0;
};

// at() in y mode YM on a pencil (XH): the columns i+di = -1 and nx from
// the x halo x (common.cuh xcol, X_HALO: its rows -1 .. ny), every other
// read by aty<YM>.
template <int YM, typename T>
__device__ __forceinline__ T atxh(const T* f, const T* e, const YRows<T>& y,
                                  const YRows<T>& x, const Cell& c, int dk,
                                  int dj, int di) {
  const int ix = c.i + di;
  if (ix < 0 || ix >= c.nx)
    return __ldg(xcol<YM, X_HALO>(x, c.k + dk, ix < 0 ? 0 : 2, c.j + dj,
                                  c.nz, c.ny));
  return aty<YM>(f, e, y, c, dk, dj, di);
}

template <typename T, bool YW, int AVG, bool YH = false, bool XH = false>
__global__ void __launch_bounds__(CALES_THREADS) dsmag_level2_kernel(
    const T* __restrict__ fu, const T* __restrict__ fv,
    const T* __restrict__ fw, const T* __restrict__ fue,
    const T* __restrict__ fve, const T* __restrict__ fwe, Ds2In<T> in,
    const T* __restrict__ alph2, const T* __restrict__ dzci,
    const T* __restrict__ dzfi, T* __restrict__ numo, T* __restrict__ deno,
    YRows<T> yu, YRows<T> yv, YRows<T> yw, YRows<T> xu, YRows<T> xv,
    YRows<T> xw, int nz, int ny, int nx, int ylo, int yhi, T dxi, T dyi) {
  const int k = blockIdx.y;
  const int gx = (nx + 31) / 32;
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * CALES_THREADS + threadIdx.x) >> 5;
  const int j = static_cast<int>(row / gx);
  const int xb = static_cast<int>(row - static_cast<int64_t>(j) * gx);
  const int i = xb * 32 + lane;
  const bool inside = j < ny && i < nx;
  const T two = T(2);
  T num = T(0), den = T(0);
  if (inside) {
    const int64_t plane = static_cast<int64_t>(ny) * nx;
    const int64_t idx = static_cast<int64_t>(j) * nx + i;
    const Cell c(k, idx, nz, ny, nx);
    T sf[6];
    auto strain = [&](auto ytag) {
      constexpr bool Y = decltype(ytag)::value;
      return strain_rate<T>(
          [&](int dk, int dj, int di) {
            return at<Y>(fu, fue, yu, c, dk, dj, di);
          },
          [&](int dk, int dj, int di) {
            return at<Y>(fv, fve, yv, c, dk, dj, di);
          },
          [&](int dk, int dj, int di) {
            return at<Y>(fw, fwe, yw, c, dk, dj, di);
          },
          dxi, dyi, dzci[k + 1], dzci[k], dzfi[k + 1], sf);
    };
    T s0f;
    // a pencil's first and last columns read the x halo (xu, xv, xw), with
    // the y halo's rows on a slab
    auto strain_x = [&](auto ytag) {
      constexpr int Y = decltype(ytag)::value;
      return strain_rate<T>(
          [&](int dk, int dj, int di) {
            return atxh<Y>(fu, fue, yu, xu, c, dk, dj, di);
          },
          [&](int dk, int dj, int di) {
            return atxh<Y>(fv, fve, yv, xv, c, dk, dj, di);
          },
          [&](int dk, int dj, int di) {
            return atxh<Y>(fw, fwe, yw, xw, c, dk, dj, di);
          },
          dxi, dyi, dzci[k + 1], dzci[k], dzfi[k + 1], sf);
    };
    constexpr int YX = YH ? Y_HALO : Y_PERIODIC;
    if (XH && (i == 0 || i == nx - 1)) {
      s0f = strain_x(std::integral_constant<int, YX>{});
    } else if constexpr (YW) {
      s0f = y_edge(j, ny) ? strain(std::true_type{})
                          : strain(std::false_type{});
    } else if constexpr (YH) {
      // a slab: its first and last rows read the halo (yu, yv, yw)
      auto strain_h = [&]() {
        return strain_rate<T>(
            [&](int dk, int dj, int di) {
              return aty<Y_HALO>(fu, fue, yu, c, dk, dj, di);
            },
            [&](int dk, int dj, int di) {
              return aty<Y_HALO>(fv, fve, yv, c, dk, dj, di);
            },
            [&](int dk, int dj, int di) {
              return aty<Y_HALO>(fw, fwe, yw, c, dk, dj, di);
            },
            dxi, dyi, dzci[k + 1], dzci[k], dzfi[k + 1], sf);
      };
      s0f = y_edge_of<Y_HALO>(j, ny) ? strain_h() : strain(std::false_type{});
    } else {
      s0f = strain(std::false_type{});
    }
    const T a2 = (YW && ((j == 0 && (!YH || ylo != 0)) ||
                         (j == ny - 1 && (!YH || yhi != 0))))
                     ? T(2.52)
                     : alph2[k];
    const int64_t o = static_cast<int64_t>(k) * plane + idx;
    T m[6], l[6];
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      m[q] = two * (__ldg(in.fm[q] + o) - a2 * s0f * sf[q]);
      l[q] = __ldg(in.lij[q] + o);
    }
    num = m[0] * l[0] + m[1] * l[1] + m[2] * l[2] +
          two * (m[3] * l[3] + m[4] * l[4] + m[5] * l[5]);
    den = m[0] * m[0] + m[1] * m[1] + m[2] * m[2] +
          two * (m[3] * m[3] + m[4] * m[4] + m[5] * m[5]);
    if constexpr (AVG == DS2_CAVITY) {
      // nu_t = max(|S| num / den, 0); a NaN passes, as in max(x, 0.0)
      const T r = __ldg(in.s0 + o) * num / den;
      numo[o] = r < T(0) ? T(0) : r;
    }
  }
  if constexpr (AVG == DS2_DUCT) {
    // the warp is the (z, y) row's x block
    for (int off = 16; off > 0; off >>= 1) {
      num += __shfl_down_sync(0xffffffffu, num, off);
      den += __shfl_down_sync(0xffffffffu, den, off);
    }
    if (lane == 0 && j < ny) {
      const int64_t r = (static_cast<int64_t>(k) * ny + j) * gx + xb;
      numo[r] = num;
      deno[r] = den;
    }
  } else if constexpr (AVG == DS2_CHANNEL) {
    const T ns = block_sum(num);
    const T ds = block_sum(den);
    if (threadIdx.x == 0) {
      numo[static_cast<int64_t>(k) * gridDim.x + blockIdx.x] = ns;
      deno[static_cast<int64_t>(k) * gridDim.x + blockIdx.x] = ds;
    }
  }
}

template <typename T, bool YW, bool YH = false>
auto pick_dsmag_level2(int avg) {
  return avg == DS2_DUCT     ? &dsmag_level2_kernel<T, YW, DS2_DUCT, YH>
         : avg == DS2_CAVITY ? &dsmag_level2_kernel<T, YW, DS2_CAVITY, YH>
                             : &dsmag_level2_kernel<T, YW, DS2_CHANNEL, YH>;
}

// q: fm[6], lij[6], s0; y: the y-row stacks and corners of the filtered
// u, v, w (6 pointers), all null without y walls; h: their depth-1 halo
// pairs on a slab with periodic y (mode YH, the 'channel' sums; 6
// pointers, all null elsewhere); ylo, yhi: on a slab of a y-walled mesh
// (y its y-row stacks, mode YW + YH) the walls it owns, -1 elsewhere; x:
// their depth-1 x halo pairs on a pencil of the 2D mesh (mode XH, the
// 'channel' sums, with h (YH) or periodic y; cols (nz, 3, ny+2), corners
// (3, 3, ny+2); 6 pointers, all null off a pencil); avg: DS2_CHANNEL,
// DS2_DUCT or DS2_CAVITY (nu_t into numo, deno unused).
template <typename T>
int launch_dsmag_level2(const T* fu, const T* fv, const T* fw, const T* fue,
                        const T* fve, const T* fwe, const T* const* q,
                        const T* alph2, const T* dzci, const T* dzfi,
                        T* numo, T* deno, const T* const* y,
                        const T* const* h, const T* const* x, int nz,
                        int ny, int nx, int avg, int ylo, int yhi,
                        double dxi, double dyi, void* stream) {
  const bool ystacks = y[0] != nullptr;
  const bool halo = h[0] != nullptr;
  const bool xhalo = x[0] != nullptr;
  const bool slab = ystacks && ylo >= 0;
  if (nz < 2 || (ystacks && !slab && ny < 4) || avg < DS2_CHANNEL ||
      avg > DS2_CAVITY || (ystacks && halo) ||
      (halo && avg != DS2_CHANNEL) || (slab && (yhi < 0 || ny < 2)) ||
      (xhalo && (ystacks || avg != DS2_CHANNEL || nx < 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int m = 0; m < 6; ++m)
    if (ystacks != (y[m] != nullptr) || halo != (h[m] != nullptr) ||
        xhalo != (x[m] != nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
  Ds2In<T> in{};
  for (int m = 0; m < 6; ++m) {
    in.fm[m] = q[m];
    in.lij[m] = q[6 + m];
  }
  in.s0 = q[12];
  const int64_t slots = static_cast<int64_t>(ny) * ((nx + 31) / 32) * 32;
  const dim3 grid(static_cast<unsigned>((slots + CALES_THREADS - 1) /
                                        CALES_THREADS),
                  static_cast<unsigned>(nz), 1);
  constexpr int CH = DS2_CHANNEL;
  auto kern =
      xhalo     ? (halo ? &dsmag_level2_kernel<T, false, CH, true, true>
                        : &dsmag_level2_kernel<T, false, CH, false, true>)
      : slab    ? pick_dsmag_level2<T, true, true>(avg)
      : ystacks ? pick_dsmag_level2<T, true>(avg)
      : halo    ? &dsmag_level2_kernel<T, false, DS2_CHANNEL, true>
                : pick_dsmag_level2<T, false>(avg);
  // the rows the kernel reads past the interior: the y-row stacks, or a
  // slab's halo pairs
  const T* const* r = halo ? h : y;
  kern<<<grid, CALES_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      fu, fv, fw, fue, fve, fwe, in, alph2, dzci, dzfi, numo, deno,
      YRows<T>{r[0], r[1]}, YRows<T>{r[2], r[3]}, YRows<T>{r[4], r[5]},
      YRows<T>{x[0], x[1]}, YRows<T>{x[2], x[3]}, YRows<T>{x[4], x[5]}, nz,
      ny, nx, slab ? ylo : 1, slab ? yhi : 1, T(dxi), T(dyi));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cales

#define CALES_DSMAG_LEVEL2_ENTRY(NAME, T)                                    \
  extern "C" int NAME(const T* fu, const T* fv, const T* fw, const T* fue,   \
                      const T* fve, const T* fwe, const T* fm0,              \
                      const T* fm1, const T* fm2, const T* fm3,              \
                      const T* fm4, const T* fm5, const T* l0, const T* l1,  \
                      const T* l2, const T* l3, const T* l4, const T* l5,    \
                      const T* s0, const T* alph2, const T* dzci,            \
                      const T* dzfi, T* numo, T* deno, const T* yur,         \
                      const T* yuc, const T* yvr, const T* yvc,              \
                      const T* ywr, const T* ywc, const T* hur,              \
                      const T* huc, const T* hvr, const T* hvc,              \
                      const T* hwr, const T* hwc, const T* xur,              \
                      const T* xuc, const T* xvr, const T* xvc,              \
                      const T* xwr, const T* xwc, int nz, int ny, int nx,    \
                      int avg, int ylo, int yhi, double dxi, double dyi,     \
                      void* stream) {                                        \
    const T* const q[13] = {fm0, fm1, fm2, fm3, fm4, fm5, l0,                \
                            l1,  l2,  l3,  l4,  l5,  s0};                    \
    const T* const y[6] = {yur, yuc, yvr, yvc, ywr, ywc};                    \
    const T* const h[6] = {hur, huc, hvr, hvc, hwr, hwc};                    \
    const T* const x[6] = {xur, xuc, xvr, xvc, xwr, xwc};                    \
    return cales::launch_dsmag_level2<T>(fu, fv, fw, fue, fve, fwe, q,       \
                                         alph2, dzci, dzfi, numo, deno, y,   \
                                         h, x, nz, ny, nx, avg, ylo, yhi,    \
                                         dxi, dyi, stream);                  \
  }

CALES_DSMAG_LEVEL2_ENTRY(cales_dsmag_level2_f32, float)
CALES_DSMAG_LEVEL2_ENTRY(cales_dsmag_level2_f64, double)
