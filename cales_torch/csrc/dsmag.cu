// Dynamic Smagorinsky (Germano-Lilly), one z-march.
//
// Replaces: cales_tpu/ops/pallas_dsmag.py fused_dsmag_onepass (body
// _ds_onepass_kernel) on the single-device path, with its three averages
// (reference sgs.f90:153-370, ave1d_channel 433-538, ave2d_duct 540-614):
//   'channel'  |S| and, per (z row, block), the partial sums of
//              num = M_ij L_ij and den = M_ij M_ij (off-diagonal pairs
//              twice); the caller sums each z row and forms
//              nu_t = max(|S| num/den, 0);
//   'duct'     |S| and the partial sums per (z, y) row and x block (a tile
//              row is one warp, so a shuffle sums its 32 cells); the
//              caller sums over the x blocks: one ratio per (z, y) row;
//   'cavity'   nu_t = max(|S| num/den, 0) cell by cell, no averaging.
// The model and its ghost recipes are cales_torch/ops/kernels.dsmag_plain's:
//   A  source quantities at a cell centre: |S| S_ij (6), the centred
//      velocity (3) and its products (6), and |S|;
//   B  the 27-point test filter (sgs.f90:616-680, separable (1,2,1)/4 in
//      x, then y, then z) of the velocity and of the A quantities; A's z
//      ghosts extrapolate linearly at a wall (2 q_0 - q_1), and so do the
//      wall-parallel velocity's for its filter;
//   C  the test-level strain of the filtered velocity, whose fill is
//      -+1 times the first plane plus 2b (the 'D' value b) for u and v, and
//      0 for w on both z faces (its lower face and the padded-row-nz
//      rewrite); M_ij = 2 (filt(|S| S_ij) - alpha^2 |S~| S~_ij), the
//      Leonard term L_ij = filt(uc_i uc_j) - filt(uc_i) filt(uc_j).
// With y walls (the duct and cavity classes, both y faces walls) the same
// recipes hold along y (pallas_dsmag.py:905-1120): the velocity's y ghost
// rows come from the post-correction fill's y-row stacks; A's y ghost rows
// are the extrapolation 2 q_0 - q_1 of A itself (not A of the ghost
// velocity), and so are u's and w's for their filter; the filtered u and w
// take -F(first row) + 2b at a y wall (b the 'D' value), the filtered v is
// 0 on its lower wall face and its padded-ny rewrite row; alpha^2 is 2.52
// on the first and last y rows as on the first and last z rows.
//
// Design.  A block owns an 8 x 32 (y, x) tile and marches z through three
// rings of planes in shared memory, one plane entering per step:
//   V  the velocity (3) on the tile + a halo of 2, planes t-1 .. t+1;
//   A  the 16 source quantities on the tile + a halo of 1, planes t-2 .. t;
//   F  the filtered velocity (3) on the tile + a halo of 1, planes t-2 .. t.
// At step t the block loads velocity plane t+1, forms A and F at plane t,
// then finishes plane t-1 at the tile's centre: the 15 filtered A
// quantities, the test-level strain from F, M_ij, L_ij and the contraction
// in registers, the sums or nu_t, and |S|.  With y walls (template switch
// YW) the velocity's rows -1, ny-1 and ny load from the y-row stacks, and
// one pass after stage A writes plane t's y ghost rows of A and F by
// their recipes, so stage C reads the same code as without walls.
// The load, stage A, the filter and A's y fix are dsmag_common.cuh's,
// shared with dsmag_level1.cu (the grid level of the two passes).
// Nothing but |S| (or nu_t) and the partial sums goes to global memory.  x wraps when a plane is loaded,
// and so does y without y walls; a ragged tile's outside cells are
// computed on wrapped data and left out of the output and the sums.
// 'duct' keeps this tile and leaves the last sum over x to the caller, a
// (nz, ny, nx/32) reduction, rather than a tile spanning all of x (the TPU
// kernel's fold_ratio), which would not fit shared memory at nx = 512.
//
// Shared memory: (9 * 12 * 36 + 48 * 10 * 34 + 9 * 10 * 34) words =
// 93,072 bytes in f32 (two blocks on an SM), 186,144 in f64, within the
// card's 227 KB a block.
//
// Bound on the H100: operations.  It reads u, v, w once and writes |S| (4
// field streams, 0.54 GB at 512x256x256 f32: 0.16 ms at 3.35 TB/s).  The
// function needs about 473 floating-point operations a cell: A 110 (the
// strain rate's 92 + 18), 18 filtered quantities at 12 each when the
// separable passes are shared across the plane (3 passes of 4), and C 147
// (the test-level strain's 92 + M_ij, L_ij and the contraction), 15.9
// GFLOP a call: 0.24 ms at the data sheet's 67 TFLOP/s f32 outside the
// tensor cores.  This first kernel does about 1,200 a cell: it filters
// each quantity with 27 shared-memory reads per centre cell (52
// operations, nothing shared between neighbours) and recomputes A and F on
// the halo of every tile; sharing the x and y passes is later work.
#include "dsmag_common.cuh"

namespace cales {

static_assert(DS_TX == 32, "'duct' sums a tile row as one warp");
enum { DS_CHANNEL = 0, DS_DUCT = 1, DS_CAVITY = 2 };

template <typename T>
constexpr size_t dsmag_smem_bytes() {
  return sizeof(T) * (9 * DS_VPL + 3 * DS_NA * DS_APL + 9 * DS_APL);
}

template <typename T, bool YW, int AVG>
__global__ void __launch_bounds__(DS_NT) dsmag_kernel(
    const T* __restrict__ u, const T* __restrict__ v, const T* __restrict__ w,
    const T* __restrict__ ue, const T* __restrict__ ve,
    const T* __restrict__ we, const T* __restrict__ alph2,
    const T* __restrict__ dzci, const T* __restrict__ dzfi,
    T* __restrict__ s0o, T* __restrict__ numo, T* __restrict__ deno,
    DsYWalls<T> yw, int nz, int ny, int nx, int wall_lo, int wall_hi, T dxi,
    T dyi, T zoff_lo_u, T zoff_hi_u, T zoff_lo_v, T zoff_hi_v) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const Vs = reinterpret_cast<T*>(smem_raw);   // [3 planes][3][VPL]
  T* const As = Vs + 9 * DS_VPL;                   // [3 planes][16][APL]
  T* const Fs = As + 3 * DS_NA * DS_APL;           // [3 planes][3][APL]
  const int gx = (nx + DS_TX - 1) / DS_TX;
  const int bx = blockIdx.x % gx;
  const int x0 = bx * DS_TX;
  const int y0 = (blockIdx.x / gx) * DS_TY;
  const int tid = threadIdx.x;
  const int64_t plane = static_cast<int64_t>(ny) * nx;
  const T* const fld[3] = {u, v, w};
  const T* const edg[3] = {ue, ve, we};
  const T two = T(2);
  const T szlo = wall_lo ? T(-1) : T(1), szhi = wall_hi ? T(-1) : T(1);
  const T zofflo[2] = {zoff_lo_u, zoff_lo_v};
  const T zoffhi[2] = {zoff_hi_u, zoff_hi_v};

  auto vel = [&](int kz, int c) { return Vs + (ring(kz) * 3 + c) * DS_VPL; };
  auto src = [&](int kz, int q) {
    return As + (ring(kz) * DS_NA + q) * DS_APL;
  };
  auto fvel = [&](int kz, int c) { return Fs + (ring(kz) * 3 + c) * DS_APL; };

  const DsTile g{x0, y0, nz, ny, nx, tid, plane};
  auto load = [&](int kz) { ds_load<T, YW>(vel, fld, edg, yw, g, kz); };

  // stage A and the filtered velocity at plane t on the tile + halo 1
  auto stage_a = [&](int t) {
    const T dzci_c = dzci[t + 1], dzci_m = dzci[t], dzfi_c = dzfi[t + 1];
    // the wall-parallel velocity's extrapolated ghost planes for its filter
    const bool ext_lo = wall_lo && t == 0, ext_hi = wall_hi && t == nz - 1;
    for (int e = tid; e < DS_APL; e += DS_NT) {
      const int ay = e / DS_AX, ax = e - ay * DS_AX;
      const int gy = y0 - 1 + ay;
      const int vo = (ay + 1) * DS_VX + ax + 1;
      ds_source<T>(vel, src, t, e, vo, dxi, dyi, dzci_c, dzci_m, dzfi_c);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        fvel(t, c)[e] = ds_fvel<T, YW>(vel, t, c, vo, gy, ny, ext_lo, ext_hi);
    }
    if (YW && (y0 == 0 || y0 >= ny - DS_TY - 1)) {
      // plane t's y ghost rows, y = -1 and ny (tile rows rlo and rhi, in
      // the first and last tile rows only): A's by ds_fix_src_y; the
      // filtered u's and w's the fill -F(first row) + 2b, the filtered v's
      // 0, as is its rewrite row y = ny-1 (pallas_dsmag.py:1057-1071), so
      // stage C reads the filled rows as they are
      __syncthreads();
      ds_fix_src_y<T>(src, t, y0, ny, tid);
      const int rlo = -y0, rhi = ny - y0 + 1;
      for (int e = tid; e < 2 * 3 * DS_AX; e += DS_NT) {
        const int side = e / (3 * DS_AX);
        const int rest = e - side * 3 * DS_AX;
        const int c = rest / DS_AX, ax = rest - c * DS_AX;
        const int ay = side == 0 ? rlo : rhi;
        const int in = side == 0 ? DS_AX : -DS_AX;
        if (c == 1) {
          // v: the lower wall face and the rewrite row (one row below rhi)
          const int r = side == 0 ? rlo : rhi - 1;
          if (r >= 0 && r < DS_AY) fvel(t, 1)[r * DS_AX + ax] = T(0);
          continue;
        }
        if (ay < 0 || ay >= DS_AY) continue;
        T* f = fvel(t, c) + ay * DS_AX + ax;
        f[0] = -f[in] + (side == 0 ? yw.off_lo[c] : yw.off_hi[c]);
      }
    }
  };

  // stage C at the centre of plane kc; every thread calls it (block sums)
  const int cy = tid / DS_TX, cx = tid - cy * DS_TX;
  const int ao = (cy + 1) * DS_AX + cx + 1;
  const int yc = y0 + cy;
  const bool inside = yc < ny && x0 + cx < nx;
  auto stage_c = [&](int kc) {
    T fq[DS_NA - 1];
    ds_filtered<T>(src, kc, ao, nz, wall_lo, wall_hi, fq);
    // the filtered velocity with its z fill (bounduvw, static planes; the
    // y fill is in the ring already)
    auto FU = [&](int c, int dk, int dj, int di) -> T {
      const int kz = kc + dk, o = ao + dj * DS_AX + di;
      if (c == 2) return (kz < 0 || kz == nz - 1) ? T(0) : fvel(kz, 2)[o];
      if (kz < 0) return szlo * fvel(0, c)[o] + zofflo[c];
      if (kz >= nz) return szhi * fvel(nz - 1, c)[o] + zoffhi[c];
      return fvel(kz, c)[o];
    };
    T sf[6];
    const T s0f = strain_rate<T>(
        [&](int dk, int dj, int di) { return FU(0, dk, dj, di); },
        [&](int dk, int dj, int di) { return FU(1, dk, dj, di); },
        [&](int dk, int dj, int di) { return FU(2, dk, dj, di); }, dxi, dyi,
        dzci[kc + 1], dzci[kc], dzfi[kc + 1], sf);
    const T a2 = (YW && (yc == 0 || yc == ny - 1)) ? T(2.52) : alph2[kc];
    T m[6], l[6];
    const int pa[6] = {6, 7, 8, 6, 6, 7}, pb[6] = {6, 7, 8, 7, 8, 8};
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      m[q] = two * (fq[q] - a2 * s0f * sf[q]);
      l[q] = fq[9 + q] - fq[pa[q]] * fq[pb[q]];
    }
    T num = m[0] * l[0] + m[1] * l[1] + m[2] * l[2] +
            two * (m[3] * l[3] + m[4] * l[4] + m[5] * l[5]);
    T den = m[0] * m[0] + m[1] * m[1] + m[2] * m[2] +
            two * (m[3] * m[3] + m[4] * m[4] + m[5] * m[5]);
    const int64_t oc = kc * plane + static_cast<int64_t>(yc) * nx + x0 + cx;
    if constexpr (AVG == DS_CAVITY) {
      // nu_t = max(|S| num / den, 0); a NaN passes, as in max(x, 0.0)
      if (inside) {
        const T r = src(kc, 15)[ao] * num / den;
        s0o[oc] = r < T(0) ? T(0) : r;
      }
      return;
    }
    if (inside) {
      s0o[oc] = src(kc, 15)[ao];
    } else {
      num = T(0);
      den = T(0);
    }
    if constexpr (AVG == DS_DUCT) {
      // the tile row's 32 cells are one warp
      for (int off = 16; off > 0; off >>= 1) {
        num += __shfl_down_sync(0xffffffffu, num, off);
        den += __shfl_down_sync(0xffffffffu, den, off);
      }
      if (cx == 0 && yc < ny) {
        const int64_t r = (static_cast<int64_t>(kc) * ny + yc) * gx + bx;
        numo[r] = num;
        deno[r] = den;
      }
      return;
    }
    const T ns = block_sum(num);
    const T ds = block_sum(den);
    if (tid == 0) {
      numo[static_cast<int64_t>(kc) * gridDim.x + blockIdx.x] = ns;
      deno[static_cast<int64_t>(kc) * gridDim.x + blockIdx.x] = ds;
    }
  };

  load(-1);
  load(0);
  for (int t = 0; t <= nz; ++t) {
    __syncthreads();            // the previous step's readers are done
    if (t + 1 <= nz) load(t + 1);
    __syncthreads();
    if (t < nz) stage_a(t);
    __syncthreads();
    if (t >= 1) stage_c(t - 1);
  }
}

template <typename T, bool YW>
auto pick_dsmag(int avg) {
  return avg == DS_DUCT     ? &dsmag_kernel<T, YW, DS_DUCT>
         : avg == DS_CAVITY ? &dsmag_kernel<T, YW, DS_CAVITY>
                            : &dsmag_kernel<T, YW, DS_CHANNEL>;
}

// y: the y-row stacks and corners of u, v, w (6 pointers), all null
// without y walls; yvals: the filtered fill's 'D' values (u_lo, u_hi,
// w_lo, w_hi) on the y walls; avg: DS_CHANNEL, DS_DUCT or DS_CAVITY.
template <typename T>
int launch_dsmag(const T* u, const T* v, const T* w, const T* ue,
                 const T* ve, const T* we, const T* alph2, const T* dzci,
                 const T* dzfi, T* s0o, T* numo, T* deno,
                 const T* const* y, int nz, int ny, int nx, int wall_lo,
                 int wall_hi, int avg, double dxi, double dyi,
                 const double* zvals, const double* yvals, void* stream) {
  const bool ywall = y[0] != nullptr;
  if (nz < 2 || (ywall && ny < 4) || avg < DS_CHANNEL || avg > DS_CAVITY)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int m = 0; m < 6; ++m)
    if (ywall != (y[m] != nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = dsmag_smem_bytes<T>();
  auto kern = ywall ? pick_dsmag<T, true>(avg) : pick_dsmag<T, false>(avg);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nblk = ((ny + DS_TY - 1) / DS_TY) * ((nx + DS_TX - 1) / DS_TX);
  DsYWalls<T> yw{};
  for (int c = 0; c < 3; ++c) yw.vel[c] = YRows<T>{y[2 * c], y[2 * c + 1]};
  if (ywall) {
    yw.off_lo[0] = T(2 * yvals[0]);
    yw.off_hi[0] = T(2 * yvals[1]);
    yw.off_lo[2] = T(2 * yvals[2]);
    yw.off_hi[2] = T(2 * yvals[3]);
  }
  // the filtered-velocity fill's 'D' offsets 2b, on wall faces only
  const T olu = wall_lo ? T(2 * zvals[0]) : T(0);
  const T ohu = wall_hi ? T(2 * zvals[1]) : T(0);
  const T olv = wall_lo ? T(2 * zvals[2]) : T(0);
  const T ohv = wall_hi ? T(2 * zvals[3]) : T(0);
  kern<<<nblk, DS_NT, smem, static_cast<cudaStream_t>(stream)>>>(
      u, v, w, ue, ve, we, alph2, dzci, dzfi, s0o, numo, deno, yw, nz, ny, nx,
      wall_lo, wall_hi, T(dxi), T(dyi), olu, ohu, olv, ohv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cales

#define CALES_DSMAG_ENTRY(NAME, T)                                            \
  extern "C" int NAME(const T* u, const T* v, const T* w, const T* ue,        \
                      const T* ve, const T* we, const T* alph2,               \
                      const T* dzci, const T* dzfi, T* s0o, T* numo,          \
                      T* deno, const T* yur, const T* yuc, const T* yvr,      \
                      const T* yvc, const T* ywr, const T* ywc, int nz,       \
                      int ny, int nx, int wall_lo, int wall_hi, int avg,      \
                      double dxi, double dyi, double zlo_u, double zhi_u,     \
                      double zlo_v, double zhi_v, double ylo_u,               \
                      double yhi_u, double ylo_w, double yhi_w,               \
                      void* stream) {                                         \
    const T* const y[6] = {yur, yuc, yvr, yvc, ywr, ywc};                     \
    const double zvals[4] = {zlo_u, zhi_u, zlo_v, zhi_v};                     \
    const double yvals[4] = {ylo_u, yhi_u, ylo_w, yhi_w};                     \
    return cales::launch_dsmag<T>(u, v, w, ue, ve, we, alph2, dzci, dzfi,     \
                                  s0o, numo, deno, y, nz, ny, nx, wall_lo,    \
                                  wall_hi, avg, dxi, dyi, zvals, yvals,       \
                                  stream);                                    \
  }

CALES_DSMAG_ENTRY(cales_dsmag_f32, float)
CALES_DSMAG_ENTRY(cales_dsmag_f64, double)
