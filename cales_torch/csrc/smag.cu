// Static Smagorinsky eddy viscosity with van Driest damping, one pass.
//
// Replaces: cales_tpu/ops/pallas_kernels.py fused_smag (body _smag_kernel)
// on the single-device z-walls path, the nu_t stage of the channel LES with
// z-implicit diffusion (impdiff_1d), where the projection cannot carry the
// strain (cales_tpu/timeloop.py _compute_sgs_kernel).  Per output cell:
//   nu_t = (Cs Delta)^2 fd^2 |S| (sgs.f90:69-152), |S| of the
//   post-correction fill (interiors + z-edge stacks), fd from the nearer z
//   wall's shear plane; fd = 1 without z walls.
// The strain rate and the damping are common.cuh's, in the same order as
// the nu_t part of correc_smag.cu.  The halo variant (a slab of a
// y-sharded mesh, the shard branch of cales_tpu _compute_sgs_kernel) reads
// the rows -1 and ny of u, v, w from their halos (common.cuh hrow).
//
// The y-wall variant (the duct classes; the port's choice: the JAX
// package runs static Smagorinsky with y walls through XLA,
// cales_tpu/sgs.py:159 smag_visct, as its fused_smag takes z walls only)
// reads the rows -1, ny-1 and ny of u, v, w from their y-row stacks
// (common.cuh yrow), which the caller has already extrapolated on the
// wall-modelled faces (sgs.extrapolate_stacks: the strain's one-sided
// ghosts), and damps with the nearest of the four walls: the nearer y
// wall's distance and shear plane (one row of its (nz, nx) plane a z
// step) unless a z wall is strictly nearer (the running minimum over
// y-lo, y-hi, z-lo, z-hi of sgs.f90:104-146, the first minimum winning).
//
// The x-wall variant (X_WALLS, the developing channel, box and duct LES, with
// periodic y or y walls, and the developing channel LES on a slab of the
// y-slab mesh, whose x stacks carry the neighbours' rows -1 and ny; the
// port's choice: the JAX package runs static Smagorinsky with x walls
// through XLA, cales_tpu/sgs.py:159 smag_visct, its fused_smag excluding
// x walls) reads the tile's halo columns -1 and nx of u, v, w from their
// x stacks as a plane is loaded (common.cuh xcol; the stacks carry the
// wall model's 'E' corners where the caller extrapolated them,
// sgs.extrapolate_stacks), as mom_rk's X_WALLS does, and
// damps with the nearest wall in the order x, y, z: an x face whose u is
// 'D' is a wall (an inflow face too, sgs.f90:76-81), its distance along x
// per column and its (nz, ny) shear plane read at the cell; a later wall
// serves a cell only where it is strictly nearer (the running minimum
// over all six faces).
//
// The x-halo variant (X_HALO, a pencil of a 2D mesh, with the y halo
// variant, periodic y or y walls) reads the tile's halo columns -1 and nx
// from the x halo stacks (common.cuh XMode: they carry the rows -1 and
// ny, the corners where the y halo rows meet the x halo columns, or with
// y walls on the walls the pencil's mesh row holds the x neighbours' wall
// rows) as the x-wall variant reads its x stacks, and damps with the z
// walls, and with y walls the nearer y wall too (its shear planes the
// pencil's columns, made on the wall's pencils and summed over the mesh
// column by the caller): no x wall's distance or shear plane is read.
//
// Design: a z-march through shared memory, as correc_smag.cu's without
// the correction.  The strain rate at a cell reads 30 values around it: u
// and v on three planes, w on two, +-1 in x and y.  A block owns a TY x 32
// (y, x) tile (TY = 16 in float32, 8 in float64; a thread takes RPT = 2
// rows of a column in float32, 1 in float64) and marches a chunk of z,
// one plane a step.  The chunks are as many as give the launch about
// SM_BLOCKS blocks, each of at least 16 planes: the tiles alone are too
// few to fill the card (256 at 512x256x256 in float32, 128 on a slab of
// half its rows), and a chunk reloads only the two planes beyond it.  The
// march keeps a ring of 5 planes of u, v and w on the tile + a halo of 1
// in shared memory, filled by cp.async three planes ahead: at step k it
// copies plane k+3 into the slot of plane k-2, takes the strain at plane k
// from planes k-1, k and k+1 and waits for plane k+2; one barrier a
// plane, so a step's copies never meet the previous step's reads.  A
// plane is loaded as zrow reads it (z ghost planes -1 and nz and the
// rewrite row nz-1 from the edge stacks), x and y wrapped; on a slab the
// tile's rows -1 and ny come from the halos as the plane is loaded, so
// both y modes run one body.  A thread's cells of the halo tile and their
// offsets are the same at every step: it finds them once.  The spacings
// and profiles are read a step ahead, the wall-shear planes once at the
// thread's own cells, and nu_t is written a warp a row of 32 cells.  A
// ragged tile's outside cells are computed on wrapped data and not
// stored.  The arithmetic of a cell is the parent's (the thread-a-cell
// kernel reading device memory): its nu_t is bitwise the same.
// Shared memory: 5 planes x 3 fields x (TY+2) x 34 values, 36,720 bytes in
// float32 and 40,800 in float64; float32 held to 64 registers (four
// blocks of 256 threads an SM), no spills.
//
// Bound on the H100: memory.  It reads u, v, w once and writes nu_t: 4
// field streams, 0.54 GB at 512x256x256 f32, a 0.16 ms floor at the data
// sheet's 3.35 TB/s (about 100 flops a cell, far from the 67 TFLOP/s f32
// rate); the halo of the tile adds 20% to the reads (18 x 34 cells loaded
// for 16 x 32).  Measured on an NVIDIA H100 80GB HBM3 at 700 W
// (cales_torch.ab_dsmag and cales_torch.tile_probe, f32): 0.359 ms at
// 512x256x256 (0.570 for a thread a cell reading device memory; 0.428
// with a tile marching all of z), 0.394 with halos (0.636); on a slab of
// half the rows 0.187, with halos 0.205 (0.319 and 0.348 marching all of
// z).  Its 30 shared-memory reads a cell, the strain's and van Driest's
// arithmetic (two IEEE divisions, a square root, an exponential) and the
// copies keep it at 2.2x its bound: one row a thread was 19-31% slower,
// four 9-23%, tiles of 32 rows 3-9%; other block targets and five blocks
// an SM were within 3%.
#include <algorithm>

#include "common.cuh"

namespace cales {

// The tile rows (16 in float32, 8 in float64) and a thread's rows of it.
template <typename T>
struct SmTy {
  static constexpr int TY = sizeof(T) == 4 ? 16 : 8;
  static constexpr int RPT = sizeof(T) == 4 ? 2 : 1;
};

constexpr int SM_TX = 32;          // the tile's columns
constexpr int SM_CX = SM_TX + 2;   // with a halo of 1
constexpr int SM_RING = 5;         // planes in the ring
// the blocks a launch aims at (about four waves of four blocks on each of
// an H100's 132 SMs), in z chunks of at least SM_MIN_CHUNK planes: a tile
// marches one chunk, and a chunk reloads two planes beyond it
constexpr int SM_BLOCKS = 2048;
constexpr int SM_MIN_CHUNK = 16;

template <typename T>
struct SmGeo {
  static constexpr int TY = SmTy<T>::TY, RPT = SmTy<T>::RPT;
  static constexpr int NT = TY / RPT * SM_TX;
  static constexpr int CPL = (TY + 2) * SM_CX;   // one field, one plane
  // blocks an SM: float32 held to 64 registers a thread
  static constexpr int MINB = sizeof(T) == 4 ? 1024 / NT : 2;
};

template <typename T, int YM, int XM>
__global__ void __launch_bounds__(SmGeo<T>::NT, SmGeo<T>::MINB)
    smag_kernel(
    const T* __restrict__ u, const T* __restrict__ v, const T* __restrict__ w,
    const T* __restrict__ ue, const T* __restrict__ ve,
    const T* __restrict__ we, const T* __restrict__ dzci,
    const T* __restrict__ dzfi, const T* __restrict__ csd2,
    const T* __restrict__ dw, const T* __restrict__ nearlo,
    const T* __restrict__ tauw_lo, const T* __restrict__ tauw_hi,
    const T* __restrict__ dwy, const T* __restrict__ nearylo,
    const T* __restrict__ tauw_ylo, const T* __restrict__ tauw_yhi,
    const T* __restrict__ dwx, const T* __restrict__ nearxlo,
    const T* __restrict__ tauw_xlo, const T* __restrict__ tauw_xhi,
    T* __restrict__ so, YRows<T> hu, YRows<T> hv, YRows<T> hw, YRows<T> xu,
    YRows<T> xv, YRows<T> xw, int nz, int ny, int nx, int kc,
    int have_zwalls, T dxi, T dyi, T visc) {
  using G = SmGeo<T>;
  constexpr int TY = G::TY, RPT = G::RPT, NT = G::NT, CPL = G::CPL;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const R = reinterpret_cast<T*>(smem_raw);   // [plane][u, v, w][CPL]
  const int gx = (nx + SM_TX - 1) / SM_TX;
  const int x0 = (blockIdx.x % gx) * SM_TX;
  const int y0 = (blockIdx.x / gx) * TY;
  const int tid = threadIdx.x;
  const int64_t plane = static_cast<int64_t>(ny) * nx;
  // the block's planes k0 .. k1-1, a chunk of kc
  const int k0 = blockIdx.y * kc, k1 = min(nz, k0 + kc);

  // ring plane kz (-1 .. nz): its fields 3 x CPL
  auto ring = [&](int kz) { return R + ((kz + SM_RING) % SM_RING) * 3 * CPL; };

  // this thread's cells of the halo tile (e = tid + i NT): the offset of
  // each in its plane of the field (>= 0), or ~ its offset in the plane's
  // halo (< 0, on a slab) or y-row stack (< 0, y walls: rows -1, ny-1 and
  // ny, and the ragged tile's rows past ny as row ny), or with x walls in
  // its x stack or x halo (ox[i]); x and y wrapped
  constexpr int NC = (CPL + NT - 1) / NT;
  constexpr bool XS = XM != X_PERIODIC;
  // the x stacks carry the rows -1 and ny with y walls and on a slab,
  // the x halos always
  constexpr int NYC_PAD = YM != Y_PERIODIC || XM == X_HALO ? 2 : 0;
  int oc[NC];
  bool ox[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int e = tid + i * NT, ly = e / SM_CX, lx = e - ly * SM_CX;
    const int gy = y0 - 1 + ly, wx = wrap_near(x0 - 1 + lx, nx);
    ox[i] = XS && (x0 - 1 + lx == -1 || x0 - 1 + lx == nx);
    if (XS && ox[i]) {
      // column 0 (x = -1) or 2 (x = nx); rows past ny (a ragged last
      // tile's, never stored) take row ny's
      const int jj = NYC_PAD ? min(gy, ny) + 1 : wrap_near(gy, ny);
      oc[i] = ~((x0 - 1 + lx < 0 ? 0 : 2) * (ny + NYC_PAD) + jj);
      continue;
    }
    const int r = YM == Y_HALO    ? (gy < 0 ? 0 : gy == ny ? 1 : -1)
                  : YM == Y_WALLS ? (gy < 0        ? 0
                                     : gy >= ny - 1 ? min(gy - ny + 2, 2)
                                                    : -1)
                                  : -1;
    oc[i] = r >= 0 ? ~(r * nx + wx) : wrap_near(gy, ny) * nx + wx;
  }

  // the copy of plane kz (k0-1 .. k1, z-edge rows by zrow); one group a
  // plane, empty past k1
  auto load = [&](int kz) {
    if (kz <= k1) {
      const T* const fb[3] = {zrow(u, ue, kz, nz, plane),
                              zrow(v, ve, kz, nz, plane),
                              zrow(w, we, kz, nz, plane)};
      const T* yb[3] = {nullptr, nullptr, nullptr};
      if (YM == Y_HALO) {
        yb[0] = hrow(hu, kz, 0, nz, nx);
        yb[1] = hrow(hv, kz, 0, nz, nx);
        yb[2] = hrow(hw, kz, 0, nz, nx);
      } else if (YM == Y_WALLS) {
        yb[0] = yrow(hu, kz, 0, nz, nx);
        yb[1] = yrow(hv, kz, 0, nz, nx);
        yb[2] = yrow(hw, kz, 0, nz, nx);
      }
      // the x stacks' column 0 of plane kz
      const T* xb[3] = {nullptr, nullptr, nullptr};
      if (XS) {
        const int nyc = ny + NYC_PAD;
        xb[0] = yrow(xu, kz, 0, nz, nyc);
        xb[1] = yrow(xv, kz, 0, nz, nyc);
        xb[2] = yrow(xw, kz, 0, nz, nyc);
      }
      T* const dst = ring(kz);
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int e = tid + i * NT;
        if (e >= CPL) continue;
        const int o = oc[i];
#pragma unroll
        for (int f = 0; f < 3; ++f)
          cp_async(dst + f * CPL + e,
                   o >= 0 ? fb[f] + o : (XS && ox[i] ? xb[f] : yb[f]) + ~o);
      }
    }
    cp_async_commit();
  };

  // this thread's cells (RPT rows of one column), and the wall-shear
  // planes of both z walls there
  const int ty = tid / SM_TX * RPT, tx = tid - tid / SM_TX * SM_TX;
  const int co = (ty + 1) * SM_CX + tx + 1;
  const int64_t idx = static_cast<int64_t>(y0 + ty) * nx + x0 + tx;
  bool inside[RPT];
  T tlo[RPT], thi[RPT];
  // y walls: the nearer y wall's distance and shear plane at these rows
  T dy[RPT];
  const T* ty_w[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    inside[r] = y0 + ty + r < ny && x0 + tx < nx;
    tlo[r] = thi[r] = T(0);
    if (have_zwalls && inside[r]) {
      tlo[r] = tauw_lo[idx + r * nx];
      thi[r] = tauw_hi[idx + r * nx];
    }
    dy[r] = T(0);
    ty_w[r] = nullptr;
    if (YM == Y_WALLS && inside[r]) {
      dy[r] = dwy[y0 + ty + r];
      ty_w[r] = (nearylo[y0 + ty + r] > T(0.5) ? tauw_ylo : tauw_yhi) + x0 +
                tx;
    }
  }
  // x walls: the nearer x wall's distance at this column and its shear
  // plane (nz, ny), read at the cell each step
  T dxw = T(0);
  const T* tx_w = nullptr;
  if (XM == X_WALLS && dwx != nullptr && x0 + tx < nx) {
    dxw = dwx[x0 + tx];
    tx_w = (nearxlo[x0 + tx] > T(0.5) ? tauw_xlo : tauw_xhi) + y0 + ty;
  }
  // plane k's spacings and profiles, and with y walls the nearer y
  // wall's shear at these cells, read a step ahead
  T dzci_c, dzci_m, dzfi_c, csd2_k, dw_k = T(0);
  bool lo_k = false;
  T ty_k[RPT];
  auto profiles = [&](int k) {
    dzci_c = dzci[k + 1];
    dzci_m = dzci[k];
    dzfi_c = dzfi[k + 1];
    csd2_k = csd2[k];
    if (have_zwalls) {
      dw_k = dw[k];
      lo_k = nearlo[k] > T(0.5);
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r)
      ty_k[r] = YM == Y_WALLS && inside[r]
                    ? ty_w[r][static_cast<int64_t>(k) * nx]
                    : T(0);
  };

  load(k0 - 1);
  load(k0);
  load(k0 + 1);
  load(k0 + 2);
  profiles(k0);
  cp_async_wait<1>();   // planes k0-1, k0 and k0+1
  __syncthreads();
  for (int k = k0; k < k1; ++k) {
    load(k + 3);
    const T* const uk[3] = {ring(k - 1), ring(k), ring(k + 1)};
    const T* const vk[3] = {uk[0] + CPL, uk[1] + CPL, uk[2] + CPL};
    const T* const wk[2] = {uk[0] + 2 * CPL, uk[1] + 2 * CPL};
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      if (!inside[r]) continue;
      const T s0 = ring_strain<T, SM_CX>(uk, vk, wk, co + r * SM_CX, dxi,
                                         dyi, dzci_c, dzci_m, dzfi_c);
      // the running minimum over the walls in the order x, y, z, a later
      // wall serving only where strictly nearer: taken from z back to x,
      // an earlier wall serving where it is no farther
      bool any = have_zwalls;
      T tauw = lo_k ? tlo[r] : thi[r];
      T dist = dw_k;
      if (YM == Y_WALLS && !(any && dist < dy[r])) {
        tauw = ty_k[r];
        dist = dy[r];
        any = true;
      }
      if (tx_w != nullptr && !(any && dist < dxw)) {
        tauw = tx_w[static_cast<int64_t>(k) * ny + r];
        dist = dxw;
        any = true;
      }
      so[k * plane + idx + r * nx] =
          any ? van_driest_nut(s0, csd2_k, dist, tauw, visc) : csd2_k * s0;
    }
    if (k + 1 < k1) profiles(k + 1);
    cp_async_wait<1>();   // plane k+2, for step k+1
    __syncthreads();
  }
}

template <typename T>
int launch_smag(const T* u, const T* v, const T* w, const T* ue, const T* ve,
                const T* we, const T* dzci, const T* dzfi, const T* csd2,
                const T* dw, const T* nearlo, const T* tauw_lo,
                const T* tauw_hi, const T* dwy, const T* nearylo,
                const T* tauw_ylo, const T* tauw_yhi, const T* dwx,
                const T* nearxlo, const T* tauw_xlo, const T* tauw_xhi,
                T* so, const T* const* h, const T* const* x, int nz, int ny,
                int nx, int ymode, int xhalo, int have_zwalls, double dxi,
                double dyi, double visc, void* stream) {
  // ymode: Y_PERIODIC, Y_WALLS (h the y-row stacks, and the y walls' van
  // Driest inputs) or Y_HALO (h the halos); x the x stacks of u, v, w
  // with x walls (periodic y, y walls or a slab; nyc = ny + 2 with y
  // walls and on a slab), all null with periodic x, and the x walls' van
  // Driest inputs, all null where no x face is a wall; with xhalo x the x
  // halo stacks of a pencil (nyc = ny + 2; any ymode), no x
  // wall's inputs
  const bool rows = ymode != Y_PERIODIC;
  const bool xw = x[0] != nullptr;
  for (int m = 0; m < 6; ++m)
    if ((h[m] != nullptr) != rows || (x[m] != nullptr) != xw)
      return static_cast<int>(cudaErrorInvalidValue);
  if (ymode == Y_WALLS && (dwy == nullptr || nearylo == nullptr ||
                           tauw_ylo == nullptr || tauw_yhi == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool xd = dwx != nullptr;
  if ((xd && !xw) || xd != (nearxlo != nullptr) ||
      xd != (tauw_xlo != nullptr) || xd != (tauw_xhi != nullptr) ||
      (xhalo && (!xw || xd)))
    return static_cast<int>(cudaErrorInvalidValue);
  const YRows<T> hu{h[0], h[1]}, hv{h[2], h[3]}, hw{h[4], h[5]};
  const YRows<T> xu{x[0], x[1]}, xv{x[2], x[3]}, xw_{x[4], x[5]};
  using G = SmGeo<T>;
  constexpr int TY = G::TY;
  const size_t smem = sizeof(T) * SM_RING * 3 * G::CPL;
  auto kern =
      xhalo ? (ymode == Y_HALO    ? &smag_kernel<T, Y_HALO, X_HALO>
               : ymode == Y_WALLS ? &smag_kernel<T, Y_WALLS, X_HALO>
                                  : &smag_kernel<T, Y_PERIODIC, X_HALO>)
      : xw  ? (ymode == Y_WALLS  ? &smag_kernel<T, Y_WALLS, X_WALLS>
               : ymode == Y_HALO ? &smag_kernel<T, Y_HALO, X_WALLS>
                                 : &smag_kernel<T, Y_PERIODIC, X_WALLS>)
      : ymode == Y_HALO  ? &smag_kernel<T, Y_HALO, X_PERIODIC>
      : ymode == Y_WALLS ? &smag_kernel<T, Y_WALLS, X_PERIODIC>
                         : &smag_kernel<T, Y_PERIODIC, X_PERIODIC>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // z chunks of at least SM_MIN_CHUNK planes, enough for SM_BLOCKS blocks
  const int tiles = ((ny + TY - 1) / TY) * ((nx + SM_TX - 1) / SM_TX);
  const int nch = std::max(1, std::min((SM_BLOCKS + tiles - 1) / tiles,
                                       nz / SM_MIN_CHUNK));
  const int kc = (nz + nch - 1) / nch;
  const dim3 grid(static_cast<unsigned>(tiles),
                  static_cast<unsigned>((nz + kc - 1) / kc));
  kern<<<grid, G::NT, smem, static_cast<cudaStream_t>(stream)>>>(
      u, v, w, ue, ve, we, dzci, dzfi, csd2, dw, nearlo, tauw_lo, tauw_hi,
      dwy, nearylo, tauw_ylo, tauw_yhi, dwx, nearxlo, tauw_xlo, tauw_xhi, so,
      hu, hv, hw, xu, xv, xw_, nz, ny, nx, kc, have_zwalls, T(dxi), T(dyi),
      T(visc));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cales

#define CALES_SMAG_ENTRY(NAME, T)                                             \
  extern "C" int NAME(const T* u, const T* v, const T* w, const T* ue,        \
                      const T* ve, const T* we, const T* dzci,                \
                      const T* dzfi, const T* csd2, const T* dw,              \
                      const T* nearlo, const T* tauw_lo, const T* tauw_hi,    \
                      const T* dwy, const T* nearylo, const T* tauw_ylo,      \
                      const T* tauw_yhi, const T* dwx, const T* nearxlo,      \
                      const T* tauw_xlo, const T* tauw_xhi, T* so,            \
                      const T* hur, const T* huc, const T* hvr,               \
                      const T* hvc, const T* hwr, const T* hwc,               \
                      const T* xur, const T* xuc, const T* xvr,               \
                      const T* xvc, const T* xwr, const T* xwc, int nz,       \
                      int ny, int nx, int ymode, int xhalo, int have_zwalls,  \
                      double dxi, double dyi, double visc, void* stream) {    \
    const T* const h[6] = {hur, huc, hvr, hvc, hwr, hwc};                     \
    const T* const x[6] = {xur, xuc, xvr, xvc, xwr, xwc};                     \
    return cales::launch_smag<T>(u, v, w, ue, ve, we, dzci, dzfi, csd2, dw,   \
                                 nearlo, tauw_lo, tauw_hi, dwy, nearylo,      \
                                 tauw_ylo, tauw_yhi, dwx, nearxlo, tauw_xlo,  \
                                 tauw_xhi, so, h, x, nz, ny, nx, ymode,       \
                                 xhalo, have_zwalls, dxi, dyi, visc, stream); \
  }

CALES_SMAG_ENTRY(cales_smag_f32, float)
CALES_SMAG_ENTRY(cales_smag_f64, double)
