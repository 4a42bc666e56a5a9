// Dynamic Smagorinsky, the grid level of the two passes (DS1).
//
// Replaces: cales_tpu/ops/pallas_dsmag.py:537 fused_dsmag_level1 (body
// _ds1_kernel) on the single-device path.  From the post-correction fill
// (interiors + z-edge stacks, with y walls the y-row stacks) it writes 16
// fields, the intermediates of the test level (dsmag_level2.cu):
//   fm[6]   filt(|S| S_ij);
//   fvel[3] the filtered velocity, the wall-parallel components' ghosts
//           extrapolated at z and y walls (sgs.f90:682-767);
//   lij[6]  filt(uc_i uc_j) - filt(uc_i) filt(uc_j), the Leonard term
//           differenced in registers (sgs.f90:274-327);
//   s0      |S|.
// filt is the 27-point top-hat filter (sgs.f90:616-680).  The model, its
// ghost recipes and its plain twin: cales_torch/ops/kernels
// dsmag_level1_plain.  The fields are stored in the compute dtype (the TPU
// kernel's bf16 store of fm and lij is not carried over).
// Two slab modes for the y-slab mesh (the JAX package's fused_dsmag_level1
// with ystrips and per-shard wall flags, pallas_dsmag.py:537-605), template
// switches as dsmag.cu's:
//   YH       a slab with periodic y: the velocity tile's rows -2, -1, ny
//            and ny+1, and their z-edge entries, load from the neighbours'
//            two-row halo (parallel/mesh.halo_y); everything after the load
//            is the periodic kernel's;
//   YW + YH  a slab of a y-walled mesh: the rows -1, ny-1 and ny from the
//            slab's y-row stacks (boundary.slab_ystack: the wall recipe's
//            rows on a side it owns, the neighbours' rows elsewhere), -2 and
//            ny+1 from the halo, and the y-wall recipes (A's ghost rows, the
//            wall-parallel velocity's) on the owned sides only, two run-time
//            flags (ywall.lo, ywall.hi) read from shared memory.
// The 16 outputs are the slab's own rows.
// A third mode, XH, is a pencil of the 2D (gy, gx) mesh (periodic x and y
// sides, z walls; with YH on gy > 1, periodic y on gy = 1; the JAX
// package's fused_dsmag_level1 under its 2D shard_map): the velocity
// tile's columns -2, -1, nx and nx+1, at every row of the tile and with
// their z-edge entries, load from the x neighbours' two-deep halo (laid
// out as dsmag.cu's XH, dsmag_common.cuh ds_load), whose rows -2 .. ny+1
// came by the y exchange; everything after the load is the periodic
// kernel's.  The 16 outputs are the pencil's own cells.
//
// Design: dsmag.cu's z-march without its stage C, on the same tile, rings
// and stages (dsmag_common.cuh).  A block owns a TY x 32 (y, x) tile (TY =
// 16 in float32, 8 in float64) and marches z, one plane a step, with the
// test filter's x and y passes shared across the plane:
//   V   the velocity (3) on the tile + a halo of 2, a ring of 4 planes:
//       plane t+2 is copied in by cp.async while t-1 .. t+1 are read;
//   A   the 16 source quantities on the tile + a halo of 1, planes t-1 and
//       t (|S| is read at the centre, the 15 others are filtered);
//   XS  their x pass, one plane; the y pass goes to registers, one centre
//       cell a thread, and the z pass combines there: a thread keeps the
//       xy-filtered value of plane t-1 and the partial sum q(t-2) +
//       2 q(t-1) of each quantity;
//   XV, YV  the velocity's x pass (one plane) and its xy-filtered ring (3
//       planes), whose z pass at the centre is the filtered velocity.
// At step t the block starts the copy of velocity plane t+2, forms A at
// plane t and the velocity's x pass of plane t+1; then (one barrier) its y
// pass and A's x pass of plane t; then (one barrier, the copy waited for)
// each thread writes its centre cell's filtered velocity and |S| at plane
// t, and A's y and z passes give fm and lij at plane t-1.  Two barriers a
// plane; nothing is read after the second that the next step's first half
// writes (A's ring alternates planes, XS and YV are written after the next
// step's first barrier).
// Each output keeps the arithmetic of the first kernel's 27-read filter:
// x, then y, then z, each pass q (a + 2 b + c), the z and y ghost planes
// and rows of A and of the velocity formed before the x pass, and the z
// pass's last product kept out of the FMAs after it (ds_mul_rn), so that
// lij's filt(uc_i) filt(uc_j) fuses into its difference as before.  With y
// walls (template switch YW) the velocity's rows -1, ny-1 and ny load from
// the y-row stacks, and A's and the filtered velocity's y ghost rows are
// formed in the x passes, so an edge tile takes no pass or barrier of its
// own.  x wraps when a plane is loaded, and so does y without y walls; a
// ragged tile's outside cells are computed on wrapped data and not stored.
// Shared memory: V 4 x 3 VY x 36, A 2 x 16 AY x 34, XS 15 AY x 32, XV
// 3 VY x 34, YV 9 AY x 34 words: 177,648 bytes in f32 (TY 16), 201,184 in
// f64 (TY 8); one block (16 or 8 warps) an SM.
//
// Bound on the H100: bytes.  It reads u, v, w and writes 16 fields: 19
// field streams, 2.55 GB at 512x256x256 f32, 0.761 ms at 3.35 TB/s.  The
// function needs about 326 operations a cell (the strain rate's 110 and 18
// filtered quantities at 12 each with the separable passes shared across
// the plane), 0.163 ms at 67 TFLOP/s f32.  This kernel does stage A on the
// halo too (1.2x the cells in f32) and spends shared-memory traffic and
// latency with one block an SM, as dsmag.cu does.
#include "dsmag_common.cuh"

namespace cales {

// Shared memory, in words: V, A, XS, XV, YV.
template <typename T>
constexpr size_t dsmag_level1_smem_bytes() {
  using G = DsGeo<DsTy<T>::TY>;
  return sizeof(T) *
         (12 * G::VPL + 2 * DS_NA * G::APL + (DS_NA - 1) * G::AY * DS_TX +
          3 * G::VY * DS_AX + 9 * G::APL);
}

template <typename T, bool YW, bool YH = false, bool XH = false>
__global__ void __launch_bounds__(DsGeo<DsTy<T>::TY>::NT, 1)
    dsmag_level1_kernel(const T* __restrict__ u, const T* __restrict__ v,
                        const T* __restrict__ w, const T* __restrict__ ue,
                        const T* __restrict__ ve, const T* __restrict__ we,
                        const T* __restrict__ dzci,
                        const T* __restrict__ dzfi, T* __restrict__ out,
                        DsYWalls<T> yw, int nz, int ny, int nx, int wall_lo,
                        int wall_hi, T dxi, T dyi) {
  constexpr int TY = DsTy<T>::TY;
  using G = DsGeo<TY>;
  constexpr int NT = G::NT, APL = G::APL, NF = DS_NA - 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const Vs = reinterpret_cast<T*>(smem_raw);   // [4 planes][3][VPL]
  T* const As = Vs + 12 * G::VPL;                  // [2 planes][16][APL]
  T* const XS = As + 2 * DS_NA * APL;              // [15][AY][TX]
  T* const XV = XS + NF * G::AY * DS_TX;           // [3][VY][AX]
  T* const YV = XV + 3 * G::VY * DS_AX;            // [3 planes][3][APL]
  const int gx = (nx + DS_TX - 1) / DS_TX;
  const int x0 = (blockIdx.x % gx) * DS_TX;
  const int y0 = (blockIdx.x / gx) * TY;
  const int tid = threadIdx.x;
  const int64_t plane = static_cast<int64_t>(ny) * nx;
  const int64_t nall = nz * plane;     // one output field
  // the fields' pointers and the y-wall inputs, read from shared memory
  // where they are used rather than held in registers
  __shared__ const T* fld[3];
  __shared__ const T* edg[3];
  __shared__ DsYWalls<T> ywall;
  if (tid == 0) {
    fld[0] = u, fld[1] = v, fld[2] = w;
    edg[0] = ue, edg[1] = ve, edg[2] = we;
    ywall = yw;
  }
  __syncthreads();
  const T q4 = T(0.25), two = T(2);
  // the y walls of this field: both with YW, on a slab of a y-walled mesh
  // (YW and YH) the ones the slab holds
  auto ylo = [&]() { return YW && (!YH || ywall.lo != 0); };
  auto yhi = [&]() { return YW && (!YH || ywall.hi != 0); };

  auto vel = [&](int kz, int c) {
    return Vs + (((kz + 4) & 3) * 3 + c) * G::VPL;
  };
  auto src = [&](int kz, int q) { return As + ((kz & 1) * DS_NA + q) * APL; };
  auto yvel = [&](int kz, int c) { return YV + (ring(kz) * 3 + c) * APL; };

  const DsTile g{x0, y0, nz, ny, nx, tid, plane};
  auto load = [&](int kz) {
    ds_load<T, YW, TY, false, YH, XH>(vel, fld, edg, ywall, g, kz);
  };
  // the velocity's x and y passes of plane kz (a z ghost by mode)
  auto vel_x = [&](int kz, int mode) {
    if (mode == DS_GHOST_LO)
      ds_vel_x<T, YW, TY, DS_GHOST_LO>(vel, XV, kz, y0, ny, nz, tid, ylo(),
                                       yhi());
    else if (mode == DS_GHOST_HI)
      ds_vel_x<T, YW, TY, DS_GHOST_HI>(vel, XV, kz, y0, ny, nz, tid, ylo(),
                                       yhi());
    else
      ds_vel_x<T, YW, TY, DS_PLANE>(vel, XV, kz, y0, ny, nz, tid, ylo(),
                                    yhi());
  };
  auto vel_y = [&](int kz) { ds_vel_y<T, TY>(XV, yvel, kz, tid); };

  // stage A at plane t on the tile + halo 1; the cells past the first NT
  // go to the last warps, which load the fewest velocity cells
  auto stage_a = [&](int t) {
    const T dzci_c = dzci[t + 1], dzci_m = dzci[t], dzfi_c = dzfi[t + 1];
    for (int e = NT - 1 - tid; e < APL; e += NT) {
      const int ay = e / DS_AX, ax = e - ay * DS_AX;
      const int vo = (ay + 1) * DS_VX + ax + 1;
      ds_source<T>(vel, src, t, e, vo, dxi, dyi, dzci_c, dzci_m, dzfi_c);
    }
  };

  // this thread's centre cell
  const int cy = tid / DS_TX, cx = tid - cy * DS_TX;
  const int ao = (cy + 1) * DS_AX + cx + 1;
  const int yc = y0 + cy;
  const bool inside = yc < ny && x0 + cx < nx;
  const int64_t cell = static_cast<int64_t>(yc) * nx + x0 + cx;

  // the z pass in registers: zp the xy-filtered plane t-1, zs the partial
  // sum q(t-2) + 2 q(t-1), of each of the 15 quantities
  T zp[NF], zs[NF], fq[NF];
  load(-1);
  load(0);
  load(1);
  cp_async_wait<0>();
  __syncthreads();
  vel_x(-1, wall_lo ? DS_GHOST_LO : DS_PLANE);
  __syncthreads();
  vel_y(-1);
  __syncthreads();
  vel_x(0, DS_PLANE);
  __syncthreads();
  vel_y(0);
  __syncthreads();
  for (int t = 0; t <= nz; ++t) {
    if (t + 2 <= nz) load(t + 2);
    if (t < nz) stage_a(t);
    if (t + 1 <= nz)
      vel_x(t + 1, wall_hi && t + 1 == nz ? DS_GHOST_HI : DS_PLANE);
    __syncthreads();
    if (t + 1 <= nz) vel_y(t + 1);
    // A's x pass: plane t, at t = 1 the ghost below the first plane
    // first, after the last plane the ghost above it
    if (t == 1 && wall_lo) {
      ds_src_x<T, YW, TY, DS_GHOST_LO>(src, XS, 0, y0, ny, nz, tid, ylo(),
                                       yhi());
    } else if (t < nz) {
      ds_src_x<T, YW, TY, DS_PLANE>(src, XS, t, y0, ny, nz, tid, ylo(),
                                    yhi());
    } else if (wall_hi) {
      ds_src_x<T, YW, TY, DS_GHOST_HI>(src, XS, nz, y0, ny, nz, tid, ylo(),
                                       yhi());
    }
    cp_async_wait<0>();   // plane t+2 has landed, for step t+1
    __syncthreads();
    // the filtered velocity (the z pass of YV) and |S| at plane t
    if (t < nz && inside) {
      const int64_t oc = t * plane + cell;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        out[(6 + c) * nall + oc] = ds_pass(
            yvel(t - 1, c)[ao], yvel(t, c)[ao], yvel(t + 1, c)[ao]);
      out[15 * nall + oc] = src(t, NF)[ao];
    }
    T y[NF];
    if (t == 1 && wall_lo) {
      // zs = ghost + 2 q(0), then plane 1's x pass
      ds_src_y<T, TY>(XS, cy, cx, y);
#pragma unroll
      for (int q = 0; q < NF; ++q) zs[q] = y[q] + two * zp[q];
      __syncthreads();
      ds_src_x<T, YW, TY, DS_PLANE>(src, XS, 1, y0, ny, nz, tid, ylo(),
                                    yhi());
      __syncthreads();
    }
    if (t < nz || wall_hi) {
      ds_src_y<T, TY>(XS, cy, cx, y);
    } else {
#pragma unroll
      for (int q = 0; q < NF; ++q) y[q] = zp[q];   // the copied top plane
    }
#pragma unroll
    for (int q = 0; q < NF; ++q) {
      if (t == 0) {
        if (!wall_lo) zs[q] = y[q] + two * y[q];   // the copied first plane
      } else {
        fq[q] = ds_mul_rn(q4, zs[q] + y[q]);
        zs[q] = zp[q] + two * y[q];
      }
      zp[q] = y[q];
    }
    // fm and lij at plane t-1
    if (t >= 1 && inside) {
      const int64_t oc = (t - 1) * plane + cell;
      const int pa[6] = {6, 7, 8, 6, 6, 7}, pb[6] = {6, 7, 8, 7, 8, 8};
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        out[q * nall + oc] = fq[q];
        out[(9 + q) * nall + oc] = fq[9 + q] - fq[pa[q]] * fq[pb[q]];
      }
    }
  }
}

// y: the y-row stacks and corners of u, v, w (6 pointers), all null
// without y walls; h: their two-deep halo pairs on a slab of the y-slab
// mesh (6 pointers, all null off a slab): h alone is mode YH, y and h
// together a slab of a y-walled mesh (YW + YH), whose y holds the slab's
// y-row stacks and ylo, yhi the walls it owns; x: their two-deep x halo
// pairs on a pencil of the 2D mesh (6 pointers, all null off a pencil;
// cols (nz, 4, ny+4), corners (3, 4, ny+4)): mode XH, no y walls, with h
// (YH) or periodic y; out: the 16 fields (fm[6], fvel[3], lij[6], s0),
// each (nz, ny, nx), one after another.
template <typename T>
int launch_dsmag_level1(const T* u, const T* v, const T* w, const T* ue,
                        const T* ve, const T* we, const T* dzci,
                        const T* dzfi, T* out, const T* const* y,
                        const T* const* h, const T* const* x, int nz,
                        int ny, int nx, int wall_lo, int wall_hi, int ylo,
                        int yhi, double dxi, double dyi, void* stream) {
  const bool ystacks = y[0] != nullptr;
  const bool halo = h[0] != nullptr;
  const bool xhalo = x[0] != nullptr;
  if (nz < 2 || (ystacks && !halo && ny < 4) || (halo && ny < 2) ||
      (xhalo && (nx < 2 || ystacks)))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int m = 0; m < 6; ++m)
    if (ystacks != (y[m] != nullptr) || halo != (h[m] != nullptr) ||
        xhalo != (x[m] != nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = dsmag_level1_smem_bytes<T>();
  auto kern = xhalo ? (halo ? &dsmag_level1_kernel<T, false, true, true>
                            : &dsmag_level1_kernel<T, false, false, true>)
              : halo ? (ystacks ? &dsmag_level1_kernel<T, true, true>
                                : &dsmag_level1_kernel<T, false, true>)
              : ystacks ? &dsmag_level1_kernel<T, true>
                        : &dsmag_level1_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int TY = DsTy<T>::TY;
  const int nblk = ((ny + TY - 1) / TY) * ((nx + DS_TX - 1) / DS_TX);
  DsYWalls<T> yw{};
  for (int c = 0; c < 3; ++c) {
    yw.vel[c] = YRows<T>{y[2 * c], y[2 * c + 1]};
    yw.hal[c] = YRows<T>{h[2 * c], h[2 * c + 1]};
    yw.xh[c] = YRows<T>{x[2 * c], x[2 * c + 1]};
  }
  yw.lo = halo ? ylo : 1;
  yw.hi = halo ? yhi : 1;
  kern<<<nblk, DsGeo<TY>::NT, smem, static_cast<cudaStream_t>(stream)>>>(
      u, v, w, ue, ve, we, dzci, dzfi, out, yw, nz, ny, nx, wall_lo, wall_hi,
      T(dxi), T(dyi));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cales

#define CALES_DSMAG_LEVEL1_ENTRY(NAME, T)                                    \
  extern "C" int NAME(const T* u, const T* v, const T* w, const T* ue,       \
                      const T* ve, const T* we, const T* dzci,               \
                      const T* dzfi, T* out, const T* yur, const T* yuc,     \
                      const T* yvr, const T* yvc, const T* ywr,              \
                      const T* ywc, const T* hur, const T* huc,              \
                      const T* hvr, const T* hvc, const T* hwr,              \
                      const T* hwc, const T* xur, const T* xuc,              \
                      const T* xvr, const T* xvc, const T* xwr,              \
                      const T* xwc, int nz, int ny, int nx, int wall_lo,     \
                      int wall_hi, int ylo, int yhi, double dxi, double dyi, \
                      void* stream) {                                        \
    const T* const y[6] = {yur, yuc, yvr, yvc, ywr, ywc};                    \
    const T* const h[6] = {hur, huc, hvr, hvc, hwr, hwc};                    \
    const T* const x[6] = {xur, xuc, xvr, xvc, xwr, xwc};                    \
    return cales::launch_dsmag_level1<T>(u, v, w, ue, ve, we, dzci, dzfi,    \
                                         out, y, h, x, nz, ny, nx, wall_lo,  \
                                         wall_hi, ylo, yhi, dxi, dyi,        \
                                         stream);                            \
  }

CALES_DSMAG_LEVEL1_ENTRY(cales_dsmag_level1_f32, float)
CALES_DSMAG_LEVEL1_ENTRY(cales_dsmag_level1_f64, double)
