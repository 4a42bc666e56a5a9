// Dynamic Smagorinsky, the grid level of the two passes (DS1).
//
// Replaces: cales_tpu/ops/pallas_dsmag.py fused_dsmag_level1 (body
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
//
// Design: dsmag.cu's stages A and B on the same tile and rings
// (dsmag_common.cuh): a block owns an 8 x 32 (y, x) tile and marches z; at
// step t it loads velocity plane t+1, forms A at plane t on the tile + a
// halo of 1 and the filtered velocity at plane t on the centre cells
// (written out at once: no ring, nothing reads it again here), then at
// plane t-1 filters the 15 A quantities and writes fm, lij and s0.  With y
// walls (template switch YW) the velocity's rows -1, ny-1 and ny load from
// the y-row stacks and A's y ghost rows are extrapolated after stage A.
// Shared memory: (9 * 12 * 36 + 48 * 10 * 34) words = 80,832 bytes in f32,
// 161,664 in f64.
//
// Bound on the H100: bytes.  It reads u, v, w and writes 16 fields: 19
// field streams, 2.55 GB at 512x256x256 f32, 0.761 ms at 3.35 TB/s.  The
// function needs about 326 operations a cell (the strain rate's 110 and 18
// filtered quantities at 12 each with the separable passes shared across
// the plane), 0.163 ms at 67 TFLOP/s f32.  This kernel filters each A
// quantity with 27 shared-memory reads per centre cell, as dsmag.cu does,
// and recomputes A on each tile's halo; that arithmetic, not the stores,
// decides its time.
#include "dsmag_common.cuh"

namespace cales {

template <typename T>
constexpr size_t dsmag_level1_smem_bytes() {
  return sizeof(T) * (9 * DS_VPL + 3 * DS_NA * DS_APL);
}

template <typename T, bool YW>
__global__ void __launch_bounds__(DS_NT) dsmag_level1_kernel(
    const T* __restrict__ u, const T* __restrict__ v, const T* __restrict__ w,
    const T* __restrict__ ue, const T* __restrict__ ve,
    const T* __restrict__ we, const T* __restrict__ dzci,
    const T* __restrict__ dzfi, T* __restrict__ out, DsYWalls<T> yw, int nz,
    int ny, int nx, int wall_lo, int wall_hi, T dxi, T dyi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const Vs = reinterpret_cast<T*>(smem_raw);   // [3 planes][3][VPL]
  T* const As = Vs + 9 * DS_VPL;                   // [3 planes][16][APL]
  const int gx = (nx + DS_TX - 1) / DS_TX;
  const int x0 = (blockIdx.x % gx) * DS_TX;
  const int y0 = (blockIdx.x / gx) * DS_TY;
  const int tid = threadIdx.x;
  const int64_t plane = static_cast<int64_t>(ny) * nx;
  const int64_t nall = nz * plane;     // one output field
  const T* const fld[3] = {u, v, w};
  const T* const edg[3] = {ue, ve, we};

  auto vel = [&](int kz, int c) { return Vs + (ring(kz) * 3 + c) * DS_VPL; };
  auto src = [&](int kz, int q) {
    return As + (ring(kz) * DS_NA + q) * DS_APL;
  };
  const DsTile g{x0, y0, nz, ny, nx, tid, plane};

  // this thread's centre cell
  const int cy = tid / DS_TX, cx = tid - cy * DS_TX;
  const int ao = (cy + 1) * DS_AX + cx + 1;
  const int vc = (cy + 2) * DS_VX + cx + 2;
  const int yc = y0 + cy;
  const bool inside = yc < ny && x0 + cx < nx;
  const int64_t cell = static_cast<int64_t>(yc) * nx + x0 + cx;

  // stage A at plane t on the tile + halo 1, the filtered velocity at the
  // centre
  auto stage_a = [&](int t) {
    const T dzci_c = dzci[t + 1], dzci_m = dzci[t], dzfi_c = dzfi[t + 1];
    for (int e = tid; e < DS_APL; e += DS_NT) {
      const int ay = e / DS_AX, ax = e - ay * DS_AX;
      const int vo = (ay + 1) * DS_VX + ax + 1;
      ds_source<T>(vel, src, t, e, vo, dxi, dyi, dzci_c, dzci_m, dzfi_c);
    }
    if (inside) {
      const bool ext_lo = wall_lo && t == 0, ext_hi = wall_hi && t == nz - 1;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        out[(6 + c) * nall + t * plane + cell] =
            ds_fvel<T, YW>(vel, t, c, vc, yc, ny, ext_lo, ext_hi);
    }
    if (YW && (y0 == 0 || y0 >= ny - DS_TY - 1)) {
      __syncthreads();
      ds_fix_src_y<T>(src, t, y0, ny, tid);
    }
  };

  // stage B at the centre of plane kc: fm, lij and s0
  auto stage_b = [&](int kc) {
    if (!inside) return;
    T fq[DS_NA - 1];
    ds_filtered<T>(src, kc, ao, nz, wall_lo, wall_hi, fq);
    const int64_t oc = kc * plane + cell;
    const int pa[6] = {6, 7, 8, 6, 6, 7}, pb[6] = {6, 7, 8, 7, 8, 8};
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      out[q * nall + oc] = fq[q];
      out[(9 + q) * nall + oc] = fq[9 + q] - fq[pa[q]] * fq[pb[q]];
    }
    out[15 * nall + oc] = src(kc, 15)[ao];
  };

  auto load = [&](int kz) { ds_load<T, YW>(vel, fld, edg, yw, g, kz); };
  load(-1);
  load(0);
  for (int t = 0; t <= nz; ++t) {
    __syncthreads();            // the previous step's readers are done
    if (t + 1 <= nz) load(t + 1);
    __syncthreads();
    if (t < nz) stage_a(t);
    __syncthreads();
    if (t >= 1) stage_b(t - 1);
  }
}

// y: the y-row stacks and corners of u, v, w (6 pointers), all null
// without y walls; out: the 16 fields (fm[6], fvel[3], lij[6], s0), each
// (nz, ny, nx), one after another.
template <typename T>
int launch_dsmag_level1(const T* u, const T* v, const T* w, const T* ue,
                        const T* ve, const T* we, const T* dzci,
                        const T* dzfi, T* out, const T* const* y, int nz,
                        int ny, int nx, int wall_lo, int wall_hi, double dxi,
                        double dyi, void* stream) {
  const bool ywall = y[0] != nullptr;
  if (nz < 2 || (ywall && ny < 4))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int m = 0; m < 6; ++m)
    if (ywall != (y[m] != nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = dsmag_level1_smem_bytes<T>();
  auto kern = ywall ? &dsmag_level1_kernel<T, true>
                    : &dsmag_level1_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nblk = ((ny + DS_TY - 1) / DS_TY) * ((nx + DS_TX - 1) / DS_TX);
  DsYWalls<T> yw{};
  for (int c = 0; c < 3; ++c) yw.vel[c] = YRows<T>{y[2 * c], y[2 * c + 1]};
  kern<<<nblk, DS_NT, smem, static_cast<cudaStream_t>(stream)>>>(
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
                      const T* ywc, int nz, int ny, int nx, int wall_lo,     \
                      int wall_hi, double dxi, double dyi, void* stream) {   \
    const T* const y[6] = {yur, yuc, yvr, yvc, ywr, ywc};                    \
    return cales::launch_dsmag_level1<T>(u, v, w, ue, ve, we, dzci, dzfi,    \
                                         out, y, nz, ny, nx, wall_lo,        \
                                         wall_hi, dxi, dyi, stream);         \
  }

CALES_DSMAG_LEVEL1_ENTRY(cales_dsmag_level1_f32, float)
CALES_DSMAG_LEVEL1_ENTRY(cales_dsmag_level1_f64, double)
