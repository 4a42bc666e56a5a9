// Momentum RHS + low-storage RK3 update, one pass.
//
// Replaces: cales_tpu/ops/pallas_kernels.py fused_mom_rk (body _mom_kernel)
// on the single-device periodic-x/y path: previous-RHS reads skipped on the
// first substep (ruo == nullptr, f2 == 0), per-(z, tile) partial sums of
// the new u and v for the bulk forcing, and three template switches:
//   SGS    eddy-stress terms from visct (with_sgs); false for sgstype
//          'none', where s and se are null and never read;
//   YM     the y mode (common.cuh YMode): periodic; y walls (the duct and
//          cavity classes, ywalls=(True, True)), where the y ghost rows of
//          u, v, w, visct and p and v's rewrite row come from their y-row
//          stacks (common.cuh at<true>), as the TPU kernel's ye bundle
//          fixes them (pallas_kernels.py:617-628); or a slab of a y-sharded
//          mesh, where rows -1 and ny of the five fields come from their
//          halos (parallel/mesh.halo_y), as the TPU kernel's y strips
//          (_mom_kernel_sharded, cales_tpu/timeloop.py:1943-2078);
//   SPLIT  implicit diffusion with fold_cn, 0 none, 1 z only (split='1d':
//          ru = advection + xy diffusion is the stored explicit RHS, rud =
//          the z diffusion), 2 full-3D (split='xy+z': ru = advection, rud =
//          the xy and z diffusion, pallas_kernels.py:641-649); the kernel
//          emits the Crank-Nicolson RHS u + 1/2 f12 rud directly, while the
//          forcing sums measure the full prediction u + f12 rud
//          (pallas_kernels.py:671-684);
//   XM     the x mode (common.cuh XMode): periodic; X_WALLS, x walls
//          (the developing channel, the closed box, the lid-driven
//          cavity and the developing duct, and their LES; with or without
//          visct, with YM periodic, y walls or a slab, and with SPLIT 1
//          and YM periodic or a slab): the tile's halo columns -1 and nx
//          of u, v, w, p (and visct) come from their x stacks
//          (common.cuh xcol; with y walls the stacks carry the (y ghost,
//          x ghost) corners, and on a slab the neighbours' rows -1 and ny,
//          the corners where the halo rows meet the x ghost columns), as
//          the TPU kernel's xe bundle fixes them, y-sharded on the mesh
//          (cales_tpu timeloop.py:169-183, 1883-1924).  Only the first
//          and last tile column of blocks have such cells, and a cell's
//          source is found once, so the loads of every other block are
//          those of the periodic variant; or X_HALO, a pencil of a 2D
//          (gy, gx) mesh (the channel classes and the box with gx > 1;
//          with nu_t or without, each split, YM periodic or a slab; and
//          explicit with YM y walls, the duct and cavity classes on the
//          pencils): the same loads from the x halo stacks, which always
//          carry the rows -1 and ny (the JAX package's _xe_pack bundles
//          completed by the y halo, cales_tpu/timeloop.py:998-1015); with
//          y walls their rows -1 and ny on the walls the pencil's mesh row
//          holds are the x neighbours' wall rows, and v's row ny-1 there
//          its rewrite (cales_tpu _xe_wall_rows, _ystag_rw_gx), so the
//          (x +-1, y wall) corners load from the x halo as the cells of
//          the x ghost columns do, never from the y-row stack's own
//          columns, which wrap inside the pencil;
//   SCAL   the passive scalar (its own C entry, cales_mom_rk_scal_*; the
//          TPU kernel's has_scal stream, pallas_kernels.py:497-499,
//          661-667): one more cell-centred field in the ring, loaded as p
//          is (its z-edge stack, its y-row stack with y walls, its x
//          stack with x walls, each from the scalar's own BC letters and
//          values), its advection-diffusion RHS ds from the ring's u, v,
//          w and s planes (ops/stencil.scalar_rhs_core, scal.f90:14-51,
//          alpha = visc/pr) and its RK3 update s + f1 ds + f12 ssource
//          (+ f2 rso, skipped on the first substep with ruo,
//          rk.f90:123-195); periodic y, y walls, or a slab of the y-slab
//          mesh (Y_HALO, with each split: the scalar's halo rows -1 and
//          ny read as the velocity's, the TPU kernel's scalar window on the
//          y strips, cales_tpu/timeloop.py:1943-2078; with X_WALLS explicit or
//          split 1, its x stack carrying the neighbours' rows -1 and ny as
//          the velocity's, the scalar's xe columns in the y-sharded xe
//          bundle, cales_tpu timeloop.py:160-199), or a pencil of a 2D
//          mesh (X_HALO, with Y_HALO or periodic y, each split: the
//          scalar's x halo columns read as the velocity's).
// The formulas are cales_torch/ops/stencil.momentum_rhs_core term by term
// (reference mom.f90:17-309, rk.f90:77-94).
//
// Bound on the H100: memory.  About 14 field streams per call (read u, v,
// w, visct, p and ru_o, rv_o, rw_o; write u, v, w, ru, rv, rw): 1.9 GB at
// 512x256x256 f32, a 0.56 ms floor at the data sheet's 3.35 TB/s; 13
// without visct; the scalar adds four (read s and rso, write s and ds):
// 18, a 0.72 ms floor.  The stencil reads u, v, w and visct at up to 13
// neighbours on three z planes and p on two.
//
// Design: a z-march through shared memory, as correc_smag.cu's.  A block
// owns a TY x 32 (y, x) tile (TY = MomTy: 8 rows, 256 threads, in float32
// and float64) and marches z, one plane a step, with a ring of 5 planes of
// u, v, w, p (and visct) on the tile + a halo of 1 in shared memory,
// filled by cp.async three planes ahead: at step k it copies plane k+3
// into the slot of plane k-2, computes plane k from planes k-1, k and k+1
// and waits for plane k+2; one barrier a plane.  A plane is loaded as
// zrow reads it (z ghost planes -1 and nz and the rewrite row nz-1 from
// the edge stacks), x and y wrapped; with y walls or on a slab the tile's
// rows -1, ny-1 (walls) and ny come from the y-row stacks or the halos as
// the plane is loaded (common.cuh at<true> and aty<Y_HALO>), so the
// stencil has one code path for all three y modes.  A thread's cells of
// the halo tile, their wrapped offsets and their source (the field or its
// stack) are the same at every step: it finds them once.  The pointwise
// streams (ru_o, rv_o, rw_o and the six outputs) go straight between the
// thread and device memory, a warp a row of 32 cells.  The arithmetic of
// a cell is the same expressions in the same order (ptxas may fuse other
// mul/add pairs than in a thread-a-cell kernel).  The partial sums
// are per (z, tile): each warp's sum (a shuffle tree) goes to shared
// memory before the plane's barrier, and warp 0 (u) and warp 1 (v) add
// the warps' sums of that plane after it, in warp order.
// Shared memory: 5 planes x 5 fields x 10 x 34 values, 34,000 bytes in
// float32 with visct (27,200 without), 68,000 in float64; the scalar adds
// a sixth field (40,800 and 81,600 bytes with visct); 58-64
// registers in float32 with visct (four blocks an SM), 40-58 without.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (cales_torch.ab_dsmag,
// f32): 0.88 ms at 512x256x256 with visct (1.43 for a thread a cell
// reading device memory), 0.93 with y walls, 3.35 ms at 512^3 without
// visct (bound 2.08).  A tile of 16 rows was no faster.
#include "common.cuh"

namespace cales {

#define CALES_MOM_RK_PARAMS                                                   \
    const T* __restrict__ u, const T* __restrict__ v, const T* __restrict__ w,\
    const T* __restrict__ s, const T* __restrict__ p,                         \
    const T* __restrict__ ue, const T* __restrict__ ve,                       \
    const T* __restrict__ we, const T* __restrict__ se,                       \
    const T* __restrict__ pe, const T* __restrict__ ruo,                      \
    const T* __restrict__ rvo, const T* __restrict__ rwo,                     \
    const T* __restrict__ dzci, const T* __restrict__ dzfi,                   \
    T* __restrict__ uo, T* __restrict__ vo, T* __restrict__ wo,               \
    T* __restrict__ ruo_new, T* __restrict__ rvo_new, T* __restrict__ rwo_new,\
    T* __restrict__ usum, T* __restrict__ vsum, YRows<T> yu, YRows<T> yv,     \
    YRows<T> yw, YRows<T> ys, YRows<T> yp, YRows<T> xu, YRows<T> xv,          \
    YRows<T> xw, YRows<T> xs, YRows<T> xp, int nz, int ny, int nx, T f1,      \
    T f2, T visc, T dxi, T dyi, T bfx, T bfy, T bfz, ScalArgs<T> sc
// The passive scalar of the SCAL variant: the field and its z-edge stack,
// its previous RHS (null on the first substep), the new field and RHS, its
// y-row and x stack pairs (null with periodic y and x), its diffusivity
// visc/pr and source.
template <typename T>
struct ScalArgs {
  const T* s;
  const T* se;
  const T* rso;
  T* so;
  T* rs;
  YRows<T> ys, xs;
  T alpha, ssource;
};

// The explicit RHS r and the implicit part rd of one component from its
// advection (+ eddy stress) adv and molecular diffusion dxy, dz.
template <int SPLIT, typename T>
__device__ __forceinline__ void split_rhs(T adv, T dxy, T dz, T& r, T& rd) {
  if (SPLIT == 2) {
    r = adv;
    rd = dxy + dz;
  } else if (SPLIT == 1) {
    r = adv + dxy;
    rd = dz;
  } else {
    r = adv + dxy + dz;
    rd = dz;
  }
}


// The tile rows: 8 in float32 and float64 (256 threads a block).
template <typename T>
struct MomTy {
  static constexpr int TY = 8;
};

constexpr int MR_TX = 32;           // the tile's columns
constexpr int MR_CX = MR_TX + 2;    // with a halo of 1
constexpr int MR_RING = 5;          // planes in the ring

template <int TY>
struct MrGeo {
  static constexpr int NT = TY * MR_TX;
  static constexpr int NW = NT / 32;
  static constexpr int CPL = (TY + 2) * MR_CX;   // one field, one plane
};

// the ring's words, and then the warps' partial sums of two planes
template <typename T, int NF>
constexpr size_t mr_smem() {
  using G = MrGeo<MomTy<T>::TY>;
  return sizeof(T) * (MR_RING * NF * G::CPL + 4 * G::NW);
}

inline int mr_blocks(int ny, int nx, int ty) {
  return ((ny + ty - 1) / ty) * ((nx + MR_TX - 1) / MR_TX);
}

// Row r (0, 1, 2) of plane kz's y-row stack (walls) or row r (0, 1) of its
// halo (a slab), at column 0.
template <int YM, typename T>
__device__ __forceinline__ const T* ystack(const YRows<T>& y, int kz,
                                           int nz, int nx) {
  return YM == Y_WALLS ? yrow(y, kz, 0, nz, nx) : hrow(y, kz, 0, nz, nx);
}

template <typename T, bool SGS, int SPLIT, int YM, int XM, bool SCAL>
__global__ void __launch_bounds__(MrGeo<MomTy<T>::TY>::NT)
    mom_rk_kernel(CALES_MOM_RK_PARAMS) {
  constexpr int TY = MomTy<T>::TY;
  using G = MrGeo<TY>;
  constexpr int NT = G::NT, NW = G::NW, CPL = G::CPL;
  // u, v, w, p (, visct) (, the scalar, field SF)
  constexpr int SF = SGS ? 5 : 4;
  constexpr int NF = SF + (SCAL ? 1 : 0);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const R = reinterpret_cast<T*>(smem_raw);
  T* const part = R + MR_RING * NF * CPL;   // [2 planes][u, v][NW]
  const int gx = (nx + MR_TX - 1) / MR_TX;
  const int x0 = (blockIdx.x % gx) * MR_TX;
  const int y0 = (blockIdx.x / gx) * TY;
  const int tid = threadIdx.x;
  const int64_t plane = static_cast<int64_t>(ny) * nx;

  // ring plane kz (-1 .. nz): its fields NF x CPL
  auto ring = [&](int kz) { return R + ((kz + MR_RING) % MR_RING) * NF * CPL; };

  // this thread's cells of the halo tile (e = tid + i NT): the offset of
  // each in its plane of the field (>= 0), or ~ its offset in the plane's
  // y-row stack or halo (< 0), or with x walls in its x stack (ox[i]); x
  // and y wrapped
  constexpr int NC = (CPL + NT - 1) / NT;
  constexpr bool XW = XM != X_PERIODIC;
  // the x stacks carry the rows -1 and ny with y walls and on a slab,
  // the x halos always
  constexpr int NYC_PAD = YM != Y_PERIODIC || XM == X_HALO ? 2 : 0;
  int oc[NC];
  bool ox[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int e = tid + i * NT, ly = e / MR_CX, lx = e - ly * MR_CX;
    const int gy = y0 - 1 + ly, gx = x0 - 1 + lx, wx = wrap_near(gx, nx);
    ox[i] = XW && (gx == -1 || gx == nx);
    if (XW && ox[i]) {
      // column 0 (x = -1) or 2 (x = nx); rows past ny (a ragged last
      // tile's, never read) take row ny's
      const int jj = NYC_PAD ? min(gy, ny) + 1 : wrap_near(gy, ny);
      oc[i] = ~((gx < 0 ? 0 : 2) * (ny + NYC_PAD) + jj);
      continue;
    }
    int r = -1;                      // the stack row, or the field's
    if (YM == Y_WALLS)
      r = gy < 0 ? 0 : gy == ny - 1 ? 1 : gy == ny ? 2 : -1;
    else if (YM == Y_HALO)
      r = gy < 0 ? 0 : gy == ny ? 1 : -1;
    oc[i] = r >= 0 ? ~(r * nx + wx) : wrap_near(gy, ny) * nx + wx;
  }

  // the copy of plane kz (-1 .. nz, z-edge rows by zrow); one group a
  // plane, empty past nz
  auto load = [&](int kz) {
    if (kz <= nz) {
      const T* fb[6] = {zrow(u, ue, kz, nz, plane), zrow(v, ve, kz, nz, plane),
                        zrow(w, we, kz, nz, plane), zrow(p, pe, kz, nz, plane),
                        SGS ? zrow(s, se, kz, nz, plane) : nullptr, nullptr};
      if (SCAL) fb[SF] = zrow(sc.s, sc.se, kz, nz, plane);
      const T* yb[6] = {nullptr, nullptr, nullptr, nullptr, nullptr, nullptr};
      if (YM != Y_PERIODIC) {
        yb[0] = ystack<YM>(yu, kz, nz, nx);
        yb[1] = ystack<YM>(yv, kz, nz, nx);
        yb[2] = ystack<YM>(yw, kz, nz, nx);
        yb[3] = ystack<YM>(yp, kz, nz, nx);
        if (SGS) yb[4] = ystack<YM>(ys, kz, nz, nx);
        if (SCAL) yb[SF] = ystack<YM>(sc.ys, kz, nz, nx);
      }
      // the x stacks' column 0 of plane kz
      const T* xb[6] = {nullptr, nullptr, nullptr, nullptr, nullptr, nullptr};
      if (XW) {
        const int nyc = ny + NYC_PAD;
        xb[0] = yrow(xu, kz, 0, nz, nyc);
        xb[1] = yrow(xv, kz, 0, nz, nyc);
        xb[2] = yrow(xw, kz, 0, nz, nyc);
        xb[3] = yrow(xp, kz, 0, nz, nyc);
        if (SGS) xb[4] = yrow(xs, kz, 0, nz, nyc);
        if (SCAL) xb[SF] = yrow(sc.xs, kz, 0, nz, nyc);
      }
      T* const dst = ring(kz);
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int e = tid + i * NT;
        if (e >= CPL) continue;
        const int o = oc[i];
#pragma unroll
        for (int f = 0; f < NF; ++f)
          cp_async(dst + f * CPL + e,
                   o >= 0 ? fb[f] + o : (XW && ox[i] ? xb[f] : yb[f]) + ~o);
      }
    }
    cp_async_commit();
  };

  // warp 0 (u) and warp 1 (v) add the warps' partial sums of plane kz
  const int lane = tid & 31, warp = tid >> 5;
  auto store_sums = [&](int kz) {
    T* const sum = warp == 0 ? usum : vsum;
    if (warp < 2 && sum != nullptr) {
      T t = lane < NW ? part[((kz & 1) * 2 + warp) * NW + lane] : T(0);
      for (int o = 16; o > 0; o >>= 1)
        t += __shfl_down_sync(0xffffffffu, t, o);
      if (lane == 0)
        sum[static_cast<int64_t>(kz) * gridDim.x + blockIdx.x] = t;
    }
  };

  // this thread's cell
  const int ty = tid / MR_TX, tx = tid - ty * MR_TX;
  const int co = (ty + 1) * MR_CX + tx + 1;
  const bool inside = y0 + ty < ny && x0 + tx < nx;
  const int64_t idx = static_cast<int64_t>(y0 + ty) * nx + x0 + tx;

  load(-1);
  load(0);
  load(1);
  load(2);
  cp_async_wait<1>();   // planes -1, 0 and 1
  __syncthreads();
  for (int k = 0; k < nz; ++k) {
    load(k + 3);
    if (k > 0) store_sums(k - 1);
    T un = T(0), vn = T(0);
    if (inside) {
      const T* const pl[3] = {ring(k - 1) + co, ring(k) + co,
                              ring(k + 1) + co};
      const T q = T(0.25), two = T(2);
      const T dzci_c = dzci[k + 1], dzci_m = dzci[k];
      const T dzfi_c = dzfi[k + 1], dzfi_p = dzfi[k + 2];
#define MR_AT(f, dk, dj, di) pl[(dk) + 1][(f) * CPL + (dj) * MR_CX + (di)]
#define U(dk, dj, di) MR_AT(0, dk, dj, di)
#define V(dk, dj, di) MR_AT(1, dk, dj, di)
#define W(dk, dj, di) MR_AT(2, dk, dj, di)
#define P(dk, dj, di) MR_AT(3, dk, dj, di)
#define S(dk, dj, di) MR_AT(4, dk, dj, di)
      const T u_ccc = U(0, 0, 0), v_ccc = V(0, 0, 0), w_ccc = W(0, 0, 0);
      const T u_pcc = U(0, 0, 1), u_cpc = U(0, 1, 0), u_ccp = U(1, 0, 0);
      const T u_mcc = U(0, 0, -1);
      const T v_pcc = V(0, 0, 1), v_cmc = V(0, -1, 0);
      const T v_cpc = V(0, 1, 0), v_ccp = V(1, 0, 0);
      const T w_pcc = W(0, 0, 1), w_ccm = W(-1, 0, 0);
      const T w_cpc = W(0, 1, 0);
      T s_ccc = T(0), s_pcc = T(0), s_cpc = T(0), s_ccp = T(0);
      T visc_e_xy = T(0), visc_e_xz = T(0), visc_e_yz = T(0);
      if (SGS) {
        s_ccc = S(0, 0, 0);
        s_pcc = S(0, 0, 1);
        s_cpc = S(0, 1, 0);
        s_ccp = S(1, 0, 0);
        const T s_ppc = S(0, 1, 1), s_pcp = S(1, 0, 1), s_cpp = S(1, 1, 0);
        visc_e_xy = q * (s_ccc + s_pcc + s_cpc + s_ppc);
        visc_e_xz = q * (s_ccc + s_pcc + s_ccp + s_pcp);
        visc_e_yz = q * (s_ccc + s_cpc + s_ccp + s_cpp);
      }

      const T dudy_e = (u_cpc - u_ccc) * dyi;
      const T dudz_e = (u_ccp - u_ccc) * dzci_c;
      const T dvdx_e = (v_pcc - v_ccc) * dxi;
      const T dvdz_e = (v_ccp - v_ccc) * dzci_c;
      const T dwdx_e = (w_pcc - w_ccc) * dxi;
      const T dwdy_e = (w_cpc - w_ccc) * dyi;

      // ---- u momentum ----
      T ru, rud_u;
      {
        const T u_cmc = U(0, -1, 0), u_ccm = U(-1, 0, 0);
        const T v_pmc = V(0, -1, 1), w_pcm = W(-1, 0, 1);
        const T dudx_ip = (u_pcc - u_ccc) * dxi;
        const T dudx_im = (u_ccc - u_mcc) * dxi;
        const T dudy_jp = dudy_e;
        const T dudy_jm = (u_ccc - u_cmc) * dyi;
        const T dudz_kp = dudz_e;
        const T dudz_km = (u_ccc - u_ccm) * dzci_m;
        const T uu_ip = q * (u_pcc + u_ccc) * (u_ccc + u_pcc);
        const T uu_im = q * (u_mcc + u_ccc) * (u_ccc + u_mcc);
        const T vu_jp = q * (v_pcc + v_ccc) * (u_ccc + u_cpc);
        const T vu_jm = q * (v_pmc + v_cmc) * (u_ccc + u_cmc);
        const T wu_kp = q * (w_pcc + w_ccc) * (u_ccc + u_ccp);
        const T wu_km = q * (w_pcm + w_ccm) * (u_ccc + u_ccm);
        const T dudtd_xy =
            visc * ((dudx_ip - dudx_im) * dxi + (dudy_jp - dudy_jm) * dyi);
        const T dudtd_z = visc * (dudz_kp - dudz_km) * dzfi_c;
        T dudt = (-(uu_ip - uu_im) * dxi - (vu_jp - vu_jm) * dyi -
                  (wu_kp - wu_km) * dzfi_c);
        if (SGS) {
        const T s_cmc = S(0, -1, 0), s_pmc = S(0, -1, 1);
        const T s_ccm = S(-1, 0, 0), s_pcm = S(-1, 0, 1);
        const T visc_ip = s_pcc, visc_im = s_ccc;
        const T visc_jp = visc_e_xy;
        const T visc_jm = q * (s_ccc + s_pcc + s_cmc + s_pmc);
        const T visc_kp = visc_e_xz;
        const T visc_km = q * (s_ccc + s_pcc + s_ccm + s_pcm);
        const T dvdx_jp = dvdx_e;
        const T dvdx_jm = (v_pmc - v_cmc) * dxi;
        const T dwdx_kp = dwdx_e;
        const T dwdx_km = (w_pcm - w_ccm) * dxi;
        dudt = (dudt +
                (visc_ip * two * dudx_ip - visc_im * two * dudx_im) * dxi +
                (visc_jp * (dudy_jp + dvdx_jp) - visc_jm * (dudy_jm + dvdx_jm)) *
                    dyi +
                (visc_kp * (dudz_kp + dwdx_kp) - visc_km * (dudz_km + dwdx_km)) *
                    dzfi_c);
        }
        split_rhs<SPLIT>(dudt, dudtd_xy, dudtd_z, ru, rud_u);
      }

      // ---- v momentum ----
      T rv, rud_v;
      {
        const T v_mcc = V(0, 0, -1), v_ccm = V(-1, 0, 0);
        const T u_mpc = U(0, 1, -1), w_cpm = W(-1, 1, 0);
        const T dvdx_ip = dvdx_e;
        const T dvdx_im = (v_ccc - v_mcc) * dxi;
        const T dvdy_jp = (v_cpc - v_ccc) * dyi;
        const T dvdy_jm = (v_ccc - v_cmc) * dyi;
        const T dvdz_kp = dvdz_e;
        const T dvdz_km = (v_ccc - v_ccm) * dzci_m;
        const T uv_ip = q * (u_ccc + u_cpc) * (v_ccc + v_pcc);
        const T uv_im = q * (u_mcc + u_mpc) * (v_ccc + v_mcc);
        const T vv_jp = q * (v_ccc + v_cpc) * (v_ccc + v_cpc);
        const T vv_jm = q * (v_ccc + v_cmc) * (v_ccc + v_cmc);
        const T wv_kp = q * (w_ccc + w_cpc) * (v_ccc + v_ccp);
        const T wv_km = q * (w_ccm + w_cpm) * (v_ccc + v_ccm);
        const T dvdtd_xy =
            visc * ((dvdx_ip - dvdx_im) * dxi + (dvdy_jp - dvdy_jm) * dyi);
        const T dvdtd_z = visc * (dvdz_kp - dvdz_km) * dzfi_c;
        T dvdt = (-(uv_ip - uv_im) * dxi - (vv_jp - vv_jm) * dyi -
                  (wv_kp - wv_km) * dzfi_c);
        if (SGS) {
        const T s_mcc = S(0, 0, -1), s_mpc = S(0, 1, -1);
        const T s_cpm = S(-1, 1, 0), s_ccm_v = S(-1, 0, 0);
        const T visc_ip = visc_e_xy;
        const T visc_im = q * (s_ccc + s_cpc + s_mcc + s_mpc);
        const T visc_jp = s_cpc, visc_jm = s_ccc;
        const T visc_kp = visc_e_yz;
        const T visc_km = q * (s_ccc + s_cpc + s_ccm_v + s_cpm);
        const T dudy_ip = dudy_e;
        const T dudy_im = (u_mpc - u_mcc) * dyi;
        const T dwdy_kp = dwdy_e;
        const T dwdy_km = (w_cpm - w_ccm) * dyi;
        dvdt = (dvdt +
                (visc_ip * (dvdx_ip + dudy_ip) - visc_im * (dvdx_im + dudy_im)) *
                    dxi +
                (visc_jp * two * dvdy_jp - visc_jm * two * dvdy_jm) * dyi +
                (visc_kp * (dvdz_kp + dwdy_kp) - visc_km * (dvdz_km + dwdy_km)) *
                    dzfi_c);
        }
        split_rhs<SPLIT>(dvdt, dvdtd_xy, dvdtd_z, rv, rud_v);
      }

      // ---- w momentum ----
      T rw, rud_w;
      {
        const T w_mcc = W(0, 0, -1), w_cmc = W(0, -1, 0), w_ccp = W(1, 0, 0);
        const T u_mcp = U(1, 0, -1), v_cmp = V(1, -1, 0);
        const T dwdx_ip = dwdx_e;
        const T dwdx_im = (w_ccc - w_mcc) * dxi;
        const T dwdy_jp = dwdy_e;
        const T dwdy_jm = (w_ccc - w_cmc) * dyi;
        const T dwdz_kp = (w_ccp - w_ccc) * dzfi_p;
        const T dwdz_km = (w_ccc - w_ccm) * dzfi_c;
        const T uw_ip = q * (u_ccc + u_ccp) * (w_ccc + w_pcc);
        const T uw_im = q * (u_mcc + u_mcp) * (w_ccc + w_mcc);
        const T vw_jp = q * (v_ccc + v_ccp) * (w_ccc + w_cpc);
        const T vw_jm = q * (v_cmc + v_cmp) * (w_ccc + w_cmc);
        const T ww_kp = q * (w_ccc + w_ccp) * (w_ccc + w_ccp);
        const T ww_km = q * (w_ccc + w_ccm) * (w_ccc + w_ccm);
        const T dwdtd_xy =
            visc * ((dwdx_ip - dwdx_im) * dxi + (dwdy_jp - dwdy_jm) * dyi);
        const T dwdtd_z = visc * (dwdz_kp - dwdz_km) * dzci_c;
        T dwdt = (-(uw_ip - uw_im) * dxi - (vw_jp - vw_jm) * dyi -
                  (ww_kp - ww_km) * dzci_c);
        if (SGS) {
        const T s_mcc_w = S(0, 0, -1), s_mcp = S(1, 0, -1);
        const T s_cmp = S(1, -1, 0), s_cmc2 = S(0, -1, 0);
        const T visc_ip = visc_e_xz;
        const T visc_im = q * (s_ccc + s_ccp + s_mcc_w + s_mcp);
        const T visc_jp = visc_e_yz;
        const T visc_jm = q * (s_ccc + s_ccp + s_cmc2 + s_cmp);
        const T visc_kp = s_ccp, visc_km = s_ccc;
        const T dudz_ip = dudz_e;
        const T dudz_im = (u_mcp - u_mcc) * dzci_c;
        const T dvdz_jp = dvdz_e;
        const T dvdz_jm = (v_cmp - v_cmc) * dzci_c;
        dwdt = (dwdt +
                (visc_ip * (dwdx_ip + dudz_ip) - visc_im * (dwdx_im + dudz_im)) *
                    dxi +
                (visc_jp * (dwdy_jp + dvdz_jp) - visc_jm * (dwdy_jm + dvdz_jm)) *
                    dyi +
                (visc_kp * two * dwdz_kp - visc_km * two * dwdz_km) * dzci_c);
        }
        split_rhs<SPLIT>(dwdt, dwdtd_xy, dwdtd_z, rw, rud_w);
      }

      // ---- RK3 update with -grad p and the body force (rk.f90:77-94) ----
      const T pc = P(0, 0, 0);
      const T gpx = dxi * (P(0, 0, 1) - pc);
      const T gpy = dyi * (P(0, 1, 0) - pc);
      const T gpz = dzci_c * (P(1, 0, 0) - pc);
#undef U
#undef V
#undef W
#undef S
#undef P
#undef MR_AT
      const T f12 = f1 + f2;
      un = u_ccc + f1 * ru + f12 * (bfx - gpx);
      vn = v_ccc + f1 * rv + f12 * (bfy - gpy);
      T wn = w_ccc + f1 * rw + f12 * (bfz - gpz);
      const int64_t o = static_cast<int64_t>(k) * plane + idx;
      if (ruo != nullptr) {
        un = un + f2 * ruo[o];
        vn = vn + f2 * rvo[o];
        wn = wn + f2 * rwo[o];
      }
      if (SPLIT != 0) {
        // the CN fold: store the Crank-Nicolson RHS; the sums (un, vn from
        // here on) see the full prediction
        const T h = T(0.5) * f12;
        uo[o] = un + h * rud_u;
        vo[o] = vn + h * rud_v;
        wo[o] = wn + h * rud_w;
        un = un + f12 * rud_u;
        vn = vn + f12 * rud_v;
      } else {
        uo[o] = un;
        vo[o] = vn;
        wo[o] = wn;
      }
      ruo_new[o] = ru;
      rvo_new[o] = rv;
      rwo_new[o] = rw;
      if (SCAL) {
        // the scalar's RHS and update from the ring's planes, in
        // scalar_rhs_core's order (scal.f90:14-51, rk.f90:123-195)
#define MR_AT(f, dk, dj, di) pl[(dk) + 1][(f) * CPL + (dj) * MR_CX + (di)]
#define C(dk, dj, di) MR_AT(SF, dk, dj, di)
        const T h = T(0.5);
        const T sc_c = C(0, 0, 0);
        const T sc_m = C(0, 0, -1), sc_p = C(0, 0, 1);
        const T sc_jm = C(0, -1, 0), sc_jp = C(0, 1, 0);
        const T sc_km = C(-1, 0, 0), sc_kp = C(1, 0, 0);
        const T usim = h * (sc_m + sc_c) * MR_AT(0, 0, 0, -1);
        const T usip = h * (sc_p + sc_c) * MR_AT(0, 0, 0, 0);
        const T vsjm = h * (sc_jm + sc_c) * MR_AT(1, 0, -1, 0);
        const T vsjp = h * (sc_jp + sc_c) * MR_AT(1, 0, 0, 0);
        const T wskm = h * (sc_km + sc_c) * MR_AT(2, -1, 0, 0);
        const T wskp = h * (sc_kp + sc_c) * MR_AT(2, 0, 0, 0);
#undef C
#undef MR_AT
        const T dsdxp = (sc_p - sc_c) * dxi, dsdxm = (sc_c - sc_m) * dxi;
        const T dsdyp = (sc_jp - sc_c) * dyi, dsdym = (sc_c - sc_jm) * dyi;
        const T dsdzp = (sc_kp - sc_c) * dzci_c;
        const T dsdzm = (sc_c - sc_km) * dzci_m;
        const T alpha = sc.alpha;
        const T ds = dxi * (-usip + usim) + (dsdxp - dsdxm) * alpha * dxi +
                     dyi * (-vsjp + vsjm) + (dsdyp - dsdym) * alpha * dyi +
                     dzfi_c * (-wskp + wskm) +
                     (dsdzp - dsdzm) * alpha * dzfi_c;
        T sn = sc_c + f1 * ds + f12 * sc.ssource;
        if (sc.rso != nullptr) sn = sn + f2 * sc.rso[o];
        sc.so[o] = sn;
        sc.rs[o] = ds;
      }
    }
    // the warps' partial sums of the new (full-prediction) u and v
    if (usum != nullptr || vsum != nullptr) {
      for (int o = 16; o > 0; o >>= 1) {
        un += __shfl_down_sync(0xffffffffu, un, o);
        vn += __shfl_down_sync(0xffffffffu, vn, o);
      }
      if (lane == 0) {
        part[((k & 1) * 2) * NW + warp] = un;
        part[((k & 1) * 2 + 1) * NW + warp] = vn;
      }
    }
    cp_async_wait<1>();   // plane k+2, for step k+1
    __syncthreads();
  }
  store_sums(nz - 1);
}
#undef CALES_MOM_RK_PARAMS

template <typename T>
using MomKernel = void (*)(const T*, const T*, const T*, const T*, const T*,
                           const T*, const T*, const T*, const T*, const T*,
                           const T*, const T*, const T*, const T*, const T*,
                           T*, T*, T*, T*, T*, T*, T*, T*, YRows<T>, YRows<T>,
                           YRows<T>, YRows<T>, YRows<T>, YRows<T>, YRows<T>,
                           YRows<T>, YRows<T>, YRows<T>, int, int, int, T, T,
                           T, T, T, T, T, T, ScalArgs<T>);

template <typename T, bool SGS, int SPLIT>
MomKernel<T> pick_mom_rk(int ym) {
  constexpr int XP = X_PERIODIC;
  return ym == Y_HALO    ? &mom_rk_kernel<T, SGS, SPLIT, Y_HALO, XP, false>
         : ym == Y_WALLS ? &mom_rk_kernel<T, SGS, SPLIT, Y_WALLS, XP, false>
                         : &mom_rk_kernel<T, SGS, SPLIT, Y_PERIODIC, XP, false>;
}

// the x-walled variants: explicit with periodic y or y walls, split '1d'
// with periodic y; on a slab of the y-slab mesh explicit or split '1d'
template <typename T, bool SGS>
MomKernel<T> pick_mom_rk_xw(int ym, int split) {
  constexpr int XW = X_WALLS;
  if (ym == Y_HALO)
    return split == 1 ? &mom_rk_kernel<T, SGS, 1, Y_HALO, XW, false>
                      : &mom_rk_kernel<T, SGS, 0, Y_HALO, XW, false>;
  return split == 1      ? &mom_rk_kernel<T, SGS, 1, Y_PERIODIC, XW, false>
         : ym == Y_WALLS ? &mom_rk_kernel<T, SGS, 0, Y_WALLS, XW, false>
                         : &mom_rk_kernel<T, SGS, 0, Y_PERIODIC, XW, false>;
}

// the x-halo variants (a pencil of a 2D mesh): each split (explicit,
// '1d', 'xy+z'), on a slab of the mesh's y rows or with periodic y (gy =
// 1); explicit with y walls
template <typename T, bool SGS>
MomKernel<T> pick_mom_rk_xh(int ym, int split) {
  constexpr int XH = X_HALO;
  if (ym == Y_WALLS) return &mom_rk_kernel<T, SGS, 0, Y_WALLS, XH, false>;
  if (ym == Y_HALO)
    return split == 2   ? &mom_rk_kernel<T, SGS, 2, Y_HALO, XH, false>
           : split == 1 ? &mom_rk_kernel<T, SGS, 1, Y_HALO, XH, false>
                        : &mom_rk_kernel<T, SGS, 0, Y_HALO, XH, false>;
  return split == 2   ? &mom_rk_kernel<T, SGS, 2, Y_PERIODIC, XH, false>
         : split == 1 ? &mom_rk_kernel<T, SGS, 1, Y_PERIODIC, XH, false>
                      : &mom_rk_kernel<T, SGS, 0, Y_PERIODIC, XH, false>;
}

// the scalar variants, what the slice runs with a scalar: periodic y with
// each split, y walls explicit, x walls as pick_mom_rk_xw (on a slab of
// the y-slab mesh explicit or split '1d'), a slab of the y-slab mesh
// with each split, and a pencil of a 2D mesh (xhalo: X_HALO, on a slab
// of its y rows or with periodic y, each split; with y walls explicit)
template <typename T, bool SGS>
MomKernel<T> pick_mom_rk_scal(int ym, int split, bool xw, bool xhalo) {
  constexpr int XP = X_PERIODIC, XW = X_WALLS, XH = X_HALO;
  if (xhalo && ym == Y_WALLS)
    return &mom_rk_kernel<T, SGS, 0, Y_WALLS, XH, true>;
  if (xhalo && ym == Y_HALO)
    return split == 2   ? &mom_rk_kernel<T, SGS, 2, Y_HALO, XH, true>
           : split == 1 ? &mom_rk_kernel<T, SGS, 1, Y_HALO, XH, true>
                        : &mom_rk_kernel<T, SGS, 0, Y_HALO, XH, true>;
  if (xhalo)
    return split == 2   ? &mom_rk_kernel<T, SGS, 2, Y_PERIODIC, XH, true>
           : split == 1 ? &mom_rk_kernel<T, SGS, 1, Y_PERIODIC, XH, true>
                        : &mom_rk_kernel<T, SGS, 0, Y_PERIODIC, XH, true>;
  if (xw && ym == Y_HALO)
    return split == 1 ? &mom_rk_kernel<T, SGS, 1, Y_HALO, XW, true>
                      : &mom_rk_kernel<T, SGS, 0, Y_HALO, XW, true>;
  if (xw)
    return split == 1      ? &mom_rk_kernel<T, SGS, 1, Y_PERIODIC, XW, true>
           : ym == Y_WALLS ? &mom_rk_kernel<T, SGS, 0, Y_WALLS, XW, true>
                           : &mom_rk_kernel<T, SGS, 0, Y_PERIODIC, XW, true>;
  if (ym == Y_HALO)
    return split == 2   ? &mom_rk_kernel<T, SGS, 2, Y_HALO, XP, true>
           : split == 1 ? &mom_rk_kernel<T, SGS, 1, Y_HALO, XP, true>
                        : &mom_rk_kernel<T, SGS, 0, Y_HALO, XP, true>;
  if (ym == Y_WALLS) return &mom_rk_kernel<T, SGS, 0, Y_WALLS, XP, true>;
  return split == 2   ? &mom_rk_kernel<T, SGS, 2, Y_PERIODIC, XP, true>
         : split == 1 ? &mom_rk_kernel<T, SGS, 1, Y_PERIODIC, XP, true>
                      : &mom_rk_kernel<T, SGS, 0, Y_PERIODIC, XP, true>;
}

// y: the y-row stacks and corners of u, v, w, visct, p, in that order (10
// pointers, all null with periodic y; visct's null without visct); with
// halo set they are the slab's halos (rows (nz, 2, nx), corners
// (3, 2, nx)) instead; then the x stacks and corners of the same five
// fields (10 pointers, all null with periodic x; visct's null without
// visct; nyc = ny + 2 with y walls and on a slab, whose stacks carry the
// rows -1 and ny; x walls run with split 0 or, with periodic y or on a
// slab, 1); with xhalo set they are a pencil's x halo stacks (nyc = ny +
// 2; any split, periodic y or a slab; with y walls, halo unset, split
// 0).  sc: the passive scalar (the SCAL
// variants), or null: its field, edge stack and outputs set, its
// previous RHS with ruo, its y-row and x stack pairs with the velocity's
// (on a slab its halo pair, with any split, and with x walls its x stack
// pair with the neighbours' rows as the velocity's; on a pencil its x
// halo pair, with any split).
template <typename T>
int launch_mom_rk(const T* u, const T* v, const T* w, const T* s, const T* p,
                  const T* ue, const T* ve, const T* we, const T* se,
                  const T* pe, const T* ruo, const T* rvo, const T* rwo,
                  const T* dzci, const T* dzfi, T* uo, T* vo, T* wo, T* ru,
                  T* rv, T* rw, T* usum, T* vsum, const T* const* y, int nz,
                  int ny, int nx, int split, int halo, int xhalo,
                  double f1, double f2,
                  double visc, double dxi, double dyi, double bfx,
                  double bfy, double bfz, const ScalArgs<T>* sc,
                  void* stream) {
  const bool sgs = s != nullptr;
  const bool yw = y[0] != nullptr;
  const bool xw = y[10] != nullptr;
  if (sgs != (se != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (sc != nullptr &&
      (sc->s == nullptr || sc->se == nullptr || sc->so == nullptr ||
       sc->rs == nullptr || (sc->rso == nullptr) != (ruo == nullptr) ||
       yw != (sc->ys.rows != nullptr && sc->ys.corners != nullptr) ||
       xw != (sc->xs.rows != nullptr && sc->xs.corners != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int m = 0; m < 20; ++m) {
    const bool want = (m < 10 ? yw : xw) && (sgs || m % 10 / 2 != 3);
    if (want != (y[m] != nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const YRows<T> yu{y[0], y[1]}, yv{y[2], y[3]}, yw_{y[4], y[5]},
      ys{y[6], y[7]}, yp{y[8], y[9]}, xu{y[10], y[11]}, xv{y[12], y[13]},
      xw_{y[14], y[15]}, xs{y[16], y[17]}, xp{y[18], y[19]};
  if (split < 0 || split > 2 || (halo && !yw) ||
      (xw && !xhalo && (split == 2 || (split == 1 && yw && !halo))) ||
      (xhalo && (!xw || (yw && !halo && split != 0))))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ym = !yw ? Y_PERIODIC : halo ? Y_HALO : Y_WALLS;
  // y walls with the scalar run explicit
  if (sc != nullptr && ym == Y_WALLS && split != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const MomKernel<T> kern =
      sc != nullptr
          ? (sgs ? pick_mom_rk_scal<T, true>(ym, split, xw, xhalo)
                 : pick_mom_rk_scal<T, false>(ym, split, xw, xhalo))
      : xhalo ? (sgs ? pick_mom_rk_xh<T, true>(ym, split)
                     : pick_mom_rk_xh<T, false>(ym, split))
      : xw ? (sgs ? pick_mom_rk_xw<T, true>(ym, split)
                  : pick_mom_rk_xw<T, false>(ym, split))
      : sgs ? (split == 2   ? pick_mom_rk<T, true, 2>(ym)
               : split == 1 ? pick_mom_rk<T, true, 1>(ym)
                            : pick_mom_rk<T, true, 0>(ym))
            : (split == 2   ? pick_mom_rk<T, false, 2>(ym)
               : split == 1 ? pick_mom_rk<T, false, 1>(ym)
                            : pick_mom_rk<T, false, 0>(ym));
  constexpr int TY = MomTy<T>::TY;
  const int nf = (sgs ? 5 : 4) + (sc != nullptr ? 1 : 0);
  const size_t smem = nf == 6   ? mr_smem<T, 6>()
                      : nf == 5 ? mr_smem<T, 5>()
                                : mr_smem<T, 4>();
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<mr_blocks(ny, nx, TY), MrGeo<TY>::NT, smem,
         static_cast<cudaStream_t>(stream)>>>(
      u, v, w, s, p, ue, ve, we, se, pe, ruo, rvo, rwo, dzci, dzfi, uo, vo,
      wo, ru, rv, rw, usum, vsum, yu, yv, yw_, ys, yp, xu, xv, xw_, xs, xp,
      nz, ny, nx, T(f1),
      T(f2), T(visc), T(dxi), T(dyi), T(bfx), T(bfy), T(bfz),
      sc != nullptr ? *sc : ScalArgs<T>{});
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cales

#define CALES_MOM_RK_ENTRY(NAME, T)                                           \
  extern "C" int NAME(                                                        \
      const T* u, const T* v, const T* w, const T* s, const T* p,             \
      const T* ue, const T* ve, const T* we, const T* se, const T* pe,        \
      const T* ruo, const T* rvo, const T* rwo, const T* dzci,                \
      const T* dzfi, T* uo, T* vo, T* wo, T* ru, T* rv, T* rw, T* usum,       \
      T* vsum, const T* yur, const T* yuc, const T* yvr, const T* yvc,        \
      const T* ywr, const T* ywc, const T* ysr, const T* ysc,                 \
      const T* ypr, const T* ypc, const T* xur, const T* xuc, const T* xvr,   \
      const T* xvc, const T* xwr, const T* xwc, const T* xsr, const T* xsc,   \
      const T* xpr, const T* xpc, int nz, int ny, int nx, int split,          \
      int halo, int xhalo, double f1, double f2, double visc, double dxi,     \
      double dyi, double bfx, double bfy, double bfz, void* stream) {         \
    const T* const y[20] = {yur, yuc, yvr, yvc, ywr, ywc, ysr, ysc, ypr,      \
                            ypc, xur, xuc, xvr, xvc, xwr, xwc, xsr, xsc,      \
                            xpr, xpc};                                        \
    return cales::launch_mom_rk<T>(u, v, w, s, p, ue, ve, we, se, pe, ruo,    \
                                   rvo, rwo, dzci, dzfi, uo, vo, wo, ru, rv,  \
                                   rw, usum, vsum, y, nz, ny, nx, split,      \
                                   halo, xhalo, f1, f2, visc, dxi, dyi, bfx,  \
                                   bfy, bfz, nullptr, stream);                \
  }

CALES_MOM_RK_ENTRY(cales_mom_rk_f32, float)
CALES_MOM_RK_ENTRY(cales_mom_rk_f64, double)

// The scalar variants: mom_rk's arguments, then the scalar's field, edge
// stack, previous RHS (null on the first substep), outputs s and ds, its
// y-row stack pair (null with periodic y; with halo set its halo pair on a
// slab) and x stack pair (null with periodic x), and its diffusivity and
// source.
#define CALES_MOM_RK_SCAL_ENTRY(NAME, T)                                      \
  extern "C" int NAME(                                                        \
      const T* u, const T* v, const T* w, const T* s, const T* p,             \
      const T* ue, const T* ve, const T* we, const T* se, const T* pe,        \
      const T* ruo, const T* rvo, const T* rwo, const T* dzci,                \
      const T* dzfi, T* uo, T* vo, T* wo, T* ru, T* rv, T* rw, T* usum,       \
      T* vsum, const T* yur, const T* yuc, const T* yvr, const T* yvc,        \
      const T* ywr, const T* ywc, const T* ysr, const T* ysc,                 \
      const T* ypr, const T* ypc, const T* xur, const T* xuc, const T* xvr,   \
      const T* xvc, const T* xwr, const T* xwc, const T* xsr, const T* xsc,   \
      const T* xpr, const T* xpc, const T* sca, const T* scae,                \
      const T* rso, T* so, T* rs, const T* ycr, const T* ycc,                 \
      const T* xcr, const T* xcc, int nz, int ny, int nx, int split,          \
      int halo, int xhalo, double f1, double f2, double visc, double dxi,     \
      double dyi, double bfx, double bfy, double bfz, double alpha,           \
      double ssource, void* stream) {                                         \
    const T* const y[20] = {yur, yuc, yvr, yvc, ywr, ywc, ysr, ysc, ypr,      \
                            ypc, xur, xuc, xvr, xvc, xwr, xwc, xsr, xsc,      \
                            xpr, xpc};                                        \
    const cales::ScalArgs<T> sc{sca,      scae,     rso,      so,             \
                                rs,       {ycr, ycc}, {xcr, xcc},             \
                                T(alpha), T(ssource)};                        \
    return cales::launch_mom_rk<T>(u, v, w, s, p, ue, ve, we, se, pe, ruo,    \
                                   rvo, rwo, dzci, dzfi, uo, vo, wo, ru, rv,  \
                                   rw, usum, vsum, y, nz, ny, nx, split,      \
                                   halo, xhalo, f1, f2, visc, dxi, dyi, bfx,  \
                                   bfy, bfz, &sc, stream);                    \
  }

CALES_MOM_RK_SCAL_ENTRY(cales_mom_rk_scal_f32, float)
CALES_MOM_RK_SCAL_ENTRY(cales_mom_rk_scal_f64, double)

// The length of a row of the partial sums usum and vsum: the tiles of a
// plane.
extern "C" int cales_mom_rk_blocks(int ny, int nx, int f64) {
  return cales::mr_blocks(ny, nx, f64 ? cales::MomTy<double>::TY
                                      : cales::MomTy<float>::TY);
}
