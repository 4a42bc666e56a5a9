// Dynamic Smagorinsky (Germano-Lilly), one z-march.
//
// Replaces: cales_tpu/ops/pallas_dsmag.py:1168 fused_dsmag_onepass (body
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
// Two modes, template switches of the periodic-y 'channel' kernel (its
// sums also serve 'dit', the volume's one ratio, which the caller forms),
// for what the JAX package runs in XLA (sgs.dsmag_visct; its Pallas
// kernel turns both away):
//   ZP   periodic z (the triperiodic box): every z ghost of A, of the
//        velocity and of F is the real plane at the other end.  The march
//        starts a plane earlier and ends a plane later, t = -1 .. nz, and
//        loads the velocity's plane t mod nz (the edge stacks go unread),
//        so A and F at the planes -1 and nz are made as any plane is,
//        with the metrics of the plane they are; |S| and the sums are
//        written for the planes 0 .. nz-1 only;
//   F2D  the 2D test filter (sgs.f90:824-848): the x and y passes only,
//        no z pass, no extrapolation before filtering (no ghost plane of
//        A or of the velocity is read), alpha^2 2.52 everywhere (the
//        caller's profile); F keeps its z fill, the walls' recipe below or
//        with ZP the wrap, since the test-level strain takes its z
//        derivatives.
// A third mode, YH, is a slab of the y-slab mesh (periodic y, z walls, the
// 'channel' sums; the JAX package's fused_dsmag_onepass with ystrips,
// pallas_dsmag.py:867-887): the velocity tile's rows -2, -1, ny and ny+1,
// and their z-edge entries, load from the neighbours' two-row halo
// (parallel/mesh.halo_y) where the whole field wraps.  Everything after
// the load is the periodic kernel's: A's y ghosts and the filtered
// velocity's are those of real rows, as with periodic y.  The sums are
// the slab's; the caller reduces the z rows' sums over the ranks.  ZP and
// YH together are a slab of the periodic box (the triperiodic LES with
// 'dit' on dims (gy, 1)): the halo's rows load for the plane t mod nz as
// the slab's own planes do, its z-edge entries unread (ds_hrow_zp).
// F2D and YH together are a slab with the 2D test filter (the dsmag channel
// with filter_2d on dims (gy, 1); with ZP too, the box with filter_2d): the
// halo's rows load as in YH, and the rest is the F2D kernel's.  The JAX
// package runs its XLA model there.
// YW and YH together are a slab of a y-walled mesh (the duct and cavity
// classes on dims (gy, 1), any of the three averages; the JAX package's
// per-shard wall gating y_lo & ywf, pallas_dsmag.py:382-386, 650-652):
// the rows -1, ny-1 and ny load from the slab's y-row stacks (the wall
// recipe's rows on a side the slab owns, the neighbours' rows and its own
// last row elsewhere; boundary.slab_ystack) and the rows -2 and ny+1 from
// the halo, and the y-wall recipes (A's ghost rows, the wall-parallel
// velocity's, F's fill, alpha^2 2.52) apply on the owned sides only, two
// run-time flags (ywall.lo, ywall.hi).  A slab's rows are its own: 'duct'
// sums a (z, y) row over x and 'cavity' is pointwise, so neither needs a
// reduction over the ranks.
// A fourth mode, XH, is a pencil of the 2D (gy, gx) mesh (periodic x and
// y, the 'channel' sums; with YH on gy > 1, periodic y on gy = 1; with ZP
// the box's 'dit'; the JAX package's fused_dsmag_onepass under its 2D
// shard_map with _dsmag_xext, cales_tpu/timeloop.py:486-509): the
// velocity tile's columns -2, -1, nx and nx+1, at every row of the tile
// and with their z-edge entries, load from the x neighbours' two-deep
// halo, whose rows -2, -1, ny and ny+1 came by the y exchange (the
// (x +-1..2, y +-1..2) corners, two hops), where the whole field wraps.
// Everything after the load is the periodic kernel's.  The sums are the
// pencil's; the caller reduces the z rows' sums over all gy gx ranks.
// F2D and XH together are a pencil with the 2D test filter (the dsmag
// channel and, with ZP, the box with filter_2d on gx > 1): the tile's
// columns -2 .. nx+1 load as in XH, and the rest is the F2D kernel's.
// YW, YH and XH together are a pencil of a y-walled 2D mesh (the duct's
// 'duct', 'channel' or 'dit' and the cavity's 'cavity' averages on gx >
// 1, z walls, the 3D filter; the JAX package's x-extended y-walled onepass with its per-shard
// wall gating, cales_tpu/timeloop.py:1540-1581): the rows -1, ny-1 and ny
// load from the pencil's y-row stacks and -2 and ny+1 from the halo, as on
// a slab of a y-walled mesh, and the columns -2, -1, nx and nx+1 from the
// x halo at every row, whose rows -1, ny-1 (v's rewrite) and ny on the
// walls the pencil's mesh row holds are the x neighbours' wall rows (the
// caller's composition, timeloop._xstacks_on_slab): the (x ghost, y wall)
// corners come from there, never from the y-row stack's own columns.
// 'duct' writes the pencil's sums over its x blocks, which the caller sums
// over the mesh row, 'channel' the pencil's, which it sums over all the
// ranks; 'cavity' needs no reduction.
//
// Design.  A block owns a TY x 32 (y, x) tile (TY = 16 in float32, 8 in
// float64, whose planes are twice the bytes) and marches z, one plane a
// step, with the test filter's x and y passes shared across the plane:
//   V   the velocity (3) on the tile + a halo of 2, a ring of 4 planes:
//       plane t+2 is copied in by cp.async while t-1 .. t+1 are read, and
//       waited for only at the step's last barrier;
//   A   the 15 filtered source quantities on the tile + a halo of 1, planes
//       t-1 and t, and |S| on three planes;
//   XS  their x pass, one plane; the y pass goes to registers, one centre
//       cell a thread, and the z pass combines there: a thread keeps the
//       xy-filtered value of plane t-1 and the partial sum q(t-2) +
//       2 q(t-1) of each quantity;
//   XV, YV, F  the velocity's x pass (one plane), its xy-filtered ring (3
//       planes) and the filtered velocity on the tile + a halo of 1 (3
//       planes, with F's z fill written as the planes -1 and nz), whose z
//       pass is the last three YV planes.
// At step t the block starts the copy of velocity plane t+2, forms A at
// plane t and the velocity's x pass of plane t+1; then (one barrier) its y
// pass and A's x pass; then (one barrier) F at plane t and A's y and z
// passes; then (one barrier) finishes plane t-1 at the tile's centre as
// before: the test-level strain from F, M_ij, L_ij and the contraction in
// registers, the sums or nu_t, and |S|.  Three barriers a plane (the
// 'channel' sum adds one), where the 27-read filter took three and its
// block sums four.
// Each output keeps the 27-read filter's arithmetic: x, then y, then z,
// each pass q (a + 2 b + c), the z and y ghost planes and rows of A and
// of the velocity formed before the x pass by the recipes above (a ghost
// plane is one more x and y pass, at the first and last plane), and the z
// pass's last product kept out of the FMAs of stage C (ds_mul_rn), so
// |S|, nu_t and every summand are bitwise those of the 27-read filter.
// 'channel' keeps its partial sums' grouping too: a float32 block writes
// one sum per 8 tile rows (DS_SUM_TY), summed as block_sum sums a block
// of 8 warps.
// With y walls (template switch YW) the velocity's rows -1, ny-1 and ny
// load from the y-row stacks; A's y ghost rows (2 q_0 - q_1 of A) are
// formed in A's x pass and F's fill in F's z pass, row by row, so an
// edge tile takes no pass or barrier of its own.
// The load, stage A and the passes are dsmag_common.cuh's.
// Nothing but |S| (or nu_t) and the partial sums goes to global memory.  x
// wraps when a plane is loaded, and so does y without y walls; a ragged
// tile's outside cells are computed on wrapped data and left out of the
// output and the sums.  'duct' leaves the last sum over x to the caller,
// a (nz, ny, nx/32) reduction, rather than a tile spanning all of x (the
// TPU kernel's fold_ratio), which would not fit shared memory at nx = 512.
//
// Shared memory: V 4 x 3 VY x 36, A (2 x 15 + 3) x AY x 34, XS 15 x AY x
// 32, XV 3 x VY x 34, YV and F 9 x AY x 34 words: 202,128 bytes in f32
// (TY 16), 228,384 in f64 (TY 8); one block (16 or 8 warps) an SM.
//
// Bound on the H100: operations.  It reads u, v, w once and writes |S| (4
// field streams, 0.54 GB at 512x256x256 f32: 0.16 ms at 3.35 TB/s).  The
// function needs about 473 floating-point operations a cell: A 110 (the
// strain rate's 92 + 18), 18 filtered quantities at 12 each with the
// separable passes shared across the plane (3 passes of 4), and C 147
// (the test-level strain's 92 + M_ij, L_ij and the contraction), 15.9
// GFLOP a call: 0.237 ms at the data sheet's 67 TFLOP/s f32 outside the
// tensor cores.  This kernel does about 510 a cell: the halo's share of A
// (1.2 in float32) and of the filter's x passes.  Beyond that it spends
// its shared-memory traffic (about 250 accesses a centre cell, 620 with
// the 27-read filter), its copies of the velocity planes, and latency:
// one block an SM (16 warps, 128 registers a thread).
#include "dsmag_common.cuh"

namespace cales {

static_assert(DS_TX == 32, "'duct' sums a tile row as one warp");
enum { DS_CHANNEL = 0, DS_DUCT = 1, DS_CAVITY = 2 };
constexpr int DS_SUM_TY = 8;   // tile rows of one 'channel' partial sum

// Shared memory, in words: V, A (15 quantities on two planes, |S| on
// three), XS, XV, YV, F.
template <typename T>
constexpr size_t dsmag_smem_bytes() {
  using G = DsGeo<DsTy<T>::TY>;
  return sizeof(T) *
         (12 * G::VPL + (2 * (DS_NA - 1) + 3) * G::APL +
          (DS_NA - 1) * G::AY * DS_TX + 3 * G::VY * DS_AX + 18 * G::APL);
}

template <typename T, bool YW, int AVG, bool ZP, bool F2D, bool YH = false,
          bool XH = false>
__global__ void __launch_bounds__(DsGeo<DsTy<T>::TY>::NT, 1) dsmag_kernel(
    const T* __restrict__ u, const T* __restrict__ v, const T* __restrict__ w,
    const T* __restrict__ ue, const T* __restrict__ ve,
    const T* __restrict__ we, const T* __restrict__ alph2,
    const T* __restrict__ dzci, const T* __restrict__ dzfi,
    T* __restrict__ s0o, T* __restrict__ numo, T* __restrict__ deno,
    DsYWalls<T> yw, int nz, int ny, int nx, int wall_lo, int wall_hi, T dxi,
    T dyi, T zoff_lo_u, T zoff_hi_u, T zoff_lo_v, T zoff_hi_v) {
  constexpr int TY = DsTy<T>::TY;
  using G = DsGeo<TY>;
  constexpr int NT = G::NT, AY = G::AY, APL = G::APL, NF = DS_NA - 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T part[2][NT / 32];   // 'channel': the warps' sums
  T* const Vs = reinterpret_cast<T*>(smem_raw);   // [4 planes][3][VPL]
  T* const As = Vs + 12 * G::VPL;                  // [2 planes][15][APL]
  T* const S0 = As + 2 * NF * APL;                 // [3 planes][APL]
  T* const XS = S0 + 3 * APL;                      // [15][AY][TX]
  T* const XV = XS + NF * AY * DS_TX;              // [3][VY][AX]
  T* const YV = XV + 3 * G::VY * DS_AX;            // [3 planes][3][APL]
  T* const Fs = YV + 9 * APL;                      // [3 planes][3][APL]
  const int gx = (nx + DS_TX - 1) / DS_TX;
  const int bx = blockIdx.x % gx;
  const int x0 = bx * DS_TX;
  const int y0 = (blockIdx.x / gx) * TY;
  const int tid = threadIdx.x;
  const int64_t plane = static_cast<int64_t>(ny) * nx;
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
  const T szlo = wall_lo ? T(-1) : T(1), szhi = wall_hi ? T(-1) : T(1);
  const T zofflo[2] = {zoff_lo_u, zoff_lo_v};
  const T zoffhi[2] = {zoff_hi_u, zoff_hi_v};
  // the y walls of this field: both with YW, on a slab of a y-walled mesh
  // (YW and YH) the ones the slab holds, read from shared memory where
  // they are used (held in registers across the march, the flags cost the
  // float32 slab instantiations about 90 B of spills)
  auto ylo = [&]() { return YW && (!YH || ywall.lo != 0); };
  auto yhi = [&]() { return YW && (!YH || ywall.hi != 0); };

  auto vel = [&](int kz, int c) {
    return Vs + (((kz + 4) & 3) * 3 + c) * G::VPL;
  };
  auto src = [&](int kz, int q) {
    return q < NF ? As + ((kz & 1) * NF + q) * APL : S0 + ring(kz) * APL;
  };
  auto yvel = [&](int kz, int c) { return YV + (ring(kz) * 3 + c) * APL; };
  auto fvel = [&](int kz, int c) { return Fs + (ring(kz) * 3 + c) * APL; };

  const DsTile g{x0, y0, nz, ny, nx, tid, plane};
  auto load = [&](int kz) {
    ds_load<T, YW, TY, ZP, YH, XH>(vel, fld, edg, ywall, g, kz);
  };
  // the velocity's x and y passes of plane kz (a z ghost by mode)
  auto vel_x = [&](int kz, int mode) {
    if (mode == DS_GHOST_LO)
      ds_vel_x<T, YW, TY, DS_GHOST_LO>(vel, XV, kz, y0, ny, nz, tid,
                                       ylo(), yhi());
    else if (mode == DS_GHOST_HI)
      ds_vel_x<T, YW, TY, DS_GHOST_HI>(vel, XV, kz, y0, ny, nz, tid,
                                       ylo(), yhi());
    else
      ds_vel_x<T, YW, TY, DS_PLANE>(vel, XV, kz, y0, ny, nz, tid, ylo(),
                                    yhi());
  };
  auto vel_y = [&](int kz) { ds_vel_y<T, TY>(XV, yvel, kz, tid); };

  // stage A at plane t on the tile + halo 1; the cells past the first NT
  // go to the last warps, which load the fewest velocity cells
  auto stage_a = [&](int t) {
    // with ZP the plane t of -1 and nz is the plane at the other end
    const int tm = ZP ? (t + nz) % nz : t;
    const T dzci_c = dzci[tm + 1], dzci_m = dzci[tm], dzfi_c = dzfi[tm + 1];
    for (int e = NT - 1 - tid; e < APL; e += NT) {
      const int ay = e / DS_AX, ax = e - ay * DS_AX;
      const int vo = (ay + 1) * DS_VX + ax + 1;
      ds_source<T>(vel, src, t, e, vo, dxi, dyi, dzci_c, dzci_m, dzfi_c);
    }
  };

  // F at plane t: the z pass of YV (with F2D YV itself); at a y wall its
  // y ghost row takes the fill, the filtered u's and w's -F(first row) +
  // 2b, the filtered v's 0, as does its rewrite row y = ny-1
  // (pallas_dsmag.py:1057-1071), so that stage C reads the filled rows as
  // they are
  auto stage_f = [&](int t) {
    for (int e = tid; e < 3 * APL; e += NT) {
      const int c = e / APL, o = e - c * APL;
      auto pass = [&](int i) {
        return ds_pass(yvel(t - 1, c)[i], yvel(t, c)[i], yvel(t + 1, c)[i]);
      };
      T f;
      const int gy = y0 - 1 + o / DS_AX;
      if (c == 1 && ((ylo() && gy == -1) || (yhi() && gy == ny - 1)))
        f = T(0);
      else if (ylo() && c != 1 && gy == -1)
        f = -pass(o + DS_AX) + ywall.off_lo[c];
      else if (yhi() && c != 1 && gy == ny)
        f = -pass(o - DS_AX) + ywall.off_hi[c];
      else if (F2D)
        f = yvel(t, c)[o];
      else
        f = pass(o);
      fvel(t, c)[o] = f;
    }
  };

  // F's z fill (bounduvw, static planes) as planes of the ring, so that
  // stage C reads every plane as it is: below the first plane (after t =
  // 0's y fill) u, v -+F(0) + 2b and w 0; above the last u, v -+F(nz-1) +
  // 2b, and w's wall face, plane nz-1, 0
  auto fill_lo = [&]() {
    for (int e = tid; e < 3 * APL; e += NT) {
      const int c = e / APL, o = e - c * APL;
      fvel(-1, c)[o] = c < 2 ? szlo * fvel(0, c)[o] + zofflo[c] : T(0);
    }
  };
  auto fill_hi = [&]() {
    for (int e = tid; e < 3 * APL; e += NT) {
      const int c = e / APL, o = e - c * APL;
      if (c < 2)
        fvel(nz, c)[o] = szhi * fvel(nz - 1, c)[o] + zoffhi[c];
      else
        fvel(nz - 1, 2)[o] = T(0);
    }
  };

  // stage C at the centre of plane kc from the filtered A quantities fq;
  // every thread calls it (the 'channel' sum)
  const int cy = tid / DS_TX, cx = tid - cy * DS_TX;
  const int ao = (cy + 1) * DS_AX + cx + 1;
  const int yc = y0 + cy;
  const bool inside = yc < ny && x0 + cx < nx;
  auto stage_c = [&](int kc, const T (&fq)[NF]) {
    // the filtered velocity, its y and z fills in the ring
    auto FU = [&](int c, int dk, int dj, int di) -> T {
      return fvel(kc + dk, c)[ao + dj * DS_AX + di];
    };
    T sf[6];
    const T s0f = strain_rate<T>(
        [&](int dk, int dj, int di) { return FU(0, dk, dj, di); },
        [&](int dk, int dj, int di) { return FU(1, dk, dj, di); },
        [&](int dk, int dj, int di) { return FU(2, dk, dj, di); }, dxi, dyi,
        dzci[kc + 1], dzci[kc], dzfi[kc + 1], sf);
    const T a2 = ((ylo() && yc == 0) || (yhi() && yc == ny - 1))
                     ? T(2.52)
                     : alph2[kc];
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
    const T s0 = src(kc, NF)[ao];
    if constexpr (AVG == DS_CAVITY) {
      // nu_t = max(|S| num / den, 0); a NaN passes, as in max(x, 0.0)
      if (inside) {
        const T r = s0 * num / den;
        s0o[oc] = r < T(0) ? T(0) : r;
      }
      return;
    }
    if (inside) {
      s0o[oc] = s0;
    } else {
      num = T(0);
      den = T(0);
    }
    // a tile row's 32 cells are one warp
    for (int off = 16; off > 0; off >>= 1) {
      num += __shfl_down_sync(0xffffffffu, num, off);
      den += __shfl_down_sync(0xffffffffu, den, off);
    }
    if constexpr (AVG == DS_DUCT) {
      if (cx == 0 && yc < ny) {
        const int64_t r = (static_cast<int64_t>(kc) * ny + yc) * gx + bx;
        numo[r] = num;
        deno[r] = den;
      }
      return;
    }
    // 'channel': one sum per DS_SUM_TY rows, its warps in order from 0
    // (block_sum's order), at (kc, 8-row group, x block)
    const int warp = tid >> 5;
    if (cx == 0) {
      part[0][warp] = num;
      part[1][warp] = den;
    }
    __syncthreads();
    const int gy8 = y0 / DS_SUM_TY + warp / DS_SUM_TY;
    const int ny8 = (ny + DS_SUM_TY - 1) / DS_SUM_TY;
    if (tid % (DS_SUM_TY * 32) == 0 && gy8 < ny8) {
      T ns = T(0), ds = T(0);
      for (int k = 0; k < DS_SUM_TY; ++k) {
        ns += part[0][warp + k];
        ds += part[1][warp + k];
      }
      const int64_t r = (static_cast<int64_t>(kc) * ny8 + gy8) * gx + bx;
      numo[r] = ns;
      deno[r] = ds;
    }
  };

  // the z pass in registers: zp the xy-filtered plane t-1, zs the partial
  // sum q(t-2) + 2 q(t-1), of each of the 15 quantities (with F2D no z
  // pass: the filtered plane t-1 is zp).  With ZP the march starts a plane
  // earlier and ends a plane later: A and F at the planes -1 and nz are
  // made as the others are, from the planes at the other end
  constexpr int T0 = ZP ? -1 : 0;
  T zp[NF], zs[NF], fq[NF];
  load(T0 - 1);
  load(T0);
  load(T0 + 1);
  cp_async_wait<0>();
  __syncthreads();
  vel_x(T0 - 1, !ZP && wall_lo ? DS_GHOST_LO : DS_PLANE);
  __syncthreads();
  vel_y(T0 - 1);
  __syncthreads();
  vel_x(T0, DS_PLANE);
  __syncthreads();
  vel_y(T0);
  __syncthreads();
  for (int t = T0; t <= nz; ++t) {
    if (t + 2 <= (ZP ? nz + 1 : nz)) load(t + 2);
    if (ZP || t < nz) stage_a(t);
    if (ZP || t + 1 <= nz)
      vel_x(t + 1, !ZP && wall_hi && t + 1 == nz ? DS_GHOST_HI : DS_PLANE);
    __syncthreads();
    if (ZP || t + 1 <= nz) vel_y(t + 1);
    // A's x pass: plane t, at t = 1 the ghost below the first plane
    // first, after the last plane the ghost above it (with F2D no ghost:
    // no z pass reads it)
    if (ZP) {
      ds_src_x<T, YW, TY, DS_PLANE>(src, XS, t, y0, ny, nz, tid, ylo(),
                                    yhi());
    } else if (!F2D && t == 1 && wall_lo) {
      ds_src_x<T, YW, TY, DS_GHOST_LO>(src, XS, 0, y0, ny, nz, tid,
                                       ylo(), yhi());
    } else if (t < nz) {
      ds_src_x<T, YW, TY, DS_PLANE>(src, XS, t, y0, ny, nz, tid, ylo(),
                                    yhi());
    } else if (!F2D && wall_hi) {
      ds_src_x<T, YW, TY, DS_GHOST_HI>(src, XS, nz, y0, ny, nz, tid,
                                       ylo(), yhi());
    }
    __syncthreads();
    if (ZP || t < nz) stage_f(t);
    if (!ZP && t == 0) {
      __syncthreads();
      fill_lo();
    }
    if (!ZP && t == nz) fill_hi();
    T y[NF];
    if (!ZP && !F2D && t == 1 && wall_lo) {
      // zs = ghost + 2 q(0), then plane 1's x pass
      ds_src_y<T, TY>(XS, cy, cx, y);
#pragma unroll
      for (int q = 0; q < NF; ++q) zs[q] = y[q] + two * zp[q];
      __syncthreads();
      ds_src_x<T, YW, TY, DS_PLANE>(src, XS, 1, y0, ny, nz, tid, ylo(),
                                    yhi());
      __syncthreads();
    }
    if (ZP || t < nz || (!F2D && wall_hi)) {
      ds_src_y<T, TY>(XS, cy, cx, y);
    } else {
#pragma unroll
      for (int q = 0; q < NF; ++q) y[q] = zp[q];   // the copied top plane
    }
#pragma unroll
    for (int q = 0; q < NF; ++q) {
      if (t == T0) {
        if (ZP)
          zs[q] = T(0);                            // set at t = 0
        else if (!wall_lo)
          zs[q] = y[q] + two * y[q];               // the copied first plane
      } else if (F2D) {
        fq[q] = zp[q];
      } else {
        fq[q] = ds_mul_rn(q4, zs[q] + y[q]);
        zs[q] = zp[q] + two * y[q];
      }
      zp[q] = y[q];
    }
    cp_async_wait<0>();   // plane t+2 has landed, for step t+1
    __syncthreads();
    if (t >= 1) stage_c(t - 1, fq);
  }
}

template <typename T, bool YW, bool YH = false>
auto pick_dsmag(int avg) {
  return avg == DS_DUCT ? &dsmag_kernel<T, YW, DS_DUCT, false, false, YH>
         : avg == DS_CAVITY
             ? &dsmag_kernel<T, YW, DS_CAVITY, false, false, YH>
             : &dsmag_kernel<T, YW, DS_CHANNEL, false, false, YH>;
}

// The modes for periodic z (zper: the triperiodic box) and the 2D test
// filter (f2d), periodic y, the 'channel' sums (whose mean over the rows
// 'dit' weighs too); YH: on a slab of the y-slab mesh (with neither, the
// slab's plain YH mode).
template <typename T, bool YH = false>
auto pick_dsmag_mode(bool zper, bool f2d) {
  return zper ? (f2d ? &dsmag_kernel<T, false, DS_CHANNEL, true, true, YH>
                     : &dsmag_kernel<T, false, DS_CHANNEL, true, false, YH>)
              : (f2d ? &dsmag_kernel<T, false, DS_CHANNEL, false, true, YH>
                     : &dsmag_kernel<T, false, DS_CHANNEL, false, false, YH>);
}

// The modes of a pencil of the 2D mesh (XH): the 'channel' sums, z walls
// or with zper periodic z (the box's 'dit'), the 3D or with f2d the 2D
// test filter; YH on a mesh of gy > 1 (the y halo), periodic y on gy = 1.
template <typename T, bool YH>
auto pick_dsmag_xh(bool zper, bool f2d) {
  constexpr int CH = DS_CHANNEL;
  return zper ? (f2d ? &dsmag_kernel<T, false, CH, true, true, YH, true>
                     : &dsmag_kernel<T, false, CH, true, false, YH, true>)
              : (f2d ? &dsmag_kernel<T, false, CH, false, true, YH, true>
                     : &dsmag_kernel<T, false, CH, false, false, YH, true>);
}

// The y-walled modes of a pencil (YW, YH and XH): each average, z walls,
// the 3D filter.
template <typename T>
auto pick_dsmag_ywxh(int avg) {
  constexpr bool W = true;
  return avg == DS_DUCT
             ? &dsmag_kernel<T, W, DS_DUCT, false, false, true, true>
         : avg == DS_CAVITY
             ? &dsmag_kernel<T, W, DS_CAVITY, false, false, true, true>
             : &dsmag_kernel<T, W, DS_CHANNEL, false, false, true, true>;
}

// y: the y-row stacks and corners of u, v, w (6 pointers), all null
// without y walls; h: their two-deep halo pairs on a slab of the y-slab
// mesh (6 pointers, all null off a slab): h alone is mode YH (periodic y,
// the 'channel' sums; with zper ZP and YH, with f2d F2D and YH), y and h
// together a slab of a y-walled mesh, whose
// y holds the slab's y-row stacks and ylo, yhi the walls it owns; x:
// their two-deep x halo pairs on a pencil of the 2D mesh (6 pointers,
// all null off a pencil; cols (nz, 4, ny+4), corners (3, 4, ny+4)): mode
// XH, the 'channel' sums, no y walls, with h (YH) or periodic y, with
// zper or z walls, with f2d or the 3D filter; or with y and h (a pencil
// of a y-walled mesh, YW + YH + XH) any average, z walls, the 3D filter;
// yvals: the filtered fill's
// 'D' values (u_lo, u_hi, w_lo, w_hi) on the y walls;
// avg: DS_CHANNEL, DS_DUCT or DS_CAVITY; zper, f2d: the periodic-z mode
// and the 2D filter (see pick_dsmag_mode).
template <typename T>
int launch_dsmag(const T* u, const T* v, const T* w, const T* ue,
                 const T* ve, const T* we, const T* alph2, const T* dzci,
                 const T* dzfi, T* s0o, T* numo, T* deno,
                 const T* const* y, const T* const* h, const T* const* x,
                 int nz, int ny,
                 int nx, int wall_lo, int wall_hi, int avg, int zper,
                 int f2d, int ylo, int yhi, double dxi, double dyi,
                 const double* zvals, const double* yvals, void* stream) {
  const bool ystacks = y[0] != nullptr;
  const bool halo = h[0] != nullptr;
  const bool xhalo = x[0] != nullptr;
  const bool ywall = ystacks && !halo;
  if (nz < 2 || (ywall && ny < 4) || avg < DS_CHANNEL || avg > DS_CAVITY)
    return static_cast<int>(cudaErrorInvalidValue);
  if (halo && (ny < 2 || ((zper || f2d) && ystacks) ||
               (!ystacks && avg != DS_CHANNEL)))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((zper || f2d) && (ystacks || avg != DS_CHANNEL))
    return static_cast<int>(cudaErrorInvalidValue);
  if (zper && (nz < 3 || wall_lo || wall_hi))
    return static_cast<int>(cudaErrorInvalidValue);
  if (xhalo && (nx < 2 || (ystacks ? !halo : avg != DS_CHANNEL)))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int m = 0; m < 6; ++m)
    if (ystacks != (y[m] != nullptr) || halo != (h[m] != nullptr) ||
        xhalo != (x[m] != nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = dsmag_smem_bytes<T>();
  auto kern = xhalo ? (ystacks ? pick_dsmag_ywxh<T>(avg)
                       : halo  ? pick_dsmag_xh<T, true>(zper, f2d)
                               : pick_dsmag_xh<T, false>(zper, f2d))
              : halo ? (ystacks ? pick_dsmag<T, true, true>(avg)
                              : pick_dsmag_mode<T, true>(zper, f2d))
              : (zper || f2d) ? pick_dsmag_mode<T>(zper, f2d)
              : ywall         ? pick_dsmag<T, true>(avg)
                              : pick_dsmag<T, false>(avg);
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
  if (ystacks) {
    yw.off_lo[0] = T(2 * yvals[0]);
    yw.off_hi[0] = T(2 * yvals[1]);
    yw.off_lo[2] = T(2 * yvals[2]);
    yw.off_hi[2] = T(2 * yvals[3]);
    yw.lo = halo ? ylo : 1;
    yw.hi = halo ? yhi : 1;
  }
  // the filtered-velocity fill's 'D' offsets 2b, on wall faces only
  const T olu = wall_lo ? T(2 * zvals[0]) : T(0);
  const T ohu = wall_hi ? T(2 * zvals[1]) : T(0);
  const T olv = wall_lo ? T(2 * zvals[2]) : T(0);
  const T ohv = wall_hi ? T(2 * zvals[3]) : T(0);
  kern<<<nblk, DsGeo<TY>::NT, smem, static_cast<cudaStream_t>(stream)>>>(
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
                      const T* yvc, const T* ywr, const T* ywc,               \
                      const T* hur, const T* huc, const T* hvr,               \
                      const T* hvc, const T* hwr, const T* hwc,               \
                      const T* xur, const T* xuc, const T* xvr,               \
                      const T* xvc, const T* xwr, const T* xwc, int nz,       \
                      int ny, int nx, int wall_lo, int wall_hi, int avg,      \
                      int zper, int f2d, int ylo, int yhi, double dxi,        \
                      double dyi, double zlo_u, double zhi_u,                 \
                      double zlo_v, double zhi_v, double ylo_u,               \
                      double yhi_u, double ylo_w, double yhi_w,               \
                      void* stream) {                                         \
    const T* const y[6] = {yur, yuc, yvr, yvc, ywr, ywc};                     \
    const T* const h[6] = {hur, huc, hvr, hvc, hwr, hwc};                     \
    const T* const x[6] = {xur, xuc, xvr, xvc, xwr, xwc};                     \
    const double zvals[4] = {zlo_u, zhi_u, zlo_v, zhi_v};                     \
    const double yvals[4] = {ylo_u, yhi_u, ylo_w, yhi_w};                     \
    return cales::launch_dsmag<T>(u, v, w, ue, ve, we, alph2, dzci, dzfi,     \
                                  s0o, numo, deno, y, h, x, nz, ny, nx,       \
                                  wall_lo, wall_hi, avg, zper, f2d, ylo, yhi, \
                                  dxi, dyi, zvals, yvals, stream);            \
  }

CALES_DSMAG_ENTRY(cales_dsmag_f32, float)
CALES_DSMAG_ENTRY(cales_dsmag_f64, double)
