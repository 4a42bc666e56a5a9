// Device code shared by the dynamic-Smagorinsky kernels that march z
// through rings of planes: dsmag.cu (one pass) and dsmag_level1.cu (the
// grid level of the two passes).  It holds the tile, the velocity's load,
// stage A and the test filter's passes with the ghost recipes of stages A
// and B, so the recipes exist once (dsmag.cu's header states them).  A
// kernel's tile is DsTy<T>::TY x DS_TX (16 rows in float32, 8 in float64),
// its sizes DsGeo<TY>.
//
// The test filter (sgs.f90:616-680) is separable: an x pass, a y pass and
// a z pass, each ds_pass's q (a + 2 b + c).  The x and y passes are shared
// across the plane and the z pass combines the last three xy-filtered
// planes:
//   ds_vel_x / ds_vel_y  the x and y passes of the velocity's plane, its z
//               and y ghosts formed before the x pass (the filtered
//               velocity's recipes: the wall-parallel components
//               extrapolated at z and y walls);
//   ds_src_x / ds_src_y  the x and y passes of the 15 filtered A
//               quantities, their z ghost planes (extrapolated at a wall,
//               copied at a homogeneous-Neumann face) and with y walls their
//               y ghost rows formed before the x pass;
//   ds_mul_rn   the z pass's last product, kept out of the FMAs after it.
// The other helpers:
//   ds_load     the velocity plane kz on the tile + a halo of 2 by cp.async,
//               x wrapped, y wrapped or with y walls (YW) the rows -1, ny-1
//               and ny from the post-correction fill's y-row stacks, or on
//               a slab of the y-slab mesh (YH, dsmag.cu's mode) the rows
//               -2, -1, ny and ny+1 from the neighbours' halo; on a pencil
//               of the 2D mesh (XH, dsmag.cu's mode) the columns -2, -1, nx
//               and nx+1 from the x neighbours' two-deep halo; z wrapped
//               with ZP (dsmag.cu's periodic-z mode), the halos' rows too
//               with ZP and YH or XH;
//   ds_source   stage A at one cell: |S| S_ij (6), the centred velocity
//               (3), its products (6) and |S|.
// The kernel passes its ring accessors vel(kz, c) and src(kz, q), which
// return the plane of velocity component c or A quantity q at row kz.
#pragma once

#include "common.cuh"

namespace cales {

constexpr int DS_TX = 32;          // the tile's columns
constexpr int DS_VX = DS_TX + 4;   // velocity, halo 2
constexpr int DS_AX = DS_TX + 2;   // A and the filtered planes, halo 1
constexpr int DS_NA = 16;          // A quantities

// The tile rows: 16 in float32, 8 in float64 (whose planes are twice the
// bytes).
template <typename T>
struct DsTy {
  static constexpr int TY = sizeof(T) == 4 ? 16 : 8;
};

// The sizes of a TY x DS_TX tile: one thread per centre cell, the velocity
// with a halo of 2, A with a halo of 1.
template <int TY>
struct DsGeo {
  static constexpr int NT = TY * DS_TX;
  static constexpr int VY = TY + 4, AY = TY + 2;
  static constexpr int VPL = VY * DS_VX, APL = AY * DS_AX;
};

__device__ __forceinline__ int ring(int kz) { return (kz + 3) % 3; }

// The y-wall inputs and recipes of one call: y-row stacks of the velocity
// (null without y walls) and the filtered fill's 'D' offsets 2b of u and w
// on the lower and upper y walls; on a slab of the y-slab mesh (dsmag.cu's
// modes YH and YW + YH) the velocity's two-deep halo and, with y walls,
// which of the two walls the slab holds (dsmag.cu's only); on a pencil of
// the 2D mesh (dsmag.cu's mode XH) the velocity's two-deep x halo.
template <typename T>
struct DsYWalls {
  YRows<T> vel[3];
  YRows<T> hal[3];
  YRows<T> xh[3];
  T off_lo[3], off_hi[3];   // index 1 (v) unused: v's fill is 0
  int lo, hi;
};

// The tile of one block and the dims: (x0, y0) its first centre cell.
struct DsTile {
  int x0, y0, nz, ny, nx, tid;
  int64_t plane;
};

// Padded row kz (-1 .. nz) of a slab's two-deep y halo (YH): rows
// (nz, 4, nx) = [rows -2, -1, ny, ny+1] (the lower neighbour's last two,
// the upper's first two) and their z-edge stack entries, the corners
// (3, 4, nx), in the stack's order (parallel/mesh.halo_y, depth 2); r in
// 0 .. 3.
template <typename T>
__device__ __forceinline__ const T* ds_hrow(const YRows<T>& h, int kz, int r,
                                            int nz, int nx) {
  const int64_t n4 = 4 * static_cast<int64_t>(nx);
  const T* base = kz < 0 ? h.corners
                  : kz >= nz - 1 ? h.corners + (kz - nz + 2) * n4
                                 : h.rows + kz * n4;
  return base + static_cast<int64_t>(r) * nx;
}

// With ZP and YH (a slab of the periodic box): the halo's row r of the
// plane kz mod nz (kz from -2 to nz+1), its z-edge entries unread, as the
// slab's own planes load mod nz.
template <typename T>
__device__ __forceinline__ const T* ds_hrow_zp(const YRows<T>& h, int kz,
                                               int r, int nz, int nx) {
  const int64_t k = (kz + nz) % nz;
  return h.rows + (k * 4 + r) * nx;
}

// A pencil's two-deep x halo (XH) has the layout of a slab's two-deep y
// halo with x and y exchanged: cols (nz, 4, ny+4) = [columns -2, -1, nx,
// nx+1] over the rows -2 .. ny+1 (row y at index y+2) and their z-edge
// entries, the corners (3, 4, ny+4) (parallel/mesh.halo_x at depth 2,
// its rows by the depth-2 y exchange: timeloop._pencil_halos), so
// ds_hrow and ds_hrow_zp read it with ny+4 in place of nx.
//
// The velocity plane kz (-1 .. nz, ghost rows from the edge stacks) on the
// tile + halo 2, x wrapped; y wrapped, or with y walls the rows -1, ny-1
// and ny from the y-row stacks, or with YH (a slab) the rows -2, -1, ny
// and ny+1 from the halo (yw.hal; a ragged tile's rows past ny+1 wrap, as
// they feed no output); with both (a slab of a y-walled mesh) the rows -1,
// ny-1 and ny from the slab's y-row stacks, which hold the wall recipe's
// rows on the sides the slab owns and the neighbours' rows elsewhere, and
// the rows -2 and ny+1 from the halo.  With XH (a pencil) the columns
// -2, -1, nx and nx+1 from the x halo at any row of the tile: with YH its
// rows -2 .. ny+1, which carry the corners (a ragged tile's rows past
// ny+1 wrap), with periodic y its rows 0 .. ny-1, wrapped; a ragged
// tile's columns past nx+1 wrap.  With ZP
// (periodic z) any kz from -nz on, the field's plane kz mod nz (the edge
// stacks unread), the halos' plane kz mod nz too.
// A cell's index is found once for the three components and its three
// values copied by cp_async, one group a plane: the caller waits
// (cp_async_wait) and passes a barrier before the plane is read.
template <typename T, bool YW, int TY, bool ZP = false, bool YH = false,
          bool XH = false, class VEL>
__device__ __forceinline__ void ds_load(const VEL& vel, const T* const fld[3],
                                        const T* const edg[3],
                                        const DsYWalls<T>& yw,
                                        const DsTile& g, int kz) {
  const T* row[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    row[c] = ZP ? fld[c] + static_cast<int64_t>((kz + g.nz) % g.nz) * g.plane
                : zrow(fld[c], edg[c], kz, g.nz, g.plane);
  for (int e = g.tid; e < DsGeo<TY>::VPL; e += DsGeo<TY>::NT) {
    const int ly = e / DS_VX, lx = e - ly * DS_VX;
    const int y = g.y0 - 2 + ly, xr = g.x0 - 2 + lx;
    const int x = wrap_near(xr, g.nx);
    if (XH && (xr < 0 || (xr >= g.nx && xr < g.nx + 2))) {
      const int c = xr < 0 ? xr + 2 : xr - g.nx + 2;
      const int yi = (YH && y < g.ny + 2 ? y : wrap_near(y, g.ny)) + 2;
#pragma unroll
      for (int q = 0; q < 3; ++q)
        cp_async(vel(kz, q) + e,
                 (ZP ? ds_hrow_zp(yw.xh[q], kz, c, g.nz, g.ny + 4)
                     : ds_hrow(yw.xh[q], kz, c, g.nz, g.ny + 4)) + yi);
    } else if (YW && (y == -1 || y == g.ny - 1 || y == g.ny)) {
      const int r = y < 0 ? 0 : y - g.ny + 2;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        cp_async(vel(kz, c) + e, yrow(yw.vel[c], kz, r, g.nz, g.nx) + x);
    } else if (YH && y < g.ny + 2 && (y < 0 || y >= g.ny)) {
      const int r = y < 0 ? y + 2 : y - g.ny + 2;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        cp_async(vel(kz, c) + e,
                 (ZP ? ds_hrow_zp(yw.hal[c], kz, r, g.nz, g.nx)
                     : ds_hrow(yw.hal[c], kz, r, g.nz, g.nx)) + x);
    } else {
      const int64_t o = static_cast<int64_t>(wrap_near(y, g.ny)) * g.nx + x;
#pragma unroll
      for (int c = 0; c < 3; ++c) cp_async(vel(kz, c) + e, row[c] + o);
    }
  }
  cp_async_commit();
}

// Stage A at cell e of plane t's A ring (velocity ring offset vo): the 16
// source quantities into src(t, q)[e]
template <typename T, class VEL, class SRC>
__device__ __forceinline__ void ds_source(const VEL& vel, const SRC& src,
                                          int t, int e, int vo, T dxi, T dyi,
                                          T dzci_c, T dzci_m, T dzfi_c) {
  const T half = T(0.5);
  auto U = [&](int dk, int dj, int di) {
    return vel(t + dk, 0)[vo + dj * DS_VX + di];
  };
  auto V = [&](int dk, int dj, int di) {
    return vel(t + dk, 1)[vo + dj * DS_VX + di];
  };
  auto W = [&](int dk, int dj, int di) {
    return vel(t + dk, 2)[vo + dj * DS_VX + di];
  };
  T sij[6];
  const T s0 = strain_rate<T>(U, V, W, dxi, dyi, dzci_c, dzci_m, dzfi_c, sij);
  const T uc = half * (U(0, 0, 0) + U(0, 0, -1));
  const T vc = half * (V(0, 0, 0) + V(0, -1, 0));
  const T wc = half * (W(0, 0, 0) + W(-1, 0, 0));
  const T a[DS_NA] = {s0 * sij[0], s0 * sij[1], s0 * sij[2],
                      s0 * sij[3], s0 * sij[4], s0 * sij[5],
                      uc,          vc,          wc,
                      uc * uc,     vc * vc,     wc * wc,
                      uc * vc,     uc * wc,     vc * wc,
                      s0};
#pragma unroll
  for (int q = 0; q < DS_NA; ++q) src(t, q)[e] = a[q];
}

// ---------------------------------------------------------------------------
// The test filter shared across the plane
// ---------------------------------------------------------------------------

// One pass of the separable filter, q (a + 2 b + c) in the order of
// stencil.filter3d: x passes, then y, then z.
template <typename T>
__device__ __forceinline__ T ds_pass(T a, T b, T c) {
  const T q = T(0.25), two = T(2);
  return q * (a + two * b + c);
}

// a * b as a product of its own, never contracted into an FMA: the z
// pass's last product, so that the stages after it fuse their own products
// (L_ij's filt(uc_i) filt(uc_j), stage C's) as the 27-read filter of the
// first kernels did with its values, which were loads there.
__device__ __forceinline__ float ds_mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double ds_mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

// The z ghost planes of a pass's input: DS_PLANE the plane kz as it is,
// DS_GHOST_LO / DS_GHOST_HI the extrapolated ghost 2 q(0) - q(1) below
// the first plane / 2 q(nz-1) - q(nz-2) above the last.
enum { DS_PLANE = 0, DS_GHOST_LO = 1, DS_GHOST_HI = 2 };

// The velocity's x pass on plane kz of the velocity ring into xv
// [3][VY][DS_AX] (rows of the velocity tile, columns of the A tile).  Its
// input is the filtered velocity's: the ghost MODE (u and v only; w's z
// ghosts are loaded)
// and, with y walls, u's and w's rows y < 0 and y >= ny extrapolated from
// the two rows inside, 2 q(0) - q(1), after the z ghost; ylo, yhi: which
// of the two y walls there are (both, but on a slab of a y-walled mesh).
template <typename T, bool YW, int TY, int MODE, class VEL>
__device__ __forceinline__ void ds_vel_x(const VEL& vel, T* xv, int kz,
                                         int y0, int ny, int nz, int tid,
                                         bool ylo = YW, bool yhi = YW) {
  using G = DsGeo<TY>;
  const T two = T(2);
  for (int e = tid; e < 3 * G::VY * DS_AX; e += G::NT) {
    const int c = e / (G::VY * DS_AX);
    const int r = e - c * G::VY * DS_AX;
    const int vy = r / DS_AX, o = vy * DS_VX + (r - vy * DS_AX);
    auto zv = [&](int i) -> T {
      if (MODE == DS_GHOST_LO && c < 2)
        return two * vel(0, c)[i] - vel(1, c)[i];
      if (MODE == DS_GHOST_HI && c < 2)
        return two * vel(nz - 1, c)[i] - vel(nz - 2, c)[i];
      return vel(kz, c)[i];
    };
    // with y walls, u's and w's rows outside: the offset of the row in
    const int gy = y0 - 2 + vy;
    const int in = (YW && c != 1) ? (gy < 0    ? (ylo ? DS_VX : 0)
                                     : gy >= ny ? (yhi ? -DS_VX : 0)
                                                : 0)
                                  : 0;
    if (in == 0) {
      xv[e] = ds_pass(zv(o), zv(o + 1), zv(o + 2));
    } else {
      auto ext = [&](int i) { return two * zv(i + in) - zv(i + 2 * in); };
      xv[e] = ds_pass(ext(o), ext(o + 1), ext(o + 2));
    }
  }
}

// The velocity's y pass: xv -> plane kz of the xy-filtered ring yv(kz, c)
// on the A tile.
template <typename T, int TY, class YV>
__device__ __forceinline__ void ds_vel_y(const T* xv, const YV& yv, int kz,
                                         int tid) {
  using G = DsGeo<TY>;
  for (int e = tid; e < 3 * G::APL; e += G::NT) {
    const int c = e / G::APL, o = e - c * G::APL;
    const T* x = xv + c * G::VY * DS_AX + o;
    yv(kz, c)[o] = ds_pass(x[0], x[DS_AX], x[2 * DS_AX]);
  }
}

// The x pass of the 15 filtered A quantities of plane kz (or a ghost
// plane, MODE: extrapolated at a wall; a homogeneous-Neumann face's copy
// is the caller's) into xs [15][AY][DS_TX]: a warp a row of 32.  With y
// walls A's y ghost rows y = -1 and ny are the extrapolation 2 q(0) - q(1)
// of A itself (pallas_dsmag.py:941-949) on each plane, formed before the
// z ghost; ylo, yhi as ds_vel_x's.
template <typename T, bool YW, int TY, int MODE, class SRC>
__device__ __forceinline__ void ds_src_x(const SRC& src, T* xs, int kz,
                                         int y0, int ny, int nz, int tid,
                                         bool ylo = YW, bool yhi = YW) {
  using G = DsGeo<TY>;
  const T two = T(2);
  const int lane = tid & 31;
  for (int r = tid >> 5; r < (DS_NA - 1) * G::AY; r += G::NT / 32) {
    const int q = r / G::AY, ay = r - q * G::AY, o = ay * DS_AX + lane;
    const int gy = y0 - 1 + ay;
    const int in = !YW                 ? 0
                   : gy == -1 && ylo   ? DS_AX
                   : gy == ny && yhi   ? -DS_AX
                                       : 0;
    // plane kp's value at offset i, its y ghost rows filled
    auto at = [&](int kp, int i) -> T {
      const T* a = src(kp, q);
      return in == 0 ? a[i] : two * a[i + in] - a[i + 2 * in];
    };
    auto val = [&](int i) -> T {
      if (MODE == DS_GHOST_LO) return two * at(0, i) - at(1, i);
      if (MODE == DS_GHOST_HI) return two * at(nz - 1, i) - at(nz - 2, i);
      return at(kz, i);
    };
    xs[r * DS_TX + lane] = ds_pass(val(o), val(o + 1), val(o + 2));
  }
}

// The y pass of the 15 quantities at centre cell (cy, cx) from xs.
template <typename T, int TY>
__device__ __forceinline__ void ds_src_y(const T* xs, int cy, int cx,
                                         T (&y)[DS_NA - 1]) {
  using G = DsGeo<TY>;
#pragma unroll
  for (int q = 0; q < DS_NA - 1; ++q) {
    const T* x = xs + (q * G::AY + cy) * DS_TX + cx;
    y[q] = ds_pass(x[0], x[DS_TX], x[2 * DS_TX]);
  }
}

}  // namespace cales
