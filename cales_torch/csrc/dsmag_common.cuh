// Device code shared by the dynamic-Smagorinsky kernels that march z
// through rings of planes: dsmag.cu (one pass) and dsmag_level1.cu (the
// grid level of the two passes).  It holds the tile, the rings' helpers,
// the 27-point test filter and the ghost recipes of stages A and B, so the
// recipes exist once (dsmag.cu's header states them).  The tile is
// DS_TY x DS_TX by default; DsGeo<TY> gives the sizes of a TY x DS_TX one
// (dsmag.cu's float32 tile is 16 rows).
//
// The test filter comes in two forms with the same rounding: filter27, a
// centre cell's 27 reads (dsmag_level1.cu), and the separable passes
// shared across a plane (dsmag.cu), each ds_pass of filter27's
// q (a + 2 b + c):
//   ds_vel_x / ds_vel_y  the x and y passes of the velocity's plane, its z
//               and y ghosts formed before the x pass by fvel's recipes;
//   ds_src_x / ds_src_y  the x and y passes of the 15 filtered A
//               quantities, z ghost planes formed before the x pass;
//   the z pass combines the last three xy-filtered planes.
// The helpers:
//   load        the velocity plane kz on the tile + a halo of 2, x wrapped,
//               y wrapped or with y walls (YW) the rows -1, ny-1 and ny
//               from the post-correction fill's y-row stacks;
//   source      stage A at one cell: |S| S_ij (6), the centred velocity
//               (3), its products (6) and |S|;
//   fvel        the filtered velocity at one cell, the wall-parallel
//               components' ghosts extrapolated at z and y walls;
//   fix_src_y   A's y ghost rows by extrapolation (YW, edge tiles);
//   filtered    stage B: the 15 filtered A quantities at a centre cell, A's
//               z ghosts extrapolated at walls, copied elsewhere.
// The kernel passes its ring accessors vel(kz, c) and src(kz, q), which
// return the plane of velocity component c or A quantity q at row kz.
#pragma once

#include "common.cuh"

namespace cales {

constexpr int DS_TY = 8, DS_TX = 32;           // the centre tile (y, x)
constexpr int DS_NT = DS_TY * DS_TX;           // one thread per centre cell
constexpr int DS_VY = DS_TY + 4, DS_VX = DS_TX + 4;   // velocity, halo 2
constexpr int DS_AY = DS_TY + 2, DS_AX = DS_TX + 2;   // A and F, halo 1
constexpr int DS_VPL = DS_VY * DS_VX, DS_APL = DS_AY * DS_AX;
constexpr int DS_NA = 16;                      // A quantities
static_assert(DS_NT == CALES_THREADS, "block_sum assumes CALES_THREADS");

// The sizes of a TY x DS_TX tile (DsGeo<DS_TY>: the constants above).
template <int TY>
struct DsGeo {
  static constexpr int NT = TY * DS_TX;
  static constexpr int VY = TY + 4, AY = TY + 2;
  static constexpr int VPL = VY * DS_VX, APL = AY * DS_AX;
};

__device__ __forceinline__ int ring(int kz) { return (kz + 3) % 3; }

__device__ __forceinline__ int wrap(int q, int n) {
  q %= n;
  return q < 0 ? q + n : q;
}

// The separable 27-point filter of f(dk, dj, di) in the order of
// stencil.filter3d: x passes, then y, then z.
template <typename T, class F>
__device__ __forceinline__ T filter27(const F& f) {
  const T q = T(0.25), two = T(2);
  T zq[3];
#pragma unroll
  for (int dk = -1; dk <= 1; ++dk) {
    T yq[3];
#pragma unroll
    for (int dj = -1; dj <= 1; ++dj)
      yq[dj + 1] = q * (f(dk, dj, -1) + two * f(dk, dj, 0) + f(dk, dj, 1));
    zq[dk + 1] = q * (yq[0] + two * yq[1] + yq[2]);
  }
  return q * (zq[0] + two * zq[1] + zq[2]);
}

// The y-wall inputs and recipes of one call: y-row stacks of the velocity
// (null without y walls) and the filtered fill's 'D' offsets 2b of u and w
// on the lower and upper y walls (dsmag.cu's only).
template <typename T>
struct DsYWalls {
  YRows<T> vel[3];
  T off_lo[3], off_hi[3];   // index 1 (v) unused: v's fill is 0
};

// The tile of one block and the dims: (x0, y0) its first centre cell.
struct DsTile {
  int x0, y0, nz, ny, nx, tid;
  int64_t plane;
};

// An asynchronous copy of one value from global to shared memory
// (cp.async; a plain copy where the compiler targets no GPU), its group's
// commit, and the wait for every group of this thread: the copies are
// visible to the block after the wait and a barrier.
template <typename T>
__device__ __forceinline__ void ds_cp_async(T* dst, const T* src) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "n"(sizeof(T)));
#else
  *dst = *src;
#endif
}
__device__ __forceinline__ void ds_cp_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}
__device__ __forceinline__ void ds_cp_wait_all() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#endif
}

// q mod n for q a few n from [0, n): the tile's halo
__device__ __forceinline__ int wrap_near(int q, int n) {
  while (q < 0) q += n;
  while (q >= n) q -= n;
  return q;
}

// velocity plane kz (-1 .. nz, ghost rows from the edge stacks) on the
// tile + halo 2, x wrapped; y wrapped, or with y walls the rows -1, ny-1
// and ny from the y-row stacks.  NEAR (dsmag.cu): a cell's index found
// once for the three components, wrapped by wrap_near, and its three
// values copied by ds_cp_async, one group a plane: the caller waits
// (ds_cp_wait_all) and passes a barrier before the plane is read.
template <typename T, bool YW, int TY = DS_TY, bool NEAR = false, class VEL>
__device__ __forceinline__ void ds_load(const VEL& vel, const T* const fld[3],
                                        const T* const edg[3],
                                        const DsYWalls<T>& yw,
                                        const DsTile& g, int kz) {
  if constexpr (NEAR) {
    const T* row[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      row[c] = zrow(fld[c], edg[c], kz, g.nz, g.plane);
    for (int e = g.tid; e < DsGeo<TY>::VPL; e += DsGeo<TY>::NT) {
      const int ly = e / DS_VX, lx = e - ly * DS_VX;
      const int y = g.y0 - 2 + ly, x = wrap_near(g.x0 - 2 + lx, g.nx);
      if (YW && (y == -1 || y == g.ny - 1 || y == g.ny)) {
        const int r = y < 0 ? 0 : y - g.ny + 2;
#pragma unroll
        for (int c = 0; c < 3; ++c)
          ds_cp_async(vel(kz, c) + e, yrow(yw.vel[c], kz, r, g.nz, g.nx) + x);
      } else {
        const int64_t o = static_cast<int64_t>(wrap_near(y, g.ny)) * g.nx + x;
#pragma unroll
        for (int c = 0; c < 3; ++c) ds_cp_async(vel(kz, c) + e, row[c] + o);
      }
    }
    ds_cp_commit();
    return;
  }
  for (int c = 0; c < 3; ++c) {
    const T* row = zrow(fld[c], edg[c], kz, g.nz, g.plane);
    T* dst = vel(kz, c);
    for (int e = g.tid; e < DsGeo<TY>::VPL; e += DsGeo<TY>::NT) {
      const int ly = e / DS_VX, lx = e - ly * DS_VX;
      const int y = g.y0 - 2 + ly, x = wrap(g.x0 - 2 + lx, g.nx);
      if (YW && (y == -1 || y == g.ny - 1 || y == g.ny)) {
        dst[e] = __ldg(yrow(yw.vel[c], kz, y < 0 ? 0 : y - g.ny + 2, g.nz,
                            g.nx) + x);
      } else {
        dst[e] = __ldg(row + static_cast<int64_t>(wrap(y, g.ny)) * g.nx + x);
      }
    }
  }
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

// The filtered velocity component c at the cell of global row gy (velocity
// ring offset vo) of plane t: the wall-parallel components' z ghost planes
// extrapolated (ext_lo, ext_hi: plane t is the first or last next to a z
// wall), and with y walls u's and w's y ghost rows
template <typename T, bool YW, class VEL>
__device__ __forceinline__ T ds_fvel(const VEL& vel, int t, int c, int vo,
                                     int gy, int ny, bool ext_lo,
                                     bool ext_hi) {
  const T two = T(2);
  const T* pm = vel(t - 1, c);
  const T* pc = vel(t, c);
  const T* pp = vel(t + 1, c);
  const bool lo = c < 2 && ext_lo, hi = c < 2 && ext_hi;
  // the velocity at (t+dk, offset o), z ghosts extrapolated
  auto zval = [&](int dk, int o) -> T {
    if (dk < 0) return lo ? two * pc[o] - pp[o] : pm[o];
    if (dk > 0) return hi ? two * pc[o] - pm[o] : pp[o];
    return pc[o];
  };
  if (YW && c != 1 && (gy <= 0 || gy >= ny - 1)) {
    // u's and w's y ghost rows extrapolated at the y walls
    return filter27<T>([&](int dk, int dj, int di) -> T {
      const int o = vo + dj * DS_VX + di, y = gy + dj;
      if (y < 0) return two * zval(dk, o + DS_VX) - zval(dk, o + 2 * DS_VX);
      if (y >= ny)
        return two * zval(dk, o - DS_VX) - zval(dk, o - 2 * DS_VX);
      return zval(dk, o);
    });
  }
  return filter27<T>([&](int dk, int dj, int di) -> T {
    return zval(dk, vo + dj * DS_VX + di);
  });
}

// A's y ghost rows of plane t, y = -1 and ny (tile rows -y0 and
// ny - y0 + 1, in the first and last tile rows only): the extrapolation
// 2 q_0 - q_1 of A (pallas_dsmag.py:941-949), for the 15 filtered
// quantities.  Call after stage A has written plane t, past a
// __syncthreads().
template <typename T, class SRC>
__device__ __forceinline__ void ds_fix_src_y(const SRC& src, int t, int y0,
                                             int ny, int tid) {
  const T two = T(2);
  const int rlo = -y0, rhi = ny - y0 + 1;
  constexpr int nfix = DS_NA - 1;
  for (int e = tid; e < 2 * nfix * DS_AX; e += DS_NT) {
    const int side = e / (nfix * DS_AX);
    const int rest = e - side * nfix * DS_AX;
    const int q = rest / DS_AX, ax = rest - q * DS_AX;
    const int ay = side == 0 ? rlo : rhi;
    const int in = side == 0 ? DS_AX : -DS_AX;
    if (ay < 0 || ay >= DS_AY) continue;
    T* a = src(t, q) + ay * DS_AX + ax;
    a[0] = two * a[in] - a[2 * in];
  }
}

// Stage B: the 15 filtered A quantities at the centre offset ao of plane
// kc; A's z ghost planes extrapolated linearly at a wall, copied at a
// homogeneous-Neumann face
template <typename T, class SRC>
__device__ __forceinline__ void ds_filtered(const SRC& src, int kc, int ao,
                                            int nz, int wall_lo, int wall_hi,
                                            T fq[DS_NA - 1]) {
  const T two = T(2);
  auto a_at = [&](int q, int kz, int o) -> T {
    if (kz < 0) {
      const T a0 = src(0, q)[o];
      return wall_lo ? two * a0 - src(1, q)[o] : a0;
    }
    if (kz >= nz) {
      const T a0 = src(nz - 1, q)[o];
      return wall_hi ? two * a0 - src(nz - 2, q)[o] : a0;
    }
    return src(kz, q)[o];
  };
#pragma unroll 1
  for (int q = 0; q < DS_NA - 1; ++q)
    fq[q] = filter27<T>([&](int dk, int dj, int di) {
      return a_at(q, kc + dk, ao + dj * DS_AX + di);
    });
}

// ---------------------------------------------------------------------------
// The test filter shared across the plane (dsmag.cu)
// ---------------------------------------------------------------------------

// One pass of the separable filter: filter27's q (a + 2 b + c).
template <typename T>
__device__ __forceinline__ T ds_pass(T a, T b, T c) {
  const T q = T(0.25), two = T(2);
  return q * (a + two * b + c);
}

// a * b as a product of its own, never contracted into an FMA: the z
// pass's last product, so that the stages after it fuse their own products
// as they did with the 27-read filter's values (loads there).
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
// input is fvel's: the ghost MODE (u and v only; w's z ghosts are loaded)
// and, with y walls, u's and w's rows y < 0 and y >= ny extrapolated from
// the two rows inside, 2 q(0) - q(1), after the z ghost.
template <typename T, bool YW, int TY, int MODE, class VEL>
__device__ __forceinline__ void ds_vel_x(const VEL& vel, T* xv, int kz,
                                         int y0, int ny, int nz, int tid) {
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
    const int in = (YW && c != 1) ? (gy < 0 ? DS_VX : gy >= ny ? -DS_VX : 0)
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
// plane, MODE, the a_at of ds_filtered) into xs [15][AY][DS_TX]: a warp a
// row of 32.  With y walls A's y ghost rows y = -1 and ny are
// ds_fix_src_y's 2 q(0) - q(1) of each plane, formed before the z ghost.
template <typename T, bool YW, int TY, int MODE, class SRC>
__device__ __forceinline__ void ds_src_x(const SRC& src, T* xs, int kz,
                                         int y0, int ny, int nz, int tid) {
  using G = DsGeo<TY>;
  const T two = T(2);
  const int lane = tid & 31;
  for (int r = tid >> 5; r < (DS_NA - 1) * G::AY; r += G::NT / 32) {
    const int q = r / G::AY, ay = r - q * G::AY, o = ay * DS_AX + lane;
    const int gy = y0 - 1 + ay;
    const int in = YW ? (gy == -1 ? DS_AX : gy == ny ? -DS_AX : 0) : 0;
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
