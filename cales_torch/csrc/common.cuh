// Shared device helpers of the cales_torch kernels.
//
// Layout: fields are (nz, ny, nx) row-major, x fastest.  Each kernel
// thread owns one output cell; a block of CALES_THREADS threads covers a
// contiguous run of one z plane (x fastest, so a warp reads neighbouring
// addresses), blockIdx.y is the z plane.
//
// z ghosts come from (3, ny, nx) edge stacks (ops/boundary.zedge_*):
// padded z row -1 is edge[0], row nz-1 is edge[1] (the wall-face rewrite
// slot of the z-staggered w), row nz is edge[2].  The interior's last row
// is never read.  x is periodic and wraps here, unless the x-walled
// variants take the columns -1, nx-1 and nx from the field's x stack
// (xcol below, ops/boundary.xedge_*); so is y, unless the y-walled
// accessor (at<true>, the duct and cavity classes) takes the y rows -1,
// ny-1 and ny from the field's y-row stack (ops/boundary.yedge_*) in the
// same way, or the halo accessor (aty<Y_HALO>, a y slab of a mesh) takes
// the rows -1 and ny from the neighbours' rows (parallel/mesh.halo_y).
#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#define CALES_THREADS 256

namespace cales {

// One output cell and its periodic x/y neighbours.
struct Cell {
  int k, j, i, nz, ny, nx;
  int jm, jp, im, ip;
  int64_t plane;

  __device__ __forceinline__ Cell(int k_, int64_t idx, int nz_, int ny_,
                                  int nx_)
      : k(k_), nz(nz_), ny(ny_), nx(nx_) {
    j = static_cast<int>(idx / nx_);
    i = static_cast<int>(idx - static_cast<int64_t>(j) * nx_);
    jm = j == 0 ? ny - 1 : j - 1;
    jp = j == ny - 1 ? 0 : j + 1;
    im = i == 0 ? nx - 1 : i - 1;
    ip = i == nx - 1 ? 0 : i + 1;
    plane = static_cast<int64_t>(ny) * nx;
  }
  // neighbour indices for offsets in {-1, 0, 1}
  __device__ __forceinline__ int jj(int dj) const {
    return dj == 0 ? j : (dj < 0 ? jm : jp);
  }
  __device__ __forceinline__ int ii(int di) const {
    return di == 0 ? i : (di < 0 ? im : ip);
  }
  __device__ __forceinline__ int64_t off(int dj, int di) const {
    return static_cast<int64_t>(jj(dj)) * nx + ii(di);
  }
};

// z-padded row kz (-1 .. nz) of a field given as interior + edge stack.
template <typename T>
__device__ __forceinline__ const T* zrow(const T* f, const T* e, int kz,
                                         int nz, int64_t plane) {
  if (kz < 0) return e;
  if (kz >= nz - 1) return e + static_cast<int64_t>(kz - nz + 2) * plane;
  return f + static_cast<int64_t>(kz) * plane;
}

// Value of the field at (k+dk, j+dj, i+di), offsets in {-1, 0, 1}.
template <typename T>
__device__ __forceinline__ T at(const T* f, const T* e, const Cell& c,
                                int dk, int dj, int di) {
  return __ldg(zrow(f, e, c.k + dk, c.nz, c.plane) + c.off(dj, di));
}

// The y-wall ghost rows of one field: rows (nz, 3, nx) = [padded y 0,
// padded y ny, padded y ny+1] (padded y ny is v's set_bc rewrite slot, the
// interior's last row for the others) and their z-edge stack, the corners
// (3, 3, nx), ordered as the field's own z-edge stack.
template <typename T>
struct YRows {
  const T* rows;
  const T* corners;
};

// Padded row kz (-1 .. nz) of a y-row stack: r in {0, 1, 2}.
template <typename T>
__device__ __forceinline__ const T* yrow(const YRows<T>& y, int kz, int r,
                                         int nz, int nx) {
  const int64_t n3 = 3 * static_cast<int64_t>(nx);
  const T* base = kz < 0 ? y.corners
                  : kz >= nz - 1 ? y.corners + (kz - nz + 2) * n3
                                 : y.rows + kz * n3;
  return base + static_cast<int64_t>(r) * nx;
}

// Whether a cell of row j reads a y-wall row (-1, ny-1 or ny) at offsets
// dj in {-1, 0, 1}.  The y-walled kernels send these rows, and only these,
// through at<true>: its per-read branch would cost every other row the
// memory-level parallelism of its plain reads.
__device__ __forceinline__ bool y_edge(int j, int ny) {
  return j == 0 || j >= ny - 2;
}

// at() with y walls when YW: the rows j+dj = -1, ny-1 and ny come from the
// y-row stack (and its corners at a z ghost or the z rewrite row), every
// other read from the interior and its z-edge stack.  This is the TPU
// accessor's _fix_y (pallas_kernels.py:317-342) without the wrap.
template <bool YW, typename T>
__device__ __forceinline__ T at(const T* f, const T* e, const YRows<T>& y,
                                const Cell& c, int dk, int dj, int di) {
  if (YW) {
    const int jy = c.j + dj;
    if (jy < 0 || jy >= c.ny - 1) {
      const int r = jy < 0 ? 0 : jy - c.ny + 2;
      return __ldg(yrow(y, c.k + dk, r, c.nz, c.nx) + c.ii(di));
    }
  }
  return at(f, e, c, dk, dj, di);
}

// The y modes of a stencil kernel: y periodic on the whole field, y walls
// (the y-row stacks above), or a slab of a y-sharded mesh whose rows -1 and
// ny come from its neighbours.
enum YMode { Y_PERIODIC = 0, Y_WALLS = 1, Y_HALO = 2 };

// The x modes of a stencil kernel: x periodic on the whole field, x walls
// (X_WALLS: the x stacks of xcol below, u's rewrite column, the x walls'
// van Driest), or a pencil of a 2D (gy, gx) mesh (X_HALO), whose columns -1
// and nx come from its x neighbours (parallel/mesh.halo_x) in the x
// stacks' form: column 0 the lower neighbour's last column, column 2 the
// upper neighbour's first, column 1 never read (no rewrite slot), their
// z-edge entries the corners; along y they always carry the rows -1 and
// ny (nyc = ny + 2, row jy at jy + 1: the neighbours' rows on a slab, the
// periodic wrap with gy = 1), so the (x +-1, y +-1) corners of mom_rk's
// and smag's tiles arrive by the y exchange of the x halo (the JAX
// package's _xe_pack completed by _halo_y, cales_tpu/timeloop.py:
// 998-1015).  Nothing of a wall is read in the halo mode.
enum XMode { X_PERIODIC = 0, X_WALLS = 1, X_HALO = 2 };

// The y halo of one field on a slab: rows (nz, 2, nx) = [row -1 (the lower
// neighbour's last row), row ny (the upper neighbour's first row)] and
// their z-edge stack entries, the corners (3, 2, nx), ordered as the
// field's own z-edge stack.  Row ny-1 is an interior row of the slab (with
// y walls it is v's wall face; the halo mode never takes it over).  The
// same struct as the y-row stack, two rows deep.
template <typename T>
__device__ __forceinline__ const T* hrow(const YRows<T>& h, int kz, int r,
                                         int nz, int nx) {
  const int64_t n2 = 2 * static_cast<int64_t>(nx);
  const T* base = kz < 0 ? h.corners
                  : kz >= nz - 1 ? h.corners + (kz - nz + 2) * n2
                                 : h.rows + kz * n2;
  return base + static_cast<int64_t>(r) * nx;
}

// Whether a cell of row j reads a row outside the plain accessor's at
// offsets dj in {-1, 0, 1}: the wall rows (y_edge) with y walls, rows -1
// and ny on a slab.  The kernels branch on it once a cell, so a warp (one
// row's run) takes one path.
template <int YM>
__device__ __forceinline__ bool y_edge_of(int j, int ny) {
  if (YM == Y_WALLS) return y_edge(j, ny);
  if (YM == Y_HALO) return j == 0 || j == ny - 1;
  return false;
}

// at() in y mode YM: Y_WALLS is at<true>; Y_HALO reads the rows j+dj = -1
// and ny from the halo (and its corners at a z ghost or the z rewrite
// row), every other read from the interior and its z-edge stack.
template <int YM, typename T>
__device__ __forceinline__ T aty(const T* f, const T* e, const YRows<T>& y,
                                 const Cell& c, int dk, int dj, int di) {
  if (YM == Y_WALLS) return at<true>(f, e, y, c, dk, dj, di);
  if (YM == Y_HALO) {
    const int jy = c.j + dj;
    if (jy < 0 || jy >= c.ny)
      return __ldg(hrow(y, c.k + dk, jy < 0 ? 0 : 1, c.nz, c.nx) + c.ii(di));
  }
  return at(f, e, c, dk, dj, di);
}

// The x-wall ghost columns of one field (XW, the x-walled classes): a
// YRows whose rows are the columns (nz, 3, nyc) = [padded x 0, padded x
// nx, padded x nx+1] (padded x nx is u's set_bc rewrite slot, the
// interior's last column for the others) and whose corners (3, 3, nyc) are
// their z-edge stack (ops/boundary.xedge_*).  Along y the columns wrap
// (nyc = ny) with periodic y, and hold the slab's rows on a slab (YL ==
// Y_HALO: fillps and correc read them in the cell's own row only); with y
// walls (YL == Y_WALLS) they carry their y ghosts and the y rewrite slot
// (nyc = ny + 2, row jy at jy + 1), the (y ghost, x ghost) corners of the
// sequential x -> y -> z fill.  (mom_rk and smag, which read the corners,
// take a slab's stacks with the neighbours' rows -1 and ny, nyc = ny + 2,
// by their own offsets.)
// Column r (0, 1, 2) at padded z kz (-1 .. nz) and row jy (-1 .. ny).
// With XM == X_HALO (below) the stacks always carry the rows -1 and ny.
template <int YL, int XM = X_WALLS, typename T>
__device__ __forceinline__ const T* xcol(const YRows<T>& x, int kz, int r,
                                         int jy, int nz, int ny) {
  constexpr bool pad = YL == Y_WALLS || XM == X_HALO;
  const int nyc = pad ? ny + 2 : ny;
  const int jj = pad ? jy + 1
                 : jy < 0       ? jy + ny
                 : jy >= ny     ? jy - ny
                                : jy;
  return yrow(x, kz, r, nz, nyc) + jj;
}

// An asynchronous copy of one value from global to shared memory
// (cp.async; a plain copy where the compiler targets no GPU), its group's
// commit, and the wait until at most N of this thread's groups are in
// flight: the copies are visible to the block after the wait and a barrier.
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "n"(sizeof(T)));
#else
  *dst = *src;
#endif
}
__device__ __forceinline__ void cp_async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

// q mod n for q a few n from [0, n): a tile's halo
__device__ __forceinline__ int wrap_near(int q, int n) {
  while (q < 0) q += n;
  while (q >= n) q -= n;
  return q;
}

__device__ __forceinline__ float cexp(float x) { return expf(x); }
__device__ __forceinline__ double cexp(double x) { return exp(x); }
__device__ __forceinline__ float csqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double csqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float cabs(float x) { return fabsf(x); }
__device__ __forceinline__ double cabs(double x) { return fabs(x); }
__device__ __forceinline__ float cln(float x) { return logf(x); }
__device__ __forceinline__ double cln(double x) { return log(x); }
// a product rounded on its own, never merged into an FMA
__device__ __forceinline__ float cmul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double cmul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float cfma(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double cfma(double a, double b, double c) {
  return fma(a, b, c);
}

// Strain rate of the staggered velocity at one cell centre
// (cales_torch/ops/stencil.strain_rate_core term by term, reference
// sgs.f90:1019-1110): diagonal terms exact at the centre, off-diagonal ones
// averaged over the four surrounding edges.  U, V, W(dk, dj, di) return the
// velocity at the offset cell (offsets in {-1, 0, 1}); dzci_c = dzci(k),
// dzci_m = dzci(k-1), dzfi_c = dzfi(k) in the ghost-inclusive metric
// arrays.  Returns |S| = sqrt(2 S_ij S_ij); sij, when given, receives
// (S11, S22, S33, S12, S13, S23).  Shared by correc_smag.cu, smag.cu
// (through ring_strain) and the dsmag kernels.
template <typename T, class FU, class FV, class FW>
__device__ __forceinline__ T strain_rate(const FU& U, const FV& V,
                                         const FW& W, T dxi, T dyi,
                                         T dzci_c, T dzci_m, T dzfi_c,
                                         T* sij = nullptr) {
  const T u000 = U(0, 0, 0), u00m = U(0, 0, -1), u0p0 = U(0, 1, 0);
  const T u0m0 = U(0, -1, 0), u0pm = U(0, 1, -1), u0mm = U(0, -1, -1);
  const T up00 = U(1, 0, 0), um00 = U(-1, 0, 0), up0m = U(1, 0, -1);
  const T um0m = U(-1, 0, -1);
  const T v000 = V(0, 0, 0), v0m0 = V(0, -1, 0), v00p = V(0, 0, 1);
  const T v0mp = V(0, -1, 1), v00m = V(0, 0, -1), v0mm = V(0, -1, -1);
  const T vp00 = V(1, 0, 0), vm00 = V(-1, 0, 0), vpm0 = V(1, -1, 0);
  const T vmm0 = V(-1, -1, 0);
  const T w000 = W(0, 0, 0), wm00 = W(-1, 0, 0), w00p = W(0, 0, 1);
  const T wm0p = W(-1, 0, 1), w00m = W(0, 0, -1), wm0m = W(-1, 0, -1);
  const T w0p0 = W(0, 1, 0), wmp0 = W(-1, 1, 0), w0m0 = W(0, -1, 0);
  const T wmm0 = W(-1, -1, 0);
  const T e = T(0.125), two = T(2);
  const T s11 = (u000 - u00m) * dxi;
  const T s22 = (v000 - v0m0) * dyi;
  const T s33 = (w000 - wm00) * dzfi_c;
  const T s12 = e * ((u0p0 - u000) * dyi + (v00p - v000) * dxi +
                     (u000 - u0m0) * dyi + (v0mp - v0m0) * dxi +
                     (u0pm - u00m) * dyi + (v000 - v00m) * dxi +
                     (u00m - u0mm) * dyi + (v0m0 - v0mm) * dxi);
  const T s13 = e * ((up00 - u000) * dzci_c + (w00p - w000) * dxi +
                     (u000 - um00) * dzci_m + (wm0p - wm00) * dxi +
                     (up0m - u00m) * dzci_c + (w000 - w00m) * dxi +
                     (u00m - um0m) * dzci_m + (wm00 - wm0m) * dxi);
  const T s23 = e * ((vp00 - v000) * dzci_c + (w0p0 - w000) * dyi +
                     (v000 - vm00) * dzci_m + (wmp0 - wm00) * dyi +
                     (vpm0 - v0m0) * dzci_c + (w000 - w0m0) * dyi +
                     (v0m0 - vmm0) * dzci_m + (wm00 - wmm0) * dyi);
  if (sij != nullptr) {
    sij[0] = s11;
    sij[1] = s22;
    sij[2] = s33;
    sij[3] = s12;
    sij[4] = s13;
    sij[5] = s23;
  }
  return csqrt(two * (s11 * s11 + s22 * s22 + s33 * s33 +
                      two * (s12 * s12 + s13 * s13 + s23 * s23)));
}

// strain_rate at the centre cell co of a z-march's planes in shared memory
// (smag.cu, correc_smag.cu): u and v on the planes below, at and above the
// cell (u[0], u[1], u[2]), w below and at it (w[0], w[1]), each plane a
// tile with a halo of 1, CX values a row.
template <typename T, int CX>
__device__ __forceinline__ T ring_strain(const T* const (&u)[3],
                                         const T* const (&v)[3],
                                         const T* const (&w)[2], int co,
                                         T dxi, T dyi, T dzci_c, T dzci_m,
                                         T dzfi_c) {
  auto U = [&](int dk, int dj, int di) {
    return u[dk + 1][co + dj * CX + di];
  };
  auto V = [&](int dk, int dj, int di) {
    return v[dk + 1][co + dj * CX + di];
  };
  auto W = [&](int dk, int dj, int di) {
    return w[dk + 1][co + dj * CX + di];
  };
  return strain_rate<T>(U, V, W, dxi, dyi, dzci_c, dzci_m, dzfi_c);
}

// Static Smagorinsky with van Driest damping (sgs.f90:104-152):
// (Cs Delta)^2 fd^2 |S|, fd = 1 - exp(-dw+ / 25), dw+ = dw sqrt(tau_w) /
// visc with tau_w = visc tauw / 2 from the nearer wall's shear plane.
template <typename T>
__device__ __forceinline__ T van_driest_nut(T s0, T csd2, T dw, T tauw,
                                            T visc) {
  const T tauw_s = T(0.5) * visc * tauw;
  const T dw_plus = dw * csqrt(tauw_s) / visc;
  const T fd = T(1) - cexp(-dw_plus / T(25));
  return csd2 * fd * fd * s0;
}

// Sum of v over the block; the result is valid in thread 0.  Every thread
// of the block must call it.
template <typename T>
__device__ T block_sum(T v) {
  __shared__ T part[CALES_THREADS / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = v;
  __syncthreads();
  T s = T(0);
  if (threadIdx.x == 0) {
    for (int w = 0; w < CALES_THREADS / 32; ++w) s += part[w];
  }
  __syncthreads();  // part may be reused by the next call
  return s;
}

inline dim3 plane_grid(int nz, int ny, int nx) {
  const int64_t plane = static_cast<int64_t>(ny) * nx;
  return dim3(static_cast<unsigned>((plane + CALES_THREADS - 1) /
                                    CALES_THREADS),
              static_cast<unsigned>(nz), 1);
}

}  // namespace cales
