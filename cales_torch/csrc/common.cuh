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
// is never read.  x and y are periodic and wrap here.
#pragma once

#include <cstdint>
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

__device__ __forceinline__ float cexp(float x) { return expf(x); }
__device__ __forceinline__ double cexp(double x) { return exp(x); }
__device__ __forceinline__ float csqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double csqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float cabs(float x) { return fabsf(x); }
__device__ __forceinline__ double cabs(double x) { return fabs(x); }
__device__ __forceinline__ float cfma(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double cfma(double a, double b, double c) {
  return fma(a, b, c);
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
