// The tiled fp32/fp64 GEMM shared by apply_y.cu and apply_x.cu.
//
// C[b] = A[b] (M x K) . B[b] (K x N), row-major, batch b = blockIdx.z with
// element strides sA, sB, sC (0: a shared operand).  Each block computes a
// 128x128 tile of C with 256 threads, an 8x8 register tile each, from
// 128x8 / 8x128 tiles of A and B staged in shared memory; the next tiles'
// global loads are issued before the current tile's FMAs.  The sums stay in
// fp32 (fp64) FMA, never TF32.
//
// KCH: A is stored as column chunks, the K columns split into chunks of
// kch, chunk q at A + q * sAk with leading dimension lda (= kch): the
// (gy, rows, nx / gy) blocks an all-to-all delivers, read as one (rows, nx)
// operand without gathering them first.  With KCH false (apply_y, and
// apply_x on a whole slab) the code is the plain row-major GEMM.
#pragma once

#include "common.cuh"

namespace cales {
namespace {

constexpr int GM = 128;  // C tile rows
constexpr int GN = 128;  // C tile cols
constexpr int GK = 8;    // k depth of one shared-memory stage
constexpr int GPAD = 4;  // As row padding: conflict-free transposed stores

// Four consecutive shared-memory values (16-byte aligned for float).
template <typename T>
__device__ __forceinline__ void ld4(const T* p, T* r) {
  r[0] = p[0]; r[1] = p[1]; r[2] = p[2]; r[3] = p[3];
}
template <>
__device__ __forceinline__ void ld4<float>(const float* p, float* r) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
}
template <>
__device__ __forceinline__ void ld4<double>(const double* p, double* r) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  r[0] = a.x; r[1] = a.y; r[2] = b.x; r[3] = b.y;
}

// Thread (tx, ty) = (tid % 16, tid / 16) owns rows {ty*4 + i, 64 + ty*4 + i}
// and columns {tx*4 + j, 64 + tx*4 + j}, i, j < 4.
template <typename T, bool KCH>
__global__ void __launch_bounds__(256) gemm_kernel(
    const T* __restrict__ A, const T* __restrict__ B, T* __restrict__ C,
    int M, int N, int K, int lda, int ldb, int ldc, int64_t sA, int64_t sB,
    int64_t sC, int kch, int64_t sAk) {
  __shared__ __align__(16) T As[GK][GM + GPAD];
  __shared__ __align__(16) T Bs[GK][GN];
  const int64_t bz = blockIdx.z;
  A += bz * sA;
  B += bz * sB;
  C += bz * sC;
  const int m0 = blockIdx.y * GM, n0 = blockIdx.x * GN;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  // global -> register staging: A element (m0 + tid/8 + 32q, k0 + tid%8),
  // B element (k0 + tid/128 + 2q, n0 + tid%128), q < 4
  const int am = tid >> 3, ak = tid & 7, bk = tid >> 7, bn = tid & 127;
  T ra[4], rb[4];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int m = m0 + am + 32 * q, k = k0 + ak;
      if (KCH) {
        const int kq = k / kch;
        ra[q] = (m < M && k < K)
                    ? A[kq * sAk + static_cast<int64_t>(m) * lda + (k - kq * kch)]
                    : T(0);
      } else {
        ra[q] = (m < M && k < K) ? A[static_cast<int64_t>(m) * lda + k] : T(0);
      }
      const int kb = k0 + bk + 2 * q, n = n0 + bn;
      rb[q] = (kb < K && n < N) ? B[static_cast<int64_t>(kb) * ldb + n]
                                : T(0);
    }
  };
  T acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = T(0);

  fetch(0);
  for (int k0 = 0; k0 < K; k0 += GK) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      As[ak][am + 32 * q] = ra[q];
      Bs[bk + 2 * q][bn] = rb[q];
    }
    __syncthreads();
    if (k0 + GK < K) fetch(k0 + GK);
#pragma unroll
    for (int kk = 0; kk < GK; ++kk) {
      T a[8], b[8];
      ld4(&As[kk][ty * 4], a);
      ld4(&As[kk][64 + ty * 4], a + 4);
      ld4(&Bs[kk][tx * 4], b);
      ld4(&Bs[kk][64 + tx * 4], b + 4);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = cfma(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
    T* crow = C + static_cast<int64_t>(m) * ldc;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n < N) crow[n] = acc[i][j];
    }
  }
}

// kch > 0: A in column chunks of kch at stride sAk (KCH above).
template <typename T>
int launch_gemm(const T* A, const T* B, T* C, int M, int N, int K, int lda,
                int ldb, int ldc, int64_t sA, int64_t sB, int64_t sC,
                int batch, cudaStream_t stream, int kch = 0,
                int64_t sAk = 0) {
  const dim3 grid((N + GN - 1) / GN, (M + GM - 1) / GM, batch);
  if (grid.y > 65535u || grid.z > 65535u)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if (kch > 0) {
    gemm_kernel<T, true><<<grid, 256, 0, stream>>>(
        A, B, C, M, N, K, lda, ldb, ldc, sA, sB, sC, kch, sAk);
  } else {
    gemm_kernel<T, false><<<grid, 256, 0, stream>>>(
        A, B, C, M, N, K, lda, ldb, ldc, sA, sB, sC, 0, 0);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace cales
