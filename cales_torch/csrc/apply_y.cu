// x + y operator transforms of the Poisson solve: out[z] = M . in[z] . MxT.
//
// Replaces: cales_tpu/ops/pallas_solve.py apply_y, with and without the
// fused x operator (MxT, the transposed x transform matrix; the variant
// poisson.solve(pallas=True, pre_xformed_x=False) runs).  M is the dense
// (ny, ny) y operator (cos rows, then sin rows for periodic y,
// ops/transforms.make_transform); MxT the (nx, nx) x operator.
//
// Design.  One (ny, nx) plane is 512 KB in f32 at the 512x256x256 shape,
// more than the 227 KB of shared memory a block has, so the TPU kernel's
// one-pass fusion (the whole plane in VMEM) does not carry over.  The call
// is two passes of one hand-written tiled GEMM instead:
//   pass 1 (with MxT):  tmp (nz*ny, nx) = in (nz*ny, nx) . MxT   (one GEMM)
//   pass 2:             out[z] = M . tmp[z]                       (batch nz)
// through a scratch field that the wrapper allocates.  Without MxT pass 2
// reads `in` directly.
//
// Bound on the H100: fp32 arithmetic.  2 nz ny nx (nx + ny) flops, 51.5
// GFLOP a call at 512x256x256, against ~67 TFLOP/s of SIMT fp32 (no tensor
// cores: the sums stay in fp32 FMA, never TF32).  Each block computes a
// 128x128 tile of C with 256 threads, an 8x8 register tile each, from
// 128x8 / 8x128 tiles of A and B staged in shared memory; the next tiles'
// global loads are issued before the current tile's FMAs.  Tensor-core
// 3xTF32 (mma.sync / wgmma) and TMA are later work.
#include "common.cuh"

namespace cales {

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

// C[b] = A[b] (M x K, leading dim lda) . B[b] (K x N, ldb), row-major,
// batch b = blockIdx.z with element strides sA, sB, sC (0: shared operand).
// Thread (tx, ty) = (tid % 16, tid / 16) owns rows {ty*4 + i, 64 + ty*4 + i}
// and columns {tx*4 + j, 64 + tx*4 + j}, i, j < 4.
template <typename T>
__global__ void __launch_bounds__(256) gemm_kernel(
    const T* __restrict__ A, const T* __restrict__ B, T* __restrict__ C,
    int M, int N, int K, int lda, int ldb, int ldc, int64_t sA, int64_t sB,
    int64_t sC) {
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
      ra[q] = (m < M && k < K) ? A[static_cast<int64_t>(m) * lda + k] : T(0);
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

template <typename T>
int launch_gemm(const T* A, const T* B, T* C, int M, int N, int K, int lda,
                int ldb, int ldc, int64_t sA, int64_t sB, int64_t sC,
                int batch, cudaStream_t stream) {
  const dim3 grid((N + GN - 1) / GN, (M + GM - 1) / GM, batch);
  if (grid.y > 65535u || grid.z > 65535u)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  gemm_kernel<T><<<grid, 256, 0, stream>>>(A, B, C, M, N, K, lda, ldb, ldc,
                                            sA, sB, sC);
  return static_cast<int>(cudaGetLastError());
}

// out[z] = M . in[z] (. MxT): pass 1 into tmp when MxT is given.
template <typename T>
int launch_apply_y(const T* in, const T* M, const T* MxT, T* tmp, T* out,
                   int nz, int ny, int nx, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t plane = static_cast<int64_t>(ny) * nx;
  const T* src = in;
  if (MxT != nullptr) {
    const int64_t rows = static_cast<int64_t>(nz) * ny;
    if (rows > (int64_t(1) << 30))
      return static_cast<int>(cudaErrorInvalidValue);
    const int rc = launch_gemm<T>(in, MxT, tmp, static_cast<int>(rows), nx,
                                  nx, nx, nx, nx, 0, 0, 0, 1, s);
    if (rc != 0) return rc;
    src = tmp;
  }
  return launch_gemm<T>(M, src, out, ny, nx, ny, ny, nx, nx, 0, plane, plane,
                        nz, s);
}

}  // namespace cales

#define CALES_APPLY_Y_ENTRY(NAME, T)                                        \
  extern "C" int NAME(const T* in, const T* M, const T* MxT, T* tmp, T* out, \
                      int nz, int ny, int nx, void* stream) {               \
    return cales::launch_apply_y<T>(in, M, MxT, tmp, out, nz, ny, nx,       \
                                    stream);                                \
  }

CALES_APPLY_Y_ENTRY(cales_apply_y_f32, float)
CALES_APPLY_Y_ENTRY(cales_apply_y_f64, double)
