// z stage of the Poisson solve by eigendecomposition, one pass:
//   out[:, j, i] = Vr . (inv(:, j, i) * (Vl . in[:, j, i]))
//   inv = 1 / (lamz + lamy[j] + lamx[i]), zero where |lam| <= tol
// (the singular constant mode projected out, poisson.py:388-393).
//
// Replaces: cales_tpu/ops/pallas_solve.py apply_z_eig.  The field is read
// as the (nz, ny*nx) matrix X; every column (y, x) is independent.
//
// Design.  A block owns a tile of BN columns over all nz rows: it loads
// X[:, tile] into shared memory once (nz*BN values, 64 KB at nz = 256 in
// f32), computes hat = Vl . X[:, tile] with Vl streamed through shared
// memory in k-tiles of 8 columns, scales hat by inv in registers, writes it
// back over the X tile, then computes out = Vr . hat the same way and
// writes it.  Each field value is read once and written once, as in the
// TPU kernel; Vl and Vr (256 KB each in f32) come from L2.  Thread (tx, ty)
// owns rows ty*RM .. ty*RM + RM-1 and columns tx*TN .. tx*TN + TN-1 of the
// tile; RM is the template's rows per thread (nz <= 16 RM, up to 384).
//
// Bound on the H100: fp32 arithmetic, 4 nz^2 ny nx flops (34 GFLOP at
// 512x256x256) in fp32 FMA (never TF32), against ~67 TFLOP/s of SIMT fp32.
// The block's whole M dimension is nz, so each k-step is RM + TN shared
// loads for RM*TN FMAs.
#include "common.cuh"

namespace cales {

constexpr int ZK = 8;  // k depth of one Vl/Vr stage

template <typename T, int TN>
__device__ __forceinline__ void ldn(const T* p, T* r) {
#pragma unroll
  for (int c = 0; c < TN; ++c) r[c] = p[c];
}
template <>
__device__ __forceinline__ void ldn<float, 4>(const float* p, float* r) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
}
template <>
__device__ __forceinline__ void ldn<double, 2>(const double* p, double* r) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  r[0] = v.x; r[1] = v.y;
}

// acc (rows of this thread x its TN columns) = V . X over k < nz.
template <typename T, int RM, int BN>
__device__ __forceinline__ void zgemm(const T* __restrict__ V, const T* X,
                                      T* Vs, int nz, T (&acc)[RM][BN / 16]) {
  constexpr int TN = BN / 16;
  constexpr int MR = 16 * RM + 1;  // Vs row stride (padded)
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = T(0);
  for (int k0 = 0; k0 < nz; k0 += ZK) {
    __syncthreads();  // previous stage's Vs reads are done
    for (int e = tid; e < ZK * 16 * RM; e += 256) {
      const int kk = e % ZK, row = e / ZK, k = k0 + kk;
      Vs[kk * MR + row] = (row < nz && k < nz)
                              ? V[static_cast<int64_t>(row) * nz + k]
                              : T(0);
    }
    __syncthreads();
    const int kmax = min(ZK, nz - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      T a[RM], b[TN];
#pragma unroll
      for (int r = 0; r < RM; ++r) a[r] = Vs[kk * MR + ty * RM + r];
      ldn<T, TN>(X + static_cast<int64_t>(k0 + kk) * BN + tx * TN, b);
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[r][c] = cfma(a[r], b[c], acc[r][c]);
    }
  }
}

template <typename T, int RM, int BN>
__global__ void __launch_bounds__(256) z_eig_kernel(
    const T* __restrict__ in, T* __restrict__ out, const T* __restrict__ Vl,
    const T* __restrict__ Vr, const T* __restrict__ lamz,
    const T* __restrict__ lamy, const T* __restrict__ lamx, int nz, int ny,
    int nx, T tol) {
  constexpr int TN = BN / 16;
  extern __shared__ __align__(16) unsigned char zsmem[];
  T* X = reinterpret_cast<T*>(zsmem);          // [nz][BN]
  T* Vs = X + static_cast<int64_t>(nz) * BN;   // [ZK][16 RM + 1]
  const int64_t N = static_cast<int64_t>(ny) * nx;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * BN;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  for (int e = tid; e < nz * BN; e += 256) {
    const int k = e / BN, c = e % BN;
    const int64_t n = n0 + c;
    X[e] = n < N ? in[static_cast<int64_t>(k) * N + n] : T(0);
  }
  T acc[RM][TN];
  zgemm<T, RM, BN>(Vl, X, Vs, nz, acc);
  __syncthreads();  // every X read is done: hat overwrites the tile
#pragma unroll
  for (int c = 0; c < TN; ++c) {
    const int col = tx * TN + c;
    const int64_t n = n0 + col;
    T lxy = T(0);
    const bool live = n < N;
    if (live) {
      const int j = static_cast<int>(n / nx);
      const int i = static_cast<int>(n - static_cast<int64_t>(j) * nx);
      lxy = lamy[j] + lamx[i];
    }
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int row = ty * RM + r;
      if (row >= nz) continue;
      const T lam = lamz[row] + lxy;
      const T inv = (live && cabs(lam) > tol) ? T(1) / lam : T(0);
      X[static_cast<int64_t>(row) * BN + col] = acc[r][c] * inv;
    }
  }
  zgemm<T, RM, BN>(Vr, X, Vs, nz, acc);
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int row = ty * RM + r;
    if (row >= nz) continue;
    T* orow = out + static_cast<int64_t>(row) * N;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int64_t n = n0 + tx * TN + c;
      if (n < N) orow[n] = acc[r][c];
    }
  }
}

template <typename T, int RM>
int launch_z_eig_rm(const T* in, T* out, const T* Vl, const T* Vr,
                    const T* lamz, const T* lamy, const T* lamx, int nz,
                    int ny, int nx, double tol, cudaStream_t stream) {
  constexpr int BN = sizeof(T) == 4 ? 64 : 32;
  const size_t smem = (static_cast<size_t>(nz) * BN +
                       static_cast<size_t>(ZK) * (16 * RM + 1)) * sizeof(T);
  auto kern = &z_eig_kernel<T, RM, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t N = static_cast<int64_t>(ny) * nx;
  const dim3 grid(static_cast<unsigned>((N + BN - 1) / BN));
  kern<<<grid, 256, smem, stream>>>(in, out, Vl, Vr, lamz, lamy, lamx, nz,
                                    ny, nx, T(tol));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_z_eig(const T* in, T* out, const T* Vl, const T* Vr,
                 const T* lamz, const T* lamy, const T* lamx, int nz, int ny,
                 int nx, double tol, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALES_ZEIG_RM(RM)                                                  \
  if (nz <= 16 * RM)                                                       \
    return launch_z_eig_rm<T, RM>(in, out, Vl, Vr, lamz, lamy, lamx, nz,   \
                                  ny, nx, tol, s);
  CALES_ZEIG_RM(2)
  CALES_ZEIG_RM(4)
  CALES_ZEIG_RM(8)
  CALES_ZEIG_RM(16)
  CALES_ZEIG_RM(24)
#undef CALES_ZEIG_RM
  return static_cast<int>(cudaErrorInvalidValue);  // nz > 384: Thomas z
}

}  // namespace cales

#define CALES_Z_EIG_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const T* in, T* out, const T* Vl, const T* Vr,        \
                      const T* lamz, const T* lamy, const T* lamx, int nz,  \
                      int ny, int nx, double tol, void* stream) {           \
    return cales::launch_z_eig<T>(in, out, Vl, Vr, lamz, lamy, lamx, nz,    \
                                  ny, nx, tol, stream);                     \
  }

CALES_Z_EIG_ENTRY(cales_z_eig_f32, float)
CALES_Z_EIG_ENTRY(cales_z_eig_f64, double)
