// z stage of the Poisson solve by eigendecomposition:
//   out[:, j, i] = Vr . (inv(:, j, i) * (Vl . in[:, j, i]))
//   inv = 1 / (lamz + lamy[j] + lamx[i]), zero where |lam| <= tol
// (the singular constant mode projected out, poisson.py:388-393).
//
// Replaces: cales_tpu/ops/pallas_solve.py:168 apply_z_eig.  The field is
// read as the (nz, ny*nx) matrix X; every column (y, x) is independent.
//
// float32: two products on the tensor cores, gemm.cuh's 3xTF32 wgmma body
// (never one TF32 product alone).  The first, hat = Vl . X, leaves through
// the epilogue ZEigScale, which scales element (m, n = j nx + i) by
// inv(m, j, i) as the f64 body below does (lamy[j] + lamx[i] once a
// column, then lamz[m] + that, 1 / lam, zero at |lam| <= tol) and writes
// the (nz, ny*nx) scratch hat; the second, out = Vr . hat, stores as it
// is.  A and the M dimension are the nz x nz operators, B and N the field
// (N-major, as gemm.cuh takes it), K = nz.  The scratch's round trip is
// 2 nz ny nx floats (268 MB at 512x256x256, 0.08 ms at 3.35 TB/s); a fused
// kernel keeping the scaled hat in shared memory needs all nz rows of a
// column tile in one block, and is later work.
// Both products sum each k step of 8 apart (gemm.cuh's k_step_sums: the
// step's three products in a fragment of their own, added to the fp32 sum
// by a round-to-nearest add), where apply_y sums each tile of 32 apart:
// at nz = 32, one tile, the tile's four truncated sums of big products
// carried the z stage's float32 error, and through the pressure the dsmag
// cavity's nu_t, past what the SIMT body it replaces had.
//
// Bound on the H100: 4 nz^2 ny nx flops (34.4 GFLOP at 512x256x256) at
// 495 / 3 TFLOP/s (three TF32 products a product): 0.209 ms; the field's
// bytes (in read, out written: 0.27 GB, 0.08 ms) are below it.
//
// float64: the SIMT FMA body, one pass.  A block owns a tile of BN columns
// over all nz rows: it loads X[:, tile] into shared memory once, computes
// hat = Vl . X[:, tile] with Vl streamed through shared memory in k-tiles
// of 8 columns, scales hat by inv in registers, writes it back over the X
// tile, then computes out = Vr . hat the same way and writes it.  Thread
// (tx, ty) owns rows ty*RM .. ty*RM + RM-1 and columns tx*CN .. tx*CN +
// CN-1 of the tile; RM is the template's rows per thread (nz <= 16 RM, up
// to 384).  Bound: 34.4 GFLOP at the data sheet's 34 TFLOP/s f64.
#include "gemm.cuh"

namespace cales {

constexpr int ZK = 8;  // k depth of one Vl/Vr stage

template <typename T, int CN>
__device__ __forceinline__ void ldn(const T* p, T* r) {
#pragma unroll
  for (int c = 0; c < CN; ++c) r[c] = p[c];
}
template <>
__device__ __forceinline__ void ldn<double, 2>(const double* p, double* r) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  r[0] = v.x; r[1] = v.y;
}

// acc (rows of this thread x its CN columns) = V . X over k < nz.
template <typename T, int RM, int BN>
__device__ __forceinline__ void zgemm(const T* __restrict__ V, const T* X,
                                      T* Vs, int nz, T (&acc)[RM][BN / 16]) {
  constexpr int CN = BN / 16;
  constexpr int MR = 16 * RM + 1;  // Vs row stride (padded)
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < CN; ++c) acc[r][c] = T(0);
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
      T a[RM], b[CN];
#pragma unroll
      for (int r = 0; r < RM; ++r) a[r] = Vs[kk * MR + ty * RM + r];
      ldn<T, CN>(X + static_cast<int64_t>(k0 + kk) * BN + tx * CN, b);
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < CN; ++c) acc[r][c] = cfma(a[r], b[c], acc[r][c]);
    }
  }
}

template <typename T, int RM, int BN>
__global__ void __launch_bounds__(256) z_eig_kernel(
    const T* __restrict__ in, T* __restrict__ out, const T* __restrict__ Vl,
    const T* __restrict__ Vr, const T* __restrict__ lamz,
    const T* __restrict__ lamy, const T* __restrict__ lamx, int nz, int ny,
    int nx, T tol) {
  constexpr int CN = BN / 16;
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
  T acc[RM][CN];
  zgemm<T, RM, BN>(Vl, X, Vs, nz, acc);
  __syncthreads();  // every X read is done: hat overwrites the tile
#pragma unroll
  for (int c = 0; c < CN; ++c) {
    const int col = tx * CN + c;
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
    for (int c = 0; c < CN; ++c) {
      const int64_t n = n0 + tx * CN + c;
      if (n < N) orow[n] = acc[r][c];
    }
  }
}

template <typename T, int RM>
int launch_z_eig_rm(const T* in, T* out, const T* Vl, const T* Vr,
                    const T* lamz, const T* lamy, const T* lamx, int nz,
                    int ny, int nx, double tol, cudaStream_t stream) {
  constexpr int BN = 32;
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

// float64: the SIMT body, RM rows a thread
int launch_z_eig(const double* in, double* out, double*, const double* Vl,
                 const double* Vr, const double* lamz, const double* lamy,
                 const double* lamx, int nz, int ny, int nx, double tol,
                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALES_ZEIG_RM(RM)                                                   \
  if (nz <= 16 * RM)                                                        \
    return launch_z_eig_rm<double, RM>(in, out, Vl, Vr, lamz, lamy, lamx,   \
                                       nz, ny, nx, tol, s);
  CALES_ZEIG_RM(2)
  CALES_ZEIG_RM(4)
  CALES_ZEIG_RM(8)
  CALES_ZEIG_RM(16)
  CALES_ZEIG_RM(24)
#undef CALES_ZEIG_RM
  return static_cast<int>(cudaErrorInvalidValue);  // nz > 384: Thomas z
}

// The first product's epilogue: element (m, n) times inv(m, j, i).
struct ZEigScale {
  static constexpr bool by_column = true;
  static constexpr bool k_step_sums = true;
  const float* lamz;
  const float* lamy;
  const float* lamx;
  int nx;
  float tol;
  struct Col {
    float lxy;
  };
  __device__ __forceinline__ Col col(int n) const {
    const int j = n / nx, i = n - j * nx;
    return {__ldg(lamy + j) + __ldg(lamx + i)};
  }
  __device__ __forceinline__ float operator()(const Col& c, int m,
                                              float x) const {
    const float lam = __ldg(lamz + m) + c.lxy;
    const float inv = cabs(lam) > tol ? 1.0f / lam : 0.0f;
    return x * inv;
  }
};
// The second product's: the plain store, under a name of z_eig's so that a
// profile tells its launches from apply_y's and apply_x's.
struct ZEigStore : EpiStore {
  static constexpr bool k_step_sums = true;
};

// float32: hat = inv * (Vl . in) into the scratch, then out = Vr . hat.
int launch_z_eig(const float* in, float* out, float* hat, const float* Vl,
                 const float* Vr, const float* lamz, const float* lamy,
                 const float* lamx, int nz, int ny, int nx, double tol,
                 void* stream) {
  const int64_t N = static_cast<int64_t>(ny) * nx;
  if (nz < 1 || nz > 384 || N < 1 || N > INT32_MAX - TN || hat == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(N);
  const dim3 grid((n + TN - 1) / TN, (nz + TM - 1) / TM, 1);
  int rc = launch_tf32x3<false, ZEigScale>(
      Vl, in, hat, nz, n, nz, nz, n, n, 0, 0, 0, grid, s, 0, 0,
      ZEigScale{lamz, lamy, lamx, nx, static_cast<float>(tol)});
  if (rc != 0) return rc;
  return launch_tf32x3<false, ZEigStore>(Vr, hat, out, nz, n, nz, nz, n, n,
                                         0, 0, 0, grid, s, 0, 0);
}

}  // namespace cales

// hat: a (nz, ny, nx) float32 scratch (null in float64)
#define CALES_Z_EIG_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const T* in, T* out, T* hat, const T* Vl,             \
                      const T* Vr, const T* lamz, const T* lamy,            \
                      const T* lamx, int nz, int ny, int nx, double tol,    \
                      void* stream) {                                       \
    return cales::launch_z_eig(in, out, hat, Vl, Vr, lamz, lamy, lamx, nz,  \
                               ny, nx, tol, stream);                        \
  }

CALES_Z_EIG_ENTRY(cales_z_eig_f32, float)
CALES_Z_EIG_ENTRY(cales_z_eig_f64, double)
