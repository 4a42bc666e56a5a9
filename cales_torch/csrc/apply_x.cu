// x operator transform of the slab-sharded Poisson solve:
// out[z, y, :] = in[z, y, :] . MxT.
//
// Replaces: cales_tpu/ops/pallas_solve.py apply_x, the x operator matmul
// that poisson.solve_sharded_pallas runs on each y slab while x is still
// local, before the y <-> x all-to-all (forward) and after it (backward).
// MxT is the transposed (nx, nx) x transform matrix.
//
// Design.  The whole call is one flat GEMM, (rows, nx) x (nx, nx) with rows
// = nz * ny_slab, through gemm.cuh (the same body as apply_y.cu's pass 1,
// shared rather than copied: 3xTF32 on the tensor cores in float32, the
// SIMT FMA body in float64).  Two layouts spare the
// all-to-all its copies:
//   out_chunks = g > 1: out is (g, rows, nx / g), the x columns split into
//     g chunks, chunk q the block the all-to-all sends to rank q: a batch of
//     g GEMMs, each against the q-th column block of MxT;
//   in_chunks = g > 1: in is (g, rows, nx / g), the blocks an all-to-all
//     delivered (chunk q = x columns q nx/g ..), read as one (rows, nx)
//     operand in K chunks (gemm.cuh KCH) without gathering it first.
// The TPU kernel aliases its output onto its input; on the card the call
// is out of place.
//
// Bound on the H100: arithmetic.  2 rows nx^2 flops, 17.2 GFLOP at the
// (256, 128, 512) slab of the 512x256x256 channel on two ranks: 0.104 ms
// at the 3xTF32 rate of float32 (495 / 3 TFLOP/s; the SIMT fp32 FMA body
// it replaced was bound at 0.256 ms by 67 TFLOP/s); its bytes (in, out
// and MxT once) take 0.040 ms.  The chunked layouts change only the
// addresses that the cp.async copies read and the stores write.
#include "gemm.cuh"

namespace cales {

template <typename T>
int launch_apply_x(const T* in, const T* MxT, T* out, int rows, int nx,
                   int in_chunks, int out_chunks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows < 1 || nx < 1 || in_chunks < 1 || out_chunks < 1 ||
      nx % in_chunks != 0 || nx % out_chunks != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nxo = nx / out_chunks;
  const int nxi = nx / in_chunks;
  const int64_t block_o = static_cast<int64_t>(rows) * nxo;
  const int64_t block_i = static_cast<int64_t>(rows) * nxi;
  if (in_chunks == 1)
    return launch_gemm<T>(in, MxT, out, rows, nxo, nx, nx, nx, nxo, 0, nxo,
                          block_o, out_chunks, s);
  return launch_gemm<T>(in, MxT, out, rows, nxo, nx, nxi, nx, nxo, 0, nxo,
                        block_o, out_chunks, s, nxi, block_i);
}

}  // namespace cales

#define CALES_APPLY_X_ENTRY(NAME, T)                                         \
  extern "C" int NAME(const T* in, const T* MxT, T* out, int rows, int nx,   \
                      int in_chunks, int out_chunks, void* stream) {         \
    return cales::launch_apply_x<T>(in, MxT, out, rows, nx, in_chunks,       \
                                    out_chunks, stream);                     \
  }

CALES_APPLY_X_ENTRY(cales_apply_x_f32, float)
CALES_APPLY_X_ENTRY(cales_apply_x_f64, double)
