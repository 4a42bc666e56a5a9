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
// reads `in` directly.  The GEMM is gemm.cuh's, shared with apply_x.cu.
//
// Bound on the H100: fp32 arithmetic.  2 nz ny nx (nx + ny) flops, 51.5
// GFLOP a call at 512x256x256, against ~67 TFLOP/s of SIMT fp32 (no tensor
// cores: the sums stay in fp32 FMA, never TF32).  Each block computes a
// 128x128 tile of C with 256 threads, an 8x8 register tile each, from
// 128x8 / 8x128 tiles of A and B staged in shared memory; the next tiles'
// global loads are issued before the current tile's FMAs.  Tensor-core
// 3xTF32 (mma.sync / wgmma) and TMA are later work.
#include "gemm.cuh"

namespace cales {

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
