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
// Bound on the H100: arithmetic.  2 nz ny nx (nx + ny) flops, 51.5 GFLOP a
// call at 512x256x256 (275 GFLOP at 512^3).  In float32 gemm.cuh runs them
// as 3xTF32 on the tensor cores (three TF32 products a product, fp32
// sums): 0.312 ms at 495 / 3 TFLOP/s (1.67 ms at 512^3), where the SIMT
// fp32 FMA body it replaced was bound at 0.769 ms by 67 TFLOP/s; the
// fields' bytes (in, tmp and out) take 0.08 ms more.  float64 keeps the
// SIMT FMA body.  Both passes take B N-major as it lies (MxT; tmp[z]):
// gemm.cuh's split of B into the K-major tiles that wgmma reads is its
// transpose too, so neither pass needs a transposed copy.
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
