// The wall model's Neumann planes on the wall-modelled z faces, one launch.
//
// Replaces no Pallas kernel: the JAX package computes these planes in XLA
// (cales_tpu/wallmodel.py:253 z_wall_wm_planes, fed by
// cales_tpu/timeloop.py:677 _wm_bcs_fast and the fused correction's
// corrected rows, timeloop.py:1314-1342), where the fixed Newton loop
// fuses into a few kernels.  Run eagerly in torch it is about 350 small
// operations a face, called once a substep; here it is one launch.
// Twin: cales_torch/wallmodel.py wm_planes_plain.
//
// Per face (blockIdx.y, one or two faces) a thread owns one (j, i) point
// of the face's padded (ny+2, nx+2) output planes.  It samples rows r1 and
// r2 of u and v around its point, wrapped along the periodic x and y,
// as they are or, with `corrected`, as the fused correction makes them:
// fu + u - cx (pp(i+1) - pp(i)), fv + v - cy (pp(j+1) - pp(j)), in this
// order of operations.
// It interpolates them to hwm, makes them relative to the face's static
// wall velocity, and runs the log-law Newton iteration (a fixed n_newton
// steps, in registers) or the laminar profile (wmodel.f90:222-335).  bcu
// is written over [1:ny+1, 0:nx+1] and bcv over [0:ny+1, 1:nx+1]; the
// rest of each plane keeps the face's static value.  Output (nf, 2,
// ny+2, nx+2): [face][bcu, bcv].
//
// Bound on the H100: bytes, at a few microseconds.  At 512x256 it reads
// two rows each of u and v a face (and of pp, corrected) and writes two
// padded planes a face: about 5.3 MB in f32, 1.6 us at 3.35 TB/s; its
// arithmetic (two Newton solves a point, each 12 steps of a logarithm and
// three divisions) about 1.2 us at 67 TFLOP/s.  The launch is the cost.
#include "common.cuh"

namespace cales {

template <typename T>
struct WmFace {  // one wall-modelled face (wallmodel.ZFace)
  int mtype;     // 1 log-law, -1 laminar
  int r1, r2;    // the interior rows that bracket hwm
  T omc, coef;   // 1 - coef, coef
  T sv;          // sgn / visc
  T umag, vmag;  // the face's static wall-parallel values
};

template <typename T>
struct WmConst {
  T h, visc, ufloor;  // hwm, visc, the log law's lower bound on u_tau
  T lam_den, lam_c;   // the laminar profile's h/dl (2 - h/dl) and 2/dl
  T ikap, blog, eps;  // 1/kappa, B, the dtype's epsilon
  int n_newton;
};

// tau_w times comp / (|u_par| + eps) (wallmodel_tauw, one component)
template <typename T>
__device__ __forceinline__ T wm_tauw(int mtype, T uh, T vh, T comp,
                                     const WmConst<T>& c) {
  const T upar = csqrt(uh * uh + vh * vh);
  T tot;
  if (mtype == 1) {
    T utau = csqrt(upar / c.h * c.visc);
    utau = utau > c.ufloor ? utau : c.ufloor;
    for (int it = 0; it < c.n_newton; ++it) {
      const T f = upar / utau - c.ikap * cln(c.h * utau / c.visc) - c.blog;
      const T fp = -(T(1) / utau) * (upar / utau + c.ikap);
      utau = cabs(utau - f / fp);
    }
    tot = utau * utau;
  } else {
    tot = c.lam_c * (upar / c.lam_den) * c.visc;
  }
  return tot * comp / (upar + c.eps);
}

template <typename T>
__global__ void __launch_bounds__(CALES_THREADS)
    wallmodel_kernel(const T* __restrict__ u, const T* __restrict__ v,
                     const T* __restrict__ pp, const T* __restrict__ fuv,
                     T* __restrict__ out, int ny, int nx, int corrected,
                     WmFace<T> f0, WmFace<T> f1, T cx, T cy, WmConst<T> c) {
  const int px = nx + 2, py = ny + 2;
  const int64_t npt = static_cast<int64_t>(px) * py;
  const int64_t pt = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  if (pt >= npt) return;
  const WmFace<T> f = blockIdx.y == 0 ? f0 : f1;
  const int j = static_cast<int>(pt / px);
  const int i = static_cast<int>(pt - static_cast<int64_t>(j) * px);
  const int64_t plane = static_cast<int64_t>(ny) * nx;
  const T fu = corrected ? fuv[0] : T(0), fv = corrected ? fuv[1] : T(0);

  // the sampled value of u (or v) at padded (jq, iq) of interior row r
  auto sample = [&](const T* q, int r, int jq, int iq, bool is_u) {
    const int jj = wrap_near(jq - 1, ny), ii = wrap_near(iq - 1, nx);
    const int64_t o = r * plane + static_cast<int64_t>(jj) * nx + ii;
    if (!corrected) return q[o];
    const T fq = is_u ? fu : fv;
    const int64_t on = is_u ? r * plane + static_cast<int64_t>(jj) * nx +
                                  wrap_near(ii + 1, nx)
                            : r * plane +
                                  static_cast<int64_t>(wrap_near(jj + 1, ny)) *
                                      nx + ii;
    return fq + q[o] - (is_u ? cx : cy) * (pp[on] - pp[o]);
  };
  auto U = [&](int r, int jq, int iq) { return sample(u, r, jq, iq, true); };
  auto V = [&](int r, int jq, int iq) { return sample(v, r, jq, iq, false); };
  auto rel = [&](T q1, T q2, T mag) {
    return f.omc * q1 + f.coef * q2 - mag;
  };
  const T q4 = T(0.25);

  T bu = f.umag, bv = f.vmag;
  if (j >= 1 && j <= ny && i <= nx) {
    // bcu: u at its face point, v averaged from the four around it
    const T v1 = q4 * (V(f.r1, j, i) + V(f.r1, j, i + 1) +
                       V(f.r1, j - 1, i) + V(f.r1, j - 1, i + 1));
    const T v2 = q4 * (V(f.r2, j, i) + V(f.r2, j, i + 1) +
                       V(f.r2, j - 1, i) + V(f.r2, j - 1, i + 1));
    const T vm = q4 * (f.vmag + f.vmag + f.vmag + f.vmag);
    const T ur = rel(U(f.r1, j, i), U(f.r2, j, i), f.umag);
    const T vr = rel(v1, v2, vm);
    bu = f.sv * wm_tauw(f.mtype, ur, vr, ur, c);
  }
  if (j <= ny && i >= 1 && i <= nx) {
    // bcv: v at its face point, u averaged from the four around it
    const T u1 = q4 * (U(f.r1, j, i - 1) + U(f.r1, j, i) +
                       U(f.r1, j + 1, i - 1) + U(f.r1, j + 1, i));
    const T u2 = q4 * (U(f.r2, j, i - 1) + U(f.r2, j, i) +
                       U(f.r2, j + 1, i - 1) + U(f.r2, j + 1, i));
    const T um = q4 * (f.umag + f.umag + f.umag + f.umag);
    const T ur = rel(u1, u2, um);
    const T vr = rel(V(f.r1, j, i), V(f.r2, j, i), f.vmag);
    bv = f.sv * wm_tauw(f.mtype, ur, vr, vr, c);
  }
  T* o = out + static_cast<int64_t>(blockIdx.y) * 2 * npt + pt;
  o[0] = bu;
  o[npt] = bv;
}

template <typename T>
WmFace<T> wm_face(int mtype, int r1, int r2, double omc, double coef,
                  double sv, double umag, double vmag) {
  return WmFace<T>{mtype, r1, r2, T(omc), T(coef), T(sv), T(umag), T(vmag)};
}

template <typename T>
int launch_wallmodel(const T* u, const T* v, const T* pp, const T* fuv,
                     T* out, int ny, int nx, int nf, int corrected,
                     int n_newton,
                     int mt0, int r1_0, int r2_0, int mt1, int r1_1,
                     int r2_1, double omc0, double coef0, double sv0,
                     double umag0, double vmag0, double omc1, double coef1,
                     double sv1, double umag1, double vmag1, double cx,
                     double cy, double h, double visc, double ufloor,
                     double lam_den, double lam_c, double ikap, double blog,
                     double eps, void* stream) {
  const WmFace<T> f0 =
      wm_face<T>(mt0, r1_0, r2_0, omc0, coef0, sv0, umag0, vmag0);
  const WmFace<T> f1 =
      wm_face<T>(mt1, r1_1, r2_1, omc1, coef1, sv1, umag1, vmag1);
  const WmConst<T> c{T(h),    T(visc), T(ufloor), T(lam_den), T(lam_c),
                     T(ikap), T(blog), T(eps),    n_newton};
  const int64_t npt = static_cast<int64_t>(nx + 2) * (ny + 2);
  const dim3 grid(static_cast<unsigned>((npt + CALES_THREADS - 1) /
                                        CALES_THREADS),
                  static_cast<unsigned>(nf), 1);
  wallmodel_kernel<T><<<grid, CALES_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      u, v, pp, fuv, out, ny, nx, corrected, f0, f1, T(cx), T(cy), c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cales

#define CALES_WALLMODEL_ENTRY(NAME, T)                                        \
  extern "C" int NAME(                                                        \
      const T* u, const T* v, const T* pp, const T* fuv, T* out, int ny,      \
      int nx, int nf, int corrected, int n_newton, int mt0, int r1_0,         \
      int r2_0, int mt1, int r1_1, int r2_1, double omc0, double coef0,       \
      double sv0, double umag0, double vmag0, double omc1, double coef1,      \
      double sv1, double umag1, double vmag1, double cx, double cy, double h, \
      double visc, double ufloor, double lam_den, double lam_c, double ikap,  \
      double blog, double eps, void* stream) {                                \
    return cales::launch_wallmodel<T>(                                        \
        u, v, pp, fuv, out, ny, nx, nf, corrected, n_newton, mt0, r1_0, r2_0, \
        mt1, r1_1, r2_1, omc0, coef0, sv0, umag0, vmag0, omc1, coef1, sv1,    \
        umag1, vmag1, cx, cy, h, visc, ufloor, lam_den, lam_c, ikap, blog,    \
        eps, stream);                                                         \
  }

CALES_WALLMODEL_ENTRY(cales_wallmodel_f32, float)
CALES_WALLMODEL_ENTRY(cales_wallmodel_f64, double)
