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
// A thread owns one (j, i) point of one output plane: blockIdx.z is
// face * 2 + component (bcu, bcv), a block 8 rows of 31 points of that
// plane, a warp one row of 31 x-neighbours of one component, whose
// iterations converge alike.  The samples are rows r1 and r2 of u and v,
// wrapped along the periodic x and y, as they are or, with `corrected`,
// as the fused correction makes them: fu + u - cx (pp(i+1) - pp(i)),
// fv + v - cy (pp(j+1) - pp(j)), in this order of operations.  A lane
// samples its own column only: its component at its point and the other
// at two rows; the other's values one column over come from the next (or
// previous) lane by a shuffle, so the warp's 32nd lane samples the
// column past its 31 points and owns none.  The thread interpolates the
// samples to hwm, makes them relative to the face's static wall velocity,
// and solves the log law for u_tau by Newton's method, or takes the
// laminar profile (wmodel.f90:222-335).  bcu is written over
// [1:ny+1, 0:nx+1] and bcv over [0:ny+1, 1:nx+1]; the rest of each plane
// keeps the face's static value.  Output (nf, 2, ny+2, nx+2):
// [face][bcu, bcv].
//
// The Newton step is the twin's update rearranged: with a = u_par/u_tau
// and f = a - (log u_tau + log(h/visc))/kappa - B, the twin's
// u_tau - f/f' is u_tau (1 + f/(a + 1/kappa)): two divisions and a
// logarithm a step where the twin has four and a logarithm, log(h/visc)
// formed once on the host.  In float32 the logarithm and the divisions
// are the hardware's fast forms (__logf, __fdividef): the planes stay
// within 8.6e-7 of the float32 twin's maximum and 7.3e-7 of the float64
// twin's (the accurate forms: 7.7e-7 and 6.7e-7; the bound is 1e-5), and
// the kernel takes 0.0153 ms a call on corrected bulk rows at 512x256
// where the accurate forms take 0.0210 (cales_torch/wm_probe.py, H100
// 700 W).  In float64 the accurate log and IEEE divisions: the planes
// must stay within 1e-13 of the twin's maximum.
// A lane is done when |du_tau| <= 4 eps u_tau (it then keeps its u_tau),
// or from the start when it owns no point in range.  The warp leaves the
// loop when __all_sync finds every lane done, after at most WM_N_NEWTON
// = 12 steps, the twin's fixed count: a lane that has not converged by
// then runs all 12, as in the JAX package.  No thread returns early, so
// every lane reaches each vote and each shuffle; the laminar branch is a
// face's, so a whole block takes it.
//
// Bound on the H100: bytes.  At 512x256 it reads two rows each of u and v
// a face (and of pp, corrected) and writes two padded planes a face:
// about 8.4 MB corrected in f32, 2.5 us at 3.35 TB/s; its arithmetic,
// one Newton solve a point of about 9 steps on bulk-flow rows, about
// 1.2 us at 67 TFLOP/s.  Measured (wm_probe, f32, 512x256, CUDA graphs):
// 15 us a call on corrected rows, 13 us as they are; a launch that only
// stores its planes takes 2.6 us, the samples 3.5-6 us more, the Newton
// solves about 7 us more: what holds it is the instructions (the fast
// logarithm, the reciprocals, the vote, the index work), not the bytes.
#include "common.cuh"

namespace cales {

// a block is 8 warps, each one x run of 32 lanes of a plane's row, of
// which 31 own a point (the 32nd samples the column its neighbour needs)
#define WM_BX 32
#define WM_BY (CALES_THREADS / WM_BX)
#define WM_OUT (WM_BX - 1)

// the Newton steps' cap (wallmodel.N_NEWTON): the loop unrolls
constexpr int WM_N_NEWTON = 12;

// The static arguments, built once per wall model and dtype on the host
// (ops/kernels.py _WmArgs mirrors this layout); slot 1 repeats slot 0
// when one face is modelled.
struct WmArgs {
  int nf;                      // wall-modelled faces, 1 or 2
  int mtype[2];                // 1 log-law, -1 laminar
  int r1[2], r2[2];            // the interior rows that bracket hwm
  double omc[2], coef[2];      // 1 - coef, coef
  double sv[2];                // sgn / visc
  double umag[2], vmag[2];     // the faces' static wall-parallel values
  double h, visc, ufloor;      // hwm, visc, the log law's floor on u_tau
  double lam_den, lam_c;       // the laminar profile's h/dl (2 - h/dl), 2/dl
  double ikap, blog, lhv, eps;  // 1/kappa, B, log(h/visc), the epsilon
};

template <typename T>
struct WmFace {
  int mtype, r1, r2;
  T omc, coef, sv, umag, vmag;
};

template <typename T>
struct WmConst {
  T h, visc, ufloor, lam_den, lam_c, ikap, blog, lhv, eps;
};

// The Newton step's logarithm and divisions: in float32 the hardware's
// fast forms, in float64 the accurate ones (see the header).
__device__ __forceinline__ float wm_log(float x) { return __logf(x); }
__device__ __forceinline__ double wm_log(double x) { return log(x); }
__device__ __forceinline__ float wm_div(float a, float b) {
  return __fdividef(a, b);
}
__device__ __forceinline__ double wm_div(double a, double b) { return a / b; }

// u_tau of the log law at |u_par| = upar: the twin's start, then the
// rearranged steps until the whole warp is done (see above); a lane with
// `live` false only votes.
template <typename T>
__device__ __forceinline__ T wm_utau(T upar, bool live,
                                     const WmConst<T>& c) {
  T utau = csqrt(upar / c.h * c.visc);
  utau = utau > c.ufloor ? utau : c.ufloor;
  bool done = !live;
#pragma unroll
  for (int it = 0; it < WM_N_NEWTON; ++it) {
    if (__all_sync(0xffffffffu, done)) break;
    if (!done) {
      const T a = wm_div(upar, utau);
      const T f = a - c.ikap * (wm_log(utau) + c.lhv) - c.blog;
      const T next = cabs(utau * (T(1) + wm_div(f, a + c.ikap)));
      done = cabs(next - utau) <= T(4) * c.eps * next;
      utau = next;
    }
  }
  return utau;
}

// q - 1 in [-1, n] wrapped into [0, n): a padded index's interior one
__device__ __forceinline__ int wm_wrap(int q, int n) {
  return q < 0 ? q + n : (q >= n ? q - n : q);
}

template <typename T>
__global__ void __launch_bounds__(CALES_THREADS)
    wallmodel_kernel(const T* __restrict__ u, const T* __restrict__ v,
                     const T* __restrict__ pp, const T* __restrict__ fuv,
                     T* __restrict__ out, int ny, int nx, int corrected,
                     WmFace<T> f0, WmFace<T> f1, T cx, T cy, WmConst<T> c) {
  const int lane = threadIdx.x;
  const bool is_u = (blockIdx.z & 1) == 0;  // bcu, else bcv
  // this lane's padded column: bcu's lanes 0-30 own columns 31 bx + lane,
  // bcv's lanes 1-31 the same columns one lane up; lane 31 (bcu) or 0
  // (bcv) only samples the column its neighbour needs
  const int i = static_cast<int>(blockIdx.x) * WM_OUT + lane - (is_u ? 0 : 1);
  const int j = static_cast<int>(blockIdx.y) * WM_BY + threadIdx.y;
  const WmFace<T> f = blockIdx.z < 2 ? f0 : f1;
  const int px = nx + 2, py = ny + 2;
  const bool mine_lane = is_u ? lane < WM_OUT : lane > 0;
  const bool on = mine_lane && (is_u ? (j >= 1 && j <= ny && i <= nx)
                                     : (j <= ny && i >= 1 && i <= nx));
  const T fu = corrected ? fuv[0] : T(0), fv = corrected ? fuv[1] : T(0);

  // The samples of rows r1, r2 at this lane's column: its own component at
  // (j, i), the other at (j, i) and (jb, i), jb = j - 1 for bcu, j + 1 for
  // bcv; the other's x neighbours (i + 1 for bcu, i - 1 for bcv) come from
  // the next or previous lane.  Indices clamped into the padded plane
  // (they change only samples no point in range reads), then wrapped once
  // into the interior.
  const int ii = wm_wrap(min(max(i, 0), px - 1) - 1, nx);
  const int ix = ii + 1 == nx ? 0 : ii + 1;
  const int ja = wm_wrap(min(j, py - 1) - 1, ny);
  const int jb = wm_wrap(min(max(is_u ? j - 1 : j + 1, 0), py - 1) - 1, ny);
  const int jan = ja + 1 == ny ? 0 : ja + 1, jbn = jb + 1 == ny ? 0 : jb + 1;
  const int oa = ja * nx + ii, ob = jb * nx + ii;
  // corrected, a sample of u takes pp's x neighbour, one of v its y one
  const int oa_u = ja * nx + ix, ob_u = jb * nx + ix;
  const int oa_v = jan * nx + ii, ob_v = jbn * nx + ii;
  const int64_t plane = static_cast<int64_t>(ny) * nx;
  auto val = [&](const T* q, const T* p, int o, int on_, bool su) {
    if (!corrected) return q[o];
    return (su ? fu : fv) + q[o] - (su ? cx : cy) * (p[on_] - p[o]);
  };
  const T* mq = is_u ? u : v;  // this plane's component
  const T* oq = is_u ? v : u;  // the other
  T mine[2], oth_a[2], oth_b[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int64_t r = (k == 0 ? f.r1 : f.r2) * plane;
    const T* p = pp + r;
    mine[k] = val(mq + r, p, oa, is_u ? oa_u : oa_v, is_u);
    oth_a[k] = val(oq + r, p, oa, is_u ? oa_v : oa_u, !is_u);
    oth_b[k] = val(oq + r, p, ob, is_u ? ob_v : ob_u, !is_u);
  }
  const T q4 = T(0.25);
  auto rel = [&](T q1, T q2, T mag) {
    return f.omc * q1 + f.coef * q2 - mag;
  };
  // the other's four around the point, summed in the twin's order: bcu's
  // v at (j, i), (j, i+1), (j-1, i), (j-1, i+1); bcv's u at (j, i-1),
  // (j, i), (j+1, i-1), (j+1, i)
  T avg[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const T na = is_u ? __shfl_down_sync(0xffffffffu, oth_a[k], 1)
                      : __shfl_up_sync(0xffffffffu, oth_a[k], 1);
    const T nb = is_u ? __shfl_down_sync(0xffffffffu, oth_b[k], 1)
                      : __shfl_up_sync(0xffffffffu, oth_b[k], 1);
    const T s = oth_a[k] + na;
    avg[k] = q4 * (is_u ? s + oth_b[k] + nb : s + nb + oth_b[k]);
  }
  const T om = is_u ? f.vmag : f.umag;  // the other's static value
  const T other = rel(avg[0], avg[1], q4 * (om + om + om + om));
  const T own = rel(mine[0], mine[1], is_u ? f.umag : f.vmag);
  const T upar = on ? (is_u ? csqrt(own * own + other * other)
                            : csqrt(other * other + own * own))
                    : T(0);
  T tot;
  if (f.mtype == 1) {  // the face's, so the whole warp votes
    const T utau = wm_utau(upar, on, c);
    tot = utau * utau;
  } else {
    tot = c.lam_c * (upar / c.lam_den) * c.visc;
  }
  if (mine_lane && i < px && j < py) {
    out[(static_cast<int64_t>(blockIdx.z) * py + j) * px + i] =
        on ? f.sv * (tot * own / (upar + c.eps)) : (is_u ? f.umag : f.vmag);
  }
}

template <typename T>
WmFace<T> wm_face(const WmArgs& a, int n) {
  return WmFace<T>{a.mtype[n], a.r1[n],      a.r2[n],      T(a.omc[n]),
                   T(a.coef[n]), T(a.sv[n]), T(a.umag[n]), T(a.vmag[n])};
}

template <typename T>
int launch_wallmodel(const T* u, const T* v, const T* pp, const T* fuv,
                     T* out, int ny, int nx, int corrected, double cx,
                     double cy, const WmArgs* a, void* stream) {
  const WmConst<T> c{T(a->h),     T(a->visc), T(a->ufloor),
                     T(a->lam_den), T(a->lam_c), T(a->ikap),
                     T(a->blog),  T(a->lhv),  T(a->eps)};
  const dim3 block(WM_BX, WM_BY, 1);
  const dim3 grid(static_cast<unsigned>((nx + 2 + WM_OUT - 1) / WM_OUT),
                  static_cast<unsigned>((ny + 2 + WM_BY - 1) / WM_BY),
                  static_cast<unsigned>(2 * a->nf));
  wallmodel_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      u, v, pp, fuv, out, ny, nx, corrected, wm_face<T>(*a, 0),
      wm_face<T>(*a, 1), T(cx), T(cy), c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cales

#define CALES_WALLMODEL_ENTRY(NAME, T)                                       \
  extern "C" int NAME(const T* u, const T* v, const T* pp, const T* fuv,     \
                      T* out, int ny, int nx, int corrected, double cx,      \
                      double cy, const cales::WmArgs* args, void* stream) {  \
    return cales::launch_wallmodel<T>(u, v, pp, fuv, out, ny, nx, corrected, \
                                      cx, cy, args, stream);                 \
  }

CALES_WALLMODEL_ENTRY(cales_wallmodel_f32, float)
CALES_WALLMODEL_ENTRY(cales_wallmodel_f64, double)
