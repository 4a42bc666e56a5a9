// The wall model's Neumann planes on every wall-modelled y and z face, one
// launch.
//
// Replaces no Pallas kernel: the JAX package computes these planes in XLA
// (cales_tpu/wallmodel.py:204 y_wall_wm_planes and :253 z_wall_wm_planes,
// fed by cales_tpu/timeloop.py:677 _wm_bcs_fast and the fused correction's
// corrected rows, timeloop.py:1314-1342), where the fixed Newton loop
// fuses into a few kernels.  Run eagerly in torch it is about 350 small
// operations a face, called once a substep; here it is one launch.
// Twin: cales_torch/wallmodel.py wm_planes_plain.
//
// A thread owns one (j, i) point of one output plane: blockIdx.z is
// face * 2 + component, a block 8 rows of 31 points of that plane, a warp
// one row of 31 x-neighbours of one component, whose iterations converge
// alike.  A z face's planes are (ny+2, nx+2), [bcu, bcv], its samples
// rows r1 and r2 of u and v; a y face's are (nz+2, nx+2), [bcu, bcw], its
// samples rows r1 and r2 of u and w along y: a plane's rows j run along
// the face's other transverse axis (y on a z face, z on a y face) and
// blocks past a face's rows leave at once.  x wraps; along the other axis
// a sampled row takes its ghosts (padded 0 and n+1) and, for the
// staggered component (v on a z face, w on a y face), its set_bc rewrite
// (padded n) from the face's recipes: s q[idx] + c for the static BC
// values of the effective letters (a periodic axis wraps the same way,
// s = 1, c = 0), as cales_tpu's _row_pad_xy and _row_pad_xz fill them.
// With x walls (XW, z faces with periodic y: the developing channel's wall
// model, cales_tpu's x-walled _wm_fast route) a sampled row's padded
// columns 0, nx and nx+1 come first from the x recipe of its component:
// s q[idx] + c with c read per row from xc (the static x values at that
// row; an inflow profile's vary along y), u's padded nx being its set_bc
// rewrite slot, and then wrap along y as the rest of the row does.
// With both (XW x YH: the developing WMLES on a slab of the y-slab mesh,
// periodic y; cales_tpu's z_wall_wm_planes under its xe column protocol,
// timeloop.py:183-190) a row's x ghost columns take the x recipe on every
// padded row, the halo rows' too, its offsets xc per padded row 0 .. ny+1
// (the slab's rows of an inflow profile and their periodic neighbours).
// On a slab of the y-slab mesh (YH, z faces with periodic x and y, the
// rows as they are; cales_tpu's _wm_bcs_fast under its mesh) a sampled
// row's padded rows 0 and n+1 are its rows -1 and ny from the neighbours,
// yh (faces, 2 components, 2 rows, 2 sides, nx) in
// wallmodel.sampled_rows's order, where the whole field wraps y; the rest
// is the periodic kernel's.  On a slab of a y-walled mesh (YH with the
// run-time flags ylo, yhi >= 0: the walls the slab holds) a z face's row
// takes its y recipe's rows on the sides the slab owns (the ghost, and on
// the upper wall's slab the staggered component's rewrite row n) and the
// halo rows elsewhere, where the recipe's row n is the row itself; the y
// faces the slab owns come after its z faces in the launch, their rows
// the slab's own, their planes' z recipes as on the whole field (a y face
// needs no halo: z is never split).
// With `corrected` (z faces with periodic y: the fused correction's rows)
// a sample is fu + u - cx (pp(i+1) - pp(i)) or fv + v - cy (pp(j+1) -
// pp(j)), in this order of operations.  A lane samples its own column
// only: its component at its point and the other at two rows; the
// other's values one column over come from the next (or previous) lane
// by a shuffle, so the warp's 32nd lane samples the column past its 31
// points and owns none.  The thread interpolates the samples to hwm (on
// a y face u onto w's z faces with the weights wei = (zf - zc) / dzc),
// makes them relative to the face's static wall velocity, and solves the
// log law for u_tau by Newton's method, or takes the laminar profile
// (wmodel.f90:171-335).  The first component's plane is written over
// [1:n+1, 0:nx+1] and the second's over [0:n+1, 1:nx+1]; the rest of each
// plane keeps the face's static value.  Output: the faces' (2, n+2, nx+2)
// plane pairs one after another.
//
// The Newton step is the twin's update rearranged: with a = u_par/u_tau
// and f = a - (log u_tau + log(h/visc))/kappa - B, the twin's
// u_tau - f/f' is u_tau (1 + f/(a + 1/kappa)): two divisions and a
// logarithm a step where the twin has four and a logarithm, log(h/visc)
// formed once on the host.  In float32 the logarithm and the divisions
// are the hardware's fast forms (__logf, __fdividef): the planes stay
// within 8.6e-7 of the float32 twin's maximum and 7.3e-7 of the float64
// twin's (the accurate forms: 7.7e-7 and 6.7e-7; the bound is 1e-5), and
// the kernel takes 0.0170 ms a call on the two z faces' corrected bulk
// rows at 512x256 where the accurate forms take 0.0230
// (cales_torch/wm_probe.py, H100 700 W).  In float64 the accurate log and
// IEEE divisions: the planes must stay within 1e-13 of the twin's
// maximum.  A lane is done when |du_tau| <= 4 eps u_tau (it then keeps
// its u_tau), or from the start when it owns no point in range.  The warp
// leaves the loop when __all_sync finds every lane done, after at most
// WM_N_NEWTON = 12 steps, the twin's fixed count: a lane that has not
// converged by then runs all 12, as in the JAX package.  No thread of a
// block on a face's plane returns early, so every lane reaches each vote
// and each shuffle; the laminar branch is a face's, so a whole block takes
// it.
//
// Bound on the H100: bytes.  On the two z faces at 512x256 it reads two
// rows each of u and v a face (and of pp, corrected) and writes two
// padded planes a face: about 8.4 MB corrected in f32, 2.5 us at 3.35
// TB/s; its arithmetic, one Newton solve a point of about 9 steps on
// bulk-flow rows, about 1.2 us at 67 TFLOP/s.  Measured (wm_probe, f32,
// 512x256, CUDA graphs, H100 700 W): 17 us a call on the two z faces'
// corrected rows, 15 us as they are, 25 us on the duct's four faces; a
// launch that only stores its planes takes 2.9-4.6 us, the samples 5-10
// us more, the Newton solves 7-11 us more: what holds it is the
// instructions (the fast logarithm, the reciprocals, the vote, the index
// work), not the bytes.
#include "common.cuh"

namespace cales {

// a block is 8 warps, each one x run of 32 lanes of a plane's row, of
// which 31 own a point (the 32nd samples the column its neighbour needs)
#define WM_BX 32
#define WM_BY (CALES_THREADS / WM_BX)
#define WM_OUT (WM_BX - 1)
// faces in one launch: the two y faces and the two z faces
#define WM_FACES 4

// the Newton steps' cap (wallmodel.N_NEWTON): the loop unrolls
constexpr int WM_N_NEWTON = 12;

// The static arguments, built once per wall model and dtype on the host
// (ops/kernels.py _WmArgs mirrors this layout).  Per face: its normal d
// (1 a y face, 2 a z face), the model type (1 log-law, -1 laminar), the
// interior rows r1, r2 along d that bracket hwm, and for each of its two
// components the recipes of its sampled rows' padded rows 0, n and n+1
// along the other transverse axis: s q[ridx] + c, ridx < 0 counting from
// the end.
struct WmArgs {
  int nf;                          // wall-modelled faces, 1 to 4
  int d[WM_FACES], mtype[WM_FACES], r1[WM_FACES], r2[WM_FACES];
  int ridx[WM_FACES][2][3];
  double omc[WM_FACES], coef[WM_FACES];  // 1 - coef, coef
  double sv[WM_FACES];                   // sgn / visc
  double lam_den[WM_FACES], lam_c[WM_FACES];  // h/dl (2 - h/dl), 2/dl
  double mag[WM_FACES][2];               // the static wall-parallel values
  double rs[WM_FACES][2][3], rc[WM_FACES][2][3];
  double h, visc, ufloor;      // hwm, visc, the log law's floor on u_tau
  double ikap, blog, lhv, eps;  // 1/kappa, B, log(h/visc), the epsilon
  // x walls: the x recipe of each component's padded columns 0, nx and
  // nx+1 (idx < 0 counting from the end, the scale s; the offsets c per
  // row in xc)
  int xw;
  int xidx[WM_FACES][2][3];
  double xs[WM_FACES][2][3];
};

template <typename T>
struct WmFace {
  int d, mtype, r1, r2;
  int ridx[2][3];
  T omc, coef, sv, lam_den, lam_c;
  T mag[2], rs[2][3], rc[2][3];
  int xidx[2][3];
  T xs[2][3];
  int64_t off;  // the face's planes in the output
};

template <typename T>
struct WmFaces {
  WmFace<T> f[WM_FACES];
};

template <typename T>
struct WmConst {
  T h, visc, ufloor, ikap, blog, lhv, eps;
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

// A sampled row's padded row p (0 .. n+1) of component cq: s q[idx] + c,
// its interior row p - 1 as it is (s = 1, c = 0) or at p = 0, n, n+1 the
// face's recipe; and in the row (fewer than 2^31 values: the wrapper
// checks), the offsets of the point (o) and of pp's neighbour along the
// component's own axis (on: x for u, the row's axis for v), which a
// corrected sample takes.
template <typename T>
struct WmRec {
  T s, c;
  int o, on, row;
};

template <typename T>
__device__ __forceinline__ WmRec<T> wm_rec(const WmFace<T>& f, int cq,
                                           int p, int n, int stride, int ii,
                                           int ix, bool rec_hi = true) {
  // rec_hi false: a slab's row n is the row itself (its upper side is a
  // neighbour's, whose halo row n+1 the caller reads)
  const int pos = p == 0 ? 0 : p == n ? (rec_hi ? 1 : -1)
                  : p == n + 1 ? 2 : -1;
  int idx = p - 1;
  WmRec<T> r{T(1), T(0), 0, 0, 0};
  if (pos >= 0) {
    idx = f.ridx[cq][pos] < 0 ? f.ridx[cq][pos] + n : f.ridx[cq][pos];
    r.s = f.rs[cq][pos];
    r.c = f.rc[cq][pos];
  }
  r.row = idx;
  r.o = idx * stride + ii;
  r.on = cq == 0 ? idx * stride + ix
                 : (idx + 1 == n ? 0 : idx + 1) * stride + ii;
  return r;
}

template <typename T, bool XW, bool YH = false>
__global__ void __launch_bounds__(CALES_THREADS)
    wallmodel_kernel(const T* __restrict__ u, const T* __restrict__ v,
                     const T* __restrict__ w, const T* __restrict__ pp,
                     const T* __restrict__ fuv, const T* __restrict__ wz,
                     const T* __restrict__ xc, const T* __restrict__ yh,
                     T* __restrict__ out, int nz, int ny, int nx,
                     int corrected, const __grid_constant__ WmFaces<T> fs,
                     T cx, T cy, WmConst<T> c, int ylo, int yhi) {
  // the face of this block, read in place from the kernel's parameters
  // (__grid_constant__: a member indexed at run time is not copied to the
  // stack)
  const WmFace<T>& f = fs.f[blockIdx.z >> 1];
  const bool yface = f.d == 1;
  // the plane's rows run along the face's other transverse axis
  const int n = yface ? nz : ny;
  const int px = nx + 2, pn = n + 2;
  // a block past this face's rows: the whole block leaves
  if (static_cast<int>(blockIdx.y) * WM_BY >= pn) return;
  const int lane = threadIdx.x;
  const int comp = blockIdx.z & 1;     // 0: bcu, 1: bcv or bcw
  const bool is_u = comp == 0;
  // this lane's padded column: bcu's lanes 0-30 own columns 31 bx + lane,
  // the second component's lanes 1-31 the same columns one lane up; lane
  // 31 (bcu) or 0 only samples the column its neighbour needs
  const int i = static_cast<int>(blockIdx.x) * WM_OUT + lane - (is_u ? 0 : 1);
  const int j = static_cast<int>(blockIdx.y) * WM_BY + threadIdx.y;
  const bool mine_lane = is_u ? lane < WM_OUT : lane > 0;
  const bool on = mine_lane && (is_u ? (j >= 1 && j <= n && i <= nx)
                                     : (j <= n && i >= 1 && i <= nx));
  const T fu = corrected ? fuv[0] : T(0), fv = corrected ? fuv[1] : T(0);

  // The samples of rows r1, r2 at this lane's column: its own component
  // at (j, i), the other at (j, i) and (jb, i), jb = j - 1 for bcu, j + 1
  // for the second; the other's x neighbours (i + 1 for bcu, i - 1 for the
  // second) come from the next or previous lane.  Indices clamped into the
  // padded plane (they change only samples no point in range reads), the
  // column wrapped once into the interior; a row's padded 0, n and n+1
  // by its recipe, the rest its interior row j - 1.
  const int ii = wm_wrap(min(max(i, 0), px - 1) - 1, nx);
  const int ix = ii + 1 == nx ? 0 : ii + 1;
  const int ja = min(j, pn - 1);
  const int jb = min(max(is_u ? j - 1 : j + 1, 0), pn - 1);
  const int64_t plane = static_cast<int64_t>(ny) * nx;
  // a sampled row's stride along the other axis
  const int stride = yface ? ny * nx : nx;
  const T* const q2 = yface ? w : v;
  const int own = comp, oth = 1 - comp;
  // the sides whose halo rows a z face's rows take on a slab (YH): both
  // off a y-walled mesh (ylo, yhi < 0), else those the slab does not own
  const bool halo_lo = YH && !yface && ylo <= 0;
  const bool halo_hi = YH && !yface && yhi <= 0;
  // each sample's recipe and offsets in its row (wm_rec)
  const WmRec<T> rm = wm_rec(f, own, ja, n, stride, ii, ix, !halo_hi),
                 ra = wm_rec(f, oth, ja, n, stride, ii, ix, !halo_hi),
                 rb = wm_rec(f, oth, jb, n, stride, ii, ix, !halo_hi);
  // this plane's component and the other: the field, the deferred
  // forcing and the correction's factor
  const T* const qm = is_u ? u : q2;
  const T* const qo = is_u ? q2 : u;
  const T fm = is_u ? fu : fv, fo = is_u ? fv : fu;
  const T cm = is_u ? cx : cy, co = is_u ? cy : cx;
  // a sample of row rbase (pp's row at rbase too)
  auto sample = [&](const T* q, T fq, T cq, const WmRec<T>& r,
                    int64_t rbase) {
    T val = q[rbase + r.o];
    if (corrected) {
      const T* const pr = pp + rbase;
      val = fq + val - cq * (pr[r.on] - pr[r.o]);
    }
    return r.s * val + r.c;
  };
  // x walls: this lane's padded column as an x-recipe entry (0, 1, 2 for
  // padded 0, nx, nx+1; -1 inside), and a sample of component cq of the
  // face's k-th row at its padded row p there: the x recipe at the row
  // r.row, then the row's recipe along y; on a slab (YH) the offsets
  // carry the rows -1 and ny (row j at j + 1), and on a halo side the
  // neighbours' row takes the x recipe at its own offset (the x recipes
  // are pointwise along y)
  const int ic = min(max(i, 0), px - 1);
  const int xpos = !XW ? -1 : ic == 0 ? 0 : ic == nx ? 1 : ic == nx + 1 ? 2
                                                                       : -1;
  constexpr int XOFF = YH ? 1 : 0;
  auto sample_x = [&](const T* q, int cq, int p, const WmRec<T>& r,
                      int64_t rbase, int k) -> T {
    const int ci = f.xidx[cq][xpos] < 0 ? f.xidx[cq][xpos] + nx
                                        : f.xidx[cq][xpos];
    const int m = ((blockIdx.z >> 1) * 2 + cq) * 2 + k;
    const T* const c = xc + (m * 3 + xpos) * (ny + 2 * XOFF);
    if (YH && ((p == 0 && halo_lo) || (p == pn - 1 && halo_hi))) {
      const int side = p == 0 ? 0 : 1;
      return f.xs[cq][xpos] * yh[(m * 2 + side) * nx + ci] +
             c[side == 0 ? 0 : ny + 1];
    }
    const T val = f.xs[cq][xpos] * q[rbase + r.row * stride + ci] +
                  c[r.row + XOFF];
    return r.s * val + r.c;
  };
  // a slab (YH): a sample of component cq of the face's k-th row at its
  // padded row p, the halo row there (p 0 or n+1 on a halo side), else as
  // above
  auto sample_h = [&](const T* q, int cq, int p, T fq, T cfac,
                      const WmRec<T>& r, int64_t rbase, int k) -> T {
    if ((p == 0 && halo_lo) || (p == pn - 1 && halo_hi))
      return yh[((((blockIdx.z >> 1) * 2 + cq) * 2 + k) * 2 +
                 (p == 0 ? 0 : 1)) * nx + ii];
    return sample(q, fq, cfac, r, rbase);
  };
  T mine[2], oth_a[2], oth_b[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int r = k == 0 ? f.r1 : f.r2;
    const int64_t rbase = yface ? static_cast<int64_t>(r) * nx : r * plane;
    if (XW && xpos >= 0) {
      mine[k] = sample_x(qm, own, ja, rm, rbase, k);
      oth_a[k] = sample_x(qo, oth, ja, ra, rbase, k);
      oth_b[k] = sample_x(qo, oth, jb, rb, rbase, k);
    } else if (YH) {
      mine[k] = sample_h(qm, own, ja, fm, cm, rm, rbase, k);
      oth_a[k] = sample_h(qo, oth, ja, fo, co, ra, rbase, k);
      oth_b[k] = sample_h(qo, oth, jb, fo, co, rb, rbase, k);
    } else {
      mine[k] = sample(qm, fm, cm, rm, rbase);
      oth_a[k] = sample(qo, fo, co, ra, rbase);
      oth_b[k] = sample(qo, fo, co, rb, rbase);
    }
  }
  const T q4 = T(0.25), h2 = T(0.5);
  auto rel = [&](T q1, T q2_, T mag) {
    return f.omc * q1 + f.coef * q2_ - mag;
  };
  // the weights of a y face's u onto w's z faces at this row
  const bool wei = yface && !is_u;
  const T omw = wei ? wz[ja] : T(0), wk = wei ? wz[pn + ja] : T(0);
  // the other's four around the point, summed in the twin's order: bcu's
  // at (j, i), (j, i+1), (j-1, i), (j-1, i+1); the second's at (j, i-1),
  // (j, i), (j+1, i-1), (j+1, i), on a y face two x pairs weighed by wei
  T avg[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const T na = is_u ? __shfl_down_sync(0xffffffffu, oth_a[k], 1)
                      : __shfl_up_sync(0xffffffffu, oth_a[k], 1);
    const T nb = is_u ? __shfl_down_sync(0xffffffffu, oth_b[k], 1)
                      : __shfl_up_sync(0xffffffffu, oth_b[k], 1);
    const T s = oth_a[k] + na;
    avg[k] = is_u ? q4 * (s + oth_b[k] + nb)
             : wei ? h2 * (omw * (na + oth_a[k]) + wk * (nb + oth_b[k]))
                   : q4 * (s + nb + oth_b[k]);
  }
  // the other's static value, and this plane's
  const T om = f.mag[oth], mymag = f.mag[own];
  const T omag = wei ? h2 * (omw * (om + om) + wk * (om + om))
                     : q4 * (om + om + om + om);
  const T other = rel(avg[0], avg[1], omag);
  const T ownr = rel(mine[0], mine[1], mymag);
  const T upar = on ? (is_u ? csqrt(ownr * ownr + other * other)
                            : csqrt(other * other + ownr * ownr))
                    : T(0);
  T tot;
  if (f.mtype == 1) {  // the face's, so the whole warp votes
    const T utau = wm_utau(upar, on, c);
    tot = utau * utau;
  } else {
    tot = f.lam_c * (upar / f.lam_den) * c.visc;
  }
  if (mine_lane && i < px && j < pn) {
    out[f.off + (static_cast<int64_t>(comp) * pn + j) * px + i] =
        on ? f.sv * (tot * ownr / (upar + c.eps)) : mymag;
  }
}

template <typename T>
WmFace<T> wm_face(const WmArgs& a, int n, int64_t off) {
  WmFace<T> f;
  f.d = a.d[n];
  f.mtype = a.mtype[n];
  f.r1 = a.r1[n];
  f.r2 = a.r2[n];
  f.omc = T(a.omc[n]);
  f.coef = T(a.coef[n]);
  f.sv = T(a.sv[n]);
  f.lam_den = T(a.lam_den[n]);
  f.lam_c = T(a.lam_c[n]);
  for (int q = 0; q < 2; ++q) {
    f.mag[q] = T(a.mag[n][q]);
    for (int p = 0; p < 3; ++p) {
      f.ridx[q][p] = a.ridx[n][q][p];
      f.rs[q][p] = T(a.rs[n][q][p]);
      f.rc[q][p] = T(a.rc[n][q][p]);
      f.xidx[q][p] = a.xidx[n][q][p];
      f.xs[q][p] = T(a.xs[n][q][p]);
    }
  }
  f.off = off;
  return f;
}

template <typename T>
int launch_wallmodel(const T* u, const T* v, const T* w, const T* pp,
                     const T* fuv, const T* wz, const T* xc, const T* yh,
                     T* out, int nz, int ny, int nx, int corrected, double cx,
                     double cy, const WmArgs* a, int ylo, int yhi,
                     void* stream) {
  if (a->nf < 1 || a->nf > WM_FACES)
    return static_cast<int>(cudaErrorInvalidValue);
  // a slab's halo rows: z faces, the rows as they are, with periodic x or
  // (periodic y) x walls; on a y-walled mesh (ylo, yhi >= 0, periodic x)
  // the y faces it owns after them
  if (yh != nullptr && ((a->xw && ylo >= 0) || corrected ||
                        (ylo < 0) != (yhi < 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  bool yfaces = false;
  for (int n = 0; yh != nullptr && n < a->nf; ++n) {
    if (a->d[n] == 1) {
      if (ylo < 0) return static_cast<int>(cudaErrorInvalidValue);
      yfaces = true;
    } else if (yfaces) {
      return static_cast<int>(cudaErrorInvalidValue);   // z faces first
    }
  }
  // x walls: z faces only, their rows as they are, the offsets given
  if (a->xw && (xc == nullptr || corrected))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int n = 0; a->xw && n < a->nf; ++n)
    if (a->d[n] != 2) return static_cast<int>(cudaErrorInvalidValue);
  const WmConst<T> c{T(a->h),    T(a->visc), T(a->ufloor), T(a->ikap),
                     T(a->blog), T(a->lhv),  T(a->eps)};
  WmFaces<T> fs;
  int64_t off = 0;
  int rows = 0;
  for (int n = 0; n < WM_FACES; ++n) {
    // the unused slots repeat the last face; no block reads them
    const int m = n < a->nf ? n : a->nf - 1;
    fs.f[n] = wm_face<T>(*a, m, off);
    if (n < a->nf) {
      const int pn = (a->d[n] == 1 ? nz : ny) + 2;
      off += 2 * static_cast<int64_t>(pn) * (nx + 2);
      rows = pn > rows ? pn : rows;
    }
  }
  const dim3 block(WM_BX, WM_BY, 1);
  const dim3 grid(static_cast<unsigned>((nx + 2 + WM_OUT - 1) / WM_OUT),
                  static_cast<unsigned>((rows + WM_BY - 1) / WM_BY),
                  static_cast<unsigned>(2 * a->nf));
  auto kern = a->xw ? (yh != nullptr ? &wallmodel_kernel<T, true, true>
                                     : &wallmodel_kernel<T, true>)
              : yh != nullptr ? &wallmodel_kernel<T, false, true>
                              : &wallmodel_kernel<T, false>;
  kern<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      u, v, w, pp, fuv, wz, xc, yh, out, nz, ny, nx, corrected, fs, T(cx),
      T(cy), c, ylo, yhi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cales

#define CALES_WALLMODEL_ENTRY(NAME, T)                                        \
  extern "C" int NAME(const T* u, const T* v, const T* w, const T* pp,        \
                      const T* fuv, const T* wz, const T* xc, const T* yh,    \
                      T* out, int nz, int ny, int nx, int corrected,          \
                      double cx, double cy, const cales::WmArgs* args,        \
                      int ylo, int yhi, void* stream) {                       \
    return cales::launch_wallmodel<T>(u, v, w, pp, fuv, wz, xc, yh, out, nz,  \
                                      ny, nx, corrected, cx, cy, args, ylo,   \
                                      yhi, stream);                           \
  }

CALES_WALLMODEL_ENTRY(cales_wallmodel_f32, float)
CALES_WALLMODEL_ENTRY(cales_wallmodel_f64, double)
