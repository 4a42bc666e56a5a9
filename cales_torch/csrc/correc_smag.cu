// Projection + pressure update + van Driest static Smagorinsky, one pass.
//
// Replaces: cales_tpu/ops/pallas_kernels.py:1406 fused_correc_updatep_smag
// (body _correc_smag_kernel), without the x-spectral (xopi) variant.
// Per output cell:
//   u -= dt dxi (pp(i+1) - pp(i)), v likewise, w -= dt dzci (pp(k+1)-pp(k))
//   (correc.f90:14-68), plus the deferred bulk-forcing constants fuv;
//   p += pp (updatep.f90:14-24);
//   nu_t = (Cs Delta)^2 fd^2 |S| of the CORRECTED field (sgs.f90:69-152),
//   with van Driest damping from the nearer z wall's shear, or (Cs Delta)^2
//   |S| without z walls.  u and v at the z ghost rows follow the
//   post-correction fill's recipe (zrec: 'D' -> 2b - q, 'N' -> -+dr b + q,
//   q the corrected boundary plane; on a wall-modelled face 'E' ->
//   (1 + b) q - b q2, the one-sided extrapolation from q and the corrected
//   next-inner plane q2, sgs.f90:682-767); w's lower wall face keeps its
//   corrected value (impose_norm_bc=.false.), so its generic correction is
//   the post-fill value.
//
// Design: a z-march with the corrected planes in shared memory.  The
// strain rate (common.cuh strain_rate) reads 30 corrected values around a
// cell: u and v on three planes, w on two, +-1 in x and y.  Each is formed
// once, into shared memory, rather than at each of its reads (3 loads a
// value, about 90 a cell).  A block owns a TY x 32
// (y, x) tile (TY = 16 in float32, 8 in float64) and marches z, one plane
// a step:
//   R   the raw planes, a ring of 4 filled by cp.async: u, v and w on the
//       tile + a halo of 1, pp on the tile + a halo of 1 and one more row
//       and column (the corrections read pp at x+1 and y+1); plane k+3 is
//       copied while the block works on planes k and k+1;
//   C   the corrected u and v (a ring of 4 planes) and w (3) on the tile +
//       a halo of 1.
// At step k a thread forms, on its cells of the halo tile, the corrected u
// and v of plane k+1 and w of plane k (fu + u - cx (pp(i+1) - pp(i)),
// w - dt dzci (pp(k+1) - pp(k)), in this order of operations); the z ghost
// planes -1 and nz of u and v are the fill's recipes of the corrected
// planes 0 and nz-1, w's plane -1 the generic correction of the edge
// stack's row.  An 'E' ghost plane needs the corrected plane beside the
// boundary one: the lower one is formed at step 0, after plane 1, the
// upper one at step nz-1 from planes nz-1 and nz-2, both still in the
// ring; a thread forms the same cells of every plane, so neither needs a
// barrier of its own.  The thread also reads its centre cell's p and pp
// and the step's profiles.  Past one barrier it takes the strain rate at
// its centre cell from C and writes u, v, w, p + pp and nu_t of plane k.
// One barrier a plane: the rings are one plane deeper than the stencil,
// so a step's writes never meet the previous step's reads.  A thread's
// cells of the halo tile, and their wrapped offsets in a plane, are the
// same at every step: it finds them once.  Each input is read from device
// memory about once (the halo, read by two blocks, is meant to hit L2).  x
// and y wrap when a plane is loaded; a ragged tile's outside cells are
// computed on wrapped data and not stored.
// Shared memory: R 4 x (3 (TY+2) x 34 + (TY+3) x 35), C 11 (TY+2) x 34
// words: 66,944 bytes in f32, 74,880 in f64; two blocks an SM (64
// registers a thread in f32).
//
// Bound on the H100: bytes.  It reads u, v, w, pp and p and writes u, v,
// w, p and nu_t: 10 field streams, 1.34 GB at 512x256x256 f32, 0.401 ms
// at 3.35 TB/s; its 115 operations a cell take 0.058 ms at 67 TFLOP/s.
// Beyond the bytes it spends its copies' instructions (one cp.async a
// value) and the strain rate's, with two blocks an SM.
#include "common.cuh"

namespace cales {

template <typename T>
struct ZRec {  // one face's z-ghost recipe of the post-correction fill
  int letter;  // 0: 'D', 1: 'N', 2: 'E' (b = fac_ex, dr unused)
  T b, dr;
};
constexpr int ZREC_E = 2;

// The ghost value from the corrected boundary plane's q1 (and, for 'E',
// the corrected next-inner plane q2).  The 'N' recipe's product is fused
// into its sum by hand, as the compiler fused it in straight-line code:
// inside the z-march's loop it may hoist the loop-invariant product and
// round it apart.  The 'E' recipe rounds its two products apart, in the
// twin's order of operations; only the kernel's WM instantiation (a
// wall-modelled face among the four recipes) has it, so the others keep
// the code of the 'D' and 'N' recipes alone.
template <bool WM, typename T>
__device__ __forceinline__ T ghost(const ZRec<T>& r, int side, T q1, T q2) {
  if (r.letter == 0) return T(2) * r.b - q1;
  if (WM && r.letter == ZREC_E)
    return cmul_rn(T(1) + r.b, q1) - cmul_rn(r.b, q2);
  return side == 0 ? cfma(-r.dr, r.b, q1) : cfma(r.dr, r.b, q1);
}

// The tile rows: 16 in float32, 8 in float64.
template <typename T>
struct CsTy {
  static constexpr int TY = sizeof(T) == 4 ? 16 : 8;
};

constexpr int CS_TX = 32;          // the tile's columns
constexpr int CS_CX = CS_TX + 2;   // u, v, w and C: halo 1
constexpr int CS_PX = CS_TX + 3;   // pp: halo 1 and one more column

template <int TY>
struct CsGeo {
  static constexpr int NT = TY * CS_TX;
  static constexpr int CPL = (TY + 2) * CS_CX;   // u, v, w or C, one plane
  static constexpr int PPL = (TY + 3) * CS_PX;   // pp, one plane
  static constexpr int RPL = 3 * CPL + PPL;      // one raw plane
  static constexpr int WORDS = 4 * RPL + 11 * CPL;
};

template <typename T, bool WM>
__global__ void __launch_bounds__(CsGeo<CsTy<T>::TY>::NT, 2)
    correc_smag_kernel(
        const T* __restrict__ u, const T* __restrict__ v,
        const T* __restrict__ w, const T* __restrict__ pp,
        const T* __restrict__ p, const T* __restrict__ ue,
        const T* __restrict__ ve, const T* __restrict__ we,
        const T* __restrict__ ppe, const T* __restrict__ dzci,
        const T* __restrict__ dzfi, const T* __restrict__ csd2,
        const T* __restrict__ dw, const T* __restrict__ nearlo,
        const T* __restrict__ tauw_lo, const T* __restrict__ tauw_hi,
        const T* __restrict__ fuv, T* __restrict__ uo, T* __restrict__ vo,
        T* __restrict__ wo, T* __restrict__ po, T* __restrict__ so, int nz,
        int ny, int nx, int have_zwalls, ZRec<T> ru_lo, ZRec<T> ru_hi,
        ZRec<T> rv_lo, ZRec<T> rv_hi, T dtrk, T cx, T cy, T dxi, T dyi,
        T visc) {
  constexpr int TY = CsTy<T>::TY;
  using G = CsGeo<TY>;
  constexpr int NT = G::NT, CPL = G::CPL;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const R = reinterpret_cast<T*>(smem_raw);   // [4 planes][u, v, w, pp]
  T* const C = R + 4 * G::RPL;                    // U [4], V [4], W [3]
  const int gx = (nx + CS_TX - 1) / CS_TX;
  const int x0 = (blockIdx.x % gx) * CS_TX;
  const int y0 = (blockIdx.x / gx) * TY;
  const int tid = threadIdx.x;
  const int64_t plane = static_cast<int64_t>(ny) * nx;
  const T fu = fuv[0], fv = fuv[1];

  // field f (0 u, 1 v, 2 w, 3 pp) of raw plane r; the corrected planes
  auto raw = [&](int r, int f) {
    return R + ((r + 4) & 3) * G::RPL + f * CPL;
  };
  auto cu = [&](int kz) { return C + ((kz + 4) & 3) * CPL; };
  auto cv = [&](int kz) { return C + (4 + ((kz + 4) & 3)) * CPL; };
  auto cw = [&](int kz) { return C + (8 + (kz + 3) % 3) * CPL; };

  // this thread's cells of the halo tile (e = tid + i NT) and their
  // offsets in a plane, x and y wrapped: the same at every step
  constexpr int NC = (CPL + NT - 1) / NT, NP = (G::PPL + NT - 1) / NT;
  int oc[NC], op[NP];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int e = tid + i * NT, ly = e / CS_CX, lx = e - ly * CS_CX;
    oc[i] = wrap_near(y0 - 1 + ly, ny) * nx + wrap_near(x0 - 1 + lx, nx);
  }
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int e = tid + i * NT, ly = e / CS_PX, lx = e - ly * CS_PX;
    op[i] = wrap_near(y0 - 1 + ly, ny) * nx + wrap_near(x0 - 1 + lx, nx);
  }

  // the copy of raw plane r (-1 .. nz, z-edge rows by zrow): pp on every
  // plane, w up to nz-1, u and v on 0 .. nz-1 (their z ghosts are the
  // fill's recipes); one group a plane, empty past nz
  auto load = [&](int r) {
    if (r <= nz) {
      const T* pr = zrow(pp, ppe, r, nz, plane);
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const int e = tid + i * NT;
        if (e < G::PPL) cp_async(raw(r, 3) + e, pr + op[i]);
      }
    }
    if (r <= nz - 1) {
      const T* ur = zrow(u, ue, r, nz, plane);
      const T* vr = zrow(v, ve, r, nz, plane);
      const T* wr = zrow(w, we, r, nz, plane);
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int e = tid + i * NT;
        if (e >= CPL) continue;
        cp_async(raw(r, 2) + e, wr + oc[i]);
        if (r >= 0) {
          cp_async(raw(r, 0) + e, ur + oc[i]);
          cp_async(raw(r, 1) + e, vr + oc[i]);
        }
      }
    }
    cp_async_commit();
  };

  // the corrected u and v of plane kz (0 .. nz-1) at cell e of the halo
  // tile (pp's offset pe: one more column a row)
  auto corrected_uv = [&](int kz, int e, int pe, T& cuv, T& cvv) {
    const T* pk = raw(kz, 3) + pe;
    cuv = fu + raw(kz, 0)[e] - cx * (pk[1] - pk[0]);
    cvv = fv + raw(kz, 1)[e] - cy * (pk[CS_PX] - pk[0]);
  };
  // the corrected w of plane kz (-1 .. nz-1) at cell e
  auto corrected_w = [&](int kz, int e, int pe) {
    return raw(kz, 2)[e] -
           dtrk * dzci[kz + 1] * (raw(kz + 1, 3)[pe] - raw(kz, 3)[pe]);
  };
  // before the march: u and v of plane 0 and their ghost plane -1 (an
  // 'E' ghost waits for plane 1), w of plane -1
  auto form_first = [&]() {
    for (int e = tid; e < CPL; e += NT) {
      const int pe = e + e / CS_CX;
      T a, b;
      corrected_uv(0, e, pe, a, b);
      cu(0)[e] = a;
      cv(0)[e] = b;
      if (!WM || ru_lo.letter != ZREC_E)
        cu(-1)[e] = ghost<WM>(ru_lo, 0, a, a);
      if (!WM || rv_lo.letter != ZREC_E)
        cv(-1)[e] = ghost<WM>(rv_lo, 0, b, b);
      cw(-1)[e] = corrected_w(-1, e, pe);
    }
  };
  // step k: u and v of plane k+1 (past the last plane its ghost, from the
  // values this thread formed there) and w of plane k
  auto form = [&](int k) {
    for (int e = tid; e < CPL; e += NT) {
      const int pe = e + e / CS_CX;
      if (k + 1 < nz) {
        T a, b;
        corrected_uv(k + 1, e, pe, a, b);
        cu(k + 1)[e] = a;
        cv(k + 1)[e] = b;
      } else {
        const T u1 = cu(nz - 1)[e], v1 = cv(nz - 1)[e];
        cu(nz)[e] = ghost<WM>(ru_hi, 1, u1, WM ? cu(nz - 2)[e] : u1);
        cv(nz)[e] = ghost<WM>(rv_hi, 1, v1, WM ? cv(nz - 2)[e] : v1);
      }
      cw(k)[e] = corrected_w(k, e, pe);
    }
  };
  // after step 0's form: an 'E' ghost plane -1 from planes 0 and 1, on the
  // cells this thread formed there
  auto form_e_lo = [&]() {
    for (int e = tid; e < CPL; e += NT) {
      if (ru_lo.letter == ZREC_E)
        cu(-1)[e] = ghost<WM>(ru_lo, 0, cu(0)[e], cu(1)[e]);
      if (rv_lo.letter == ZREC_E)
        cv(-1)[e] = ghost<WM>(rv_lo, 0, cv(0)[e], cv(1)[e]);
    }
  };

  // this thread's centre cell
  const int ty = tid / CS_TX, tx = tid - ty * CS_TX;
  const int co = (ty + 1) * CS_CX + tx + 1;
  const int pc = (ty + 1) * CS_PX + tx + 1;
  const bool inside = y0 + ty < ny && x0 + tx < nx;
  const int64_t idx = static_cast<int64_t>(y0 + ty) * nx + x0 + tx;
  // the wall-shear planes of both z walls at this column
  T tlo = T(0), thi = T(0);
  if (have_zwalls && inside) {
    tlo = tauw_lo[idx];
    thi = tauw_hi[idx];
  }

  load(-1);
  load(0);
  load(1);
  cp_async_wait<1>();   // planes -1 and 0
  __syncthreads();
  form_first();
  load(2);
  cp_async_wait<1>();   // plane 1
  __syncthreads();
  for (int k = 0; k < nz; ++k) {
    load(k + 3);
    form(k);
    if (WM && k == 0) form_e_lo();
    // the centre's p and pp, and the step's profiles, read before the
    // barrier
    T pk = T(0), ppk = T(0);
    if (inside) {
      pk = p[k * plane + idx];
      ppk = raw(k, 3)[pc];
    }
    const T dzci_c = dzci[k + 1], dzci_m = dzci[k], dzfi_c = dzfi[k + 1];
    const T csd2_k = csd2[k];
    const T tauw = nearlo[k] > T(0.5) ? tlo : thi;
    const T dw_k = have_zwalls ? dw[k] : T(0);
    cp_async_wait<1>();   // plane k+2, for step k+1
    __syncthreads();
    if (!inside) continue;
    const T* const uk[3] = {cu(k - 1), cu(k), cu(k + 1)};
    const T* const vk[3] = {cv(k - 1), cv(k), cv(k + 1)};
    const T* const wk[2] = {cw(k - 1), cw(k)};
    const int64_t o = k * plane + idx;
    uo[o] = uk[1][co];
    vo[o] = vk[1][co];
    wo[o] = wk[1][co];
    po[o] = pk + ppk;
    // strain rate of the corrected field (common.cuh strain_rate)
    const T s0 = ring_strain<T, CS_CX>(uk, vk, wk, co, dxi, dyi, dzci_c,
                                       dzci_m, dzfi_c);
    // van Driest damping with the nearer z wall's shear (sgs.f90:104-149)
    so[o] = have_zwalls ? van_driest_nut(s0, csd2_k, dw_k, tauw, visc)
                        : csd2_k * s0;
  }
}

template <typename T>
int launch_correc_smag(const T* u, const T* v, const T* w, const T* pp,
                       const T* p, const T* ue, const T* ve, const T* we,
                       const T* ppe, const T* dzci, const T* dzfi,
                       const T* csd2, const T* dw, const T* nearlo,
                       const T* tauw_lo, const T* tauw_hi, const T* fuv,
                       T* uo, T* vo, T* wo, T* po, T* so, int nz, int ny,
                       int nx, int have_zwalls, int lt_ulo, double b_ulo,
                       double dr_ulo, int lt_uhi, double b_uhi, double dr_uhi,
                       int lt_vlo, double b_vlo, double dr_vlo, int lt_vhi,
                       double b_vhi, double dr_vhi, double dtrk, double dxi,
                       double dyi, double visc, void* stream) {
  const ZRec<T> ru_lo{lt_ulo, T(b_ulo), T(dr_ulo)};
  const ZRec<T> ru_hi{lt_uhi, T(b_uhi), T(dr_uhi)};
  const ZRec<T> rv_lo{lt_vlo, T(b_vlo), T(dr_vlo)};
  const ZRec<T> rv_hi{lt_vhi, T(b_vhi), T(dr_vhi)};
  // the WM instantiation where a face takes the wall model's 'E' recipe
  const bool wm = lt_ulo == ZREC_E || lt_uhi == ZREC_E || lt_vlo == ZREC_E ||
                  lt_vhi == ZREC_E;
  auto kernel = wm ? correc_smag_kernel<T, true> : correc_smag_kernel<T, false>;
  constexpr int TY = CsTy<T>::TY;
  const size_t smem = sizeof(T) * CsGeo<TY>::WORDS;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nblk = ((ny + TY - 1) / TY) * ((nx + CS_TX - 1) / CS_TX);
  kernel<<<nblk, CsGeo<TY>::NT, smem, static_cast<cudaStream_t>(stream)>>>(
      u, v, w, pp, p, ue, ve, we, ppe, dzci, dzfi, csd2, dw, nearlo, tauw_lo,
      tauw_hi, fuv, uo, vo, wo, po, so, nz, ny, nx, have_zwalls, ru_lo,
      ru_hi, rv_lo, rv_hi, T(dtrk), T(dtrk * dxi), T(dtrk * dyi), T(dxi),
      T(dyi), T(visc));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cales

#define CALES_CORREC_SMAG_ENTRY(NAME, T)                                       \
  extern "C" int NAME(                                                         \
      const T* u, const T* v, const T* w, const T* pp, const T* p,             \
      const T* ue, const T* ve, const T* we, const T* ppe, const T* dzci,      \
      const T* dzfi, const T* csd2, const T* dw, const T* nearlo,              \
      const T* tauw_lo, const T* tauw_hi, const T* fuv, T* uo, T* vo, T* wo,   \
      T* po, T* so, int nz, int ny, int nx, int have_zwalls, int lt_ulo,       \
      double b_ulo, double dr_ulo, int lt_uhi, double b_uhi, double dr_uhi,    \
      int lt_vlo, double b_vlo, double dr_vlo, int lt_vhi, double b_vhi,       \
      double dr_vhi, double dtrk, double dxi, double dyi, double visc,         \
      void* stream) {                                                          \
    return cales::launch_correc_smag<T>(                                       \
        u, v, w, pp, p, ue, ve, we, ppe, dzci, dzfi, csd2, dw, nearlo,         \
        tauw_lo, tauw_hi, fuv, uo, vo, wo, po, so, nz, ny, nx, have_zwalls,    \
        lt_ulo, b_ulo, dr_ulo, lt_uhi, b_uhi, dr_uhi, lt_vlo, b_vlo, dr_vlo,   \
        lt_vhi, b_vhi, dr_vhi, dtrk, dxi, dyi, visc, stream);                  \
  }

CALES_CORREC_SMAG_ENTRY(cales_correc_smag_f32, float)
CALES_CORREC_SMAG_ENTRY(cales_correc_smag_f64, double)
