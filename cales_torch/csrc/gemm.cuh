// The GEMM shared by apply_y.cu, apply_x.cu and (float32) z_eig.cu.
//
// C[b] = A[b] (M x K) . B[b] (K x N), row-major, batch b = blockIdx.z with
// element strides sA, sB, sC (0: a shared operand).  Every ragged edge of
// M, N and K is masked.
//
// KCH: A is stored as column chunks, the K columns split into chunks of
// kch, chunk q at A + q * sAk with leading dimension lda (= kch): the
// (gy, rows, nx / gy) blocks an all-to-all delivers, read as one (rows, nx)
// operand without gathering them first.  With KCH false (apply_y, and
// apply_x on a whole slab) the operand is plain row-major.
//
// float32: 3xTF32 on the tensor cores (gemm_tf32x3_kernel).  Bound: its
// arithmetic, 2 M N K flops a batch at 495 / 3 TFLOP/s (three TF32 products
// a product; 0.312 ms for apply_y's 51.5 GFLOP at 512x256x256), where the
// SIMT fp32 FMA body it replaced was bound at 0.769 ms by 67 TFLOP/s.
// Each element x is split into big = tf32(x) and small = tf32(x - big)
// (cvt.rna), and each k step of 8 takes small.big, big.small and big.big
// (never one TF32 product alone: that keeps ~3 digits).  The tensor cores
// truncate their sums toward zero, so a k tile's twelve products go into a
// fragment of their own (zeroed by the first) that joins the running fp32
// sum in one round-to-nearest add a tile (summed straight into the
// running sum, the truncations of a K = 512 product pile up to several
// times the error of an fp32 FMA sum); within the tile the eight
// small.big and big.small products come first, while the fragment is
// small, and the four big.big ones last.  The products are
// wgmma.m64n128k8.tf32 with both operands read from shared memory, where
// wgmma wants them K-major with the 128-byte swizzle; B arrives N-major
// (as every caller stores it), so its split is also its transpose.
// A block computes a 128x128 tile of C with three warpgroups:
//   producer (warps 8-11): streams raw A and B tiles of k depth 32 into a
//     3-stage cp.async ring (16-byte copies where the operand's leading
//     dimension, strides and base allow them, 4-byte copies otherwise: the
//     same kernel), zero-filled past every edge, and splits B into the
//     split set the consumers take next;
//   consumers (warpgroups 0, 1, 64 rows each): split their A rows of the
//     next tile while their wgmmas of this one run, then fold the tile's
//     sums.
// Two split sets (A big, A small, B big, B small) alternate; named
// barriers pass tiles between the warpgroups, and the two consumer
// warpgroups run apart so that one's wgmmas fill the other's gaps.  The
// raw A tile lands already swizzled as wgmma wants it, so its split is in
// place, float4 by float4; every shared-memory load and store of the
// splits hits 32 distinct banks.  Dynamic shared memory: 225 KB, one block
// an SM.
//
// The epilogue is a template parameter (Epi): EpiStore, the default, stores
// C as the products left it (apply_y, apply_x); z_eig.cu's scales each
// element by its row's and column's inverse eigenvalue on the way out.
// Epi::col(n) does a column's share, Epi(col, m, x) gives the value stored
// at (m, n); neither is called past an edge.
//
// float64: the SIMT FMA body (gemm_kernel): a 128x128 tile of C with 256
// threads, an 8x8 register tile each, from 128x8 / 8x128 tiles of A and B
// staged in shared memory; the next tiles' global loads are issued before
// the current tile's FMAs.
#pragma once

#include "common.cuh"

namespace cales {
namespace {

// ---------------------------------------------------------------------------
// float64: the SIMT FMA body
// ---------------------------------------------------------------------------

constexpr int GM = 128;  // C tile rows
constexpr int GN = 128;  // C tile cols
constexpr int GK = 8;    // k depth of one shared-memory stage
constexpr int GPAD = 4;  // As row padding: conflict-free transposed stores

// Four consecutive shared-memory values.
template <typename T>
__device__ __forceinline__ void ld4(const T* p, T* r) {
  r[0] = p[0]; r[1] = p[1]; r[2] = p[2]; r[3] = p[3];
}
template <>
__device__ __forceinline__ void ld4<double>(const double* p, double* r) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  r[0] = a.x; r[1] = a.y; r[2] = b.x; r[3] = b.y;
}

// Thread (tx, ty) = (tid % 16, tid / 16) owns rows {ty*4 + i, 64 + ty*4 + i}
// and columns {tx*4 + j, 64 + tx*4 + j}, i, j < 4.
template <typename T, bool KCH>
__global__ void __launch_bounds__(256) gemm_kernel(
    const T* __restrict__ A, const T* __restrict__ B, T* __restrict__ C,
    int M, int N, int K, int lda, int ldb, int ldc, int64_t sA, int64_t sB,
    int64_t sC, int kch, int64_t sAk) {
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
      if (KCH) {
        const int kq = k / kch;
        ra[q] = (m < M && k < K)
                    ? A[kq * sAk + static_cast<int64_t>(m) * lda + (k - kq * kch)]
                    : T(0);
      } else {
        ra[q] = (m < M && k < K) ? A[static_cast<int64_t>(m) * lda + k] : T(0);
      }
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

// ---------------------------------------------------------------------------
// float32: 3xTF32 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int TM = 128;      // C tile rows: two consumer warpgroups of 64
constexpr int TN = 128;      // C tile cols: one wgmma n128
constexpr int TK = 32;       // k depth of one stage: one 128-byte row
constexpr int TKB = TK / 8;  // k steps of 8 a stage
constexpr int TRAW = 3;      // raw stages in the cp.async ring
constexpr int TTILE = TM * TK;  // floats of one tile (A or B: TM == TN)
constexpr int TCONS = 256;      // consumer threads (warps 0 .. 7)
constexpr int TPROD = 128;      // producer threads (warps 8 .. 11)
// [split set 0][split set 1][raw stage 0 .. TRAW-1]; a split set is A big,
// A small, B big, B small; a raw stage A, B.  1024-byte aligned for the
// 128-byte swizzle, with 1 KB of slack for the alignment.
constexpr int TSMEM =
    (2 * 4 * TTILE + TRAW * 2 * TTILE) * static_cast<int>(sizeof(float)) +
    1024;
static_assert(TM == 128 && TN == 128 && TK == 32,
              "the lane maps assume 128x128x32 tiles");
// named barriers: RAW + t % 2 (raw tile t landed), FULL + 2 w + b (split
// set b's B filled, for consumer warpgroup w), EMPTY + b (split set b
// free), PROD (the producer warps alone); 0 is __syncthreads
constexpr int BAR_RAW = 1, BAR_FULL = 3, BAR_EMPTY = 7, BAR_PROD = 9;

// The default epilogue: C as the products left it.  by_column: the
// epilogue walks C by columns, each column's share found once (an
// epilogue whose col() costs more than a store).
struct EpiStore {
  static constexpr bool by_column = false;
  static constexpr bool k_step_sums = false;   // see the consumers' loop
  struct Col {};
  __device__ __forceinline__ Col col(int) const { return {}; }
  __device__ __forceinline__ float operator()(const Col&, int,
                                              float x) const {
    return x;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
// Copy `bytes` (0 .. size) from global src to shared dst, zero-filling the
// rest of the size-byte piece.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = big + small, both TF32 (round to nearest, ties away from zero).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

// The wgmma descriptor of a K-major tile with the 128-byte swizzle: rows
// of 128 bytes (32 tf32 along k), 8-row groups 1024 bytes apart, 16-byte
// chunk c of row r stored at chunk c ^ (r % 8).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |        // leading offset (unused)
         (static_cast<uint64_t>(1024 >> 4) << 32) |  // 8-row group stride
         (static_cast<uint64_t>(1) << 62);          // 128-byte swizzle
}
// the float offset of element (row r, k) of such a tile
__device__ __forceinline__ int sw128_off(int r, int k) {
  return r * 32 + ((((k >> 2) ^ r) & 7) << 2) + (k & 3);
}

// d (+)= a (64x8) . b (8x128), both from shared memory by descriptor:
// TF32 products, f32 sums; d is overwritten when acc is 0.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t ad,
                                           uint64_t bd, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(ad), "l"(bd), "r"(acc));
}

// Keep the compiler from moving reads or writes of d across the
// asynchronous wgmma that owns it.
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int q = 0; q < 64; ++q) asm volatile("" : "+f"(d[q])::"memory");
}

// Warp-specialised (the note at the top): the producer warpgroup (warps
// 8 .. 11) streams the raw tiles in and splits B; consumer warpgroup w
// (warps 4w .. 4w+3) splits its A rows and owns C rows 64w .. 64w+63 of
// the tile and all 128 columns; lane (g, t) = (lane / 4, lane % 4) of its
// warp q holds rows 16q + g and 16q + g + 8, columns 8j + 2t and 8j + 2t
// + 1 (d[4j .. 4j+3]).  vecA / vecB: the operand takes 16-byte copies;
// vecC: C takes 8-byte stores; epi: the epilogue (EpiStore above).
template <bool KCH, class Epi = EpiStore>
__global__ void __launch_bounds__(TCONS + TPROD, 1) gemm_tf32x3_kernel(
    const float* __restrict__ A, const float* __restrict__ B,
    float* __restrict__ C, int M, int N, int K, int lda, int ldb, int ldc,
    int64_t sA, int64_t sB, int64_t sC, int kch, int64_t sAk, int vecA,
    int vecB, int vecC, Epi epi) {
  extern __shared__ __align__(16) float smem_raw[];
  float* const smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023) / 4;
  float* const raw0 = smem + 8 * TTILE;
  const int64_t bz = blockIdx.z;
  A += bz * sA;
  B += bz * sB;
  C += bz * sC;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ktiles = (K + TK - 1) / TK;

  if (tid >= TCONS) {
    // ---------------- producer: the cp.async ring, B's split ----------------
    const int pt = tid - TCONS;
    // KCH: the chunk and the column in it of the tile's first k, found
    // once a tile (a division), from which a_at steps to k = k0 + c
    int q0 = 0, r0 = 0;
    auto a_at = [&](int m, int c) -> const float* {
      if (KCH) {
        int q = q0, kk = r0 + c;
        if (kch >= TK) {
          if (kk >= kch) kk -= kch, ++q;   // a tile spans two chunks at most
        } else {
          q += kk / kch;
          kk -= (kk / kch) * kch;
        }
        return A + q * sAk + static_cast<int64_t>(m) * lda + kk;
      }
      return A + static_cast<int64_t>(m) * lda + (r0 + c);
    };
    // raw stage s <- A[m0 .., k0 ..] (TM x TK, rows of 128 bytes with the
    // 16-byte chunks swizzled as the split tiles are) and B[k0 .., n0 ..]
    // (TK x TN, row-major)
    auto load = [&](int s, int k0) {
      float* As = raw0 + 2 * TTILE * s;
      float* Bs = As + TTILE;
      if (KCH) {
        q0 = k0 / kch;
        r0 = k0 - q0 * kch;
      } else {
        r0 = k0;
      }
      if (vecA) {
#pragma unroll
        for (int i = 0; i < TTILE / 4 / TPROD; ++i) {
          const int v = pt + TPROD * i, r = v >> 3, c = (v & 7) * 4;
          const int m = m0 + r, k = k0 + c;
          const int n = (m < M && k < K) ? min(4, K - k) : 0;
          cp_async16(smem_u32(As + sw128_off(r, c)), n ? a_at(m, c) : A,
                     4 * n);
        }
      } else {
#pragma unroll 8
        for (int i = 0; i < TTILE / TPROD; ++i) {
          const int e = pt + TPROD * i, r = e >> 5, c = e & 31;
          const int m = m0 + r, k = k0 + c;
          const bool ok = m < M && k < K;
          cp_async4(smem_u32(As + sw128_off(r, c)), ok ? a_at(m, c) : A,
                    ok ? 4 : 0);
        }
      }
      if (vecB) {
#pragma unroll
        for (int i = 0; i < TTILE / 4 / TPROD; ++i) {
          const int v = pt + TPROD * i, r = v >> 5, c = (v & 31) * 4;
          const int k = k0 + r, n = n0 + c;
          const int w = (k < K && n < N) ? min(4, N - n) : 0;
          cp_async16(smem_u32(Bs + r * TN + c),
                     w ? B + static_cast<int64_t>(k) * ldb + n : B, 4 * w);
        }
      } else {
#pragma unroll 8
        for (int i = 0; i < TTILE / TPROD; ++i) {
          const int e = pt + TPROD * i, r = e >> 7, c = e & 127;
          const int k = k0 + r, n = n0 + c;
          const bool ok = k < K && n < N;
          cp_async4(smem_u32(Bs + r * TN + c),
                    ok ? B + static_cast<int64_t>(k) * ldb + n : B,
                    ok ? 4 : 0);
        }
      }
    };
#pragma unroll
    for (int s = 0; s < TRAW - 1; ++s) {
      if (s < ktiles) load(s, s * TK);
      cp_async_commit();
    }
    for (int kt = 0; kt < ktiles; ++kt) {
      const int b = kt & 1;
      // raw tile kt has landed for every producer thread
      cp_async_wait<TRAW - 2>();
      bar_sync(BAR_PROD, TPROD);
      bar_arrive(BAR_RAW + b, TCONS + TPROD);
      // split set b is free, and raw tile kt - 1 (whose stage the next
      // load reuses) read, once the consumers are done with tile kt - 2;
      // at kt = 1, once they have split raw tile 0's A
      if (kt >= 2 || (kt == 1 && TRAW < ktiles))
        bar_sync(BAR_EMPTY + b, TCONS + TPROD);
      if (kt + TRAW - 1 < ktiles)
        load((kt + TRAW - 1) % TRAW, (kt + TRAW - 1) * TK);
      cp_async_commit();
      const float* Bs = raw0 + 2 * TTILE * (kt % TRAW) + TTILE;
      float* const set = smem + 4 * TTILE * b;
      // B: (k, n) row-major -> K-major rows n; a lane takes 4 k of one n,
      // the warp 32 consecutive n
#pragma unroll
      for (int i = 0; i < TTILE / 4 / TPROD; ++i) {
        const int n = pt, kc = i;   // TTILE / 4 / TPROD == TK / 4
        uint4 hi, lo;
        split_tf32(Bs[(4 * kc + 0) * TN + n], hi.x, lo.x);
        split_tf32(Bs[(4 * kc + 1) * TN + n], hi.y, lo.y);
        split_tf32(Bs[(4 * kc + 2) * TN + n], hi.z, lo.z);
        split_tf32(Bs[(4 * kc + 3) * TN + n], hi.w, lo.w);
        const int off = sw128_off(n, 4 * kc);
        *reinterpret_cast<uint4*>(set + 2 * TTILE + off) = hi;
        *reinterpret_cast<uint4*>(set + 3 * TTILE + off) = lo;
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_arrive(BAR_FULL + b, TCONS / 2 + TPROD);
      bar_arrive(BAR_FULL + 2 + b, TCONS / 2 + TPROD);
    }
    cp_async_wait<0>();
    return;
  }

  // ---------------- consumers: A's split, the wgmmas ----------------
  const int wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  // raw tile kt's A rows of this warpgroup -> split set kt % 2: the raw
  // tile already lies as the split tiles do, so float4 by float4 in place
  auto split_a = [&](int kt) {
    bar_sync(BAR_RAW + (kt & 1), TCONS + TPROD);
    const float* As = raw0 + 2 * TTILE * (kt % TRAW);
    float* const set = smem + 4 * TTILE * (kt & 1);
#pragma unroll
    for (int i = 0; i < TTILE / 4 / TCONS; ++i) {
      const int off = 2048 * wg + 4 * ((tid & 127) + 128 * i);
      const float4 x = *reinterpret_cast<const float4*>(As + off);
      uint4 hi, lo;
      split_tf32(x.x, hi.x, lo.x);
      split_tf32(x.y, hi.y, lo.y);
      split_tf32(x.z, hi.z, lo.z);
      split_tf32(x.w, hi.w, lo.w);
      *reinterpret_cast<uint4*>(set + off) = hi;
      *reinterpret_cast<uint4*>(set + TTILE + off) = lo;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };
  float acc[64], part[64];
#pragma unroll
  for (int q = 0; q < 64; ++q) acc[q] = part[q] = 0.0f;
  split_a(0);
  if (TRAW < ktiles) bar_arrive(BAR_EMPTY + 1, TCONS + TPROD);
  for (int kt = 0; kt < ktiles; ++kt) {
    const int b = kt & 1;
    // split set b: B from the producer, A from this warpgroup (each of its
    // threads has split its share of tile kt before arriving); the two
    // warpgroups run apart, so one's wgmmas fill the other's gaps
    bar_sync(BAR_FULL + 2 * wg + b, TCONS / 2 + TPROD);
    // tile kt's products into part, zeroed by the first: the tile's
    // small.big and big.small products while part is still small (their
    // truncations stay at its scale), then its big.big ones
    const uint32_t set = smem_u32(smem + 4 * TTILE * b);
    const uint32_t abig = set + 64 * 128 * wg, asml = abig + 4 * TTILE;
    const uint32_t bbig = set + 8 * TTILE, bsml = bbig + 4 * TTILE;
    if constexpr (Epi::k_step_sums) {
      // each k step's three products (small.big, big.small, big.big) into
      // part, zeroed by the first, and part into the sum by a
      // round-to-nearest add: one truncated sum a step of 8, where a tile
      // truncates four sums at the scale of its big products
#pragma unroll
      for (int kb = 0; kb < TKB; ++kb) {
        fence_regs(part);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        wgmma_tf32(part, sw128_desc(asml + 32 * kb),
                   sw128_desc(bbig + 32 * kb), 0);
        wgmma_tf32(part, sw128_desc(abig + 32 * kb),
                   sw128_desc(bsml + 32 * kb), 1);
        wgmma_tf32(part, sw128_desc(abig + 32 * kb),
                   sw128_desc(bbig + 32 * kb), 1);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        if (kb == 0 && kt + 1 < ktiles) split_a(kt + 1);
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_regs(part);
#pragma unroll
        for (int q = 0; q < 64; ++q) acc[q] += part[q];
      }
      if (kt + 2 < ktiles) bar_arrive(BAR_EMPTY + b, TCONS + TPROD);
      continue;
    }
    fence_regs(part);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kb = 0; kb < TKB; ++kb) {
      wgmma_tf32(part, sw128_desc(asml + 32 * kb),
                 sw128_desc(bbig + 32 * kb), kb > 0);
      wgmma_tf32(part, sw128_desc(abig + 32 * kb),
                 sw128_desc(bsml + 32 * kb), 1);
    }
#pragma unroll
    for (int kb = 0; kb < TKB; ++kb)
      wgmma_tf32(part, sw128_desc(abig + 32 * kb),
                 sw128_desc(bbig + 32 * kb), 1);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // while they run: split tile kt + 1's A rows into the other set (its
    // A part was read by this warpgroup's wgmmas of tile kt - 1 alone)
    if (kt + 1 < ktiles) split_a(kt + 1);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs(part);
    if (kt + 2 < ktiles) bar_arrive(BAR_EMPTY + b, TCONS + TPROD);
#pragma unroll
    for (int q = 0; q < 64; ++q) acc[q] += part[q];
  }

  const int wrow = 16 * warp;   // 64 wg + 16 (warp % 4)
  if constexpr (Epi::by_column) {
    // a column's share of the epilogue once for both its rows
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = n0 + 8 * j + 2 * t;
      if (n >= N) continue;
      const typename Epi::Col c0 = epi.col(n);
      const typename Epi::Col c1 = n + 1 < N ? epi.col(n + 1) : c0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wrow + g + 8 * h;
        if (m >= M) continue;
        float* crow = C + static_cast<int64_t>(m) * ldc;
        const float x = epi(c0, m, acc[4 * j + 2 * h]);
        if (n + 1 < N) {
          const float y = epi(c1, m, acc[4 * j + 2 * h + 1]);
          if (vecC) {
            *reinterpret_cast<float2*>(crow + n) = make_float2(x, y);
          } else {
            crow[n] = x;
            crow[n + 1] = y;
          }
        } else {
          crow[n] = x;
        }
      }
    }
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wrow + g + 8 * h;
      if (m >= M) continue;
      float* crow = C + static_cast<int64_t>(m) * ldc;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int n = n0 + 8 * j + 2 * t;
        const float x = acc[4 * j + 2 * h], y = acc[4 * j + 2 * h + 1];
        if (vecC && n + 1 < N) {
          *reinterpret_cast<float2*>(crow + n) = make_float2(
              epi(epi.col(n), m, x), epi(epi.col(n + 1), m, y));
        } else {
          if (n < N) crow[n] = epi(epi.col(n), m, x);
          if (n + 1 < N) crow[n + 1] = epi(epi.col(n + 1), m, y);
        }
      }
    }
  }
}

template <bool KCH, class Epi = EpiStore>
int launch_tf32x3(const float* A, const float* B, float* C, int M, int N,
                  int K, int lda, int ldb, int ldc, int64_t sA, int64_t sB,
                  int64_t sC, dim3 grid, cudaStream_t stream, int kch,
                  int64_t sAk, Epi epi = Epi()) {
  auto aligned = [](const void* p, uintptr_t bytes) {
    return reinterpret_cast<uintptr_t>(p) % bytes == 0;
  };
  const int vecA = aligned(A, 16) && lda % 4 == 0 && sA % 4 == 0 &&
                   (!KCH || (kch % 4 == 0 && sAk % 4 == 0));
  const int vecB = aligned(B, 16) && ldb % 4 == 0 && sB % 4 == 0;
  const int vecC = aligned(C, 8) && ldc % 2 == 0 && sC % 2 == 0;
  if (M < 1 || N < 1 || K < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t rc = cudaFuncSetAttribute(
      gemm_tf32x3_kernel<KCH, Epi>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, TSMEM);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  gemm_tf32x3_kernel<KCH, Epi><<<grid, TCONS + TPROD, TSMEM, stream>>>(
      A, B, C, M, N, K, lda, ldb, ldc, sA, sB, sC, kch, sAk, vecA, vecB,
      vecC, epi);
  return static_cast<int>(cudaGetLastError());
}

// kch > 0: A in column chunks of kch at stride sAk (KCH above).  float32
// takes the tensor-core kernel, float64 the SIMT one.
template <typename T>
int launch_gemm(const T* A, const T* B, T* C, int M, int N, int K, int lda,
                int ldb, int ldc, int64_t sA, int64_t sB, int64_t sC,
                int batch, cudaStream_t stream, int kch = 0,
                int64_t sAk = 0) {
  const dim3 grid((N + GN - 1) / GN, (M + GM - 1) / GM, batch);
  if (grid.y > 65535u || grid.z > 65535u)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if constexpr (std::is_same<T, float>::value) {
    static_assert(TM == GM && TN == GN, "one grid for both bodies");
    if (kch > 0)
      return launch_tf32x3<true>(A, B, C, M, N, K, lda, ldb, ldc, sA, sB, sC,
                                 grid, stream, kch, sAk);
    return launch_tf32x3<false>(A, B, C, M, N, K, lda, ldb, ldc, sA, sB, sC,
                                grid, stream, 0, 0);
  } else {
    if (kch > 0) {
      gemm_kernel<T, true><<<grid, 256, 0, stream>>>(
          A, B, C, M, N, K, lda, ldb, ldc, sA, sB, sC, kch, sAk);
    } else {
      gemm_kernel<T, false><<<grid, 256, 0, stream>>>(
          A, B, C, M, N, K, lda, ldb, ldc, sA, sB, sC, 0, 0);
    }
    return static_cast<int>(cudaGetLastError());
  }
}

}  // namespace
}  // namespace cales
