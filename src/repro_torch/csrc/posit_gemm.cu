// K2: the posit GEMM with in-kernel decode: f32 activations x posit weights
// -> f32 on the serving path (linear layers and the tied unembedding), and
// the general posit x posit -> f32 or posit form of the quire GEMM.
//
// Replaces the TPU kernel repro/kernels/posit_gemm.py::posit_gemm (:87;
// pallas_call at :139) in two forms.  posit_pw_gemm is its pw_gemm form
// (:158): cfg_a = None, posit B, f32 out, transpose_b in {False, True}.
// posit_gemm is the general form: A and B each f32 or posit (int8/int16,
// any format), f32 out or posit out (out_posit: the accumulator rounded
// once to cfg_out with posit_encode, the quire's single rounding), and
// transpose_a / transpose_b.  transpose_a is the training backward's dW
// leg, dW = X^T G: A is stored [K, M] and contracted on its first axis.
//
// Bound on an H100.  A decode step (M = max_seqs <= 8 rows) reads every
// weight once, 2 B per element at posit16, for 2*M flops per element: HBM
// bytes bound it.  Every other call (prefill chunks, the quire GEMM, the
// training forward, dX and dW) does 2*M flops per element of B and runs on
// the tensor cores: bf16 mma.sync at 989 TFLOP/s dense, P bf16 products per
// f32 product (below), so its bound is P * 2MNK / 989e12 against the
// bytes it must move.
//
// Exact products on bf16 tensor cores.  TF32 keeps 11 significand bits
// and a posit16 value can need 12, so neither TF32 nor a single bf16 can
// hold the operands.  Each operand element is decoded to f32 (posits:
// posit_decode, exact) and split once, when its tile is staged, into bf16
// pieces rounded to nearest: x1 = bf16(x), x2 = bf16(x - x1),
// x3 = bf16(x - x1 - x2).  bf16 has f32's exponent range, and a bf16 x bf16
// product (8 x 8 significand bits) is exact in the f32 accumulator.
//   - A posit with n <= 16 and es <= 3 has at most 14 significand bits and
//     magnitudes in [2^-112, 2^112]: x = x1 + x2 exactly (x - x1 is a
//     multiple of x's last place below half of x1's, at most 6 bits).
//   - A finite f32 with |x| >= 2^-110 is x1 + x2 + x3 exactly (each RN
//     step leaves at most 15, then 7 bits of x's 24, on a grid bf16 still
//     reaches); where bf16(x) overflows, x1 is rounded toward zero instead.
//     Below 2^-110 the pieces drop bits under bf16's subnormal step 2^-133
//     (declared, not reached by the checks' data).
// The products summed are fixed at compile time by the operand kinds:
//   posit x posit: all 4, f32 x posit (and posit x f32): all 6, so every
//   product of decoded values is exact and only the f32 summation differs
//   from the reference, as in the FFMA kernel this replaces;
//   f32 x f32: 6 of 9: a1b1, a1b2, a2b1, a2b2, a1b3, a3b1.  The dropped
//   terms: |a - a1| <= 2^-8 |a|, so |a2| <= 2^-8 (1 + 2^-8) |a| and
//   |a3| <= 2^-8 |a - a1| <= 2^-16 |a|; |a2 b3| + |a3 b2| + |a3 b3| <=
//   2^-23 (1 + 2^-8) |a||b| + 2^-32 |a||b| < 2^-22 |a||b|, about the one
//   rounding an FFMA makes.  Over k the result moves by at most
//   2^-22 (|a| @ |b|): the checks of the f32 x f32 forms add that term to
//   the f32 dot-product bound 2 K 2^-24 (|a| @ |b|).
// Summation.  The tensor cores' internal f32 sum of an mma is not IEEE
// round-to-nearest (products aligned to the largest, then cut), so a
// product chained through several mmas collects one such cut each.  Per
// 16-deep k step the cross products go into the accumulators first, A
// piece by piece from the smallest (their cuts are a 2^-8 part of the
// result when an accumulator starts from 0), and x1 y1 into fresh zero
// accumulators, added with one f32 round-to-nearest: at K = 1 the result
// is the exact product rounded once, and over K at most one cut per mma of
// each kind and step, inside the f32 bound 2 K 2^-24 (|a| @ |b|).
// Declared departures: a partial product below f32's normal range can lose
// bits (two posit16 operands both below ~2^-50, f32 products below
// ~2^-96); an infinite f32 operand meets the other operand's zero pieces
// and gives NaN where the reference gives Inf.
//
// Design.
//   M <= 8, pw form (decode steps): skinny kernels.  Without transpose_b
//     each lane owns one output column (coalesced 2-byte weight reads
//     across the warp) and the 32 warps of a block split K into contiguous
//     ranges; their partial sums meet in shared memory and add in warp
//     order.  With transpose_b (the [V, d] table, k contiguous) each warp
//     owns one column, lanes stride k, and a butterfly shuffle adds the
//     lanes.
//   Every other call: gemm_mma_kernel.  A block computes a BM x BN tile
//     (128 x 128 with 8 warps of 64 x 32, or 64 x 64 with 4 warps of
//     32 x 32) over k-tiles of 32.  The next k-tile's raw elements (f32,
//     or the narrow posit ints) are loaded into registers, 16-, 8- or
//     4-byte chunks where rows allow it, while the current tile's mma.sync
//     m16n8k16 run; A's are then decoded, split and stored behind the
//     first 16-deep step's mma, B's behind the second, into the other of
//     two shared stages, one bf16 plane per piece, rows padded by 16
//     bytes so that ldmatrix reads 8 rows on 8 distinct bank groups.  Each
//     plane keeps the operand's stored orientation: A [m][k] or, with
//     transpose_a, [k][m]; B [n][k] with transpose_b, else [k][n].  ldmatrix
//     (.trans for [k][m] A and [k][n] B) turns either into the mma
//     fragments, so no transposed copy exists anywhere.  One block barrier
//     per k-tile.  A thread keeps the B fragments of every piece and one
//     A piece at a time; each piece product runs over the warp's 16
//     fragments, independent accumulators.  Pieces are cut two elements
//     per cvt.rn.bf16x2.  At over 200 registers a 128 x 128 block is alone
//     on its SM (8 warps).
//   Split-K.  When a shape's tiles leave SMs idle (under one wave, or a
//     small last wave) and K is long, make_plan cuts the k-tiles into S
//     equal slices (S <= 8, >= 4 k-tiles each, none empty) where that saves
//     rounds of k-tiles; block z writes its slice's f32 partial tile to a
//     workspace [S, M, N] the wrapper allocates, and splitk_reduce_kernel
//     adds s = 0..S-1 in that order and applies the
//     epilogue, so posit out is still one rounding.  No atomics: every
//     launch sums in the same order and repeats bit for bit.
//   Epilogue: f32 stores, or one RNE rounding to posit (store_value).
//     Rows and columns past M/N are masked; K ragged at the tile edge is
//     zero-filled when staged.
// The plan (tile, splits, threads, dynamic shared bytes) is mirrored by
// kernels/posit_gemm.py::gemm_plan; the wrapper passes it in and the entry
// points refuse a launch whose numbers differ (cudaErrorInvalidConfiguration).
#include <cuda_bf16.h>

#include <algorithm>

#include "posit_codec.cuh"

namespace {

// ---- the plan (mirrored by kernels/posit_gemm.py::gemm_plan) --------------
constexpr int kSMs = 132;            // H100 SXM
constexpr int kBK = 32;              // k per tile: two m16n8k16 steps
constexpr int kPad = 8;              // bf16 elements of padding per row
constexpr int kStages = 2;
constexpr int kMaxSplits = 8;
constexpr int kMinSliceTiles = 4;    // k-tiles a split-K slice keeps
constexpr int kNumTiles = 2;
constexpr int kTileBM[kNumTiles] = {128, 64};
constexpr int kTileBN[kNumTiles] = {128, 64};
constexpr int kTileWM[kNumTiles] = {2, 2};   // warps along m
constexpr int kTileWN[kNumTiles] = {4, 2};   // warps along n

struct Plan {
  int tile, bm, bn, threads, splits, per;    // per: k-tiles per slice
  size_t smem;
};

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

size_t plan_smem(int bm, int bn, int pa, int pb, bool ta, bool tb) {
  const int a_rows = ta ? kBK : bm, a_cols = ta ? bm : kBK;
  const int b_rows = tb ? bn : kBK, b_cols = tb ? kBK : bn;
  return sizeof(__nv_bfloat16) * kStages *
         static_cast<size_t>(pa * a_rows * (a_cols + kPad) +
                             pb * b_rows * (b_cols + kPad));
}

// Per tile, largest first: the split S (1, or 2..8 slices of at least
// kMinSliceTiles k-tiles, considered while the tiles fill under two waves)
// that takes the fewest rounds of k-tiles on the SMs at one block each,
// ceil(tiles S / SMs) * ceil(nk / S), where a split must save at least a
// tenth; the tile is kept if its blocks are busy at least 3/4 of that time
// (the smallest tile is kept regardless).
Plan make_plan(int M, int N, int K, int pa, int pb, bool ta, bool tb) {
  const long long nk = cdiv(K > 0 ? K : 1, kBK);
  int t = 0;
  long long splits = 1, per = nk;
  for (;; ++t) {
    const long long tiles = cdiv(M, kTileBM[t]) * cdiv(N, kTileBN[t]);
    const long long cost1 = cdiv(tiles, kSMs) * nk;
    long long best = cost1;
    splits = 1;
    per = nk;
    if (tiles < 2 * kSMs) {
      const long long top =
          std::min<long long>(kMaxSplits, nk / kMinSliceTiles);
      for (long long s = 2; s <= top; ++s) {
        const long long p = cdiv(nk, s), se = cdiv(nk, p);
        const long long c = cdiv(tiles * se, kSMs) * p;
        if (c < best && 10 * c <= 9 * cost1) {
          best = c;
          splits = se;
          per = p;
        }
      }
    }
    if (4 * tiles * nk >= 3 * kSMs * best || t == kNumTiles - 1) break;
  }
  Plan p;
  p.tile = t;
  p.bm = kTileBM[t];
  p.bn = kTileBN[t];
  p.threads = kTileWM[t] * kTileWN[t] * 32;
  p.splits = static_cast<int>(splits);
  p.per = static_cast<int>(per);
  p.smem = plan_smem(p.bm, p.bn, pa, pb, ta, tb);
  return p;
}

// ---- operands, output ------------------------------------------------------
struct Operand {
  const void* p;
  int dtype, n, es;                  // DT_F32, or posit ints of (n, es)
  int rows, cols;                    // stored shape; cols contiguous
  int vec;                           // rows 4-element aligned: chunk loads
};

struct Out {
  void* p;
  int dtype, n, es;                  // f32, or one RNE rounding to posit
  size_t zstride;                    // split-K: elements between slices
  __device__ __forceinline__ void store(size_t i, float v) const {
    if (dtype == DT_I8)
      static_cast<int8_t*>(p)[i] = store_value<int8_t>(v, n, es);
    else if (dtype == DT_I16)
      static_cast<int16_t*>(p)[i] = store_value<int16_t>(v, n, es);
    else
      static_cast<float*>(p)[i] = v;
  }
};

// ---- bf16 pieces ---------------------------------------------------------
// Two elements x0, x1 -> P packed bf16x2 words (cvt.rn.bf16x2.f32): word p
// holds x0's piece p in its low half and x1's in its high half, each piece
// rounded to nearest from what the earlier ones leave.  Where bf16(x)
// overflows, x1 is rounded toward zero instead; a non-finite x keeps
// x1 = x and zero pieces after it.
__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}
__device__ __forceinline__ uint32_t bf2_rn(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
template <int P>
__device__ __forceinline__ void split_pair(float x0, float x1,
                                           uint32_t (&h)[P]) {
  uint32_t w = bf2_rn(x0, x1);
  if (P == 3) {                                  // |x| above bf16's max
    if (isinf(bf_lo(w)) && isfinite(x0))
      w = (w & 0xFFFF0000u) | (__float_as_uint(x0) >> 16);
    if (isinf(bf_hi(w)) && isfinite(x1))
      w = (w & 0xFFFFu) | (__float_as_uint(x1) & 0xFFFF0000u);
  }
  h[0] = w;
  float r0 = isfinite(x0) ? x0 - bf_lo(w) : 0.0f;
  float r1 = isfinite(x1) ? x1 - bf_hi(w) : 0.0f;
#pragma unroll
  for (int p = 1; p < P; ++p) {
    w = bf2_rn(r0, r1);
    h[p] = w;
    r0 = r0 - bf_lo(w);
    r1 = r1 - bf_hi(w);
  }
}

// Raw registers of one 4-element chunk: f32, or 4 posit ints (int16 in
// x and y, int8 in x).
template <int P>
struct RawChunk;
template <>
struct RawChunk<3> {
  using T = float4;
};
template <>
struct RawChunk<2> {
  using T = uint2;
};

// Global -> registers: chunk c of an R x C tile (stored orientation) at
// (r0, c0); zero past the operand's rows and columns.
template <int P, int R, int C, int NT>
__device__ __forceinline__ void load_tile(
    const Operand& op, int r0, int c0,
    typename RawChunk<P>::T (&raw)[R * C / 4 / NT]) {
  constexpr int CPR = C / 4;
  constexpr int CH = R * CPR / NT;
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int c = threadIdx.x + i * NT;
    const int gr = r0 + c / CPR, gc = c0 + (c % CPR) * 4;
    const bool in = gr < op.rows && gc < op.cols;
    const size_t base = static_cast<size_t>(gr) * op.cols + gc;
    if constexpr (P == 3) {
      const float* p = static_cast<const float*>(op.p) + base;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (in) {
        if (op.vec) {
          v = __ldg(reinterpret_cast<const float4*>(p));
        } else {
          v.x = __ldg(p);
          if (gc + 1 < op.cols) v.y = __ldg(p + 1);
          if (gc + 2 < op.cols) v.z = __ldg(p + 2);
          if (gc + 3 < op.cols) v.w = __ldg(p + 3);
        }
      }
      raw[i] = v;
    } else {
      uint2 v = make_uint2(0u, 0u);
      if (in && op.dtype == DT_I16) {
        const uint16_t* p = static_cast<const uint16_t*>(op.p) + base;
        if (op.vec) {
          v = __ldg(reinterpret_cast<const uint2*>(p));
        } else {
          uint32_t e[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (gc + j < op.cols) e[j] = p[j];
          v = make_uint2(e[0] | (e[1] << 16), e[2] | (e[3] << 16));
        }
      } else if (in) {
        const uint8_t* p = static_cast<const uint8_t*>(op.p) + base;
        if (op.vec) {
          v.x = __ldg(reinterpret_cast<const unsigned int*>(p));
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (gc + j < op.cols) v.x |= static_cast<uint32_t>(p[j]) << (8 * j);
        }
      }
      raw[i] = v;
    }
  }
}

// Registers -> the P shared planes of one stage: decode, split, and store
// each piece's 4 bf16 as one 8-byte word.
template <int P, int R, int C, int NT>
__device__ __forceinline__ void store_tile(
    const Operand& op, const typename RawChunk<P>::T (&raw)[R * C / 4 / NT],
    __nv_bfloat16* planes) {
  constexpr int CPR = C / 4;
  constexpr int CH = R * CPR / NT;
  constexpr int LD = C + kPad;
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int c = threadIdx.x + i * NT;
    const int r = c / CPR, col = (c % CPR) * 4;
    float v[4];
    if constexpr (P == 3) {
      v[0] = raw[i].x;
      v[1] = raw[i].y;
      v[2] = raw[i].z;
      v[3] = raw[i].w;
    } else if (op.dtype == DT_I16) {
      v[0] = posit_decode(static_cast<int32_t>(raw[i].x & 0xFFFFu), op.n,
                          op.es);
      v[1] = posit_decode(static_cast<int32_t>(raw[i].x >> 16), op.n, op.es);
      v[2] = posit_decode(static_cast<int32_t>(raw[i].y & 0xFFFFu), op.n,
                          op.es);
      v[3] = posit_decode(static_cast<int32_t>(raw[i].y >> 16), op.n, op.es);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = posit_decode(static_cast<int32_t>((raw[i].x >> (8 * j)) & 0xFFu),
                            op.n, op.es);
    }
    uint32_t h01[P], h23[P];
    split_pair<P>(v[0], v[1], h01);
    split_pair<P>(v[2], v[3], h23);
#pragma unroll
    for (int p = 0; p < P; ++p)
      *reinterpret_cast<uint2*>(planes + p * R * LD + r * LD + col) =
          make_uint2(h01[p], h23[p]);
  }
}

// ---- tensor-core primitives ----------------------------------------------
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- the tiled tensor-core GEMM --------------------------------------------
// A [M, K] (TA: [K, M]) x B [K, N] (TB: [N, K]) over k-tiles
// [z * per, min(nk, (z + 1) * per)) of block z; PA / PB bf16 pieces per
// element (3: f32, 2: posit).
template <int BM, int BN, int WM, int WN, int PA, int PB, bool TA, bool TB>
__global__ void __launch_bounds__(WM * WN * 32, 1)
gemm_mma_kernel(Operand a, Operand b, Out out, int M, int N, int K,
                int per) {
  constexpr int NT = WM * WN * 32;
  constexpr int WTM = BM / WM, WTN = BN / WN;
  constexpr int MF = WTM / 16, NF = WTN / 8;
  static_assert(NF % 2 == 0, "B fragments load in pairs");
  constexpr int AR = TA ? kBK : BM, AC = TA ? BM : kBK, ALD = AC + kPad;
  constexpr int BR = TB ? BN : kBK, BC = TB ? kBK : BN, BLD = BC + kPad;
  constexpr int APL = AR * ALD, BPL = BR * BLD;      // elements per plane
  constexpr int STAGE = PA * APL + PB * BPL;
  constexpr int CHA = AR * AC / 4 / NT, CHB = BR * BC / 4 / NT;
  static_assert(CHA * 4 * NT == AR * AC && CHB * 4 * NT == BR * BC,
                "tiles split evenly into 4-element chunks");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const uint32_t sbase =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm0 = (warp / WN) * WTM, wn0 = (warp % WN) * WTN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (max(K, 1) + kBK - 1) / kBK;
  const int kt0 = blockIdx.z * per;
  const int kt1 = min(nk, kt0 + per);

  // per-lane element offsets of the ldmatrix rows inside a stage
  const int a_off = TA ? (lane % 8 + (lane / 16) * 8) * ALD + wm0 +
                             ((lane / 8) % 2) * 8
                       : (wm0 + lane % 16) * ALD + (lane / 16) * 8;
  const int b_off = PA * APL +
                    (TB ? (wn0 + lane % 8 + (lane / 16) * 8) * BLD +
                              ((lane / 8) % 2) * 8
                        : (lane % 8 + ((lane / 8) % 2) * 8) * BLD + wn0 +
                              (lane / 16) * 8);

  float acc[MF][NF][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;

  typename RawChunk<PA>::T ra[CHA];
  typename RawChunk<PB>::T rb[CHB];
  load_tile<PA, AR, AC, NT>(a, TA ? kt0 * kBK : m0, TA ? m0 : kt0 * kBK, ra);
  load_tile<PB, BR, BC, NT>(b, TB ? n0 : kt0 * kBK, TB ? kt0 * kBK : n0, rb);
  store_tile<PA, AR, AC, NT>(a, ra, smem);
  store_tile<PB, BR, BC, NT>(b, rb, smem + PA * APL);
  __syncthreads();
  for (int kt = kt0; kt < kt1; ++kt) {
    const int s = (kt - kt0) & 1;
    const bool more = kt + 1 < kt1;
    if (more) {                      // the next k-tile, in flight over the mma
      const int k1 = (kt + 1) * kBK;
      load_tile<PA, AR, AC, NT>(a, TA ? k1 : m0, TA ? m0 : k1, ra);
      load_tile<PB, BR, BC, NT>(b, TB ? n0 : k1, TB ? k1 : n0, rb);
    }
    const uint32_t st = sbase + 2u * static_cast<uint32_t>(s * STAGE);
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      uint32_t bf[PB][NF][2];
#pragma unroll
      for (int p = 0; p < PB; ++p)
#pragma unroll
        for (int q = 0; q < NF / 2; ++q) {
          uint32_t r[4];
          const int e = b_off + p * BPL +
                        (TB ? q * 16 * BLD + ks : ks * BLD + q * 16);
          if (TB)
            ldsm_x4(r, st + 2u * e);
          else
            ldsm_x4_t(r, st + 2u * e);
          bf[p][2 * q][0] = r[0];
          bf[p][2 * q][1] = r[1];
          bf[p][2 * q + 1][0] = r[2];
          bf[p][2 * q + 1][1] = r[3];
        }
      // A piece by piece, largest index (smallest piece) first; each of its
      // cross products over all 16 fragments (independent accumulators)
#pragma unroll
      for (int pa = PA - 1; pa >= 0; --pa) {
        uint32_t af[MF][4];
#pragma unroll
        for (int i = 0; i < MF; ++i) {
          const int e = a_off + pa * APL +
                        (TA ? ks * ALD + i * 16 : i * 16 * ALD + ks);
          if (TA)
            ldsm_x4_t(af[i], st + 2u * e);
          else
            ldsm_x4(af[i], st + 2u * e);
        }
#pragma unroll
        for (int pb = PB - 1; pb >= 0; --pb) {
          if (pa + pb == 0) continue;                    // x1 y1: below
          if (PA == 3 && PB == 3 && pa + pb > 2) continue;   // dropped terms
#pragma unroll
          for (int i = 0; i < MF; ++i)
#pragma unroll
            for (int j = 0; j < NF; ++j)
              mma_bf16(acc[i][j], af[i], bf[pb][j][0], bf[pb][j][1]);
        }
        if (pa == 0) {
          // x1 y1 into fresh zero accumulators, added with one f32 rounding
#pragma unroll
          for (int i = 0; i < MF; ++i) {
            float t[NF][4];
#pragma unroll
            for (int j = 0; j < NF; ++j) {
#pragma unroll
              for (int q = 0; q < 4; ++q) t[j][q] = 0.0f;
              mma_bf16(t[j], af[i], bf[0][j][0], bf[0][j][1]);
            }
#pragma unroll
            for (int j = 0; j < NF; ++j)
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[i][j][q] += t[j][q];
          }
        }
      }
      if (ks == 0 && more)             // A's next tile, behind ks 0's mma
        store_tile<PA, AR, AC, NT>(a, ra, smem + (s ^ 1) * STAGE);
    }
    if (more)                          // B's, behind ks 16's
      store_tile<PB, BR, BC, NT>(b, rb, smem + (s ^ 1) * STAGE + PA * APL);
    __syncthreads();
  }

  // epilogue: c0, c1 at (g, 2t..2t+1), c2, c3 at (g + 8, ...)
  Out o = out;
  o.p = o.dtype == DT_F32
            ? static_cast<void*>(static_cast<float*>(out.p) +
                                 blockIdx.z * out.zstride)
            : out.p;
  const int g = lane / 4, tq = lane % 4;
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int col = n0 + wn0 + j * 8 + 2 * tq;
      if (col >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm0 + i * 16 + g + 8 * h;
        if (row >= M) continue;
        const size_t idx = static_cast<size_t>(row) * N + col;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (o.dtype == DT_F32 && (N % 2) == 0) {
          *reinterpret_cast<float2*>(static_cast<float*>(o.p) + idx) =
              make_float2(v0, v1);
        } else {
          o.store(idx, v0);
          if (col + 1 < N) o.store(idx + 1, v1);
        }
      }
    }
}

// out[i] = ws[0][i] + ws[1][i] + ... + ws[S-1][i], in that order, then the
// epilogue (f32, or one rounding to posit).
__global__ void __launch_bounds__(256)
splitk_reduce_kernel(const float* __restrict__ ws, int S, size_t MN, Out o) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < MN; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = ws[i];
    for (int z = 1; z < S; ++z) s += ws[z * MN + i];
    o.store(i, s);
  }
}

template <int T, int PA, int PB, bool TA, bool TB>
int launch_mma(const Operand& a, const Operand& b, const Out& out,
               float* ws, const Plan& pl, int M, int N, int K,
               cudaStream_t st) {
  constexpr int BM = kTileBM[T], BN = kTileBN[T];
  constexpr int WM = kTileWM[T], WN = kTileWN[T];
  if (pl.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gemm_mma_kernel<BM, BN, WM, WN, PA, PB, TA, TB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(pl.smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const size_t MN = static_cast<size_t>(M) * N;
  Out o = out;
  if (pl.splits > 1) o = Out{ws, DT_F32, 0, 0, MN};
  dim3 grid(static_cast<unsigned>(cdiv(N, BN)),
            static_cast<unsigned>(cdiv(M, BM)), pl.splits);
  gemm_mma_kernel<BM, BN, WM, WN, PA, PB, TA, TB>
      <<<grid, pl.threads, pl.smem, st>>>(a, b, o, M, N, K, pl.per);
  if (pl.splits > 1) {
    const long long blocks = std::min<long long>(cdiv(MN, 256), 8 * kSMs);
    splitk_reduce_kernel<<<static_cast<unsigned>(blocks), 256, 0, st>>>(
        ws, pl.splits, MN, out);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int T, int PA, int PB>
int dispatch_trans(bool ta, bool tb, const Operand& a, const Operand& b,
                   const Out& o, float* ws, const Plan& pl, int M, int N,
                   int K, cudaStream_t st) {
  if (ta)
    return tb ? launch_mma<T, PA, PB, true, true>(a, b, o, ws, pl, M, N, K, st)
              : launch_mma<T, PA, PB, true, false>(a, b, o, ws, pl, M, N, K,
                                                   st);
  return tb ? launch_mma<T, PA, PB, false, true>(a, b, o, ws, pl, M, N, K, st)
            : launch_mma<T, PA, PB, false, false>(a, b, o, ws, pl, M, N, K,
                                                  st);
}

template <int T>
int dispatch_pieces(int pa, int pb, bool ta, bool tb, const Operand& a,
                    const Operand& b, const Out& o, float* ws,
                    const Plan& pl, int M, int N, int K, cudaStream_t st) {
  if (pa == 3)
    return pb == 3
               ? dispatch_trans<T, 3, 3>(ta, tb, a, b, o, ws, pl, M, N, K, st)
               : dispatch_trans<T, 3, 2>(ta, tb, a, b, o, ws, pl, M, N, K, st);
  return pb == 3
             ? dispatch_trans<T, 2, 3>(ta, tb, a, b, o, ws, pl, M, N, K, st)
             : dispatch_trans<T, 2, 2>(ta, tb, a, b, o, ws, pl, M, N, K, st);
}

Operand make_operand(const void* p, int dtype, int n, int es, int rows,
                     int cols) {
  const size_t chunk = 4 * (dtype == DT_F32 ? 4 : dtype == DT_I16 ? 2 : 1);
  const bool vec = cols % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(p) % chunk == 0;
  return Operand{p, dtype, n, es, rows, cols, vec ? 1 : 0};
}

// The tiled launch: the caller's plan must be this file's.
int launch_tiled(const Operand& a, const Operand& b, const Out& o, bool ta,
                 bool tb, int M, int N, int K, void* ws, int bm, int bn,
                 int splits, int threads, long long smem, cudaStream_t st) {
  const int pa = a.dtype == DT_F32 ? 3 : 2, pb = b.dtype == DT_F32 ? 3 : 2;
  const Plan pl = make_plan(M, N, K, pa, pb, ta, tb);
  if (bm != pl.bm || bn != pl.bn || splits != pl.splits ||
      threads != pl.threads || smem != static_cast<long long>(pl.smem))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if (pl.splits > 1 && ws == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  float* w = static_cast<float*>(ws);
  return pl.tile == 0
             ? dispatch_pieces<0>(pa, pb, ta, tb, a, b, o, w, pl, M, N, K, st)
             : dispatch_pieces<1>(pa, pb, ta, tb, a, b, o, w, pl, M, N, K, st);
}

// ---- skinny M (decode steps) ----------------------------------------------
constexpr int kSkinnyM = 8;
constexpr int kGemvWarps = 32;

// w [K, N], n contiguous: one column per lane, warps split K.
template <typename T>
__global__ void __launch_bounds__(kGemvWarps * 32)
pw_gemv_kernel(const float* __restrict__ x, const T* __restrict__ w,
               float* __restrict__ out, int M, int N, int K, int n, int es) {
  __shared__ float red[kGemvWarps][kSkinnyM][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  const int chunk = (K + kGemvWarps - 1) / kGemvWarps;
  const int k0 = warp * chunk, k1 = min(K, k0 + chunk);
  float acc[kSkinnyM];
#pragma unroll
  for (int m = 0; m < kSkinnyM; ++m) acc[m] = 0.0f;
  if (col < N) {
#pragma unroll 4
    for (int k = k0; k < k1; ++k) {
      const float wv = load_value<T>(w, static_cast<size_t>(k) * N + col, n,
                                     es);
#pragma unroll
      for (int m = 0; m < kSkinnyM; ++m)
        if (m < M)
          acc[m] = fmaf(__ldg(&x[static_cast<size_t>(m) * K + k]), wv, acc[m]);
    }
  }
#pragma unroll
  for (int m = 0; m < kSkinnyM; ++m) red[warp][m][lane] = acc[m];
  __syncthreads();
  if (threadIdx.x < kSkinnyM * 32) {
    const int m = threadIdx.x >> 5, c = threadIdx.x & 31;
    const int gc = blockIdx.x * 32 + c;
    if (m < M && gc < N) {
      float s = 0.0f;
      for (int i = 0; i < kGemvWarps; ++i) s += red[i][m][c];
      out[static_cast<size_t>(m) * N + gc] = s;
    }
  }
}

// w [N, K], k contiguous: one column per warp, lanes stride k.
template <typename T>
__global__ void __launch_bounds__(256)
pw_gemv_t_kernel(const float* __restrict__ x, const T* __restrict__ w,
                 float* __restrict__ out, int M, int N, int K, int n, int es) {
  const int lane = threadIdx.x & 31;
  const int col = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (col >= N) return;                          // whole warp; no barrier
  const T* wr = w + static_cast<size_t>(col) * K;
  float acc[kSkinnyM];
#pragma unroll
  for (int m = 0; m < kSkinnyM; ++m) acc[m] = 0.0f;
#pragma unroll 4
  for (int k = lane; k < K; k += 32) {
    const float wv = load_value<T>(wr, k, n, es);
#pragma unroll
    for (int m = 0; m < kSkinnyM; ++m)
      if (m < M)
        acc[m] = fmaf(__ldg(&x[static_cast<size_t>(m) * K + k]), wv, acc[m]);
  }
#pragma unroll
  for (int m = 0; m < kSkinnyM; ++m)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], off);
  if (lane == 0)
    for (int m = 0; m < M; ++m) out[static_cast<size_t>(m) * N + col] = acc[m];
}

template <typename T>
void launch_skinny(const float* x, const void* w, float* out, int M, int N,
                   int K, bool transpose_b, int n, int es, cudaStream_t st) {
  const T* wt = static_cast<const T*>(w);
  if (transpose_b)
    pw_gemv_t_kernel<T><<<(N + 7) / 8, 256, 0, st>>>(x, wt, out, M, N, K, n,
                                                     es);
  else
    pw_gemv_kernel<T><<<(N + 31) / 32, kGemvWarps * 32, 0, st>>>(
        x, wt, out, M, N, K, n, es);
}

}  // namespace

// x [M, K] f32; w [K, N] (or [N, K] when transpose_b) posit ints; out [M, N].
// M <= 8 runs the skinny kernels (the plan arguments are not read); above,
// the tiled kernel with the caller's plan (bm, bn, splits, threads, smem)
// and, when splits > 1, its f32 workspace ws [splits, M, N].
extern "C" int posit_pw_gemm(const void* x, const void* w, void* out, int M,
                             int N, int K, int transpose_b, int dtype, int n,
                             int es, void* ws, int bm, int bn, int splits,
                             int threads, long long smem, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (dtype != DT_I8 && dtype != DT_I16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= kSkinnyM) {
    const float* xf = static_cast<const float*>(x);
    float* of = static_cast<float*>(out);
    if (dtype == DT_I8)
      launch_skinny<int8_t>(xf, w, of, M, N, K, transpose_b, n, es, st);
    else
      launch_skinny<int16_t>(xf, w, of, M, N, K, transpose_b, n, es, st);
    return static_cast<int>(cudaGetLastError());
  }
  const Operand a = make_operand(x, DT_F32, 0, 0, M, K);
  const Operand b = transpose_b ? make_operand(w, dtype, n, es, N, K)
                                : make_operand(w, dtype, n, es, K, N);
  return launch_tiled(a, b, Out{out, DT_F32, 0, 0, 0}, false, transpose_b,
                      M, N, K, ws, bm, bn, splits, threads, smem, st);
}

// a [M, K] (or [K, M] when transpose_a), b [K, N] (or [N, K] when
// transpose_b), out [M, N]; each of the three is f32 (dtype 0) or posit ints
// (1: int8, 2: int16) of format (n, es).  Always the tiled kernel, with the
// caller's plan and, when splits > 1, its f32 workspace ws [splits, M, N].
extern "C" int posit_gemm(const void* a, const void* b, void* out, int M,
                          int N, int K, int transpose_a, int transpose_b,
                          int dta, int na, int esa, int dtb, int nb, int esb,
                          int dto, int no, int eso, void* ws, int bm, int bn,
                          int splits, int threads, long long smem,
                          void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const int dts[3] = {dta, dtb, dto};
  for (int dt : dts)
    if (dt != DT_F32 && dt != DT_I8 && dt != DT_I16)
      return static_cast<int>(cudaErrorInvalidValue);
  const Operand oa = transpose_a ? make_operand(a, dta, na, esa, K, M)
                                 : make_operand(a, dta, na, esa, M, K);
  const Operand ob = transpose_b ? make_operand(b, dtb, nb, esb, N, K)
                                 : make_operand(b, dtb, nb, esb, K, N);
  return launch_tiled(oa, ob, Out{out, dto, no, eso, 0}, transpose_a != 0,
                      transpose_b != 0, M, N, K, ws, bm, bn, splits, threads,
                      smem, static_cast<cudaStream_t>(stream));
}
