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
//   M <= 8, pw form (decode steps): pw_skinny_kernel, which streams the
//     weights once through FFMA.  FFMA, not the tensor cores: at M <= 8 an
//     element costs M FFMAs on the FP32 pipe, issued beside the decode's
//     integer work; the tensor cores would take over the FFMAs but not the
//     decode, and would add the bf16 piece split above on top.  The integer
//     decode sets the pace either way.
//     - Decode specialised per format (a template parameter).  int8 storage
//       (every n <= 8 format): a 256-entry f32 table in shared memory, built
//       at block start, one load per element.  P16_2 (serving's format):
//       the 8 bits after the sign of a = |p| (p at the top of a 32-bit word)
//       index a 256-entry table whose entry e holds the f32 bits of the
//       regime's scale, less the regime's own bits, and in its low 5 bits a
//       rotation that puts the exponent field at bit 23:
//         v = ((rotl(a, e & 31) + e) & 0x7FFFF000) | (p's sign),
//       about 9 integer operations and one shared load.  The fraction ends
//       above bit 11, so the rotation's 5 bits never carry into it.  Where
//       the regime runs past that byte (|w| >= 2^24 or < 2^-28, 0 and NaR)
//       the entry carries a flag (bit 11) and the 8 values of that load go
//       through posit_decode instead.  Every other int16 format runs
//       posit_decode with its runtime (n, es).  All bit-exact against the
//       reference.
//     - 16-byte weight loads.  w [K, N]: a lane loads 8 posit16 (16 posit8)
//       columns of one k-row; tn lanes along n, 256 / tn k-rows a block
//       pass.  w [N, K] (transpose_b): a lane loads 8 (16) consecutive k of
//       each of 4 columns; the 8 lanes of a quarter warp hold 8 column
//       groups at one k, so they read one x row.  Loads go by cp.async into
//       the lane's own slots of a ring in shared memory, 4 steps of 2 k-rows
//       (3 steps of 4 column loads with transpose_b) in flight; a lane waits
//       only for its own copies, so the ring needs no barrier.  Rows that
//       are not 16-byte aligned load element by element into registers.
//     - x staged once per k-chunk in shared memory as [k][m], m padded with
//       zeros to MP = 4 or 8: one k's values are one or two float4 reads
//       shared by the lane's columns.  No global x load and no m < M test in
//       the loop; a lane keeps MP x its columns accumulators.
//     - Every SM busy in one launch: make_skinny_plan picks the column tile
//       (tn), a k-split over the cs <= 8 blocks of a thread-block cluster
//       (cudaLaunchKernelEx), and a grid persistent over tiles, for the
//       fewest rounds of work on 132 SMs at the blocks each SM holds.  A
//       cluster's partials meet in its leader's shared memory through
//       distributed shared memory.  No atomics, no workspace.
//     - Sum order, fixed, so a repeated launch gives the same bits.  A lane
//       adds its products by FFMA in increasing k.  The block's k-lanes of a
//       column meet in shared memory as p[i] + p[i + h] (h = half of them),
//       added over i in order from 0; the cluster's ranks add in rank order;
//       when x is staged in several k-chunks (past 32 KB), each chunk's sum
//       is added to the output in chunk order.  Every product is exact inside
//       its FFMA, so the result is an f32 sum of exact products in a fixed
//       order: within 2 K 2^-24 (|x| @ |w|) of any other order.
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
// The plans (tile, splits, threads, dynamic shared bytes) are mirrored by
// kernels/posit_gemm.py::gemm_plan and ::skinny_plan; the wrapper passes
// them in and the entry points refuse a launch whose numbers differ
// (cudaErrorInvalidConfiguration).
#include <cooperative_groups.h>
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

// ---- skinny M: the decode step's weight stream (mirrored by skinny_plan) --
constexpr int kSkinnyM = 8;
constexpr int kSkThreads = 256;
constexpr int kSkMaxCluster = 8;          // the portable cluster size
constexpr int kSkXsBytes = 32 * 1024;     // x staged per k-chunk, at most
constexpr int kSkTabBytes = 256 * 4;      // the static decode table
constexpr int kSkSmemSM = 233472;         // shared bytes of an SM (H100)
constexpr int kSkSmemBlock = 232448;      // ... that one block may use
constexpr int kSkReserve = 1024;          // the system's share per block
constexpr int kSkTileCost = 8192;         // a tile's fixed cost, in elements
constexpr int kSkClusterCost = 8192;      // ... more with a cluster's syncs
constexpr int kSkTnN[] = {32, 16, 8, 4, 2};  // w [K, N]: lanes along n
constexpr int kSkTnT[] = {64, 32, 16, 8};    // w [N, K]: column groups
constexpr int kSkNtnN = sizeof(kSkTnN) / sizeof(int);
constexpr int kSkNtnT = sizeof(kSkTnT) / sizeof(int);

enum SkFmt { SK_TAB8 = 0, SK_P16E2 = 1, SK_GEN16 = 2 };
// Groups of a lane's pipeline step (k-rows of w [K, N]; one group of 4
// column loads for w [N, K]), its 16-byte loads, and the steps in flight
// (cp.async into the lane's own ring slots in shared memory).
__host__ __device__ constexpr int sk_step_groups(bool tb) {
  return tb ? 1 : 2;
}
__host__ __device__ constexpr int sk_step_loads(bool tb) {
  return tb ? 4 : 2;
}
__host__ __device__ constexpr int sk_stages(bool tb) { return tb ? 3 : 4; }

// Columns a lane holds, and k per group (one 16-byte load along k, or one
// k-row), for a format of eb bytes.
__host__ __device__ constexpr int sk_cpt(bool tb, int eb) {
  return tb ? 4 : 16 / eb;
}
__host__ __device__ constexpr int sk_kpg(bool tb, int eb) {
  return tb ? 16 / eb : 1;
}
// Blocks an SM holds by registers (two: at most 128 a thread).  One past
// 64 accumulators a lane, and for [N, K] weights at MP = 8: four 16-byte
// loads in flight and two steps' x rows beside 32 accumulators spilled at
// 128 registers.
__host__ __device__ constexpr int sk_min_blocks(bool tb, int eb, int mp) {
  return mp * sk_cpt(tb, eb) > 64 || (tb && mp == 8) ? 1 : 2;
}

struct SkPlan {
  int mp, cpt, kpg, tn, tk, bn, cs;
  int per, chunk, nch, tiles, grid;       // per, chunk: k-groups
  long long smem;                         // dynamic shared bytes
};

// For each column tile (tn, widest first) and cluster size cs (1..8, none
// leaving a rank without k): ranks split the k-groups into cs equal slices,
// x is staged in chunks of at most 32 KB, and blocks loop over the tiles,
// as many as the SMs hold at once (a cluster takes one tile: clusters
// looping over tiles, two cluster syncs a tile, ran slower than blocks).
// The cost is the
// elements one block streams, rounds of tiles x (its slice x tile width +
// each chunk's fixed cost: its first loads' latency and its sums, and a
// cluster's two syncs); the cheapest plan wins, the first of equals.
SkPlan make_skinny_plan(int M, int N, int K, bool tb, int eb) {
  const int mp = M <= 4 ? 4 : 8;
  const int cpt = sk_cpt(tb, eb), kpg = sk_kpg(tb, eb);
  const long long ng = cdiv(K > 0 ? K : 1, kpg);
  const long long xs_groups = kSkXsBytes / (4LL * kpg * mp);
  const int* tns = tb ? kSkTnT : kSkTnN;
  const int ntn = tb ? kSkNtnT : kSkNtnN;
  const long long reg_bps = sk_min_blocks(tb, eb, mp);
  SkPlan best{};
  long long best_cost = -1;
  for (int i = 0; i < ntn; ++i) {
    const int tn = tns[i], tk = kSkThreads / tn, bn = tn * cpt;
    const long long tiles = cdiv(N, bn);
    for (int cs = 1; cs <= kSkMaxCluster; ++cs) {
      const long long per = cdiv(ng, cs);
      if (cdiv(ng, per) != cs) continue;
      const long long chunk = std::min(per, xs_groups);
      const long long red = 4LL * (tk / 2) * (mp * bn + 4);
      const long long cred = cs > 1 ? 4LL * cs * mp * bn : 0;
      const long long ring = 16LL * sk_stages(tb) * sk_step_loads(tb) *
                             kSkThreads;
      const long long smem =
          4LL * chunk * kpg * mp + std::max(red, cred) + ring;
      if (smem + kSkTabBytes > kSkSmemBlock) continue;
      const long long bps = std::min(
          reg_bps, kSkSmemSM / (smem + kSkTabBytes + kSkReserve));
      const long long groups =
          std::min(tiles, std::max(1LL, kSMs * bps / cs));
      if (cs > 1 && groups < tiles) continue;   // a cluster takes one tile
      const long long nch = cdiv(per, chunk);
      const long long fixed = kSkTileCost + (cs > 1 ? kSkClusterCost : 0);
      const long long cost =
          cdiv(tiles, groups) * (per * kpg * bn + nch * fixed);
      if (best_cost < 0 || cost < best_cost) {
        best_cost = cost;
        best = SkPlan{mp, cpt, kpg, tn, tk, bn, cs,
                      static_cast<int>(per), static_cast<int>(chunk),
                      static_cast<int>(nch),
                      static_cast<int>(tiles),
                      static_cast<int>(groups * cs), smem};
      }
    }
  }
  return best;
}

struct SkArgs {
  const float* x;                         // [M, K]
  const void* w;                          // [K, N], or [N, K] (transpose_b)
  float* out;                             // [M, N]
  int M, N, K, n, es;
  int vec;                                // 16-byte weight loads allowed
  int tn, tk, bn, cs, per, chunk, nch, tiles;
  int xs_floats;                          // floats of the staged x region
  int ring_off;                           // floats before the load ring
};

// P16_2's table entry for i = a[30:23], the 8 bits after the sign of the
// magnitude a (the 16-bit pattern at the top of a 32-bit word).  The regime
// (run bits equal to i's first, and the opposite terminator) takes S = run
// + 2 bits of a with the sign; rotating a left by S - 7 (mod 32) puts its
// exponent bits at 24:23 and its fraction under them, the regime's top bits
// at 31:25 (for S <= 7 the zeros of a's low half wrap to the top).  The
// entry is the f32 bits of 2^(4k) less those regime bits, plus the
// rotation in bits 4:0.  The rotated a is zero below bit 12 and the fraction
// ends above bit 11, so bits 11:0 of the sum are cleared: the rotation
// never carries into the value.  Bit 11 (kSkSlow) marks a regime longer
// than i's 7 bits (0x00, 0xFF) and i = 0xFE, whose rotation would wrap a
// regime bit into bit 0.
constexpr uint32_t kSkSlow = 0x800u;
__device__ __forceinline__ uint32_t p16e2_entry(uint32_t i) {
  const uint32_t r0 = i >> 7;
  const uint32_t y = r0 ? (~i & 0xFFu) : i;
  if (y == 0u || i == 0xFEu) return kSkSlow;
  const int run = __clz(static_cast<int>(y)) - 24;       // 1..7
  const int S = run + 2;
  const int k = r0 ? run - 1 : -run;
  const uint32_t top = i >> (9 - S);                     // a's top S bits
  const uint32_t regime = (S <= 7 ? top : top & 0x7Fu) << 25;
  return (static_cast<uint32_t>(4 * k + 127) << 23) - regime +
         (static_cast<uint32_t>(S + 25) & 31u);
}

// One P16_2 element at the top of xi (low half zero) -> f32; ORs the entry
// into `slow`, whose kSkSlow bit then sends the load to posit_decode.
__device__ __forceinline__ float p16e2_fast(uint32_t xi, const uint32_t* tab,
                                            uint32_t& slow) {
  uint32_t a;                                 // abs.s32 keeps NaR's 2^31
  asm("abs.s32 %0, %1;" : "=r"(a) : "r"(xi));
  const uint32_t e = tab[(a >> 23) & 0xFFu];
  slow |= e;
  const uint32_t r = __funnelshift_l(a, a, e);           // rotl(a, e & 31)
  return __uint_as_float(((r + e) & 0x7FFFF000u) | (xi & 0x80000FFFu));
}

__device__ __forceinline__ uint32_t sk_word(const uint4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// Eight int16 posits, two per word (low half first) -> f32.
template <int FMT>
__device__ __forceinline__ void sk_decode8(const uint32_t (&wd)[4],
                                           float (&v)[8],
                                           const uint32_t* tab, int n,
                                           int es) {
  if constexpr (FMT == SK_P16E2) {
    uint32_t slow = 0u;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[2 * q] = p16e2_fast(wd[q] << 16, tab, slow);
      v[2 * q + 1] = p16e2_fast(wd[q] & 0xFFFF0000u, tab, slow);
    }
    if (__builtin_expect((slow & kSkSlow) != 0u, 0)) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v[2 * q] = posit_decode(static_cast<int32_t>(wd[q] & 0xFFFFu), 16, 2);
        v[2 * q + 1] = posit_decode(static_cast<int32_t>(wd[q] >> 16), 16, 2);
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[2 * q] = posit_decode(static_cast<int32_t>(wd[q] & 0xFFFFu), n, es);
      v[2 * q + 1] = posit_decode(static_cast<int32_t>(wd[q] >> 16), n, es);
    }
  }
}

__device__ __forceinline__ float sk_tab8(const uint32_t* tab, uint32_t w,
                                         int b) {
  return __uint_as_float(tab[(w >> (8 * b)) & 0xFFu]);
}

// 16 bytes' worth of weights at element offset `off` of a row with `avail`
// valid elements from there, loaded element by element (rows that are not
// 16-byte aligned); zeros past them, and all zeros when avail <= 0.
template <int EB>
__device__ __forceinline__ uint4 sk_load(const SkArgs& p, size_t off,
                                         int avail) {
  constexpr int VE = 16 / EB;
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (avail <= 0) return v;
  const unsigned char* src = static_cast<const unsigned char*>(p.w) +
                             off * EB;
  uint32_t wd[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < VE; ++e)
    if (e < avail) {
      const uint32_t b = EB == 2
          ? static_cast<uint32_t>(reinterpret_cast<const uint16_t*>(src)[e])
          : static_cast<uint32_t>(src[e]);
      wd[(e * EB) / 4] |= b << (8 * ((e * EB) % 4));
    }
  return make_uint4(wd[0], wd[1], wd[2], wd[3]);
}

// The raw weights of one group: w [K, N]: row g, the lane's VE columns;
// w [N, K]: k from g * VE, one load for each of the lane's 4 columns.
template <bool TB, int EB, int LPG>
__device__ __forceinline__ void sk_load_group(const SkArgs& p, uint4 (&b)[LPG],
                                              int g, int c0) {
  constexpr int VE = 16 / EB;
  if constexpr (TB) {
#pragma unroll
    for (int c = 0; c < LPG; ++c) {
      const int col = c0 + c;
      b[c] = sk_load<EB>(p, static_cast<size_t>(col) * p.K +
                                static_cast<size_t>(g) * VE,
                         col < p.N ? p.K - g * VE : 0);
    }
  } else {
    b[0] = sk_load<EB>(p, static_cast<size_t>(g) * p.N + c0,
                       g < p.K ? p.N - c0 : 0);
  }
}

template <bool TB, int EB, int U, int LPG>
__device__ __forceinline__ void sk_load_step(const SkArgs& p,
                                             uint4 (&b)[U][LPG], int g,
                                             int g1, int c0) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int gg = g + u * p.tk;
    if (gg < g1) sk_load_group<TB, EB, LPG>(p, b[u], gg, c0);
  }
}

template <int MP>
__device__ __forceinline__ void sk_xrow(const float* xs, int kk,
                                        float (&xv)[MP]) {
  const float4* r = reinterpret_cast<const float4*>(xs + kk * MP);
#pragma unroll
  for (int q = 0; q < MP / 4; ++q) {
    const float4 f = r[q];
    xv[4 * q] = f.x;
    xv[4 * q + 1] = f.y;
    xv[4 * q + 2] = f.z;
    xv[4 * q + 3] = f.w;
  }
}

// acc[m][c] += x[k][m] * w[k][c] for the group's k in increasing order;
// kk: the group's first row in the staged x.
template <int FMT, bool TB, int MP, int CPT, int LPG>
__device__ __forceinline__ void sk_group(const SkArgs& p, const uint4 (&b)[LPG],
                                         int kk, const float* xs,
                                         const uint32_t* tab,
                                         float (&acc)[MP][CPT]) {
  float xv[MP];
  if constexpr (!TB) {
    sk_xrow<MP>(xs, kk, xv);
    if constexpr (FMT == SK_TAB8) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float v = sk_tab8(tab, sk_word(b[0], c / 4), c % 4);
#pragma unroll
        for (int m = 0; m < MP; ++m) acc[m][c] = fmaf(xv[m], v, acc[m][c]);
      }
    } else {
      const uint32_t wd[4] = {b[0].x, b[0].y, b[0].z, b[0].w};
      float v[8];
      sk_decode8<FMT>(wd, v, tab, p.n, p.es);
#pragma unroll
      for (int c = 0; c < CPT; ++c)
#pragma unroll
        for (int m = 0; m < MP; ++m) acc[m][c] = fmaf(xv[m], v[c], acc[m][c]);
    }
  } else if constexpr (FMT == SK_TAB8) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      sk_xrow<MP>(xs, kk + j, xv);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float v = sk_tab8(tab, sk_word(b[c], j / 4), j % 4);
#pragma unroll
        for (int m = 0; m < MP; ++m) acc[m][c] = fmaf(xv[m], v, acc[m][c]);
      }
    }
  } else {
    // word q of each column's load holds its k = 2q (low half) and 2q + 1
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t wd[4] = {sk_word(b[0], q), sk_word(b[1], q),
                              sk_word(b[2], q), sk_word(b[3], q)};
      float v[8];
      sk_decode8<FMT>(wd, v, tab, p.n, p.es);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sk_xrow<MP>(xs, kk + 2 * q + h, xv);
#pragma unroll
        for (int c = 0; c < CPT; ++c)
#pragma unroll
          for (int m = 0; m < MP; ++m)
            acc[m][c] = fmaf(xv[m], v[2 * c + h], acc[m][c]);
      }
    }
  }
}

template <int FMT, bool TB, int MP, int CPT, int U, int LPG>
__device__ __forceinline__ void sk_step(const SkArgs& p,
                                        const uint4 (&b)[U][LPG], int g,
                                        int g0, int g1, const float* xs,
                                        const uint32_t* tab,
                                        float (&acc)[MP][CPT]) {
  constexpr int KPG = sk_kpg(TB, FMT == SK_TAB8 ? 1 : 2);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int gg = g + u * p.tk;
    if (gg < g1)
      sk_group<FMT, TB, MP, CPT, LPG>(p, b[u], (gg - g0) * KPG, xs, tab, acc);
  }
}

// xs[kk][m] = x[m][k0 + kk] for kk < rows; 0 for m >= M and k >= K.
template <int MP>
__device__ __forceinline__ void sk_stage_x(const SkArgs& p, float* xs, int k0,
                                           int rows) {
#pragma unroll 4
  for (int kk = threadIdx.x; kk < rows; kk += kSkThreads) {
    const int k = k0 + kk;
    float v[MP];
#pragma unroll
    for (int m = 0; m < MP; ++m)
      v[m] = m < p.M && k < p.K
                 ? __ldg(p.x + static_cast<size_t>(m) * p.K + k)
                 : 0.0f;
    float4* d = reinterpret_cast<float4*>(xs + kk * MP);
#pragma unroll
    for (int q = 0; q < MP / 4; ++q)
      d[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
}

// One tile's weight stream over k-groups [g0, g1) where rows are not
// 16-byte aligned: the lane's groups g0 + tk, + tk, ... loaded element by
// element into registers, the next step's in flight while one step is
// computed; x is staged behind the first loads when not yet staged.
template <int FMT, bool TB, int MP, int CPT>
__device__ __forceinline__ void sk_stream_rows(const SkArgs& p, int g0,
                                               int g1, int tk, int c0,
                                               float* xs, const uint32_t* tab,
                                               float (&acc)[MP][CPT],
                                               bool& staged) {
  constexpr int EB = FMT == SK_TAB8 ? 1 : 2;
  constexpr int KPG = sk_kpg(TB, EB);
  constexpr int LPG = TB ? CPT : 1;        // 16-byte loads per group
  constexpr int U = sk_step_groups(TB);
  const int step = U * p.tk;
  uint4 b0[U][LPG], b1[U][LPG];
  int g = g0 + tk;
  sk_load_step<TB, EB, U, LPG>(p, b0, g, g1, c0);
  if (!staged) {                           // behind the first loads
    sk_stage_x<MP>(p, xs, g0 * KPG, max(0, g1 - g0) * KPG);
    __syncthreads();
    staged = true;
  }
  while (g < g1) {
    sk_load_step<TB, EB, U, LPG>(p, b1, g + step, g1, c0);
    sk_step<FMT, TB, MP, CPT, U, LPG>(p, b0, g, g0, g1, xs, tab, acc);
    g += step;
    if (g >= g1) break;
    sk_load_step<TB, EB, U, LPG>(p, b0, g + step, g1, c0);
    sk_step<FMT, TB, MP, CPT, U, LPG>(p, b1, g, g0, g1, xs, tab, acc);
    g += step;
  }
}

// cp.async of 16 bytes into shared memory; zero-filled when !valid.
__device__ __forceinline__ void sk_cp16(uint4* dst, const void* src,
                                        bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void sk_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void sk_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One pipeline step's 16-byte loads into ring stage `st` (a lane's own
// slots, [stage][load][thread]); a group past g1 loads nothing.
template <bool TB, int EB, int U, int LPG>
__device__ __forceinline__ void sk_issue(const SkArgs& p, uint4* ring, int st,
                                         int g, int g1, int c0) {
  constexpr int VE = 16 / EB;
  const unsigned char* w = static_cast<const unsigned char*>(p.w);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int gg = g + u * p.tk;
    if (gg >= g1) continue;
#pragma unroll
    for (int l = 0; l < LPG; ++l) {
      uint4* dst = ring + ((st * U + u) * LPG + l) * kSkThreads + threadIdx.x;
      if constexpr (TB) {
        const int col = c0 + l;
        const bool ok = col < p.N;
        sk_cp16(dst, w + (ok ? (static_cast<size_t>(col) * p.K +
                                static_cast<size_t>(gg) * VE) * EB : 0), ok);
      } else {
        const bool ok = c0 < p.N;
        sk_cp16(dst, w + (ok ? (static_cast<size_t>(gg) * p.N + c0) * EB : 0),
                ok);
      }
    }
  }
  sk_cp_commit();
}

// The tile's stream for 16-byte rows: sk_stages steps of loads in flight
// through cp.async into the lane's ring slots, each step computed when its
// own copies have landed (no barrier: a lane reads only what it copied).
template <int FMT, bool TB, int MP, int CPT>
__device__ __forceinline__ void sk_stream_ring(const SkArgs& p, int g0, int g1,
                                               int tk, int c0, float* xs,
                                               uint4* ring,
                                               const uint32_t* tab,
                                               float (&acc)[MP][CPT],
                                               bool& staged) {
  constexpr int EB = FMT == SK_TAB8 ? 1 : 2;
  constexpr int KPG = sk_kpg(TB, EB);
  constexpr int LPG = TB ? CPT : 1;
  constexpr int U = sk_step_groups(TB);
  constexpr int S = sk_stages(TB);
  const int step = U * p.tk;
#pragma unroll
  for (int st = 0; st < S - 1; ++st)
    sk_issue<TB, EB, U, LPG>(p, ring, st, g0 + tk + st * step, g1, c0);
  if (!staged) {                           // behind the first loads
    sk_stage_x<MP>(p, xs, g0 * KPG, max(0, g1 - g0) * KPG);
    __syncthreads();
    staged = true;
  }
  int st = 0;
  for (int g = g0 + tk; g < g1; g += step) {
    sk_issue<TB, EB, U, LPG>(p, ring, st == 0 ? S - 1 : st - 1,
                             g + (S - 1) * step, g1, c0);
    sk_cp_wait<S - 1>();                   // this step's copies landed
    uint4 b[U][LPG];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int l = 0; l < LPG; ++l)
        b[u][l] = ring[((st * U + u) * LPG + l) * kSkThreads + threadIdx.x];
    sk_step<FMT, TB, MP, CPT, U, LPG>(p, b, g, g0, g1, xs, tab, acc);
    st = st == S - 1 ? 0 : st + 1;
  }
  sk_cp_wait<0>();
}

// out = x @ decode(w) for M <= MP rows.  Block b is rank b % cs of its
// cluster (its k-slice) and takes column tiles b / cs, + grid / cs, ...
template <int FMT, bool TB, int MP>
__global__ void __launch_bounds__(
    kSkThreads, sk_min_blocks(TB, FMT == SK_TAB8 ? 1 : 2, MP))
pw_skinny_kernel(SkArgs p) {
  constexpr int EB = FMT == SK_TAB8 ? 1 : 2;
  constexpr int CPT = sk_cpt(TB, EB), KPG = sk_kpg(TB, EB);
  // outputs a thread sums: M x bn <= MP x the widest tile, over 256
  constexpr int MAXO = MP * (TB ? kSkTnT[0] : kSkTnN[0]) * CPT / kSkThreads;
  __shared__ uint32_t tab[256];
  extern __shared__ __align__(16) float sk_smem[];
  float* xs = sk_smem;
  float* red = sk_smem + p.xs_floats;
  uint4* ring = reinterpret_cast<uint4*>(sk_smem + p.ring_off);

  const int t = threadIdx.x;
  int tn, tk;
  if constexpr (TB) {                      // a quarter warp: 8 column groups
    tn = (t & 7) + 8 * ((t >> 3) / p.tk);
    tk = (t >> 3) % p.tk;
  } else {
    tn = t % p.tn;
    tk = t / p.tn;
  }
  if constexpr (FMT == SK_TAB8)
    tab[t] = __float_as_uint(posit_decode(t, p.n, p.es));
  else if constexpr (FMT == SK_P16E2)
    tab[t] = p16e2_entry(static_cast<uint32_t>(t));

  const int rank = blockIdx.x % p.cs;
  const int ngroups = (max(p.K, 1) + KPG - 1) / KPG;
  const int s0 = rank * p.per, s1 = min(ngroups, s0 + p.per);
  const int half = p.tk / 2;
  const int ss = MP * p.bn + 4;            // floats per partial slab
  const int mb = p.M * p.bn;               // outputs of a tile
  float* slab = red + (tk < half ? tk : tk - half) * ss;

  for (int c = 0; c < p.nch; ++c) {
    const int g0 = s0 + c * p.chunk, g1 = min(s1, g0 + p.chunk);
    bool staged = false;
    for (int tile = blockIdx.x / p.cs; tile < p.tiles;
         tile += gridDim.x / p.cs) {
      const int n0 = tile * p.bn;
      const int c0 = n0 + tn * CPT;
      float acc[MP][CPT];
#pragma unroll
      for (int m = 0; m < MP; ++m)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[m][j] = 0.0f;
      if (p.vec)
        sk_stream_ring<FMT, TB, MP>(p, g0, g1, tk, c0, xs, ring, tab, acc,
                                    staged);
      else
        sk_stream_rows<FMT, TB, MP>(p, g0, g1, tk, c0, xs, tab, acc, staged);

      // the block's k-lanes: p[i] + p[i + half], then over i from 0
      __syncthreads();                     // the last tile's sums are read
      const int col = tn * CPT;
      if (tk < half) {
#pragma unroll
        for (int m = 0; m < MP; ++m)
#pragma unroll
          for (int j = 0; j < CPT; j += 4)
            *reinterpret_cast<float4*>(slab + m * p.bn + col + j) =
                make_float4(acc[m][j], acc[m][j + 1], acc[m][j + 2],
                            acc[m][j + 3]);
      }
      __syncthreads();
      if (tk >= half) {
#pragma unroll
        for (int m = 0; m < MP; ++m)
#pragma unroll
          for (int j = 0; j < CPT; j += 4) {
            float4* d = reinterpret_cast<float4*>(slab + m * p.bn + col + j);
            const float4 s = *d;
            *d = make_float4(s.x + acc[m][j], s.y + acc[m][j + 1],
                             s.z + acc[m][j + 2], s.w + acc[m][j + 3]);
          }
      }
      __syncthreads();
      float vals[MAXO];
#pragma unroll
      for (int i = 0; i < MAXO; ++i) {
        const int o = t + i * kSkThreads;
        vals[i] = 0.0f;
        if (o < mb) {
          const int m = o / p.bn, oc = o % p.bn;
          float s = 0.0f;
          for (int sl = 0; sl < half; ++sl) s += red[sl * ss + m * p.bn + oc];
          vals[i] = s;
        }
      }
      if (p.cs > 1) {
        // the ranks' sums meet in the leader's red region, added in rank
        // order; the first barrier also waits for every block to start
        namespace cg = cooperative_groups;
        cg::cluster_group cl = cg::this_cluster();
        cl.sync();
        float* dst = cl.map_shared_rank(red, 0) + rank * mb;
#pragma unroll
        for (int i = 0; i < MAXO; ++i) {
          const int o = t + i * kSkThreads;
          if (o < mb) dst[o] = vals[i];
        }
        cl.sync();
        if (rank != 0) continue;
#pragma unroll
        for (int i = 0; i < MAXO; ++i) {
          const int o = t + i * kSkThreads;
          if (o < mb) {
            float s = 0.0f;
            for (int r = 0; r < p.cs; ++r) s += red[r * mb + o];
            vals[i] = s;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < MAXO; ++i) {
        const int o = t + i * kSkThreads;
        if (o >= mb) continue;
        const int m = o / p.bn, n = n0 + o % p.bn;
        if (n >= p.N) continue;
        float* d = p.out + static_cast<size_t>(m) * p.N + n;
        *d = c == 0 ? vals[i] : *d + vals[i];
      }
    }
  }
}

template <int FMT, bool TB, int MP>
int sk_launch(const SkArgs& a, const SkPlan& pl, cudaStream_t st) {
  auto kern = pw_skinny_kernel<FMT, TB, MP>;
  // dynamic shared bytes this instance was opted into, per device
  static long long opted[16] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  // past 48 KB a block's shared memory (the table's with it) needs the
  // opt-in
  if (pl.smem + kSkTabBytes > 48 * 1024 &&
      (dev >= 16 || pl.smem > opted[dev])) {
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(pl.smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 16) opted[dev] = pl.smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(pl.grid));
  cfg.blockDim = dim3(kSkThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(pl.smem);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(pl.cs);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pl.cs > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <int FMT>
int sk_dispatch(bool tb, const SkArgs& a, const SkPlan& pl,
                cudaStream_t st) {
  if (tb)
    return pl.mp == 4 ? sk_launch<FMT, true, 4>(a, pl, st)
                      : sk_launch<FMT, true, 8>(a, pl, st);
  return pl.mp == 4 ? sk_launch<FMT, false, 4>(a, pl, st)
                    : sk_launch<FMT, false, 8>(a, pl, st);
}

// The skinny launch: the caller's plan must be this file's.
int launch_skinny(const void* x, const void* w, void* out, int M, int N,
                  int K, bool tb, int dtype, int n, int es, int bm, int bn,
                  int splits, int threads, long long smem, cudaStream_t st) {
  const int eb = dtype == DT_I8 ? 1 : 2;
  const SkPlan pl = make_skinny_plan(M, N, K, tb, eb);
  if (bm != pl.mp || bn != pl.bn || splits != pl.cs ||
      threads != kSkThreads || smem != pl.smem)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  SkArgs a;
  a.x = static_cast<const float*>(x);
  a.w = w;
  a.out = static_cast<float*>(out);
  a.M = M;
  a.N = N;
  a.K = K;
  a.n = n;
  a.es = es;
  a.vec = (tb ? K : N) % (16 / eb) == 0 &&
          reinterpret_cast<uintptr_t>(w) % 16 == 0;
  a.tn = pl.tn;
  a.tk = pl.tk;
  a.bn = pl.bn;
  a.cs = pl.cs;
  a.per = pl.per;
  a.chunk = pl.chunk;
  a.nch = pl.nch;
  a.tiles = pl.tiles;
  a.xs_floats = pl.chunk * pl.kpg * pl.mp;
  a.ring_off = static_cast<int>(
      (pl.smem - 16LL * sk_stages(tb) * sk_step_loads(tb) * kSkThreads) / 4);
  if (dtype == DT_I8) return sk_dispatch<SK_TAB8>(tb, a, pl, st);
  if (n == 16 && es == 2) return sk_dispatch<SK_P16E2>(tb, a, pl, st);
  return sk_dispatch<SK_GEN16>(tb, a, pl, st);
}

}  // namespace

// x [M, K] f32; w [K, N] (or [N, K] when transpose_b) posit ints; out [M, N].
// M <= 8 runs the skinny kernel with the caller's skinny plan (bm: rows
// padded to 4 or 8, bn: columns a tile, splits: cluster size, threads,
// smem; ws is not read); above, the tiled kernel with the caller's plan
// (bm, bn, splits, threads, smem) and, when splits > 1, its f32 workspace
// ws [splits, M, N].
extern "C" int posit_pw_gemm(const void* x, const void* w, void* out, int M,
                             int N, int K, int transpose_b, int dtype, int n,
                             int es, void* ws, int bm, int bn, int splits,
                             int threads, long long smem, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (dtype != DT_I8 && dtype != DT_I16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= kSkinnyM)
    return launch_skinny(x, w, out, M, N, K, transpose_b != 0, dtype, n, es,
                         bm, bn, splits, threads, smem, st);
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
