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

#include <algorithm>

#include "gemm_pieces.cuh"
#include "posit_stream.cuh"

namespace {

// ---- the plan (mirrored by kernels/posit_gemm.py::gemm_plan) --------------
constexpr int kSMs = 132;            // H100 SXM
constexpr int kMaxSplits = 8;
constexpr int kMinSliceTiles = 4;    // k-tiles a split-K slice keeps

struct Plan {
  int tile, bm, bn, threads, splits, per;    // per: k-tiles per slice
  size_t smem;
};

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
  p.smem = mma_smem(p.bm, p.bn, pa, pb, ta, tb);
  return p;
}

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

// ---- the tiled tensor-core GEMM --------------------------------------------
// A [M, K] (TA: [K, M]) x B [K, N] (TB: [N, K]) over k-tiles
// [z * per, min(nk, (z + 1) * per)) of block z; PA / PB bf16 pieces per
// element (3: f32, 2: posit).
template <int BM, int BN, int WM, int WN, int PA, int PB, bool TA, bool TB>
__global__ void __launch_bounds__(WM * WN * 32, 1)
gemm_mma_kernel(Operand a, Operand b, Out out, int M, int N, int K,
                int per) {
  using T = MmaTile<BM, BN, WM, WN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm0 = (warp / WN) * T::WTM, wn0 = (warp % WN) * T::WTN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (max(K, 1) + kBK - 1) / kBK;
  const int kt0 = blockIdx.z * per;
  const int kt1 = min(nk, kt0 + per);

  float acc[T::MF][T::NF][4];
#pragma unroll
  for (int i = 0; i < T::MF; ++i)
#pragma unroll
    for (int j = 0; j < T::NF; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;
  mma_mainloop<BM, BN, WM, WN, PA, PB, TA, TB>(a, b, m0, n0, 0, kt0, kt1,
                                               smem_raw, acc);

  // epilogue: c0, c1 at (g, 2t..2t+1), c2, c3 at (g + 8, ...)
  Out o = out;
  o.p = o.dtype == DT_F32
            ? static_cast<void*>(static_cast<float*>(out.p) +
                                 blockIdx.z * out.zstride)
            : out.p;
  const int g = lane / 4, tq = lane % 4;
#pragma unroll
  for (int i = 0; i < T::MF; ++i)
#pragma unroll
    for (int j = 0; j < T::NF; ++j) {
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
constexpr int kSkMaxCluster = 8;          // the portable cluster size
constexpr int kSkSmemSM = 233472;         // shared bytes of an SM (H100)
constexpr int kSkSmemBlock = 232448;      // ... that one block may use
constexpr int kSkReserve = 1024;          // the system's share per block
constexpr int kSkTileCost = 8192;         // a tile's fixed cost, in elements
constexpr int kSkClusterCost = 8192;      // ... more with a cluster's syncs
constexpr int kSkTnN[] = {32, 16, 8, 4, 2};  // w [K, N]: lanes along n
constexpr int kSkTnT[] = {64, 32, 16, 8};    // w [N, K]: column groups
constexpr int kSkNtnN = sizeof(kSkTnN) / sizeof(int);
constexpr int kSkNtnT = sizeof(kSkTnT) / sizeof(int);

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
  sk_fill_table<FMT>(tab, t, p.n, p.es);

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
      float vals[MAXO];
      sk_block_sum<MP, CPT, MAXO>(p, acc, red, slab, half, ss, mb, t, tn,
                                  tk, vals);
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
      sk_store_out<MAXO>(p, vals, t, mb, n0, c);
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
