// K10 and K11: the grouped posit GEMM of the MoE block and its dW.
//
// K10 (posit_grouped_gemm) replaces repro/kernels/grouped_gemm.py::
// posit_grouped_gemm (:146; pallas_call at :212): out[r] = x[r] @ w[g(r)]
// for expert-sorted rows, where rows [offsets[g], offsets[g+1]) belong to
// group g.  x is f32 [S, K]; w is posit ints (int8/int16) or f32, stored
// [E, K, N], or [E, N, K] with transpose_b (the backward's dX = G W^T
// reads the same storage).  Rows outside every group are left untouched:
// the wrapper hands in a zeroed output, so they come back exactly 0.
// K11 (posit_grouped_gemm_dw) replaces ::posit_grouped_gemm_dw (:272;
// pallas_call at :314): dw[e] = x[rows(e)]^T g[rows(e)], f32 [E, M, N],
// exactly 0 for an empty group.
//
// Bound on an H100.  A decode step routes 8 tokens x top-8 = 64 rows over
// 64 experts: K10 reads each active expert's [K, N] table once, 2 bytes
// per posit16 element, for ~2 flops per element per row: HBM bytes bound
// it.  A prefill step (8,192 rows) and the training step (32,768 rows) do
// 2 S K N flops over E K N weights; on the tensor cores (below) that is
// P bf16 products per f32 product at 989 TFLOP/s: P = 6 for f32 x posit
// and f32 x f32 (whose three smallest products are dropped).
//
// Design.  The Pallas kernel walks a static, ordered (group, m-tile)
// incidence table because a TPU grid must be static.  A CUDA block reads
// offsets[g] and offsets[g+1] itself (clamped to [0, S]; they must be
// nondecreasing, as the sort-based dispatch makes them), so the grid is
// (column tile, group) and an empty group's blocks return at once: an
// inactive expert's table is never read.  Each output element is written
// by one block, in a fixed order: no atomics, and a repeated launch gives
// the same bits.  Three forms, chosen by make_grouped_plan from what the
// host knows (S, E, the format), mirrored by kernels/grouped_gemm.py::
// grouped_plan; the wrapper passes the plan in and the entry points refuse
// a launch whose numbers differ (cudaErrorInvalidConfiguration).
//   Decode (posit weights, S < 16 E: fewer than 16 rows a group on
//     average): grouped_stream_kernel streams the group's table the way
//     K2's skinny form streams a weight (posit_stream.cuh): a decode
//     specialised per format (P16_2 by its 256-entry regime table with the
//     slow-path flag, int8 formats by a 256-entry f32 table, other int16
//     formats by posit_decode with the runtime (n, es)), 16-byte cp.async
//     loads into the lane's own ring slots, the group's x rows staged in
//     shared memory per k-chunk of at most 32 KB.  A block takes 128
//     columns (8 tiles at N = 1,024, 16 at 2,048: ~40 active experts of
//     olmoe's 64 give 320-640 blocks, two to an SM) and its group's rows in
//     chunks of at most 8, 4 wide where a chunk has 4 rows or fewer (a
//     decode step gives most groups one or two rows), each chunk streaming
//     the table once.  Sum order: a lane's FFMAs in increasing k, the
//     block's k-lanes in the fixed order of sk_block_sum, k-chunks added in
//     order.  Products are exact (f32 x decoded posit inside an FFMA).
//   Tiled (f32 weights, or S >= 16 E): grouped_mma_kernel runs K2's
//     tensor-core k-loop (gemm_pieces.cuh) on exact bf16 pieces: x split in
//     three, a posit in two, an f32 weight in three; the tile's operands
//     decoded and split once when staged into two shared stages of padded
//     bf16 planes in their stored orientation, ldmatrix.trans where the
//     mma wants the other one, so transpose_b needs no transposed copy.  A
//     block takes a column tile of its group and walks the group's m-tiles
//     from offsets[g]; rows past the group's end are read as 0 and not
//     written.  128 x 128 tiles (8 warps) when groups average 128 rows or
//     more, else 64 x 64 (4 warps).  A skewed router puts most m-tiles in a
//     few blocks: correct, and slower.
//   dW (K11): grouped_dw_kernel, grid (n-tile, m-tile, group), 128 x 128:
//     the block sums its group's rows as the k dimension of x^T g, x read
//     from its stored [S, M] layout through ldmatrix.trans; k-tiles start
//     at offsets[e] and rows past offsets[e + 1] are read as 0.  One slice:
//     the k-tiles in order.  An empty group's blocks store zeros.
// Arithmetic of the tiled forms (posit_gemm.cu's note derives it): every
// product of a posit piece is exact; f32 x f32 (training: forward, dX and
// dW) keeps 6 of the 9 piece products, which moves a result by at most
// 2^-22 (|a| @ |b|) beside the f32 dot-product bound 2 K 2^-24 (|a| @ |b|);
// the x1 y1 product goes into zero accumulators and is added with one f32
// rounding.
#include <algorithm>

#include "gemm_pieces.cuh"
#include "posit_stream.cuh"

namespace {

// ---- the plan (mirrored by kernels/grouped_gemm.py::grouped_plan) --------
constexpr int kStreamRows = 16;      // S < 16 E: the decode form
constexpr int kStreamBM = 8;         // a group's rows a pass, at most
constexpr int kStreamBN = 128;       // columns a block
constexpr int kBigTileRows = 128;    // S >= 128 E: 128 x 128 tiles

enum GroupedForm { FORM_STREAM = 0, FORM_MMA = 1 };

struct GPlan {
  int form, tile, bm, bn, threads;
  long long smem;                    // dynamic shared bytes
  int tn, tk, chunk, nch;            // the decode form's lanes and k-chunks
};

// K10: the decode form for posit weights below 16 rows a group on average,
// else the tiled form, 128 x 128 from 128 rows a group on average.
GPlan make_grouped_plan(int S, int N, int K, int E, int dtype, bool tb) {
  GPlan p{};
  if (dtype != DT_F32 && static_cast<long long>(S) < 1LL * kStreamRows * E) {
    const int eb = dtype == DT_I8 ? 1 : 2;
    const int cpt = sk_cpt(tb, eb), kpg = sk_kpg(tb, eb);
    p.form = FORM_STREAM;
    p.tile = -1;
    p.bm = kStreamBM;
    p.bn = kStreamBN;
    p.threads = kSkThreads;
    p.tn = kStreamBN / cpt;
    p.tk = kSkThreads / p.tn;
    const long long ng = cdiv(K > 0 ? K : 1, kpg);
    const long long xs_groups = kSkXsBytes / (4LL * kpg * kStreamBM);
    p.chunk = static_cast<int>(std::min(ng, xs_groups));
    p.nch = static_cast<int>(cdiv(ng, p.chunk));
    // x and the k-lanes' slabs share one region (used in turn); the ring
    const long long xs = 4LL * p.chunk * kpg * kStreamBM;
    const long long red = 4LL * (p.tk / 2) * (kStreamBM * kStreamBN + 4);
    const long long ring =
        16LL * sk_stages(tb) * sk_step_loads(tb) * kSkThreads;
    p.smem = std::max(xs, red) + ring;
    return p;
  }
  const int t = static_cast<long long>(S) >= 1LL * kBigTileRows * E ? 0 : 1;
  p.form = FORM_MMA;
  p.tile = t;
  p.bm = kTileBM[t];
  p.bn = kTileBN[t];
  p.threads = kTileWM[t] * kTileWN[t] * 32;
  p.smem = static_cast<long long>(
      mma_smem(p.bm, p.bn, 3, dtype == DT_F32 ? 3 : 2, false, tb));
  return p;
}

// K11: 128 x 128 tiles of f32 x^T (stored [S, M]) times f32 g.
GPlan make_dw_plan() {
  GPlan p{};
  p.form = FORM_MMA;
  p.tile = 0;
  p.bm = kTileBM[0];
  p.bn = kTileBN[0];
  p.threads = kTileWM[0] * kTileWN[0] * 32;
  p.smem = static_cast<long long>(mma_smem(p.bm, p.bn, 3, 3, true, false));
  return p;
}

bool plan_is(const GPlan& p, int form, int bm, int bn, int threads,
             long long smem) {
  return p.form == form && p.bm == bm && p.bn == bn && p.threads == threads &&
         p.smem == smem;
}

__device__ __forceinline__ void group_rows(const int* offsets, int g, int S,
                                           int& r0, int& r1) {
  r0 = min(max(__ldg(&offsets[g]), 0), S);
  r1 = min(max(__ldg(&offsets[g + 1]), r0), S);
}

// Blocks an SM holds by registers: two, except past 64 accumulators a lane
// at 8 rows and for [N, K] weights (as K2's skinny form).
__host__ __device__ constexpr int gs_min_blocks(bool tb, int eb) {
  return kStreamBM * sk_cpt(tb, eb) > 64 || tb ? 1 : 2;
}

// ---- the decode form ---------------------------------------------------
// One pass over rows [m0, m0 + p.M) of the group (p.x, p.out at row m0):
// the k-chunks in order, each staged, streamed, summed over the block's
// k-lanes and added to the output.
template <int FMT, bool TB, int MP>
__device__ __forceinline__ void gs_pass(const SkArgs& p, int ngroups, int t,
                                        int tn, int tk, int n0,
                                        float* region, uint4* ring,
                                        const uint32_t* tab) {
  constexpr int EB = FMT == SK_TAB8 ? 1 : 2;
  constexpr int CPT = sk_cpt(TB, EB);
  constexpr int MAXO = MP * kStreamBN / kSkThreads;
  const int c0 = n0 + tn * CPT;
  const int half = p.tk / 2;
  const int ss = MP * p.bn + 4;            // floats per partial slab
  const int mb = p.M * p.bn;               // outputs of the pass
  float* slab = region + (tk < half ? tk : tk - half) * ss;
  for (int c = 0; c < p.nch; ++c) {
    const int g0 = c * p.chunk, g1 = min(ngroups, g0 + p.chunk);
    bool staged = false;
    float acc[MP][CPT];
#pragma unroll
    for (int m = 0; m < MP; ++m)
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[m][j] = 0.0f;
    if (p.vec)
      sk_stream_ring<FMT, TB, MP>(p, g0, g1, tk, c0, region, ring, tab, acc,
                                  staged);
    else
      sk_stream_rows<FMT, TB, MP>(p, g0, g1, tk, c0, region, tab, acc,
                                  staged);
    float vals[MAXO];
    sk_block_sum<MP, CPT, MAXO>(p, acc, region, slab, half, ss, mb, t, tn,
                                tk, vals);
    sk_store_out<MAXO>(p, vals, t, mb, n0, c);
    __syncthreads();                   // the slabs are read: x may be staged
  }
}

// K10's decode form: block (column tile, group).  base: x [S, K], w [E, K,
// N] (TB: [E, N, K]) at group 0, out [S, N], and the plan's lanes and
// chunks; wbytes: bytes of one group's table.
template <int FMT, bool TB>
__global__ void __launch_bounds__(kSkThreads,
                                  gs_min_blocks(TB, FMT == SK_TAB8 ? 1 : 2))
grouped_stream_kernel(SkArgs base, const int* __restrict__ offsets, int S,
                      size_t wbytes) {
  constexpr int KPG = sk_kpg(TB, FMT == SK_TAB8 ? 1 : 2);
  __shared__ uint32_t tab[256];
  extern __shared__ __align__(16) float sk_smem[];
  const int g = blockIdx.y;
  int r0, r1;
  group_rows(offsets, g, S, r0, r1);
  if (r0 >= r1) return;                  // empty group (block-uniform)
  float* region = sk_smem;               // staged x, then the k-lanes' slabs
  uint4* ring = reinterpret_cast<uint4*>(sk_smem + base.ring_off);
  const int t = threadIdx.x;
  int tn, tk;
  if constexpr (TB) {                      // a quarter warp: 8 column groups
    tn = (t & 7) + 8 * ((t >> 3) / base.tk);
    tk = (t >> 3) % base.tk;
  } else {
    tn = t % base.tn;
    tk = t / base.tn;
  }
  sk_fill_table<FMT>(tab, t, base.n, base.es);
  SkArgs p = base;
  p.w = static_cast<const unsigned char*>(base.w) + g * wbytes;
  const int n0 = blockIdx.x * kStreamBN;
  const int ngroups = (max(p.K, 1) + KPG - 1) / KPG;
  for (int m0 = r0; m0 < r1; m0 += kStreamBM) {
    p.M = min(kStreamBM, r1 - m0);
    p.x = base.x + static_cast<size_t>(m0) * p.K;
    p.out = base.out + static_cast<size_t>(m0) * p.N;
    if (p.M <= 4)
      gs_pass<FMT, TB, 4>(p, ngroups, t, tn, tk, n0, region, ring, tab);
    else
      gs_pass<FMT, TB, 8>(p, ngroups, t, tn, tk, n0, region, ring, tab);
  }
}

// ---- the tiled forms -----------------------------------------------------
// K10's tiled form: block (column tile, group) walks the group's m-tiles.
// xa: x [S, K] f32; wa: one group's table ([K, N], TB: [N, K]) at group 0,
// wbytes apart; a posit table decodes by FB (SK_P16E2 and SK_TAB8 from the
// block's table, else posit_decode).
template <int BM, int BN, int WM, int WN, int PB, int FB, bool TB>
__global__ void __launch_bounds__(WM * WN * 32, 1)
grouped_mma_kernel(Operand xa, Operand wa, float* __restrict__ out,
                   const int* __restrict__ offsets, int S, int N, int K,
                   size_t wbytes) {
  using T = MmaTile<BM, BN, WM, WN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint32_t tab[256];
  const int g = blockIdx.y;
  int r0, r1;
  group_rows(offsets, g, S, r0, r1);
  if (r0 >= r1) return;                  // empty group (block-uniform)
  if constexpr (FB == SK_P16E2 || FB == SK_TAB8) {
    for (int i = threadIdx.x; i < 256; i += WM * WN * 32)
      tab[i] = FB == SK_P16E2
                   ? p16e2_entry(static_cast<uint32_t>(i))
                   : __float_as_uint(posit_decode(i, wa.n, wa.es));
    __syncthreads();
  }
  Operand a = xa, b = wa;
  a.rows = r1;                           // rows past the group read as 0
  b.p = static_cast<const unsigned char*>(wa.p) + g * wbytes;
  const int n0 = blockIdx.x * BN;
  const int nk = (max(K, 1) + kBK - 1) / kBK;
  for (int m0 = r0; m0 < r1; m0 += BM) {
    float acc[T::MF][T::NF][4];
#pragma unroll
    for (int i = 0; i < T::MF; ++i)
#pragma unroll
      for (int j = 0; j < T::NF; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;
    mma_mainloop<BM, BN, WM, WN, 3, PB, false, TB, FB>(
        a, b, m0, n0, 0, 0, nk, smem_raw, acc, tab);
    store_acc_f32<BM, BN, WM, WN>(acc, out, m0, n0, r1, N);
  }
}

// K11: block (n-tile, m-tile, group) of dw [E, M, N]; xa: x [S, M] read as
// x^T, ga: g [S, N], both f32.
template <int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__(WM * WN * 32, 1)
grouped_dw_kernel(Operand xa, Operand ga, float* __restrict__ dw,
                  const int* __restrict__ offsets, int S, int M, int N) {
  using T = MmaTile<BM, BN, WM, WN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int e = blockIdx.z;
  int r0, r1;
  group_rows(offsets, e, S, r0, r1);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[T::MF][T::NF][4];
#pragma unroll
  for (int i = 0; i < T::MF; ++i)
#pragma unroll
    for (int j = 0; j < T::NF; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;
  if (r0 < r1) {                         // block-uniform
    Operand a = xa, b = ga;
    a.rows = r1;                         // the group's rows are the k axis
    b.rows = r1;
    const int nk = (r1 - r0 + kBK - 1) / kBK;
    mma_mainloop<BM, BN, WM, WN, 3, 3, true, false>(a, b, m0, n0, r0, 0, nk,
                                                    smem_raw, acc);
  }
  store_acc_f32<BM, BN, WM, WN>(acc, dw + static_cast<size_t>(e) * M * N,
                                m0, n0, M, N);
}

// ---- launches --------------------------------------------------------------
// Opt a kernel into `bytes` of dynamic shared memory where they and its
// `fixed` static bytes pass 48 KB, once per device and size.
template <auto Kern>
int opt_in_smem(long long bytes, long long fixed = 0) {
  static long long opted[16] = {};
  if (bytes + fixed <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 16 && bytes <= opted[dev]) return 0;
  e = cudaFuncSetAttribute(Kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 16) opted[dev] = bytes;
  return 0;
}

template <int FMT, bool TB>
int launch_stream(const SkArgs& a, const int* off, int S, int E,
                  size_t wbytes, const GPlan& pl, cudaStream_t st) {
  const int rc =
      opt_in_smem<&grouped_stream_kernel<FMT, TB>>(pl.smem, kSkTabBytes);
  if (rc) return rc;
  dim3 grid(static_cast<unsigned>(cdiv(a.N, kStreamBN)),
            static_cast<unsigned>(E));
  grouped_stream_kernel<FMT, TB><<<grid, kSkThreads, pl.smem, st>>>(
      a, off, S, wbytes);
  return static_cast<int>(cudaGetLastError());
}

template <int FMT>
int dispatch_stream(bool tb, const SkArgs& a, const int* off, int S, int E,
                    size_t wbytes, const GPlan& pl, cudaStream_t st) {
  return tb ? launch_stream<FMT, true>(a, off, S, E, wbytes, pl, st)
            : launch_stream<FMT, false>(a, off, S, E, wbytes, pl, st);
}

template <int T, int PB, int FB, bool TB>
int launch_mma(const Operand& xa, const Operand& wa, float* out,
               const int* off, int S, int N, int K, int E, size_t wbytes,
               const GPlan& pl, cudaStream_t st) {
  constexpr int BM = kTileBM[T], BN = kTileBN[T];
  constexpr int WM = kTileWM[T], WN = kTileWN[T];
  const int rc = opt_in_smem<&grouped_mma_kernel<BM, BN, WM, WN, PB, FB, TB>>(
      pl.smem, 1024);
  if (rc) return rc;
  dim3 grid(static_cast<unsigned>(cdiv(N, BN)), static_cast<unsigned>(E));
  grouped_mma_kernel<BM, BN, WM, WN, PB, FB, TB>
      <<<grid, pl.threads, pl.smem, st>>>(xa, wa, out, off, S, N, K, wbytes);
  return static_cast<int>(cudaGetLastError());
}

// fb: -1 for f32 weights (three pieces), else the posit table's SkFmt.
template <int T>
int dispatch_mma(int fb, bool tb, const Operand& xa, const Operand& wa,
                 float* out, const int* off, int S, int N, int K, int E,
                 size_t wbytes, const GPlan& pl, cudaStream_t st) {
#define GG_LAUNCH(PB, FB)                                                    \
  return tb ? launch_mma<T, PB, FB, true>(xa, wa, out, off, S, N, K, E,     \
                                          wbytes, pl, st)                   \
            : launch_mma<T, PB, FB, false>(xa, wa, out, off, S, N, K, E,    \
                                           wbytes, pl, st)
  if (fb == SK_P16E2) GG_LAUNCH(2, SK_P16E2);
  if (fb == SK_TAB8) GG_LAUNCH(2, SK_TAB8);
  if (fb == SK_GEN16) GG_LAUNCH(2, SK_GEN16);
  GG_LAUNCH(3, -1);
#undef GG_LAUNCH
}

}  // namespace

// x [S, K] f32; w [E, K, N] (or [E, N, K] when transpose_b) of storage type
// dtype (0: f32, 1: int8, 2: int16 posit of format (n, es)); offsets [E+1]
// int32; out [S, N] f32, zeroed by the caller.  form, bm, bn, threads and
// smem are the caller's plan, which must be make_grouped_plan's.
extern "C" int posit_grouped_gemm(const void* x, const void* w, void* out,
                                  const void* offsets, int S, int N, int K,
                                  int E, int transpose_b, int dtype, int n,
                                  int es, int form, int bm, int bn,
                                  int threads, long long smem, void* stream) {
  if (S <= 0 || N <= 0 || E <= 0) return 0;
  if (dtype != DT_F32 && dtype != DT_I8 && dtype != DT_I16)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool tb = transpose_b != 0;
  const GPlan pl = make_grouped_plan(S, N, K, E, dtype, tb);
  if (!plan_is(pl, form, bm, bn, threads, smem))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* off = static_cast<const int*>(offsets);
  const int eb = dtype == DT_F32 ? 4 : dtype == DT_I16 ? 2 : 1;
  const size_t wbytes = static_cast<size_t>(K) * N * eb;
  if (pl.form == FORM_STREAM) {
    SkArgs a{};
    a.x = static_cast<const float*>(x);
    a.w = w;
    a.out = static_cast<float*>(out);
    a.M = 0;                             // set per pass
    a.N = N;
    a.K = K;
    a.n = n;
    a.es = es;
    a.vec = (tb ? K : N) % (16 / eb) == 0 &&
            reinterpret_cast<uintptr_t>(w) % 16 == 0;
    a.tn = pl.tn;
    a.tk = pl.tk;
    a.bn = pl.bn;
    a.cs = 1;
    a.chunk = pl.chunk;
    a.nch = pl.nch;
    a.ring_off = static_cast<int>(
        (pl.smem - 16LL * sk_stages(tb) * sk_step_loads(tb) * kSkThreads) /
        4);
    if (dtype == DT_I8)
      return dispatch_stream<SK_TAB8>(tb, a, off, S, E, wbytes, pl, st);
    if (n == 16 && es == 2)
      return dispatch_stream<SK_P16E2>(tb, a, off, S, E, wbytes, pl, st);
    return dispatch_stream<SK_GEN16>(tb, a, off, S, E, wbytes, pl, st);
  }
  const Operand xa = make_operand(x, DT_F32, 0, 0, S, K);
  const Operand wa = tb ? make_operand(w, dtype, n, es, N, K)
                        : make_operand(w, dtype, n, es, K, N);
  const int fb = dtype == DT_F32              ? -1
                 : dtype == DT_I8             ? SK_TAB8
                 : (n == 16 && es == 2)       ? SK_P16E2
                                              : SK_GEN16;
  float* o = static_cast<float*>(out);
  return pl.tile == 0
             ? dispatch_mma<0>(fb, tb, xa, wa, o, off, S, N, K, E, wbytes, pl,
                               st)
             : dispatch_mma<1>(fb, tb, xa, wa, o, off, S, N, K, E, wbytes, pl,
                               st);
}

// x [S, M] f32, g [S, N] f32, offsets [E+1] int32 -> dw [E, M, N] f32 (every
// element written); bm, bn, threads and smem are the caller's plan, which
// must be make_dw_plan's.
extern "C" int posit_grouped_gemm_dw(const void* x, const void* g, void* dw,
                                     const void* offsets, int S, int M, int N,
                                     int E, int bm, int bn, int threads,
                                     long long smem, void* stream) {
  if (M <= 0 || N <= 0 || E <= 0) return 0;
  const GPlan pl = make_dw_plan();
  if (!plan_is(pl, FORM_MMA, bm, bn, threads, smem))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  constexpr int BM = kTileBM[0], BN = kTileBN[0];
  constexpr int WM = kTileWM[0], WN = kTileWN[0];
  const int rc = opt_in_smem<&grouped_dw_kernel<BM, BN, WM, WN>>(pl.smem);
  if (rc) return rc;
  const Operand xa = make_operand(x, DT_F32, 0, 0, S, M);
  const Operand ga = make_operand(g, DT_F32, 0, 0, S, N);
  dim3 grid(static_cast<unsigned>(cdiv(N, pl.bn)),
            static_cast<unsigned>(cdiv(M, pl.bm)), static_cast<unsigned>(E));
  grouped_dw_kernel<BM, BN, WM, WN>
      <<<grid, pl.threads, pl.smem, static_cast<cudaStream_t>(stream)>>>(
      xa, ga, static_cast<float*>(dw), static_cast<const int*>(offsets), S, M,
      N);
  return static_cast<int>(cudaGetLastError());
}
