// K3: paged decode attention, one f32 query per sequence and query head over
// the paged (posit) KV pool.  Replaces repro/kernels/flash_attention.py::
// paged_flash_decode (:650; pallas_call :694, body _paged_decode_kernel
// :92).  (K4, the paged prefill, is K7's forward reading its keys through
// the page table: flash_fwd_paged_kernel in csrc/flash_prefill.cu.)
//
// Pool layout: pages [num_pages, n_kv, page, D] (f32, int8 or int16 posit),
// page_table [B, W] int32, seq_lens [B] int32 (post-append lengths).  The
// query of sequence b sits at seq_lens[b] - 1 and sees keys kpos < seq_lens
// [b] (and at most W page), with a window kpos >= seq_lens[b] - window.
// GQA: query head h * G + g reads kv head h, G = H / n_kv.
//
// Bound on an H100.  Each visible key's K and V are read once (2 B an
// element at posit16) for 4 G flops an element: HBM bytes, a few MB a layer
// (3.8 MB at smollm-360m's decode layer), which the card reads in about a
// microsecond.  A launch's floor of a few microseconds sets the time.
//
// Design.  The TPU grid walked one sequence's pages in order, carrying the
// online softmax in VMEM.  Here every (sequence, kv head) is split into S
// contiguous ranges of whole pages of the table, one block each, S chosen
// from host-known shapes only (make_decode_plan: never seq_lens, which
// would synchronise the step) so that the grid fills the card: 40 x 4
// blocks at smollm-360m's layer, 8 x 16 at recurrentgemma-9b's.  The G
// query heads of the group stay in the block, so each K/V byte is read
// once.  A block first reads its range's page-table entries into shared
// memory (one read a page), then streams the pages that hold its visible
// keys in stages of whole pages (about 4,096 elements of K) through a
// ring of three stages in shared memory: 16-byte cp.async copies of a
// page's contiguous rows, two stages in flight under the arithmetic of
// the third.  A page wholly outside [lo, seq_len) or on an entry outside
// [0, num_pages) is never copied, and a key outside [lo, seq_len) never
// read (the garbage page behind a reclaimed window, even full of NaR
// patterns, cannot reach the output).
//
// Warps take keys and lanes take dimensions: a key's row is spread over
// LPK = DMAX / 8 lanes, 8 dimensions a lane (the last lane 4 at D % 8 ==
// 4: any D % 4 == 0 up to 256 is taken), so a warp takes 32 / LPK keys at
// once (four such steps a turn above D = 128), holding 4 query heads' q
// and accumulators in registers (warps split larger groups: 4 head groups
// at G = 16).  Lanes decode their values per format (posit16 es2 and
// every 8-bit format by the tables of csrc/posit_stream.cuh, other 16-bit
// formats by posit_decode); above D = 128, where the head groups would
// each decode the same values, a posit stage is decoded once into an f32
// tile instead (two block barriers a stage).  A block has 256 threads (two
// blocks an SM, so that 16-block clusters all fit the card at once).
// A step's 4 dot products are summed over the key's lanes by a transposed
// butterfly that leaves each lane one head's sum; the lane runs that
// head's online softmax, and its rescale factor and probabilities go to
// the key's lanes by shuffles.
//
// Each (warp, key slot) is a stream with its own (m, l, acc).  At the end
// the block weighs its streams (a warp a head, by butterflies) and sums
// them in stream order, and the S blocks of a split, a thread-block
// cluster along the split, combine their partials in rank order: each
// block takes a slice of the G x D outputs and reads every rank's partial
// from distributed shared memory.  Weights of a partial that saw no key
// are 0 (never exp(-1e30 - -1e30)), and a row that sees no key gives 0.
// No atomics: a repeated launch is bit-identical.
#include <cooperative_groups.h>

#include <algorithm>

#include "posit_codec.cuh"
#include "posit_stream.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr float kNeg = -1e30f;        // repro's _NEG
constexpr unsigned kAll = 0xffffffffu;
// The plan's constants (mirrored by kernels/flash_attention.py).
constexpr int kDecThreads = 256;      // a block's threads
constexpr int kDecVpl = 8;            // dimensions a lane holds
constexpr int kDecGh = 4;             // query heads a warp holds, at most
constexpr int kDecStages = 3;         // ring stages: two in flight
constexpr int kDecStageElems = 4096;  // K (and V) elements a stage aims at
constexpr int kDecMaxSplit = 16;      // cluster size (above 8: non-portable)
constexpr int kDecSMs = 132;          // H100 SXM
constexpr int kDecMaxG = 32;          // query heads a kv head, at most

enum DecFmt { DEC_F32 = 0, DEC_TAB8 = 1, DEC_P16E2 = 2, DEC_GEN16 = 3 };

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

struct DecPlan {
  int splits;             // S: blocks (and cluster ranks) a sequence
  int pps;                // pages of the table a split owns, at most
  int sp;                 // pages a ring stage holds
  int hg, gh;             // head groups (warps split G), heads a group
  int nks;                // streams a head group: (warp, key slot)
  int psw;                // floats of the streams' m (and l): nks G,
                          // rounded to 4 (their acc is float4-stored)
  int pt_words;           // ints of the page-table slice (16-byte rounded)
  int mask_words;         // ... of the stages' key masks (a byte a key)
  int ring_floats;        // the raw ring
  int region_floats;      // ring and decoded stage / stream partials /
                          // cluster weights
  long long smem;         // dynamic shared bytes
};

// Splits fill the card at one block a (sequence, kv head, split) and at
// most 16 ranks a cluster, and own the table's W pages evenly: split s
// pages [s W / S, (s + 1) W / S), at least one each (S <= W).  A block
// has 256 threads (two blocks an SM: at one block an SM, 16-block
// clusters did not all fit the card at once).  Warps split G into hg =
// 2^k groups of at most 4 heads; above D = 128 (where G = 8 and 16 live)
// a posit stage is decoded once into an f32 tile the groups share.
// Stages hold whole pages, about 4,096 elements of K (and of V) each.
// The streams' m and l take psw floats each, nks G rounded to 4, so that
// their acc after them stays 16-byte aligned for its float4 stores.
DecPlan make_decode_plan(int B, int n_kv, int W, int page, int D, int G,
                         int eb) {
  DecPlan p{};
  const int dmax = D <= 64 ? 64 : D <= 128 ? 128 : 256;
  const int kpw = 32 / (dmax / kDecVpl);
  const int want = std::max(1, cdiv(kDecSMs, std::max(1, B * n_kv)));
  p.splits = std::min(std::min(kDecMaxSplit, W), want);
  p.hg = 1;
  while (p.hg * kDecGh < G) p.hg *= 2;
  p.gh = cdiv(G, p.hg);
  p.nks = kDecThreads / 32 / p.hg * kpw;
  p.psw = cdiv(p.nks * G, 4) * 4;
  p.pps = cdiv(W, p.splits);
  p.sp = std::min(p.pps, std::max(1, kDecStageElems / (page * D)));
  p.pt_words = cdiv(p.pps, 4) * 4;
  p.mask_words = cdiv(kDecStages * p.sp * page, 16) * 4;
  p.ring_floats = kDecStages * 2 * p.sp * page * D * eb / 4;
  const long long tile = eb == 4 || D <= 128 ? 0 : 2LL * p.sp * page * D;
  const long long streams = 1LL * p.nks * G * D + 2LL * p.psw;
  const long long weights = 3LL * p.splits * G + G;
  p.region_floats = static_cast<int>(
      std::max(p.ring_floats + tile, std::max(streams, weights)));
  p.smem = 4LL * (p.pt_words + p.mask_words + p.region_floats + G * D +
                  2 * G);
  return p;
}

struct DecArgs {
  const float* q;
  const unsigned char* k;
  const unsigned char* v;
  const int* table;
  const int* seq_lens;
  float* out;
  int H, n_kv, page, D, W, num_pages, window, n, es;
  float scale;
  int sp, hg, gh, nks, psw, pt_words, mask_words, ring_floats,
      region_floats;
};

__device__ __forceinline__ void dec_cp16(unsigned char* dst,
                                         const unsigned char* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void dec_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void dec_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Whether key j of the split is visible and on a page of the pool.
struct DecKeys {
  const int* pt;          // the split's table entries (shared memory)
  int p0, k_lo, k_hi, page, num_pages;
  __device__ __forceinline__ int entry(int j) const {
    return pt[j / page - p0];
  }
  __device__ __forceinline__ bool ok(int j) const {
    if (j < k_lo || j >= k_hi) return false;
    const int pg = entry(j);
    return pg >= 0 && pg < num_pages;
  }
};

// Stage t (pages fp + t sp ..) into ring slot t % 3: the K rows of its
// pages, then the V rows (a page's page x D elements are contiguous in the
// pool), 16-byte copies of pages with an entry inside the pool, and the
// slot's key mask (1: visible, on such a page).  Every page of [fp, lp)
// holds a visible key; a reclaimed page before the window is never copied.
// Commits a group in any case, so that wait_group counts stages.
template <int EB>
__device__ __forceinline__ void dec_issue(const DecArgs& a, const DecKeys& ky,
                                          unsigned char* ring,
                                          unsigned char* okm, int t, int n_st,
                                          int fp, int lp, int h) {
  if (t < n_st) {
    const int PB = a.page * a.D * EB, CPP = PB / 16;
    const int pg0 = fp + t * a.sp;
    const int np = min(a.sp, lp - pg0);
    const size_t sbytes = static_cast<size_t>(a.sp) * PB;
    unsigned char* kd = ring + (t % kDecStages) * 2 * sbytes;
    unsigned char* vd = kd + sbytes;
    unsigned char* mk = okm + (t % kDecStages) * a.sp * a.page;
    for (int kk = threadIdx.x; kk < np * a.page; kk += kDecThreads)
      mk[kk] = ky.ok(pg0 * a.page + kk);
    for (int c = threadIdx.x; c < np * CPP; c += kDecThreads) {
      const int pi = c / CPP, cc = c - pi * CPP;
      const int pg = ky.pt[pg0 + pi - ky.p0];
      if (pg < 0 || pg >= a.num_pages) continue;
      const size_t src =
          (static_cast<size_t>(pg) * a.n_kv + h) * PB + cc * 16;
      dec_cp16(kd + pi * PB + cc * 16, a.k + src);
      dec_cp16(vd + pi * PB + cc * 16, a.v + src);
    }
  }
  dec_commit();
}

// The 8 values of a row from element e0 (only the first 4 unless `full`:
// D % 8 == 4), decoded per format (posit16 es2 and 8-bit formats by the
// block's table).  Rows are 16-byte aligned at f32, 8 at posit16, 4 at
// 8 bits.
template <int FMT>
__device__ __forceinline__ void dec_raw8(const unsigned char* row, int e0,
                                         bool full, const uint32_t* tab,
                                         int n, int es, float (&v)[8]) {
  if constexpr (FMT == DEC_F32) {
    const float* r = reinterpret_cast<const float*>(row) + e0;
    const float4 x = *reinterpret_cast<const float4*>(r);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    if (full) {
      const float4 y = *reinterpret_cast<const float4*>(r + 4);
      v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
    }
  } else if constexpr (FMT == DEC_TAB8) {
    const uint32_t* r = reinterpret_cast<const uint32_t*>(row + e0);
    const uint32_t w0 = r[0], w1 = full ? r[1] : 0u;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = sk_tab8(tab, w0, e);
      if (full) v[4 + e] = sk_tab8(tab, w1, e);
    }
  } else {
    const uint2* r = reinterpret_cast<const uint2*>(row + 2 * e0);
    const uint2 x = r[0], y = full ? r[1] : make_uint2(0u, 0u);
    const uint32_t wd[4] = {x.x, x.y, y.x, y.y};
    sk_decode8<FMT == DEC_P16E2 ? SK_P16E2 : SK_GEN16>(wd, v, tab, n, es);
  }
}

// The lane's 8 values of a row (zeros unless `ok`; the last 4 zero unless
// `full`).
template <int FMT>
__device__ __forceinline__ void dec_row(const unsigned char* row, int e0,
                                        bool ok, bool full,
                                        const uint32_t* tab, int n, int es,
                                        float (&v)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = 0.0f;
  if (ok) dec_raw8<FMT>(row, e0, full, tab, n, es, v);
}

// Stage t's visible raw rows (ring slot t % 3), decoded once into the f32
// tile kvf (K rows, then V rows, D floats a key), 8 values a thread at a
// time.
template <int FMT>
__device__ __forceinline__ void dec_decode(const DecArgs& a,
                                           const unsigned char* mk,
                                           const unsigned char* kb,
                                           const unsigned char* vb, float* kvf,
                                           int nk, const uint32_t* tab) {
  constexpr int EB = FMT == DEC_TAB8 ? 1 : 2;
  const int RB = a.D * EB, CPR = cdiv(a.D, 8);
  const int per = nk * CPR;
  const int tile = a.sp * a.page * a.D;
  for (int c = threadIdx.x; c < 2 * per; c += kDecThreads) {
    const int v = c >= per, cc = c - v * per;
    const int kk = cc / CPR, q = cc - kk * CPR;
    if (!mk[kk]) continue;
    const bool full = 8 * q + 8 <= a.D;
    float x[8];
    dec_raw8<FMT>((v ? vb : kb) + kk * RB, 8 * q, full, tab, a.n, a.es, x);
    float* d = kvf + v * tile + kk * a.D + 8 * q;
    *reinterpret_cast<float4*>(d) = make_float4(x[0], x[1], x[2], x[3]);
    if (full)
      *reinterpret_cast<float4*>(d + 4) = make_float4(x[4], x[5], x[6], x[7]);
  }
}

// The dot products of the 4 heads a warp holds, summed over the LPK lanes
// of a key by a transposed butterfly: two exchanges split the heads (lanes
// with bit H1 keep heads 2 and 3, then those with bit H2 the odd one), the
// rest sum; the lane ends with the whole sum of head 2 b1 + b2, the same
// bits on every lane that holds it (float addition commutes).
template <int LPK>
__device__ __forceinline__ float dec_sum4(const float (&v)[kDecGh], int li) {
  constexpr int H1 = LPK / 2, H2 = LPK / 4;
  const bool b1 = li & H1, b2 = li & H2;
  const float a0 = (b1 ? v[2] : v[0]) +
                   __shfl_xor_sync(kAll, b1 ? v[0] : v[2], H1);
  const float a1 = (b1 ? v[3] : v[1]) +
                   __shfl_xor_sync(kAll, b1 ? v[1] : v[3], H1);
  float r = (b2 ? a1 : a0) + __shfl_xor_sync(kAll, b2 ? a0 : a1, H2);
#pragma unroll
  for (int off = H2 / 2; off > 0; off >>= 1)
    r += __shfl_xor_sync(kAll, r, off);
  return r;
}

// The lane of a key's LPK that ends dec_sum4 with head i.
template <int LPK>
__device__ __forceinline__ int dec_src(int i) {
  return (i >> 1) * (LPK / 2) + (i & 1) * (LPK / 4);
}

// Max and sum over a warp's lanes by butterflies (a fixed order: every
// lane ends with the same bits).
__device__ __forceinline__ float dec_wmax(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kAll, x, off));
  return x;
}

__device__ __forceinline__ float dec_wsum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(kAll, x, off);
  return x;
}

template <int FMT, int DMAX>
__global__ void __launch_bounds__(kDecThreads, 2)
    paged_decode_kernel(DecArgs a) {
  constexpr int LPK = DMAX / kDecVpl;           // lanes a key
  constexpr int KPW = 32 / LPK;                 // keys a warp takes at once
  constexpr int H1 = LPK / 2, H2 = LPK / 4;
  constexpr bool kF32 = FMT == DEC_F32;
  constexpr int EB = kF32 ? 4 : FMT == DEC_TAB8 ? 1 : 2;
  // D > 128 (warps split G = 8 or 16 into head groups): a posit stage is
  // decoded once into f32, not by every group
  constexpr bool kPre = !kF32 && DMAX == 256;
  // keys a stream takes a turn: four where rows come decoded, one where
  // the lanes decode them (registers)
  constexpr int U = kPre ? 4 : 1;
  __shared__ uint32_t tab[256];
  extern __shared__ __align__(16) float smem[];
  int* pt_s = reinterpret_cast<int*>(smem);
  unsigned char* okm = reinterpret_cast<unsigned char*>(smem + a.pt_words);
  float* region = smem + a.pt_words + a.mask_words;
  unsigned char* ring = reinterpret_cast<unsigned char*>(region);
  float* kvf = region + a.ring_floats;         // a posit stage, decoded
  const int G = a.H / a.n_kv;
  float* bp_m = region + a.region_floats;      // the block's partial, read
  float* bp_l = bp_m + G;                      // by every rank of the
  float* bp_a = bp_l + G;                      // cluster: m, l [G], acc [G][D]

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hg = w % a.hg, kw = w / a.hg;
  const int sub = lane / LPK, li = lane % LPK;
  const int ks = kw * KPW + sub;               // this lane's stream
  const int g0 = hg * a.gh;
  const int gn = max(0, min(a.gh, G - g0));    // heads this warp holds
  const bool dl = li * kDecVpl < a.D;          // lane holds dimensions,
  const bool lf = li * kDecVpl + 8 <= a.D;     // 8 of them (else 4)
  const int nks = a.nks;                       // streams of a head group
  const int hsel = (li & H1 ? 2 : 0) + (li & H2 ? 1 : 0);  // softmax head
  const int gbase = lane & ~(LPK - 1);         // the key's first lane

  if (tid < 256) {
    if constexpr (FMT == DEC_TAB8)
      sk_fill_table<SK_TAB8>(tab, tid, a.n, a.es);
    else if constexpr (FMT == DEC_P16E2)
      sk_fill_table<SK_P16E2>(tab, tid, a.n, a.es);
  }

  // the sequence's visible keys [lo, sl) and this split's pages [p0, p1)
  const int split = blockIdx.x;
  const int sl = min(a.seq_lens[b], a.W * a.page);
  const int lo = a.window > 0 ? max(0, sl - a.window) : 0;
  const int S = static_cast<int>(gridDim.x);
  const int p0 = split * a.W / S, p1 = (split + 1) * a.W / S;
  const DecKeys ky{pt_s, p0, max(lo, p0 * a.page), min(sl, p1 * a.page),
                   a.page, a.num_pages};
  const int* trow = a.table + static_cast<size_t>(b) * a.W;
  for (int i = tid; i < p1 - p0; i += kDecThreads)
    pt_s[i] = __ldg(trow + p0 + i);

  // q and the accumulators of 4 heads over the lane's 8 dimensions; the
  // running max and sum of head hsel
  float qr[kDecGh][kDecVpl], acc[kDecGh][kDecVpl];
  float m = kNeg, l = 0.0f;
  const float* qb =
      a.q + (static_cast<size_t>(b) * a.H + h * G + g0) * a.D + li * kDecVpl;
#pragma unroll
  for (int i = 0; i < kDecGh; ++i) {
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f), y = x;
    if (i < gn && dl) {
      x = *reinterpret_cast<const float4*>(qb + i * a.D);
      if (lf) y = *reinterpret_cast<const float4*>(qb + i * a.D + 4);
    }
    qr[i][0] = x.x; qr[i][1] = x.y; qr[i][2] = x.z; qr[i][3] = x.w;
    qr[i][4] = y.x; qr[i][5] = y.y; qr[i][6] = y.z; qr[i][7] = y.w;
#pragma unroll
    for (int e = 0; e < kDecVpl; ++e) acc[i][e] = 0.0f;
  }

  const bool any = ky.k_lo < ky.k_hi;          // block-uniform
  const int fp = any ? ky.k_lo / a.page : 0;
  const int lp = any ? (ky.k_hi - 1) / a.page + 1 : 0;
  const int n_st = any ? cdiv(lp - fp, a.sp) : 0;
  const int RB = a.D * EB;
  const size_t sbytes = static_cast<size_t>(a.sp) * a.page * RB;
  const int tile = a.sp * a.page * a.D;        // floats of K (of V) a stage
  __syncthreads();                             // the table slice, tab
  dec_issue<EB>(a, ky, ring, okm, 0, n_st, fp, lp, h);
  dec_issue<EB>(a, ky, ring, okm, 1, n_st, fp, lp, h);
  for (int t = 0; t < n_st; ++t) {
    dec_wait<1>();
    __syncthreads();        // stage t landed; every warp is done with t - 1
    dec_issue<EB>(a, ky, ring, okm, t + 2, n_st, fp, lp, h);
    const unsigned char* kb = ring + (t % kDecStages) * 2 * sbytes;
    const unsigned char* vb = kb + sbytes;
    const unsigned char* mk = okm + (t % kDecStages) * a.sp * a.page;
    const int nk = min(a.sp, lp - fp - t * a.sp) * a.page;
    if constexpr (kPre) {
      dec_decode<FMT>(a, mk, kb, vb, kvf, nk, tab);
      __syncthreads();                         // the decoded stage
    }
    // rows at byte offset kk rs, decoded (kPre) or raw
    const unsigned char* kr = kPre ? reinterpret_cast<const unsigned char*>(
                                         kvf)
                                   : kb;
    const unsigned char* vr = kPre ? kr + 4 * tile : vb;
    constexpr int kRowFmt = kPre ? DEC_F32 : FMT;
    const int rs = kPre ? 4 * a.D : RB, e0 = li * kDecVpl;
    // U keys a stream a turn (key k0 + u nks + sub), through one 8-value
    // buffer; every lane of a warp runs the loop and its shuffles (a key's
    // lanes agree on its mask)
    for (int k0 = kw * KPW; k0 < nk; k0 += U * nks) {
      float sc[U], pu[U];
      bool vu[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int kk = k0 + u * nks + sub;
        vu[u] = kk < nk && mk[kk];
        float x[kDecVpl], d[kDecGh];
        dec_row<kRowFmt>(kr + kk * rs, e0, vu[u] && dl, lf, tab, a.n, a.es,
                         x);
#pragma unroll
        for (int i = 0; i < kDecGh; ++i) {
          d[i] = 0.0f;
#pragma unroll
          for (int e = 0; e < kDecVpl; ++e)
            d[i] = fmaf(qr[i][e], x[e], d[i]);
        }
        sc[u] = dec_sum4<LPK>(d, li) * a.scale;
      }
      // the online softmax of head hsel, then its factors to every lane
      float mx = m;
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (vu[u]) mx = fmaxf(mx, sc[u]);
      const float al = mx > m ? expf(m - mx) : 1.0f;
      l *= al;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        pu[u] = vu[u] ? expf(sc[u] - mx) : 0.0f;
        l += pu[u];
      }
      m = mx;
#pragma unroll
      for (int i = 0; i < kDecGh; ++i) {
        const float ai = __shfl_sync(kAll, al, gbase + dec_src<LPK>(i));
        if (ai != 1.0f) {
#pragma unroll
          for (int e = 0; e < kDecVpl; ++e) acc[i][e] *= ai;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int kk = k0 + u * nks + sub;
        float x[kDecVpl];
        dec_row<kRowFmt>(vr + kk * rs, e0, vu[u] && dl, lf, tab, a.n, a.es,
                         x);
#pragma unroll
        for (int i = 0; i < kDecGh; ++i) {
          const float pi = __shfl_sync(kAll, pu[u], gbase + dec_src<LPK>(i));
#pragma unroll
          for (int e = 0; e < kDecVpl; ++e)
            acc[i][e] = fmaf(pi, x[e], acc[i][e]);
        }
      }
    }
  }
  dec_wait<0>();
  __syncthreads();                             // the ring is free

  // the block's streams (m, l, acc of each (stream, head)); per head a
  // warp takes the streams' weights exp(m - M) (0 for a stream that saw no
  // key) and their sum by butterflies, then each output sums its streams
  // in stream order
  float* ps_m = region;                        // then each stream's weight
  float* ps_l = ps_m + a.psw;
  float* ps_a = ps_l + a.psw;
  if ((li & (H2 - 1)) == 0 && hsel < gn) {
    ps_m[ks * G + g0 + hsel] = m;
    ps_l[ks * G + g0 + hsel] = l;
  }
#pragma unroll
  for (int i = 0; i < kDecGh; ++i) {
    if (i >= gn || !dl) continue;
    float* d = ps_a + static_cast<size_t>(ks * G + g0 + i) * a.D +
               li * kDecVpl;
    *reinterpret_cast<float4*>(d) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    if (lf)
      *reinterpret_cast<float4*>(d + 4) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  __syncthreads();
  for (int g = w; g < G; g += kDecThreads / 32) {
    float M = kNeg;
    for (int s = lane; s < nks; s += 32)
      if (ps_l[s * G + g] > 0.0f) M = fmaxf(M, ps_m[s * G + g]);
    M = dec_wmax(M);
    float L = 0.0f;
    for (int s = lane; s < nks; s += 32) {
      const float ls = ps_l[s * G + g];
      const float wt = ls > 0.0f ? expf(ps_m[s * G + g] - M) : 0.0f;
      ps_m[s * G + g] = wt;
      L = fmaf(wt, ls, L);
    }
    L = dec_wsum(L);
    if (lane == 0) {
      bp_m[g] = M;
      bp_l[g] = L;
    }
  }
  __syncthreads();
  for (int o = tid; o < G * a.D; o += kDecThreads) {
    const int g = o / a.D, d = o - g * a.D;
    float A = 0.0f;
    for (int s = 0; s < nks; ++s)
      A = fmaf(ps_m[s * G + g], ps_a[static_cast<size_t>(s * G + g) * a.D + d],
               A);
    bp_a[o] = A;
  }

  // the cluster's ranks (the splits) in rank order: each rank's m and l
  // read once into shared memory, the weights of each (rank, head), then
  // a slice of the outputs with its S remote reads in flight together
  cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());
  cl.sync();                                   // every partial is written
  float* cw = region;                          // weights [S][G], L [G],
  float* cL = cw + S * G;                      // the ranks' m and l [S][G]
  float* rm = cL + G;
  float* rl = rm + S * G;
  for (int t = tid; t < S * G; t += kDecThreads) {
    const float* pm = cl.map_shared_rank(bp_m, t / G);
    rm[t] = pm[t % G];
    rl[t] = pm[G + t % G];
  }
  __syncthreads();
  for (int g = tid; g < G; g += kDecThreads) {
    float M = kNeg;
    for (int r = 0; r < S; ++r)
      if (rl[r * G + g] > 0.0f) M = fmaxf(M, rm[r * G + g]);
    float L = 0.0f;
    for (int r = 0; r < S; ++r) {
      const float lr = rl[r * G + g];
      const float wt = lr > 0.0f ? expf(rm[r * G + g] - M) : 0.0f;
      cw[r * G + g] = wt;
      L = fmaf(wt, lr, L);
    }
    cL[g] = L;
  }
  __syncthreads();
  const int GD = G * a.D, per = cdiv(GD, S);
  float* ob = a.out + (static_cast<size_t>(b) * a.H + h * G) * a.D;
  for (int o = rank * per + tid; o < min(GD, (rank + 1) * per);
       o += kDecThreads) {
    const int g = o / a.D;
    float v[kDecMaxSplit];
#pragma unroll
    for (int r = 0; r < kDecMaxSplit; ++r)
      v[r] = r < S ? cl.map_shared_rank(bp_a, r)[o] : 0.0f;
    float A = 0.0f;
#pragma unroll
    for (int r = 0; r < kDecMaxSplit; ++r)
      if (r < S) A = fmaf(cw[r * G + g], v[r], A);
    const float L = cL[g];
    ob[o] = L > 0.0f ? A / L : 0.0f;
  }
  cl.sync();                  // no block leaves while a rank reads its partial
}

template <int FMT, int DMAX>
int launch_decode(const DecArgs& a, const DecPlan& pl, int B,
                  cudaStream_t st) {
  auto kern = paged_decode_kernel<FMT, DMAX>;
  // per device: the shared bytes this instance was opted into, and
  // whether it may form clusters above the portable 8
  static long long opted[16] = {};
  static bool wide[16] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (pl.smem > 48 * 1024 && (dev >= 16 || pl.smem > opted[dev])) {
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(pl.smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 16) opted[dev] = pl.smem;
  }
  if (pl.splits > 8 && (dev >= 16 || !wide[dev])) {
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 16) wide[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(pl.splits),
                     static_cast<unsigned>(a.n_kv), static_cast<unsigned>(B));
  cfg.blockDim = dim3(kDecThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(pl.smem);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(pl.splits);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <int FMT>
int dispatch_decode(const DecArgs& a, const DecPlan& pl, int B,
                    cudaStream_t st) {
  if (a.D <= 64) return launch_decode<FMT, 64>(a, pl, B, st);
  if (a.D <= 128) return launch_decode<FMT, 128>(a, pl, B, st);
  return launch_decode<FMT, 256>(a, pl, B, st);
}

}  // namespace

// q [B, H, D] -> out [B, H, D].  window <= 0: no window.  splits and
// smem: the caller's plan (refused unless it is make_decode_plan's).
// Takes D % 4 == 0, D <= 256, page * D * element bytes % 16 == 0, G <= 32,
// and 16-byte aligned q and pools.
extern "C" int posit_paged_decode(const void* q, const void* k_pages,
                                  const void* v_pages, const void* page_table,
                                  const void* seq_lens, void* out, int B,
                                  int H, int n_kv, int page, int D, int W,
                                  int num_pages, int window, float scale,
                                  int dtype, int n, int es, int splits,
                                  int smem, void* stream) {
  if (B <= 0) return 0;
  const int eb = dtype == DT_F32 ? 4 : dtype == DT_I8 ? 1 : 2;
  if (n_kv <= 0 || H % n_kv != 0 || H / n_kv > kDecMaxG || D <= 0 ||
      D % 4 != 0 || D > 256 || page <= 0 || (page * D * eb) % 16 != 0 ||
      W <= 0 ||
      (dtype != DT_F32 && dtype != DT_I8 && dtype != DT_I16) ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(k_pages) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v_pages) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const DecPlan pl = make_decode_plan(B, n_kv, W, page, D, H / n_kv, eb);
  if (splits != pl.splits || smem != pl.smem)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  DecArgs a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const unsigned char*>(k_pages);
  a.v = static_cast<const unsigned char*>(v_pages);
  a.table = static_cast<const int*>(page_table);
  a.seq_lens = static_cast<const int*>(seq_lens);
  a.out = static_cast<float*>(out);
  a.H = H;
  a.n_kv = n_kv;
  a.page = page;
  a.D = D;
  a.W = W;
  a.num_pages = num_pages;
  a.window = window;
  a.n = n;
  a.es = es;
  a.scale = scale;
  a.sp = pl.sp;
  a.hg = pl.hg;
  a.gh = pl.gh;
  a.nks = pl.nks;
  a.psw = pl.psw;
  a.pt_words = pl.pt_words;
  a.mask_words = pl.mask_words;
  a.ring_floats = pl.ring_floats;
  a.region_floats = pl.region_floats;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) return dispatch_decode<DEC_F32>(a, pl, B, st);
  if (dtype == DT_I8) return dispatch_decode<DEC_TAB8>(a, pl, B, st);
  if (n == 16 && es == 2) return dispatch_decode<DEC_P16E2>(a, pl, B, st);
  return dispatch_decode<DEC_GEN16>(a, pl, B, st);
}
