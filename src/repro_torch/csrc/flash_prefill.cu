// K7-K9: flash attention over a contiguous KV cache: the forward with the
// row log-sum-exp (K7, also launched by K14), and the two passes of its
// backward, dQ (K8) and dK/dV (K9).  The training forward and backward of
// every attention layer.  K4, the paged prefill of serving, is K7's
// forward reading its keys through the page table.
//
// K7 replaces repro/kernels/flash_attention.py::flash_prefill_contiguous
// (:332; pallas_call :404, body _prefill_body :153, return_lse); K4
// (flash_fwd_paged_kernel) ::paged_flash_prefill (:259; pallas_call :316,
// the same body over the paged pool).  K8
// replaces the dQ pass of ::flash_prefill_bwd_contiguous (:552; pallas_call
// :598, body _prefill_bwd_dq_body :448) and K9 its dK/dV pass (pallas_call
// :626, body _prefill_bwd_dkv_body :497), both with _bwd_probs' masks.
//
// Layout: q, o, dO [B, H, Sq, D] f32; k, v [B, n_kv, Skv, D] (f32, or
// int8/int16 posit for K7 and K8; K4: page pools [num_pages, n_kv, page, D]
// with page_table [B, W], Skv = W page); lse and delta [B, H, Sq] f32;
// kv_len (K4: seq_lens) and q_offset [B] int32.  Query row r of sequence
// b sits at position q_offset[b] + r and sees key positions kpos <
// kv_len[b], kpos <= qpos when causal, qpos - kpos < window when window >
// 0.  GQA: query head hq
// reads kv head hq / G, G = H / n_kv.  Scores are q.k * D^-0.5, then
// tanh-capped when softcap > 0.
//
// Bound on an H100.  Every kernel does O(Sq * Skv * D) flops per head on
// O((Sq + Skv) * D) bytes: at the training shapes (512 x 512, D = 64) that
// is thousands of flops per byte, so f32 FFMA throughput bounds them (per
// visible query-key pair: 4 D flops in K7, 6 D in K8, 8 D in K9).  No
// tensor cores: TF32 would round the f32 activations the reference
// multiplies exactly (the same reason as the GEMM).
//
// Design.  The TPU grid carried the online-softmax state (or the dQ / dK dV
// accumulators) across its sequential kv (or q) axis in VMEM.  Here each
// block owns one output tile and loops over the other axis itself.
//
//   K7 (and K14): one block of 256 threads per (64-row tile, kv head,
//     sequence).  The tile's rows are the G query heads of the kv group
//     folded together (flat row i = r * G + g), so every K/V tile feeds all
//     of them and a G = 1 layout still gets a full tile.  The Q tile sits
//     in shared memory for the whole sweep (read from device memory once);
//     K and V tiles of 64 keys (32 above D = 64) are double-buffered: by
//     cp.async for f32 KV; posit KV is loaded raw into registers and
//     decoded once per element into shared memory behind the previous
//     tile's arithmetic.  Threads form a 16 x 16 grid: each owns 4 rows and
//     computes a 4 x BN/16 register tile of S = Q K^T and a 4 x D/16
//     register tile of O += P V, every operand read from shared memory as
//     float4 (one shared load feeds 8-16 FMAs).  The row max combines over
//     the 16 threads of a row by warp shuffles; each thread keeps a partial
//     row sum, combined once at the end.  P goes through shared memory
//     between the two products, inside the warp that owns its rows.  Only
//     key tiles some row may see are visited, and per-element masks run
//     only on edge tiles.  One block barrier per K/V tile.
//   K4: K7's body (fwd_tile) with the row address of the staging a
//     template parameter: key j at row j % page of page table[b, j / page]
//     (PagedRows) instead of row (b n_kv + h) Skv + j (ContigRows, whose
//     instances compile to the code they had before).  The staging zeroes,
//     and never reads, keys below the block's lowest visible key (q_first -
//     window + 1), at or past kv_hi, or on an entry outside the pool: a
//     reclaimed window's garbage page (NaR patterns) never meets P = 0 in
//     O += P V.  A visible key on an entry outside the pool is masked from
//     the scores too (in the paged instance only), as K3 skips it.  A
//     decode step with a softcap (Sq = 1) is one G-row tile.
//     Bound as K7's: at smollm-360m's prefill layer (8 x 128 queries over
//     up to 512 keys) 4 G D flops a visible pair, 15 us of FFMA.
//   K8: K7's block, rows, staging and barrier, with dO beside Q in shared
//     memory for the whole sweep and lse and delta of each thread's 4 rows
//     in registers.  Per K/V tile: S = Q K^T and dP = dO V^T as 4 x BN/16
//     register tiles, P = exp(s - lse) and dS = P (dP - delta) dcap in
//     registers (masked on edge tiles only), dS^T through shared memory
//     inside the warp that owns its rows, then dQ += dS K into a 4 x D/16
//     register tile, scaled and written once.  K/V tiles of 32 keys at
//     D <= 64 and 16 above (two blocks a SM at D <= 128; Q + dO for 64
//     rows take 128 KB at D = 256), V stored like K with a padded row
//     stride since both are read by key row.  Nothing crosses blocks: a
//     repeated launch is bit-identical, and G (any H % n_kv == 0) only
//     sets the grid.
//   K9: one block per (32-key tile, kv head, sequence), 128 threads (256
//     above D = 128).  K and V of the tile stay in shared memory; the block
//     sweeps the flat rows of all G heads that can see its keys in tiles of
//     64 (32 above D = 64), Q, dO, lse and delta double-buffered with
//     cp.async.  Per tile: S^T = K Q^T and dP^T = V dO^T as register tiles
//     (4 keys x BR/TX rows a thread), P^T = exp(s - lse) and dS^T = P^T
//     (dP^T - delta) dcap into shared memory (read back by the warp that
//     wrote them), then dV += P^T dO and dK += dS^T Q into register tiles
//     of 4 keys x D/TX columns.  One block barrier per tile.  The sum over
//     heads and query tiles runs in a fixed order inside the block, one
//     output tile per block: no atomics, a repeated launch is bit-identical.
// A row that sees no key gets out = 0 and lse = 0 (l == 0), and dQ = 0.
#include <type_traits>

#include "posit_codec.cuh"

namespace {

constexpr float kNeg = -1e30f;        // repro's _NEG
constexpr int FT = 256;               // threads per block (K7, K8): 16 x 16
constexpr int BKV = 32;               // keys per block (K9): 4 per thread row
constexpr int KLDP = BKV + 4;         // row stride of K9's P / dS tiles

// K7 tile per head-width class: BN keys per K/V tile; two blocks a SM
// (registers capped at 128) where shared memory allows it.  Every class
// has RM = 4 rows a thread, BM = 64 flat query rows a block: 8-row
// threads halved the blocks a SM and ran slower.
template <int DMAX>
struct FwdTile {
  static constexpr int RM = 4;
  static constexpr int BM = 16 * RM;
  static constexpr int BN = DMAX <= 64 ? 64 : 32;
  static constexpr int LDP = BM + 4;            // row stride of P^T
  static constexpr int MIN_BLOCKS = DMAX <= 128 ? 2 : 1;
};

// K8 tile per head-width class: K7's 64 flat rows, 4 a thread; BN keys
// per K/V tile, two blocks a SM (registers capped at 128) at D <= 128.
// Tiles of 64 keys at D <= 64 and 32 at D <= 128 (one block a SM, for
// shared memory) timed the same on an H100.
template <int DMAX>
struct DqTile {
  static constexpr int RM = 4;
  static constexpr int BM = 16 * RM;
  static constexpr int BN = DMAX <= 64 ? 32 : 16;
  static constexpr int LDS = BM + 4;            // row stride of dS^T
  static constexpr int MIN_BLOCKS = DMAX <= 128 ? 2 : 1;
};

// K9 tile per head-width class: TY x TX threads (TY * 4 = BKV keys), BR
// flat query rows per staged tile.
template <int DMAX>
struct DkvTile {
  static constexpr int TY = 8;
  static constexpr int TX = DMAX <= 128 ? 16 : 32;
  static constexpr int BR = DMAX <= 64 ? 64 : 32;
  static constexpr int NT = TY * TX;
};

// Row stride (floats) of a shared tile read by 8 lanes at 8 different rows
// in one float4 phase: an odd number of 16-byte chunks keeps them on
// distinct banks.
__host__ __device__ constexpr int pad_ld(int D) {
  return ((D / 4) & 1) ? D : D + 4;
}

// Dynamic shared bytes of each kernel (mirrored by the Python wrappers,
// which pass them in; the entry points refuse a launch that differs).
template <int DMAX>
size_t fwd_shmem(int D) {
  using F = FwdTile<DMAX>;
  return sizeof(float) * (static_cast<size_t>(F::BM) * D +
                          2 * F::BN * pad_ld(D) + 2 * F::BN * D +
                          F::BN * F::LDP);
}

template <int DMAX>
size_t dq_shmem(int D) {
  using F = DqTile<DMAX>;
  return sizeof(float) * (2 * static_cast<size_t>(F::BM) * D +
                          4 * F::BN * pad_ld(D) + F::BN * F::LDS);
}

template <int DMAX>
size_t dkv_shmem(int D) {
  constexpr int BR = DkvTile<DMAX>::BR;
  return sizeof(float) * (2 * static_cast<size_t>(BKV) * D +
                          4 * BR * pad_ld(D) + 2 * BR * KLDP + 4 * BR);
}

// ---- cp.async (sm_80+): 16- and 4-byte copies, zero-filled when !full --
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float comp(float4 v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// Key range [*lo, *hi) any row of the query positions [q_first, q_last]
// may see.
__device__ __forceinline__ void tile_keys(int q_first, int q_last, int kl,
                                          int causal, int window, int* lo,
                                          int* hi) {
  *hi = causal ? min(kl, q_last + 1) : kl;
  *lo = window > 0 ? max(0, q_first - window + 1) : 0;
}

// Whether the key at j is visible from the query at qpos.
__device__ __forceinline__ bool visible(int j, int qpos, int kl, int causal,
                                        int window) {
  return j < kl && (!causal || j <= qpos) &&
         (window <= 0 || qpos - j < window);
}

// Scaled, capped score; *dcap = d s_cap / d s (1 without a cap).
__device__ __forceinline__ float cap_score(float dot, float scale,
                                          float softcap, float* dcap) {
  float s = dot * scale;
  *dcap = 1.0f;
  if (softcap > 0.0f) {
    const float t = tanhf(s / softcap);
    s = t * softcap;
    *dcap = 1.0f - t * t;
  }
  return s;
}

// Four stored posit elements as one vector load, and their decode (f32
// tiles go by cp.async and hold nothing in registers).
template <typename T>
struct Raw4 {
  using type = unsigned;
};
template <>
struct Raw4<int16_t> {
  using type = uint2;
};
template <>
struct Raw4<int8_t> {
  using type = unsigned;
};

__device__ __forceinline__ float4 decode4(uint2 r, int n, int es) {
  return make_float4(posit_decode(static_cast<int32_t>(r.x & 0xffffu), n, es),
                     posit_decode(static_cast<int32_t>(r.x >> 16), n, es),
                     posit_decode(static_cast<int32_t>(r.y & 0xffffu), n, es),
                     posit_decode(static_cast<int32_t>(r.y >> 16), n, es));
}

__device__ __forceinline__ float4 decode4(unsigned r, int n, int es) {
  return make_float4(posit_decode(static_cast<int32_t>(r & 0xffu), n, es),
                     posit_decode(static_cast<int32_t>((r >> 8) & 0xffu), n,
                                  es),
                     posit_decode(static_cast<int32_t>((r >> 16) & 0xffu), n,
                                  es),
                     posit_decode(static_cast<int32_t>(r >> 24), n, es));
}

// Where key j of the block's kv head lives, in rows of D elements (the
// row address of the K/V staging): K7's contiguous cache, row0 + j ...
struct ContigRows {
  static constexpr bool kPaged = false;
  struct Args {};
  size_t row0;
  static __device__ __forceinline__ ContigRows make(const Args&, int b,
                                                    int h, int n_kv,
                                                    int Skv) {
    return {(static_cast<size_t>(b) * n_kv + h) * Skv};
  }
  __device__ __forceinline__ void from(int) {}
  __device__ __forceinline__ bool has(int) const { return true; }
  // the row of key j if ok, else a row that exists
  __device__ __forceinline__ size_t row(bool ok, int j) const {
    return row0 + (ok ? j : 0);
  }
};

// ... or K4's page pool [num_pages, n_kv, page, D] through the sequence's
// row of the page table: key j is row j % page of page table[j / page].
// Keys below lo (the block's lowest visible key) and keys on an entry
// outside [0, num_pages) are never read: they stage as zeros, so the
// garbage page behind a reclaimed window (NaR patterns) never meets a
// zero probability.  A visible key on such an entry is dropped from the
// softmax too (`pooled`, in the score mask), as K3 drops it.
struct PagedRows {
  static constexpr bool kPaged = true;
  struct Args {
    const int* table;                            // [B, W]
    int W, page, num_pages;
  };
  const int* table;
  int page, n_kv, h, num_pages, lim, lo;
  static __device__ __forceinline__ PagedRows make(const Args& a, int b,
                                                   int h, int n_kv,
                                                   int Skv) {
    return {a.table + static_cast<size_t>(b) * a.W, a.page, n_kv, h,
            a.num_pages, Skv, 0};
  }
  // the block's lowest visible key
  __device__ __forceinline__ void from(int kv_lo) { lo = kv_lo; }
  // key j (< W page) lies on a page of the pool
  __device__ __forceinline__ bool pooled(int j) const {
    if (j >= lim) return false;
    const int pg = __ldg(table + j / page);
    return pg >= 0 && pg < num_pages;
  }
  __device__ __forceinline__ bool has(int j) const {
    return j >= lo && pooled(j);
  }
  __device__ __forceinline__ size_t row(bool ok, int j) const {
    if (!ok) return 0;
    const int pg = __ldg(table + j / page);
    return (static_cast<size_t>(pg) * n_kv + h) * page + j % page;
  }
};

// K/V staging of K7, K8 and K4: tile rows [j0, j0 + BN) of the block's kv
// head, addressed by `rows` (row strides ldk and ldv in shared memory),
// keys at or past kv_hi (and those `rows` does not have) zero.  Chunk c
// (4 values) is key c / D4, columns 4 (c % D4).  f32 goes by cp.async;
// posit is loaded raw into registers (fwd_load_raw) and decoded into
// shared memory later (fwd_store_raw).
template <int BN, typename RW>
__device__ __forceinline__ void fwd_copy_f32(float* ks, float* vs,
                                             const float* k, const float* v,
                                             const RW& rows, int j0,
                                             int kv_hi, int D, int ldk,
                                             int ldv) {
  const int D4 = D / 4;
  for (int c = threadIdx.x; c < BN * D4; c += FT) {
    const int p = c / D4, d4 = c - p * D4;
    const bool ok = j0 + p < kv_hi && rows.has(j0 + p);
    const size_t src = rows.row(ok, j0 + p) * D + 4 * d4;
    cp_async16(ks + p * ldk + 4 * d4, k + src, ok);
    cp_async16(vs + p * ldv + 4 * d4, v + src, ok);
  }
}

template <typename T, int BN, int CH, typename RW>
__device__ __forceinline__ void fwd_load_raw(
    typename Raw4<T>::type (&kr)[CH], typename Raw4<T>::type (&vr)[CH],
    const T* k, const T* v, const RW& rows, int j0, int kv_hi, int D) {
  using R = typename Raw4<T>::type;
  const int D4 = D / 4;
#pragma unroll
  for (int cc = 0; cc < CH; ++cc) {
    const int c = threadIdx.x + cc * FT;
    const int p = c / D4, d4 = c - p * D4;
    const bool ok = c < BN * D4 && j0 + p < kv_hi && rows.has(j0 + p);
    const size_t src = rows.row(ok, j0 + p) * D + 4 * d4;
    kr[cc] = ok ? *reinterpret_cast<const R*>(k + src) : R{};
    vr[cc] = ok ? *reinterpret_cast<const R*>(v + src) : R{};
  }
}

template <typename T, int BN, int CH>
__device__ __forceinline__ void fwd_store_raw(
    float* ks, float* vs, const typename Raw4<T>::type (&kr)[CH],
    const typename Raw4<T>::type (&vr)[CH], int D, int ldk, int ldv, int n,
    int es) {
  const int D4 = D / 4;
#pragma unroll
  for (int cc = 0; cc < CH; ++cc) {
    const int c = threadIdx.x + cc * FT;
    if (c < BN * D4) {
      const int p = c / D4, d4 = c - p * D4;
      st4(ks + p * ldk + 4 * d4, decode4(kr[cc], n, es));
      st4(vs + p * ldv + 4 * d4, decode4(vr[cc], n, es));
    }
  }
}

// ---- K7: forward, online softmax, optional lse --------------------------
// Shared memory: q [BM][D], k [2][BN][pad_ld(D)], v [2][BN][D],
// p^T [BN][LDP].  Thread (ty, tx) owns flat rows ty*RM .. ty*RM + RM-1
// (a warp owns 2 RM rows: P^T passes between its own lanes), keys tx +
// 16 c of each tile and float4 columns tx + 16 nc of the output.  One
// block barrier per K/V tile: the copy of tile t+1 starts right after it
// and runs under tile t's arithmetic (posit tiles are loaded raw into
// registers there and decoded into shared memory after it).
// The body of K7's two kernels: flash_fwd_kernel (contiguous rows) and
// flash_fwd_paged_kernel (K4: rows through the page table, Skv = W page).
template <typename T, int DMAX, typename RW>
__device__ __forceinline__ void fwd_tile(
    const float* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ kv_len,
    const int* __restrict__ q_offset, float* __restrict__ out,
    float* __restrict__ lse, int H, int n_kv, int Sq, int Skv, int D,
    int causal, int window, float softcap, float scale, int n, int es,
    const typename RW::Args& ra) {
  using F = FwdTile<DMAX>;
  constexpr int RM = F::RM, BM = F::BM, BN = F::BN, LDP = F::LDP;
  constexpr int RN = BN / 16;                    // keys per thread (S)
  constexpr int NC = DMAX / 64;                  // float4 columns (O)
  constexpr int CH = BN * DMAX / 4 / FT;         // K (V) chunks per thread
  constexpr bool kF32 = std::is_same<T, float>::value;
  extern __shared__ __align__(16) float smem[];
  const int G = H / n_kv;
  const int D4 = D / 4, ldk = pad_ld(D);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  // the last row tiles see the most keys under a causal mask: run first
  const int i0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nrows = G * Sq;
  float* q_s = smem;
  float* k_s = q_s + BM * D;
  float* v_s = k_s + 2 * BN * ldk;
  float* p_s = v_s + 2 * BN * D;

  const int qo = q_offset[b];
  const int kl = min(kv_len[b], Skv);
  const size_t qrow0 = (static_cast<size_t>(b) * H + h * G) * Sq;
  RW rows = RW::make(ra, b, h, n_kv, Skv);

  // the Q tile: flat row i -> head h*G + i % G, query row i / G
  for (int c = tid; c < BM * D4; c += FT) {
    const int rr = c / D4, d4 = c - rr * D4;
    const int i = i0 + rr;
    const bool ok = i < nrows;
    const size_t row = ok ? qrow0 + static_cast<size_t>(i % G) * Sq + i / G
                          : qrow0;
    cp_async16(q_s + rr * D + 4 * d4, q + row * D + 4 * d4, ok);
  }

  const int i_last = min(i0 + BM, nrows) - 1;
  const int q_first = qo + i0 / G, q_last = qo + i_last / G;
  int kv_lo, kv_hi;
  tile_keys(q_first, q_last, kl, causal, window, &kv_lo, &kv_hi);
  const int j_start = (kv_lo / BN) * BN;
  const int n_tiles = kv_hi > j_start ? (kv_hi - j_start + BN - 1) / BN : 0;
  rows.from(kv_lo);

  typename Raw4<T>::type k_raw[kF32 ? 1 : CH], v_raw[kF32 ? 1 : CH];
  float acc[RM][NC][4];
  float m[RM], l[RM];
#pragma unroll
  for (int a = 0; a < RM; ++a) {
    m[a] = kNeg;
    l[a] = 0.0f;
#pragma unroll
    for (int nc = 0; nc < NC; ++nc)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][nc][e] = 0.0f;
  }

  if (n_tiles > 0) {
    if constexpr (kF32) {
      fwd_copy_f32<BN>(k_s, v_s, k, v, rows, j_start, kv_hi, D, ldk, D);
    } else {
      fwd_load_raw<T, BN, CH>(k_raw, v_raw, k, v, rows, j_start, kv_hi, D);
      fwd_store_raw<T, BN, CH>(k_s, v_s, k_raw, v_raw, D, ldk, D, n, es);
    }
  }
  cp_async_commit();                             // Q (and the first tile)
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();        // tile t landed; every warp is done with t - 1
    const int j0 = j_start + t * BN;
    const int nb = (t + 1) & 1;
    const bool more = t + 1 < n_tiles;
    if (more) {
      if constexpr (kF32)
        fwd_copy_f32<BN>(k_s + nb * BN * ldk, v_s + nb * BN * D, k, v,
                         rows, j0 + BN, kv_hi, D, ldk, D);
      else
        fwd_load_raw<T, BN, CH>(k_raw, v_raw, k, v, rows, j0 + BN, kv_hi,
                                D);
    }
    cp_async_commit();
    const float* ks = k_s + (t & 1) * BN * ldk;
    const float* vs = v_s + (t & 1) * BN * D;

    // S = Q K^T: rows ty*RM + a, keys tx + 16 c
    float s[RM][RN];
#pragma unroll
    for (int a = 0; a < RM; ++a)
#pragma unroll
      for (int c = 0; c < RN; ++c) s[a][c] = 0.0f;
#pragma unroll 1
    for (int d4 = 0; d4 < D4; ++d4) {
      float4 kb[RN];
#pragma unroll
      for (int c = 0; c < RN; ++c)
        kb[c] = ld4(ks + (tx + 16 * c) * ldk + 4 * d4);
#pragma unroll
      for (int a = 0; a < RM; ++a) {
        const float4 qa = ld4(q_s + (ty * RM + a) * D + 4 * d4);
#pragma unroll
        for (int c = 0; c < RN; ++c) s[a][c] = dot4(qa, kb[c], s[a][c]);
      }
    }

    // masks (edge tiles only, and K4's keys on an entry outside the
    // pool), online softmax, P^T into shared memory
    const bool full = j0 + BN <= kl && i0 + BM <= nrows &&
                      (!causal || j0 + BN - 1 <= q_first) &&
                      (window <= 0 || q_last - j0 < window);
    bool pool[RN];
    if constexpr (RW::kPaged) {
#pragma unroll
      for (int c = 0; c < RN; ++c) pool[c] = rows.pooled(j0 + tx + 16 * c);
    }
#pragma unroll
    for (int a = 0; a < RM; ++a) {
      const int i = i0 + ty * RM + a;
      const int qpos = qo + i / G;
      bool ok[RN];
      float mx = m[a];
#pragma unroll
      for (int c = 0; c < RN; ++c) {
        float dcap;
        s[a][c] = cap_score(s[a][c], scale, softcap, &dcap);
        ok[c] = full || (i < nrows && visible(j0 + tx + 16 * c, qpos, kl,
                                              causal, window));
        if constexpr (RW::kPaged) ok[c] = ok[c] && pool[c];
        if (ok[c]) mx = fmaxf(mx, s[a][c]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float alpha = expf(m[a] - mx);
      m[a] = mx;
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < RN; ++c) {
        const float e = ok[c] ? expf(s[a][c] - mx) : 0.0f;
        s[a][c] = e;
        sum += e;
      }
      l[a] = fmaf(l[a], alpha, sum);
#pragma unroll
      for (int nc = 0; nc < NC; ++nc)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][nc][e] *= alpha;
    }
#pragma unroll
    for (int c = 0; c < RN; ++c)
#pragma unroll
      for (int a = 0; a < RM; a += 4)
        st4(p_s + (tx + 16 * c) * LDP + ty * RM + a,
            make_float4(s[a][c], s[a + 1][c], s[a + 2][c], s[a + 3][c]));
    __syncwarp();

    // O += P V: rows ty*RM + a, float4 columns tx + 16 nc
    const int nk = min(BN, kv_hi - j0);
#pragma unroll 2
    for (int p = 0; p < nk; ++p) {
      float pr[RM];
#pragma unroll
      for (int a = 0; a < RM; a += 4) {
        const float4 pa = ld4(p_s + p * LDP + ty * RM + a);
        pr[a] = pa.x;
        pr[a + 1] = pa.y;
        pr[a + 2] = pa.z;
        pr[a + 3] = pa.w;
      }
#pragma unroll
      for (int nc = 0; nc < NC; ++nc) {
        const int c = tx + 16 * nc;
        if (c < D4) {
          const float4 vv = ld4(vs + p * D + 4 * c);
#pragma unroll
          for (int a = 0; a < RM; ++a) {
            acc[a][nc][0] = fmaf(pr[a], vv.x, acc[a][nc][0]);
            acc[a][nc][1] = fmaf(pr[a], vv.y, acc[a][nc][1]);
            acc[a][nc][2] = fmaf(pr[a], vv.z, acc[a][nc][2]);
            acc[a][nc][3] = fmaf(pr[a], vv.w, acc[a][nc][3]);
          }
        }
      }
    }
    if constexpr (!kF32) {
      if (more)
        fwd_store_raw<T, BN, CH>(k_s + nb * BN * ldk, v_s + nb * BN * D,
                                 k_raw, v_raw, D, ldk, D, n, es);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int a = 0; a < RM; ++a) {
    float lt = l[a];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, off);
    const int i = i0 + ty * RM + a;
    if (i >= nrows) continue;
    const size_t row = qrow0 + static_cast<size_t>(i % G) * Sq + i / G;
#pragma unroll
    for (int nc = 0; nc < NC; ++nc) {
      const int c = tx + 16 * nc;
      if (c < D4) {
        float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (lt > 0.0f)
          o = make_float4(acc[a][nc][0] / lt, acc[a][nc][1] / lt,
                          acc[a][nc][2] / lt, acc[a][nc][3] / lt);
        st4(out + row * D + 4 * c, o);
      }
    }
    if (lse != nullptr && tx == 0)
      lse[row] = lt > 0.0f ? m[a] + logf(lt) : 0.0f;
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(FT, FwdTile<DMAX>::MIN_BLOCKS)
    flash_fwd_kernel(
    const float* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ kv_len,
    const int* __restrict__ q_offset, float* __restrict__ out,
    float* __restrict__ lse, int H, int n_kv, int Sq, int Skv, int D,
    int causal, int window, float softcap, float scale, int n, int es) {
  fwd_tile<T, DMAX, ContigRows>(q, k, v, kv_len, q_offset, out, lse, H, n_kv,
                                Sq, Skv, D, causal, window, softcap, scale, n,
                                es, ContigRows::Args{});
}

// K4: k, v are the page pools [num_pages, n_kv, page, D]; kv_len the
// post-append seq_lens; Skv = W * page.
template <typename T, int DMAX>
__global__ void __launch_bounds__(FT, FwdTile<DMAX>::MIN_BLOCKS)
    flash_fwd_paged_kernel(
    const float* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ kv_len,
    const int* __restrict__ q_offset, float* __restrict__ out, int H,
    int n_kv, int Sq, int D, int causal, int window, float softcap,
    float scale, int n, int es, PagedRows::Args pa) {
  fwd_tile<T, DMAX, PagedRows>(q, k, v, kv_len, q_offset, out, nullptr, H,
                               n_kv, Sq, pa.W * pa.page, D, causal, window,
                               softcap, scale, n, es, pa);
}

// ---- K8: dQ --------------------------------------------------------------
// Shared memory: q and dO [BM][D] each, k and v [2][BN][pad_ld(D)] each,
// dS^T [BN][LDS].  Thread (ty, tx) owns flat rows ty*RM .. ty*RM + RM-1
// (dS^T passes between the lanes of the warp that owns them), keys tx +
// 16 c of each tile and float4 columns tx + 16 nc of dQ.  Staging and the
// one block barrier per K/V tile as in K7.
template <typename T, int DMAX>
__global__ void __launch_bounds__(FT, DqTile<DMAX>::MIN_BLOCKS)
    flash_bwd_dq_kernel(
    const float* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ kv_len, const int* __restrict__ q_offset,
    float* __restrict__ dq, int H, int n_kv, int Sq, int Skv, int D,
    int causal, int window, float softcap, float scale, int n, int es) {
  using F = DqTile<DMAX>;
  constexpr int RM = F::RM, BM = F::BM, BN = F::BN, LDS = F::LDS;
  constexpr int RN = BN / 16;                    // keys per thread (S, dP)
  constexpr int NC = DMAX / 64;                  // float4 columns (dQ)
  constexpr int CH = BN * DMAX / 4 / FT;         // K (V) chunks per thread
  constexpr bool kF32 = std::is_same<T, float>::value;
  extern __shared__ __align__(16) float smem[];
  const int G = H / n_kv;
  const int D4 = D / 4, ldk = pad_ld(D);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  // the last row tiles see the most keys under a causal mask: run first
  const int i0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nrows = G * Sq;
  float* q_s = smem;
  float* o_s = q_s + BM * D;
  float* k_s = o_s + BM * D;
  float* v_s = k_s + 2 * BN * ldk;
  float* ds_s = v_s + 2 * BN * ldk;

  const int qo = q_offset[b];
  const int kl = min(kv_len[b], Skv);
  const size_t qrow0 = (static_cast<size_t>(b) * H + h * G) * Sq;
  const size_t kvrow0 = (static_cast<size_t>(b) * n_kv + h) * Skv;

  // the Q and dO tiles: flat row i -> head h*G + i % G, query row i / G
  for (int c = tid; c < BM * D4; c += FT) {
    const int rr = c / D4, d4 = c - rr * D4;
    const int i = i0 + rr;
    const bool ok = i < nrows;
    const size_t row = ok ? qrow0 + static_cast<size_t>(i % G) * Sq + i / G
                          : qrow0;
    cp_async16(q_s + rr * D + 4 * d4, q + row * D + 4 * d4, ok);
    cp_async16(o_s + rr * D + 4 * d4, dout + row * D + 4 * d4, ok);
  }
  float L[RM], dl[RM];
#pragma unroll
  for (int a = 0; a < RM; ++a) {
    const int i = i0 + ty * RM + a;
    const size_t row = qrow0 + static_cast<size_t>(i % G) * Sq + i / G;
    L[a] = i < nrows ? lse[row] : 0.0f;
    dl[a] = i < nrows ? delta[row] : 0.0f;
  }

  const int i_last = min(i0 + BM, nrows) - 1;
  const int q_first = qo + i0 / G, q_last = qo + i_last / G;
  int kv_lo, kv_hi;
  tile_keys(q_first, q_last, kl, causal, window, &kv_lo, &kv_hi);
  const int j_start = (kv_lo / BN) * BN;
  const int n_tiles = kv_hi > j_start ? (kv_hi - j_start + BN - 1) / BN : 0;

  typename Raw4<T>::type k_raw[kF32 ? 1 : CH], v_raw[kF32 ? 1 : CH];
  float acc[RM][NC][4];
#pragma unroll
  for (int a = 0; a < RM; ++a)
#pragma unroll
    for (int nc = 0; nc < NC; ++nc)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][nc][e] = 0.0f;

  if (n_tiles > 0) {
    if constexpr (kF32) {
      fwd_copy_f32<BN>(k_s, v_s, k, v, ContigRows{kvrow0}, j_start, kv_hi,
                       D, ldk, ldk);
    } else {
      fwd_load_raw<T, BN, CH>(k_raw, v_raw, k, v, ContigRows{kvrow0}, j_start,
                              kv_hi, D);
      fwd_store_raw<T, BN, CH>(k_s, v_s, k_raw, v_raw, D, ldk, ldk, n, es);
    }
  }
  cp_async_commit();                             // Q, dO (and the first tile)
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();        // tile t landed; every warp is done with t - 1
    const int j0 = j_start + t * BN;
    const int nb = (t + 1) & 1;
    const bool more = t + 1 < n_tiles;
    if (more) {
      if constexpr (kF32)
        fwd_copy_f32<BN>(k_s + nb * BN * ldk, v_s + nb * BN * ldk, k, v,
                         ContigRows{kvrow0}, j0 + BN, kv_hi, D, ldk, ldk);
      else
        fwd_load_raw<T, BN, CH>(k_raw, v_raw, k, v, ContigRows{kvrow0},
                                j0 + BN, kv_hi, D);
    }
    cp_async_commit();
    const float* ks = k_s + (t & 1) * BN * ldk;
    const float* vs = v_s + (t & 1) * BN * ldk;

    // S = Q K^T and dP = dO V^T: rows ty*RM + a, keys tx + 16 c
    float s[RM][RN], dp[RM][RN];
#pragma unroll
    for (int a = 0; a < RM; ++a)
#pragma unroll
      for (int c = 0; c < RN; ++c) {
        s[a][c] = 0.0f;
        dp[a][c] = 0.0f;
      }
#pragma unroll 1
    for (int d4 = 0; d4 < D4; ++d4) {
      float4 kb[RN];
#pragma unroll
      for (int c = 0; c < RN; ++c)
        kb[c] = ld4(ks + (tx + 16 * c) * ldk + 4 * d4);
#pragma unroll
      for (int a = 0; a < RM; ++a) {
        const float4 qa = ld4(q_s + (ty * RM + a) * D + 4 * d4);
#pragma unroll
        for (int c = 0; c < RN; ++c) s[a][c] = dot4(qa, kb[c], s[a][c]);
      }
    }
#pragma unroll 1
    for (int d4 = 0; d4 < D4; ++d4) {
      float4 vb[RN];
#pragma unroll
      for (int c = 0; c < RN; ++c)
        vb[c] = ld4(vs + (tx + 16 * c) * ldk + 4 * d4);
#pragma unroll
      for (int a = 0; a < RM; ++a) {
        const float4 oa = ld4(o_s + (ty * RM + a) * D + 4 * d4);
#pragma unroll
        for (int c = 0; c < RN; ++c) dp[a][c] = dot4(oa, vb[c], dp[a][c]);
      }
    }

    // dS = P (dP - delta) dcap, P = exp(s - lse), masked on edge tiles
    // only; dS^T into shared memory
    const bool full = j0 + BN <= kl && i0 + BM <= nrows &&
                      (!causal || j0 + BN - 1 <= q_first) &&
                      (window <= 0 || q_last - j0 < window);
#pragma unroll
    for (int a = 0; a < RM; ++a) {
      const int i = i0 + ty * RM + a;
      const int qpos = qo + i / G;
#pragma unroll
      for (int c = 0; c < RN; ++c) {
        const bool ok = full || (i < nrows && visible(j0 + tx + 16 * c, qpos,
                                                      kl, causal, window));
        float dcap;
        const float sv = cap_score(s[a][c], scale, softcap, &dcap);
        s[a][c] = ok ? expf(sv - L[a]) * (dp[a][c] - dl[a]) * dcap : 0.0f;
      }
    }
#pragma unroll
    for (int c = 0; c < RN; ++c)
#pragma unroll
      for (int a = 0; a < RM; a += 4)
        st4(ds_s + (tx + 16 * c) * LDS + ty * RM + a,
            make_float4(s[a][c], s[a + 1][c], s[a + 2][c], s[a + 3][c]));
    __syncwarp();

    // dQ += dS K: rows ty*RM + a, float4 columns tx + 16 nc
    const int nk = min(BN, kv_hi - j0);
#pragma unroll 2
    for (int p = 0; p < nk; ++p) {
      float dsr[RM];
#pragma unroll
      for (int a = 0; a < RM; a += 4) {
        const float4 da = ld4(ds_s + p * LDS + ty * RM + a);
        dsr[a] = da.x;
        dsr[a + 1] = da.y;
        dsr[a + 2] = da.z;
        dsr[a + 3] = da.w;
      }
#pragma unroll
      for (int nc = 0; nc < NC; ++nc) {
        const int c = tx + 16 * nc;
        if (c < D4) {
          const float4 kv = ld4(ks + p * ldk + 4 * c);
#pragma unroll
          for (int a = 0; a < RM; ++a) {
            acc[a][nc][0] = fmaf(dsr[a], kv.x, acc[a][nc][0]);
            acc[a][nc][1] = fmaf(dsr[a], kv.y, acc[a][nc][1]);
            acc[a][nc][2] = fmaf(dsr[a], kv.z, acc[a][nc][2]);
            acc[a][nc][3] = fmaf(dsr[a], kv.w, acc[a][nc][3]);
          }
        }
      }
    }
    if constexpr (!kF32) {
      if (more)
        fwd_store_raw<T, BN, CH>(k_s + nb * BN * ldk, v_s + nb * BN * ldk,
                                 k_raw, v_raw, D, ldk, ldk, n, es);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int a = 0; a < RM; ++a) {
    const int i = i0 + ty * RM + a;
    if (i >= nrows) continue;
    const size_t row = qrow0 + static_cast<size_t>(i % G) * Sq + i / G;
#pragma unroll
    for (int nc = 0; nc < NC; ++nc) {
      const int c = tx + 16 * nc;
      if (c < D4)
        st4(dq + row * D + 4 * c,
            make_float4(acc[a][nc][0] * scale, acc[a][nc][1] * scale,
                        acc[a][nc][2] * scale, acc[a][nc][3] * scale));
    }
  }
}

// Staging of K9: flat rows [i0, i0 + BR) of Q, dO (row stride ldq), lse
// and delta, rows at or past i_hi zero.
template <int BR, int NT>
__device__ __forceinline__ void dkv_stage(
    float* qs, float* os, float* ls, float* ds, const float* q,
    const float* dout, const float* lse, const float* delta, size_t qrow0,
    int G, int Sq, int i0, int i_hi, int D, int ldq) {
  const int D4 = D / 4;
  for (int c = threadIdx.x; c < BR * D4; c += NT) {
    const int rr = c / D4, d4 = c - rr * D4;
    const int i = i0 + rr;
    const bool ok = i < i_hi;
    const size_t row = ok ? qrow0 + static_cast<size_t>(i % G) * Sq + i / G
                          : qrow0;
    cp_async16(qs + rr * ldq + 4 * d4, q + row * D + 4 * d4, ok);
    cp_async16(os + rr * ldq + 4 * d4, dout + row * D + 4 * d4, ok);
  }
  for (int rr = threadIdx.x; rr < BR; rr += NT) {
    const int i = i0 + rr;
    const bool ok = i < i_hi;
    const size_t row = ok ? qrow0 + static_cast<size_t>(i % G) * Sq + i / G
                          : qrow0;
    cp_async4(ls + rr, lse + row, ok);
    cp_async4(ds + rr, delta + row, ok);
  }
}

// ---- K9: dK and dV (float KV) -------------------------------------------
// Shared memory: k [BKV][D], v [BKV][D], q and dO [2][BR][pad_ld(D)] each,
// p and ds [BR][KLDP] each, lse and delta [2][BR] each.
template <int DMAX>
__global__ void __launch_bounds__(DkvTile<DMAX>::NT, 1) flash_bwd_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ kv_len, const int* __restrict__ q_offset,
    float* __restrict__ dk, float* __restrict__ dv, int H, int n_kv, int Sq,
    int Skv, int D, int causal, int window, float softcap, float scale) {
  constexpr int TX = DkvTile<DMAX>::TX, BR = DkvTile<DMAX>::BR;
  constexpr int NT = DkvTile<DMAX>::NT;
  constexpr int RR = BR / TX;                    // rows per thread (S^T)
  constexpr int NC = DMAX / (4 * TX);            // float4 columns (dK, dV)
  extern __shared__ __align__(16) float smem[];
  const int G = H / n_kv;
  const int D4 = D / 4, ldq = pad_ld(D);
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  float* k_s = smem;
  float* v_s = k_s + BKV * D;
  float* q_s = v_s + BKV * D;
  float* o_s = q_s + 2 * BR * ldq;
  float* p_s = o_s + 2 * BR * ldq;
  float* ds_s = p_s + BR * KLDP;
  float* lse_s = ds_s + BR * KLDP;
  float* dl_s = lse_s + 2 * BR;

  const int j0 = kt * BKV;
  const int kl = min(kv_len[b], Skv);
  const int qo = q_offset[b];
  const size_t kvrow0 = (static_cast<size_t>(b) * n_kv + h) * Skv;
  const size_t qrow0 = (static_cast<size_t>(b) * H + h * G) * Sq;

  for (int c = tid; c < BKV * D4; c += NT) {
    const int p = c / D4, d4 = c - p * D4;
    const int j = j0 + p;
    const bool ok = j < Skv;
    const size_t src = (kvrow0 + (ok ? j : 0)) * D + 4 * d4;
    cp_async16(k_s + p * D + 4 * d4, k + src, ok);
    cp_async16(v_s + p * D + 4 * d4, v + src, ok);
  }

  // flat rows i = r * G + g of the query rows that see some key of the tile
  int i_lo = 0, i_hi = 0;
  if (j0 < kl) {                                 // block-uniform
    const int j_hi = min(j0 + BKV, kl);
    const int r_lo = causal ? max(0, j0 - qo) : 0;
    const int r_hi = window > 0 ? min(Sq, j_hi - 1 + window - qo) : Sq;
    if (r_hi > r_lo) {
      i_lo = r_lo * G;
      i_hi = r_hi * G;
    }
  }
  const int n_tiles = (i_hi - i_lo + BR - 1) / BR;

  float dK[4][NC][4], dV[4][NC][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int nc = 0; nc < NC; ++nc)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dK[a][nc][e] = 0.0f;
        dV[a][nc][e] = 0.0f;
      }

  if (n_tiles > 0)
    dkv_stage<BR, NT>(q_s, o_s, lse_s, dl_s, q, dout, lse, delta, qrow0, G,
                      Sq, i_lo, i_hi, D, ldq);
  cp_async_commit();                             // K, V and the first tile
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();        // tile t landed; every warp is done with t - 1
    if (t + 1 < n_tiles) {
      const int nb = (t + 1) & 1;
      dkv_stage<BR, NT>(q_s + nb * BR * ldq, o_s + nb * BR * ldq,
                        lse_s + nb * BR, dl_s + nb * BR, q, dout, lse, delta,
                        qrow0, G, Sq, i_lo + (t + 1) * BR, i_hi, D, ldq);
    }
    cp_async_commit();
    const int i0 = i_lo + t * BR;
    const float* qs = q_s + (t & 1) * BR * ldq;
    const float* os = o_s + (t & 1) * BR * ldq;
    const float* ls = lse_s + (t & 1) * BR;
    const float* dls = dl_s + (t & 1) * BR;

    // S^T = K Q^T and dP^T = V dO^T: keys ty*4 + a, rows tx + TX c
    float s[4][RR], dp[4][RR];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < RR; ++c) {
        s[a][c] = 0.0f;
        dp[a][c] = 0.0f;
      }
#pragma unroll 2
    for (int d4 = 0; d4 < D4; ++d4) {
      float4 ka[4], va[4], qb[RR], ob[RR];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        ka[a] = ld4(k_s + (ty * 4 + a) * D + 4 * d4);
        va[a] = ld4(v_s + (ty * 4 + a) * D + 4 * d4);
      }
#pragma unroll
      for (int c = 0; c < RR; ++c) {
        qb[c] = ld4(qs + (tx + TX * c) * ldq + 4 * d4);
        ob[c] = ld4(os + (tx + TX * c) * ldq + 4 * d4);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < RR; ++c) {
          s[a][c] = dot4(ka[a], qb[c], s[a][c]);
          dp[a][c] = dot4(va[a], ob[c], dp[a][c]);
        }
    }

    // P^T = exp(s - lse), dS^T = P^T (dP^T - delta) dcap, masked
    const int i_end = min(i0 + BR, i_hi);
    const int q_first = qo + i0 / G, q_last = qo + (i_end - 1) / G;
    const bool full = j0 + BKV <= kl && i0 + BR <= i_hi &&
                      (!causal || j0 + BKV - 1 <= q_first) &&
                      (window <= 0 || q_last - j0 < window);
#pragma unroll
    for (int c = 0; c < RR; ++c) {
      const int rr = tx + TX * c;
      const int i = i0 + rr;
      const int qp = qo + i / G;
      const float L = ls[rr], dl = dls[rr];
      float pv[4], dsv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const bool ok = full || (i < i_hi && visible(j0 + ty * 4 + a, qp, kl,
                                                     causal, window));
        float dcap;
        const float sv = cap_score(s[a][c], scale, softcap, &dcap);
        const float pr = ok ? expf(sv - L) : 0.0f;
        pv[a] = pr;
        dsv[a] = ok ? pr * (dp[a][c] - dl) * dcap : 0.0f;
      }
      st4(p_s + rr * KLDP + ty * 4, make_float4(pv[0], pv[1], pv[2], pv[3]));
      st4(ds_s + rr * KLDP + ty * 4,
          make_float4(dsv[0], dsv[1], dsv[2], dsv[3]));
    }
    __syncwarp();           // the rows of keys ty*4.. come from this warp

    // dV += P^T dO, dK += dS^T Q: keys ty*4 + a, float4 columns tx + TX nc
    const int nr = i_end - i0;
#pragma unroll 2
    for (int r = 0; r < nr; ++r) {
      const float4 pa = ld4(p_s + r * KLDP + ty * 4);
      const float4 da = ld4(ds_s + r * KLDP + ty * 4);
#pragma unroll
      for (int nc = 0; nc < NC; ++nc) {
        const int c = tx + TX * nc;
        if (c < D4) {
          const float4 ov = ld4(os + r * ldq + 4 * c);
          const float4 qv = ld4(qs + r * ldq + 4 * c);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float pr = comp(pa, a), dsr = comp(da, a);
            dV[a][nc][0] = fmaf(pr, ov.x, dV[a][nc][0]);
            dV[a][nc][1] = fmaf(pr, ov.y, dV[a][nc][1]);
            dV[a][nc][2] = fmaf(pr, ov.z, dV[a][nc][2]);
            dV[a][nc][3] = fmaf(pr, ov.w, dV[a][nc][3]);
            dK[a][nc][0] = fmaf(dsr, qv.x, dK[a][nc][0]);
            dK[a][nc][1] = fmaf(dsr, qv.y, dK[a][nc][1]);
            dK[a][nc][2] = fmaf(dsr, qv.z, dK[a][nc][2]);
            dK[a][nc][3] = fmaf(dsr, qv.w, dK[a][nc][3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = j0 + ty * 4 + a;
    if (j >= Skv) continue;
    const size_t o = (kvrow0 + j) * D;
#pragma unroll
    for (int nc = 0; nc < NC; ++nc) {
      const int c = tx + TX * nc;
      if (c < D4) {
        st4(dk + o + 4 * c,
            make_float4(dK[a][nc][0] * scale, dK[a][nc][1] * scale,
                        dK[a][nc][2] * scale, dK[a][nc][3] * scale));
        st4(dv + o + 4 * c, make_float4(dV[a][nc][0], dV[a][nc][1],
                                        dV[a][nc][2], dV[a][nc][3]));
      }
    }
  }
}

// Dynamic shared memory above 48 KB needs an opt-in per kernel and device.
// `opted` (one per kernel instance: a static of its launcher) remembers, per
// device, the bytes the instance was opted into, so the attribute is set
// once and not on every launch.
template <typename K>
cudaError_t allow_shmem(K kernel, size_t bytes, size_t (&opted)[16]) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 16 && bytes <= opted[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  if (e == cudaSuccess && dev < 16) opted[dev] = bytes;
  return e;
}

struct Args {
  const float* q;
  const void* k;
  const void* v;
  const float* dout;
  const float* lse_in;
  const float* delta;
  const int* kv_len;
  const int* q_offset;
  float* out;                                    // o (K7) or dq (K8)
  float* lse_out;                                // K7, may be null
  int B, H, n_kv, Sq, Skv, D, causal, window;
  float softcap, scale;
  int n, es;
};

template <typename T, int DMAX>
int launch_fwd(const Args& a, int threads, size_t shmem, cudaStream_t st) {
  if (threads != FT || shmem != fwd_shmem<DMAX>(a.D))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int G = a.H / a.n_kv;
  constexpr int BM = FwdTile<DMAX>::BM;
  dim3 grid((G * a.Sq + BM - 1) / BM, a.n_kv, a.B);
  static size_t opted[16] = {};
  cudaError_t e = allow_shmem(flash_fwd_kernel<T, DMAX>, shmem, opted);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_fwd_kernel<T, DMAX><<<grid, FT, shmem, st>>>(
      a.q, static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.kv_len,
      a.q_offset, a.out, a.lse_out, a.H, a.n_kv, a.Sq, a.Skv, a.D, a.causal,
      a.window, a.softcap, a.scale, a.n, a.es);
  return static_cast<int>(cudaGetLastError());
}

// K4: K7's forward over the page pool (a.k, a.v), a.kv_len = seq_lens.
template <typename T, int DMAX>
int launch_paged(const Args& a, const PagedRows::Args& pa, int threads,
                 size_t shmem, cudaStream_t st) {
  if (threads != FT || shmem != fwd_shmem<DMAX>(a.D))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int G = a.H / a.n_kv;
  constexpr int BM = FwdTile<DMAX>::BM;
  dim3 grid((G * a.Sq + BM - 1) / BM, a.n_kv, a.B);
  static size_t opted[16] = {};
  cudaError_t e = allow_shmem(flash_fwd_paged_kernel<T, DMAX>, shmem, opted);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_fwd_paged_kernel<T, DMAX><<<grid, FT, shmem, st>>>(
      a.q, static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.kv_len,
      a.q_offset, a.out, a.H, a.n_kv, a.Sq, a.D, a.causal, a.window,
      a.softcap, a.scale, a.n, a.es, pa);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_paged(const Args& a, const PagedRows::Args& pa, int threads,
                   size_t shmem, cudaStream_t st) {
  if (a.D <= 64) return launch_paged<T, 64>(a, pa, threads, shmem, st);
  if (a.D <= 128) return launch_paged<T, 128>(a, pa, threads, shmem, st);
  if (a.D <= 256) return launch_paged<T, 256>(a, pa, threads, shmem, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch_fwd(const Args& a, int threads, size_t shmem, cudaStream_t st) {
  if (a.D <= 64) return launch_fwd<T, 64>(a, threads, shmem, st);
  if (a.D <= 128) return launch_fwd<T, 128>(a, threads, shmem, st);
  if (a.D <= 256) return launch_fwd<T, 256>(a, threads, shmem, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int DMAX>
int launch_dq(const Args& a, int threads, size_t shmem, cudaStream_t st) {
  if (threads != FT || shmem != dq_shmem<DMAX>(a.D))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int G = a.H / a.n_kv;
  constexpr int BM = DqTile<DMAX>::BM;
  dim3 grid((G * a.Sq + BM - 1) / BM, a.n_kv, a.B);
  static size_t opted[16] = {};
  cudaError_t e = allow_shmem(flash_bwd_dq_kernel<T, DMAX>, shmem, opted);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dq_kernel<T, DMAX><<<grid, FT, shmem, st>>>(
      a.q, static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.dout,
      a.lse_in, a.delta, a.kv_len, a.q_offset, a.out, a.H, a.n_kv, a.Sq,
      a.Skv, a.D, a.causal, a.window, a.softcap, a.scale, a.n, a.es);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dq(const Args& a, int threads, size_t shmem, cudaStream_t st) {
  if (a.D <= 64) return launch_dq<T, 64>(a, threads, shmem, st);
  if (a.D <= 128) return launch_dq<T, 128>(a, threads, shmem, st);
  if (a.D <= 256) return launch_dq<T, 256>(a, threads, shmem, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

int check_args(const Args& a) {
  if (a.D % 4 != 0 || a.D <= 0 || a.n_kv <= 0 || a.H % a.n_kv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <int DMAX>
int launch_dkv(const Args& a, float* dk, float* dv, int threads,
               size_t shmem, cudaStream_t st) {
  if (threads != DkvTile<DMAX>::NT || shmem != dkv_shmem<DMAX>(a.D))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  static size_t opted[16] = {};
  cudaError_t e = allow_shmem(flash_bwd_dkv_kernel<DMAX>, shmem, opted);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((a.Skv + BKV - 1) / BKV, a.n_kv, a.B);
  flash_bwd_dkv_kernel<DMAX><<<grid, threads, shmem, st>>>(
      a.q, static_cast<const float*>(a.k), static_cast<const float*>(a.v),
      a.dout, a.lse_in, a.delta, a.kv_len, a.q_offset, dk, dv, a.H, a.n_kv,
      a.Sq, a.Skv, a.D, a.causal, a.window, a.softcap, a.scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K7 (and K14).  out [B,H,Sq,D]; lse [B,H,Sq] or null.  window <= 0: none;
// softcap <= 0: none.  dtype: the storage of k and v (0 f32, 1 int8,
// 2 int16 posit of format (n, es)).  threads and shmem: the launch
// geometry the caller computed for D (refused unless it is this file's).
extern "C" int flash_prefill_fwd(const void* q, const void* k, const void* v,
                                 const void* kv_len, const void* q_offset,
                                 void* out, void* lse, int B, int H, int n_kv,
                                 int Sq, int Skv, int D, int causal,
                                 int window, float softcap, float scale,
                                 int dtype, int n, int es, int threads,
                                 int shmem, void* stream) {
  Args a{static_cast<const float*>(q), k, v, nullptr, nullptr, nullptr,
         static_cast<const int*>(kv_len), static_cast<const int*>(q_offset),
         static_cast<float*>(out), static_cast<float*>(lse), B, H, n_kv, Sq,
         Skv, D, causal, window, softcap, scale, n, es};
  if (B <= 0 || Sq <= 0) return 0;
  if (int e = check_args(a)) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t sh = static_cast<size_t>(shmem);
  if (dtype == DT_F32) return dispatch_fwd<float>(a, threads, sh, st);
  if (dtype == DT_I8) return dispatch_fwd<int8_t>(a, threads, sh, st);
  if (dtype == DT_I16) return dispatch_fwd<int16_t>(a, threads, sh, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K4.  q [B,H,Sq,D] over the page pools k_pages, v_pages [num_pages, n_kv,
// page, D] through page_table [B, W] -> out [B,H,Sq,D]: K7's forward with
// key j of sequence b at row j % page of page page_table[b, j / page],
// kv_len = seq_lens (post-append) and no lse.  dtype, threads and shmem as
// for K7 (the geometry of K7 at D).
extern "C" int flash_prefill_paged_fwd(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* seq_lens, const void* q_offset,
    void* out, int B, int H, int n_kv, int Sq, int page, int D, int W,
    int num_pages, int causal, int window, float softcap, float scale,
    int dtype, int n, int es, int threads, int shmem, void* stream) {
  Args a{static_cast<const float*>(q), k_pages, v_pages, nullptr, nullptr,
         nullptr, static_cast<const int*>(seq_lens),
         static_cast<const int*>(q_offset), static_cast<float*>(out), nullptr,
         B, H, n_kv, Sq, W * page, D, causal, window, softcap, scale, n, es};
  if (B <= 0 || Sq <= 0) return 0;
  if (int e = check_args(a)) return e;
  if (page <= 0 || W <= 0 || num_pages <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const PagedRows::Args pa{static_cast<const int*>(page_table), W, page,
                           num_pages};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t sh = static_cast<size_t>(shmem);
  if (dtype == DT_F32) return dispatch_paged<float>(a, pa, threads, sh, st);
  if (dtype == DT_I8) return dispatch_paged<int8_t>(a, pa, threads, sh, st);
  if (dtype == DT_I16) return dispatch_paged<int16_t>(a, pa, threads, sh, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K8.  dq [B,H,Sq,D] from q, k, v, dO, lse, delta = rowsum(dO * o);
// dtype, threads and shmem as for K7.
extern "C" int flash_prefill_bwd_dq(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    const void* kv_len, const void* q_offset,
                                    void* dq, int B, int H, int n_kv, int Sq,
                                    int Skv, int D, int causal, int window,
                                    float softcap, float scale, int dtype,
                                    int n, int es, int threads, int shmem,
                                    void* stream) {
  Args a{static_cast<const float*>(q), k, v, static_cast<const float*>(dout),
         static_cast<const float*>(lse), static_cast<const float*>(delta),
         static_cast<const int*>(kv_len), static_cast<const int*>(q_offset),
         static_cast<float*>(dq), nullptr, B, H, n_kv, Sq, Skv, D, causal,
         window, softcap, scale, n, es};
  if (B <= 0 || Sq <= 0) return 0;
  if (int e = check_args(a)) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t sh = static_cast<size_t>(shmem);
  if (dtype == DT_F32) return dispatch_dq<float>(a, threads, sh, st);
  if (dtype == DT_I8) return dispatch_dq<int8_t>(a, threads, sh, st);
  if (dtype == DT_I16) return dispatch_dq<int16_t>(a, threads, sh, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K9.  dk, dv [B,n_kv,Skv,D] (group-summed) for f32 k and v; threads and
// shmem as for K7.
extern "C" int flash_prefill_bwd_dkv(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     const void* kv_len, const void* q_offset,
                                     void* dk, void* dv, int B, int H,
                                     int n_kv, int Sq, int Skv, int D,
                                     int causal, int window, float softcap,
                                     float scale, int threads, int shmem,
                                     void* stream) {
  Args a{static_cast<const float*>(q), k, v, static_cast<const float*>(dout),
         static_cast<const float*>(lse), static_cast<const float*>(delta),
         static_cast<const int*>(kv_len), static_cast<const int*>(q_offset),
         nullptr, nullptr, B, H, n_kv, Sq, Skv, D, causal, window, softcap,
         scale, 0, 0};
  if (B <= 0 || Skv <= 0) return 0;
  if (int e = check_args(a)) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dkp = static_cast<float*>(dk);
  float* dvp = static_cast<float*>(dv);
  const size_t sh = static_cast<size_t>(shmem);
  if (D <= 64) return launch_dkv<64>(a, dkp, dvp, threads, sh, st);
  if (D <= 128) return launch_dkv<128>(a, dkp, dvp, threads, sh, st);
  if (D <= 256) return launch_dkv<256>(a, dkp, dvp, threads, sh, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
