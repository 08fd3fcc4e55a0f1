// K3 and K4: attention of f32 queries over the paged (posit) KV pool.
//
// K3 replaces repro/kernels/flash_attention.py::paged_flash_decode (:650;
// pallas_call :694, body _paged_decode_kernel :92): one query per sequence.
// K4 replaces ::paged_flash_prefill (:259; pallas_call :316, body
// _prefill_body :153): a chunk of Sq queries per sequence, with causal,
// q_offset, window, tanh softcap and kpos < seq_lens masks.
//
// Pool layout: pages [num_pages, n_kv, page, D] (f32, int8 or int16 posit),
// page_table [B, W] int32, seq_lens [B] int32 (post-append lengths).  GQA:
// query head h reads kv head h / G, G = H / n_kv.
//
// Bound on an H100.  Decode reads each cached token's K and V once (2 B per
// element at posit16) for 4 flops per element per query head: HBM bytes.
// Prefill does 4*Sq*G flops per cached K/V element; at Sq = 128 that is
// FFMA throughput.  No tensor cores, for the same reason as the GEMM.
//
// Design.  The TPU grid walked the page table one page per grid step, in
// order, carrying the online-softmax state in VMEM.  Here a block owns one
// (sequence, kv head) (K3) or one (sequence, kv head, 32-query tile) (K4),
// reads its page-table row itself and loops over the pages inside the
// block (K3 a chunk of several pages per round of barriers).  Each page of
// K and V is decoded once into shared memory and shared by the G query
// heads of the group.  The loop visits only pages
// that hold a key some query of the block may see (kpos < seq_len, inside
// the window, not after the block's last query under causal masking), and
// masked keys are skipped, never multiplied: positions at or past seq_len
// are never read.  A row that sees no key has l == 0 and gives 0 (the
// reference's -1e30 masking averages the masked values instead; the
// engine never reads such rows).  A key outside a row's masks never enters
// its arithmetic, so a page the table points at but no row may see (the
// garbage page behind a reclaimed sliding window, even full of NaR
// patterns) cannot reach the output.
//
// head_dim 256 (recurrentgemma's MQA: G = 16 query heads on one kv head).
// K3 keeps its shared-memory layout (66,880 B at D = 256, G = 16: opted in
// above 48 KB).  K4 keeps q and the accumulator of a row in registers; at
// D = 256 one thread cannot (512 floats), so the split form spreads each
// row over NS = 4 neighbouring lanes of a warp, each owning the dimensions
// d = i * NS + lane (i < 64), and sums a dot product's four partials with
// a butterfly of warp shuffles (every lane ends with the same bits: float
// addition commutes).  At most 256 threads a block: G * NS * bq threads,
// bq = 256 / (G * NS) query rows per head (4 at G = 16).
#include <cfloat>
#include "posit_codec.cuh"

namespace {

constexpr float kNeg = -1e30f;        // repro's _NEG

// ---- K3: decode, one block per (kv head, sequence) ----------------------
// The block walks the sequence in chunks of CH positions (whole pages; CH
// chosen by the wrapper to fit shared memory), so one round of barriers
// covers several pages.  Shared memory: q [G*D], k [CH*(D+1)] (rows padded
// so the per-position dot products hit distinct banks), v [CH*D],
// p [G*CH], acc [G*D], m/l/alpha [G] each, ok [CH] (position readable).
template <typename T>
__global__ void paged_decode_kernel(
    const float* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ page_table,
    const int* __restrict__ seq_lens, float* __restrict__ out, int H,
    int n_kv, int page, int D, int W, int num_pages, int window, int CH,
    float scale, int n, int es) {
  extern __shared__ float smem[];
  const int G = H / n_kv;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int KD = D + 1;
  float* q_s = smem;
  float* k_s = q_s + G * D;
  float* v_s = k_s + CH * KD;
  float* p_s = v_s + CH * D;
  float* acc_s = p_s + G * CH;
  float* m_s = acc_s + G * D;
  float* l_s = m_s + G;
  float* a_s = l_s + G;
  int* ok_s = reinterpret_cast<int*>(a_s + G);
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int i = tid; i < G * D; i += nt) {
    q_s[i] = q[(static_cast<size_t>(b) * H + h * G) * D + i];
    acc_s[i] = 0.0f;
  }
  if (tid < G) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.0f;
  }
  // the query sits at sl - 1; the window keeps kpos > sl - 1 - window
  const int sl = min(seq_lens[b], W * page);
  const int lo = window > 0 ? max(0, sl - window) : 0;
  __syncthreads();

  for (int c0 = (lo / page) * page; c0 < sl; c0 += CH) {
    const int p_lo = max(lo - c0, 0);
    const int p_hi = min(sl - c0, CH);           // candidate keys [p_lo, p_hi)
    for (int p = tid; p < CH; p += nt) {
      int ok = 0;
      if (p >= p_lo && p < p_hi) {
        const int pg = page_table[b * W + (c0 + p) / page];
        ok = pg >= 0 && pg < num_pages;
      }
      ok_s[p] = ok;
    }
    for (int i = p_lo * D + tid; i < p_hi * D; i += nt) {
      const int p = i / D, d = i - p * D;
      const int pos = c0 + p;
      const int pg = page_table[b * W + pos / page];
      if (pg < 0 || pg >= num_pages) continue;
      const size_t src =
          ((static_cast<size_t>(pg) * n_kv + h) * page + pos % page) * D + d;
      k_s[p * KD + d] = load_value<T>(k_pages, src, n, es);
      v_s[i] = load_value<T>(v_pages, src, n, es);
    }
    __syncthreads();
    for (int i = tid; i < G * CH; i += nt) {
      const int g = i / CH, p = i - g * CH;
      float s = kNeg;
      if (ok_s[p]) {
        float dot = 0.0f;
        for (int d = 0; d < D; ++d)
          dot = fmaf(q_s[g * D + d], k_s[p * KD + d], dot);
        s = dot * scale;
      }
      p_s[i] = s;
    }
    __syncthreads();
    if (tid < G) {
      const int g = tid;
      const float m_prev = m_s[g];
      float mx = m_prev;
      for (int p = p_lo; p < p_hi; ++p)
        if (ok_s[p]) mx = fmaxf(mx, p_s[g * CH + p]);
      float l = 0.0f;
      for (int p = p_lo; p < p_hi; ++p) {
        float e = 0.0f;
        if (ok_s[p]) {
          e = expf(p_s[g * CH + p] - mx);
          l += e;
        }
        p_s[g * CH + p] = e;
      }
      const float alpha = expf(m_prev - mx);
      l_s[g] = l_s[g] * alpha + l;
      m_s[g] = mx;
      a_s[g] = alpha;
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += nt) {
      const int g = i / D, d = i - g * D;
      float a = acc_s[i] * a_s[g];
      for (int p = p_lo; p < p_hi; ++p)
        if (ok_s[p]) a = fmaf(p_s[g * CH + p], v_s[p * D + d], a);
      acc_s[i] = a;
    }
    __syncthreads();
  }
  for (int i = tid; i < G * D; i += nt) {
    const float l = l_s[i / D];
    out[(static_cast<size_t>(b) * H + h * G) * D + i] =
        l > 0.0f ? acc_s[i] / l : 0.0f;
  }
}

// ---- K4: prefill, one block per (q tile, kv head, sequence) -------------
// One thread per query row (G heads x BQ rows); q and the accumulator live
// in registers.  Shared memory: k [page*D], v [page*D], s [page*threads].
constexpr int BQ = 32;

template <typename T, int DMAX>
__global__ void paged_prefill_kernel(
    const float* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ page_table,
    const int* __restrict__ seq_lens, const int* __restrict__ q_offset,
    float* __restrict__ out, int H, int n_kv, int Sq, int page, int D, int W,
    int num_pages, int causal, int window, float softcap, float scale, int n,
    int es) {
  extern __shared__ float smem[];
  const int G = H / n_kv;
  const int nt = blockDim.x;                     // == G * BQ
  const int tid = threadIdx.x;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  float* k_s = smem;
  float* v_s = k_s + page * D;
  float* s_s = v_s + page * D;                   // [page][nt]

  const int g = tid / BQ;
  const int row = qt * BQ + tid % BQ;
  const int head = h * G + g;
  const bool live = row < Sq;
  const int qo = q_offset[b];
  const int qpos = qo + row;
  const int sl = seq_lens[b];

  float qr[DMAX], acc[DMAX];
  const size_t qbase = ((static_cast<size_t>(b) * H + head) * Sq + row) * D;
#pragma unroll
  for (int d = 0; d < DMAX; ++d) {
    qr[d] = (live && d < D) ? q[qbase + d] : 0.0f;
    acc[d] = 0.0f;
  }
  float m = kNeg, l = 0.0f;

  // keys any row of this tile may see
  const int q_first = qo + qt * BQ;
  const int q_last = qo + min(qt * BQ + BQ, Sq) - 1;
  int kv_hi = sl;
  if (causal) kv_hi = min(kv_hi, q_last + 1);
  kv_hi = min(kv_hi, W * page);
  const int kv_lo = window > 0 ? max(0, q_first - window + 1) : 0;

  for (int j = kv_lo / page; j * page < kv_hi; ++j) {
    const int pg = page_table[b * W + j];
    if (pg >= 0 && pg < num_pages) {
      const size_t base = (static_cast<size_t>(pg) * n_kv + h) * page * D;
      const int n_valid = min(kv_hi - j * page, page) * D;
      for (int i = tid; i < n_valid; i += nt) {
        k_s[i] = load_value<T>(k_pages, base + i, n, es);
        v_s[i] = load_value<T>(v_pages, base + i, n, es);
      }
    }
    __syncthreads();
    // this row's valid keys in the page: [p_lo, p_hi)
    int k_lo = j * page, k_hi = min(j * page + page, sl);
    if (causal) k_hi = min(k_hi, qpos + 1);
    if (window > 0) k_lo = max(k_lo, qpos - window + 1);
    if (!live || !(pg >= 0 && pg < num_pages)) k_hi = k_lo;
    const int p_lo = k_lo - j * page, p_hi = k_hi - j * page;
    if (p_lo < p_hi) {
      float mx = m;
      for (int p = p_lo; p < p_hi; ++p) {
        float dot = 0.0f;
#pragma unroll
        for (int d = 0; d < DMAX; ++d)
          if (d < D) dot = fmaf(qr[d], k_s[p * D + d], dot);
        float s = dot * scale;
        if (softcap > 0.0f) s = tanhf(s / softcap) * softcap;
        s_s[p * nt + tid] = s;
        mx = fmaxf(mx, s);
      }
      const float alpha = expf(m - mx);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < DMAX; ++d) acc[d] *= alpha;
      for (int p = p_lo; p < p_hi; ++p) {
        const float e = expf(s_s[p * nt + tid] - mx);
        l += e;
#pragma unroll
        for (int d = 0; d < DMAX; ++d)
          if (d < D) acc[d] = fmaf(e, v_s[p * D + d], acc[d]);
      }
      m = mx;
    }
    __syncthreads();
  }
  if (live) {
    const float inv = l > 0.0f ? 1.0f / l : 0.0f;
#pragma unroll
    for (int d = 0; d < DMAX; ++d)
      if (d < D) out[qbase + d] = l > 0.0f ? acc[d] * inv : 0.0f;
  }
}

// Dynamic shared memory above 48 KB needs an opt-in per kernel.
template <typename K>
cudaError_t allow_shmem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// ---- K4, split form for 128 < D <= 64 * NS --------------------------------
// A kernel of its own, so that K4 at D <= 128 keeps its launch shape and
// registers.  Thread tid: lane = tid % NS of row r = tid / NS; head
// g = r / bq, query row qt * bq + r % bq.  Shared memory as in K4:
// k [page*D], v [page*D], s [page*threads].
constexpr int kSplitThreads = 256;
constexpr int kSplitDs = 64;          // dimensions per lane

template <int NS>
__device__ __forceinline__ float row_sum(float x, unsigned mask) {
#pragma unroll
  for (int off = NS / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(mask, x, off);
  return x;
}

template <typename T, int NS>
__global__ void __launch_bounds__(kSplitThreads) paged_prefill_split_kernel(
    const float* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ page_table,
    const int* __restrict__ seq_lens, const int* __restrict__ q_offset,
    float* __restrict__ out, int H, int n_kv, int Sq, int page, int D, int W,
    int num_pages, int causal, int window, float softcap, float scale, int n,
    int es, int bq) {
  extern __shared__ float smem[];
  const int G = H / n_kv;
  const int nt = blockDim.x;                     // == G * bq * NS
  const int tid = threadIdx.x;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  float* k_s = smem;
  float* v_s = k_s + page * D;
  float* s_s = v_s + page * D;                   // [page][nt]

  const int lane = tid % NS;
  const int r = tid / NS;
  const int g = r / bq;
  const int row = qt * bq + r % bq;
  const int head = h * G + g;
  const bool live = row < Sq;
  const int qo = q_offset[b];
  const int qpos = qo + row;
  const int sl = seq_lens[b];
  // the NS lanes of this row: same warp, same control flow
  const unsigned mask = ((1u << NS) - 1u) << ((tid % 32) / NS * NS);

  float qr[kSplitDs], acc[kSplitDs];
  const size_t qbase = ((static_cast<size_t>(b) * H + head) * Sq + row) * D;
#pragma unroll
  for (int i = 0; i < kSplitDs; ++i) {
    const int d = i * NS + lane;
    qr[i] = (live && d < D) ? q[qbase + d] : 0.0f;
    acc[i] = 0.0f;
  }
  float m = kNeg, l = 0.0f;

  const int q_first = qo + qt * bq;
  const int q_last = qo + min(qt * bq + bq, Sq) - 1;
  int kv_hi = sl;
  if (causal) kv_hi = min(kv_hi, q_last + 1);
  kv_hi = min(kv_hi, W * page);
  const int kv_lo = window > 0 ? max(0, q_first - window + 1) : 0;

  for (int j = kv_lo / page; j * page < kv_hi; ++j) {
    const int pg = page_table[b * W + j];
    if (pg >= 0 && pg < num_pages) {
      const size_t base = (static_cast<size_t>(pg) * n_kv + h) * page * D;
      const int n_valid = min(kv_hi - j * page, page) * D;
      for (int i = tid; i < n_valid; i += nt) {
        k_s[i] = load_value<T>(k_pages, base + i, n, es);
        v_s[i] = load_value<T>(v_pages, base + i, n, es);
      }
    }
    __syncthreads();
    int k_lo = j * page, k_hi = min(j * page + page, sl);
    if (causal) k_hi = min(k_hi, qpos + 1);
    if (window > 0) k_lo = max(k_lo, qpos - window + 1);
    if (!live || !(pg >= 0 && pg < num_pages)) k_hi = k_lo;
    const int p_lo = k_lo - j * page, p_hi = k_hi - j * page;
    if (p_lo < p_hi) {
      float mx = m;
      for (int p = p_lo; p < p_hi; ++p) {
        float dot = 0.0f;
#pragma unroll
        for (int i = 0; i < kSplitDs; ++i) {
          const int d = i * NS + lane;
          if (d < D) dot = fmaf(qr[i], k_s[p * D + d], dot);
        }
        float s = row_sum<NS>(dot, mask) * scale;
        if (softcap > 0.0f) s = tanhf(s / softcap) * softcap;
        s_s[p * nt + tid] = s;
        mx = fmaxf(mx, s);
      }
      const float alpha = expf(m - mx);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < kSplitDs; ++i) acc[i] *= alpha;
      for (int p = p_lo; p < p_hi; ++p) {
        const float e = expf(s_s[p * nt + tid] - mx);
        l += e;
#pragma unroll
        for (int i = 0; i < kSplitDs; ++i) {
          const int d = i * NS + lane;
          if (d < D) acc[i] = fmaf(e, v_s[p * D + d], acc[i]);
        }
      }
      m = mx;
    }
    __syncthreads();
  }
  if (live) {
    const float inv = l > 0.0f ? 1.0f / l : 0.0f;
#pragma unroll
    for (int i = 0; i < kSplitDs; ++i) {
      const int d = i * NS + lane;
      if (d < D) out[qbase + d] = l > 0.0f ? acc[i] * inv : 0.0f;
    }
  }
}

template <typename T>
int launch_decode(const void* q, const void* kp, const void* vp,
                  const int* pt, const int* sl, float* out, int B, int H,
                  int n_kv, int page, int D, int W, int num_pages, int window,
                  int CH, float scale, int n, int es, cudaStream_t st) {
  const int G = H / n_kv;
  const size_t shmem = sizeof(float) * (2 * G * D + CH * (2 * D + 1)
                                        + G * CH + 3 * G) + sizeof(int) * CH;
  cudaError_t e = allow_shmem(paged_decode_kernel<T>, shmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(n_kv, B);
  paged_decode_kernel<T><<<grid, 256, shmem, st>>>(
      static_cast<const float*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), pt, sl, out, H, n_kv, page, D, W, num_pages,
      window, CH, scale, n, es);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DMAX>
int launch_prefill_d(const void* q, const void* kp, const void* vp,
                     const int* pt, const int* sl, const int* qo, float* out,
                     int B, int H, int n_kv, int Sq, int page, int D, int W,
                     int num_pages, int causal, int window, float softcap,
                     float scale, int n, int es, cudaStream_t st) {
  const int G = H / n_kv;
  const int nt = G * BQ;
  const size_t shmem = sizeof(float) * (2 * page * D + page * nt);
  cudaError_t e = allow_shmem(paged_prefill_kernel<T, DMAX>, shmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((Sq + BQ - 1) / BQ, n_kv, B);
  paged_prefill_kernel<T, DMAX><<<grid, nt, shmem, st>>>(
      static_cast<const float*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), pt, sl, qo, out, H, n_kv, Sq, page, D, W,
      num_pages, causal, window, softcap, scale, n, es);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NS>
int launch_prefill_split(const void* q, const void* kp, const void* vp,
                         const int* pt, const int* sl, const int* qo,
                         float* out, int B, int H, int n_kv, int Sq, int page,
                         int D, int W, int num_pages, int causal, int window,
                         float softcap, float scale, int n, int es,
                         cudaStream_t st) {
  const int G = H / n_kv;
  const int bq = kSplitThreads / (G * NS);
  if (bq < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int nt = G * bq * NS;
  const size_t shmem = sizeof(float) * (2 * page * D + page * nt);
  cudaError_t e = allow_shmem(paged_prefill_split_kernel<T, NS>, shmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((Sq + bq - 1) / bq, n_kv, B);
  paged_prefill_split_kernel<T, NS><<<grid, nt, shmem, st>>>(
      static_cast<const float*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), pt, sl, qo, out, H, n_kv, Sq, page, D, W,
      num_pages, causal, window, softcap, scale, n, es, bq);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_prefill(const void* q, const void* kp, const void* vp,
                   const int* pt, const int* sl, const int* qo, float* out,
                   int B, int H, int n_kv, int Sq, int page, int D, int W,
                   int num_pages, int causal, int window, float softcap,
                   float scale, int n, int es, cudaStream_t st) {
  if (D <= 32)
    return launch_prefill_d<T, 32>(q, kp, vp, pt, sl, qo, out, B, H, n_kv, Sq,
                                   page, D, W, num_pages, causal, window,
                                   softcap, scale, n, es, st);
  if (D <= 64)
    return launch_prefill_d<T, 64>(q, kp, vp, pt, sl, qo, out, B, H, n_kv, Sq,
                                   page, D, W, num_pages, causal, window,
                                   softcap, scale, n, es, st);
  if (D <= 128)
    return launch_prefill_d<T, 128>(q, kp, vp, pt, sl, qo, out, B, H, n_kv,
                                    Sq, page, D, W, num_pages, causal, window,
                                    softcap, scale, n, es, st);
  if (D <= kSplitDs * 4)
    return launch_prefill_split<T, 4>(q, kp, vp, pt, sl, qo, out, B, H, n_kv,
                                      Sq, page, D, W, num_pages, causal,
                                      window, softcap, scale, n, es, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q [B, H, D] -> out [B, H, D].  window <= 0: no window.  CH: positions
// per chunk, a multiple of page.
extern "C" int posit_paged_decode(const void* q, const void* k_pages,
                                  const void* v_pages, const void* page_table,
                                  const void* seq_lens, void* out, int B,
                                  int H, int n_kv, int page, int D, int W,
                                  int num_pages, int window, int CH,
                                  float scale, int dtype, int n, int es,
                                  void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pt = static_cast<const int*>(page_table);
  const int* sl = static_cast<const int*>(seq_lens);
  float* o = static_cast<float*>(out);
  if (dtype == DT_F32)
    return launch_decode<float>(q, k_pages, v_pages, pt, sl, o, B, H, n_kv,
                                page, D, W, num_pages, window, CH, scale, n, es,
                                st);
  if (dtype == DT_I8)
    return launch_decode<int8_t>(q, k_pages, v_pages, pt, sl, o, B, H, n_kv,
                                 page, D, W, num_pages, window, CH, scale, n,
                                 es, st);
  if (dtype == DT_I16)
    return launch_decode<int16_t>(q, k_pages, v_pages, pt, sl, o, B, H, n_kv,
                                  page, D, W, num_pages, window, CH, scale, n,
                                  es, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// q [B, H, Sq, D] -> out [B, H, Sq, D].  window <= 0: none; softcap <= 0:
// none.
extern "C" int posit_paged_prefill(const void* q, const void* k_pages,
                                   const void* v_pages, const void* page_table,
                                   const void* seq_lens, const void* q_offset,
                                   void* out, int B, int H, int n_kv, int Sq,
                                   int page, int D, int W, int num_pages,
                                   int causal, int window, float softcap,
                                   float scale, int dtype, int n, int es,
                                   void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pt = static_cast<const int*>(page_table);
  const int* sl = static_cast<const int*>(seq_lens);
  const int* qo = static_cast<const int*>(q_offset);
  float* o = static_cast<float*>(out);
  if (dtype == DT_F32)
    return launch_prefill<float>(q, k_pages, v_pages, pt, sl, qo, o, B, H,
                                 n_kv, Sq, page, D, W, num_pages, causal,
                                 window, softcap, scale, n, es, st);
  if (dtype == DT_I8)
    return launch_prefill<int8_t>(q, k_pages, v_pages, pt, sl, qo, o, B, H,
                                  n_kv, Sq, page, D, W, num_pages, causal,
                                  window, softcap, scale, n, es, st);
  if (dtype == DT_I16)
    return launch_prefill<int16_t>(q, k_pages, v_pages, pt, sl, qo, o, B, H,
                                   n_kv, Sq, page, D, W, num_pages, causal,
                                   window, softcap, scale, n, es, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
