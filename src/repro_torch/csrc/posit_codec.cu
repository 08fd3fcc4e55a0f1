// K1: the bulk posit codec, its one-pass round trip, and the KV append
// that encodes and scatters.
//
// Replaces the TPU kernels repro/kernels/posit_codec.py::decode_block (:41,
// pallas_call :47) and ::encode_block (:59, pallas_call :65), and the jnp
// encode + scatter of repro/serving/paged_kv.py::paged_append_kv (:266,
// encode at :282).  round_trip_block computes in one pass what the
// reference's QAT cast (repro/quant/policy.py:56,
// decode_to_f32(f32_to_posit(w))) and repro/models/blocks.py:113
// rt_values compute as one expression, which XLA fuses into one pass; the
// port's posit_cast (and with it posit_cast_ste) and rt_values call it.
//
// Bound on an H100: HBM bytes.  decode reads 2 B (p16) and writes 4 B an
// element, encode the reverse, the round trip reads and writes 4 B: 6, 6
// and 8 B an element at 3.35 TB/s.  At that rate an element may cost ~60
// (codec) or ~80 (round trip) thread instructions before the issue rate
// (132 SMs x 4 schedulers x 32 lanes at ~1.98 GHz) binds instead; the
// tables below keep each pass well under that.  chip_smoke.py
// --codec-times times them beside one PyTorch copy of the round trip's
// bytes (PERF.md, with the card's name and power limit).
//
// Design of the three passes.
// - A step is 4 elements: one float4 on the f32 side, and 4 posits (8 B
//   of p16, 4 B of p8) or a float4 on the other, so every load and store
//   instruction of a warp covers one contiguous run (512 B of f32).  Each
//   thread keeps kUnroll steps in flight; blocks of kThreads walk a
//   grid-stride loop over the steps (32-bit step indices), the grid sized
//   to the blocks an SM holds at once (occupancy, read once per instance)
//   times the SMs.  The first steps' loads are issued before the block
//   fills its tables.
// - The split: `head` lanes first, until the f32 side sits on a 16-byte
//   boundary, then `nvec` steps, then the ragged tail, lanes one by one.
//   If the other side is then not aligned to its 4 elements, every
//   element goes lane by lane (head = count).
//   kernels/posit_codec.py::codec_split computes the split, this file's
//   codec_split the same: an entry refuses another
//   (cudaErrorInvalidConfiguration).
// - Encode by two 256-entry tables a block fills (posit_codec.cuh,
//   EncodeTables): by x's exponent, the |M| whose f32 add and subtract
//   rounds x where the pattern keeps a fraction bit (posit_rt's
//   rounding); by the rounded value's exponent, the pattern of that
//   power of two and the fraction's shift.  A step whose table entry is 0
//   (zero, subnormals, NaN, Inf, the binades next to maxpos and minpos)
//   takes posit_encode for those lanes.  P16_2 and P8_2 are compiled for
//   their format (the fill and that fallback constant-folded); any other
//   n <= 16 runs the same code with (n, es) at run time.
// - Decode: int8 storage (any n <= 8) by a table of every pattern's f32
//   bits; P16_2 by the skinny K2's regime table (posit_stream.cuh), with
//   posit_decode for a step holding zero, NaR or a regime past 7 bits;
//   any other int16 format by posit_decode.
// - The round trip is posit_rt, shared with K12 and K13.
//
// The append, by token rows.  Row (b, h, s) of k and v [B, n_kv, S, D]
// goes to row (page_table[b, pos / page], h, pos % page) of the pools [P,
// n_kv, page, D], pos = seq_lens[b] + s: a row is contiguous on both sides.
// A block is one (b, h) and RPB consecutive s, 256 threads as RPB rows of
// LPR lanes (LPR the power of two holding D / 4 chunks, at most 32).  Its
// num_new[b], seq_lens[b] and page-table row (W <= 256 entries, staged in
// shared memory) load while it fills the encode tables; then each lane
// finds its row's mask, page and offset once, drops a masked row (s >=
// num_new[b], a position past the table, a page outside the pool) before
// any load of k or v, and moves 4 elements at a time: one float4 of k and
// of v, stored as 8 (p16), 4 (p8) or 16 (f32 pages) bytes.  Where D % 4 !=
// 0 or a base pointer is not aligned for that, it moves the row element
// by element.  The pools are updated in place and no index tensor is
// materialized.
#include <algorithm>
#include <type_traits>

#include "posit_codec.cuh"
#include "posit_stream.cuh"

namespace {

constexpr int kThreads = 256;       // every K1 kernel
constexpr int kUnroll = 2;          // steps a thread has in flight
static_assert(kThreads == 256, "the tables: one entry a thread");

// The split of `count` elements: `head` lanes, `nvec` steps of 4 elements
// (one float4 on the f32 side), the tail lanes.  The f32 side (address fa)
// is 16-byte aligned after the head; the other side (elements of `pb`
// bytes at pa) must then be aligned to its 4 elements, else every element
// is a lane.
struct Split {
  long long head, nvec;
};
Split codec_split(long long count, uintptr_t fa, uintptr_t pa, int pb) {
  long long head = static_cast<long long>((16 - fa % 16) % 16) / 4;
  if (head > count ||
      (pa + static_cast<uintptr_t>(pb) * head) % (4 * pb) != 0)
    head = count;
  return {head, (count - head) / 4};
}

inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// Blocks for `units` threads' work: at most what the card holds at once of
// `kernel` (read once per instance through `cap`).
template <typename K>
unsigned grid_for(K kernel, int& cap, long long units) {
  if (cap == 0) {
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                  0);
    cap = std::max(per_sm, 1) * sm_count();
  }
  const long long want = (units + kThreads - 1) / kThreads;
  return static_cast<unsigned>(
      std::max(1LL, std::min(want, static_cast<long long>(cap))));
}

// Four posits of T as one 8-byte (int16) or 4-byte (int8) word.
template <typename T>
using Word4 = typename std::conditional<sizeof(T) == 2, uint2, uint32_t>::type;

template <typename T>
__device__ __forceinline__ uint32_t lane_of(Word4<T> w, int j) {
  if constexpr (sizeof(T) == 2) {
    const uint32_t h = j < 2 ? w.x : w.y;
    return (j & 1) ? h >> 16 : h & 0xFFFFu;
  } else {
    return (w >> (8 * j)) & 0xFFu;
  }
}

template <typename T>
__device__ __forceinline__ Word4<T> pack4(const int32_t (&p)[4]) {
  const uint32_t u0 = static_cast<uint32_t>(p[0]);
  const uint32_t u1 = static_cast<uint32_t>(p[1]);
  const uint32_t u2 = static_cast<uint32_t>(p[2]);
  const uint32_t u3 = static_cast<uint32_t>(p[3]);
  if constexpr (sizeof(T) == 2)
    return make_uint2((u0 & 0xFFFFu) | (u1 << 16),
                      (u2 & 0xFFFFu) | (u3 << 16));
  else
    return (u0 & 0xFFu) | ((u1 & 0xFFu) << 8) | ((u2 & 0xFFu) << 16) |
           (u3 << 24);
}

// ---- decode -------------------------------------------------------------
// Per storage and format: int8, any n <= 8 by a table of every pattern's
// f32 bits; P16_2 by the skinny K2's regime table (posit_stream.cuh's
// p16e2_fast, posit_decode for a step holding zero, NaR or a regime longer
// than 7 bits); any other int16 format by posit_decode.
enum DecFmt { DEC_TAB8 = 0, DEC_P16E2 = 1, DEC_GEN16 = 2 };

template <int FMT>
__device__ __forceinline__ void dec_fill(uint32_t* tab, int t, int n,
                                         int es) {
  if constexpr (FMT == DEC_TAB8)
    tab[t] = __float_as_uint(posit_decode(t, n, es));
  else if constexpr (FMT == DEC_P16E2)
    tab[t] = p16e2_entry(static_cast<uint32_t>(t));
}

template <int FMT>
__device__ __forceinline__ float dec_lane(int32_t p, const uint32_t* tab,
                                          int n, int es) {
  if constexpr (FMT == DEC_TAB8)
    return __uint_as_float(tab[p & 0xFF]);
  else if constexpr (FMT == DEC_P16E2)
    return posit_decode(p, 16, 2);
  else
    return posit_decode(p, n, es);
}

// Four posits -> four f32.
template <typename T, int FMT>
__device__ __forceinline__ float4 dec_step(Word4<T> w, const uint32_t* tab,
                                           int n, int es) {
  float v[4];
  if constexpr (FMT == DEC_P16E2) {
    uint32_t slow = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = p16e2_fast(lane_of<T>(w, j) << 16, tab, slow);
    if (__builtin_expect((slow & kSkSlow) != 0u, 0)) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = posit_decode(static_cast<int32_t>(lane_of<T>(w, j)), 16, 2);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = dec_lane<FMT>(static_cast<int32_t>(lane_of<T>(w, j)), tab, n, es);
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

template <typename T, int FMT>
__global__ void __launch_bounds__(kThreads)
decode_block_kernel(const T* __restrict__ in, float* __restrict__ out,
                    long long count, long long head, unsigned nvec, int n,
                    int es) {
  __shared__ uint32_t tab[256];
  const unsigned tid = blockIdx.x * kThreads + threadIdx.x;
  const unsigned stride = gridDim.x * kThreads;
  const Word4<T>* src = reinterpret_cast<const Word4<T>*>(in + head);
  float4* dst = reinterpret_cast<float4*>(out + head);
  Word4<T> raw[kUnroll];
  unsigned i = tid;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)        // in flight while the table fills
    if (i + u * stride < nvec) raw[u] = __ldg(src + i + u * stride);
  dec_fill<FMT>(tab, threadIdx.x, n, es);
  __syncthreads();
  while (i < nvec) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i + u * stride < nvec)
        dst[i + u * stride] = dec_step<T, FMT>(raw[u], tab, n, es);
    i += kUnroll * stride;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i + u * stride < nvec) raw[u] = __ldg(src + i + u * stride);
  }
  const long long tail0 = head + 4LL * nvec;
  for (long long j = tid; j < head; j += stride)
    out[j] = dec_lane<FMT>(in[j], tab, n, es);
  for (long long j = tail0 + tid; j < count; j += stride)
    out[j] = dec_lane<FMT>(in[j], tab, n, es);
}

// ---- encode -------------------------------------------------------------
// Four f32 -> four patterns, by the tables (posit_encode where they say so).
__device__ __forceinline__ void enc_step(float4 f, const EncodeTables& tab,
                                         int n, int es, int32_t (&p)[4]) {
  uint32_t slow = 0u;
  p[0] = encode_tab(f.x, tab, slow);
  p[1] = encode_tab(f.y, tab, slow);
  p[2] = encode_tab(f.z, tab, slow);
  p[3] = encode_tab(f.w, tab, slow);
  if (__builtin_expect(slow != 0u, 0)) {
    p[0] = encode_fix(f.x, p[0], tab, n, es);
    p[1] = encode_fix(f.y, p[1], tab, n, es);
    p[2] = encode_fix(f.z, p[2], tab, n, es);
    p[3] = encode_fix(f.w, p[3], tab, n, es);
  }
}

__device__ __forceinline__ int32_t enc_lane(float x, const EncodeTables& tab,
                                            int n, int es) {
  uint32_t slow = 0u;
  const int32_t p = encode_tab(x, tab, slow);
  return slow ? posit_encode(x, n, es) : p;
}

template <typename T, int N, int ES>
__global__ void __launch_bounds__(kThreads)
encode_block_kernel(const float* __restrict__ in, T* __restrict__ out,
                    long long count, long long head, unsigned nvec, int n_rt,
                    int es_rt) {
  __shared__ EncodeTables tab;
  const int n = N > 0 ? N : n_rt, es = N > 0 ? ES : es_rt;
  const unsigned tid = blockIdx.x * kThreads + threadIdx.x;
  const unsigned stride = gridDim.x * kThreads;
  const float4* src = reinterpret_cast<const float4*>(in + head);
  Word4<T>* dst = reinterpret_cast<Word4<T>*>(out + head);
  float4 raw[kUnroll];
  unsigned i = tid;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)        // in flight while the tables fill
    if (i + u * stride < nvec) raw[u] = __ldg(src + i + u * stride);
  encode_table_fill<N, ES>(tab, threadIdx.x, n, es);
  __syncthreads();
  while (i < nvec) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i + u * stride < nvec) {
        int32_t p[4];
        enc_step(raw[u], tab, n, es, p);
        dst[i + u * stride] = pack4<T>(p);
      }
    i += kUnroll * stride;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i + u * stride < nvec) raw[u] = __ldg(src + i + u * stride);
  }
  const long long tail0 = head + 4LL * nvec;
  for (long long j = tid; j < head; j += stride)
    out[j] = static_cast<T>(enc_lane(in[j], tab, n, es));
  for (long long j = tail0 + tid; j < count; j += stride)
    out[j] = static_cast<T>(enc_lane(in[j], tab, n, es));
}

// ---- the round trip -----------------------------------------------------
template <int N, int ES>
__device__ __forceinline__ float4 rt4(float4 a, int n, int es) {
  return make_float4(posit_rt<N, ES>(a.x, n, es), posit_rt<N, ES>(a.y, n, es),
                     posit_rt<N, ES>(a.z, n, es), posit_rt<N, ES>(a.w, n, es));
}

template <int N, int ES>
__global__ void __launch_bounds__(kThreads)
round_trip_kernel(const float* __restrict__ in, float* __restrict__ out,
                  long long count, long long head, unsigned nvec, int n,
                  int es) {
  const unsigned tid = blockIdx.x * kThreads + threadIdx.x;
  const unsigned stride = gridDim.x * kThreads;
  const float4* src = reinterpret_cast<const float4*>(in + head);
  float4* dst = reinterpret_cast<float4*>(out + head);
  for (unsigned i = tid; i < nvec; i += kUnroll * stride) {
    float4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i + u * stride < nvec) raw[u] = __ldg(src + i + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i + u * stride < nvec)
        dst[i + u * stride] = rt4<N, ES>(raw[u], n, es);
  }
  const long long tail0 = head + 4LL * nvec;
  for (long long j = tid; j < head; j += stride)
    out[j] = posit_rt<N, ES>(in[j], n, es);
  for (long long j = tail0 + tid; j < count; j += stride)
    out[j] = posit_rt<N, ES>(in[j], n, es);
}

// ---- the append -----------------------------------------------------------
// Four encoded elements (or copied floats) to dst, aligned for them.
template <typename T>
__device__ __forceinline__ void store4(T* dst, float4 f,
                                       const EncodeTables& tab, int n,
                                       int es) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(dst) = f;
  } else {
    int32_t p[4];
    enc_step(f, tab, n, es, p);
    *reinterpret_cast<Word4<T>*>(dst) = pack4<T>(p);
  }
}

template <typename T>
__device__ __forceinline__ T store1(float v, const EncodeTables& tab, int n,
                                    int es) {
  if constexpr (sizeof(T) == 4)
    return v;
  else
    return static_cast<T>(enc_lane(v, tab, n, es));
}

// k, v: [B, n_kv, S, D] f32 contiguous; pages: [P, n_kv, page, D].  Block
// (LPR, RPB) holds rows s = blockIdx.x RPB + threadIdx.y of one (b, h) =
// blockIdx.y: threadIdx.x is the lane of a row.  The page-table row of b
// (W <= kThreads entries) is staged in shared memory beside the tables,
// so a row's page costs no dependent global load.
template <typename T, int N, int ES>
__global__ void __launch_bounds__(kThreads) paged_append_kernel(
    const float* __restrict__ k, const float* __restrict__ v,
    const int* __restrict__ seq_lens, const int* __restrict__ num_new,
    const int* __restrict__ page_table, T* __restrict__ k_pages,
    T* __restrict__ v_pages, int n_kv, int S, int D, int page, int W,
    int num_pages, int vec, int n_rt, int es_rt) {
  __shared__ EncodeTables tab;
  __shared__ int pages[kThreads];
  const int n = N > 0 ? N : n_rt, es = N > 0 ? ES : es_rt;
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
  const int b = blockIdx.y / n_kv;
  const int h = blockIdx.y - b * n_kv;
  const int s = blockIdx.x * blockDim.y + threadIdx.y;
  const int new_b = num_new[b];            // in flight while the tables
  const int len_b = seq_lens[b];           // fill
  if (W <= kThreads && t < W) pages[t] = page_table[b * W + t];
  if constexpr (sizeof(T) != 4)
    encode_table_fill<N, ES>(tab, t, n, es);
  __syncthreads();
  if (s >= S || s >= new_b) return;        // masked token: dropped
  const int pos = len_b + s;
  const int slot = pos / page;
  if (slot >= W) return;                   // past the table: dropped
  const int pg = W <= kThreads ? pages[slot] : page_table[b * W + slot];
  if (pg < 0 || pg >= num_pages) return;   // outside the pool: dropped
  const size_t src = (static_cast<size_t>(blockIdx.y) * S + s) * D;
  const size_t dst =
      ((static_cast<size_t>(pg) * n_kv + h) * page + pos % page) * D;
  if (vec) {
    for (int d = 4 * threadIdx.x; d < D; d += 4 * blockDim.x) {
      const float4 kf = __ldg(reinterpret_cast<const float4*>(k + src + d));
      const float4 vf = __ldg(reinterpret_cast<const float4*>(v + src + d));
      store4<T>(k_pages + dst + d, kf, tab, n, es);
      store4<T>(v_pages + dst + d, vf, tab, n, es);
    }
  } else {
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
      k_pages[dst + d] = store1<T>(k[src + d], tab, n, es);
      v_pages[dst + d] = store1<T>(v[src + d], tab, n, es);
    }
  }
}

// ---- launches ---------------------------------------------------------------
// One pass (decode, encode or round trip) of kernel Kern, In -> Out: a grid
// for the larger of its steps' threads (kUnroll steps each) and its lanes'.
template <auto Kern, typename In, typename Out>
int launch_pass(const void* in, void* out, long long count, long long head,
                unsigned nvec, int n, int es, cudaStream_t st) {
  static int cap = 0;                       // per instance: its occupancy
  const long long lanes = count - 4LL * nvec;
  const long long units = (nvec + kUnroll - 1LL) / kUnroll;
  Kern<<<grid_for(Kern, cap, std::max(units, lanes)), kThreads, 0, st>>>(
      static_cast<const In*>(in), static_cast<Out*>(out), count, head, nvec,
      n, es);
  return static_cast<int>(cudaGetLastError());
}

// The caller's split must be this file's; nvec must fit the 32-bit loop.
bool split_ok(long long count, long long head, long long nvec,
              const void* f32, const void* other, int pb) {
  const Split sp = codec_split(count, reinterpret_cast<uintptr_t>(f32),
                               reinterpret_cast<uintptr_t>(other), pb);
  return sp.head == head && sp.nvec == nvec && nvec < (1LL << 31);
}

bool format_ok(int n, int es, int dtype) {
  return n >= 2 && n <= (dtype == DT_I8 ? 8 : 16) && es >= 0 && es <= 4;
}

}  // namespace

extern "C" int posit_decode_block(const void* in, void* out, long long count,
                                  long long head, long long nvec, int dtype,
                                  int n, int es, void* stream) {
  if (count <= 0) return 0;
  if ((dtype != DT_I8 && dtype != DT_I16) || !format_ok(n, es, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const int pb = dtype == DT_I8 ? 1 : 2;
  if (!split_ok(count, head, nvec, out, in, pb))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned nv = static_cast<unsigned>(nvec);
  if (dtype == DT_I8)
    return launch_pass<decode_block_kernel<int8_t, DEC_TAB8>, int8_t, float>(
        in, out, count, head, nv, n, es, st);
  return n == 16 && es == 2
             ? launch_pass<decode_block_kernel<int16_t, DEC_P16E2>, int16_t,
                           float>(in, out, count, head, nv, n, es, st)
             : launch_pass<decode_block_kernel<int16_t, DEC_GEN16>, int16_t,
                           float>(in, out, count, head, nv, n, es, st);
}

extern "C" int posit_encode_block(const void* in, void* out, long long count,
                                  long long head, long long nvec, int dtype,
                                  int n, int es, void* stream) {
  if (count <= 0) return 0;
  if ((dtype != DT_I8 && dtype != DT_I16) || !format_ok(n, es, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const int pb = dtype == DT_I8 ? 1 : 2;
  if (!split_ok(count, head, nvec, in, out, pb))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned nv = static_cast<unsigned>(nvec);
  if (dtype == DT_I8)
    return n == 8 && es == 2
               ? launch_pass<encode_block_kernel<int8_t, 8, 2>, float,
                             int8_t>(in, out, count, head, nv, n, es, st)
               : launch_pass<encode_block_kernel<int8_t, kRuntime, 0>, float,
                             int8_t>(in, out, count, head, nv, n, es, st);
  return n == 16 && es == 2
             ? launch_pass<encode_block_kernel<int16_t, 16, 2>, float,
                           int16_t>(in, out, count, head, nv, n, es, st)
             : launch_pass<encode_block_kernel<int16_t, kRuntime, 0>, float,
                           int16_t>(in, out, count, head, nv, n, es, st);
}

// f32 -> f32 decode(encode(x)) in Posit<n, es> (n <= 16), NaR as
// POSIT_NAN_BITS.
extern "C" int posit_round_trip_block(const void* in, void* out,
                                      long long count, long long head,
                                      long long nvec, int n, int es,
                                      void* stream) {
  if (count <= 0) return 0;
  if (!format_ok(n, es, DT_I16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!split_ok(count, head, nvec, in, out, 4))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned nv = static_cast<unsigned>(nvec);
  if (n == 16 && es == 2)
    return launch_pass<round_trip_kernel<16, 2>, float, float>(
        in, out, count, head, nv, n, es, st);
  if (n == 8 && es == 2)
    return launch_pass<round_trip_kernel<8, 2>, float, float>(
        in, out, count, head, nv, n, es, st);
  return launch_pass<round_trip_kernel<kRuntime, 0>, float, float>(
      in, out, count, head, nv, n, es, st);
}

extern "C" int posit_paged_append(const void* k, const void* v,
                                  const void* seq_lens, const void* num_new,
                                  const void* page_table, void* k_pages,
                                  void* v_pages, int B, int n_kv, int S, int D,
                                  int page, int W, int num_pages, int dtype,
                                  int n, int es, void* stream) {
  if (B <= 0 || n_kv <= 0 || S <= 0 || D <= 0) return 0;
  if (static_cast<long long>(B) * n_kv > 65535 ||
      static_cast<long long>(B) * n_kv * S * D >= (1LL << 40) ||
      static_cast<long long>(B) * W >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != DT_F32 && !format_ok(n, es, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int eb = dtype == DT_F32 ? 4 : dtype == DT_I16 ? 2 : 1;
  auto al = [](const void* p, uintptr_t b) {
    return reinterpret_cast<uintptr_t>(p) % b == 0;
  };
  const int vec = D % 4 == 0 && al(k, 16) && al(v, 16) &&
                  al(k_pages, 4 * eb) && al(v_pages, 4 * eb);
  int lpr = 1;
  while (lpr < 32 && 4 * lpr < D) lpr *= 2;
  const dim3 block(lpr, kThreads / lpr);
  const dim3 grid((S + block.y - 1) / block.y, B * n_kv);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const int* sl = static_cast<const int*>(seq_lens);
  const int* nn = static_cast<const int*>(num_new);
  const int* pt = static_cast<const int*>(page_table);
#define APPEND(T, N, ES)                                                     \
  paged_append_kernel<T, N, ES><<<grid, block, 0, st>>>(                     \
      kf, vf, sl, nn, pt, static_cast<T*>(k_pages), static_cast<T*>(v_pages), \
      n_kv, S, D, page, W, num_pages, vec, n, es)
  if (dtype == DT_F32)
    APPEND(float, kRuntime, 0);
  else if (dtype == DT_I8 && n == 8 && es == 2)
    APPEND(int8_t, 8, 2);
  else if (dtype == DT_I8)
    APPEND(int8_t, kRuntime, 0);
  else if (dtype == DT_I16 && n == 16 && es == 2)
    APPEND(int16_t, 16, 2);
  else if (dtype == DT_I16)
    APPEND(int16_t, kRuntime, 0);
  else
    return static_cast<int>(cudaErrorInvalidValue);
#undef APPEND
  return static_cast<int>(cudaGetLastError());
}
