// K12 and K13: the recurrent scans of the serving path, with the carried
// state posit-round-tripped after every token.
//
// K12 replaces repro/kernels/recurrent_scan.py::wkv_scan_pallas (:107;
// pallas_call :132, body _wkv_kernel :64): the RWKV6 WKV recurrence
//   y_t = r_t . S + (sum_d r_t u k_t) v_t,   S <- rt(diag(e^w_t) S + k_t^T v_t)
// over r/k/v/logw [B, H, T, dh] f32, u [H, dh], S [B, H, dh, dh].
// K13 replaces ::rglru_scan_pallas (:203; pallas_call :224, body
// _rglru_kernel :185): h_t = rt(a_t h + b_t) over a/b [B, T, d], h [B, d].
//
// State storage: int16/int8 posit bits of (n, es) (decoded once at load,
// the last live token's pattern stored as it is), or f32 (n > 0:
// round-tripped through (n, es) every token; n == 0: no round trip).
// num_new [B]: tokens t >= num_new[b] give y = 0 and leave the state
// alone; an idle slot (num_new = 0) gets back the bits it came with, copied.
//
// Exactness.  The state update is a product, a product and a sum, each
// rounded on its own (__fmul_rn / __fadd_rn, which nvcc never contracts
// into an FMA), and expf, the same libm function PyTorch's CUDA exp calls;
// the round trip below equals posit_decode(posit_encode(x)) on every f32
// input.  So the state equals the plain version's (torch.exp, *, +, the
// codec) bit for bit, and one last-bit difference can never flip a posit
// rounding and ride along in the state.  K12's y is a sum of per-thread
// fmaf chains combined by shuffles in a fixed order: within the f32
// dot-product bound of the plain version's einsum, and the same bits from
// run to run.
//
// Bound on an H100.  K12 reads r, k, v, logw and writes y once (20 B per
// head element per token); K13 moves 12 B per element per token: both
// byte-bound by that count.  Neither gets near it: the per-token round
// trip of every state element is integer work on a dependent chain.  K12 at
// rwkv6-3b's prefill chunk (B = 8, H = 40, dh = 64, T = 128) round-trips
// 168 M elements; at 21 instructions an element a token in its SASS
// (update, y term, the round trip's fast path and its branch) that is
// ~110 M warp instructions, ~0.1 ms at the card's full issue rate.
//
// The round trip (posit_rt).  Where the posit keeps every exponent bit and
// at least one fraction bit (te in [-(n-3-es) 2^es, (n-3-es) 2^es - 1]:
// P16_2 [-44, 43], P8_2 [-12, 11]), posit_encode rounds the f32 significand
// to nearest-even at the bit the regime's length fixes (its case A, the
// pattern's last bit being the fraction's), and decoding gives that value
// back.  That is one f32 addition and subtraction of M = sign(x) 2^(te+sh),
// sh the dropped bits: x + M rounds at ulp(M), ties to even, a carry into
// the exponent included, and (x + M) - M is exact.  Elsewhere (0, NaN, Inf,
// subnormals, the binades next to maxpos and minpos) it takes
// posit_decode(posit_encode(x)).  P16_2 and P8_2 are compile-time formats;
// any other n <= 16 takes the same code with (n, es) at run time.
//
// K12's design.  Column c of S evolves on its own (y_c and S[:, c] read
// only column c), and its 64 rows are split over kWkvR = 4 threads of one
// warp (16 rows each, lane = 8 q + column): a block is 32 columns of one
// (b, h), 128 threads, and rwkv6-3b's 8 x 40 heads give 640 blocks, 4.85 an
// SM against the 5 that fit (19 warps an SM; 320 blocks of 256 threads
// would leave SMs at 3 against an average of 2.4).  r, k, logw and v of
// kWkvTC = 16 tokens are staged by 16-byte cp.async (4-byte where dh % 4
// or the inputs' alignment forbids), double-buffered; one
// pass over a staged chunk takes e^w (expf once per (token, row)) and
// su_t = sum_d r u k (once per token, a warp's fixed butterfly), so a chunk
// costs three barriers, not two a token.  Per token a thread reads its 16
// rows of r, k and e^w as float4 (a quarter-warp reads one address), adds
// 16 r S terms, combines the four partial sums by xor shuffles 8 and 16,
// and updates its 16 elements.  The last live token of a posit state is
// encoded straight from the update, with no decode.
//
// K13's design.  A thread carries two channels (8-byte copies and stores
// where the width is even and the inputs aligned, else 4-byte),
// so two independent chains interleave; 128 threads a block give
// recurrentgemma-9b's 8 x 4,096 channels 128 blocks, one an SM.  a and b
// of the next kRgDepth tokens are in flight in a per-thread cp.async ring
// (32 KB an SM), read back by the thread that copied them, so no barrier.
#include <type_traits>

#include "posit_codec.cuh"

namespace {

constexpr int kDhMax = 64;          // K12: head_dim <= 64
constexpr int kWkvR = 4;            // K12: threads a column
constexpr int kWkvRows = 16;        // K12: state rows a thread
constexpr int kWkvCols = 32;        // K12: columns a block
constexpr int kWkvThreads = 128;    // K12: threads a block
constexpr int kWkvTC = 16;          // K12: tokens a staged chunk
constexpr int kWkvMinBlocks = 5;    // K12: blocks an SM (launch bounds)
constexpr int kWkvSmemBytes = 33152;  // K12: static shared memory a block
constexpr int kRgChannels = 2;      // K13: channels a thread
constexpr int kRgThreads = 128;     // K13: threads a block
constexpr int kRgDepth = 16;        // K13: tokens in flight a thread
constexpr int kRgSmemBytes = 32768;   // K13: static shared memory a block
static_assert(kWkvR * kWkvRows == kDhMax, "rows split over kWkvR threads");
static_assert(kWkvCols * kWkvR == kWkvThreads, "a block is kWkvCols columns");
static_assert(kWkvR == 4 && kWkvRows % 4 == 0, "lane = 8 q + column");
static_assert((kRgDepth & (kRgDepth - 1)) == 0, "ring slots by mask");

// Format template arguments: N = kNoRt, no round trip (f32 state);
// kRuntime, (n, es) from the kernel's arguments; else Posit<N, ES>.
constexpr int kNoRt = 0;
constexpr int kRuntime = -1;

// ---- the direct round trip ------------------------------------------------
__device__ __forceinline__ float rt_codec(float x, int n, int es) {
  return posit_decode(posit_encode(x, n, es), n, es);
}

// x -> decode(encode(x)) in Posit<n, es> (n <= 16), bit-identical to
// rt_codec on every f32 input; identity for kNoRt.
template <int N, int ES>
__device__ __forceinline__ float posit_rt(float x, int n_rt, int es_rt) {
  if constexpr (N == kNoRt) {
    return x;
  } else {
    const int n = N > 0 ? N : n_rt;
    const int es = N > 0 ? ES : es_rt;
    const int span = (n - 3 - es) * (1 << es);   // case A: te in [-span, span)
    const int lo = max(127 - span, 1);            // f32 normals only
    const int hi = min(126 + span, 232);          // ex + sh <= 254: M finite
    const uint32_t bits = __float_as_uint(x);
    const int ex = static_cast<int>((bits >> 23) & 0xFFu);
    if (__builtin_expect(hi < lo || static_cast<unsigned>(ex - lo) >
                                        static_cast<unsigned>(hi - lo), 0))
      return rt_codec(x, n, es);
    const int k = (ex - 127) >> es;               // the regime's k
    const int sh = 26 - n + es + (k ^ (k >> 31)); // 23 - fraction bits
    const float M = __uint_as_float((bits & 0xFF800000u) +
                                    (static_cast<uint32_t>(sh) << 23));
    return __fsub_rn(__fadd_rn(x, M), M);
  }
}

// ---- cp.async (sm_80+) ----------------------------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int P>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(P) : "memory");
}

// ---- K12 ------------------------------------------------------------------
enum { kR = 0, kK = 1, kE = 2, kV = 3 };   // staged inputs (kE: logw, then e^w)

struct WkvSmem {
  float stage[2][4][kWkvTC][kDhMax];   // [buffer][input][token][row or column]
  float su[2][kWkvTC];
  float u[kDhMax];
};
static_assert(sizeof(WkvSmem) == kWkvSmemBytes, "kWkvSmemBytes");

// Tokens [t0, t0 + ntok) of one (b, h) into buffer `buf`: each input's rows
// are one contiguous run of ntok * dh floats, copied 16 bytes at a time
// when `vec` (dh % 4 == 0 and 16-byte aligned inputs; always in the kFull
// instance), else 4.
template <bool kFull>
__device__ __forceinline__ void wkv_stage(WkvSmem& sm, int buf,
                                          const float* const (&src)[4],
                                          int t0, int ntok, int dh, bool vec,
                                          int tid) {
  const int DH = kFull ? kDhMax : dh;
  const int count = ntok * DH;
  if (kFull || vec) {
    for (int a = 0; a < 4; ++a)
      for (int f = 4 * tid; f < count; f += 4 * kWkvThreads) {
        const int t = f / DH, d = f - t * DH;
        cp_async16(&sm.stage[buf][a][t][d],
                   src[a] + static_cast<size_t>(t0) * DH + f);
      }
  } else {
    for (int a = 0; a < 4; ++a)
      for (int f = tid; f < count; f += kWkvThreads) {
        const int t = f / DH, d = f - t * DH;
        cp_async4(&sm.stage[buf][a][t][d],
                  src[a] + static_cast<size_t>(t0) * DH + f);
      }
  }
}

// One token of one thread: its partial r . S over rows d0 .. d0 + 15 (an
// fmaf chain in row order, the pre-update S), and the update of those rows;
// kLast (the last live token of a posit state) leaves each row's pattern,
// encoded straight from the update, in S's bits.
template <int N, int ES, bool kFull, bool kLast>
__device__ __forceinline__ float wkv_token(float (&S)[kWkvRows],
                                           const float* const (&rke)[3],
                                           float vc, int d0, int dh, bool col,
                                           int n, int es) {
  float acc = 0.0f;
#pragma unroll
  for (int g = 0; g < kWkvRows / 4; ++g) {
    const float4 rv = reinterpret_cast<const float4*>(rke[0])[g];
    const float4 kv = reinterpret_cast<const float4*>(rke[1])[g];
    const float4 ev = reinterpret_cast<const float4*>(rke[2])[g];
    const float rg[4] = {rv.x, rv.y, rv.z, rv.w};
    const float kg[4] = {kv.x, kv.y, kv.z, kv.w};
    const float eg[4] = {ev.x, ev.y, ev.z, ev.w};
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int i = 4 * g + m;
      acc = fmaf(rg[m], S[i], acc);
      if (kFull || (col && d0 + i < dh)) {
        const float x =
            __fadd_rn(__fmul_rn(eg[m], S[i]), __fmul_rn(kg[m], vc));
        if constexpr (kLast)
          S[i] = __int_as_float(posit_encode(x, n, es));
        else
          S[i] = posit_rt<N, ES>(x, n, es);
      }
    }
  }
  return acc;
}

template <typename ST, int N, int ES, bool kFull>
__global__ void __launch_bounds__(kWkvThreads, kWkvMinBlocks) wkv_scan_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ logw,
    const float* __restrict__ u, const ST* __restrict__ s0,
    const int* __restrict__ num_new, float* __restrict__ y,
    ST* __restrict__ s_out, int H, int T_len, int dh_rt, int vec, int n_rt,
    int es_rt) {
  constexpr bool kPosit = !std::is_same<ST, float>::value;
  __shared__ __align__(16) WkvSmem sm;
  const int dh = kFull ? kDhMax : dh_rt;
  const int n = N > 0 ? N : n_rt, es = N > 0 ? ES : es_rt;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = lane >> 3, d0 = q * kWkvRows;     // rows d0 .. d0 + 15
  const int c = blockIdx.x * kWkvCols + warp * 8 + (lane & 7);
  const int h = blockIdx.y, b = blockIdx.z;
  const bool col = kFull || c < dh;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t sbase = bh * dh * dh, tbase = bh * T_len * dh;
  const int live = min(max(num_new[b], 0), T_len);

  if (live == 0) {                    // idle: the state's bits as they came
    if (col) {
#pragma unroll
      for (int i = 0; i < kWkvRows; ++i)
        if (kFull || d0 + i < dh) {
          const size_t o = sbase + static_cast<size_t>(d0 + i) * dh + c;
          s_out[o] = s0[o];
        }
      for (int t = q; t < T_len; t += kWkvR)
        y[tbase + static_cast<size_t>(t) * dh + c] = 0.0f;
    }
    return;
  }

  const float* const src[4] = {r + tbase, k + tbase, logw + tbase,
                               v + tbase};
  const int nch = (live + kWkvTC - 1) / kWkvTC;
  if (!kFull) {                       // rows and columns past dh read as 0
    for (int i = tid; i < 2 * 4 * kWkvTC * kDhMax; i += kWkvThreads)
      if ((i & (kDhMax - 1)) >= dh) (&sm.stage[0][0][0][0])[i] = 0.0f;
  }
  wkv_stage<kFull>(sm, 0, src, 0, min(kWkvTC, live), dh, vec, tid);
  cp_async_commit();
  if (nch > 1)
    wkv_stage<kFull>(sm, 1, src, kWkvTC, min(kWkvTC, live - kWkvTC), dh,
                     vec, tid);
  cp_async_commit();
  if (tid < kDhMax) sm.u[tid] = tid < dh ? u[h * dh + tid] : 0.0f;

  float S[kWkvRows];                  // S[d0 + i][c], decoded once
#pragma unroll
  for (int i = 0; i < kWkvRows; ++i)
    S[i] = (col && (kFull || d0 + i < dh))
               ? load_value<ST>(s0, sbase + static_cast<size_t>(d0 + i) * dh
                                        + c, n, es)
               : 0.0f;

  for (int j = 0; j < nch; ++j) {
    const int buf = j & 1, t0 = j * kWkvTC, ntok = min(kWkvTC, live - t0);
    cp_async_wait<1>();               // every group but the newest: chunk j
    __syncthreads();
    // e^w in place, once per (token, row); su_t, a warp a token
    for (int i = tid; i < ntok * kDhMax; i += kWkvThreads)
      if (kFull || (i & (kDhMax - 1)) < dh) {
        float& e = sm.stage[buf][kE][i / kDhMax][i & (kDhMax - 1)];
        e = expf(e);
      }
    for (int t = warp; t < ntok; t += kWkvThreads / 32) {
      const float* rr = sm.stage[buf][kR][t];
      const float* kk = sm.stage[buf][kK][t];
      float p = rr[lane] * sm.u[lane] * kk[lane];
      p = fmaf(rr[lane + 32] * sm.u[lane + 32], kk[lane + 32], p);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, o);
      if (lane == 0) sm.su[buf][t] = p;
    }
    __syncthreads();

    for (int tt = 0; tt < ntok; ++tt) {
      const int t = t0 + tt;
      const float vc = sm.stage[buf][kV][tt][c & (kDhMax - 1)];
      const float* rkev[3] = {sm.stage[buf][kR][tt] + d0,
                              sm.stage[buf][kK][tt] + d0,
                              sm.stage[buf][kE][tt] + d0};
      float acc = (kPosit && t == live - 1)
                      ? wkv_token<N, ES, kFull, true>(S, rkev, vc, d0, dh,
                                                      col, n, es)
                      : wkv_token<N, ES, kFull, false>(S, rkev, vc, d0, dh,
                                                       col, n, es);
      acc += __shfl_xor_sync(0xffffffffu, acc, 8);
      acc += __shfl_xor_sync(0xffffffffu, acc, 16);
      if (q == 0 && col)
        y[tbase + static_cast<size_t>(t) * dh + c] =
            acc + sm.su[buf][tt] * vc;
    }
    __syncthreads();                  // every thread is done with `buf`
    if (j + 2 < nch)
      wkv_stage<kFull>(sm, buf, src, t0 + 2 * kWkvTC,
                       min(kWkvTC, live - t0 - 2 * kWkvTC), dh, vec, tid);
    cp_async_commit();
  }

  if (col) {
    for (int t = live + q; t < T_len; t += kWkvR)
      y[tbase + static_cast<size_t>(t) * dh + c] = 0.0f;
#pragma unroll
    for (int i = 0; i < kWkvRows; ++i)
      if (kFull || d0 + i < dh) {
        const size_t o = sbase + static_cast<size_t>(d0 + i) * dh + c;
        if constexpr (kPosit)
          s_out[o] = static_cast<ST>(__float_as_int(S[i]));  // the pattern
        else
          s_out[o] = S[i];
      }
  }
}

// ---- K13 ------------------------------------------------------------------
template <typename ST, int N, int ES>
__global__ void __launch_bounds__(kRgThreads) rglru_scan_kernel(
    const float* __restrict__ a, const float* __restrict__ bv,
    const ST* __restrict__ h0, const int* __restrict__ num_new,
    float* __restrict__ y, ST* __restrict__ h_out, int T_len, int d,
    int vec, int n_rt, int es_rt) {
  __shared__ __align__(16) float2 ring[kRgDepth][2][kRgThreads];
  static_assert(sizeof(ring) == kRgSmemBytes, "kRgSmemBytes");
  const int n = N > 0 ? N : n_rt, es = N > 0 ? ES : es_rt;
  const int tid = threadIdx.x;
  const int c0 = (blockIdx.x * kRgThreads + tid) * kRgChannels;
  const int b = blockIdx.y;
  if (c0 >= d) return;                // no barrier below
  const bool two = c0 + 1 < d;        // vec: 8-byte copies and stores
  const int live = min(max(num_new[b], 0), T_len);
  const size_t hb = static_cast<size_t>(b) * d + c0;
  const size_t base = static_cast<size_t>(b) * T_len * d + c0;

  if (live == 0) {                    // idle: the state's bits as they came
    h_out[hb] = h0[hb];
    if (two) h_out[hb + 1] = h0[hb + 1];
    for (int t = 0; t < T_len; ++t) {
      y[base + static_cast<size_t>(t) * d] = 0.0f;
      if (two) y[base + static_cast<size_t>(t) * d + 1] = 0.0f;
    }
    return;
  }

  auto issue = [&](int t) {           // token t's a and b into its slot
    const size_t o = base + static_cast<size_t>(t) * d;
    float2* sa = &ring[t & (kRgDepth - 1)][0][tid];
    float2* sb = &ring[t & (kRgDepth - 1)][1][tid];
    if (vec) {
      cp_async8(sa, a + o);
      cp_async8(sb, bv + o);
    } else {
      cp_async4(&sa->x, a + o);
      cp_async4(&sb->x, bv + o);
      if (two) {
        cp_async4(&sa->y, a + o + 1);
        cp_async4(&sb->y, bv + o + 1);
      }
    }
  };
  const int ahead = min(live, kRgDepth);  // a group a token, in order
#pragma unroll 1
  for (int t = 0; t < ahead; ++t) {
    issue(t);
    cp_async_commit();
  }
  float h_a = load_value<ST>(h0, hb, n, es);
  float h_b = two ? load_value<ST>(h0, hb + 1, n, es) : 0.0f;

  if (ahead < kRgDepth) cp_async_wait<0>();   // a short run has landed
  for (int t = 0; t < live; ++t) {
    cp_async_wait<kRgDepth - 1>();    // token t's group has landed
    const float2 at = ring[t & (kRgDepth - 1)][0][tid];
    const float2 bt = ring[t & (kRgDepth - 1)][1][tid];
    h_a = posit_rt<N, ES>(__fadd_rn(__fmul_rn(at.x, h_a), bt.x), n, es);
    h_b = posit_rt<N, ES>(__fadd_rn(__fmul_rn(at.y, h_b), bt.y), n, es);
    const size_t o = base + static_cast<size_t>(t) * d;
    if (vec) {
      *reinterpret_cast<float2*>(y + o) = make_float2(h_a, h_b);
    } else {
      y[o] = h_a;
      if (two) y[o + 1] = h_b;
    }
    if (t + kRgDepth < live) issue(t + kRgDepth);   // after its slot's read
    cp_async_commit();
  }
  for (int t = live; t < T_len; ++t) {
    y[base + static_cast<size_t>(t) * d] = 0.0f;
    if (two) y[base + static_cast<size_t>(t) * d + 1] = 0.0f;
  }
  h_out[hb] = store_value<ST>(h_a, n, es);
  if (two) h_out[hb + 1] = store_value<ST>(h_b, n, es);
}

// ---- the exhaustive check of posit_rt -------------------------------------
// Every f32 bit pattern through posit_rt<N, ES> and rt_codec (runtime n,
// es): out[0] += mismatches, out[1] = min(first mismatching pattern).
template <int N, int ES>
__global__ void __launch_bounds__(256) rt_check_kernel(
    int n, int es, unsigned long long* __restrict__ out) {
  unsigned long long bad = 0, first = ~0ull;
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
       i < (1ull << 32); i += stride) {
    const float x = __uint_as_float(static_cast<uint32_t>(i));
    if (__float_as_uint(posit_rt<N, ES>(x, n, es)) !=
        __float_as_uint(rt_codec(x, n, es))) {
      ++bad;
      first = min(first, static_cast<unsigned long long>(i));
    }
  }
  if (bad) {
    atomicAdd(&out[0], bad);
    atomicMin(&out[1], first);
  }
}

// Every pointer a multiple of `bytes`: the vector copies' condition.
template <typename... P>
bool aligned(uintptr_t bytes, const P*... p) {
  return ((reinterpret_cast<uintptr_t>(p) % bytes == 0) && ...);
}

// Format dispatch: P16_2 and P8_2 compile-time, any other (n, es) at run
// time, n == 0 no round trip (f32 state only).
template <typename ST, template <typename, int, int> class L, typename... A>
int by_format(int n, int es, A... args) {
  if constexpr (std::is_same<ST, float>::value) {
    if (n == 0) return L<ST, kNoRt, 0>::run(args...);
  }
  if constexpr (!std::is_same<ST, int8_t>::value) {
    if (n == 16 && es == 2) return L<ST, 16, 2>::run(args...);
  }
  if constexpr (!std::is_same<ST, int16_t>::value) {
    if (n == 8 && es == 2) return L<ST, 8, 2>::run(args...);
  }
  return L<ST, kRuntime, 0>::run(args...);
}

template <typename ST, int N, int ES>
struct LaunchWkv {
  static int run(const float* r, const float* k, const float* v,
                 const float* logw, const float* u, const void* s0,
                 const int* nn, float* y, void* s_out, int B, int H,
                 int T_len, int dh, int n, int es, cudaStream_t st) {
    dim3 grid((dh + kWkvCols - 1) / kWkvCols, H, B);
    const int vec = dh % 4 == 0 && aligned(16, r, k, v, logw);
    if (dh == kDhMax && vec)
      wkv_scan_kernel<ST, N, ES, true><<<grid, kWkvThreads, 0, st>>>(
          r, k, v, logw, u, static_cast<const ST*>(s0), nn, y,
          static_cast<ST*>(s_out), H, T_len, dh, vec, n, es);
    else
      wkv_scan_kernel<ST, N, ES, false><<<grid, kWkvThreads, 0, st>>>(
          r, k, v, logw, u, static_cast<const ST*>(s0), nn, y,
          static_cast<ST*>(s_out), H, T_len, dh, vec, n, es);
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename ST, int N, int ES>
struct LaunchRglru {
  static int run(const float* a, const float* b, const void* h0,
                 const int* nn, float* y, void* h_out, int B, int T_len,
                 int d, int n, int es, cudaStream_t st) {
    const int per_block = kRgThreads * kRgChannels;
    dim3 grid((d + per_block - 1) / per_block, B);
    const int vec = d % 2 == 0 && aligned(8, a, b, y);
    rglru_scan_kernel<ST, N, ES><<<grid, kRgThreads, 0, st>>>(
        a, b, static_cast<const ST*>(h0), nn, y, static_cast<ST*>(h_out),
        T_len, d, vec, n, es);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// K12.  y [B,H,T,dh] f32; s0 and s_out [B,H,dh,dh] of `dtype` (0 f32,
// 1 int8, 2 int16 posit of (n, es)); n == 0: f32 state, no round trip.
extern "C" int wkv_scan(const void* r, const void* k, const void* v,
                        const void* logw, const void* u, const void* s0,
                        const void* num_new, void* y, void* s_out, int B,
                        int H, int T_len, int dh, int dtype, int n, int es,
                        void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (dh <= 0 || dh > kDhMax || n < 0 || n > 16 ||
      (dtype != DT_F32 && n == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* rf = static_cast<const float*>(r);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* wf = static_cast<const float*>(logw);
  const float* uf = static_cast<const float*>(u);
  const int* nn = static_cast<const int*>(num_new);
  float* yf = static_cast<float*>(y);
  if (dtype == DT_F32)
    return by_format<float, LaunchWkv>(n, es, rf, kf, vf, wf, uf, s0, nn, yf,
                                       s_out, B, H, T_len, dh, n, es, st);
  if (dtype == DT_I8)
    return by_format<int8_t, LaunchWkv>(n, es, rf, kf, vf, wf, uf, s0, nn,
                                        yf, s_out, B, H, T_len, dh, n, es,
                                        st);
  if (dtype == DT_I16)
    return by_format<int16_t, LaunchWkv>(n, es, rf, kf, vf, wf, uf, s0, nn,
                                         yf, s_out, B, H, T_len, dh, n, es,
                                         st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K13.  h_seq [B,T,d] f32; h0 and h_out [B,d] of `dtype`, as for K12.
extern "C" int rglru_scan(const void* a, const void* b, const void* h0,
                          const void* num_new, void* h_seq, void* h_out,
                          int B, int T_len, int d, int dtype, int n, int es,
                          void* stream) {
  if (B <= 0 || d <= 0) return 0;
  if (n < 0 || n > 16 || (dtype != DT_F32 && n == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  const int* nn = static_cast<const int*>(num_new);
  float* yf = static_cast<float*>(h_seq);
  if (dtype == DT_F32)
    return by_format<float, LaunchRglru>(n, es, af, bf, h0, nn, yf, h_out,
                                         B, T_len, d, n, es, st);
  if (dtype == DT_I8)
    return by_format<int8_t, LaunchRglru>(n, es, af, bf, h0, nn, yf, h_out,
                                          B, T_len, d, n, es, st);
  if (dtype == DT_I16)
    return by_format<int16_t, LaunchRglru>(n, es, af, bf, h0, nn, yf, h_out,
                                           B, T_len, d, n, es, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// posit_rt against posit_decode(posit_encode()) over all 2^32 f32 patterns
// in Posit<n, es> (1 < n <= 16): the compile-time instance (P16_2, P8_2)
// when `specialised`, else the runtime one.  out [2] u64, set by the
// caller to {0, ~0}: the mismatch count and the least mismatching pattern.
extern "C" int posit_rt_check(int n, int es, int specialised, void* out,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<unsigned long long*>(out);
  if (n < 2 || n > 16 || es < 0 || es > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = 132 * 8;
  if (!specialised)
    rt_check_kernel<kRuntime, 0><<<blocks, 256, 0, st>>>(n, es, o);
  else if (n == 16 && es == 2)
    rt_check_kernel<16, 2><<<blocks, 256, 0, st>>>(n, es, o);
  else if (n == 8 && es == 2)
    rt_check_kernel<8, 2><<<blocks, 256, 0, st>>>(n, es, o);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
