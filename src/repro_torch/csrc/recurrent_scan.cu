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
// State storage: int16/int8 posit bits of (n, es) (decoded once at t = 0,
// encoded once at the end), or f32 (n > 0: round-tripped through (n, es)
// every token; n == 0: no round trip).  num_new [B]: tokens t >= num_new[b]
// give y = 0 and leave the state alone, so an idle slot (num_new = 0) gets
// back exactly the bits it came with (decode/encode is the identity on
// every posit pattern).
//
// Exactness.  The state update is a product, a product and a sum, each
// rounded on its own (__fmul_rn / __fadd_rn, which nvcc never contracts
// into an FMA), and expf, the same libm function PyTorch's CUDA exp calls;
// so the state equals the plain version's (torch.exp, *, +) bit for bit, and
// one last-bit difference can never flip a posit rounding and ride along in
// the state.  y's dot products are fmaf chains in d order: within the f32
// dot-product bound of the plain version's einsum.
//
// Bound on an H100.  K12 reads r, k, v, logw and writes y once (20 B per
// head element per token) and does ~4 dh flops per element per token (the
// y dot product and the update): at dh = 64 that is ~13 flops per byte, so
// at a prefill chunk the f32 rate and at decode (T = 1) the state's bytes
// bound it.  K13 moves 12 B per element per token for 2 flops: bytes.
//
// Design.  The TPU grid walked T as a sequential axis, carrying S in VMEM.
// Here column v of S evolves on its own (y_v and S[:, v] read only column
// v), so one thread owns one column of one (b, h) in registers and loops
// over T inside the block: no reduction across threads, no atomics.  Per
// token the block stages r, k and e^w in shared memory (each read by every
// thread: a broadcast); su = sum r u k is computed by every thread in the
// same order.  K13 is one thread per (b, channel), elementwise.
#include "posit_codec.cuh"

namespace {

constexpr int kDhMax = 64;             // K12: head_dim <= 64
constexpr int kRgThreads = 256;        // K13: channels per block

// x -> decode(encode(x)) in Posit<n, es>; identity when n == 0.
__device__ __forceinline__ float round_trip(float x, int n, int es) {
  return n > 0 ? posit_decode(posit_encode(x, n, es), n, es) : x;
}

template <typename T>
__global__ void __launch_bounds__(kDhMax) wkv_scan_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ logw,
    const float* __restrict__ u, const T* __restrict__ s0,
    const int* __restrict__ num_new, float* __restrict__ y,
    T* __restrict__ s_out, int H, int T_len, int dh, int n, int es) {
  __shared__ float r_s[kDhMax], k_s[kDhMax], e_s[kDhMax], u_s[kDhMax];
  const int h = blockIdx.x, b = blockIdx.y, c = threadIdx.x;  // c: column
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t sbase = bh * dh * dh;
  float S[kDhMax];
#pragma unroll
  for (int d = 0; d < kDhMax; ++d)
    S[d] = d < dh ? load_value<T>(s0, sbase + static_cast<size_t>(d) * dh + c,
                                  n, es)
                  : 0.0f;
  u_s[c] = u[h * dh + c];
  const int live = min(max(num_new[b], 0), T_len);
  const size_t tbase = bh * T_len * dh;
  for (int t = 0; t < live; ++t) {
    const size_t o = tbase + static_cast<size_t>(t) * dh;
    __syncthreads();                   // the previous token's reads are done
    r_s[c] = r[o + c];
    k_s[c] = k[o + c];
    e_s[c] = expf(logw[o + c]);
    __syncthreads();
    const float vc = v[o + c];
    float su = 0.0f, acc = 0.0f;
#pragma unroll
    for (int d = 0; d < kDhMax; ++d) {
      if (d < dh) {
        su = fmaf(r_s[d] * u_s[d], k_s[d], su);
        acc = fmaf(r_s[d], S[d], acc);
      }
    }
    y[o + c] = acc + su * vc;
#pragma unroll
    for (int d = 0; d < kDhMax; ++d) {
      if (d < dh)
        S[d] = round_trip(
            __fadd_rn(__fmul_rn(e_s[d], S[d]), __fmul_rn(k_s[d], vc)), n,
            es);
    }
  }
  for (int t = live; t < T_len; ++t)
    y[tbase + static_cast<size_t>(t) * dh + c] = 0.0f;
#pragma unroll
  for (int d = 0; d < kDhMax; ++d)
    if (d < dh)
      s_out[sbase + static_cast<size_t>(d) * dh + c] =
          store_value<T>(S[d], n, es);
}

template <typename T>
__global__ void __launch_bounds__(kRgThreads) rglru_scan_kernel(
    const float* __restrict__ a, const float* __restrict__ bv,
    const T* __restrict__ h0, const int* __restrict__ num_new,
    float* __restrict__ y, T* __restrict__ h_out, int T_len, int d, int n,
    int es) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (c >= d) return;
  const size_t hb = static_cast<size_t>(b) * d + c;
  float h = load_value<T>(h0, hb, n, es);
  const int live = min(max(num_new[b], 0), T_len);
  const size_t base = static_cast<size_t>(b) * T_len * d + c;
  for (int t = 0; t < live; ++t) {
    const size_t o = base + static_cast<size_t>(t) * d;
    h = round_trip(__fadd_rn(__fmul_rn(a[o], h), bv[o]), n, es);
    y[o] = h;
  }
  for (int t = live; t < T_len; ++t)
    y[base + static_cast<size_t>(t) * d] = 0.0f;
  h_out[hb] = store_value<T>(h, n, es);
}

template <typename T>
int launch_wkv(const float* r, const float* k, const float* v,
               const float* logw, const float* u, const void* s0,
               const int* nn, float* y, void* s_out, int B, int H, int T_len,
               int dh, int n, int es, cudaStream_t st) {
  dim3 grid(H, B);
  wkv_scan_kernel<T><<<grid, dh, 0, st>>>(
      r, k, v, logw, u, static_cast<const T*>(s0), nn, y,
      static_cast<T*>(s_out), H, T_len, dh, n, es);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rglru(const float* a, const float* b, const void* h0,
                 const int* nn, float* y, void* h_out, int B, int T_len,
                 int d, int n, int es, cudaStream_t st) {
  dim3 grid((d + kRgThreads - 1) / kRgThreads, B);
  rglru_scan_kernel<T><<<grid, kRgThreads, 0, st>>>(
      a, b, static_cast<const T*>(h0), nn, y, static_cast<T*>(h_out), T_len,
      d, n, es);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K12.  y [B,H,T,dh] f32; s0 and s_out [B,H,dh,dh] of `dtype` (0 f32,
// 1 int8, 2 int16 posit of (n, es)); n == 0: f32 state, no round trip.
extern "C" int wkv_scan(const void* r, const void* k, const void* v,
                        const void* logw, const void* u, const void* s0,
                        const void* num_new, void* y, void* s_out, int B,
                        int H, int T_len, int dh, int dtype, int n, int es,
                        void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (dh <= 0 || dh > kDhMax || (dtype != DT_F32 && n <= 0))
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
    return launch_wkv<float>(rf, kf, vf, wf, uf, s0, nn, yf, s_out, B, H,
                             T_len, dh, n, es, st);
  if (dtype == DT_I8)
    return launch_wkv<int8_t>(rf, kf, vf, wf, uf, s0, nn, yf, s_out, B, H,
                              T_len, dh, n, es, st);
  if (dtype == DT_I16)
    return launch_wkv<int16_t>(rf, kf, vf, wf, uf, s0, nn, yf, s_out, B, H,
                               T_len, dh, n, es, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K13.  h_seq [B,T,d] f32; h0 and h_out [B,d] of `dtype`, as for K12.
extern "C" int rglru_scan(const void* a, const void* b, const void* h0,
                          const void* num_new, void* h_seq, void* h_out,
                          int B, int T_len, int d, int dtype, int n, int es,
                          void* stream) {
  if (B <= 0 || d <= 0) return 0;
  if (dtype != DT_F32 && n <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  const int* nn = static_cast<const int*>(num_new);
  float* yf = static_cast<float*>(h_seq);
  if (dtype == DT_F32)
    return launch_rglru<float>(af, bf, h0, nn, yf, h_out, B, T_len, d, n, es,
                               st);
  if (dtype == DT_I8)
    return launch_rglru<int8_t>(af, bf, h0, nn, yf, h_out, B, T_len, d, n,
                                es, st);
  if (dtype == DT_I16)
    return launch_rglru<int16_t>(af, bf, h0, nn, yf, h_out, B, T_len, d, n,
                                 es, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
