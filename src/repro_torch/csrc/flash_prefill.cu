// K7-K9: flash attention over a contiguous KV cache: the forward with the
// row log-sum-exp (K7), and the two passes of its backward, dQ (K8) and
// dK/dV (K9).  The training forward and backward of every attention layer.
//
// K7 replaces repro/kernels/flash_attention.py::flash_prefill_contiguous
// (:332; pallas_call :404, body _prefill_body :153, return_lse).  K8
// replaces the dQ pass of ::flash_prefill_bwd_contiguous (:552; pallas_call
// :598, body _prefill_bwd_dq_body :448) and K9 its dK/dV pass (pallas_call
// :626, body _prefill_bwd_dkv_body :497), both with _bwd_probs' masks.
//
// Layout: q, o, dO [B, H, Sq, D] f32; k, v [B, n_kv, Skv, D] (f32, or
// int8/int16 posit for K7 and K8); lse and delta [B, H, Sq] f32; kv_len and
// q_offset [B] int32.  Query row r of sequence b sits at position
// q_offset[b] + r and sees key positions kpos < kv_len[b], kpos <= qpos
// when causal, qpos - kpos < window when window > 0.  GQA: query head hq
// reads kv head hq / G, G = H / n_kv.  Scores are q.k * D^-0.5, then
// tanh-capped when softcap > 0.
//
// Bound on an H100.  Every kernel does O(Sq * Skv * D) flops per head on
// O((Sq + Skv) * D) bytes: at the training shapes (512 x 512, D = 64) that
// is thousands of flops per byte, so f32 FFMA throughput bounds them.  No
// tensor cores: TF32 would round the f32 activations the reference
// multiplies exactly (the same reason as the GEMM).
//
// Design.  The TPU grid carried the online-softmax state (or the dQ / dK dV
// accumulators) across its sequential kv (or q) axis in VMEM.  Here each
// block owns one output tile and loops over the other axis itself:
//   K7, K8: one block per (32-query tile, kv head, sequence), one thread
//     per query row of the G heads of the group (G * 32 threads); q, the
//     accumulator (and dO for K8) live in registers; the block decodes each
//     32-key tile of K and V into shared memory once for all G heads.  The
//     loop visits only the key tiles some row of the block may see (causal
//     and window cut it), and each row skips the keys its masks exclude,
//     so masked scores are never computed.  K7 keeps the online softmax
//     (scores of the tile in shared memory, one column per thread); K8
//     rebuilds p = exp(s - lse) from the saved lse.
//   K9: one block per (64-key tile, kv head, sequence), one thread per key,
//     with dK and dV in registers and K, V stored transposed in shared
//     memory (each thread reads its own column, conflict-free).  It sweeps
//     the query rows of all G heads of the group in 16-row tiles staged in
//     shared memory (each value read by the whole block: a broadcast), only
//     the rows that can see the tile (q >= k under causal, the window).
//     Summing over the G heads inside the thread is the GQA group-sum: no
//     atomics, so every kernel here is deterministic run to run.
// A row that sees no key gets out = 0 and lse = 0 (l == 0), and dQ = 0.
// Dot products keep four partial sums (D % 4 == 0) for instruction-level
// parallelism.
#include "posit_codec.cuh"

namespace {

constexpr float kNeg = -1e30f;        // repro's _NEG
constexpr int BQ = 32;                // query rows per head per block (K7, K8)
constexpr int BK = 32;                // keys per shared tile (K7, K8)
constexpr int BKV = 64;               // keys per block, one thread each (K9)
constexpr int BR = 16;                // query rows per shared tile (K9)

// dot(r, s) over d < D: r in registers, s contiguous (a broadcast read).
template <int DMAX>
__device__ __forceinline__ float dot_rs(const float (&r)[DMAX],
                                        const float* s, int D) {
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll
  for (int d = 0; d < DMAX; d += 4) {
    if (d < D) {
      a0 = fmaf(r[d], s[d], a0);
      a1 = fmaf(r[d + 1], s[d + 1], a1);
      a2 = fmaf(r[d + 2], s[d + 2], a2);
      a3 = fmaf(r[d + 3], s[d + 3], a3);
    }
  }
  return (a0 + a1) + (a2 + a3);
}

// dot(a, b) over d < D: a contiguous, b strided by `stride`.
template <int DMAX>
__device__ __forceinline__ float dot_ss(const float* a, const float* b,
                                        int stride, int D) {
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll
  for (int d = 0; d < DMAX; d += 4) {
    if (d < D) {
      a0 = fmaf(a[d], b[d * stride], a0);
      a1 = fmaf(a[d + 1], b[(d + 1) * stride], a1);
      a2 = fmaf(a[d + 2], b[(d + 2) * stride], a2);
      a3 = fmaf(a[d + 3], b[(d + 3) * stride], a3);
    }
  }
  return (a0 + a1) + (a2 + a3);
}

// Keys [lo, hi) of the tile at j0 that the row at qpos sees.
__device__ __forceinline__ void row_keys(int j0, int kl, int qpos, int causal,
                                         int window, bool live, int* lo,
                                         int* hi) {
  int a = j0, z = min(j0 + BK, kl);
  if (causal) z = min(z, qpos + 1);
  if (window > 0) a = max(a, qpos - window + 1);
  *lo = a;
  *hi = live ? z : a;
}

// Key range [*lo, *hi) any row of the query tile qt may see.
__device__ __forceinline__ void tile_keys(int qo, int qt, int Sq, int kl,
                                          int causal, int window, int* lo,
                                          int* hi) {
  const int q_first = qo + qt * BQ;
  const int q_last = qo + min(qt * BQ + BQ, Sq) - 1;
  *hi = causal ? min(kl, q_last + 1) : kl;
  *lo = window > 0 ? max(0, q_first - window + 1) : 0;
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

// ---- K7: forward, online softmax, optional lse --------------------------
// Shared memory: k [BK*D], v [BK*D], s [BK*threads].
template <typename T, int DMAX>
__global__ void flash_fwd_kernel(
    const float* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ kv_len,
    const int* __restrict__ q_offset, float* __restrict__ out,
    float* __restrict__ lse, int H, int n_kv, int Sq, int Skv, int D,
    int causal, int window, float softcap, float scale, int n, int es) {
  extern __shared__ float smem[];
  const int G = H / n_kv;
  const int nt = blockDim.x;                     // == G * BQ
  const int tid = threadIdx.x;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  float* k_s = smem;
  float* v_s = k_s + BK * D;
  float* s_s = v_s + BK * D;                     // [BK][nt]

  const int row = qt * BQ + tid % BQ;
  const int head = h * G + tid / BQ;
  const bool live = row < Sq;
  const int qo = q_offset[b];
  const int qpos = qo + row;
  const int kl = min(kv_len[b], Skv);
  const size_t ridx = (static_cast<size_t>(b) * H + head) * Sq + row;

  float qr[DMAX], acc[DMAX];
#pragma unroll
  for (int d = 0; d < DMAX; ++d) {
    qr[d] = (live && d < D) ? q[ridx * D + d] : 0.0f;
    acc[d] = 0.0f;
  }
  float m = kNeg, l = 0.0f;

  int kv_lo, kv_hi;
  tile_keys(qo, qt, Sq, kl, causal, window, &kv_lo, &kv_hi);
  const size_t kvbase = (static_cast<size_t>(b) * n_kv + h) * Skv * D;
  for (int j0 = (kv_lo / BK) * BK; j0 < kv_hi; j0 += BK) {
    const int nkd = min(kv_hi - j0, BK) * D;
    for (int i = tid; i < nkd; i += nt) {
      k_s[i] = load_value<T>(k, kvbase + static_cast<size_t>(j0) * D + i, n,
                             es);
      v_s[i] = load_value<T>(v, kvbase + static_cast<size_t>(j0) * D + i, n,
                             es);
    }
    __syncthreads();
    int lo, hi;
    row_keys(j0, kl, qpos, causal, window, live, &lo, &hi);
    const int p_lo = lo - j0, p_hi = hi - j0;
    if (p_lo < p_hi) {
      float mx = m;
      for (int p = p_lo; p < p_hi; ++p) {
        float dcap;
        const float s = cap_score(dot_rs<DMAX>(qr, k_s + p * D, D), scale,
                                  softcap, &dcap);
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
      if (d < D) out[ridx * D + d] = acc[d] * inv;
    if (lse != nullptr) lse[ridx] = l > 0.0f ? m + logf(l) : 0.0f;
  }
}

// ---- K8: dQ --------------------------------------------------------------
// Shared memory: k [BK*D], v [BK*D].
template <typename T, int DMAX>
__global__ void flash_bwd_dq_kernel(
    const float* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ kv_len, const int* __restrict__ q_offset,
    float* __restrict__ dq, int H, int n_kv, int Sq, int Skv, int D,
    int causal, int window, float softcap, float scale, int n, int es) {
  extern __shared__ float smem[];
  const int G = H / n_kv;
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  float* k_s = smem;
  float* v_s = k_s + BK * D;

  const int row = qt * BQ + tid % BQ;
  const int head = h * G + tid / BQ;
  const bool live = row < Sq;
  const int qo = q_offset[b];
  const int qpos = qo + row;
  const int kl = min(kv_len[b], Skv);
  const size_t ridx = (static_cast<size_t>(b) * H + head) * Sq + row;

  float qr[DMAX], dor[DMAX], acc[DMAX];
#pragma unroll
  for (int d = 0; d < DMAX; ++d) {
    qr[d] = (live && d < D) ? q[ridx * D + d] : 0.0f;
    dor[d] = (live && d < D) ? dout[ridx * D + d] : 0.0f;
    acc[d] = 0.0f;
  }
  const float L = live ? lse[ridx] : 0.0f;
  const float dl = live ? delta[ridx] : 0.0f;

  int kv_lo, kv_hi;
  tile_keys(qo, qt, Sq, kl, causal, window, &kv_lo, &kv_hi);
  const size_t kvbase = (static_cast<size_t>(b) * n_kv + h) * Skv * D;
  for (int j0 = (kv_lo / BK) * BK; j0 < kv_hi; j0 += BK) {
    const int nkd = min(kv_hi - j0, BK) * D;
    for (int i = tid; i < nkd; i += nt) {
      k_s[i] = load_value<T>(k, kvbase + static_cast<size_t>(j0) * D + i, n,
                             es);
      v_s[i] = load_value<T>(v, kvbase + static_cast<size_t>(j0) * D + i, n,
                             es);
    }
    __syncthreads();
    int lo, hi;
    row_keys(j0, kl, qpos, causal, window, live, &lo, &hi);
    for (int p = lo - j0; p < hi - j0; ++p) {
      float dcap;
      const float s = cap_score(dot_rs<DMAX>(qr, k_s + p * D, D), scale,
                                softcap, &dcap);
      const float pr = expf(s - L);
      const float dp = dot_rs<DMAX>(dor, v_s + p * D, D);
      const float ds = pr * (dp - dl) * dcap;
#pragma unroll
      for (int d = 0; d < DMAX; ++d)
        if (d < D) acc[d] = fmaf(ds, k_s[p * D + d], acc[d]);
    }
    __syncthreads();
  }
  if (live) {
#pragma unroll
    for (int d = 0; d < DMAX; ++d)
      if (d < D) dq[ridx * D + d] = acc[d] * scale;
  }
}

// ---- K9: dK and dV (float KV) -------------------------------------------
// Shared memory: kT [D*BKV], vT [D*BKV] (transposed: column = key),
// q [BR*D], dO [BR*D], lse [BR], delta [BR].
template <int DMAX>
__global__ void __launch_bounds__(BKV) flash_bwd_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ kv_len, const int* __restrict__ q_offset,
    float* __restrict__ dk, float* __restrict__ dv, int H, int n_kv, int Sq,
    int Skv, int D, int causal, int window, float softcap, float scale) {
  extern __shared__ float smem[];
  const int G = H / n_kv;
  const int tid = threadIdx.x;
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  float* kT = smem;
  float* vT = kT + D * BKV;
  float* q_s = vT + D * BKV;
  float* do_s = q_s + BR * D;
  float* lse_s = do_s + BR * D;
  float* dl_s = lse_s + BR;

  const int j0 = kt * BKV;
  const int j = j0 + tid;
  const int kl = min(kv_len[b], Skv);
  const int qo = q_offset[b];
  const size_t kvbase = (static_cast<size_t>(b) * n_kv + h) * Skv * D;
  const int nkd = min(BKV, Skv - j0) * D;
  for (int i = tid; i < nkd; i += BKV) {
    const int p = i / D, d = i - p * D;
    kT[d * BKV + p] = k[kvbase + static_cast<size_t>(j0) * D + i];
    vT[d * BKV + p] = v[kvbase + static_cast<size_t>(j0) * D + i];
  }
  float dk_r[DMAX], dv_r[DMAX];
#pragma unroll
  for (int d = 0; d < DMAX; ++d) {
    dk_r[d] = 0.0f;
    dv_r[d] = 0.0f;
  }
  __syncthreads();

  if (j0 < kl) {                                 // block-uniform
    const int j_hi = min(j0 + BKV, kl);
    // query rows that see some key of [j0, j_hi)
    const int r_lo = causal ? max(0, j0 - qo) : 0;
    const int r_hi = window > 0 ? min(Sq, j_hi - 1 + window - qo) : Sq;
    const bool kvalid = j < kl;
    for (int g = 0; g < G; ++g) {
      const size_t rbase = (static_cast<size_t>(b) * H + h * G + g) * Sq;
      for (int r0 = r_lo; r0 < r_hi; r0 += BR) {
        const int nr = min(BR, r_hi - r0);
        for (int i = tid; i < nr * D; i += BKV) {
          q_s[i] = q[(rbase + r0) * D + i];
          do_s[i] = dout[(rbase + r0) * D + i];
        }
        if (tid < nr) {
          lse_s[tid] = lse[rbase + r0 + tid];
          dl_s[tid] = delta[rbase + r0 + tid];
        }
        __syncthreads();
        if (kvalid) {
          for (int ii = 0; ii < nr; ++ii) {
            const int qpos = qo + r0 + ii;
            if (causal && qpos < j) continue;
            if (window > 0 && qpos - j >= window) continue;
            const float* qi = q_s + ii * D;
            const float* di = do_s + ii * D;
            float dcap;
            const float s = cap_score(dot_ss<DMAX>(qi, kT + tid, BKV, D),
                                      scale, softcap, &dcap);
            const float pr = expf(s - lse_s[ii]);
            const float dp = dot_ss<DMAX>(di, vT + tid, BKV, D);
            const float ds = pr * (dp - dl_s[ii]) * dcap;
#pragma unroll
            for (int d = 0; d < DMAX; ++d) {
              if (d < D) {
                dv_r[d] = fmaf(pr, di[d], dv_r[d]);
                dk_r[d] = fmaf(ds, qi[d], dk_r[d]);
              }
            }
          }
        }
        __syncthreads();
      }
    }
  }
  if (j < Skv) {
    const size_t o = kvbase + static_cast<size_t>(j) * D;
#pragma unroll
    for (int d = 0; d < DMAX; ++d) {
      if (d < D) {
        dk[o + d] = dk_r[d] * scale;
        dv[o + d] = dv_r[d];
      }
    }
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
int launch_qtile(const Args& a, bool backward, cudaStream_t st) {
  const int G = a.H / a.n_kv;
  const int nt = G * BQ;
  dim3 grid((a.Sq + BQ - 1) / BQ, a.n_kv, a.B);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  if (!backward) {
    const size_t shmem = sizeof(float) * (2 * BK * a.D + BK * nt);
    cudaError_t e = allow_shmem(flash_fwd_kernel<T, DMAX>, shmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_fwd_kernel<T, DMAX><<<grid, nt, shmem, st>>>(
        a.q, k, v, a.kv_len, a.q_offset, a.out, a.lse_out, a.H, a.n_kv, a.Sq,
        a.Skv, a.D, a.causal, a.window, a.softcap, a.scale, a.n, a.es);
  } else {
    const size_t shmem = sizeof(float) * 2 * BK * a.D;
    cudaError_t e = allow_shmem(flash_bwd_dq_kernel<T, DMAX>, shmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_bwd_dq_kernel<T, DMAX><<<grid, nt, shmem, st>>>(
        a.q, k, v, a.dout, a.lse_in, a.delta, a.kv_len, a.q_offset, a.out,
        a.H, a.n_kv, a.Sq, a.Skv, a.D, a.causal, a.window, a.softcap,
        a.scale, a.n, a.es);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const Args& a, bool backward, cudaStream_t st) {
  if (a.D <= 64) return launch_qtile<T, 64>(a, backward, st);
  if (a.D <= 128) return launch_qtile<T, 128>(a, backward, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

int dispatch_qtile(const Args& a, int dtype, bool backward,
                   cudaStream_t st) {
  if (a.B <= 0 || a.Sq <= 0) return 0;
  if (a.D % 4 != 0 || a.H % a.n_kv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == DT_F32) return dispatch_d<float>(a, backward, st);
  if (dtype == DT_I8) return dispatch_d<int8_t>(a, backward, st);
  if (dtype == DT_I16) return dispatch_d<int16_t>(a, backward, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int DMAX>
int launch_dkv(const Args& a, float* dk, float* dv, cudaStream_t st) {
  const size_t shmem =
      sizeof(float) * (2 * a.D * BKV + 2 * BR * a.D + 2 * BR);
  cudaError_t e = allow_shmem(flash_bwd_dkv_kernel<DMAX>, shmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((a.Skv + BKV - 1) / BKV, a.n_kv, a.B);
  flash_bwd_dkv_kernel<DMAX><<<grid, BKV, shmem, st>>>(
      a.q, static_cast<const float*>(a.k), static_cast<const float*>(a.v),
      a.dout, a.lse_in, a.delta, a.kv_len, a.q_offset, dk, dv, a.H, a.n_kv,
      a.Sq, a.Skv, a.D, a.causal, a.window, a.softcap, a.scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K7.  out [B,H,Sq,D]; lse [B,H,Sq] or null.  window <= 0: none;
// softcap <= 0: none.  dtype: the storage of k and v (0 f32, 1 int8,
// 2 int16 posit of format (n, es)).
extern "C" int flash_prefill_fwd(const void* q, const void* k, const void* v,
                                 const void* kv_len, const void* q_offset,
                                 void* out, void* lse, int B, int H, int n_kv,
                                 int Sq, int Skv, int D, int causal,
                                 int window, float softcap, float scale,
                                 int dtype, int n, int es, void* stream) {
  Args a{static_cast<const float*>(q), k, v, nullptr, nullptr, nullptr,
         static_cast<const int*>(kv_len), static_cast<const int*>(q_offset),
         static_cast<float*>(out), static_cast<float*>(lse), B, H, n_kv, Sq,
         Skv, D, causal, window, softcap, scale, n, es};
  return dispatch_qtile(a, dtype, false, static_cast<cudaStream_t>(stream));
}

// K8.  dq [B,H,Sq,D] from q, k, v, dO, lse, delta = rowsum(dO * o).
extern "C" int flash_prefill_bwd_dq(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    const void* kv_len, const void* q_offset,
                                    void* dq, int B, int H, int n_kv, int Sq,
                                    int Skv, int D, int causal, int window,
                                    float softcap, float scale, int dtype,
                                    int n, int es, void* stream) {
  Args a{static_cast<const float*>(q), k, v, static_cast<const float*>(dout),
         static_cast<const float*>(lse), static_cast<const float*>(delta),
         static_cast<const int*>(kv_len), static_cast<const int*>(q_offset),
         static_cast<float*>(dq), nullptr, B, H, n_kv, Sq, Skv, D, causal,
         window, softcap, scale, n, es};
  return dispatch_qtile(a, dtype, true, static_cast<cudaStream_t>(stream));
}

// K9.  dk, dv [B,n_kv,Skv,D] (group-summed) for f32 k and v.
extern "C" int flash_prefill_bwd_dkv(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     const void* kv_len, const void* q_offset,
                                     void* dk, void* dv, int B, int H,
                                     int n_kv, int Sq, int Skv, int D,
                                     int causal, int window, float softcap,
                                     float scale, void* stream) {
  if (B <= 0 || Skv <= 0) return 0;
  if (D % 4 != 0 || H % n_kv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const float*>(q), k, v, static_cast<const float*>(dout),
         static_cast<const float*>(lse), static_cast<const float*>(delta),
         static_cast<const int*>(kv_len), static_cast<const int*>(q_offset),
         nullptr, nullptr, B, H, n_kv, Sq, Skv, D, causal, window, softcap,
         scale, 0, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dkp = static_cast<float*>(dk);
  float* dvp = static_cast<float*>(dv);
  if (D <= 64) return launch_dkv<64>(a, dkp, dvp, st);
  if (D <= 128) return launch_dkv<128>(a, dkp, dvp, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
