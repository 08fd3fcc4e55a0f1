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
// bytes bound it.  A prefill chunk (M = max_seqs * prefill_chunk), and the
// quire GEMM at M = 1024, do 2*M flops per weight element and are bound by
// f32 FFMA throughput (no tensor cores: TF32 keeps 11 significand bits and
// a posit16 es2 value needs up to 12, so a TF32 product would round the
// operands away from the reference's exact-decode f32 semantics).
//
// Design.  The launch is chosen by the wrapper's M; every one is a single
// kernel launch with a fixed summation order (run-to-run deterministic):
//   M <= 8 (decode steps, pw form): a skinny kernel.  Without transpose_b
//     each lane owns one output column (coalesced 2-byte weight reads
//     across the warp) and the 32 warps of a block split K into contiguous
//     ranges; their partial sums meet in shared memory and add in warp
//     order.  With transpose_b (the [V, d] table, k contiguous) each warp
//     owns one column, lanes stride k, and a butterfly shuffle adds the
//     lanes.  Many independent weight loads are in flight per SM, which is
//     what an HBM-bound GEMV needs; the tiled kernel below kept one k-tile
//     in flight per block and was latency-bound at M = 8.
//   M > 8, and every general-form call: tiled, BM=64, BN=64, BK=16, 4x4
//     outputs per thread.
// Each tiled block stages a BM x BK tile of A and a BK x BN tile of B in
// shared memory; a posit tile is decoded to exact f32 as it is stored, so
// HBM only sees the narrow ints.  With transpose_a the stored A already is
// the [k][m] layout of the shared tile: its loader reads rows of k,
// coalesced along m, and the FFMA loop is the same.  The operand types are the loader
// functors of the kernel template: fixed types for the pw form, a
// warp-uniform switch on the storage type for the general form (it runs in
// the staging loop, not in the FFMA loop).  For transpose_b the B tile is
// read along the stored k axis and written transposed into shared memory:
// no transposed copy exists anywhere.  A tiled output accumulates over k in
// order 0..K-1 with fmaf in one thread; the epilogue stores it, or its
// posit encoding.
#include "posit_codec.cuh"

namespace {

// Tile loaders: element i of an operand -> exact f32.
struct F32In {
  __device__ __forceinline__ float operator()(const void* p, size_t i) const {
    return static_cast<const float*>(p)[i];
  }
};
template <typename T>
struct PositIn {
  int n, es;
  __device__ __forceinline__ float operator()(const void* p, size_t i) const {
    return load_value<T>(static_cast<const T*>(p), i, n, es);
  }
};
struct AnyIn {                         // storage type known at run time
  int dtype, n, es;
  __device__ __forceinline__ float operator()(const void* p, size_t i) const {
    if (dtype == DT_I8)
      return load_value<int8_t>(static_cast<const int8_t*>(p), i, n, es);
    if (dtype == DT_I16)
      return load_value<int16_t>(static_cast<const int16_t*>(p), i, n, es);
    return static_cast<const float*>(p)[i];
  }
};
// Epilogues: the f32 accumulator -> element i of the output.
struct F32Out {
  __device__ __forceinline__ void operator()(void* p, size_t i,
                                             float v) const {
    static_cast<float*>(p)[i] = v;
  }
};
struct AnyOut {                        // f32, or one RNE rounding to posit
  int dtype, n, es;
  __device__ __forceinline__ void operator()(void* p, size_t i,
                                             float v) const {
    if (dtype == DT_I8)
      static_cast<int8_t*>(p)[i] = store_value<int8_t>(v, n, es);
    else if (dtype == DT_I16)
      static_cast<int16_t*>(p)[i] = store_value<int16_t>(v, n, es);
    else
      static_cast<float*>(p)[i] = v;
  }
};

template <class LA, class LB, class ST, int BM, int BN, int BK, int TM,
          int TN, bool TRANSA, bool TRANSB>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
gemm_tile_kernel(const void* __restrict__ a, const void* __restrict__ b,
                 void* __restrict__ out, int M, int N, int K, LA load_a,
                 LB load_b, ST store) {
  constexpr int TX = BN / TN;          // threads along n
  constexpr int TY = BM / TM;          // threads along m
  constexpr int NT = TX * TY;
  __shared__ float As[BK][BM + 1];     // +1: conflict-free transposed stores
  __shared__ float Bs[BK][BN + 1];
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int idx = tid; idx < BM * BK; idx += NT) {
      int mm, kk;
      if (TRANSA) {                             // a is [K, M], m contiguous
        kk = idx / BM;
        mm = idx % BM;
      } else {                                  // a is [M, K], k contiguous
        mm = idx / BK;
        kk = idx % BK;
      }
      const int gm = m0 + mm, gk = k0 + kk;
      float val = 0.0f;
      if (gm < M && gk < K) {
        const size_t off = TRANSA ? static_cast<size_t>(gk) * M + gm
                                  : static_cast<size_t>(gm) * K + gk;
        val = load_a(a, off);
      }
      As[kk][mm] = val;
    }
    for (int idx = tid; idx < BK * BN; idx += NT) {
      int kk, nn;
      if (TRANSB) {                             // b is [N, K], k contiguous
        nn = idx / BK;
        kk = idx % BK;
      } else {                                  // b is [K, N], n contiguous
        kk = idx / BN;
        nn = idx % BN;
      }
      const int gk = k0 + kk, gn = n0 + nn;
      float val = 0.0f;
      if (gk < K && gn < N) {
        const size_t off = TRANSB ? static_cast<size_t>(gn) * K + gk
                                  : static_cast<size_t>(gk) * N + gn;
        val = load_b(b, off);
      }
      Bs[kk][nn] = val;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[kk][ty + i * TY];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + i * TY;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * TX;
      if (gn < N) store(out, static_cast<size_t>(gm) * N + gn, acc[i][j]);
    }
  }
}

// ---- skinny M (decode steps) ----------------------------------------------
constexpr int kSkinnyM = 8;
constexpr int kGemvWarps = 32;

// w [K, N], n contiguous: one column per lane, warps split K.
template <typename T>
__global__ void __launch_bounds__(kGemvWarps * 32)
pw_gemv_kernel(const float* __restrict__ x, const T* __restrict__ w,
               float* __restrict__ out, int M, int N, int K, int n, int es) {
  __shared__ float red[kGemvWarps][kSkinnyM][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  const int chunk = (K + kGemvWarps - 1) / kGemvWarps;
  const int k0 = warp * chunk, k1 = min(K, k0 + chunk);
  float acc[kSkinnyM];
#pragma unroll
  for (int m = 0; m < kSkinnyM; ++m) acc[m] = 0.0f;
  if (col < N) {
#pragma unroll 4
    for (int k = k0; k < k1; ++k) {
      const float wv = load_value<T>(w, static_cast<size_t>(k) * N + col, n,
                                     es);
#pragma unroll
      for (int m = 0; m < kSkinnyM; ++m)
        if (m < M)
          acc[m] = fmaf(__ldg(&x[static_cast<size_t>(m) * K + k]), wv, acc[m]);
    }
  }
#pragma unroll
  for (int m = 0; m < kSkinnyM; ++m) red[warp][m][lane] = acc[m];
  __syncthreads();
  if (threadIdx.x < kSkinnyM * 32) {
    const int m = threadIdx.x >> 5, c = threadIdx.x & 31;
    const int gc = blockIdx.x * 32 + c;
    if (m < M && gc < N) {
      float s = 0.0f;
      for (int i = 0; i < kGemvWarps; ++i) s += red[i][m][c];
      out[static_cast<size_t>(m) * N + gc] = s;
    }
  }
}

// w [N, K], k contiguous: one column per warp, lanes stride k.
template <typename T>
__global__ void __launch_bounds__(256)
pw_gemv_t_kernel(const float* __restrict__ x, const T* __restrict__ w,
                 float* __restrict__ out, int M, int N, int K, int n, int es) {
  const int lane = threadIdx.x & 31;
  const int col = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (col >= N) return;                          // whole warp; no barrier
  const T* wr = w + static_cast<size_t>(col) * K;
  float acc[kSkinnyM];
#pragma unroll
  for (int m = 0; m < kSkinnyM; ++m) acc[m] = 0.0f;
#pragma unroll 4
  for (int k = lane; k < K; k += 32) {
    const float wv = load_value<T>(wr, k, n, es);
#pragma unroll
    for (int m = 0; m < kSkinnyM; ++m)
      if (m < M)
        acc[m] = fmaf(__ldg(&x[static_cast<size_t>(m) * K + k]), wv, acc[m]);
  }
#pragma unroll
  for (int m = 0; m < kSkinnyM; ++m)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], off);
  if (lane == 0)
    for (int m = 0; m < M; ++m) out[static_cast<size_t>(m) * N + col] = acc[m];
}

constexpr int kBM = 64, kBN = 64, kBK = 16, kTM = 4, kTN = 4;

template <bool TRANSB, bool TRANSA = false, class LA, class LB, class ST>
void launch_tiled(const void* a, const void* b, void* out, int M, int N,
                  int K, LA la, LB lb, ST st, cudaStream_t stream) {
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  dim3 block((kBM / kTM) * (kBN / kTN));
  gemm_tile_kernel<LA, LB, ST, kBM, kBN, kBK, kTM, kTN, TRANSA, TRANSB>
      <<<grid, block, 0, stream>>>(a, b, out, M, N, K, la, lb, st);
}

template <typename T, bool TRANSB>
void dispatch_tile(const float* x, const void* w, float* out, int M, int N,
                   int K, int n, int es, cudaStream_t st) {
  if (M <= kSkinnyM) {
    const T* wt = static_cast<const T*>(w);
    if (TRANSB)
      pw_gemv_t_kernel<T><<<(N + 7) / 8, 256, 0, st>>>(x, wt, out, M, N, K, n,
                                                       es);
    else
      pw_gemv_kernel<T><<<(N + 31) / 32, kGemvWarps * 32, 0, st>>>(
          x, wt, out, M, N, K, n, es);
  } else {
    launch_tiled<TRANSB>(x, w, out, M, N, K, F32In{}, PositIn<T>{n, es},
                         F32Out{}, st);
  }
}

template <typename T>
void dispatch_trans(const float* x, const void* w, float* out, int M, int N,
                    int K, int transpose_b, int n, int es, cudaStream_t st) {
  if (transpose_b)
    dispatch_tile<T, true>(x, w, out, M, N, K, n, es, st);
  else
    dispatch_tile<T, false>(x, w, out, M, N, K, n, es, st);
}

}  // namespace

// x [M, K] f32; w [K, N] (or [N, K] when transpose_b) posit ints; out [M, N].
extern "C" int posit_pw_gemm(const void* x, const void* w, void* out, int M,
                             int N, int K, int transpose_b, int dtype, int n,
                             int es, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  if (dtype == DT_I8)
    dispatch_trans<int8_t>(xf, w, of, M, N, K, transpose_b, n, es, st);
  else if (dtype == DT_I16)
    dispatch_trans<int16_t>(xf, w, of, M, N, K, transpose_b, n, es, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// a [M, K] (or [K, M] when transpose_a), b [K, N] (or [N, K] when
// transpose_b), out [M, N]; each of the three is f32 (dtype 0) or posit ints
// (1: int8, 2: int16) of format (n, es).
extern "C" int posit_gemm(const void* a, const void* b, void* out, int M,
                          int N, int K, int transpose_a, int transpose_b,
                          int dta, int na,
                          int esa, int dtb, int nb, int esb, int dto, int no,
                          int eso, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const int dts[3] = {dta, dtb, dto};
  for (int dt : dts)
    if (dt != DT_F32 && dt != DT_I8 && dt != DT_I16)
      return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const AnyIn la{dta, na, esa}, lb{dtb, nb, esb};
  const AnyOut so{dto, no, eso};
  if (transpose_a && transpose_b)
    launch_tiled<true, true>(a, b, out, M, N, K, la, lb, so, st);
  else if (transpose_a)
    launch_tiled<false, true>(a, b, out, M, N, K, la, lb, so, st);
  else if (transpose_b)
    launch_tiled<true>(a, b, out, M, N, K, la, lb, so, st);
  else
    launch_tiled<false>(a, b, out, M, N, K, la, lb, so, st);
  return static_cast<int>(cudaGetLastError());
}
