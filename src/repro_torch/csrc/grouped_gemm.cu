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
// per posit16 element, for ~2 flops per element: HBM bytes bound it.  A
// prefill step (8,192 rows) and the training step (32,768 rows) do 2 S K N
// flops over E K N weights and are bound by f32 FFMA.  No tensor cores:
// TF32 keeps 11 significand bits and a posit16 es2 value needs up to 12
// (the same reason as K2's).
//
// Design.  The Pallas kernel walks a static, ordered (group, m-tile)
// incidence table because a TPU grid must be static.  A CUDA block reads
// offsets[g] and offsets[g+1] itself, so the grid is simply:
//   K10: (n-tile, group).  A block loops over its group's rows in BM-row
//     chunks, with the whole K loop inside each chunk; an empty group
//     returns at once, so an inactive expert's table is never read.  Each
//     output row belongs to one group, so each output element is written
//     once by one thread: no atomics, a fixed summation order (k = 0..K-1
//     with fmaf), deterministic.  BM is 64 (4x4 outputs per thread) when
//     groups average 16 rows or more, else 16 (1x4 per thread): a decode
//     step gives most experts one or two rows, and a 64-row tile would
//     spend 97% of its FMAs on rows past the group's end.
//   K11: (n-tile, m-tile, group).  A block sums its group's rows in order,
//     16 at a time, and writes its tile once (zeros when the group is
//     empty).
// Both stage BMx16 and 16x64 tiles in shared memory (posit tiles decoded
// to exact f32 as they are stored, by the loaders of posit_tile.cuh) with
// 256 threads, as K2's tiled kernel does.
// Offsets are read on the device and clamped to [0, S]; they must be
// nondecreasing, as the sort-based dispatch makes them.
#include "posit_tile.cuh"

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 16, kTM = 4, kTN = 4;
constexpr int kTX = kBN / kTN;           // threads along n
constexpr int kThreads = 256;
constexpr int kSmallBM = 16;             // K10's tile for few rows per group

__device__ __forceinline__ void group_rows(const int* offsets, int g, int S,
                                           int& r0, int& r1) {
  r0 = min(max(__ldg(&offsets[g]), 0), S);
  r1 = min(max(__ldg(&offsets[g + 1]), r0), S);
}

// acc[i][j] += sum over kk of As[kk][ty + i TY] Bs[kk][tx + j TX], kk in
// order; TY = BM / TM threads along m.
template <int BM, int TM>
__device__ __forceinline__ void tile_fma(float (&acc)[TM][kTN],
                                         const float (&As)[kBK][BM + 1],
                                         const float (&Bs)[kBK][kBN + 1],
                                         int tx, int ty) {
  constexpr int TY = BM / TM;
#pragma unroll
  for (int kk = 0; kk < kBK; ++kk) {
    float av[TM], bv[kTN];
#pragma unroll
    for (int i = 0; i < TM; ++i) av[i] = As[kk][ty + i * TY];
#pragma unroll
    for (int j = 0; j < kTN; ++j) bv[j] = Bs[kk][tx + j * kTX];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// K10: x [S, K] f32; w [E, K, N] (or [E, N, K] when TRANSB); out [S, N].
template <class LB, bool TRANSB, int BM, int TM>
__global__ void __launch_bounds__(kThreads)
grouped_gemm_kernel(const float* __restrict__ x, const void* __restrict__ w,
                    float* __restrict__ out, const int* __restrict__ offsets,
                    int S, int N, int K, LB load_b) {
  static_assert(kTX * (BM / TM) == kThreads, "256 threads per block");
  constexpr int TY = BM / TM;
  __shared__ float As[kBK][BM + 1];      // +1: conflict-free transposed stores
  __shared__ float Bs[kBK][kBN + 1];
  const int g = blockIdx.y;
  int r0, r1;
  group_rows(offsets, g, S, r0, r1);
  if (r0 >= r1) return;                  // empty group (block-uniform)
  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;
  const int n0 = blockIdx.x * kBN;
  const size_t wbase = static_cast<size_t>(g) * K * N;

  for (int m0 = r0; m0 < r1; m0 += BM) {
    float acc[TM][kTN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;
    for (int k0 = 0; k0 < K; k0 += kBK) {
      for (int idx = tid; idx < BM * kBK; idx += kThreads) {
        const int mm = idx / kBK, kk = idx % kBK;
        const int gm = m0 + mm, gk = k0 + kk;
        As[kk][mm] = (gm < r1 && gk < K) ? x[static_cast<size_t>(gm) * K + gk]
                                         : 0.0f;
      }
      for (int idx = tid; idx < kBK * kBN; idx += kThreads) {
        int kk, nn;
        if (TRANSB) {                    // w[g] is [N, K], k contiguous
          nn = idx / kBK;
          kk = idx % kBK;
        } else {                         // w[g] is [K, N], n contiguous
          kk = idx / kBN;
          nn = idx % kBN;
        }
        const int gk = k0 + kk, gn = n0 + nn;
        float val = 0.0f;
        if (gk < K && gn < N) {
          const size_t off = TRANSB ? static_cast<size_t>(gn) * K + gk
                                    : static_cast<size_t>(gk) * N + gn;
          val = load_b(w, wbase + off);
        }
        Bs[kk][nn] = val;
      }
      __syncthreads();
      tile_fma<BM, TM>(acc, As, Bs, tx, ty);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int gm = m0 + ty + i * TY;
      if (gm >= r1) continue;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int gn = n0 + tx + j * kTX;
        if (gn < N) out[static_cast<size_t>(gm) * N + gn] = acc[i][j];
      }
    }
  }
}

// K11: x [S, M] f32, g [S, N] f32 -> dw [E, M, N] f32.
__global__ void __launch_bounds__(kThreads)
grouped_dw_kernel(const float* __restrict__ x, const float* __restrict__ gr,
                  float* __restrict__ dw, const int* __restrict__ offsets,
                  int S, int M, int N) {
  __shared__ float As[kBK][kBM + 1];
  __shared__ float Bs[kBK][kBN + 1];
  constexpr int TY = kBM / kTM;
  const int e = blockIdx.z;
  int r0, r1;
  group_rows(offsets, e, S, r0, r1);
  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  for (int s0 = r0; s0 < r1; s0 += kBK) {  // the group's rows, in order
    for (int idx = tid; idx < kBK * kBM; idx += kThreads) {
      const int kk = idx / kBM, mm = idx % kBM;   // rows of x, m contiguous
      const int gs = s0 + kk, gm = m0 + mm;
      As[kk][mm] = (gs < r1 && gm < M) ? x[static_cast<size_t>(gs) * M + gm]
                                       : 0.0f;
    }
    for (int idx = tid; idx < kBK * kBN; idx += kThreads) {
      const int kk = idx / kBN, nn = idx % kBN;
      const int gs = s0 + kk, gn = n0 + nn;
      Bs[kk][nn] = (gs < r1 && gn < N) ? gr[static_cast<size_t>(gs) * N + gn]
                                       : 0.0f;
    }
    __syncthreads();
    tile_fma<kBM, kTM>(acc, As, Bs, tx, ty);
    __syncthreads();
  }
  const size_t base = static_cast<size_t>(e) * M * N;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gm = m0 + ty + i * TY;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gn = n0 + tx + j * kTX;
      if (gn < N) dw[base + static_cast<size_t>(gm) * N + gn] = acc[i][j];
    }
  }
}

template <class LB, int BM, int TM>
void launch_tile(const float* x, const void* w, float* out,
                 const int* offsets, int S, int N, int K, int E,
                 int transpose_b, LB lb, cudaStream_t st) {
  dim3 grid((N + kBN - 1) / kBN, E);
  if (transpose_b)
    grouped_gemm_kernel<LB, true, BM, TM><<<grid, kThreads, 0, st>>>(
        x, w, out, offsets, S, N, K, lb);
  else
    grouped_gemm_kernel<LB, false, BM, TM><<<grid, kThreads, 0, st>>>(
        x, w, out, offsets, S, N, K, lb);
}

template <class LB>
void launch_grouped(const float* x, const void* w, float* out,
                    const int* offsets, int S, int N, int K, int E,
                    int transpose_b, LB lb, cudaStream_t st) {
  if (S < kSmallBM * E)                  // fewer than 16 rows per group
    launch_tile<LB, kSmallBM, 1>(x, w, out, offsets, S, N, K, E,
                                 transpose_b, lb, st);
  else
    launch_tile<LB, kBM, kTM>(x, w, out, offsets, S, N, K, E, transpose_b,
                              lb, st);
}

}  // namespace

// x [S, K] f32; w [E, K, N] (or [E, N, K] when transpose_b) of storage type
// dtype (0: f32, 1: int8, 2: int16 posit of format (n, es)); offsets [E+1]
// int32; out [S, N] f32, zeroed by the caller.
extern "C" int posit_grouped_gemm(const void* x, const void* w, void* out,
                                  const void* offsets, int S, int N, int K,
                                  int E, int transpose_b, int dtype, int n,
                                  int es, void* stream) {
  if (S <= 0 || N <= 0 || E <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  const int* off = static_cast<const int*>(offsets);
  if (dtype == DT_F32)
    launch_grouped(xf, w, of, off, S, N, K, E, transpose_b, F32In{}, st);
  else if (dtype == DT_I8)
    launch_grouped(xf, w, of, off, S, N, K, E, transpose_b,
                   PositIn<int8_t>{n, es}, st);
  else if (dtype == DT_I16)
    launch_grouped(xf, w, of, off, S, N, K, E, transpose_b,
                   PositIn<int16_t>{n, es}, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// x [S, M] f32, g [S, N] f32, offsets [E+1] int32 -> dw [E, M, N] f32 (every
// element written).
extern "C" int posit_grouped_gemm_dw(const void* x, const void* g, void* dw,
                                     const void* offsets, int S, int M, int N,
                                     int E, void* stream) {
  if (M <= 0 || N <= 0 || E <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, E);
  grouped_dw_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(g),
      static_cast<float*>(dw), static_cast<const int*>(offsets), S, M, N);
  return static_cast<int>(cudaGetLastError());
}
