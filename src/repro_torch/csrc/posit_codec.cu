// K1: the bulk posit codec, plus the KV append that encodes and scatters.
//
// Replaces the TPU kernels repro/kernels/posit_codec.py::decode_block (:41)
// and ::encode_block (:59), and the jnp encode + scatter of
// repro/serving/paged_kv.py::paged_append_kv (:266, encode at :282).
//
// Bound on an H100: HBM bytes.  decode reads 2 B and writes 4 B per element,
// encode the reverse, for ~20 integer operations per element, far below
// the card's ratio of operations to bytes.  Design: one thread per element,
// consecutive threads on consecutive elements so every load and store
// coalesces; no shared memory.  The append computes each token's page and
// offset itself from the page table, and drops masked writes (token index
// >= num_new, or a position past the table) before touching the pool, so
// the pool is updated in place and no index tensor is materialized.
#include "posit_codec.cuh"

namespace {

template <typename T>
__global__ void decode_block_kernel(const T* __restrict__ in,
                                    float* __restrict__ out, long long count,
                                    int n, int es) {
  long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i < count) out[i] = load_value<T>(in, i, n, es);
}

template <typename T>
__global__ void encode_block_kernel(const float* __restrict__ in,
                                    T* __restrict__ out, long long count,
                                    int n, int es) {
  long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i < count) out[i] = store_value<T>(in[i], n, es);
}

// k, v: [B, n_kv, S, D] f32 contiguous; pages: [P, n_kv, page, D].
template <typename T>
__global__ void paged_append_kernel(
    const float* __restrict__ k, const float* __restrict__ v,
    const int* __restrict__ seq_lens, const int* __restrict__ num_new,
    const int* __restrict__ page_table, T* __restrict__ k_pages,
    T* __restrict__ v_pages, int B, int n_kv, int S, int D, int page, int W,
    int num_pages, int n, int es) {
  long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  const long long total = static_cast<long long>(B) * n_kv * S * D;
  if (i >= total) return;
  const int d = static_cast<int>(i % D);
  const int s = static_cast<int>((i / D) % S);
  const int h = static_cast<int>((i / (static_cast<long long>(D) * S)) % n_kv);
  const int b = static_cast<int>(i / (static_cast<long long>(D) * S * n_kv));
  if (s >= num_new[b]) return;                   // masked write: dropped
  const int pos = seq_lens[b] + s;
  const int slot = pos / page;
  if (slot >= W) return;                         // past the table: dropped
  const int pg = page_table[b * W + slot];
  if (pg < 0 || pg >= num_pages) return;
  const long long dst =
      ((static_cast<long long>(pg) * n_kv + h) * page + pos % page) * D + d;
  k_pages[dst] = store_value<T>(k[i], n, es);
  v_pages[dst] = store_value<T>(v[i], n, es);
}

constexpr int kThreads = 256;

inline unsigned blocks_for(long long count) {
  return static_cast<unsigned>((count + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int posit_decode_block(const void* in, void* out, long long count,
                                  int dtype, int n, int es, void* stream) {
  if (count <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_I8)
    decode_block_kernel<int8_t><<<blocks_for(count), kThreads, 0, st>>>(
        static_cast<const int8_t*>(in), static_cast<float*>(out), count, n, es);
  else if (dtype == DT_I16)
    decode_block_kernel<int16_t><<<blocks_for(count), kThreads, 0, st>>>(
        static_cast<const int16_t*>(in), static_cast<float*>(out), count, n,
        es);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int posit_encode_block(const void* in, void* out, long long count,
                                  int dtype, int n, int es, void* stream) {
  if (count <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_I8)
    encode_block_kernel<int8_t><<<blocks_for(count), kThreads, 0, st>>>(
        static_cast<const float*>(in), static_cast<int8_t*>(out), count, n, es);
  else if (dtype == DT_I16)
    encode_block_kernel<int16_t><<<blocks_for(count), kThreads, 0, st>>>(
        static_cast<const float*>(in), static_cast<int16_t*>(out), count, n,
        es);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int posit_paged_append(const void* k, const void* v,
                                  const void* seq_lens, const void* num_new,
                                  const void* page_table, void* k_pages,
                                  void* v_pages, int B, int n_kv, int S, int D,
                                  int page, int W, int num_pages, int dtype,
                                  int n, int es, void* stream) {
  const long long total = static_cast<long long>(B) * n_kv * S * D;
  if (total <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const int* sl = static_cast<const int*>(seq_lens);
  const int* nn = static_cast<const int*>(num_new);
  const int* pt = static_cast<const int*>(page_table);
#define APPEND(T)                                                         \
  paged_append_kernel<T><<<blocks_for(total), kThreads, 0, st>>>(         \
      kf, vf, sl, nn, pt, static_cast<T*>(k_pages), static_cast<T*>(v_pages), \
      B, n_kv, S, D, page, W, num_pages, n, es)
  if (dtype == DT_F32)
    APPEND(float);
  else if (dtype == DT_I8)
    APPEND(int8_t);
  else if (dtype == DT_I16)
    APPEND(int16_t);
  else
    return static_cast<int>(cudaErrorInvalidValue);
#undef APPEND
  return static_cast<int>(cudaGetLastError());
}
