// Tile loaders of the grouped GEMM kernels (grouped_gemm.cu): element i of
// an operand -> exact f32, as a tile is staged in shared memory.  A posit
// operand is decoded here, so HBM only sees the narrow ints and the FFMA
// loop only sees f32.
#pragma once
#include "posit_codec.cuh"

namespace {

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

}  // namespace
