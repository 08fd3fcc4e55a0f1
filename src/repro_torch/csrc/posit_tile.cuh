// Tile loaders shared by the GEMM kernels (posit_gemm.cu, grouped_gemm.cu):
// element i of an operand -> exact f32, as a tile is staged in shared
// memory.  A posit operand is decoded here, so HBM only sees the narrow
// ints and the FFMA loop only sees f32.
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

}  // namespace
