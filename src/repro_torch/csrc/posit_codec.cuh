// Posit <-> float32 device functions shared by every kernel of the port.
//
// Exact ports of repro/core/decode.py::decode_to_f32 and
// repro/core/convert.py::f32_to_posit (with core/encode.py::encode_fir):
// branch-light 32-bit integer arithmetic, bit-identical to the reference on
// every pattern.  Where the reference finds a bit length through the
// exponent of an f32 cast (core/bitutil.py), this uses __clz.
// Widths n <= 16 (int8/int16 storage); es <= 4.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

#define POSIT_NAN_BITS 0x7fc00000

// Storage-type codes shared with the Python wrappers.
enum PositDtype { DT_F32 = 0, DT_I8 = 1, DT_I16 = 2 };

__device__ __forceinline__ float posit_decode(int32_t p, int n, int es) {
  const uint32_t mask = (1u << n) - 1u;
  const uint32_t u = static_cast<uint32_t>(p) & mask;
  if (u == 0u) return 0.0f;
  if (u == (1u << (n - 1))) return __int_as_float(POSIT_NAN_BITS);
  const uint32_t s = u >> (n - 1);
  const uint32_t a = s ? ((0u - u) & mask) : u;
  const uint32_t x = (a << 1) & mask;            // drop sign, regime at MSB
  const uint32_t b = x >> (n - 1);
  const uint32_t y = b ? (~x & mask) : x;
  const int bl = 32 - __clz(static_cast<int>(y)); // __clz(0) == 32
  const int run = min(n - bl, n - 1);
  const int k = b ? run - 1 : -run;
  const uint32_t rem = (x << (run + 1)) & mask;  // run + 1 <= n <= 16
  int e = 0;
  uint32_t frac = rem;
  if (es > 0) {
    e = static_cast<int>(rem >> (n - es));
    frac = (rem << es) & mask;
  }
  const int te = k * (1 << es) + e;
  const int W = n - 3;
  const uint32_t mant23 = (frac >> 3) << (23 - W);
  const uint32_t fbits = (s << 31) | (static_cast<uint32_t>(te + 127) << 23) |
                         mant23;
  return __uint_as_float(fbits);
}

// float32 -> posit pattern, sign-extended to int32 (fits the storage type).
__device__ __forceinline__ int32_t posit_encode(float v, int n, int es) {
  const int32_t i = __float_as_int(v);
  const int32_t ex = (i >> 23) & 0xFF;
  const int32_t mask = (1 << n) - 1;
  if (ex == 0xFF) return -(1 << (n - 1));        // Inf/NaN -> NaR
  if ((i & 0x7FFFFFFF) == 0) return 0;
  const int32_t s = (i >> 31) & 1;
  const int W = 23;
  const int32_t mant = i & 0x7FFFFF;
  int32_t te = (ex == 0) ? -200 : ex - 127;      // subnormal -> minpos
  const int32_t M = (1 << W) | mant;

  const int32_t te_max = (n - 2) * (1 << es);
  const int32_t te_min = -te_max;
  const bool sat_hi = te > te_max;
  const bool sat_lo = te < te_min;
  te = min(max(te, te_min), te_max);
  const int32_t k = te >> es;                    // arithmetic shift
  const int32_t e = te - (k << es);

  const bool k_pos = k >= 0;
  const int32_t rlen = k_pos ? k + 2 : 1 - k;
  const int32_t regime = k_pos ? (((1 << (min(k, n) + 1)) - 1) << 1) : 1;
  const int32_t frac = M - (1 << W);
  const int32_t nre = rlen + es;
  const int32_t body_bits = n - 1;
  const int32_t combined_re = (regime << es) | e;

  // case A: some fraction bits survive (nre < n-1)
  const int32_t ffield = max(body_bits - nre, 0);
  const int32_t shiftA = min(max(W - ffield, 1), 31);
  const int32_t keptA = frac >> shiftA;
  const int32_t rA = (frac >> (shiftA - 1)) & 1;
  const int32_t sA = (frac & ((1 << (shiftA - 1)) - 1)) != 0;
  const int32_t bodyA = (combined_re << ffield) | keptA;

  // case B: regime+exponent fill the body (nre >= n-1)
  const int32_t shiftB = min(max(nre - body_bits, 0), 31);
  const int32_t bodyB = combined_re >> shiftB;
  const int32_t shiftB1 = max(shiftB - 1, 0);
  const int32_t rB = shiftB > 0 ? (combined_re >> shiftB1) & 1
                                : (frac >> (W - 1)) & 1;
  const bool low_re = (combined_re & ((1 << shiftB1) - 1)) != 0;
  const bool low_fr_all = frac != 0;
  const bool low_fr_tail = (frac & ((1 << (W - 1)) - 1)) != 0;
  const int32_t sB = shiftB > 0 ? (low_re || low_fr_all) : low_fr_tail;

  const bool caseA = nre < body_bits;
  int32_t body = caseA ? bodyA : bodyB;
  const int32_t r = caseA ? rA : rB;
  const int32_t st = caseA ? sA : sB;
  body += r & (st | (body & 1));                 // RNE on the monotone pattern

  const int32_t maxpos = mask >> 1;
  body = min(max(body, 1), maxpos);
  if (sat_hi) body = maxpos;
  if (sat_lo) body = 1;
  const int32_t out = s ? ((-body) & mask) : body;
  return (out & (1 << (n - 1))) ? out - (1 << n) : out;   // sign-extend
}

// One stored element -> float32, for the three page/weight storage types.
template <typename T>
__device__ __forceinline__ float load_value(const T* p, size_t i, int n,
                                            int es) {
  return posit_decode(static_cast<int32_t>(p[i]), n, es);
}
template <>
__device__ __forceinline__ float load_value<float>(const float* p, size_t i,
                                                   int, int) {
  return p[i];
}

// float32 -> one stored element (encode for posit storage, copy for f32).
template <typename T>
__device__ __forceinline__ T store_value(float v, int n, int es) {
  return static_cast<T>(posit_encode(v, n, es));
}
template <>
__device__ __forceinline__ float store_value<float>(float v, int, int) {
  return v;
}
