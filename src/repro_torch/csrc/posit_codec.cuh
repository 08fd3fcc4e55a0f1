// Posit <-> float32 device functions shared by every kernel of the port.
//
// Exact ports of repro/core/decode.py::decode_to_f32 and
// repro/core/convert.py::f32_to_posit (with core/encode.py::encode_fir):
// branch-light 32-bit integer arithmetic, bit-identical to the reference on
// every pattern.  Where the reference finds a bit length through the
// exponent of an f32 cast (core/bitutil.py), this uses __clz.
// Widths n <= 16 (int8/int16 storage); es <= 4.
//
// Below them, what K1 (posit_codec.cu), K12 and K13 (recurrent_scan.cu)
// share: the direct round trip `posit_rt`, and the encode built on its
// rounding, `encode_tab`, with its per-block tables.  Template arguments
// N, ES name the format at compile time (P16_2, P8_2: every shift and mask
// a constant), kRuntime takes (n, es) from the arguments, and kNoRt (the
// round trip only) is no round trip.
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

// ---- format-specialised forms ---------------------------------------------
constexpr int kNoRt = 0;
constexpr int kRuntime = -1;

// The round trip through the general codec.
__device__ __forceinline__ float rt_codec(float x, int n, int es) {
  return posit_decode(posit_encode(x, n, es), n, es);
}

// x -> decode(encode(x)) in Posit<n, es> (n <= 16), bit-identical to
// rt_codec on every f32 input; identity for kNoRt.  Where the posit keeps
// every exponent bit and at least one fraction bit (te in
// [-(n-3-es) 2^es, (n-3-es) 2^es - 1]: P16_2 [-44, 43], P8_2 [-12, 11]),
// posit_encode rounds the f32 significand to nearest-even at the bit the
// regime's length fixes, and decoding gives that value back: one f32
// addition and subtraction of M = sign(x) 2^(te+sh), sh the dropped bits
// (x + M rounds at ulp(M), ties to even, a carry into the exponent
// included, and (x + M) - M is exact).  Elsewhere (0, NaN, Inf,
// subnormals, the binades next to maxpos and minpos) rt_codec.
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

// The encode by tables: bit-identical to posit_encode on every f32 input,
// any n <= 16.  On posit_rt's fast binades the pattern is that of the
// rounded value y = x + M - M, which is a posit of the format (posit_rt's
// claim), so nothing of y is dropped: its pattern is the pattern of 2^te(y)
// (regime and exponent bits, the fraction field's length fixed by te(y))
// plus y's 23 fraction bits shifted to that field.  Both depend on a
// biased f32 exponent only, so a block keeps them in two 256-entry tables:
// m[ex], the bits of |M| for x's exponent ex (0 off the fast binades: the
// lane then takes posit_encode), and f[ey], the pattern of 2^(ey - 127) in
// bits 31:16 and the fraction's right shift 23 - (fraction bits) in bits
// 4:0, for y's exponent ey (te(y) is x's or, after a carry, one more: at
// most (n-3-es) 2^es, where the field is empty and the shift 23).
struct EncodeTables {
  uint32_t m[256];
  uint32_t f[256];
};

// Entries t of both tables (thread t of a 256-thread block fills them).
template <int N, int ES>
__device__ __forceinline__ void encode_table_fill(EncodeTables& tab, int t,
                                                  int n_rt, int es_rt) {
  const int n = N > 0 ? N : n_rt;
  const int es = N > 0 ? ES : es_rt;
  const int span = (n - 3 - es) * (1 << es);
  const int lo = max(127 - span, 1);
  const int hi = min(126 + span, 232);
  uint32_t m = 0u, f = 0u;
  if (t >= lo && t <= hi) {
    const int k = (t - 127) >> es;
    const int sh = 26 - n + es + (k ^ (k >> 31));
    m = static_cast<uint32_t>(t + sh) << 23;
  }
  const int te = t - 127;
  if (t >= 1 && t <= 254 && te >= -span && te <= span) {
    const int k = te >> es;
    const int rlen = k >= 0 ? k + 2 : 1 - k;
    const int fbits = n - 1 - rlen - es;          // >= 0 on these binades
    const uint32_t pat = static_cast<uint32_t>(
        posit_encode(__uint_as_float(static_cast<uint32_t>(t) << 23), n, es));
    f = (pat << 16) | static_cast<uint32_t>(23 - fbits);
  }
  tab.m[t] = m;
  tab.f[t] = f;
}

// One f32 -> its pattern (sign-extended) by the tables; ORs a flag into
// `slow` where the lane must take posit_encode instead (encode_fix).
__device__ __forceinline__ int32_t encode_tab(float x,
                                              const EncodeTables& tab,
                                              uint32_t& slow) {
  const uint32_t b = __float_as_uint(x);
  const uint32_t m = tab.m[(b >> 23) & 0xFFu];
  slow |= m == 0u;
  const float M = __uint_as_float(m | (b & 0x80000000u));
  const uint32_t y = __float_as_uint(__fsub_rn(__fadd_rn(x, M), M));
  const uint32_t f = tab.f[(y >> 23) & 0xFFu];
  const int32_t body = static_cast<int32_t>(
      (f >> 16) + __funnelshift_r(y & 0x7FFFFFu, 0u, f));
  return static_cast<int32_t>(b) < 0 ? -body : body;
}

// The lanes encode_tab flagged, by posit_encode.
__device__ __forceinline__ int32_t encode_fix(float x, int32_t p,
                                              const EncodeTables& tab, int n,
                                              int es) {
  return tab.m[(__float_as_uint(x) >> 23) & 0xFFu] == 0u
             ? posit_encode(x, n, es) : p;
}
