// Integer-domain posit arithmetic per lane: the FPPU datapath of the paper
// (§IV-V) as device functions, for n <= 16.
//
// Line-for-line ports of the port's plain versions, which are themselves
// the reference's int32 sequences:
//   posit_decode_fields  <- repro_torch/core/decode.py::decode
//   encode_fir           <- repro_torch/core/encode.py::encode_fir
//   lane_padd/psub/pmul/pfma/pdiv <- repro_torch/core/ops.py
//   recip_poly_fx, nr_round_fx, approx_quotient <- repro_torch/core/recip.py
// The reference computes in XLA's int32, which wraps on overflow and floors
// on `//`.  Here every sum or product that can pass 2^31 is computed in
// uint32 and reinterpreted (C++ leaves signed overflow undefined), floor
// division is written out (C++ `/` truncates toward zero), and every shift
// amount stays in [0, 31].  Right shifts of negative int32 are arithmetic
// under nvcc, as XLA's are.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace parith {

enum { KLASS_ZERO = 0, KLASS_NAR = 1, KLASS_NORMAL = 2 };

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t wmul(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) *
                              static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t wshl(int32_t a, int s) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) << s);
}
// (1 << s) - 1 for s in [0, 31]; s = 31 gives INT_MAX, as the wrapped int32
// of the reference does.
__device__ __forceinline__ int32_t lowmask(int s) {
  return static_cast<int32_t>((1u << s) - 1u);
}
// bit_length of a non-negative int32 (0 -> 0).
__device__ __forceinline__ int32_t bitlen(int32_t y) { return 32 - __clz(y); }
// floor(a / b) for b > 0.
__device__ __forceinline__ int32_t floordiv(int32_t a, int32_t b) {
  const int32_t q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

struct Fields {
  int32_t klass, s, te, M;
};

// posit bits -> (klass, sign, te, M), M in [2^(n-3), 2^(n-2)).  M is a
// stub on ZERO/NAR lanes (callers mask by klass).
__device__ __forceinline__ Fields posit_decode_fields(int32_t p, int n,
                                                      int es) {
  const int32_t mask = (1 << n) - 1;
  const int32_t u = p & mask;
  Fields f;
  f.klass = (u == 0) ? KLASS_ZERO
                     : (u == (1 << (n - 1)) ? KLASS_NAR : KLASS_NORMAL);
  f.s = (u >> (n - 1)) & 1;
  int32_t absu = f.s ? ((-u) & mask) : u;
  if (f.klass != KLASS_NORMAL) absu = 1;
  const int32_t x = (absu << 1) & mask;          // drop sign, regime at MSB
  const int32_t b = (x >> (n - 1)) & 1;
  const int32_t y = b ? (~x & mask) : x;
  const int32_t run = min(n - bitlen(y), n - 1);
  const int32_t k = b ? run - 1 : -run;
  const int32_t rem = wshl(x, run + 1) & mask;   // exponent+fraction
  int32_t e = 0, frac = rem;
  if (es > 0) {
    e = rem >> (n - es);
    frac = (rem << es) & mask;
  }
  f.te = k * (1 << es) + e;
  f.M = (1 << (n - 3)) | (frac >> 3);            // bottom 3+es bits are 0
  return f;
}

// RNE-encode (-1)^s * 2^te * (M / 2^W) to the n-bit pattern in [0, 2^n).
// M is normalized to [2^W, 2^(W+1)) by the callers; sticky is 0/1.
__device__ __forceinline__ int32_t encode_fir(int32_t s, int32_t te,
                                              int32_t M, int W,
                                              int32_t sticky, int n, int es) {
  const int32_t mask = (1 << n) - 1;
  const int32_t te_max = (n - 2) * (1 << es);
  const int32_t te_min = -te_max;
  const bool sat_hi = te > te_max;
  const bool sat_lo = te < te_min;
  te = min(max(te, te_min), te_max);
  const int32_t k = te >> es;                    // arithmetic: floor
  const int32_t e = te - k * (1 << es);

  const bool k_pos = k >= 0;
  const int32_t rlen = k_pos ? k + 2 : 1 - k;
  const int32_t ones = (1 << (min(max(k, 0), n) + 1)) - 1;
  const int32_t regime = k_pos ? (ones << 1) : 1;

  const int32_t frac = M - (1 << W);
  const int32_t nre = rlen + es;
  const int32_t body_bits = n - 1;
  const int32_t combined_re = (regime << es) | e;

  // case A: some fraction bits survive (nre < n-1)
  const int32_t ffield = max(body_bits - nre, 0);
  const int32_t shiftA = min(max(W - ffield, 1), 31);
  const int32_t keptA = frac >> shiftA;
  const int32_t rA = (frac >> (shiftA - 1)) & 1;
  const int32_t sA = ((frac & lowmask(shiftA - 1)) != 0) | sticky;
  const int32_t bodyA = wshl(combined_re, ffield) | keptA;

  // case B: regime+exponent fill the body (nre >= n-1)
  const int32_t shiftB = min(max(nre - body_bits, 0), 31);
  const int32_t bodyB = combined_re >> shiftB;
  const int32_t shiftB1 = max(shiftB - 1, 0);
  const int32_t rB = shiftB > 0 ? (combined_re >> shiftB1) & 1
                                : (frac >> (W - 1)) & 1;
  const bool low_re = (combined_re & lowmask(shiftB1)) != 0;
  const bool low_fr_all = frac != 0;
  const bool low_fr_tail = (frac & lowmask(W - 1)) != 0;
  const int32_t sB =
      static_cast<int32_t>(shiftB > 0 ? (low_re || low_fr_all) : low_fr_tail)
      | sticky;

  const bool caseA = nre < body_bits;
  int32_t body = caseA ? bodyA : bodyB;
  const int32_t r = caseA ? rA : rB;
  const int32_t st = caseA ? sA : sB;
  body += r & (st | (body & 1));                 // RNE on the monotone pattern

  body = min(max(body, 1), mask >> 1);
  if (sat_hi) body = mask >> 1;
  if (sat_lo) body = 1;
  return s == 1 ? ((-body) & mask) : body;
}

__device__ __forceinline__ int32_t pneg_bits(int32_t p, int n) {
  const int32_t mask = (1 << n) - 1;
  const int32_t u = p & mask;
  return u == (1 << (n - 1)) ? u : ((-u) & mask);
}

// Shared add stage of padd/pfma (repro_torch/core/ops.py::_align_add):
// align M2 to M1 with G guard bits and a sticky bit, add or subtract,
// renormalize to [2^W, 2^(W+1)), encode.  *zero_mag: exact zero result.
__device__ __forceinline__ int32_t align_add(int32_t s1, int32_t te1,
                                             int32_t M1, int32_t s2,
                                             int32_t te2, int32_t M2, int G,
                                             int W, int n, int es,
                                             bool* zero_mag) {
  const int32_t M1w = M1 << G;
  const int32_t M2w = M2 << G;
  const int32_t d = min(max(te1 - te2, 0), W + 2);
  const int32_t M2s = M2w >> d;
  const int32_t sticky = (M2w & lowmask(d)) != 0;
  const bool eff_sub = s1 != s2;
  int32_t mag = eff_sub ? M1w - M2s : M1w + M2s;
  if (eff_sub && sticky) mag -= 1;
  const int32_t shift_left = (W + 1) - bitlen(max(mag, 1));
  const int32_t sl = min(max(shift_left, 0), 31);
  const int32_t sr = min(max(-shift_left, 0), 31);
  const int32_t lost = (mag & lowmask(sr)) != 0;
  const int32_t Mn = shift_left >= 0 ? wshl(mag, sl) : (mag >> sr);
  *zero_mag = mag == 0;
  return encode_fir(s1, te1 - shift_left, max(Mn, 1 << W), W, sticky | lost,
                    n, es);
}

// ---- PADD / PSUB (paper §IV-A) ---------------------------------------------
__device__ __forceinline__ int32_t lane_padd(int32_t a, int32_t b, int n,
                                             int es) {
  const int32_t mask = (1 << n) - 1;
  const Fields fa = posit_decode_fields(a, n, es);
  const Fields fb = posit_decode_fields(b, n, es);
  const bool swap = (fb.te > fa.te) || ((fb.te == fa.te) && (fb.M > fa.M));
  const Fields& f1 = swap ? fb : fa;
  const Fields& f2 = swap ? fa : fb;
  const int W = n;                               // Wd + 3 guard bits
  bool zero_mag;
  int32_t res = align_add(f1.s, f1.te, f1.M, f2.s, f2.te, f2.M, 3, W, n, es,
                          &zero_mag);
  if (zero_mag) res = 0;
  if (fa.klass == KLASS_ZERO) res = b & mask;
  if (fb.klass == KLASS_ZERO) res = a & mask;
  if (fa.klass == KLASS_ZERO && fb.klass == KLASS_ZERO) res = 0;
  if (fa.klass == KLASS_NAR || fb.klass == KLASS_NAR) res = 1 << (n - 1);
  return res;
}

__device__ __forceinline__ int32_t lane_psub(int32_t a, int32_t b, int n,
                                             int es) {
  return lane_padd(a, pneg_bits(b, n), n, es);
}

// ---- PMUL (paper §IV-B) ----------------------------------------------------
__device__ __forceinline__ int32_t lane_pmul(int32_t a, int32_t b, int n,
                                             int es) {
  const Fields fa = posit_decode_fields(a, n, es);
  const Fields fb = posit_decode_fields(b, n, es);
  const int32_t P = fa.M * fb.M;                 // <= 28 bits
  const int W = 2 * (n - 3);
  const int32_t top = (P >> (W + 1)) & 1;
  const int32_t M = top ? P >> 1 : P;
  const int32_t st = top ? P & 1 : 0;
  int32_t res = encode_fir(fa.s ^ fb.s, fa.te + fb.te + top, M, W, st, n, es);
  if (fa.klass == KLASS_ZERO || fb.klass == KLASS_ZERO) res = 0;
  if (fa.klass == KLASS_NAR || fb.klass == KLASS_NAR) res = 1 << (n - 1);
  return res;
}

// ---- PFMADD: round(a*b + c), one rounding ---------------------------------
__device__ __forceinline__ int32_t lane_pfma(int32_t a, int32_t b, int32_t c,
                                             int n, int es) {
  const int32_t mask = (1 << n) - 1;
  const int Wd = n - 3;
  const Fields fa = posit_decode_fields(a, n, es);
  const Fields fb = posit_decode_fields(b, n, es);
  const Fields fc = posit_decode_fields(c, n, es);
  const int32_t sp = fa.s ^ fb.s;
  int32_t P = fa.M * fb.M;
  const int32_t top = (P >> (2 * Wd + 1)) & 1;
  const int32_t tep = fa.te + fb.te + top;
  if (!top) P <<= 1;                             // normalize, keep every bit
  const int Wp = 2 * Wd + 1;
  const int32_t Cw = fc.M << (Wp - Wd);
  const bool p_big = (tep > fc.te) || ((tep == fc.te) && (P >= Cw));
  const int W = Wp + 2;                          // G = 2: W = 2n-3 <= 29
  bool zero_mag;
  int32_t res = p_big ? align_add(sp, tep, P, fc.s, fc.te, Cw, 2, W, n, es,
                                  &zero_mag)
                      : align_add(fc.s, fc.te, Cw, sp, tep, P, 2, W, n, es,
                                  &zero_mag);
  if (zero_mag) res = 0;
  // the reference's mask order: a*b == 0 -> c; c == 0 -> round(a*b)
  const bool ab_zero = fa.klass == KLASS_ZERO || fb.klass == KLASS_ZERO;
  const bool c_zero = fc.klass == KLASS_ZERO;
  if (ab_zero) res = c & mask;
  if (c_zero && !ab_zero) res = lane_pmul(a, b, n, es);
  if (ab_zero && c_zero) res = 0;
  if (fa.klass == KLASS_NAR || fb.klass == KLASS_NAR || fc.klass == KLASS_NAR)
    res = 1 << (n - 1);
  return res;
}

// ---- reciprocal datapath (repro_torch/core/recip.py) -----------------------
constexpr int kYF = 28;       // frac bits of the reciprocal estimate y
constexpr int kSplit = 14;    // hi/lo split of 28f operands

// (A * Y) >> 14 with Y split at 14 bits; wraps like the reference's int32.
__device__ __forceinline__ int32_t mul_y(int32_t A, int32_t Y) {
  const int32_t Yh = Y >> kSplit;
  const int32_t Yl = Y & ((1 << kSplit) - 1);
  return wadd(wmul(A, Yh), wmul(A, Yl) >> kSplit);
}

// Algorithm 1: X = x*2^14, x in [0.5, 1) -> y0 at 28 frac bits.
__device__ __forceinline__ int32_t recip_poly_fx(int32_t X, int32_t K1q,
                                                 int32_t K2q) {
  const int32_t B = K1q - X;
  const int32_t C = wmul(X, B);
  const int32_t D = wsub(K2q, C);
  const int32_t E = mul_y(B, D);
  return wshl(E, 2);
}

// y <- y*(2 - x*y), Y 28f, X 14f.
__device__ __forceinline__ int32_t nr_round_fx(int32_t Y, int32_t X) {
  const int32_t T = mul_y(X, Y);
  const int32_t U = wsub(2 << kYF, T);
  const int32_t hi = mul_y(U >> kSplit, Y);
  const int32_t lo = wmul(U & ((1 << kSplit) - 1), Y >> kSplit) >> kSplit;
  return wadd(hi, lo);
}

enum DivMode { DIV_EXACT = 0, DIV_POLY = 1, DIV_POLY_CORRECTED = 2,
               DIV_PACOGEN = 3 };

// ---- PDIV (paper §IV-C, §V-A) ----------------------------------------------
template <int MODE>
__device__ __forceinline__ int32_t lane_pdiv(int32_t a, int32_t b, int n,
                                             int es, int nr_rounds,
                                             int32_t K1q, int32_t K2q,
                                             const int32_t* __restrict__ lut) {
  const int Wd = n - 3;
  const int Wq = n;
  const Fields fa = posit_decode_fields(a, n, es);
  const Fields fb = posit_decode_fields(b, n, es);
  const int32_t num = fa.M << (Wq + 1);          // <= 2n-1 bits
  int32_t q, rem = 0;
  if (MODE == DIV_EXACT) {
    q = floordiv(num, fb.M);
    rem = num - q * fb.M;
  } else {
    int32_t Y;
    if (MODE == DIV_PACOGEN) {
      const int32_t frac = fb.M - (1 << Wd);
      const int32_t idx = Wd >= 8 ? frac >> (Wd - 8) : frac << (8 - Wd);
      Y = __ldg(lut + idx) << (kYF - 9);
      const int32_t X2 = fb.M << (14 - Wd);      // m_b in [1, 2) at 14f
      for (int i = 0; i < nr_rounds; ++i) Y = nr_round_fx(Y, X2);
      q = mul_y(fa.M, Y) >> (kYF - kSplit - (Wq + 1 - Wd));
    } else {
      const int32_t X = fb.M << (13 - Wd);       // x = m_b/2 at 14f
      Y = recip_poly_fx(X, K1q, K2q);
      for (int i = 0; i < nr_rounds; ++i) Y = nr_round_fx(Y, X);
      q = mul_y(fa.M, Y) >> (kYF - kSplit - (Wq - Wd));
    }
    q = min(max(q, 1), 1 << (Wq + 2));
    if (MODE == DIV_POLY_CORRECTED) {
      // q + floor((num - q*Mb) / Mb) == floor(num / Mb) for any q; q*Mb
      // may pass 2^31 for p16 and wraps, as in the reference
      q = wadd(q, floordiv(wsub(num, wmul(q, fb.M)), fb.M));
      rem = wsub(num, wmul(q, fb.M));
    }
  }
  const int32_t big = (q >> (Wq + 1)) & 1;       // q in (2^Wq, 2^(Wq+2))
  const int32_t stq = big ? q & 1 : 0;
  if (big) q >>= 1;
  const int32_t te = fa.te - fb.te - 1 + big;
  const int32_t st = (MODE == DIV_EXACT || MODE == DIV_POLY_CORRECTED)
                         ? ((rem != 0) | stq)
                         : 1;                    // residual unknown: inexact
  int32_t res = encode_fir(fa.s ^ fb.s, te, max(q, 1 << Wq), Wq, st, n, es);
  if (fa.klass == KLASS_ZERO) res = 0;
  if (fb.klass == KLASS_ZERO) res = 1 << (n - 1);  // x/0 = NaR
  if (fa.klass == KLASS_NAR || fb.klass == KLASS_NAR) res = 1 << (n - 1);
  return res;
}

// n-bit pattern -> sign-extended int32 (fits the storage type).
__device__ __forceinline__ int32_t sign_extend(int32_t u, int n) {
  return (u & (1 << (n - 1))) ? u - (1 << n) : u;
}

}  // namespace parith
