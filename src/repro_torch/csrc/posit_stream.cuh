// The weight stream of the skinny posit GEMMs: K2's skinny form
// (pw_skinny_kernel in csrc/posit_gemm.cu, M <= 8) and K10's decode form
// (grouped_stream_kernel in csrc/grouped_gemm.cu, a group's rows in chunks
// of at most 8).  posit_gemm.cu's note states the design: a decode
// specialised per format (SkFmt), 16-byte weight loads by cp.async into
// the lane's own ring slots (or element by element into registers where
// rows are not 16-byte aligned), x staged per k-chunk in shared memory as
// [k][m] with m padded to MP, and each lane's products added by FFMA in
// increasing k; sk_block_sum then meets the block's k-lanes in a fixed
// order and sk_store_out adds a k-chunk's sums to the output.
#pragma once
#include "posit_codec.cuh"

namespace {

constexpr int kSkThreads = 256;
constexpr int kSkXsBytes = 32 * 1024;     // x staged per k-chunk, at most
constexpr int kSkTabBytes = 256 * 4;      // the static decode table

enum SkFmt { SK_TAB8 = 0, SK_P16E2 = 1, SK_GEN16 = 2 };
// Groups of a lane's pipeline step (k-rows of w [K, N]; one group of 4
// column loads for w [N, K]), its 16-byte loads, and the steps in flight
// (cp.async into the lane's own ring slots in shared memory).
__host__ __device__ constexpr int sk_step_groups(bool tb) {
  return tb ? 1 : 2;
}
__host__ __device__ constexpr int sk_step_loads(bool tb) {
  return tb ? 4 : 2;
}
__host__ __device__ constexpr int sk_stages(bool tb) { return tb ? 3 : 4; }

// Columns a lane holds, and k per group (one 16-byte load along k, or one
// k-row), for a format of eb bytes.
__host__ __device__ constexpr int sk_cpt(bool tb, int eb) {
  return tb ? 4 : 16 / eb;
}
__host__ __device__ constexpr int sk_kpg(bool tb, int eb) {
  return tb ? 16 / eb : 1;
}
struct SkArgs {
  const float* x;                         // [M, K]
  const void* w;                          // [K, N], or [N, K] (transpose_b)
  float* out;                             // [M, N]
  int M, N, K, n, es;
  int vec;                                // 16-byte weight loads allowed
  int tn, tk, bn, cs, per, chunk, nch, tiles;
  int xs_floats;                          // floats of the staged x region
  int ring_off;                           // floats before the load ring
};

// P16_2's table entry for i = a[30:23], the 8 bits after the sign of the
// magnitude a (the 16-bit pattern at the top of a 32-bit word).  The regime
// (run bits equal to i's first, and the opposite terminator) takes S = run
// + 2 bits of a with the sign; rotating a left by S - 7 (mod 32) puts its
// exponent bits at 24:23 and its fraction under them, the regime's top bits
// at 31:25 (for S <= 7 the zeros of a's low half wrap to the top).  The
// entry is the f32 bits of 2^(4k) less those regime bits, plus the
// rotation in bits 4:0.  The rotated a is zero below bit 12 and the fraction
// ends above bit 11, so bits 11:0 of the sum are cleared: the rotation
// never carries into the value.  Bit 11 (kSkSlow) marks a regime longer
// than i's 7 bits (0x00, 0xFF) and i = 0xFE, whose rotation would wrap a
// regime bit into bit 0.
constexpr uint32_t kSkSlow = 0x800u;
__device__ __forceinline__ uint32_t p16e2_entry(uint32_t i) {
  const uint32_t r0 = i >> 7;
  const uint32_t y = r0 ? (~i & 0xFFu) : i;
  if (y == 0u || i == 0xFEu) return kSkSlow;
  const int run = __clz(static_cast<int>(y)) - 24;       // 1..7
  const int S = run + 2;
  const int k = r0 ? run - 1 : -run;
  const uint32_t top = i >> (9 - S);                     // a's top S bits
  const uint32_t regime = (S <= 7 ? top : top & 0x7Fu) << 25;
  return (static_cast<uint32_t>(4 * k + 127) << 23) - regime +
         (static_cast<uint32_t>(S + 25) & 31u);
}

// One P16_2 element at the top of xi (low half zero) -> f32; ORs the entry
// into `slow`, whose kSkSlow bit then sends the load to posit_decode.
__device__ __forceinline__ float p16e2_fast(uint32_t xi, const uint32_t* tab,
                                            uint32_t& slow) {
  uint32_t a;                                 // abs.s32 keeps NaR's 2^31
  asm("abs.s32 %0, %1;" : "=r"(a) : "r"(xi));
  const uint32_t e = tab[(a >> 23) & 0xFFu];
  slow |= e;
  const uint32_t r = __funnelshift_l(a, a, e);           // rotl(a, e & 31)
  return __uint_as_float(((r + e) & 0x7FFFF000u) | (xi & 0x80000FFFu));
}

__device__ __forceinline__ uint32_t sk_word(const uint4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// Eight int16 posits, two per word (low half first) -> f32.
template <int FMT>
__device__ __forceinline__ void sk_decode8(const uint32_t (&wd)[4],
                                           float (&v)[8],
                                           const uint32_t* tab, int n,
                                           int es) {
  if constexpr (FMT == SK_P16E2) {
    uint32_t slow = 0u;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[2 * q] = p16e2_fast(wd[q] << 16, tab, slow);
      v[2 * q + 1] = p16e2_fast(wd[q] & 0xFFFF0000u, tab, slow);
    }
    if (__builtin_expect((slow & kSkSlow) != 0u, 0)) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v[2 * q] = posit_decode(static_cast<int32_t>(wd[q] & 0xFFFFu), 16, 2);
        v[2 * q + 1] = posit_decode(static_cast<int32_t>(wd[q] >> 16), 16, 2);
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[2 * q] = posit_decode(static_cast<int32_t>(wd[q] & 0xFFFFu), n, es);
      v[2 * q + 1] = posit_decode(static_cast<int32_t>(wd[q] >> 16), n, es);
    }
  }
}

__device__ __forceinline__ float sk_tab8(const uint32_t* tab, uint32_t w,
                                         int b) {
  return __uint_as_float(tab[(w >> (8 * b)) & 0xFFu]);
}

// 16 bytes' worth of weights at element offset `off` of a row with `avail`
// valid elements from there, loaded element by element (rows that are not
// 16-byte aligned); zeros past them, and all zeros when avail <= 0.
template <int EB>
__device__ __forceinline__ uint4 sk_load(const SkArgs& p, size_t off,
                                         int avail) {
  constexpr int VE = 16 / EB;
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (avail <= 0) return v;
  const unsigned char* src = static_cast<const unsigned char*>(p.w) +
                             off * EB;
  uint32_t wd[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < VE; ++e)
    if (e < avail) {
      const uint32_t b = EB == 2
          ? static_cast<uint32_t>(reinterpret_cast<const uint16_t*>(src)[e])
          : static_cast<uint32_t>(src[e]);
      wd[(e * EB) / 4] |= b << (8 * ((e * EB) % 4));
    }
  return make_uint4(wd[0], wd[1], wd[2], wd[3]);
}

// The raw weights of one group: w [K, N]: row g, the lane's VE columns;
// w [N, K]: k from g * VE, one load for each of the lane's 4 columns.
template <bool TB, int EB, int LPG>
__device__ __forceinline__ void sk_load_group(const SkArgs& p, uint4 (&b)[LPG],
                                              int g, int c0) {
  constexpr int VE = 16 / EB;
  if constexpr (TB) {
#pragma unroll
    for (int c = 0; c < LPG; ++c) {
      const int col = c0 + c;
      b[c] = sk_load<EB>(p, static_cast<size_t>(col) * p.K +
                                static_cast<size_t>(g) * VE,
                         col < p.N ? p.K - g * VE : 0);
    }
  } else {
    b[0] = sk_load<EB>(p, static_cast<size_t>(g) * p.N + c0,
                       g < p.K ? p.N - c0 : 0);
  }
}

template <bool TB, int EB, int U, int LPG>
__device__ __forceinline__ void sk_load_step(const SkArgs& p,
                                             uint4 (&b)[U][LPG], int g,
                                             int g1, int c0) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int gg = g + u * p.tk;
    if (gg < g1) sk_load_group<TB, EB, LPG>(p, b[u], gg, c0);
  }
}

template <int MP>
__device__ __forceinline__ void sk_xrow(const float* xs, int kk,
                                        float (&xv)[MP]) {
  const float4* r = reinterpret_cast<const float4*>(xs + kk * MP);
#pragma unroll
  for (int q = 0; q < MP / 4; ++q) {
    const float4 f = r[q];
    xv[4 * q] = f.x;
    xv[4 * q + 1] = f.y;
    xv[4 * q + 2] = f.z;
    xv[4 * q + 3] = f.w;
  }
}

// acc[m][c] += x[k][m] * w[k][c] for the group's k in increasing order;
// kk: the group's first row in the staged x.
template <int FMT, bool TB, int MP, int CPT, int LPG>
__device__ __forceinline__ void sk_group(const SkArgs& p, const uint4 (&b)[LPG],
                                         int kk, const float* xs,
                                         const uint32_t* tab,
                                         float (&acc)[MP][CPT]) {
  float xv[MP];
  if constexpr (!TB) {
    sk_xrow<MP>(xs, kk, xv);
    if constexpr (FMT == SK_TAB8) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float v = sk_tab8(tab, sk_word(b[0], c / 4), c % 4);
#pragma unroll
        for (int m = 0; m < MP; ++m) acc[m][c] = fmaf(xv[m], v, acc[m][c]);
      }
    } else {
      const uint32_t wd[4] = {b[0].x, b[0].y, b[0].z, b[0].w};
      float v[8];
      sk_decode8<FMT>(wd, v, tab, p.n, p.es);
#pragma unroll
      for (int c = 0; c < CPT; ++c)
#pragma unroll
        for (int m = 0; m < MP; ++m) acc[m][c] = fmaf(xv[m], v[c], acc[m][c]);
    }
  } else if constexpr (FMT == SK_TAB8) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      sk_xrow<MP>(xs, kk + j, xv);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float v = sk_tab8(tab, sk_word(b[c], j / 4), j % 4);
#pragma unroll
        for (int m = 0; m < MP; ++m) acc[m][c] = fmaf(xv[m], v, acc[m][c]);
      }
    }
  } else {
    // word q of each column's load holds its k = 2q (low half) and 2q + 1
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t wd[4] = {sk_word(b[0], q), sk_word(b[1], q),
                              sk_word(b[2], q), sk_word(b[3], q)};
      float v[8];
      sk_decode8<FMT>(wd, v, tab, p.n, p.es);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sk_xrow<MP>(xs, kk + 2 * q + h, xv);
#pragma unroll
        for (int c = 0; c < CPT; ++c)
#pragma unroll
          for (int m = 0; m < MP; ++m)
            acc[m][c] = fmaf(xv[m], v[2 * c + h], acc[m][c]);
      }
    }
  }
}

template <int FMT, bool TB, int MP, int CPT, int U, int LPG>
__device__ __forceinline__ void sk_step(const SkArgs& p,
                                        const uint4 (&b)[U][LPG], int g,
                                        int g0, int g1, const float* xs,
                                        const uint32_t* tab,
                                        float (&acc)[MP][CPT]) {
  constexpr int KPG = sk_kpg(TB, FMT == SK_TAB8 ? 1 : 2);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int gg = g + u * p.tk;
    if (gg < g1)
      sk_group<FMT, TB, MP, CPT, LPG>(p, b[u], (gg - g0) * KPG, xs, tab, acc);
  }
}

// xs[kk][m] = x[m][k0 + kk] for kk < rows; 0 for m >= M and k >= K.
template <int MP>
__device__ __forceinline__ void sk_stage_x(const SkArgs& p, float* xs, int k0,
                                           int rows) {
#pragma unroll 4
  for (int kk = threadIdx.x; kk < rows; kk += kSkThreads) {
    const int k = k0 + kk;
    float v[MP];
#pragma unroll
    for (int m = 0; m < MP; ++m)
      v[m] = m < p.M && k < p.K
                 ? __ldg(p.x + static_cast<size_t>(m) * p.K + k)
                 : 0.0f;
    float4* d = reinterpret_cast<float4*>(xs + kk * MP);
#pragma unroll
    for (int q = 0; q < MP / 4; ++q)
      d[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
}

// One tile's weight stream over k-groups [g0, g1) where rows are not
// 16-byte aligned: the lane's groups g0 + tk, + tk, ... loaded element by
// element into registers, the next step's in flight while one step is
// computed; x is staged behind the first loads when not yet staged.
template <int FMT, bool TB, int MP, int CPT>
__device__ __forceinline__ void sk_stream_rows(const SkArgs& p, int g0,
                                               int g1, int tk, int c0,
                                               float* xs, const uint32_t* tab,
                                               float (&acc)[MP][CPT],
                                               bool& staged) {
  constexpr int EB = FMT == SK_TAB8 ? 1 : 2;
  constexpr int KPG = sk_kpg(TB, EB);
  constexpr int LPG = TB ? CPT : 1;        // 16-byte loads per group
  constexpr int U = sk_step_groups(TB);
  const int step = U * p.tk;
  uint4 b0[U][LPG], b1[U][LPG];
  int g = g0 + tk;
  sk_load_step<TB, EB, U, LPG>(p, b0, g, g1, c0);
  if (!staged) {                           // behind the first loads
    sk_stage_x<MP>(p, xs, g0 * KPG, max(0, g1 - g0) * KPG);
    __syncthreads();
    staged = true;
  }
  while (g < g1) {
    sk_load_step<TB, EB, U, LPG>(p, b1, g + step, g1, c0);
    sk_step<FMT, TB, MP, CPT, U, LPG>(p, b0, g, g0, g1, xs, tab, acc);
    g += step;
    if (g >= g1) break;
    sk_load_step<TB, EB, U, LPG>(p, b0, g + step, g1, c0);
    sk_step<FMT, TB, MP, CPT, U, LPG>(p, b1, g, g0, g1, xs, tab, acc);
    g += step;
  }
}

// cp.async of 16 bytes into shared memory; zero-filled when !valid.
__device__ __forceinline__ void sk_cp16(uint4* dst, const void* src,
                                        bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void sk_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void sk_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One pipeline step's 16-byte loads into ring stage `st` (a lane's own
// slots, [stage][load][thread]); a group past g1 loads nothing.
template <bool TB, int EB, int U, int LPG>
__device__ __forceinline__ void sk_issue(const SkArgs& p, uint4* ring, int st,
                                         int g, int g1, int c0) {
  constexpr int VE = 16 / EB;
  const unsigned char* w = static_cast<const unsigned char*>(p.w);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int gg = g + u * p.tk;
    if (gg >= g1) continue;
#pragma unroll
    for (int l = 0; l < LPG; ++l) {
      uint4* dst = ring + ((st * U + u) * LPG + l) * kSkThreads + threadIdx.x;
      if constexpr (TB) {
        const int col = c0 + l;
        const bool ok = col < p.N;
        sk_cp16(dst, w + (ok ? (static_cast<size_t>(col) * p.K +
                                static_cast<size_t>(gg) * VE) * EB : 0), ok);
      } else {
        const bool ok = c0 < p.N;
        sk_cp16(dst, w + (ok ? (static_cast<size_t>(gg) * p.N + c0) * EB : 0),
                ok);
      }
    }
  }
  sk_cp_commit();
}

// The tile's stream for 16-byte rows: sk_stages steps of loads in flight
// through cp.async into the lane's ring slots, each step computed when its
// own copies have landed (no barrier: a lane reads only what it copied).
template <int FMT, bool TB, int MP, int CPT>
__device__ __forceinline__ void sk_stream_ring(const SkArgs& p, int g0, int g1,
                                               int tk, int c0, float* xs,
                                               uint4* ring,
                                               const uint32_t* tab,
                                               float (&acc)[MP][CPT],
                                               bool& staged) {
  constexpr int EB = FMT == SK_TAB8 ? 1 : 2;
  constexpr int KPG = sk_kpg(TB, EB);
  constexpr int LPG = TB ? CPT : 1;
  constexpr int U = sk_step_groups(TB);
  constexpr int S = sk_stages(TB);
  const int step = U * p.tk;
#pragma unroll
  for (int st = 0; st < S - 1; ++st)
    sk_issue<TB, EB, U, LPG>(p, ring, st, g0 + tk + st * step, g1, c0);
  if (!staged) {                           // behind the first loads
    sk_stage_x<MP>(p, xs, g0 * KPG, max(0, g1 - g0) * KPG);
    __syncthreads();
    staged = true;
  }
  int st = 0;
  for (int g = g0 + tk; g < g1; g += step) {
    sk_issue<TB, EB, U, LPG>(p, ring, st == 0 ? S - 1 : st - 1,
                             g + (S - 1) * step, g1, c0);
    sk_cp_wait<S - 1>();                   // this step's copies landed
    uint4 b[U][LPG];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int l = 0; l < LPG; ++l)
        b[u][l] = ring[((st * U + u) * LPG + l) * kSkThreads + threadIdx.x];
    sk_step<FMT, TB, MP, CPT, U, LPG>(p, b, g, g0, g1, xs, tab, acc);
    st = st == S - 1 ? 0 : st + 1;
  }
  sk_cp_wait<0>();
}

// The block's decode table, entry t by thread t: int8 formats, every
// pattern's f32 bits; P16_2, its regime table (p16e2_entry).  Read after
// the first barrier.
template <int FMT>
__device__ __forceinline__ void sk_fill_table(uint32_t* tab, int t, int n,
                                              int es) {
  if constexpr (FMT == SK_TAB8)
    tab[t] = __float_as_uint(posit_decode(t, n, es));
  else if constexpr (FMT == SK_P16E2)
    tab[t] = p16e2_entry(static_cast<uint32_t>(t));
}

// The block's k-lanes of one tile meet in `red`, slabs of ss = MP bn + 4
// floats: lanes tk < half (= p.tk / 2) store their sums in their slab
// (red + (tk mod half) ss), lanes tk >= half add theirs to it, and output
// o = m bn + oc of the tile (o = t + i 256, below mb = M bn) is the sum of
// the half slabs in order from 0, in vals[i] (0 past mb).
template <int MP, int CPT, int MAXO>
__device__ __forceinline__ void sk_block_sum(const SkArgs& p,
                                             const float (&acc)[MP][CPT],
                                             const float* red, float* slab,
                                             int half, int ss, int mb, int t,
                                             int tn, int tk,
                                             float (&vals)[MAXO]) {
  __syncthreads();                     // the last tile's sums are read
  const int col = tn * CPT;
  if (tk < half) {
#pragma unroll
    for (int m = 0; m < MP; ++m)
#pragma unroll
      for (int j = 0; j < CPT; j += 4)
        *reinterpret_cast<float4*>(slab + m * p.bn + col + j) =
            make_float4(acc[m][j], acc[m][j + 1], acc[m][j + 2],
                        acc[m][j + 3]);
  }
  __syncthreads();
  if (tk >= half) {
#pragma unroll
    for (int m = 0; m < MP; ++m)
#pragma unroll
      for (int j = 0; j < CPT; j += 4) {
        float4* d = reinterpret_cast<float4*>(slab + m * p.bn + col + j);
        const float4 s = *d;
        *d = make_float4(s.x + acc[m][j], s.y + acc[m][j + 1],
                         s.z + acc[m][j + 2], s.w + acc[m][j + 3]);
      }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < MAXO; ++i) {
    const int o = t + i * kSkThreads;
    vals[i] = 0.0f;
    if (o < mb) {
      const int m = o / p.bn, oc = o % p.bn;
      float s = 0.0f;
      for (int sl = 0; sl < half; ++sl) s += red[sl * ss + m * p.bn + oc];
      vals[i] = s;
    }
  }
}

// A tile's sums (outputs t + i 256 below mb) -> out [M, N] at column n0:
// k-chunk c == 0 stores, a later chunk adds its sums to the earlier ones'
// (chunk order).
template <int MAXO>
__device__ __forceinline__ void sk_store_out(const SkArgs& p,
                                             const float (&vals)[MAXO],
                                             int t, int mb, int n0, int c) {
#pragma unroll
  for (int i = 0; i < MAXO; ++i) {
    const int o = t + i * kSkThreads;
    if (o >= mb) continue;
    const int m = o / p.bn, n = n0 + o % p.bn;
    if (n >= p.N) continue;
    float* d = p.out + static_cast<size_t>(m) * p.N + n;
    *d = c == 0 ? vals[i] : *d + vals[i];
  }
}

}  // namespace
