// Exact bf16 pieces on Hopper's tensor cores: the staging and mma.sync
// machinery of the tiled posit GEMM (K2's tiled form, csrc/posit_gemm.cu)
// and of the grouped GEMM's tiled forms (K10 at S >= 16 E, K11,
// csrc/grouped_gemm.cu).  The arithmetic (pieces, kept products, their
// order) and its error bound are stated in posit_gemm.cu's note.
//
// - Operand: a stored operand (f32 or posit ints), its shape and whether
//   its rows allow 4-element chunk loads.
// - split_pair: two f32 values -> P bf16 pieces each, exact (see the note).
// - load_tile / store_tile: global -> registers (raw f32 or posit ints),
//   then registers -> the P bf16 planes of a shared stage (decoded and
//   split once per element; a posit by posit_decode, or by the skinny
//   form's table decode of posit_stream.cuh where the caller names it).
// - mma_mainloop: the k-loop of one BM x BN output tile over two shared
//   stages: the next k-tile's raw loads in flight over the current tile's
//   mma.sync m16n8k16, ldmatrix (.trans for [k][m] A and [k][n] B), one
//   block barrier per k-tile.
// - store_acc_f32: a tile's accumulators -> f32 rows [m0, row_end).
#pragma once
#include <cuda_bf16.h>

#include "posit_codec.cuh"
#include "posit_stream.cuh"

namespace {

constexpr int kBK = 32;              // k per tile: two m16n8k16 steps
constexpr int kPad = 8;              // bf16 elements of padding per row
constexpr int kStages = 2;
// The output tiles (BM x BN with WM x WN warps), largest first.
constexpr int kNumTiles = 2;
constexpr int kTileBM[kNumTiles] = {128, 64};
constexpr int kTileBN[kNumTiles] = {128, 64};
constexpr int kTileWM[kNumTiles] = {2, 2};   // warps along m
constexpr int kTileWN[kNumTiles] = {4, 2};   // warps along n

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// ---- operands --------------------------------------------------------------
struct Operand {
  const void* p;
  int dtype, n, es;                  // DT_F32, or posit ints of (n, es)
  int rows, cols;                    // stored shape; cols contiguous
  int vec;                           // rows 4-element aligned: chunk loads
};

// ---- bf16 pieces ---------------------------------------------------------
// Two elements x0, x1 -> P packed bf16x2 words (cvt.rn.bf16x2.f32): word p
// holds x0's piece p in its low half and x1's in its high half, each piece
// rounded to nearest from what the earlier ones leave.  Where bf16(x)
// overflows, x1 is rounded toward zero instead; a non-finite x keeps
// x1 = x and zero pieces after it.
__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}
__device__ __forceinline__ uint32_t bf2_rn(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
template <int P>
__device__ __forceinline__ void split_pair(float x0, float x1,
                                           uint32_t (&h)[P]) {
  uint32_t w = bf2_rn(x0, x1);
  if (P == 3) {                                  // |x| above bf16's max
    if (isinf(bf_lo(w)) && isfinite(x0))
      w = (w & 0xFFFF0000u) | (__float_as_uint(x0) >> 16);
    if (isinf(bf_hi(w)) && isfinite(x1))
      w = (w & 0xFFFFu) | (__float_as_uint(x1) & 0xFFFF0000u);
  }
  h[0] = w;
  float r0 = isfinite(x0) ? x0 - bf_lo(w) : 0.0f;
  float r1 = isfinite(x1) ? x1 - bf_hi(w) : 0.0f;
#pragma unroll
  for (int p = 1; p < P; ++p) {
    w = bf2_rn(r0, r1);
    h[p] = w;
    r0 = r0 - bf_lo(w);
    r1 = r1 - bf_hi(w);
  }
}

// Raw registers of one 4-element chunk: f32, or 4 posit ints (int16 in
// x and y, int8 in x).
template <int P>
struct RawChunk;
template <>
struct RawChunk<3> {
  using T = float4;
};
template <>
struct RawChunk<2> {
  using T = uint2;
};

// Global -> registers: chunk c of an R x C tile (stored orientation) at
// (r0, c0); zero past the operand's rows and columns.
template <int P, int R, int C, int NT>
__device__ __forceinline__ void load_tile(
    const Operand& op, int r0, int c0,
    typename RawChunk<P>::T (&raw)[R * C / 4 / NT]) {
  constexpr int CPR = C / 4;
  constexpr int CH = R * CPR / NT;
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int c = threadIdx.x + i * NT;
    const int gr = r0 + c / CPR, gc = c0 + (c % CPR) * 4;
    const bool in = gr < op.rows && gc < op.cols;
    const size_t base = static_cast<size_t>(gr) * op.cols + gc;
    if constexpr (P == 3) {
      const float* p = static_cast<const float*>(op.p) + base;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (in) {
        if (op.vec) {
          v = __ldg(reinterpret_cast<const float4*>(p));
        } else {
          v.x = __ldg(p);
          if (gc + 1 < op.cols) v.y = __ldg(p + 1);
          if (gc + 2 < op.cols) v.z = __ldg(p + 2);
          if (gc + 3 < op.cols) v.w = __ldg(p + 3);
        }
      }
      raw[i] = v;
    } else {
      uint2 v = make_uint2(0u, 0u);
      if (in && op.dtype == DT_I16) {
        const uint16_t* p = static_cast<const uint16_t*>(op.p) + base;
        if (op.vec) {
          v = __ldg(reinterpret_cast<const uint2*>(p));
        } else {
          uint32_t e[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (gc + j < op.cols) e[j] = p[j];
          v = make_uint2(e[0] | (e[1] << 16), e[2] | (e[3] << 16));
        }
      } else if (in) {
        const uint8_t* p = static_cast<const uint8_t*>(op.p) + base;
        if (op.vec) {
          v.x = __ldg(reinterpret_cast<const unsigned int*>(p));
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (gc + j < op.cols) v.x |= static_cast<uint32_t>(p[j]) << (8 * j);
        }
      }
      raw[i] = v;
    }
  }
}

// Registers -> the P shared planes of one stage: decode, split, and store
// each piece's 4 bf16 as one 8-byte word.  A posit decodes by FMT (SkFmt,
// posit_stream.cuh) from the block's table `tab` where FMT is SK_P16E2
// (flagged loads of 4 through posit_decode) or SK_TAB8, else by
// posit_decode with the operand's runtime (n, es).
template <int P, int R, int C, int NT, int FMT = -1>
__device__ __forceinline__ void store_tile(
    const Operand& op, const typename RawChunk<P>::T (&raw)[R * C / 4 / NT],
    __nv_bfloat16* planes, const uint32_t* tab = nullptr) {
  constexpr int CPR = C / 4;
  constexpr int CH = R * CPR / NT;
  constexpr int LD = C + kPad;
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int c = threadIdx.x + i * NT;
    const int r = c / CPR, col = (c % CPR) * 4;
    float v[4];
    if constexpr (P == 3) {
      v[0] = raw[i].x;
      v[1] = raw[i].y;
      v[2] = raw[i].z;
      v[3] = raw[i].w;
    } else if constexpr (FMT == SK_P16E2) {
      uint32_t slow = 0u;
      v[0] = p16e2_fast(raw[i].x << 16, tab, slow);
      v[1] = p16e2_fast(raw[i].x & 0xFFFF0000u, tab, slow);
      v[2] = p16e2_fast(raw[i].y << 16, tab, slow);
      v[3] = p16e2_fast(raw[i].y & 0xFFFF0000u, tab, slow);
      if (__builtin_expect((slow & kSkSlow) != 0u, 0)) {
        v[0] = posit_decode(static_cast<int32_t>(raw[i].x & 0xFFFFu), 16, 2);
        v[1] = posit_decode(static_cast<int32_t>(raw[i].x >> 16), 16, 2);
        v[2] = posit_decode(static_cast<int32_t>(raw[i].y & 0xFFFFu), 16, 2);
        v[3] = posit_decode(static_cast<int32_t>(raw[i].y >> 16), 16, 2);
      }
    } else if constexpr (FMT == SK_TAB8) {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = sk_tab8(tab, raw[i].x, j);
    } else if (op.dtype == DT_I16) {
      v[0] = posit_decode(static_cast<int32_t>(raw[i].x & 0xFFFFu), op.n,
                          op.es);
      v[1] = posit_decode(static_cast<int32_t>(raw[i].x >> 16), op.n, op.es);
      v[2] = posit_decode(static_cast<int32_t>(raw[i].y & 0xFFFFu), op.n,
                          op.es);
      v[3] = posit_decode(static_cast<int32_t>(raw[i].y >> 16), op.n, op.es);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = posit_decode(static_cast<int32_t>((raw[i].x >> (8 * j)) & 0xFFu),
                            op.n, op.es);
    }
    uint32_t h01[P], h23[P];
    split_pair<P>(v[0], v[1], h01);
    split_pair<P>(v[2], v[3], h23);
#pragma unroll
    for (int p = 0; p < P; ++p)
      *reinterpret_cast<uint2*>(planes + p * R * LD + r * LD + col) =
          make_uint2(h01[p], h23[p]);
  }
}

// ---- tensor-core primitives ----------------------------------------------
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

Operand make_operand(const void* p, int dtype, int n, int es, int rows,
                     int cols) {
  const size_t chunk = 4 * (dtype == DT_F32 ? 4 : dtype == DT_I16 ? 2 : 1);
  const bool vec = cols % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(p) % chunk == 0;
  return Operand{p, dtype, n, es, rows, cols, vec ? 1 : 0};
}

// ---- the k-loop of one output tile ------------------------------------------
// Warp layout and sizes of a BM x BN tile with WM x WN warps.
template <int BM, int BN, int WM, int WN>
struct MmaTile {
  static constexpr int NT = WM * WN * 32;
  static constexpr int WTM = BM / WM, WTN = BN / WN;
  static constexpr int MF = WTM / 16, NF = WTN / 8;
};

// acc += A [M, K] (TA: stored [K, M]) x B [K, N] (TB: stored [N, K]) for
// the BM x BN tile at (m0, n0), over k-tiles kt0 <= kt < kt1, tile kt
// covering k from kbase + kt kBK; PA / PB bf16 pieces per element (3: f32,
// 2: posit).  Past an operand's rows and columns, and so past K, its
// elements are zero.  smem_raw holds the two stages; the loop leaves every
// thread past its last barrier, so a next call may reuse them.  A posit B
// decodes by FB from `tab` (store_tile).
template <int BM, int BN, int WM, int WN, int PA, int PB, bool TA, bool TB,
          int FB = -1>
__device__ __forceinline__ void mma_mainloop(
    const Operand& a, const Operand& b, int m0, int n0, int kbase, int kt0,
    int kt1, unsigned char* smem_raw,
    float (&acc)[MmaTile<BM, BN, WM, WN>::MF][MmaTile<BM, BN, WM, WN>::NF]
                [4],
    const uint32_t* tab = nullptr) {
  using T = MmaTile<BM, BN, WM, WN>;
  constexpr int NT = T::NT, WTM = T::WTM, WTN = T::WTN;
  constexpr int MF = T::MF, NF = T::NF;
  static_assert(NF % 2 == 0, "B fragments load in pairs");
  constexpr int AR = TA ? kBK : BM, AC = TA ? BM : kBK, ALD = AC + kPad;
  constexpr int BR = TB ? BN : kBK, BC = TB ? kBK : BN, BLD = BC + kPad;
  constexpr int APL = AR * ALD, BPL = BR * BLD;      // elements per plane
  constexpr int STAGE = PA * APL + PB * BPL;
  constexpr int CHA = AR * AC / 4 / NT, CHB = BR * BC / 4 / NT;
  static_assert(CHA * 4 * NT == AR * AC && CHB * 4 * NT == BR * BC,
                "tiles split evenly into 4-element chunks");
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const uint32_t sbase =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm0 = (warp / WN) * WTM, wn0 = (warp % WN) * WTN;

  // per-lane element offsets of the ldmatrix rows inside a stage
  const int a_off = TA ? (lane % 8 + (lane / 16) * 8) * ALD + wm0 +
                             ((lane / 8) % 2) * 8
                       : (wm0 + lane % 16) * ALD + (lane / 16) * 8;
  const int b_off = PA * APL +
                    (TB ? (wn0 + lane % 8 + (lane / 16) * 8) * BLD +
                              ((lane / 8) % 2) * 8
                        : (lane % 8 + ((lane / 8) % 2) * 8) * BLD + wn0 +
                              (lane / 16) * 8);

  typename RawChunk<PA>::T ra[CHA];
  typename RawChunk<PB>::T rb[CHB];
  const int k0 = kbase + kt0 * kBK;
  load_tile<PA, AR, AC, NT>(a, TA ? k0 : m0, TA ? m0 : k0, ra);
  load_tile<PB, BR, BC, NT>(b, TB ? n0 : k0, TB ? k0 : n0, rb);
  store_tile<PA, AR, AC, NT>(a, ra, smem);
  store_tile<PB, BR, BC, NT, FB>(b, rb, smem + PA * APL, tab);
  __syncthreads();
  for (int kt = kt0; kt < kt1; ++kt) {
    const int s = (kt - kt0) & 1;
    const bool more = kt + 1 < kt1;
    if (more) {                      // the next k-tile, in flight over the mma
      const int k1 = kbase + (kt + 1) * kBK;
      load_tile<PA, AR, AC, NT>(a, TA ? k1 : m0, TA ? m0 : k1, ra);
      load_tile<PB, BR, BC, NT>(b, TB ? n0 : k1, TB ? k1 : n0, rb);
    }
    const uint32_t st = sbase + 2u * static_cast<uint32_t>(s * STAGE);
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      uint32_t bf[PB][NF][2];
#pragma unroll
      for (int p = 0; p < PB; ++p)
#pragma unroll
        for (int q = 0; q < NF / 2; ++q) {
          uint32_t r[4];
          const int e = b_off + p * BPL +
                        (TB ? q * 16 * BLD + ks : ks * BLD + q * 16);
          if (TB)
            ldsm_x4(r, st + 2u * e);
          else
            ldsm_x4_t(r, st + 2u * e);
          bf[p][2 * q][0] = r[0];
          bf[p][2 * q][1] = r[1];
          bf[p][2 * q + 1][0] = r[2];
          bf[p][2 * q + 1][1] = r[3];
        }
      // A piece by piece, largest index (smallest piece) first; each of its
      // cross products over all 16 fragments (independent accumulators)
#pragma unroll
      for (int pa = PA - 1; pa >= 0; --pa) {
        uint32_t af[MF][4];
#pragma unroll
        for (int i = 0; i < MF; ++i) {
          const int e = a_off + pa * APL +
                        (TA ? ks * ALD + i * 16 : i * 16 * ALD + ks);
          if (TA)
            ldsm_x4_t(af[i], st + 2u * e);
          else
            ldsm_x4(af[i], st + 2u * e);
        }
#pragma unroll
        for (int pb = PB - 1; pb >= 0; --pb) {
          if (pa + pb == 0) continue;                    // x1 y1: below
          if (PA == 3 && PB == 3 && pa + pb > 2) continue;   // dropped terms
#pragma unroll
          for (int i = 0; i < MF; ++i)
#pragma unroll
            for (int j = 0; j < NF; ++j)
              mma_bf16(acc[i][j], af[i], bf[pb][j][0], bf[pb][j][1]);
        }
        if (pa == 0) {
          // x1 y1 into fresh zero accumulators, added with one f32 rounding
#pragma unroll
          for (int i = 0; i < MF; ++i) {
            float t[NF][4];
#pragma unroll
            for (int j = 0; j < NF; ++j) {
#pragma unroll
              for (int q = 0; q < 4; ++q) t[j][q] = 0.0f;
              mma_bf16(t[j], af[i], bf[0][j][0], bf[0][j][1]);
            }
#pragma unroll
            for (int j = 0; j < NF; ++j)
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[i][j][q] += t[j][q];
          }
        }
      }
      if (ks == 0 && more)             // A's next tile, behind ks 0's mma
        store_tile<PA, AR, AC, NT>(a, ra, smem + (s ^ 1) * STAGE);
    }
    if (more)                          // B's, behind ks 16's
      store_tile<PB, BR, BC, NT, FB>(b, rb, smem + (s ^ 1) * STAGE + PA * APL,
                                     tab);
    __syncthreads();
  }
}

// Dynamic shared bytes of mma_mainloop's two stages.
__host__ __device__ constexpr size_t mma_smem(int bm, int bn, int pa, int pb,
                                              bool ta, bool tb) {
  return sizeof(__nv_bfloat16) * kStages *
         static_cast<size_t>(pa * (ta ? kBK : bm) * ((ta ? bm : kBK) + kPad) +
                             pb * (tb ? bn : kBK) * ((tb ? kBK : bn) + kPad));
}

// The accumulators of the tile at (m0, n0) -> f32 out [*, N] (row stride
// N), rows m0 + r < row_end and columns < N; fragment layout of m16n8:
// c0, c1 at (g, 2t..2t+1), c2, c3 at (g + 8, ...).
template <int BM, int BN, int WM, int WN>
__device__ __forceinline__ void store_acc_f32(
    const float (&acc)[MmaTile<BM, BN, WM, WN>::MF]
                      [MmaTile<BM, BN, WM, WN>::NF][4],
    float* out, int m0, int n0, int row_end, int N) {
  using T = MmaTile<BM, BN, WM, WN>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm0 = (warp / WN) * T::WTM, wn0 = (warp % WN) * T::WTN;
  const int g = lane / 4, tq = lane % 4;
#pragma unroll
  for (int i = 0; i < T::MF; ++i)
#pragma unroll
    for (int j = 0; j < T::NF; ++j) {
      const int col = n0 + wn0 + j * 8 + 2 * tq;
      if (col >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm0 + i * 16 + g + 8 * h;
        if (row >= row_end) continue;
        float* d = out + static_cast<size_t>(row) * N + col;
        if ((N % 2) == 0) {
          *reinterpret_cast<float2*>(d) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        } else {
          d[0] = acc[i][j][2 * h];
          if (col + 1 < N) d[1] = acc[i][j][2 * h + 1];
        }
      }
    }
}

}  // namespace
