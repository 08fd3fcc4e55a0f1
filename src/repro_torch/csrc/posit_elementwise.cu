// K5/K6: bit-exact elementwise posit arithmetic, the FPPU's PADD, PSUB,
// PMUL, PFMADD and PDIV per lane.
//
// Replaces the TPU kernels of repro/kernels/posit_elementwise.py:
// _ew_kernel (:33, pallas_call at :66, wrapper `elementwise` :50) and
// _div_kernel / _div_kernel_lut (:78, :83; pallas_calls at :138 and :126,
// wrapper `divide` :110).  Each lane runs the integer datapath of
// posit_arith.cuh, line for line the port's plain version
// (repro_torch/core/ops.py), so kernel and plain version agree bit for bit.
//
// Bound on an H100.  At p16 an add reads 4 B and writes 2 B per lane for
// some 150-200 integer instructions; 2^26 lanes move 0.4 GB (0.12 ms at
// 3.35 TB/s) and issue ~10^10 thread-instructions (~0.35 ms at 132 SMs x 128
// lanes x 1.98 GHz): the integer pipes, not HBM, set the time, and division
// (two reciprocal polynomials, Newton-Raphson, a remainder fix-up) more so.
// chip_smoke.py reports the bytes bound, and beside it, as a diagnostic,
// the static SASS instruction count per lane of each instantiation.
//
// Design.  One thread handles 16 bytes of each operand per step (16 posit8
// or 8 posit16 lanes) with 16-byte vector loads and stores, in a
// grid-stride loop; the ragged tail (or unaligned operands) goes lane by
// lane.  The op and the division mode are template parameters, so each
// instantiation holds one straight-line datapath with selects for the
// special cases (zero, NaR), which keeps a warp converged.  nr_rounds is a
// runtime loop count.  The 256-entry PACoGen LUT is an input (int32, made
// once per device by the wrapper) read through the read-only cache.  The
// kernels allocate nothing.
#include "posit_arith.cuh"
#include "posit_codec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

enum EwOp { EW_ADD = 0, EW_SUB = 1, EW_MUL = 2, EW_FMA = 3 };

template <int OP>
__device__ __forceinline__ int32_t ew_lane(int32_t a, int32_t b, int32_t c,
                                           int n, int es) {
  if (OP == EW_ADD) return parith::lane_padd(a, b, n, es);
  if (OP == EW_SUB) return parith::lane_psub(a, b, n, es);
  if (OP == EW_MUL) return parith::lane_pmul(a, b, n, es);
  return parith::lane_pfma(a, b, c, n, es);
}

// 16 bytes of T as lanes.
template <typename T>
union Vec {
  int4 v;
  T x[16 / sizeof(T)];
};

template <int OP, typename T>
__global__ void __launch_bounds__(kThreads)
ew_kernel(const T* __restrict__ a, const T* __restrict__ b,
          const T* __restrict__ c, T* __restrict__ out, long long count,
          int vec_ok, int n, int es) {
  constexpr int V = 16 / sizeof(T);
  const long long tid = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long nvec = vec_ok ? count / V : 0;
  for (long long i = tid; i < nvec; i += stride) {
    Vec<T> va, vb, vc, vo;
    va.v = __ldg(reinterpret_cast<const int4*>(a) + i);
    vb.v = __ldg(reinterpret_cast<const int4*>(b) + i);
    if (OP == EW_FMA) vc.v = __ldg(reinterpret_cast<const int4*>(c) + i);
#pragma unroll
    for (int j = 0; j < V; ++j)
      vo.x[j] = static_cast<T>(parith::sign_extend(
          ew_lane<OP>(va.x[j], vb.x[j], OP == EW_FMA ? vc.x[j] : 0, n, es),
          n));
    reinterpret_cast<int4*>(out)[i] = vo.v;
  }
  for (long long i = nvec * V + tid; i < count; i += stride)
    out[i] = static_cast<T>(parith::sign_extend(
        ew_lane<OP>(a[i], b[i], OP == EW_FMA ? c[i] : 0, n, es), n));
}

template <int MODE, typename T>
__global__ void __launch_bounds__(kThreads)
div_kernel(const T* __restrict__ a, const T* __restrict__ b,
           T* __restrict__ out, const int32_t* __restrict__ lut,
           long long count, int vec_ok, int nr_rounds, int k1q, int k2q,
           int n, int es) {
  constexpr int V = 16 / sizeof(T);
  const long long tid = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long nvec = vec_ok ? count / V : 0;
  for (long long i = tid; i < nvec; i += stride) {
    Vec<T> va, vb, vo;
    va.v = __ldg(reinterpret_cast<const int4*>(a) + i);
    vb.v = __ldg(reinterpret_cast<const int4*>(b) + i);
#pragma unroll
    for (int j = 0; j < V; ++j)
      vo.x[j] = static_cast<T>(parith::sign_extend(
          parith::lane_pdiv<MODE>(va.x[j], vb.x[j], n, es, nr_rounds, k1q,
                                  k2q, lut),
          n));
    reinterpret_cast<int4*>(out)[i] = vo.v;
  }
  for (long long i = nvec * V + tid; i < count; i += stride)
    out[i] = static_cast<T>(parith::sign_extend(
        parith::lane_pdiv<MODE>(a[i], b[i], n, es, nr_rounds, k1q, k2q, lut),
        n));
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

int grid_for(long long count, int lanes_per_vec, bool vec_ok) {
  const long long units = vec_ok ? (count + lanes_per_vec - 1) / lanes_per_vec
                                 : count;
  const long long blocks = (units + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < kMaxBlocks ? (blocks > 0 ? blocks : 1)
                                              : kMaxBlocks);
}

template <typename T>
int launch_ew(int op, const void* a, const void* b, const void* c, void* out,
              long long count, int n, int es, cudaStream_t st) {
  const bool vec_ok = aligned16(a) && aligned16(b) && aligned16(out) &&
                      (op != EW_FMA || aligned16(c));
  const int grid = grid_for(count, 16 / sizeof(T), vec_ok);
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  const T* tc = static_cast<const T*>(c);
  T* to = static_cast<T*>(out);
  switch (op) {
    case EW_ADD:
      ew_kernel<EW_ADD, T><<<grid, kThreads, 0, st>>>(ta, tb, tc, to, count,
                                                       vec_ok, n, es);
      break;
    case EW_SUB:
      ew_kernel<EW_SUB, T><<<grid, kThreads, 0, st>>>(ta, tb, tc, to, count,
                                                       vec_ok, n, es);
      break;
    case EW_MUL:
      ew_kernel<EW_MUL, T><<<grid, kThreads, 0, st>>>(ta, tb, tc, to, count,
                                                       vec_ok, n, es);
      break;
    case EW_FMA:
      if (c == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      ew_kernel<EW_FMA, T><<<grid, kThreads, 0, st>>>(ta, tb, tc, to, count,
                                                       vec_ok, n, es);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_div(const void* a, const void* b, void* out, const int32_t* lut,
               long long count, int mode, int nr_rounds, int k1q, int k2q,
               int n, int es, cudaStream_t st) {
  const bool vec_ok = aligned16(a) && aligned16(b) && aligned16(out);
  const int grid = grid_for(count, 16 / sizeof(T), vec_ok);
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  T* to = static_cast<T*>(out);
#define DIV_CASE(M)                                                         \
  case M:                                                                   \
    div_kernel<M, T><<<grid, kThreads, 0, st>>>(ta, tb, to, lut, count,     \
                                               vec_ok, nr_rounds, k1q, k2q, \
                                               n, es);                      \
    break;
  switch (mode) {
    DIV_CASE(parith::DIV_EXACT)
    DIV_CASE(parith::DIV_POLY)
    DIV_CASE(parith::DIV_POLY_CORRECTED)
    DIV_CASE(parith::DIV_PACOGEN)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DIV_CASE
  return static_cast<int>(cudaGetLastError());
}

bool supported(int dtype, int n, int es) {
  const int bits = dtype == DT_I8 ? 8 : (dtype == DT_I16 ? 16 : 0);
  return bits != 0 && n >= 3 && n <= bits && es >= 0 && es <= 6;
}

}  // namespace

// a, b, c (fma only, else null), out: `count` posit lanes of one storage type.
extern "C" int posit_elementwise(int op, const void* a, const void* b,
                                 const void* c, void* out, long long count,
                                 int dtype, int n, int es, void* stream) {
  if (count <= 0) return 0;
  if (!supported(dtype, n, es)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_I8)
    return launch_ew<int8_t>(op, a, b, c, out, count, n, es, st);
  return launch_ew<int16_t>(op, a, b, c, out, count, n, es, st);
}

// mode: 0 exact, 1 poly, 2 poly_corrected, 3 pacogen; lut: 256 int32.
extern "C" int posit_divide(const void* a, const void* b, void* out,
                            const void* lut, long long count, int mode,
                            int nr_rounds, int k1q, int k2q, int dtype, int n,
                            int es, void* stream) {
  if (count <= 0) return 0;
  if (!supported(dtype, n, es) || nr_rounds < 0 || lut == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* l = static_cast<const int32_t*>(lut);
  if (dtype == DT_I8)
    return launch_div<int8_t>(a, b, out, l, count, mode, nr_rounds, k1q, k2q,
                              n, es, st);
  return launch_div<int16_t>(a, b, out, l, count, mode, nr_rounds, k1q, k2q,
                             n, es, st);
}
