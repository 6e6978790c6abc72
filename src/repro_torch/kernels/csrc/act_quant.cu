// Per-row symmetric activation quantization, bf16/f32 -> int8/uint8 + f32
// scale, with the row gather of the mixed-tier path.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/act_quant.py:
//   act_quant       (pallas_call at act_quant.py:46, body _kernel)       -> act_quant_gather
//   act_quant_rows  (pallas_call at act_quant.py:91, body _rows_kernel)  -> act_quant_rows_gather
//
// Computes, for output row i of [M, K] and its source row r = perm[i]
// (r = i without perm):
//   scale = max(amax_r, 1e-8) * (1 / qmax)        (reciprocal-multiply, as the reference)
//   q     = clip(rint(x_r / scale), qmin, qmax)    (round half to even)
// with one static width (act_quant_gather) or a per-row f32 qmax, qmin =
// -qmax - 1 (act_quant_rows_gather, the mixed-a_bits decode path).  x is
// read in its own type, bf16 or f32, and widened to f32 in registers, which
// is exact; x's rows may lie ldx elements apart.
//
// Bound on an H100: neither bytes nor operations.  A serving call moves
// 2 B in and 1 B out per element over 8-64 rows of K = 4096 or 12288, well
// under a microsecond at 3.35 TB/s and below what a launch costs, so the
// design cuts the dependent round trips to device memory inside a launch:
// - one block per row, so the 8 decode rows or 64 prefill rows each find
//   an SM;
// - each thread issues all of its 16-byte loads (8 bf16 or 4 f32) before
//   the first use and keeps the row in registers: one read of the row, one
//   round trip; a compile-time element count per serving K (4096, 12288);
// - amax by warp shuffles and one shared-memory step (one barrier);
// - the codes come from the registers, 8 or 4 bytes per thread-store;
// - the row gather and the bf16 read happen here, so the caller makes no
//   copy of x before the launch.
// A K without an instantiation, or rows that are not 16-byte aligned, take
// a generic path: element loads, the row read twice, the same bits.
// amax is exact in any order; 1/qmax and x/scale are IEEE divides and
// __float2int_rn rounds half to even (clamping the integer afterwards equals
// clipping the rounded float: the bounds are integers), so the codes and
// scales equal the plain PyTorch version bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Word w of a 16-byte vector (w is a constant once the loops unroll).
__device__ __forceinline__ uint32_t word(const uint4& v, int w) {
  return w == 0 ? v.x : w == 1 ? v.y : w == 2 ? v.z : v.w;
}

// The element types x may have: one 16-byte vector holds kVec of them.
struct Bf16 {
  static constexpr int kVec = 8;
  static constexpr int kBytes = 2;
  __device__ static float at(const uint4& v, int e) {
    const uint32_t w = word(v, e >> 1);      // element 2j in the low half
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  }
  __device__ static float load(const char* row, int k) {
    return __uint_as_float(
        static_cast<uint32_t>(reinterpret_cast<const uint16_t*>(row)[k]) << 16);
  }
};

struct F32 {
  static constexpr int kVec = 4;
  static constexpr int kBytes = 4;
  __device__ static float at(const uint4& v, int e) {
    return __uint_as_float(word(v, e));
  }
  __device__ static float load(const char* row, int k) {
    return reinterpret_cast<const float*>(row)[k];
  }
};

struct Rows {
  const char* x;
  long long ldx_bytes;       // distance between x's rows
  const void* perm;          // int32 or int64 [M], or nullptr
  int perm64;
  const float* qmax_rows;    // f32 [M], or nullptr: one width (qmin_c, qmax_c)
  float qmin_c, qmax_c;
  void* q;                   // [M, K], contiguous
  float* scale;              // [M]
  int K;
};

__device__ __forceinline__ const char* source_row(const Rows& a, int i) {
  long long r = i;
  if (a.perm != nullptr)
    r = a.perm64 ? static_cast<const int64_t*>(a.perm)[i]
                 : static_cast<const int32_t*>(a.perm)[i];
  return a.x + r * a.ldx_bytes;
}

__device__ __forceinline__ void row_range(const Rows& a, int i, float& qmin,
                                          float& qmax) {
  qmax = a.qmax_rows != nullptr ? a.qmax_rows[i] : a.qmax_c;
  qmin = a.qmax_rows != nullptr ? -qmax - 1.0f : a.qmin_c;
}

// Block-wide max: warp shuffles, then every thread reads the per-warp
// maxima from shared memory (one barrier).
template <int kThreads>
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) v = fmaxf(v, red[w]);
  return v;
}

__device__ __forceinline__ float row_scale(float amax, float qmax) {
  return fmaxf(amax, 1e-8f) * __fdiv_rn(1.0f, qmax);
}

__device__ __forceinline__ int code(float x, float s, int qmin, int qmax) {
  return min(max(__float2int_rn(__fdiv_rn(x, s)), qmin), qmax);
}

// The row in registers: kPer 16-byte vectors a thread, vector j of thread t
// at position j * kThreads + t of the row.
template <typename In, typename QT, int K, int kPer>
__global__ void __launch_bounds__(K / In::kVec / kPer)
act_quant_vec_kernel(Rows a) {
  constexpr int kThreads = K / In::kVec / kPer;
  static_assert(kThreads * kPer * In::kVec == K && kThreads % 32 == 0 &&
                kThreads <= 1024, "no block shape for this K");
  __shared__ float red[kThreads / 32];
  const int i = blockIdx.x;
  float qmin, qmax;
  row_range(a, i, qmin, qmax);
  const uint4* xr = reinterpret_cast<const uint4*>(source_row(a, i));
  uint4 v[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) v[j] = __ldg(xr + j * kThreads + threadIdx.x);
  float amax = 0.0f;
#pragma unroll
  for (int j = 0; j < kPer; ++j)
#pragma unroll
    for (int e = 0; e < In::kVec; ++e) amax = fmaxf(amax, fabsf(In::at(v[j], e)));
  const float s = row_scale(block_max<kThreads>(amax, red), qmax);
  const int lo = static_cast<int>(qmin), hi = static_cast<int>(qmax);
  QT* qr = static_cast<QT*>(a.q) + static_cast<size_t>(i) * K;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    uint32_t w[In::kVec / 4] = {};
#pragma unroll
    for (int e = 0; e < In::kVec; ++e)
      w[e >> 2] |= (static_cast<uint32_t>(code(In::at(v[j], e), s, lo, hi)) &
                    0xffu) << (8 * (e & 3));
    QT* dst = qr + (j * kThreads + threadIdx.x) * In::kVec;
    if constexpr (In::kVec == 8)
      *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
    else
      *reinterpret_cast<uint32_t*>(dst) = w[0];
  }
  if (threadIdx.x == 0) a.scale[i] = s;
}

constexpr int kGenericThreads = 256;

template <typename In, typename QT>
__global__ void __launch_bounds__(kGenericThreads)
act_quant_generic_kernel(Rows a) {
  __shared__ float red[kGenericThreads / 32];
  const int i = blockIdx.x;
  float qmin, qmax;
  row_range(a, i, qmin, qmax);
  const char* xr = source_row(a, i);
  float amax = 0.0f;
  for (int k = threadIdx.x; k < a.K; k += kGenericThreads)
    amax = fmaxf(amax, fabsf(In::load(xr, k)));
  const float s = row_scale(block_max<kGenericThreads>(amax, red), qmax);
  const int lo = static_cast<int>(qmin), hi = static_cast<int>(qmax);
  QT* qr = static_cast<QT*>(a.q) + static_cast<size_t>(i) * a.K;
  for (int k = threadIdx.x; k < a.K; k += kGenericThreads)
    qr[k] = static_cast<QT>(code(In::load(xr, k), s, lo, hi));
  if (threadIdx.x == 0) a.scale[i] = s;
}

// Per serving K, the 16-byte vectors a thread holds: 128-512 threads a row.
template <typename In, typename QT>
void launch_rows(const Rows& a, int M, cudaStream_t st) {
  const bool aligned = reinterpret_cast<uintptr_t>(a.x) % 16 == 0 &&
                       a.ldx_bytes % 16 == 0;
  if (aligned && a.K == 4096) {
    act_quant_vec_kernel<In, QT, 4096, 4>
        <<<M, 4096 / In::kVec / 4, 0, st>>>(a);
  } else if (aligned && a.K == 12288) {
    act_quant_vec_kernel<In, QT, 12288, 6>
        <<<M, 12288 / In::kVec / 6, 0, st>>>(a);
  } else {
    act_quant_generic_kernel<In, QT><<<M, kGenericThreads, 0, st>>>(a);
  }
}

template <typename QT>
int launch(Rows a, int x_bf16, int ldx, int M, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    a.ldx_bytes = static_cast<long long>(ldx) * Bf16::kBytes;
    launch_rows<Bf16, QT>(a, M, st);
  } else {
    a.ldx_bytes = static_cast<long long>(ldx) * F32::kBytes;
    launch_rows<F32, QT>(a, M, st);
  }
  return static_cast<int>(cudaGetLastError());
}

__global__ void noop_kernel() {}

}  // namespace

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int act_quant_gather(const void* x, int x_bf16, int ldx,
                                const void* perm, int perm64, void* q,
                                void* scale, int M, int K, int bits,
                                int is_signed, void* stream) {
  Rows a{static_cast<const char*>(x), 0, perm, perm64, nullptr, 0.0f, 0.0f,
         q, static_cast<float*>(scale), K};
  if (is_signed) {
    a.qmax_c = static_cast<float>((1 << (bits - 1)) - 1);
    a.qmin_c = static_cast<float>(-(1 << (bits - 1)));
    return launch<int8_t>(a, x_bf16, ldx, M, stream);
  }
  a.qmax_c = static_cast<float>((1 << bits) - 1);
  return launch<uint8_t>(a, x_bf16, ldx, M, stream);
}

extern "C" int act_quant_rows_gather(const void* x, int x_bf16, int ldx,
                                     const void* perm, int perm64,
                                     const void* qmax, void* q, void* scale,
                                     int M, int K, void* stream) {
  Rows a{static_cast<const char*>(x), 0, perm, perm64,
         static_cast<const float*>(qmax), 0.0f, 0.0f, q,
         static_cast<float*>(scale), K};
  return launch<int8_t>(a, x_bf16, ldx, M, stream);
}

// An empty kernel: the least a launch costs (chip_smoke.py's launch floor).
extern "C" int repro_noop(void* stream) {
  noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
