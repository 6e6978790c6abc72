// Per-row symmetric activation quantization, f32 -> int8/uint8 + f32 scale.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/act_quant.py:
//   act_quant       (pallas_call at act_quant.py:46, body _kernel)       -> act_quant_f32
//   act_quant_rows  (pallas_call at act_quant.py:91, body _rows_kernel)  -> act_quant_rows_f32
//
// Computes, per row r of x [M, K]:
//   scale = max(amax_r, 1e-8) * (1 / qmax)        (reciprocal-multiply, as the reference)
//   q     = clip(rint(x / scale), qmin, qmax)      (round half to even)
// with one static width (act_quant_f32) or a per-row f32 qmax, qmin = -qmax - 1
// (act_quant_rows_f32, the mixed-a_bits decode path).
//
// Bound on an H100: memory.  The kernel reads 4 B and writes 1 B per element
// (K = 4096 or 12288 on the serving path); the arithmetic is a few flops per
// byte.  Design: one block per row, so the row's amax is a block reduction
// (warp shuffles, then one warp over the per-warp maxima) with no second
// launch; the quantize pass re-reads the row, which is still in L1/L2.
// amax is exact in any order; 1/qmax and x/scale are IEEE divides (this file
// is built without --use_fast_math) and rintf rounds half to even, so the
// codes and scales equal the plain PyTorch version bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (kThreads >> 5) ? red[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

// qmax_rows == nullptr: one width for every row (qmin_c, qmax_c).
template <typename QT>
__global__ void __launch_bounds__(kThreads)
act_quant_kernel(const float* __restrict__ x, const float* __restrict__ qmax_rows,
                 float qmin_c, float qmax_c, QT* __restrict__ q,
                 float* __restrict__ scale, int K) {
  __shared__ float red[kThreads / 32];
  const size_t row = blockIdx.x;
  const float* xr = x + row * (size_t)K;
  QT* qr = q + row * (size_t)K;
  float amax = 0.0f;
  for (int k = threadIdx.x; k < K; k += kThreads) amax = fmaxf(amax, fabsf(xr[k]));
  amax = block_max(amax, red);
  const float qmax = qmax_rows != nullptr ? qmax_rows[row] : qmax_c;
  const float qmin = qmax_rows != nullptr ? -qmax - 1.0f : qmin_c;
  const float s = fmaxf(amax, 1e-8f) * (1.0f / qmax);
  for (int k = threadIdx.x; k < K; k += kThreads) {
    float v = rintf(xr[k] / s);
    v = fminf(fmaxf(v, qmin), qmax);
    qr[k] = static_cast<QT>(__float2int_rn(v));
  }
  if (threadIdx.x == 0) scale[row] = s;
}

}  // namespace

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int act_quant_f32(const void* x, void* q, void* scale, int M, int K,
                             int bits, int is_signed, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_signed) {
    const float qmax = static_cast<float>((1 << (bits - 1)) - 1);
    const float qmin = static_cast<float>(-(1 << (bits - 1)));
    act_quant_kernel<int8_t><<<M, kThreads, 0, st>>>(
        static_cast<const float*>(x), nullptr, qmin, qmax,
        static_cast<int8_t*>(q), static_cast<float*>(scale), K);
  } else {
    const float qmax = static_cast<float>((1 << bits) - 1);
    act_quant_kernel<uint8_t><<<M, kThreads, 0, st>>>(
        static_cast<const float*>(x), nullptr, 0.0f, qmax,
        static_cast<uint8_t*>(q), static_cast<float*>(scale), K);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int act_quant_rows_f32(const void* x, const void* qmax, void* q,
                                  void* scale, int M, int K, void* stream) {
  act_quant_kernel<int8_t><<<M, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(qmax), 0.0f, 0.0f,
      static_cast<int8_t*>(q), static_cast<float*>(scale), K);
  return static_cast<int>(cudaGetLastError());
}
