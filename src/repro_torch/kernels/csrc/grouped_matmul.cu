// Group-switching plane-prefix GEMM with the fused dequant epilogue:
//   out bf16 [M, N] = bf16(((f32(sum_c (x @ plane_c) * mult[m, c])) * x_scale[m])
//                          * w_scale[group[m], n])
//
// Replaces the Pallas TPU kernel src/repro/kernels/grouped_matmul.py::
// grouped_dequant_matmul (pallas_call at grouped_matmul.py:203; bodies
// _dequant_kernel, _accumulate, _plane), the single GEMM of every mixed-tier
// decode projection (ops.fused_decode_linear).  Rows of different effective
// widths share every plane pass: the per-row multiplier table mult [M, Pmax]
// (decompose.prefix_multipliers) weighs plane c by 4^(P'_r-1-c) inside a row's
// prefix and by 0 beyond it.  The weight scale arrives as one effective scale
// row per tier group [G, N] plus a row -> group index, in place of the
// reference's broadcast [M, N] rows; the values and the multiply order
// (acc * x_scale) * w_scale are the reference's, converted with __int2float_rn
// and __float2bfloat16_rn, so the output bits equal the plain version's.
//
// Bound on an H100: memory.  A full-width decode step reads Pmax*K*N plane
// bytes per projection (about 30.3 GB over all projections at Pmax = 4) and
// M <= max_batch rows of activations.  The GEMM core is plane_gemm.cuh (shared
// with bitserial_matmul.cu); the epilogue runs on the int32 accumulators in
// registers, so no unscaled int32 result ever reaches device memory.
#include <cuda_bf16.h>

#include "plane_gemm.cuh"

namespace {

using namespace plane_gemm;

template <int TM>
__global__ void __launch_bounds__(kThreads)
grouped_dequant_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ planes,
                       const int32_t* __restrict__ mult, const float* __restrict__ x_scale,
                       const float* __restrict__ w_scale,
                       const int32_t* __restrict__ row_group,
                       __nv_bfloat16* __restrict__ out, int M, int K, int N, int P,
                       bool vec_x, bool vec_w) {
  __shared__ Smem<TM> sm;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * (8 * TM);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  int coef[TM][kMaxPlanes];
  int acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 8 * i;
#pragma unroll
    for (int c = 0; c < kMaxPlanes; ++c)
      coef[i][c] = (m < M && c < P) ? mult[static_cast<size_t>(m) * P + c] : 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
  }
  accumulate<TM>(x, planes, M, K, N, P, m0, n0, vec_x, vec_w, coef, acc, sm);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 8 * i;
    if (m >= M) continue;
    const float xs = x_scale[m];
    const float* ws = w_scale + static_cast<size_t>(row_group[m]) * N;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) {
        const float v = (__int2float_rn(acc[i][j]) * xs) * ws[n];
        out[static_cast<size_t>(m) * N + n] = __float2bfloat16_rn(v);
      }
    }
  }
}

}  // namespace

extern "C" int grouped_dequant_matmul_s8(const void* x, const void* planes,
                                         const void* mult, const void* x_scale,
                                         const void* w_scale, const void* row_group,
                                         void* out, int M, int K, int N, int P,
                                         int vec_x, int vec_w, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(planes);
  const int32_t* mp = static_cast<const int32_t*>(mult);
  const float* xs = static_cast<const float*>(x_scale);
  const float* ws = static_cast<const float*>(w_scale);
  const int32_t* gp = static_cast<const int32_t*>(row_group);
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(out);
  const dim3 block(kThreads);
  if (M <= 8) {
    const dim3 grid((N + kBN - 1) / kBN, (M + 7) / 8);
    grouped_dequant_kernel<1><<<grid, block, 0, st>>>(xp, wp, mp, xs, ws, gp, op, M, K,
                                                      N, P, vec_x != 0, vec_w != 0);
  } else {
    const dim3 grid((N + kBN - 1) / kBN, (M + 31) / 32);
    grouped_dequant_kernel<4><<<grid, block, 0, st>>>(xp, wp, mp, xs, ws, gp, op, M, K,
                                                      N, P, vec_x != 0, vec_w != 0);
  }
  return static_cast<int>(cudaGetLastError());
}
