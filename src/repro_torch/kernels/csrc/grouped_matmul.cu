// Group-switching plane-prefix GEMM, raw and with the fused dequant epilogue:
//   grouped_matmul:          out int32 [M, N] = sum_c (x @ plane_c) * mult[m, c]
//   grouped_dequant_matmul:  out bf16 [M, N] = bf16(((f32(acc[m, n])) * x_scale[m])
//                                                   * w_scale[group[m], n])
// each from int8 planes (_s8) or a byte-packed uint8 store (_u8).
//
// Replaces the Pallas TPU kernels src/repro/kernels/grouped_matmul.py::
// grouped_dequant_matmul (pallas_call at grouped_matmul.py:203; bodies
// _dequant_kernel, _accumulate, _plane), the single GEMM of every mixed-tier
// decode projection (ops.fused_decode_linear), and grouped_matmul.py::
// grouped_matmul (pallas_call at grouped_matmul.py:164, body _kernel), its
// raw-int32 twin behind the kernel-level API (ops.bitserial_matmul_planes with
// row_groups).  Rows of different effective widths share every plane pass:
// the per-row multiplier table mult [M, Pmax] (decompose.prefix_multipliers)
// weighs plane c by 4^(P'_r-1-c) inside a row's prefix and by 0 beyond it.
// MSB-first plane c is plane c of the int8 prefix, or byte field
// store_planes-1-c of the packed store, read as signed [-2, 1] only for the
// store's top field (c = 0) of a signed store.  The weight scale arrives as
// one effective scale row per tier group [G, N] plus a row -> group index, in
// place of the reference's broadcast [M, N] rows; the values and the multiply
// order (acc * x_scale) * w_scale are the reference's, converted with
// __int2float_rn and __float2bfloat16_rn, so the output bits equal the plain
// version's.
//
// Bound on an H100: memory.  A full-width decode step reads Pmax*K*N plane
// bytes per projection from the unpacked store (about 30.3 GB over all
// projections at Pmax = 4) and K*N bytes from the packed store at any Pmax
// (about 7.6 GB), plus M <= max_batch rows of activations.  The GEMM core is
// plane_gemm.cuh (shared with bitserial_matmul.cu); the epilogue runs on the
// int32 accumulators in registers, so no unscaled int32 result ever reaches
// device memory.
#include <cuda_bf16.h>

#include "plane_gemm.cuh"

namespace {

using namespace plane_gemm;

struct Epilogue {   // null x_scale: write the raw int32 accumulator
  const float* x_scale;
  const float* w_scale;
  const int32_t* row_group;
};

template <int TM, class WSource>
__global__ void __launch_bounds__(kThreads)
grouped_kernel(const int8_t* __restrict__ x, WSource wsrc,
               const int32_t* __restrict__ mult, Epilogue epi, void* __restrict__ out,
               int M, int K, int N, int P, bool vec_x) {
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
  accumulate<TM>(x, wsrc, M, K, N, P, m0, n0, vec_x, coef, acc, sm);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 8 * i;
    if (m >= M) continue;
    if (epi.x_scale == nullptr) {
      int32_t* o = static_cast<int32_t*>(out) + static_cast<size_t>(m) * N;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx + 16 * j;
        if (n < N) o[n] = acc[i][j];
      }
      continue;
    }
    const float xs = epi.x_scale[m];
    const float* ws = epi.w_scale + static_cast<size_t>(epi.row_group[m]) * N;
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + static_cast<size_t>(m) * N;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) o[n] = __float2bfloat16_rn((__int2float_rn(acc[i][j]) * xs) * ws[n]);
    }
  }
}

template <class WSource>
int launch(const void* x, WSource wsrc, const void* mult, Epilogue epi, void* out,
           int M, int K, int N, int P, int vec_x, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int32_t* mp = static_cast<const int32_t*>(mult);
  const dim3 block(kThreads);
  if (M <= 8) {
    const dim3 grid((N + kBN - 1) / kBN, (M + 7) / 8);
    grouped_kernel<1, WSource><<<grid, block, 0, st>>>(xp, wsrc, mp, epi, out, M, K, N,
                                                       P, vec_x != 0);
  } else {
    const dim3 grid((N + kBN - 1) / kBN, (M + 31) / 32);
    grouped_kernel<4, WSource><<<grid, block, 0, st>>>(xp, wsrc, mp, epi, out, M, K, N,
                                                       P, vec_x != 0);
  }
  return static_cast<int>(cudaGetLastError());
}

PlaneSource planes_of(const void* planes, int vec_w) {
  return PlaneSource{static_cast<const int8_t*>(planes), vec_w != 0};
}

// MSB-first plane c = field store_planes-1-c; only c = 0 may be signed.
PackedSource packed_of(const void* packed, int store_planes, int sign, int vec_w) {
  return PackedSource{static_cast<const int8_t*>(packed), vec_w != 0, store_planes - 1,
                      -1, sign != 0 ? 0 : -1};
}

Epilogue dequant(const void* x_scale, const void* w_scale, const void* row_group) {
  return Epilogue{static_cast<const float*>(x_scale), static_cast<const float*>(w_scale),
                  static_cast<const int32_t*>(row_group)};
}

}  // namespace

extern "C" int grouped_matmul_s8(const void* x, const void* planes, const void* mult,
                                 void* out, int M, int K, int N, int P, int vec_x,
                                 int vec_w, void* stream) {
  return launch(x, planes_of(planes, vec_w), mult, Epilogue{nullptr, nullptr, nullptr},
                out, M, K, N, P, vec_x, stream);
}

extern "C" int grouped_matmul_u8(const void* x, const void* packed, const void* mult,
                                 void* out, int M, int K, int N, int P, int store_planes,
                                 int sign, int vec_x, int vec_w, void* stream) {
  return launch(x, packed_of(packed, store_planes, sign, vec_w), mult,
                Epilogue{nullptr, nullptr, nullptr}, out, M, K, N, P, vec_x, stream);
}

extern "C" int grouped_dequant_matmul_s8(const void* x, const void* planes,
                                         const void* mult, const void* x_scale,
                                         const void* w_scale, const void* row_group,
                                         void* out, int M, int K, int N, int P,
                                         int vec_x, int vec_w, void* stream) {
  return launch(x, planes_of(planes, vec_w), mult, dequant(x_scale, w_scale, row_group),
                out, M, K, N, P, vec_x, stream);
}

extern "C" int grouped_dequant_matmul_u8(const void* x, const void* packed,
                                         const void* mult, const void* x_scale,
                                         const void* w_scale, const void* row_group,
                                         void* out, int M, int K, int N, int P,
                                         int store_planes, int sign, int vec_x,
                                         int vec_w, void* stream) {
  return launch(x, packed_of(packed, store_planes, sign, vec_w), mult,
                dequant(x_scale, w_scale, row_group), out, M, K, N, P, vec_x, stream);
}
