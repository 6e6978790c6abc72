// Plane-decomposed integer GEMM: out int32 [M, N] = sum_c (x @ plane_c) << s_c,
// from int8 planes (bitserial_matmul_s8) or a byte-packed store
// (packed_bitserial_matmul_u8).
//
// bitserial_matmul_s8 replaces the Pallas TPU kernel src/repro/kernels/
// bitserial_matmul.py::bitserial_matmul (pallas_call at bitserial_matmul.py:84,
// body _kernel).  It serves prefill and tier-homogeneous decode steps of an
// unpacked store (ops.dequant_matmul).  P = 1..4 planes; the shift table is
// s_c = 2c for LSB-first fixed-precision planes and s_c = 2(P'-1-c) for an
// MSB-first superplane prefix, so one kernel serves both stores.
//
// packed_bitserial_matmul_u8 replaces bitserial_matmul.py::packed_bitserial_matmul
// (pallas_call at bitserial_matmul.py:169, body _packed_kernel), the same
// GEMM over a uint8 [K, N] store with plane c in bits 2c..2c+1 of each byte.
// A runtime-truncated read (eff_bits < w_bits) takes the top P = eff_bits/2
// fields, field base/2 + c for plane c with base = w_bits - eff_bits, at shift
// 2c; the top extracted field is signed for a signed store.
//
// Bound on an H100: memory at decode (M <= max_batch rows; the weight bytes,
// P*K*N unpacked or K*N packed, are read once per 8*TM-row tile and dominate
// the traffic), int8 operations at large prefill M.  The design (plane_gemm.cuh)
// keeps the x tile and all P plane tiles of a K stage in shared memory, so
// every weight byte read from device memory feeds all rows of the tile; the
// packed source splits each byte into its fields on the way into shared
// memory, so a packed read costs one byte per weight whatever P is.  A
// small-M instantiation (8-row tiles) keeps decode from wasting work on empty
// rows.  Known limits, left for later work: dp4a instead of tensor-core MMA,
// no cp.async/TMA pipelining, no split-K for narrow N (k/v projections give
// 16 blocks).
#include "plane_gemm.cuh"

namespace {

using namespace plane_gemm;

template <int TM, class WSource>
__global__ void __launch_bounds__(kThreads)
bitserial_kernel(const int8_t* __restrict__ x, WSource wsrc, int32_t* __restrict__ out,
                 int M, int K, int N, int P, int s0, int s1, int s2, int s3,
                 bool vec_x) {
  __shared__ Smem<TM> sm;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * (8 * TM);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int shifts[kMaxPlanes] = {s0, s1, s2, s3};
  int coef[TM][kMaxPlanes];
  int acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int c = 0; c < kMaxPlanes; ++c) coef[i][c] = 1 << shifts[c];
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
  }
  accumulate<TM>(x, wsrc, M, K, N, P, m0, n0, vec_x, coef, acc, sm);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 8 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (m < M && n < N) out[static_cast<size_t>(m) * N + n] = acc[i][j];
    }
  }
}

template <class WSource>
int launch(const void* x, WSource wsrc, void* out, int M, int K, int N, int P,
           const int (&s)[kMaxPlanes], int vec_x, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x);
  int32_t* op = static_cast<int32_t*>(out);
  const dim3 block(kThreads);
  if (M <= 8) {
    const dim3 grid((N + kBN - 1) / kBN, (M + 7) / 8);
    bitserial_kernel<1, WSource><<<grid, block, 0, st>>>(
        xp, wsrc, op, M, K, N, P, s[0], s[1], s[2], s[3], vec_x != 0);
  } else {
    const dim3 grid((N + kBN - 1) / kBN, (M + 31) / 32);
    bitserial_kernel<4, WSource><<<grid, block, 0, st>>>(
        xp, wsrc, op, M, K, N, P, s[0], s[1], s[2], s[3], vec_x != 0);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bitserial_matmul_s8(const void* x, const void* planes, void* out,
                                   int M, int K, int N, int P, int s0, int s1,
                                   int s2, int s3, int vec_x, int vec_w,
                                   void* stream) {
  const PlaneSource src{static_cast<const int8_t*>(planes), vec_w != 0};
  const int s[kMaxPlanes] = {s0, s1, s2, s3};
  return launch(x, src, out, M, K, N, P, s, vec_x, stream);
}

// P = eff_bits / 2 planes; plane c is byte field first_field + c at shift 2c;
// the top one (c = P - 1) is signed when sign != 0.
extern "C" int packed_bitserial_matmul_u8(const void* x, const void* packed, void* out,
                                          int M, int K, int N, int P, int first_field,
                                          int sign, int vec_x, int vec_w,
                                          void* stream) {
  const PackedSource src{static_cast<const int8_t*>(packed), vec_w != 0, first_field, 1,
                         sign != 0 ? P - 1 : -1};
  const int s[kMaxPlanes] = {0, 2, 4, 6};
  return launch(x, src, out, M, K, N, P, s, vec_x, stream);
}
