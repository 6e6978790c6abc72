// Plane-decomposed integer GEMM: out int32 [M, N] = sum_c (x @ planes[c]) << s_c.
//
// Replaces the Pallas TPU kernel src/repro/kernels/bitserial_matmul.py::bitserial_matmul
// (pallas_call at bitserial_matmul.py:84, body _kernel).  It serves prefill and
// tier-homogeneous decode steps (ops._dequant_gemm).  P = 1..4 planes; the shift
// table is s_c = 2c for LSB-first fixed-precision planes and s_c = 2(P'-1-c) for
// an MSB-first superplane prefix, so one kernel serves both stores.
//
// Bound on an H100: memory at decode (M <= max_batch rows; the planes, P*K*N
// bytes, are read once per 8*TM-row tile and dominate the traffic), int8
// operations at large prefill M.  The design (plane_gemm.cuh) keeps the x tile
// and all P plane tiles of a K stage in shared memory, so every weight byte
// read from device memory feeds all rows of the tile; a small-M instantiation
// (8-row tiles) keeps decode from wasting work on empty rows.  Known limits,
// left for later work: dp4a instead of tensor-core MMA, no cp.async/TMA
// pipelining, no split-K for narrow N (k/v projections give 16 blocks).
#include "plane_gemm.cuh"

namespace {

using namespace plane_gemm;

template <int TM>
__global__ void __launch_bounds__(kThreads)
bitserial_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ planes,
                 int32_t* __restrict__ out, int M, int K, int N, int P,
                 int s0, int s1, int s2, int s3, bool vec_x, bool vec_w) {
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
  accumulate<TM>(x, planes, M, K, N, P, m0, n0, vec_x, vec_w, coef, acc, sm);
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

}  // namespace

extern "C" int bitserial_matmul_s8(const void* x, const void* planes, void* out,
                                   int M, int K, int N, int P, int s0, int s1,
                                   int s2, int s3, int vec_x, int vec_w,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(planes);
  int32_t* op = static_cast<int32_t*>(out);
  const dim3 block(kThreads);
  if (M <= 8) {
    const dim3 grid((N + kBN - 1) / kBN, (M + 7) / 8);
    bitserial_kernel<1><<<grid, block, 0, st>>>(xp, wp, op, M, K, N, P, s0, s1, s2,
                                                s3, vec_x != 0, vec_w != 0);
  } else {
    const dim3 grid((N + kBN - 1) / kBN, (M + 31) / 32);
    bitserial_kernel<4><<<grid, block, 0, st>>>(xp, wp, op, M, K, N, P, s0, s1, s2,
                                                s3, vec_x != 0, vec_w != 0);
  }
  return static_cast<int>(cudaGetLastError());
}
