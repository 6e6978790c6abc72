// Shared core of the plane-decomposed integer GEMMs (bitserial_matmul.cu,
// grouped_matmul.cu): acc[m, n] = sum_c coef[m, c] * (x[m, :] . plane_c[:, n]).
//
// x is int8 [M, K] (K contiguous).  The weight comes from one of two sources,
// a template parameter of accumulate():
//   * PlaneSource: int8 planes [P, K, N] (N contiguous), P <= 4;
//   * PackedSource: one uint8 [K, N] store holding four 2-bit fields per byte
//     (field f at bits 2f..2f+1); plane c is field f0 + fstep * c, and one
//     plane (sign_plane) is read as signed [-2, 1], the others as [0, 3].
// A block owns a (8*TM) x 64 output tile and walks K in stages of 64 inside
// the block (the TPU kernel's sequential K grid axis becomes this loop; blocks
// run in any order).  Per stage it stages the x tile and every plane's 64 x 64
// tile in shared memory; each plane tile is transposed on the way in (4x4 byte
// transposes with __byte_perm) so that four consecutive k of one column form
// one 32-bit word, and the products run as dp4a (int8 x int8 -> int32, four
// MACs per instruction).  The packed source reads the uint8 tile ONCE per
// stage and splits it into all P planes in registers (one shift-and-mask per
// word and plane, a per-byte sign extension for the signed field), so the
// weight bytes read per stage are 64 * 64 instead of P * 64 * 64.  Each
// plane's stage sum is folded into the accumulator times its per-row
// coefficient: 1 << shift for the fixed/prefix shift schedules, the prefix
// multiplier for mixed-width batches.  Integer arithmetic is exact in any
// order, so the result equals the plain float64 version bit for bit.
// |acc| <= 128 * 191 * K < 2^31 for K <= 12288.  Ragged M, N and K edges are
// masked on load and store; a zero byte decodes to zero in every field.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace plane_gemm {

constexpr int kThreads = 128;   // 16 column lanes x 8 row lanes
constexpr int kBN = 64;         // output columns per block
constexpr int kBK = 64;         // k per stage
constexpr int kKW = kBK / 4;    // 32-bit words of k per stage
constexpr int kMaxPlanes = 4;

// Four bytes x[m, k..k+3] as one word (zero beyond the edges).
__device__ __forceinline__ int load_x_word(const int8_t* __restrict__ x, int m, int k,
                                           int M, int K, bool vec) {
  if (m >= M || k >= K) return 0;
  const int8_t* p = x + static_cast<size_t>(m) * K + k;
  if (vec) return __ldg(reinterpret_cast<const int*>(p));
  unsigned w = 0;
  for (int j = 0; j < 4; ++j)
    if (k + j < K) w |= static_cast<unsigned>(static_cast<uint8_t>(p[j])) << (8 * j);
  return static_cast<int>(w);
}

// Four bytes w[k, n..n+3] of a [K, N] byte matrix as one word (zero beyond
// the edges).
__device__ __forceinline__ int load_w_word(const int8_t* __restrict__ plane, int k, int n,
                                           int K, int N, bool vec) {
  if (k >= K || n >= N) return 0;
  const int8_t* p = plane + static_cast<size_t>(k) * N + n;
  if (vec) return __ldg(reinterpret_cast<const int*>(p));
  unsigned w = 0;
  for (int j = 0; j < 4; ++j)
    if (n + j < N) w |= static_cast<unsigned>(static_cast<uint8_t>(p[j])) << (8 * j);
  return static_cast<int>(w);
}

template <int TM>
struct Smem {
  int x[8 * TM][kKW];                  // x tile, k packed four per word
  int w[kMaxPlanes][kBN][kKW + 1];     // plane tiles, one row per column (+1 pad)
};

using PlaneTile = int[kBN][kKW + 1];

// Rows r0..r3 = w[k..k+3, n..n+3] -> column words: tile[4 nq + j][kq] holds
// w[k..k+3, n + j] (4x4 byte transpose).
__device__ __forceinline__ void store_transposed(PlaneTile& tile, int kq, int nq, int r0,
                                                 int r1, int r2, int r3) {
  const int t0 = __byte_perm(r0, r1, 0x5140), t1 = __byte_perm(r0, r1, 0x7362);
  const int t2 = __byte_perm(r2, r3, 0x5140), t3 = __byte_perm(r2, r3, 0x7362);
  tile[4 * nq + 0][kq] = __byte_perm(t0, t2, 0x5410);
  tile[4 * nq + 1][kq] = __byte_perm(t0, t2, 0x7632);
  tile[4 * nq + 2][kq] = __byte_perm(t1, t3, 0x5410);
  tile[4 * nq + 3][kq] = __byte_perm(t1, t3, 0x7632);
}

// int8 planes [P, K, N]: each plane's tile is loaded and transposed.
struct PlaneSource {
  const int8_t* planes;
  bool vec;

  __device__ __forceinline__ void stage(PlaneTile* w, int k0, int n0, int K, int N,
                                        int P) const {
    const size_t plane_stride = static_cast<size_t>(K) * N;
    for (int c = 0; c < P; ++c) {
      const int8_t* plane = planes + c * plane_stride;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int s = threadIdx.x + kThreads * i;   // 16 x 16 sub-blocks of 4k x 4n
        const int kq = s / 16, nq = s % 16;
        const int k = k0 + 4 * kq, n = n0 + 4 * nq;
        store_transposed(w[c], kq, nq, load_w_word(plane, k + 0, n, K, N, vec),
                         load_w_word(plane, k + 1, n, K, N, vec),
                         load_w_word(plane, k + 2, n, K, N, vec),
                         load_w_word(plane, k + 3, n, K, N, vec));
      }
    }
  }
};

// Field f of four packed bytes: (word >> 2f) & 0x03030303 keeps bits 2f, 2f+1
// of every byte; the signed read maps [0, 3] to [0, 1, -2, -1] per byte as
// (f ^ 2) - 2 (__vsub4 subtracts bytewise, without borrows between bytes).
__device__ __forceinline__ int field_word(int word, int f, bool sign) {
  const int v = (static_cast<unsigned>(word) >> (2 * f)) & 0x03030303;
  return sign ? static_cast<int>(__vsub4(v ^ 0x02020202, 0x02020202)) : v;
}

// uint8 store [K, N]: the tile is loaded once and split into P planes.
struct PackedSource {
  const int8_t* packed;
  bool vec;
  int f0, fstep, sign_plane;   // plane c = field f0 + fstep * c

  __device__ __forceinline__ void stage(PlaneTile* w, int k0, int n0, int K, int N,
                                        int P) const {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int s = threadIdx.x + kThreads * i;
      const int kq = s / 16, nq = s % 16;
      const int k = k0 + 4 * kq, n = n0 + 4 * nq;
      const int r0 = load_w_word(packed, k + 0, n, K, N, vec);
      const int r1 = load_w_word(packed, k + 1, n, K, N, vec);
      const int r2 = load_w_word(packed, k + 2, n, K, N, vec);
      const int r3 = load_w_word(packed, k + 3, n, K, N, vec);
#pragma unroll
      for (int c = 0; c < kMaxPlanes; ++c) {
        if (c >= P) break;
        const int f = f0 + fstep * c;
        const bool sign = c == sign_plane;
        store_transposed(w[c], kq, nq, field_word(r0, f, sign), field_word(r1, f, sign),
                         field_word(r2, f, sign), field_word(r3, f, sign));
      }
    }
  }
};

// Accumulates the block's tile into acc[i][j] (row ty + 8 i, column tx + 16 j).
template <int TM, class WSource>
__device__ __forceinline__ void accumulate(
    const int8_t* __restrict__ x, const WSource& wsrc, int M, int K, int N, int P,
    int m0, int n0, bool vec_x, const int (&coef)[TM][kMaxPlanes], int (&acc)[TM][4],
    Smem<TM>& sm) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int w = tid + kThreads * i;
      const int r = w / kKW, kw = w % kKW;
      sm.x[r][kw] = load_x_word(x, m0 + r, k0 + 4 * kw, M, K, vec_x);
    }
    wsrc.stage(sm.w, k0, n0, K, N, P);
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kMaxPlanes; ++c) {
      if (c >= P) break;
      int part[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = 0;
#pragma unroll
      for (int kw = 0; kw < kKW; ++kw) {
        int b[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = sm.w[c][tx + 16 * j][kw];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int a = sm.x[ty + 8 * i][kw];
#pragma unroll
          for (int j = 0; j < 4; ++j) part[i][j] = __dp4a(a, b[j], part[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j] * coef[i][c];
    }
    __syncthreads();
  }
}

}  // namespace plane_gemm
