// Tensor-core core of every plane GEMM of the port:
//   acc int32 [M, N] = sum_c (x int8 [M, K] @ plane_c int8 [K, N]) * coef[m, c]
// from int8 planes [P, K, N] or a byte-packed uint8 [K, N] store (plane c =
// 2-bit field f0 + c, one field read as signed [-2, 1]).  The shift GEMMs
// (bitserial_matmul.cu) take one coefficient per plane, coef_c = 1 << s_c,
// and write acc as int32.  The grouped GEMMs (grouped_matmul.cu, kGrouped)
// take one per row and plane, mult[m, c] (decompose.prefix_multipliers), and
// write acc as int32 (grouped_matmul) or through the dequant epilogue
// bf16((f32(acc) * x_scale[m]) * w_scale[row_group[m], n])
// (grouped_dequant_matmul).
//
// What holds these GEMMs back on an H100 is bytes, not operations: at M <= 64
// a GEMM does 2 M <= 128 int8 operations per weight byte, against the card's
// ~590 (1979 T int8 op/s over 3.35 TB/s).  The design keeps enough weight
// bytes in flight and takes the products off the CUDA cores:
//
// 1. Int8 tensor-core MMA (mma.sync m16n8k32 .s32.s8.s8.s32), one pass per
//    plane: each plane's partial sum of a K stage starts at zero and is folded
//    into the int32 accumulator times its coefficient, the TPU kernels'
//    structure (cost scales with the planes read).  A grouped kernel holds
//    the coefficients of its thread's fragment rows in registers (0 for rows
//    >= M), loaded once per block.  Planes are never recombined into one int8
//    operand: that is exact only for 2-bit planes, and the planes are taken as
//    any int8 values.  No saturation: |acc| <= 128 * 191 * K < 2^31 for
//    K <= 12288 on the serving stores (128 * 128 * K for the grouped sums,
//    which rebuild an 8-bit weight).
// 2. Both operands K-major.  The store is N-contiguous, so each warp reads
//    four rows k..k+3 of a 4-byte column word from the raw stage tile and
//    transposes them in registers (8 __byte_perm): word j then holds column
//    n + j, k..k+3, which is the m16n8k32 B fragment of MMA column g in n8
//    tile j when the warp's 32 columns are ordered n = 4 g + j.  The output
//    fragment inherits that order, so a thread's eight values of one row are
//    eight consecutive columns (one or two 16-byte stores).  The x tile's rows
//    are the A fragment, read with ldmatrix.x4.  The packed source reads and
//    transposes a stage's words once and splits each plane's field from the
//    transposed words (field_word works bytewise, so the two commute).  The
//    raw weight tile's 16-byte chunks are XOR-swizzled by row
//    (chunk ^ 2 ((k >> 2) & 3)) and x rows padded by 16 bytes, so the
//    fragment reads are free of bank conflicts.
// 3. An asynchronous copy ring: kStages slots in dynamic shared memory; the x
//    tile and the raw weight tiles of stage s + kStages - 1 are requested with
//    cp.async.cg 16-byte copies while stage s computes (one __syncthreads per
//    stage).  Out-of-range chunks are zero-filled by the copy itself.  Rows
//    that are not 16-byte aligned (K or N not a multiple of 16, an offset
//    view) take a masked byte-load path into the same ring.
// 4. Split-K: blockIdx.z owns K slice [z * kslice, (z + 1) * kslice), a whole
//    number of stages.  Each slice stores its partial tile to a workspace,
//    fences, and draws a ticket from its output tile's counter; the block
//    that draws the last ticket adds the slices in slice order, writes the
//    tile (through the dequant epilogue, in registers, where there is one)
//    and resets the counter to zero for the next launch: one launch, no
//    memset, no atomics on the output.  The sums are integers, so the
//    result is bit-identical in any order.
// 5. Tile shapes by M: BM = 16, 32 or 64 rows and kBN = 128 columns per
//    block of eight warps, four along N (32 columns each) and two along M
//    (BM >= 32) or along K (BM = 16, alternate k32 steps, summed through
//    shared memory at the end), so more warps hide the latency of the
//    fragment loads.  The launch plan (BM, stage depth BK, kslice, shared
//    bytes, workspace ints) is computed by the Python wrapper
//    (bitserial_matmul.plan) and passed in; BM and BK are template
//    parameters, so the k32 loop unrolls.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace plane_mma {

constexpr int kThreads = 256;   // eight warps
constexpr int kBN = 128;        // output columns per block, 32 per warp
constexpr int kStages = 4;      // slots of the copy ring
constexpr int kMaxPlanes = 4;
constexpr int kXPad = 16;       // bytes of padding at the end of each x row
constexpr int kMaxSmem = 227 * 1024;

// The weight operand: plane c is tile c of a stage (int8 planes) or field
// f0 + c of the one packed tile.  Its coefficient is coef[c] = 1 << shift in
// the shift GEMMs; in the grouped ones it is mult[m * P + c] for row m, or
// mult[m * P + P - 1 - c] with mult_reversed (a packed store's fields ascend
// while the multiplier table is MSB-first).
struct Weights {
  const int8_t* ptr;
  int P;
  int coef[kMaxPlanes];
  int f0, sign_plane;     // packed only; sign_plane -1: every field unsigned
  const int32_t* mult;    // grouped only: int32 [M, P]
  bool mult_reversed;
};

// The grouped kernels' output: a null x_scale writes the int32 sums (as the
// shift GEMMs do); otherwise bf16((f32(acc) * x_scale[m]) * w_scale[g * N + n])
// with g = row_group[m].
struct Epilogue {
  const float* x_scale;
  const float* w_scale;
  const int32_t* row_group;
};

// A split launch's scratch: `workspace` (workspace_ints) and one counter per
// output tile, zero between launches.
struct Split {
  int* counters;
  int* workspace;
};

// The workspace a split launch needs: one BM x kBN int32 tile per output
// tile and K slice (0 without a split).
__host__ __device__ constexpr int workspace_ints(int bm, int gx, int gy, int splits) {
  return splits > 1 ? splits * gx * gy * bm * kBN : 0;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d += a (16 x 32, row) * b (32 x 8, col), int8 in, int32 accumulate.
__device__ __forceinline__ void mma_s8(int (&d)[4], const int (&a)[4], int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows r[q] = w[k + q, n..n+3] -> w[j] = w[k..k+3, n + j] (4x4 byte transpose).
__device__ __forceinline__ void transpose4(const int (&r)[4], int (&w)[4]) {
  const int t0 = __byte_perm(r[0], r[1], 0x5140), t1 = __byte_perm(r[0], r[1], 0x7362);
  const int t2 = __byte_perm(r[2], r[3], 0x5140), t3 = __byte_perm(r[2], r[3], 0x7362);
  w[0] = __byte_perm(t0, t2, 0x5410);
  w[1] = __byte_perm(t0, t2, 0x7632);
  w[2] = __byte_perm(t1, t3, 0x5410);
  w[3] = __byte_perm(t1, t3, 0x7632);
}

// Field f of four packed bytes: (word >> 2f) & 0x03030303 keeps bits 2f, 2f+1
// of every byte; the signed read maps [0, 3] to [0, 1, -2, -1] per byte as
// (f ^ 2) - 2 (__vsub4 subtracts bytewise, without borrows between bytes).
__device__ __forceinline__ int field_word(int word, int f, bool sign) {
  const int v = (static_cast<unsigned>(word) >> (2 * f)) & 0x03030303;
  return sign ? static_cast<int>(__vsub4(v ^ 0x02020202, 0x02020202)) : v;
}

// 16 bytes row[col .. col+15] into dst, zero at and beyond `limit` or when
// !row_ok (the masked path for rows that are not 16-byte aligned).
__device__ __forceinline__ void load_chunk_masked(unsigned char* dst, const int8_t* row,
                                                  int col, int limit, bool row_ok) {
  unsigned w[4] = {0u, 0u, 0u, 0u};
  if (row_ok) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (col + j < limit)
        w[j / 4] |= static_cast<unsigned>(static_cast<uint8_t>(row[col + j])) << (8 * (j % 4));
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ int lds(const unsigned char* p) {
  return *reinterpret_cast<const int*>(p);
}

// Physical 16-byte chunk of logical chunk ch in row r of a raw weight tile.
__device__ __forceinline__ int swizzle(int r, int ch) { return ch ^ (((r >> 2) & 3) << 1); }

// Dynamic shared memory of one launch: kStages slots of (weight tiles, x tile).
__host__ __device__ constexpr int slot_bytes(int tiles, int bm, int bk) {
  return tiles * bk * kBN + bm * (bk + kXPad);
}

// The 16 x 32-byte A tile at `tile` (row stride `stride`) as the four m8n8
// b16 matrices of the m16n8k32 A fragment: lane 8q + r addresses row
// (q & 1) 8 + r, bytes (q >> 1) 16.
__device__ __forceinline__ void ldmatrix_a(int (&a)[4], const unsigned char* tile, int stride,
                                           int lane) {
  const int q = lane >> 3, r = lane & 7;
  const unsigned s = static_cast<unsigned>(
      __cvta_generic_to_shared(tile + ((q & 1) * 8 + r) * stride + (q >> 1) * 16));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(s));
}

// bf16((f32(v) * xs) * ws), the reference's order, rounded to nearest even.
__device__ __forceinline__ __nv_bfloat16 dequant(int v, float xs, float ws) {
  return __float2bfloat16_rn((__int2float_rn(v) * xs) * ws);
}

// Two bf16 as one word, lo in the low half (the lower address).
__device__ __forceinline__ unsigned bf16x2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(lo)) |
         (static_cast<unsigned>(__bfloat16_as_ushort(hi)) << 16);
}

// Eight warps: four along N (32 columns each) times two along M (BM >= 32,
// MT = BM / 32 m16 tiles each) or along K (BM = 16: the two halves take
// alternate k32 steps and add their sums through shared memory at the end).
template <int BM, int BK, bool kPacked, bool kGrouped>
__global__ void __launch_bounds__(kThreads, 2)
plane_gemm_kernel(const int8_t* __restrict__ x, const Weights wt, const Epilogue epi,
                  const Split sp, void* __restrict__ out, int M, int K, int N, int kslice,
                  bool vec_x, bool vec_w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* const smem = smem_raw;
  constexpr int WM = BM >= 32 ? 2 : 1, WK = 2 / WM;
  constexpr int MT = BM / 16 / WM, KS = BK / 32;
  constexpr int kTileBytes = BK * kBN, kXStride = BK + kXPad;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int nw = warp % 4, wy = warp / 4;
  const int wrow = WM == 2 ? wy * (BM / 2) : 0, kg = WK == 2 ? wy : 0;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int kb = blockIdx.z * kslice, ke = min(K, kb + kslice);
  const int nst = ke > kb ? (ke - kb + BK - 1) / BK : 0;
  const int tiles = kPacked ? 1 : wt.P;
  const int slot = slot_bytes(tiles, BM, BK);
  const size_t plane_stride = static_cast<size_t>(K) * N;

  auto load = [&](int s) {
    unsigned char* ws = smem + (s % kStages) * slot;
    unsigned char* xs = ws + tiles * kTileBytes;
    const int k0 = kb + s * BK;
    for (int i = tid; i < tiles * BK * 8; i += kThreads) {
      const int c = i / (BK * 8), r = (i / 8) % BK, ch = i % 8;
      const int k = k0 + r, n = n0 + ch * 16;
      unsigned char* dst = ws + c * kTileBytes + r * kBN + swizzle(r, ch) * 16;
      const int8_t* row = wt.ptr + c * plane_stride + static_cast<size_t>(k) * N;
      if (vec_w) {
        const bool ok = k < K && n < N;
        cp_async16(dst, ok ? row + n : wt.ptr, ok ? 16 : 0);
      } else {
        load_chunk_masked(dst, row, n, N, k < K);
      }
    }
    constexpr int kXChunks = BK / 16;
    for (int i = tid; i < BM * kXChunks; i += kThreads) {
      const int r = i / kXChunks, ch = i % kXChunks;
      const int m = m0 + r, k = k0 + ch * 16;
      unsigned char* dst = xs + r * kXStride + ch * 16;
      const int8_t* row = x + static_cast<size_t>(m) * K;
      if (vec_x) {
        const bool ok = m < M && k < K;
        cp_async16(dst, ok ? row + k : x, ok ? 16 : 0);
      } else {
        load_chunk_masked(dst, row, k, K, m < M);
      }
    }
  };

  int acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][j][q] = 0;

  // Grouped: the coefficients of this thread's fragment rows
  // m0 + wrow + 16 mt + g + 8 half (see the store below), 0 beyond M.
  int rc[kGrouped ? MT : 1][2][kMaxPlanes];
  if constexpr (kGrouped) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wrow + mt * 16 + g + 8 * half;
#pragma unroll
        for (int c = 0; c < kMaxPlanes; ++c) {
          const int col = wt.mult_reversed ? wt.P - 1 - c : c;
          rc[mt][half][c] =
              m < M && c < wt.P ? wt.mult[static_cast<size_t>(m) * wt.P + col] : 0;
        }
      }
  }

  // This thread's byte in a raw tile row: columns 32 nw + 4 g .. + 3, a
  // word of logical chunk 2 nw + g / 4; the rows it reads have
  // (r >> 2) & 3 == t, so the swizzle is fixed per thread.
  const int colbyte = (((2 * nw + (g >> 2)) ^ (2 * t)) * 16) + (g & 3) * 4;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nst) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // stage s landed; every thread is done with slot s - 1
    if (s + kStages - 1 < nst) load(s + kStages - 1);
    cp_async_commit();
    // With one k32 step per stage, the K halves take alternate stages.
    if (WK == 2 && KS == 1 && (s & 1) != kg) continue;

    const unsigned char* ws = smem + (s % kStages) * slot;
    const unsigned char* xs = ws + tiles * kTileBytes + wrow * kXStride;
    // Packed: this thread's words of the stage, read and transposed once for
    // all planes (a field is taken bytewise, so it commutes with the byte
    // transpose).
    int raw[kPacked ? KS : 1][2][4];
    if (kPacked) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        if (WK == 2 && KS > 1 && (ks & 1) != kg) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const unsigned char* br = ws + colbyte + (ks * 32 + h * 16 + 4 * t) * kBN;
          int r[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) r[q] = lds(br + q * kBN);
          transpose4(r, raw[kPacked ? ks : 0][h]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kMaxPlanes; ++c) {
      if (c >= wt.P) break;
      const unsigned char* tile = ws + c * kTileBytes + colbyte;   // int8 planes
      int part[MT][4][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) part[mt][j][q] = 0;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        if (WK == 2 && KS > 1 && (ks & 1) != kg) continue;
        int a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldmatrix_a(a[mt], xs + mt * 16 * kXStride + ks * 32, kXStride, lane);
        int b[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (kPacked) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              b[h][j] = field_word(raw[kPacked ? ks : 0][h][j], wt.f0 + c, c == wt.sign_plane);
          } else {
            const unsigned char* br = tile + (ks * 32 + h * 16 + 4 * t) * kBN;
            int r[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) r[q] = lds(br + q * kBN);
            transpose4(r, b[h]);
          }
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_s8(part[mt][j], a[mt], b[0][j], b[1][j]);
      }
      const int coef = wt.coef[c];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[mt][j][q] += part[mt][j][q] * (kGrouped ? rc[kGrouped ? mt : 0][q / 2][c] : coef);
    }
  }
  cp_async_wait<0>();

  // With the K halves (BM = 16), the upper one hands its sums to the lower
  // one, which alone holds the result from here on.
  const bool owner = WK == 1 || kg == 0;
  if (WK == 2) {
    __syncthreads();
    int* red = reinterpret_cast<int*>(smem);
    const int id = nw * 32 + lane;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int idx = ((mt * 4 + j) * 4 + q) * 128 + id;
          if (kg == 1) red[idx] = acc[mt][j][q];
        }
    __syncthreads();
    if (owner) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mt][j][q] += red[((mt * 4 + j) * 4 + q) * 128 + id];
    }
  }

  if (gridDim.z > 1) {
    // Each slice's partial tile goes to the workspace, [tile][z][int4 q][owner],
    // so that a thread stores and later reads its own fragments, coalesced.
    constexpr int kOwners = kThreads / WK, kQuads = MT * 4;
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    const int id = WK == 2 ? nw * 32 + lane : tid;
    int4* part = reinterpret_cast<int4*>(sp.workspace) +
                 static_cast<size_t>(tile) * gridDim.z * kQuads * kOwners + id;
    if (owner) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          part[(blockIdx.z * kQuads + mt * 4 + j) * kOwners] =
              make_int4(acc[mt][j][0], acc[mt][j][1], acc[mt][j][2], acc[mt][j][3]);
    }
    __threadfence();   // the partial is visible on the device before the ticket
    __syncthreads();   // (and every thread is past its reads of `red`)
    int* ticket = reinterpret_cast<int*>(smem);
    if (tid == 0) *ticket = atomicAdd(sp.counters + tile, 1);
    __syncthreads();
    if (*ticket != static_cast<int>(gridDim.z) - 1) return;
    __threadfence();
    if (tid == 0) sp.counters[tile] = 0;   // ready for the next launch
    if (owner) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mt][j][q] = 0;
      // A bounded unroll keeps the loads in flight, and so the registers,
      // to what the main loop needs (an unbounded one sets the kernel's
      // register count, and with it the blocks resident per SM).
      constexpr int kUnroll = MT == 1 ? 2 : 1;
#pragma unroll kUnroll
      for (int z = 0; z < static_cast<int>(gridDim.z); ++z) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int4 v = __ldcg(part + (z * kQuads + mt * 4 + j) * kOwners);
            acc[mt][j][0] += v.x;
            acc[mt][j][1] += v.y;
            acc[mt][j][2] += v.z;
            acc[mt][j][3] += v.w;
          }
      }
    }
  }
  if (!owner) return;

  // Fragment (mt, j, q): row mt 16 + g + 8 (q / 2), MMA column 2 t + q % 2,
  // i.e. block column 32 nw + 8 t + 4 (q % 2) + j.
  const bool dequant_out = kGrouped && epi.x_scale != nullptr;
  const int n = n0 + 32 * nw + 8 * t;
  const bool vec_out =
      dequant_out ? N % 8 == 0 && ((reinterpret_cast<uintptr_t>(out) |
                                    reinterpret_cast<uintptr_t>(epi.w_scale)) & 15) == 0
                  : N % 4 == 0;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wrow + mt * 16 + g + 8 * half;
      if (m >= M) continue;
      int v[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = acc[mt][j][2 * half];
        v[4 + j] = acc[mt][j][2 * half + 1];
      }
      if (dequant_out) {
        const float xs = epi.x_scale[m];
        const float* wsr = epi.w_scale + static_cast<size_t>(epi.row_group[m]) * N + n;
        __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + static_cast<size_t>(m) * N + n;
        if (vec_out && n + 8 <= N) {
          const float4 w0 = __ldg(reinterpret_cast<const float4*>(wsr));
          const float4 w1 = __ldg(reinterpret_cast<const float4*>(wsr) + 1);
          *reinterpret_cast<uint4*>(o) = make_uint4(
              bf16x2(dequant(v[0], xs, w0.x), dequant(v[1], xs, w0.y)),
              bf16x2(dequant(v[2], xs, w0.z), dequant(v[3], xs, w0.w)),
              bf16x2(dequant(v[4], xs, w1.x), dequant(v[5], xs, w1.y)),
              bf16x2(dequant(v[6], xs, w1.z), dequant(v[7], xs, w1.w)));
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (n + e < N) o[e] = dequant(v[e], xs, wsr[e]);
        }
        continue;
      }
      int32_t* o = static_cast<int32_t*>(out) + static_cast<size_t>(m) * N + n;
      if (vec_out && n + 8 <= N) {
        reinterpret_cast<int4*>(o)[0] = make_int4(v[0], v[1], v[2], v[3]);
        reinterpret_cast<int4*>(o)[1] = make_int4(v[4], v[5], v[6], v[7]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (n + e < N) o[e] = v[e];
      }
    }
  }
}

// The launch after its plan is checked: smem and ws_ints are the plan's
// requests, refused (cudaErrorInvalidValue) where they differ from this
// core's layout (kStages slots of slot_bytes; workspace_ints for a split
// launch, which also needs its counters and workspace).
template <int BM, int BK, bool kPacked, bool kGrouped>
int launch_tile(const int8_t* x, const Weights& wt, const Epilogue& epi, const Split& sp,
                void* out, int M, int K, int N, int kslice, int smem, int ws_ints, bool vec_x,
                bool vec_w, cudaStream_t stream) {
  const int splits = K > 0 ? (K + kslice - 1) / kslice : 1;
  const dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM, splits);
  const int ws_need = workspace_ints(BM, grid.x, grid.y, splits);
  if (smem != kStages * slot_bytes(kPacked ? 1 : wt.P, BM, BK) || smem > kMaxSmem ||
      ws_ints != ws_need ||
      (ws_need > 0 && (sp.counters == nullptr || sp.workspace == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = plane_gemm_kernel<BM, BK, kPacked, kGrouped>;
  static unsigned opted_in = 0;   // devices (bit per ordinal) allowed kMaxSmem
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 32 || !(opted_in & (1u << dev))) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 32) opted_in |= 1u << dev;
  }
  kernel<<<grid, kThreads, smem, stream>>>(x, wt, epi, sp, out, M, K, N, kslice, vec_x,
                                           vec_w);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, bool kPacked, bool kGrouped>
int launch_bm(const int8_t* x, const Weights& wt, const Epilogue& epi, const Split& sp,
              void* out, int M, int K, int N, int bk, int kslice, int smem, int ws_ints,
              bool vec_x, bool vec_w, cudaStream_t stream) {
  switch (bk) {
    case 32:
      return launch_tile<BM, 32, kPacked, kGrouped>(x, wt, epi, sp, out, M, K, N, kslice,
                                                   smem, ws_ints, vec_x, vec_w, stream);
    case 64:
      return launch_tile<BM, 64, kPacked, kGrouped>(x, wt, epi, sp, out, M, K, N, kslice,
                                                   smem, ws_ints, vec_x, vec_w, stream);
    case 128:
      return launch_tile<BM, 128, kPacked, kGrouped>(x, wt, epi, sp, out, M, K, N, kslice,
                                                    smem, ws_ints, vec_x, vec_w, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Checks the plan and launches; bm in {16, 32, 64}, bk in {32, 64, 128},
// kslice a positive multiple of bk, smem the layout's dynamic shared bytes,
// ws_ints the split launch's workspace (0 without a split).
template <bool kPacked, bool kGrouped>
int launch(const void* x, const Weights& wt, const Epilogue& epi, void* counters,
           void* workspace, void* out, int M, int K, int N, int vec_x, int vec_w, int bm,
           int bk, int kslice, int smem, int ws_ints, void* stream) {
  if (kslice <= 0 || bk <= 0 || kslice % bk != 0 || wt.P < 1 || wt.P > kMaxPlanes)
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const Split sp{static_cast<int*>(counters), static_cast<int*>(workspace)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bm) {
    case 16:
      return launch_bm<16, kPacked, kGrouped>(xp, wt, epi, sp, out, M, K, N, bk, kslice,
                                              smem, ws_ints, vec_x, vec_w, st);
    case 32:
      return launch_bm<32, kPacked, kGrouped>(xp, wt, epi, sp, out, M, K, N, bk, kslice,
                                              smem, ws_ints, vec_x, vec_w, st);
    case 64:
      return launch_bm<64, kPacked, kGrouped>(xp, wt, epi, sp, out, M, K, N, bk, kslice,
                                              smem, ws_ints, vec_x, vec_w, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace plane_mma
