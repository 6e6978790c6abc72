// Group-switching plane-prefix GEMM, raw and with the fused dequant epilogue:
//   grouped_matmul:          out int32 [M, N] = sum_c (x @ plane_c) * mult[m, c]
//   grouped_dequant_matmul:  out bf16 [M, N] = bf16(((f32(acc[m, n])) * x_scale[m])
//                                                   * w_scale[group[m], n])
// each from int8 planes (_s8) or a byte-packed uint8 store (_u8), on the int8
// tensor-core core plane_mma.cuh (kGrouped), the core of the shift GEMMs too.
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
// store's top field (c = 0) of a signed store; in the core's ascending field
// order, core plane c' is field store_planes-Pmax+c' with multiplier column
// Pmax-1-c'.  The weight scale arrives as one effective scale row per tier
// group [G, N] plus a row -> group index, in place of the reference's
// broadcast [M, N] rows; the values and the multiply order
// (acc * x_scale) * w_scale are the reference's, converted with
// __int2float_rn and __float2bfloat16_rn, so the output bits equal the plain
// version's.
//
// Bound on an H100 (3.35 TB/s): bytes, as for the shift GEMMs (M <= 64 rows
// do at most 128 int8 operations per weight byte, the card ~590).  At M = 8,
// K = 4096, the int8 prefix at Pmax = 4 reads 16 K N bytes, N = 1024 / 4096 /
// 12288 / 152064: 0.005 / 0.020 / 0.060 / 0.745 ms; K = 12288, N = 4096:
// 0.060 ms; the packed store reads K N bytes at any Pmax, a quarter of those.
// A full-width decode step reads about 30.3 GB of int8 planes at Pmax = 4
// (9.0 ms), or 7.6 GB packed (2.3 ms).
//
// The earlier dp4a core reached 1-56 % of these bounds (0.5-21 % packed): its
// time barely moved with N, since one 64-column block owned the whole K and
// walked it serially; each 64-deep stage was loaded, then computed on the
// CUDA cores (__dp4a) with nothing in flight; and N = 1024 / 4096 / 12288
// gave 16 / 64 / 192 blocks on 132 SMs.  plane_mma.cuh answers each: int8
// mma.sync, one pass per plane folded by each row's multiplier held in
// registers (1); a four-slot cp.async ring (3); split-K to one wave of
// resident blocks, the slices summed by the last block of each output tile
// through a workspace, which then applies the epilogue to the fragments in
// registers and writes eight bf16 with one 16-byte store (4); the packed
// store read and transposed once per stage for all planes (2).  The plan
// (row tile, stage depth, K slice, shared bytes, workspace) comes from
// bitserial_matmul.plan, the same for all four GEMMs; a plan that differs
// from the core's layout is refused (cudaErrorInvalidValue).
#include "plane_mma.cuh"

namespace {

using plane_mma::Epilogue;
using plane_mma::Weights;

Weights planes_of(const void* planes, const void* mult, int P) {
  return Weights{static_cast<const int8_t*>(planes), P, {0, 0, 0, 0}, 0, -1,
                 static_cast<const int32_t*>(mult), false};
}

// MSB-first plane c = field store_planes-1-c; only c = 0 may be signed.
Weights packed_of(const void* packed, const void* mult, int P, int store_planes, int sign) {
  return Weights{static_cast<const int8_t*>(packed), P, {0, 0, 0, 0}, store_planes - P,
                 sign != 0 ? P - 1 : -1, static_cast<const int32_t*>(mult), true};
}

Epilogue epilogue_of(const void* x_scale, const void* w_scale, const void* row_group) {
  return Epilogue{static_cast<const float*>(x_scale), static_cast<const float*>(w_scale),
                  static_cast<const int32_t*>(row_group)};
}

}  // namespace

extern "C" int grouped_matmul_s8(const void* x, const void* planes, const void* mult,
                                 void* counters, void* workspace, void* out, int M, int K,
                                 int N, int P, int vec_x, int vec_w, int bm, int bk, int kslice,
                                 int smem, int ws_ints, void* stream) {
  return plane_mma::launch<false, true>(x, planes_of(planes, mult, P), Epilogue{}, counters,
                                        workspace, out, M, K, N, vec_x, vec_w, bm, bk, kslice,
                                        smem, ws_ints, stream);
}

extern "C" int grouped_matmul_u8(const void* x, const void* packed, const void* mult,
                                 void* counters, void* workspace, void* out, int M, int K,
                                 int N, int P, int store_planes, int sign, int vec_x, int vec_w,
                                 int bm, int bk, int kslice, int smem, int ws_ints,
                                 void* stream) {
  if (P > store_planes) return static_cast<int>(cudaErrorInvalidValue);
  return plane_mma::launch<true, true>(x, packed_of(packed, mult, P, store_planes, sign),
                                       Epilogue{}, counters, workspace, out, M, K, N, vec_x,
                                       vec_w, bm, bk, kslice, smem, ws_ints, stream);
}

extern "C" int grouped_dequant_matmul_s8(const void* x, const void* planes,
                                         const void* mult, const void* x_scale,
                                         const void* w_scale, const void* row_group,
                                         void* counters, void* workspace, void* out, int M,
                                         int K, int N, int P, int vec_x, int vec_w, int bm,
                                         int bk, int kslice, int smem, int ws_ints,
                                         void* stream) {
  return plane_mma::launch<false, true>(x, planes_of(planes, mult, P),
                                        epilogue_of(x_scale, w_scale, row_group), counters,
                                        workspace, out, M, K, N, vec_x, vec_w, bm, bk, kslice,
                                        smem, ws_ints, stream);
}

extern "C" int grouped_dequant_matmul_u8(const void* x, const void* packed,
                                         const void* mult, const void* x_scale,
                                         const void* w_scale, const void* row_group,
                                         void* counters, void* workspace, void* out, int M,
                                         int K, int N, int P, int store_planes, int sign,
                                         int vec_x, int vec_w, int bm, int bk, int kslice,
                                         int smem, int ws_ints, void* stream) {
  if (P > store_planes) return static_cast<int>(cudaErrorInvalidValue);
  return plane_mma::launch<true, true>(x, packed_of(packed, mult, P, store_planes, sign),
                                       epilogue_of(x_scale, w_scale, row_group), counters,
                                       workspace, out, M, K, N, vec_x, vec_w, bm, bk, kslice,
                                       smem, ws_ints, stream);
}
