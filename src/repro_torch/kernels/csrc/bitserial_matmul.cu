// Plane-decomposed integer GEMM: out int32 [M, N] = sum_c (x @ plane_c) << s_c,
// from int8 planes (bitserial_matmul_s8) or a byte-packed store
// (packed_bitserial_matmul_u8), on the int8 tensor-core core plane_mma.cuh.
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
// Bound on an H100 (3.35 TB/s): bytes at every serving shape (M <= 64 rows do
// at most 128 int8 operations per weight byte, the card ~590).  At K = 4096
// the P = 4 planes read 16 K N bytes, N = 1024 / 4096 / 12288 / 152064:
// 0.005 / 0.020 / 0.060 / 0.744 ms; K = 12288, N = 4096: 0.060 ms.  The
// packed store reads K N bytes at any P, a quarter of those.
//
// The first port of these GEMMs (a dp4a core, since removed) reached
// 2.5-14 % of these bounds: products on the CUDA cores (dp4a, four MACs per
// instruction), each K stage loaded then computed with nothing in flight, and
// 16 (N = 1024) or 64 (N = 4096) blocks on 132 SMs.  plane_mma.cuh answers
// each: int8 mma.sync, one pass per plane folded by its shift (1); operands
// K-major by a register transpose of the N-contiguous store, which is kept as
// the reference's (2); a four-slot cp.async ring (3); split-K over
// blockIdx.z where the output tiles are fewer than one wave of resident
// blocks, the slices summed by the last block of each output tile through a
// workspace (4); 16-, 32- or 64-row tiles by M (5).  The grouped GEMMs
// (grouped_matmul.cu) run on the same core.  The plan (row tile, stage
// depth, K slice, shared bytes, workspace) comes from the Python wrapper,
// bitserial_matmul.plan; a plan that differs from the core's layout is
// refused (cudaErrorInvalidValue).
#include "plane_mma.cuh"

extern "C" int bitserial_matmul_s8(const void* x, const void* planes, void* counters,
                                   void* workspace, void* out, int M, int K, int N, int P,
                                   int s0, int s1, int s2, int s3, int vec_x, int vec_w,
                                   int bm, int bk, int kslice, int smem, int ws_ints,
                                   void* stream) {
  const plane_mma::Weights wt{static_cast<const int8_t*>(planes), P,
                              {1 << s0, 1 << s1, 1 << s2, 1 << s3}, 0, -1, nullptr, false};
  return plane_mma::launch<false, false>(x, wt, plane_mma::Epilogue{}, counters, workspace,
                                         out, M, K, N, vec_x, vec_w, bm, bk, kslice, smem,
                                         ws_ints, stream);
}

// P = eff_bits / 2 planes; plane c is byte field first_field + c at shift 2c;
// the top one (c = P - 1) is signed when sign != 0.
extern "C" int packed_bitserial_matmul_u8(const void* x, const void* packed,
                                          void* counters, void* workspace, void* out, int M,
                                          int K, int N, int P, int first_field, int sign,
                                          int vec_x, int vec_w, int bm, int bk, int kslice,
                                          int smem, int ws_ints, void* stream) {
  const plane_mma::Weights wt{static_cast<const int8_t*>(packed), P, {1, 4, 16, 64},
                              first_field, sign != 0 ? P - 1 : -1, nullptr, false};
  return plane_mma::launch<true, false>(x, wt, plane_mma::Epilogue{}, counters, workspace,
                                        out, M, K, N, vec_x, vec_w, bm, bk, kslice, smem,
                                        ws_ints, stream);
}
