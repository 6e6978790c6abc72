// Single-token decode attention over the KV arena, in every storage mode.
//
// Replaces no TPU kernel: the reference's decode attention is plain jnp
// (src/repro/models/layers.py::decode_attention, no pallas_call).  It takes
// the place of the port's plain path on the card (KVCache.read, which
// dequantizes and casts the whole arena, then _decode_core's f32 einsums
// and softmax: some twenty launches a layer over every slot's Smax
// positions), and computes, for slot b, query head h of KV head h / g:
//   s[t] = (sum_d f32(q[d]) * f32(k[t, d])) * (1/sqrt(Dh))   t < len[b]
//   s[t] = NEG = -1e30                                        t >= len[b]
//   m = max_t s[t],  l = sum_t expf(s[t] - m)     over the WHOLE slot
//   p[t] = bf16(expf(s[t] - m) / l)               (IEEE division)
//   out[d] = bf16(sum_t f32(p[t]) * f32(v[t, d]))
// with K and V read as the arena stores them: bf16; int8 codes, or int4
// nibbles (element 2i in the low half of byte i), times the position's
// bf16 scale and rounded to bf16 (bf16(code * scale), as KVCache.read
// rounds); or the mixed byte-lane arena, each slot at its own kv_bits
// code (a code the arena does not serve takes the last one it does, as
// KVCache._slot_select does), read on the device.  These are the plain
// version's rounding points; only the order of the f32 sums differs.
//
// Bound on an H100: bytes.  A slot of length n needs its K and V rows up
// to n read once, 2 * KVH * Dh * n elements (bf16: 4 KB a position at 8
// KV heads of 128), nothing else of the arena; reason's ~640-token mean
// context over 64 slots is ~168 MB a layer, ~50 us at 3.35 TB/s.  Design:
// - one block per (slot, KV head) serves the head's g query heads from
//   one read of K and one of V (GQA); a third grid axis splits g > 8
//   into groups of heads, each its own block;
// - rows are read as 8-element vectors (16 B of bf16, 8 of int8, 4 of
//   int4): a K row by one thread, all of it (a score is one thread's dot
//   product: no shuffle, q broadcast from shared memory), kBatch vectors
//   in flight; a V row by kLanes lanes, coalesced along Dh, each thread
//   issuing the loads of kUnroll rows before it uses the first;
// - loops end at the slot's own length, read on the device: no host read,
//   no sync, nothing past the length is read (a slot of length 0 reads V
//   over the whole slot: every score is NEG, so p is 1/Smax everywhere,
//   the plain version's result);
// - two passes: scores into shared memory (chunks of up to `chunk`
//   positions; a longer slot recomputes each chunk's scores in the later
//   phases), then m and l, then p in place and the PV product;
// - every operand is addressed through its strides, so slot views and
//   head-sliced views (a tensor-parallel rank's heads) are read in place.
// The reduction order depends on nothing but Dh and the slot's length: a
// score's dot product runs over Dh in order; l sums position t on thread
// t mod kThreads, in order, then a fixed tree; PV sums position t on row
// group t mod kRows, in order, then a fixed tree over row groups and
// warps.  Chunks are
// multiples of kThreads, so recomputing changes no sum either.  A row's
// bits are therefore the same alone or in a batch, among other heads or
// not, in an arena of any Smax.  Explicit __fmaf_rn / __fadd_rn /
// __fmul_rn / __fdiv_rn keep the compiler from contracting differently
// at different call sites; expf is the accurate one (no fast math).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;               // V rows in flight per row group
constexpr int kBatch = 8;                // K vectors in flight per thread
constexpr float kNeg = -1e30f;           // layers.NEG
constexpr int kScoreBudget = 96 * 1024;  // shared bytes for a chunk of scores
constexpr int kMaxSmem = 227 * 1024;

// How a row of Dh elements is spread over a warp: kVecs 8-element vectors,
// kLanes lanes a row (a power of two), kVpl vectors a lane at most.
template <int DH>
struct Geo {
  static constexpr int kVecs = DH / 8;
  static constexpr int kLanes = kVecs >= 16 ? 16 : kVecs;
  static constexpr int kVpl = (kVecs + kLanes - 1) / kLanes;
  static constexpr int kRowsWarp = 32 / kLanes;
  static constexpr int kRows = kWarps * kRowsWarp;   // row groups a block
  static_assert(DH % 8 == 0 && (kLanes & (kLanes - 1)) == 0 && 32 % kLanes == 0,
                "no row layout for this head size");
};

struct Args {
  const __nv_bfloat16* q;           // [B, 1, H, Dh]: element strides below
  long long q_sb, q_sh;
  const char* k;                    // [B, Smax, KVH, lanes]: byte strides
  const char* v;
  long long k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  const __nv_bfloat16* ks;          // [B, Smax, KVH, 1] or nullptr
  const __nv_bfloat16* vs;
  long long ks_sb, ks_ss, ks_sh, vs_sb, vs_ss, vs_sh;
  const int* length;                // [B]
  const int* kv_bits;               // [B] tier codes (mixed arena) or nullptr
  __nv_bfloat16* out;               // [B, 1, H, Dh], contiguous
  int B, KVH, g, smax;
  int mode;                         // 16, 8 or 4 (ignored with kv_bits)
  int modes_mask;                   // mixed: codes served but the last (16: 1, 8: 2, 4: 4)
  int last_mode;                    // mixed: the last code served
  int chunk;                        // positions of scores held in shared memory
  float scale;                      // f32(1 / sqrt(Dh))
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float bf16_bits(uint32_t w, int hi) {
  return __uint_as_float(hi ? (w & 0xffff0000u) : (w << 16));
}

// One 8-element vector of a row: 16 bytes of bf16, 8 of int8 codes or 4
// of int4 nibbles, in the low words of a uint4.
__device__ __forceinline__ uint4 load_vec(const char* row, int vec, int mode) {
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (mode == 16) {
    r = __ldg(reinterpret_cast<const uint4*>(row + vec * 16));
  } else if (mode == 8) {
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(row + vec * 8));
    r.x = w.x;
    r.y = w.y;
  } else {
    r.x = __ldg(reinterpret_cast<const unsigned int*>(row + vec * 4));
  }
  return r;
}

// A lane's vectors of one row (zero where the row is not read) and the
// row's scale.
template <int DH>
__device__ __forceinline__ void load_row(uint4 (&raw)[Geo<DH>::kVpl], float& sc,
                                         const char* rows, long long ss,
                                         const __nv_bfloat16* scales, long long sss,
                                         int t, bool valid, int mode, int li) {
  using Gm = Geo<DH>;
#pragma unroll
  for (int i = 0; i < Gm::kVpl; ++i) raw[i] = make_uint4(0u, 0u, 0u, 0u);
  sc = 0.0f;
  if (!valid) return;
  const char* row = rows + static_cast<long long>(t) * ss;
#pragma unroll
  for (int i = 0; i < Gm::kVpl; ++i) {
    const int vec = li + i * Gm::kLanes;
    if (vec < Gm::kVecs) raw[i] = load_vec(row, vec, mode);
  }
  if (mode != 16) sc = __bfloat162float(scales[static_cast<long long>(t) * sss]);
}

// A vector's 8 values in f32: bf16 bits, or bf16(code * scale).
__device__ __forceinline__ void widen(const uint4& r, float sc, int mode, float (&x)[8]) {
  if (mode == 16) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = bf16_bits(w[e >> 1], e & 1);
  } else if (mode == 8) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const uint32_t w = e < 4 ? r.x : r.y;
      const int c = static_cast<int8_t>((w >> (8 * (e & 3))) & 0xffu);
      x[e] = round_bf16(__fmul_rn(static_cast<float>(c), sc));
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const uint32_t byte = (r.x >> (8 * (e >> 1))) & 0xffu;
      const int nib = static_cast<int>((e & 1) ? (byte >> 4) : (byte & 0xfu));
      x[e] = round_bf16(__fmul_rn(static_cast<float>((nib ^ 8) - 8), sc));
    }
  }
}

// Everything a block knows about its (slot, KV head, head group).
struct Block {
  const char* k;                    // the slot's head's rows (position 0)
  const char* v;
  const __nv_bfloat16* ks;
  const __nv_bfloat16* vs;
  long long k_ss, v_ss, ks_ss, vs_ss;
  int n;                            // positions visited: len, or Smax if empty
  bool empty;
  int mode, ng, li, rg;
};

// Scores of positions [c0, c1) for heads j < ng into buf[j * chunk + t - c0],
// and the running maxima: position t on thread (t - c0) mod kThreads, its
// dot product over Dh in order, one f32 fma a term (no shuffle: a lane
// reads its own row, kBatch vectors in flight, q broadcast from shared
// memory).
template <int DH, int G>
__device__ __forceinline__ void chunk_scores(const Block& bk, const float* q_s, float* buf,
                                             int chunk, int c0, int c1, float scale,
                                             float (&mx)[G]) {
  constexpr int kVecs = DH / 8;
  if (bk.empty) {
    for (int t = c0 + static_cast<int>(threadIdx.x); t < c1; t += kThreads)
#pragma unroll
      for (int j = 0; j < G; ++j)
        if (j < bk.ng) buf[j * chunk + t - c0] = kNeg;
#pragma unroll
    for (int j = 0; j < G; ++j) mx[j] = kNeg;
    return;
  }
  for (int t = c0 + static_cast<int>(threadIdx.x); t < c1; t += kThreads) {
    const char* row = bk.k + static_cast<long long>(t) * bk.k_ss;
    const float sc =
        bk.mode != 16 ? __bfloat162float(bk.ks[static_cast<long long>(t) * bk.ks_ss]) : 0.0f;
    float p[G];
#pragma unroll
    for (int j = 0; j < G; ++j) p[j] = 0.0f;
#pragma unroll
    for (int v0 = 0; v0 < kVecs; v0 += kBatch) {
      uint4 raw[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
        if (v0 + i < kVecs) raw[i] = load_vec(row, v0 + i, bk.mode);
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (v0 + i >= kVecs) continue;
        float x[8];
        widen(raw[i], sc, bk.mode, x);
#pragma unroll
        for (int j = 0; j < G; ++j) {
          if (j >= bk.ng) continue;                // the same in the whole block
          const float* qv = q_s + j * DH + (v0 + i) * 8;
          const float4 a = *reinterpret_cast<const float4*>(qv);
          const float4 c = *reinterpret_cast<const float4*>(qv + 4);
          p[j] = __fmaf_rn(a.x, x[0], p[j]);
          p[j] = __fmaf_rn(a.y, x[1], p[j]);
          p[j] = __fmaf_rn(a.z, x[2], p[j]);
          p[j] = __fmaf_rn(a.w, x[3], p[j]);
          p[j] = __fmaf_rn(c.x, x[4], p[j]);
          p[j] = __fmaf_rn(c.y, x[5], p[j]);
          p[j] = __fmaf_rn(c.z, x[6], p[j]);
          p[j] = __fmaf_rn(c.w, x[7], p[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (j >= bk.ng) continue;
      const float s = __fmul_rn(p[j], scale);
      mx[j] = fmaxf(mx[j], s);
      buf[j * chunk + t - c0] = s;
    }
  }
}

// Block-wide max (exact in any order) or sum (a fixed order: a shuffle
// tree, then the warps in turn) of each head's per-thread value; the
// result in dst[j] for every thread to read.
template <int G, bool kSum>
__device__ __forceinline__ void block_reduce(float (&x)[G], float* red, float* dst) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < G; ++j) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float y = __shfl_xor_sync(0xffffffffu, x[j], o);
      x[j] = kSum ? __fadd_rn(x[j], y) : fmaxf(x[j], y);
    }
    if (lane == 0) red[warp * G + j] = x[j];
  }
  __syncthreads();
  if (threadIdx.x < G) {
    float r = red[threadIdx.x];
    for (int w = 1; w < kWarps; ++w)
      r = kSum ? __fadd_rn(r, red[w * G + threadIdx.x]) : fmaxf(r, red[w * G + threadIdx.x]);
    dst[threadIdx.x] = r;
  }
  __syncthreads();
}

template <int DH, int G>
__global__ void __launch_bounds__(kThreads, G * Geo<DH>::kVpl <= 4 ? 2 : 1)
decode_attention_kernel(Args a) {
  using Gm = Geo<DH>;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // [G][DH]
  float* red = q_s + G * DH;                      // [kWarps][G]
  float* stat = red + kWarps * G;                 // m [G], l [G]
  float* buf = stat + 2 * G;                      // scores / p, then partials

  const int kvh = blockIdx.x, b = blockIdx.y, j0 = blockIdx.z * G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = a.KVH * a.g;
  const int len = a.length[b];
  Block bk;
  bk.empty = len <= 0;
  bk.n = bk.empty ? a.smax : min(len, a.smax);
  bk.mode = a.mode;
  if (a.kv_bits != nullptr) {
    const int c = a.kv_bits[b];
    const bool served = (c == 16 && (a.modes_mask & 1)) || (c == 8 && (a.modes_mask & 2)) ||
                        (c == 4 && (a.modes_mask & 4));
    bk.mode = served ? c : a.last_mode;
  }
  bk.ng = min(G, a.g - j0);
  bk.li = lane % Gm::kLanes;
  bk.rg = warp * Gm::kRowsWarp + lane / Gm::kLanes;
  bk.k = a.k + b * a.k_sb + kvh * a.k_sh;
  bk.v = a.v + b * a.v_sb + kvh * a.v_sh;
  bk.ks = a.ks != nullptr ? a.ks + b * a.ks_sb + kvh * a.ks_sh : nullptr;
  bk.vs = a.vs != nullptr ? a.vs + b * a.vs_sb + kvh * a.vs_sh : nullptr;
  bk.k_ss = a.k_ss;
  bk.v_ss = a.v_ss;
  bk.ks_ss = a.ks_ss;
  bk.vs_ss = a.vs_ss;

  const int head0 = kvh * a.g + j0;
  for (int i = tid; i < G * DH; i += kThreads) {
    const int j = i / DH, d = i - j * DH;
    q_s[i] = j < bk.ng ? __bfloat162float(a.q[b * a.q_sb + (head0 + j) * a.q_sh + d]) : 0.0f;
  }
  __syncthreads();

  const int chunk = a.chunk;
  const int nchunks = (bk.n + chunk - 1) / chunk;

  // Pass 1: scores and their maxima.  A masked position's NEG enters the
  // maximum as in the plain version.
  float mx[G];
#pragma unroll
  for (int j = 0; j < G; ++j) mx[j] = bk.n < a.smax ? kNeg : -INFINITY;
  for (int c = 0; c < nchunks; ++c) {
    const int c0 = c * chunk;
    chunk_scores<DH, G>(bk, q_s, buf, chunk, c0, min(bk.n, c0 + chunk), a.scale, mx);
  }
  block_reduce<G, false>(mx, red, stat);
  float m[G];
#pragma unroll
  for (int j = 0; j < G; ++j) m[j] = stat[j];

  // l = sum_t expf(s - m): position t on thread t mod kThreads, in order.
  float l[G];
#pragma unroll
  for (int j = 0; j < G; ++j) l[j] = 0.0f;
  for (int c = 0; c < nchunks; ++c) {
    const int c0 = c * chunk, c1 = min(bk.n, c0 + chunk);
    if (nchunks > 1) {
      __syncthreads();
      chunk_scores<DH, G>(bk, q_s, buf, chunk, c0, c1, a.scale, mx);
      __syncthreads();
    }
    for (int t = c0 + tid; t < c1; t += kThreads)
#pragma unroll
      for (int j = 0; j < G; ++j)
        if (j < bk.ng) l[j] = __fadd_rn(l[j], expf(__fsub_rn(buf[j * chunk + t - c0], m[j])));
  }
  block_reduce<G, true>(l, red, stat + G);
#pragma unroll
  for (int j = 0; j < G; ++j) l[j] = stat[G + j];

  // Pass 2: p = bf16(expf(s - m) / l) in place, then PV: position t on row
  // group t mod kRows, in order.
  float acc[G][Gm::kVpl][8];
#pragma unroll
  for (int j = 0; j < G; ++j)
#pragma unroll
    for (int i = 0; i < Gm::kVpl; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[j][i][e] = 0.0f;
  for (int c = 0; c < nchunks; ++c) {
    const int c0 = c * chunk, c1 = min(bk.n, c0 + chunk);
    if (nchunks > 1) {
      __syncthreads();
      chunk_scores<DH, G>(bk, q_s, buf, chunk, c0, c1, a.scale, mx);
    }
    __syncthreads();
    for (int t = c0 + tid; t < c1; t += kThreads)
#pragma unroll
      for (int j = 0; j < G; ++j)
        if (j < bk.ng) {
          float* s = buf + j * chunk + t - c0;
          *s = round_bf16(__fdiv_rn(expf(__fsub_rn(*s, m[j])), l[j]));
        }
    __syncthreads();
    for (int base = c0; base < c1; base += Gm::kRows * kUnroll) {
      uint4 raw[kUnroll][Gm::kVpl];
      float sc[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = base + u * Gm::kRows + bk.rg;
        load_row<DH>(raw[u], sc[u], bk.v, bk.v_ss, bk.vs, bk.vs_ss, t, t < c1, bk.mode, bk.li);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = base + u * Gm::kRows + bk.rg;
        if (t >= c1) continue;
        float x[Gm::kVpl][8];
#pragma unroll
        for (int i = 0; i < Gm::kVpl; ++i) widen(raw[u][i], sc[u], bk.mode, x[i]);
#pragma unroll
        for (int j = 0; j < G; ++j) {
          if (j >= bk.ng) continue;
          const float p = buf[j * chunk + t - c0];
#pragma unroll
          for (int i = 0; i < Gm::kVpl; ++i)
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[j][i][e] = __fmaf_rn(p, x[i][e], acc[j][i][e]);
        }
      }
    }
  }

  // The row groups of a warp (a shuffle tree), then the warps in turn.
#pragma unroll
  for (int j = 0; j < G; ++j)
#pragma unroll
    for (int i = 0; i < Gm::kVpl; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e)
#pragma unroll
        for (int o = Gm::kLanes; o < 32; o <<= 1)
          acc[j][i][e] = __fadd_rn(acc[j][i][e], __shfl_xor_sync(0xffffffffu, acc[j][i][e], o));
  __syncthreads();                               // buf's p are read
  float* part = buf;                              // [kWarps][G][DH]
  if (lane < Gm::kLanes) {
#pragma unroll
    for (int j = 0; j < G; ++j)
#pragma unroll
      for (int i = 0; i < Gm::kVpl; ++i) {
        const int vec = lane + i * Gm::kLanes;
        if (vec < Gm::kVecs)
#pragma unroll
          for (int e = 0; e < 8; ++e) part[(warp * G + j) * DH + vec * 8 + e] = acc[j][i][e];
      }
  }
  __syncthreads();
  for (int i = tid; i < bk.ng * DH; i += kThreads) {
    const int j = i / DH, d = i - j * DH;
    float r = part[j * DH + d];
    for (int w = 1; w < kWarps; ++w) r = __fadd_rn(r, part[(w * G + j) * DH + d]);
    a.out[(static_cast<long long>(b) * H + head0 + j) * DH + d] = __float2bfloat16_rn(r);
  }
}

template <int DH, int G>
int launch_g(Args a, cudaStream_t st) {
  const int fixed = G * DH + kWarps * G + 2 * G;  // floats before buf
  int cap = (kScoreBudget / 4 - fixed) / G / kThreads * kThreads;
  if (cap < kThreads) cap = kThreads;
  const int want = (a.smax + kThreads - 1) / kThreads * kThreads;
  a.chunk = want < cap ? want : cap;
  const int buf = G * a.chunk > kWarps * G * DH ? G * a.chunk : kWarps * G * DH;
  const int smem = (fixed + buf) * 4;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = decode_attention_kernel<DH, G>;
  static unsigned opted_in = 0;   // devices (bit per ordinal) allowed kMaxSmem
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 32 || !(opted_in & (1u << dev))) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 32) opted_in |= 1u << dev;
  }
  const dim3 grid(a.KVH, a.B, (a.g + G - 1) / G);
  kernel<<<grid, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Query heads a block serves: 4 (qwen3-8b, granite, pixtral, stablelm,
// and every g below) or 8 (llama4's 5, grok's 6, jamba's 8); g > 8 takes
// groups of 8, each group its own blocks.
template <int DH>
int launch_dh(const Args& a, cudaStream_t st) {
  if (a.g <= 4) return launch_g<DH, 4>(a, st);
  return launch_g<DH, 8>(a, st);
}

}  // namespace

// Strides: q and the scales in elements, K and V in bytes.  mode 16 / 8 / 4
// for a homogeneous arena; with kv_bits, modes_mask and last_mode say which
// codes the mixed arena serves.  k_scale / v_scale may be null for bf16.
extern "C" int decode_attention(const void* q, const void* k, const void* v, const void* k_scale,
                                const void* v_scale, const void* length, const void* kv_bits,
                                void* out, int B, int KVH, int g, int dh, int smax, int mode,
                                int modes_mask, int last_mode, int q_sb, int q_sh, int k_sb,
                                int k_ss, int k_sh, int v_sb, int v_ss, int v_sh, int ks_sb,
                                int ks_ss, int ks_sh, int vs_sb, int vs_ss, int vs_sh,
                                void* stream) {
  Args a{static_cast<const __nv_bfloat16*>(q), q_sb, q_sh,
         static_cast<const char*>(k), static_cast<const char*>(v),
         k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
         static_cast<const __nv_bfloat16*>(k_scale), static_cast<const __nv_bfloat16*>(v_scale),
         ks_sb, ks_ss, ks_sh, vs_sb, vs_ss, vs_sh,
         static_cast<const int*>(length), static_cast<const int*>(kv_bits),
         static_cast<__nv_bfloat16*>(out), B, KVH, g, smax, mode, modes_mask, last_mode, 0,
         static_cast<float>(1.0 / std::sqrt(static_cast<double>(dh)))};
  if (B <= 0 || KVH <= 0 || g <= 0 || smax <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: return launch_dh<16>(a, st);
    case 64: return launch_dh<64>(a, st);
    case 128: return launch_dh<128>(a, st);
    case 160: return launch_dh<160>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
