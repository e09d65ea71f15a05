// Tensor-core building blocks of encoder_attention.cu (and, through
// attention_bwd.cuh, encoder_attention_bwd.cu): warp-level
// `mma.sync.m16n8k16` bf16 products with f32 accumulators, in the register
// layout of FlashAttention-2.
//
// Tiling: a block of 4 warps owns 64 query rows of one (batch, head), 16
// rows per warp.  The warp keeps its Q rows in registers as A fragments for
// the whole key walk.  Key tiles of 64 rows of K (and V) are staged in
// shared memory with 16-byte loads, padded by 8 bf16 per row so that the
// fragment reads below hit 32 distinct banks.  S = Q K^T for a tile is 8
// n-tiles of 8 keys; its accumulator layout is exactly the A-fragment
// layout of P for P V, so P never leaves registers.  V's B fragments come
// from `ldmatrix.trans`.
//
// Fragment layout of m16n8k16 (lane = 4 * g + t):
//   A (16 x 16, row major): reg0 = (row g,   cols 2t, 2t+1)
//                           reg1 = (row g+8, cols 2t, 2t+1)
//                           reg2 = (row g,   cols 2t+8, 2t+9)
//                           reg3 = (row g+8, cols 2t+8, 2t+9)
//   B (16 x 8, "col"):      reg0 = (k 2t, 2t+1; n g), reg1 = (k 2t+8, 2t+9; n g)
//   C (16 x 8, f32):        c0, c1 = (row g, cols 2t, 2t+1); c2, c3 = row g+8
// The lower-indexed element of a pair sits in the low 16 bits.
//
// Layout of the tensors: q, k, v and o are [B, S, H, D] (the paddle layout
// the public functions take), contiguous, bf16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace mma_attention {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;   // query rows per block
constexpr int kBK = 64;            // keys per staged tile
constexpr int kPad = 8;            // bf16 of padding per shared row
constexpr float kNegInf = -1e30f;  // finite, as the reference's NEG_INF

struct Problem {
  const __nv_bfloat16* q;  // [B, Sq, H, D]
  const __nv_bfloat16* k;  // [B, Sk, H, D]
  const __nv_bfloat16* v;
  __nv_bfloat16* o;        // [B, Sq, H, D]
  int B, H, Sq, Sk;
  float scale;
  int causal;              // bottom-right: query i sees keys <= i + Sk - Sq
  const int* seed;         // encoder dropout: int32 [2] seed pair, or null (no dropout)
  uint32_t thresh;         // keep iff the element's Philox word < thresh
  float inv_keep;          // 1 / (1 - rate)
};

template <int D>
struct Tile {
  __nv_bfloat16 k[kBK][D + kPad];
  __nv_bfloat16 v[kBK][D + kPad];
};

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                                  uint32_t& r3, const void* smem) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(a));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The warp's 16 query rows from `row0` as A fragments over D; rows past Sq
// are zeros.
template <int D>
__device__ __forceinline__ void load_q(uint32_t (&qa)[D / 16][4], const Problem& p, int b,
                                       int h, int row0, int g, int t) {
  const int r0 = row0 + g, r1 = row0 + g + 8;
  const uint32_t* q0 = r0 < p.Sq ? reinterpret_cast<const uint32_t*>(
                                       p.q + ((size_t)(b * p.Sq + r0) * p.H + h) * D)
                                 : nullptr;
  const uint32_t* q1 = r1 < p.Sq ? reinterpret_cast<const uint32_t*>(
                                       p.q + ((size_t)(b * p.Sq + r1) * p.H + h) * D)
                                 : nullptr;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qa[kk][0] = q0 ? q0[8 * kk + t] : 0u;
    qa[kk][1] = q1 ? q1[8 * kk + t] : 0u;
    qa[kk][2] = q0 ? q0[8 * kk + 4 + t] : 0u;
    qa[kk][3] = q1 ? q1[8 * kk + 4 + t] : 0u;
  }
}

// Stage keys [kb, kb + kBK) of (b, h) into shared memory (V too when
// WITH_V); keys past Sk are zeros, so that masked probabilities (exactly 0)
// never meet garbage.
template <int D, bool WITH_V>
__device__ __forceinline__ void stage(Tile<D>& sm, const Problem& p, int b, int h, int kb,
                                      int tid) {
  constexpr int kSegs = D / 8;  // 16-byte segments per row
  for (int i = tid; i < kBK * kSegs; i += kThreads) {
    const int j = i / kSegs, seg = i % kSegs, key = kb + j;
    uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
    if (key < p.Sk) {
      const size_t base = ((size_t)(b * p.Sk + key) * p.H + h) * D + seg * 8;
      kv = *reinterpret_cast<const uint4*>(p.k + base);
      if (WITH_V) vv = *reinterpret_cast<const uint4*>(p.v + base);
    }
    *reinterpret_cast<uint4*>(&sm.k[j][seg * 8]) = kv;
    if (WITH_V) *reinterpret_cast<uint4*>(&sm.v[j][seg * 8]) = vv;
  }
}

// s = scale * Q K^T for the staged tile, masked to kNegInf past Sk and, if
// causal, past each row's diagonal.  `row` is the query row of c0/c1 (g);
// c2/c3 belong to row + 8.
template <int D>
__device__ __forceinline__ void scores(float (&s)[kBK / 8][4], const uint32_t (&qa)[D / 16][4],
                                       const Tile<D>& sm, const Problem& p, int kb, int row,
                                       int g, int t) {
  const int off = p.Sk - p.Sq;
#pragma unroll
  for (int n = 0; n < kBK / 8; ++n) {
    s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    const __nv_bfloat16* kr = &sm.k[8 * n + g][0];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + 16 * kk + 2 * t);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + 16 * kk + 8 + 2 * t);
      mma_16816(s[n], qa[kk], b0, b1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = kb + 8 * n + 2 * t + (e & 1);
      const int qrow = row + 8 * (e >> 1);
      const bool ok = key < p.Sk && (!p.causal || key <= qrow + off);
      s[n][e] = ok ? s[n][e] * p.scale : kNegInf;
    }
  }
}

// The largest score of the thread's half-row hr (0: row g, 1: row g + 8),
// reduced over the 4 lanes that share the row.
__device__ __forceinline__ float row_max(const float (&s)[kBK / 8][4], int hr) {
  float mx = kNegInf;
#pragma unroll
  for (int n = 0; n < kBK / 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * hr], s[n][2 * hr + 1]));
  return quad_max(mx);
}

// o += P V for the staged tile; P (the tile's probabilities, in the S
// accumulator layout) is rounded to bf16 here, as the reference rounds p
// to v's dtype before its P.V product.
template <int D>
__device__ __forceinline__ void pv(float (&o)[D / 8][4], const float (&pr)[kBK / 8][4],
                                   const Tile<D>& sm, int lane) {
  const int mi = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint32_t pa[4] = {pack_bf16x2(pr[2 * kk][0], pr[2 * kk][1]),
                            pack_bf16x2(pr[2 * kk][2], pr[2 * kk][3]),
                            pack_bf16x2(pr[2 * kk + 1][0], pr[2 * kk + 1][1]),
                            pack_bf16x2(pr[2 * kk + 1][2], pr[2 * kk + 1][3])};
    // matrices: 0 = keys 16kk+0..7 x dims 8dn.., 1 = keys +8..15 x 8dn..,
    // 2 and 3 the same keys x dims 8(dn+1)..; lane gives one row address
    const __nv_bfloat16* vrow = &sm.v[16 * kk + (mi & 1) * 8 + r][(mi >> 1) * 8];
#pragma unroll
    for (int dn = 0; dn < D / 8; dn += 2) {
      uint32_t b0, b1, b2, b3;
      ldmatrix_x4_trans(b0, b1, b2, b3, vrow + 8 * dn);
      mma_16816(o[dn], pa, b0, b1);
      mma_16816(o[dn + 1], pa, b2, b3);
    }
  }
}

// Dropout keep bits of 16 x 16 tiles of the [B * H, S, S] probabilities
// (philox.cuh: element (bh, i, j) reads counter (oct(i), oct(j), bh, 0),
// word 2 * ((i >> 3) & 1) + ((j >> 3) & 1)).  A pair of accumulators a, b
// holds this thread's 8 elements of a tile; bit 4 * (0 for a, 1 for b) + e
// is element e's.
//
// keep_pair: rows i0 .. i0 + 15 (queries), columns j0 .. j0 + 15 (keys), a
// the columns j0 .. j0 + 7; element e at row i0 + g + 8 (e >> 1), column
// + 2t + (e & 1): the S and dP tiles of the forward and the dQ kernel.
__device__ __forceinline__ uint32_t keep_pair(uint2 key, int bh, int i0, int j0, int g, int t,
                                              uint32_t thresh) {
  uint32_t bits = 0;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const uint4 w = philox::encoder_words(key, bh, i0 + g, j0 + 2 * t + c);
    bits |= (w.x < thresh) << c | (w.z < thresh) << (2 + c) | (w.y < thresh) << (4 + c) |
            (w.w < thresh) << (6 + c);
  }
  return bits;
}

// keep_pair_t: the transposed tile of the dK/dV kernel, rows k0 .. k0 + 15
// (keys), columns q0 .. q0 + 15 (queries), a the queries q0 .. q0 + 7;
// element e at key k0 + g + 8 (e >> 1), query + 2t + (e & 1).
__device__ __forceinline__ uint32_t keep_pair_t(uint2 key, int bh, int q0, int k0, int g, int t,
                                                uint32_t thresh) {
  uint32_t bits = 0;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const uint4 w = philox::encoder_words(key, bh, q0 + 2 * t + c, k0 + g);
    bits |= (w.x < thresh) << c | (w.y < thresh) << (2 + c) | (w.z < thresh) << (4 + c) |
            (w.w < thresh) << (6 + c);
  }
  return bits;
}

// x = where(keep, x * mul, 0) over a pair's 8 elements.
__device__ __forceinline__ void apply_keep(float (&a)[4], float (&b)[4], uint32_t bits,
                                           float mul) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    a[e] = (bits >> e) & 1 ? a[e] * mul : 0.f;
    b[e] = (bits >> (4 + e)) & 1 ? b[e] * mul : 0.f;
  }
}

// Write the warp's output rows: o * inv[hr] as bf16 at row0 + g (+ 8).
template <int D>
__device__ __forceinline__ void store_o(const float (&o)[D / 8][4], const float (&inv)[2],
                                        const Problem& p, int b, int h, int row0, int g,
                                        int t) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row0 + g + 8 * hr;
    if (row >= p.Sq) continue;
    uint32_t* dst = reinterpret_cast<uint32_t*>(p.o + ((size_t)(b * p.Sq + row) * p.H + h) * D);
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      dst[4 * dn + t] = pack_bf16x2(o[dn][2 * hr] * inv[hr], o[dn][2 * hr + 1] * inv[hr]);
  }
}

}  // namespace mma_attention
