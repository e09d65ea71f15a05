// Device code the encoder-attention kernels share (encoder_attention.cu,
// encoder_attention_bwd.cu), on the Hopper building blocks of
// wgmma_attention.cuh: the dropout mask in the `wgmma` accumulator layout,
// the mask's bit buffer, stores of 2-byte pairs (bf16 or float16) into a
// 128-byte swizzled shared tile, and the row statistics of a whole row held
// in one 128-key tile.
//
// The accumulator of m64nNk16 holds, in warp w of the warpgroup and lane
// 4 g + t, d[4 j + e] = row 16 w + g + 8 (e >> 1), column 8 j + 2 t + (e & 1).
// So the 8 elements d[8 kk .. 8 kk + 7] of a thread sit at rows {r, r + 8}
// (r = 16 w + g, bit 3 clear) and columns {c, c + 1, c + 8, c + 9} of the
// 16-column chunk kk (c = 16 kk + 2 t): exactly the elements of two Philox
// calls of the encoder mapping (philox.cuh: element (bh, i, j) reads counter
// (oct(i), oct(j), bh, 0), word 2 ((i >> 3) & 1) + ((j >> 3) & 1)), so every
// call is a whole one and no bit is drawn twice.
#pragma once

#include "philox.cuh"
#include "wgmma_attention.cuh"

namespace encoder_wgmma {

using namespace wgmma_attention;

constexpr int kT = 128;  // rows of a query or key tile

// Dropout of a call: null seed means rate 0 (no mask is drawn).
struct Drop {
  const int* seed;  // int32 [2] seed pair on the device, or null
  uint32_t thresh;  // keep iff the element's Philox word < thresh
  float inv_keep;   // 1 / (1 - rate)
};

// The two calls of chunk kk for thread rows (row, row + 8) and chunk
// columns from col0 = kb + 16 kk, as one byte: nibble c (c = 0, 1) for the
// call at column j = col0 + 2 t + c, its bit w the keep of the call's word
// w, which philox.cuh orders 0 (row, j), 1 (row, j + 8), 2 (row + 8, j),
// 3 (row + 8, j + 8).
__device__ __forceinline__ uint32_t keep_byte(uint2 key, int bh, int row, int col0, int t,
                                              uint32_t thresh) {
  uint32_t byte = 0;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const uint4 w = philox::encoder_words(key, bh, row, col0 + 2 * t + c);
    byte |= ((w.x < thresh) | (w.y < thresh) << 1 | (w.z < thresh) << 2 | (w.w < thresh) << 3)
            << (4 * c);
  }
  return byte;
}

// Whether accumulator element 8 kk + e of a thread is kept, from its chunk's
// byte (keep_byte): column c = e & 1, word 2 * row half + column half.
__device__ __forceinline__ bool kept(uint32_t byte, int e) {
  const int c = e & 1, w = 2 * ((e >> 1) & 1) + (e >> 2);
  return (byte >> (4 * c + w)) & 1u;
}

// The bit buffer of a call's mask, [B * H][S / 16][S / 16] tiles of 16
// queries x 16 keys, 8 words a tile: word g' holds the 8 nibbles of the
// calls (i0 + g', j0 + c') for c' = 0..7, nibble c' at bit 4 c', its bits
// the 4 words of the call as in keep_byte.  The thread (g, t) that draws
// chunk kk of query rows i0 + g (+ 8) writes byte t of word g: the 2 calls
// of columns j0 + 2 t + c.
__device__ __forceinline__ uint8_t* bits_byte(uint8_t* bits, int bh, int S, int i0, int j0, int g,
                                              int t) {
  const int n = S / 16;
  return bits + ((((size_t)bh * n + i0 / 16) * n + j0 / 16) * 8 + g) * 4 + t;
}

// The transposed reader: rows are keys (key0 + g, + 8; key0 a multiple of
// 16) and columns queries (q0 + 2 t + c, + 8): the calls (q0 + 2 t + c,
// key0 + g) sit in words 2 t + c of the tile (q0, key0), nibble g.  Returns
// those two nibbles as one byte, nibble c for query column q0 + 2 t + c.
__device__ __forceinline__ uint32_t keep_byte_t(const uint8_t* bits, int bh, int S, int q0, int key0,
                                                int g, int t) {
  const int n = S / 16;
  const uint2 w = *reinterpret_cast<const uint2*>(
      bits + ((((size_t)bh * n + q0 / 16) * n + key0 / 16) * 8 + 2 * t) * 4);
  return ((w.x >> (4 * g)) & 0xFu) | ((w.y >> (4 * g)) & 0xFu) << 4;
}

// Whether element 8 kk + e of a transposed (key-row) accumulator is kept,
// from keep_byte_t's byte: query column c = e & 1, key half (e >> 1) & 1,
// query half e >> 2; the call's word is 2 * query half + key half.
__device__ __forceinline__ bool kept_t(uint32_t byte, int e) {
  const int c = e & 1, w = 2 * (e >> 2) + ((e >> 1) & 1);
  return (byte >> (4 * c + w)) & 1u;
}

// Element (row, col) of a tile of ROWS rows stored as 64-column panels of
// ROWS x 64 elements of T (2 bytes) with the 128-byte swizzle (as TMA
// writes them): a pair of T at an even column, one 32-bit store.
template <int ROWS, typename T>
__device__ __forceinline__ void st_pair(T* tile, int row, int col, uint32_t v) {
  const int c = col & 63, ch = (c >> 3) ^ (row & 7);
  *reinterpret_cast<uint32_t*>(tile + (col >> 6) * ROWS * kPanel + row * kPanel + ch * 8 + (c & 7)) = v;
}

// Scores of a warpgroup's 64 rows against one key tile (128 keys, or the
// float32 forward's 64: R = keys / 2 values a thread), in place: s *
// scale * log2(e), and kNegInf past each row's last visible key when
// causal (`row`: the thread's first row; the second is row + 8).
template <int R>
__device__ __forceinline__ void scale_mask(float (&s)[R], float scale_log2, bool edge, int kb,
                                           int row, int t) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    s[i] *= scale_log2;
    if (edge && kb + acc_col(i, t) > row + 8 * acc_half(i)) s[i] = kNegInf;
  }
}

// Whole-row statistics of a tile that holds the entire row: m the row's
// max, and s becomes exp2(s - m); returns through l the row's sum (all four
// lanes of the row agree).
template <int R>
__device__ __forceinline__ void row_softmax(float (&s)[R], float (&m)[2], float (&l)[2]) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float mx = kNegInf;
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (acc_half(i) == hr) mx = fmaxf(mx, s[i]);
    m[hr] = quad_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (acc_half(i) == hr) {
        s[i] = exp2f(s[i] - m[hr]);
        sum += s[i];
      }
    l[hr] = quad_sum(sum);
  }
}

// x = where(keep, x * inv_keep, 0) over the thread's elements of a key
// tile (R = keys / 2 values a thread) of query rows (row, row + 8) from key
// kb, drawing each call once.
template <int R>
__device__ __forceinline__ void drop_tile(float (&x)[R], const Drop& dr, uint2 key, int bh,
                                          int row, int kb, int t) {
#pragma unroll
  for (int kk = 0; kk < R / 8; ++kk) {
    const uint32_t byte = keep_byte(key, bh, row, kb + 16 * kk, t, dr.thresh);
#pragma unroll
    for (int e = 0; e < 8; ++e) x[8 * kk + e] = kept(byte, e) ? x[8 * kk + e] * dr.inv_keep : 0.f;
  }
}

__device__ __forceinline__ uint2 philox_key(const Drop& dr) {
  return dr.seed ? philox::key(dr.seed) : make_uint2(0u, 0u);
}

}  // namespace encoder_wgmma
