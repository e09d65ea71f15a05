// Philox4x32-10, the counter-based generator every dropout kernel of the
// port draws its mask from (fused_ln.cu, encoder_attention.cu,
// encoder_attention_bwd.cu).
//
// Replaces: paddle_tpu/ops/_prng.py `block_bits` and `keep_mask`, the device
// functions the reference's dropout kernels share.  The reference seeds the
// TPU's hardware generator per grid block; its bits are the TPU's own and
// the port does not try to match them (_prng.py:38-41).  What the port keeps
// is the contract: forward and backward, and kernel and plain version
// (paddle_tpu_torch/ops/_prng.py, the torch twin of this file), draw the same
// bits, because every element's bits are a function of the seed pair and
// the element's coordinates alone, never of a thread's layout.
//
// The generator: Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3" (SC 2011), 10 rounds, the Random123 constants.  Known answers (key,
// counter -> words), checked on the card by chip_smoke.py through
// `philox_launch` in fused_ln.cu and on the CPU against the torch twin:
//   key (0, 0), counter 0          -> 6627e8d5 e169c58d bc57ac4c 9b00dbd8
//   key all ones, counter all ones -> 408f276d 41c83b0e a20bc7c6 6d5451fd
//   key (a4093822, 299f31d0), counter (243f6a88, 85a308d3, 13198a2e,
//   03707344)                      -> d16cfe09 94fdcceb 5001e420 24126ea1
//
// The key is the call's seed pair, an int32 [2] tensor on the device
// (ops/_prng.py draw_seed), read through a pointer.  Keep iff the element's
// word < thresh, thresh = min(round((1 - rate) 2^32), 2^32 - 1), the
// reference's `thresh_u32`.
//
// Which (counter, word) each element reads:
//  * fused LN, element (row, col) of the [n, h] matrix: counter (col >> 2,
//    row, 0, 0), word col & 3.  One call serves 4 adjacent columns.
//  * encoder attention, element (bh, i, j) of the [B * H, S, S]
//    probabilities (query i, key j, bh = b * H + h): counter
//    (oct(i), oct(j), bh, 0) with oct(x) = (x >> 4) * 8 + (x & 7), word
//    2 * ((i >> 3) & 1) + ((j >> 3) & 1).  One call serves rows {i, i + 8}
//    times columns {j, j + 8} of a 16 x 16 tile.  A `wgmma` accumulator
//    thread holds exactly such a set in each 16-column chunk (rows g and
//    g + 8, columns 2t + c and 8 + 2t + c; encoder_wgmma.cuh), so every
//    kernel draws whole calls, each once; the streamed encoder backward
//    keeps the drawn bits for its transposed dK/dV tiles.
#pragma once

#include <stdint.h>

namespace philox {

constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = kM0 * c.x, hi0 = __umulhi(kM0, c.x);
    const uint32_t lo1 = kM1 * c.z, hi1 = __umulhi(kM1, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += kW0;
    k.y += kW1;
  }
  return c;
}

// The key from the seed pair (int32 [2] on the device).
__device__ __forceinline__ uint2 key(const int* seed) {
  return make_uint2(static_cast<uint32_t>(__ldg(seed)), static_cast<uint32_t>(__ldg(seed + 1)));
}

__device__ __forceinline__ uint32_t word(const uint4& w, int i) {
  return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}

// Fused LN: the words of columns 4 * grp .. 4 * grp + 3 of `row`.
__device__ __forceinline__ uint4 ln_words(uint2 k, uint32_t row, uint32_t grp) {
  return philox4x32_10(make_uint4(grp, row, 0u, 0u), k);
}

// Encoder: oct(x) of the mapping above.
__device__ __forceinline__ uint32_t oct(int x) { return (uint32_t)((x >> 4) * 8 + (x & 7)); }

// Encoder: the words of rows {i, i + 8} x columns {j, j + 8} for i, j with
// bit 3 clear (word 2 * (row is i + 8) + (column is j + 8)).
__device__ __forceinline__ uint4 encoder_words(uint2 k, int bh, int i, int j) {
  return philox4x32_10(make_uint4(oct(i), oct(j), (uint32_t)bh, 0u), k);
}

}  // namespace philox
