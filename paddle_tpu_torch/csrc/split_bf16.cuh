// Float32 products on the bf16 tensor cores, as split-bf16 products: the
// device code that the float32 instantiations of the flash and encoder
// kernels, forward and backward (flash_attention.cu, flash_attention_bwd.cu,
// encoder_attention.cu, encoder_attention_bwd.cu), and of the decode and
// paged kernels (kv_attention.cuh), share.
//
// Each f32 operand x is two bf16 planes, hi = RN(x) and lo = RN(x - hi)
// (about 16 of f32's 24 bits), and each product A B is the sum of the terms
// of SPLIT_BF16_TERMS, A_lo B_hi + A_hi B_lo + A_hi B_hi: three bf16
// products, exact in f32 and summed in f32 (the small terms first; A_lo
// B_lo, under 2^-16 of the rest, is left out).  An f32 tile of R rows and D
// columns is held as a bf16 tile of W = 2 D columns, a row's D hi values and
// then its D lo values: 4 bytes an element either way, so a tile's two
// planes are neighbouring 64-column panels of one bf16 tile, and a k-step
// kk of plane a is k-step kk + a D / 16 of that tile.  The 2-byte types run
// the same code with one plane and one term.
#pragma once

#include "wgmma_attention.cuh"

// The float32 products' terms, (A plane, B plane) with 0 = hi and 1 = lo,
// in the order they are summed (a CPU test emulates this list).
#define SPLIT_BF16_TERMS(X) X(1, 0) X(0, 1) X(0, 0)

namespace split_bf16 {

using namespace wgmma_attention;

// How the products read an input type T: a 2-byte T as itself, one plane;
// float as P = 2 bf16 planes (hi, lo) side by side along a row.
template <typename T>
struct Planes {
  using E = T;
  static constexpr int P = 1;
};

template <>
struct Planes<float> {
  using E = bf16;
  static constexpr int P = 2;
};

// A plane index known at compile time.
template <int V>
struct Plane {
  __host__ __device__ constexpr operator int() const { return V; }
};

// f(a, b, first) for each term of a product of an operand of PA planes by
// one of PB planes: the terms of SPLIT_BF16_TERMS whose planes both
// operands have, in its order: (0, 0) alone at PA = PB = 1, all three at
// PA = PB = 2, and at PA = 2, PB = 1 (a float32 or float16 q against a
// 16-bit cache) lo x B then hi x B.  a and b are compile-time plane
// indices, `first` marks the term that starts the accumulator.
template <int PA, int PB = PA, typename F>
__device__ __forceinline__ void for_terms(F&& f) {
  bool first = true;
#define X(A, B)                         \
  if constexpr (A < PA && B < PB) {     \
    f(Plane<A>(), Plane<B>(), first);   \
    first = false;                      \
  }
  SPLIT_BF16_TERMS(X)
#undef X
}

// The A fragments of an m64 x N accumulator for the products: rounded to T,
// or at float32 split into hi = RN(x) and lo = RN(x - hi) bf16 planes.
template <int N, typename T>
__device__ __forceinline__ void to_planes(uint32_t (&a)[Planes<T>::P][N / 16][4],
                                          const float (&d)[N / 2]) {
  if constexpr (Planes<T>::P == 1) {
    to_a<N, T>(a[0], d);
  } else {
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x0 = d[8 * kk + 2 * r], x1 = d[8 * kk + 2 * r + 1];
        __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
        const float2 h = __bfloat1622float2(hi);
        __nv_bfloat162 lo = __floats2bfloat162_rn(x0 - h.x, x1 - h.y);
        a[0][kk][r] = *reinterpret_cast<uint32_t*>(&hi);
        a[1][kk][r] = *reinterpret_cast<uint32_t*>(&lo);
      }
  }
}

// (x0, x1) as a bf16 pair rounded to nearest (returned) and the pair of
// what that rounding left out, rounded again (lo); lo = 0 where hi is not
// finite.
__device__ __forceinline__ uint32_t split_pair(float x0, float x1, uint32_t& lo) {
  __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
  const float2 h = __bfloat1622float2(hi);
  __nv_bfloat162 l = __floats2bfloat162_rn(isfinite(h.x) ? x0 - h.x : 0.f,
                                           isfinite(h.y) ? x1 - h.y : 0.f);
  lo = *reinterpret_cast<uint32_t*>(&l);
  return *reinterpret_cast<uint32_t*>(&hi);
}

// An f32 tile of ROWS rows x D columns as tma_tile wrote it (D / 32 panels
// of ROWS rows x 32 values, 128-byte swizzled) becomes, in the same bytes,
// its bf16 tile of W = 2 D columns (D / 32 panels of ROWS rows x 64 values,
// the same swizzle): hi then lo of each row, split_pair's values, the
// layout the products read.  A row's bytes are the same D / 32 128-byte
// lines of the tile in both layouts, so the warp that owns a row reads it
// whole, syncs, and writes it back: split_rows makes the calling warp's
// rows (4-row groups from r0, every `step` rows, below r1), and
// split_tile's warps take 4 rows a round each and need no barrier among
// themselves.  The caller fences (fence_async_shared) and syncs the block
// (or, where the warp alone reads its rows, the warp) before a product
// reads the tile.
template <int D, int ROWS>
__device__ __forceinline__ void split_rows(bf16* tile, int r0, int r1, int step) {
  static_assert(D % 64 == 0 && ROWS % 4 == 0, "whole 64-column pairs of panels, 4 rows a round");
  constexpr int J = D / 64;          // the lane's column pairs in a row: c = 64 j + 2 lane
  constexpr int kLo = J * ROWS * 128;  // bytes from a hi value to its lo value
  unsigned char* base = reinterpret_cast<unsigned char*>(tile);
  const int lane = threadIdx.x & 31;
  for (; r0 < r1; r0 += step) {
    float2 x[4][J];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int r = r0 + i, c = 64 * j + 2 * lane;
        x[i][j] = *reinterpret_cast<const float2*>(base + (c >> 5) * ROWS * 128 + r * 128 +
                                                   ((((c & 31) >> 2) ^ (r & 7)) << 4) + (c & 3) * 4);
      }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int r = r0 + i, c = 64 * j + 2 * lane;
        unsigned char* at =
            base + j * ROWS * 128 + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4) + (c & 7) * 2;
        uint32_t lo;
        *reinterpret_cast<uint32_t*>(at) = split_pair(x[i][j].x, x[i][j].y, lo);
        *reinterpret_cast<uint32_t*>(at + kLo) = lo;
      }
  }
}

// The whole tile by the block's NT threads.
template <int D, int ROWS, int NT = kThreads>
__device__ __forceinline__ void split_tile(bf16* tile) {
  split_rows<D, ROWS>(tile, 4 * (threadIdx.x >> 5), ROWS, 4 * (NT / 32));
}

// At float32 the f32 tiles of ROWS rows, as TMA wrote them, become their
// bf16 planes where they landed (split_tile); then the block syncs, so that
// both warpgroups read them.  Nothing at the 2-byte types.
template <typename T, int D, int ROWS, typename... E>
__device__ __forceinline__ void make_planes(E*... tiles) {
  if constexpr (Planes<T>::P > 1) {
    (split_tile<D, ROWS>(tiles), ...);
    fence_async_shared();
    __syncthreads();
  }
}

}  // namespace split_bf16
