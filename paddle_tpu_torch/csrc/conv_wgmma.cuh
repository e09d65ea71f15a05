// Hopper building blocks of the fused 1x1-conv + BatchNorm kernels
// (fused_conv_bn.cu) beyond those of wgmma_attention.cuh (TMA loads, the
// mbarrier ring, descriptors, the products Mma<N>) and encoder_wgmma.cuh
// (st_pair, fence_async_shared): the offset of an element in a swizzled
// tile, TMA stores with their bulk groups, and named barriers of one
// warpgroup.
//
// A 2-D activation [M, K] is the map (K, 1, M, 1) of make_map; a box is
// `rows` rows of 64 bf16 (one 128-byte swizzled panel).  A tile of R rows
// and N columns is N / 64 such panels, each R * 64 elements.
#pragma once

#include "encoder_wgmma.cuh"

namespace conv_wgmma {

using namespace wgmma_attention;
using encoder_wgmma::fence_async_shared;
using encoder_wgmma::st_pair;

constexpr int kTile = 64 * kPanel;  // bf16 of a 64-row panel (8 KB)

// Element offset of (row, col) in a tile of ROWS-row panels with the
// 128-byte swizzle: 16-byte chunk c of row r sits at chunk c ^ (r % 8).
template <int ROWS>
__device__ __forceinline__ int swz(int row, int col) {
  return (col >> 6) * ROWS * kPanel + row * kPanel + ((((col & 63) >> 3) ^ (row & 7)) << 3) +
         (col & 7);
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// One box from shared memory (swizzled as the map says) to global memory;
// rows past the tensor's end are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until the committed stores have read their shared memory (READ) or are
// complete.
template <bool READ>
__device__ __forceinline__ void bulk_wait() {
  if (READ)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace conv_wgmma
