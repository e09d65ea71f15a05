// Hopper building blocks of the flash- and encoder-attention kernels
// (flash_attention.cu, flash_attention_bwd.cu, and through
// encoder_wgmma.cuh encoder_attention.cu, encoder_attention_bwd.cu): TMA loads into 128-byte-swizzled shared memory,
// an mbarrier ring that keeps tiles in flight, warpgroup `wgmma` products
// with f32 accumulators, and the online-softmax step.  sm_90a only (`wgmma`
// exists for no other target).
//
// Block: two warpgroups, each owning 64 rows of the block's own side and
// running its products on the walked tiles as they arrive.  Thread 0 also
// issues the TMA loads: the own tile and the first N walked tiles of an
// N-stage ring up front, then tile j + N into stage j % N once both
// warpgroups have released tile j.  There is no producer warp: ptxas (CUDA
// 12.8) sizes every thread of a block with warpgroup products by whole
// warpgroups, so 288 or 384 threads get 65,536 / 384 = 168 registers a
// thread, and it kept that budget for the consumers after setmaxnreg (the
// dK/dV kernel spilled either way); 256 threads get up to 255, and the
// dK/dV kernel at D = 128 needs about 250.
//
// Element types.  Every helper below takes the 2-byte storage type T of
// the operands (bf16 by default; the flash and encoder kernels also
// __half, float16): the products run `wgmma ... .f32.bf16.bf16` or
// `.f32.f16.f16` with f32 sums, and every layout below is the same for
// both, since it counts 2-byte elements.  Elem<T> holds what differs: the
// TMA data type and the rounding of f32 pairs.  (The flash and encoder
// kernels at float32, forward and backward, read each f32 operand as two
// bf16 planes, hi and lo, through these same bf16 helpers (split_bf16.cuh);
// only make_map and tma_tile, which also load f32 tiles, and store_rows,
// which writes f32, take float.)
//
// Tiles in shared memory.  A tensor is [B, S, H, D] of T, its last
// dimension contiguous (the flash kernels take contiguous tensors, the
// encoder kernels views with any 16-byte-multiple strides).  Its TMA map
// (make_map) is 4-D over (D, H, S, B) with a box of (64, 1, rows,
// 1): one box is `rows` rows of 64 elements, 128 bytes a row, stored with the
// 128-byte swizzle (16-byte chunk c of row r lands at chunk c ^ (r % 8)).
// A rows x D tile is D / 64 such panels one after another, each 1024-byte
// aligned.  Rows past S come in as zeros (TMA's out-of-bounds fill), and a
// box never crosses into the next batch, so ragged edges need no copies.
//
// wgmma operands (the descriptor's layout type is the same 128-byte
// swizzle; SBO, the step between groups of 8 rows, is 1024 bytes):
//  * K-major (rows = M or N, the reduction runs along D): Q, K, V, dO as
//    the operands of Q K^T, dO V^T, K Q^T, V dO^T.  The k-step kk of 16
//    columns starts in panel kk / 4, 32 bytes per step into its rows.
//  * MN-major B (rows = the reduction, D = N along a row): V of P V, K of
//    dS K, dO of P^T dO, Q of dS^T Q, with the transpose bit.  The k-step
//    kk starts at row 16 kk of panel 0; LBO steps to the next 64 columns
//    (the next panel).
//  * A from registers: the f32 accumulator of m64nNk16 holds, in warp w of
//    the warpgroup and lane 4 g + t, d[4 j + e] = row 16 w + g + 8 (e >> 1),
//    column 8 j + 2 t + (e & 1).  Two neighbouring n8 chunks packed to T
//    pairs are exactly the A fragment of an m64k16 step (to_a), so P and dS
//    never leave registers.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only; nothing is linked from libcuda)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wgmma_attention {

using bf16 = __nv_bfloat16;

// What the kernels' element type decides: the TMA map's data type, the
// packed pair of two elements and its conversions from and to f32 (rounded
// to nearest even).
template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  static constexpr CUtensorMapDataType kTma = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  using Pair = __nv_bfloat162;
  static __device__ __forceinline__ Pair round2(float lo, float hi) {
    return __floats2bfloat162_rn(lo, hi);
  }
  static __device__ __forceinline__ float2 widen2(Pair v) { return __bfloat1622float2(v); }
};

template <>
struct Elem<__half> {
  static constexpr CUtensorMapDataType kTma = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  using Pair = __half2;
  static __device__ __forceinline__ Pair round2(float lo, float hi) {
    return __floats2half2_rn(lo, hi);
  }
  static __device__ __forceinline__ float2 widen2(Pair v) { return __half22float2(v); }
};

// float: the TMA data type of the f32 tiles that the float32 kernels load
// and split into bf16 planes in shared memory (split_bf16.cuh).
template <>
struct Elem<float> {
  static constexpr CUtensorMapDataType kTma = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};

constexpr int kThreads = 256;                    // two warpgroups
constexpr int kPanel = 64;                       // 2-byte elements in a 128-byte swizzled row
constexpr float kNegInf = -1e30f;                // finite, as the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kNoLimit = 1 << 30;                // a row's last key when not causal

// ------------------------------------------------------------ shared memory

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory, rounded up to 1024 bytes (the swizzle's
// period); launches ask for sizeof(T) + 1024.
template <typename T>
__device__ __forceinline__ T& aligned_smem() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t a = smem_u32(smem_raw);
  return *reinterpret_cast<T*>(smem_raw + (((a + 1023u) & ~1023u) - a));
}

// Shared-memory writes of the threads made visible to the async proxy
// (wgmma operands, TMA), before the barrier that publishes them.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic to come.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t ns;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(ns));
  return ns;
}

// Wait until the phase of parity `parity` has completed.  A wait that
// outlasts two seconds (a sound one takes microseconds) traps, so a broken
// ring ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  const uint64_t t0 = global_ns();
  uint32_t done;
  do {
    if (global_ns() - t0 > 2000000000ull) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// The ring of N stages: stage j % N holds walked tile j.  Its full barrier
// (one arrival, the issuer's, plus the TMA bytes) completes once per use,
// its empty barrier (kThreads arrivals) once every thread is done with it;
// use j waits for phase j / N of either.
template <int N>
struct Ring {
  static constexpr int kStages = N;
  uint64_t full[N], empty[N];
};

// Thread 0 sets up the own tile's barrier and the ring; then the block syncs.
template <int N>
__device__ __forceinline__ void init_ring(uint64_t* own, Ring<N>& ring) {
  if (threadIdx.x == 0) {
    mbar_init(own, 1);
#pragma unroll
    for (int s = 0; s < N; ++s) {
      mbar_init(&ring.full[s], 1);
      mbar_init(&ring.empty[s], kThreads);
    }
    fence_barrier_init();
  }
  __syncthreads();
}

template <int N>
__device__ __forceinline__ void wait_full(Ring<N>& ring, int j) {
  mbar_wait(&ring.full[j % N], (j / N) & 1);
}

// Thread 0 refills the stage of tile j - 1 with tile j - 1 + N, once every
// thread has released tile j - 1.  Called while tile j's first products run,
// so that the wait overlaps them and the two warpgroups may drift apart by
// up to a tile (one does its softmax while the other's products run).
template <int N, typename Load>
__device__ __forceinline__ void refill(Ring<N>& ring, int j, int tiles, Load load) {
  if (threadIdx.x == 0 && j >= 1 && j - 1 + N < tiles) {
    mbar_wait(&ring.empty[(j - 1) % N], ((j - 1) / N) & 1);
    load(j - 1 + N);
  }
}

template <int N>
__device__ __forceinline__ void release(Ring<N>& ring, int j) {
  mbar_arrive(&ring.empty[j % N]);
}

// -------------------------------------------------------------------- TMA

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// `bytes` contiguous bytes (16-byte aligned, a multiple of 16) from global
// memory into shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Rows [row0, row0 + ROWS) of head h, batch b, all D columns, as panels of
// ROWS rows x 128 bytes: D / 64 panels of 64 2-byte elements, or of float
// D / 32 panels of 32 (ROWS * D * sizeof(T) bytes of TMA traffic on `bar`).
template <int D, int ROWS, typename T>
__device__ __forceinline__ void tma_tile(T* dst, const CUtensorMap* map, uint64_t* bar, int h,
                                         int row0, int b) {
  constexpr int kCols = 128 / sizeof(T);
#pragma unroll
  for (int p = 0; p < D / kCols; ++p)
    tma_load(dst + p * ROWS * kCols, map, bar, kCols * p, h, row0, b);
}

// ------------------------------------------------------------------ wgmma

__device__ __forceinline__ uint64_t desc(const void* smem, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(smem) & 0x3FFFFu) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32 | 1ull << 62;  // 128B swizzle
}

// K-major operand, k-step kk: `tile` is row 0 of the operand's rows inside
// a tile of ROWS-row panels.
template <int ROWS, typename T>
__device__ __forceinline__ uint64_t desc_k(const T* tile, int kk) {
  static_assert(sizeof(T) == 2, "the tiles hold 2-byte elements");
  return desc(tile + (kk >> 2) * ROWS * kPanel + (kk & 3) * 16, 16, 1024);
}

// MN-major B operand, k-step kk (rows 16 kk .. 16 kk + 15 of a ROWS-row tile).
template <int ROWS, typename T>
__device__ __forceinline__ uint64_t desc_mn(const T* tile, int kk) {
  static_assert(sizeof(T) == 2, "the tiles hold 2-byte elements");
  return desc(tile + kk * 16 * kPanel, ROWS * 128, 1024);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups are still running (they finish in
// the order they were committed).
template <int N = 0>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins an accumulator's registers after wg_wait: the compiler sees the
// asynchronous product's result only from here on.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WGA_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WGA_F16(i) WGA_F4(i), WGA_F4(i + 4), WGA_F4(i + 8), WGA_F4(i + 12)
#define WGA_F32(i) WGA_F16(i), WGA_F16(i + 16)
#define WGA_R16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define WGA_R32 \
  WGA_R16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define WGA_R64                                                                   \
  WGA_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, " \
          "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "   \
          "%60, %61, %62, %63"
#define WGA_R128                                                                          \
  WGA_R64 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, "   \
          "%79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, " \
          "%95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, "  \
          "%109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "   \
          "%122, %123, %124, %125, %126, %127"

// d (m64 x N, f32) = A B (+ d when acc), one k16 step, N 32 (ss only), 64,
// 128 or 256, A and B of element type T.  ss: A and B from shared memory,
// both K-major.  rs: A from registers, B MN-major (the transpose bit),
// always accumulating.  tt: A and B from shared memory, both MN-major (both
// transpose bits): A is read as the transpose of a tile whose rows run
// along the reduction, as the encoder backward reads P_d and dS (rows =
// queries; a warpgroup's 64 keys are one panel) to form P_d^T and dS^T, and
// the conv backward xf and dyt to form xf^T dyt.  WGA_PRODUCTS(T, TY)
// writes the four widths for T, whose name in the mnemonic is TY.
template <int N, typename T = bf16>
struct Mma;

#define WGA_OP(N, TY) "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " "
#define WGA_PRODUCTS(T, TY)                                                                     \
  template <>                                                                                   \
  struct Mma<32, T> {                                                                           \
    static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a, uint64_t b, int acc) { \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n" WGA_OP(32, TY) WGA_R16          \
                   "}, %16, %17, p, 1, 1, 0, 0;\n}\n"                                           \
                   : WGA_F16(0)                                                                 \
                   : "l"(a), "l"(b), "r"(acc));                                                 \
    }                                                                                           \
  };                                                                                            \
                                                                                                \
  template <>                                                                                   \
  struct Mma<64, T> {                                                                           \
    static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b, int acc) { \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" WGA_OP(64, TY) WGA_R32          \
                   "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                                           \
                   : WGA_F32(0)                                                                 \
                   : "l"(a), "l"(b), "r"(acc));                                                 \
    }                                                                                           \
    static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4],           \
                                              uint64_t b) {                                     \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" WGA_OP(64, TY) WGA_R32          \
                   "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                             \
                   : WGA_F32(0)                                                                 \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));               \
    }                                                                                           \
    static __device__ __forceinline__ void tt(float (&d)[32], uint64_t a, uint64_t b, int acc) { \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" WGA_OP(64, TY) WGA_R32          \
                   "}, %32, %33, p, 1, 1, 1, 1;\n}\n"                                           \
                   : WGA_F32(0)                                                                 \
                   : "l"(a), "l"(b), "r"(acc));                                                 \
    }                                                                                           \
  };                                                                                            \
                                                                                                \
  template <>                                                                                   \
  struct Mma<128, T> {                                                                          \
    static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b, int acc) { \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" WGA_OP(128, TY) WGA_R64         \
                   "}, %64, %65, p, 1, 1, 0, 0;\n}\n"                                           \
                   : WGA_F32(0), WGA_F32(32)                                                    \
                   : "l"(a), "l"(b), "r"(acc));                                                 \
    }                                                                                           \
    static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4],           \
                                              uint64_t b) {                                     \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" WGA_OP(128, TY) WGA_R64         \
                   "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                             \
                   : WGA_F32(0), WGA_F32(32)                                                    \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));               \
    }                                                                                           \
    static __device__ __forceinline__ void tt(float (&d)[64], uint64_t a, uint64_t b, int acc) { \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" WGA_OP(128, TY) WGA_R64         \
                   "}, %64, %65, p, 1, 1, 1, 1;\n}\n"                                           \
                   : WGA_F32(0), WGA_F32(32)                                                    \
                   : "l"(a), "l"(b), "r"(acc));                                                 \
    }                                                                                           \
  };                                                                                            \
                                                                                                \
  template <>                                                                                   \
  struct Mma<256, T> {                                                                          \
    static __device__ __forceinline__ void ss(float (&d)[128], uint64_t a, uint64_t b,          \
                                              int acc) {                                        \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n" WGA_OP(256, TY) WGA_R128       \
                   "}, %128, %129, p, 1, 1, 0, 0;\n}\n"                                         \
                   : WGA_F32(0), WGA_F32(32), WGA_F32(64), WGA_F32(96)                          \
                   : "l"(a), "l"(b), "r"(acc));                                                 \
    }                                                                                           \
    static __device__ __forceinline__ void tt(float (&d)[128], uint64_t a, uint64_t b,          \
                                              int acc) {                                        \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n" WGA_OP(256, TY) WGA_R128       \
                   "}, %128, %129, p, 1, 1, 1, 1;\n}\n"                                         \
                   : WGA_F32(0), WGA_F32(32), WGA_F32(64), WGA_F32(96)                          \
                   : "l"(a), "l"(b), "r"(acc));                                                 \
    }                                                                                           \
    static __device__ __forceinline__ void rs(float (&d)[128], const uint32_t (&a)[4],          \
                                              uint64_t b) {                                     \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n" WGA_OP(256, TY) WGA_R128       \
                   "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"                        \
                   : WGA_F32(0), WGA_F32(32), WGA_F32(64), WGA_F32(96)                          \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));               \
    }                                                                                           \
  };

WGA_PRODUCTS(__nv_bfloat16, "bf16")
WGA_PRODUCTS(__half, "f16")

#undef WGA_PRODUCTS
#undef WGA_OP
#undef WGA_F4
#undef WGA_F16
#undef WGA_F32
#undef WGA_R16
#undef WGA_R32
#undef WGA_R64
#undef WGA_R128

// The thread's warpgroup, warp-uniform for the compiler (a shuffle from
// lane 0), so that the warpgroup-wide products stay in one block of code.
__device__ __forceinline__ int warpgroup() { return __shfl_sync(0xffffffffu, threadIdx.x / 128, 0); }

// ------------------------------------------------------- register fragments

// Two f32 values rounded to a T pair, as one 32-bit register.
template <typename T = bf16>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  typename Elem<T>::Pair h = Elem<T>::round2(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) { return pack2<bf16>(lo, hi); }

// The A fragments (m64 x k16 steps) of an m64 x N accumulator, rounded to T.
template <int N, typename T = bf16>
__device__ __forceinline__ void to_a(uint32_t (&a)[N / 16][4], const float (&d)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack2<T>(d[8 * kk], d[8 * kk + 1]);
    a[kk][1] = pack2<T>(d[8 * kk + 2], d[8 * kk + 3]);
    a[kk][2] = pack2<T>(d[8 * kk + 4], d[8 * kk + 5]);
    a[kk][3] = pack2<T>(d[8 * kk + 6], d[8 * kk + 7]);
  }
}

// Column of accumulator element i (within the N columns) for lane 4 g + t;
// its row is the thread's row + 8 * half(i).
__device__ __forceinline__ int acc_col(int i, int t) { return 8 * (i >> 2) + 2 * t + (i & 1); }
__device__ __forceinline__ int acc_half(int i) { return (i >> 1) & 1; }

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// One key tile of the online softmax, in place over a warpgroup's S
// accumulator (m64 x BK): scores become scale * log2(e) * s, masked to
// kNegInf at keys >= Sk or past the row's last visible key (`last`, for the
// thread's first row; the second row's is last + 8) when `edge`; then the
// running max m and this lane's share of the sum l (base-2 units) move on,
// o is rescaled, and s holds the tile's unnormalised probabilities.
template <int BK, int D>
__device__ __forceinline__ void softmax_step(float (&s)[BK / 2], float (&o)[D / 2], float (&m)[2],
                                             float (&l)[2], float scale_log2, bool edge, int kb,
                                             int Sk, int last, int t) {
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    s[i] *= scale_log2;
    if (edge) {
      const int key = kb + acc_col(i, t);
      if (key >= Sk || key > last + 8 * acc_half(i)) s[i] = kNegInf;
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float mx = kNegInf;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      if (acc_half(i) == hr) mx = fmaxf(mx, s[i]);
    const float m_new = fmaxf(m[hr], quad_max(mx));
    const float corr = exp2f(m[hr] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      if (acc_half(i) == hr) {
        s[i] = exp2f(s[i] - m_new);
        sum += s[i];
      }
    l[hr] = l[hr] * corr + sum;
    m[hr] = m_new;
#pragma unroll
    for (int i = 0; i < D / 2; ++i)
      if (acc_half(i) == hr) o[i] *= corr;
  }
}

// The thread's two rows (row, row + 8) of an m64 x N accumulator times
// `mul[half]` as T into columns [col0, col0 + N) of a [B, S, H, D] tensor
// of T (N = D unless a warpgroup owns a column slice); rows at or past S
// are not written.  T may also be float (the flash backward's float32
// outputs): the pair then goes out as a float2, unrounded.
template <int N, int D = N, typename T>
__device__ __forceinline__ void store_rows(T* dst, const float (&acc)[N / 2], const float (&mul)[2],
                                           int b, int h, int row, int S, int H, int t,
                                           int col0 = 0) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = row + 8 * hr;
    if (r >= S) continue;
    T* at = dst + ((size_t)(b * S + r) * H + h) * D + col0;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const float lo = acc[4 * j + 2 * hr] * mul[hr], hi = acc[4 * j + 2 * hr + 1] * mul[hr];
      if constexpr (sizeof(T) == 4)
        reinterpret_cast<float2*>(at)[4 * j + t] = make_float2(lo, hi);
      else
        reinterpret_cast<uint32_t*>(at)[4 * j + t] = pack2<T>(lo, hi);
    }
  }
}

// ------------------------------------------------------------------- host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime, so
// the library links against the runtime alone (no -lcuda).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// Element strides of a [B, S, H, D] view whose last dimension is contiguous.
struct Strides {
  long long h, s, b;
};

inline Strides contiguous_strides(int S, int H, int D) {
  return Strides{(long long)D, (long long)H * D, (long long)S * H * D};
}

// The TMA map of a [B, S, H, D] view of T at `ptr` (16-byte aligned) with
// element strides `st` (each 16 bytes' multiple: TMA's rule), with boxes of
// `rows` rows x 128 bytes of one head (64 columns of a 2-byte T, 32 of
// float) and the 128-byte swizzle.
template <typename T = bf16>
inline cudaError_t make_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int D, int rows,
                            Strides st) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  constexpr cuuint64_t kBytes = sizeof(T);
  const cuuint64_t strides[3] = {(cuuint64_t)st.h * kBytes, (cuuint64_t)st.s * kBytes,
                                 (cuuint64_t)st.b * kBytes};
  const cuuint32_t box[4] = {(cuuint32_t)(128 / kBytes), 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, Elem<T>::kTma, 4, const_cast<void*>(ptr), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The same for a contiguous [B, S, H, D] tensor.
template <typename T = bf16>
inline cudaError_t make_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int D, int rows) {
  return make_map<T>(map, ptr, B, S, H, D, rows, contiguous_strides(S, H, D));
}

// Launch kernel<<<grid, kThreads, smem>>> after raising its dynamic shared
// memory limit; returns the launch's error.
template <typename Kernel, typename... Args>
inline cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t st, const Args&... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, st>>>(args...);
  return cudaGetLastError();
}

inline bool bad_shape(int B, int H, int Sq, int Sk, int causal) {
  return B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || (causal && Sq > Sk) || H > 65535 || B > 65535;
}

}  // namespace wgmma_attention
