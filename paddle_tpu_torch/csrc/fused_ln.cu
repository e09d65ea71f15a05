// Fused dropout + residual add + LayerNorm for Hopper (sm_90a), forward and
// backward, bf16 or f32, every hidden size the reference admits: h % 128 ==
// 0 up to 32768.
//
// Replaces: paddle_tpu/ops/fused_ln.py `_fwd_kernel` (launched by
// `_fused_fwd`) and `_bwd_kernel` (launched by `_fused_bwd`), the glue of
// every BERT/ERNIE encoder layer.  With x the residual and y the branch,
// both [n, h]:
//   forward:  s = x + where(keep, y * scale, 0) in f32, rounded to x's dtype
//             and stored; mean and var two-pass in f32 on the rounded s;
//             out = (s - mean) rstd gamma + beta in f32, rounded;
//   backward: from s (the only saved activation) and dout: xhat, dxhat =
//             dout gamma, ds = rstd (dxhat - mean(dxhat) - xhat
//             mean(dxhat xhat)); dx = ds, dy = where(keep, ds * scale, 0),
//             and one dgamma = sum dout xhat and dbeta = sum dout partial
//             row per team of the grid, [teams, h] f32, which the caller
//             sums, as the reference sums its per-block partials outside
//             the kernel.
// The mask is regenerated in the backward from the saved seed pair
// (philox.cuh: element (row, col) reads counter (col >> 2, row, 0, 0), word
// col & 3), so no mask is stored.
//
// What bounds it on this card: bytes.  Each direction reads two [n, h]
// tensors and writes two: at the ERNIE shape (n 65,536, h 768, bf16) 403 MB,
// 0.120 ms at 3.35 TB/s; at h 4096 (n 16,384, bf16) and h 32768 (n 2,048
// bf16, n 1,024 f32) 537 MB, 0.160 ms.  The arithmetic is a few operations
// per element, and the dropout's Philox costs 40 32-bit multiplies per 4
// elements: at the ERNIE shape 12.6 M calls, 0.030 ms at the card's 16.7 T
// multiplies/s, under the bytes.
//
// What the design does about it (ops/fused_ln.py `_plan` picks the path and
// its shape; the C entries run the plan they are given or refuse it):
//  * Narrow forward (h <= 1024): one warp per row, so that a row's
//    statistics are warp shuffles and its values stay in registers between
//    the passes; each lane moves 4 adjacent elements a load, and one Philox
//    call serves them.
//  * Narrow backward (h <= 1024), templated on NG = h / 128 so that every
//    per-lane array has its exact size.  Persistent blocks of 8 warps, SMs x
//    the occupancy the kernel reaches; warp w of block b takes rows 8 b + w,
//    8 b + w + 8 grid, ...  Each warp keeps a ring of rows (s and dz) in
//    shared memory, fed by 1-D bulk copies (cp.async.bulk, UBLKCP in SASS)
//    that its lane 0 issues onto the stage's mbarrier: the next rows' bytes
//    are in flight while the warp reduces the current one and draws its
//    Philox words.  A row costs two dependent shuffle rounds, each adding two
//    sums in one butterfly: (sum s, sum dxhat), then (sum (s - mean)^2, sum
//    dxhat (s - mean)), which is sum(dxhat xhat) / rstd.  dgamma and dbeta
//    stay in registers across rows; the block adds its warps' in warp order
//    once, at the end.  Measured on the H100 and not kept: 3 or 4 ring
//    stages (2 are as fast), 16-byte pieces in bf16 (8 are as fast), and
//    two blocks an SM at 128 registers (slower than one at up to 255).
//  * Wide (h > 1024), forward and backward: a team of CL blocks (a thread
//    block cluster, CL 1..8) takes one row at a time; block q takes the q-th
//    slice of the row's 16-byte pieces, each thread at most 16 values of a
//    tensor in registers (at 256 threads a block holds 4096 columns, so h
//    32768 takes 8 blocks: a row pair in f32 is 256 KB, more than an SM's
//    shared memory, and a thread of a 1024-thread block has 64 registers).
//    Cross-warp sums go through shared memory and cross-block sums through
//    distributed shared memory: each block's sum goes by st.async into every
//    block of the team, completing on the receiver's mbarrier, and every
//    thread adds the same values in the same order.  (A cluster barrier in
//    their place, whose release waits for the thread's outstanding global
//    stores row after row, left h 32768 slower than the library
//    composition.)  Two such sums a row in either direction.  Teams are
//    persistent, each block with a ring of its row slices fed by bulk copies
//    that thread 0 issues.  A thread owns the same columns in every row, so
//    the backward keeps its dgamma and dbeta in registers and writes them
//    to the team's partial row once.
// Partials are summed in a fixed order: the same bits on every run, without
// atomics.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (paddle_tpu_torch/ops/_build.py does this).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"
#include "wgmma_attention.cuh"  // smem_u32, the mbarrier helpers, bulk_load

// The kernels a plan can name (ops/fused_ln.py `_plan` and
// tests/test_torch_fused_ln.py read these two lists).  Narrow backward: NG =
// h / 128.  Wide, forward and backward: (element type, 16-byte pieces a
// thread).
#define FUSED_LN_NARROW(X) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8)
#define FUSED_LN_WIDE(X) X(__nv_bfloat16, 1) X(__nv_bfloat16, 2) X(float, 1) X(float, 2) X(float, 4)

namespace {

using wgmma_attention::bulk_load;
using wgmma_attention::fence_barrier_init;
using wgmma_attention::mbar_expect_tx;
using wgmma_attention::mbar_init;
using wgmma_attention::mbar_wait;
using wgmma_attention::smem_u32;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kNarrowMaxH = 1024;  // a row is one warp's: 4 * 8 columns a lane
constexpr int kMaxH = 32768;       // the reference's admission: 8 rows of 32768
constexpr int kWideValues = 16;    // values of a tensor a wide thread holds
constexpr int kStages = 2;         // rows (narrow) or row slices (wide) in a ring

__device__ __forceinline__ float2 unpack(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

__device__ __forceinline__ uint32_t pack(float a, float b) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// V adjacent elements at p (V * sizeof(T) bytes, aligned to that or 16) as
// f32, and back.
template <int V>
__device__ __forceinline__ void ldv(const float* p, float (&v)[V]) {
#pragma unroll
  for (int i = 0; i < V; i += 4) {
    const float4 u = *reinterpret_cast<const float4*>(p + i);
    v[i] = u.x, v[i + 1] = u.y, v[i + 2] = u.z, v[i + 3] = u.w;
  }
}

template <int V>
__device__ __forceinline__ void ldv(const __nv_bfloat16* p, float (&v)[V]) {
  static_assert(V == 4 || V == 8, "8 or 16 bytes of bf16");
  uint32_t w[V / 2];
  if constexpr (V == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x, w[1] = u.y;
  }
#pragma unroll
  for (int i = 0; i < V / 2; ++i) {
    const float2 f = unpack(w[i]);
    v[2 * i] = f.x, v[2 * i + 1] = f.y;
  }
}

template <int V>
__device__ __forceinline__ void stv(float* p, const float (&v)[V]) {
#pragma unroll
  for (int i = 0; i < V; i += 4)
    *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}

template <int V>
__device__ __forceinline__ void stv(__nv_bfloat16* p, const float (&v)[V]) {
  static_assert(V == 4 || V == 8, "8 or 16 bytes of bf16");
  uint32_t w[V / 2];
#pragma unroll
  for (int i = 0; i < V / 2; ++i) w[i] = pack(v[2 * i], v[2 * i + 1]);
  if constexpr (V == 8)
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  else
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
}

// x rounded to T and back.
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// Two independent sums in one butterfly (the same bits as two warp_sums).
__device__ __forceinline__ float2 warp_sum2(float2 v) {
#pragma unroll
  for (int m = 16; m; m >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, m);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, m);
  }
  return v;
}

// Orders this thread's generic-proxy accesses of shared memory before the
// bulk copies it issues next.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

struct Ln {
  const float* gamma;  // [h] f32
  const float* beta;   // [h] f32 (forward)
  const int* seed;     // int32 [2] on the device, or null at rate 0
  int n, h;
  uint32_t thresh;     // keep iff the element's word < thresh
  float scale;         // 1 / (1 - rate) when upscaling, else 1
  float eps;
};

// Dropout of the V values of `row` from column col on (col % 4 == 0): kept
// ones times scale, dropped ones 0.
template <int V>
__device__ __forceinline__ void drop(float (&v)[V], uint2 key, int row, int col, const Ln& a) {
#pragma unroll
  for (int q = 0; q < V / 4; ++q) {
    const uint4 w = philox::ln_words(key, (uint32_t)row, (uint32_t)(col / 4 + q));
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[4 * q + e] = philox::word(w, e) < a.thresh ? v[4 * q + e] * a.scale : 0.f;
  }
}

// ----------------------------------------------------------------- narrow

// One warp per row.  s and out are [n, h] of T; x and y likewise.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_ln_fwd_kernel(const T* x, const T* y, T* out, T* s_out, Ln a) {
  constexpr int kMaxGroups = kNarrowMaxH / 128;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= a.n) return;  // whole warps leave together
  const int ng = a.h / 128;
  const bool drop = a.seed != nullptr;
  const uint2 key = drop ? philox::key(a.seed) : make_uint2(0u, 0u);
  const size_t base = (size_t)row * a.h;
  float v[kMaxGroups][4];
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxGroups; ++k) {
    if (k >= ng) break;
    const int grp = lane + 32 * k, col = 4 * grp;
    float xv[4], yv[4];
    ldv<4>(x + base + col, xv);
    ldv<4>(y + base + col, yv);
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (drop) w = philox::ln_words(key, (uint32_t)row, (uint32_t)grp);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float yd = yv[e];
      if (drop) yd = philox::word(w, e) < a.thresh ? yd * a.scale : 0.f;
      v[k][e] = round_to(xv[e] + yd, x);
      sum += v[k][e];
    }
    stv<4>(s_out + base + col, v[k]);
  }
  const float mean = warp_sum(sum) / a.h;
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxGroups; ++k) {
    if (k >= ng) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float c = v[k][e] - mean;
      sq += c * c;
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / a.h + a.eps);
#pragma unroll
  for (int k = 0; k < kMaxGroups; ++k) {
    if (k >= ng) break;
    const int col = 4 * (lane + 32 * k);
    float g[4], b[4], o[4];
    ldv<4>(a.gamma + col, g);
    ldv<4>(a.beta + col, b);
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = (v[k][e] - mean) * rstd * g[e] + b[e];
    stv<4>(out + base + col, o);
  }
}

// Shared memory of a narrow backward block: the warps' rings [kWarps]
// [kStages][2][h] of T (a stage holds s, then dz, of one row), their full
// barriers [kWarps][kStages], and gamma [h] f32.
template <typename T>
size_t narrow_smem(int h) {
  return (size_t)kWarps * kStages * 2 * h * sizeof(T) + kWarps * kStages * sizeof(uint64_t) +
         h * 4;
}

// Persistent blocks of 8 warps, one row a warp at a time (rows 8 b + w +
// 8 grid j); dg_part and db_part are [gridDim.x, h] f32, one row a block.
// Compiled for one block an SM: held to the 128 registers of two, ptxas
// spills from NG = 7 on and at NG = 6 the kernel is slower.
template <typename T, int NG>
__global__ void __launch_bounds__(kThreads, 1)
    fused_ln_bwd_kernel(const T* s, const T* dz, T* dx, T* dy, float* dg_part, float* db_part,
                        Ln a) {
  constexpr int H = 128 * NG, S = kStages;
  constexpr int V = 4, P = NG;  // a lane's pieces: 4 adjacent columns, one Philox call each
  constexpr uint32_t kRowBytes = H * sizeof(T);
  static_assert(S * 2 * sizeof(T) >= 2 * sizeof(float), "the rings hold the partials' sums");
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t ring_bytes = (size_t)kWarps * S * 2 * H * sizeof(T);
  T* ring = reinterpret_cast<T*>(smem) + (size_t)warp * S * 2 * H;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ring_bytes) + warp * S;
  float* g_s = reinterpret_cast<float*>(smem + ring_bytes + kWarps * S * sizeof(uint64_t));
  for (int c = threadIdx.x; c < H; c += kThreads) g_s[c] = a.gamma[c];
  if (lane == 0) {
#pragma unroll
    for (int st = 0; st < S; ++st) mbar_init(&full[st], 1);
    fence_barrier_init();
  }
  __syncthreads();
  const int row0 = blockIdx.x * kWarps + warp, stride = gridDim.x * kWarps;
  // lane 0: the warp's j-th row into stage j % S
  auto issue = [&](int j) {
    const int row = row0 + j * stride;
    if (row >= a.n) return;
    T* st = ring + (j % S) * 2 * H;
    uint64_t* bar = &full[j % S];
    mbar_expect_tx(bar, 2 * kRowBytes);
    bulk_load(st, s + (size_t)row * H, kRowBytes, bar);
    bulk_load(st + H, dz + (size_t)row * H, kRowBytes, bar);
  };
  if (lane == 0)
#pragma unroll
    for (int j = 0; j < S; ++j) issue(j);
  const bool drop_on = a.seed != nullptr;
  const uint2 key = drop_on ? philox::key(a.seed) : make_uint2(0u, 0u);
  float dg[P][V], db[P][V];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int e = 0; e < V; ++e) dg[p][e] = db[p][e] = 0.f;
  for (int j = 0, row = row0; row < a.n; ++j, row += stride) {
    const T* sr = ring + (j % S) * 2 * H;
    const T* dr = sr + H;
    mbar_wait(&full[j % S], (j / S) & 1);
    // round 1: sum(s) and sum(dxhat), dxhat = dz gamma; s stays in v, dz
    // and gamma are read again from shared memory where they are needed
    float v[P][V];
    float2 r1 = make_float2(0.f, 0.f);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int col = V * (lane + 32 * p);
      float d[V], g[V];
      ldv<V>(sr + col, v[p]);
      ldv<V>(dr + col, d);
      ldv<V>(g_s + col, g);
#pragma unroll
      for (int e = 0; e < V; ++e) r1.x += v[p][e], r1.y += d[e] * g[e];
    }
    r1 = warp_sum2(r1);
    const float mean = r1.x / H, ma = r1.y / H;
    // round 2: sum((s - mean)^2) and sum(dxhat (s - mean)), which is
    // sum(dxhat xhat) / rstd; v becomes s - mean
    float2 r2 = make_float2(0.f, 0.f);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int col = V * (lane + 32 * p);
      float d[V], g[V];
      ldv<V>(dr + col, d);
      ldv<V>(g_s + col, g);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        v[p][e] -= mean;
        r2.x += v[p][e] * v[p][e];
        r2.y += d[e] * g[e] * v[p][e];
      }
    }
    r2 = warp_sum2(r2);
    const float rstd = rsqrtf(r2.x / H + a.eps), mb = rstd * r2.y / H;
    const size_t base = (size_t)row * H;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int col = V * (lane + 32 * p);
      float d[V], g[V], ds[V], dd[V];
      ldv<V>(dr + col, d);
      ldv<V>(g_s + col, g);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float xhat = v[p][e] * rstd;
        dg[p][e] += d[e] * xhat;
        db[p][e] += d[e];
        dd[e] = ds[e] = rstd * (d[e] * g[e] - ma - xhat * mb);
      }
      if (drop_on) drop<V>(dd, key, row, col, a);
      stv<V>(dx + base + col, ds);
      stv<V>(dy + base + col, dd);
    }
    // every lane has read stage j % S (its values are spent): refill it
    __syncwarp();
    if (lane == 0) {
      fence_proxy_async();
      issue(j + S);
    }
  }
  // the block's partials, its warps' sums added in warp order; the rings are
  // drained (every issued row was waited for), so their memory is reused
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // [2][kWarps][H]
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int col = V * (lane + 32 * p);
    stv<V>(red + warp * H + col, dg[p]);
    stv<V>(red + (kWarps + warp) * H + col, db[p]);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * H; c += kThreads) {
    const int which = c / H, col = c % H;
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += red[(which * kWarps + w) * H + col];
    (which ? db_part : dg_part)[(size_t)blockIdx.x * H + col] = t;
  }
}

// ------------------------------------------------------------------- wide

struct Wide {
  int cl;      // blocks a team (the cluster's size)
  int pieces;  // 16-byte pieces of a block's slice of a row (the last block's may be fewer)
};

constexpr int kMaxCluster = 8;

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// v into *p and its 8 bytes onto *bar, both in the shared memory of the
// team's block `rank`.  No fence: the receiver sees v once its mbarrier's
// phase completes, and this thread's global stores are not waited for (a
// cluster barrier's release would wait for them, row after row).
__device__ __forceinline__ void st_peer(float2* p, uint64_t* bar, int rank, float2 v) {
  uint32_t pa, ba;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(pa) : "r"(smem_u32(p)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(ba) : "r"(smem_u32(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];\n" ::"r"(
          pa),
      "f"(v.x), "f"(v.y), "r"(ba)
      : "memory");
}

// A team's cross-thread sums, in the block's shared memory.  Two sets,
// alternating sum by sum: a block writes a set again two sums later, after
// every block of the team has read it (each sends its next sum only then).
struct TeamSums {
  float2 warp[2][kWarps];       // the warps' sums
  float2 block[2][kMaxCluster]; // the team's blocks' sums, by rank
  uint64_t bar[2];              // completes when every block's sum has landed
};

// The team's sum of v, both halves, the same bits in every thread of the
// team: the warps' sums are added in warp order, then (cl > 1) the blocks'
// sums, which warp 0's lane r sends to block r, in rank order.
__device__ __forceinline__ float2 team_sum(float2 v, TeamSums& t, int& uses, int cl) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const int set = uses & 1;
  const uint32_t parity = (uses >> 1) & 1;
  ++uses;
  v = warp_sum2(v);
  if (lane == 0) t.warp[set][warp] = v;
  __syncthreads();
  float2 r = make_float2(0.f, 0.f);
  for (int w = 0; w < nw; ++w) r.x += t.warp[set][w].x, r.y += t.warp[set][w].y;
  if (cl == 1) return r;
  if (warp == 0) {
    if (lane == 0) mbar_expect_tx(&t.bar[set], cl * sizeof(float2));
    if (lane < cl) st_peer(&t.block[set][blockIdx.x % cl], &t.bar[set], lane, r);
  }
  mbar_wait(&t.bar[set], parity);
  r = make_float2(0.f, 0.f);
  for (int q = 0; q < cl; ++q) r.x += t.block[set][q].x, r.y += t.block[set][q].y;
  return r;
}

// Shared memory of a wide block: its ring [kStages][2][pieces * 16
// bytes] (a stage holds its slices of the two input rows), the full
// barriers [kStages], and the team's sums.
size_t wide_smem(int pieces) {
  return (size_t)kStages * 2 * pieces * 16 + kStages * sizeof(uint64_t) +
         sizeof(TeamSums);
}

// Team t = blockIdx.x / cl takes rows t, t + teams, ...; its block q the
// pieces [q pieces, (q + 1) pieces) of each; thread i the pieces i + k
// blockDim.x of that slice.  Forward: in0 x, in1 y, out0 out, out1 s.
// Backward: in0 s, in1 dz, out0 dx, out1 dy, and the team's partial rows
// dg_part[t] and db_part[t], [teams, h] f32, each block its slice.  Two
// team sums a row either way: the forward's mean, then its variance; the
// backward's (sum s, sum dxhat), then (sum (s - mean)^2, sum dxhat (s -
// mean)).
template <typename T, int K, bool BWD>
__device__ __forceinline__ void wide_rows(const T* in0, const T* in1, T* out0, T* out1,
                                          float* dg_part, float* db_part, const Ln& a,
                                          const Wide& w) {
  constexpr int V = 16 / sizeof(T);
  static_assert(K * V <= kWideValues, "at most 16 values of a tensor a thread");
  extern __shared__ __align__(16) unsigned char smem[];
  const int q = blockIdx.x % w.cl, team = blockIdx.x / w.cl, teams = gridDim.x / w.cl;
  const int c0 = q * w.pieces * V;                       // the slice's first column
  const int np = min(w.pieces, a.h / V - q * w.pieces);  // its pieces
  const int slice = w.pieces * V;                        // elements of a stage half
  const uint32_t bytes = np * 16;
  T* ring = reinterpret_cast<T*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + (size_t)kStages * 2 * w.pieces * 16);
  TeamSums& sums = *reinterpret_cast<TeamSums*>(full + kStages);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) mbar_init(&full[st], 1);
    mbar_init(&sums.bar[0], 1);
    mbar_init(&sums.bar[1], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (w.cl > 1) cluster_sync();  // the team's barriers are set up before any sum lands
  // thread 0: the team's j-th row into stage j % kStages
  auto issue = [&](int j) {
    const int row = team + j * teams;
    if (row >= a.n) return;
    T* st = ring + (size_t)(j % kStages) * 2 * slice;
    uint64_t* bar = &full[j % kStages];
    mbar_expect_tx(bar, 2 * bytes);
    bulk_load(st, in0 + (size_t)row * a.h + c0, bytes, bar);
    bulk_load(st + slice, in1 + (size_t)row * a.h + c0, bytes, bar);
  };
  if (threadIdx.x == 0)
#pragma unroll
    for (int j = 0; j < kStages; ++j) issue(j);
  const bool drop_on = a.seed != nullptr;
  const uint2 key = drop_on ? philox::key(a.seed) : make_uint2(0u, 0u);
  float g[K][V], b[K][V], dg[K][V], db[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int lp = threadIdx.x + k * blockDim.x, col = c0 + lp * V;
#pragma unroll
    for (int e = 0; e < V; ++e) g[k][e] = b[k][e] = dg[k][e] = db[k][e] = 0.f;
    if (lp < np) {
      ldv<V>(a.gamma + col, g[k]);
      if (!BWD) ldv<V>(a.beta + col, b[k]);
    }
  }
  int uses = 0;
  for (int j = 0, row = team; row < a.n; ++j, row += teams) {
    const T* r0 = ring + (size_t)(j % kStages) * 2 * slice;
    const T* r1 = r0 + slice;
    mbar_wait(&full[j % kStages], (j / kStages) & 1);
    const size_t base = (size_t)row * a.h;
    // v: x, then s (forward) or s (backward); d: y (forward) or dz
    float v[K][V], d[K][V];
    float2 s1 = make_float2(0.f, 0.f);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int lp = threadIdx.x + k * blockDim.x, col = c0 + lp * V;
#pragma unroll
      for (int e = 0; e < V; ++e) v[k][e] = d[k][e] = 0.f;
      if (lp >= np) continue;
      ldv<V>(r0 + lp * V, v[k]);
      ldv<V>(r1 + lp * V, d[k]);
      if (!BWD) {  // s = x + dropout(y), rounded, stored
        if (drop_on) drop<V>(d[k], key, row, col, a);
#pragma unroll
        for (int e = 0; e < V; ++e) v[k][e] = round_to(v[k][e] + d[k][e], in0);
        stv<V>(out1 + base + col, v[k]);
      }
#pragma unroll
      for (int e = 0; e < V; ++e) s1.x += v[k][e], s1.y += BWD ? d[k][e] * g[k][e] : 0.f;
    }
    s1 = team_sum(s1, sums, uses, w.cl);
    const float mean = s1.x / a.h, ma = s1.y / a.h;
    // every thread of the block has read the stage (the sum's barrier): refill it
    if (threadIdx.x == 0) {
      fence_proxy_async();
      issue(j + kStages);
    }
    float2 s2 = make_float2(0.f, 0.f);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (threadIdx.x + k * blockDim.x >= np) continue;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        v[k][e] -= mean;
        s2.x += v[k][e] * v[k][e];
        if (BWD) s2.y += d[k][e] * g[k][e] * v[k][e];
      }
    }
    s2 = team_sum(s2, sums, uses, w.cl);
    const float rstd = rsqrtf(s2.x / a.h + a.eps), mb = rstd * s2.y / a.h;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int lp = threadIdx.x + k * blockDim.x, col = c0 + lp * V;
      if (lp >= np) continue;
      float o[V], dd[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float xhat = v[k][e] * rstd;
        if (BWD) {
          dg[k][e] += d[k][e] * xhat;
          db[k][e] += d[k][e];
          dd[e] = o[e] = rstd * (d[k][e] * g[k][e] - ma - xhat * mb);
        } else {
          o[e] = xhat * g[k][e] + b[k][e];
        }
      }
      stv<V>(out0 + base + col, o);
      if (BWD) {
        if (drop_on) drop<V>(dd, key, row, col, a);
        stv<V>(out1 + base + col, dd);
      }
    }
  }
  if (BWD) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int lp = threadIdx.x + k * blockDim.x, col = c0 + lp * V;
      if (lp >= np) continue;
      stv<V>(dg_part + (size_t)team * a.h + col, dg[k]);
      stv<V>(db_part + (size_t)team * a.h + col, db[k]);
    }
  }
  if (w.cl > 1) cluster_sync();  // every sum has landed before a block leaves
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads, 2)
    fused_ln_fwd_kernel_wide(const T* x, const T* y, T* out, T* s, Ln a, Wide w) {
  wide_rows<T, K, false>(x, y, out, s, nullptr, nullptr, a, w);
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads, 2)
    fused_ln_bwd_kernel_wide(const T* s, const T* dz, T* dx, T* dy, float* dg_part,
                             float* db_part, Ln a, Wide w) {
  wide_rows<T, K, true>(s, dz, dx, dy, dg_part, db_part, a, w);
}

__global__ void philox_kernel(const uint32_t* in, uint32_t* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t* c = in + 6 * i;
  const uint4 w = philox::philox4x32_10(make_uint4(c[0], c[1], c[2], c[3]),
                                        make_uint2(c[4], c[5]));
  out[4 * i] = w.x, out[4 * i + 1] = w.y, out[4 * i + 2] = w.z, out[4 * i + 3] = w.w;
}

// ------------------------------------------------------------------- host

bool bad(int n, int h) { return n <= 0 || h <= 0 || h % 128 != 0 || h > kMaxH; }

// A plan (ops/fused_ln.py `_plan`): h <= 1024 runs the narrow kernels, k =
// h / 128, one block of 8 warps a team; above, the wide kernels, teams of cl
// blocks of `threads` threads, k pieces a thread.  The kernel it names is
// looked up below; a plan that names none, or does not cover the row, is
// refused.
struct Plan {
  int k, cl, threads;
};

bool bad_plan(int h, int bf16, const Plan& p) {
  if (h <= kNarrowMaxH) return p.k != h / 128 || p.cl != 1 || p.threads != kThreads;
  const int V = bf16 ? 8 : 4, pieces = h / V, per = (pieces + p.cl - 1) / p.cl;
  return !(p.cl == 1 || p.cl == 2 || p.cl == 4 || p.cl == 8) || p.threads <= 0 ||
         p.threads % 32 != 0 || p.threads > kThreads || p.k * V > kWideValues ||
         p.threads * p.k < per || pieces - (p.cl - 1) * per <= 0;
}

// The kernel a plan names, and its dynamic shared memory; null if none.
const void* plan_kernel(bool bwd, int h, int bf16, const Plan& p, size_t* smem) {
  if (h <= kNarrowMaxH) {
    if (!bwd) return nullptr;  // the narrow forward is not persistent
    *smem = bf16 ? narrow_smem<__nv_bfloat16>(h) : narrow_smem<float>(h);
#define X(NG)                                                              \
  if (p.k == NG)                                                           \
    return bf16 ? (const void*)fused_ln_bwd_kernel<__nv_bfloat16, NG>       \
                : (const void*)fused_ln_bwd_kernel<float, NG>;
    FUSED_LN_NARROW(X)
#undef X
    return nullptr;
  }
  const int V = bf16 ? 8 : 4;
  *smem = wide_smem((h / V + p.cl - 1) / p.cl);
#define X(T, K)                                                                 \
  if ((sizeof(T) == 2) == (bf16 != 0) && p.k == K)                              \
    return bwd ? (const void*)fused_ln_bwd_kernel_wide<T, K>                    \
               : (const void*)fused_ln_fwd_kernel_wide<T, K>;
  FUSED_LN_WIDE(X)
#undef X
  return nullptr;
}

// The launch of `teams` teams of a plan: p.cl blocks (one cluster) a team,
// p.threads threads a block, after raising the kernel's shared memory limit.
struct TeamLaunch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg{};
  cudaError_t err;

  TeamLaunch(const void* fn, int teams, const Plan& p, size_t smem, cudaStream_t st) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.cl;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(teams * p.cl);
    cfg.blockDim = dim3(p.threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
};

cudaError_t launch(const void* fn, int teams, const Plan& p, size_t smem, cudaStream_t st,
                   void** args) {
  TeamLaunch l(fn, teams, p, smem, st);
  if (l.err != cudaSuccess) return l.err;
  const cudaError_t err = cudaLaunchKernelExC(&l.cfg, fn, args);
  return err != cudaSuccess ? err : cudaGetLastError();
}

Ln make_ln(const void* gamma, const void* beta, const void* seed, int n, int h,
           unsigned thresh, float scale, float eps) {
  return Ln{static_cast<const float*>(gamma), static_cast<const float*>(beta),
            static_cast<const int*>(seed), n, h, thresh, scale, eps};
}

}  // namespace

// Plain C interface (bound with ctypes).  Each returns a cudaError_t: 0 on
// a clean launch.  Pointers are device pointers to contiguous tensors;
// `bf16` selects bf16 (1) or f32 (0) for every [n, h] tensor; gamma and
// beta are f32 [h]; seed is int32 [2] or null (no dropout); (k, cl,
// threads) is the plan and `teams` the persistent grid, at most
// fused_ln_teams' count.

// The most teams of a plan's persistent kernel that run on the card at once
// (the clusters of p.cl blocks that fit), into *teams; 0 for the narrow
// forward, which launches a block per 8 rows.
extern "C" int fused_ln_teams(int bwd, int h, int bf16, int k, int cl, int threads, int* teams) {
  const Plan p{k, cl, threads};
  if (bad(1, h) || bad_plan(h, bf16, p)) return (int)cudaErrorInvalidValue;
  *teams = 0;
  if (!bwd && h <= kNarrowMaxH) return 0;
  size_t smem = 0;
  const void* fn = plan_kernel(bwd != 0, h, bf16, p, &smem);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  TeamLaunch l(fn, 1, p, smem, nullptr);
  if (l.err != cudaSuccess) return (int)l.err;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(teams, fn, &l.cfg);
  if (err != cudaSuccess) return (int)err;
  return *teams > 0 ? 0 : (int)cudaErrorInvalidConfiguration;
}

extern "C" int fused_ln_fwd_launch(const void* x, const void* y, const void* gamma,
                                   const void* beta, const void* seed, void* out, void* s,
                                   int n, int h, int bf16, unsigned thresh, float scale,
                                   float eps, int k, int cl, int threads, int teams,
                                   void* stream) {
  const Plan p{k, cl, threads};
  if (bad(n, h) || bad_plan(h, bf16, p)) return (int)cudaErrorInvalidValue;
  Ln a = make_ln(gamma, beta, seed, n, h, thresh, scale, eps);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (h <= kNarrowMaxH) {
    const dim3 grid((n + kWarps - 1) / kWarps);
    if (bf16)
      fused_ln_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(y),
          static_cast<__nv_bfloat16*>(out), static_cast<__nv_bfloat16*>(s), a);
    else
      fused_ln_fwd_kernel<float><<<grid, kThreads, 0, st>>>(
          static_cast<const float*>(x), static_cast<const float*>(y), static_cast<float*>(out),
          static_cast<float*>(s), a);
    return (int)cudaGetLastError();
  }
  size_t smem = 0;
  const void* fn = plan_kernel(false, h, bf16, p, &smem);
  if (fn == nullptr || teams <= 0 || teams > n) return (int)cudaErrorInvalidValue;
  Wide w{cl, (h / (bf16 ? 8 : 4) + cl - 1) / cl};
  void* args[] = {&x, &y, &out, &s, &a, &w};
  return (int)launch(fn, teams, p, smem, st, args);
}

// dg_part and db_part are f32 [teams, h]: team t's rows are those with
// (row / 8) % teams == t on the narrow path (h <= 1024), row % teams == t on
// the wide one.
extern "C" int fused_ln_bwd_launch(const void* s, const void* gamma, const void* dz,
                                   const void* seed, void* dx, void* dy, void* dg_part,
                                   void* db_part, int n, int h, int bf16, unsigned thresh,
                                   float scale, float eps, int k, int cl, int threads, int teams,
                                   void* stream) {
  const Plan p{k, cl, threads};
  if (bad(n, h) || bad_plan(h, bf16, p) || teams <= 0) return (int)cudaErrorInvalidValue;
  Ln a = make_ln(gamma, nullptr, seed, n, h, thresh, scale, eps);
  size_t smem = 0;
  const void* fn = plan_kernel(true, h, bf16, p, &smem);
  const int rows = h <= kNarrowMaxH ? kWarps : 1;  // a team's rows at a time
  if (fn == nullptr || teams > (n + rows - 1) / rows) return (int)cudaErrorInvalidValue;
  Wide w{cl, (h / (bf16 ? 8 : 4) + cl - 1) / cl};
  void* narrow_args[] = {&s, &dz, &dx, &dy, &dg_part, &db_part, &a};
  void* wide_args[] = {&s, &dz, &dx, &dy, &dg_part, &db_part, &a, &w};
  return (int)launch(fn, teams, p, smem, static_cast<cudaStream_t>(stream),
                     h <= kNarrowMaxH ? narrow_args : wide_args);
}

// Philox4x32-10 on n (counter, key) rows: in [n, 6] uint32 (c0..c3, k0,
// k1), out [n, 4] uint32; for the known-answer check on the card.
extern "C" int philox_launch(const void* in, void* out, int n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  philox_kernel<<<(n + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), n);
  return (int)cudaGetLastError();
}

extern "C" const char* fused_ln_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
