// Fused dropout + residual add + LayerNorm for Hopper (sm_90a), forward and
// backward, bf16 or f32, hidden sizes h % 128 == 0 up to 1024.
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
//             and per-block partials of dgamma = sum dout xhat and dbeta =
//             sum dout, [nblocks, h] f32, which the caller sums, as the
//             reference sums its per-block partials outside the kernel.
// The mask is regenerated in the backward from the saved seed pair
// (philox.cuh: element (row, col) reads counter (col >> 2, row, 0, 0), word
// col & 3), so no mask is stored.
//
// What bounds it on this card: bytes.  The forward reads x and y and writes
// out and s, the backward reads s and dout and writes dx and dy: at the
// ERNIE shape (n 65,536, h 768, bf16) 403 MB each way, 0.120 ms at
// 3.35 TB/s.  Its arithmetic is a few operations per element, and the
// dropout's Philox costs 40 32-bit multiplies per 4 elements: 12.6 M calls,
// 0.030 ms at the card's 16.7 T multiplies/s, under the bytes.
//
// What the design does about it: one warp per row, so that a row's
// statistics are warp shuffles and its values stay in registers between
// the passes (at h = 768 a lane holds 24 values); each lane moves 4 adjacent
// elements a load (8 bytes in bf16, 16 in f32), neighbouring lanes on
// neighbouring addresses, and one Philox call serves those 4 elements.
// Nothing is read twice from memory.  The backward's blocks own 128 rows
// each and add their warps' dgamma and dbeta in a fixed order through
// shared memory, so the partials carry the same bits on every run, without
// atomics.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (paddle_tpu_torch/ops/_build.py does this).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxGroups = 8;   // groups of 4 columns per lane: h <= 32 * 4 * 8
constexpr int kBwdRows = 128;   // rows per backward block: one partial row each

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
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

struct Ln {
  const float* gamma;  // [h] f32
  const float* beta;   // [h] f32 (forward)
  const int* seed;     // int32 [2] on the device, or null at rate 0
  int n, h;
  uint32_t thresh;     // keep iff the element's word < thresh
  float scale;         // 1 / (1 - rate) when upscaling, else 1
  float eps;
};

// One warp per row.  s and out are [n, h] of T; x and y likewise.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_ln_fwd_kernel(const T* x, const T* y, T* out, T* s_out, Ln a) {
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
    load4(x + base + col, xv);
    load4(y + base + col, yv);
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (drop) w = philox::ln_words(key, (uint32_t)row, (uint32_t)grp);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float yd = yv[e];
      if (drop) yd = philox::word(w, e) < a.thresh ? yd * a.scale : 0.f;
      v[k][e] = round_to(xv[e] + yd, x);
      sum += v[k][e];
    }
    store4(s_out + base + col, v[k]);
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
    load4(a.gamma + col, g);
    load4(a.beta + col, b);
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = (v[k][e] - mean) * rstd * g[e] + b[e];
    store4(out + base + col, o);
  }
}

// One block per kBwdRows rows, one warp per row in turn; dg_part and
// db_part are [gridDim.x, h] f32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_ln_bwd_kernel(const T* s, const T* dz, T* dx, T* dy, float* dg_part, float* db_part,
                        Ln a) {
  __shared__ float red[kWarps][kMaxGroups * 128];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ng = a.h / 128;
  const bool drop = a.seed != nullptr;
  const uint2 key = drop ? philox::key(a.seed) : make_uint2(0u, 0u);
  float dg[kMaxGroups][4], db[kMaxGroups][4];
#pragma unroll
  for (int k = 0; k < kMaxGroups; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) dg[k][e] = db[k][e] = 0.f;
  const int row0 = blockIdx.x * kBwdRows, rend = min(row0 + kBwdRows, a.n);
  for (int row = row0 + warp; row < rend; row += kWarps) {
    const size_t base = (size_t)row * a.h;
    float v[kMaxGroups][4], d[kMaxGroups][4];
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxGroups; ++k) {
      if (k >= ng) break;
      const int col = 4 * (lane + 32 * k);
      load4(s + base + col, v[k]);
      load4(dz + base + col, d[k]);
      sum += v[k][0] + v[k][1] + v[k][2] + v[k][3];
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
    // v becomes xhat and d keeps dout; dxhat = dout gamma is recomputed
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxGroups; ++k) {
      if (k >= ng) break;
      float g[4];
      load4(a.gamma + 4 * (lane + 32 * k), g);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[k][e] = (v[k][e] - mean) * rstd;
        const float dxh = d[k][e] * g[e];
        sa += dxh;
        sb += dxh * v[k][e];
        dg[k][e] += d[k][e] * v[k][e];
        db[k][e] += d[k][e];
      }
    }
    const float ma = warp_sum(sa) / a.h, mb = warp_sum(sb) / a.h;
#pragma unroll
    for (int k = 0; k < kMaxGroups; ++k) {
      if (k >= ng) break;
      const int grp = lane + 32 * k, col = 4 * grp;
      float g[4], ds[4], dd[4];
      load4(a.gamma + col, g);
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (drop) w = philox::ln_words(key, (uint32_t)row, (uint32_t)grp);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ds[e] = rstd * (d[k][e] * g[e] - ma - v[k][e] * mb);
        dd[e] = ds[e];
        if (drop) dd[e] = philox::word(w, e) < a.thresh ? ds[e] * a.scale : 0.f;
      }
      store4(dx + base + col, ds);
      store4(dy + base + col, dd);
    }
  }
  // the block's partials: the warps' sums added in warp order
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int k = 0; k < kMaxGroups; ++k) {
      if (k >= ng) break;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[warp][4 * (lane + 32 * k) + e] = pass ? db[k][e] : dg[k][e];
    }
    __syncthreads();
    float* part = (pass ? db_part : dg_part) + (size_t)blockIdx.x * a.h;
    for (int c = threadIdx.x; c < a.h; c += kThreads) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) t += red[w][c];
      part[c] = t;
    }
    __syncthreads();
  }
}

__global__ void philox_kernel(const uint32_t* in, uint32_t* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t* c = in + 6 * i;
  const uint4 w = philox::philox4x32_10(make_uint4(c[0], c[1], c[2], c[3]),
                                        make_uint2(c[4], c[5]));
  out[4 * i] = w.x, out[4 * i + 1] = w.y, out[4 * i + 2] = w.z, out[4 * i + 3] = w.w;
}

bool bad(int n, int h) { return n <= 0 || h <= 0 || h % 128 != 0 || h > 128 * kMaxGroups; }

Ln make_ln(const void* gamma, const void* beta, const void* seed, int n, int h,
           unsigned thresh, float scale, float eps) {
  return Ln{static_cast<const float*>(gamma), static_cast<const float*>(beta),
            static_cast<const int*>(seed), n, h, thresh, scale, eps};
}

}  // namespace

// Plain C interface (bound with ctypes).  Each returns a cudaError_t: 0 on
// a clean launch.  Pointers are device pointers to contiguous tensors;
// `bf16` selects bf16 (1) or f32 (0) for every [n, h] tensor; gamma and
// beta are f32 [h]; seed is int32 [2] or null (no dropout).
extern "C" int fused_ln_fwd_launch(const void* x, const void* y, const void* gamma,
                                   const void* beta, const void* seed, void* out, void* s,
                                   int n, int h, int bf16, unsigned thresh, float scale,
                                   float eps, void* stream) {
  if (bad(n, h)) return (int)cudaErrorInvalidValue;
  const Ln a = make_ln(gamma, beta, seed, n, h, thresh, scale, eps);
  const dim3 grid((n + kWarps - 1) / kWarps);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
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

// dg_part and db_part are f32 [ceil(n / 128), h].
extern "C" int fused_ln_bwd_launch(const void* s, const void* gamma, const void* dz,
                                   const void* seed, void* dx, void* dy, void* dg_part,
                                   void* db_part, int n, int h, int bf16, unsigned thresh,
                                   float scale, float eps, void* stream) {
  if (bad(n, h)) return (int)cudaErrorInvalidValue;
  const Ln a = make_ln(gamma, nullptr, seed, n, h, thresh, scale, eps);
  const dim3 grid((n + kBwdRows - 1) / kBwdRows);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dg = static_cast<float*>(dg_part);
  float* db = static_cast<float*>(db_part);
  if (bf16)
    fused_ln_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(s), static_cast<const __nv_bfloat16*>(dz),
        static_cast<__nv_bfloat16*>(dx), static_cast<__nv_bfloat16*>(dy), dg, db, a);
  else
    fused_ln_bwd_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(s), static_cast<const float*>(dz), static_cast<float*>(dx),
        static_cast<float*>(dy), dg, db, a);
  return (int)cudaGetLastError();
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
