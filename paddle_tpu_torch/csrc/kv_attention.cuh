// Attention of a query block against a kv cache walked row by row: the
// device code shared by paged_attention.cu (a page pool behind page tables)
// and decode_attention.cu (a head-major static cache).  The two differ only
// in where key position kpos of slot b and kv head kvh lives, which a
// `Rows` policy answers (PagedRows, StaticRows below).
//
// For q [B, S, H, D] bf16, query position s of slot b attends keys
// [0, lengths[b] - S + s] (lengths = offset + S), and query head h reads kv
// head h / (H / Hkv).  One block per (row tile, kv head, slot): the S * rep
// query rows that share a kv head fold into tiles of up to 16 rows, each
// row with its own causal end, and a tile walks keys only up to its last
// row's end, never past the cache's capacity.  K/V rows stream from device
// memory once per block in 64-key chunks with 16-byte coalesced loads into
// shared memory; int8 rows dequantize there.  The softmax is online across
// chunks in f32, with m/l/acc kept in shared memory and registers.  CUDA
// cores only: no wgmma, TMA, double buffering or split-K yet.
//
// Numerics follow the reference kernels: NEG_INF = -1e30 is finite (an -inf
// would give NaN from inf - inf); int8 k-scales multiply the scores after
// the dot, v-scales multiply p after l is updated, and p is rounded to bf16
// before the PV product; a slot with lengths <= 0 emits zeros.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace kv_attention {

constexpr int kD = 128;             // head dim (the only one instantiated)
constexpr int kKC = 64;             // keys per staged chunk
constexpr int kThreads = 128;       // one thread per head-dim column in PV
constexpr int kKW = kD / 2 + 1;     // K row stride in 32-bit words: 65 keeps
                                    // the score loop free of bank conflicts
constexpr float kNegInf = -1e30f;

static_assert(kThreads == kD, "PV maps one thread to one head-dim column");
static_assert(kThreads == 2 * kKC, "scores map two row groups over a chunk");

// Paged: key kpos of slot b lives in page tbl[b, kpos / ps] at row kpos % ps
// of a pool [P, Hkv, ps, D]; the table has M entries per slot.
struct PagedRows {
  const int* tbl;
  int Hkv, ps, M;
  __device__ __forceinline__ size_t row(int b, int kvh, int kpos) const {
    return ((size_t)tbl[(size_t)b * M + kpos / ps] * Hkv + kvh) * ps + kpos % ps;
  }
  __device__ __forceinline__ int capacity() const { return M * ps; }
};

// Static: key kpos of slot b is row kpos of the head-major [B, Hkv, L, D].
struct StaticRows {
  int Hkv, L;
  __device__ __forceinline__ size_t row(int b, int kvh, int kpos) const {
    return ((size_t)b * Hkv + kvh) * L + kpos;
  }
  __device__ __forceinline__ int capacity() const { return L; }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t w) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&w);
  return __bfloat1622float2(h);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// RT: query rows per block (a power of two <= 16); QUANT: int8 caches.
template <int RT, bool QUANT, class Rows>
__global__ void __launch_bounds__(kThreads)
kv_attention_kernel(const __nv_bfloat16* __restrict__ q,  // [B, S, H, D]
                    const void* __restrict__ k_cache,     // bf16 or int8 rows of D
                    const void* __restrict__ v_cache,
                    const float* __restrict__ k_scale,    // one f32 per row
                    const float* __restrict__ v_scale,
                    const int* __restrict__ lengths,      // [B]
                    __nv_bfloat16* __restrict__ out,      // [B, S, H, D]
                    int S, int H, float scale, Rows rows_of) {
  constexpr int RPG = (RT + 1) / 2;  // score rows per thread group
  const int tile = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int rep = H / rows_of.Hkv;
  const int rows = S * rep;          // query rows reading this kv head
  const int r0 = tile * RT;
  const int R = min(RT, rows - r0);  // live rows of this tile
  const int len = lengths[b];

  __shared__ __align__(16) float q_s[RT][kD];
  __shared__ uint32_t k_s[kKC][kKW];
  __shared__ __align__(16) __nv_bfloat16 v_s[kKC][kD];
  __shared__ float s_s[RT][kKC];     // scores, then probabilities
  __shared__ float ks_s[kKC], vs_s[kKC];
  __shared__ float m_s[RT], l_s[RT], c_s[RT];
  __shared__ int qend_s[RT];

  // Row r of the tile is query position s = (r0 + r) / rep of query head
  // kvh * rep + (r0 + r) % rep: every row reads the same kv head.
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    float val = 0.f;
    if (r < R) {
      const int rg = r0 + r, s = rg / rep, h = kvh * rep + rg % rep;
      val = __bfloat162float(q[((size_t)(b * S + s) * H + h) * kD + t]);
    }
    q_s[r][t] = val;
  }
  if (t < RT) {
    const int s = (r0 + min(t, R - 1)) / rep;
    m_s[t] = kNegInf;
    l_s[t] = 0.f;
    c_s[t] = 1.f;
    qend_s[t] = len - S + s + 1;     // row t reads keys [0, qend)
  }
  // the tile's last live row sees the most keys: walk no further, and never
  // past the cache's capacity (a chunk's padded rows can reach beyond it;
  // the reference's grid stops there too)
  const int kend = min(min(len, len - S + (r0 + R - 1) / rep + 1), rows_of.capacity());
  float acc[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) acc[r] = 0.f;
  __syncthreads();

  for (int kb = 0; kb < kend; kb += kKC) {
    const int nk = min(kKC, kend - kb);
    // ---- stage the chunk's K/V rows (16-byte loads, 16 or 8 per row)
    if (!QUANT) {
      const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(k_cache);
      const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(v_cache);
      for (int i = t; i < nk * 16; i += kThreads) {
        const int j = i >> 4, seg = i & 15;
        const size_t base = rows_of.row(b, kvh, kb + j) * kD + seg * 8;
        const uint4 kv = *reinterpret_cast<const uint4*>(kp + base);
        const uint4 vv = *reinterpret_cast<const uint4*>(vp + base);
        uint32_t* kd = &k_s[j][seg * 4];
        kd[0] = kv.x; kd[1] = kv.y; kd[2] = kv.z; kd[3] = kv.w;
        *reinterpret_cast<uint4*>(&v_s[j][seg * 8]) = vv;
      }
    } else {
      const int8_t* kp = static_cast<const int8_t*>(k_cache);
      const int8_t* vp = static_cast<const int8_t*>(v_cache);
      for (int i = t; i < nk * 8; i += kThreads) {
        const int j = i >> 3, seg = i & 7;
        const size_t base = rows_of.row(b, kvh, kb + j) * kD + seg * 16;
        const int4 kraw = *reinterpret_cast<const int4*>(kp + base);
        const int4 vraw = *reinterpret_cast<const int4*>(vp + base);
        const int8_t* k8 = reinterpret_cast<const int8_t*>(&kraw);
        const int8_t* v8 = reinterpret_cast<const int8_t*>(&vraw);
#pragma unroll
        for (int e = 0; e < 8; ++e)  // int8 -> bf16 is exact
          k_s[j][seg * 8 + e] = pack_bf16x2((float)k8[2 * e], (float)k8[2 * e + 1]);
#pragma unroll
        for (int e = 0; e < 16; ++e) v_s[j][seg * 16 + e] = __float2bfloat16((float)v8[e]);
      }
      if (t < nk) {
        const size_t si = rows_of.row(b, kvh, kb + t);
        ks_s[t] = k_scale[si];
        vs_s[t] = v_scale[si];
      }
    }
    __syncthreads();

    // ---- scores: thread -> key j, row group g (RPG rows)
    {
      const int j = t % kKC, g = t / kKC;
      if (j < nk && g * RPG < RT) {
        float dot[RPG];
#pragma unroll
        for (int rr = 0; rr < RPG; ++rr) dot[rr] = 0.f;
        const uint32_t* kr = k_s[j];
#pragma unroll 8
        for (int w = 0; w < kD / 2; ++w) {
          const float2 kf = bf16x2_to_float2(kr[w]);
#pragma unroll
          for (int rr = 0; rr < RPG; ++rr) {
            const float2 qf = *reinterpret_cast<const float2*>(&q_s[g * RPG + rr][2 * w]);
            dot[rr] = fmaf(qf.x, kf.x, dot[rr]);
            dot[rr] = fmaf(qf.y, kf.y, dot[rr]);
          }
        }
        const int kpos = kb + j;
#pragma unroll
        for (int rr = 0; rr < RPG; ++rr) {
          const int r = g * RPG + rr;
          if (r < RT) {
            float sc = dot[rr] * scale;
            if (QUANT) sc *= ks_s[j];
            s_s[r][j] = kpos < qend_s[r] ? sc : kNegInf;
          }
        }
      }
    }
    __syncthreads();

    // ---- online softmax: warp w owns rows w, w + 4, ...
    for (int r = warp; r < RT; r += kThreads / 32) {
      const float m_prev = m_s[r], l_prev = l_s[r];
      const bool in0 = lane < nk, in1 = lane + 32 < nk;
      const float s0 = in0 ? s_s[r][lane] : -3.0e38f;
      const float s1 = in1 ? s_s[r][lane + 32] : -3.0e38f;
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      float p0 = in0 ? expf(s0 - m_new) : 0.f;
      float p1 = in1 ? expf(s1 - m_new) : 0.f;
      const float corr = expf(m_prev - m_new);
      const float l_new = l_prev * corr + warp_sum(p0 + p1);
      if (QUANT) {
        if (in0) p0 *= vs_s[lane];
        if (in1) p1 *= vs_s[lane + 32];
      }
      s_s[r][lane] = __bfloat162float(__float2bfloat16(p0));
      s_s[r][lane + 32] = __bfloat162float(__float2bfloat16(p1));
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // ---- acc = acc * corr + p @ V: thread t owns head-dim column t
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[r] *= c_s[r];
    for (int j = 0; j < nk; ++j) {
      const float vf = __bfloat162float(v_s[j][t]);
#pragma unroll
      for (int r = 0; r < RT; ++r) acc[r] = fmaf(s_s[r][j], vf, acc[r]);
    }
    __syncthreads();  // the next chunk overwrites the staged rows
  }

#pragma unroll
  for (int r = 0; r < RT; ++r) {
    if (r < R) {
      const float l = l_s[r];
      const int rg = r0 + r, s = rg / rep, h = kvh * rep + rg % rep;
      out[((size_t)(b * S + s) * H + h) * kD + t] =
          __float2bfloat16(acc[r] / (l <= 0.f ? 1.f : l));
    }
  }
}

template <int RT, class Rows>
cudaError_t launch_rt(bool quant, dim3 grid, cudaStream_t stream, const void* q,
                      const void* k, const void* v, const void* ks, const void* vs,
                      const void* lengths, void* out, int S, int H, float scale,
                      Rows rows_of) {
  const auto* qq = static_cast<const __nv_bfloat16*>(q);
  auto* oo = static_cast<__nv_bfloat16*>(out);
  const auto* ll = static_cast<const int*>(lengths);
  const auto* kss = static_cast<const float*>(ks);
  const auto* vss = static_cast<const float*>(vs);
  if (quant)
    kv_attention_kernel<RT, true, Rows><<<grid, kThreads, 0, stream>>>(
        qq, k, v, kss, vss, ll, oo, S, H, scale, rows_of);
  else
    kv_attention_kernel<RT, false, Rows><<<grid, kThreads, 0, stream>>>(
        qq, k, v, kss, vss, ll, oo, S, H, scale, rows_of);
  return cudaGetLastError();
}

// Pick the row tile for S * rep rows, check the grid, and launch.
template <class Rows>
cudaError_t launch(bool quant, int B, int S, int H, cudaStream_t stream, const void* q,
                   const void* k, const void* v, const void* ks, const void* vs,
                   const void* lengths, void* out, float scale, Rows rows_of) {
  const int rows = S * (H / rows_of.Hkv);
  const int rt = rows <= 1 ? 1 : rows <= 2 ? 2 : rows <= 4 ? 4 : rows <= 8 ? 8 : 16;
  const dim3 grid((rows + rt - 1) / rt, rows_of.Hkv, B);
  if (grid.x > 2147483647u || grid.y > 65535u || grid.z > 65535u)
    return cudaErrorInvalidConfiguration;
  switch (rt) {
    case 1: return launch_rt<1>(quant, grid, stream, q, k, v, ks, vs, lengths, out, S, H, scale, rows_of);
    case 2: return launch_rt<2>(quant, grid, stream, q, k, v, ks, vs, lengths, out, S, H, scale, rows_of);
    case 4: return launch_rt<4>(quant, grid, stream, q, k, v, ks, vs, lengths, out, S, H, scale, rows_of);
    case 8: return launch_rt<8>(quant, grid, stream, q, k, v, ks, vs, lengths, out, S, H, scale, rows_of);
    default: return launch_rt<16>(quant, grid, stream, q, k, v, ks, vs, lengths, out, S, H, scale, rows_of);
  }
}

}  // namespace kv_attention
