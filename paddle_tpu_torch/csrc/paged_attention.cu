// Ragged paged attention for Hopper (sm_90a), bf16 or int8 page pools.
//
// Replaces: paddle_tpu/ops/decode_attention.py `_paged_kernel` (launched by
// `_paged_pallas`).  One kernel serves every query block the paged serving
// engine produces: S = 1 decode ticks and S = prefill_chunk chunks at any
// per-slot offset.  For q [B, S, H, D] against page pools [P, Hkv, ps, D]
// walked through page_tbl [B, M], query position s of slot b attends keys
// [0, lengths[b] - S + s] (lengths = offset + S), and query head h reads
// kv head h / (H / Hkv).
//
// What bounds it on this card: a decode tick is memory bound.  It must read
// the K and V rows of every valid token once (2 * Hkv * D bytes per token in
// bf16, half of that in int8), so its floor is those bytes over the H100's
// 3.35 TB/s; its arithmetic (4 * rows * keys * D operations) is two orders
// below the tensor-core rate.  A long prefill chunk reads the same bytes but
// does S * rep times the arithmetic, so it is the one case that leans on
// operations.
//
// What the design does about it: one block per (row tile, kv head, slot).
// The block reads its own lengths[b] and page-table row, and walks only the
// keys its rows can see causally, so it never reads past the slot's last
// valid page and a prefill tile stops at its own causal end.  A live slot's
// walk never touches the trash page 0; an idle slot, whose row the engine
// masks to page 0 at length 1, reads one key of it and its output is
// discarded.  K/V rows stream from device memory once per block
// in 64-key chunks with 16-byte coalesced loads into shared memory; int8 rows
// dequantize there.  All S * rep query rows that share a kv head sit in the
// same tile, so GQA reads each K/V row once for up to 16 query rows.  The
// softmax is online across chunks in f32, with m/l/acc kept in shared memory
// and registers.  This first version uses CUDA cores only: no wgmma, TMA,
// double buffering or split-K yet (later work, see PERF.md).
//
// Numerics follow the reference kernel: NEG_INF = -1e30 is finite (an -inf
// would give NaN from inf - inf); int8 k-scales multiply the scores after
// the dot, v-scales multiply p after l is updated, and p is rounded to bf16
// before the PV product; a slot with lengths <= 0 emits zeros.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (paddle_tpu_torch/ops/_build.py does this).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;             // head dim (the only one instantiated)
constexpr int kKC = 64;             // keys per staged chunk
constexpr int kThreads = 128;       // one thread per head-dim column in PV
constexpr int kKW = kD / 2 + 1;     // K row stride in 32-bit words: 65 keeps
                                    // the score loop free of bank conflicts
constexpr float kNegInf = -1e30f;

static_assert(kThreads == kD, "PV maps one thread to one head-dim column");
static_assert(kThreads == 2 * kKC, "scores map two row groups over a chunk");

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

// RT: query rows per block (a power of two <= 16); QUANT: int8 pools.
template <int RT, bool QUANT>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const __nv_bfloat16* __restrict__ q,  // [B, S, H, D]
                       const void* __restrict__ k_pages,     // [P, Hkv, ps, D]
                       const void* __restrict__ v_pages,
                       const float* __restrict__ k_scale,    // [P, Hkv, ps]
                       const float* __restrict__ v_scale,
                       const int* __restrict__ lengths,      // [B]
                       const int* __restrict__ page_tbl,     // [B, M]
                       __nv_bfloat16* __restrict__ out,      // [B, S, H, D]
                       int S, int H, int Hkv, int ps, int M, float scale) {
  constexpr int RPG = (RT + 1) / 2;  // score rows per thread group
  const int tile = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int rep = H / Hkv;
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
  // past the table's M pages (a chunk's padded rows can reach beyond them;
  // the reference's page grid stops at M too)
  const int kend = min(min(len, len - S + (r0 + R - 1) / rep + 1), M * ps);
  float acc[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) acc[r] = 0.f;
  __syncthreads();

  const int* pt = page_tbl + (size_t)b * M;
  for (int kb = 0; kb < kend; kb += kKC) {
    const int nk = min(kKC, kend - kb);
    // ---- stage the chunk's K/V rows (16-byte loads, 16 or 8 per row)
    if (!QUANT) {
      const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(k_pages);
      const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(v_pages);
      for (int i = t; i < nk * 16; i += kThreads) {
        const int j = i >> 4, seg = i & 15, kpos = kb + j;
        const size_t base =
            (((size_t)pt[kpos / ps] * Hkv + kvh) * ps + kpos % ps) * kD + seg * 8;
        const uint4 kv = *reinterpret_cast<const uint4*>(kp + base);
        const uint4 vv = *reinterpret_cast<const uint4*>(vp + base);
        uint32_t* kd = &k_s[j][seg * 4];
        kd[0] = kv.x; kd[1] = kv.y; kd[2] = kv.z; kd[3] = kv.w;
        *reinterpret_cast<uint4*>(&v_s[j][seg * 8]) = vv;
      }
    } else {
      const int8_t* kp = static_cast<const int8_t*>(k_pages);
      const int8_t* vp = static_cast<const int8_t*>(v_pages);
      for (int i = t; i < nk * 8; i += kThreads) {
        const int j = i >> 3, seg = i & 7, kpos = kb + j;
        const size_t base =
            (((size_t)pt[kpos / ps] * Hkv + kvh) * ps + kpos % ps) * kD + seg * 16;
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
        const int kpos = kb + t;
        const size_t si = ((size_t)pt[kpos / ps] * Hkv + kvh) * ps + kpos % ps;
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

template <int RT>
cudaError_t launch_rt(bool quant, dim3 grid, cudaStream_t stream,
                      const void* q, const void* k, const void* v, const void* ks,
                      const void* vs, const void* lengths, const void* page_tbl,
                      void* out, int S, int H, int Hkv, int ps, int M, float scale) {
  const auto* qq = static_cast<const __nv_bfloat16*>(q);
  auto* oo = static_cast<__nv_bfloat16*>(out);
  const auto* ll = static_cast<const int*>(lengths);
  const auto* pt = static_cast<const int*>(page_tbl);
  const auto* kss = static_cast<const float*>(ks);
  const auto* vss = static_cast<const float*>(vs);
  if (quant)
    paged_attention_kernel<RT, true><<<grid, kThreads, 0, stream>>>(
        qq, k, v, kss, vss, ll, pt, oo, S, H, Hkv, ps, M, scale);
  else
    paged_attention_kernel<RT, false><<<grid, kThreads, 0, stream>>>(
        qq, k, v, kss, vss, ll, pt, oo, S, H, Hkv, ps, M, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface (bound with ctypes).  Returns a cudaError_t: 0 on a
// clean launch.  Pointers are device pointers; `quant` selects int8 pools
// with f32 scale pools (ks/vs ignored otherwise).
extern "C" int paged_attention_launch(const void* q, const void* k, const void* v,
                                      const void* ks, const void* vs,
                                      const void* lengths, const void* page_tbl,
                                      void* out, int B, int S, int H, int Hkv, int D,
                                      int ps, int M, float scale, int quant,
                                      void* stream) {
  if (D != kD || Hkv <= 0 || H % Hkv != 0 || S <= 0 || B <= 0 || ps <= 0 || M <= 0)
    return (int)cudaErrorInvalidValue;
  const int rows = S * (H / Hkv);
  const int rt = rows <= 1 ? 1 : rows <= 2 ? 2 : rows <= 4 ? 4 : rows <= 8 ? 8 : 16;
  const dim3 grid((rows + rt - 1) / rt, Hkv, B);
  if (grid.x > 2147483647u || grid.y > 65535u || grid.z > 65535u)
    return (int)cudaErrorInvalidConfiguration;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool qt = quant != 0;
  cudaError_t err;
  switch (rt) {
    case 1: err = launch_rt<1>(qt, grid, st, q, k, v, ks, vs, lengths, page_tbl, out, S, H, Hkv, ps, M, scale); break;
    case 2: err = launch_rt<2>(qt, grid, st, q, k, v, ks, vs, lengths, page_tbl, out, S, H, Hkv, ps, M, scale); break;
    case 4: err = launch_rt<4>(qt, grid, st, q, k, v, ks, vs, lengths, page_tbl, out, S, H, Hkv, ps, M, scale); break;
    case 8: err = launch_rt<8>(qt, grid, st, q, k, v, ks, vs, lengths, page_tbl, out, S, H, Hkv, ps, M, scale); break;
    default: err = launch_rt<16>(qt, grid, st, q, k, v, ks, vs, lengths, page_tbl, out, S, H, Hkv, ps, M, scale); break;
  }
  return (int)err;
}

extern "C" const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
