// Attention on the CUDA cores in f32 arithmetic, for float32 and float16
// storage: the device code of the decode and paged kernels at those types
// (attention_simt_decode.cu, attention_simt_paged.cu).  The bf16 decode
// and paged kernels (kv_attention.cuh), and the flash and encoder kernels
// at every type (wgmma_attention.cuh, encoder_wgmma.cuh; float32 as
// split-bf16 products, split_bf16.cuh), run on the tensor cores; this body
// runs every product as f32 FFMA.
//
// Replaces, at float32 and float16: paddle_tpu/ops/decode_attention.py
// `_decode_kernel` and `_paged_kernel`.  The reference's kernels take any
// float type and type their outputs by q.
//
// What they compute, per type (the reference kernels' rounding):
//  * q . k^T with f32 accumulation of the stored values (a product of two
//    float16 values, or of a float16 and a bf16 value, is exact in f32);
//    the score scale after the dot.
//  * the online softmax's unnormalised p rounded to v's type before p . v
//    (a no-op at float32).
//  * int8 caches: K and V widened exactly, the k-scale on the scores after
//    the dot, the v-scale on p after l, and p rounded to bf16 whatever q's
//    type, as the reference widens int8 to bf16.
//  * outputs in q's type.
// Scores run in base-2 units (scale * log2(e)), as the bf16 kernels' do.
//
// Why CUDA cores and not the tensor cores: the reference holds its f32
// kernels within 2e-5 of dense math, which single-pass TF32 or bf16 (about
// three decimal digits) cannot meet.  The flash and encoder kernels at
// float32 have since moved to the tensor cores as split-bf16 products
// (each f32 operand two bf16 planes, three bf16 products a product, about
// 16 bits of each operand); decode and paged can take the same split, and
// float16 decode and paged the 16-bit bodies (ROADMAP Queue 2, R1).
//
// What bounds them on the H100: decode ticks read every valid K/V row once
// at a few FLOP a byte (bytes); prefill chunks do 4 * D FLOP a visible
// (query, key) pair, far past the 67 TFLOP/s f32 FFMA ridge (operations).
//
// The design: one body for both entries, 128 threads a block, a block owns
// RT query rows of one (kv head, slot) (16 in the decode regime, rows =
// S * H / Hkv <= 16; 64 otherwise) and walks key tiles of BK keys (64, or
// 32 at D = 256) through a two-stage cp.async ring in shared memory, in
// the storage type (rows past the block's key range zero-filled, never
// read).  Thread t owns row group t / 8 and, of each tile, keys t % 8 + 8j
// for the scores and columns 4 (t % 8) + 32c for the output: the 8 threads
// of a row group reduce a row's max with 3 shuffles, and each thread keeps
// its rows' m, its share of l and its columns of the accumulator in
// registers.  The scores are a register-tiled product (TR rows x BK / 8
// keys a thread, 4 elements of D a step); p goes through shared memory,
// transposed, to the p . v product (TR rows x D / 8 columns a thread).
// The decode regime splits the keys as the bf16 decode kernels do (the
// host's _split_plan, from the capacity), and the last split of a (kv
// head, slot) merges the partials in split order within the launch, so
// the bits do not depend on which block ran first.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// The instantiations, one list each, which paddle_tpu_torch/ops/_simt.py
// admits (a CPU test parses these lines against its admission list):
// (q type, kv type) of the decode and paged kernels, and their head dims.
#define SIMT_KV_PAIRS(X) X(float, float) X(__half, __half) X(__half, float) X(float, int8_t) X(__half, int8_t)
#define SIMT_KV_DIMS(X) X(64) X(128) X(256)

namespace attention_simt {

constexpr int kThreads = 128;
constexpr int kDecRows = 16;    // decode regime: rows a block (every row of a kv head)
constexpr int kChunkRows = 64;  // otherwise
constexpr int kMaxSplits = 64;  // decode regime: most key splits of a launch
constexpr int kSplitUnit = 64;  // the host's split length is a multiple of this
constexpr float kNegInf = -1e30f;  // finite, as the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

template <class T>
constexpr int type_code();
template <>
constexpr int type_code<float>() { return 0; }
template <>
constexpr int type_code<__half>() { return 1; }
template <>
constexpr int type_code<int8_t>() { return 2; }

// ------------------------------------------------------------ conversions

// Four consecutive elements (shared or global memory) as f32.
__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 ld4(const __half* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 ld4(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4((float)c.x, (float)c.y, (float)c.z, (float)c.w);
}

__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void st4(__half* p, float4 v) {
  __half2 a = __floats2half2_rn(v.x, v.y), b = __floats2half2_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// p rounded to the type of the p . v product's left operand, kept in f32.
template <class T>
struct Round;
template <>
struct Round<float> {
  static __device__ __forceinline__ float f(float x) { return x; }
};
template <>
struct Round<__half> {
  static __device__ __forceinline__ float f(float x) { return __half2float(__float2half_rn(x)); }
};
template <>
struct Round<__nv_bfloat16> {
  static __device__ __forceinline__ float f(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

// The type p is rounded to: v's, or bf16 for an int8 cache (the reference
// widens int8 to bf16).
template <class TKV>
struct PType {
  using T = TKV;
};
template <>
struct PType<int8_t> {
  using T = __nv_bfloat16;
};

// --------------------------------------------------------------- copies

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, asynchronously; zeros when !valid,
// without reading src.
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------- key layouts

// Where key kpos of slot b and kv head kvh starts (element offset of its D
// values); int8 scales sit at elem / D.
// Paged: a pool [P, Hkv, ps, D] behind page tables [B, M].
struct PagedRows {
  const int* tbl;
  int Hkv, ps, M;
  __host__ __device__ __forceinline__ int capacity() const { return M * ps; }
  __device__ __forceinline__ size_t elem(int b, int kvh, int kpos, int D) const {
    const int page = __ldg(tbl + (size_t)b * M + kpos / ps);
    return (((size_t)page * Hkv + kvh) * ps + kpos % ps) * D;
  }
};

// Static: a head-major [B, Hkv, L, D] cache.
struct StaticRows {
  int Hkv, L;
  __host__ __device__ __forceinline__ int capacity() const { return L; }
  __device__ __forceinline__ size_t elem(int b, int kvh, int kpos, int D) const {
    return (((size_t)b * Hkv + kvh) * L + kpos) * D;
  }
};

struct Params {
  const void* q;           // [B, S, H, D] view: heads D apart, q_ss, q_sb
  const void* k;           // rows of D (a Rows layout)
  const void* v;
  const float* ks;         // int8: one f32 a row
  const float* vs;
  const int* lengths;      // [B] (= offset + S): row s sees keys [0, len - S + s]
  void* out;               // [B, S, H, D] contiguous, q's type
  float* part;             // decode regime, splits > 1: the split partials
  int* ticket;             // [B * Hkv], zero between launches
  long long q_sb, q_ss;
  int B, S, H, Hkv, rep;
  float scale_log2;        // scale * log2(e)
  int splits, split_keys;  // decode regime
};

// Shared memory of one block: q rows in f32, a two-stage ring of K and V
// tiles in the storage type (rows padded by 16 bytes, which puts the
// rows that neighbouring threads read in different banks), int8 scales, and
// p transposed.
template <int D, int RT, class TKV>
struct Layout {
  static constexpr int BK = D <= 128 ? 64 : 32;
  static constexpr int QS = D + 4;
  static constexpr int KS = D + 16 / (int)sizeof(TKV);
  static constexpr int PS = RT + 4;
  static constexpr size_t kv_bytes = (size_t)BK * KS * sizeof(TKV);
  static constexpr size_t off_k = (size_t)RT * QS * 4;
  static constexpr size_t off_v = off_k + 2 * kv_bytes;
  static constexpr size_t off_sc = off_v + 2 * kv_bytes;  // [stage][k, v][BK]
  static constexpr size_t off_p = off_sc + 4 * BK * 4;
  static constexpr size_t off_flag = off_p + (size_t)BK * PS * 4;
  static constexpr size_t bytes = off_flag + 16;
};

// Row i of this thread's TR rows within the block's RT (row group g =
// thread / 8).  At TR = 4, rows come in pairs {x, x + 8} (i = 0, 1 and
// 2, 3) with bit 3 of x clear; four neighbouring groups take neighbouring
// rows.
template <int TR>
__device__ __forceinline__ int row_of(int g, int i) {
  if constexpr (TR == 1) return g;
  return (g & 7) + 8 * (i & 1) + 16 * ((g >> 3) + 2 * (i >> 1));
}

__device__ __forceinline__ float max8(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}
__device__ __forceinline__ float sum8(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

// ------------------------------------------------------------------ body

// Block (split or row tile, kv head, slot).  RT == kDecRows is the decode
// regime (blockIdx.x the key split).
template <int D, int RT, class TQ, class TKV, class Rows>
__global__ void __launch_bounds__(kThreads) simt_attention(const Params p, const Rows rows) {
  using L = Layout<D, RT, TKV>;
  using TP = typename PType<TKV>::T;
  constexpr int BK = L::BK, QS = L::QS, KS = L::KS, PS = L::PS;
  constexpr int TR = RT / 16, NK = BK / 8, NC = D / 32;
  constexpr bool QUANT = std::is_same<TKV, int8_t>::value;
  constexpr bool SPLIT = RT == kDecRows;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  TKV* kt0 = reinterpret_cast<TKV*>(smem + L::off_k);
  TKV* vt0 = reinterpret_cast<TKV*>(smem + L::off_v);
  float* sc = reinterpret_cast<float*>(smem + L::off_sc);
  float* pt = reinterpret_cast<float*>(smem + L::off_p);
  int* flag = reinterpret_cast<int*>(smem + L::off_flag);

  const int t = threadIdx.x, g = t >> 3, l8 = t & 7;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int R = p.S * p.rep;
  // row tiles of a causal walk, the longest first
  const int tile = SPLIT ? 0 : gridDim.x - 1 - blockIdx.x;
  const int r0 = tile * RT, live = min(RT, R - r0);
  const int len = p.lengths[b];
  const int cap = rows.capacity();
  const auto row_end = [&](int r) {  // keys [0, end) are visible to row r
    return max(0, min(len - p.S + r / p.rep + 1, cap));
  };
  const int kmax = row_end(r0 + live - 1);  // the last row sees the most
  int kbeg = 0, kend = kmax;
  if constexpr (SPLIT) {
    kbeg = blockIdx.x * p.split_keys;
    kend = min(kmax, kbeg + p.split_keys);
  }
  const int ntiles = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;

  int rr[TR], rend[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    rr[i] = row_of<TR>(g, i);
    rend[i] = rr[i] < live ? row_end(r0 + rr[i]) : 0;
  }
  // the decode regime skips the products of padding rows
  const bool act = TR > 1 || rr[0] < live;

  // q rows -> f32 in shared memory (padding rows zero)
  const TQ* qg = static_cast<const TQ*>(p.q);
  for (int idx = t; idx < RT * D / 4; idx += kThreads) {
    const int r = idx / (D / 4), c = (idx % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < live) {
      const int rg = r0 + r, s = rg / p.rep, h = kvh * p.rep + rg % p.rep;
      x = ld4(qg + (size_t)b * p.q_sb + (size_t)s * p.q_ss + (size_t)h * D + c);
    }
    st4(qs + r * QS + c, x);
  }

  const TKV* kg = static_cast<const TKV*>(p.k);
  const TKV* vg = static_cast<const TKV*>(p.v);
  const auto load = [&](int j) {
    const int kb = kbeg + j * BK, stage = j & 1;
    constexpr int CH = D * (int)sizeof(TKV) / 16, EL = 16 / (int)sizeof(TKV);
    TKV* kd = kt0 + stage * BK * KS;
    TKV* vd = vt0 + stage * BK * KS;
    for (int idx = t; idx < BK * CH; idx += kThreads) {
      const int r = idx / CH, c = (idx % CH) * EL, kpos = kb + r;
      const bool ok = kpos < kend;
      const size_t e = ok ? rows.elem(b, kvh, kpos, D) : 0;
      cp16(kd + r * KS + c, kg + e + c, ok);
      cp16(vd + r * KS + c, vg + e + c, ok);
    }
    if constexpr (QUANT) {
      for (int r = t; r < BK; r += kThreads) {
        const int kpos = kb + r;
        const bool ok = kpos < kend;
        const size_t row = ok ? rows.elem(b, kvh, kpos, D) / D : 0;
        cp4(sc + (2 * stage) * BK + r, p.ks + row, ok);
        cp4(sc + (2 * stage + 1) * BK + r, p.vs + row, ok);
      }
    }
    cp_commit();
  };

  float o[TR][NC][4];
  float m[TR], lp[TR];  // running max (base 2) and this thread's share of l
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = kNegInf;
    lp[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][c][e] = 0.f;
  }

  if (ntiles > 0) load(0);
  for (int j = 0; j < ntiles; ++j) {
    if (j + 1 < ntiles) {
      load(j + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int stage = j & 1, kb = kbeg + j * BK;
    const TKV* kt = kt0 + stage * BK * KS;
    const TKV* vt = vt0 + stage * BK * KS;

    float s[TR][NK];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int n = 0; n < NK; ++n) s[i][n] = 0.f;
    if (act) {
#pragma unroll 2
      for (int d = 0; d < D; d += 4) {
        float4 qv[TR];
#pragma unroll
        for (int i = 0; i < TR; ++i) qv[i] = *reinterpret_cast<const float4*>(qs + rr[i] * QS + d);
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          const float4 kv = ld4(kt + (l8 + 8 * n) * KS + d);
#pragma unroll
          for (int i = 0; i < TR; ++i) {
            float a = s[i][n];
            a = fmaf(qv[i].x, kv.x, a);
            a = fmaf(qv[i].y, kv.y, a);
            a = fmaf(qv[i].z, kv.z, a);
            s[i][n] = fmaf(qv[i].w, kv.w, a);
          }
        }
      }
    }

    // the online softmax
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        const int key_pos = kb + l8 + 8 * n;
        float x = s[i][n] * p.scale_log2;
        if constexpr (QUANT) x *= sc[(2 * stage) * BK + l8 + 8 * n];
        if (key_pos >= kend || key_pos >= rend[i]) x = kNegInf;
        s[i][n] = x;
        mx = fmaxf(mx, x);
      }
      mx = max8(mx);
      const float m_new = fmaxf(m[i], mx);
      const float mu = m_new == kNegInf ? 0.f : m_new;
      const float corr = exp2f(m[i] - mu);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        s[i][n] = exp2f(s[i][n] - mu);
        sum += s[i][n];
      }
      lp[i] = lp[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][c][e] *= corr;
      if constexpr (QUANT) {
#pragma unroll
        for (int n = 0; n < NK; ++n) s[i][n] *= sc[(2 * stage + 1) * BK + l8 + 8 * n];
      }
    }
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int n = 0; n < NK; ++n) pt[(l8 + 8 * n) * PS + rr[i]] = Round<TP>::f(s[i][n]);
    __syncthreads();
    if (act) {
      const int nk = min(BK, kend - kb);
      for (int kk = 0; kk < nk; ++kk) {
        float pr[TR];
#pragma unroll
        for (int i = 0; i < TR; ++i) pr[i] = pt[kk * PS + rr[i]];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 vv = ld4(vt + kk * KS + 4 * l8 + 32 * c);
#pragma unroll
          for (int i = 0; i < TR; ++i) {
            o[i][c][0] = fmaf(pr[i], vv.x, o[i][c][0]);
            o[i][c][1] = fmaf(pr[i], vv.y, o[i][c][1]);
            o[i][c][2] = fmaf(pr[i], vv.z, o[i][c][2]);
            o[i][c][3] = fmaf(pr[i], vv.w, o[i][c][3]);
          }
        }
      }
    }
    __syncthreads();  // p and the stage are rewritten next
  }
  float lrow[TR];  // the row's l
#pragma unroll
  for (int i = 0; i < TR; ++i) lrow[i] = sum8(lp[i]);

  TQ* out = static_cast<TQ*>(p.out);
  const auto out_at = [&](int r) {  // row r of (kv head, slot): position r / rep
    const int s = r / p.rep, h = kvh * p.rep + r % p.rep;
    return out + ((size_t)(b * p.S + s) * p.H + h) * D;
  };
  if (!SPLIT || p.splits == 1) {
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      if (rr[i] >= live) continue;
      const float inv = 1.f / (lrow[i] <= 0.f ? 1.f : lrow[i]);
      TQ* dst = out_at(r0 + rr[i]);
#pragma unroll
      for (int c = 0; c < NC; ++c)
        st4(dst + 4 * l8 + 32 * c,
            make_float4(o[i][c][0] * inv, o[i][c][1] * inv, o[i][c][2] * inv, o[i][c][3] * inv));
    }
    return;
  }

  // split-K (decode regime, TR = 1): this split's (m, l, acc), then the
  // last split of the (kv head, slot) to arrive merges them in split order
  constexpr int PR = D + 2;
  const size_t split_stride = (size_t)p.B * p.Hkv * kDecRows * PR;
  const size_t mine = ((size_t)b * p.Hkv + kvh) * kDecRows * PR + (size_t)rr[0] * PR;
  float* part = p.part + (size_t)blockIdx.x * split_stride + mine;
  if (l8 == 0) {
    part[0] = m[0];
    part[1] = lrow[0];
  }
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[2 + 4 * l8 + 32 * c + e] = o[0][c][e];
  __threadfence();
  __syncthreads();
  if (t == 0) {
    int* tk = p.ticket + (size_t)b * p.Hkv + kvh;
    const int last = atomicAdd(tk, 1) == p.splits - 1;
    if (last) *tk = 0;  // every split has arrived: reset for the next launch
    *flag = last;
  }
  __syncthreads();
  if (!*flag || rr[0] >= live) return;
  __threadfence();
  const float* base = p.part + mine;
  float top = kNegInf;
  for (int sp = 0; sp < p.splits; ++sp) top = fmaxf(top, __ldcg(base + sp * split_stride));
  const float mu = top == kNegInf ? 0.f : top;
  float l = 0.f, acc[NC][4];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  for (int sp = 0; sp < p.splits; ++sp) {
    const float* src = base + sp * split_stride;
    const float ms = __ldcg(src);
    const float w = ms == kNegInf ? 0.f : exp2f(ms - mu);
    l += w * __ldcg(src + 1);
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] += w * __ldcg(src + 2 + 4 * l8 + 32 * c + e);
  }
  const float inv = 1.f / (l <= 0.f ? 1.f : l);
  TQ* dst = out_at(rr[0]);
#pragma unroll
  for (int c = 0; c < NC; ++c)
    st4(dst + 4 * l8 + 32 * c, make_float4(acc[c][0] * inv, acc[c][1] * inv, acc[c][2] * inv,
                                           acc[c][3] * inv));
}

// ------------------------------------------------------------------ host

template <int D, int RT, class TQ, class TKV, class Rows>
cudaError_t run(const Params& p, const Rows& rows, dim3 grid, cudaStream_t st) {
  const auto kernel = simt_attention<D, RT, TQ, TKV, Rows>;
  const int smem = (int)Layout<D, RT, TKV>::bytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, st>>>(p, rows);
  return cudaGetLastError();
}

template <class TQ, class TKV, class Rows>
cudaError_t launch_kv_types(const Params& p, const Rows& rows, int D, cudaStream_t st) {
  if (p.S * p.rep <= kDecRows) {
    const dim3 grid(p.splits, p.Hkv, p.B);
#define SIMT_DEC(DD) \
  if (D == DD) return run<DD, kDecRows, TQ, TKV, Rows>(p, rows, grid, st);
    SIMT_KV_DIMS(SIMT_DEC)
#undef SIMT_DEC
  } else {
    const dim3 grid((p.S * p.rep + kChunkRows - 1) / kChunkRows, p.Hkv, p.B);
#define SIMT_CHUNK(DD) \
  if (D == DD) return run<DD, kChunkRows, TQ, TKV, Rows>(p, rows, grid, st);
    SIMT_KV_DIMS(SIMT_CHUNK)
#undef SIMT_CHUNK
  }
  return cudaErrorInvalidValue;
}

// Decode and paged: check the shape and the split plan (splits and
// p.split_keys from the host's _split_plan), pick the instantiation of
// (q type, kv type, D) and the regime, and launch.
template <class Rows>
cudaError_t launch_kv(Params p, const Rows& rows, int D, int q_type, int kv_type,
                      cudaStream_t st) {
  const int cap = rows.capacity();
  if (p.B <= 0 || p.S <= 0 || p.Hkv <= 0 || p.H % p.Hkv != 0 || cap <= 0 || p.B > 65535 ||
      p.Hkv > 65535 || !p.lengths)
    return cudaErrorInvalidValue;
  p.rep = p.H / p.Hkv;
  if (p.S * p.rep <= kDecRows) {
    if (p.splits <= 0 || p.splits > kMaxSplits || p.split_keys <= 0 ||
        p.split_keys % kSplitUnit != 0 || (long long)p.splits * p.split_keys < cap ||
        (p.splits > 1 && (!p.part || !p.ticket)))
      return cudaErrorInvalidValue;
  } else {
    p.splits = 1;
  }
#define SIMT_PAIR(TQ, TKV)                                             \
  if (q_type == type_code<TQ>() && kv_type == type_code<TKV>()) \
    return launch_kv_types<TQ, TKV>(p, rows, D, st);
  SIMT_KV_PAIRS(SIMT_PAIR)
#undef SIMT_PAIR
  return cudaErrorInvalidValue;
}

}  // namespace attention_simt
