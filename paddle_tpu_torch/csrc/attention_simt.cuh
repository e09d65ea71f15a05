// Attention on the CUDA cores in f32 arithmetic, for float32 and float16
// storage: the device code of the four attention forward kernels at those
// types (attention_simt_decode.cu, attention_simt_paged.cu,
// attention_simt_flash.cu and attention_simt_encoder.cu at float32 only).
// The bf16 kernels (kv_attention.cuh, wgmma_attention.cuh,
// encoder_wgmma.cuh), and the flash and encoder forwards at float16
// (flash_attention.cu, encoder_attention.cu), run on the tensor cores; this
// body runs every product as f32 FFMA.
//
// Replaces, at float32 (and decode and paged at float16):
// paddle_tpu/ops/decode_attention.py `_decode_kernel` and `_paged_kernel`,
// paddle_tpu/ops/flash_attention.py `_fwd_kernel` and
// paddle_tpu/ops/encoder_attention.py `_fwd_kernel`.  The
// reference's kernels take any float type and type their outputs by q.
//
// What they compute, per type (the reference kernels' rounding):
//  * q . k^T with f32 accumulation of the stored values (a product of two
//    float16 values, or of a float16 and a bf16 value, is exact in f32);
//    the score scale after the dot.
//  * p rounded to v's type before p . v (a no-op at float32): the online
//    softmax's unnormalised p for decode, paged and flash, the normalised
//    and dropped-out p for the encoder, whose softmax is whole-row (its max
//    and sum first, in a first pass over the keys).
//  * int8 caches (decode and paged): K and V widened exactly, the k-scale
//    on the scores after the dot, the v-scale on p after l, and p rounded
//    to bf16 whatever q's type, as the reference widens int8 to bf16.
//  * outputs in q's type, lse (flash, encoder) in f32 natural-log units.
// Scores run in base-2 units (scale * log2(e)), as the bf16 kernels' do.
//
// Why CUDA cores and not the tensor cores: the reference holds its f32
// kernels within 2e-5 of dense math, which single-pass TF32 or bf16 (about
// three decimal digits) cannot meet.  The flash backward at float32 has
// since moved to the tensor cores as split-bf16 products
// (flash_attention_bwd.cu: each f32 operand two bf16 planes, hi and lo,
// three bf16 products a product, about 16 bits of each operand, within
// 3.2e-5 of max against an f32 plain backward); these forwards can take
// the same split, and float16 decode and paged the 16-bit bodies (ROADMAP;
// float16 flash moved to flash_attention.cu, the float16 encoder to
// encoder_attention.cu).
//
// What bounds them on the H100: decode ticks read every valid K/V row once
// at a few FLOP a byte (bytes); prefill chunks, flash and the encoder do
// 4 * D FLOP a visible (query, key) pair, far past the 67 TFLOP/s f32 FFMA
// ridge (operations).
//
// The design: one body for every entry, 128 threads a block, a block owns
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
// the bits do not depend on which block ran first.  Encoder dropout draws
// Philox (philox.cuh): a thread's rows come in pairs {x, x + 8} and its
// keys in pairs {c, c + 8}, so each of its calls serves four of its own
// elements.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "philox.cuh"

// The instantiations, one list each, which paddle_tpu_torch/ops/_simt.py
// admits (a CPU test parses these lines against its admission list):
// (q type, kv type) of the decode and paged kernels, and their head dims;
// the types (q = k = v) and head dims of flash and of the encoder (float16
// flash and encoder run the tensor-core kernels, flash_attention.cu and
// encoder_attention.cu).
#define SIMT_KV_PAIRS(X) X(float, float) X(__half, __half) X(__half, float) X(float, int8_t) X(__half, int8_t)
#define SIMT_KV_DIMS(X) X(64) X(128) X(256)
#define SIMT_FLASH_TYPES(X) X(float)
#define SIMT_ENCODER_TYPES(X) X(float)
#define SIMT_FLASH_DIMS(X) X(64) X(128) X(256)
#define SIMT_ENCODER_DIMS(X) X(64) X(128)

namespace attention_simt {

constexpr int kThreads = 128;
constexpr int kDecRows = 16;    // decode regime: rows a block (every row of a kv head)
constexpr int kChunkRows = 64;  // otherwise
constexpr int kMaxSplits = 64;  // decode regime: most key splits of a launch
constexpr int kSplitUnit = 64;  // the host's split length is a multiple of this
constexpr float kNegInf = -1e30f;  // finite, as the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

// Sequences: k/v [B, Sk, H, D] views, heads D apart, positions ss and
// batches sb elements apart (k and v share the strides).
struct SeqRows {
  long long sb, ss;
  int Sk;
  __host__ __device__ __forceinline__ int capacity() const { return Sk; }
  __device__ __forceinline__ size_t elem(int b, int h, int kpos, int D) const {
    return (size_t)(b * sb + kpos * ss) + (size_t)h * D;
  }
};

struct Params {
  const void* q;           // [B, S, H, D] view: heads D apart, q_ss, q_sb
  const void* k;           // rows of D (a Rows layout)
  const void* v;
  const float* ks;         // int8: one f32 a row
  const float* vs;
  const int* lengths;      // [B] (= offset + S), or null: every slot len_all keys
  void* out;               // [B, S, H, D] contiguous, q's type
  float* lse;              // [B * H, S] natural-log logsumexp, or null
  float* part;             // decode regime, splits > 1: the split partials
  int* ticket;             // [B * Hkv], zero between launches
  long long q_sb, q_ss;
  int B, S, H, Hkv, rep;
  int len_all;
  int causal;              // row s sees keys [0, len - S + s]; else [0, len)
  float scale_log2;        // scale * log2(e)
  int splits, split_keys;  // decode regime
  const int* seed;         // encoder dropout: the int32 [2] seed pair, or null
  uint32_t thresh;         // keep iff the element's Philox word < thresh
  float inv_keep;          // 1 / (1 - rate)
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
// 2, 3) with bit 3 of x clear, as one Philox call of the encoder mask
// serves; four neighbouring groups take neighbouring rows.
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
// regime (blockIdx.x the key split); TWO is the encoder's whole-row
// softmax (a statistics pass, then the normalised p).
template <int D, int RT, class TQ, class TKV, class Rows, bool TWO>
__global__ void __launch_bounds__(kThreads) simt_attention(const Params p, const Rows rows) {
  using L = Layout<D, RT, TKV>;
  using TP = typename PType<TKV>::T;
  constexpr int BK = L::BK, QS = L::QS, KS = L::KS, PS = L::PS;
  constexpr int TR = RT / 16, NK = BK / 8, NC = D / 32;
  constexpr bool QUANT = std::is_same<TKV, int8_t>::value;
  constexpr bool SPLIT = RT == kDecRows;
  static_assert(!TWO || (TR == 4 && BK == 64), "the encoder's Philox pairs need 64-row tiles");
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
  const int tile = SPLIT ? 0 : (p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
  const int r0 = tile * RT, live = min(RT, R - r0);
  const int len = p.lengths ? p.lengths[b] : p.len_all;
  const int cap = rows.capacity();
  const auto row_end = [&](int r) {  // keys [0, end) are visible to row r
    const int e = p.causal ? len - p.S + r / p.rep + 1 : len;
    return max(0, min(e, cap));
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
  const auto load = [&](int j, bool with_v) {
    const int kb = kbeg + j * BK, stage = j & 1;
    constexpr int CH = D * (int)sizeof(TKV) / 16, EL = 16 / (int)sizeof(TKV);
    TKV* kd = kt0 + stage * BK * KS;
    TKV* vd = vt0 + stage * BK * KS;
    for (int idx = t; idx < BK * CH; idx += kThreads) {
      const int r = idx / CH, c = (idx % CH) * EL, kpos = kb + r;
      const bool ok = kpos < kend;
      const size_t e = ok ? rows.elem(b, kvh, kpos, D) : 0;
      cp16(kd + r * KS + c, kg + e + c, ok);
      if (with_v) cp16(vd + r * KS + c, vg + e + c, ok);
    }
    if constexpr (QUANT) {
      for (int r = t; r < BK; r += kThreads) {
        const int kpos = kb + r;
        const bool ok = kpos < kend;
        const size_t row = ok ? rows.elem(b, kvh, kpos, D) / D : 0;
        cp4(sc + (2 * stage) * BK + r, p.ks + row, ok);
        if (with_v) cp4(sc + (2 * stage + 1) * BK + r, p.vs + row, ok);
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
  float lrow[TR];  // the row's l (TWO: after the statistics pass)
  const uint2 key = (TWO && p.seed) ? philox::key(p.seed) : make_uint2(0u, 0u);
  const int bh = b * p.H + kvh;  // the encoder's (batch, head): rep = 1

  for (int pass = TWO ? 0 : 1; pass < 2; ++pass) {
    const bool pv = pass == 1;  // pass 0: the encoder's max and sum only
    if (ntiles > 0) load(0, pv);
    for (int j = 0; j < ntiles; ++j) {
      if (j + 1 < ntiles) {
        load(j + 1, pv);
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
        if (!pv) {  // statistics pass
          const float m_new = fmaxf(m[i], mx);
          const float mu = m_new == kNegInf ? 0.f : m_new;
          float sum = 0.f;
#pragma unroll
          for (int n = 0; n < NK; ++n) sum += exp2f(s[i][n] - mu);
          lp[i] = lp[i] * exp2f(m[i] - mu) + sum;
          m[i] = m_new;
          continue;
        }
        if constexpr (TWO) {  // normalised p = e / l, the row's m and l known
          const float mu = m[i] == kNegInf ? 0.f : m[i];
          const float inv_l = lrow[i] > 0.f ? 1.f / lrow[i] : 0.f;  // 0: a padding row
#pragma unroll
          for (int n = 0; n < NK; ++n) s[i][n] = exp2f(s[i][n] - mu) * inv_l;
        } else {  // online softmax
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
      }
      if (!pv) {
        __syncthreads();  // the stage is refilled two tiles on
        continue;
      }
      if constexpr (TWO) {
        if (p.seed) {  // dropout: one Philox call per (row pair, key pair)
#pragma unroll
          for (int i = 0; i < TR; i += 2)
#pragma unroll
            for (int n = 0; n < NK; n += 2) {
              const uint4 w = philox::encoder_words(key, bh, r0 + rr[i], kb + l8 + 8 * n);
              s[i][n] = w.x < p.thresh ? s[i][n] * p.inv_keep : 0.f;
              s[i][n + 1] = w.y < p.thresh ? s[i][n + 1] * p.inv_keep : 0.f;
              s[i + 1][n] = w.z < p.thresh ? s[i + 1][n] * p.inv_keep : 0.f;
              s[i + 1][n + 1] = w.w < p.thresh ? s[i + 1][n + 1] * p.inv_keep : 0.f;
            }
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
    if (!pv || !TWO) {
#pragma unroll
      for (int i = 0; i < TR; ++i) lrow[i] = sum8(lp[i]);
    }
  }

  // lse (flash, encoder): m + log2(l), in natural-log units
  if (p.lse && l8 == 0) {
#pragma unroll
    for (int i = 0; i < TR; ++i)
      if (rr[i] < live) {
        const int r = r0 + rr[i];
        p.lse[(size_t)bh * p.S + r] = (m[i] + log2f(lrow[i])) * kLn2;
      }
  }

  TQ* out = static_cast<TQ*>(p.out);
  const auto out_at = [&](int r) {  // row r of (kv head, slot): position r / rep
    const int s = r / p.rep, h = kvh * p.rep + r % p.rep;
    return out + ((size_t)(b * p.S + s) * p.H + h) * D;
  };
  if (!SPLIT || p.splits == 1) {
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      if (rr[i] >= live) continue;
      const float inv = TWO ? 1.f : 1.f / (lrow[i] <= 0.f ? 1.f : lrow[i]);
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

template <int D, int RT, class TQ, class TKV, class Rows, bool TWO>
cudaError_t run(const Params& p, const Rows& rows, dim3 grid, cudaStream_t st) {
  const auto kernel = simt_attention<D, RT, TQ, TKV, Rows, TWO>;
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
  if (D == DD) return run<DD, kDecRows, TQ, TKV, Rows, false>(p, rows, grid, st);
    SIMT_KV_DIMS(SIMT_DEC)
#undef SIMT_DEC
  } else {
    const dim3 grid((p.S * p.rep + kChunkRows - 1) / kChunkRows, p.Hkv, p.B);
#define SIMT_CHUNK(DD) \
  if (D == DD) return run<DD, kChunkRows, TQ, TKV, Rows, false>(p, rows, grid, st);
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
      p.Hkv > 65535)
    return cudaErrorInvalidValue;
  p.rep = p.H / p.Hkv;
  p.causal = 1;
  p.lse = nullptr;
  p.seed = nullptr;
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

// Flash (TWO = false) and encoder (TWO = true): q [B, S, H, D] and k/v
// [B, Sk, H, D] of one type; one 64-row tile a block.
template <bool TWO, class T>
cudaError_t launch_seq_type(const Params& p, const SeqRows& rows, int D, cudaStream_t st) {
  const dim3 grid((p.S + kChunkRows - 1) / kChunkRows, p.H, p.B);
  if constexpr (TWO) {
#define SIMT_ENC(DD) \
  if (D == DD) return run<DD, kChunkRows, T, T, SeqRows, true>(p, rows, grid, st);
    SIMT_ENCODER_DIMS(SIMT_ENC)
#undef SIMT_ENC
  } else {
#define SIMT_FLASH(DD) \
  if (D == DD) return run<DD, kChunkRows, T, T, SeqRows, false>(p, rows, grid, st);
    SIMT_FLASH_DIMS(SIMT_FLASH)
#undef SIMT_FLASH
  }
  return cudaErrorInvalidValue;
}

template <bool TWO>
cudaError_t launch_seq(Params p, const SeqRows& rows, int D, int type, cudaStream_t st) {
  if (p.B <= 0 || p.S <= 0 || p.H <= 0 || rows.Sk <= 0 || p.B > 65535 || p.H > 65535 ||
      (p.causal && p.S > rows.Sk) || (TWO && p.S != rows.Sk))
    return cudaErrorInvalidValue;
  p.Hkv = p.H;
  p.rep = 1;
  p.lengths = nullptr;
  p.len_all = rows.Sk;
  p.splits = 1;
  p.ks = p.vs = nullptr;
#define SIMT_TYPE(T) \
  if (type == type_code<T>()) return launch_seq_type<TWO, T>(p, rows, D, st);
  if constexpr (TWO) {
    SIMT_ENCODER_TYPES(SIMT_TYPE)
  } else {
    SIMT_FLASH_TYPES(SIMT_TYPE)
  }
#undef SIMT_TYPE
  return cudaErrorInvalidValue;
}

}  // namespace attention_simt
