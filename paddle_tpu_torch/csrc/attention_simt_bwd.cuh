// The encoder attention backward on the CUDA cores in f32 arithmetic, for
// float32 storage: the device code of attention_simt_encoder_bwd.cu.  The
// bf16 kernels (flash_attention_bwd.cu, encoder_attention_bwd.cu), both
// backwards at float16 (the same sources) and the flash backward at
// float32 (flash_attention_bwd.cu, as split-bf16 products) run on the
// tensor cores; this body runs every product as f32 FFMA, as the forward
// body attention_simt.cuh does.
//
// Replaces, at float32: paddle_tpu/ops/encoder_attention.py `_bwd_kernel`.
// It computes what that computes, with its rounding (a no-op at float32):
// P the whole-row softmax (from the forward's lse at S > 128, found in the
// block at S = 128), the mask regenerated from the seed pair (philox.cuh,
// the forward's map), P_d = where(keep, P / (1 - r), 0) NOT rounded for
// dV = P_d^T dO (the reference widens dO to f32), dP = where(keep, dO V^T
// / (1 - r), 0), dsum = rowsum(dP * P), dS = round(P (dP - dsum) * scale),
// dQ = dS K, dK = dS^T Q; every sum in f32, the outputs in q's type.
// Scores run in base-2 units (scale * log2(e)) against lse * log2(e).
//
// What bounds it on the H100: operations.  The least work is 5 products,
// 10 D FLOP a visible (query, key) pair, far past the 67 TFLOP/s f32 FFMA
// ridge; the reads (q, k, v, dO, lse) and writes (dq, dk, dv) are a few
// hundred MB at the training shapes.
//
// The design: a "row pass" owns 32 query rows and walks key tiles (dQ), a
// "column pass" owns 32 key rows and walks query tiles (dK and dV), each
// its own block, each writing only its own rows: no atomics, so the bits
// do not depend on block order.  The price is S and dP computed in both
// passes, and the row pass walks twice (dsum first, in the reference's
// order, then dQ): 18 D FLOP a pair.  128 threads a block; thread t owns
// own rows (t / 8) % 8 + 16 (t / 64) + {0, 8} and, of each walked tile,
// rows t % 8 + 8n (n < 4): the 8 threads of a row group reduce a row with
// 3 shuffles, and an own pair {x, x + 8} with a walked pair {c, c + 8} is
// one Philox call of the mask.  The own rows sit in shared memory in f32,
// the walked tiles stream through a two-stage cp.async ring in the storage
// type, and dS (and, in the column pass, the P_d that dV takes) goes
// through shared memory, transposed, to the output products.
//
// Why 32-row tiles (and not the forward's 64): the column pass holds dK and
// dV, 2 rows x D / 8 columns each a thread, 64 f32 registers at D = 128;
// 64 own keys would double that to 128 before the scores, and the 64-row
// tiles' shared memory (about 190 KB at f32) would leave one block of four
// warps an SM.  At 32 rows a block takes 109 KB at f32 (D = 128), so two
// blocks share an SM.
//
// The regimes: at S = 128 one block holds the whole head (its four row
// passes, the rows' lse and dsum kept in shared memory, then its four
// column passes), needing nothing from the forward; at S > 128 a row
// kernel reads the forward's lse, writes each row's (lse * log2(e), dsum)
// to `stats`, and a column kernel reads them.
#pragma once

#include "attention_simt.cuh"

// The instantiations, one list each, which paddle_tpu_torch/ops/_simt.py
// admits for "encoder_bwd" (a CPU test parses these lines against its
// lists): the storage types (q = k = v = dO) and head dims (float16 runs
// the tensor-core kernel, encoder_attention_bwd.cu).
#define SIMT_BWD_ENCODER_TYPES(X) X(float)
#define SIMT_BWD_ENCODER_DIMS(X) X(64) X(128)

namespace attention_simt_bwd {

using namespace attention_simt;

constexpr int kTile = 32;   // own rows a block, and rows a walked tile
constexpr int kHeadS = 128; // the whole-head regime

// A [B, S, H, D] view: heads D apart, positions ss and batches sb elements
// apart.
struct View {
  const void* p;
  long long sb, ss;
};

struct BwdParams {
  View q, k, v, dO;
  const float* lse;  // S > kHeadS: the forward's [B * H, S] natural-log lse
  float* stats;      // [2, B * H, Sq]: each row's lse * log2(e), then its dsum
  void* dq;          // [B, Sq, H, D] contiguous, q's type
  void* dk;          // [B, Sk, H, D] contiguous
  void* dv;
  int B, H, Sq, Sk;
  int causal;
  float scale;
  float scale_log2;  // scale * log2(e)
  const int* seed;   // dropout: the int32 [2] seed pair, or null
  uint32_t thresh;   // keep iff the element's Philox word < thresh
  float inv_keep;    // 1 / (1 - rate)
};

// Shared memory of one block: two own tensors of 32 rows in f32, a
// two-stage ring of two walked tiles in the storage type (rows padded by 16
// bytes, which puts the rows that neighbouring threads read in different
// banks), two transposed [walked][own] f32 buffers (dS; and the column
// pass's P for dV), and the whole-head regime's row statistics.
template <int D, class T>
struct BwdLayout {
  static constexpr int OS = D + 4;
  static constexpr int WS = D + 16 / (int)sizeof(T);
  static constexpr int PS = kTile + 4;
  static constexpr size_t own_bytes = (size_t)kTile * OS * 4;
  static constexpr size_t walk_bytes = (size_t)kTile * WS * sizeof(T);
  static constexpr size_t off_b = own_bytes;
  static constexpr size_t off_w = 2 * own_bytes;            // [stage][a, b]
  static constexpr size_t off_p = off_w + 4 * walk_bytes;   // [2][kTile][PS]
  static constexpr size_t off_st = off_p + 2 * (size_t)kTile * PS * 4;  // [2][kHeadS]
  static constexpr size_t bytes = off_st + 2 * (size_t)kHeadS * 4;
};

// Own row i (0, 1) of row group g: pairs {x, x + 8} with bit 3 of x clear.
__device__ __forceinline__ int own_row(int g, int i) { return (g & 7) + 8 * i + 16 * (g >> 3); }

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <class T>
__device__ __forceinline__ const T* row_ptr(const View& w, int b, int h, int pos, int D) {
  return static_cast<const T*>(w.p) + (size_t)(b * w.sb + pos * w.ss) + (size_t)h * D;
}

// Rows [r0, r0 + live) of a view -> f32 shared [kTile][OS], zeros past live.
template <int D, class T>
__device__ void load_own(float* dst, const View& w, int b, int h, int r0, int live) {
  constexpr int OS = BwdLayout<D, T>::OS;
  for (int idx = threadIdx.x; idx < kTile * D / 4; idx += kThreads) {
    const int r = idx / (D / 4), c = (idx % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < live) x = ld4(row_ptr<T>(w, b, h, r0 + r, D) + c);
    *reinterpret_cast<float4*>(dst + r * OS + c) = x;
  }
}

// Rows [w0, w0 + kTile) of a view -> shared [kTile][WS] in the storage type,
// asynchronously; rows at or past `end` zero-filled, never read.
template <int D, class T>
__device__ void load_walk(T* dst, const View& w, int b, int h, int w0, int end) {
  constexpr int WS = BwdLayout<D, T>::WS;
  constexpr int CH = D * (int)sizeof(T) / 16, EL = 16 / (int)sizeof(T);
  for (int idx = threadIdx.x; idx < kTile * CH; idx += kThreads) {
    const int r = idx / CH, c = (idx % CH) * EL, pos = w0 + r;
    const bool ok = pos < end;
    cp16(dst + r * WS + c, ok ? row_ptr<T>(w, b, h, pos, D) + c : static_cast<const T*>(w.p), ok);
  }
}

// The keep bits of one Philox call: own pair {x, x + 8} times walked pair
// {c, c + 8} of a thread, for query rows own (row pass) or walked (column
// pass).  keep[i][n] is own row i, walked row n.
__device__ __forceinline__ void keep_bits(bool (&keep)[2][4], const BwdParams& p, uint2 key, int bh,
                                          int own0, int walk0, bool own_is_query) {
#pragma unroll
  for (int n = 0; n < 4; n += 2) {
    const int wn = walk0 + 8 * n;  // walked rows l8 + 8n in pairs (n, n + 1)
    const uint4 w = own_is_query ? philox::encoder_words(key, bh, own0, wn)
                                 : philox::encoder_words(key, bh, wn, own0);
    // word 2 * (query is the +8 row) + (key is the +8 row)
    keep[0][n] = w.x < p.thresh;
    keep[0][n + 1] = (own_is_query ? w.y : w.z) < p.thresh;
    keep[1][n] = (own_is_query ? w.z : w.y) < p.thresh;
    keep[1][n + 1] = w.w < p.thresh;
  }
}

// ------------------------------------------------------------- row pass

// dQ of query rows [r0, r0 + kTile) of (b, h), walking key tiles twice:
// first for dsum = rowsum(dP * P) (and, when `lse` is null, the row's max
// and sum, online), which it writes to st_l / st_d; then for dS and dQ.
// st_l and st_d are this head's rows (global or shared).
template <int D, class T>
__device__ void row_pass(const BwdParams& p, unsigned char* smem, int b, int h, int r0,
                         float* st_l, float* st_d, const float* lse) {
  using L = BwdLayout<D, T>;
  constexpr int OS = L::OS, WS = L::WS, PS = L::PS, NC = D / 32;
  float* qa = reinterpret_cast<float*>(smem);
  float* da = reinterpret_cast<float*>(smem + L::off_b);
  T* ring = reinterpret_cast<T*>(smem + L::off_w);
  float* pb = reinterpret_cast<float*>(smem + L::off_p);

  const int t = threadIdx.x, g = t >> 3, l8 = t & 7;
  const int bh = b * p.H + h, off = p.Sk - p.Sq;
  const int live = min(kTile, p.Sq - r0);
  const auto row_end = [&](int i) {  // keys [0, end) are visible to query i
    return p.causal ? max(0, min(p.Sk, i + off + 1)) : p.Sk;
  };
  const int kend = row_end(r0 + live - 1);  // the last row sees the most
  const int ntiles = (kend + kTile - 1) / kTile;
  int rr[2], rend[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rr[i] = own_row(g, i);
    rend[i] = rr[i] < live ? row_end(r0 + rr[i]) : 0;
  }

  __syncthreads();  // the previous pass of this block is done with shared memory
  load_own<D, T>(qa, p.q, b, h, r0, live);
  load_own<D, T>(da, p.dO, b, h, r0, live);

  float lr[2] = {0.f, 0.f}, dr[2] = {0.f, 0.f};  // the rows' lse * log2(e), dsum
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rr[i] < live && lse) lr[i] = lse[(size_t)bh * p.Sq + r0 + rr[i]] * kLog2e;
  }
  const uint2 key = p.seed ? philox::key(p.seed) : make_uint2(0u, 0u);
  const auto load = [&](int j) {
    T* kd = ring + (size_t)(2 * (j & 1)) * kTile * WS;
    load_walk<D, T>(kd, p.k, b, h, j * kTile, kend);
    load_walk<D, T>(kd + kTile * WS, p.v, b, h, j * kTile, kend);
    cp_commit();
  };

  float acc[2][NC][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, lp[2] = {0.f, 0.f}, part[2] = {0.f, 0.f};

  for (int pass = 0; pass < 2; ++pass) {
    if (ntiles > 0) load(0);
    for (int j = 0; j < ntiles; ++j) {
      if (j + 1 < ntiles) {
        load(j + 1);
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      const int kb = j * kTile;
      const T* kt = ring + (size_t)(2 * (j & 1)) * kTile * WS;
      const T* vt = kt + kTile * WS;

      float s[2][4], dp[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int n = 0; n < 4; ++n) s[i][n] = dp[i][n] = 0.f;
#pragma unroll 2
      for (int d = 0; d < D; d += 4) {
        float4 qv[2], gv[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          qv[i] = *reinterpret_cast<const float4*>(qa + rr[i] * OS + d);
          gv[i] = *reinterpret_cast<const float4*>(da + rr[i] * OS + d);
        }
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const float4 kv = ld4(kt + (l8 + 8 * n) * WS + d);
          const float4 vv = ld4(vt + (l8 + 8 * n) * WS + d);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            s[i][n] = dot4(qv[i], kv, s[i][n]);
            dp[i][n] = dot4(gv[i], vv, dp[i][n]);
          }
        }
      }
      bool keep[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int n = 0; n < 4; ++n) keep[i][n] = true;
      if (p.seed) keep_bits(keep, p, key, bh, r0 + rr[0], kb + l8, true);

      if (pass == 0) {  // the statistics
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float x[4], dpd[4];
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const bool vis = kb + l8 + 8 * n < rend[i];
            x[n] = vis ? s[i][n] * p.scale_log2 : kNegInf;
            dpd[n] = keep[i][n] ? dp[i][n] * p.inv_keep : 0.f;
          }
          if (lse) {  // P known from the forward's lse
#pragma unroll
            for (int n = 0; n < 4; ++n)
              part[i] += x[n] == kNegInf ? 0.f : dpd[n] * exp2f(x[n] - lr[i]);
          } else {  // online: rowsum(dP * e) and rowsum(e) against the running max
            float mx = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
            mx = max8(mx);
            const float m_new = fmaxf(m[i], mx);
            const float mu = m_new == kNegInf ? 0.f : m_new;
            const float corr = exp2f(m[i] - mu);
            float se = 0.f, sde = 0.f;
#pragma unroll
            for (int n = 0; n < 4; ++n) {
              const float e = x[n] == kNegInf ? 0.f : exp2f(x[n] - mu);
              se += e;
              sde += dpd[n] * e;
            }
            lp[i] = lp[i] * corr + se;
            part[i] = part[i] * corr + sde;
            m[i] = m_new;
          }
        }
        __syncthreads();  // the stage is refilled two tiles on
        continue;
      }

      // dS, transposed to shared memory
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const bool vis = kb + l8 + 8 * n < rend[i];
          const float pr = vis ? exp2f(s[i][n] * p.scale_log2 - lr[i]) : 0.f;
          const float dpd = keep[i][n] ? dp[i][n] * p.inv_keep : 0.f;
          pb[(l8 + 8 * n) * PS + rr[i]] = Round<T>::f(pr * (dpd - dr[i]) * p.scale);
        }
      __syncthreads();
      const int nk = min(kTile, kend - kb);
      for (int kk = 0; kk < nk; ++kk) {
        float pr[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) pr[i] = pb[kk * PS + rr[i]];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 kv = ld4(kt + kk * WS + 4 * l8 + 32 * c);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            acc[i][c][0] = fmaf(pr[i], kv.x, acc[i][c][0]);
            acc[i][c][1] = fmaf(pr[i], kv.y, acc[i][c][1]);
            acc[i][c][2] = fmaf(pr[i], kv.z, acc[i][c][2]);
            acc[i][c][3] = fmaf(pr[i], kv.w, acc[i][c][3]);
          }
        }
      }
      __syncthreads();  // dS and the stage are rewritten next
    }
    if (pass == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float sum_de = sum8(part[i]);
        if (lse) {
          dr[i] = sum_de;
        } else {
          const float l = sum8(lp[i]);
          lr[i] = l > 0.f ? m[i] + log2f(l) : 0.f;
          dr[i] = l > 0.f ? sum_de / l : 0.f;
        }
        if (rr[i] >= live) lr[i] = dr[i] = 0.f;
      }
      if (l8 == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (rr[i] < live) {
            st_l[r0 + rr[i]] = lr[i];
            st_d[r0 + rr[i]] = dr[i];
          }
      }
    }
  }

  T* dq = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rr[i] >= live) continue;
    T* dst = dq + ((size_t)(b * p.Sq + r0 + rr[i]) * p.H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      st4(dst + 4 * l8 + 32 * c, make_float4(acc[i][c][0], acc[i][c][1], acc[i][c][2], acc[i][c][3]));
  }
}

// ---------------------------------------------------------- column pass

// dK and dV of key rows [c0, c0 + kTile) of (b, h), walking query tiles
// from the first that sees them; each query's lse * log2(e) and dsum from
// st_l / st_d (this head's rows, global or shared).
template <int D, class T>
__device__ void col_pass(const BwdParams& p, unsigned char* smem, int b, int h, int c0,
                         const float* st_l, const float* st_d) {
  using L = BwdLayout<D, T>;
  constexpr int OS = L::OS, WS = L::WS, PS = L::PS, NC = D / 32;
  float* ka = reinterpret_cast<float*>(smem);
  float* va = reinterpret_cast<float*>(smem + L::off_b);
  T* ring = reinterpret_cast<T*>(smem + L::off_w);
  float* pvb = reinterpret_cast<float*>(smem + L::off_p);  // P_d, for dV
  float* dsb = pvb + kTile * PS;                           // dS, for dK

  const int t = threadIdx.x, g = t >> 3, l8 = t & 7;
  const int bh = b * p.H + h, off = p.Sk - p.Sq;
  const int livek = min(kTile, p.Sk - c0);
  int qbeg = 0;
  if (p.causal) {  // the first query that sees key c0, down to a whole tile
    qbeg = max(0, c0 - off);
    qbeg -= qbeg % kTile;
  }
  const int ntiles = p.Sq > qbeg ? (p.Sq - qbeg + kTile - 1) / kTile : 0;
  int cc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) cc[i] = own_row(g, i);

  __syncthreads();  // the previous pass of this block is done with shared memory
  load_own<D, T>(ka, p.k, b, h, c0, livek);
  load_own<D, T>(va, p.v, b, h, c0, livek);
  const uint2 key = p.seed ? philox::key(p.seed) : make_uint2(0u, 0u);
  const auto load = [&](int j) {
    T* qd = ring + (size_t)(2 * (j & 1)) * kTile * WS;
    load_walk<D, T>(qd, p.q, b, h, qbeg + j * kTile, p.Sq);
    load_walk<D, T>(qd + kTile * WS, p.dO, b, h, qbeg + j * kTile, p.Sq);
    cp_commit();
  };
  // the walked queries' statistics, a tile ahead in registers
  const auto fetch = [&](int qb, float (&l)[4], float (&dd)[4]) {
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int x = qb + l8 + 8 * n;
      l[n] = x < p.Sq ? st_l[x] : 0.f;
      dd[n] = x < p.Sq ? st_d[x] : 0.f;
    }
  };
  float sl[4], sd[4], nl[4] = {0.f, 0.f, 0.f, 0.f}, nd[4] = {0.f, 0.f, 0.f, 0.f};
  fetch(qbeg, sl, sd);

  float dk[2][NC][4], dv[2][NC][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[i][c][e] = dv[i][c][e] = 0.f;

  if (ntiles > 0) load(0);
  for (int j = 0; j < ntiles; ++j) {
    const int qb = qbeg + j * kTile;
    if (j + 1 < ntiles) {
      load(j + 1);
      fetch(qb + kTile, nl, nd);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const T* qt = ring + (size_t)(2 * (j & 1)) * kTile * WS;
    const T* gt = qt + kTile * WS;

    float s[2][4], dp[2][4];  // own key i, walked query n
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < 4; ++n) s[i][n] = dp[i][n] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 kv[2], vv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        kv[i] = *reinterpret_cast<const float4*>(ka + cc[i] * OS + d);
        vv[i] = *reinterpret_cast<const float4*>(va + cc[i] * OS + d);
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float4 qv = ld4(qt + (l8 + 8 * n) * WS + d);
        const float4 gv = ld4(gt + (l8 + 8 * n) * WS + d);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          s[i][n] = dot4(kv[i], qv, s[i][n]);
          dp[i][n] = dot4(vv[i], gv, dp[i][n]);
        }
      }
    }
    bool keep[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < 4; ++n) keep[i][n] = true;
    if (p.seed) keep_bits(keep, p, key, bh, c0 + cc[0], qb + l8, false);

#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int x = qb + l8 + 8 * n, kpos = c0 + cc[i];
        const bool vis = x < p.Sq && kpos < p.Sk && (!p.causal || kpos <= x + off);
        const float pr = vis ? exp2f(s[i][n] * p.scale_log2 - sl[n]) : 0.f;
        const float dpd = keep[i][n] ? dp[i][n] * p.inv_keep : 0.f;
        pvb[(l8 + 8 * n) * PS + cc[i]] = keep[i][n] ? pr * p.inv_keep : 0.f;  // not rounded: f32 dV
        dsb[(l8 + 8 * n) * PS + cc[i]] = Round<T>::f(pr * (dpd - sd[n]) * p.scale);
      }
    __syncthreads();
    const int nq = min(kTile, p.Sq - qb);
    for (int qq = 0; qq < nq; ++qq) {
      float a[2], e2[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        a[i] = pvb[qq * PS + cc[i]];
        e2[i] = dsb[qq * PS + cc[i]];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 gv = ld4(gt + qq * WS + 4 * l8 + 32 * c);
        const float4 qv = ld4(qt + qq * WS + 4 * l8 + 32 * c);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          dv[i][c][0] = fmaf(a[i], gv.x, dv[i][c][0]);
          dv[i][c][1] = fmaf(a[i], gv.y, dv[i][c][1]);
          dv[i][c][2] = fmaf(a[i], gv.z, dv[i][c][2]);
          dv[i][c][3] = fmaf(a[i], gv.w, dv[i][c][3]);
          dk[i][c][0] = fmaf(e2[i], qv.x, dk[i][c][0]);
          dk[i][c][1] = fmaf(e2[i], qv.y, dk[i][c][1]);
          dk[i][c][2] = fmaf(e2[i], qv.z, dk[i][c][2]);
          dk[i][c][3] = fmaf(e2[i], qv.w, dk[i][c][3]);
        }
      }
    }
    __syncthreads();  // the buffers and the stage are rewritten next
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      sl[n] = nl[n];
      sd[n] = nd[n];
    }
  }

  T* dkg = static_cast<T*>(p.dk);
  T* dvg = static_cast<T*>(p.dv);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (cc[i] >= livek) continue;
    const size_t at = ((size_t)(b * p.Sk + c0 + cc[i]) * p.H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      st4(dkg + at + 4 * l8 + 32 * c, make_float4(dk[i][c][0], dk[i][c][1], dk[i][c][2], dk[i][c][3]));
      st4(dvg + at + 4 * l8 + 32 * c, make_float4(dv[i][c][0], dv[i][c][1], dv[i][c][2], dv[i][c][3]));
    }
  }
}

// -------------------------------------------------------------- kernels

enum class Op { EncoderDq, EncoderDkv, EncoderHead };

// Grid: (row tiles, H, B) or (key tiles, H, B) for the streamed ops (causal
// dQ tiles the longest walks first); (H, B) for the whole head.
template <Op OP, int D, class T>
__global__ void __launch_bounds__(kThreads) simt_attention_bwd(const BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (OP == Op::EncoderHead) {
    const int h = blockIdx.x, b = blockIdx.y;
    using L = BwdLayout<D, T>;
    float* sl = reinterpret_cast<float*>(smem + L::off_st);
    float* sd = sl + kHeadS;
    for (int r0 = 0; r0 < kHeadS; r0 += kTile) row_pass<D, T>(p, smem, b, h, r0, sl, sd, nullptr);
    for (int c0 = 0; c0 < kHeadS; c0 += kTile) col_pass<D, T>(p, smem, b, h, c0, sl, sd);
  } else {
    const int h = blockIdx.y, b = blockIdx.z, bh = b * p.H + h;
    float* sl = p.stats + (size_t)bh * p.Sq;
    float* sd = p.stats + ((size_t)p.B * p.H + bh) * p.Sq;
    if constexpr (OP == Op::EncoderDq) {
      const int tile = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
      row_pass<D, T>(p, smem, b, h, tile * kTile, sl, sd, p.lse);
    } else {
      col_pass<D, T>(p, smem, b, h, blockIdx.x * kTile, sl, sd);
    }
  }
}

// ------------------------------------------------------------------ host

template <class K>
cudaError_t run(K kernel, dim3 grid, size_t smem, cudaStream_t st, const BwdParams& p) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

template <Op OP, class T>
cudaError_t run_typed(const BwdParams& p, int D, dim3 grid, cudaStream_t st) {
#define SIMT_BWD_RUN(DD) \
  if (D == DD) return run(simt_attention_bwd<OP, DD, T>, grid, BwdLayout<DD, T>::bytes, st, p);
  SIMT_BWD_ENCODER_DIMS(SIMT_BWD_RUN)
#undef SIMT_BWD_RUN
  return cudaErrorInvalidValue;
}

// Launch op OP on storage type `type` (0 float32) and head dim D, or
// return cudaErrorInvalidValue where no instantiation is built.
template <Op OP>
cudaError_t run_op(const BwdParams& p, int D, int type, dim3 grid, cudaStream_t st) {
#define SIMT_BWD_TYPE(T) \
  if (type == type_code<T>()) return run_typed<OP, T>(p, D, grid, st);
  SIMT_BWD_ENCODER_TYPES(SIMT_BWD_TYPE)
#undef SIMT_BWD_TYPE
  return cudaErrorInvalidValue;
}

}  // namespace attention_simt_bwd
