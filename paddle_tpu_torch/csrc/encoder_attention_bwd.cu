// Short-sequence self-attention backward for Hopper (sm_90a), bf16, head
// dims 64 and 128, with dropout of the probabilities.
//
// Replaces: paddle_tpu/ops/encoder_attention.py `_bwd_kernel` (launched by
// `_attn_bwd`).  From q, k, v [B, S, H, D] (S % 128 == 0, S <= 512,
// optionally causal) and the output cotangent dO it writes, as the
// reference does with P = softmax(scale q k^T) taken over each whole row
// and, with dropout, keep the forward's mask and r the rate:
//   dV = P_d^T dO,        P_d = where(keep, P / (1 - r), 0) in f32,
//   dP = where(keep, dO v^T / (1 - r), 0),
//   dS = P (dP - rowsum(dP * P)) * scale, rounded to bf16,
//   dQ = dS k,            dK = dS^T q.
// The mask is regenerated from the forward's seed pair (philox.cuh) and
// drawn once per element per call.  Nothing of size [B * H, S, S] is
// stored.  q, k, v and dO may be views with any 16-byte-multiple row and
// batch strides (head stride D): TMA reads them in place.
//
// What bounds it on this card: bytes.  Its least work is 5 products, 10 D
// operations per visible query-key pair, and it must read q, k, v, dO and
// write dq, dk, dv once: at the ERNIE shape (B 512, H 12, S 128, D 64,
// dropout 0.1) 705 MB, 0.210 ms at 3.35 TB/s, against 0.033 ms of
// tensor-core work and 0.060 ms for one Philox draw per element; at the
// LLaMA train_s512 microbatch (B 16, H 16, S 512, D 128, causal) 235 MB,
// 0.070 ms, against 0.044 ms of tensor-core work.
//
// What the design does about it: products on `wgmma`, loads by TMA
// (wgmma_attention.cuh, encoder_wgmma.cuh), blocks of two warpgroups.  The
// reference's dV takes P_d in f32; the tensor cores take bf16, so P_d is
// split in two bf16 parts (hi + lo, about 16 bits of mantissa) and the dV
// product runs twice.  Two regimes:
//  * whole head, S = 128 (ERNIE): one block holds a head's Q, K, V and dO
//    (64 KB at D 64) and its whole [128, 128] score block, so nothing is
//    recomputed and nothing leaves the chip but the gradients.  Each
//    warpgroup takes 64 query rows: S = Q K^T and dP = dO V^T into
//    registers, the exact row max and sum, P, the mask (one draw), dsum =
//    rowsum(dP * P) and dS in registers, dQ = dS K from registers; P_d
//    (hi, lo) and dS go to shared memory in bf16.  Then each warpgroup takes
//    64 keys: dV = P_d^T dO and dK = dS^T Q with A read transposed from
//    shared memory.  A persistent grid walks the heads and, at D 64, loads
//    the next head while it computes this one.  12 D operations a pair (the
//    dV product twice), every one needed.
//  * streamed, S >= 256: the structure of flash_attention_bwd.cu, two
//    deterministic kernels.  The forward saved each row's lse, so P =
//    exp(scale S - lse) is exact in one pass and no max or sum is walked
//    for.  dQ: per 128-row query tile, 128-key tiles of K and V in a TMA
//    ring, walked twice: once for the statistics (S and dP, the mask drawn
//    once and written as bits, 1 bit an element in a [B * H, S / 16,
//    S / 16] buffer of 16 x 16 tiles, dsum = rowsum(dP * P) in the
//    reference's order), once for dS and dQ += dS K from registers.
//    dK/dV: per 128-key tile, 64-query tiles of Q and dO with their
//    statistics in a ring; S^T and dP^T, the mask read from the bits, dV +=
//    P_d^T dO (hi and lo) and dK += dS^T Q from registers.  Each block owns
//    its output rows: no atomics, the same bits on every run.  S and dP
//    three times (walk 1, walk 2, dK/dV) are the price of that and of the
//    reference's dsum: 20 D operations a pair against the 12 D of the
//    whole-head kernel.
// At rate 0 no mask is drawn and nothing is written to the bits.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (paddle_tpu_torch/ops/_build.py does this).

#include "encoder_wgmma.cuh"

namespace {

using namespace encoder_wgmma;

struct BwdArgs {
  bf16* dq;            // [B, S, H, D], contiguous
  bf16* dk;
  bf16* dv;
  const float* lse;    // streamed: the forward's natural-log lse [B * H, S]
  float* stats;        // streamed: [2, B * H, S]: lse * log2(e), dsum
  uint8_t* bits;       // streamed with dropout: the mask's bits
  int B, H, S;
  float scale;
  float scale_log2;    // scale * log2(e)
  int causal;
  Drop drop;
};

__device__ __forceinline__ uint32_t split_bf16x2(float x0, float x1, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h));
  lo = *reinterpret_cast<const uint32_t*>(&l);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// ------------------------------------------------------------ whole head

// Persistent: block x takes heads x, x + gridDim.x, ...; NB buffers of a
// head's Q, K, V, dO (128 x D each) in a ring, then the staging tiles of
// P_d hi, P_d lo and dS ([128 queries, 128 keys] bf16 each, two swizzled
// 64-key panels).
template <int D, int NB>
__global__ void __launch_bounds__(kThreads, 1)
    encoder_bwd_head(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                     const BwdArgs p) {
  constexpr int kElems = kT * D;  // one tensor's tile
  unsigned char* base = &aligned_smem<unsigned char>();
  bf16* buf = reinterpret_cast<bf16*>(base);
  bf16* hi = buf + NB * 4 * kElems;
  bf16* lo = hi + kT * kT;
  bf16* dsb = lo + kT * kT;
  struct Bars {
    uint64_t unused;
    Ring<NB> ring;
  };
  Bars& bars = *reinterpret_cast<Bars*>(dsb + kT * kT);
  const int heads = p.B * p.H;
  const int count = heads > (int)blockIdx.x ? (heads - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const auto load = [&](int n) {
    const int bh = blockIdx.x + n * gridDim.x, b = bh / p.H, h = bh % p.H;
    uint64_t* full = &bars.ring.full[n % NB];
    bf16* x = buf + (n % NB) * 4 * kElems;
    mbar_expect_tx(full, 4 * kElems * 2);
    tma_tile<D, kT>(x, &tq, full, h, 0, b);
    tma_tile<D, kT>(x + kElems, &tk, full, h, 0, b);
    tma_tile<D, kT>(x + 2 * kElems, &tv, full, h, 0, b);
    tma_tile<D, kT>(x + 3 * kElems, &tdo, full, h, 0, b);
  };
  init_ring(&bars.unused, bars.ring);
  if (threadIdx.x == 0)
    for (int n = 0; n < min(count, NB); ++n) load(n);
  const uint2 key = philox_key(p.drop);
  const bool drop = p.drop.seed != nullptr;
  const int wg = warpgroup(), warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row = 64 * wg + 16 * warp + g;  // query rows (phase A) or keys (phase B): row, row + 8
  const float one[2] = {1.f, 1.f};

  for (int n = 0; n < count; ++n) {
    if (threadIdx.x == 0 && n >= 1 && n - 1 + NB < count) {
      mbar_wait(&bars.ring.empty[(n - 1) % NB], ((n - 1) / NB) & 1);
      load(n - 1 + NB);
    }
    wait_full(bars.ring, n);
    const int bh = blockIdx.x + n * gridDim.x, b = bh / p.H, h = bh % p.H;
    const bf16* q = buf + (n % NB) * 4 * kElems;
    const bf16* k = q + kElems;
    const bf16* v = q + 2 * kElems;
    const bf16* dO = q + 3 * kElems;

    // ---- phase A: the warpgroup's 64 query rows against all 128 keys
    {
      float sc[kT / 2], dp[kT / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Mma<kT>::ss(sc, desc_k<kT>(q + 64 * wg * kPanel, kk), desc_k<kT>(k, kk), kk > 0);
      wg_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Mma<kT>::ss(dp, desc_k<kT>(dO + 64 * wg * kPanel, kk), desc_k<kT>(v, kk), kk > 0);
      wg_commit();
      wg_wait<1>();  // S is done: P while dP runs
      fence_regs(sc);
      scale_mask(sc, p.scale_log2, p.causal != 0, 0, row, t);
      float m[2], l[2];
      row_softmax(sc, m, l);
      const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
      for (int i = 0; i < kT / 2; ++i) sc[i] *= inv[acc_half(i)];
      wg_wait<0>();
      fence_regs(dp);
      float dsum[2] = {0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk) {
        const uint32_t byte = drop ? keep_byte(key, bh, row, 16 * kk, t, p.drop.thresh) : 0xFFu;
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          const int i = 8 * kk + e;
          float pd[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const bool kp = kept(byte, e + c);
            pd[c] = drop ? (kp ? sc[i + c] * p.drop.inv_keep : 0.f) : sc[i + c];
            if (drop) dp[i + c] = kp ? dp[i + c] * p.drop.inv_keep : 0.f;
            dsum[acc_half(i)] += dp[i + c] * sc[i + c];
          }
          uint32_t plo;
          const uint32_t phi = split_bf16x2(pd[0], pd[1], plo);
          const int r = row + 8 * acc_half(i), col = acc_col(i, t);
          st_pair<kT>(hi, r, col, phi);
          st_pair<kT>(lo, r, col, plo);
        }
      }
      dsum[0] = quad_sum(dsum[0]);
      dsum[1] = quad_sum(dsum[1]);
#pragma unroll
      for (int i = 0; i < kT / 2; ++i) dp[i] = (sc[i] * (dp[i] - dsum[acc_half(i)])) * p.scale;
      uint32_t da[kT / 16][4];
      to_a<kT>(da, dp);
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk) {
        // da[kk] = {(row, c), (row + 8, c), (row, c + 8), (row + 8, c + 8)},
        // c = 16 kk + 2 t: the bf16 pairs of dS as the A operand holds them
        st_pair<kT>(dsb, row, 16 * kk + 2 * t, da[kk][0]);
        st_pair<kT>(dsb, row + 8, 16 * kk + 2 * t, da[kk][1]);
        st_pair<kT>(dsb, row, 16 * kk + 8 + 2 * t, da[kk][2]);
        st_pair<kT>(dsb, row + 8, 16 * kk + 8 + 2 * t, da[kk][3]);
      }
      float dq[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk) Mma<D>::rs(dq, da[kk], desc_mn<kT>(k, kk));
      wg_commit();
      wg_wait();
      fence_regs(dq);
      store_rows<D>(p.dq, dq, one, b, h, row, p.S, p.H, t);
    }
    fence_async_shared();
    __syncthreads();  // P_d and dS of all 128 queries are in shared memory

    // ---- phase B: the warpgroup's 64 keys against all 128 queries
    {
      float dv[D / 2], dk[D / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk)
        Mma<D>::tt(dv, desc_mn<kT>(hi + wg * kT * kPanel, kk), desc_mn<kT>(dO, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk)
        Mma<D>::tt(dv, desc_mn<kT>(lo + wg * kT * kPanel, kk), desc_mn<kT>(dO, kk), 1);
      wg_commit();
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk)
        Mma<D>::tt(dk, desc_mn<kT>(dsb + wg * kT * kPanel, kk), desc_mn<kT>(q, kk), kk > 0);
      wg_commit();
      wg_wait<1>();
      fence_regs(dv);
      store_rows<D>(p.dv, dv, one, b, h, row, p.S, p.H, t);
      wg_wait<0>();
      fence_regs(dk);
      store_rows<D>(p.dk, dk, one, b, h, row, p.S, p.H, t);
    }
    release(bars.ring, n);
    __syncthreads();  // the staging tiles are free for the next head
  }
}

// -------------------------------------------------------------- streamed

constexpr int kWalk = 64;     // queries per tile of the dK/dV walk
constexpr int kStagesQ = 3;   // its ring: 160 KB of shared memory at D = 128
constexpr int kStagesK = 2;   // the dQ walk's ring of 128-key tiles: 192 KB at D = 128

template <int D>
struct DqSmem {
  bf16 q[kT * D];
  bf16 dO[kT * D];
  bf16 k[kStagesK][kT * D];
  bf16 v[kStagesK][kT * D];
  uint64_t own_full;
  Ring<kStagesK> ring;
};

template <int D>
struct DkvSmem {
  bf16 k[kT * D];
  bf16 v[kT * D];
  bf16 q[kStagesQ][kWalk * D];
  bf16 dO[kStagesQ][kWalk * D];
  float lse2[kStagesQ][kWalk];  // the walked queries' statistics
  float dsum[kStagesQ][kWalk];
  uint64_t own_full;
  Ring<kStagesQ> ring;
};

// dQ for one 128-row query tile (grid: query tiles x H x B, the longest
// causal walks first), in two walks over the 128-key tiles up to the causal
// end, K and V streaming through the ring for both (ring use u: tile u %
// tiles).  Walk 1, the statistics: S and dP, P = exp(scale S - lse) with
// the forward's lse, the mask drawn once (and written as bits), dsum =
// rowsum(dP * P); lse and dsum go to `stats` for the dK/dV kernel.  Walk 2:
// S and dP again, the mask from the bits, dS = bf16(P (dP - dsum) scale),
// dQ += dS K.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    encoder_dq(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
               const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
               const BwdArgs p) {
  DqSmem<D>& sm = aligned_smem<DqSmem<D>>();
  const int h = blockIdx.y, b = blockIdx.z, bh = b * p.H + h;
  const int qt = gridDim.x - 1 - blockIdx.x, q0 = qt * kT;
  const int tiles = p.causal ? qt + 1 : p.S / kT, uses = 2 * tiles;
  const auto load_kv = [&](int u) {
    uint64_t* full = &sm.ring.full[u % kStagesK];
    mbar_expect_tx(full, 2 * kT * D * 2);
    tma_tile<D, kT>(sm.k[u % kStagesK], &tk, full, h, (u % tiles) * kT, b);
    tma_tile<D, kT>(sm.v[u % kStagesK], &tv, full, h, (u % tiles) * kT, b);
  };
  init_ring(&sm.own_full, sm.ring);
  if (threadIdx.x == 0) {
    mbar_expect_tx(&sm.own_full, 2 * kT * D * 2);
    tma_tile<D, kT>(sm.q, &tq, &sm.own_full, h, q0, b);
    tma_tile<D, kT>(sm.dO, &tdo, &sm.own_full, h, q0, b);
    for (int u = 0; u < min(uses, kStagesK); ++u) load_kv(u);
  }

  const int wg = warpgroup(), warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wq0 = q0 + 64 * wg;
  const int row = wq0 + 16 * warp + g;  // rows row, row + 8
  const bool drop = p.drop.seed != nullptr;
  const uint2 key = philox_key(p.drop);
  const float lse2[2] = {p.lse[(size_t)bh * p.S + row] * kLog2e,
                         p.lse[(size_t)bh * p.S + row + 8] * kLog2e};
  const bf16* qw = sm.q + 64 * wg * kPanel;
  const bf16* dow = sm.dO + 64 * wg * kPanel;
  float sc[kT / 2], dp[kT / 2];
  uint32_t keep[kT / 64];  // the tile's 8 mask bytes, byte kk in keep[kk / 4]

  // S and dP of ring use u (tile kb) into sc (as P) and dp (masked and
  // scaled by the tile's mask in keep)
  const auto products = [&](int u, int kb) {
    const int s = u % kStagesK;
    wait_full(sm.ring, u);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Mma<kT>::ss(sc, desc_k<kT>(qw, kk), desc_k<kT>(sm.k[s], kk), kk > 0);
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Mma<kT>::ss(dp, desc_k<kT>(dow, kk), desc_k<kT>(sm.v[s], kk), kk > 0);
    wg_commit();
    refill(sm.ring, u, uses, load_kv);
    wg_wait<1>();  // S is done: P while dP = dO V^T runs
    fence_regs(sc);
    const bool edge = p.causal && kb + kT - 1 > wq0;
#pragma unroll
    for (int i = 0; i < kT / 2; ++i) {
      const int hr = acc_half(i);
      const float pr = exp2f(sc[i] * p.scale_log2 - lse2[hr]);
      sc[i] = edge && kb + acc_col(i, t) > row + 8 * hr ? 0.f : pr;
    }
    wg_wait<0>();
    fence_regs(dp);
    if (drop) {
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dp[8 * kk + e] = kept(keep[kk / 4] >> (8 * (kk % 4)), e) ? dp[8 * kk + e] * p.drop.inv_keep
                                                                  : 0.f;
    }
  };

  // ---- walk 1: dsum = rowsum(dP * P); the mask drawn before the tile's
  // products are issued, while no accumulator is live
  float part[2] = {0.f, 0.f};
  mbar_wait(&sm.own_full, 0);
  for (int j = 0; j < tiles; ++j) {
    const int kb = j * kT;
    if (drop) {
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk) {
        const uint32_t byte = keep_byte(key, bh, row, kb + 16 * kk, t, p.drop.thresh);
        *bits_byte(p.bits, bh, p.S, row - g, kb + 16 * kk, g, t) = (uint8_t)byte;
        if (kk % 4 == 0) keep[kk / 4] = 0;
        keep[kk / 4] |= byte << (8 * (kk % 4));
      }
    }
    products(j, kb);
#pragma unroll
    for (int i = 0; i < kT / 2; ++i) part[acc_half(i)] += dp[i] * sc[i];
    release(sm.ring, j);
  }
  const float dsum[2] = {quad_sum(part[0]), quad_sum(part[1])};
  if (t == 0) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      p.stats[(size_t)bh * p.S + row + 8 * hr] = lse2[hr];
      p.stats[(size_t)p.B * p.H * p.S + (size_t)bh * p.S + row + 8 * hr] = dsum[hr];
    }
  }

  // ---- walk 2: dQ, the mask read back from this thread's own bits
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  for (int j = 0; j < tiles; ++j) {
    const int u = tiles + j, kb = j * kT;
    if (drop) {
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk) {
        const uint32_t byte = *bits_byte(p.bits, bh, p.S, row - g, kb + 16 * kk, g, t);
        if (kk % 4 == 0) keep[kk / 4] = 0;
        keep[kk / 4] |= byte << (8 * (kk % 4));
      }
    }
    products(u, kb);
#pragma unroll
    for (int i = 0; i < kT / 2; ++i) sc[i] = (sc[i] * (dp[i] - dsum[acc_half(i)])) * p.scale;
    uint32_t da[kT / 16][4];
    to_a<kT>(da, sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk)
      Mma<D>::rs(dq, da[kk], desc_mn<kT>(sm.k[u % kStagesK], kk));
    wg_commit();
    wg_wait();
    fence_regs(dq);
    release(sm.ring, u);
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(p.dq, dq, one, b, h, row, p.S, p.H, t);
}

// dK and dV for one 128-key tile (grid: key tiles x H x B), walking the
// 64-query tiles from the first that sees a key of the tile.  Per query
// tile: P^T = exp(scale S^T - lse), the mask from the bits, dV += P_d^T dO
// (hi and lo), dS^T = bf16(P^T (dP^T - dsum) scale), dK += dS^T Q.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    encoder_dkv(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                const BwdArgs p) {
  DkvSmem<D>& sm = aligned_smem<DkvSmem<D>>();
  const int h = blockIdx.y, b = blockIdx.z, bh = b * p.H + h;
  const int k0 = blockIdx.x * kT;
  const int qstart = p.causal ? k0 : 0;
  const int tiles = (p.S - qstart) / kWalk;
  const size_t stat0 = (size_t)bh * p.S;
  const float* lse2g = p.stats;
  const float* dsumg = p.stats + (size_t)p.B * p.H * p.S;
  const auto load_q = [&](int j) {
    const int s = j % kStagesQ, qb = qstart + j * kWalk;
    uint64_t* full = &sm.ring.full[s];
    mbar_expect_tx(full, 2 * kWalk * D * 2 + 2 * kWalk * 4);
    tma_tile<D, kWalk>(sm.q[s], &tq, full, h, qb, b);
    tma_tile<D, kWalk>(sm.dO[s], &tdo, full, h, qb, b);
    bulk_load(sm.lse2[s], lse2g + stat0 + qb, kWalk * 4, full);
    bulk_load(sm.dsum[s], dsumg + stat0 + qb, kWalk * 4, full);
  };
  init_ring(&sm.own_full, sm.ring);
  if (threadIdx.x == 0) {
    mbar_expect_tx(&sm.own_full, 2 * kT * D * 2);
    tma_tile<D, kT>(sm.k, &tk, &sm.own_full, h, k0, b);
    tma_tile<D, kT>(sm.v, &tv, &sm.own_full, h, k0, b);
    for (int j = 0; j < min(tiles, kStagesQ); ++j) load_q(j);
  }

  const int wg = warpgroup(), warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wk0 = k0 + 64 * wg;
  const int key = wk0 + 16 * warp + g;  // keys key, key + 8
  const bool drop = p.drop.seed != nullptr;
  const bf16* kw = sm.k + 64 * wg * kPanel;
  const bf16* vw = sm.v + 64 * wg * kPanel;
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(&sm.own_full, 0);
  uint32_t pa[kWalk / 16][4], pl[kWalk / 16][4], da[kWalk / 16][4];
  for (int j = 0; j < tiles; ++j) {
    const int s = j % kStagesQ, qb = qstart + j * kWalk;
    wait_full(sm.ring, j);
    float sc[kWalk / 2], dp[kWalk / 2];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Mma<kWalk>::ss(sc, desc_k<kT>(kw, kk), desc_k<kWalk>(sm.q[s], kk), kk > 0);
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Mma<kWalk>::ss(dp, desc_k<kT>(vw, kk), desc_k<kWalk>(sm.dO[s], kk), kk > 0);
    wg_commit();
    if (j > 0) {
      wg_wait<2>();  // dV and dK of tile j - 1 are done: its stage is free
      release(sm.ring, j - 1);
      refill(sm.ring, j, tiles, load_q);
    }
    uint32_t bytes[kWalk / 16];
#pragma unroll
    for (int kk = 0; kk < kWalk / 16; ++kk)
      bytes[kk] = drop ? keep_byte_t(p.bits, bh, p.S, qb + 16 * kk, key - g, g, t) : 0xFFu;
    wg_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    fence_regs(dv);
    fence_regs(dk);
    const bool edge = p.causal && wk0 + 63 > qb;
#pragma unroll
    for (int i = 0; i < kWalk / 2; ++i) {
      const int c = acc_col(i, t);
      const float pr = edge && key + 8 * acc_half(i) > qb + c
                           ? 0.f
                           : exp2f(sc[i] * p.scale_log2 - sm.lse2[s][c]);
      const bool kp = kept_t(bytes[i >> 3], i & 7);
      const float dpd = drop ? (kp ? dp[i] * p.drop.inv_keep : 0.f) : dp[i];
      dp[i] = (pr * (dpd - sm.dsum[s][c])) * p.scale;
      sc[i] = drop ? (kp ? pr * p.drop.inv_keep : 0.f) : pr;
    }
    to_a<kWalk>(da, dp);
#pragma unroll
    for (int kk = 0; kk < kWalk / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = split_bf16x2(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], pl[kk][r]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kWalk / 16; ++kk) Mma<D>::rs(dv, pa[kk], desc_mn<kWalk>(sm.dO[s], kk));
#pragma unroll
    for (int kk = 0; kk < kWalk / 16; ++kk) Mma<D>::rs(dv, pl[kk], desc_mn<kWalk>(sm.dO[s], kk));
#pragma unroll
    for (int kk = 0; kk < kWalk / 16; ++kk) Mma<D>::rs(dk, da[kk], desc_mn<kWalk>(sm.q[s], kk));
    wg_commit();
  }
  wg_wait();
  fence_regs(dv);
  fence_regs(dk);
  const float one[2] = {1.f, 1.f};
  store_rows<D>(p.dk, dk, one, b, h, key, p.S, p.H, t);
  store_rows<D>(p.dv, dv, one, b, h, key, p.S, p.H, t);
}

// ------------------------------------------------------------------ host

struct Inputs {
  const void *q, *k, *v, *dO;
  Strides st[4];
};

// The four TMA maps: q and dO with boxes of q_rows rows, k and v of k_rows.
cudaError_t make_maps(CUtensorMap (&m)[4], const Inputs& in, const BwdArgs& a, int D, int q_rows,
                      int k_rows) {
  cudaError_t err;
  if ((err = make_map(&m[0], in.q, a.B, a.S, a.H, D, q_rows, in.st[0])) != cudaSuccess) return err;
  if ((err = make_map(&m[1], in.dO, a.B, a.S, a.H, D, q_rows, in.st[3])) != cudaSuccess) return err;
  if ((err = make_map(&m[2], in.k, a.B, a.S, a.H, D, k_rows, in.st[1])) != cudaSuccess) return err;
  return make_map(&m[3], in.v, a.B, a.S, a.H, D, k_rows, in.st[2]);
}

template <int D, int NB>
cudaError_t run_head(const Inputs& in, const BwdArgs& a, cudaStream_t st) {
  CUtensorMap m[4];  // q, dO, k, v
  cudaError_t err = make_maps(m, in, a, D, kT, kT);
  if (err != cudaSuccess) return err;
  const size_t smem = (size_t)(NB * 4 * kT * D + 3 * kT * kT) * sizeof(bf16) + 64 + 1024;
  const auto kernel = encoder_bwd_head<D, NB>;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
      cudaSuccess)
    return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return err;
  const int grid = min(a.B * a.H, sms * max(per_sm, 1));
  kernel<<<grid, kThreads, smem, st>>>(m[0], m[2], m[3], m[1], a);
  return cudaGetLastError();
}

template <int D>
cudaError_t run_streamed(const Inputs& in, const BwdArgs& a, cudaStream_t st) {
  CUtensorMap m[4];
  cudaError_t err = make_maps(m, in, a, D, kT, kT);
  if (err != cudaSuccess) return err;
  err = launch(encoder_dq<D>, dim3(a.S / kT, a.H, a.B), sizeof(DqSmem<D>) + 1024, st, m[0], m[1], m[2],
               m[3], a);
  if (err != cudaSuccess || (err = make_maps(m, in, a, D, kWalk, kT)) != cudaSuccess) return err;
  return launch(encoder_dkv<D>, dim3(a.S / kT, a.H, a.B), sizeof(DkvSmem<D>) + 1024, st, m[0], m[1],
                m[2], m[3], a);
}

}  // namespace

// Plain C interface (bound with ctypes).  Returns a cudaError_t: 0 on a
// clean launch.  q, k, v, dO: device pointers of [B, S, H, D] bf16 views,
// 16-byte aligned, with element strides (head, row, batch), each a multiple
// of 8; dq, dk, dv [B, S, H, D] bf16 contiguous.  At S = 128 nothing else
// is read.  At S > 128: lse [B * H, S] f32, the forward's; stats f32
// [2, B * H, S] scratch; bits, with dropout, uint8 [B * H * S * S / 8]
// scratch.  seed, thresh and inv_keep are the
// forward's (seed null: no dropout).
extern "C" int encoder_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* dO, const void* lse,
    void* stats, void* bits, void* dq, void* dk, void* dv, int B, int H, int S, int D, long long qh,
    long long qs, long long qb, long long kh, long long ks, long long kb, long long vh, long long vs,
    long long vb, long long dh, long long ds, long long db, float scale, int causal,
    const void* seed, unsigned thresh, float inv_keep, void* stream) {
  if (bad_shape(B, H, S, S, causal) || S % kT != 0 || S > 512) return (int)cudaErrorInvalidValue;
  const Inputs in{q, k, v, dO, {{qh, qs, qb}, {kh, ks, kb}, {vh, vs, vb}, {dh, ds, db}}};
  BwdArgs a{};
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.lse = static_cast<const float*>(lse);
  a.stats = static_cast<float*>(stats);
  a.bits = static_cast<uint8_t*>(bits);
  a.B = B, a.H = H, a.S = S, a.scale = scale, a.scale_log2 = scale * kLog2e, a.causal = causal;
  a.drop = Drop{static_cast<const int*>(seed), thresh, inv_keep};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  if (S == kT) return (int)(D == 64 ? run_head<64, 2>(in, a, st) : run_head<128, 1>(in, a, st));
  if (!lse || !stats || (seed && !bits)) return (int)cudaErrorInvalidValue;
  return (int)(D == 64 ? run_streamed<64>(in, a, st) : run_streamed<128>(in, a, st));
}

extern "C" const char* encoder_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
