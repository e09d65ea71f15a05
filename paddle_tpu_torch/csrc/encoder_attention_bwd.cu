// Short-sequence self-attention backward for Hopper (sm_90a), bf16,
// float16 and float32, head dims 64 and 128, with dropout of the
// probabilities.
//
// Replaces: paddle_tpu/ops/encoder_attention.py `_bwd_kernel` (launched by
// `_attn_bwd`).  From q, k, v [B, S, H, D] (S % 128 == 0, S <= 512,
// optionally causal) and the output cotangent dO it writes, as the
// reference does with P = softmax(scale q k^T) taken over each whole row
// and, with dropout, keep the forward's mask and r the rate:
//   dV = P_d^T dO,        P_d = where(keep, P / (1 - r), 0) in f32,
//   dP = where(keep, dO v^T / (1 - r), 0),
//   dS = P (dP - rowsum(dP * P)) * scale, rounded to q's type (a no-op at
//        float32),
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
// 0.070 ms, against 0.044 ms of tensor-core work.  float16 moves the same
// bytes on the same 16-bit tensor cores: its bound at the ERNIE shape is
// the bf16 one, 0.2103 ms.  float32 moves twice the bytes and does each
// product as three bf16 products: at the ERNIE shape 7 x 201.3 MB = 1.409
// GB, 0.4207 ms, against 193.3 GFLOP, 0.1955 ms, on the tensor cores (the
// f32 FFMA floor of the CUDA-core kernel this one replaced at float32:
// 0.9616 ms); at the LLaMA microbatch 470.3 MB with the lse, 0.1404 ms,
// against 129.1 GFLOP, 0.1305 ms (FFMA floor 0.6423 ms).
//
// What the design does about it: products on `wgmma`, loads by TMA
// (wgmma_attention.cuh, encoder_wgmma.cuh), blocks of two warpgroups.  The
// reference's dV takes P_d in f32; the tensor cores take 16-bit operands,
// so P_d is split in two parts of the products' type E (hi + lo, rounded to
// nearest, split2) and the dV product runs over both: about 16 bits of
// mantissa at bf16, about 22 at float16, where a P_d under 2^-14 has a
// subnormal hi and keeps an absolute error of at most 2^-25 (3e-8): the
// conversions keep float16 subnormals (cvt.rn, no flush to zero), as the
// reference's float16 dS does.  bf16 and float16 run this one design,
// instantiated at T (ENCODER_BWD_TYPES); scores, dP and every accumulator
// stay f32 at every type.
//
// Float32 runs the same kernels as split-bf16 products (split_bf16.cuh, as
// the flash backward's float32 does): q, k, v and dO are each two bf16
// planes (hi = RN(x), lo = RN(x - hi)), dS is split where it is made
// (to_planes), P_d is bf16 hi and lo, and each product is the three bf16
// products of SPLIT_BF16_TERMS; scores, dsum = rowsum(dP * P) and every
// accumulator stay f32, and dQ, dK and dV are written in f32.  The planes
// are made in shared memory: each f32 tile comes by TMA as it is (so the
// strided q, k, v of a packed projection are read in place) and is split
// where it landed, into the same bytes (split_tile), by all 256 threads
// before a block barrier.  So the kernel moves the function's 28 bytes an
// element (4 read of each of q, k, v, dO, 4 written of each gradient),
// where a split pass before it would add 32 (4 read and 4 written of each
// input).  A float32 tile is a bf16 tile of width W = 2 D, and the layouts
// are picked by W (Planes, Streamed), as the flash backward's are: float32
// at D = 64 takes bf16's D = 128 shapes.
//
// Two regimes:
//  * whole head, S = 128, where a head's tiles fit (W <= 128; kHeadFits):
//    one block holds a head's Q, K, V and dO (64 KB at bf16 D 64) and its
//    whole [128, 128] score block, so nothing is recomputed and nothing
//    leaves the chip but the gradients.  Each warpgroup takes 64 query
//    rows: S = Q K^T and dP = dO V^T into registers, the exact row max and
//    sum, P, the mask (one draw), dsum = rowsum(dP * P) and dS in
//    registers, dQ = dS K from registers; P_d (hi, lo) and dS go to shared
//    memory.  Then each warpgroup takes 64 keys: dV = P_d^T dO and dK = dS^T
//    Q with A read transposed from shared memory.  A persistent grid walks
//    the heads and, at bf16 and float16 D 64, loads the next head while it
//    computes this one.  12 D operations a pair at bf16 (the dV product
//    twice), every one needed.  Float32 at D 64: one head's four tiles
//    take 128 KB and the staging tiles P_d hi, P_d lo and dS hi 96 KB; dS's
//    lo plane goes to V's tile, free once both warpgroups have dP = dO V^T
//    (a block barrier): 224 KB, one head in flight, whose loads wait for the
//    last head's products.  Float32 at D 128, whose four tiles alone take
//    256 KB, runs the streamed pair at S = 128 too.
//  * streamed, S >= 256 (and float32 at D 128): the structure of
//    flash_attention_bwd.cu, two deterministic kernels.  The forward saved
//    each row's lse, so P = exp(scale S - lse) is exact in one pass and no
//    max or sum is walked for.  dQ: per 128-row query tile, BK-key tiles of
//    K and V in a TMA ring, walked twice: once for the statistics (S and
//    dP, the mask drawn once and written as bits, 1 bit an element in a
//    [B * H, S / 16, S / 16] buffer of 16 x 16 tiles, dsum = rowsum(dP * P)
//    in the reference's order), once for dS and dQ += dS K from registers.
//    dK/dV: per 128-key tile, WALK-query tiles of Q and dO with their
//    statistics in a ring; S^T and dP^T, the mask read from the bits, dV +=
//    P_d^T dO (hi and lo) and dK += dS^T Q from registers.  Each block owns
//    its output rows: no atomics, the same bits on every run.  S and dP
//    three times (walk 1, walk 2, dK/dV) are the price of that and of the
//    reference's dsum: 20 D operations a pair against the 12 D of the
//    whole-head kernel.  By W: BK = 128 keys in two stages and WALK = 64
//    queries in three at W <= 128; at W = 256 (float32 at D 128) 32-key
//    tiles in three stages (224 KB) and 32-query tiles (m64n32 scores, so
//    that dK and dV's 128 registers, two planes of P_d^T and dS^T and the
//    scores fit in 255) in three (224 KB), the flash backward's float32
//    D = 128 shapes.  At float32 the warpgroups walk in step: a walked tile
//    is split by the whole block.
// At rate 0 no mask is drawn and nothing is written to the bits.
//
// ptxas -v (sm_90a) at float32, registers a thread: the whole head (D 64)
// 202; dQ 222 and 196, dK/dV 230 and 255 at D 64 and 128; no spill (bf16
// and float16: 201-239).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (paddle_tpu_torch/ops/_build.py does this).

#include <type_traits>

#include "encoder_wgmma.cuh"
#include "split_bf16.cuh"

// The instantiations, one list each (paddle_tpu_torch/ops/_admit.py
// TC_TYPES, TC_TYPE_CODES; a CPU test parses these lines against them):
// (element type, its type code), and the head dims.
#define ENCODER_BWD_TYPES(X) X(__nv_bfloat16, 1) X(__half, 2) X(float, 0)
#define ENCODER_BWD_DIMS(X) X(64) X(128)

namespace {

using namespace encoder_wgmma;
using namespace split_bf16;

template <typename T>
struct BwdArgs {
  T* dq;               // [B, S, H, D], contiguous
  T* dk;
  T* dv;
  const float* lse;    // streamed: the forward's natural-log lse [B * H, S]
  float* stats;        // streamed: [2, B * H, S]: lse * log2(e), dsum
  uint8_t* bits;       // streamed with dropout: the mask's bits
  int B, H, S;
  float scale;
  float scale_log2;    // scale * log2(e)
  int causal;
  Drop drop;
};

// (x0, x1) as a pair of T rounded to nearest (returned) and the pair of
// what that rounding left out, rounded again (lo): hi + lo carries about
// twice T's mantissa.
template <typename T>
__device__ __forceinline__ uint32_t split2(float x0, float x1, uint32_t& lo) {
  const typename Elem<T>::Pair h = Elem<T>::round2(x0, x1);
  const float2 hf = Elem<T>::widen2(h);
  const typename Elem<T>::Pair l = Elem<T>::round2(x0 - hf.x, x1 - hf.y);
  lo = *reinterpret_cast<const uint32_t*>(&l);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// f(a, c, first) for each term of dV = P_d^T dO: P_d is two planes of E
// (hi, lo) at every type and dO has P: hi then lo against dO at P = 1,
// SPLIT_BF16_TERMS at P = 2 (lo against lo left out, as in every product).
template <int P, typename F>
__device__ __forceinline__ void for_pd_terms(F&& f) {
  if constexpr (P == 1) {
    f(Plane<0>(), Plane<0>(), true);
    f(Plane<1>(), Plane<0>(), false);
  } else {
    for_terms<2>(f);
  }
}

// Whether a head's four tiles of T at head dim D fit beside the staging
// tiles of the whole-head kernel: W = P D <= 128 (a row of q at most 256
// bytes).  At S = 128 those shapes run the whole head, every other the
// streamed pair (ops/encoder_attention.py _whole_head is this rule).
template <typename T, int D>
constexpr bool kHeadFits = Planes<T>::P * D <= kT;

// ------------------------------------------------------------ whole head

// Persistent: block x takes heads x, x + gridDim.x, ...; NB buffers of a
// head's Q, K, V, dO (128 x W of E each; at float32 an f32 tile until
// split_tile makes it planes) in a ring, then the staging tiles of P_d hi,
// P_d lo and dS ([128 queries, 128 keys] of E each, two swizzled 64-key
// panels); at float32 dS is two planes, the lo one in V's tile.
template <typename T, int D, int NB>
__global__ void __launch_bounds__(kThreads, 1)
    encoder_bwd_head(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                     const BwdArgs<T> p) {
  using E = typename Planes<T>::E;
  constexpr int P = Planes<T>::P, KD = D / 16;  // KD: k-steps of a plane
  constexpr int kElems = kT * P * D;            // one tensor's tile, in E
  constexpr int kTile = kT * D;                 // the same, in T
  unsigned char* base = &aligned_smem<unsigned char>();
  E* buf = reinterpret_cast<E*>(base);
  E* hi = buf + NB * 4 * kElems;
  E* lo = hi + kT * kT;
  E* dsb = lo + kT * kT;
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
    T* x = reinterpret_cast<T*>(buf + (n % NB) * 4 * kElems);
    mbar_expect_tx(full, 4 * kTile * sizeof(T));
    tma_tile<D, kT>(x, &tq, full, h, 0, b);
    tma_tile<D, kT>(x + kTile, &tk, full, h, 0, b);
    tma_tile<D, kT>(x + 2 * kTile, &tv, full, h, 0, b);
    tma_tile<D, kT>(x + 3 * kTile, &tdo, full, h, 0, b);
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
    E* q = buf + (n % NB) * 4 * kElems;
    E* k = q + kElems;
    E* v = q + 2 * kElems;
    E* dO = q + 3 * kElems;
    if constexpr (P > 1) {  // the f32 tiles become their bf16 planes where they landed
      split_tile<D, kT>(q);
      split_tile<D, kT>(k);
      split_tile<D, kT>(v);
      split_tile<D, kT>(dO);
      fence_async_shared();
      __syncthreads();
    }

    // ---- phase A: the warpgroup's 64 query rows against all 128 keys
    {
      float sc[kT / 2], dp[kT / 2];
      wg_fence();
      for_terms<P>([&](auto a, auto c, bool first) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
          Mma<kT, E>::ss(sc, desc_k<kT>(q + 64 * wg * kPanel, kk + a * KD),
                         desc_k<kT>(k, kk + c * KD), !first || kk > 0);
      });
      wg_commit();
      for_terms<P>([&](auto a, auto c, bool first) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
          Mma<kT, E>::ss(dp, desc_k<kT>(dO + 64 * wg * kPanel, kk + a * KD),
                         desc_k<kT>(v, kk + c * KD), !first || kk > 0);
      });
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
          const uint32_t phi = split2<E>(pd[0], pd[1], plo);
          const int r = row + 8 * acc_half(i), col = acc_col(i, t);
          st_pair<kT>(hi, r, col, phi);
          st_pair<kT>(lo, r, col, plo);
        }
      }
      dsum[0] = quad_sum(dsum[0]);
      dsum[1] = quad_sum(dsum[1]);
#pragma unroll
      for (int i = 0; i < kT / 2; ++i) dp[i] = (sc[i] * (dp[i] - dsum[acc_half(i)])) * p.scale;
      uint32_t da[P][kT / 16][4];
      to_planes<kT, T>(da, dp);
      if constexpr (P > 1) __syncthreads();  // both warpgroups have dP: V's tile takes dS's lo plane
#pragma unroll
      for (int a = 0; a < P; ++a) {
        E* ds = a == 0 ? dsb : v;
#pragma unroll
        for (int kk = 0; kk < kT / 16; ++kk) {
          // da[a][kk] = {(row, c), (row + 8, c), (row, c + 8), (row + 8, c + 8)},
          // c = 16 kk + 2 t: the E pairs of dS as the A operand holds them
          st_pair<kT>(ds, row, 16 * kk + 2 * t, da[a][kk][0]);
          st_pair<kT>(ds, row + 8, 16 * kk + 2 * t, da[a][kk][1]);
          st_pair<kT>(ds, row, 16 * kk + 8 + 2 * t, da[a][kk][2]);
          st_pair<kT>(ds, row + 8, 16 * kk + 8 + 2 * t, da[a][kk][3]);
        }
      }
      float dq[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
      wg_fence();
      for_terms<P>([&](auto a, auto c, bool) {
        const E* kc = k + (c * D / kPanel) * kT * kPanel;  // plane c of K
#pragma unroll
        for (int kk = 0; kk < kT / 16; ++kk) Mma<D, E>::rs(dq, da[a][kk], desc_mn<kT>(kc, kk));
      });
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
      for_pd_terms<P>([&](auto a, auto c, bool first) {
        const E* pa = (a == 0 ? hi : lo) + wg * kT * kPanel;
        const E* dc = dO + (c * D / kPanel) * kT * kPanel;
#pragma unroll
        for (int kk = 0; kk < kT / 16; ++kk)
          Mma<D, E>::tt(dv, desc_mn<kT>(pa, kk), desc_mn<kT>(dc, kk), !first || kk > 0);
      });
      wg_commit();
      for_terms<P>([&](auto a, auto c, bool first) {
        const E* ds = (a == 0 ? dsb : v) + wg * kT * kPanel;
        const E* qc = q + (c * D / kPanel) * kT * kPanel;
#pragma unroll
        for (int kk = 0; kk < kT / 16; ++kk)
          Mma<D, E>::tt(dk, desc_mn<kT>(ds, kk), desc_mn<kT>(qc, kk), !first || kk > 0);
      });
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

// The streamed kernels' layouts at T and D, by the row width W = P D of
// their tiles: dQ keeps 128 own queries and walks BK-key tiles of K and V
// through NS stages; dK/dV keeps 128 own keys and walks WALK-query tiles of
// Q and dO, with their statistics, through three.
template <typename T, int D>
struct Streamed {
  using E = typename Planes<T>::E;
  static constexpr int P = Planes<T>::P;
  static constexpr int W = P * D;
  static constexpr int BK = W <= 128 ? kT : 32;    // keys a dQ tile (m64nBK scores)
  static constexpr int NS = W <= 128 ? 2 : 3;      // 192 KB at W = 128, 224 KB at W = 256
  static constexpr int WALK = W <= 128 ? 64 : 32;  // queries a dK/dV tile (m64nWALK scores)
  static constexpr int NQ = 3;                     // 160 KB at W = 128, 224 KB at W = 256
  struct DqSmem {
    E q[kT * W];
    E dO[kT * W];
    E k[NS][BK * W];
    E v[NS][BK * W];
    uint64_t own_full;
    Ring<NS> ring;
  };
  struct DkvSmem {
    E k[kT * W];
    E v[kT * W];
    E q[NQ][WALK * W];
    E dO[NQ][WALK * W];
    float lse2[NQ][WALK];  // the walked queries' statistics
    float dsum[NQ][WALK];
    uint64_t own_full;
    Ring<NQ> ring;
  };
};

// dQ for one 128-row query tile (grid: query tiles x H x B, the longest
// causal walks first), in two walks over the BK-key tiles up to the causal
// end, K and V streaming through the ring for both (ring use u: tile u %
// tiles).  Walk 1, the statistics: S and dP, P = exp(scale S - lse) with
// the forward's lse, the mask drawn once (and written as bits), dsum =
// rowsum(dP * P); lse and dsum go to `stats` for the dK/dV kernel.  Walk 2:
// S and dP again, the mask from the bits, dS = T(P (dP - dsum) scale),
// dQ += dS K.  Every product over the planes' terms (for_terms).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    encoder_dq(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
               const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
               const BwdArgs<T> p) {
  using L = Streamed<T, D>;
  using E = typename L::E;
  constexpr int P = L::P, BK = L::BK, NS = L::NS, KD = D / 16;
  typename L::DqSmem& sm = aligned_smem<typename L::DqSmem>();
  const int h = blockIdx.y, b = blockIdx.z, bh = b * p.H + h;
  const int qt = gridDim.x - 1 - blockIdx.x, q0 = qt * kT;
  const int tiles = (p.causal ? q0 + kT : p.S) / BK, uses = 2 * tiles;
  const auto load_kv = [&](int u) {
    uint64_t* full = &sm.ring.full[u % NS];
    mbar_expect_tx(full, 2 * BK * D * sizeof(T));
    tma_tile<D, BK>(reinterpret_cast<T*>(sm.k[u % NS]), &tk, full, h, (u % tiles) * BK, b);
    tma_tile<D, BK>(reinterpret_cast<T*>(sm.v[u % NS]), &tv, full, h, (u % tiles) * BK, b);
  };
  init_ring(&sm.own_full, sm.ring);
  if (threadIdx.x == 0) {
    mbar_expect_tx(&sm.own_full, 2 * kT * D * sizeof(T));
    tma_tile<D, kT>(reinterpret_cast<T*>(sm.q), &tq, &sm.own_full, h, q0, b);
    tma_tile<D, kT>(reinterpret_cast<T*>(sm.dO), &tdo, &sm.own_full, h, q0, b);
    for (int u = 0; u < min(uses, NS); ++u) load_kv(u);
  }

  const int wg = warpgroup(), warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wq0 = q0 + 64 * wg;
  const int row = wq0 + 16 * warp + g;  // rows row, row + 8
  const bool drop = p.drop.seed != nullptr;
  const uint2 key = philox_key(p.drop);
  const float lse2[2] = {p.lse[(size_t)bh * p.S + row] * kLog2e,
                         p.lse[(size_t)bh * p.S + row + 8] * kLog2e};
  const E* qw = sm.q + 64 * wg * kPanel;
  const E* dow = sm.dO + 64 * wg * kPanel;
  float sc[BK / 2], dp[BK / 2];
  uint32_t keep[(BK / 16 + 3) / 4];  // the tile's mask bytes, byte kk in keep[kk / 4]

  // S and dP of ring use u (tile kb) into sc (as P) and dp (masked and
  // scaled by the tile's mask in keep)
  const auto products = [&](int u, int kb) {
    const int s = u % NS;
    wait_full(sm.ring, u);
    make_planes<T, D, BK>(sm.k[s], sm.v[s]);
    wg_fence();
    for_terms<P>([&](auto a, auto c, bool first) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        Mma<BK, E>::ss(sc, desc_k<kT>(qw, kk + a * KD), desc_k<BK>(sm.k[s], kk + c * KD),
                       !first || kk > 0);
    });
    wg_commit();
    for_terms<P>([&](auto a, auto c, bool first) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        Mma<BK, E>::ss(dp, desc_k<kT>(dow, kk + a * KD), desc_k<BK>(sm.v[s], kk + c * KD),
                       !first || kk > 0);
    });
    wg_commit();
    refill(sm.ring, u, uses, load_kv);
    wg_wait<1>();  // S is done: P while dP = dO V^T runs
    fence_regs(sc);
    const bool edge = p.causal && kb + BK - 1 > wq0;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int hr = acc_half(i);
      const float pr = exp2f(sc[i] * p.scale_log2 - lse2[hr]);
      sc[i] = edge && kb + acc_col(i, t) > row + 8 * hr ? 0.f : pr;
    }
    wg_wait<0>();
    fence_regs(dp);
    if (drop) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
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
  make_planes<T, D, kT>(sm.q, sm.dO);
  for (int j = 0; j < tiles; ++j) {
    const int kb = j * BK;
    if (drop) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t byte = keep_byte(key, bh, row, kb + 16 * kk, t, p.drop.thresh);
        *bits_byte(p.bits, bh, p.S, row - g, kb + 16 * kk, g, t) = (uint8_t)byte;
        if (kk % 4 == 0) keep[kk / 4] = 0;
        keep[kk / 4] |= byte << (8 * (kk % 4));
      }
    }
    products(j, kb);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) part[acc_half(i)] += dp[i] * sc[i];
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
    const int u = tiles + j, kb = j * BK;
    if (drop) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t byte = *bits_byte(p.bits, bh, p.S, row - g, kb + 16 * kk, g, t);
        if (kk % 4 == 0) keep[kk / 4] = 0;
        keep[kk / 4] |= byte << (8 * (kk % 4));
      }
    }
    products(u, kb);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = (sc[i] * (dp[i] - dsum[acc_half(i)])) * p.scale;
    uint32_t da[P][BK / 16][4];
    to_planes<BK, T>(da, sc);
    wg_fence();
    for_terms<P>([&](auto a, auto c, bool) {
      const E* kc = sm.k[u % NS] + (c * D / kPanel) * BK * kPanel;  // plane c of K
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) Mma<D, E>::rs(dq, da[a][kk], desc_mn<BK>(kc, kk));
    });
    wg_commit();
    wg_wait();
    fence_regs(dq);
    release(sm.ring, u);
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(p.dq, dq, one, b, h, row, p.S, p.H, t);
}

// dK and dV for one 128-key tile (grid: key tiles x H x B), walking the
// WALK-query tiles from the first that sees a key of the tile.  Per query
// tile: P^T = exp(scale S^T - lse), the mask from the bits, dV += P_d^T dO
// (hi and lo), dS^T = T(P^T (dP^T - dsum) scale), dK += dS^T Q; every
// product over the planes' terms.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    encoder_dkv(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                const BwdArgs<T> p) {
  using L = Streamed<T, D>;
  using E = typename L::E;
  constexpr int P = L::P, WALK = L::WALK, NQ = L::NQ, KD = D / 16;
  typename L::DkvSmem& sm = aligned_smem<typename L::DkvSmem>();
  const int h = blockIdx.y, b = blockIdx.z, bh = b * p.H + h;
  const int k0 = blockIdx.x * kT;
  const int qstart = p.causal ? k0 : 0;
  const int tiles = (p.S - qstart) / WALK;
  const size_t stat0 = (size_t)bh * p.S;
  const float* lse2g = p.stats;
  const float* dsumg = p.stats + (size_t)p.B * p.H * p.S;
  const auto load_q = [&](int j) {
    const int s = j % NQ, qb = qstart + j * WALK;
    uint64_t* full = &sm.ring.full[s];
    mbar_expect_tx(full, 2 * WALK * D * sizeof(T) + 2 * WALK * 4);
    tma_tile<D, WALK>(reinterpret_cast<T*>(sm.q[s]), &tq, full, h, qb, b);
    tma_tile<D, WALK>(reinterpret_cast<T*>(sm.dO[s]), &tdo, full, h, qb, b);
    bulk_load(sm.lse2[s], lse2g + stat0 + qb, WALK * 4, full);
    bulk_load(sm.dsum[s], dsumg + stat0 + qb, WALK * 4, full);
  };
  init_ring(&sm.own_full, sm.ring);
  if (threadIdx.x == 0) {
    mbar_expect_tx(&sm.own_full, 2 * kT * D * sizeof(T));
    tma_tile<D, kT>(reinterpret_cast<T*>(sm.k), &tk, &sm.own_full, h, k0, b);
    tma_tile<D, kT>(reinterpret_cast<T*>(sm.v), &tv, &sm.own_full, h, k0, b);
    for (int j = 0; j < min(tiles, NQ); ++j) load_q(j);
  }

  const int wg = warpgroup(), warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wk0 = k0 + 64 * wg;
  const int key = wk0 + 16 * warp + g;  // keys key, key + 8
  const bool drop = p.drop.seed != nullptr;
  const E* kw = sm.k + 64 * wg * kPanel;
  const E* vw = sm.v + 64 * wg * kPanel;
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(&sm.own_full, 0);
  make_planes<T, D, kT>(sm.k, sm.v);
  // the A operands of the last tile's dV and dK products, live until they end
  uint32_t pa[2][WALK / 16][4], da[P][WALK / 16][4];
  for (int j = 0; j < tiles; ++j) {
    const int s = j % NQ, qb = qstart + j * WALK;
    wait_full(sm.ring, j);
    make_planes<T, D, WALK>(sm.q[s], sm.dO[s]);
    float sc[WALK / 2], dp[WALK / 2];
    wg_fence();
    for_terms<P>([&](auto a, auto c, bool first) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        Mma<WALK, E>::ss(sc, desc_k<kT>(kw, kk + a * KD), desc_k<WALK>(sm.q[s], kk + c * KD),
                         !first || kk > 0);
    });
    wg_commit();
    for_terms<P>([&](auto a, auto c, bool first) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        Mma<WALK, E>::ss(dp, desc_k<kT>(vw, kk + a * KD), desc_k<WALK>(sm.dO[s], kk + c * KD),
                         !first || kk > 0);
    });
    wg_commit();
    if (j > 0) {
      wg_wait<2>();  // dV and dK of tile j - 1 are done: its stage is free
      release(sm.ring, j - 1);
      refill(sm.ring, j, tiles, load_q);
    }
    uint32_t bytes[WALK / 16];
#pragma unroll
    for (int kk = 0; kk < WALK / 16; ++kk)
      bytes[kk] = drop ? keep_byte_t(p.bits, bh, p.S, qb + 16 * kk, key - g, g, t) : 0xFFu;
    wg_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    fence_regs(dv);
    fence_regs(dk);
    const bool edge = p.causal && wk0 + 63 > qb;
#pragma unroll
    for (int i = 0; i < WALK / 2; ++i) {
      const int c = acc_col(i, t);
      const float pr = edge && key + 8 * acc_half(i) > qb + c
                           ? 0.f
                           : exp2f(sc[i] * p.scale_log2 - sm.lse2[s][c]);
      const bool kp = kept_t(bytes[i >> 3], i & 7);
      const float dpd = drop ? (kp ? dp[i] * p.drop.inv_keep : 0.f) : dp[i];
      dp[i] = (pr * (dpd - sm.dsum[s][c])) * p.scale;
      sc[i] = drop ? (kp ? pr * p.drop.inv_keep : 0.f) : pr;
    }
    to_planes<WALK, T>(da, dp);
#pragma unroll
    for (int kk = 0; kk < WALK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[0][kk][r] = split2<E>(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], pa[1][kk][r]);
    wg_fence();
    for_pd_terms<P>([&](auto a, auto c, bool) {
      const E* dos = sm.dO[s] + (c * D / kPanel) * WALK * kPanel;  // plane c of dO
#pragma unroll
      for (int kk = 0; kk < WALK / 16; ++kk) Mma<D, E>::rs(dv, pa[a][kk], desc_mn<WALK>(dos, kk));
    });
    for_terms<P>([&](auto a, auto c, bool) {
      const E* qs = sm.q[s] + (c * D / kPanel) * WALK * kPanel;  // plane c of Q
#pragma unroll
      for (int kk = 0; kk < WALK / 16; ++kk) Mma<D, E>::rs(dk, da[a][kk], desc_mn<WALK>(qs, kk));
    });
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
template <typename T>
cudaError_t make_maps(CUtensorMap (&m)[4], const Inputs& in, const BwdArgs<T>& a, int D, int q_rows,
                      int k_rows) {
  cudaError_t err;
  if ((err = make_map<T>(&m[0], in.q, a.B, a.S, a.H, D, q_rows, in.st[0])) != cudaSuccess) return err;
  if ((err = make_map<T>(&m[1], in.dO, a.B, a.S, a.H, D, q_rows, in.st[3])) != cudaSuccess) return err;
  if ((err = make_map<T>(&m[2], in.k, a.B, a.S, a.H, D, k_rows, in.st[1])) != cudaSuccess) return err;
  return make_map<T>(&m[3], in.v, a.B, a.S, a.H, D, k_rows, in.st[2]);
}

template <typename T, int D, int NB>
cudaError_t run_head(const Inputs& in, const BwdArgs<T>& a, cudaStream_t st) {
  using E = typename Planes<T>::E;
  constexpr int W = Planes<T>::P * D;
  CUtensorMap m[4];  // q, dO, k, v
  cudaError_t err = make_maps(m, in, a, D, kT, kT);
  if (err != cudaSuccess) return err;
  const size_t smem = (size_t)(NB * 4 * kT * W + 3 * kT * kT) * sizeof(E) + 64 + 1024;
  const auto kernel = encoder_bwd_head<T, D, NB>;
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

template <typename T, int D>
cudaError_t run_streamed(const Inputs& in, const BwdArgs<T>& a, cudaStream_t st) {
  using L = Streamed<T, D>;
  CUtensorMap m[4];
  cudaError_t err = make_maps(m, in, a, D, kT, L::BK);
  if (err != cudaSuccess) return err;
  err = launch(encoder_dq<T, D>, dim3(a.S / kT, a.H, a.B), sizeof(typename L::DqSmem) + 1024, st, m[0],
               m[1], m[2], m[3], a);
  if (err != cudaSuccess || (err = make_maps(m, in, a, D, L::WALK, kT)) != cudaSuccess) return err;
  return launch(encoder_dkv<T, D>, dim3(a.S / kT, a.H, a.B), sizeof(typename L::DkvSmem) + 1024, st,
                m[0], m[1], m[2], m[3], a);
}

// run(T()) for the element type of type code `type` (ENCODER_BWD_TYPES),
// or cudaErrorInvalidValue where none is built.
template <typename Run>
cudaError_t by_type(int type, Run run) {
#define X(TT, CODE) \
  if (type == CODE) return run(TT());
  ENCODER_BWD_TYPES(X)
#undef X
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface (bound with ctypes).  Returns a cudaError_t: 0 on a
// clean launch.  q, k, v, dO: device pointers of [B, S, H, D] views of the
// type of code `type` (ENCODER_BWD_TYPES: 1 bf16, 2 float16, 0 float32),
// 16-byte aligned, with element strides (head, row, batch), each 16 bytes'
// multiple; dq, dk, dv [B, S, H, D] of that type, contiguous.  The whole
// head (S = 128, kHeadFits: a row of q at most 256 bytes) reads nothing
// else.  The streamed pair (every other shape): lse [B * H, S] f32, the
// forward's; stats f32 [2, B * H, S] scratch; bits, with dropout, uint8
// [B * H * S * S / 8] scratch.  seed, thresh and inv_keep are the
// forward's (seed null: no dropout).
extern "C" int encoder_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* dO, const void* lse,
    void* stats, void* bits, void* dq, void* dk, void* dv, int B, int H, int S, int D, long long qh,
    long long qs, long long qb, long long kh, long long ks, long long kb, long long vh, long long vs,
    long long vb, long long dh, long long ds, long long db, float scale, int causal, int type,
    const void* seed, unsigned thresh, float inv_keep, void* stream) {
  if (bad_shape(B, H, S, S, causal) || S % kT != 0 || S > 512) return (int)cudaErrorInvalidValue;
  const Inputs in{q, k, v, dO, {{qh, qs, qb}, {kh, ks, kb}, {vh, vs, vb}, {dh, ds, db}}};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto run = [&](auto t, auto dim) {
    using T = decltype(t);
    constexpr int DD = decltype(dim)::value;
    BwdArgs<T> a{};
    a.dq = static_cast<T*>(dq);
    a.dk = static_cast<T*>(dk);
    a.dv = static_cast<T*>(dv);
    a.lse = static_cast<const float*>(lse);
    a.stats = static_cast<float*>(stats);
    a.bits = static_cast<uint8_t*>(bits);
    a.B = B, a.H = H, a.S = S, a.scale = scale, a.scale_log2 = scale * kLog2e, a.causal = causal;
    a.drop = Drop{static_cast<const int*>(seed), thresh, inv_keep};
    // the whole head at S = 128 where it fits: two heads in flight at
    // W = 64, one at W = 128; every other shape the streamed pair
    if constexpr (kHeadFits<T, DD>) {
      if (S == kT) return run_head<T, DD, Planes<T>::P * DD == 64 ? 2 : 1>(in, a, st);
    }
    if (!lse || !stats || (seed && !bits)) return cudaErrorInvalidValue;
    return run_streamed<T, DD>(in, a, st);
  };
#define X(DD) \
  if (D == DD) return (int)by_type(type, [&](auto t) { return run(t, std::integral_constant<int, DD>()); });
  ENCODER_BWD_DIMS(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* encoder_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
