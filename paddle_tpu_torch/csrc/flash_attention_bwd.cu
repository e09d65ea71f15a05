// FlashAttention backward for Hopper (sm_90a), bf16 and float16, head dims
// 64, 128 and 256: two entry points, one per TPU kernel, and the dsum pass
// they share.
//
// Replaces: paddle_tpu/ops/flash_attention.py `_dq_kernel` (entry
// flash_attention_dq) and `_dkv_kernel` (entry flash_attention_dkv), both
// launched by `_flash_bwd`.  From q, k, v [B, S, H, D], the forward's o and
// natural-log lse [B * H, Sq] (f32), the output cotangent dO and, for the
// lse-returning entry, the lse cotangent dlse, they recompute P = exp(scale
// q k^T - lse) and write
//   dQ = scale * T(P (dP - dsum)) k,        dP = dO v^T,
//   dK = scale * T(P (dP - dsum))^T q,      dsum = rowsum(dO * O) - dlse,
//   dV = T(P)^T dO,
// with the reference's roundings (dS and, for dV, P to the inputs' type T;
// the scale after the product) and f32 sums.  bf16 and float16 run one
// design, instantiated at T (FLASH_BWD_TYPES): the reference computes both
// the same way, and every tile, descriptor and register count below is in
// 2-byte elements.  Causal masks are bottom-right aligned (query
// i sees keys <= i + Sk - Sq).
//
// What bounds it on this card: operations.  Per visible query-key pair dQ
// does 3 products (S, dP, dS K: 6 D operations) and dK/dV 4 (S, dP, P^T dO,
// dS^T Q: 8 D); the function's least work is 5 products, 10 D.  At the
// training shape (B 8, H 16, S 2048, D 128, causal) that is 0.35 ms at
// 989 TFLOP/s (bf16 and float16 alike) against 0.16 ms for its bytes (q,
// k, v, o, dO, lse in; dq, dk, dv out) at 3.35 TB/s; the D = 256 shape
// [8, 2048, 8, 256] has the same H D and so the same bounds.
//
// What the design does about it: every product runs on `wgmma`
// (wgmma_attention.cuh), with the forward's block shape: two warpgroups of
// 64 own rows each; the own side comes once by TMA, and the walked side
// stays in flight in a TMA ring.  dQ: one block per 128-row query tile
// walks key tiles of K and V (128 keys in a two-stage ring at D <= 128;
// 32 keys in a three-stage ring at D = 256, where the own Q and dO take
// 128 KB) up to its causal end; S = Q K^T and dP = dO V^T from shared
// memory, then dQ += dS K with dS as the register A operand and K MN-major
// (m64nDk16: 128 f32 registers a thread at D = 256).  dK/dV at D <= 128:
// one block per 128-key tile walks 64-query tiles of Q and dO (a
// three-stage ring; their lse and dsum come by bulk copy beside them) from
// its causal start; S^T = K Q^T and dP^T = V dO^T from shared memory, then
// dV += T(P)^T dO and dK += dS^T Q from registers.  The products go in
// separate commit groups, so P is computed while dP still runs and dS while
// dV runs, and the dK/dV kernel waits for a tile's dK product only once the
// next tile's S^T and dP^T are queued behind it.
//
// dK/dV at D = 256: wgmma's 64-row minimum makes a warpgroup's dK and dV
// m64n256 each, 256 f32 registers a thread before anything else, above the
// 255 a thread can have.  Of the two ways to split them, this kernel takes
// the D halves (one block's two warpgroups own the same 64 keys, each one
// 128-column half of dK and of dV: 128 registers), not the exchange of P
// and dS between a warpgroup that computes S^T and one that computes dP^T:
// each warpgroup recomputes S^T and dP^T over the whole D (12 D operations
// a pair against 8 D), but the warpgroups never wait for each other inside
// a tile, and the walked Q and dO tiles, loaded once a block, feed both
// halves.  64 own keys at D = 256 take 64 KB and each stage of the 64-query
// ring another 64 KB: two stages.  ptxas -v (sm_90a) at D = 256: dK/dV 250
// registers, dQ 197, the statistics pass 27; no spill.
//
// Each block owns its output rows (and columns): no atomics, the same bits
// on every run -- at the price of computing S and dP in both kernels (14 D
// against 10 D above; 18 D at D = 256).  The per-query statistics are a
// small kernel of their own (FlashAttention-2's preprocessing step):
// `stats` [2, B * H, Sqp] holds lse * log2(e) and dsum, zero-padded to Sqp
// = Sq rounded up to 64 so that a walked tile's 64 values are one aligned
// bulk copy.  The autograd backward fills it once and passes `stats_ready`
// to both entries; an entry called alone fills it first.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (paddle_tpu_torch/ops/_build.py does this).

#include "wgmma_attention.cuh"

namespace {

using namespace wgmma_attention;

struct BwdArgs {
  const float* lse2;  // [B * H, Sqp]: lse * log2(e), 0 past Sq
  const float* dsum;  // [B * H, Sqp]: rowsum(dO * O) - dlse, 0 past Sq
  void* dq;           // [B, Sq, H, D] of the inputs' type
  void* dk;           // [B, Sk, H, D]
  void* dv;
  int H, Sq, Sk, Sqp;
  float scale;
  float scale_log2;   // scale * log2(e)
  int causal;
};

// The head dims and the (element type, type code)s built, one list each
// (paddle_tpu_torch/ops/flash_attention.py BWD_HEAD_DIMS and TYPE_CODES; a
// CPU test parses these lines against them).
#define FLASH_BWD_DIMS(X) X(64) X(128) X(256)
#define FLASH_BWD_TYPES(X) X(__nv_bfloat16, 1) X(__half, 2)

constexpr int kOwn = 128;    // own query rows per dQ block, 64 per warpgroup
constexpr int kWalk = 64;    // queries per tile of the dK/dV walk

inline int padded(int Sq) { return (Sq + kWalk - 1) / kWalk * kWalk; }

template <typename T, int D>
struct Dq {
  static constexpr int BK = D <= 128 ? 128 : 32;     // keys a walked tile (m64nBK products)
  static constexpr int kStages = D <= 128 ? 2 : 3;  // 192 KB at D = 128, 224 KB at D = 256
  struct Smem {
    T q[kOwn * D];
    T dO[kOwn * D];
    T k[kStages][BK * D];
    T v[kStages][BK * D];
    uint64_t own_full;
    Ring<kStages> ring;
  };
  static constexpr size_t kSmem = sizeof(Smem) + 1024;
};

template <typename T, int D>
struct Dkv {
  static constexpr bool kSplit = D > 128;           // the warpgroups split D, not the keys
  static constexpr int OWN = kSplit ? 64 : 128;     // own keys a block
  static constexpr int CW = kSplit ? D / 2 : D;     // dK/dV columns a warpgroup owns
  static constexpr int kStages = kSplit ? 2 : 3;    // 160 KB at D = 128, 193 KB at D = 256
  struct Smem {
    T k[OWN * D];
    T v[OWN * D];
    T q[kStages][kWalk * D];
    T dO[kStages][kWalk * D];
    float lse2[kStages][kWalk];  // the walked queries' statistics
    float dsum[kStages][kWalk];
    uint64_t own_full;
    Ring<kStages> ring;
  };
  static constexpr size_t kSmem = sizeof(Smem) + 1024;
};

// stats[0][bh][i] = lse[bh][i] * log2(e) and stats[1][bh][i] = sum_d
// dO[b, i, h, d] O[b, i, h, d] in f32 minus dlse[bh][i] when given, for i <
// Sq; zeros for Sq <= i < Sqp.  One warp per (bh, i).
template <typename T, int D>
__global__ void __launch_bounds__(128) flash_dsum_kernel(const T* o, const T* dO,
                                                         const float* lse, const float* dlse,
                                                         float* stats, int rows, int H, int Sq,
                                                         int Sqp) {
  using Pair = typename Elem<T>::Pair;
  const int row = blockIdx.x * 4 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps leave together
  const int i = row % Sqp, bh = row / Sqp;
  float acc = 0.f;
  if (i < Sq) {
    const size_t base = ((size_t)((bh / H) * Sq + i) * H + bh % H) * D;
    const Pair* x = reinterpret_cast<const Pair*>(dO + base);
    const Pair* y = reinterpret_cast<const Pair*>(o + base);
    for (int j = lane; j < D / 2; j += 32) {
      const float2 a = Elem<T>::widen2(x[j]), c = Elem<T>::widen2(y[j]);
      acc += a.x * c.x + a.y * c.y;
    }
  }
#pragma unroll
  for (int m = 16; m; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) {
    const size_t at = (size_t)bh * Sq + i;
    stats[row] = i < Sq ? lse[at] * kLog2e : 0.f;
    stats[(size_t)rows + row] = i < Sq ? acc - (dlse ? dlse[at] : 0.f) : 0.f;
  }
}

// dQ for one 128-row query tile (grid: query tiles x H x B, the longest
// causal walks first).  Per BK-key tile up to the causal end: P =
// exp(scale S - lse), dS = T(P (dP - dsum)), dQ += dS K.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                    const BwdArgs p) {
  using L = Dq<T, D>;
  constexpr int BK = L::BK, NS = L::kStages;
  typename L::Smem& sm = aligned_smem<typename L::Smem>();
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kOwn;
  const int off = p.Sk - p.Sq;
  const int kend = p.causal ? min(p.Sk, min(q0 + kOwn, p.Sq) + off) : p.Sk;
  const int tiles = (kend + BK - 1) / BK;
  const auto load_kv = [&](int j) {
    uint64_t* full = &sm.ring.full[j % NS];
    mbar_expect_tx(full, 2 * BK * D * 2);
    tma_tile<D, BK>(sm.k[j % NS], &tk, full, h, j * BK, b);
    tma_tile<D, BK>(sm.v[j % NS], &tv, full, h, j * BK, b);
  };
  init_ring(&sm.own_full, sm.ring);
  if (threadIdx.x == 0) {
    mbar_expect_tx(&sm.own_full, 2 * kOwn * D * 2);
    tma_tile<D, kOwn>(sm.q, &tq, &sm.own_full, h, q0, b);
    tma_tile<D, kOwn>(sm.dO, &tdo, &sm.own_full, h, q0, b);
    for (int j = 0; j < min(tiles, NS); ++j) load_kv(j);
  }

  const int wg = warpgroup(), warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int wq0 = q0 + 64 * wg;
  const int row = wq0 + 16 * warp + (lane >> 2);  // rows row, row + 8
  const int last = p.causal ? row + off : kNoLimit;
  const size_t stat0 = (size_t)(b * p.H + h) * p.Sqp;
  float lse2[2], dsum[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = row + 8 * hr;
    lse2[hr] = r < p.Sq ? p.lse2[stat0 + r] : 0.f;
    dsum[hr] = r < p.Sq ? p.dsum[stat0 + r] : 0.f;
  }
  const T* qw = sm.q + 64 * wg * kPanel;
  const T* dow = sm.dO + 64 * wg * kPanel;
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  mbar_wait(&sm.own_full, 0);
  for (int j = 0; j < tiles; ++j) {
    const int s = j % NS, kb = j * BK;
    wait_full(sm.ring, j);
    float sc[BK / 2], dp[BK / 2];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Mma<BK, T>::ss(sc, desc_k<kOwn>(qw, kk), desc_k<BK>(sm.k[s], kk), kk > 0);
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Mma<BK, T>::ss(dp, desc_k<kOwn>(dow, kk), desc_k<BK>(sm.v[s], kk), kk > 0);
    wg_commit();
    refill(sm.ring, j, tiles, load_kv);
    wg_wait<1>();  // S is done: P while dP = dO V^T runs
    fence_regs(sc);
    const bool edge = kb + BK > p.Sk || (p.causal && kb + BK - 1 > wq0 + off);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int hr = acc_half(i), key = kb + acc_col(i, t);
      const float pr = exp2f(sc[i] * p.scale_log2 - lse2[hr]);
      sc[i] = edge && (key >= p.Sk || key > last + 8 * hr) ? 0.f : pr;
    }
    wg_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] *= dp[i] - dsum[acc_half(i)];
    uint32_t da[BK / 16][4];
    to_a<BK, T>(da, sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) Mma<D, T>::rs(dq, da[kk], desc_mn<BK>(sm.k[s], kk));
    wg_commit();
    wg_wait();
    fence_regs(dq);
    release(sm.ring, j);
  }
  const float mul[2] = {p.scale, p.scale};
  store_rows<D>(static_cast<T*>(p.dq), dq, mul, b, h, row, p.Sq, p.H, t);
}

// dK and dV for one key tile (grid: key tiles x H x B): 128 keys, 64 a
// warpgroup, at D <= 128; 64 keys and one D half of dK and dV a warpgroup
// at D = 256.  It walks the 64-query tiles from the first that sees a key
// of the tile to Sq.  Per query tile: P^T = exp(scale S^T - lse), dV +=
// T(P^T) dO, dS^T = T(P^T (dP^T - dsum)), dK += dS^T Q.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                     const BwdArgs p) {
  using L = Dkv<T, D>;
  constexpr int OWN = L::OWN, CW = L::CW, NS = L::kStages;
  typename L::Smem& sm = aligned_smem<typename L::Smem>();
  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * OWN;
  const int off = p.Sk - p.Sq;
  const int qstart = p.causal ? max(0, k0 - off) / kWalk * kWalk : 0;
  const int tiles = (p.Sq - qstart + kWalk - 1) / kWalk;
  const size_t stat0 = (size_t)(b * p.H + h) * p.Sqp;
  const auto load_q = [&](int j) {
    const int s = j % NS, qb = qstart + j * kWalk;
    uint64_t* full = &sm.ring.full[s];
    mbar_expect_tx(full, 2 * kWalk * D * 2 + 2 * kWalk * 4);
    tma_tile<D, kWalk>(sm.q[s], &tq, full, h, qb, b);
    tma_tile<D, kWalk>(sm.dO[s], &tdo, full, h, qb, b);
    bulk_load(sm.lse2[s], p.lse2 + stat0 + qb, kWalk * 4, full);
    bulk_load(sm.dsum[s], p.dsum + stat0 + qb, kWalk * 4, full);
  };
  init_ring(&sm.own_full, sm.ring);
  if (threadIdx.x == 0) {
    mbar_expect_tx(&sm.own_full, 2 * OWN * D * 2);
    tma_tile<D, OWN>(sm.k, &tk, &sm.own_full, h, k0, b);
    tma_tile<D, OWN>(sm.v, &tv, &sm.own_full, h, k0, b);
    for (int j = 0; j < min(tiles, NS); ++j) load_q(j);
  }

  const int wg = warpgroup(), warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int wk0 = k0 + (L::kSplit ? 0 : 64 * wg);  // the warpgroup's first key
  const int key = wk0 + 16 * warp + (lane >> 2);   // keys key, key + 8
  const int col0 = L::kSplit ? CW * wg : 0;        // its first dK/dV column
  const T* kw = sm.k + (wk0 - k0) * kPanel;
  const T* vw = sm.v + (wk0 - k0) * kPanel;
  float dk[CW / 2], dv[CW / 2];
#pragma unroll
  for (int i = 0; i < CW / 2; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(&sm.own_full, 0);
  uint32_t pa[kWalk / 16][4], da[kWalk / 16][4];
  for (int j = 0; j < tiles; ++j) {
    const int s = j % NS, qb = qstart + j * kWalk;
    wait_full(sm.ring, j);
    float sc[kWalk / 2], dp[kWalk / 2];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Mma<kWalk, T>::ss(sc, desc_k<OWN>(kw, kk), desc_k<kWalk>(sm.q[s], kk), kk > 0);
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Mma<kWalk, T>::ss(dp, desc_k<OWN>(vw, kk), desc_k<kWalk>(sm.dO[s], kk), kk > 0);
    wg_commit();
    if (j > 0) {
      wg_wait<2>();  // dK of tile j - 1 is done: its stage is free
      release(sm.ring, j - 1);
      refill(sm.ring, j, tiles, load_q);
    }
    wg_wait<1>();  // S^T is done: P^T and dV while dP^T = V dO^T runs
    fence_regs(sc);
    fence_regs(dv);
    fence_regs(dk);
    const bool edge = qb + kWalk > p.Sq || (p.causal && wk0 + 63 > qb + off);
#pragma unroll
    for (int i = 0; i < kWalk / 2; ++i) {
      const int c = acc_col(i, t), q = qb + c;
      const float pr = exp2f(sc[i] * p.scale_log2 - sm.lse2[s][c]);
      sc[i] = edge && (q >= p.Sq || (p.causal && key + 8 * acc_half(i) > q + off)) ? 0.f : pr;
    }
    to_a<kWalk, T>(pa, sc);
    // the warpgroup's columns of dO and Q: panels col0 / 64 on
    const T* dos = sm.dO[s] + (col0 / kPanel) * kWalk * kPanel;
    const T* qs = sm.q[s] + (col0 / kPanel) * kWalk * kPanel;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kWalk / 16; ++kk) Mma<CW, T>::rs(dv, pa[kk], desc_mn<kWalk>(dos, kk));
    wg_commit();
    wg_wait<1>();  // dP^T is done (dV may still run)
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < kWalk / 2; ++i) dp[i] = sc[i] * (dp[i] - sm.dsum[s][acc_col(i, t)]);
    to_a<kWalk, T>(da, dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kWalk / 16; ++kk) Mma<CW, T>::rs(dk, da[kk], desc_mn<kWalk>(qs, kk));
    wg_commit();
  }
  wg_wait();
  fence_regs(dv);
  fence_regs(dk);
  const float kmul[2] = {p.scale, p.scale}, one[2] = {1.f, 1.f};
  store_rows<CW, D>(static_cast<T*>(p.dk), dk, kmul, b, h, key, p.Sk, p.H, t, col0);
  store_rows<CW, D>(static_cast<T*>(p.dv), dv, one, b, h, key, p.Sk, p.H, t, col0);
}

struct Inputs {
  const void *q, *k, *v, *o, *dO, *lse, *dlse;
  float* stats;  // [2, B * H, Sqp]
  int B, H, Sq, Sk;
  float scale;
  int causal;
};

BwdArgs make_args(const Inputs& in) {
  BwdArgs a{};
  a.Sqp = padded(in.Sq);
  a.lse2 = in.stats;
  a.dsum = in.stats + (size_t)in.B * in.H * a.Sqp;
  a.H = in.H, a.Sq = in.Sq, a.Sk = in.Sk;
  a.scale = in.scale, a.scale_log2 = in.scale * kLog2e, a.causal = in.causal;
  return a;
}

template <typename T, int D>
cudaError_t run_stats(const Inputs& in, cudaStream_t st) {
  const int Sqp = padded(in.Sq), rows = in.B * in.H * Sqp;
  flash_dsum_kernel<T, D><<<(rows + 3) / 4, 128, 0, st>>>(
      static_cast<const T*>(in.o), static_cast<const T*>(in.dO),
      static_cast<const float*>(in.lse), static_cast<const float*>(in.dlse), in.stats, rows,
      in.H, in.Sq, Sqp);
  return cudaGetLastError();
}

// The four TMA maps: q and dO with boxes of q_rows rows, k and v of k_rows.
template <typename T>
cudaError_t make_maps(CUtensorMap (&m)[4], const Inputs& in, int D, int q_rows, int k_rows) {
  cudaError_t err;
  if ((err = make_map<T>(&m[0], in.q, in.B, in.Sq, in.H, D, q_rows)) != cudaSuccess) return err;
  if ((err = make_map<T>(&m[1], in.dO, in.B, in.Sq, in.H, D, q_rows)) != cudaSuccess) return err;
  if ((err = make_map<T>(&m[2], in.k, in.B, in.Sk, in.H, D, k_rows)) != cudaSuccess) return err;
  return make_map<T>(&m[3], in.v, in.B, in.Sk, in.H, D, k_rows);
}

template <typename T, int D>
cudaError_t run_dq(const Inputs& in, void* dq, int stats_ready, cudaStream_t st) {
  using L = Dq<T, D>;
  cudaError_t err = stats_ready ? cudaSuccess : run_stats<T, D>(in, st);
  CUtensorMap m[4];
  if (err != cudaSuccess || (err = make_maps<T>(m, in, D, kOwn, L::BK)) != cudaSuccess) return err;
  BwdArgs a = make_args(in);
  a.dq = dq;
  return launch(flash_dq_kernel<T, D>, dim3((in.Sq + kOwn - 1) / kOwn, in.H, in.B), L::kSmem, st,
                m[0], m[1], m[2], m[3], a);
}

template <typename T, int D>
cudaError_t run_dkv(const Inputs& in, void* dk, void* dv, int stats_ready, cudaStream_t st) {
  using L = Dkv<T, D>;
  cudaError_t err = stats_ready ? cudaSuccess : run_stats<T, D>(in, st);
  CUtensorMap m[4];
  if (err != cudaSuccess || (err = make_maps<T>(m, in, D, kWalk, L::OWN)) != cudaSuccess)
    return err;
  BwdArgs a = make_args(in);
  a.dk = dk;
  a.dv = dv;
  return launch(flash_dkv_kernel<T, D>, dim3((in.Sk + L::OWN - 1) / L::OWN, in.H, in.B), L::kSmem,
                st, m[0], m[1], m[2], m[3], a);
}

// run(T()) for the element type of type code `type` (FLASH_BWD_TYPES), or
// cudaErrorInvalidValue where none is built.
template <typename Run>
cudaError_t by_type(int type, Run run) {
#define X(TT, CODE) \
  if (type == CODE) return run(TT());
  FLASH_BWD_TYPES(X)
#undef X
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface (bound with ctypes).  Each returns a cudaError_t: 0 on a
// clean launch.  Pointers are device pointers to contiguous tensors, 16-byte
// aligned: q, k, v, o, dO and the gradients of the type of code `type`
// (FLASH_BWD_TYPES: 1 bf16, 2 float16), lse, dlse and stats f32; dlse may
// be null; stats is f32 [2, B * H, Sqp] with Sqp = Sq
// rounded up to 64: flash_attention_dsum fills it, and the dq and dkv
// entries read it as it is when stats_ready is non-zero, else fill it first.
extern "C" int flash_attention_dsum_launch(const void* o, const void* dO, const void* lse,
                                           const void* dlse, void* stats, int B, int H, int Sq,
                                           int D, int type, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return (int)cudaErrorInvalidValue;
  const Inputs in{nullptr, nullptr, nullptr, o, dO, lse, dlse, static_cast<float*>(stats),
                  B, H, Sq, Sq, 1.f, 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define X(DD) \
  if (D == DD) return (int)by_type(type, [&](auto t) { return run_stats<decltype(t), DD>(in, st); });
  FLASH_BWD_DIMS(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_dq_launch(const void* q, const void* k, const void* v,
                                         const void* o, const void* dO, const void* lse,
                                         const void* dlse, void* stats, void* dq, int B, int H,
                                         int Sq, int Sk, int D, float scale, int causal,
                                         int stats_ready, int type, void* stream) {
  if (bad_shape(B, H, Sq, Sk, causal)) return (int)cudaErrorInvalidValue;
  const Inputs in{q, k, v, o, dO, lse, dlse, static_cast<float*>(stats), B, H, Sq, Sk, scale, causal};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define X(DD)                                                                          \
  if (D == DD)                                                                         \
    return (int)by_type(type,                                                          \
                        [&](auto t) { return run_dq<decltype(t), DD>(in, dq, stats_ready, st); });
  FLASH_BWD_DIMS(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_dkv_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dO, const void* lse,
                                          const void* dlse, void* stats, void* dk, void* dv,
                                          int B, int H, int Sq, int Sk, int D, float scale,
                                          int causal, int stats_ready, int type, void* stream) {
  if (bad_shape(B, H, Sq, Sk, causal)) return (int)cudaErrorInvalidValue;
  const Inputs in{q, k, v, o, dO, lse, dlse, static_cast<float*>(stats), B, H, Sq, Sk, scale, causal};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define X(DD)                                                                           \
  if (D == DD)                                                                          \
    return (int)by_type(                                                                \
        type, [&](auto t) { return run_dkv<decltype(t), DD>(in, dk, dv, stats_ready, st); });
  FLASH_BWD_DIMS(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
