// FlashAttention backward for Hopper (sm_90a), bf16, float16 and float32,
// head dims 64, 128 and 256: two entry points, one per TPU kernel, the
// dsum pass they share and, at float32, the split pass.
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
// with the reference's roundings (dS and, for dV, P to the inputs' type T,
// a no-op at float32; the scale after the product) and f32 sums.  bf16 and
// float16 run one design, instantiated at T (FLASH_BWD_TYPES): the
// reference computes both the same way, and every tile, descriptor and
// register count below is in 2-byte elements.  Causal masks are
// bottom-right aligned (query i sees keys <= i + Sk - Sq).
//
// Float32 runs the same kernels on the tensor cores as split-bf16
// products.  Each f32 operand x is two bf16 planes, hi = RN(x) and lo =
// RN(x - hi) (about 16 of f32's 24 bits), and each product A B is the sum
// of the terms of SPLIT_BF16_TERMS, A_lo B_hi + A_hi B_lo + A_hi B_hi,
// three bf16 products exact in f32 and summed in f32 (the small terms
// first; A_lo B_lo, under 2^-16 of the rest, is left out): split_bf16.cuh,
// which the encoder backward shares.  The planes of
// q, k, v and dO come from a split pass of their own
// (flash_attention_split: [B, S, H, 2, D] bf16 each, hi then lo along a
// row, so a tile's two planes are neighbouring 64-column panels of one TMA
// map over 2 D columns); the register A operands P and dS are split where
// they are made (to_planes).  dQ, dK and dV are written in f32 from the
// accumulators.
//
// What bounds it on this card: operations.  Per visible query-key pair dQ
// does 3 products (S, dP, dS K: 6 D operations) and dK/dV 4 (S, dP, P^T dO,
// dS^T Q: 8 D); the function's least work is 5 products, 10 D.  At the
// training shape (B 8, H 16, S 2048, D 128, causal) that is 0.35 ms at
// 989 TFLOP/s (bf16 and float16 alike) against 0.16 ms for its bytes (q,
// k, v, o, dO, lse in; dq, dk, dv out) at 3.35 TB/s; the D = 256 shape
// [8, 2048, 8, 256] has the same H D and so the same bounds.  Float32 does
// three bf16 products for each: dq 0.626 ms and dkv 0.834 ms at both
// shapes (the f32 FFMA floor they replace: 3.08 and 4.10 ms).
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
// registers, dQ 197; the statistics pass 48-62 at every instantiation; no
// spill.
//
// Float32 tiles.  Two planes double shared memory against bf16 (4 bytes
// an element), so a float32 tile is a bf16 tile of width W = 2 D, and the
// layouts (Dq, Dkv) are picked by W: at D = 64 the bf16 D = 128 shapes; at
// D = 128 dQ takes the bf16 D = 256 shape (128 own queries, 32-key tiles,
// three stages: 224 KB) and dK/dV 128 own keys walking 32-query tiles
// (m64n32 scores, so that dK and dV's 128 registers, two planes of P^T and
// dS^T and the scores fit in 255; three stages, 224 KB); at D = 256 64 own
// rows of two tensors in two planes already take 128 KB, so both kernels
// put their two warpgroups on the same 64 own rows, each owning one
// 128-column half of the output (dQ as dK/dV above), and walk 32-row tiles
// through one stage (64 KB): a tile's loads wait for the last tile's
// products.  The products read both planes from shared memory, three
// times the bf16 kernel's wgmma a tile (HGMMA by instantiation: the build
// log).
//
// Each block owns its output rows (and columns): no atomics, the same bits
// on every run -- at the price of computing S and dP in both kernels (14 D
// against 10 D above; 18 D at D = 256).  The per-query statistics are a
// small kernel of their own (FlashAttention-2's preprocessing step):
// `stats` [2, B * H, Sqp] holds lse * log2(e) and dsum, zero-padded to Sqp
// = Sq rounded up to 64 so that a walked tile's values are one aligned
// bulk copy.  The autograd backward fills it once and passes `stats_ready`
// to both entries; an entry called alone fills it first.  At float32 the
// split pass reads 4 bytes and writes 4 an element (bytes-bound: about
// 0.32 ms at the training shape), once for both entries.
//
// The statistics pass is bytes-bound: it reads o and dO once (2 D
// elements a query and head against 2 D operations) and lse and dlse, and
// writes the two planes: 0.0410 ms at 3.35 TB/s at the training shape in
// bf16 and float16, 0.0811 in float32 (0.0405 / 0.0806 at [8, 2048, 8,
// 256]).  So it is a stream: a tile is 32 queries of one b and all H heads
// (fewer where B * Sq / 32 tiles would leave SMs idle), whose rows are
// contiguous bytes of o and dO, read in memory order by 256 threads with
// 16-byte read-once loads, a row spread over D * size(T) / 16 lanes (up to
// 32; two loads a lane at float32 D = 256) and four loads of each tensor in
// flight a lane; each row's sum is reduced across its lanes by a fixed xor
// tree into shared memory, and the block then writes both planes as runs of
// 32 (the last run of a b: 64, the pad's zeros included) consecutive
// queries of a head, lse read in the same order.  A block a tile, up to
// eight blocks a SM, then grid-stride.  No atomics: the same bits on every
// run, whatever the grid.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (paddle_tpu_torch/ops/_build.py does this).

#include <algorithm>

#include "split_bf16.cuh"

namespace {

using namespace split_bf16;

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
#define FLASH_BWD_TYPES(X) X(__nv_bfloat16, 1) X(__half, 2) X(float, 0)
constexpr int kOwn = 128;    // own query rows per dQ block, 64 per warpgroup
constexpr int kWalk = 64;    // the statistics' padding: queries per tile of the bf16 dK/dV walk

inline int padded(int Sq) { return (Sq + kWalk - 1) / kWalk * kWalk; }

// dQ's layout at T and D (W = P D elements of a row's planes): 128 own
// queries, 64 a warpgroup, walking BK-key tiles through kStages stages; at
// W > 256 (float32 at D = 256) 64 own queries that both warpgroups share,
// each owning CW = D / 2 columns of dQ, through one stage.
template <typename T, int D>
struct Dq {
  using E = typename Planes<T>::E;
  static constexpr int P = Planes<T>::P;
  static constexpr int W = P * D;
  static constexpr bool kSplit = W > 256;            // the warpgroups split D, not the rows
  static constexpr int OWN = kSplit ? 64 : kOwn;
  static constexpr int CW = kSplit ? D / 2 : D;      // dQ columns a warpgroup owns
  static constexpr int BK = W <= 128 ? 128 : 32;     // keys a walked tile (m64nBK products)
  // 192 KB at W = 128, 224 KB at W = 256, 192 KB at W = 512
  static constexpr int kStages = W <= 128 ? 2 : (kSplit ? 1 : 3);
  struct Smem {
    E q[OWN * W];
    E dO[OWN * W];
    E k[kStages][BK * W];
    E v[kStages][BK * W];
    uint64_t own_full;
    Ring<kStages> ring;
  };
  static constexpr size_t kSmem = sizeof(Smem) + 1024;
};

// dK/dV's layout: OWN own keys walking WALK-query tiles.
template <typename T, int D>
struct Dkv {
  using E = typename Planes<T>::E;
  static constexpr int P = Planes<T>::P;
  static constexpr int W = P * D;
  static constexpr bool kSplit = D > 128;           // the warpgroups split D, not the keys
  static constexpr int OWN = kSplit ? 64 : 128;     // own keys a block
  static constexpr int CW = kSplit ? D / 2 : D;     // dK/dV columns a warpgroup owns
  static constexpr int WALK = P == 1 || W <= 128 ? kWalk : 32;  // queries a walked tile
  // bf16: 160 KB at D = 128, 193 KB at D = 256; float32: 160, 224, 192 KB
  static constexpr int kStages = kSplit ? 3 - P : 3;
  struct Smem {
    E k[OWN * W];
    E v[OWN * W];
    E q[kStages][WALK * W];
    E dO[kStages][WALK * W];
    float lse2[kStages][WALK];  // the walked queries' statistics
    float dsum[kStages][WALK];
    uint64_t own_full;
    Ring<kStages> ring;
  };
  static constexpr size_t kSmem = sizeof(Smem) + 1024;
};

// The statistics pass's shape at T and D: a row of o or dO (one (b, i, h))
// is kPieces 16-byte pieces, read by kLanes neighbouring lanes, kPer
// pieces each; a warp instruction reads kRowsWarp neighbouring rows (512
// contiguous bytes), and a warp loads kGroups such row groups at once, so
// that each lane has four 16-byte loads of each tensor in flight.
template <typename T, int D>
struct Stats {
  static constexpr int kPieces = D * (int)sizeof(T) / 16;
  static constexpr int kLanes = kPieces < 32 ? kPieces : 32;
  static constexpr int kPer = kPieces / kLanes;
  static constexpr int kRowsWarp = 32 / kLanes;
  static constexpr int kGroups = 4 / kPer;
  static constexpr int kRowsStep = kThreads / 32 * kGroups * kRowsWarp;  // rows a block a step
  static_assert(kPieces % kLanes == 0 && kGroups * kPer == 4, "a row is whole 16-byte pieces");
};
constexpr int kRun = 32;          // queries a statistics tile: each head's values as runs of 32
constexpr int kStatsHeads = 256;  // heads a statistics tile at most (32 KB of row sums)

// 16 bytes that are read once: not kept in L1.
__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// acc + the dot product of two 16-byte pieces of T, widened to f32, in
// order.
template <typename T>
__device__ __forceinline__ float dot16(uint4 a, uint4 b, float acc) {
  if constexpr (sizeof(T) == 4) {
    acc = fmaf(__uint_as_float(a.x), __uint_as_float(b.x), acc);
    acc = fmaf(__uint_as_float(a.y), __uint_as_float(b.y), acc);
    acc = fmaf(__uint_as_float(a.z), __uint_as_float(b.z), acc);
    acc = fmaf(__uint_as_float(a.w), __uint_as_float(b.w), acc);
  } else {
    using Pair = typename Elem<T>::Pair;
    const uint32_t wa[4] = {a.x, a.y, a.z, a.w}, wb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      Pair pa, pb;
      memcpy(&pa, &wa[k], 4);
      memcpy(&pb, &wb[k], 4);
      const float2 s = Elem<T>::widen2(pa), t = Elem<T>::widen2(pb);
      acc = fmaf(s.x, t.x, acc);
      acc = fmaf(s.y, t.y, acc);
    }
  }
  return acc;
}

// stats[0][bh][i] = lse[bh][i] * log2(e) and stats[1][bh][i] = sum_d
// dO[b, i, h, d] O[b, i, h, d] in f32 minus dlse[bh][i] when given, for i <
// Sq; zeros for Sq <= i < Sqp (the design: the header).  A tile is kRun
// queries i0.. of one b and the hg heads h0.. of group g (G heads a group);
// its row rr = (i - i0) * hg + h - h0 is in memory order.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_dsum_kernel(const T* o, const T* dO,
                                                              const float* lse,
                                                              const float* dlse, float* stats,
                                                              int B, int H, int Sq, int Sqp,
                                                              int G) {
  using S = Stats<T, D>;
  constexpr int kElems = 16 / (int)sizeof(T);  // elements a piece
  extern __shared__ float sums[];              // [kRun * hg]: the tile's row sums, memory order
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane / S::kLanes, piece = lane % S::kLanes;
  const long long runs = (Sq + kRun - 1) / kRun, groups = (H + G - 1) / G;
  const long long tiles = B * runs * groups;
  float* const dsum = stats + (size_t)B * H * Sqp;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int g = (int)(tile % groups), r = (int)(tile / groups % runs);
    const int b = (int)(tile / groups / runs);
    const int h0 = g * G, hg = min(G, H - h0), i0 = r * kRun;
    const int rows = min(kRun, Sq - i0) * hg;                  // the tile's rows below Sq
    const unsigned long long magic = ((1ull << 32) + hg - 1) / hg;  // rr / hg = rr * magic >> 32
    const size_t tile_at = (((size_t)b * Sq + i0) * H + h0) * D;
    for (int base = warp * S::kGroups * S::kRowsWarp; base < rows; base += S::kRowsStep) {
      uint4 x[S::kGroups][S::kPer], y[S::kGroups][S::kPer];
#pragma unroll
      for (int u = 0; u < S::kGroups; ++u) {
        const int rr = base + u * S::kRowsWarp + sub;
        const int il = (int)((rr * magic) >> 32);
        const size_t at = tile_at + (size_t)(rr + il * (H - hg)) * D + piece * kElems;
#pragma unroll
        for (int p = 0; p < S::kPer; ++p) {
          x[u][p] = y[u][p] = make_uint4(0u, 0u, 0u, 0u);
          if (rr < rows) {
            x[u][p] = ld_stream(dO + at + p * S::kLanes * kElems);
            y[u][p] = ld_stream(o + at + p * S::kLanes * kElems);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < S::kGroups; ++u) {
        float acc = 0.f;
#pragma unroll
        for (int p = 0; p < S::kPer; ++p) acc = dot16<T>(x[u][p], y[u][p], acc);
#pragma unroll
        for (int m = S::kLanes / 2; m; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
        const int rr = base + u * S::kRowsWarp + sub;
        if (piece == 0 && rr < rows) sums[rr] = acc;
      }
    }
    __syncthreads();
    const int n = r == runs - 1 ? Sqp - i0 : kRun;  // 32 or 64: the last run ends at Sqp
    const int shift = n == 64 ? 6 : 5;
    for (int q = threadIdx.x; q < hg * n; q += kThreads) {
      const int hl = q >> shift, il = q & (n - 1), i = i0 + il;
      const size_t bh = (size_t)b * H + h0 + hl, at = bh * Sq + i, out = bh * Sqp + i;
      float l2 = 0.f, ds = 0.f;
      if (i < Sq) {
        l2 = lse[at] * kLog2e;
        ds = sums[il * hg + hl] - (dlse ? dlse[at] : 0.f);
      }
      stats[out] = l2;
      dsum[out] = ds;
    }
    __syncthreads();  // the next tile's sums
  }
}

// The split pass: q, k, v and dO (f32 [B, S, H, D], contiguous; nq values
// each of q and dO, nk of k and v) into their bf16 planes, one after
// another in `planes` (q, k, v, dO, each [B, S, H, 2, D]: a row's D hi
// values, then its D lo values), hi = RN(x), lo = RN(x - hi) (exact
// before the rounding), lo = 0 where hi is not finite.  Each thread takes
// 8 values of one row: two 16-byte loads and a 16-byte store a plane.
// Bytes-bound: 4 bytes read and 4 written an element.
__global__ void __launch_bounds__(256) flash_split_kernel(const float* q, const float* k,
                                                          const float* v, const float* dO,
                                                          bf16* planes, long long nq,
                                                          long long nk, int D) {
  const long long n8 = (2 * nq + 2 * nk) / 8;
  for (long long c = blockIdx.x * 256ll + threadIdx.x; c < n8; c += (long long)gridDim.x * 256) {
    const long long i = 8 * c;  // the value's index over the four tensors
    const float* src = dO;
    long long base = nq + 2 * nk;  // the tensor's first index
    if (i < nq) {
      src = q, base = 0;
    } else if (i < nq + nk) {
      src = k, base = nq;
    } else if (i < nq + 2 * nk) {
      src = v, base = nq + nk;
    }
    const long long e = i - base, row = e / D, col = e % D;
    const float4 x0 = __ldg(reinterpret_cast<const float4*>(src + e));
    const float4 x1 = __ldg(reinterpret_cast<const float4*>(src + e) + 1);
    uint4 hi, lo;
    hi.x = split_pair(x0.x, x0.y, lo.x);
    hi.y = split_pair(x0.z, x0.w, lo.y);
    hi.z = split_pair(x1.x, x1.y, lo.z);
    hi.w = split_pair(x1.z, x1.w, lo.w);
    bf16* dst = planes + 2 * base + row * 2 * D + col;
    *reinterpret_cast<uint4*>(dst) = hi;
    *reinterpret_cast<uint4*>(dst + D) = lo;
  }
}

// dQ for one query tile of OWN rows (grid: query tiles x H x B, the longest
// causal walks first).  Per BK-key tile up to the causal end: P =
// exp(scale S - lse), dS = T(P (dP - dsum)), dQ += dS K; every product
// over the planes' terms (for_terms).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                    const BwdArgs p) {
  using L = Dq<T, D>;
  using E = typename L::E;
  constexpr int BK = L::BK, NS = L::kStages, OWN = L::OWN, W = L::W, CW = L::CW, P = L::P;
  constexpr int KD = D / 16;  // k-steps of a plane
  typename L::Smem& sm = aligned_smem<typename L::Smem>();
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * OWN;
  const int off = p.Sk - p.Sq;
  const int kend = p.causal ? min(p.Sk, min(q0 + OWN, p.Sq) + off) : p.Sk;
  const int tiles = (kend + BK - 1) / BK;
  const auto load_kv = [&](int j) {
    uint64_t* full = &sm.ring.full[j % NS];
    mbar_expect_tx(full, 2 * BK * W * 2);
    tma_tile<W, BK>(sm.k[j % NS], &tk, full, h, j * BK, b);
    tma_tile<W, BK>(sm.v[j % NS], &tv, full, h, j * BK, b);
  };
  init_ring(&sm.own_full, sm.ring);
  if (threadIdx.x == 0) {
    mbar_expect_tx(&sm.own_full, 2 * OWN * W * 2);
    tma_tile<W, OWN>(sm.q, &tq, &sm.own_full, h, q0, b);
    tma_tile<W, OWN>(sm.dO, &tdo, &sm.own_full, h, q0, b);
    for (int j = 0; j < min(tiles, NS); ++j) load_kv(j);
  }

  const int wg = warpgroup(), warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int wq0 = q0 + (L::kSplit ? 0 : 64 * wg);  // the warpgroup's first row
  const int row = wq0 + 16 * warp + (lane >> 2);   // rows row, row + 8
  const int col0 = L::kSplit ? CW * wg : 0;        // its first dQ column
  const int last = p.causal ? row + off : kNoLimit;
  const size_t stat0 = (size_t)(b * p.H + h) * p.Sqp;
  float lse2[2], dsum[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = row + 8 * hr;
    lse2[hr] = r < p.Sq ? p.lse2[stat0 + r] : 0.f;
    dsum[hr] = r < p.Sq ? p.dsum[stat0 + r] : 0.f;
  }
  const E* qw = sm.q + (wq0 - q0) * kPanel;
  const E* dow = sm.dO + (wq0 - q0) * kPanel;
  float dq[CW / 2];
#pragma unroll
  for (int i = 0; i < CW / 2; ++i) dq[i] = 0.f;

  mbar_wait(&sm.own_full, 0);
  for (int j = 0; j < tiles; ++j) {
    const int s = j % NS, kb = j * BK;
    if constexpr (NS == 1) refill(sm.ring, j, tiles, load_kv);  // the one stage: tile j now
    wait_full(sm.ring, j);
    float sc[BK / 2], dp[BK / 2];
    wg_fence();
    for_terms<P>([&](auto a, auto c, bool first) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        Mma<BK, E>::ss(sc, desc_k<OWN>(qw, kk + a * KD), desc_k<BK>(sm.k[s], kk + c * KD),
                       !first || kk > 0);
    });
    wg_commit();
    for_terms<P>([&](auto a, auto c, bool first) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        Mma<BK, E>::ss(dp, desc_k<OWN>(dow, kk + a * KD), desc_k<BK>(sm.v[s], kk + c * KD),
                       !first || kk > 0);
    });
    wg_commit();
    if constexpr (NS > 1) refill(sm.ring, j, tiles, load_kv);
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
    uint32_t da[P][BK / 16][4];
    to_planes<BK, T>(da, sc);
    wg_fence();
    for_terms<P>([&](auto a, auto c, bool) {
      // plane c of K, the warpgroup's columns: panels (c D + col0) / 64 on
      const E* kc = sm.k[s] + ((c * D + col0) / kPanel) * BK * kPanel;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) Mma<CW, E>::rs(dq, da[a][kk], desc_mn<BK>(kc, kk));
    });
    wg_commit();
    wg_wait();
    fence_regs(dq);
    release(sm.ring, j);
  }
  const float mul[2] = {p.scale, p.scale};
  store_rows<CW, D>(static_cast<T*>(p.dq), dq, mul, b, h, row, p.Sq, p.H, t, col0);
}

// dK and dV for one key tile (grid: key tiles x H x B): 128 keys, 64 a
// warpgroup, at D <= 128; 64 keys and one D half of dK and dV a warpgroup
// at D = 256.  It walks the WALK-query tiles from the first that sees a key
// of the tile to Sq.  Per query tile: P^T = exp(scale S^T - lse), dV +=
// T(P^T) dO, dS^T = T(P^T (dP^T - dsum)), dK += dS^T Q; every product over
// the planes' terms.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                     const BwdArgs p) {
  using L = Dkv<T, D>;
  using E = typename L::E;
  constexpr int OWN = L::OWN, CW = L::CW, NS = L::kStages, WALK = L::WALK, W = L::W, P = L::P;
  constexpr int KD = D / 16;
  typename L::Smem& sm = aligned_smem<typename L::Smem>();
  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * OWN;
  const int off = p.Sk - p.Sq;
  const int qstart = p.causal ? max(0, k0 - off) / WALK * WALK : 0;
  const int tiles = (p.Sq - qstart + WALK - 1) / WALK;
  const size_t stat0 = (size_t)(b * p.H + h) * p.Sqp;
  const auto load_q = [&](int j) {
    const int s = j % NS, qb = qstart + j * WALK;
    uint64_t* full = &sm.ring.full[s];
    mbar_expect_tx(full, 2 * WALK * W * 2 + 2 * WALK * 4);
    tma_tile<W, WALK>(sm.q[s], &tq, full, h, qb, b);
    tma_tile<W, WALK>(sm.dO[s], &tdo, full, h, qb, b);
    bulk_load(sm.lse2[s], p.lse2 + stat0 + qb, WALK * 4, full);
    bulk_load(sm.dsum[s], p.dsum + stat0 + qb, WALK * 4, full);
  };
  init_ring(&sm.own_full, sm.ring);
  if (threadIdx.x == 0) {
    mbar_expect_tx(&sm.own_full, 2 * OWN * W * 2);
    tma_tile<W, OWN>(sm.k, &tk, &sm.own_full, h, k0, b);
    tma_tile<W, OWN>(sm.v, &tv, &sm.own_full, h, k0, b);
    for (int j = 0; j < min(tiles, NS); ++j) load_q(j);
  }

  const int wg = warpgroup(), warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int wk0 = k0 + (L::kSplit ? 0 : 64 * wg);  // the warpgroup's first key
  const int key = wk0 + 16 * warp + (lane >> 2);   // keys key, key + 8
  const int col0 = L::kSplit ? CW * wg : 0;        // its first dK/dV column
  const E* kw = sm.k + (wk0 - k0) * kPanel;
  const E* vw = sm.v + (wk0 - k0) * kPanel;
  float dk[CW / 2], dv[CW / 2];
#pragma unroll
  for (int i = 0; i < CW / 2; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(&sm.own_full, 0);
  uint32_t pa[P][WALK / 16][4], da[P][WALK / 16][4];
  for (int j = 0; j < tiles; ++j) {
    const int s = j % NS, qb = qstart + j * WALK;
    if constexpr (NS == 1) {  // the one stage: tile j - 1's products end before tile j loads
      if (j > 0) {
        wg_wait();
        release(sm.ring, j - 1);
        refill(sm.ring, j, tiles, load_q);
      }
    }
    wait_full(sm.ring, j);
    float sc[WALK / 2], dp[WALK / 2];
    wg_fence();
    for_terms<P>([&](auto a, auto c, bool first) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        Mma<WALK, E>::ss(sc, desc_k<OWN>(kw, kk + a * KD), desc_k<WALK>(sm.q[s], kk + c * KD),
                         !first || kk > 0);
    });
    wg_commit();
    for_terms<P>([&](auto a, auto c, bool first) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        Mma<WALK, E>::ss(dp, desc_k<OWN>(vw, kk + a * KD), desc_k<WALK>(sm.dO[s], kk + c * KD),
                         !first || kk > 0);
    });
    wg_commit();
    if constexpr (NS > 1) {
      if (j > 0) {
        wg_wait<2>();  // dK of tile j - 1 is done: its stage is free
        release(sm.ring, j - 1);
        refill(sm.ring, j, tiles, load_q);
      }
    }
    wg_wait<1>();  // S^T is done: P^T and dV while dP^T = V dO^T runs
    fence_regs(sc);
    fence_regs(dv);
    fence_regs(dk);
    const bool edge = qb + WALK > p.Sq || (p.causal && wk0 + 63 > qb + off);
#pragma unroll
    for (int i = 0; i < WALK / 2; ++i) {
      const int c = acc_col(i, t), q = qb + c;
      const float pr = exp2f(sc[i] * p.scale_log2 - sm.lse2[s][c]);
      sc[i] = edge && (q >= p.Sq || (p.causal && key + 8 * acc_half(i) > q + off)) ? 0.f : pr;
    }
    to_planes<WALK, T>(pa, sc);
    wg_fence();
    for_terms<P>([&](auto a, auto c, bool) {
      // plane c of dO, the warpgroup's columns: panels (c D + col0) / 64 on
      const E* dos = sm.dO[s] + ((c * D + col0) / kPanel) * WALK * kPanel;
#pragma unroll
      for (int kk = 0; kk < WALK / 16; ++kk) Mma<CW, E>::rs(dv, pa[a][kk], desc_mn<WALK>(dos, kk));
    });
    wg_commit();
    wg_wait<1>();  // dP^T is done (dV may still run)
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < WALK / 2; ++i) dp[i] = sc[i] * (dp[i] - sm.dsum[s][acc_col(i, t)]);
    to_planes<WALK, T>(da, dp);
    wg_fence();
    for_terms<P>([&](auto a, auto c, bool) {
      const E* qs = sm.q[s] + ((c * D + col0) / kPanel) * WALK * kPanel;
#pragma unroll
      for (int kk = 0; kk < WALK / 16; ++kk) Mma<CW, E>::rs(dk, da[a][kk], desc_mn<WALK>(qs, kk));
    });
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
  float* stats;        // [2, B * H, Sqp]
  const void* planes;  // float32: the split pass's planes of q, k, v, dO; else null
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

// The statistics pass: tiles of all H heads, or of G heads (H halved, and
// halved again) while a tile would hold more than kStatsHeads or the card
// would get under two tiles a SM.
template <typename T, int D>
cudaError_t run_stats(const Inputs& in, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long runs = (in.Sq + kRun - 1) / kRun;
  int G = in.H;
  while (G > 1 && (G > kStatsHeads || in.B * runs * ((in.H + G - 1) / G) < 2ll * sms))
    G = (G + 1) / 2;
  const long long tiles = in.B * runs * ((in.H + G - 1) / G);
  flash_dsum_kernel<T, D><<<(unsigned)std::min(tiles, 8ll * sms), kThreads,
                            kRun * G * sizeof(float), st>>>(
      static_cast<const T*>(in.o), static_cast<const T*>(in.dO),
      static_cast<const float*>(in.lse), static_cast<const float*>(in.dlse), in.stats, in.B,
      in.H, in.Sq, padded(in.Sq), G);
  return cudaGetLastError();
}

// The four TMA maps of what the products read, q and dO with boxes of
// q_rows rows, k and v of k_rows: the inputs themselves, or at float32
// their planes (a [B, S, H, 2 D] bf16 tensor each, in the split pass's
// order).
template <typename T, int D>
cudaError_t make_maps(CUtensorMap (&m)[4], const Inputs& in, int q_rows, int k_rows) {
  using E = typename Planes<T>::E;
  constexpr int W = Planes<T>::P * D;
  const void *q = in.q, *k = in.k, *v = in.v, *dO = in.dO;
  if constexpr (Planes<T>::P > 1) {
    if (!in.planes) return cudaErrorInvalidValue;
    const size_t nq = (size_t)in.B * in.Sq * in.H * W, nk = (size_t)in.B * in.Sk * in.H * W;
    const E* base = static_cast<const E*>(in.planes);
    q = base, k = base + nq, v = base + nq + nk, dO = base + nq + 2 * nk;
  }
  cudaError_t err;
  if ((err = make_map<E>(&m[0], q, in.B, in.Sq, in.H, W, q_rows)) != cudaSuccess) return err;
  if ((err = make_map<E>(&m[1], dO, in.B, in.Sq, in.H, W, q_rows)) != cudaSuccess) return err;
  if ((err = make_map<E>(&m[2], k, in.B, in.Sk, in.H, W, k_rows)) != cudaSuccess) return err;
  return make_map<E>(&m[3], v, in.B, in.Sk, in.H, W, k_rows);
}

template <typename T, int D>
cudaError_t run_dq(const Inputs& in, void* dq, int stats_ready, cudaStream_t st) {
  using L = Dq<T, D>;
  cudaError_t err = stats_ready ? cudaSuccess : run_stats<T, D>(in, st);
  CUtensorMap m[4];
  if (err != cudaSuccess || (err = make_maps<T, D>(m, in, L::OWN, L::BK)) != cudaSuccess)
    return err;
  BwdArgs a = make_args(in);
  a.dq = dq;
  return launch(flash_dq_kernel<T, D>, dim3((in.Sq + L::OWN - 1) / L::OWN, in.H, in.B), L::kSmem,
                st, m[0], m[1], m[2], m[3], a);
}

template <typename T, int D>
cudaError_t run_dkv(const Inputs& in, void* dk, void* dv, int stats_ready, cudaStream_t st) {
  using L = Dkv<T, D>;
  cudaError_t err = stats_ready ? cudaSuccess : run_stats<T, D>(in, st);
  CUtensorMap m[4];
  if (err != cudaSuccess || (err = make_maps<T, D>(m, in, L::WALK, L::OWN)) != cudaSuccess)
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
// (FLASH_BWD_TYPES: 1 bf16, 2 float16, 0 float32), lse, dlse and stats f32;
// dlse may be null; stats is f32 [2, B * H, Sqp] with Sqp = Sq rounded up
// to 64: flash_attention_dsum fills it, and the dq and dkv entries read it
// as it is when stats_ready is non-zero, else fill it first.  At float32
// the dq and dkv entries read their products' operands from `planes`, which
// flash_attention_split fills (null at the other types).
extern "C" int flash_attention_dsum_launch(const void* o, const void* dO, const void* lse,
                                           const void* dlse, void* stats, int B, int H, int Sq,
                                           int D, int type, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return (int)cudaErrorInvalidValue;
  const Inputs in{nullptr, nullptr, nullptr, o, dO, lse, dlse, static_cast<float*>(stats),
                  nullptr, B, H, Sq, Sq, 1.f, 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define X(DD) \
  if (D == DD) return (int)by_type(type, [&](auto t) { return run_stats<decltype(t), DD>(in, st); });
  FLASH_BWD_DIMS(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

// planes: bf16, 2 (2 B Sq H D + 2 B Sk H D) values: the [B, S, H, 2, D]
// planes of q, k, v and dO, one after another.
extern "C" int flash_attention_split_launch(const void* q, const void* k, const void* v,
                                            const void* dO, void* planes, int B, int H, int Sq,
                                            int Sk, int D, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || D <= 0 || D % 8) return (int)cudaErrorInvalidValue;
  const long long nq = (long long)B * Sq * H * D, nk = (long long)B * Sk * H * D;
  const long long blocks = std::min((2 * nq + 2 * nk) / 8 / 256 + 1, 1ll << 20);
  flash_split_kernel<<<(unsigned)blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dO), static_cast<bf16*>(planes), nq, nk, D);
  return (int)cudaGetLastError();
}

extern "C" int flash_attention_dq_launch(const void* q, const void* k, const void* v,
                                         const void* o, const void* dO, const void* lse,
                                         const void* dlse, void* stats, const void* planes,
                                         void* dq, int B, int H, int Sq, int Sk, int D,
                                         float scale, int causal, int stats_ready, int type,
                                         void* stream) {
  if (bad_shape(B, H, Sq, Sk, causal)) return (int)cudaErrorInvalidValue;
  const Inputs in{q, k, v, o, dO, lse, dlse, static_cast<float*>(stats), planes,
                  B, H, Sq, Sk, scale, causal};
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
                                          const void* dlse, void* stats, const void* planes,
                                          void* dk, void* dv, int B, int H, int Sq, int Sk, int D,
                                          float scale, int causal, int stats_ready, int type,
                                          void* stream) {
  if (bad_shape(B, H, Sq, Sk, causal)) return (int)cudaErrorInvalidValue;
  const Inputs in{q, k, v, o, dO, lse, dlse, static_cast<float*>(stats), planes,
                  B, H, Sq, Sk, scale, causal};
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
