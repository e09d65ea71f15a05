// FlashAttention forward for Hopper (sm_90a), bf16, float16 and float32,
// head dims 64, 128 and 256.
//
// Replaces: paddle_tpu/ops/flash_attention.py `_fwd_kernel` (launched by
// `_flash_fwd`).  For q [B, Sq, H, D] and k, v [B, Sk, H, D] it writes
// o [B, Sq, H, D] = softmax(scale * q k^T) v and the per-row natural-log
// logsumexp lse [B * H, Sq] (f32) of the scaled scores, which the recompute
// backward and ring attention consume.  Causal masks are bottom-right
// aligned: query i sees keys <= i + Sk - Sq (the caller rejects Sq > Sk).
//
// What bounds it on this card: it straddles the H100's ridge of 295
// operations per byte.  It does 4 * D operations per visible query-key
// pair and must read q, k, v and write o once: 256 operations per byte at
// S = 1024 causal, D = 128 (bytes bound, narrowly), 512 at S = 2048
// (operations bound), so its floor is near both the bytes over 3.35 TB/s
// and the operations over the 989 TFLOP/s of the 16-bit tensor cores
// (bf16 and float16 alike), which only `wgmma` reaches.  Float32 moves
// twice the bytes and does each product as three bf16 products (below):
// operations bound, at generate()'s [4, 1024, 32, 128] causal 103.2 GFLOP,
// 0.1043 ms (its bytes 0.0803 ms), at the training shape [8, 2048, 16, 128]
// causal and the D = 256 LLaMA's [8, 2048, 8, 256] 412.5 GFLOP, 0.4171 ms
// (bytes 0.1606 ms); the f32 FFMA floor of the CUDA-core kernel this one
// replaced at float32: 0.5133 and 2.0523 ms.
//
// What the design does about it (wgmma_attention.cuh): one block per
// (128-row query tile, head, batch), the longest causal walks first.  The
// Q tile comes once by TMA, and K and V tiles of BK keys (128 at D <= 128,
// 64 at D = 256) stay in flight in a TMA ring of three stages (two at
// D = 256) guarded by mbarriers.  Each of two warpgroups owns 64 query
// rows and, per key tile, runs S = Q K^T as `wgmma m64nBKk16` with both operands
// in shared memory, the online softmax in f32 registers (in base-2 units),
// and O += P V as `wgmma m64nDk16` with P rounded to the element type in
// registers as the A operand (the reference rounds p to v's dtype there
// too) and V as an MN-major B operand.  bf16 and float16 run this one
// design, instantiated at the inputs' type T (FLASH_TYPES): the reference
// computes both the same way, products of T operands with f32 sums, and
// the tiles, swizzle, descriptors and registers count 2-byte elements.  Key tiles past a tile's causal end are never loaded;
// only tiles that cross the diagonal or Sk are masked.  Registers: the O
// accumulator takes D / 2 a thread and the S tile BK / 2, within the 255
// that 256 threads a block allow.  Not yet: overlap of one tile's softmax
// with the next tile's products inside a warpgroup.
//
// Float32 runs the same kernel on the tensor cores as split-bf16 products
// (split_bf16.cuh, as the float32 backward kernels do): each f32 tile of
// Q, K and V comes by TMA as it is (a float map of 32-column panels) and
// split_tile rewrites it where it landed into its two bf16 planes, hi =
// RN(x) and lo = RN(x - hi), a bf16 tile of width W = 2 D; S = Q K^T is
// the three bf16 products of SPLIT_BF16_TERMS summed in f32, the softmax
// stays in f32 registers, P is split in registers (to_planes: the
// reference does not round p at float32) and P V is three products against
// V's planes.  No split pass: it would add 8 bytes an element to the 4 the
// kernel must move.  The whole block splits each tile and then syncs, so
// at float32 the warpgroups walk in step.  The layout (Fwd) is picked by
// W, the bytes of a row over 2: at W <= 256 the 2-byte shapes (float32 at
// D = 64 takes bf16's D = 128 layout, 224 KB; at D = 128 bf16's D = 256
// one, 64-key tiles in two stages, 192 KB); at W = 512 (float32 at
// D = 256) a 128-row Q tile alone would take 128 KB, so the block's two
// warpgroups share 64 query rows, each owning one 128-column half of O
// (m64n128 accumulators, 64 registers), and walk 32-key tiles in two
// stages (192 KB), computing S twice (6 D operations a pair where 4 D are
// needed), as the float32 dQ kernel at D = 256 does.  ptxas -v (sm_90a) at
// float32: 202, 161 and 168 registers at D = 64, 128 and 256; no spill.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (paddle_tpu_torch/ops/_build.py does this).

#include "split_bf16.cuh"

// The instantiations, one list each (paddle_tpu_torch/ops/flash_attention.py
// TYPE_CODES and FWD_HEAD_DIMS; a CPU test parses these lines against
// them): (element type, its type code), and the head dims.
#define FLASH_TYPES(X) X(__nv_bfloat16, 1) X(__half, 2) X(float, 0)
#define FLASH_DIMS(X) X(64) X(128) X(256)

namespace {

using namespace split_bf16;

struct FwdArgs {
  void* o;           // [B, Sq, H, D] of the inputs' type
  float* lse;        // [B * H, Sq]
  int H, Sq, Sk;
  float scale_log2;  // scale * log2(e)
  int causal;
};

// The layout at T and D, by W = P D, the elements of a row's planes: 128
// query rows, 64 a warpgroup, walking BK-key tiles through kStages stages;
// at W > 256 (float32 at D = 256) 64 query rows that both warpgroups share,
// each owning CW = D / 2 columns of O.
template <typename T, int D>
struct Fwd {
  using E = typename Planes<T>::E;
  static constexpr int P = Planes<T>::P;
  static constexpr int W = P * D;
  static constexpr bool kSplit = W > 256;             // the warpgroups split D, not the rows
  static constexpr int BQ = kSplit ? 64 : 128;        // query rows per block
  static constexpr int CW = kSplit ? D / 2 : D;       // O columns a warpgroup owns
  static constexpr int BK = W <= 128 ? 128 : (kSplit ? 32 : 64);
  static constexpr int kStages = W <= 128 ? 3 : 2;    // 225 KB at W = 128, 192 KB at 256 and 512
  struct Smem {
    E q[BQ * W];
    E k[kStages][BK * W];
    E v[kStages][BK * W];
    uint64_t q_full;
    Ring<kStages> ring;
  };
  static constexpr size_t kSmem = sizeof(Smem) + 1024;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const FwdArgs p) {
  using F = Fwd<T, D>;
  using E = typename F::E;
  constexpr int BQ = F::BQ, BK = F::BK, kStages = F::kStages, P = F::P, CW = F::CW;
  constexpr int KD = D / 16;  // k-steps of a plane
  typename F::Smem& sm = aligned_smem<typename F::Smem>();
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int off = p.Sk - p.Sq;
  const int kend = p.causal ? min(p.Sk, min(q0 + BQ, p.Sq) + off) : p.Sk;
  const int tiles = (kend + BK - 1) / BK;
  const auto load_kv = [&](int j) {
    uint64_t* full = &sm.ring.full[j % kStages];
    mbar_expect_tx(full, 2 * BK * D * sizeof(T));
    tma_tile<D, BK>(reinterpret_cast<T*>(sm.k[j % kStages]), &tk, full, h, j * BK, b);
    tma_tile<D, BK>(reinterpret_cast<T*>(sm.v[j % kStages]), &tv, full, h, j * BK, b);
  };
  init_ring(&sm.q_full, sm.ring);
  if (threadIdx.x == 0) {
    mbar_expect_tx(&sm.q_full, BQ * D * sizeof(T));
    tma_tile<D, BQ>(reinterpret_cast<T*>(sm.q), &tq, &sm.q_full, h, q0, b);
    for (int j = 0; j < min(tiles, kStages); ++j) load_kv(j);
  }

  const int wg = warpgroup(), warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int wq0 = q0 + (F::kSplit ? 0 : 64 * wg);  // the warpgroup's first query row
  const int row = wq0 + 16 * warp + (lane >> 2);   // this thread's rows: row, row + 8
  const int col0 = F::kSplit ? CW * wg : 0;        // its first O column
  const int last = p.causal ? row + off : kNoLimit;
  const E* qw = sm.q + (wq0 - q0) * kPanel;
  float o[CW / 2];
#pragma unroll
  for (int i = 0; i < CW / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this lane's share

  mbar_wait(&sm.q_full, 0);
  make_planes<T, D, BQ>(sm.q);
  for (int j = 0; j < tiles; ++j) {
    const int s = j % kStages, kb = j * BK;
    wait_full(sm.ring, j);
    make_planes<T, D, BK>(sm.k[s], sm.v[s]);
    float sc[BK / 2];
    wg_fence();
    for_terms<P>([&](auto a, auto c, bool first) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        Mma<BK, E>::ss(sc, desc_k<BQ>(qw, kk + a * KD), desc_k<BK>(sm.k[s], kk + c * KD),
                       !first || kk > 0);
    });
    wg_commit();
    refill(sm.ring, j, tiles, load_kv);
    wg_wait();
    fence_regs(sc);
    const bool edge = kb + BK > p.Sk || (p.causal && kb + BK - 1 > wq0 + off);
    softmax_step<BK, CW>(sc, o, m, l, p.scale_log2, edge, kb, p.Sk, last, t);
    uint32_t pa[P][BK / 16][4];
    to_planes<BK, T>(pa, sc);
    wg_fence();
    for_terms<P>([&](auto a, auto c, bool) {
      // plane c of V, the warpgroup's columns: panels (c D + col0) / 64 on
      const E* vc = sm.v[s] + ((c * D + col0) / kPanel) * BK * kPanel;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) Mma<CW, E>::rs(o, pa[a][kk], desc_mn<BK>(vc, kk));
    });
    wg_commit();
    wg_wait();
    fence_regs(o);
    release(sm.ring, j);
  }

  float inv[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] = quad_sum(l[hr]);
    inv[hr] = 1.f / l[hr];
  }
  store_rows<CW, D>(static_cast<T*>(p.o), o, inv, b, h, row, p.Sq, p.H, t, col0);
  if (t == 0 && col0 == 0) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = row + 8 * hr;
      if (r < p.Sq) p.lse[(size_t)(b * p.H + h) * p.Sq + r] = (m[hr] + log2f(l[hr])) * kLn2;
    }
  }
}

template <typename T, int D>
cudaError_t run_fwd(const void* q, const void* k, const void* v, const FwdArgs& a, int B,
                    cudaStream_t st) {
  using F = Fwd<T, D>;
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  if ((err = make_map<T>(&tq, q, B, a.Sq, a.H, D, F::BQ)) != cudaSuccess) return err;
  if ((err = make_map<T>(&tk, k, B, a.Sk, a.H, D, F::BK)) != cudaSuccess) return err;
  if ((err = make_map<T>(&tv, v, B, a.Sk, a.H, D, F::BK)) != cudaSuccess) return err;
  const dim3 grid((a.Sq + F::BQ - 1) / F::BQ, a.H, B);
  return launch(flash_fwd_kernel<T, D>, grid, F::kSmem, st, tq, tk, tv, a);
}

// run(T()) for the element type of type code `type` (FLASH_TYPES), or
// cudaErrorInvalidValue where none is built.
template <typename Run>
cudaError_t by_type(int type, Run run) {
#define X(TT, CODE) \
  if (type == CODE) return run(TT());
  FLASH_TYPES(X)
#undef X
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface (bound with ctypes).  Returns a cudaError_t: 0 on a
// clean launch.  Pointers are device pointers to contiguous tensors, 16-byte
// aligned (TMA's rule); q, k, v and o of the type of code `type`
// (FLASH_TYPES: 1 bf16, 2 float16, 0 float32), lse f32.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      void* lse, int B, int H, int Sq, int Sk, int D,
                                      float scale, int causal, int type, void* stream) {
  if (bad_shape(B, H, Sq, Sk, causal)) return (int)cudaErrorInvalidValue;
  const FwdArgs a{o, static_cast<float*>(lse), H, Sq, Sk, scale * kLog2e, causal};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define X(DD)                                                                             \
  if (D == DD)                                                                            \
    return (int)by_type(type, [&](auto t) { return run_fwd<decltype(t), DD>(q, k, v, a, B, st); });
  FLASH_DIMS(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
