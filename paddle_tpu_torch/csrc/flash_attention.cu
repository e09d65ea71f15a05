// FlashAttention forward for Hopper (sm_90a), bf16, head dims 64, 128 and 256.
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
// and the operations over the 989 TFLOP/s of the bf16 tensor cores, which
// only `wgmma` reaches.
//
// What the design does about it (wgmma_attention.cuh): one block per
// (128-row query tile, head, batch), the longest causal walks first.  The
// Q tile comes once by TMA, and K and V tiles of BK keys (128 at D <= 128,
// 64 at D = 256) stay in flight in a TMA ring of three stages (two at
// D = 256) guarded by mbarriers.  Each of two warpgroups owns 64 query
// rows and, per key tile, runs S = Q K^T as `wgmma m64nBKk16` with both operands
// in shared memory, the online softmax in f32 registers (in base-2 units),
// and O += P V as `wgmma m64nDk16` with P rounded to bf16 in registers as
// the A operand (the reference rounds p to v's dtype there too) and V as an
// MN-major B operand.  Key tiles past a tile's causal end are never loaded;
// only tiles that cross the diagonal or Sk are masked.  Registers: the O
// accumulator takes D / 2 a thread and the S tile BK / 2, within the 255
// that 256 threads a block allow.  Not yet: overlap of one tile's softmax
// with the next tile's products inside a warpgroup.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (paddle_tpu_torch/ops/_build.py does this).

#include "wgmma_attention.cuh"

namespace {

using namespace wgmma_attention;

struct FwdArgs {
  bf16* o;           // [B, Sq, H, D]
  float* lse;        // [B * H, Sq]
  int H, Sq, Sk;
  float scale_log2;  // scale * log2(e)
  int causal;
};

template <int D>
struct Fwd {
  static constexpr int BQ = 128;  // query rows per block, 64 per warpgroup
  static constexpr int BK = D <= 128 ? 128 : 64;
  static constexpr int kStages = D <= 128 ? 3 : 2;  // 225 KB and 192 KB at D = 128, 256
  struct Smem {
    bf16 q[BQ * D];
    bf16 k[kStages][BK * D];
    bf16 v[kStages][BK * D];
    uint64_t q_full;
    Ring<kStages> ring;
  };
  static constexpr size_t kSmem = sizeof(Smem) + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const FwdArgs p) {
  constexpr int BQ = Fwd<D>::BQ, BK = Fwd<D>::BK, kStages = Fwd<D>::kStages;
  typename Fwd<D>::Smem& sm = aligned_smem<typename Fwd<D>::Smem>();
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int off = p.Sk - p.Sq;
  const int kend = p.causal ? min(p.Sk, min(q0 + BQ, p.Sq) + off) : p.Sk;
  const int tiles = (kend + BK - 1) / BK;
  const auto load_kv = [&](int j) {
    uint64_t* full = &sm.ring.full[j % kStages];
    mbar_expect_tx(full, 2 * BK * D * 2);
    tma_tile<D, BK>(sm.k[j % kStages], &tk, full, h, j * BK, b);
    tma_tile<D, BK>(sm.v[j % kStages], &tv, full, h, j * BK, b);
  };
  init_ring(&sm.q_full, sm.ring);
  if (threadIdx.x == 0) {
    mbar_expect_tx(&sm.q_full, BQ * D * 2);
    tma_tile<D, BQ>(sm.q, &tq, &sm.q_full, h, q0, b);
    for (int j = 0; j < min(tiles, kStages); ++j) load_kv(j);
  }

  const int wg = warpgroup(), warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int wq0 = q0 + 64 * wg;                   // the warpgroup's first query row
  const int row = wq0 + 16 * warp + (lane >> 2);  // this thread's rows: row, row + 8
  const int last = p.causal ? row + off : kNoLimit;
  const bf16* qw = sm.q + 64 * wg * kPanel;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this lane's share

  mbar_wait(&sm.q_full, 0);
  for (int j = 0; j < tiles; ++j) {
    const int s = j % kStages, kb = j * BK;
    wait_full(sm.ring, j);
    float sc[BK / 2];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Mma<BK>::ss(sc, desc_k<BQ>(qw, kk), desc_k<BK>(sm.k[s], kk), kk > 0);
    wg_commit();
    refill(sm.ring, j, tiles, load_kv);
    wg_wait();
    fence_regs(sc);
    const bool edge = kb + BK > p.Sk || (p.causal && kb + BK - 1 > wq0 + off);
    softmax_step<BK, D>(sc, o, m, l, p.scale_log2, edge, kb, p.Sk, last, t);
    uint32_t pa[BK / 16][4];
    to_a<BK>(pa, sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) Mma<D>::rs(o, pa[kk], desc_mn<BK>(sm.v[s], kk));
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
  store_rows<D>(p.o, o, inv, b, h, row, p.Sq, p.H, t);
  if (t == 0) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = row + 8 * hr;
      if (r < p.Sq) p.lse[(size_t)(b * p.H + h) * p.Sq + r] = (m[hr] + log2f(l[hr])) * kLn2;
    }
  }
}

template <int D>
cudaError_t run_fwd(const void* q, const void* k, const void* v, const FwdArgs& a, int B,
                    cudaStream_t st) {
  using F = Fwd<D>;
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  if ((err = make_map(&tq, q, B, a.Sq, a.H, D, F::BQ)) != cudaSuccess) return err;
  if ((err = make_map(&tk, k, B, a.Sk, a.H, D, F::BK)) != cudaSuccess) return err;
  if ((err = make_map(&tv, v, B, a.Sk, a.H, D, F::BK)) != cudaSuccess) return err;
  const dim3 grid((a.Sq + F::BQ - 1) / F::BQ, a.H, B);
  return launch(flash_fwd_kernel<D>, grid, F::kSmem, st, tq, tk, tv, a);
}

}  // namespace

// Plain C interface (bound with ctypes).  Returns a cudaError_t: 0 on a
// clean launch.  Pointers are device pointers to contiguous tensors, 16-byte
// aligned (TMA's rule).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      void* lse, int B, int H, int Sq, int Sk, int D,
                                      float scale, int causal, void* stream) {
  if (bad_shape(B, H, Sq, Sk, causal)) return (int)cudaErrorInvalidValue;
  const FwdArgs a{static_cast<bf16*>(o), static_cast<float*>(lse), H, Sq, Sk, scale * kLog2e,
                  causal};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return (int)run_fwd<64>(q, k, v, a, B, st);
  if (D == 128) return (int)run_fwd<128>(q, k, v, a, B, st);
  if (D == 256) return (int)run_fwd<256>(q, k, v, a, B, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
