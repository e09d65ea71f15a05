// Short-sequence self-attention forward for Hopper (sm_90a), bf16,
// float16 and float32, head dims 64 and 128, with dropout of the
// probabilities.
//
// Replaces: paddle_tpu/ops/encoder_attention.py `_fwd_kernel` (launched by
// `_attn_fwd`).  For q, k, v [B, S, H, D] with S % 128 == 0 and S <= 512, it
// writes o [B, S, H, D] = P v with P = softmax(scale * q k^T) taken over
// each whole row, optionally causal, exactly as the reference does: the
// row's max and sum come first, then P = exp(s - m) / l; with dropout
// (rate > 0) P becomes where(keep, P / (1 - rate), 0); then P is rounded to
// v's type and multiplied by V, with no division afterwards.  The keep mask is
// Philox (philox.cuh: element (bh, i, j) reads counter (oct(i), oct(j), bh,
// 0)), drawn once per element from the seed pair the backward reads again.
// It also writes the rows' natural-log logsumexp lse [B * H, S] (f32), which
// the backward's streamed kernels read.  q, k and v may be views with any
// 16-byte-multiple row and batch strides (head stride D), such as the three
// slices of one packed [B, S, 3, H, D] tensor: TMA reads them in place.
//
// What bounds it on this card: bytes.  It does 4 D operations per visible
// query-key pair and must read q, k, v and write o once: at the ERNIE
// shape (B 512, H 12, S 128, D 64, dropout 0.1) 403 MB, 0.120 ms at
// 3.35 TB/s (0.1211 ms with the lse the chip check counts), against
// 0.013 ms of tensor-core work; its 25.2 M Philox calls (40 32-bit
// multiplies each) take 0.060 ms at the card's 16.7 T multiplies/s.
// float16 moves the same bytes and runs on the same 989 TFLOP/s of the
// 16-bit tensor cores: its bound at the ERNIE shape is the bf16 one,
// 0.1211 ms.  At the LLaMA train_s512 microbatch (B 16, H 16, S 512,
// D 128, causal) 134 MB, 0.040 ms, against 0.009 ms of tensor-core work.
// float32 moves twice the bytes and does each product as three bf16
// products: at the ERNIE shape 808.5 MB with the lse, 0.2413 ms, against
// 77.3 GFLOP, 0.0782 ms, on the tensor cores; at the LLaMA microbatch
// 269.0 MB, 0.0803 ms, against 51.6 GFLOP, 0.0522 ms (the f32 FFMA floor
// of the CUDA-core kernel this one replaced at float32: 0.3846 and
// 0.2569 ms).
//
// What the design does about it: products on `wgmma`, loads by TMA
// (wgmma_attention.cuh), blocks of two warpgroups, each owning 64 query
// rows of a 128-row query tile; 128-key tiles, so a warpgroup's score block
// is an m64n128 accumulator, 64 registers a thread.  Two regimes, by the
// bytes of a head (W = the 2-byte elements of a row, D, or 2 D at
// float32):
//  * resident, S * W <= 32768 (S <= 256 at D 128, S <= 512 at D 64; at
//    float32 half that): a head's Q, K and V (3 S W elements, at most
//    192 KB) fit one block's shared memory.  A persistent grid walks the
//    heads; each block loads a whole head by TMA, walks its query tiles
//    with K and V resident, and, where two heads fit (S * W <= 16384, the
//    ERNIE shape at every type: 2 x 48 KB, at float32 2 x 96 KB), loads
//    the next head while it computes this one.  K and V come from device
//    memory once per head.
//  * streamed, S * W > 32768 (S 384 and 512 at D 128; at float32 S >= 256
//    at D 128 and S >= 384 at D 64): one block per (query tile, head), in
//    head-major order so that the query tiles of a head run together and
//    re-read its K and V from L2; K and V tiles stream through a two-stage
//    TMA ring (128 keys a tile, but 64 at W = 256, float32 at D 128, whose
//    128-key tiles would take 64 KB each).
// A row that lies in one key tile (S = 128, or the first causal query
// tile) takes one pass: its exact max and sum come from registers, and P
// goes from the accumulator to the A operand of P V (to_a) without leaving
// registers.  A longer row takes the exact-order two passes, each row's
// max and sum first (online over the key tiles, K only), then the scores
// again, P = exp(s - m) / l, the mask, and P V: the second Q K^T costs
// about 0.009 ms of tensor time at train_s512 against 0.040 ms of bytes.
// Causal blocks stop at their diagonal tile.  At rate 0 no mask is drawn.
// bf16 and float16 run this one design, instantiated at the inputs' type T
// (ENCODER_TYPES): the reference computes both alike, products of T
// operands with f32 sums and P rounded to T, and the tiles, swizzle,
// descriptors and registers count 2-byte elements.
//
// Float32 runs the same kernels as split-bf16 products (split_bf16.cuh, as
// the float32 backward kernels do): each f32 tile comes by TMA as it is (so
// the strided q, k, v of a packed projection are read in place, and no
// split pass adds 8 bytes an element to the 16 the kernel must move) and
// split_tile rewrites it where it landed into its bf16 planes, hi = RN(x)
// and lo = RN(x - hi); S = Q K^T is the three bf16 products of
// SPLIT_BF16_TERMS summed in f32; the softmax, in the same two-pass order,
// stays in f32; the Philox mask is applied to P in f32 (the same element to
// counter map, so one seed gives one mask at every type); then P is split
// in registers (to_planes: the reference does not round p at float32) and
// P V is three products against V's planes.  The whole block splits each
// tile and syncs, so the warpgroups walk in step.  ptxas -v (sm_90a) at
// float32, registers a thread: resident 224 (two heads) and 232 (one) at
// D 64, 242 at D 128; streamed 218 and 182 at D 64 and 128; no spill.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (paddle_tpu_torch/ops/_build.py does this).

#include "encoder_wgmma.cuh"
#include "split_bf16.cuh"

// The instantiations, one list each (paddle_tpu_torch/ops/_admit.py
// TC_TYPE_CODES and ENCODER_DIMS; a CPU test parses these lines against
// them): (element type, its type code), and the head dims.
#define ENCODER_TYPES(X) X(__nv_bfloat16, 1) X(__half, 2) X(float, 0)
#define ENCODER_DIMS(X) X(64) X(128)

namespace {

using namespace encoder_wgmma;
using namespace split_bf16;

template <typename T>
struct FwdArgs {
  T* o;        // [B, S, H, D], contiguous
  float* lse;  // [B * H, S]
  int B, H, S;
  float scale_log2;  // scale * log2(e)
  int causal;
  Drop drop;
};

// One warpgroup's 64 query rows from wq0 (a multiple of 64) of head (b, h):
// o = T(dropout(P)) V over the `nt` key tiles of BK keys its rows see, each
// product over the planes' terms (for_terms).  `qw`: its rows of the
// 128-row Q tile.  `tiles` gives the K and V tile of ring use u (k(u),
// v(u)) and waits for and frees them (acquire(u), after_issue(u),
// release(u)): pass 1 of a two-pass row uses u = 0 .. nt - 1 (K only),
// pass 2 u = nt .. 2 nt - 1; a one-pass row uses u = 0 (K and V).
template <typename T, int D, int BK, typename Tiles>
__device__ __forceinline__ void attend_rows(const typename Planes<T>::E* qw, int nt, Tiles& tiles,
                                            const FwdArgs<T>& p, int bh, int b, int h, int wq0,
                                            uint2 key) {
  using E = typename Planes<T>::E;
  constexpr int P = Planes<T>::P, KD = D / 16;  // KD: k-steps of a plane
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, t = lane & 3;
  const int row = wq0 + 16 * warp + (lane >> 2);  // this thread's rows: row, row + 8
  float sc[BK / 2], o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2], l[2];

  const auto scores = [&](int u, int kb) {
    tiles.acquire(u);
    wg_fence();
    for_terms<P>([&](auto a, auto c, bool first) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        Mma<BK, E>::ss(sc, desc_k<kT>(qw, kk + a * KD), desc_k<BK>(tiles.k(u), kk + c * KD),
                       !first || kk > 0);
    });
    wg_commit();
    tiles.after_issue(u);
    wg_wait();
    fence_regs(sc);
    scale_mask(sc, p.scale_log2, p.causal && kb + BK - 1 > wq0, kb, row, t);
  };
  // sc holds P (normalised, f32): mask, round to T (or split), o += P V
  const auto pv = [&](int u, int kb) {
    if (p.drop.seed) drop_tile(sc, p.drop, key, bh, row, kb, t);
    uint32_t pa[P][BK / 16][4];
    to_planes<BK, T>(pa, sc);
    wg_fence();
    for_terms<P>([&](auto a, auto c, bool) {
      const E* vc = tiles.v(u) + (c * D / kPanel) * BK * kPanel;  // plane c of V
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) Mma<D, E>::rs(o, pa[a][kk], desc_mn<BK>(vc, kk));
    });
    wg_commit();
    wg_wait();
    fence_regs(o);
    tiles.release(u);
  };

  if (nt == 1) {  // the whole row in one tile: exact statistics from registers
    scores(0, 0);
    row_softmax(sc, m, l);
    const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] *= inv[acc_half(i)];
    pv(0, 0);
  } else {
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;  // this lane's share until the end of pass 1
    for (int j = 0; j < nt; ++j) {
      scores(j, j * BK);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = kNegInf;
#pragma unroll
        for (int i = 0; i < BK / 2; ++i)
          if (acc_half(i) == hr) mx = fmaxf(mx, sc[i]);
        const float m_new = fmaxf(m[hr], quad_max(mx));
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < BK / 2; ++i)
          if (acc_half(i) == hr) sum += exp2f(sc[i] - m_new);
        l[hr] = l[hr] * exp2f(m[hr] - m_new) + sum;
        m[hr] = m_new;
      }
      tiles.release(j);
    }
    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);
    const float inv[2] = {1.f / l[0], 1.f / l[1]};
    for (int j = 0; j < nt; ++j) {
      scores(nt + j, j * BK);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = exp2f(sc[i] - m[acc_half(i)]) * inv[acc_half(i)];
      pv(nt + j, j * BK);
    }
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(p.o, o, one, b, h, row, p.S, p.H, t);
  if (t == 0) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      p.lse[(size_t)bh * p.S + row + 8 * hr] = (m[hr] + log2f(l[hr])) * kLn2;
  }
}

// ------------------------------------------------------------- resident

// The resident tiles of one head: K and V whole in shared memory, already
// waited for (and split); u % nt is the key tile.
template <typename T, int D>
struct ResidentTiles {
  using E = typename Planes<T>::E;
  static constexpr int W = Planes<T>::P * D;
  const E *kbuf, *vbuf;
  int nt;
  __device__ const E* k(int u) const { return kbuf + (u % nt) * kT * W; }
  __device__ const E* v(int u) const { return vbuf + (u % nt) * kT * W; }
  __device__ void acquire(int) {}
  __device__ void after_issue(int) {}
  __device__ void release(int) {}
};

// Persistent: block x takes heads x, x + gridDim.x, ...; NB head buffers of
// Q, K, V (3 S W elements each, 128-row tiles of W / 64 swizzled panels; at
// float32 f32 tiles until make_planes splits them) in a ring, the next
// NB - 1 heads loading while this one computes.
template <typename T, int D, int NB>
__global__ void __launch_bounds__(kThreads, 1)
    encoder_fwd_resident(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, const FwdArgs<T> p) {
  using E = typename Planes<T>::E;
  constexpr int W = Planes<T>::P * D;
  unsigned char* base = &aligned_smem<unsigned char>();
  const int S = p.S, heads = p.B * p.H, nq = S / kT;
  const size_t head_elems = (size_t)S * W;  // one tensor of a head, in E
  E* buf = reinterpret_cast<E*>(base);
  struct Bars {
    uint64_t unused;
    Ring<NB> ring;
  };
  Bars& bars = *reinterpret_cast<Bars*>(base + NB * 3 * head_elems * sizeof(E));
  const int count = heads > (int)blockIdx.x ? (heads - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const auto load = [&](int n) {
    const int bh = blockIdx.x + n * gridDim.x, b = bh / p.H, h = bh % p.H;
    uint64_t* full = &bars.ring.full[n % NB];
    E* q = buf + (n % NB) * 3 * head_elems;
    mbar_expect_tx(full, (uint32_t)(3 * (size_t)S * D * sizeof(T)));
    for (int i = 0; i < nq; ++i) {
      tma_tile<D, kT>(reinterpret_cast<T*>(q + i * kT * W), &tq, full, h, i * kT, b);
      tma_tile<D, kT>(reinterpret_cast<T*>(q + head_elems + i * kT * W), &tk, full, h, i * kT, b);
      tma_tile<D, kT>(reinterpret_cast<T*>(q + 2 * head_elems + i * kT * W), &tv, full, h, i * kT,
                      b);
    }
  };
  init_ring(&bars.unused, bars.ring);
  if (threadIdx.x == 0)
    for (int n = 0; n < min(count, NB); ++n) load(n);
  const uint2 key = philox_key(p.drop);
  const int wg = warpgroup();

  for (int n = 0; n < count; ++n) {
    // the buffer of head n - 1 refills with head n - 1 + NB once every
    // thread is done with it (with NB = 1 that is head n itself)
    if (threadIdx.x == 0 && n >= 1 && n - 1 + NB < count) {
      mbar_wait(&bars.ring.empty[(n - 1) % NB], ((n - 1) / NB) & 1);
      load(n - 1 + NB);
    }
    wait_full(bars.ring, n);
    const int bh = blockIdx.x + n * gridDim.x, b = bh / p.H, h = bh % p.H;
    E* q = buf + (n % NB) * 3 * head_elems;
    if constexpr (Planes<T>::P > 1) {  // the head's 3 nq f32 tiles become their planes
      for (int i = 0; i < 3 * nq; ++i) split_tile<D, kT>(q + i * kT * W);
      fence_async_shared();
      __syncthreads();
    }
    ResidentTiles<T, D> tiles{q + head_elems, q + 2 * head_elems, 0};
    for (int qt = 0; qt < nq; ++qt) {
      tiles.nt = p.causal ? qt + 1 : nq;
      attend_rows<T, D, kT>(q + qt * kT * W + 64 * wg * kPanel, tiles.nt, tiles, p, bh, b, h,
                            qt * kT + 64 * wg, key);
    }
    release(bars.ring, n);
  }
}

// ------------------------------------------------------------- streamed

constexpr int kStages = 2;  // K + V ring stages

// The streamed kernel's layout at T and D: a 128-row Q tile and BK-key
// tiles of K and V, by W = P D: 128 keys at W = 128 (160 KB), 64 at
// W = 256 (float32 at D 128: 192 KB).
template <typename T, int D>
struct Stream {
  using E = typename Planes<T>::E;
  static constexpr int W = Planes<T>::P * D;
  static constexpr int BK = W <= 128 ? kT : 64;
  struct Smem {
    E q[kT * W];
    E k[kStages][BK * W];
    E v[kStages][BK * W];
    uint64_t q_full;
    Ring<kStages> ring;
  };
};

// The ring of the streamed kernel: use u holds K tile u (pass 1, or the
// one pass of a one-tile row, which also loads V) or K and V of tile
// u - nt (pass 2).  At float32 acquire splits what arrived and syncs the
// block.
template <typename T, int D, typename Load>
struct RingTiles {
  using L = Stream<T, D>;
  using E = typename L::E;
  typename L::Smem& sm;
  int nt, uses;
  Load load;
  __device__ const E* k(int u) const { return sm.k[u % kStages]; }
  __device__ const E* v(int u) const { return sm.v[u % kStages]; }
  __device__ void acquire(int u) {
    wait_full(sm.ring, u);
    if constexpr (Planes<T>::P > 1) {
      split_tile<D, L::BK>(sm.k[u % kStages]);
      if (nt == 1 || u >= nt) split_tile<D, L::BK>(sm.v[u % kStages]);
      fence_async_shared();
      __syncthreads();
    }
  }
  __device__ void after_issue(int u) { refill(sm.ring, u, uses, load); }
  __device__ void release(int u) { wgmma_attention::release(sm.ring, u); }
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    encoder_fwd_streamed(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, const FwdArgs<T> p) {
  using L = Stream<T, D>;
  constexpr int BK = L::BK;
  typename L::Smem& sm = aligned_smem<typename L::Smem>();
  const int h = blockIdx.y, b = blockIdx.z, bh = b * p.H + h;
  const int qt = gridDim.x - 1 - blockIdx.x, q0 = qt * kT;  // longest causal walks first
  const int nt = (p.causal ? q0 + kT : p.S) / BK;
  const int uses = nt == 1 ? 1 : 2 * nt;
  const auto load = [&](int u) {
    const bool second = nt > 1 && u >= nt, with_v = nt == 1 || second;
    const int j = second ? u - nt : u;
    uint64_t* full = &sm.ring.full[u % kStages];
    mbar_expect_tx(full, (with_v ? 2 : 1) * BK * D * sizeof(T));
    tma_tile<D, BK>(reinterpret_cast<T*>(sm.k[u % kStages]), &tk, full, h, j * BK, b);
    if (with_v) tma_tile<D, BK>(reinterpret_cast<T*>(sm.v[u % kStages]), &tv, full, h, j * BK, b);
  };
  init_ring(&sm.q_full, sm.ring);
  if (threadIdx.x == 0) {
    mbar_expect_tx(&sm.q_full, kT * D * sizeof(T));
    tma_tile<D, kT>(reinterpret_cast<T*>(sm.q), &tq, &sm.q_full, h, q0, b);
    for (int u = 0; u < min(uses, kStages); ++u) load(u);
  }
  const int wg = warpgroup();
  RingTiles<T, D, decltype(load)> tiles{sm, nt, uses, load};
  mbar_wait(&sm.q_full, 0);
  make_planes<T, D, kT>(sm.q);
  attend_rows<T, D, BK>(sm.q + 64 * wg * kPanel, nt, tiles, p, bh, b, h, q0 + 64 * wg,
                        philox_key(p.drop));
}

// ------------------------------------------------------------------ host

template <typename T, int D, int NB>
cudaError_t run_resident(const CUtensorMap (&m)[3], const FwdArgs<T>& a, cudaStream_t st) {
  const size_t smem = (size_t)NB * 3 * a.S * D * sizeof(T) + 64 + 1024;  // 3 S W elements of E
  const auto kernel = encoder_fwd_resident<T, D, NB>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return err;
  const int grid = min(a.B * a.H, sms * max(per_sm, 1));
  kernel<<<grid, kThreads, smem, st>>>(m[0], m[1], m[2], a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t run_fwd(const void* q, const void* k, const void* v, const Strides (&sd)[3],
                    const FwdArgs<T>& a, cudaStream_t st) {
  constexpr int W = Planes<T>::P * D;
  const bool resident = a.S * W <= 32768;
  // boxes of 128 rows, but the streamed kernel's K and V tiles of BK keys
  const int krows = resident ? kT : Stream<T, D>::BK;
  const int rows[3] = {kT, krows, krows};
  CUtensorMap m[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err = make_map<T>(&m[i], ptrs[i], a.B, a.S, a.H, D, rows[i], sd[i]);
    if (err != cudaSuccess) return err;
  }
  if (resident) {
    if constexpr (W <= 128) {  // two heads fit at S = 128 only there
      if (a.S * W <= 16384) return run_resident<T, D, 2>(m, a, st);
    }
    return run_resident<T, D, 1>(m, a, st);
  }
  if constexpr (W > 64) {
    return launch(encoder_fwd_streamed<T, D>, dim3(a.S / kT, a.H, a.B),
                  sizeof(typename Stream<T, D>::Smem) + 1024, st, m[0], m[1], m[2], a);
  } else {
    return cudaErrorInvalidValue;  // S <= 512 keeps W = 64 (bf16 and float16 at D 64) resident
  }
}

// run(T()) for the element type of type code `type` (ENCODER_TYPES), or
// cudaErrorInvalidValue where none is built.
template <typename Run>
cudaError_t by_type(int type, Run run) {
#define X(TT, CODE) \
  if (type == CODE) return run(TT());
  ENCODER_TYPES(X)
#undef X
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface (bound with ctypes).  Returns a cudaError_t: 0 on a
// clean launch.  q, k, v: device pointers of [B, S, H, D] views of the type
// of code `type` (ENCODER_TYPES: 1 bf16, 2 float16, 0 float32), 16-byte
// aligned, with element strides (head, row, batch), each 16 bytes'
// multiple; o [B, S, H, D] of that type and lse [B * H, S] f32 contiguous.
// seed is the int32 [2] seed pair, or null for no dropout (rate 0); thresh
// and inv_keep the rate's keep threshold and 1 / (1 - rate).
extern "C" int encoder_attention_launch(const void* q, const void* k, const void* v, void* o, void* lse,
                                        int B, int H, int S, int D, long long qh, long long qs,
                                        long long qb, long long kh, long long ks, long long kb,
                                        long long vh, long long vs, long long vb, float scale,
                                        int causal, int type, const void* seed, unsigned thresh,
                                        float inv_keep, void* stream) {
  if (bad_shape(B, H, S, S, causal) || S % kT != 0 || S > 512) return (int)cudaErrorInvalidValue;
  const Strides sd[3] = {{qh, qs, qb}, {kh, ks, kb}, {vh, vs, vb}};
  const Drop drop{static_cast<const int*>(seed), thresh, inv_keep};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define X(DD)                                                                                   \
  if (D == DD) return (int)by_type(type, [&](auto t) {                                           \
    using T = decltype(t);                                                                      \
    const FwdArgs<T> a{static_cast<T*>(o), static_cast<float*>(lse), B, H, S, scale * kLog2e,    \
                       causal, drop};                                                           \
    return run_fwd<T, DD>(q, k, v, sd, a, st);                                                  \
  });
  ENCODER_DIMS(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* encoder_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
