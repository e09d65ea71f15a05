// Short-sequence self-attention forward for Hopper (sm_90a), bf16 and
// float16, head dims 64 and 128, with dropout of the probabilities.
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
//
// What the design does about it: products on `wgmma`, loads by TMA
// (wgmma_attention.cuh), blocks of two warpgroups, each owning 64 query
// rows of a 128-row query tile; 128-key tiles, so a warpgroup's score block
// is an m64n128 accumulator, 64 registers a thread.  Two regimes:
//  * resident, S * D <= 32768 (S <= 256 at D 128, S <= 512 at D 64): a
//    head's Q, K and V (3 S D elements, at most 192 KB) fit one block's shared
//    memory.  A persistent grid walks the heads; each block loads a whole
//    head by TMA, walks its query tiles with K and V resident, and, where
//    two heads fit (S * D <= 16384, the ERNIE shape: 2 x 48 KB), loads the
//    next head while it computes this one.  K and V come from device memory
//    once per head.
//  * streamed, S * D > 32768 (S 384 and 512 at D 128): one block per
//    (query tile, head), in head-major order so that the query tiles of a
//    head run together and re-read its K and V from L2; K and V tiles
//    stream through a two-stage TMA ring.
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
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (paddle_tpu_torch/ops/_build.py does this).

#include "encoder_wgmma.cuh"

// The instantiations, one list each (paddle_tpu_torch/ops/_simt.py
// TC_TYPE_CODES and ENCODER_DIMS; a CPU test parses these lines against
// them): (element type, its type code), and the head dims.
#define ENCODER_TYPES(X) X(__nv_bfloat16, 1) X(__half, 2)
#define ENCODER_DIMS(X) X(64) X(128)

namespace {

using namespace encoder_wgmma;

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
// o = T(dropout(P)) V over the `nt` key tiles its rows see.  `tiles`
// gives the K and V tile of ring use u (k(u), v(u)) and waits for and frees
// them (acquire(u), after_issue(u), release(u)): pass 1 of a two-pass row
// uses u = 0 .. nt - 1 (K only), pass 2 u = nt .. 2 nt - 1; a one-pass row
// uses u = 0 (K and V).
template <typename T, int D, typename Tiles>
__device__ __forceinline__ void attend_rows(const T* qw, int nt, Tiles& tiles, const FwdArgs<T>& p,
                                            int bh, int b, int h, int wq0, uint2 key) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, t = lane & 3;
  const int row = wq0 + 16 * warp + (lane >> 2);  // this thread's rows: row, row + 8
  float sc[kT / 2], o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2], l[2];

  const auto scores = [&](int u, int kb) {
    tiles.acquire(u);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Mma<kT, T>::ss(sc, desc_k<kT>(qw, kk), desc_k<kT>(tiles.k(u), kk), kk > 0);
    wg_commit();
    tiles.after_issue(u);
    wg_wait();
    fence_regs(sc);
    scale_mask(sc, p.scale_log2, p.causal && kb + kT - 1 > wq0, kb, row, t);
  };
  // sc holds P (normalised, f32): mask, round to T, o += P V
  const auto pv = [&](int u, int kb) {
    if (p.drop.seed) drop_tile(sc, p.drop, key, bh, row, kb, t);
    uint32_t pa[kT / 16][4];
    to_a<kT, T>(pa, sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) Mma<D, T>::rs(o, pa[kk], desc_mn<kT>(tiles.v(u), kk));
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
    for (int i = 0; i < kT / 2; ++i) sc[i] *= inv[acc_half(i)];
    pv(0, 0);
  } else {
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;  // this lane's share until the end of pass 1
    for (int j = 0; j < nt; ++j) {
      scores(j, j * kT);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = kNegInf;
#pragma unroll
        for (int i = 0; i < kT / 2; ++i)
          if (acc_half(i) == hr) mx = fmaxf(mx, sc[i]);
        const float m_new = fmaxf(m[hr], quad_max(mx));
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < kT / 2; ++i)
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
      scores(nt + j, j * kT);
#pragma unroll
      for (int i = 0; i < kT / 2; ++i) sc[i] = exp2f(sc[i] - m[acc_half(i)]) * inv[acc_half(i)];
      pv(nt + j, j * kT);
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
// waited for; u % nt is the key tile.
template <typename T, int D>
struct ResidentTiles {
  const T *kbuf, *vbuf;
  int nt;
  __device__ const T* k(int u) const { return kbuf + (u % nt) * kT * D; }
  __device__ const T* v(int u) const { return vbuf + (u % nt) * kT * D; }
  __device__ void acquire(int) {}
  __device__ void after_issue(int) {}
  __device__ void release(int) {}
};

// Persistent: block x takes heads x, x + gridDim.x, ...; NB head buffers of
// Q, K, V (3 S D elements of T each, 128-row tiles of D / 64 swizzled
// panels) in a ring, the next NB - 1 heads loading while this one computes.
template <typename T, int D, int NB>
__global__ void __launch_bounds__(kThreads, 1)
    encoder_fwd_resident(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, const FwdArgs<T> p) {
  unsigned char* base = &aligned_smem<unsigned char>();
  const int S = p.S, heads = p.B * p.H, nq = S / kT;
  const size_t head_elems = (size_t)S * D;
  T* buf = reinterpret_cast<T*>(base);
  struct Bars {
    uint64_t unused;
    Ring<NB> ring;
  };
  Bars& bars = *reinterpret_cast<Bars*>(base + NB * 3 * head_elems * sizeof(T));
  const int count = heads > (int)blockIdx.x ? (heads - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const auto load = [&](int n) {
    const int bh = blockIdx.x + n * gridDim.x, b = bh / p.H, h = bh % p.H;
    uint64_t* full = &bars.ring.full[n % NB];
    T* q = buf + (n % NB) * 3 * head_elems;
    mbar_expect_tx(full, (uint32_t)(3 * head_elems * sizeof(T)));
    for (int i = 0; i < nq; ++i) {
      tma_tile<D, kT>(q + i * kT * D, &tq, full, h, i * kT, b);
      tma_tile<D, kT>(q + head_elems + i * kT * D, &tk, full, h, i * kT, b);
      tma_tile<D, kT>(q + 2 * head_elems + i * kT * D, &tv, full, h, i * kT, b);
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
    const T* q = buf + (n % NB) * 3 * head_elems;
    ResidentTiles<T, D> tiles{q + head_elems, q + 2 * head_elems, 0};
    for (int qt = 0; qt < nq; ++qt) {
      tiles.nt = p.causal ? qt + 1 : nq;
      attend_rows<T, D>(q + qt * kT * D + 64 * wg * kPanel, tiles.nt, tiles, p, bh, b, h,
                     qt * kT + 64 * wg, key);
    }
    release(bars.ring, n);
  }
}

// ------------------------------------------------------------- streamed

constexpr int kStages = 2;  // K + V ring stages: 32 + 2 x 64 KB at D = 128

template <typename T, int D>
struct StreamSmem {
  T q[kT * D];
  T k[kStages][kT * D];
  T v[kStages][kT * D];
  uint64_t q_full;
  Ring<kStages> ring;
};

// The ring of the streamed kernel: use u holds K tile u (pass 1, or the
// one pass of a one-tile row, which also loads V) or K and V of tile
// u - nt (pass 2).
template <typename T, int D, typename Load>
struct RingTiles {
  StreamSmem<T, D>& sm;
  int uses;
  Load load;
  __device__ const T* k(int u) const { return sm.k[u % kStages]; }
  __device__ const T* v(int u) const { return sm.v[u % kStages]; }
  __device__ void acquire(int u) { wait_full(sm.ring, u); }
  __device__ void after_issue(int u) { refill(sm.ring, u, uses, load); }
  __device__ void release(int u) { wgmma_attention::release(sm.ring, u); }
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    encoder_fwd_streamed(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, const FwdArgs<T> p) {
  StreamSmem<T, D>& sm = aligned_smem<StreamSmem<T, D>>();
  const int h = blockIdx.y, b = blockIdx.z, bh = b * p.H + h;
  const int qt = gridDim.x - 1 - blockIdx.x, q0 = qt * kT;  // longest causal walks first
  const int nt = p.causal ? qt + 1 : p.S / kT;
  const int uses = nt == 1 ? 1 : 2 * nt;
  const auto load = [&](int u) {
    const bool second = nt > 1 && u >= nt, with_v = nt == 1 || second;
    const int j = second ? u - nt : u;
    uint64_t* full = &sm.ring.full[u % kStages];
    mbar_expect_tx(full, (with_v ? 2 : 1) * kT * D * sizeof(T));
    tma_tile<D, kT>(sm.k[u % kStages], &tk, full, h, j * kT, b);
    if (with_v) tma_tile<D, kT>(sm.v[u % kStages], &tv, full, h, j * kT, b);
  };
  init_ring(&sm.q_full, sm.ring);
  if (threadIdx.x == 0) {
    mbar_expect_tx(&sm.q_full, kT * D * sizeof(T));
    tma_tile<D, kT>(sm.q, &tq, &sm.q_full, h, q0, b);
    for (int u = 0; u < min(uses, kStages); ++u) load(u);
  }
  const int wg = warpgroup();
  RingTiles<T, D, decltype(load)> tiles{sm, uses, load};
  mbar_wait(&sm.q_full, 0);
  attend_rows<T, D>(sm.q + 64 * wg * kPanel, nt, tiles, p, bh, b, h, q0 + 64 * wg, philox_key(p.drop));
}

// ------------------------------------------------------------------ host

template <typename T, int D, int NB>
cudaError_t run_resident(const CUtensorMap (&m)[3], const FwdArgs<T>& a, cudaStream_t st) {
  const size_t smem = (size_t)NB * 3 * a.S * D * sizeof(T) + 64 + 1024;
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
  CUtensorMap m[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err = make_map<T>(&m[i], ptrs[i], a.B, a.S, a.H, D, kT, sd[i]);
    if (err != cudaSuccess) return err;
  }
  if (a.S * D <= 16384) return run_resident<T, D, 2>(m, a, st);
  if (a.S * D <= 32768) return run_resident<T, D, 1>(m, a, st);
  if (D != 128) return cudaErrorInvalidValue;  // S <= 512 keeps D = 64 resident
  return launch(encoder_fwd_streamed<T, 128>, dim3(a.S / kT, a.H, a.B),
                sizeof(StreamSmem<T, 128>) + 1024, st, m[0], m[1], m[2], a);
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
// of code `type` (ENCODER_TYPES: 1 bf16, 2 float16), 16-byte aligned, with
// element strides (head, row, batch), each a multiple of 8; o [B, S, H, D]
// of that type and lse [B * H, S] f32 contiguous.  seed is the int32 [2]
// seed pair, or null for no dropout (rate 0); thresh and inv_keep the
// rate's keep threshold and 1 / (1 - rate).
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
