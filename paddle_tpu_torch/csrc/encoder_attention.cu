// Short-sequence self-attention forward for Hopper (sm_90a), bf16, head
// dims 64 and 128, with dropout of the probabilities.
//
// Replaces: paddle_tpu/ops/encoder_attention.py `_fwd_kernel` (launched by
// `_attn_fwd`).  For q, k, v [B, S, H, D] with S % 128 == 0 and S <= 512, it
// writes o [B, S, H, D] = P v with P = softmax(scale * q k^T) taken over
// each whole row, optionally causal, exactly as the reference does: the
// row's max and sum come first, then P = exp(s - m) / l; with dropout
// (rate > 0) P becomes where(keep, P / (1 - rate), 0); then P is rounded to
// bf16 and multiplied by V, with no division afterwards.  The keep mask is
// Philox (philox.cuh: element (bh, i, j) reads counter (oct(i), oct(j), bh,
// 0)), from the seed pair the backward reads again, so no mask is stored.
//
// What bounds it on this card: bytes, narrowly.  It does 4 * D operations
// per visible query-key pair and must read q, k, v and write o once: 64 to
// 256 operations per byte at S = 128..512 non-causal (half that causal),
// under the H100's ridge of 295, so its floor is those bytes over
// 3.35 TB/s, with the tensor-core time close behind at S = 512.  Dropout
// adds one Philox call (40 32-bit multiplies) per 4 probabilities: at the
// ERNIE shape (B 512, H 12, S 128, D 64) 25.2 M calls, 0.060 ms at the
// card's 16.7 T multiplies/s, against 0.120 ms of bytes.
//
// What the design does about it: the products run on the tensor cores
// (warp-level mma.sync m16n8k16 bf16, mma_attention.cuh), one block of 4
// warps per (64-row query tile, head, batch).  The reference holds a
// head's whole [S, S] score block in VMEM; here K and V of one head are up
// to 256 KB at S = 512, D = 128, more than a block's shared memory, so key
// tiles of 64 rows stream through shared memory twice: the first pass
// computes each row's max and sum (online, K only), the second recomputes
// the scores and accumulates the normalised, masked, bf16-rounded P times
// V.  The second pass of Q K^T costs half again the tensor-core work of a
// one-pass online softmax; it buys the reference's rounding order exactly.
// The mask is drawn in the second pass only, one Philox call for the 4
// elements a thread holds of rows {i, i + 8} and keys {j, j + 8}.  Causal
// blocks stop at their diagonal tile in both passes.  At rate 0 no mask is
// drawn and the arithmetic is the rate-0 kernel's.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (paddle_tpu_torch/ops/_build.py does this).

#include "mma_attention.cuh"

namespace {

using namespace mma_attention;

template <int D>
__global__ void __launch_bounds__(kThreads) encoder_fwd_kernel(Problem p) {
  __shared__ __align__(16) Tile<D> sm;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kBQ, row0 = q0 + 16 * warp;
  const int bh = b * p.H + h;
  const uint2 key = p.seed ? philox::key(p.seed) : make_uint2(0u, 0u);

  uint32_t qa[D / 16][4];
  load_q<D>(qa, p, b, h, row0, g, t);
  const int qlast = min(q0 + kBQ, p.Sq) - 1;
  const int kend = p.causal ? min(p.Sk, qlast + 1) : p.Sk;

  // ---- pass 1: each row's max m and sum l of exp(s - m)
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this lane's share
  for (int kb = 0; kb < kend; kb += kBK) {
    __syncthreads();
    stage<D, false>(sm, p, b, h, kb, tid);
    __syncthreads();
    float s[kBK / 8][4];
    scores<D>(s, qa, sm, p, kb, row0 + g, g, t);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float m_new = fmaxf(m[hr], row_max(s, hr));
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n)
        sum += __expf(s[n][2 * hr] - m_new) + __expf(s[n][2 * hr + 1] - m_new);
      l[hr] = l[hr] * __expf(m[hr] - m_new) + sum;
      m[hr] = m_new;
    }
  }
  float inv_l[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) inv_l[hr] = 1.f / quad_sum(l[hr]);

  // ---- pass 2: o = bf16(dropout(exp(s - m) / l)) @ V
  float o[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  for (int kb = 0; kb < kend; kb += kBK) {
    __syncthreads();
    stage<D, true>(sm, p, b, h, kb, tid);
    __syncthreads();
    float s[kBK / 8][4];
    scores<D>(s, qa, sm, p, kb, row0 + g, g, t);
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = __expf(s[n][e] - m[e >> 1]) * inv_l[e >> 1];
    if (p.seed) {
#pragma unroll
      for (int n = 0; n < kBK / 8; n += 2)
        apply_keep(s[n], s[n + 1], keep_pair(key, bh, row0, kb + 8 * n, g, t, p.thresh),
                   p.inv_keep);
    }
    pv<D>(o, s, sm, lane);
  }
  const float one[2] = {1.f, 1.f};
  store_o<D>(o, one, p, b, h, row0, g, t);
}

}  // namespace

// Plain C interface (bound with ctypes).  Returns a cudaError_t: 0 on a
// clean launch.  Pointers are device pointers to contiguous tensors; seed
// is the int32 [2] seed pair, or null for no dropout (rate 0), and thresh
// and inv_keep the rate's keep threshold and 1 / (1 - rate).
extern "C" int encoder_attention_launch(const void* q, const void* k, const void* v, void* o,
                                        int B, int H, int S, int D, float scale, int causal,
                                        const void* seed, unsigned thresh, float inv_keep,
                                        void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || S % 128 != 0 || S > 512 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const Problem p{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                  static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
                  B, H, S, S, scale, causal,
                  static_cast<const int*>(seed), thresh, inv_keep};
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    encoder_fwd_kernel<64><<<grid, kThreads, 0, st>>>(p);
  else if (D == 128)
    encoder_fwd_kernel<128><<<grid, kThreads, 0, st>>>(p);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* encoder_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
