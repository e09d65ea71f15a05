// FlashAttention-2 forward for Hopper (sm_90a), bf16, head dims 64 and 128.
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
// S = 1024 causal (bytes bound, narrowly), 512 at S = 2048 (operations
// bound), so its floor is near both the bytes over 3.35 TB/s and the
// operations over the 989 TFLOP/s of the bf16 tensor cores.
//
// What the design does about it: the products run on the tensor cores, as
// warp-level mma.sync m16n8k16 bf16 with f32 accumulators
// (mma_attention.cuh).  One block of 4 warps per (64-row query tile, head,
// batch); each warp holds its 16 query rows as A fragments in registers
// and walks 64-key tiles of K and V staged in shared memory, up to the
// tile's causal end (whole tiles past it are never read).  The softmax is
// online across tiles in f32, in registers: each lane keeps its rows' max
// and a partial sum, P stays in registers as the A operand of P V after a
// bf16 rounding (the reference rounds p to v's dtype there too), and the
// output is o / l.  Not yet: wgmma, TMA, double-buffered staging, and
// larger tiles (PERF.md).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (paddle_tpu_torch/ops/_build.py does this).

#include "mma_attention.cuh"

namespace {

using namespace mma_attention;

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Problem p) {
  __shared__ __align__(16) Tile<D> sm;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kBQ, row0 = q0 + 16 * warp;

  uint32_t qa[D / 16][4];
  load_q<D>(qa, p, b, h, row0, g, t);
  float o[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this lane's share

  const int qlast = min(q0 + kBQ, p.Sq) - 1;
  const int kend = p.causal ? min(p.Sk, qlast + p.Sk - p.Sq + 1) : p.Sk;
  for (int kb = 0; kb < kend; kb += kBK) {
    __syncthreads();  // every warp is done with the previous tile
    stage<D, true>(sm, p, b, h, kb, tid);
    __syncthreads();
    float s[kBK / 8][4];
    scores<D>(s, qa, sm, p, kb, row0 + g, g, t);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float m_new = fmaxf(m[hr], row_max(s, hr));
      const float corr = __expf(m[hr] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n) {
        s[n][2 * hr] = __expf(s[n][2 * hr] - m_new);
        s[n][2 * hr + 1] = __expf(s[n][2 * hr + 1] - m_new);
        sum += s[n][2 * hr] + s[n][2 * hr + 1];
      }
      l[hr] = l[hr] * corr + sum;
      m[hr] = m_new;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        o[dn][2 * hr] *= corr;
        o[dn][2 * hr + 1] *= corr;
      }
    }
    pv<D>(o, s, sm, lane);
  }

  float inv[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] = quad_sum(l[hr]);
    inv[hr] = 1.f / l[hr];
  }
  store_o<D>(o, inv, p, b, h, row0, g, t);
  if (t == 0) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = row0 + g + 8 * hr;
      if (row < p.Sq) p.lse[(size_t)(b * p.H + h) * p.Sq + row] = m[hr] + logf(l[hr]);
    }
  }
}

}  // namespace

// Plain C interface (bound with ctypes).  Returns a cudaError_t: 0 on a
// clean launch.  Pointers are device pointers to contiguous tensors.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      void* lse, int B, int H, int Sq, int Sk, int D,
                                      float scale, int causal, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || (causal && Sq > Sk) || H > 65535 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  const Problem p{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                  static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
                  static_cast<float*>(lse), B, H, Sq, Sk, scale, causal};
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    flash_fwd_kernel<64><<<grid, kThreads, 0, st>>>(p);
  else if (D == 128)
    flash_fwd_kernel<128><<<grid, kThreads, 0, st>>>(p);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
