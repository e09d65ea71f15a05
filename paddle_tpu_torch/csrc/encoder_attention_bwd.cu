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
//   dS = P (dP - rowsum(dP * P)) * scale,
//   dQ = bf16(dS) k,      dK = bf16(dS)^T q.
// The forward saves only q, k and v (encoder_attention.py:162), so the row
// statistics are recomputed here, and the mask is regenerated from the
// seed pair (philox.cuh): element (bh, i, j) reads the same Philox word in
// the dQ kernel, which holds the tile as the forward does, and in the dK/dV
// kernel, which holds it transposed.  Nothing of size [B * H, S, S] is
// stored.
//
// What bounds it on this card: bytes.  Its least work is 5 products, 10 D
// operations per visible query-key pair, and it must read q, k, v, dO and
// write dq, dk, dv once: at the training shape (B 16, H 16, S 512, D 128,
// causal) 235 MB, 0.070 ms at 3.35 TB/s, against 0.044 ms of tensor-core
// work at 989 TFLOP/s.
//
// What the design does about it: the products run on the tensor cores
// (mma.sync m16n8k16 bf16, f32 accumulators; attention_bwd.cuh).  The
// reference holds a head's whole [S, S] block in VMEM; here a head's K and
// V (up to 256 KB) do not fit a block's shared memory, so key tiles
// stream.  Two kernels, launched one
// after the other by the one entry point:
//  1. per 64-row query tile: a first walk over the key tiles finds each
//     row's max, sum and sum of P dP online (S = q k^T and dP = dO v^T per
//     tile); it writes lse = m + log l and dsum = rowsum(dP * P) [B * H, S]
//     to f32 scratch, then a second walk accumulates dQ;
//  2. per 64-row key tile: dK and dV over the query tiles from the causal
//     start, reading those statistics.
// Precision: dP is a bf16 x bf16 product with f32 accumulation, exact in
// each term, so it equals the reference's f32 product up to summation
// order.  The reference takes dV = P^T dO with P in f32; the tensor cores
// take bf16, so P is split in two bf16 parts (hi + lo, about 16 bits of
// mantissa) and the dV product runs twice.  dS is scaled, then rounded to
// bf16, as the reference rounds it.  Dropout draws the mask three times:
// in both walks of the dQ kernel and once in the dK/dV kernel; at the ERNIE
// shape (B 512, H 12, S 128, D 64) 75.5 M Philox calls, 0.181 ms at the
// card's 16.7 T 32-bit multiplies/s, against 0.210 ms of bytes.  At rate 0
// no mask is drawn and the arithmetic is the rate-0 kernel's.  Not yet:
// wgmma, TMA.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (paddle_tpu_torch/ops/_build.py does this).

#include "attention_bwd.cuh"

namespace {

using namespace mma_attention;

template <int D>
cudaError_t run(const Grad& p, cudaStream_t st) {
  const dim3 grid((p.Sq + kBK - 1) / kBK, p.H, p.B);
  cudaError_t err = launch_bwd(dq_kernel<D>, grid, sizeof(BwdSmem<D>), st, p);
  if (err != cudaSuccess) return err;
  return launch_bwd(dkv_kernel<D>, grid, sizeof(BwdSmem<D>), st, p);
}

}  // namespace

// Plain C interface (bound with ctypes).  Returns a cudaError_t: 0 on a
// clean launch.  Pointers are device pointers to contiguous tensors; lse
// and dsum are f32 scratch [B * H, S] the entry overwrites; seed, thresh
// and inv_keep are the forward's (seed null: no dropout).
extern "C" int encoder_attention_bwd_launch(const void* q, const void* k, const void* v,
                                            const void* dO, void* lse, void* dsum, void* dq,
                                            void* dk, void* dv, int B, int H, int S, int D,
                                            float scale, int causal, const void* seed,
                                            unsigned thresh, float inv_keep, void* stream) {
  if (bad_shape(B, H, S, S, causal) || S % 128 != 0 || S > 512)
    return (int)cudaErrorInvalidValue;
  Grad p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dO = static_cast<const __nv_bfloat16*>(dO);
  p.lse = static_cast<float*>(lse);
  p.dsum = static_cast<float*>(dsum);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.B = B, p.H = H, p.Sq = S, p.Sk = S, p.scale = scale, p.causal = causal;
  p.seed = static_cast<const int*>(seed), p.thresh = thresh, p.inv_keep = inv_keep;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return (int)run<64>(p, st);
  if (D == 128) return (int)run<128>(p, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* encoder_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
