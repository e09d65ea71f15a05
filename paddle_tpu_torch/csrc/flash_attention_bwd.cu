// FlashAttention-2 backward for Hopper (sm_90a), bf16, head dims 64 and 128:
// two entry points, one per TPU kernel.
//
// Replaces: paddle_tpu/ops/flash_attention.py `_dq_kernel` (entry
// flash_attention_dq) and `_dkv_kernel` (entry flash_attention_dkv), both
// launched by `_flash_bwd`.  From q, k, v [B, S, H, D], the forward's o and
// natural-log lse [B * H, Sq] (f32), the output cotangent dO and, for the
// lse-returning entry, the lse cotangent dlse, they recompute P = exp(scale
// q k^T - lse) and write
//   dQ = scale * bf16(P (dP - dsum)) k,        dP = dO v^T,
//   dK = scale * bf16(P (dP - dsum))^T q,      dsum = rowsum(dO * O) - dlse,
//   dV = bf16(P)^T dO,
// with the reference's roundings (dS and, for dV, P to bf16) and f32 sums.
// Causal masks are bottom-right aligned (query i sees keys <= i + Sk - Sq).
//
// What bounds it on this card: operations.  Per visible query-key pair dQ
// does 3 products (S, dP, dS K: 6 D operations) and dK/dV 4 (S, dP, P^T dO,
// dS^T Q: 8 D); the function's least work is 5 products, 10 D.  At the
// training shape (B 8, H 16, S 2048, D 128, causal) that is 0.35 ms at
// 989 TFLOP/s against 0.16 ms for its bytes (q, k, v, o, dO, lse in; dq,
// dk, dv out) at 3.35 TB/s.
//
// What the design does about it: every product runs on the tensor cores
// (mma.sync m16n8k16 bf16, f32 accumulators; attention_bwd.cuh).  dQ and
// dK/dV are separate kernels, as on the TPU: one block per 64-row query
// tile accumulates its dQ over the key tiles up to its causal end, one
// block per 64-row key tile accumulates its dK and dV over the query tiles
// from its causal start.  Each block owns its output rows, so there are no
// atomics and the result has the same bits on every run -- at the price of
// recomputing S and dP in both kernels (the 14 D against 10 D above).  A
// small kernel first computes dsum = rowsum(dO * O) - dlse per query row
// (FlashAttention-2's preprocessing step); each entry launches it, so each
// stands alone.  Not yet: wgmma, TMA, pipelined staging, larger tiles.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (paddle_tpu_torch/ops/_build.py does this).

#include "attention_bwd.cuh"

namespace {

using namespace mma_attention;

Grad make_grad(const void* q, const void* k, const void* v, const void* o, const void* dO,
               const void* lse, const void* dlse, void* dsum, int B, int H, int Sq, int Sk,
               float scale, int causal) {
  Grad p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dO = static_cast<const __nv_bfloat16*>(dO);
  p.lse = const_cast<float*>(static_cast<const float*>(lse));  // read only here
  p.dlse = static_cast<const float*>(dlse);
  p.dsum = static_cast<float*>(dsum);
  p.B = B, p.H = H, p.Sq = Sq, p.Sk = Sk, p.scale = scale, p.causal = causal;
  return p;
}

template <int D>
cudaError_t run_dsum(const Grad& p, cudaStream_t st) {
  const int rows = p.B * p.H * p.Sq;
  dsum_kernel<D><<<(rows + kWarps - 1) / kWarps, kThreads, 0, st>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t run_dq(const Grad& p, cudaStream_t st) {
  cudaError_t err = run_dsum<D>(p, st);
  if (err != cudaSuccess) return err;
  return launch_bwd(dq_kernel<D, false>, dim3((p.Sq + kBK - 1) / kBK, p.H, p.B),
                    sizeof(BwdSmem<D>), st, p);
}

template <int D>
cudaError_t run_dkv(const Grad& p, cudaStream_t st) {
  cudaError_t err = run_dsum<D>(p, st);
  if (err != cudaSuccess) return err;
  return launch_bwd(dkv_kernel<D, false>, dim3((p.Sk + kBK - 1) / kBK, p.H, p.B),
                    sizeof(BwdSmem<D>), st, p);
}

}  // namespace

// Plain C interface (bound with ctypes).  Each returns a cudaError_t: 0 on a
// clean launch.  Pointers are device pointers to contiguous tensors; dlse
// may be null; dsum is f32 scratch [B * H, Sq] the entry overwrites.
extern "C" int flash_attention_dq_launch(const void* q, const void* k, const void* v,
                                         const void* o, const void* dO, const void* lse,
                                         const void* dlse, void* dsum, void* dq, int B, int H,
                                         int Sq, int Sk, int D, float scale, int causal,
                                         void* stream) {
  if (bad_shape(B, H, Sq, Sk, causal)) return (int)cudaErrorInvalidValue;
  Grad p = make_grad(q, k, v, o, dO, lse, dlse, dsum, B, H, Sq, Sk, scale, causal);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return (int)run_dq<64>(p, st);
  if (D == 128) return (int)run_dq<128>(p, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_dkv_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dO, const void* lse,
                                          const void* dlse, void* dsum, void* dk, void* dv,
                                          int B, int H, int Sq, int Sk, int D, float scale,
                                          int causal, void* stream) {
  if (bad_shape(B, H, Sq, Sk, causal)) return (int)cudaErrorInvalidValue;
  Grad p = make_grad(q, k, v, o, dO, lse, dlse, dsum, B, H, Sq, Sk, scale, causal);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return (int)run_dkv<64>(p, st);
  if (D == 128) return (int)run_dkv<128>(p, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
