// Encoder self-attention backward with dropout of the probabilities, at
// float32 (q, k, v and dO), S % 128 == 0 up to 512, head dims 64 and 128,
// on the CUDA cores.  float16 runs the tensor-core kernel of
// encoder_attention_bwd.cu.
//
// Replaces: paddle_tpu/ops/encoder_attention.py `_bwd_kernel` (launched by
// `_attn_bwd`) at the type the tensor-core kernel (encoder_attention_bwd.cu)
// does not take.  From q, k, v and dO [B, S, H, D] views it writes dq, dk, dv
// [B, S, H, D] (contiguous, q's type) as the reference does: P the
// whole-row softmax of scale q k^T (optionally causal), the mask
// regenerated from the forward's seed pair (philox.cuh: the forward's map,
// so one seed gives one mask at every type), P_d = where(keep, P / (1 -
// rate), 0) in f32 and not rounded for dV = P_d^T dO, dP = where(keep,
// dO v^T / (1 - rate), 0), dS = P (dP - rowsum(dP * P)) * scale rounded to
// the input type for dQ = dS k and dK = dS^T q.  A float32 BERT / ERNIE's
// training step, and a float32 LLaMA's at S <= 512, route here.
//
// What bounds it: operations (10 D FLOP a visible pair at least, and a
// Philox call for four pairs, on the CUDA cores).  What the design does
// about it (attention_simt_bwd.cuh): at S = 128 one block a head (B * H
// blocks) walks the head's four 32-row query tiles (the rows' max, sum and
// dsum in one walk, online, then dQ) and its four 32-row key tiles (dK and
// dV), so nothing comes from the forward and nothing is written but the
// gradients; at S > 128 a row kernel reads the forward's lse (the second
// output of encoder_attention_simt_launch), walks for dsum and then for dQ
// and writes each row's (lse * log2(e), dsum) to `stats`, and a column
// kernel walks the queries for dK and dV.  q, k, v and dO are read in place
// through their strides, so BERT's packed projection needs no copy.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (paddle_tpu_torch/ops/_build.py does this).

#include "attention_simt_bwd.cuh"

// Plain C interface (bound with ctypes).  Returns a cudaError_t: 0 on a
// clean launch.  Each of q, k, v, dO has its own (batch, position) strides
// in elements, heads D apart; dq, dk, dv [B, S, H, D] contiguous; `type` 0
// float32 (nothing else is built).  At S > 128, lse (f32 [B * H, S], the forward's) and
// stats (f32 [2, B * H, S] scratch) are required; at S = 128 both may be
// null.  seed is the int32 [2] seed pair, or null for no dropout; thresh
// and inv_keep the rate's keep threshold and 1 / (1 - rate).
extern "C" int encoder_attention_simt_bwd_launch(
    const void* q, const void* k, const void* v, const void* dO, const void* lse, void* stats,
    void* dq, void* dk, void* dv, int B, int H, int S, int D, long long q_sb, long long q_ss,
    long long k_sb, long long k_ss, long long v_sb, long long v_ss, long long do_sb,
    long long do_ss, float scale, int causal, int type, const void* seed, unsigned thresh,
    float inv_keep, void* stream) {
  using namespace attention_simt_bwd;
  if (B <= 0 || H <= 0 || B > 65535 || H > 65535 || S <= 0 || S % kHeadS != 0 || S > 512)
    return (int)cudaErrorInvalidValue;
  BwdParams p{};
  p.q = View{q, q_sb, q_ss};
  p.k = View{k, k_sb, k_ss};
  p.v = View{v, v_sb, v_ss};
  p.dO = View{dO, do_sb, do_ss};
  p.lse = static_cast<const float*>(lse);
  p.stats = static_cast<float*>(stats);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.B = B, p.H = H, p.Sq = S, p.Sk = S, p.causal = causal != 0;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  p.seed = static_cast<const int*>(seed);
  p.thresh = thresh;
  p.inv_keep = inv_keep;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S == kHeadS) return (int)run_op<Op::EncoderHead>(p, D, type, dim3(H, B), st);
  if (!lse || !stats) return (int)cudaErrorInvalidValue;
  const dim3 grid(S / kTile, H, B);
  cudaError_t err = run_op<Op::EncoderDq>(p, D, type, grid, st);
  if (err != cudaSuccess) return (int)err;
  return (int)run_op<Op::EncoderDkv>(p, D, type, grid, st);
}

extern "C" const char* attention_simt_encoder_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
