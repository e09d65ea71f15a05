// Encoder self-attention forward with dropout of the probabilities, at
// float32 (q, k and v), S % 128 == 0 up to 512, head dims 64 and 128, on
// the CUDA cores.  float16 runs the tensor-core kernel of
// encoder_attention.cu.
//
// Replaces: paddle_tpu/ops/encoder_attention.py `_fwd_kernel` (launched by
// `encoder_attention`) at the type the tensor-core kernel
// (encoder_attention.cu) does not take.  For q, k, v [B, S, H, D] views it writes o [B, S, H, D]
// (contiguous, q's type) = P v with P = dropout(softmax(scale * q k^T)),
// each row's softmax taken whole (max and sum over every key first, then
// e / sum), masked by Philox from the seed pair and scaled by 1 / (1 - rate)
// (the same element-to-counter map as the bf16 kernel, philox.cuh, so one
// seed gives one mask at every type), and rounded to v's type before P v;
// and the rows' natural-log logsumexp lse [B * H, S] (f32).  A float32
// BERT / ERNIE, and a float32 LLaMA's no-cache forward at S <= 512, route
// here.
//
// What bounds it: operations (4 * D FLOP a pair, and a Philox call for
// four of them, on the CUDA cores).  What the design does about it
// (attention_simt.cuh): 64-row tiles, a statistics pass over the keys (max
// and sum, the reference's order) and then the products; q, k and v are
// read in place through their strides, so the three slices of one packed
// [B, S, 3, H, D] projection need no copy.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (paddle_tpu_torch/ops/_build.py does this).

#include "attention_simt.cuh"

// Plain C interface (bound with ctypes).  Returns a cudaError_t: 0 on a
// clean launch.  q strides (q_sb, q_ss) and k/v strides (kv_sb, kv_ss) in
// elements, heads D apart; o [B, S, H, D] contiguous, lse f32 [B * H, S];
// `type` 0 float32 (nothing else is built).  seed is the int32 [2] seed
// pair, or null for no dropout; thresh and inv_keep the rate's keep
// threshold and 1 / (1 - rate).
extern "C" int encoder_attention_simt_launch(const void* q, const void* k, const void* v, void* o,
                                             void* lse, int B, int H, int S, int D,
                                             long long q_sb, long long q_ss, long long kv_sb,
                                             long long kv_ss, float scale, int causal, int type,
                                             const void* seed, unsigned thresh, float inv_keep,
                                             void* stream) {
  using namespace attention_simt;
  if (S % 128 != 0 || S > 512) return (int)cudaErrorInvalidValue;
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = o;
  p.lse = static_cast<float*>(lse);
  p.q_ss = q_ss;
  p.q_sb = q_sb;
  p.B = B;
  p.S = S;
  p.H = H;
  p.causal = causal != 0;
  p.scale_log2 = scale * kLog2e;
  p.seed = static_cast<const int*>(seed);
  p.thresh = thresh;
  p.inv_keep = inv_keep;
  return (int)launch_seq<true>(p, SeqRows{kv_sb, kv_ss, S}, D, type,
                               static_cast<cudaStream_t>(stream));
}

extern "C" const char* attention_simt_encoder_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
