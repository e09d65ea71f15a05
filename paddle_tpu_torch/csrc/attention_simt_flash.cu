// FlashAttention forward at float32 (q, k and v), head dims 64, 128 and
// 256, on the CUDA cores.  float16 runs the tensor-core kernel of
// flash_attention.cu.
//
// Replaces: paddle_tpu/ops/flash_attention.py `_fwd_kernel` (launched by
// `_flash_fwd`) at the type the tensor-core kernel (flash_attention.cu)
// does not take.  For q [B, Sq, H, D] and k, v [B, Sk, H, D] it writes o
// [B, Sq, H, D] = softmax(scale * q k^T) v in q's type, with p rounded to
// v's type before p . v, and the rows' natural-log logsumexp lse
// [B * H, Sq] (f32).  Causal masks are bottom-right aligned: query i sees
// keys <= i + Sk - Sq (the caller rejects Sq > Sk).  A float32 model's
// no-cache forward at S >= 1024 routes here.
//
// What bounds it: operations (4 * D FLOP a visible pair, at the f32 FFMA
// rate of 67 TFLOP/s).  What the design does about it (attention_simt.cuh):
// 64-row tiles, the longest causal walks first, register-tiled products
// (4 rows x 8 keys of the scores and 4 rows x D / 8 columns of the output a
// thread) over key tiles streamed through a two-stage cp.async ring; key
// tiles past a tile's causal end are never loaded.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (paddle_tpu_torch/ops/_build.py does this).

#include "attention_simt.cuh"

// Plain C interface (bound with ctypes).  Returns a cudaError_t: 0 on a
// clean launch.  q, k, v, o contiguous [B, S, H, D] of `type` (0 float32,
// nothing else is built); lse f32 [B * H, Sq].
extern "C" int flash_attention_simt_launch(const void* q, const void* k, const void* v, void* o,
                                           void* lse, int B, int H, int Sq, int Sk, int D,
                                           float scale, int causal, int type, void* stream) {
  using namespace attention_simt;
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = o;
  p.lse = static_cast<float*>(lse);
  p.q_ss = (long long)H * D;
  p.q_sb = (long long)Sq * H * D;
  p.B = B;
  p.S = Sq;
  p.H = H;
  p.causal = causal != 0;
  p.scale_log2 = scale * kLog2e;
  const SeqRows rows{(long long)Sk * H * D, (long long)H * D, Sk};
  return (int)launch_seq<false>(p, rows, D, type, static_cast<cudaStream_t>(stream));
}

extern "C" const char* attention_simt_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
