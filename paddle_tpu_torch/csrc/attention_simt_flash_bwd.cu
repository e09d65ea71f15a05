// FlashAttention backward at float32 (q, k, v, O and dO), head dims 64, 128
// and 256, on the CUDA cores: three entries, the statistics pass and one
// per TPU kernel.  float16 runs the tensor-core kernels of
// flash_attention_bwd.cu.
//
// Replaces: paddle_tpu/ops/flash_attention.py `_dq_kernel` (entry
// flash_attention_simt_dq) and `_dkv_kernel` (entry flash_attention_simt_dkv),
// launched by `_flash_bwd`, at the type the tensor-core kernels
// (flash_attention_bwd.cu) do not take.  Both recompute P = exp(scale q k^T
// - lse) from the forward's natural-log lse; the statistics pass
// (flash_attention_simt_stats, the dsum each of the reference's kernels
// takes first) writes stats [2, B * H, Sq] = (lse * log2(e), rowsum(dO * O)
// - dlse) once for both.  dQ, dK, dV follow the reference's rounding
// (attention_simt_bwd.cuh): dS, and for dV P, to the input type.  Causal
// masks are bottom-right aligned (query i sees keys <= i + Sk - Sq; the
// caller rejects Sq > Sk).  A float32 LLaMA's training step at S >= 1024
// routes here.
//
// What bounds it: operations.  dQ does 3 products, 6 D FLOP a visible
// pair, dK/dV 4, 8 D, at the f32 FFMA rate of 67 TFLOP/s; the statistics
// pass reads O and dO once (bytes).  What the design does about it
// (attention_simt_bwd.cuh): 32-row tiles of own rows in f32 shared memory,
// register-tiled products (2 own rows x 4 walked rows of the scores, 2 own
// rows x D / 8 columns of the outputs a thread), the walked tiles streamed
// through a two-stage cp.async ring, two blocks an SM (one at D = 256,
// where two blocks share a key tile's dK/dV columns); each block writes
// only its own rows and columns, so the bits are the same on every run.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (paddle_tpu_torch/ops/_build.py does this).

#include "attention_simt_bwd.cuh"

namespace {

using namespace attention_simt_bwd;

bool bad_shape(int B, int H, int Sq, int Sk, int causal) {
  return B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || B > 65535 || H > 65535 || (causal && Sq > Sk);
}

BwdParams flash_params(const void* q, const void* k, const void* v, const void* dO,
                       const void* stats, int B, int H, int Sq, int Sk, int D, float scale,
                       int causal) {
  BwdParams p{};
  const long long qs = (long long)H * D;
  p.q = View{q, (long long)Sq * qs, qs};
  p.dO = View{dO, (long long)Sq * qs, qs};
  p.k = View{k, (long long)Sk * qs, qs};
  p.v = View{v, (long long)Sk * qs, qs};
  p.stats = static_cast<float*>(const_cast<void*>(stats));
  p.B = B, p.H = H, p.Sq = Sq, p.Sk = Sk, p.causal = causal != 0;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  return p;
}

}  // namespace

// Plain C interface (bound with ctypes).  Each returns a cudaError_t: 0 on a
// clean launch.  q, o, dO [B, Sq, H, D] and k, v [B, Sk, H, D] contiguous
// of `type` (0 float32; nothing else is built); lse and dlse (or null) f32
// [B * H, Sq]; stats f32 [2, B * H, Sq].

extern "C" int flash_attention_simt_stats_launch(const void* o, const void* dO, const void* lse,
                                                 const void* dlse, void* stats, int B, int H,
                                                 int Sq, int D, int type, void* stream) {
  if (bad_shape(B, H, Sq, Sq, 0)) return (int)cudaErrorInvalidValue;
  const int rows = B * H * Sq;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(dlse);
  float* s = static_cast<float*>(stats);
#define SIMT_BWD_STATS_TYPE(T) \
  if (type == type_code<T>()) return (int)run_flash_stats_typed<T>(o, dO, l, dl, s, rows, H, Sq, D, st);
  SIMT_BWD_FLASH_TYPES(SIMT_BWD_STATS_TYPE)
#undef SIMT_BWD_STATS_TYPE
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_simt_dq_launch(const void* q, const void* k, const void* v,
                                              const void* dO, const void* stats, void* dq, int B,
                                              int H, int Sq, int Sk, int D, float scale,
                                              int causal, int type, void* stream) {
  if (bad_shape(B, H, Sq, Sk, causal) || !stats) return (int)cudaErrorInvalidValue;
  BwdParams p = flash_params(q, k, v, dO, stats, B, H, Sq, Sk, D, scale, causal);
  p.dq = dq;
  const dim3 grid((Sq + kTile - 1) / kTile, H, B);
  return (int)run_op<Op::FlashDq>(p, D, type, grid, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_simt_dkv_launch(const void* q, const void* k, const void* v,
                                               const void* dO, const void* stats, void* dk,
                                               void* dv, int B, int H, int Sq, int Sk, int D,
                                               float scale, int causal, int type, void* stream) {
  if (bad_shape(B, H, Sq, Sk, causal) || !stats) return (int)cudaErrorInvalidValue;
  BwdParams p = flash_params(q, k, v, dO, stats, B, H, Sq, Sk, D, scale, causal);
  p.dk = dk;
  p.dv = dv;
  const dim3 grid((Sk + kTile - 1) / kTile * col_splits(D), H, B);
  return (int)run_op<Op::FlashDkv>(p, D, type, grid, static_cast<cudaStream_t>(stream));
}

extern "C" const char* attention_simt_flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
