// Decode attention over a head-major static kv cache at float32 and float16
// (q float32 or float16; cache float32, float16 or int8 with f32 scales),
// head dims 64, 128 and 256, on the CUDA cores.
//
// Replaces: paddle_tpu/ops/decode_attention.py `_decode_kernel` (launched by
// `_decode_pallas`) at the types the bf16 kernel (decode_attention.cu) does
// not take.  For q [B, S, H, D] against k/v [B, Hkv, L, D], query position
// s of slot b attends keys [0, lengths[b] - S + s] (lengths = offset + S),
// and query head h reads kv head h / (H / Hkv).  generate() at float32 or
// float16 and the dense engine of such a model (whose cache is float32, the
// reference's choice for every non-bf16 model) call it.
//
// What bounds it: bytes.  A decode step reads the K and V rows of every
// valid token once (2 * Hkv * D * 4 bytes a token at float32); its
// arithmetic is a few FLOP a byte, under the card's f32 ridge of about 20.
// What the design does about it: split-K over the capacity, as the bf16
// kernel, so that a tick of 8 slots fills every SM, with a two-stage
// cp.async ring under the products (attention_simt.cuh).  More than 16
// query rows a kv head (prefill chunks, long verifies) run in 64-row tiles.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (paddle_tpu_torch/ops/_build.py does this).

#include "attention_simt.cuh"

// Plain C interface (bound with ctypes).  Returns a cudaError_t: 0 on a
// clean launch.  q_type: 0 float32, 1 float16; kv_type: 0 float32,
// 1 float16, 2 int8 (ks/vs f32 [B, Hkv, L], ignored otherwise); the pairs of
// SIMT_KV_PAIRS, anything else is cudaErrorInvalidValue.  `part` (f32,
// splits * B * Hkv * 16 * (D + 2)) and `ticket` (int32 [B * Hkv], zero)
// serve the split-K merge when S * H / Hkv <= 16 and splits > 1;
// `split_keys` keys a split, a multiple of 64, splits * split_keys >= L.
extern "C" int decode_attention_simt_launch(const void* q, const void* k, const void* v,
                                            const void* ks, const void* vs, const void* lengths,
                                            void* out, void* part, void* ticket, int B, int S,
                                            int H, int Hkv, int D, int L, float scale, int q_type,
                                            int kv_type, int splits, int split_keys,
                                            void* stream) {
  using namespace attention_simt;
  if (L <= 0) return (int)cudaErrorInvalidValue;
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.ks = static_cast<const float*>(ks);
  p.vs = static_cast<const float*>(vs);
  p.lengths = static_cast<const int*>(lengths);
  p.out = out;
  p.part = static_cast<float*>(part);
  p.ticket = static_cast<int*>(ticket);
  p.q_ss = (long long)H * D;
  p.q_sb = (long long)S * H * D;
  p.B = B;
  p.S = S;
  p.H = H;
  p.Hkv = Hkv;
  p.scale_log2 = scale * kLog2e;
  p.splits = splits;
  p.split_keys = split_keys;
  return (int)launch_kv(p, StaticRows{Hkv, L}, D, q_type, kv_type,
                        static_cast<cudaStream_t>(stream));
}

extern "C" const char* attention_simt_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
