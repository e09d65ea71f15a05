// Decode attention over a head-major static kv cache for Hopper (sm_90a):
// q bf16, float16 or float32 against caches of bf16, float16, float32 or
// int8 (kv_attention.cuh KV_PAIRS), head dims 64, 128 and 256.
//
// Replaces: paddle_tpu/ops/decode_attention.py `_decode_kernel` (launched by
// `_decode_pallas`).  For q [B, S, H, D] against k/v [B, Hkv, L, D] (or
// int8 with f32 per-(head, token) scales [B, Hkv, L]), query position s
// of slot b attends keys [0, lengths[b] - S + s] (lengths = offset + S, the
// offset a scalar or per slot), and query head h reads kv head
// h / (H / Hkv); the output is in q's type.  generate() and the dense
// engine call it with S = 1; an S > 1 block takes per-row causal ends, as
// the paged kernel does.
//
// What bounds it on this card: bytes.  A decode step must read the K and V
// rows of every valid token once (2 * Hkv * D bytes per token in bf16 and
// float16, twice that in float32, half that plus 8 bytes of scales in
// int8), so its floor is those bytes over the H100's 3.35 TB/s; its
// arithmetic (4 * D operations per query row and key, three bf16 products
// a product at float32) is two orders below the tensor-core rate.  Reaching
// the floor takes every SM streaming at once, whatever the slots' lengths.
//
// What the design does about it (kv_attention.cuh, shared with the paged
// kernel): split-K.  The grid is (key split, kv head, slot), with the
// split count chosen on the host from the capacity L so that the call
// fills the 132 SMs about twice over; a slot of 2,047 keys is walked by
// several blocks at once instead of one, and a split past a slot's length
// returns at once.  Each block streams its contiguous [L, D] rows through a
// TMA ring (bulk copies for int8 and scales; cp.async when L is not a
// multiple of 64) that overlaps the next tiles' loads with the current
// one's `mma.sync` products, and holds the rep query heads of its kv head as
// the rows of one m16 tile, so GQA reads each K/V row once for up to 16
// query rows.  The last split to finish merges the partials in split order
// within the same launch.  A float32 cache's tiles land as they are
// stored and each warp splits its own 16 rows into bf16 planes in shared
// memory, so float32 moves its 4 bytes an element and no more.  The
// reference's `B*H <= 192` gate (a TPU
// measurement) is not copied: every shape runs here.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (paddle_tpu_torch/ops/_build.py does this).

#include "kv_attention.cuh"

// Plain C interface (bound with ctypes).  Returns a cudaError_t: 0 on a
// clean launch.  Pointers are device pointers; q_type and kv_type are type
// codes (kv_attention.cuh KV_TYPES: 0 float32, 1 bf16, 2 float16, 3 int8),
// a pair of KV_PAIRS, and out is of q's type; int8 caches take f32 scales
// ks/vs (ignored otherwise).  `part` (f32, splits * B * Hkv * 16 * (D + 2))
// and `ticket` (int32 [B * Hkv], zero) serve the split-K merge of the
// decode regime (S * H / Hkv <= 16) when splits > 1; `split_keys` keys a
// split, a multiple of 64, splits * split_keys >= L.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* ks, const void* vs,
                                       const void* lengths, void* out, void* part, void* ticket,
                                       int B, int S, int H, int Hkv, int D, int L, float scale,
                                       int q_type, int kv_type, int splits, int split_keys,
                                       void* stream) {
  using namespace kv_attention;
  const Params p{q, k, v, static_cast<const float*>(ks), static_cast<const float*>(vs),
                 static_cast<const int*>(lengths), out, static_cast<float*>(part),
                 static_cast<int*>(ticket), B, S, H, Hkv, /*rep: launch_kv() sets it*/ 0,
                 scale * kLog2e, split_keys};
  return (int)launch_kv(p, StaticRows{Hkv, L, B}, D, q_type, kv_type, splits, L,
                        static_cast<cudaStream_t>(stream));
}

extern "C" const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
