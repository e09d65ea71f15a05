// Decode attention over a head-major static kv cache for Hopper (sm_90a),
// bf16 or int8 caches.
//
// Replaces: paddle_tpu/ops/decode_attention.py `_decode_kernel` (launched by
// `_decode_pallas`).  For q [B, S, H, D] against k/v [B, Hkv, L, D] (bf16,
// or int8 with f32 per-(head, token) scales [B, Hkv, L]), query position s
// of slot b attends keys [0, lengths[b] - S + s] (lengths = offset + S, the
// offset a scalar or per slot), and query head h reads kv head
// h / (H / Hkv).  generate() and the dense engine call it with S = 1; an
// S > 1 block takes per-row causal ends, as the paged kernel does.
//
// What bounds it on this card: bytes.  A decode step must read the K and V
// rows of every valid token once (2 * Hkv * D bytes per token in bf16, half
// that plus 8 bytes of scales in int8), so its floor is those bytes over
// the H100's 3.35 TB/s; its arithmetic (4 * D operations per query row and
// key) is two orders below the tensor-core rate.
//
// What the design does about it (kv_attention.cuh, shared with the paged
// kernel): one block per (kv head, slot), which holds the rep query heads
// of that kv head as the rows of one tile, so GQA reads each K/V row once
// for up to 16 query rows.  The block walks keys [0, lengths[b]) of its
// contiguous [L, D] rows in 64-key chunks with 16-byte coalesced loads and
// stops at the slot's valid length, so the bytes it moves are the valid
// rows and nothing past them; int8 rows dequantize in shared memory, so an
// int8 cache halves the bytes read.  The reference's `B*H <= 192` gate
// (a TPU measurement) is not copied: every shape runs here.  Known
// shortfall: the 70B layout (64 query / 8 kv heads) at 8 slots makes 64
// blocks on 132 SMs, each walking up to 2,047 keys alone; split-K over
// the keys is later work (PERF.md).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (paddle_tpu_torch/ops/_build.py does this).

#include "kv_attention.cuh"

// Plain C interface (bound with ctypes).  Returns a cudaError_t: 0 on a
// clean launch.  Pointers are device pointers; `quant` selects int8 caches
// with f32 scales (ks/vs ignored otherwise).
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* ks, const void* vs,
                                       const void* lengths, void* out, int B, int S,
                                       int H, int Hkv, int D, int L, float scale,
                                       int quant, void* stream) {
  if (D != kv_attention::kD || Hkv <= 0 || H % Hkv != 0 || S <= 0 || B <= 0 || L <= 0)
    return (int)cudaErrorInvalidValue;
  const kv_attention::StaticRows rows{Hkv, L};
  return (int)kv_attention::launch(quant != 0, B, S, H, static_cast<cudaStream_t>(stream),
                                   q, k, v, ks, vs, lengths, out, scale, rows);
}

extern "C" const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
