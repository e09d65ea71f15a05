// Ragged paged attention for Hopper (sm_90a), bf16 or int8 page pools.
//
// Replaces: paddle_tpu/ops/decode_attention.py `_paged_kernel` (launched by
// `_paged_pallas`).  One kernel serves every query block the paged serving
// engine produces: S = 1 decode ticks and S = prefill_chunk chunks at any
// per-slot offset.  For q [B, S, H, D] against page pools [P, Hkv, ps, D]
// walked through page_tbl [B, M], query position s of slot b attends keys
// [0, lengths[b] - S + s] (lengths = offset + S), and query head h reads
// kv head h / (H / Hkv).
//
// What bounds it on this card: a decode tick is memory bound.  It must read
// the K and V rows of every valid token once (2 * Hkv * D bytes per token in
// bf16, half of that in int8), so its floor is those bytes over the H100's
// 3.35 TB/s; its arithmetic (4 * rows * keys * D operations) is two orders
// below the tensor-core rate.  A long prefill chunk reads the same bytes but
// does S * rep times the arithmetic, so it is the one case that leans on
// operations.
//
// What the design does about it (kv_attention.cuh, shared with the static
// decode kernel): one block per (row tile, kv head, slot).  The block reads
// its own lengths[b] and page-table row, and walks only the keys its rows
// can see causally, so it never reads past the slot's last valid page and a
// prefill tile stops at its own causal end.  A live slot's walk never
// touches the trash page 0; an idle slot, whose row the engine masks to
// page 0 at length 1, reads one key of it and its output is discarded.  All
// S * rep query rows that share a kv head sit in the same tile, so GQA reads
// each K/V row once for up to 16 query rows.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (paddle_tpu_torch/ops/_build.py does this).

#include "kv_attention.cuh"

// Plain C interface (bound with ctypes).  Returns a cudaError_t: 0 on a
// clean launch.  Pointers are device pointers; `quant` selects int8 pools
// with f32 scale pools (ks/vs ignored otherwise).
extern "C" int paged_attention_launch(const void* q, const void* k, const void* v,
                                      const void* ks, const void* vs,
                                      const void* lengths, const void* page_tbl,
                                      void* out, int B, int S, int H, int Hkv, int D,
                                      int ps, int M, float scale, int quant,
                                      void* stream) {
  if (D != kv_attention::kD || Hkv <= 0 || H % Hkv != 0 || S <= 0 || B <= 0 ||
      ps <= 0 || M <= 0)
    return (int)cudaErrorInvalidValue;
  const kv_attention::PagedRows rows{static_cast<const int*>(page_tbl), Hkv, ps, M};
  return (int)kv_attention::launch(quant != 0, B, S, H, static_cast<cudaStream_t>(stream),
                                   q, k, v, ks, vs, lengths, out, scale, rows);
}

extern "C" const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
