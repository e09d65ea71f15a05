// Ragged paged attention for Hopper (sm_90a): q bf16, float16 or float32
// against page pools of bf16, float16, float32 or int8 (kv_attention.cuh
// KV_PAIRS; a float16 model's engines keep float32 pools), head dims 64, 128
// and 256.
//
// Replaces: paddle_tpu/ops/decode_attention.py `_paged_kernel` (launched by
// `_paged_pallas`).  One kernel serves every query block the paged serving
// engine produces: S = 1 decode ticks and S = prefill_chunk chunks at any
// per-slot offset.  For q [B, S, H, D] against page pools [P, Hkv, ps, D]
// walked through page_tbl [B, M], query position s of slot b attends keys
// [0, lengths[b] - S + s] (lengths = offset + S), and query head h reads
// kv head h / (H / Hkv); the output is in q's type.
//
// What bounds it on this card: a decode tick is memory bound.  It must read
// the K and V rows of every valid token once (2 * Hkv * D bytes per token in
// bf16 and float16, twice that in float32, half of that in int8), so its
// floor is those bytes over the H100's 3.35 TB/s; its arithmetic (4 * rows
// * keys * D operations, three bf16 products a product at float32) is two
// orders below the tensor-core rate.  A prefill chunk reads the same bytes but
// does S * rep times the arithmetic (4 * D * 256 * 1,500 operations a head
// for a 256-token chunk at offset 1,280): it leans on the tensor cores, and
// only `wgmma` reaches their rate.
//
// What the design does about it (kv_attention.cuh, shared with the static
// decode kernel): two regimes on rows = S * rep.  Decode ticks (rows <= 16)
// split the keys: the grid is (key split, kv head, slot) with the split
// count from the table's capacity M * ps, so a slot of 2,047 keys beside
// slots of 37 is walked by several blocks, each streaming its pages through
// a TMA ring into `mma.sync` products, and the last to finish merges the
// partials in split order in the same launch.  Prefill chunks (rows > 16)
// run on `wgmma` in 128-row tiles, as the flash forward does, and skip the
// key tiles above their last row's causal end.  Each block reads the page
// table on the device and uses the page index as a TMA coordinate into a
// map over the pool's P * Hkv * ps rows (int8 pages and their scales by
// bulk copies; page sizes that do not tile 64-key runs, row by row with
// cp.async); a float32 pool's tiles are split into their bf16 planes in
// shared memory, never in device memory.  A live slot's walk never goes
// past its last valid page, so
// it never touches the trash page 0; an idle slot, whose row the engine
// masks to page 0 at length 1, reads one run of it and its output is
// discarded.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (paddle_tpu_torch/ops/_build.py does this).

#include "kv_attention.cuh"

// Plain C interface (bound with ctypes).  Returns a cudaError_t: 0 on a
// clean launch.  Pointers are device pointers; q_type and kv_type are type
// codes (kv_attention.cuh KV_TYPES: 0 float32, 1 bf16, 2 float16, 3 int8),
// a pair of KV_PAIRS, and out is of q's type; int8 pools take f32 scale
// pools ks/vs [P, Hkv, ps] (ignored otherwise).  `part` (f32, splits * B *
// Hkv * 16 * (D + 2)) and `ticket` (int32 [B * Hkv], zero) serve the
// split-K merge of the decode regime (S * H / Hkv <= 16) when splits > 1;
// `split_keys` keys a split, a multiple of 64, splits * split_keys >= M * ps.
extern "C" int paged_attention_launch(const void* q, const void* k, const void* v,
                                      const void* ks, const void* vs,
                                      const void* lengths, const void* page_tbl,
                                      void* out, void* part, void* ticket, int B, int S, int H,
                                      int Hkv, int D, int P, int ps, int M, float scale,
                                      int q_type, int kv_type, int splits, int split_keys,
                                      void* stream) {
  using namespace kv_attention;
  if (P <= 0 || ps <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, static_cast<const float*>(ks), static_cast<const float*>(vs),
                 static_cast<const int*>(lengths), out, static_cast<float*>(part),
                 static_cast<int*>(ticket), B, S, H, Hkv, /*rep: launch_kv() sets it*/ 0,
                 scale * kLog2e, split_keys};
  return (int)launch_kv(p, PagedRows{static_cast<const int*>(page_tbl), Hkv, ps, M, P}, D, q_type,
                        kv_type, splits, M * ps, static_cast<cudaStream_t>(stream));
}

extern "C" const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
