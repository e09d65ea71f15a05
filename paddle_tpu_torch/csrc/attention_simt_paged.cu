// Ragged paged attention at float32 and float16 (q float32 or float16; page
// pools float32, float16 or int8 with f32 scale pools), head dims 64, 128
// and 256, on the CUDA cores.
//
// Replaces: paddle_tpu/ops/decode_attention.py `_paged_kernel` (launched by
// `_paged_pallas`) at the types the bf16 kernel (paged_attention.cu) does
// not take.  One kernel serves every query block of the paged engine: S = 1
// decode ticks, speculative verifies and S = prefill_chunk chunks at any
// per-slot offset.  For q [B, S, H, D] against pools [P, Hkv, ps, D] walked
// through page_tbl [B, M], query position s of slot b attends keys
// [0, lengths[b] - S + s] (lengths = offset + S), and query head h reads kv
// head h / (H / Hkv).  The paged engine of a float32 or float16 model
// (whose pools are float32, the reference's choice) calls it.
//
// What bounds it: a decode tick reads every valid K/V row once (bytes); a
// prefill chunk does 4 * D FLOP a visible (query row, key) pair, past the
// f32 ridge (operations).  What the design does about it
// (attention_simt.cuh): split-K decode ticks over the table's capacity, and
// 64-row tiles for chunks that skip the key tiles past their last row's
// causal end; each block reads the page table itself and streams its pages
// through a two-stage cp.async ring.  A walk never reads a page past the
// slot's last valid key: those rows of a tile are zero-filled.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (paddle_tpu_torch/ops/_build.py does this).

#include "attention_simt.cuh"

// Plain C interface (bound with ctypes).  Returns a cudaError_t: 0 on a
// clean launch.  Types as decode_attention_simt_launch; int8 pools pass
// f32 scale pools [P, Hkv, ps].  `part`, `ticket`, `splits` and
// `split_keys` as there, with the capacity M * ps.
extern "C" int paged_attention_simt_launch(const void* q, const void* k, const void* v,
                                           const void* ks, const void* vs, const void* lengths,
                                           const void* page_tbl, void* out, void* part,
                                           void* ticket, int B, int S, int H, int Hkv, int D,
                                           int P, int ps, int M, float scale, int q_type,
                                           int kv_type, int splits, int split_keys,
                                           void* stream) {
  using namespace attention_simt;
  if (P <= 0 || ps <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
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
  return (int)launch_kv(p, PagedRows{static_cast<const int*>(page_tbl), Hkv, ps, M}, D, q_type,
                        kv_type, static_cast<cudaStream_t>(stream));
}

extern "C" const char* attention_simt_paged_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
