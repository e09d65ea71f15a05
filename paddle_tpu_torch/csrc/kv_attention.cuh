// Attention of a query block against a kv cache walked by key tiles: the
// device code shared by paged_attention.cu (a page pool behind page tables)
// and decode_attention.cu (a head-major static cache), on the Hopper
// building blocks of wgmma_attention.cuh.  The two caches differ only in
// where key position kpos of slot b and kv head kvh lives, which a `Rows`
// policy answers (PagedRows, StaticRows below).
//
// For q [B, S, H, D], query position s of slot b attends keys
// [0, lengths[b] - S + s] (lengths = offset + S), never past the cache's
// capacity, and query head h reads kv head h / rep (rep = H / Hkv).  The
// S * rep query rows of one (kv head, slot) are laid out as the reference
// kernel lays them out: row s * rep + r is position s of head kvh * rep + r.
// Head dims 64, 128 and 256.  Key tiles are kBK = 64 keys.
//
// Element types (KV_PAIRS below): q bfloat16 against bf16 or int8 caches,
// q float32 against float32 or int8 caches, q float16 against float16,
// float32 (a float16 model's engines keep float32 pools, as the
// reference's) or int8 caches; the output in q's type.  Every product runs
// on the tensor cores with f32 sums (Kv below): bf16 and float16 operands
// as they are (`.bf16` or `.f16` products); int8 widened exactly to bf16
// in shared memory; float32 operands as split-bf16 products (split_bf16.cuh:
// two bf16 planes an operand, hi = RN(x) and lo = RN(x - hi), and the terms
// of SPLIT_BF16_TERMS, the float32 flash and encoder kernels' arithmetic).
// A float16 q against a float32 or int8 cache is two bf16 planes too, which
// hold it exactly (11 significand bits in 8 + 8): against int8 its scores
// are exact.  An f32 key tile lands in shared memory as it is stored and is
// split in place into its planes (split_rows / make_planes), never in
// device memory; q is split once a block, as it is loaded.
//
// Two regimes behind one dispatch on rows = S * rep, known on the host:
//
// * Decode (rows <= 16): split-K.  One block of four warps per (key split,
//   kv head, slot).  The split length comes from the capacity (never from
//   `lengths`, which the host does not read), so the grid is fixed for a
//   shape; a split that starts past its slot's causal end returns at once.
//   The rows, padded to 16, are the M of `mma.sync m16n8k16`: each warp
//   takes 16 keys of every tile (and splits or dequantizes those rows
//   itself), scores them on the tensor cores with its own online softmax,
//   and runs P V likewise (the tensor cores leave the cores free for the
//   softmax, the split and the dequant).  The four warps merge in order,
//   and the splits merge in split order: the last block of a (kv head,
//   slot) to arrive, by a ticket it resets, reads the other splits' (m, l,
//   acc) partials and writes the output, so the bits do not depend on which
//   block ran first and a call is one launch.
// * Chunk (rows > 16): tensor cores on `wgmma`.  One block of two 64-row
//   warpgroups per (128-row tile, kv head, slot), as the flash forward:
//   S = Q K^T as m64n64k16 from shared memory, the online softmax in f32
//   registers, O += P V as m64nDk16 with P from registers.  Where a row of
//   planes is wider than 256 bf16 (D = 256 with q's or the cache's planes)
//   the block takes 64 rows, which both warpgroups score, each owning one
//   half of O's columns, as the float32 flash forward at D = 256 does.  Key
//   tiles past the tile's last row's causal end are never loaded; only
//   tiles that cross a row's end are masked.
//
// Loads (both regimes): a ring of key tiles in shared memory, K and V as
// 128-byte panels with the 128-byte swizzle (the layout `wgmma` and
// `ldmatrix` read without bank conflicts; an f32 tile's panels hold 32
// values a row until the split makes them 64 bf16).  Where a page (or the
// static cache's [L, D] rows) holds whole runs of 8-row multiples
// (PagedRows / StaticRows::bulk_ok), thread 0 fills the ring: 2- and 4-byte
// tiles by TMA from a 2-D map over every row of the pool (the page index,
// read from the table on the device, is a runtime coordinate), int8 tiles
// and their f32 scales by bulk copies, each stage completing an mbarrier
// (wgmma_attention.cuh's waits trap after 2 s instead of hanging).  Other
// page sizes load row by row with `cp.async` by every thread.  int8 tiles
// land raw and are dequantized (exactly: int8 -> bf16) into a swizzled bf16
// tile before the products read them.  No walk reads a page past the
// slot's last valid key: a tile's runs beyond it repeat that last run.  A
// stage of a float32 cache at D = 256 is 128 KB, so that ring has one
// stage: a tile loads once every thread has released the one before.
//
// Numerics follow the reference kernels: NEG_INF = -1e30 is finite; int8
// k-scales multiply the scores after the dot, v-scales multiply p after l
// is updated, and p is rounded to v's type before the P V product (bf16
// against an int8 cache; at float32 it is split, not rounded); a row with
// no visible key (a slot with lengths <= 0) emits zeros.  Scores run in
// base-2 units (scale * log2(e)), as the flash kernels' do.
#pragma once

#include <type_traits>

#include "split_bf16.cuh"

// The instantiations, one list each, which paddle_tpu_torch/ops/_admit.py
// admits (a CPU test parses these lines against its lists): (C type, type
// code) of q and of the caches, the (q type, kv type) pairs built, and the
// head dims.
#define KV_TYPES(X) X(float, 0) X(__nv_bfloat16, 1) X(__half, 2) X(int8_t, 3)
#define KV_PAIRS(X) X(__nv_bfloat16, __nv_bfloat16) X(__nv_bfloat16, int8_t) X(float, float) X(__half, __half) X(__half, float) X(float, int8_t) X(__half, int8_t)
#define KV_DIMS(X) X(64) X(128) X(256)

namespace kv_attention {

using namespace split_bf16;

constexpr int kBK = 64;            // keys per tile, both regimes
constexpr int kDecRows = 16;       // decode regime: the m16 tile of query rows
constexpr int kDecWarps = 4;       // a warp takes 16 keys of every tile
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kChunkRows = 128;    // chunk regime: two warpgroups of 64 rows
constexpr int kMaxSplits = 64;     // decode regime: most key splits of a launch

template <typename T>
constexpr int type_code();
#define X(T, CODE) \
  template <>      \
  constexpr int type_code<T>() { return CODE; }
KV_TYPES(X)
#undef X

// What a (q type, kv type) pair computes with: the products' 2-byte type E
// (float16 against a float16 cache, bf16 otherwise), q's planes PQ (1 where
// q is E; 2 for float32 q and for float16 q against a float32 or int8
// cache), the cache's planes PKV (2 at float32), and PT, the type p takes
// before P V: float (split into planes) against a float32 cache, E
// otherwise (v's type, or bf16 against int8).
template <typename TQ, typename TKV>
struct Kv {
  static constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  using E = std::conditional_t<std::is_same<TKV, __half>::value, __half, bf16>;
  static constexpr int PQ = std::is_same<TQ, E>::value ? 1 : 2;
  static constexpr int PKV = std::is_same<TKV, float>::value ? 2 : 1;
  using PT = std::conditional_t<PKV == 2, float, E>;
  static_assert(PQ == 1 || std::is_same<E, bf16>::value, "q's planes are bf16");
};

// ------------------------------------------------------------- row policies

// Paged: key kpos of slot b lives in page tbl[b, kpos / ps] at row kpos % ps
// of a pool [P, Hkv, ps, D]; the table has M entries per slot.
struct PagedRows {
  const int* tbl;
  int Hkv, ps, M, P;
  __device__ __forceinline__ int capacity() const { return M * ps; }
  __device__ __forceinline__ size_t row(int b, int kvh, int kpos) const {
    return ((size_t)tbl[(size_t)b * M + kpos / ps] * Hkv + kvh) * ps + kpos % ps;
  }
  // rows of one contiguous run of a key tile (a whole tile or a whole page)
  __host__ __device__ __forceinline__ int run() const { return ps < kBK ? ps : kBK; }
  // runs of 8-row multiples that tile both the page and the key tile
  bool bulk_ok() const { return ps % 8 == 0 && (ps % kBK == 0 || kBK % ps == 0); }
  size_t rows_total() const { return (size_t)P * Hkv * ps; }
};

// Static: key kpos of slot b is row kpos of the head-major [B, Hkv, L, D].
struct StaticRows {
  int Hkv, L, B;
  __device__ __forceinline__ int capacity() const { return L; }
  __device__ __forceinline__ size_t row(int b, int kvh, int kpos) const {
    return ((size_t)b * Hkv + kvh) * L + kpos;
  }
  __host__ __device__ __forceinline__ int run() const { return kBK; }
  bool bulk_ok() const { return L % kBK == 0; }
  size_t rows_total() const { return (size_t)B * Hkv * L; }
};

struct Params {
  const void* q;          // [B, S, H, D] of q's type
  const void* k;          // rows of D of the cache's type
  const void* v;
  const float* ks;        // int8: one f32 per row
  const float* vs;
  const int* lengths;     // [B]
  void* out;              // [B, S, H, D] of q's type
  float* part;            // decode regime, splits > 1: the split partials
  int* ticket;            // [B * Hkv], zero between launches
  int B, S, H, Hkv, rep;
  float scale_log2;       // scale * log2(e)
  int split_keys;         // decode regime: keys per split, a multiple of kBK
};

// ------------------------------------------------------------ shared tiles

// Element (r, c) of a tile of ROWS rows of 2-byte elements stored as
// 64-column panels of ROWS x 64 with the 128-byte swizzle (16-byte chunk ch
// of row r at chunk ch ^ (r % 8)), as TMA writes it and `wgmma` reads it.
template <int ROWS>
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 6) * ROWS * kPanel + r * kPanel + ((((c >> 3) & 7) ^ (r & 7)) << 3) + (c & 7);
}

// The same place as a byte offset, for byte column bc of a row of any
// element size (128-byte panels).
template <int ROWS>
__device__ __forceinline__ int swz_bytes(int r, int bc) {
  return (bc >> 7) * ROWS * 128 + r * 128 + ((((bc >> 4) & 7) ^ (r & 7)) << 4) + (bc & 15);
}

template <int ROWS, int W, typename E>
struct alignas(1024) QTile {  // ROWS query rows of W columns (q's planes side by side)
  E x[ROWS * W];
};

// K and V of one key tile, swizzled panels of W 2-byte columns: the cache's
// 2-byte values, or an f32 tile's bf16 planes (loaded as its D f32 values a
// row, then split in place).
template <typename E, int W>
struct alignas(1024) TileKV {
  E k[kBK * W];
  E v[kBK * W];
};

template <int D>
struct alignas(128) TileI8 {     // the raw int8 rows of a key tile and their scales
  int8_t k[kBK * D];
  int8_t v[kBK * D];
  float ks[kBK];
  float vs[kBK];
};

template <int D>
struct alignas(1024) Work {      // an int8 tile dequantized for the products
  TileKV<bf16, D> kv;
  float ks[kBK];
  float vs[kBK];
};

// A ring stage of the cache type TKV: raw int8 rows, or a TileKV of the
// products' type E at W = the cache's planes x D columns.
template <int D, typename TQ, typename TKV>
using Stage = std::conditional_t<Kv<TQ, TKV>::kQuant, TileI8<D>,
                                 TileKV<typename Kv<TQ, TKV>::E, Kv<TQ, TKV>::PKV * D>>;

struct Empty {};

template <int N>
struct Bars {
  uint64_t full[N], empty[N];
};

// Thread 0 sets up the ring: a stage is full once its loads have landed
// (one arrival with the TMA or bulk bytes) and empty once all NT threads
// have released it.  The block syncs after.
template <int N, int NT>
__device__ __forceinline__ void init_bars(Bars<N>& bars) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < N; ++s) {
      mbar_init(&bars.full[s], 1);
      mbar_init(&bars.empty[s], NT);
    }
    fence_barrier_init();
  }
  __syncthreads();
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                            int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------------------------- ring

// The key tiles of one block's walk, j = 0 .. T - 1 (keys kbase + 64 j),
// through N stages of type St holding the cache's TKV rows.  PROD: thread 0
// issues each tile (TMA or bulk copies) and the stages turn on mbarriers.
// Otherwise every thread copies its share with cp.async, one commit group a
// tile, and the block syncs on each tile (PROXY: and fences its copies for
// the async proxy, which `wgmma` reads through).  A tile's keys past `kend`
// (the block's walk) repeat the last valid run, so no page past the slot's
// end is read.  Each iteration j calls top(j), wait(j), refill(j) and, once
// done with the stage, release(j); with N = 1 top(j) issues tile j after
// every thread has released tile j - 1, and refill does nothing.
template <int D, typename TKV, class St, bool PROD, bool PROXY, int NT, int N, class Rows>
struct Pipe {
  static constexpr bool QUANT = std::is_same<TKV, int8_t>::value;
  St* st;
  Bars<N>* bars;
  const CUtensorMap* tk;
  const CUtensorMap* tv;
  const Params* p;
  Rows rows;
  int b, kvh, kbase, kend, T;

  __device__ __forceinline__ void issue(int j) const {
    St& s = st[j % N];
    const int kb = kbase + j * kBK;
    if constexpr (PROD) {
      uint64_t* full = &bars->full[j % N];
      const int run = rows.run();
      const int last = (kend - 1) / run * run;  // the start of the last valid run
      if constexpr (!QUANT) {
        constexpr int kCols = 128 / sizeof(TKV);  // values of a 128-byte panel row
        mbar_expect_tx(full, 2 * kBK * D * sizeof(TKV));
        unsigned char* sk = reinterpret_cast<unsigned char*>(s.k);
        unsigned char* sv = reinterpret_cast<unsigned char*>(s.v);
        for (int i = 0; i < kBK; i += run) {
          const int r = (int)rows.row(b, kvh, min(kb + i, last));
#pragma unroll
          for (int pn = 0; pn < D / kCols; ++pn) {
            tma_load_2d(sk + (pn * kBK + i) * 128, tk, full, pn * kCols, r);
            tma_load_2d(sv + (pn * kBK + i) * 128, tv, full, pn * kCols, r);
          }
        }
      } else {
        mbar_expect_tx(full, 2 * kBK * D + 2 * kBK * 4);
        const int8_t* k8 = static_cast<const int8_t*>(p->k);
        const int8_t* v8 = static_cast<const int8_t*>(p->v);
        for (int i = 0; i < kBK; i += run) {
          const size_t r = rows.row(b, kvh, min(kb + i, last));
          bulk_load(s.k + i * D, k8 + r * D, run * D, full);
          bulk_load(s.v + i * D, v8 + r * D, run * D, full);
          bulk_load(s.ks + i, p->ks + r, run * 4, full);
          bulk_load(s.vs + i, p->vs + r, run * 4, full);
        }
      }
    } else {
      if constexpr (!QUANT) {
        constexpr int kRow = D * (int)sizeof(TKV), CH = kRow / 16;  // 16-byte chunks a row
        const unsigned char* kp = static_cast<const unsigned char*>(p->k);
        const unsigned char* vp = static_cast<const unsigned char*>(p->v);
        unsigned char* sk = reinterpret_cast<unsigned char*>(s.k);
        unsigned char* sv = reinterpret_cast<unsigned char*>(s.v);
        for (int i = threadIdx.x; i < kBK * CH; i += NT) {
          const int r = i / CH, bc = (i % CH) * 16;
          const size_t src = rows.row(b, kvh, min(kb + r, kend - 1)) * kRow + bc;
          cp_async16(sk + swz_bytes<kBK>(r, bc), kp + src);
          cp_async16(sv + swz_bytes<kBK>(r, bc), vp + src);
        }
      } else {
        constexpr int CH = D / 16;
        const int8_t* k8 = static_cast<const int8_t*>(p->k);
        const int8_t* v8 = static_cast<const int8_t*>(p->v);
        for (int i = threadIdx.x; i < kBK * CH; i += NT) {
          const int r = i / CH, c = (i % CH) * 16;
          const size_t src = rows.row(b, kvh, min(kb + r, kend - 1)) * D + c;
          cp_async16(s.k + r * D + c, k8 + src);
          cp_async16(s.v + r * D + c, v8 + src);
        }
        for (int i = threadIdx.x; i < kBK; i += NT) {
          const size_t r = rows.row(b, kvh, min(kb + i, kend - 1));
          cp_async4(s.ks + i, p->ks + r);
          cp_async4(s.vs + i, p->vs + r);
        }
      }
    }
  }

  // The first tiles of the walk: N in flight (PROD), N - 1 (cp.async).
  __device__ __forceinline__ void start() const {
    if constexpr (PROD) {
      if (threadIdx.x == 0)
        for (int j = 0; j < min(T, N); ++j) issue(j);
    } else {
#pragma unroll
      for (int j = 0; j < N - 1; ++j) {
        if (j < T) issue(j);
        cp_async_commit();
      }
    }
  }

  // One stage: tile j into it once every thread is done with tile j - 1.
  __device__ __forceinline__ void top(int j) const {
    if constexpr (N == 1) {
      if constexpr (PROD) {
        if (threadIdx.x == 0 && j >= 1) {
          mbar_wait(&bars->empty[0], (j - 1) & 1);
          issue(j);
        }
      } else {
        __syncthreads();
        issue(j);
        cp_async_commit();
      }
    }
  }

  // Tile j is in stage j % N, visible to every thread.
  __device__ __forceinline__ void wait(int j) const {
    if constexpr (PROD) {
      mbar_wait(&bars->full[j % N], (j / N) & 1);
    } else {
      cp_async_wait<N == 1 ? 0 : N - 2>();
      if constexpr (PROXY) fence_proxy_async();
      __syncthreads();
    }
  }

  // Keep the ring full: PROD, thread 0 loads tile j - 1 + N into the stage
  // of tile j - 1 once every thread has released it; cp.async, every thread
  // loads tile j + N - 1 into that stage, which the sync in wait(j) freed.
  __device__ __forceinline__ void refill(int j) const {
    if constexpr (N == 1) {
      return;
    } else if constexpr (PROD) {
      if (threadIdx.x == 0 && j >= 1 && j - 1 + N < T) {
        mbar_wait(&bars->empty[(j - 1) % N], ((j - 1) / N) & 1);
        issue(j - 1 + N);
      }
    } else {
      if (j + N - 1 < T) issue(j + N - 1);
      cp_async_commit();
    }
  }

  __device__ __forceinline__ void release(int j) const {
    if constexpr (PROD) mbar_arrive(&bars->empty[j % N]);
  }
};

// Four int8 (one 32-bit word) as two bf16x2, exactly and without the
// conversion units: byte x + 128 goes into the mantissa of 2^23 (one
// PRMT), 2^23 + 128 is subtracted (FADD), and a small integer's float
// keeps its bits in the upper half, which is its bf16 (PRMT).
__device__ __forceinline__ uint2 int8x4_to_bf16x4(uint32_t w) {
  w ^= 0x80808080u;
  float f[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    f[e] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440u | e)) - 8388736.f;
  return make_uint2(__byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632u),
                    __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632u));
}

// Rows [r0, r0 + n) of a raw int8 tile into the swizzled bf16 work tile
// (int8 -> bf16 is exact), with their scales, by threads tid, tid + nt, ...
template <int D>
__device__ __forceinline__ void dequant(Work<D>& w, const TileI8<D>& s, int r0, int n, int tid,
                                        int nt) {
  constexpr int CH = D / 16;  // 16 int8 a chunk
  for (int i = tid; i < n * CH; i += nt) {
    const int r = r0 + i / CH, c = (i % CH) * 16;
#pragma unroll
    for (int kv = 0; kv < 2; ++kv) {
      const uint4 raw = *reinterpret_cast<const uint4*>((kv ? s.v : s.k) + r * D + c);
      const uint2 h0 = int8x4_to_bf16x4(raw.x), h1 = int8x4_to_bf16x4(raw.y);
      const uint2 h2 = int8x4_to_bf16x4(raw.z), h3 = int8x4_to_bf16x4(raw.w);
      bf16* dst = kv ? w.kv.v : w.kv.k;
      *reinterpret_cast<uint4*>(dst + swz<kBK>(r, c)) = make_uint4(h0.x, h0.y, h1.x, h1.y);
      *reinterpret_cast<uint4*>(dst + swz<kBK>(r, c + 8)) = make_uint4(h2.x, h2.y, h3.x, h3.y);
    }
  }
  for (int i = tid; i < n; i += nt) {
    w.ks[r0 + i] = s.ks[r0 + i];
    w.vs[r0 + i] = s.vs[r0 + i];
  }
}

// Row r (< S * rep) of the (kv head, slot) block: its offset in q and out.
__device__ __forceinline__ size_t row_offset(const Params& p, int b, int kvh, int r, int D) {
  const int s = r / p.rep, h = kvh * p.rep + r % p.rep;
  return ((size_t)(b * p.S + s) * p.H + h) * D;
}

// Eight values of q at `src` (float32 or float16) as f32.
__device__ __forceinline__ void load8(const float* src, float (&x)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(src));
  const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w, x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}

__device__ __forceinline__ void load8(const __half* src, float (&x)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(src));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w[e]));
    x[2 * e] = f.x;
    x[2 * e + 1] = f.y;
  }
}

// Rows [r0, r0 + ROWS) of the block's query rows into a swizzled tile of
// PQ planes (W = PQ D columns: q as stored, or its hi then lo bf16 planes),
// zeros past the R live rows.
template <int ROWS, int D, int NT, typename TQ, int PQ, typename E>
__device__ __forceinline__ void load_q(E* tile, const Params& p, int b, int kvh, int r0, int R) {
  constexpr int CH = D / 8;  // 8 values a step
  const TQ* q = static_cast<const TQ*>(p.q);
  for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 8;
    if constexpr (PQ == 1) {
      static_assert(std::is_same<TQ, E>::value, "one plane: q as stored");
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < R) val = __ldg(reinterpret_cast<const uint4*>(q + row_offset(p, b, kvh, r0 + r, D) + c));
      *reinterpret_cast<uint4*>(tile + swz<ROWS>(r, c)) = val;
    } else {
      float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (r0 + r < R) load8(q + row_offset(p, b, kvh, r0 + r, D) + c, x);
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) hi[e] = split_pair(x[2 * e], x[2 * e + 1], lo[e]);
      *reinterpret_cast<uint4*>(tile + swz<ROWS>(r, c)) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(tile + swz<ROWS>(r, D + c)) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  }
}

// Values of the output in q's type T at element i of `out`: four (i a
// multiple of 4) or two (i even).
template <typename T>
__device__ __forceinline__ void store4(void* out, size_t i, float a, float b, float c, float d) {
  if constexpr (sizeof(T) == 4)
    *reinterpret_cast<float4*>(static_cast<float*>(out) + i) = make_float4(a, b, c, d);
  else
    *reinterpret_cast<uint2*>(static_cast<T*>(out) + i) = make_uint2(pack2<T>(a, b), pack2<T>(c, d));
}

template <typename T>
__device__ __forceinline__ void store2(void* out, size_t i, float a, float b) {
  if constexpr (sizeof(T) == 4)
    *reinterpret_cast<float2*>(static_cast<float*>(out) + i) = make_float2(a, b);
  else
    *reinterpret_cast<uint32_t*>(static_cast<T*>(out) + i) = pack2<T>(a, b);
}

// The causal end of query row r: keys [0, end) are visible.
__device__ __forceinline__ int row_end(const Params& p, int len, int cap, int r) {
  return min(len - p.S + r / p.rep + 1, cap);
}

// ------------------------------------------------------- decode regime: mma.sync

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d (m16 x n8, f32) += a (m16 x k16) b (k16 x n8), a and b of the 2-byte E
template <typename E>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  if constexpr (std::is_same<E, __half>::value)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int D, typename TQ, typename TKV>
struct DecCfg {
  using K = Kv<TQ, TKV>;
  using E = typename K::E;
  static constexpr int WQ = K::PQ * D, W = K::PKV * D;  // columns of q's and a key tile's planes
  // 2-3 blocks a SM at W <= 128 (about 66-102 KB), one at W >= 256 (a
  // float32 cache at D = 256: one 128 KB stage)
  static constexpr int kStages =
      K::kQuant ? (D == 256 ? 3 : 4) : (W == 512 ? 1 : W == 256 ? 2 : W == 128 ? 3 : 4);
  using St = Stage<D, TQ, TKV>;
  struct Merge {  // the four warps' (m, l, acc), read back in warp order
    float m[kDecWarps][kDecRows];
    float l[kDecWarps][kDecRows];
    float f[kDecWarps][kDecRows];   // each warp's weight in its row
    float row_m[kDecRows], row_l[kDecRows];
    float sf[kMaxSplits][kDecRows]; // the last block: each split's weight
    float acc[kDecWarps][kDecRows][D + 4];
  };
  struct Smem {
    QTile<kDecRows, WQ, E> q;
    std::conditional_t<K::kQuant, Work<D>, Empty> work;
    union {
      St st[kStages];
      Merge merge;
    };
    Bars<kStages> bars;
  };
  static constexpr size_t kSmem = sizeof(Smem) + 1024;
  static_assert(kSmem <= 232448, "decode regime: shared memory over the 227 KB a block may use");
};

// Decode regime: block (split, kv head, slot), 128 threads.  Warp w takes
// keys 16 w .. 16 w + 15 of every tile; lane 4 g + t holds score and output
// rows g and g + 8 (the m16n8 accumulator layout).  Against a float32 cache
// at D = 256 the accumulator for all D columns (128 registers) spills
// beside the planes' products, so there the warps pair up (kPairs): warps
// 2 k and 2 k + 1 both score keys 32 k .. 32 k + 31 of every tile and each
// accumulates one half of the columns, 64 registers; the merge then sums
// the pair's halves (the second warp of a pair reports l = 0, so that its
// twin's l counts once).
template <int D, typename TQ, typename TKV, bool PROD, class Rows>
__global__ void __launch_bounds__(kDecThreads)
    kv_decode_kernel(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                     const Params p, const Rows rows) {
  using C = DecCfg<D, TQ, TKV>;
  using K = typename C::K;
  using E = typename C::E;
  constexpr int N = C::kStages, PQ = K::PQ, PKV = K::PKV, PP = Planes<typename K::PT>::P;
  constexpr bool QUANT = K::kQuant;
  constexpr bool kPairs = PKV == 2 && D == 256;
  constexpr int KW = kPairs ? 32 : 16;  // keys of a tile a warp scores
  constexpr int CD = kPairs ? D / 2 : D;  // columns of acc a warp owns
  typename C::Smem& sm = aligned_smem<typename C::Smem>();
  __shared__ int last_block;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int R = p.S * p.rep;
  const int len = p.lengths[b], cap = rows.capacity();
  const int kend = row_end(p, len, cap, R - 1);  // the last row sees the most keys
  const int live = kend > 0 ? (kend + p.split_keys - 1) / p.split_keys : 0;
  if (split >= max(live, 1)) return;  // past the slot's end: no partial, no ticket
  const int k0 = split * p.split_keys;
  const int T = live ? (min(k0 + p.split_keys, kend) - k0 + kBK - 1) / kBK : 0;

  const Pipe<D, TKV, typename C::St, PROD, false, kDecThreads, N, Rows> pipe{
      sm.st, &sm.bars, &tk, &tv, &p, rows, b, kvh, k0, kend, T};
  if constexpr (PROD) init_bars<N, kDecThreads>(sm.bars);
  pipe.start();  // the first tiles are in flight while q loads
  load_q<kDecRows, D, kDecThreads, TQ, PQ>(sm.q.x, p, b, kvh, 0, R);
  __syncthreads();

  int qe[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = g + 8 * hr;
    qe[hr] = r < R ? row_end(p, len, cap, r) : 0;
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this lane's share
  float acc[CD / 8][4];
#pragma unroll
  for (int i = 0; i < CD / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const int key0 = kPairs ? KW * (warp >> 1) : KW * warp;  // the warp's first key of a tile
  const int col0 = kPairs ? CD * (warp & 1) : 0;           // its first column of acc
  const int mi = lane >> 3, mr = lane & 7;  // this lane's ldmatrix row: matrix mi, row mr

  for (int j = 0; j < T; ++j) {
    pipe.top(j);
    pipe.wait(j);
    pipe.refill(j);
    const int kb = k0 + j * kBK;
    const E *kt, *vt;
    const float *kst = nullptr, *vst = nullptr;
    if constexpr (QUANT) {
      dequant<D>(sm.work, sm.st[j % N], key0, 16, lane, 32);
      __syncwarp();
      pipe.release(j);
      kt = sm.work.kv.k;
      vt = sm.work.kv.v;
      kst = sm.work.ks;
      vst = sm.work.vs;
    } else {
      kt = sm.st[j % N].k;
      vt = sm.st[j % N].v;
      if constexpr (PKV == 2) {  // the warp's 16 rows of K and V into their planes
        const int r0 = kPairs ? key0 + 16 * (warp & 1) : key0;
        split_rows<D, kBK>(sm.st[j % N].k, r0, r0 + 16, 4);
        split_rows<D, kBK>(sm.st[j % N].v, r0, r0 + 16, 4);
        if constexpr (kPairs)
          __syncthreads();  // a pair reads each other's rows
        else
          __syncwarp();
      }
    }

    // scores: sc[nb] is keys key0 + 8 nb .. + 7 of rows g, g + 8; plane a
    // of q (columns a D on) by plane c of K, 16 keys a load.  With kPairs
    // each k-step loads its planes once and runs the terms on them (term by
    // term, ptxas spills there); otherwise term by term (k-step by k-step,
    // ptxas spills float32 and float16 q against int8 pages at D = 128, and
    // float32 caches at D = 128 ran 2-5% slower on the card).
    float sc[KW / 8][4];
#pragma unroll
    for (int nb = 0; nb < KW / 8; ++nb) sc[nb][0] = sc[nb][1] = sc[nb][2] = sc[nb][3] = 0.f;
    if constexpr (kPairs) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t qa[PQ][4], kf[PKV][KW / 16][4];
#pragma unroll
        for (int a = 0; a < PQ; ++a)
          ldsm_x4(qa[a], sm.q.x + swz<kDecRows>((mi & 1) * 8 + mr, 16 * kk + a * D + (mi >> 1) * 8));
#pragma unroll
        for (int c = 0; c < PKV; ++c)
#pragma unroll
          for (int h = 0; h < KW / 16; ++h)
            ldsm_x4(kf[c][h], kt + swz<kBK>(key0 + 16 * h + (mi >> 1) * 8 + mr,
                                            16 * kk + c * D + (mi & 1) * 8));
        for_terms<PQ, PKV>([&](auto a, auto c, bool) {
#pragma unroll
          for (int h = 0; h < KW / 16; ++h) {
            mma16816<E>(sc[2 * h], qa[a], kf[c][h][0], kf[c][h][1]);
            mma16816<E>(sc[2 * h + 1], qa[a], kf[c][h][2], kf[c][h][3]);
          }
        });
      }
    } else {
      for_terms<PQ, PKV>([&](auto a, auto c, bool) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t qa[4], kf[4];
          ldsm_x4(qa, sm.q.x + swz<kDecRows>((mi & 1) * 8 + mr, 16 * kk + a * D + (mi >> 1) * 8));
          ldsm_x4(kf, kt + swz<kBK>(key0 + (mi >> 1) * 8 + mr, 16 * kk + c * D + (mi & 1) * 8));
          mma16816<E>(sc[0], qa, kf[0], kf[1]);
          mma16816<E>(sc[1], qa, kf[2], kf[3]);
        }
      });
    }

    // online softmax over the warp's keys
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nb = 0; nb < KW / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = key0 + 8 * nb + 2 * t + (e & 1);
        float x = sc[nb][e] * p.scale_log2;
        if constexpr (QUANT) x *= kst[kl];
        if (kb + kl >= qe[e >> 1]) x = kNegInf;
        sc[nb][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float mu[2], corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float m_new = fmaxf(m[hr], quad_max(mx[hr]));
      mu[hr] = m_new == kNegInf ? 0.f : m_new;  // a row with no visible key yet keeps p = 0
      corr[hr] = exp2f(m[hr] - mu[hr]);
      m[hr] = m_new;
    }
#pragma unroll
    for (int nb = 0; nb < KW / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pe = exp2f(sc[nb][e] - mu[e >> 1]);
        sum[e >> 1] += pe;
        if constexpr (QUANT) pe *= vst[key0 + 8 * nb + 2 * t + (e & 1)];
        sc[nb][e] = pe;
      }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) l[hr] = l[hr] * corr[hr] + sum[hr];
#pragma unroll
    for (int i = 0; i < CD / 8; ++i) {
      acc[i][0] *= corr[0];
      acc[i][1] *= corr[0];
      acc[i][2] *= corr[1];
      acc[i][3] *= corr[1];
    }

    // acc += P V: P (rows x the warp's keys, a k16 step each 16) is the A
    // fragment as it stands, rounded to E, or split into its bf16 planes
    // against f32 V
    uint32_t pa[PP][KW / 16][4];
#pragma unroll
    for (int h = 0; h < KW / 16; ++h)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x0 = sc[2 * h + (r >> 1)][2 * (r & 1)], x1 = sc[2 * h + (r >> 1)][2 * (r & 1) + 1];
        if constexpr (PP == 1)
          pa[0][h][r] = pack2<E>(x0, x1);
        else
          pa[0][h][r] = split_pair(x0, x1, pa[PP - 1][h][r]);
      }
    if constexpr (kPairs) {  // as the scores: each step's planes once
#pragma unroll
      for (int db = 0; db < CD / 16; ++db)
#pragma unroll
        for (int h = 0; h < KW / 16; ++h) {
          uint32_t vf[PKV][4];
#pragma unroll
          for (int c = 0; c < PKV; ++c)
            ldsm_x4_t(vf[c], vt + swz<kBK>(key0 + 16 * h + (mi & 1) * 8 + mr,
                                           col0 + 16 * db + c * D + (mi >> 1) * 8));
          for_terms<PP, PKV>([&](auto a, auto c, bool) {
            mma16816<E>(acc[2 * db], pa[a][h], vf[c][0], vf[c][1]);
            mma16816<E>(acc[2 * db + 1], pa[a][h], vf[c][2], vf[c][3]);
          });
        }
    } else {
      for_terms<PP, PKV>([&](auto a, auto c, bool) {
#pragma unroll
        for (int db = 0; db < D / 16; ++db) {
          uint32_t vf[4];
          ldsm_x4_t(vf, vt + swz<kBK>(key0 + (mi & 1) * 8 + mr, 16 * db + c * D + (mi >> 1) * 8));
          mma16816<E>(acc[2 * db], pa[a][0], vf[0], vf[1]);
          mma16816<E>(acc[2 * db + 1], pa[a][0], vf[2], vf[3]);
        }
      });
    }
    if constexpr (!QUANT) {
      if constexpr (PKV == 2) fence_proxy_async();  // the split's stores, before the next load
      pipe.release(j);
    }
  }

  // merge the four warps in order: every load has been consumed, so the
  // ring's shared memory holds the merge
  __syncthreads();
  auto& mg = sm.merge;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] = quad_sum(l[hr]);
    if (t == 0) {
      mg.m[warp][g + 8 * hr] = m[hr];
      mg.l[warp][g + 8 * hr] = kPairs && (warp & 1) ? 0.f : l[hr];
    }
  }
#pragma unroll
  for (int i = 0; i < CD / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float* row = mg.acc[warp][g + 8 * (e >> 1)];
      row[col0 + 8 * i + 2 * t + (e & 1)] = acc[i][e];
      if constexpr (kPairs) row[(CD - col0) + 8 * i + 2 * t + (e & 1)] = 0.f;  // the twin's half
    }
  __syncthreads();
  if (tid < R) {  // each row's max, the warps' weights and the row's sum
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) M = fmaxf(M, mg.m[w][tid]);
    const float mu = M == kNegInf ? 0.f : M;
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      mg.f[w][tid] = exp2f(mg.m[w][tid] - mu);
      L += mg.f[w][tid] * mg.l[w][tid];
    }
    mg.row_m[tid] = M;
    mg.row_l[tid] = L;
  }
  __syncthreads();

  // partials (live > 1): acc [splits][B Hkv][16][D], then (m, l) [splits][B Hkv][16][2]
  const size_t slot = (size_t)b * p.Hkv + kvh;
  const size_t nslot = (size_t)p.B * p.Hkv;
  const auto part_acc = [&](int s, int r) {
    return p.part + (((size_t)s * nslot + slot) * kDecRows + r) * D;
  };
  const auto part_ml = [&](int s, int r) {
    return p.part + (size_t)gridDim.x * nslot * kDecRows * D +
           2 * (((size_t)s * nslot + slot) * kDecRows + r);
  };
  for (int i = tid; i < R * D / 4; i += kDecThreads) {
    const int r = i / (D / 4), c = 4 * (i % (D / 4));
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      const float f = mg.f[w][r];
      const float4 a = *reinterpret_cast<const float4*>(&mg.acc[w][r][c]);
      o.x += f * a.x;
      o.y += f * a.y;
      o.z += f * a.z;
      o.w += f * a.w;
    }
    if (live <= 1) {
      const float L = mg.row_l[r], inv = 1.f / (L <= 0.f ? 1.f : L);
      store4<TQ>(p.out, row_offset(p, b, kvh, r, D) + c, o.x * inv, o.y * inv, o.z * inv, o.w * inv);
    } else {
      *reinterpret_cast<float4*>(part_acc(split, r) + c) = o;
    }
  }
  if (live <= 1) return;
  if (tid < R) *reinterpret_cast<float2*>(part_ml(split, tid)) = make_float2(mg.row_m[tid], mg.row_l[tid]);

  // the last of the slot's live splits to arrive merges them, in split order
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int n = atomicAdd(&p.ticket[slot], 1);
    last_block = n == live - 1;
    if (last_block) p.ticket[slot] = 0;  // ready for the next launch
  }
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  if (tid < R) {  // each row's weight per split (in the merge's f), and 1 / its sum
    float M = kNegInf;
    for (int s = 0; s < live; ++s) M = fmaxf(M, __ldcg(part_ml(s, tid)));
    const float mu = M == kNegInf ? 0.f : M;
    float L = 0.f;
    for (int s = 0; s < live; ++s) {
      const float2 ml = __ldcg(reinterpret_cast<const float2*>(part_ml(s, tid)));
      const float f = exp2f(ml.x - mu);
      mg.sf[s][tid] = f;
      L += f * ml.y;
    }
    mg.row_l[tid] = 1.f / (L <= 0.f ? 1.f : L);
  }
  __syncthreads();
  for (int i = tid; i < R * D / 4; i += kDecThreads) {
    const int r = i / (D / 4), c = 4 * (i % (D / 4));
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int s = 0; s < live; ++s) {
      const float f = mg.sf[s][r];
      const float4 a = __ldcg(reinterpret_cast<const float4*>(part_acc(s, r) + c));
      o.x += f * a.x;
      o.y += f * a.y;
      o.z += f * a.z;
      o.w += f * a.w;
    }
    const float inv = mg.row_l[r];
    store4<TQ>(p.out, row_offset(p, b, kvh, r, D) + c, o.x * inv, o.y * inv, o.z * inv, o.w * inv);
  }
}

// ---------------------------------------------------------- chunk regime: wgmma

template <int D, typename TQ, typename TKV>
struct ChunkCfg {
  using K = Kv<TQ, TKV>;
  using E = typename K::E;
  static constexpr int WQ = K::PQ * D, W = K::PKV * D;
  // a row of planes wider than 256: 64 rows that both warpgroups score,
  // each owning CW = D / 2 columns of O (a 128-row q tile alone would be
  // 128 KB)
  static constexpr bool kSplit = WQ > 256 || W > 256;
  static constexpr int BQ = kSplit ? 64 : kChunkRows;
  static constexpr int CW = kSplit ? D / 2 : D;
  // 160-195 KB: one block a SM at W >= 128 (one 128 KB stage at W = 512)
  static constexpr int kStages = W == 512 ? 1 : W == 256 ? 2 : 4;
  using St = Stage<D, TQ, TKV>;
  struct Smem {
    QTile<BQ, WQ, E> q;
    std::conditional_t<K::kQuant, Work<D>, Empty> work;
    St st[kStages];
    Bars<kStages> bars;
  };
  static constexpr size_t kSmem = sizeof(Smem) + 1024;
  static_assert(kSmem <= 232448, "chunk regime: shared memory over the 227 KB a block may use");
};

// One key tile of the online softmax over a warpgroup's m64 x 64 score
// accumulator, in place: scale (and int8 k-scales), kNegInf at keys at or
// past the row's end qe[half] on tiles that cross one (`edge`), the running
// max and this lane's share of l, o (m64 x CW) rescaled; s becomes p (times
// int8 v-scales, after l).
template <int CW, bool QUANT>
__device__ __forceinline__ void chunk_softmax(float (&s)[kBK / 2], float (&o)[CW / 2], float (&m)[2],
                                              float (&l)[2], float scale_log2, bool edge, int kb,
                                              const int (&qe)[2], int t, const float* ks,
                                              const float* vs) {
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) {
    float x = s[i] * scale_log2;
    if constexpr (QUANT) x *= ks[acc_col(i, t)];
    if (edge && kb + acc_col(i, t) >= qe[acc_half(i)]) x = kNegInf;
    s[i] = x;
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float mx = kNegInf;
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i)
      if (acc_half(i) == hr) mx = fmaxf(mx, s[i]);
    const float m_new = fmaxf(m[hr], quad_max(mx));
    const float mu = m_new == kNegInf ? 0.f : m_new;
    const float corr = exp2f(m[hr] - mu);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i)
      if (acc_half(i) == hr) {
        s[i] = exp2f(s[i] - mu);
        sum += s[i];
      }
    l[hr] = l[hr] * corr + sum;
    m[hr] = m_new;
#pragma unroll
    for (int i = 0; i < CW / 2; ++i)
      if (acc_half(i) == hr) o[i] *= corr;
  }
  if constexpr (QUANT) {
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) s[i] *= vs[acc_col(i, t)];
  }
}

// Chunk regime: block (BQ-row tile, kv head, slot), 256 threads.
template <int D, typename TQ, typename TKV, bool PROD, class Rows>
__global__ void __launch_bounds__(kThreads, 1)
    kv_chunk_kernel(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                    const Params p, const Rows rows) {
  using C = ChunkCfg<D, TQ, TKV>;
  using K = typename C::K;
  using E = typename C::E;
  constexpr int N = C::kStages, BQ = C::BQ, CW = C::CW, KD = D / 16;
  constexpr int PQ = K::PQ, PKV = K::PKV, PP = Planes<typename K::PT>::P;
  constexpr bool QUANT = K::kQuant;
  typename C::Smem& sm = aligned_smem<typename C::Smem>();
  const int r0 = blockIdx.x * BQ, kvh = blockIdx.y, b = blockIdx.z;
  const int R = p.S * p.rep, live_rows = min(BQ, R - r0);
  const int len = p.lengths[b], cap = rows.capacity();
  const int kend = row_end(p, len, cap, r0 + live_rows - 1);
  const int T = kend > 0 ? (kend + kBK - 1) / kBK : 0;

  const Pipe<D, TKV, typename C::St, PROD, !QUANT, kThreads, N, Rows> pipe{
      sm.st, &sm.bars, &tk, &tv, &p, rows, b, kvh, 0, kend, T};
  if constexpr (PROD) init_bars<N, kThreads>(sm.bars);
  pipe.start();  // the first tiles are in flight while q loads
  load_q<BQ, D, kThreads, TQ, PQ>(sm.q.x, p, b, kvh, r0, R);
  fence_proxy_async();  // the threads' stores, read by wgmma
  __syncthreads();

  const int wg = warpgroup(), warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int wrow0 = C::kSplit ? 0 : 64 * wg;         // the warpgroup's first row in the tile
  const int row = wrow0 + 16 * warp + (lane >> 2);   // this thread's rows: row, row + 8
  const int col0 = C::kSplit ? CW * wg : 0;          // its first column of O
  int qe[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r0 + row + 8 * hr;
    qe[hr] = r < R ? row_end(p, len, cap, r) : 0;
  }
  // the warpgroup's first row ends first: a tile below its end needs no mask
  const int wfirst = r0 + wrow0;
  const int first_end = wfirst < R ? row_end(p, len, cap, wfirst) : 0;
  const E* qw = sm.q.x + wrow0 * kPanel;
  float o[CW / 2];
#pragma unroll
  for (int i = 0; i < CW / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int j = 0; j < T; ++j) {
    pipe.top(j);
    pipe.wait(j);
    const int kb = j * kBK;
    const E *kt, *vt;
    const float *kst = nullptr, *vst = nullptr;
    if constexpr (QUANT) {
      if constexpr (PROD) __syncthreads();  // every product of tile j - 1 is done
      dequant<D>(sm.work, sm.st[j % N], 0, kBK, threadIdx.x, kThreads);
      fence_proxy_async();
      __syncthreads();
      pipe.release(j);
      kt = sm.work.kv.k;
      vt = sm.work.kv.v;
      kst = sm.work.ks;
      vst = sm.work.vs;
    } else {
      make_planes<TKV, D, kBK>(sm.st[j % N].k, sm.st[j % N].v);  // float32: split in place
      kt = sm.st[j % N].k;
      vt = sm.st[j % N].v;
    }
    float sc[kBK / 2];
    wg_fence();
    for_terms<PQ, PKV>([&](auto a, auto c, bool first) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        Mma<kBK, E>::ss(sc, desc_k<BQ>(qw, kk + a * KD), desc_k<kBK>(kt, kk + c * KD),
                        !first || kk > 0);
    });
    wg_commit();
    pipe.refill(j);
    wg_wait();
    fence_regs(sc);
    chunk_softmax<CW, QUANT>(sc, o, m, l, p.scale_log2, kb + kBK > first_end, kb, qe, t, kst, vst);
    uint32_t pa[PP][kBK / 16][4];
    to_planes<kBK, typename K::PT>(pa, sc);
    wg_fence();
    for_terms<PP, PKV>([&](auto a, auto c, bool) {
      // plane c of V, this warpgroup's columns: panels (c D + col0) / 64 on
      const E* vc = vt + ((c * D + col0) / kPanel) * kBK * kPanel;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) Mma<CW, E>::rs(o, pa[a][kk], desc_mn<kBK>(vc, kk));
    });
    wg_commit();
    wg_wait();
    fence_regs(o);
    if constexpr (!QUANT) pipe.release(j);
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const float lt = quad_sum(l[hr]);
    const float inv = 1.f / (lt <= 0.f ? 1.f : lt);
    const int r = r0 + row + 8 * hr;
    if (r >= R) continue;
    const size_t at = row_offset(p, b, kvh, r, D) + col0;
#pragma unroll
    for (int i = 0; i < CW / 8; ++i)
      store2<TQ>(p.out, at + 8 * i + 2 * t, o[4 * i + 2 * hr] * inv, o[4 * i + 2 * hr + 1] * inv);
  }
}

// -------------------------------------------------------------------- host

// The TMA map of `rows` rows of D values of T at `ptr`: boxes of `box_rows`
// rows x 128 bytes (64 2-byte values, 32 f32) with the 128-byte swizzle.
template <typename T>
inline cudaError_t make_rows_map(CUtensorMap* map, const void* ptr, size_t rows, int D, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / sizeof(T)), (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, Elem<T>::kTma, 2, const_cast<void*>(ptr), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename Kernel>
inline cudaError_t run_kernel(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t st,
                              const CUtensorMap& tk, const CUtensorMap& tv, const Params& p,
                              const void* rows_ptr) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  void* args[] = {const_cast<CUtensorMap*>(&tk), const_cast<CUtensorMap*>(&tv),
                  const_cast<Params*>(&p), const_cast<void*>(rows_ptr)};
  return cudaLaunchKernel(reinterpret_cast<const void*>(kernel), grid, dim3(threads), args, smem, st);
}

template <int D, typename TQ, typename TKV, bool PROD, class Rows>
cudaError_t launch_d(const Params& p, const Rows& rows, int splits, const CUtensorMap& tk,
                     const CUtensorMap& tv, cudaStream_t st) {
  const int R = p.S * p.rep;
  if (R <= kDecRows)
    return run_kernel(kv_decode_kernel<D, TQ, TKV, PROD, Rows>, dim3(splits, p.Hkv, p.B),
                      kDecThreads, DecCfg<D, TQ, TKV>::kSmem, st, tk, tv, p, &rows);
  using C = ChunkCfg<D, TQ, TKV>;
  return run_kernel(kv_chunk_kernel<D, TQ, TKV, PROD, Rows>,
                    dim3((R + C::BQ - 1) / C::BQ, p.Hkv, p.B), kThreads, C::kSmem, st, tk, tv, p,
                    &rows);
}

// Build the TMA maps where they are used (2- and 4-byte caches in whole
// runs) and launch the instantiation of head dim D.
template <typename TQ, typename TKV, class Rows>
cudaError_t launch_types(const Params& p, const Rows& rows, int D, int splits, cudaStream_t st) {
  const bool prod = rows.bulk_ok();
  CUtensorMap tk{}, tv{};
  if constexpr (!Kv<TQ, TKV>::kQuant) {
    if (prod) {
      if (rows.rows_total() > 2147483647ull) return cudaErrorInvalidValue;  // TMA coordinates are int
      cudaError_t err = make_rows_map<TKV>(&tk, p.k, rows.rows_total(), D, rows.run());
      if (err == cudaSuccess) err = make_rows_map<TKV>(&tv, p.v, rows.rows_total(), D, rows.run());
      if (err != cudaSuccess) return err;
    }
  }
#define X(DD)                                                               \
  if (D == DD)                                                              \
    return prod ? launch_d<DD, TQ, TKV, true>(p, rows, splits, tk, tv, st) \
                : launch_d<DD, TQ, TKV, false>(p, rows, splits, tk, tv, st);
  KV_DIMS(X)
#undef X
  return cudaErrorInvalidValue;
}

// Check the shape, pick the instantiation of (q type, kv type) by their type
// codes (KV_TYPES; a pair not in KV_PAIRS is cudaErrorInvalidValue) and the
// regime, and launch.  `splits` and p.split_keys come from the caller (the
// capacity rule of ops/decode_attention.py); the decode regime with
// splits > 1 needs p.part and p.ticket.
template <class Rows>
cudaError_t launch_kv(Params p, const Rows& rows, int D, int q_type, int kv_type, int splits, int cap,
                      cudaStream_t st) {
  if (p.B <= 0 || p.S <= 0 || p.Hkv <= 0 || p.H % p.Hkv != 0 || cap <= 0 || p.B > 65535 ||
      p.Hkv > 65535)
    return cudaErrorInvalidValue;
  p.rep = p.H / p.Hkv;
  const int R = p.S * p.rep;
  if (R <= kDecRows &&
      (splits <= 0 || p.split_keys <= 0 || p.split_keys % kBK != 0 ||
       splits > kMaxSplits || (long long)splits * p.split_keys < cap ||
       (splits > 1 && (!p.part || !p.ticket))))
    return cudaErrorInvalidValue;
#define X(TQ, TKV)                                                    \
  if (q_type == type_code<TQ>() && kv_type == type_code<TKV>()) \
    return launch_types<TQ, TKV>(p, rows, D, splits, st);
  KV_PAIRS(X)
#undef X
  return cudaErrorInvalidValue;
}

}  // namespace kv_attention
