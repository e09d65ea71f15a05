// Attention of a query block against a kv cache walked by key tiles: the
// device code shared by paged_attention.cu (a page pool behind page tables)
// and decode_attention.cu (a head-major static cache), on the Hopper
// building blocks of wgmma_attention.cuh.  The two caches differ only in
// where key position kpos of slot b and kv head kvh lives, which a `Rows`
// policy answers (PagedRows, StaticRows below).
//
// For q [B, S, H, D] bf16, query position s of slot b attends keys
// [0, lengths[b] - S + s] (lengths = offset + S), never past the cache's
// capacity, and query head h reads kv head h / rep (rep = H / Hkv).  The
// S * rep query rows of one (kv head, slot) are laid out as the reference
// kernel lays them out: row s * rep + r is position s of head kvh * rep + r.
// Head dims 64, 128 and 256.  Key tiles are kBK = 64 keys.
//
// Two regimes behind one dispatch on rows = S * rep, known on the host:
//
// * Decode (rows <= 16): split-K.  One block of four warps per (key split,
//   kv head, slot).  The split length comes from the capacity (never from
//   `lengths`, which the host does not read), so the grid is fixed for a
//   shape; a split that starts past its slot's causal end returns at once.
//   The rows, padded to 16, are the M of `mma.sync m16n8k16`: each warp
//   takes 16 keys of every tile, scores them on the tensor cores with its
//   own online softmax, and runs P V likewise (8 flop a byte at rep 8 is
//   within the f32 cores' reach, but not with int8's halved bytes, and the
//   tensor cores leave the cores free for the softmax and the dequant).
//   The four warps merge in order, and the splits merge in split order:
//   the last block of a (kv head, slot) to arrive, by a ticket it resets,
//   reads the other splits' (m, l, acc) partials and writes the output, so
//   the bits do not depend on which block ran first and a call is one
//   launch.
// * Chunk (rows > 16): tensor cores on `wgmma`.  One block of two 64-row
//   warpgroups per (128-row tile, kv head, slot), as the flash forward:
//   S = Q K^T as m64n64k16 from shared memory, the online softmax in f32
//   registers, O += P V as m64nDk16 with P from registers.  Key tiles past
//   the tile's last row's causal end are never loaded; only tiles that
//   cross a row's end are masked.
//
// Loads (both regimes): a ring of key tiles in shared memory, K and V as
// 64-column panels with the 128-byte swizzle (the layout `wgmma` and
// `ldmatrix` read without bank conflicts).  Where a page (or the static
// cache's [L, D] rows) holds whole runs of 8-row multiples (PagedRows /
// StaticRows::bulk_ok), thread 0 fills the ring: bf16 tiles by TMA from a
// 2-D map over every row of the pool (the page index, read from the table
// on the device, is a runtime coordinate), int8 tiles and their f32 scales
// by bulk copies, each stage completing an mbarrier (wgmma_attention.cuh's
// waits trap after 2 s instead of hanging).  Other page sizes load row by
// row with `cp.async` by every thread.  int8 tiles land raw and are
// dequantized (exactly: int8 -> bf16) into a swizzled bf16 tile before the
// products read them.  No walk reads a page past the slot's last valid
// key: a tile's runs beyond it repeat that last run.
//
// Numerics follow the reference kernels: NEG_INF = -1e30 is finite; int8
// k-scales multiply the scores after the dot, v-scales multiply p after l
// is updated, and p is rounded to bf16 before the P V product; a row with
// no visible key (a slot with lengths <= 0) emits zeros.  Scores run in
// base-2 units (scale * log2(e)), as the flash kernels' do.
#pragma once

#include <type_traits>

#include "wgmma_attention.cuh"

namespace kv_attention {

using namespace wgmma_attention;

constexpr int kBK = 64;            // keys per tile, both regimes
constexpr int kDecRows = 16;       // decode regime: the m16 tile of query rows
constexpr int kDecWarps = 4;       // a warp takes 16 keys of every tile
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kChunkRows = 128;    // chunk regime: two warpgroups of 64 rows
constexpr int kMaxSplits = 64;     // decode regime: most key splits of a launch

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
  const bf16* q;          // [B, S, H, D]
  const void* k;          // bf16 or int8 rows of D
  const void* v;
  const float* ks;        // int8: one f32 per row
  const float* vs;
  const int* lengths;     // [B]
  bf16* out;              // [B, S, H, D]
  float* part;            // decode regime, splits > 1: the split partials
  int* ticket;            // [B * Hkv], zero between launches
  int B, S, H, Hkv, rep;
  float scale_log2;       // scale * log2(e)
  int split_keys;         // decode regime: keys per split, a multiple of kBK
};

// ------------------------------------------------------------ shared tiles

// Element (r, c) of a tile of ROWS rows stored as 64-column panels of
// ROWS x 64 bf16 with the 128-byte swizzle (16-byte chunk ch of row r at
// chunk ch ^ (r % 8)), as TMA writes it and `wgmma` reads it.
template <int ROWS>
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 6) * ROWS * kPanel + r * kPanel + ((((c >> 3) & 7) ^ (r & 7)) << 3) + (c & 7);
}

template <int ROWS, int D>
struct alignas(1024) QTile {
  bf16 x[ROWS * D];
};

template <int D>
struct alignas(1024) TileBf16 {  // K and V of one key tile, swizzled panels
  bf16 k[kBK * D];
  bf16 v[kBK * D];
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
  TileBf16<D> kv;
  float ks[kBK];
  float vs[kBK];
};

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
// through N stages.  PROD: thread 0 issues each tile (TMA or bulk copies)
// and the stages turn on mbarriers.  Otherwise every thread copies its
// share with cp.async, one commit group a tile, and the block syncs on
// each tile (PROXY: and fences its copies for the async proxy, which
// `wgmma` reads through).  A tile's keys past `kend` (the block's walk)
// repeat the last valid run, so no page past the slot's end is read.
template <int D, bool QUANT, bool PROD, bool PROXY, int NT, int N, class Rows>
struct Pipe {
  using Stage = std::conditional_t<QUANT, TileI8<D>, TileBf16<D>>;
  Stage* st;
  Bars<N>* bars;
  const CUtensorMap* tk;
  const CUtensorMap* tv;
  const Params* p;
  Rows rows;
  int b, kvh, kbase, kend, T;

  __device__ __forceinline__ void issue(int j) const {
    Stage& s = st[j % N];
    const int kb = kbase + j * kBK;
    if constexpr (PROD) {
      uint64_t* full = &bars->full[j % N];
      const int run = rows.run();
      const int last = (kend - 1) / run * run;  // the start of the last valid run
      if constexpr (!QUANT) {
        mbar_expect_tx(full, 2 * kBK * D * 2);
        for (int i = 0; i < kBK; i += run) {
          const int r = (int)rows.row(b, kvh, min(kb + i, last));
#pragma unroll
          for (int pn = 0; pn < D / kPanel; ++pn) {
            tma_load_2d(s.k + pn * kBK * kPanel + i * kPanel, tk, full, pn * kPanel, r);
            tma_load_2d(s.v + pn * kBK * kPanel + i * kPanel, tv, full, pn * kPanel, r);
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
        constexpr int CH = D / 8;  // 16-byte chunks a row
        const bf16* kp = static_cast<const bf16*>(p->k);
        const bf16* vp = static_cast<const bf16*>(p->v);
        for (int i = threadIdx.x; i < kBK * CH; i += NT) {
          const int r = i / CH, c = (i % CH) * 8;
          const size_t src = rows.row(b, kvh, min(kb + r, kend - 1)) * D + c;
          cp_async16(s.k + swz<kBK>(r, c), kp + src);
          cp_async16(s.v + swz<kBK>(r, c), vp + src);
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

  // Tile j is in stage j % N, visible to every thread.
  __device__ __forceinline__ void wait(int j) const {
    if constexpr (PROD) {
      mbar_wait(&bars->full[j % N], (j / N) & 1);
    } else {
      cp_async_wait<N - 2>();
      if constexpr (PROXY) fence_proxy_async();
      __syncthreads();
    }
  }

  // Keep the ring full: PROD, thread 0 loads tile j - 1 + N into the stage
  // of tile j - 1 once every thread has released it; cp.async, every thread
  // loads tile j + N - 1 into that stage, which the sync in wait(j) freed.
  __device__ __forceinline__ void refill(int j) const {
    if constexpr (PROD) {
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

// Rows [r0, r0 + ROWS) of the block's query rows into a swizzled tile,
// zeros past the R live rows.
template <int ROWS, int D, int NT>
__device__ __forceinline__ void load_q(bf16* tile, const Params& p, int b, int kvh, int r0, int R) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < R) val = __ldg(reinterpret_cast<const uint4*>(p.q + row_offset(p, b, kvh, r0 + r, D) + c));
    *reinterpret_cast<uint4*>(tile + swz<ROWS>(r, c)) = val;
  }
}

// The causal end of query row r: keys [0, end) are visible.
__device__ __forceinline__ int row_end(const Params& p, int len, int cap, int r) {
  return min(len - p.S + r / p.rep + 1, cap);
}

// ------------------------------------------------------- decode regime: mma.sync

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d (m16 x n8, f32) += a (m16 x k16, bf16) b (k16 x n8, bf16)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int D, bool QUANT>
struct DecCfg {
  // 2-3 blocks a SM at D <= 128 (about 66-102 KB), one at D = 256
  static constexpr int kStages = D == 256 ? (QUANT ? 3 : 2) : (D == 128 && !QUANT ? 3 : 4);
  using Stage = std::conditional_t<QUANT, TileI8<D>, TileBf16<D>>;
  struct Merge {  // the four warps' (m, l, acc), read back in warp order
    float m[kDecWarps][kDecRows];
    float l[kDecWarps][kDecRows];
    float f[kDecWarps][kDecRows];   // each warp's weight in its row
    float row_m[kDecRows], row_l[kDecRows];
    float sf[kMaxSplits][kDecRows]; // the last block: each split's weight
    float acc[kDecWarps][kDecRows][D + 4];
  };
  struct Smem {
    QTile<kDecRows, D> q;
    std::conditional_t<QUANT, Work<D>, Empty> work;
    union {
      Stage st[kStages];
      Merge merge;
    };
    Bars<kStages> bars;
  };
  static constexpr size_t kSmem = sizeof(Smem) + 1024;
  static_assert(kSmem <= 232448, "decode regime: shared memory over the 227 KB a block may use");
};

// Decode regime: block (split, kv head, slot), 128 threads.  Warp w takes
// keys 16 w .. 16 w + 15 of every tile; lane 4 g + t holds score and output
// rows g and g + 8 (the m16n8 accumulator layout).
template <int D, bool QUANT, bool PROD, class Rows>
__global__ void __launch_bounds__(kDecThreads)
    kv_decode_kernel(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                     const Params p, const Rows rows) {
  using C = DecCfg<D, QUANT>;
  constexpr int N = C::kStages;
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

  const Pipe<D, QUANT, PROD, false, kDecThreads, N, Rows> pipe{sm.st, &sm.bars, &tk, &tv, &p,
                                                               rows, b, kvh, k0, kend, T};
  if constexpr (PROD) init_bars<N, kDecThreads>(sm.bars);
  pipe.start();  // the first tiles are in flight while q loads
  load_q<kDecRows, D, kDecThreads>(sm.q.x, p, b, kvh, 0, R);
  __syncthreads();

  int qe[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = g + 8 * hr;
    qe[hr] = r < R ? row_end(p, len, cap, r) : 0;
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this lane's share
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const int key0 = 16 * warp;
  const int mi = lane >> 3, mr = lane & 7;  // this lane's ldmatrix row: matrix mi, row mr

  for (int j = 0; j < T; ++j) {
    pipe.wait(j);
    pipe.refill(j);
    const int kb = k0 + j * kBK;
    const bf16 *kt, *vt;
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
    }

    // scores: sc[nb] is keys key0 + 8 nb .. + 7 of rows g, g + 8
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], kf[4];
      ldsm_x4(a, sm.q.x + swz<kDecRows>((mi & 1) * 8 + mr, 16 * kk + (mi >> 1) * 8));
      ldsm_x4(kf, kt + swz<kBK>(key0 + (mi >> 1) * 8 + mr, 16 * kk + (mi & 1) * 8));
      mma16816(sc[0], a, kf[0], kf[1]);
      mma16816(sc[1], a, kf[2], kf[3]);
    }

    // online softmax over the warp's 16 keys
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
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
    for (int nb = 0; nb < 2; ++nb)
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
    for (int i = 0; i < D / 8; ++i) {
      acc[i][0] *= corr[0];
      acc[i][1] *= corr[0];
      acc[i][2] *= corr[1];
      acc[i][3] *= corr[1];
    }

    // acc += P V: P (rows x the warp's 16 keys) is the A fragment as it stands
    const uint32_t pa[4] = {pack_bf16x2(sc[0][0], sc[0][1]), pack_bf16x2(sc[0][2], sc[0][3]),
                            pack_bf16x2(sc[1][0], sc[1][1]), pack_bf16x2(sc[1][2], sc[1][3])};
#pragma unroll
    for (int db = 0; db < D / 16; ++db) {
      uint32_t vf[4];
      ldsm_x4_t(vf, vt + swz<kBK>(key0 + (mi & 1) * 8 + mr, 16 * db + (mi >> 1) * 8));
      mma16816(acc[2 * db], pa, vf[0], vf[1]);
      mma16816(acc[2 * db + 1], pa, vf[2], vf[3]);
    }
    if constexpr (!QUANT) pipe.release(j);
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
      mg.l[warp][g + 8 * hr] = l[hr];
    }
  }
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) mg.acc[warp][g + 8 * (e >> 1)][8 * i + 2 * t + (e & 1)] = acc[i][e];
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
      *reinterpret_cast<uint2*>(p.out + row_offset(p, b, kvh, r, D) + c) =
          make_uint2(pack_bf16x2(o.x * inv, o.y * inv), pack_bf16x2(o.z * inv, o.w * inv));
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
    *reinterpret_cast<uint2*>(p.out + row_offset(p, b, kvh, r, D) + c) =
        make_uint2(pack_bf16x2(o.x * inv, o.y * inv), pack_bf16x2(o.z * inv, o.w * inv));
  }
}

// ---------------------------------------------------------- chunk regime: wgmma

template <int D, bool QUANT>
struct ChunkCfg {
  static constexpr int kStages = D == 256 ? 2 : 4;  // 160-195 KB: one block a SM at D >= 128
  using Stage = std::conditional_t<QUANT, TileI8<D>, TileBf16<D>>;
  struct Smem {
    QTile<kChunkRows, D> q;
    std::conditional_t<QUANT, Work<D>, Empty> work;
    Stage st[kStages];
    Bars<kStages> bars;
  };
  static constexpr size_t kSmem = sizeof(Smem) + 1024;
  static_assert(kSmem <= 232448, "chunk regime: shared memory over the 227 KB a block may use");
};

// One key tile of the online softmax over a warpgroup's m64 x 64 score
// accumulator, in place: scale (and int8 k-scales), kNegInf at keys at or
// past the row's end qe[half] on tiles that cross one (`edge`), the running
// max and this lane's share of l, o rescaled; s becomes p (times int8
// v-scales, after l).
template <int D, bool QUANT>
__device__ __forceinline__ void chunk_softmax(float (&s)[kBK / 2], float (&o)[D / 2], float (&m)[2],
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
    for (int i = 0; i < D / 2; ++i)
      if (acc_half(i) == hr) o[i] *= corr;
  }
  if constexpr (QUANT) {
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) s[i] *= vs[acc_col(i, t)];
  }
}

// Chunk regime: block (128-row tile, kv head, slot), 256 threads.
template <int D, bool QUANT, bool PROD, class Rows>
__global__ void __launch_bounds__(kThreads, 1)
    kv_chunk_kernel(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                    const Params p, const Rows rows) {
  using C = ChunkCfg<D, QUANT>;
  constexpr int N = C::kStages;
  typename C::Smem& sm = aligned_smem<typename C::Smem>();
  const int r0 = blockIdx.x * kChunkRows, kvh = blockIdx.y, b = blockIdx.z;
  const int R = p.S * p.rep, live_rows = min(kChunkRows, R - r0);
  const int len = p.lengths[b], cap = rows.capacity();
  const int kend = row_end(p, len, cap, r0 + live_rows - 1);
  const int T = kend > 0 ? (kend + kBK - 1) / kBK : 0;

  const Pipe<D, QUANT, PROD, !QUANT, kThreads, N, Rows> pipe{sm.st, &sm.bars, &tk, &tv, &p,
                                                             rows, b, kvh, 0, kend, T};
  if constexpr (PROD) init_bars<N, kThreads>(sm.bars);
  pipe.start();  // the first tiles are in flight while q loads
  load_q<kChunkRows, D, kThreads>(sm.q.x, p, b, kvh, r0, R);
  fence_proxy_async();  // the threads' stores, read by wgmma
  __syncthreads();

  const int wg = warpgroup(), warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int row = 64 * wg + 16 * warp + (lane >> 2);  // this thread's rows: row, row + 8
  int qe[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r0 + row + 8 * hr;
    qe[hr] = r < R ? row_end(p, len, cap, r) : 0;
  }
  // the warpgroup's first row ends first: a tile below its end needs no mask
  const int wfirst = r0 + 64 * wg;
  const int first_end = wfirst < R ? row_end(p, len, cap, wfirst) : 0;
  const bf16* qw = sm.q.x + 64 * wg * kPanel;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int j = 0; j < T; ++j) {
    pipe.wait(j);
    const int kb = j * kBK;
    const bf16 *kt, *vt;
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
      kt = sm.st[j % N].k;
      vt = sm.st[j % N].v;
    }
    float sc[kBK / 2];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Mma<kBK>::ss(sc, desc_k<kChunkRows>(qw, kk), desc_k<kBK>(kt, kk), kk > 0);
    wg_commit();
    pipe.refill(j);
    wg_wait();
    fence_regs(sc);
    chunk_softmax<D, QUANT>(sc, o, m, l, p.scale_log2, kb + kBK > first_end, kb, qe, t, kst, vst);
    uint32_t pa[kBK / 16][4];
    to_a<kBK>(pa, sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) Mma<D>::rs(o, pa[kk], desc_mn<kBK>(vt, kk));
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
    uint32_t* dst = reinterpret_cast<uint32_t*>(p.out + row_offset(p, b, kvh, r, D));
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      dst[4 * i + t] = pack_bf16x2(o[4 * i + 2 * hr] * inv, o[4 * i + 2 * hr + 1] * inv);
  }
}

// -------------------------------------------------------------------- host

// The TMA map of `rows` rows of D bf16 at `ptr`: boxes of `box_rows` rows x
// 64 columns with the 128-byte swizzle.
inline cudaError_t make_rows_map(CUtensorMap* map, const void* ptr, size_t rows, int D, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kPanel, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
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

template <int D, bool QUANT, bool PROD, class Rows>
cudaError_t launch_d(const Params& p, const Rows& rows, int splits, const CUtensorMap& tk,
                     const CUtensorMap& tv, cudaStream_t st) {
  const int R = p.S * p.rep;
  if (R <= kDecRows)
    return run_kernel(kv_decode_kernel<D, QUANT, PROD, Rows>, dim3(splits, p.Hkv, p.B), kDecThreads,
                      DecCfg<D, QUANT>::kSmem, st, tk, tv, p, &rows);
  return run_kernel(kv_chunk_kernel<D, QUANT, PROD, Rows>,
                    dim3((R + kChunkRows - 1) / kChunkRows, p.Hkv, p.B), kThreads,
                    ChunkCfg<D, QUANT>::kSmem, st, tk, tv, p, &rows);
}

template <int D, class Rows>
cudaError_t launch_q(const Params& p, const Rows& rows, bool quant, bool prod, int splits,
                     const CUtensorMap& tk, const CUtensorMap& tv, cudaStream_t st) {
  if (quant)
    return prod ? launch_d<D, true, true>(p, rows, splits, tk, tv, st)
                : launch_d<D, true, false>(p, rows, splits, tk, tv, st);
  return prod ? launch_d<D, false, true>(p, rows, splits, tk, tv, st)
              : launch_d<D, false, false>(p, rows, splits, tk, tv, st);
}

// Check the shape, build the TMA maps where they are used, pick the regime
// and launch.  `splits` and p.split_keys come from the caller (the capacity
// rule of ops/decode_attention.py); the decode regime with splits > 1 needs
// p.part and p.ticket.
template <class Rows>
cudaError_t launch(Params p, const Rows& rows, int D, bool quant, int splits, int cap,
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
  const bool prod = rows.bulk_ok();
  CUtensorMap tk{}, tv{};
  if (prod && !quant) {
    if (rows.rows_total() > 2147483647ull) return cudaErrorInvalidValue;  // TMA coordinates are int
    cudaError_t err = make_rows_map(&tk, p.k, rows.rows_total(), D, rows.run());
    if (err == cudaSuccess) err = make_rows_map(&tv, p.v, rows.rows_total(), D, rows.run());
    if (err != cudaSuccess) return err;
  }
  if (D == 64) return launch_q<64>(p, rows, quant, prod, splits, tk, tv, st);
  if (D == 128) return launch_q<128>(p, rows, quant, prod, splits, tk, tv, st);
  if (D == 256) return launch_q<256>(p, rows, quant, prod, splits, tk, tv, st);
  return cudaErrorInvalidValue;
}

}  // namespace kv_attention
