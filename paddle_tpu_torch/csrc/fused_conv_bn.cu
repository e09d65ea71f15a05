// Fused 1x1 convolution + BatchNorm statistics for Hopper (sm_90a), forward
// and backward: bf16 on `wgmma` with TMA loads through an mbarrier ring
// (conv_wgmma.cuh on wgmma_attention.cuh), f32 on CUDA cores.
//
// Replaces: paddle_tpu/ops/fused_conv_bn.py `_fwd_kernel` (launched by
// `_fwd_fold`) and `_bwd_kernel` (launched by `_bwd_call`), the 1x1 convs
// of every ResNet bottleneck in NHWC training.  Rows m of the flattened
// [M = N * H * W', .] activations sit at column w = m % W'; columns w >= wv
// are padding ("pad rows").
//   forward (entry fused_conv_bn_fwd, with the fold of the previous BN):
//     a = x * scale + offset in f32, ReLU if relu, 0 on pad rows, rounded to
//     x's dtype; y = a @ W accumulated in f32, stored in x's dtype; per
//     column f32 sum and sum of squares of the ROUNDED y.
//   backward (entry fused_conv_bn_bwd, with or without the fold):
//     dyt = dy + (bf(ds1) + y * bf(2 ds2)) in the activation dtype, in that
//     order, 0 on pad rows; dW = xf^T dyt in f32 (xf: the forward's folded
//     input, or x without the fold); dxf = dyt W^T in f32; with the fold
//     g = dxf where a > 0 (when relu), dx = cast(g * scale), dscale = sum_m
//     g * x and doffset = sum_m g; without it dx = cast(dxf).
//
// The bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16), ResNet-50 at batch
// 128 x 224^2, conv3's shapes (K -> C = 4K), each input read once and each
// output written once:
//   stage  M        K -> C       forward              backward
//   1      401,408  64 -> 256    257 MB  0.0767 ms    514 MB  0.1534 ms  (bytes)
//   2      114,688  128 -> 512   147 MB  0.0439 ms    294 MB  0.0878 ms  (bytes)
//   3      28,672   256 -> 1024   74 MB  0.0221 ms    148 MB  0.0443 ms  (bytes)
//   4      7,168    512 -> 2048  15 GFLOP 0.0152 ms   30 GFLOP 0.0304 ms (operations)
// conv1 runs the backward without the fold at 4w -> w (K > C).
//
// Tile plan.  Blocks of 256 threads, two consumer warpgroups; thread 0
// also issues the TMA loads (no producer warp: see wgmma_attention.cuh).
// The caller chooses the rows a block owns, the column width BN and one
// pass or two (ops/fused_conv_bn.py `_geometry`, which sizes the partials
// and the workspace from the same choice); the entries run that plan or
// refuse it.  Every block is persistent over a contiguous range of row tiles (about
// one block an SM), keeps its statistics in registers across them and
// writes ONE partial row (column sums, dscale/doffset, dW) that the caller
// sums in block order: no float atomics, the same bits on every run.  dyt
// is formed by the threads in bf16x2 arithmetic (each operation rounded
// once, as the reference rounds it), the fold in f32 with its rounding,
// as swizzled bf16 tiles that wgmma reads (fence.proxy.async before the
// barrier that publishes them).  Outputs leave by TMA store from swizzled
// staging tiles, never as scattered 4-byte stores.
//  * forward (fcbn_fwd_bf16<BN, WRES>): 128 rows x BN (256 where C allows)
//    of y a tile, over K in 64-wide units.  The raw x unit arrives by TMA;
//    each warpgroup reads its A fragments from shared memory, folds them in
//    registers and issues wgmma with A from registers (m64nBNk16, 128 f32
//    accumulators a thread); unit u + 1 is folded while unit u's products
//    run.  W is resident for the block's life where its K x BN slice fits
//    (stages 1 and 2: 32 and 64 KB), else it streams with x.  y goes out by
//    TMA store from a staging tile (32 KB a warpgroup), so tile i's store
//    overlaps tile i + 1's loads and products; the column sums are read back
//    from the staging tile, two columns a thread.  Shared memory: ring 4 x
//    16 KB + W <= 64 KB + staging 64 KB (resident W), or ring 3 x 48 KB +
//    staging 64 KB (streamed): <= 212 KB.
//  * backward in one pass (fcbn_bwd1_bf16<K, C> for K x C = 64 x 64, 64 x
//    128, 64 x 256, 128 x 64, 128 x 128 and 256 x 64, where the f32 dW
//    fits the registers: stage 1's conv3 and conv1s): 64-row tiles; dy, y
//    and x arrive once (stage 64 (K + 2C) x 2 bytes, 72 KB at 64 -> 256,
//    two stages), W is resident (<= 32 KB), dyt is formed in place over dy,
//    xf into its own tile (<= 32 KB), dx staged (<= 32 KB).  A tile is formed, then its
//    products run, so its stage is free (and the load of tile + 2 goes out)
//    as soon as they are done.  Each warpgroup runs dX = dyt W^T for K / 2
//    columns (SS; the fold's backward in the epilogue, on raw x read
//    through L2 while the products run; dscale and doffset in registers
//    across the block's tiles) and its share of dW += xf^T dyt (TT, <= 64
//    f32 a thread, held in registers across the block's tiles): <= 203 KB.
//  * backward in two passes elsewhere.  dX pass (fcbn_dx_bf16<BK, FOLD>):
//    128 rows x BK (all of K up to 256, else K / 256 slices) a tile, over C
//    in 64-wide units (dy, y and a W panel, 64 KB at BK 256, three stages);
//    each warpgroup forms dyt for its own 64 rows, in place, and the first
//    slice also writes it to a bf16 workspace; the tile's last stage then
//    stages its dx.  dscale and doffset are summed over a column's 8 lanes
//    by halving exchanges (sum_over_g32) and kept in registers.  dW pass
//    (fcbn_dw_bf16<BN>): 128 of K x BN (256) of C a tile, over rows in
//    units of 64 (x and dyt, 48 KB, four stages, the fold applied in
//    place); M split so that the grid fills the SMs.  dyt is formed once a
//    dX slice; the dW pass reads it, so the design moves the dyt workspace
//    twice and x once more than the bound (chip_smoke.py's
//    design_extra_bytes).
// ptxas gives every kernel at most 255 registers a thread (one block an
// SM); the build phase of chip_smoke.py fails on a spill.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (paddle_tpu_torch/ops/_build.py does this).

#include "conv_wgmma.cuh"

namespace {

using namespace conv_wgmma;

constexpr int kFT = 64;          // f32 tile edge
constexpr int kFK = 16;          // reduction step of the f32 tiles
constexpr int kSplitRows = 32;   // f32 dW splits: a multiple of this many rows
constexpr int kMaxSmem = 232448;  // shared memory a block may ask for

struct Args {
  const void* x;        // [M, K]
  const void* w;        // [K, C]
  const float* scale;   // [K] f32, or null: no fold (backward only)
  const float* offset;  // [K] f32
  const void* dy;       // [M, C] (backward)
  const void* y;        // [M, C] (backward)
  const float* ds;      // [2, C] f32: the cotangents of the sums and sums of squares
  void* out;            // forward: y [M, C]; backward: dx [M, K]
  float* part;          // [2, blocks, C] forward; [2, blocks, K] backward with the fold
  float* dw_part;       // backward: [blocks or splits, K, C]
  bf16* dyt;            // bf16 backward in two passes: dyt [M, C]
  int M, K, C, Wp, wv, relu;
  int tpb;              // bf16: row tiles a block
  int rows_per_split;   // backward: rows of M that one dW block reduces
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ bool live_row(const Args& p, int m) {
  return m < p.M && (m % p.Wp) < p.wv;
}

// x * scale + offset in f32, rounded after each operation as the reference
// computes it (no fused multiply-add).
__device__ __forceinline__ float affine(float x, float s, float o) {
  return __fadd_rn(__fmul_rn(x, s), o);
}

__device__ __forceinline__ float fold1(const Args& p, float x, int k) {
  const float a = affine(x, p.scale[k], p.offset[k]);
  return (p.relu && !(a > 0.f)) ? 0.f : a;
}

// The fold of one element with its scale and offset given, 0 off live rows.
__device__ __forceinline__ float fold_v(float x, float s, float o, int relu, bool live) {
  const float a = affine(x, s, o);
  return (!live || (relu && !(a > 0.f))) ? 0.f : a;
}

// dyt of one f32 element: dy + (ds1 + y * (2 ds2)).
__device__ __forceinline__ float dyt1(const Args& p, float dy, float y, int c) {
  return dy + (p.ds[c] + y * (2.f * p.ds[p.C + c]));
}

__device__ __forceinline__ void load8(const bf16* src, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = v.x, f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ float2 unpack2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  return make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]), pack_bf16x2(f[4], f[5]),
                    pack_bf16x2(f[6], f[7]));
}

// bf16x2 arithmetic, each result rounded to bf16 once.  The product of two
// bf16 is exact in f32 and the sum of two rounds to the same bf16 whether or
// not it is first rounded to f32, so these give the bits of the reference's
// bf16 operations (each computed in f32 and rounded).
__device__ __forceinline__ uint32_t bmul2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t badd2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// dyt of 8 bf16 elements (a 16-byte chunk) from d1 = bf(ds1) and d2 =
// bf(2 ds2) of their columns: dy + (d1 + y * d2), or 0 off live rows.
__device__ __forceinline__ uint4 dyt8(uint4 dy, uint4 y, uint4 d1, uint4 d2, bool live) {
  if (!live) return make_uint4(0u, 0u, 0u, 0u);
  return make_uint4(badd2(dy.x, badd2(d1.x, bmul2(y.x, d2.x))),
                    badd2(dy.y, badd2(d1.y, bmul2(y.y, d2.y))),
                    badd2(dy.z, badd2(d1.z, bmul2(y.z, d2.z))),
                    badd2(dy.w, badd2(d1.w, bmul2(y.w, d2.w))));
}

// 8 consecutive f32 from shared memory (32-byte aligned).
__device__ __forceinline__ void lds8(const float* src, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(src)[0], b = reinterpret_cast<const float4*>(src)[1];
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w, f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

// The sum over the 8 lanes that share t (the rows g of a fragment).
__device__ __forceinline__ float sum_over_g(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// One halving exchange over the lanes `mask` apart: the lane whose bit is
// `up` keeps the upper H of its values, its partner the lower H, each
// adding the other's copy.
template <int H, int MASK>
__device__ __forceinline__ void halve(float (&v)[32], bool up) {
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? v[i] : v[i + H], keep = up ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, MASK);
  }
}

// sum_over_g over 32 values a thread by halving exchanges (28 shuffles, not
// 96): lane g ends with r[i] = the sum of index i + 16 (g & 1) + 8 ((g >> 1)
// & 1) + 4 (g >> 2) over the 8 lanes, in a fixed order.
__device__ __forceinline__ void sum_over_g32(float (&v)[32], float (&r)[4], int g) {
  halve<16, 4>(v, g & 1);
  halve<8, 8>(v, (g >> 1) & 1);
  halve<4, 16>(v, (g >> 2) & 1);
#pragma unroll
  for (int i = 0; i < 4; ++i) r[i] = v[i];
}

__device__ __forceinline__ unsigned char* smem_base() {
  return reinterpret_cast<unsigned char*>(&aligned_smem<uint4>());
}

// ------------------------------------------------------------ shared memory
// Byte offsets into each kernel's dynamic shared memory (1024-aligned
// base); the launch asks for `total` + 1024.  Tiles first (each a multiple
// of 8 KB), then f32 arrays, then the barriers.

struct FwdSmem {
  int ring, w, ys, red, so, bars, total;
};
__host__ __device__ inline FwdSmem fwd_smem(int BN, bool wres, int KP, int nst) {
  const int stage = (128 + (wres ? 0 : BN)) * 128;
  FwdSmem s;
  s.ring = 0;
  s.w = nst * stage;                       // x unit 128 x 64 (+ W unit 64 x BN)
  s.ys = s.w + (wres ? KP * BN * 128 : 0);  // resident W slice K x BN
  s.red = s.ys + 2 * BN * 128;             // y staging, 64 x BN a warpgroup
  s.so = s.red + 4 * 256 * 4;              // column sums [2][2 * 256 / BN][BN]
  s.bars = s.so + 2 * KP * 64 * 4;         // scale, offset
  s.total = s.bars + 16 * nst + 16;
  return s;
}

struct OneSmem {
  int ring, xf, ys, w, sc, d, red, bars, total;
};
__host__ __device__ inline OneSmem one_smem(int K, int C) {
  OneSmem s;
  s.ring = 0;
  s.xf = 2 * 128 * (K + 2 * C);  // two stages of x, dy, y (64 rows)
  s.ys = s.xf + 128 * K;         // xf (64 rows)
  s.w = s.ys + 128 * K;          // dx staging (64 rows)
  s.sc = s.w + K * C * 2;        // W, K x C
  s.d = s.sc + 2 * K * 4;        // scale, offset
  s.red = s.d + 2 * C * 2;       // bf(ds1), bf(2 ds2) in bf16
  s.bars = s.red + 2 * 4 * 2 * (K / 2) * 4;  // dscale, doffset [wg][warp][2][K / 2]
  s.total = s.bars + 16 * 2 + 16 + 16;  // ring, W, y
  return s;
}

struct DxSmem {
  int ring, red, dd, so, bars, total;
};
__host__ __device__ inline DxSmem dx_smem(int BK, int C) {
  DxSmem s;
  s.ring = 0;
  s.red = 3 * (256 + BK) * 128;      // three stages of dy, y (128 rows) and a W panel
  s.dd = s.red + 2 * 4 * 2 * BK * 4;  // dscale, doffset [wg][warp][2][BK]
  s.so = s.dd + 2 * C * 2;            // bf(ds1), bf(2 ds2) in bf16
  s.bars = s.so + 2 * BK * 4;         // scale, offset of the slice
  s.total = s.bars + 16 * 3 + 16;
  return s;
}

struct DwSmem {
  int ring, so, bars, total;
};
__host__ __device__ inline DwSmem dw_smem(int BN) {
  DwSmem s;
  s.ring = 0;
  s.so = 4 * (128 + BN) * 128;  // four stages of x (64 x 128) and dyt (64 x BN)
  s.bars = s.so + 2 * 128 * 4;  // scale, offset of the tile's 128 of K
  s.total = s.bars + 16 * 4 + 16;
  return s;
}

// ------------------------------------------------------------ bf16 forward
// Grid (row blocks, C / BN): block (b, n) computes y[rows, n BN : (n + 1) BN]
// for its tiles of 128 rows, unit u = (tile u / KP, k panel u % KP), in a
// ring of NST units.
template <int BN, bool WRES, int NST>
__global__ void __launch_bounds__(kThreads, 1)
    fcbn_fwd_bf16(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                  const __grid_constant__ CUtensorMap ty, const Args p) {
  constexpr int XE = 128 * kPanel, WE = BN * kPanel;
  constexpr int SE = XE + (WRES ? 0 : WE), NRH = 256 / BN;
  const int KP = p.K / 64;
  const FwdSmem L = fwd_smem(BN, WRES, KP, NST);
  unsigned char* sm = smem_base();
  bf16* ring = reinterpret_cast<bf16*>(sm + L.ring);
  bf16* wres = reinterpret_cast<bf16*>(sm + L.w);
  float* red = reinterpret_cast<float*>(sm + L.red);
  float* so = reinterpret_cast<float*>(sm + L.so);  // scale [K], offset [K]
  Ring<NST>& rb = *reinterpret_cast<Ring<NST>*>(sm + L.bars);
  uint64_t* wbar = reinterpret_cast<uint64_t*>(sm + L.bars + sizeof(Ring<NST>));
  const int tid = threadIdx.x, wg = warpgroup(), lw = tid & 127, w4 = lw >> 5;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  bf16* ys = reinterpret_cast<bf16*>(sm + L.ys) + wg * WE;
  for (int i = tid; i < p.K; i += kThreads) so[i] = p.scale[i], so[p.K + i] = p.offset[i];
  const int n0 = blockIdx.y * BN;
  const int tb = blockIdx.x * p.tpb, nt = min(cdiv(p.M, 128), tb + p.tpb) - tb, U = nt * KP;

  auto load = [&](int u) {
    const int s = u % NST, kp = u % KP;
    bf16* st = ring + s * SE;
    mbar_expect_tx(&rb.full[s], SE * 2);
    tma_load(st, &tx, &rb.full[s], 64 * kp, 0, 128 * (tb + u / KP), 0);
    if (!WRES) {
#pragma unroll
      for (int q = 0; q < BN / 64; ++q)
        tma_load(st + XE + q * kTile, &tw, &rb.full[s], n0 + 64 * q, 0, 64 * kp, 0);
    }
  };
  init_ring(wbar, rb);  // its barrier also publishes scale and offset
  if (tid == 0) {
    if (WRES) {
      mbar_expect_tx(wbar, KP * WE * 2);
      for (int kp = 0; kp < KP; ++kp)
#pragma unroll
        for (int q = 0; q < BN / 64; ++q)
          tma_load(wres + kp * WE + q * kTile, &tw, wbar, n0 + 64 * q, 0, 64 * kp, 0);
    }
    for (int u = 0; u < min(NST, U); ++u) load(u);
  }
  if (WRES) mbar_wait(wbar, 0);

  const int r0 = 64 * wg + 16 * w4 + g;       // the thread's rows r0, r0 + 8 of a tile
  const int cp = lw % (BN / 2), rh = lw / (BN / 2);  // column pair and row group of the sums
  // the A fragments of unit u's folded x: a[kk] = (r0, c), (r0 + 8, c),
  // (r0, c + 8), (r0 + 8, c + 8) at c = 16 kk + 2 t
  auto fold_unit = [&](int u, uint32_t (&a)[4][4]) {
    const int kp = u % KP, row = 128 * (tb + u / KP) + r0;
    wait_full(rb, u);
    const bf16* xs = ring + (u % NST) * SE;
    const bool live[2] = {live_row(p, row), live_row(p, row + 8)};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int hc = 0; hc < 2; ++hc) {
        const int col = 16 * kk + 8 * hc + 2 * t, k = 64 * kp + col;
        const float2 sc = *reinterpret_cast<const float2*>(so + k);
        const float2 of = *reinterpret_cast<const float2*>(so + p.K + k);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float2 v = unpack2(*reinterpret_cast<const uint32_t*>(xs + swz<128>(r0 + 8 * hr, col)));
          a[kk][2 * hc + hr] = pack_bf16x2(fold_v(v.x, sc.x, of.x, p.relu, live[hr]),
                                           fold_v(v.y, sc.y, of.y, p.relu, live[hr]));
        }
      }
  };
  float acc[BN / 2];
  float cs[4] = {0.f, 0.f, 0.f, 0.f};  // s1 of columns 2 cp, 2 cp + 1, then s2
  // unit u's products run while unit u + 1 is folded into the other
  // fragment set
  auto step = [&](int u, const uint32_t (&a)[4][4], uint32_t (&next)[4][4]) {
    const int kp = u % KP, i = tb + u / KP;
    if (kp == 0) {
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;
    }
    const bf16* wt = WRES ? wres + kp * WE : ring + (u % NST) * SE + XE;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) Mma<BN>::rs(acc, a[kk], desc_mn<64>(wt, kk));
    wg_commit();
    if (tid == 0 && u >= 1 && u - 1 + NST < U) {  // unit u - 1 was released a unit ago
      mbar_wait(&rb.empty[(u - 1) % NST], ((u - 1) / NST) & 1);
      load(u - 1 + NST);
    }
    if (u + 1 < U) fold_unit(u + 1, next);
    wg_wait<0>();
    fence_regs(acc);
    release(rb, u);
    if (kp < KP - 1) return;
    // y: rounded into the staging tile, stored by TMA; the column sums of
    // the rounded values read back from it (rows past M and pad rows hold
    // exact zeros: their folded input is zero)
    if (lw == 0) bulk_wait<true>();
    bar_sync(1 + wg, 128);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        st_pair<64>(ys, 16 * w4 + g + 8 * hr, 8 * j + 2 * t,
                    pack_bf16x2(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]));
    fence_async_shared();
    bar_sync(1 + wg, 128);
    if (lw == 0) {
#pragma unroll
      for (int q = 0; q < BN / 64; ++q) tma_store(&ty, ys + q * kTile, n0 + 64 * q, 0, 128 * i + 64 * wg, 0);
      bulk_commit();
    }
    for (int r = rh * (64 / NRH); r < (rh + 1) * (64 / NRH); ++r) {
      const float2 v = unpack2(*reinterpret_cast<const uint32_t*>(ys + swz<64>(r, 2 * cp)));
      cs[0] += v.x, cs[1] += v.y;
      cs[2] += v.x * v.x, cs[3] += v.y * v.y;
    }
  };
  uint32_t a0[4][4], a1[4][4];
  if (U > 0) fold_unit(0, a0);
  for (int u = 0; u < U; ++u) {
    if (u & 1)
      step(u, a1, a0);
    else
      step(u, a0, a1);
  }
  // the block's column sums: over warpgroups, then row groups, in order
  {
    float* rr = red + (wg * NRH + rh) * BN + 2 * cp;
    rr[0] = cs[0], rr[1] = cs[1];
    rr[2 * NRH * BN] = cs[2], rr[2 * NRH * BN + 1] = cs[3];
  }
  __syncthreads();
  for (int c = tid; c < 2 * BN; c += kThreads) {
    const int q = c / BN, col = c % BN;
    if (n0 + col >= p.C) continue;
    float v = 0.f;
    for (int r = 0; r < 2 * NRH; ++r) v += red[(q * 2 * NRH + r) * BN + col];
    p.part[((size_t)q * gridDim.x + blockIdx.x) * p.C + n0 + col] = v;
  }
  if (lw == 0) bulk_wait<false>();
}

// ------------------------------------------------- bf16 backward, one pass
// Grid (row blocks): block b walks its tiles of 64 rows.  The dW work of a
// tile is split between the warpgroups by k groups of 64 (K >= 128), by
// halves of C (K = 64, C >= 128), or by halves of the tile's rows (64 x 64;
// the two dW accumulators are added in warpgroup order at the end).
template <int K, int C>
__global__ void __launch_bounds__(kThreads, 1)
    fcbn_bwd1_bf16(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tdy,
                   const __grid_constant__ CUtensorMap ty, const __grid_constant__ CUtensorMap tw,
                   const __grid_constant__ CUtensorMap tdx, const Args p) {
  constexpr int NX = K / 2;  // dX columns a warpgroup
  constexpr int MODE = K >= 128 ? 0 : (C >= 128 ? 1 : 2);
  constexpr int KGW = MODE == 0 ? K / 128 : 1, NW = MODE == 1 ? C / 2 : C;
  constexpr int XE = 64 * K, DE = 64 * C, SE = XE + 2 * DE;
  const OneSmem L = one_smem(K, C);
  unsigned char* sm = smem_base();
  bf16* ring = reinterpret_cast<bf16*>(sm + L.ring);
  bf16* xf = reinterpret_cast<bf16*>(sm + L.xf);
  bf16* ys = reinterpret_cast<bf16*>(sm + L.ys);  // dx of a tile, stored by TMA
  bf16* ws = reinterpret_cast<bf16*>(sm + L.w);
  float* scs = reinterpret_cast<float*>(sm + L.sc);  // scale [K], offset [K]
  bf16* d12 = reinterpret_cast<bf16*>(sm + L.d);     // bf(ds1) [C], bf(2 ds2) [C]
  float* red = reinterpret_cast<float*>(sm + L.red);
  Ring<2>& rb = *reinterpret_cast<Ring<2>*>(sm + L.bars);
  uint64_t* wbar = reinterpret_cast<uint64_t*>(sm + L.bars + sizeof(Ring<2>));
  uint64_t* ybar = wbar + 1;  // y of stage s, refilled as soon as the tile is formed
  const int tid = threadIdx.x, wg = warpgroup(), lw = tid & 127, w4 = lw >> 5;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const bool fold = p.scale != nullptr;
  const int tb = blockIdx.x * p.tpb, nt = min(cdiv(p.M, 64), tb + p.tpb) - tb;

  for (int i = tid; i < K; i += kThreads) {
    scs[i] = fold ? p.scale[i] : 0.f;
    scs[K + i] = fold ? p.offset[i] : 0.f;
  }
  for (int i = tid; i < C; i += kThreads) {
    d12[i] = __float2bfloat16_rn(p.ds[i]);
    d12[C + i] = __float2bfloat16_rn(2.f * p.ds[C + i]);
  }
  auto load = [&](int u) {  // x and dy of tile u
    const int s = u & 1, row = 64 * (tb + u);
    bf16* st = ring + s * SE;
    mbar_expect_tx(&rb.full[s], (XE + DE) * 2);
#pragma unroll
    for (int q = 0; q < K / 64; ++q) tma_load(st + q * kTile, &tx, &rb.full[s], 64 * q, 0, row, 0);
#pragma unroll
    for (int q = 0; q < C / 64; ++q) tma_load(st + XE + q * kTile, &tdy, &rb.full[s], 64 * q, 0, row, 0);
  };
  auto load_y = [&](int u) {
    const int s = u & 1, row = 64 * (tb + u);
    mbar_expect_tx(&ybar[s], DE * 2);
#pragma unroll
    for (int q = 0; q < C / 64; ++q)
      tma_load(ring + s * SE + XE + DE + q * kTile, &ty, &ybar[s], 64 * q, 0, row, 0);
  };
  if (tid == 0) {
    mbar_init(&ybar[0], 1);
    mbar_init(&ybar[1], 1);
  }
  init_ring(wbar, rb);  // its barrier also publishes the arrays above
  if (tid == 0) {
    mbar_expect_tx(wbar, K * C * 2);
#pragma unroll
    for (int q = 0; q < C / 64; ++q) tma_load(ws + q * K * kPanel, &tw, wbar, 64 * q, 0, 0, 0);
    for (int u = 0; u < min(2, nt); ++u) {
      load(u);
      load_y(u);
    }
  }
  mbar_wait(wbar, 0);

  // dyt in place over dy, and with the fold xf (the previous tile's
  // products are done: a barrier came after them)
  auto form = [&](int u) {
    bf16* st = ring + (u & 1) * SE;
    const int row0 = 64 * (tb + u);
    wait_full(rb, u);
    mbar_wait(&ybar[u & 1], (u >> 1) & 1);
#pragma unroll
    for (int q = 0; q < C / 32; ++q) {
      const int idx = tid + kThreads * q, r = idx / (C / 8), c = 8 * (idx % (C / 8));
      const int off = swz<64>(r, c);
      uint4* dyp = reinterpret_cast<uint4*>(st + XE + off);
      *dyp = dyt8(*dyp, *reinterpret_cast<const uint4*>(st + XE + DE + off),
                  *reinterpret_cast<const uint4*>(d12 + c), *reinterpret_cast<const uint4*>(d12 + C + c),
                  live_row(p, row0 + r));
    }
    if (fold) {
#pragma unroll
      for (int q = 0; q < K / 32; ++q) {
        const int idx = tid + kThreads * q, r = idx / (K / 8), k = 8 * (idx % (K / 8));
        const int off = swz<64>(r, k);
        const bool lv = live_row(p, row0 + r);
        float f[8], sc[8], of[8];
        load8(st + off, f);
        lds8(scs + k, sc);
        lds8(scs + K + k, of);
#pragma unroll
        for (int e = 0; e < 8; ++e) f[e] = fold_v(f[e], sc[e], of[e], p.relu, lv);
        *reinterpret_cast<uint4*>(xf + off) = pack8(f);
      }
    }
    fence_async_shared();
  };

  float accx[NX / 2];
  float accw[KGW][NW / 2];
#pragma unroll
  for (int g2 = 0; g2 < KGW; ++g2)
#pragma unroll
    for (int e = 0; e < NW / 2; ++e) accw[g2][e] = 0.f;
  const bf16* x = static_cast<const bf16*>(p.x);
  // the thread's dscale and doffset partials over the block's tiles, its
  // columns 8 j + 2 t + e of the warpgroup's NX
  float dsc[NX / 8][2] = {}, dof[NX / 8][2] = {};
  for (int u = 0; u < nt; ++u) {
    // tile u is formed first: its stage is then free once the products are
    // done, so the load of tile u + 2 goes out a tile and a half before it
    // is needed
    if (tid == 0) bulk_wait<true>();  // the previous tile's dx left the staging tile
    form(u);
    __syncthreads();
    if (tid == 0 && u + 2 < nt) load_y(u + 2);  // y is read only while forming
    const bf16* st = ring + (u & 1) * SE;
    const bf16* dyt = st + XE;
    const bf16* xa = fold ? xf : st;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk)
      Mma<NX>::ss(accx, desc_k<64>(dyt, kk), desc_k<K>(ws + wg * NX * kPanel, kk), kk > 0);
    if constexpr (MODE == 0) {
#pragma unroll
      for (int g2 = 0; g2 < KGW; ++g2)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Mma<NW>::tt(accw[g2], desc_mn<64>(xa + (wg * KGW + g2) * kTile, kk), desc_mn<64>(dyt, kk), 1);
    } else if constexpr (MODE == 1) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Mma<NW>::tt(accw[0], desc_mn<64>(xa, kk), desc_mn<64>(dyt + wg * (NW / 64) * kTile, kk), 1);
    } else {
#pragma unroll
      for (int kk = 2 * wg; kk < 2 * wg + 2; ++kk)
        Mma<NW>::tt(accw[0], desc_mn<64>(xa, kk), desc_mn<64>(dyt, kk), 1);
    }
    wg_commit();
    // the fold's backward reads raw x through L2: its loads go out while
    // the products run
    const int row0 = 64 * (tb + u);
    uint32_t xr[NX / 8][2];
#pragma unroll
    for (int j = 0; j < NX / 8; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int m = row0 + 16 * w4 + g + 8 * hr;
        xr[j][hr] = fold && m < p.M ? __ldg(reinterpret_cast<const unsigned int*>(
                                          x + (size_t)m * K + wg * NX + 8 * j + 2 * t))
                                    : 0u;
      }
    wg_wait<0>();
    fence_regs(accx);
#pragma unroll
    for (int g2 = 0; g2 < KGW; ++g2) fence_regs(accw[g2]);
    release(rb, u);
    if (tid == 0 && u + 2 < nt) {
      mbar_wait(&rb.empty[u & 1], (u >> 1) & 1);
      load(u + 2);
    }
    // dX of the tile, with the fold's backward
#pragma unroll
    for (int j = 0; j < NX / 8; ++j) {
      const int k = wg * NX + 8 * j + 2 * t;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float o[2] = {accx[4 * j + 2 * hr], accx[4 * j + 2 * hr + 1]};
        if (fold) {
          const float2 xv = unpack2(xr[j][hr]);
          const float xs[2] = {xv.x, xv.y};
          const float2 sc2 = *reinterpret_cast<const float2*>(scs + k);
          const float2 of2 = *reinterpret_cast<const float2*>(scs + K + k);
          const float scv[2] = {sc2.x, sc2.y}, ofv[2] = {of2.x, of2.y};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float sc = scv[e], a = affine(xs[e], sc, ofv[e]);
            const float gg = (p.relu && !(a > 0.f)) ? 0.f : o[e];
            o[e] = gg * sc;
            dsc[j][e] += gg * xs[e];
            dof[j][e] += gg;
          }
        }
        st_pair<64>(ys, 16 * w4 + g + 8 * hr, k, pack_bf16x2(o[0], o[1]));
      }
    }
    fence_async_shared();
    __syncthreads();  // the tile's dx is staged; every product of the tile is done
    if (tid == 0) {
#pragma unroll
      for (int q = 0; q < K / 64; ++q) tma_store(&tdx, ys + q * kTile, 64 * q, 0, row0, 0);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait<false>();
  if (fold) {  // over the 8 lanes of a column, once
#pragma unroll
    for (int j = 0; j < NX / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float a = sum_over_g(dsc[j][e]), b = sum_over_g(dof[j][e]);
        if (g == 0) {
          red[((wg * 4 + w4) * 2 + 0) * NX + 8 * j + 2 * t + e] = a;
          red[((wg * 4 + w4) * 2 + 1) * NX + 8 * j + 2 * t + e] = b;
        }
      }
  }
  __syncthreads();
  // the block's partials: dscale and doffset over the warps in order; dW
  if (fold) {
    for (int c = tid; c < 2 * K; c += kThreads) {
      const int q = c / K, k = c % K, wgc = k / NX, kl = k % NX;
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) v += red[((wgc * 4 + w) * 2 + q) * NX + kl];
      p.part[((size_t)q * gridDim.x + blockIdx.x) * K + k] = v;
    }
  }
  float* dw = p.dw_part + (size_t)blockIdx.x * K * C;
  if constexpr (MODE == 2) {  // both warpgroups hold all of dW over half the rows
    float* other = reinterpret_cast<float*>(ring);
    if (wg == 1) {
#pragma unroll
      for (int j = 0; j < NW / 8; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          *reinterpret_cast<float2*>(other + (16 * w4 + g + 8 * hr) * C + 8 * j + 2 * t) =
              make_float2(accw[0][4 * j + 2 * hr], accw[0][4 * j + 2 * hr + 1]);
    }
    __syncthreads();
    if (wg == 0) {
#pragma unroll
      for (int j = 0; j < NW / 8; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int k = 16 * w4 + g + 8 * hr, c = 8 * j + 2 * t;
          const float2 b = *reinterpret_cast<const float2*>(other + k * C + c);
          *reinterpret_cast<float2*>(dw + (size_t)k * C + c) =
              make_float2(accw[0][4 * j + 2 * hr] + b.x, accw[0][4 * j + 2 * hr + 1] + b.y);
        }
    }
  } else {
#pragma unroll
    for (int g2 = 0; g2 < KGW; ++g2)
#pragma unroll
      for (int j = 0; j < NW / 8; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int k = 64 * (MODE == 0 ? wg * KGW + g2 : 0) + 16 * w4 + g + 8 * hr;
          const int c = (MODE == 1 ? wg * NW : 0) + 8 * j + 2 * t;
          *reinterpret_cast<float2*>(dw + (size_t)k * C + c) =
              make_float2(accw[g2][4 * j + 2 * hr], accw[g2][4 * j + 2 * hr + 1]);
        }
  }
}

// -------------------------------------------------- bf16 backward, dX pass
// Grid (row blocks, K / BK): block (b, s) computes dx[rows, s BK : (s + 1)
// BK] for its tiles of 128 rows, unit u = (tile u / CP, C panel u % CP).
// Slice 0 also writes dyt to p.dyt for the dW pass.  With the FOLD, each
// tile's dscale and doffset partials are summed over the 8 lanes of a
// column by halving exchanges, 64 columns at a time, and each thread keeps
// its share across the block's tiles (BK / 16 registers).
template <int BK, bool FOLD>
__global__ void __launch_bounds__(kThreads, 1)
    fcbn_dx_bf16(const __grid_constant__ CUtensorMap tdy, const __grid_constant__ CUtensorMap ty,
                 const __grid_constant__ CUtensorMap tw, const __grid_constant__ CUtensorMap tdx,
                 const Args p) {
  constexpr int NST = 3, DE = 128 * kPanel, SE = 2 * DE + BK * kPanel;
  const DxSmem L = dx_smem(BK, p.C);
  unsigned char* sm = smem_base();
  bf16* ring = reinterpret_cast<bf16*>(sm + L.ring);
  float* red = reinterpret_cast<float*>(sm + L.red);
  bf16* dd = reinterpret_cast<bf16*>(sm + L.dd);    // bf(ds1) [C], bf(2 ds2) [C]
  float* so = reinterpret_cast<float*>(sm + L.so);  // scale [BK], offset [BK] from k0
  Ring<NST>& rb = *reinterpret_cast<Ring<NST>*>(sm + L.bars);
  uint64_t* unused = reinterpret_cast<uint64_t*>(sm + L.bars + sizeof(Ring<NST>));
  const int tid = threadIdx.x, wg = warpgroup(), lw = tid & 127, w4 = lw >> 5;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  constexpr bool fold = FOLD;
  const int k0 = blockIdx.y * BK, CP = p.C / 64;
  const int tb = blockIdx.x * p.tpb, nt = min(cdiv(p.M, 128), tb + p.tpb) - tb, U = nt * CP;
  const bf16* x = static_cast<const bf16*>(p.x);

  for (int i = tid; i < p.C; i += kThreads) {
    dd[i] = __float2bfloat16_rn(p.ds[i]);
    dd[p.C + i] = __float2bfloat16_rn(2.f * p.ds[p.C + i]);
  }
  if (fold)
    for (int i = tid; i < BK; i += kThreads) {
      const bool in = k0 + i < p.K;
      so[i] = in ? p.scale[k0 + i] : 0.f, so[BK + i] = in ? p.offset[k0 + i] : 0.f;
    }
  auto load = [&](int u) {
    const int s = u % NST, cp = u % CP, row = 128 * (tb + u / CP);
    bf16* st = ring + s * SE;
    mbar_expect_tx(&rb.full[s], SE * 2);
    tma_load(st, &tdy, &rb.full[s], 64 * cp, 0, row, 0);
    tma_load(st + DE, &ty, &rb.full[s], 64 * cp, 0, row, 0);
    tma_load(st + 2 * DE, &tw, &rb.full[s], 64 * cp, 0, k0, 0);
  };
  init_ring(unused, rb);  // its barrier also publishes dd and so
  int next = min(NST, U);  // thread 0: the next unit to load
  if (tid == 0)
    for (int u = 0; u < next; ++u) load(u);

  float acc[BK / 2];
  // the thread's dscale and doffset partials: part_acc[c][i] is index i +
  // 16 (g & 1) + 8 ((g >> 1) & 1) + 4 (g >> 2) of chunk c's 32 values,
  // (q 16 + jj 2 + e) for q 0 dscale, 1 doffset, column k0 + 64 c + 8 jj + 2 t + e
  float part_acc[FOLD ? BK / 64 : 1][4] = {};
  int rel = -1;  // the last unit this thread released
  bool live[4];  // the thread's formed rows 64 wg + lw / 8 + 16 q of the tile
  for (int u = 0; u < U; ++u) {
    const int s = u % NST, cp = u % CP, i = tb + u / CP;
    bf16* st = ring + s * SE;
    if (cp == 0)
#pragma unroll
      for (int q = 0; q < 4; ++q) live[q] = live_row(p, 128 * i + 64 * wg + (lw >> 3) + 16 * q);
    wait_full(rb, u);
    // dyt of the warpgroup's 64 rows, in place over dy
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = 64 * wg + (lw >> 3) + 16 * q, cc = 8 * (lw & 7);
      const int c = 64 * cp + cc, m = 128 * i + r, off = swz<128>(r, cc);
      uint4* dyp = reinterpret_cast<uint4*>(st + off);
      const uint4 v = dyt8(*dyp, *reinterpret_cast<const uint4*>(st + DE + off),
                           *reinterpret_cast<const uint4*>(dd + c),
                           *reinterpret_cast<const uint4*>(dd + p.C + c), live[q]);
      *dyp = v;
      if (blockIdx.y == 0 && m < p.M) *reinterpret_cast<uint4*>(p.dyt + (size_t)m * p.C + c) = v;
    }
    fence_async_shared();
    bar_sync(1 + wg, 128);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Mma<BK>::ss(acc, desc_k<128>(st + 64 * wg * kPanel, kk), desc_k<BK>(st + 2 * DE, kk),
                   (cp > 0 || kk > 0) ? 1 : 0);
    wg_commit();
    const bool last = cp == CP - 1;
    // the fold's backward reads x through L2: the tile's loads go out
    // while its last products run
    uint32_t xr[BK / 8][2] = {};
    if (fold && last) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int m = 128 * i + 64 * wg + 16 * w4 + g + 8 * hr, k = k0 + 8 * j + 2 * t;
          if (m < p.M && k < p.K)
            xr[j][hr] = __ldg(reinterpret_cast<const unsigned int*>(x + (size_t)m * p.K + k));
        }
    }
    wg_wait<1>();  // unit u - 1's products are done
    if (u >= 1 && (u - 1) % CP != CP - 1) {
      release(rb, u - 1);
      rel = u - 1;
    }
    if (last) {
      wg_wait<0>();
      fence_regs(acc);
    }
    auto refill = [&] {
      if (tid == 0)
        for (; next < U && next - NST <= rel; ++next) {
          mbar_wait(&rb.empty[(next - NST) % NST], ((next - NST) / NST) & 1);
          load(next);
        }
    };
    refill();
    if (!last) continue;
    // the tile's last stage becomes its dx staging tile (BK / 64 panels of
    // 128 rows) once every product of the tile is done
    __syncthreads();
    // dX of the tile, with the fold's backward, 64 columns at a time
#pragma unroll
    for (int c = 0; c < BK / 64; ++c) {
      if (k0 + 64 * c >= p.K) continue;  // K is a multiple of 64
      float v[32];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = 8 * c + jj, k = k0 + 8 * j + 2 * t;
        float2 sc = make_float2(0.f, 0.f), of = sc;
        if (fold) {
          sc = *reinterpret_cast<const float2*>(so + k - k0);
          of = *reinterpret_cast<const float2*>(so + BK + k - k0);
        }
        float gx[2] = {0.f, 0.f}, gs[2] = {0.f, 0.f};
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int m = 128 * i + 64 * wg + 16 * w4 + g + 8 * hr;
          float o[2] = {acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]};
          if (fold) {
            const float2 xv = unpack2(xr[j][hr]);
            const float xs[2] = {xv.x, xv.y}, ss[2] = {sc.x, sc.y}, oo[2] = {of.x, of.y};
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float a = affine(xs[e], ss[e], oo[e]);
              const float gg = (p.relu && !(a > 0.f)) ? 0.f : o[e];
              o[e] = gg * ss[e];
              gx[e] += gg * xs[e];
              gs[e] += gg;
            }
          }
          st_pair<128>(st, m - 128 * i, 8 * j + 2 * t, pack_bf16x2(o[0], o[1]));
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) v[2 * jj + e] = gx[e], v[16 + 2 * jj + e] = gs[e];
      }
      if constexpr (FOLD) {
        float r[4];
        sum_over_g32(v, r, g);
#pragma unroll
        for (int q = 0; q < 4; ++q) part_acc[c][q] += r[q];
      }
    }
    fence_async_shared();
    bar_sync(1 + wg, 128);
    if (lw == 0) {
      for (int q = 0; q < BK / 64 && k0 + 64 * q < p.K; ++q)
        tma_store(&tdx, st + q * 128 * kPanel + 64 * wg * kPanel, k0 + 64 * q, 0, 128 * i + 64 * wg, 0);
      bulk_commit();
      bulk_wait<true>();
    }
    bar_sync(1 + wg, 128);
    release(rb, u);
    rel = u;
    refill();
  }
  if (lw == 0) bulk_wait<false>();
  if constexpr (!FOLD) {
    return;
  } else {
    const int base = 16 * (g & 1) + 8 * ((g >> 1) & 1) + 4 * (g >> 2);
#pragma unroll
    for (int c = 0; c < BK / 64; ++c)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int idx = base + q, jj = (idx >> 1) & 7;
        red[((wg * 4 + w4) * 2 + (idx >> 4)) * BK + 64 * c + 8 * jj + 2 * t + (idx & 1)] = part_acc[c][q];
      }
  }
  __syncthreads();
  for (int c = tid; c < 2 * BK; c += kThreads) {
    const int q = c / BK, col = c % BK;
    if (k0 + col >= p.K) continue;
    float v = 0.f;
    for (int w = 0; w < 8; ++w) v += red[(w * 2 + q) * BK + col];  // warpgroup 0's warps, then 1's
    p.part[((size_t)q * gridDim.x + blockIdx.x) * p.K + k0 + col] = v;
  }
}

// -------------------------------------------------- bf16 backward, dW pass
// Grid (dW tiles, splits): block (tile, s) sums dW[128 of K, BN of C] over
// the rows of split s, in units of 64 rows; writes dw_part[s].
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    fcbn_dw_bf16(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tdt,
                 const Args p) {
  constexpr int NST = 4, XE = 2 * kTile, SE = XE + BN * kPanel;
  const DwSmem L = dw_smem(BN);
  unsigned char* sm = smem_base();
  bf16* ring = reinterpret_cast<bf16*>(sm + L.ring);
  float* so = reinterpret_cast<float*>(sm + L.so);  // scale [128], offset [128] from k0
  Ring<NST>& rb = *reinterpret_cast<Ring<NST>*>(sm + L.bars);
  uint64_t* unused = reinterpret_cast<uint64_t*>(sm + L.bars + sizeof(Ring<NST>));
  const int tid = threadIdx.x, wg = warpgroup(), lw = tid & 127, w4 = lw >> 5;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const bool fold = p.scale != nullptr;
  const int KT = cdiv(p.K, 128), k0 = 128 * (blockIdx.x % KT), c0 = BN * (blockIdx.x / KT);
  const int row0 = blockIdx.y * p.rows_per_split;
  const int U = cdiv(min(p.M, row0 + p.rows_per_split) - row0, 64);
  const int kw = k0 + 64 * wg;  // the warpgroup's 64 of K
  const bool mine = kw < p.K;

  auto load = [&](int u) {
    const int s = u % NST, row = row0 + 64 * u;
    bf16* st = ring + s * SE;
    mbar_expect_tx(&rb.full[s], SE * 2);
    tma_load(st, &tx, &rb.full[s], k0, 0, row, 0);
    tma_load(st + kTile, &tx, &rb.full[s], k0 + 64, 0, row, 0);
#pragma unroll
    for (int q = 0; q < BN / 64; ++q) tma_load(st + XE + q * kTile, &tdt, &rb.full[s], c0 + 64 * q, 0, row, 0);
  };
  if (fold)
    for (int i = tid; i < 128; i += kThreads) {
      const bool in = k0 + i < p.K;
      so[i] = in ? p.scale[k0 + i] : 0.f, so[128 + i] = in ? p.offset[k0 + i] : 0.f;
    }
  init_ring(unused, rb);  // its barrier also publishes so
  if (tid == 0)
    for (int u = 0; u < min(NST, U); ++u) load(u);

  float acc[BN / 2];
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;
  for (int u = 0; u < U; ++u) {
    bf16* st = ring + (u % NST) * SE;
    bf16* xa = st + wg * kTile;
    wait_full(rb, u);
    if (fold) {  // xf in place over the warpgroup's x panel
      for (int q = 0; mine && q < 4; ++q) {
        const int idx = lw + 128 * q, r = idx >> 3, cc = 8 * (idx & 7), off = swz<64>(r, cc);
        const bool lv = live_row(p, row0 + 64 * u + r);
        float f[8], sc[8], of[8];
        load8(xa + off, f);
        lds8(so + 64 * wg + cc, sc);
        lds8(so + 128 + 64 * wg + cc, of);
#pragma unroll
        for (int e = 0; e < 8; ++e) f[e] = fold_v(f[e], sc[e], of[e], p.relu, lv);
        *reinterpret_cast<uint4*>(xa + off) = pack8(f);
      }
      fence_async_shared();
      bar_sync(1 + wg, 128);
    }
    wg_fence();  // past K the x panel holds TMA's zero fill: products of zeros, not stored
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) Mma<BN>::tt(acc, desc_mn<64>(xa, kk), desc_mn<64>(st + XE, kk), 1);
    wg_commit();
    wg_wait<1>();  // unit u - 1's products are done
    if (u >= 1) release(rb, u - 1);
    if (tid == 0 && u >= 1 && u - 1 + NST < U) {
      mbar_wait(&rb.empty[(u - 1) % NST], ((u - 1) / NST) & 1);
      load(u - 1 + NST);
    }
  }
  wg_wait<0>();
  fence_regs(acc);
  if (!mine) return;
  float* dw = p.dw_part + (size_t)blockIdx.y * p.K * p.C;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int k = kw + 16 * w4 + g + 8 * hr, c = c0 + 8 * j + 2 * t;
      if (c < p.C)
        *reinterpret_cast<float2*>(dw + (size_t)k * p.C + c) =
            make_float2(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
    }
}

// ------------------------------------------------------------------ f32
// One kernel for the three products on CUDA cores: KIND 0 the forward
// (rows M, cols C, reduce K), 1 the backward's dX (rows M, cols K, reduce
// C), 2 its dW (rows K, cols C, reduce a split of M).  64 x 64 tiles, a
// thread 4 x 4 outputs, the reduction in steps of 16.
enum { kFwd = 0, kDx = 1, kDw = 2 };

template <int KIND>
__device__ __forceinline__ float a_elem(const Args& p, int row, int red, int re) {
  const float* x = static_cast<const float*>(p.x);
  if (KIND == kFwd) {  // the folded x (m = row, k = red)
    return live_row(p, row) ? fold1(p, x[(size_t)row * p.K + red], red) : 0.f;
  }
  if (KIND == kDx) {  // dyt (m = row, c = red)
    if (!live_row(p, row)) return 0.f;
    const size_t i = (size_t)row * p.C + red;
    return dyt1(p, static_cast<const float*>(p.dy)[i], static_cast<const float*>(p.y)[i],
                       red);
  }
  // xf transposed (k = row, m = red)
  if (red >= re || !live_row(p, red) || row >= p.K) return 0.f;
  const float v = x[(size_t)red * p.K + row];
  return p.scale != nullptr ? fold1(p, v, row) : v;
}

template <int KIND>
__device__ __forceinline__ float b_elem(const Args& p, int red, int col, int re) {
  const float* w = static_cast<const float*>(p.w);
  if (KIND == kFwd) return col < p.C ? w[(size_t)red * p.C + col] : 0.f;  // W [k][c]
  if (KIND == kDx) return col < p.K ? w[(size_t)col * p.C + red] : 0.f;   // W^T: (c, k)
  if (red >= re || !live_row(p, red) || col >= p.C) return 0.f;           // dyt (m, c)
  const size_t i = (size_t)red * p.C + col;
  return dyt1(p, static_cast<const float*>(p.dy)[i], static_cast<const float*>(p.y)[i],
                     col);
}

template <int KIND>
__global__ void __launch_bounds__(kThreads) gemm_f32(Args p) {
  __shared__ float As[kFK][kFT + 4];  // [reduction][row]
  __shared__ float Bs[kFK][kFT + 4];  // [reduction][col]
  __shared__ float red[2][16][kFT];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int col0 = blockIdx.x * kFT, row0 = blockIdx.y * kFT;
  int rb = 0, re = KIND == kFwd ? p.K : p.C;
  if (KIND == kDw) {
    rb = blockIdx.z * p.rows_per_split;
    re = min(p.M, rb + p.rows_per_split);
  }
  float acc[4][4] = {};
  for (int r0 = rb; r0 < re; r0 += kFK) {
    // neighbouring threads read neighbouring addresses: along the reduction
    // for the forward's and dX's A and dX's B, along rows or columns else
    for (int i = tid; i < kFT * kFK; i += kThreads) {
      const bool red_fast = KIND != kDw;
      const int rr = red_fast ? i % kFK : i / kFT, row = red_fast ? i / kFK : i % kFT;
      As[rr][row] = a_elem<KIND>(p, row0 + row, r0 + rr, re);
    }
    for (int i = tid; i < kFT * kFK; i += kThreads) {
      const bool red_fast = KIND == kDx;
      const int rr = red_fast ? i % kFK : i / kFT, col = red_fast ? i / kFK : i % kFT;
      Bs[rr][col] = b_elem<KIND>(p, r0 + rr, col0 + col, re);
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kFK; ++rr) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[rr][4 * ty + i], b[i] = Bs[rr][4 * tx + i];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  if (KIND == kDw) {
    float* dw = p.dw_part + (size_t)blockIdx.z * p.K * p.C;
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j) {
        const int k = row0 + 4 * ty + i, c = col0 + 4 * tx + j;
        if (k < p.K && c < p.C) dw[(size_t)k * p.C + c] = acc[i][j];
      }
    return;
  }
  const int ncols = KIND == kFwd ? p.C : p.K;
  const float* x = static_cast<const float*>(p.x);
  const bool stats = KIND == kFwd || p.scale != nullptr;
  float v1[4] = {}, v2[4] = {};
  for (int i = 0; i < 4; ++i) {
    const int m = row0 + 4 * ty + i;
    for (int j = 0; j < 4; ++j) {
      const int n = col0 + 4 * tx + j;
      float o = acc[i][j];
      if (KIND == kFwd) {
        v1[j] += o, v2[j] += o * o;
      } else if (p.scale != nullptr && m < p.M && n < ncols) {
        const float xv = x[(size_t)m * p.K + n], s = p.scale[n];
        const float a = affine(xv, s, p.offset[n]);
        const float gg = (p.relu && !(a > 0.f)) ? 0.f : o;
        o = gg * s;
        v1[j] += gg * xv, v2[j] += gg;
      }
      if (m < p.M && n < ncols) static_cast<float*>(p.out)[(size_t)m * ncols + n] = o;
    }
  }
  if (!stats) return;
  for (int j = 0; j < 4; ++j) red[0][ty][4 * tx + j] = v1[j], red[1][ty][4 * tx + j] = v2[j];
  __syncthreads();
  if (tid < 2 * kFT) {
    const int which = tid / kFT, c = tid % kFT;
    if (col0 + c < ncols) {
      float s = 0.f;
      for (int r = 0; r < 16; ++r) s += red[which][r][c];
      p.part[((size_t)which * gridDim.y + blockIdx.y) * ncols + col0 + c] = s;
    }
  }
}


// The admission of both entries: ResNet's 1x1 convs (K and C multiples of
// 64, W' a multiple of 8, 0 < wv <= W') and a bf16 column width.
bool bad(const Args& p, int bn) {
  return p.M <= 0 || p.K <= 0 || p.C <= 0 || p.K % 64 || p.C % 64 || p.Wp <= 0 || p.Wp % 8 ||
         p.M % p.Wp || p.wv <= 0 || p.wv > p.Wp || (bn != 64 && bn != 128 && bn != 256);
}

Args make_args(const void* x, const void* w, const void* scale, const void* offset, int M, int K,
               int C, int Wp, int wv, int relu) {
  Args p{};
  p.x = x, p.w = w;
  p.scale = static_cast<const float*>(scale), p.offset = static_cast<const float*>(offset);
  p.M = M, p.K = K, p.C = C, p.Wp = Wp, p.wv = wv, p.relu = relu;
  return p;
}

// The TMA map of a contiguous [rows, cols] bf16 matrix, boxes of `box`
// rows x 64 columns.
cudaError_t map2d(CUtensorMap* m, const void* ptr, int rows, int cols, int box) {
  return make_map(m, ptr, 1, rows, 1, cols, box);
}

// The dX pass's BK: all of K up to 256, narrower where bf(ds1) and bf(2 ds2)
// of a wide C leave no room for three stages.
int dx_cols(int K, int C) {
  int bk = K <= 64 ? 64 : K <= 128 ? 128 : 256;
  while (bk > 64 && dx_smem(bk, C).total + 1024 > kMaxSmem) bk /= 2;  // C > 4032
  return bk;
}

cudaError_t fwd_bf16(const Args& p, int rows, int BN, cudaStream_t st) {
  const int KP = p.K / 64;
  const bool wres = KP * BN <= 512;  // the K x BN slice of W (<= 64 KB) stays resident
  CUtensorMap tx, tw, ty;
  cudaError_t e = map2d(&tx, p.x, p.M, p.K, 128);
  if (e == cudaSuccess) e = map2d(&tw, p.w, p.K, p.C, 64);
  if (e == cudaSuccess) e = map2d(&ty, p.out, p.M, p.C, 64);
  if (e != cudaSuccess) return e;
  // four stages with W resident, three streamed (two from K = 1792 at BN
  // 256, where scale and offset crowd the third out)
  const int nst = wres ? 4 : fwd_smem(BN, false, KP, 3).total + 1024 <= kMaxSmem ? 3 : 2;
  const dim3 grid(cdiv(p.M, rows), cdiv(p.C, BN));
  const size_t smem = fwd_smem(BN, wres, KP, nst).total + 1024;
#define FWD(bn, res, n) \
  if (BN == bn && wres == res && nst == n)    \
    return launch(fcbn_fwd_bf16<bn, res, n>, grid, smem, st, tx, tw, ty, p);
  FWD(256, true, 4) FWD(256, false, 3) FWD(256, false, 2) FWD(128, true, 4) FWD(128, false, 3)
  FWD(64, true, 4) FWD(64, false, 3)
#undef FWD
  return cudaErrorInvalidValue;
}

cudaError_t bwd_one_pass(const Args& p, int rows, cudaStream_t st) {
  const int K = p.K, C = p.C;
  CUtensorMap tx, tdy, ty, tw, tdx;
  cudaError_t e = map2d(&tx, p.x, p.M, K, 64);
  if (e == cudaSuccess) e = map2d(&tdy, p.dy, p.M, C, 64);
  if (e == cudaSuccess) e = map2d(&ty, p.y, p.M, C, 64);
  if (e == cudaSuccess) e = map2d(&tw, p.w, K, C, K);
  if (e == cudaSuccess) e = map2d(&tdx, p.out, p.M, K, 64);
  if (e != cudaSuccess) return e;
  const dim3 grid(cdiv(p.M, rows));
  const size_t smem = one_smem(K, C).total + 1024;
#define ONE(k, c) \
  if (K == k && C == c) return launch(fcbn_bwd1_bf16<k, c>, grid, smem, st, tx, tdy, ty, tw, tdx, p);
  ONE(64, 64) ONE(64, 128) ONE(64, 256) ONE(128, 64) ONE(128, 128) ONE(256, 64)
#undef ONE
  return cudaErrorInvalidValue;
}

cudaError_t bwd_two_pass(const Args& p, int rows, int rows_per_split, int BN, cudaStream_t st) {
  const int BK = dx_cols(p.K, p.C);
  CUtensorMap tdy, ty, tw, tdx, tx, tdt;
  cudaError_t e = map2d(&tdy, p.dy, p.M, p.C, 128);
  if (e == cudaSuccess) e = map2d(&ty, p.y, p.M, p.C, 128);
  if (e == cudaSuccess) e = map2d(&tw, p.w, p.K, p.C, BK);
  if (e == cudaSuccess) e = map2d(&tdx, p.out, p.M, p.K, 64);
  if (e == cudaSuccess) e = map2d(&tx, p.x, p.M, p.K, 64);
  if (e == cudaSuccess) e = map2d(&tdt, p.dyt, p.M, p.C, 64);
  if (e != cudaSuccess) return e;
  const dim3 gx(cdiv(p.M, rows), cdiv(p.K, BK));
  const size_t sx = dx_smem(BK, p.C).total + 1024;
#define DX(bk, fold) \
  if (BK == bk && (p.scale != nullptr) == fold) e = launch(fcbn_dx_bf16<bk, fold>, gx, sx, st, tdy, ty, tw, tdx, p);
  DX(256, true) DX(256, false) DX(128, true) DX(128, false) DX(64, true) DX(64, false)
#undef DX
  if (e != cudaSuccess) return e;
  const dim3 gw(cdiv(p.K, 128) * cdiv(p.C, BN), cdiv(p.M, rows_per_split));
  const size_t sw = dw_smem(BN).total + 1024;
  return BN == 256   ? launch(fcbn_dw_bf16<256>, gw, sw, st, tx, tdt, p)
         : BN == 128 ? launch(fcbn_dw_bf16<128>, gw, sw, st, tx, tdt, p)
         : BN == 64  ? launch(fcbn_dw_bf16<64>, gw, sw, st, tx, tdt, p)
                     : cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface (bound with ctypes).  Each returns a cudaError_t: 0 on
// a clean launch, cudaErrorInvalidValue for a plan no kernel here runs.
// Pointers are device pointers to contiguous tensors; x [M, K] and w [K, C]
// share the dtype `bf16` selects (1: bf16, 0: f32); scale and offset are
// f32 [K].  The plan is the caller's (ops/fused_conv_bn.py `_geometry`):
// the rows a block owns, the bf16 tiles' column width `bn` (64, 128 or
// 256; unread for f32) and, in the backward, one pass or two.  The
// partials have one row for each block of `rows` rows (the last one
// shorter): a multiple of 128 for bf16, 64 for f32; the caller sums them in
// block order.
//
// Forward with the fold: y [M, C]; part f32 [2, ceil(M / rows), C], the
// column sums and sums of squares of y over each block's rows.
extern "C" int fused_conv_bn_fwd_launch(const void* x, const void* w, const void* scale,
                                        const void* offset, void* y, void* part, int M, int K,
                                        int C, int Wp, int wv, int relu, int bf16_, int rows,
                                        int bn, void* stream) {
  Args p = make_args(x, w, scale, offset, M, K, C, Wp, wv, relu);
  p.out = y, p.part = static_cast<float*>(part);
  if (bad(p, bf16_ ? bn : 64) || scale == nullptr || offset == nullptr || rows <= 0 ||
      rows % (bf16_ ? 128 : kFT) || (!bf16_ && rows != kFT))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16_) {
    p.tpb = rows / 128;
    return (int)fwd_bf16(p, rows, bn, st);
  }
  gemm_f32<kFwd><<<dim3(cdiv(C, kFT), cdiv(M, kFT)), kThreads, 0, st>>>(p);
  return (int)cudaGetLastError();
}

// Backward, with the fold (scale and offset given) or without (both null):
// dy and y [M, C]; ds f32 [2, C] (the cotangents of the sums and of the
// sums of squares); dx [M, K]; part f32 [2, ceil(M / rows), K], the
// partials of dscale and doffset over each block's rows (with the fold;
// unread otherwise); dw_part f32 [ceil(M / rows_per_split), K, C], one dW
// over each split of rows_per_split rows.
//   bf16 with one_pass (only the (K, C) pairs of fcbn_bwd1_bf16 below):
//     rows_per_split == rows, a multiple of 64; dyt may be null.
//   bf16 otherwise: a dX pass over blocks of `rows` (a multiple of 128)
//     that writes dyt (bf16 [M, C], a workspace), then a dW pass over
//     splits of rows_per_split (a multiple of 64) that reads it.
//   f32: rows 64, rows_per_split a multiple of 32.
extern "C" int fused_conv_bn_bwd_launch(const void* dy, const void* y, const void* x,
                                        const void* w, const void* scale, const void* offset,
                                        const void* ds, void* dx, void* part, void* dw_part,
                                        void* dyt, int M, int K, int C, int Wp, int wv, int relu,
                                        int bf16_, int rows, int rows_per_split, int one_pass,
                                        int bn, void* stream) {
  Args p = make_args(x, w, scale, offset, M, K, C, Wp, wv, relu);
  p.dy = dy, p.y = y, p.ds = static_cast<const float*>(ds);
  p.out = dx, p.part = static_cast<float*>(part), p.dw_part = static_cast<float*>(dw_part);
  p.dyt = static_cast<bf16*>(dyt);
  p.rows_per_split = rows_per_split;
  if (bad(p, bf16_ ? bn : 64) || (scale == nullptr) != (offset == nullptr) || rows <= 0 || rows_per_split <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16_) {
    if (one_pass) {
      if (rows % 64 || rows_per_split != rows) return (int)cudaErrorInvalidValue;
      p.tpb = rows / 64;
      return (int)bwd_one_pass(p, rows, st);
    }
    if (rows % 128 || rows_per_split % 64 || dyt == nullptr) return (int)cudaErrorInvalidValue;
    p.tpb = rows / 128;
    return (int)bwd_two_pass(p, rows, rows_per_split, bn, st);
  }
  if (rows != kFT || rows_per_split % kSplitRows) return (int)cudaErrorInvalidValue;
  const int tiles = cdiv(M, kFT), splits = cdiv(M, rows_per_split);
  gemm_f32<kDx><<<dim3(cdiv(K, kFT), tiles), kThreads, 0, st>>>(p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  gemm_f32<kDw><<<dim3(cdiv(C, kFT), cdiv(K, kFT), splits), kThreads, 0, st>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* fused_conv_bn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
