// Fused 1x1 convolution + BatchNorm statistics for Hopper (sm_90a), forward
// and backward, bf16 (tensor cores, warp-level mma.sync) or f32 (CUDA cores).
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
// What bounds it on this card: bytes, except at ResNet-50's stage 4.  At
// the stage-1 shape (M 401,408, K 64 -> 256, bf16) the forward moves 257 MB
// (0.077 ms at 3.35 TB/s) for 13 GFLOP (0.013 ms at 989 TFLOP/s); the
// backward 514 MB for 26 GFLOP.  Stage 4 (M 7,168, K 512 -> 2048) is
// tensor-bound: 15 GFLOP forward, 0.015 ms, against 39 MB.
//
// What the design does about it.  Every product is a block GEMM tile on
// mma.sync.m16n8k16 (bf16 in, f32 accumulate), 8 warps, reducing in steps
// of 32.  The fold (scale, offset, ReLU, pad mask, rounding) is applied to
// x as it is staged into shared memory, so the folded activation never
// reaches device memory; the backward's dyt is formed the same way while
// staging dy and y.  The TPU kernel carries its statistics, dW and
// dscale/doffset across a sequential grid; here blocks run in any order,
// so each block writes f32 partials (a row of column sums per row tile,
// a dW tile per split of M) that the caller sums in a fixed order: no
// atomics, the same bits on every run.  The backward runs two passes, one
// for dX (with the fold's backward and its column sums in the epilogue),
// one for dW, so it reads dy, y and x twice where the TPU kernel reads them
// once (the bound counts one read).  The staging loads go to registers
// and then shared memory with no pipelining (cp.async, TMA, wgmma and a
// persistent schedule are later work).  f32 runs on CUDA cores, in 64 x 64
// tiles of 4 x 4 outputs a thread: right, and slow.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (paddle_tpu_torch/ops/_build.py does this).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kBK = 32;        // reduction step of the bf16 tiles
constexpr int kPad = 8;        // bf16 of padding per shared row: conflict-free fragments
constexpr int kFT = 64;        // f32 tile edge
constexpr int kFK = 16;        // reduction step of the f32 tiles

struct Args {
  const void* x;        // [M, K]
  const void* w;        // [K, C]
  const float* scale;   // [K] f32, or null: no fold (backward only)
  const float* offset;  // [K] f32
  const void* dy;       // [M, C] (backward)
  const void* y;        // [M, C] (backward)
  const float* ds;      // [2, C] f32: the cotangents of the sums and sums of squares
  void* out;            // forward: y [M, C]; backward: dx [M, K]
  float* part;          // forward: [2, row tiles, C]; backward with the fold: [2, row tiles, K]
  float* dw_part;       // backward: [splits, K, C]
  int M, K, C, Wp, wv, relu;
  int rows_per_split;   // backward: rows of M that one dW block reduces
};

__device__ __forceinline__ bool live_row(const Args& p, int m) {
  return m < p.M && (m % p.Wp) < p.wv;
}

// x rounded to T and back.
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const bf16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
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

// dyt of one element in T's arithmetic: dy + (bf(ds1) + y * bf(2 ds2)),
// each operation rounded to T.
template <typename T>
__device__ __forceinline__ float dyt1(const Args& p, float dy, float y, int c) {
  const T* tag = nullptr;
  const float d1 = round_to(p.ds[c], tag);
  const float d2 = round_to(2.f * p.ds[p.C + c], tag);
  const float t1 = round_to(y * d2, tag);
  const float t2 = round_to(d1 + t1, tag);
  return round_to(dy + t2, tag);
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

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]), pack2(f[6], f[7]));
}

__device__ __forceinline__ uint32_t u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                                  uint32_t& r3, const bf16* smem) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(a));
}

// Fragment layout of m16n8k16 (lane = 4 g + t): A (16 x 16) reg0 = (row g,
// cols 2t, 2t+1), reg1 = row g+8, reg2 = (row g, cols 2t+8, 2t+9), reg3 =
// row g+8 of those; B (16 x 8) reg0 = (k 2t, 2t+1; n g), reg1 = k + 8;
// C (16 x 8, f32): c0, c1 = (row g, cols 2t, 2t+1), c2, c3 = row g+8.
//
// A fragment from a [row][reduction] tile (reduction contiguous).
template <int LD>
__device__ __forceinline__ void frag_a_rows(uint32_t (&a)[4], bf16 (*s)[LD], int row,
                                            int col, int g, int t) {
  const bf16* r0 = &s[row + g][col + 2 * t];
  const bf16* r1 = &s[row + g + 8][col + 2 * t];
  a[0] = u32(r0), a[1] = u32(r1), a[2] = u32(r0 + 8), a[3] = u32(r1 + 8);
}

// A fragment from a [reduction][row] tile, through ldmatrix.trans: matrix
// q = lane / 8 holds reduction rows red + 8 (q >> 1) and output rows row +
// 8 (q & 1), in the order of reg0..reg3.
template <int LD>
__device__ __forceinline__ void frag_a_trans(uint32_t (&a)[4], bf16 (*s)[LD], int red,
                                             int row, int lane) {
  const int q = lane >> 3, r = lane & 7;
  ldmatrix_x4_trans(a[0], a[1], a[2], a[3], &s[red + (q >> 1) * 8 + r][row + (q & 1) * 8]);
}

// B fragments of two neighbouring n-tiles (cols col .. col + 15) from a
// [reduction][n] tile, through ldmatrix.trans: (b0, b1) for the first,
// (b2, b3) for the second.
template <int LD>
__device__ __forceinline__ void frag_b_trans(uint32_t (&b)[4], bf16 (*s)[LD], int red,
                                             int col, int lane) {
  const int q = lane >> 3, r = lane & 7;
  ldmatrix_x4_trans(b[0], b[1], b[2], b[3], &s[red + (q & 1) * 8 + r][col + (q >> 1) * 8]);
}

// The sum over the 8 lanes that share t (the rows g of a fragment).
__device__ __forceinline__ float sum_over_g(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// Column sums of a BM x BN tile, two of them (v1, v2), held per thread as
// [NT][2] over its fragment columns: reduced over the warp's rows, then
// over the WM warps of a column in warp order, and written to
// part[(which * tiles + tile) * ld + col0 + c] for columns below `ncols`.
template <int WM, int BN, int NT>
__device__ __forceinline__ void column_partials(float (&v1)[NT][2], float (&v2)[NT][2],
                                                float (*red)[WM][BN], float* part, int tiles,
                                                int tile, int ld, int col0, int ncols,
                                                int wm, int wcol, int lane) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float a = sum_over_g(v1[nt][e]), b = sum_over_g(v2[nt][e]);
      if (lane < 4) {
        red[0][wm][wcol + 8 * nt + 2 * lane + e] = a;
        red[1][wm][wcol + 8 * nt + 2 * lane + e] = b;
      }
    }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * BN; i += kThreads) {
    const int which = i / BN, c = i % BN;
    if (col0 + c >= ncols) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WM; ++w) s += red[which][w][c];
    part[((size_t)which * tiles + tile) * ld + col0 + c] = s;
  }
}

// ------------------------------------------------------------- bf16 forward
// Tile BM rows of M x BN columns of C; grid (C / BN, ceil(M / BM)).
template <int BM, int BN>
__global__ void __launch_bounds__(kThreads) fwd_bf16(Args p) {
  constexpr int WM = BM / 32, WN = 8 / WM, WC = BN / WN, NT = WC / 8;
  __shared__ __align__(16) bf16 As[BM][kBK + kPad];  // folded x [m][k]
  __shared__ __align__(16) bf16 Bs[kBK][BN + kPad];  // W [k][n]
  __shared__ float red[2][WM][BN];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const bf16* x = static_cast<const bf16*>(p.x);
  const bf16* w = static_cast<const bf16*>(p.w);
  float acc[2][NT][4] = {};
  for (int k0 = 0; k0 < p.K; k0 += kBK) {
    for (int i = tid; i < BM * kBK / 8; i += kThreads) {
      const int r = i / (kBK / 8), k = k0 + 8 * (i % (kBK / 8)), m = m0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (live_row(p, m)) {
        float f[8];
        load8(x + (size_t)m * p.K + k, f);
#pragma unroll
        for (int e = 0; e < 8; ++e) f[e] = fold1(p, f[e], k + e);
        v = pack8(f);
      }
      *reinterpret_cast<uint4*>(&As[r][k - k0]) = v;
    }
    for (int i = tid; i < kBK * BN / 8; i += kThreads) {
      const int r = i / (BN / 8), c = 8 * (i % (BN / 8));
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + c < p.C) v = *reinterpret_cast<const uint4*>(w + (size_t)(k0 + r) * p.C + n0 + c);
      *reinterpret_cast<uint4*>(&Bs[r][c]) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) frag_a_rows(a[mt], As, wm * 32 + 16 * mt, kk, g, t);
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        uint32_t b[4];
        frag_b_trans(b, Bs, kk, wn * WC + 16 * j, lane);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_16816(acc[mt][2 * j], a[mt], b[0], b[1]);
          mma_16816(acc[mt][2 * j + 1], a[mt], b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }
  // y rounded to bf16, stored; the column sums of the rounded values (rows
  // past M and pad rows are exact zeros)
  bf16* y = static_cast<bf16*>(p.out);
  float s1[NT][2] = {}, s2[NT][2] = {};
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 32 + 16 * mt + g + 8 * h;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = n0 + wn * WC + 8 * nt + 2 * t;
        const __nv_bfloat162 v = __floats2bfloat162_rn(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        if (m < p.M && n < p.C) *reinterpret_cast<__nv_bfloat162*>(y + (size_t)m * p.C + n) = v;
        const float2 f = __bfloat1622float2(v);
        s1[nt][0] += f.x, s1[nt][1] += f.y;
        s2[nt][0] += f.x * f.x, s2[nt][1] += f.y * f.y;
      }
    }
  column_partials<WM, BN, NT>(s1, s2, red, p.part, gridDim.y, blockIdx.y, p.C, n0, p.C, wm,
                              wn * WC, lane);
}

// ---------------------------------------------------------- bf16 backward dX
// Tile BM rows of M x BN columns of K, reducing over C; grid (K / BN,
// ceil(M / BM)).  With the fold, the epilogue applies its backward and
// writes the column partials of dscale and doffset.
template <int BM, int BN>
__global__ void __launch_bounds__(kThreads) dx_bf16(Args p) {
  constexpr int WM = BM / 32, WN = 8 / WM, WC = BN / WN, NT = WC / 8;
  __shared__ __align__(16) bf16 As[BM][kBK + kPad];  // dyt [m][c]
  __shared__ __align__(16) bf16 Bs[BN][kBK + kPad];  // W [k][c]
  __shared__ float red[2][WM][BN];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const bf16* dy = static_cast<const bf16*>(p.dy);
  const bf16* yv = static_cast<const bf16*>(p.y);
  const bf16* w = static_cast<const bf16*>(p.w);
  float acc[2][NT][4] = {};
  for (int c0 = 0; c0 < p.C; c0 += kBK) {
    for (int i = tid; i < BM * kBK / 8; i += kThreads) {
      const int r = i / (kBK / 8), c = c0 + 8 * (i % (kBK / 8)), m = m0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (live_row(p, m)) {
        float d[8], yy[8];
        load8(dy + (size_t)m * p.C + c, d);
        load8(yv + (size_t)m * p.C + c, yy);
#pragma unroll
        for (int e = 0; e < 8; ++e) d[e] = dyt1<bf16>(p, d[e], yy[e], c + e);
        v = pack8(d);
      }
      *reinterpret_cast<uint4*>(&As[r][c - c0]) = v;
    }
    for (int i = tid; i < BN * kBK / 8; i += kThreads) {
      const int r = i / (kBK / 8), c = c0 + 8 * (i % (kBK / 8));
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + r < p.K) v = *reinterpret_cast<const uint4*>(w + (size_t)(n0 + r) * p.C + c);
      *reinterpret_cast<uint4*>(&Bs[r][c - c0]) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) frag_a_rows(a[mt], As, wm * 32 + 16 * mt, kk, g, t);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const bf16* br = &Bs[wn * WC + 8 * nt + g][kk + 2 * t];
        const uint32_t b0 = u32(br), b1 = u32(br + 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_16816(acc[mt][nt], a[mt], b0, b1);
      }
    }
    __syncthreads();
  }
  const bf16* x = static_cast<const bf16*>(p.x);
  bf16* dx = static_cast<bf16*>(p.out);
  const bool fold = p.scale != nullptr;
  float dsc[NT][2] = {}, dof[NT][2] = {};
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 32 + 16 * mt + g + 8 * h;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int k = n0 + wn * WC + 8 * nt + 2 * t;
        if (m >= p.M || k >= p.K) continue;
        float o[2] = {acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]};
        if (fold) {
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(x + (size_t)m * p.K + k));
          const float xs[2] = {xv.x, xv.y};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float s = p.scale[k + e];
            const float a = affine(xs[e], s, p.offset[k + e]);
            const float gg = (p.relu && !(a > 0.f)) ? 0.f : o[e];
            o[e] = gg * s;
            dsc[nt][e] += gg * xs[e];
            dof[nt][e] += gg;
          }
        }
        *reinterpret_cast<__nv_bfloat162*>(dx + (size_t)m * p.K + k) =
            __floats2bfloat162_rn(o[0], o[1]);
      }
    }
  if (fold)
    column_partials<WM, BN, NT>(dsc, dof, red, p.part, gridDim.y, blockIdx.y, p.K, n0, p.K, wm,
                                wn * WC, lane);
}

// ---------------------------------------------------------- bf16 backward dW
// Tile BM rows of K x BN columns of C, reducing over rows_per_split rows of
// M; grid (C / BN, K / BM, splits).  Writes dw_part[split].
template <int BM, int BN>
__global__ void __launch_bounds__(kThreads) dw_bf16(Args p) {
  constexpr int WM = BM / 32, WN = 8 / WM, WC = BN / WN, NT = WC / 8;
  __shared__ __align__(16) bf16 Xs[kBK][BM + kPad];  // xf [m][k]
  __shared__ __align__(16) bf16 Ds[kBK][BN + kPad];  // dyt [m][c]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int c0 = blockIdx.x * BN, k0 = blockIdx.y * BM;
  const int rb = blockIdx.z * p.rows_per_split, re = min(p.M, rb + p.rows_per_split);
  const bf16* x = static_cast<const bf16*>(p.x);
  const bf16* dy = static_cast<const bf16*>(p.dy);
  const bf16* yv = static_cast<const bf16*>(p.y);
  const bool fold = p.scale != nullptr;
  float acc[2][NT][4] = {};
  for (int mr = rb; mr < re; mr += kBK) {
    for (int i = tid; i < kBK * BM / 8; i += kThreads) {
      const int r = i / (BM / 8), k = k0 + 8 * (i % (BM / 8)), m = mr + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m < re && live_row(p, m)) {
        if (fold) {
          float f[8];
          load8(x + (size_t)m * p.K + k, f);
#pragma unroll
          for (int e = 0; e < 8; ++e) f[e] = fold1(p, f[e], k + e);
          v = pack8(f);
        } else {
          v = *reinterpret_cast<const uint4*>(x + (size_t)m * p.K + k);
        }
      }
      *reinterpret_cast<uint4*>(&Xs[r][k - k0]) = v;
    }
    for (int i = tid; i < kBK * BN / 8; i += kThreads) {
      const int r = i / (BN / 8), c = c0 + 8 * (i % (BN / 8)), m = mr + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m < re && live_row(p, m) && c < p.C) {
        float d[8], yy[8];
        load8(dy + (size_t)m * p.C + c, d);
        load8(yv + (size_t)m * p.C + c, yy);
#pragma unroll
        for (int e = 0; e < 8; ++e) d[e] = dyt1<bf16>(p, d[e], yy[e], c + e);
        v = pack8(d);
      }
      *reinterpret_cast<uint4*>(&Ds[r][c - c0]) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) frag_a_trans(a[mt], Xs, kk, wm * 32 + 16 * mt, lane);
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        uint32_t b[4];
        frag_b_trans(b, Ds, kk, wn * WC + 16 * j, lane);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_16816(acc[mt][2 * j], a[mt], b[0], b[1]);
          mma_16816(acc[mt][2 * j + 1], a[mt], b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }
  float* dw = p.dw_part + (size_t)blockIdx.z * p.K * p.C;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = k0 + wm * 32 + 16 * mt + g + 8 * h;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = c0 + wn * WC + 8 * nt + 2 * t;
        if (k < p.K && c < p.C)
          *reinterpret_cast<float2*>(dw + (size_t)k * p.C + c) =
              make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
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
    return dyt1<float>(p, static_cast<const float*>(p.dy)[i], static_cast<const float*>(p.y)[i],
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
  return dyt1<float>(p, static_cast<const float*>(p.dy)[i], static_cast<const float*>(p.y)[i],
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

int cdiv(int a, int b) { return (a + b - 1) / b; }

// The admission of both entries: ResNet's 1x1 convs (K and C multiples of
// 64, W' a multiple of 8, 0 < wv <= W').
bool bad(const Args& p) {
  return p.M <= 0 || p.K <= 0 || p.C <= 0 || p.K % 64 || p.C % 64 || p.Wp <= 0 || p.Wp % 8 ||
         p.M % p.Wp || p.wv <= 0 || p.wv > p.Wp;
}

// Row tiles of the forward and dX passes: 128 rows (bf16) or 64 (f32).
int row_tiles(int M, int bf16) { return cdiv(M, bf16 ? 128 : kFT); }

Args make_args(const void* x, const void* w, const void* scale, const void* offset, int M, int K,
               int C, int Wp, int wv, int relu) {
  Args p{};
  p.x = x, p.w = w;
  p.scale = static_cast<const float*>(scale), p.offset = static_cast<const float*>(offset);
  p.M = M, p.K = K, p.C = C, p.Wp = Wp, p.wv = wv, p.relu = relu;
  return p;
}

}  // namespace

// Plain C interface (bound with ctypes).  Each returns a cudaError_t: 0 on
// a clean launch.  Pointers are device pointers to contiguous tensors; x
// [M, K] and w [K, C] share the dtype `bf16` selects (1: bf16, 0: f32);
// scale and offset are f32 [K].  `tiles` must equal the row tiles of the
// partials, ceil(M / 128) for bf16 and ceil(M / 64) for f32.
//
// Forward with the fold: y [M, C]; part f32 [2, tiles, C], the column sums
// and sums of squares of y per row tile.
extern "C" int fused_conv_bn_fwd_launch(const void* x, const void* w, const void* scale,
                                        const void* offset, void* y, void* part, int M, int K,
                                        int C, int Wp, int wv, int relu, int bf16_, int tiles,
                                        void* stream) {
  Args p = make_args(x, w, scale, offset, M, K, C, Wp, wv, relu);
  p.out = y, p.part = static_cast<float*>(part);
  if (bad(p) || scale == nullptr || offset == nullptr || tiles != row_tiles(M, bf16_))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16_)
    fwd_bf16<128, 128><<<dim3(cdiv(C, 128), tiles), kThreads, 0, st>>>(p);
  else
    gemm_f32<kFwd><<<dim3(cdiv(C, kFT), tiles), kThreads, 0, st>>>(p);
  return (int)cudaGetLastError();
}

// Backward, with the fold (scale and offset given) or without (both null):
// dy and y [M, C]; ds f32 [2, C] (the cotangents of the sums and of the
// sums of squares); dx [M, K]; part f32 [2, tiles, K], the column partials
// of dscale and doffset (with the fold; unread otherwise); dw_part f32
// [splits, K, C], one dW per split of M into rows_per_split rows (a
// multiple of 32), which the caller sums.
extern "C" int fused_conv_bn_bwd_launch(const void* dy, const void* y, const void* x,
                                        const void* w, const void* scale, const void* offset,
                                        const void* ds, void* dx, void* part, void* dw_part,
                                        int M, int K, int C, int Wp, int wv, int relu, int bf16_,
                                        int tiles, int splits, int rows_per_split,
                                        void* stream) {
  Args p = make_args(x, w, scale, offset, M, K, C, Wp, wv, relu);
  p.dy = dy, p.y = y, p.ds = static_cast<const float*>(ds);
  p.out = dx, p.part = static_cast<float*>(part), p.dw_part = static_cast<float*>(dw_part);
  p.rows_per_split = rows_per_split;
  if (bad(p) || (scale == nullptr) != (offset == nullptr) || tiles != row_tiles(M, bf16_) ||
      rows_per_split <= 0 || rows_per_split % kBK || splits != cdiv(M, rows_per_split))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16_) {
    if (K % 128 == 0)
      dx_bf16<128, 128><<<dim3(K / 128, tiles), kThreads, 0, st>>>(p);
    else
      dx_bf16<128, 64><<<dim3(K / 64, tiles), kThreads, 0, st>>>(p);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    dw_bf16<64, 128><<<dim3(cdiv(C, 128), K / 64, splits), kThreads, 0, st>>>(p);
  } else {
    gemm_f32<kDx><<<dim3(cdiv(K, kFT), tiles), kThreads, 0, st>>>(p);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    gemm_f32<kDw><<<dim3(cdiv(C, kFT), cdiv(K, kFT), splits), kThreads, 0, st>>>(p);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* fused_conv_bn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
