// Attention backward kernels of encoder_attention_bwd.cu, on the
// `mma.sync.m16n8k16` bf16 fragments of mma_attention.cuh (f32
// accumulators).
//
// Tiling: a block of 4 warps owns 64 rows of one (batch, head) -- query rows
// for dQ, key rows for dK/dV -- and stages them once in shared memory (Q and
// dO, or K and V).  It then walks 64-row tiles of the other side (K and V,
// or Q and dO), staged in turn.  Each warp owns 16 of the block's rows and
// works through a tile 16 columns at a time ("chunks"), so that only two
// 16 x 16 f32 products (8 registers each) are live besides its accumulators.
// All arrays in shared memory are [64][D + 8] bf16: the 8 bf16 of padding
// make every fragment read below hit 32 distinct banks, as in the forward.
//
// The products, and their fragment layouts (lane = 4 g + t; see
// mma_attention.cuh for the m16n8k16 A, B and C layouts):
//  * X Y^T, X the warp's 16 rows over D, Y the tile's rows (S = Q K^T and
//    dP = dO V^T for dQ; S^T = K Q^T and dP^T = V dO^T for dK/dV).  A is X
//    row major: a0 = X[g][16dd + 2t, +1], a1 = X[g + 8][...], a2 = X[g][16dd
//    + 8 + 2t, +1], a3 = X[g + 8][16dd + 8 + 2t, +1].  B of n-tile n (k = d,
//    n = a row of Y) is b0 = Y[8n + g][16dd + 2t, +1], b1 = Y[8n + g][16dd +
//    8 + 2t, +1]: the reads the forward's `scores` makes of K.
//  * C A Y, where C is one 16 x 16 chunk of such a product (columns 16kk..
//    16kk + 15 of the tile: n-tiles 2kk and 2kk + 1, elements c[j][e] at row
//    g + 8 (e >> 1), column 8j + 2t + (e & 1)).  Its A fragment is {c[0][0,1],
//    c[0][2,3], c[1][0,1], c[1][2,3]} (the layout of P in the forward's P V),
//    and Y's rows 16kk.. are the B operand (k = the chunk's 16 columns, n = d),
//    read transposed by `ldmatrix.trans`.  dQ += dS K takes Y = K (rows are
//    keys); dV += P^T dO and dK += dS^T Q take Y = dO and Y = Q (rows are
//    queries).
//
// Masks are bottom-right aligned as in the forward: query i sees key j iff
// j <= i + Sk - Sq.  Rows past the sequence are staged as zeros and masked,
// so they add nothing.
//
// Encoder dropout (seed given): with keep the forward's mask (regenerated
// from the seed pair by keep_pair / keep_pair_t of mma_attention.cuh, the
// same bits whichever way a tile is held), P_d = where(keep, P / (1 -
// rate), 0) and dP = where(keep, dO V^T / (1 - rate), 0): dV = P_d^T dO,
// dsum = rowsum(dP * P), dS = P (dP - dsum).
#pragma once

#include "mma_attention.cuh"

namespace mma_attention {

struct Grad {
  const __nv_bfloat16* q;   // [B, Sq, H, D]
  const __nv_bfloat16* k;   // [B, Sk, H, D]
  const __nv_bfloat16* v;   // [B, Sk, H, D]
  const __nv_bfloat16* dO;  // [B, Sq, H, D]
  float* lse;               // [B * H, Sq], written by dq_kernel
  float* dsum;              // [B * H, Sq]: sum_j P dP, written by dq_kernel
  __nv_bfloat16* dq;        // [B, Sq, H, D]
  __nv_bfloat16* dk;        // [B, Sk, H, D]
  __nv_bfloat16* dv;        // [B, Sk, H, D]
  int B, H, Sq, Sk;
  float scale;
  int causal;
  const int* seed;          // encoder dropout: int32 [2] seed pair, or null (no dropout)
  uint32_t thresh;          // keep iff the element's Philox word < thresh
  float inv_keep;           // 1 / (1 - rate)
};

template <int D>
struct BwdSmem {
  __nv_bfloat16 x1[kBK][D + kPad];  // the block's own rows: Q (dQ) or K (dK/dV)
  __nv_bfloat16 x2[kBK][D + kPad];  // dO (dQ) or V (dK/dV)
  __nv_bfloat16 y1[kBK][D + kPad];  // the walked tile: K (dQ) or Q (dK/dV)
  __nv_bfloat16 y2[kBK][D + kPad];  // V (dQ) or dO (dK/dV)
  float lse[kBK];                   // the tile's per-query statistics (dK/dV)
  float dsum[kBK];
};

__device__ __forceinline__ bool visible(const Grad& p, int query, int key) {
  return query < p.Sq && key < p.Sk && (!p.causal || key <= query + p.Sk - p.Sq);
}

// Rows [r0, r0 + kBK) of head h, batch b of a [B, S, H, D] tensor into a
// shared [kBK][D + kPad] array, 16 bytes a thread; rows at or past S are 0.
template <int D>
__device__ __forceinline__ void stage_rows(__nv_bfloat16 (*dst)[D + kPad],
                                           const __nv_bfloat16* src, int b, int h, int r0,
                                           int S, int H, int tid) {
  constexpr int kSegs = D / 8;
  for (int i = tid; i < kBK * kSegs; i += kThreads) {
    const int j = i / kSegs, seg = i % kSegs, r = r0 + j;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < S)
      val = *reinterpret_cast<const uint4*>(src + ((size_t)(b * S + r) * H + h) * D + seg * 8);
    *reinterpret_cast<uint4*>(&dst[j][seg * 8]) = val;
  }
}

// c = X Y^T for the chunk kk (Y rows 16kk .. 16kk + 15): x points at the
// warp's 16 rows of X, y at row 0 of Y, both shared [.][D + kPad] arrays.
template <int D>
__device__ __forceinline__ void xyt_chunk(float (&c)[2][4], const __nv_bfloat16* x,
                                          const __nv_bfloat16* y, int kk, int g, int t) {
  constexpr int L = D + kPad;
#pragma unroll
  for (int j = 0; j < 2; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
  for (int dd = 0; dd < D / 16; ++dd) {
    const __nv_bfloat16* x0 = x + g * L + 16 * dd + 2 * t;
    const __nv_bfloat16* x1 = x0 + 8 * L;
    const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(x0),
                           *reinterpret_cast<const uint32_t*>(x1),
                           *reinterpret_cast<const uint32_t*>(x0 + 8),
                           *reinterpret_cast<const uint32_t*>(x1 + 8)};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const __nv_bfloat16* yr = y + (16 * kk + 8 * j + g) * L + 16 * dd + 2 * t;
      mma_16816(c[j], a, *reinterpret_cast<const uint32_t*>(yr),
                *reinterpret_cast<const uint32_t*>(yr + 8));
    }
  }
}

// The A fragment of a chunk, rounded to bf16.
__device__ __forceinline__ void chunk_a(uint32_t (&a)[4], const float (&c)[2][4]) {
  a[0] = pack_bf16x2(c[0][0], c[0][1]);
  a[1] = pack_bf16x2(c[0][2], c[0][3]);
  a[2] = pack_bf16x2(c[1][0], c[1][1]);
  a[3] = pack_bf16x2(c[1][2], c[1][3]);
}

// The same split in two bf16 parts, hi = bf16(c) and lo = bf16(c - hi): hi
// + lo carries about 16 bits of c's mantissa, so hi Y + lo Y on the bf16
// tensor cores is within about 2^-17 of c Y in f32.
__device__ __forceinline__ uint32_t split_bf16x2(float x0, float x1, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h));
  lo = *reinterpret_cast<const uint32_t*>(&l);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void chunk_a_split(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                              const float (&c)[2][4]) {
  hi[0] = split_bf16x2(c[0][0], c[0][1], lo[0]);
  hi[1] = split_bf16x2(c[0][2], c[0][3], lo[1]);
  hi[2] = split_bf16x2(c[1][0], c[1][1], lo[2]);
  hi[3] = split_bf16x2(c[1][2], c[1][3], lo[3]);
}

// o += A Y for the chunk kk: A a 16 x 16 fragment, Y rows 16kk .. 16kk + 15
// of a shared [kBK][D + kPad] array (y: its row 0) read transposed (ldmatrix.trans:
// matrices 0/1 = rows 0-7 / 8-15 at dims 8dn.., 2/3 the same at 8(dn+1)..).
template <int D>
__device__ __forceinline__ void ay(float (&o)[D / 8][4], const uint32_t (&a)[4],
                                   const __nv_bfloat16* y, int kk, int lane) {
  const int mi = lane >> 3, r = lane & 7;
  const __nv_bfloat16* row = y + (16 * kk + (mi & 1) * 8 + r) * (D + kPad) + (mi >> 1) * 8;
#pragma unroll
  for (int dn = 0; dn < D / 8; dn += 2) {
    uint32_t b0, b1, b2, b3;
    ldmatrix_x4_trans(b0, b1, b2, b3, row + 8 * dn);
    mma_16816(o[dn], a, b0, b1);
    mma_16816(o[dn + 1], a, b2, b3);
  }
}

// The warp's 16 rows (row0 + g, + 8) of acc * mul as bf16 into a [B, S, H, D]
// tensor; rows at or past S are not written.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const float (&acc)[D / 8][4],
                                           float mul, int b, int h, int row0, int S, int H,
                                           int g, int t) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row0 + g + 8 * hr;
    if (row >= S) continue;
    uint32_t* out = reinterpret_cast<uint32_t*>(dst + ((size_t)(b * S + row) * H + h) * D);
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      out[4 * dn + t] = pack_bf16x2(acc[dn][2 * hr] * mul, acc[dn][2 * hr + 1] * mul);
  }
}

// dQ for one 64-row query tile (grid: query tiles x H x B).  Per key tile up
// to the causal end: P = exp(scale S - lse), dP = dO V^T, dS = P (dP - dsum)
// times scale, rounded to bf16 (the encoder reference's order), and dQ +=
// dS K.
//
// The forward saved no statistics, so a first walk over the same key tiles
// finds each row's max m, sum l of exp(scale S - m) and sum of exp(scale S
// - m) dP (online, rescaled as the max grows); then lse = m + log l and
// dsum = sum_j P dP, which it also writes out for the dK/dV kernel.
template <int D>
__global__ void __launch_bounds__(kThreads) dq_kernel(Grad p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem<D>& sm = *reinterpret_cast<BwdSmem<D>*>(smem_raw);
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kBK, row0 = q0 + 16 * warp;
  const size_t stat0 = (size_t)(b * p.H + h) * p.Sq;
  const bool drop = p.seed != nullptr;
  const uint2 key = drop ? philox::key(p.seed) : make_uint2(0u, 0u);

  stage_rows<D>(sm.x1, p.q, b, h, q0, p.Sq, p.H, tid);
  stage_rows<D>(sm.x2, p.dO, b, h, q0, p.Sq, p.H, tid);
  const __nv_bfloat16* xq = &sm.x1[16 * warp][0];
  const __nv_bfloat16* xd = &sm.x2[16 * warp][0];
  const int qlast = min(q0 + kBK, p.Sq) - 1;
  const int kend = p.causal ? min(p.Sk, qlast + p.Sk - p.Sq + 1) : p.Sk;

  float lse[2], dsum[2];
  {  // the first walk
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, a[2] = {0.f, 0.f};  // lane shares
    for (int kb = 0; kb < kend; kb += kBK) {
      __syncthreads();
      stage_rows<D>(sm.y1, p.k, b, h, kb, p.Sk, p.H, tid);
      stage_rows<D>(sm.y2, p.v, b, h, kb, p.Sk, p.H, tid);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        float s[2][4], dp[2][4];
        xyt_chunk<D>(s, xq, &sm.y1[0][0], kk, g, t);
        xyt_chunk<D>(dp, xd, &sm.y2[0][0], kk, g, t);
        if (drop)
          apply_keep(dp[0], dp[1],
                     keep_pair(key, b * p.H + h, row0, kb + 16 * kk, g, t, p.thresh),
                     p.inv_keep);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float mx = kNegInf;
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
              const int col = kb + 16 * kk + 8 * j + 2 * t + (e & 1);
              s[j][e] = visible(p, row0 + g + 8 * hr, col) ? s[j][e] * p.scale : kNegInf;
              mx = fmaxf(mx, s[j][e]);
            }
          const float m_new = fmaxf(m[hr], quad_max(mx));
          const float corr = __expf(m[hr] - m_new);
          float es = 0.f, eds = 0.f;
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
              const float ex = __expf(s[j][e] - m_new);
              es += ex;
              eds += ex * dp[j][e];
            }
          l[hr] = l[hr] * corr + es;
          a[hr] = a[hr] * corr + eds;
          m[hr] = m_new;
        }
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float lt = quad_sum(l[hr]), at = quad_sum(a[hr]);
      const int row = row0 + g + 8 * hr;
      const bool live = row < p.Sq && lt > 0.f;
      lse[hr] = live ? m[hr] + logf(lt) : 0.f;
      dsum[hr] = live ? at / lt : 0.f;
      if (t == 0 && row < p.Sq) {
        p.lse[stat0 + row] = lse[hr];
        p.dsum[stat0 + row] = dsum[hr];
      }
    }
  }

  float dq[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) dq[dn][0] = dq[dn][1] = dq[dn][2] = dq[dn][3] = 0.f;
  for (int kb = 0; kb < kend; kb += kBK) {
    __syncthreads();  // the previous tile is done with (and x1/x2 are staged)
    stage_rows<D>(sm.y1, p.k, b, h, kb, p.Sk, p.H, tid);
    stage_rows<D>(sm.y2, p.v, b, h, kb, p.Sk, p.H, tid);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      float s[2][4], dp[2][4];
      xyt_chunk<D>(s, xq, &sm.y1[0][0], kk, g, t);
      xyt_chunk<D>(dp, xd, &sm.y2[0][0], kk, g, t);
      if (drop)
        apply_keep(dp[0], dp[1],
                   keep_pair(key, b * p.H + h, row0, kb + 16 * kk, g, t, p.thresh),
                   p.inv_keep);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e >> 1, col = kb + 16 * kk + 8 * j + 2 * t + (e & 1);
          const float ds = visible(p, row0 + g + 8 * hr, col)
                               ? __expf(s[j][e] * p.scale - lse[hr]) * (dp[j][e] - dsum[hr])
                               : 0.f;
          s[j][e] = ds * p.scale;
        }
      uint32_t a[4];
      chunk_a(a, s);
      ay<D>(dq, a, &sm.y1[0][0], kk, lane);
    }
  }
  store_rows<D>(p.dq, dq, 1.f, b, h, row0, p.Sq, p.H, g, t);
}

// dK and dV for one 64-row key tile (grid: key tiles x H x B), walking the
// query tiles from the first that sees a key of the tile (the causal start)
// to Sq.  Per query tile: P^T = exp(scale S^T - lse), dV += P^T dO, dP^T =
// V dO^T, dS^T = P^T (dP^T - dsum) times scale, rounded to bf16, dK +=
// dS^T Q.  The encoder reference takes P in f32 for dV, so P is split into
// two bf16 parts and the dV product runs twice.  Each block owns its keys'
// dK and dV, so no atomics are needed and every run gives the same bits.
template <int D>
__global__ void __launch_bounds__(kThreads) dkv_kernel(Grad p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem<D>& sm = *reinterpret_cast<BwdSmem<D>*>(smem_raw);
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kBK, key0 = k0 + 16 * warp;
  const size_t stat0 = (size_t)(b * p.H + h) * p.Sq;
  const bool drop = p.seed != nullptr;
  const uint2 key = drop ? philox::key(p.seed) : make_uint2(0u, 0u);

  stage_rows<D>(sm.x1, p.k, b, h, k0, p.Sk, p.H, tid);
  stage_rows<D>(sm.x2, p.v, b, h, k0, p.Sk, p.H, tid);
  const __nv_bfloat16* xk = &sm.x1[16 * warp][0];
  const __nv_bfloat16* xv = &sm.x2[16 * warp][0];
  const int qstart = p.causal ? max(0, k0 - (p.Sk - p.Sq)) / kBK * kBK : 0;

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dn][e] = dv[dn][e] = 0.f;
  for (int qb = qstart; qb < p.Sq; qb += kBK) {
    __syncthreads();
    stage_rows<D>(sm.y1, p.q, b, h, qb, p.Sq, p.H, tid);
    stage_rows<D>(sm.y2, p.dO, b, h, qb, p.Sq, p.H, tid);
    if (tid < kBK) {
      const int q = qb + tid;
      sm.lse[tid] = q < p.Sq ? p.lse[stat0 + q] : 0.f;
      sm.dsum[tid] = q < p.Sq ? p.dsum[stat0 + q] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      float s[2][4], dp[2][4];
      xyt_chunk<D>(s, xk, &sm.y1[0][0], kk, g, t);
      xyt_chunk<D>(dp, xv, &sm.y2[0][0], kk, g, t);
      const uint32_t keep =
          drop ? keep_pair_t(key, b * p.H + h, qb + 16 * kk, key0, g, t, p.thresh) : 0u;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 16 * kk + 8 * j + 2 * t + (e & 1);
          const float pr = visible(p, qb + qi, key0 + g + 8 * (e >> 1))
                               ? __expf(s[j][e] * p.scale - sm.lse[qi])
                               : 0.f;
          if (drop) {  // P_d for dV; the masked dP for dS
            const bool kept = (keep >> (4 * j + e)) & 1;
            const float ds = pr * ((kept ? dp[j][e] * p.inv_keep : 0.f) - sm.dsum[qi]);
            s[j][e] = kept ? pr * p.inv_keep : 0.f;
            dp[j][e] = ds * p.scale;
          } else {
            const float ds = pr * (dp[j][e] - sm.dsum[qi]);
            s[j][e] = pr;
            dp[j][e] = ds * p.scale;
          }
        }
      uint32_t a[4], lo[4];
      chunk_a_split(a, lo, s);
      ay<D>(dv, lo, &sm.y2[0][0], kk, lane);
      ay<D>(dv, a, &sm.y2[0][0], kk, lane);
      chunk_a(a, dp);
      ay<D>(dk, a, &sm.y1[0][0], kk, lane);
    }
  }
  store_rows<D>(p.dk, dk, 1.f, b, h, key0, p.Sk, p.H, g, t);
  store_rows<D>(p.dv, dv, 1.f, b, h, key0, p.Sk, p.H, g, t);
}

// Launch kernel<<<grid, kThreads, sizeof(BwdSmem<D>)>>> after raising its
// dynamic shared memory limit (70,144 bytes at D = 128, above the default
// 48 KB); returns the launch's error.
template <typename K>
inline cudaError_t launch_bwd(K kernel, dim3 grid, size_t smem, cudaStream_t st,
                              const Grad& p) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

inline bool bad_shape(int B, int H, int Sq, int Sk, int causal) {
  return B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || (causal && Sq > Sk) || H > 65535 ||
         B > 65535;
}

}  // namespace mma_attention
