// Fused Adam / AdamW update for Hopper (sm_90a): one launch updates every
// parameter of a group (one element type, one decay mode) in place.
//
// Replaces no TPU kernel.  The reference updates each parameter with jnp
// code (paddle_tpu/optimizer/optimizer.py: Optimizer._apply_update around
// Adam._update_rule) that XLA fuses into its one jitted train step.  The
// port's eager counterpart is that chain as torch ops, a dozen elementwise
// kernels a parameter (ops/fused_adam.py adam_update_dense, the plain
// version); this kernel is the fusion.
//
// What it computes, for each element, in the chain's order and with its
// roundings (T the parameter's type; r() rounds an f32 value to T, the
// identity at float32; every f32 operation is one IEEE-rounded __f*_rn
// intrinsic, so that nvcc contracts no pair into an FMA the chain lacks):
//   g  = r(g + r(coeff_T p))                         L2 decay (Adam), coeff != 0
//   m  = r(r(b1 m) + r((1 - b1) g))                  b1, 1 - b1, b2, 1 - b2, eps
//   v  = r(r(b2 v) + r((1 - b2) r(g g)))             rounded to T first, as JAX
//   b1p' = b1p * f32(b1), b2p' = b2p * f32(b2)       (f32 scalars per parameter)
//   mhat = r(m / r(1 - b1p')), vhat = r(v / r(1 - b2p'))
//   p' = p - (lr mhat) / r(r(sqrt(vhat)) + eps)      in f32
//   p' = p' - (lr coeff) p                           decoupled decay (AdamW), coeff != 0
// then p, m and v are stored as T.  At bf16, r(0.999) = 1.0: the second
// moment decays by 1, as the chain's _like makes it (optimizer.py).
//
// How it walks.  The launch's parameters are a table passed by value (one
// 64-byte entry each: the five tensors' pointers, the element count, the
// decay coefficient, whether all four tensors are 16-byte aligned) with
// each parameter's first block; a block binary-searches its parameter and
// takes 256 threads x 4 pieces of 16 bytes of it (4096 f32 or 8192 16-bit
// elements), reading p, g, m and v once with 16-byte loads where aligned,
// writing p, m and v.  A table in the kernel's parameters (up to 32,764
// bytes since CUDA 12.1) needs no upload, so a captured graph replays it
// as it is.
//
// The pows.  beta1_pow and beta2_pow are one f32 scalar each per
// parameter, read by every block of it; a block that wrote the new pow
// could race a block that has not read the old one yet.  So thread 0 of
// each block reads the old pows, fences, and takes a ticket (an atomicAdd
// on the parameter's counter); only the block that takes the last ticket,
// after every other block has read, writes the new pows, and it resets the
// counter to 0 for the next launch on the stream (one counter buffer a
// stream, ops/fused_adam.py _tickets).
//
// Bound: bytes.  Four tensors read and three written, 14 bytes a bf16
// parameter and 28 a float32 one: 3.1 and 6.2 ms for the 738.3 M
// parameters of the LLaMA training configuration at 3.35 TB/s.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;         // 16-byte pieces of each tensor a thread takes
constexpr int kMaxParams = 384;   // ops/fused_adam.py MAX_PARAMS

struct Entry {
  void* p;
  const void* g;
  void* m;
  void* v;
  float* pow1;
  float* pow2;
  long long n;
  float coeff;  // L2: coeff rounded to T; decoupled: f32(coeff); 0: no decay
  int vec;      // p, g, m and v all 16-byte aligned
};

struct Table {
  Entry e[kMaxParams];
  int first[kMaxParams + 1];  // each parameter's first block; first[count] = the grid
  int count;
  int decoupled;
  const float* lr;
  unsigned* tickets;
  float b1, omb1, b2, omb2, eps;  // rounded to T
  float b1f, b2f;                 // f32(beta1), f32(beta2): the pows' factors
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) { return __float2half_rn(x); }

// r(): an f32 value rounded to T, back in f32
template <typename T>
__device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

struct Consts {
  float b1, omb1, b2, omb2, eps, d1, d2, lr, lrc, coeff;
  bool l2, decoupled;
};

template <typename T>
__device__ __forceinline__ void adam_elem(T& p, T g_in, T& m, T& v, const Consts& c) {
  const float pf = to_f(p);
  float g = to_f(g_in);
  if (c.l2) g = rnd<T>(__fadd_rn(g, rnd<T>(__fmul_rn(c.coeff, pf))));
  const float mf =
      rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(c.b1, to_f(m))), rnd<T>(__fmul_rn(c.omb1, g))));
  const float sq = rnd<T>(__fmul_rn(g, g));
  const float vf =
      rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(c.b2, to_f(v))), rnd<T>(__fmul_rn(c.omb2, sq))));
  const float mhat = rnd<T>(__fdiv_rn(mf, c.d1));
  const float vhat = rnd<T>(__fdiv_rn(vf, c.d2));
  const float den = rnd<T>(__fadd_rn(rnd<T>(__fsqrt_rn(vhat)), c.eps));
  float np = __fsub_rn(pf, __fdiv_rn(__fmul_rn(c.lr, mhat), den));
  if (c.decoupled) np = __fsub_rn(np, __fmul_rn(c.lrc, pf));
  p = from_f<T>(np);
  m = from_f<T>(mf);
  v = from_f<T>(vf);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) fused_adam_kernel(const __grid_constant__ Table t) {
  constexpr int kVec = 16 / sizeof(T);
  __shared__ float pows[2];
  const int b = blockIdx.x;
  int lo = 0, hi = t.count - 1;  // this block's parameter: the last i with first[i] <= b
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.first[mid] <= b) lo = mid; else hi = mid - 1;
  }
  const Entry& e = t.e[lo];
  if (threadIdx.x == 0) {
    const float p1 = __ldcg(e.pow1), p2 = __ldcg(e.pow2);
    pows[0] = p1, pows[1] = p2;
    __threadfence();  // the reads above before the ticket
    const unsigned blocks = (unsigned)(t.first[lo + 1] - t.first[lo]);
    if (atomicAdd(&t.tickets[lo], 1u) == blocks - 1) {  // every block has read: the last writes
      *e.pow1 = __fmul_rn(p1, t.b1f);
      *e.pow2 = __fmul_rn(p2, t.b2f);
      t.tickets[lo] = 0;
    }
  }
  __syncthreads();
  Consts c;
  c.b1 = t.b1, c.omb1 = t.omb1, c.b2 = t.b2, c.omb2 = t.omb2, c.eps = t.eps;
  c.d1 = rnd<T>(__fsub_rn(1.f, __fmul_rn(pows[0], t.b1f)));
  c.d2 = rnd<T>(__fsub_rn(1.f, __fmul_rn(pows[1], t.b2f)));
  c.lr = __ldg(t.lr);
  c.coeff = e.coeff;
  c.l2 = !t.decoupled && e.coeff != 0.f;
  c.decoupled = t.decoupled && e.coeff != 0.f;
  c.lrc = __fmul_rn(c.lr, e.coeff);
  T* p = static_cast<T*>(e.p);
  const T* g = static_cast<const T*>(e.g);
  T* m = static_cast<T*>(e.m);
  T* v = static_cast<T*>(e.v);
  const long long base = (long long)(b - t.first[lo]) * (kThreads * kItems * kVec);
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const long long j = base + ((long long)it * kThreads + threadIdx.x) * kVec;
    if (j >= e.n) break;
    if (e.vec && j + kVec <= e.n) {
      uint4 rp = *reinterpret_cast<const uint4*>(p + j);
      const uint4 rg = __ldg(reinterpret_cast<const uint4*>(g + j));
      uint4 rm = *reinterpret_cast<const uint4*>(m + j);
      uint4 rv = *reinterpret_cast<const uint4*>(v + j);
      T* tp = reinterpret_cast<T*>(&rp);
      const T* tg = reinterpret_cast<const T*>(&rg);
      T* tm = reinterpret_cast<T*>(&rm);
      T* tv = reinterpret_cast<T*>(&rv);
#pragma unroll
      for (int k = 0; k < kVec; ++k) adam_elem<T>(tp[k], tg[k], tm[k], tv[k], c);
      *reinterpret_cast<uint4*>(p + j) = rp;
      *reinterpret_cast<uint4*>(m + j) = rm;
      *reinterpret_cast<uint4*>(v + j) = rv;
    } else {
      const long long end = j + kVec < e.n ? j + kVec : e.n;
      for (long long k = j; k < end; ++k) adam_elem<T>(p[k], g[k], m[k], v[k], c);
    }
  }
}

template <typename T>
cudaError_t run(Table& t, const long long* numel, cudaStream_t st) {
  constexpr long long kPerBlock = (long long)kThreads * kItems * (16 / sizeof(T));
  long long blocks = 0;
  for (int i = 0; i < t.count; ++i) {
    t.first[i] = (int)blocks;
    const long long nb = (numel[i] + kPerBlock - 1) / kPerBlock;
    blocks += nb > 0 ? nb : 1;  // an empty parameter still advances its pows
    if (blocks > 0x7fffffffll) return cudaErrorInvalidValue;
  }
  t.first[t.count] = (int)blocks;
  fused_adam_kernel<T><<<(unsigned)blocks, kThreads, 0, st>>>(t);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface (bound with ctypes).  Returns a cudaError_t: 0 on a
// clean launch.  type: 0 float32, 1 bf16, 2 float16 (ops/fused_adam.py
// TYPE_CODES); count parameters, at most kMaxParams; ptrs: count rows of
// (p, g, m, v, beta1_pow, beta2_pow) device pointers, p, g, m and v
// contiguous of that type with numel[i] elements each, the pows f32
// scalars; coeff: each parameter's decay coefficient as the mode uses it
// (L2: rounded to the type; decoupled: f32; 0 for none); lr: a device f32
// scalar; b1, omb1, b2, omb2 and eps rounded to the type; b1f, b2f the
// betas in f32; tickets: count zeroed uint32 counters on the device, zero
// again after the launch.
extern "C" int fused_adam_launch(int type, int count, const long long* ptrs,
                                 const long long* numel, const float* coeff, const void* lr,
                                 float b1, float omb1, float b2, float omb2, float eps, float b1f,
                                 float b2f, int decoupled, void* tickets, void* stream) {
  if (count <= 0 || count > kMaxParams || lr == nullptr || tickets == nullptr)
    return (int)cudaErrorInvalidValue;
  static thread_local Table t;
  t.count = count, t.decoupled = decoupled;
  t.lr = static_cast<const float*>(lr), t.tickets = static_cast<unsigned*>(tickets);
  t.b1 = b1, t.omb1 = omb1, t.b2 = b2, t.omb2 = omb2, t.eps = eps, t.b1f = b1f, t.b2f = b2f;
  for (int i = 0; i < count; ++i) {
    const long long* r = ptrs + 6 * i;
    Entry& e = t.e[i];
    e.p = reinterpret_cast<void*>(r[0]);
    e.g = reinterpret_cast<const void*>(r[1]);
    e.m = reinterpret_cast<void*>(r[2]);
    e.v = reinterpret_cast<void*>(r[3]);
    e.pow1 = reinterpret_cast<float*>(r[4]);
    e.pow2 = reinterpret_cast<float*>(r[5]);
    e.n = numel[i];
    e.coeff = coeff[i];
    e.vec = ((r[0] | r[1] | r[2] | r[3]) & 15) == 0;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (type == 0) return (int)run<float>(t, numel, st);
  if (type == 1) return (int)run<__nv_bfloat16>(t, numel, st);
  if (type == 2) return (int)run<__half>(t, numel, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* fused_adam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
