// adam: the fused mixed-precision Adam update of one parameter leaf.
//
// A port kernel with no TPU counterpart: the reference updates the
// optimizer state with XLA's fused elementwise code. Per element, with
// the scalars scale, lr, b1c = 1 - b1^t and b2c = 1 - b2^t read from
// device memory (0-d f32 tensors: no host sync) and the constants
// b1, 1 - b1, b2, 1 - b2, eps, weight_decay rounded to f32 by the caller:
//   g  = f32(grad) * scale
//   m  = m * b1 + (1 - b1) * g
//   v  = v * b2 + (1 - b2) * (g * g)
//   u  = (m / b1c) / (sqrt(v / b2c) + eps)
//   w  = w - lr * (u + weight_decay * w)        (the f32 master)
//   p  = bf16(w)                                (round to nearest even)
// bit for bit the plain per-leaf arithmetic of repro_torch.optim.adam
// (kernels/ref.py adam_plain) as PyTorch runs it on the card: each
// operation is one IEEE f32 rounding (__fmul_rn, __fadd_rn, __fdiv_rn,
// __fsqrt_rn, never contracted into an FMA), as each of PyTorch's
// separate elementwise kernels rounds its result; the bf16 copy is
// __float2bfloat16_rn, which c10::BFloat16 uses on sm_80 and later.
//
// Bound: bytes. Per element it reads grad (4 B, or 2 B at gas 1), the
// master, m and v, and writes the master, m, v and the bf16 weight:
// 30 B (28 B with a bf16 grad), against ~20 flops. Design: one thread
// per 8-element vector (two 16-byte loads of each f32 array, one of a
// bf16 array, a 16-byte store of the bf16 weight) and as many blocks of
// 256 as the leaf needs; a scalar loop takes the tail of a length that is
// not a multiple of 8, and the whole leaf when a pointer is not 16-byte
// aligned. A grid of as many blocks ran at 85 % of the bound on the
// H100 where one resident wave looping over the leaf ran at 79 %. Both
// loops stride by the grid, so any length is covered. The kernel
// allocates nothing and runs on the caller's stream.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;          // elements per thread per vector step
constexpr int64_t kMaxBlocks = 0x7fffffff;   // the grid's x limit

// gradient dtype codes shared with the Python wrapper
enum GradType { kF32 = 0, kBF16 = 1 };

struct Consts {
  float b1, c1, b2, c2, eps, wd;  // c1 = 1 - b1, c2 = 1 - b2
};

struct Scalars {
  float scale, lr, b1c, b2c;
};

__device__ __forceinline__ float bf16_bits_to_f32(uint16_t b) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);   // exact
}

__device__ __forceinline__ uint16_t f32_to_bf16_bits(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

__device__ __forceinline__ void update(float g, float& w, float& m, float& v,
                                       const Consts& k, const Scalars& s) {
  g = __fmul_rn(g, s.scale);
  m = __fadd_rn(__fmul_rn(m, k.b1), __fmul_rn(k.c1, g));
  v = __fadd_rn(__fmul_rn(v, k.b2), __fmul_rn(k.c2, __fmul_rn(g, g)));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.b2c)), k.eps);
  const float u = __fdiv_rn(__fdiv_rn(m, s.b1c), den);
  w = __fsub_rn(w, __fmul_rn(s.lr, __fadd_rn(u, __fmul_rn(k.wd, w))));
}

__device__ __forceinline__ void load8(const float* p, float (&x)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float (&x)[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

template <int G> struct Grad;
template <> struct Grad<kF32> {
  using T = float;
  static __device__ __forceinline__ float one(const T* g, int64_t i) {
    return g[i];
  }
  static __device__ __forceinline__ void eight(const T* g, float (&x)[kVec]) {
    load8(g, x);
  }
};
template <> struct Grad<kBF16> {
  using T = uint16_t;
  static __device__ __forceinline__ float one(const T* g, int64_t i) {
    return bf16_bits_to_f32(g[i]);
  }
  static __device__ __forceinline__ void eight(const T* g, float (&x)[kVec]) {
    alignas(16) uint16_t in[kVec];
    *reinterpret_cast<uint4*>(in) = *reinterpret_cast<const uint4*>(g);
#pragma unroll
    for (int e = 0; e < kVec; ++e) x[e] = bf16_bits_to_f32(in[e]);
  }
};

template <int G, bool VEC>
__global__ void __launch_bounds__(kThreads)
adam_kernel(const void* __restrict__ grad, float* __restrict__ master,
            float* __restrict__ m, float* __restrict__ v,
            uint16_t* __restrict__ param, int64_t n,
            const float* __restrict__ scale, const float* __restrict__ lr,
            const float* __restrict__ b1c, const float* __restrict__ b2c,
            Consts k) {
  using T = typename Grad<G>::T;
  const T* gp = static_cast<const T*>(grad);
  const Scalars s{*scale, *lr, *b1c, *b2c};
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const int64_t nvec = VEC ? n / kVec : 0;
  for (int64_t i = tid; i < nvec; i += stride) {
    const int64_t e = i * kVec;
    float g[kVec], w[kVec], mm[kVec], vv[kVec];
    Grad<G>::eight(gp + e, g);
    load8(master + e, w);
    load8(m + e, mm);
    load8(v + e, vv);
    alignas(16) uint16_t out[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      update(g[j], w[j], mm[j], vv[j], k, s);
      out[j] = f32_to_bf16_bits(w[j]);
    }
    store8(master + e, w);
    store8(m + e, mm);
    store8(v + e, vv);
    *reinterpret_cast<uint4*>(param + e) = *reinterpret_cast<const uint4*>(out);
  }
  for (int64_t e = nvec * kVec + tid; e < n; e += stride) {
    float w = master[e], mm = m[e], vv = v[e];
    update(Grad<G>::one(gp, e), w, mm, vv, k, s);
    master[e] = w;
    m[e] = mm;
    v[e] = vv;
    param[e] = f32_to_bf16_bits(w);
  }
}

template <int G, bool VEC>
int launch(const void* grad, float* master, float* m, float* v,
           uint16_t* param, int64_t n, const float* scale, const float* lr,
           const float* b1c, const float* b2c, const Consts& k,
           cudaStream_t stream) {
  const int64_t items = VEC ? n / kVec + n % kVec : n;
  const int64_t blocks = (items + kThreads - 1) / kThreads;
  const unsigned grid = static_cast<unsigned>(
      blocks < kMaxBlocks ? blocks : kMaxBlocks);
  adam_kernel<G, VEC><<<grid, kThreads, 0, stream>>>(
      grad, master, m, v, param, n, scale, lr, b1c, b2c, k);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// C entry point (bound with ctypes): one leaf of n elements. grad holds
// grad_code's dtype; master, m and v are f32, param bf16, each
// contiguous; scale, lr, b1c and b2c point at one f32 each on the same
// device. The wrapper checks devices, dtypes, shapes and contiguity.
// Returns cudaGetLastError() after the launch (or cudaErrorInvalidValue
// for an unknown dtype code or an empty leaf).
extern "C" int adam_launch(const void* grad, int grad_code, void* master,
                           void* m, void* v, void* param, long long n,
                           const void* scale, const void* lr,
                           const void* b1c, const void* b2c, float b1,
                           float c1, float b2, float c2, float eps, float wd,
                           void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Consts k{b1, c1, b2, c2, eps, wd};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(master);
  float* mm = static_cast<float*>(m);
  float* vv = static_cast<float*>(v);
  uint16_t* p = static_cast<uint16_t*>(param);
  const float* sc = static_cast<const float*>(scale);
  const float* l = static_cast<const float*>(lr);
  const float* c1p = static_cast<const float*>(b1c);
  const float* c2p = static_cast<const float*>(b2c);
  const bool vec = aligned16(grad) && aligned16(master) && aligned16(m) &&
                   aligned16(v) && aligned16(param);
  switch (grad_code) {
    case kF32:
      return vec ? launch<kF32, true>(grad, w, mm, vv, p, n, sc, l, c1p, c2p, k, s)
                 : launch<kF32, false>(grad, w, mm, vv, p, n, sc, l, c1p, c2p, k, s);
    case kBF16:
      return vec ? launch<kBF16, true>(grad, w, mm, vv, p, n, sc, l, c1p, c2p, k, s)
                 : launch<kBF16, false>(grad, w, mm, vv, p, n, sc, l, c1p, c2p, k, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
