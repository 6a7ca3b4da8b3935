// flash_attention: blocked attention with an online softmax.
//
// Replaces the TPU Pallas kernel src/repro/kernels/flash_attention.py
// (flash_attention, body _kernel). q (B, H, Lq, hd); k, v (B, KV, Lk, hd)
// with GQA (kv head = h / (H / KV)); out like q. Optional causal mask,
// sliding window (q - k < window) and soft-cap cap * tanh(s / cap).
// The arithmetic is the Pallas kernel's: q, k and v are read as f32,
// scores, the running max, sum and accumulator are f32, p stays f32
// against an f32 v, masked logits are -1e30 (not -inf: a row that has
// seen no valid key yet gets p = 1 for its masked keys, which the first
// valid key rescales away with alpha = exp(-1e30 - m) = 0, where -inf
// would give NaN), and out = acc / max(l, 1e-30). All math is IEEE f32
// (expf, tanhf; no fast math, no TF32), for the reference's 2e-5.
//
// Layout on Hopper: the TPU kernel carries (m, l, acc) in scratch across
// an ordered grid axis over K blocks. Blocks here run in no order, so one
// block owns a (b, h, 64-row q tile) and loops over the 64-key K/V tiles
// itself, (m, l, acc) in registers. 256 threads: thread (ty, tx) =
// (tid / 16, tid % 16) owns rows ty + 16 i and, for the scores, keys
// tx + 16 j (i, j < 4), for the output columns tx + 16 j (j < hd / 16):
// 4 x 4 register tiles, so each value read from shared memory feeds 4
// FMAs. A row's 16 threads are one half-warp: row max and sum are warp
// shuffles. Shared rows of q and k are padded to hd + 1 floats so the
// column walks are free of bank conflicts. Keys >= Lk are masked in the
// kernel (zero-filled tiles, p = 0); nothing is padded on the host.
// Causal without a window: K tiles wholly above the diagonal are skipped.
// That is exact: key 0 is valid for every row, so the row max is a real
// logit from the first tile on and a skipped key's p would be exactly
// exp(-1e30 - m) = 0. With a window every tile is visited, so a row with
// no valid key at all averages v over the Lk keys, as the reference's
// flash_attention_ref does.
//
// Bound at the path's shape (stablelm_1_6b, (4, 32, 512, 64) bf16,
// causal): 33.6 MB of q, k, v and out = 10.0 us at 3.35 TB/s, against
// 4.3 GFLOP = 4.3 us at the bf16 tensor-core rate: bytes. This first
// version runs on the f32 FMA units and is bound by shared-memory loads
// (one 4-byte load per 2 FMAs); tensor cores (wgmma) are a later step.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // q rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;
constexpr float kMask = -1e30f;  // the reference's NEG_INF

// dtype codes shared with the Python wrapper
enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Strides { long long b, h, l; };   // in elements; hd is contiguous

struct Params {
  const void* q; const void* k; const void* v; void* o;
  Strides sq, sk, sv, so;
  int rep, Lq, Lk;
  float scale, cap;      // cap <= 0: no soft-cap
  int causal, window;    // window < 0: no window
};

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kBQ * (HD + 1) + kBK * (HD + 1) + kBK * HD + kBQ * (kBK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_kernel(const Params p) {
  extern __shared__ float smem[];
  constexpr int QS = HD + 1;       // padded row stride of Qs and Ks
  constexpr int PS = kBK + 1;      // padded row stride of Ps
  constexpr int NJ = HD / 16;      // output columns per thread
  float* Qs = smem;                // [kBQ][QS]
  float* Ks = Qs + kBQ * QS;       // [kBK][QS]
  float* Vs = Ks + kBK * QS;       // [kBK][HD]
  float* Ps = Vs + kBK * HD;       // [kBQ][PS]

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  // the last q tiles have the most keys under a causal mask: start them
  // first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / p.rep;
  const T* q = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* k = static_cast<const T*>(p.k) + b * p.sk.b + kvh * p.sk.h;
  const T* v = static_cast<const T*>(p.v) + b * p.sv.b + kvh * p.sv.h;
  T* o = static_cast<T*>(p.o) + b * p.so.b + h * p.so.h;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, qr = q0 + r;
    Qs[r * QS + d] = qr < p.Lq ? to_f32(q[qr * p.sq.l + d]) : 0.f;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMask;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int q_last = min(q0 + kBQ, p.Lq) - 1;
  int n_kt = (p.Lk + kBK - 1) / kBK;
  if (p.causal && p.window < 0) n_kt = min(n_kt, q_last / kBK + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();               // the last tile's Ks, Vs, Ps are read
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int r = i / HD, d = i % HD, kr = k0 + r;
      const bool in = kr < p.Lk;
      Ks[r * QS + d] = in ? to_f32(k[kr * p.sk.l + d]) : 0.f;
      Vs[r * HD + d] = in ? to_f32(v[kr * p.sv.l + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = Ks[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * p.scale;
        if (p.cap > 0.f) x = p.cap * tanhf(x / p.cap);
        const bool ok = (!p.causal || qpos >= kpos) &&
                        (p.window < 0 || qpos - kpos < p.window);
        x = ok ? x : kMask;
        s[i][j] = x;
        if (kpos < p.Lk) mt = fmaxf(mt, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      // every tile holds a key < Lk, so mt >= -1e30 and nothing is -inf
      const float mn = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - mn);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const float pe = kpos < p.Lk ? expf(s[i][j] - mn) : 0.f;
        Ps[(ty + 16 * i) * PS + tx + 16 * j] = pe;
        ps += pe;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * alpha + ps;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
      m[i] = mn;
    }
    // a row of Ps is written and read by the same half-warp
    __syncwarp();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], c[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Ps[(ty + 16 * i) * PS + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) c[j] = Vs[kk * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], c[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.Lq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      o[row * p.so.l + tx + 16 * j] = from_f32<T>(acc[i][j] / denom);
  }
}

template <typename T, int HD>
int launch(const Params& p, int B, int H, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((p.Lq + kBQ - 1) / kBQ, H, B);
  flash_kernel<T, HD><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const Params& p, int B, int H, cudaStream_t s) {
  switch (hd) {
    case 64: return launch<T, 64>(p, B, H, s);
    case 128: return launch<T, 128>(p, B, H, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C entry point (bound with ctypes). strides: 12 element strides, (b, h,
// l) of q, k, v and out in that order; the last dimension of each must be
// contiguous (the wrapper checks). window < 0: none; cap <= 0: none.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for arguments the kernel does not take.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      const long long* strides, int B, int H,
                                      int KV, int Lq, int Lk, int hd,
                                      int dtype, int causal, int window,
                                      float cap, float scale, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || H > 65535 || KV <= 0 || H % KV ||
      Lq <= 0 || Lk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.sq = {strides[0], strides[1], strides[2]};
  p.sk = {strides[3], strides[4], strides[5]};
  p.sv = {strides[6], strides[7], strides[8]};
  p.so = {strides[9], strides[10], strides[11]};
  p.rep = H / KV; p.Lq = Lq; p.Lk = Lk;
  p.scale = scale; p.cap = cap; p.causal = causal; p.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return dispatch_hd<float>(hd, p, B, H, s);
    case kBF16: return dispatch_hd<__nv_bfloat16>(hd, p, B, H, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
