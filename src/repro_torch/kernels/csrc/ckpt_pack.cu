// ckpt_pack: checkpoint block pack + per-block abs-max (+ change mask),
// and the blockwise int8 quantizer built on the same abs-max.
//
// Replaces the TPU Pallas kernels in src/repro/kernels/ckpt_pack.py:
//   ckpt_pack_blocks        (_kernel)        -> MASK = false
//   ckpt_pack_dirty_blocks  (_dirty_kernel)  -> MASK = true
// One template over (in dtype, out dtype, identity pack, with mask).
// ckpt_quant_kernel (below) is ckpt_pack_blocks' quantize mode: its
// amax, then the host quantizer of src/repro/core/quant.py (_blockwise)
// on the card, so a quantized save moves int8 + scales, not a pack.
//
// Per row of an (n_rows, block) matrix:
//   y    = x                        (identity: same dtype and scale == 1;
//                                    a raw bit copy, NaN payloads kept)
//        = out(f32(x) * scale)      (otherwise; round to nearest even)
//   amax = max |f32(x) * scale|     (NaN propagates, like jnp.max)
//   mask = any bit of y differs from prev   (MASK only; compared on the
//                                    raw bits, so NaN and -0.0 are stable)
//
// Bound: bytes. The dirty pack reads x and prev and writes y: 3 bytes
// moved per byte of state and a handful of integer ops per element, far
// below the card's compute. At the H100's 3.35 TB/s a 23 GB training
// state (stablelm_1_6b with Adam) cannot be masked in less than about
// 20.6 ms per save. Design: one CUDA block per row, 256 threads,
// each thread moves 16-byte vectors (a 4096-byte dirty block is exactly
// one vector per thread), reduces its amax and differ flag in registers,
// then one warp-shuffle plus shared-memory reduction and a single store
// per row. The kernel allocates nothing and runs on the caller's stream.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// dtype codes shared with the Python wrapper
enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

template <int D> struct Bits;
template <> struct Bits<kF32> {
  using T = uint32_t;
  static __device__ __forceinline__ float to_f32(T b) { return __uint_as_float(b); }
  static __device__ __forceinline__ T from_f32(float f) { return __float_as_uint(f); }
};
template <> struct Bits<kBF16> {
  using T = uint16_t;
  static __device__ __forceinline__ float to_f32(T b) {
    return __uint_as_float(static_cast<uint32_t>(b) << 16);   // exact
  }
  static __device__ __forceinline__ T from_f32(float f) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
};
template <> struct Bits<kF16> {
  using T = uint16_t;
  static __device__ __forceinline__ float to_f32(T b) {
    return __half2float(__ushort_as_half(b));
  }
  static __device__ __forceinline__ T from_f32(float f) {
    return __half_as_ushort(__float2half_rn(f));
  }
};

// NaN-propagating max (fmaxf would drop a NaN)
__device__ __forceinline__ float nanmax(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}

// copy N bytes between 16-byte aligned locations as wide words
template <int N>
__device__ __forceinline__ void copy_vec(void* dst, const void* src) {
  static_assert(N == 8 || N == 16 || N == 32, "vector width");
  if constexpr (N == 8) {
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
  } else {
    #pragma unroll
    for (int k = 0; k < N / 16; ++k)
      reinterpret_cast<uint4*>(dst)[k] = reinterpret_cast<const uint4*>(src)[k];
  }
}

template <int DIN, int DOUT, bool IDENT, bool MASK>
__global__ void __launch_bounds__(kThreads)
ckpt_pack_kernel(const void* __restrict__ x, const void* __restrict__ prev,
                 void* __restrict__ y, float* __restrict__ amax,
                 int32_t* __restrict__ mask, int64_t block, float scale) {
  using TI = typename Bits<DIN>::T;
  using TO = typename Bits<DOUT>::T;
  constexpr int VEC = 16 / sizeof(TI);            // elements per 16-byte load
  constexpr int OUT_BYTES = VEC * sizeof(TO);
  static_assert(!IDENT || DIN == DOUT, "identity pack needs one dtype");

  const int64_t row = blockIdx.x;
  const TI* xr = static_cast<const TI*>(x) + row * block;
  TO* yr = static_cast<TO*>(y) + row * block;
  const TO* pr = MASK ? static_cast<const TO*>(prev) + row * block : nullptr;

  float m = 0.0f;
  int differ = 0;
  for (int64_t i = static_cast<int64_t>(threadIdx.x) * VEC; i < block;
       i += static_cast<int64_t>(kThreads) * VEC) {
    alignas(16) TI in[VEC];
    alignas(16) TO out[VEC];
    *reinterpret_cast<uint4*>(in) = *reinterpret_cast<const uint4*>(xr + i);
    #pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float f = Bits<DIN>::to_f32(in[k]) * scale;
      m = nanmax(m, fabsf(f));
      if constexpr (IDENT) {
        out[k] = static_cast<TO>(in[k]);
      } else {
        out[k] = Bits<DOUT>::from_f32(f);
      }
    }
    copy_vec<OUT_BYTES>(yr + i, out);
    if constexpr (MASK) {
      alignas(16) TO old[VEC];
      copy_vec<OUT_BYTES>(old, pr + i);
      #pragma unroll
      for (int k = 0; k < VEC; ++k) differ |= (out[k] != old[k]);
    }
  }

  // row reduction: warp shuffle, then one value per warp in shared memory
  #pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m = nanmax(m, __shfl_xor_sync(0xffffffffu, m, off));
    if constexpr (MASK) differ |= __shfl_xor_sync(0xffffffffu, differ, off);
  }
  __shared__ float s_m[kThreads / 32];
  __shared__ int s_d[kThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_m[warp] = m;
    s_d[warp] = differ;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float r = s_m[0];
    int d = s_d[0];
    #pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) {
      r = nanmax(r, s_m[w]);
      d |= s_d[w];
    }
    amax[row] = r;
    if constexpr (MASK) mask[row] = d ? 1 : 0;
  }
}

template <int DIN, int DOUT, bool IDENT, bool MASK>
void launch(const void* x, const void* prev, void* y, float* amax,
            int32_t* mask, int64_t n_rows, int64_t block, float scale,
            cudaStream_t stream) {
  ckpt_pack_kernel<DIN, DOUT, IDENT, MASK>
      <<<static_cast<unsigned>(n_rows), kThreads, 0, stream>>>(
          x, prev, y, amax, mask, block, scale);
}

template <int DIN, int DOUT>
void launch_mode(bool identity, bool with_mask, const void* x,
                 const void* prev, void* y, float* amax, int32_t* mask,
                 int64_t n_rows, int64_t block, float scale,
                 cudaStream_t stream) {
  if constexpr (DIN == DOUT) {
    if (identity) {
      if (with_mask)
        launch<DIN, DOUT, true, true>(x, prev, y, amax, mask, n_rows, block, scale, stream);
      else
        launch<DIN, DOUT, true, false>(x, prev, y, amax, mask, n_rows, block, scale, stream);
      return;
    }
  }
  if (with_mask)
    launch<DIN, DOUT, false, true>(x, prev, y, amax, mask, n_rows, block, scale, stream);
  else
    launch<DIN, DOUT, false, false>(x, prev, y, amax, mask, n_rows, block, scale, stream);
}

template <int DIN>
bool dispatch_out(int out_code, bool identity, bool with_mask, const void* x,
                  const void* prev, void* y, float* amax, int32_t* mask,
                  int64_t n_rows, int64_t block, float scale,
                  cudaStream_t stream) {
  switch (out_code) {
    case kF32: launch_mode<DIN, kF32>(identity, with_mask, x, prev, y, amax, mask, n_rows, block, scale, stream); return true;
    case kBF16: launch_mode<DIN, kBF16>(identity, with_mask, x, prev, y, amax, mask, n_rows, block, scale, stream); return true;
    case kF16: launch_mode<DIN, kF16>(identity, with_mask, x, prev, y, amax, mask, n_rows, block, scale, stream); return true;
  }
  return false;
}

// ---- quantize mode -------------------------------------------------
//
// Per row of the flat input x (n elements) cut into rows of `block`,
// the last row zero-padded (the rows ops.to_blocks makes):
//   amax  = max |f32(x)|                     (NaN propagates)
//   scale = amax > 0 ? amax / 127 : 1        (a NaN amax gives 1)
//   q     = int8(clamp(rint(f32(x) / scale), -127, 127))
// bit for bit the reference's _blockwise: an IEEE f32 divide
// (__fdiv_rn, never x * (1/scale), which is one ulp away on some
// inputs and flips a rounding), rintf (half to even, as np.round; not
// roundf), then the clip. The int8 of a NaN element is undefined, as
// in the reference. Bound: bytes. It reads x once and writes n + 4 per
// row; no pack. Design: one CUDA block per row, 256 threads; the row
// stays in registers (at most kQuantMaxBlock elements, 16 a thread, in
// 16-byte vectors, neighbouring threads on neighbouring vectors) across
// the amax pass and the quantize pass; one warp-shuffle + shared-memory
// reduction broadcasts the scale.
constexpr int kQuantMaxBlock = 4096;

template <int DIN>
__global__ void __launch_bounds__(kThreads)
ckpt_quant_kernel(const void* __restrict__ x, int8_t* __restrict__ q,
                  float* __restrict__ scale, int64_t n, int64_t block) {
  using TI = typename Bits<DIN>::T;
  constexpr int VEC = 16 / sizeof(TI);                 // elements per load
  constexpr int ITERS = kQuantMaxBlock / (kThreads * VEC);
  static_assert(ITERS * kThreads * VEC == kQuantMaxBlock, "row tiling");

  const int64_t base = static_cast<int64_t>(blockIdx.x) * block;
  const TI* xr = static_cast<const TI*>(x) + base;
  const int64_t valid = n - base < block ? n - base : block;  // in x

  float v[ITERS][VEC];
  float m = 0.0f;
  #pragma unroll
  for (int k = 0; k < ITERS; ++k) {
    const int64_t i = (static_cast<int64_t>(k) * kThreads + threadIdx.x) * VEC;
    if (i + VEC <= valid) {
      alignas(16) TI in[VEC];
      *reinterpret_cast<uint4*>(in) = *reinterpret_cast<const uint4*>(xr + i);
      #pragma unroll
      for (int e = 0; e < VEC; ++e) v[k][e] = Bits<DIN>::to_f32(in[e]);
    } else {                                 // ragged tail, then padding
      #pragma unroll
      for (int e = 0; e < VEC; ++e)
        v[k][e] = i + e < valid ? Bits<DIN>::to_f32(xr[i + e]) : 0.0f;
    }
    #pragma unroll
    for (int e = 0; e < VEC; ++e) m = nanmax(m, fabsf(v[k][e]));
  }

  #pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = nanmax(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ float s_m[kThreads / 32];
  __shared__ float s_scale;
  if (threadIdx.x % 32 == 0) s_m[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float r = s_m[0];
    #pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) r = nanmax(r, s_m[w]);
    const float s = r > 0.0f ? __fdiv_rn(r, 127.0f) : 1.0f;
    s_scale = s;
    scale[blockIdx.x] = s;
  }
  __syncthreads();
  const float s = s_scale;

  int8_t* qr = q + base;
  #pragma unroll
  for (int k = 0; k < ITERS; ++k) {
    const int64_t i = (static_cast<int64_t>(k) * kThreads + threadIdx.x) * VEC;
    if (i >= valid) continue;
    alignas(8) int8_t out[VEC];
    #pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float t = rintf(__fdiv_rn(v[k][e], s));
      out[e] = static_cast<int8_t>(
          static_cast<int>(fminf(fmaxf(t, -127.0f), 127.0f)));
    }
    if (i + VEC <= valid) {
      if constexpr (VEC == 8)
        *reinterpret_cast<uint2*>(qr + i) = *reinterpret_cast<const uint2*>(out);
      else
        *reinterpret_cast<uint32_t*>(qr + i) =
            *reinterpret_cast<const uint32_t*>(out);
    } else {
      for (int e = 0; e < VEC && i + e < valid; ++e) qr[i + e] = out[e];
    }
  }
}

}  // namespace

// C entry point of the quantize mode (bound with ctypes): x holds n
// elements of in_code's dtype, 16-byte aligned; q (n int8) and scale
// (ceil(n / block) f32) are the wrapper's. block must be a multiple of
// 8 elements and at most kQuantMaxBlock. Returns cudaGetLastError()
// after the launch (or cudaErrorInvalidValue for bad arguments).
extern "C" int ckpt_quant_launch(const void* x, void* q, void* scale,
                                 long long n, long long block, int in_code,
                                 void* stream) {
  const long long n_rows = block > 0 ? (n + block - 1) / block : 0;
  if (n <= 0 || block <= 0 || block % 8 != 0 || block > kQuantMaxBlock ||
      n_rows > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* qo = static_cast<int8_t*>(q);
  float* so = static_cast<float*>(scale);
  const unsigned grid = static_cast<unsigned>(n_rows);
  switch (in_code) {
    case kF32: ckpt_quant_kernel<kF32><<<grid, kThreads, 0, s>>>(x, qo, so, n, block); break;
    case kBF16: ckpt_quant_kernel<kBF16><<<grid, kThreads, 0, s>>>(x, qo, so, n, block); break;
    case kF16: ckpt_quant_kernel<kF16><<<grid, kThreads, 0, s>>>(x, qo, so, n, block); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// C entry point (bound with ctypes). prev/mask are ignored unless
// with_mask; identity requires in_code == out_code. The wrapper checks
// shapes, contiguity and 16-byte alignment; block must be a multiple of
// 8 elements. Returns cudaGetLastError() after the launch (or
// cudaErrorInvalidValue for an unknown dtype code / empty grid).
extern "C" int ckpt_pack_launch(const void* x, const void* prev, void* y,
                                void* amax, void* mask, long long n_rows,
                                long long block, int in_code, int out_code,
                                int identity, int with_mask, float scale,
                                void* stream) {
  if (n_rows <= 0 || n_rows > 0x7fffffffLL || block <= 0 || block % 8 != 0 ||
      (identity && in_code != out_code))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* a = static_cast<float*>(amax);
  int32_t* mk = static_cast<int32_t*>(mask);
  bool ok = false;
  switch (in_code) {
    case kF32: ok = dispatch_out<kF32>(out_code, identity, with_mask, x, prev, y, a, mk, n_rows, block, scale, s); break;
    case kBF16: ok = dispatch_out<kBF16>(out_code, identity, with_mask, x, prev, y, a, mk, n_rows, block, scale, s); break;
    case kF16: ok = dispatch_out<kF16>(out_code, identity, with_mask, x, prev, y, a, mk, n_rows, block, scale, s); break;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
