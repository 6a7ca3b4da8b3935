// flash_attention: blocked attention with an online softmax.
//
// Replaces the TPU Pallas kernel src/repro/kernels/flash_attention.py
// (flash_attention, body _kernel). q (B, H, Lq, hd); k, v (B, KV, Lk, hd)
// with GQA (kv head = h / (H / KV)); out like q. Optional causal mask,
// sliding window (q - k < window) and soft-cap cap * tanh(s / cap).
// Common to both bodies below: scores, the running max, sum and
// accumulator are f32; masked logits are -1e30 (not -inf: a row that has
// seen no valid key yet gets p = 1 for its masked keys, which the first
// valid key rescales away with alpha = exp(-1e30 - m) = 0, where -inf
// would give NaN); out = acc / max(l, 1e-30); expf, exp2f and tanhf are
// IEEE (no fast math). The TPU kernel carries (m, l, acc) in scratch across an
// ordered grid axis over K blocks. Blocks here run in no order, so one
// block owns a (b, h, 64-row q tile) and loops over the 64-key K/V tiles
// itself, (m, l, acc) in registers. Keys >= Lk are masked in the kernel
// (zero-filled tiles, p = 0); nothing is padded on the host. Causal
// without a window: K tiles wholly above the diagonal are skipped. That
// is exact: key 0 is valid for every row, so the row max is a real logit
// from the first tile on and a skipped key's p would be exactly
// exp(-1e30 - m) = 0. With a window every tile is visited, so a row with
// no valid key at all averages v over the Lk keys, as the reference's
// flash_attention_ref does.
//
// Bound at the path's shape (stablelm_1_6b, (4, 32, 512, 64) bf16,
// causal): 33.6 MB of q, k, v and out = 10.0 us at 3.35 TB/s, against
// 4.3 GFLOP = 4.3 us at the bf16 tensor-core rate: bytes. f32 FMAs alone
// (67 TFLOP/s) would need 64 us, so only the tensor cores get near it.
//
// bf16 body (flash_tc_kernel), the path's: tensor cores through
// mma.sync.m16n8k16 (bf16 in, f32 accumulate). 128 threads, 4 warps, each
// owning 16 q rows. The Q tile and two stages of 64-key K/V tiles stay
// bf16 in shared memory, rows padded to hd + 8 elements (16 B apart mod
// 128 B) so ldmatrix reads them free of bank conflicts; K/V tile k+1 is
// brought in by cp.async (16 B a thread) while tile k computes. The
// strided (B, L, H, hd) views are read in place through their row
// strides. S = Q K^T: Q's fragments are loaded once (ldmatrix), K's by
// ldmatrix per k16 step, S (16 x 64 per warp) in f32 registers. bf16
// products are exact in f32, so this is the reference's f32 dot of
// upcast q and k, summed in another order. The softmax runs on the
// accumulator fragments: a row lives on one quad of threads, so its max
// and sum take two shuffles. O += P V: P is rounded to bf16 in registers
// (the accumulator layout of two adjacent n8 tiles is the A layout of
// one k16 step, so P never touches shared memory) and V is fed by
// ldmatrix.trans. That rounding is the one departure from the reference,
// which keeps p in f32: it adds at most 2^-9 relative per weight, below
// the bf16 output's own 2^-8 rounding, inside the bf16 tolerance 2e-2.
// The row sum l is taken over the f32 p. Why mma.sync and not wgmma/TMA:
// on the tensor cores this shape is bytes-bound (4.3 GFLOP is 13 us even
// at a third of the bf16 peak), so warpgroup MMA, TMA and warp
// specialisation would buy little for their complexity.
//
// f32 body (flash_kernel), for float32 inputs: the f32 tolerance (2e-5)
// rules out single-pass bf16 or TF32 products, so q, k and v are read as
// f32 and every product is an f32 FMA. 256 threads: thread (ty, tx) =
// (tid / 16, tid % 16) owns rows ty + 16 i and, for the scores, keys
// tx + 16 j (i, j < 4), for the output columns tx + 16 j (j < hd / 16):
// 4 x 4 register tiles, so each value read from shared memory feeds 4
// FMAs. A row's 16 threads are one half-warp: row max and sum are warp
// shuffles. Shared rows of q and k are padded to hd + 1 floats so the
// column walks are free of bank conflicts. It is bound by shared-memory
// loads (one 4-byte load per 2 FMAs).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // q rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;    // f32 body
constexpr int kTcThreads = 128;  // bf16 tensor-core body: 4 warps
constexpr float kMask = -1e30f;  // the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

// dtype codes shared with the Python wrapper
enum DType { kF32 = 0, kBF16 = 1 };

struct Strides { long long b, h, l; };   // in elements; hd is contiguous

struct Params {
  const void* q; const void* k; const void* v; void* o;
  Strides sq, sk, sv, so;
  int rep, Lq, Lk;
  float scale, cap;      // cap <= 0: no soft-cap
  int causal, window;    // window < 0: no window
};

// ------------------------------------------------------------ f32 body
template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kBQ * (HD + 1) + kBK * (HD + 1) + kBK * HD + kBQ * (kBK + 1));
}

template <int HD>
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
  const float* q = static_cast<const float*>(p.q) + b * p.sq.b + h * p.sq.h;
  const float* k =
      static_cast<const float*>(p.k) + b * p.sk.b + kvh * p.sk.h;
  const float* v =
      static_cast<const float*>(p.v) + b * p.sv.b + kvh * p.sv.h;
  float* o = static_cast<float*>(p.o) + b * p.so.b + h * p.so.h;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, qr = q0 + r;
    Qs[r * QS + d] = qr < p.Lq ? q[qr * p.sq.l + d] : 0.f;
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
      Ks[r * QS + d] = in ? k[kr * p.sk.l + d] : 0.f;
      Vs[r * HD + d] = in ? v[kr * p.sv.l + d] : 0.f;
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
      o[row * p.so.l + tx + 16 * j] = acc[i][j] / denom;
  }
}

// ------------------------------------------------ bf16 tensor-core body
using bf16 = __nv_bfloat16;

template <int HD>
constexpr size_t tc_smem_bytes() {
  // Q tile, then two stages of K and V tiles; rows of HD + 8 elements
  return sizeof(bf16) * static_cast<size_t>(HD + 8) * (kBQ + 4 * kBK);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 b16 matrices; lanes 8i .. 8i + 7 address the rows of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)) : "memory");
}

// d += a (16 x 16, row) * b (16 x 8, col); bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// rows [r0, r0 + 64) of a (rows, HD) bf16 matrix with row stride `ld`
// into a [64][HD + 8] tile: cp.async for rows < end, zeros past it
template <int HD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long ld, int r0, int end,
                                          int tid) {
  constexpr int CPR = HD / 8;      // 16-byte chunks per row
#pragma unroll
  for (int i = tid; i < kBK * CPR; i += kTcThreads) {
    const int r = i / CPR, c = (i % CPR) * 8;
    bf16* d = dst + r * (HD + 8) + c;
    if (r0 + r < end)
      cp_async16(d, src + (r0 + r) * ld + c);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads)
    flash_tc_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int RS = HD + 8;       // padded row stride (elements)
  constexpr int KS = HD / 16;      // k16 steps of Q K^T
  constexpr int NO = HD / 8;       // n8 tiles of the output
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [kBQ][RS]
  bf16* Ks = Qs + kBQ * RS;                       // [2][kBK][RS]
  bf16* Vs = Ks + 2 * kBK * RS;                   // [2][kBK][RS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;   // fragment row, column pair
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / p.rep;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.sq.b + h * p.sq.h;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.sk.b + kvh * p.sk.h;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.sv.b + kvh * p.sv.h;
  bf16* o = static_cast<bf16*>(p.o) + b * p.so.b + h * p.so.h;

  const int q_last = min(q0 + kBQ, p.Lq) - 1;
  int n_kt = (p.Lk + kBK - 1) / kBK;
  if (p.causal && p.window < 0) n_kt = min(n_kt, q_last / kBK + 1);

  load_tile<HD>(Qs, q, p.sq.l, q0, p.Lq, tid);
  load_tile<HD>(Ks, k, p.sk.l, 0, p.Lk, tid);
  load_tile<HD>(Vs, v, p.sv.l, 0, p.Lk, tid);
  cp_async_commit();

  // rows g and g + 8 of the warp's 16: running max, sum, accumulator
  float m[2] = {kMask, kMask}, l[2] = {0.f, 0.f}, acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  uint32_t qf[KS][4];

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_kt) {           // stage st ^ 1 was freed last iteration
      const int nxt = (st ^ 1) * kBK * RS;
      load_tile<HD>(Ks + nxt, k, p.sk.l, (kt + 1) * kBK, p.Lk, tid);
      load_tile<HD>(Vs + nxt, v, p.sv.l, (kt + 1) * kBK, p.Lk, tid);
      cp_async_commit();
      cp_async_wait<1>();          // tile kt (and Q) has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldsm_x4(qf[ks], Qs + (warp * 16 + (lane & 15)) * RS + ks * 16 +
                            (lane >> 4) * 8);
    }
    const bf16* Kt = Ks + st * kBK * RS;
    const bf16* Vt = Vs + st * kBK * RS;

    // S = Q K^T: n8 tile j holds keys 8j .. 8j + 7 of the tile
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {   // key tiles 2np and 2np + 1
        uint32_t kb[4];
        ldsm_x4(kb, Kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * RS +
                        ks * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[ks], kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qf[ks], kb[2], kb[3]);
      }
    }

    // online softmax; s[j][2r + e] is row g + 8r, key 8j + 2t + e. Each
    // step runs over all 32 values as straight-line code (a branch per
    // value would split the unrolled loop into blocks the scheduler
    // cannot interleave); the soft-cap and the masks branch once per tile.
    // Logits are kept in base 2 (times log2 e), so each weight is one
    // exp2f; the -1e30 mask keeps its meaning (exp2f(-1e30 - m) = 0, and
    // a row with no valid key still weighs its masked keys equally).
    const int k0 = kt * kBK;
    if (p.cap > 0.f) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = p.cap * tanhf(s[j][e] * p.scale / p.cap) * kLog2e;
    } else {
      const float scale2 = p.scale * kLog2e;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= scale2;
    }
    // masked logits are -1e30; keys >= Lk are -inf, out of the row max
    // (every tile holds a key < Lk, so the max stays >= -1e30) and
    // exp(-inf - m) = 0
    const int row0 = q0 + warp * 16 + g;
    if ((p.causal && k0 + kBK - 1 > q0 + warp * 16) || p.window >= 0 ||
        k0 + kBK > p.Lk) {                 // the same for the whole warp
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qpos = row0 + 8 * (e >> 1);
          const int kpos = k0 + 8 * j + 2 * t + (e & 1);
          const bool ok = (!p.causal || qpos >= kpos) &&
                          (p.window < 0 || qpos - kpos < p.window);
          s[j][e] = kpos >= p.Lk ? -INFINITY : ok ? s[j][e] : kMask;
        }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mt = s[0][2 * r];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mt = fmaxf(mt, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      // a row's 64 keys lie on the 4 threads of one quad
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float mn = fmaxf(m[r], mt);
      const float alpha = exp2f(m[r] - mn);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[j][2 * r + e] = exp2f(s[j][2 * r + e] - mn);
          ps += s[j][2 * r + e];
        }
      ps += __shfl_xor_sync(0xffffffffu, ps, 1);
      ps += __shfl_xor_sync(0xffffffffu, ps, 2);
      l[r] = l[r] * alpha + ps;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        acc[j][2 * r] *= alpha;
        acc[j][2 * r + 1] *= alpha;
      }
      m[r] = mn;
    }

    // O += P V: P's n8 tiles 2kk, 2kk + 1 are the A fragment of k16 step
    // kk, rounded to bf16
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {   // output tiles 2dp, 2dp + 1
        uint32_t vb[4];
        ldsm_x4_trans(vb, Vt + (kk * 16 + (lane & 7) +
                                ((lane >> 3) & 1) * 8) * RS +
                              dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], a, vb[0], vb[1]);
        mma_bf16(acc[2 * dp + 1], a, vb[2], vb[3]);
      }
    }
    __syncthreads();               // stage st is read: free for tile kt + 2
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= p.Lq) continue;
    // one reciprocal per row: within an f32 ulp of the division, far
    // below the bf16 output's rounding
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    bf16* orow = o + row * p.so.l + 2 * t;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
  }
}

template <typename Kernel>
int launch(Kernel kernel, size_t smem, int threads, const Params& p, int B,
           int H, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((p.Lq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_hd(int dtype, const Params& p, int B, int H, cudaStream_t s) {
  switch (dtype) {
    case kF32:
      return launch(flash_kernel<HD>, smem_bytes<HD>(), kThreads, p, B, H,
                    s);
    case kBF16:
      return launch(flash_tc_kernel<HD>, tc_smem_bytes<HD>(), kTcThreads, p,
                    B, H, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C entry point (bound with ctypes). strides: 12 element strides, (b, h,
// l) of q, k, v and out in that order; the last dimension of each must be
// contiguous and every row 16-byte aligned (the wrapper checks). window
// < 0: none; cap <= 0: none. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments the kernel does not
// take.
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
  switch (hd) {
    case 64: return launch_hd<64>(dtype, p, B, H, s);
    case 128: return launch_hd<128>(dtype, p, B, H, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory per block of the body that takes (hd, dtype), in
// bytes; -1 for arguments the kernel does not take.
extern "C" long long flash_attention_smem_bytes(int hd, int dtype) {
  size_t bytes = 0;
  if (dtype == kF32 && hd == 64) bytes = smem_bytes<64>();
  if (dtype == kF32 && hd == 128) bytes = smem_bytes<128>();
  if (dtype == kBF16 && hd == 64) bytes = tc_smem_bytes<64>();
  if (dtype == kBF16 && hd == 128) bytes = tc_smem_bytes<128>();
  return bytes ? static_cast<long long>(bytes) : -1;
}
