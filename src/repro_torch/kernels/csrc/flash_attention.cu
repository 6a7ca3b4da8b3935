// flash_attention: blocked attention with an online softmax.
//
// Replaces the TPU Pallas kernel src/repro/kernels/flash_attention.py
// (flash_attention, body _kernel). q (B, H, Lq, hd); k, v (B, KV, Lk, hd)
// with GQA (kv head = h / (H / KV)); out like q. Head dims 64, 80, 96 and
// 128: every head dim that the repo's configs send to the kernel (the
// Pallas kernel tiles the whole head dim and takes any). Optional causal
// mask, sliding window (q - k < window) and soft-cap cap * tanh(s / cap).
// Common to both bodies below: scores, the running max, sum and
// accumulator are f32; masked logits are -1e30 (not -inf: a row that has
// seen no valid key yet gets p = 1 for its masked keys, which the first
// valid key rescales away with alpha = exp(-1e30 - m) = 0, where -inf
// would give NaN); out = acc / max(l, 1e-30); exp2f and tanhf are IEEE
// (no fast math). The TPU kernel carries (m, l, acc) in scratch across an
// ordered grid axis over K blocks. Blocks here run in no order, so one
// block owns a (b, h, 64-row q tile) and loops over the 64-key K/V tiles
// itself, (m, l, acc) in registers; the last q tiles, which have the most
// keys under a causal mask, start first. Keys >= Lk are masked in the
// kernel (zero-filled tiles, p = 0); nothing is padded on the host.
// Causal without a window: K tiles wholly above the diagonal are skipped.
// That is exact: key 0 is valid for every row, so the row max is a real
// logit from the first tile on and a skipped key's p would be exactly
// exp(-1e30 - m) = 0. With a window every tile is visited, so a row with
// no valid key at all averages v over the Lk keys, as the reference's
// flash_attention_ref does.
//
// Both bodies share one skeleton: 128 threads, 4 warps, each owning 16 q
// rows of the 64-row q tile; the Q tile and a two-stage ring of 64-key
// K/V tiles in shared memory, rows padded by 16 bytes, K/V tile k+1
// brought in by cp.async (16 B a thread) while tile k computes; the
// strided (B, L, H, hd) views are read in place through their row
// strides. S (16 x 64 per warp) lives in the mma accumulator layout, where
// a row lies on one quad of threads: the softmax runs on those registers
// (row max and sum take two shuffles) and P feeds P V straight from them,
// never through shared memory. Logits are kept in base 2 (times log2 e),
// so each weight is one exp2f.
//
// bf16 body (flash_tc_kernel): mma.sync.m16n8k16 (bf16 in, f32
// accumulate). Rows of hd + 8 elements (16 B apart mod 128 B, an odd
// number of 16-byte units at every head dim taken) so ldmatrix reads
// them free of bank conflicts. Q's fragments are loaded once, K's by
// ldmatrix per k16 step. bf16 products are exact in f32, so S is the
// reference's f32 dot of upcast q and k, summed in another order. O += P
// V: P is rounded to bf16 in registers (the accumulator layout of two
// adjacent n8 tiles is the A layout of one k16 step) and V is fed by
// ldmatrix.trans. That rounding is the one departure from the reference,
// which keeps p in f32: it adds at most 2^-9 relative per weight, below
// the bf16 output's own 2^-8 rounding, inside the bf16 tolerance 2e-2.
// The row sum l is taken over the f32 p. Bound at the path's shape
// (stablelm_1_6b, (4, 32, 512, 64) causal): 33.6 MB of q, k, v and out =
// 10.0 us at 3.35 TB/s, against 4.3 GFLOP = 4.3 us at the bf16
// tensor-core rate: bytes.
//
// f32 body (flash_tf32_kernel): 3xTF32 on the tensor cores. Every
// operand x is split as hi = tf32(x), lo = tf32(x - hi) (to nearest), and
// each product a.b is taken as hi_a.hi_b + hi_a.lo_b + lo_a.hi_b by
// mma.sync.m16n8k8.tf32 with f32 accumulation; the dropped lo.lo term and
// the roundings of lo are about 2^-21 relative per product, far inside
// the f32 tolerance 2e-5 (single-pass TF32, 2^-11, is not). The small
// terms go to accumulators of their own, added once at the end (S per
// tile, O at the output), so the tensor cores' rounding of the long
// hi.hi sums is not repeated for them. Rows of hd + 4 floats (16 B apart
// mod 128 B): ldmatrix reads Q's and K's fragments (f32 as pairs of b16:
// lane (g, t) gets element (g, t) of each 8 x 4 matrix) and the scalar
// reads of V's fragment (lane (g, t) -> 2t (hd + 4) + g) are free of bank
// conflicts at every head dim taken. Q, K and V stay f32 in shared
// memory and each operand is split as its fragment is read: Q's 4 values
// a thread per k8 step cost a quarter of K's. Splitting Q once per block
// into hi and lo halves in shared memory was no faster at hd 64, 96 and
// 128 and 21 % slower at hd 80, where the second half pushes the block
// past 113 KB and halves the blocks per SM (measured on an H100 80GB
// HBM3 at 700 W by scripts/flash_attention_ab.py). P stays in registers: a thread holds keys 2t and 2t + 1
// of each n8 tile of S, and TF32's A fragment wants k positions t and
// t + 4, so the keys of each k8 step are taken in the order 0, 2, 4, 6,
// 1, 3, 5, 7 (position t is key 2t, position t + 4 is key 2t + 1), a sum
// over keys being free of order, and V's fragment is read in the same
// order. P is split in registers. out = acc / max(l, 1e-30) is a real
// division: the f32 output has no rounding of its own to hide a
// reciprocal. Bound at the path's shape ((4, 32, 512, 64) f32 causal,
// phase 6's f32 scoring): 67.1 MB of q, k, v and out = 20.0 us at 3.35
// TB/s, against 4.3 GFLOP at three TF32 products each (495/3 TFLOP/s) =
// 26.1 us: operations. f32 FMAs alone (67 TFLOP/s) would need 64 us.
//
// Why mma.sync and not wgmma/TMA: the register fragments let P feed P V
// without a trip through shared memory, at bf16 the shape is bytes-bound
// (4.3 GFLOP is 13 us even at a third of the bf16 peak), and the f32
// body is the bf16 body's skeleton with B4's (ssd_scan.cu) 3xTF32
// products; warpgroup MMA, TMA and warp specialisation would buy little
// here for their complexity.
//
// The bf16 body writes each row's base-2 log-sum-exp m + log2 l (f32,
// (B, H, Lq padded to 64), +inf past Lq) when the caller passes a pointer
// for it, for the backward; without one it runs as before.
//
// Backward (flash_bwd_dq_kernel, flash_bwd_dkv_kernel): FlashAttention-2's
// backward for causal or full attention in bf16, GQA, no window and no
// soft-cap. It replaces no TPU kernel: the Pallas kernel is forward-only
// and the reference leaves its training attention to XLA. Neither kernel
// writes an (L x L) tensor: P = exp2(S scale log2 e - LSE) is recomputed
// from the forward's log-sum-exp, and S, P, dP and dS live in the mma
// accumulator layout, where (as P in the forward) two adjacent n8 tiles
// are the A fragment of the next product. The dQ kernel (one block a (b,
// h, 64-row q tile), K/V tiles up to the diagonal, as the forward) first
// takes D = rowsum(dO o O) of its rows and writes it for the dK/dV
// kernel (one block a (b, kv head, 64-key tile), over the group's query
// heads and the q tiles at or below the diagonal, Q, dO, LSE and D in a
// two-stage cp.async ring). Each recomputes S and dP = dO V^T itself, so
// no sum crosses blocks: no atomics, and the same inputs give the same
// bits. dV += bf16(P)^T dO rounds P to bf16, as the reference rounds its
// probabilities before P V (layers.attention); dP is kept in f32 (the
// reference rounds it to bf16). dK += dS^T Q and dQ += dS K take dS as a
// bf16 pair hi + lo in two products (Q and K are exact in bf16): about
// 2^-17 relative per element, where one bf16 product (2^-9) would be a
// lower precision than the reference's f32 products; dQ and dK are
// scaled once at the end. Tiles wholly above the diagonal are skipped,
// exact as in the forward (their P is 0).
// Bound at the train step's shape (gpt3_2_7b_tp4, (4, 8, 2048, 80)
// causal): 67.1 M causal pairs x 7 products (S, dP, dV, and dK and dQ
// twice each) x 160 FLOP = 75.2 GFLOP = 76 us at the bf16 tensor-core
// rate, against 84 MB of q, k, v, o, dO, LSE, dq, dk and dv = 25 us:
// products. So every product runs on the tensor cores, P and dS go from
// register to product without a trip through shared memory, and the two
// recomputed products (S and dP in both kernels, 9 in all for 7) are the
// price of no atomics. wgmma and TMA are later work.
//
// MLA (DeepSeek-V2's training attention): q and k at head dim 192 (nope
// 128 + rope 64), v, the output and dO at 128; bf16 only, forward and
// backward (flash_tc_kernel<192, 128>, flash_bwd_dq_kernel<192, 128>,
// flash_bwd_dkv_kernel<192, 128>), scores scaled by 1 / sqrt(192). The V
// and dO tiles keep v's own row stride (128 + 8) and the products over
// v's head dim (P V, dP = dO V^T, dV) stop at 128: padding v to 192 would
// add half again to those three products and to their tiles. Shared
// memory: forward 111,616 B a block (two blocks an SM), backward 130,048
// B (one). The dK/dV kernel holds dK at 192 and dV at 128 in registers.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // q rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 128;    // 4 warps of 16 q rows
constexpr float kMask = -1e30f;  // the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

// dtype codes shared with the Python wrapper
enum DType { kF32 = 0, kBF16 = 1 };

struct Strides { long long b, h, l; };   // in elements; hd is contiguous

struct Params {
  const void* q; const void* k; const void* v; void* o;
  float* lse;            // (B, H, Lpad) base-2 log-sum-exp, or null
  Strides sq, sk, sv, so;
  int rep, Lq, Lk;
  float scale, cap;      // cap <= 0: no soft-cap
  int causal, window;    // window < 0: no window
};

using bf16 = __nv_bfloat16;

// ------------------------------------------------- shared by both bodies
// row stride of the shared tiles in elements: hd plus 16 bytes
template <typename T, int HD>
__host__ __device__ constexpr int row_stride() {
  return HD + 16 / static_cast<int>(sizeof(T));
}

// the Q tile, then two stages of K and V (V's rows at HDV)
template <typename T, int HD, int HDV = HD>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(T) * (static_cast<size_t>(row_stride<T, HD>()) *
                          (kBQ + 2 * kBK) +
                      static_cast<size_t>(row_stride<T, HDV>()) * 2 * kBK);
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

// four 8 x 8 b16 matrices (8 x 4 f32); lanes 8i .. 8i + 7 address the
// rows of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)) : "memory");
}

// rows [r0, r0 + 64) of a (rows, HD) matrix with row stride `ld` into a
// [64][row_stride] tile: cp.async for rows < end, zeros past it
template <typename T, int HD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long ld,
                                          int r0, int end, int tid) {
  constexpr int E = 16 / sizeof(T);          // elements per 16-byte chunk
  constexpr int CPR = HD / E;                // chunks per row
#pragma unroll
  for (int i = tid; i < kBK * CPR; i += kThreads) {
    const int r = i / CPR, c = (i % CPR) * E;
    T* d = dst + r * row_stride<T, HD>() + c;
    if (r0 + r < end)
      cp_async16(d, src + (r0 + r) * ld + c);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// the block's (b, h) slices of q, k, v and out
template <typename T>
struct Heads {
  const T* q; const T* k; const T* v; T* o;
  __device__ Heads(const Params& p, int b, int h) {
    const int kvh = h / p.rep;
    q = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
    k = static_cast<const T*>(p.k) + b * p.sk.b + kvh * p.sk.h;
    v = static_cast<const T*>(p.v) + b * p.sv.b + kvh * p.sv.h;
    o = static_cast<T*>(p.o) + b * p.so.b + h * p.so.h;
  }
};

// K tiles the q tile at q0 visits: all, or under a causal mask without a
// window those up to its last row's diagonal
__device__ __forceinline__ int n_key_tiles(const Params& p, int q0) {
  const int n_kt = (p.Lk + kBK - 1) / kBK;
  if (!p.causal || p.window >= 0) return n_kt;
  return min(n_kt, (min(q0 + kBQ, p.Lq) - 1) / kBK + 1);
}

// the ring's first fill: the Q tile and K/V tile 0 into stage 0
template <typename T, int HD, int HDV>
__device__ __forceinline__ void load_first(T* Qs, T* Ks, T* Vs,
                                           const Heads<T>& x, const Params& p,
                                           int q0, int tid) {
  load_tile<T, HD>(Qs, x.q, p.sq.l, q0, p.Lq, tid);
  load_tile<T, HD>(Ks, x.k, p.sk.l, 0, p.Lk, tid);
  load_tile<T, HDV>(Vs, x.v, p.sv.l, 0, p.Lk, tid);
  cp_async_commit();
}

// K/V tile kt + 1 into stage (kt + 1) & 1 (freed by the barrier that
// ended tile kt - 1), then wait for tile kt (and, at kt 0, the Q tile);
// returns tile kt's stage: its K tile is at Ks + stage * kBK * row_stride
// <HD>, its V tile at Vs + stage * kBK * row_stride<HDV>
template <typename T, int HD, int HDV>
__device__ __forceinline__ int next_tile(T* Ks, T* Vs, const T* k, const T* v,
                                         long long ldk, long long ldv, int Lk,
                                         int kt, int n_kt, int tid) {
  if (kt + 1 < n_kt) {
    const int nxt = (kt + 1) & 1;
    load_tile<T, HD>(Ks + nxt * kBK * row_stride<T, HD>(), k, ldk,
                     (kt + 1) * kBK, Lk, tid);
    load_tile<T, HDV>(Vs + nxt * kBK * row_stride<T, HDV>(), v, ldv,
                      (kt + 1) * kBK, Lk, tid);
    cp_async_commit();
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();
  return kt & 1;
}

// Online softmax over one 64-key tile. s[j][2r + e] is the raw score of
// row w0 + g + 8r of the q tile at q0 (w0: the warp's first row) and key
// k0 + 8j + 2t + e. Scales (soft-caps) and masks s in place into base-2
// logits, then into the weights p; updates the row max m and sum l and
// returns each row's rescale factor alpha for the accumulator. Each step
// runs over all 32 values as straight-line code (a branch per value would
// split the unrolled loop into blocks the scheduler cannot interleave);
// the soft-cap and the masks branch once per tile. Masked logits are
// -1e30 and keep their meaning in base 2 (exp2f(-1e30 - m) = 0, and a row
// with no valid key still weighs its masked keys equally); keys >= Lk are
// -inf, out of the row max (every tile holds a key < Lk, so the max stays
// >= -1e30) and exp2f(-inf - m) = 0.
__device__ __forceinline__ void softmax_tile(float (&s)[8][4], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             const Params& p, int q0, int w0,
                                             int k0, int g, int t) {
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
  const int row0 = q0 + w0 + g;
  if ((p.causal && k0 + kBK - 1 > q0 + w0) || p.window >= 0 ||
      k0 + kBK > p.Lk) {                   // the same for the whole warp
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
    alpha[r] = exp2f(m[r] - mn);
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
    l[r] = l[r] * alpha[r] + ps;
    m[r] = mn;
  }
}

// acc[j][2r + e] (rows g + 8r) times its row's alpha
template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N][4],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[j][e] = 0.f;
}

// ------------------------------------------------ bf16 tensor-core body
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

// HDV: v's head dim (MLA: 128 against q and k's 192), HD's otherwise
template <int HD, int HDV = HD>
__global__ void __launch_bounds__(kThreads) flash_tc_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int RS = row_stride<bf16, HD>();
  constexpr int RSV = row_stride<bf16, HDV>();
  constexpr int KS = HD / 16;      // k16 steps of Q K^T
  constexpr int NO = HDV / 8;      // n8 tiles of the output
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [kBQ][RS]
  bf16* Ks = Qs + kBQ * RS;                       // [2][kBK][RS]
  bf16* Vs = Ks + 2 * kBK * RS;                   // [2][kBK][RSV]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;   // fragment row, column pair
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const Heads<bf16> x(p, blockIdx.z, blockIdx.y);
  const int n_kt = n_key_tiles(p, q0);
  load_first<bf16, HD, HDV>(Qs, Ks, Vs, x, p, q0, tid);

  // rows g and g + 8 of the warp's 16: running max, sum, accumulator
  float m[2] = {kMask, kMask}, l[2] = {0.f, 0.f}, alpha[2], acc[NO][4];
  zero(acc);
  uint32_t qf[KS][4];

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = next_tile<bf16, HD, HDV>(Ks, Vs, x.k, x.v, p.sk.l,
                                            p.sv.l, p.Lk, kt, n_kt, tid);
    if (kt == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldsm_x4(qf[ks], Qs + (warp * 16 + (lane & 15)) * RS + ks * 16 +
                            (lane >> 4) * 8);
    }
    const bf16* Kt = Ks + st * kBK * RS;
    const bf16* Vt = Vs + st * kBK * RSV;

    // S = Q K^T: n8 tile j holds keys 8j .. 8j + 7 of the tile
    float s[8][4];
    zero(s);
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
    softmax_tile(s, m, l, alpha, p, q0, warp * 16, kt * kBK, g, t);
    rescale(acc, alpha);

    // O += P V: P's n8 tiles 2kk, 2kk + 1 are the A fragment of k16 step
    // kk, rounded to bf16
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < HDV / 16; ++dp) {  // output tiles 2dp, 2dp + 1
        uint32_t vb[4];
        ldsm_x4_trans(vb, Vt + (kk * 16 + (lane & 7) +
                                ((lane >> 3) & 1) * 8) * RSV +
                              dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], a, vb[0], vb[1]);
        mma_bf16(acc[2 * dp + 1], a, vb[2], vb[3]);
      }
    }
    __syncthreads();               // this stage is read: free for kt + 2
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    // each row's base-2 log-sum-exp for the backward, +inf on the rows
    // of the last tile past Lq (the row's four threads hold the same m, l)
    if (p.lse != nullptr && t == 0)
      p.lse[(static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y) *
                (gridDim.x * kBQ) + row] =
          row < p.Lq ? m[r] + log2f(fmaxf(l[r], 1e-30f)) : INFINITY;
    if (row >= p.Lq) continue;
    // one reciprocal per row: within an f32 ulp of the division, far
    // below the bf16 output's rounding
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    bf16* orow = x.o + row * p.so.l + 2 * t;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
  }
}

// ------------------------------------------------------ f32 3xTF32 body
// x to TF32, to nearest with ties away from zero: cvt.rna.tf32.f32 on
// finite values, as two integer ops on the bits (as in ssd_scan.cu)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo + O(2^-22 |x|), hi and lo TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d += a (16 x 8, row) * b (8 x 8, col); TF32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32 from split operands, lo.lo dropped: the hi.hi product into d,
// the two small ones into dl
__device__ __forceinline__ void mma3(float (&d)[4], float (&dl)[4],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  mma_tf32(dl, ah, bl0, bl1);
  mma_tf32(dl, al, bh0, bh1);
  mma_tf32(d, ah, bh0, bh1);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_tf32_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int RS = row_stride<float, HD>();
  constexpr int KS = HD / 8;       // k8 steps of Q K^T
  constexpr int NO = HD / 8;       // n8 tiles of the output
  float* Qs = smem;                // [kBQ][RS]
  float* Ks = Qs + kBQ * RS;       // [2][kBK][RS]
  float* Vs = Ks + 2 * kBK * RS;   // [2][kBK][RS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;   // fragment row, column
  const int w0 = warp * 16;                // the warp's rows
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const Heads<float> x(p, blockIdx.z, blockIdx.y);
  const int n_kt = n_key_tiles(p, q0);
  load_first<float, HD, HD>(Qs, Ks, Vs, x, p, q0, tid);

  // rows g and g + 8 of the warp's 16: running max, sum; the output's
  // hi.hi terms and, apart, its small terms
  float m[2] = {kMask, kMask}, l[2] = {0.f, 0.f}, alpha[2];
  float acc[NO][4], acl[NO][4];
  zero(acc);
  zero(acl);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int off = next_tile<float, HD, HD>(Ks, Vs, x.k, x.v, p.sk.l,
                                               p.sv.l, p.Lk, kt, n_kt, tid) *
                    kBK * RS;
    const float* Kt = Ks + off;
    const float* Vt = Vs + off;

    // S = Q K^T: n8 tile j holds keys 8j .. 8j + 7 of the tile; the
    // small terms in sl, added once the tile's sums are done
    float s[8][4], sl[8][4];
    zero(s);
    zero(sl);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      // A: rows w0 .. w0 + 15, dims 8ks .. 8ks + 7
      uint32_t qa[4], ah[4], al[4];
      ldsm_x4(qa, Qs + (w0 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS +
                      ks * 8 + (lane >> 4) * 4);
#pragma unroll
      for (int e = 0; e < 4; ++e) split(__uint_as_float(qa[e]), ah[e], al[e]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {   // key tiles 2np and 2np + 1
        uint32_t kb[4], bh[4], bl[4];
        ldsm_x4(kb, Kt + (np * 16 + (lane & 7) + (lane >> 4) * 8) * RS +
                        ks * 8 + ((lane >> 3) & 1) * 4);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split(__uint_as_float(kb[e]), bh[e], bl[e]);
        mma3(s[2 * np], sl[2 * np], ah, al, bh[0], bh[1], bl[0], bl[1]);
        mma3(s[2 * np + 1], sl[2 * np + 1], ah, al, bh[2], bh[3], bl[2],
             bl[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += sl[j][e];
    softmax_tile(s, m, l, alpha, p, q0, w0, kt * kBK, g, t);
    rescale(acc, alpha);
    rescale(acl, alpha);

    // O += P V over k8 steps of 8 keys, taken in the order 2t (position
    // t) and 2t + 1 (position t + 4): the A fragment is s[kk] as it lies
    // in the registers, and V's fragment reads rows 2t and 2t + 1
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      uint32_t ph[4], pl[4];
      split(s[kk][0], ph[0], pl[0]);       // row g,     key 2t
      split(s[kk][2], ph[1], pl[1]);       // row g + 8, key 2t
      split(s[kk][1], ph[2], pl[2]);       // row g,     key 2t + 1
      split(s[kk][3], ph[3], pl[3]);       // row g + 8, key 2t + 1
      const float* vr = Vt + (8 * kk + 2 * t) * RS + g;
#pragma unroll
      for (int n = 0; n < NO; ++n) {       // output dims 8n .. 8n + 7
        uint32_t bh0, bl0, bh1, bl1;
        split(vr[8 * n], bh0, bl0);
        split(vr[RS + 8 * n], bh1, bl1);
        mma3(acc[n], acl[n], ph, pl, bh0, bh1, bl0, bl1);
      }
    }
    __syncthreads();               // this stage is read: free for kt + 2
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + w0 + g + 8 * r;
    if (row >= p.Lq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    float* orow = x.o + row * p.so.l + 2 * t;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j) =
          make_float2((acc[j][2 * r] + acl[j][2 * r]) / denom,
                      (acc[j][2 * r + 1] + acl[j][2 * r + 1]) / denom);
  }
}

// ---------------------------------------------------- bf16 backward bodies
struct BwdParams {
  const bf16* q; const bf16* k; const bf16* v; const bf16* o;
  const bf16* dout;
  const float* lse;    // (B, H, Lpad): the forward's base-2 log-sum-exp
  float* delta;        // (B, H, Lpad): rowsum(dO o O), the dQ kernel's
  bf16* dq; bf16* dk; bf16* dv;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int H, rep, Lq, Lk, Lpad;
  float scale;
  int causal;
};

// Shared memory of either backward body: six 64-row tiles (dQ: Q, dO and
// two stages of K and V; dK/dV: K, V and two stages of Q and dO), three
// of them (V, dO) at v's head dim HDV, then 4 x 64 floats (dQ: its rows'
// LSE and D; dK/dV: two stages of the q tile's LSE and D)
template <int HD, int HDV = HD>
__host__ __device__ constexpr size_t bwd_smem_bytes() {
  return sizeof(bf16) * static_cast<size_t>(row_stride<bf16, HD>() +
                                            row_stride<bf16, HDV>()) * 3 *
             kBQ + sizeof(float) * 4 * kBQ;
}

// the A fragment of k16 step kk (16 rows x 16 columns) from the
// accumulator tiles 2kk and 2kk + 1 of x, as bf16 hi + lo: each value
// within 2^-17 relative of hi + lo (x - hi is exact in f32)
template <int N>
__device__ __forceinline__ void a_split(const float (&x)[N][4], int kk,
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float a = x[2 * kk + (i >> 1)][2 * (i & 1)];
    const float b = x[2 * kk + (i >> 1)][2 * (i & 1) + 1];
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const float2 hf = __bfloat1622float2(h);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i] = pack_bf16(a - hf.x, b - hf.y);
  }
}

// dQ, and D for the dK/dV kernel. One block a (b, h, 64-row q tile),
// each warp 16 rows; loops over the K/V tiles up to the diagonal as the
// forward does. D = rowsum(dO o O) of the tile's rows first, straight
// from device memory (two threads a row), while the Q, dO and first K/V
// tiles arrive. Per key tile: S = Q K^T and dP = dO V^T (bf16 in, f32
// accumulate), P = exp2(S scale log2 e - LSE), dS = P o (dP - D), dQ +=
// dS K with dS as bf16 hi + lo; dQ times the scale at the end. HDV: the
// head dim of v, o and dO (MLA: 128 against q and k's 192), at most HD.
template <int HD, int HDV = HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const BwdParams p) {
  static_assert(HDV <= HD, "v's head dim is at most q's");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int RS = row_stride<bf16, HD>();
  constexpr int RSV = row_stride<bf16, HDV>();
  constexpr int KS = HD / 16;      // k16 steps over the head dim
  constexpr int KSV = HDV / 16;    // k16 steps over v's head dim
  constexpr int NO = HD / 8;       // n8 tiles of dQ
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);             // [kBQ][RS]
  bf16* dOs = Qs + kBQ * RS;                                 // [kBQ][RSV]
  bf16* Ks = dOs + kBQ * RSV;                                // [2][kBK][RS]
  bf16* Vs = Ks + 2 * kBK * RS;                              // [2][kBK][RSV]
  float* sL = reinterpret_cast<float*>(Vs + 2 * kBK * RSV); // [kBQ]
  float* sD = sL + kBQ;                                      // [kBQ]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;   // fragment row, column pair
  const int w0 = warp * 16;                // the warp's rows
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int b = blockIdx.z, h = blockIdx.y, kvh = h / p.rep;
  const long long bh = (static_cast<long long>(b) * p.H + h) * p.Lpad;
  const bf16* q = p.q + b * p.sq.b + h * p.sq.h;
  const bf16* o = p.o + b * p.so.b + h * p.so.h;
  const bf16* dout = p.dout + b * p.sdo.b + h * p.sdo.h;
  const bf16* k = p.k + b * p.sk.b + kvh * p.sk.h;
  const bf16* v = p.v + b * p.sv.b + kvh * p.sv.h;
  const int n_all = (p.Lk + kBK - 1) / kBK;
  const int n_kt = p.causal
      ? min(n_all, (min(q0 + kBQ, p.Lq) - 1) / kBK + 1) : n_all;
  load_tile<bf16, HD>(Qs, q, p.sq.l, q0, p.Lq, tid);
  load_tile<bf16, HDV>(dOs, dout, p.sdo.l, q0, p.Lq, tid);
  load_tile<bf16, HD>(Ks, k, p.sk.l, 0, p.Lk, tid);
  load_tile<bf16, HDV>(Vs, v, p.sv.l, 0, p.Lk, tid);
  cp_async_commit();
  {
    const int r = tid >> 1, half = tid & 1, row = q0 + r;
    float d = 0.f;
    if (row < p.Lq) {
      const bf16* x = dout + row * p.sdo.l + half * (HDV / 2);
      const bf16* y = o + row * p.so.l + half * (HDV / 2);
#pragma unroll
      for (int c = 0; c < HDV / 16; ++c) {     // 8 elements at a time
        const uint4 xa = *reinterpret_cast<const uint4*>(x + 8 * c);
        const uint4 ya = *reinterpret_cast<const uint4*>(y + 8 * c);
        const __nv_bfloat162* x2 =
            reinterpret_cast<const __nv_bfloat162*>(&xa);
        const __nv_bfloat162* y2 =
            reinterpret_cast<const __nv_bfloat162*>(&ya);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 xf = __bfloat1622float2(x2[e]);
          const float2 yf = __bfloat1622float2(y2[e]);
          d = fmaf(xf.x, yf.x, d);
          d = fmaf(xf.y, yf.y, d);
        }
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (half == 0) {
      sD[r] = d;
      sL[r] = row < p.Lq ? p.lse[bh + row] : INFINITY;
      p.delta[bh + row] = d;
    }
  }

  const float scale2 = p.scale * kLog2e;
  float lse[2], dd[2], acc[NO][4];   // rows g and g + 8 of the warp's 16
  zero(acc);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = next_tile<bf16, HD, HDV>(Ks, Vs, k, v, p.sk.l, p.sv.l,
                                            p.Lk, kt, n_kt, tid);
    if (kt == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lse[r] = sL[w0 + g + 8 * r];
        dd[r] = sD[w0 + g + 8 * r];
      }
    }
    const bf16* Kt = Ks + st * kBK * RS;
    const bf16* Vt = Vs + st * kBK * RSV;
    const int k0 = kt * kBK;

    // S = Q K^T, dP = dO V^T: n8 tile j holds keys 8j .. 8j + 7; dP's
    // k16 steps end at v's head dim
    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qa[4], oa[4];
      ldsm_x4(qa, Qs + (w0 + (lane & 15)) * RS + ks * 16 + (lane >> 4) * 8);
      if (ks < KSV)
        ldsm_x4(oa, dOs + (w0 + (lane & 15)) * RSV + ks * 16 +
                        (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {   // key tiles 2np and 2np + 1
        const int row = np * 16 + (lane & 7) + ((lane >> 4) << 3);
        const int col = ks * 16 + ((lane >> 3) & 1) * 8;
        uint32_t kb[4], vb[4];
        ldsm_x4(kb, Kt + row * RS + col);
        mma_bf16(s[2 * np], qa, kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
        if (ks < KSV) {
          ldsm_x4(vb, Vt + row * RSV + col);
          mma_bf16(dp[2 * np], oa, vb[0], vb[1]);
          mma_bf16(dp[2 * np + 1], oa, vb[2], vb[3]);
        }
      }
    }
    // dS = P o (dP - D) into s; P is 0 above the diagonal and past Lk
    const bool edge = (p.causal && k0 + kBK - 1 > q0 + w0) || k0 + kBK > p.Lk;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float pv = exp2f(s[j][e] * scale2 - lse[r]);
        if (edge) {
          const int qpos = q0 + w0 + g + 8 * r;
          const int kpos = k0 + 8 * j + 2 * t + (e & 1);
          if (kpos >= p.Lk || (p.causal && qpos < kpos)) pv = 0.f;
        }
        s[j][e] = pv * (dp[j][e] - dd[r]);
      }
    // dQ += dS K: dS's n8 tiles 2kk, 2kk + 1 are the A fragment of k16
    // step kk (hi and lo), K's fragment read by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ah[4], al[4];
      a_split(s, kk, ah, al);
#pragma unroll
      for (int d2 = 0; d2 < HD / 16; ++d2) {   // dQ tiles 2d2, 2d2 + 1
        uint32_t kb[4];
        ldsm_x4_trans(kb, Kt + (kk * 16 + (lane & 7) +
                                ((lane >> 3) & 1) * 8) * RS +
                              d2 * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * d2], ah, kb[0], kb[1]);
        mma_bf16(acc[2 * d2], al, kb[0], kb[1]);
        mma_bf16(acc[2 * d2 + 1], ah, kb[2], kb[3]);
        mma_bf16(acc[2 * d2 + 1], al, kb[2], kb[3]);
      }
    }
    __syncthreads();               // this stage is read: free for kt + 2
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + w0 + g + 8 * r;
    if (row >= p.Lq) continue;
    bf16* out = p.dq + b * p.sdq.b + h * p.sdq.h + row * p.sdq.l + 2 * t;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) = __floats2bfloat162_rn(
          acc[j][2 * r] * p.scale, acc[j][2 * r + 1] * p.scale);
  }
}

// dK and dV. One block a (b, kv head, 64-key tile), each warp 16 keys;
// K and V stay in shared memory. Loops over the group's query heads and,
// for each, the q tiles at or below the diagonal (causal: from the tile
// of the block's first key), in a two-stage cp.async ring of Q, dO and
// the q tile's LSE and D. Per q tile, in two halves of 32 rows: S^T = K
// Q^T and dP^T = V dO^T, P^T = exp2(S^T scale log2 e - LSE), dV +=
// bf16(P^T) dO, dS^T = P^T o (dP^T - D), dK += dS^T Q with dS^T as bf16
// hi + lo; dK times the scale at the end. HDV: the head dim of v and dO
// (MLA: 128 against q and k's 192), at most HD.
template <int HD, int HDV = HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const BwdParams p) {
  static_assert(HDV <= HD, "v's head dim is at most q's");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int RS = row_stride<bf16, HD>();
  constexpr int RSV = row_stride<bf16, HDV>();
  constexpr int KS = HD / 16;      // k16 steps over the head dim
  constexpr int KSV = HDV / 16;    // k16 steps over v's head dim
  constexpr int NO = HD / 8;       // n8 tiles of dK
  constexpr int NOV = HDV / 8;     // n8 tiles of dV
  constexpr int TILE = kBQ * RS;
  constexpr int TILEV = kBQ * RSV;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);             // [kBK][RS]
  bf16* Vs = Ks + kBK * RS;                                  // [kBK][RSV]
  bf16* Qs = Vs + kBK * RSV;                                 // [2][kBQ][RS]
  bf16* dOs = Qs + 2 * TILE;                                 // [2][kBQ][RSV]
  float* sL = reinterpret_cast<float*>(dOs + 2 * TILEV);    // [2][kBQ]
  float* sD = sL + 2 * kBQ;                                  // [2][kBQ]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;   // fragment row, column pair
  const int w0 = warp * 16;                // the warp's keys
  // causal: the first key tiles see the most q tiles, and start first
  const int k0 = blockIdx.x * kBK;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const bf16* k = p.k + b * p.sk.b + kvh * p.sk.h;
  const bf16* v = p.v + b * p.sv.b + kvh * p.sv.h;
  const int n_qt = (p.Lq + kBQ - 1) / kBQ;
  // causal: q tiles wholly before key k0 see none of the tile's keys
  const int qt0 = p.causal ? min(k0 / kBQ, n_qt) : 0;
  const int per_head = n_qt - qt0, n_it = per_head * p.rep;

  // iteration i: query head kvh rep + i / per_head, q tile qt0 + i %
  // per_head, into stage i & 1
  auto load_it = [&](int i) {
    const int h = kvh * p.rep + i / per_head;
    const int q0 = (qt0 + i % per_head) * kBQ, st = i & 1;
    load_tile<bf16, HD>(Qs + st * TILE, p.q + b * p.sq.b + h * p.sq.h,
                        p.sq.l, q0, p.Lq, tid);
    load_tile<bf16, HDV>(dOs + st * TILEV, p.dout + b * p.sdo.b +
                         h * p.sdo.h, p.sdo.l, q0, p.Lq, tid);
    const long long at = (static_cast<long long>(b) * p.H + h) * p.Lpad + q0;
    if (tid < 16)
      cp_async16(sL + st * kBQ + 4 * tid, p.lse + at + 4 * tid);
    else if (tid < 32)
      cp_async16(sD + st * kBQ + 4 * (tid - 16),
                 p.delta + at + 4 * (tid - 16));
  };
  if (n_it > 0) {
    load_tile<bf16, HD>(Ks, k, p.sk.l, k0, p.Lk, tid);
    load_tile<bf16, HDV>(Vs, v, p.sv.l, k0, p.Lk, tid);
    load_it(0);
  }
  cp_async_commit();

  const float scale2 = p.scale * kLog2e;
  float dk[NO][4], dv[NOV][4];  // keys g and g + 8 of the warp's 16
  zero(dk);
  zero(dv);
  for (int i = 0; i < n_it; ++i) {
    if (i + 1 < n_it) {           // stage (i + 1) & 1 was freed by i - 1
      load_it(i + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int st = i & 1, q0 = (qt0 + i % per_head) * kBQ;
    const bf16* Qt = Qs + st * TILE;
    const bf16* dOt = dOs + st * TILEV;
    const float* L = sL + st * kBQ;
    const float* D = sD + st * kBQ;
#pragma unroll
    for (int c0 = 0; c0 < kBQ; c0 += 32) {   // rows c0 .. c0 + 31 of the tile
      // S^T = K Q^T, dP^T = V dO^T: n8 tile j holds q rows c0 + 8j ..;
      // dP^T's k16 steps end at v's head dim
      float s[4][4], dp[4][4];
      zero(s);
      zero(dp);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t ka[4], va[4];
        ldsm_x4(ka, Ks + (w0 + (lane & 15)) * RS + ks * 16 + (lane >> 4) * 8);
        if (ks < KSV)
          ldsm_x4(va, Vs + (w0 + (lane & 15)) * RSV + ks * 16 +
                          (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < 2; ++np) {   // q tiles 2np and 2np + 1
          const int row = c0 + np * 16 + (lane & 7) + ((lane >> 4) << 3);
          const int col = ks * 16 + ((lane >> 3) & 1) * 8;
          uint32_t qb[4], ob[4];
          ldsm_x4(qb, Qt + row * RS + col);
          mma_bf16(s[2 * np], ka, qb[0], qb[1]);
          mma_bf16(s[2 * np + 1], ka, qb[2], qb[3]);
          if (ks < KSV) {
            ldsm_x4(ob, dOt + row * RSV + col);
            mma_bf16(dp[2 * np], va, ob[0], ob[1]);
            mma_bf16(dp[2 * np + 1], va, ob[2], ob[3]);
          }
        }
      }
      // P^T into s (0 above the diagonal and past Lq), dS^T into dp
      const bool edge = (p.causal && q0 + c0 < k0 + w0 + 15) ||
                        q0 + c0 + 32 > p.Lq;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + 8 * j + 2 * t + (e & 1);
          float pv = exp2f(s[j][e] * scale2 - L[c]);
          if (edge) {
            const int qpos = q0 + c, kpos = k0 + w0 + g + 8 * (e >> 1);
            if (qpos >= p.Lq || (p.causal && qpos < kpos)) pv = 0.f;
          }
          s[j][e] = pv;
          dp[j][e] = pv * (dp[j][e] - D[c]);
        }
      // dV += bf16(P^T) dO and dK += dS^T Q (hi and lo): the n8 tiles 2kk,
      // 2kk + 1 are the A fragment of k16 step kk, dO's and Q's fragments
      // read by ldmatrix.trans; dV's tiles end at v's head dim
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        uint32_t ah[4], al[4];
        a_split(dp, kk, ah, al);
#pragma unroll
        for (int d2 = 0; d2 < HD / 16; ++d2) {   // tiles 2d2, 2d2 + 1
          const int row = c0 + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          const int col = d2 * 16 + (lane >> 4) * 8;
          uint32_t ob[4], qb[4];
          if (d2 < KSV) {
            ldsm_x4_trans(ob, dOt + row * RSV + col);
            mma_bf16(dv[2 * d2], a, ob[0], ob[1]);
            mma_bf16(dv[2 * d2 + 1], a, ob[2], ob[3]);
          }
          ldsm_x4_trans(qb, Qt + row * RS + col);
          mma_bf16(dk[2 * d2], ah, qb[0], qb[1]);
          mma_bf16(dk[2 * d2], al, qb[0], qb[1]);
          mma_bf16(dk[2 * d2 + 1], ah, qb[2], qb[3]);
          mma_bf16(dk[2 * d2 + 1], al, qb[2], qb[3]);
        }
      }
    }
    __syncthreads();               // this stage is read: free for i + 2
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + w0 + g + 8 * r;
    if (key >= p.Lk) continue;
    bf16* outk = p.dk + b * p.sdk.b + kvh * p.sdk.h + key * p.sdk.l + 2 * t;
    bf16* outv = p.dv + b * p.sdv.b + kvh * p.sdv.h + key * p.sdv.l + 2 * t;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(outk + 8 * j) = __floats2bfloat162_rn(
          dk[j][2 * r] * p.scale, dk[j][2 * r + 1] * p.scale);
      if (j < NOV)
        *reinterpret_cast<__nv_bfloat162*>(outv + 8 * j) =
            __floats2bfloat162_rn(dv[j][2 * r], dv[j][2 * r + 1]);
    }
  }
}

template <typename Kernel, typename P>
int launch(Kernel kernel, size_t smem, dim3 grid, const P& p,
           cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_hd(int dtype, const Params& p, int B, int H, cudaStream_t s) {
  const dim3 grid((p.Lq + kBQ - 1) / kBQ, H, B);
  switch (dtype) {
    case kF32:
      return launch(flash_tf32_kernel<HD>, smem_bytes<float, HD>(), grid, p,
                    s);
    case kBF16:
      return launch(flash_tc_kernel<HD>, smem_bytes<bf16, HD>(), grid, p, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// MLA's (192, 128): the bf16 body only
int launch_mla(int dtype, const Params& p, int B, int H, cudaStream_t s) {
  if (dtype != kBF16) return static_cast<int>(cudaErrorInvalidValue);
  return launch(flash_tc_kernel<192, 128>, smem_bytes<bf16, 192, 128>(),
                dim3((p.Lq + kBQ - 1) / kBQ, H, B), p, s);
}

// the dQ kernel (which writes D), then the dK/dV kernel, on one stream
template <int HD, int HDV = HD>
int launch_bwd_hd(const BwdParams& p, int B, int KV, cudaStream_t s) {
  const int e = launch(flash_bwd_dq_kernel<HD, HDV>, bwd_smem_bytes<HD, HDV>(),
                       dim3(p.Lpad / kBQ, p.H, B), p, s);
  if (e != 0) return e;
  return launch(flash_bwd_dkv_kernel<HD, HDV>, bwd_smem_bytes<HD, HDV>(),
                dim3((p.Lk + kBK - 1) / kBK, KV, B), p, s);
}

template <int HD>
long long smem_hd(int dtype) {
  switch (dtype) {
    case kF32: return static_cast<long long>(smem_bytes<float, HD>());
    case kBF16: return static_cast<long long>(smem_bytes<bf16, HD>());
  }
  return -1;
}

}  // namespace

// C entry point (bound with ctypes). strides: 12 element strides, (b, h,
// l) of q, k, v and out in that order; the last dimension of each must be
// contiguous and every row 16-byte aligned (the wrapper checks). hd (q and
// k) and hdv (v and out): 64, 80, 96 or 128 for both, or (bf16 only) 192
// and 128. window < 0: none; cap <= 0: none. lse: null, or (bf16 only) (B,
// H, ceil(Lq / 64) * 64) f32 for each row's base-2 log-sum-exp (+inf past
// Lq). Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      const long long* strides, int B, int H,
                                      int KV, int Lq, int Lk, int hd, int hdv,
                                      int dtype, int causal, int window,
                                      float cap, float scale, float* lse,
                                      void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || H > 65535 || KV <= 0 || H % KV ||
      Lq <= 0 || Lk <= 0 || (lse != nullptr && dtype != kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.lse = lse;
  p.sq = {strides[0], strides[1], strides[2]};
  p.sk = {strides[3], strides[4], strides[5]};
  p.sv = {strides[6], strides[7], strides[8]};
  p.so = {strides[9], strides[10], strides[11]};
  p.rep = H / KV; p.Lq = Lq; p.Lk = Lk;
  p.scale = scale; p.cap = cap; p.causal = causal; p.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 192 && hdv == 128) return launch_mla(dtype, p, B, H, s);
  if (hdv != hd) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 64: return launch_hd<64>(dtype, p, B, H, s);
    case 80: return launch_hd<80>(dtype, p, B, H, s);
    case 96: return launch_hd<96>(dtype, p, B, H, s);
    case 128: return launch_hd<128>(dtype, p, B, H, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory per block of the body that takes (hd, hdv, dtype),
// in bytes; -1 for arguments the kernel does not take.
extern "C" long long flash_attention_smem_bytes(int hd, int hdv, int dtype) {
  if (hd == 192 && hdv == 128)
    return dtype == kBF16
               ? static_cast<long long>(smem_bytes<bf16, 192, 128>()) : -1;
  if (hdv != hd) return -1;
  switch (hd) {
    case 64: return smem_hd<64>(dtype);
    case 80: return smem_hd<80>(dtype);
    case 96: return smem_hd<96>(dtype);
    case 128: return smem_hd<128>(dtype);
  }
  return -1;
}

// C entry point of the backward (bf16 only, no window, no soft-cap).
// strides: 24 element strides, (b, h, l) of q, k, v, o, dout, dq, dk and
// dv in that order, under the forward's rules. hd: q's and k's head dim,
// hdv: v's, o's and dout's (the forward's pairs). lse: the forward's, (B,
// H, Lpad) with Lpad = ceil(Lq / 64) * 64; delta: scratch of the same
// shape. dq, dk, dv take q's, k's and v's shapes. Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for
// arguments the kernels do not take.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, const long long* strides, int B, int H, int KV, int Lq, int Lk,
    int hd, int hdv, int causal, float scale, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || H > 65535 || KV <= 0 || H % KV ||
      Lq <= 0 || Lk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p;
  p.q = static_cast<const bf16*>(q); p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v); p.o = static_cast<const bf16*>(o);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = lse; p.delta = delta;
  p.dq = static_cast<bf16*>(dq); p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  Strides* ss[8] = {&p.sq, &p.sk, &p.sv, &p.so, &p.sdo, &p.sdq, &p.sdk,
                    &p.sdv};
  for (int i = 0; i < 8; ++i)
    *ss[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  p.H = H; p.rep = H / KV; p.Lq = Lq; p.Lk = Lk;
  p.Lpad = (Lq + kBQ - 1) / kBQ * kBQ;
  p.scale = scale; p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 192 && hdv == 128) return launch_bwd_hd<192, 128>(p, B, KV, s);
  if (hdv != hd) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 64: return launch_bwd_hd<64>(p, B, KV, s);
    case 80: return launch_bwd_hd<80>(p, B, KV, s);
    case 96: return launch_bwd_hd<96>(p, B, KV, s);
    case 128: return launch_bwd_hd<128>(p, B, KV, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory per block of either backward body at (hd, hdv), in
// bytes; -1 for a pair the kernels do not take.
extern "C" long long flash_attention_bwd_smem_bytes(int hd, int hdv) {
  if (hd == 192 && hdv == 128)
    return static_cast<long long>(bwd_smem_bytes<192, 128>());
  if (hdv != hd) return -1;
  switch (hd) {
    case 64: return static_cast<long long>(bwd_smem_bytes<64>());
    case 80: return static_cast<long long>(bwd_smem_bytes<80>());
    case 96: return static_cast<long long>(bwd_smem_bytes<96>());
    case 128: return static_cast<long long>(bwd_smem_bytes<128>());
  }
  return -1;
}
