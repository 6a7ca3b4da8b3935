// ssd_scan: the Mamba2 SSD intra-chunk term (arXiv:2405.21060).
//
// Replaces the TPU Pallas kernel src/repro/kernels/ssd_scan.py
// (ssd_intra_chunk, body _kernel). Per (batch, chunk, head):
//
//   Y[l, :] = sum_{s <= l} (C[l] . B[s]) * exp(sum_{i=s+1..l} dA[i]) * X[s, :]
//
// xc (b, nc, cl, h, p), dAc (b, nc, cl, h), Bc and Cc (b, nc, cl, h, n),
// all f32, each read through its element strides of (b, nc, cl, h) with
// the last dimension contiguous. y (b, nc, cl, h, p) f32.
//
// Two kernels, one after the other on the stream:
//   ssd_gram_kernel: G = C B^T, the lower-triangle 64 x 64 tiles of each
//   (b, chunk, group), into a scratch tensor the wrapper allocates. When
//   B and C are one group expanded over the heads (head stride 0, as
//   ssd_chunked passes mamba2_370m's), G is the same for every head and
//   is computed once per group: that is two thirds of the products (k =
//   n = 128 against k = 64 for the second product), 32 times fewer.
//   Other layouts get a G per head.
//   ssd_kernel: one block per (b, chunk, head) walks 64-row tiles of l and
//   the 64-row tiles of s <= l, reads its G tile (from L2: a group's G is
//   256 KB at cl 256, read by its heads one after the other), builds the
//   decay tile and takes Y += (G o L) X.
// Each block has 128 threads, 4 warps of 16 rows; tiles come in by
// cp.async (16 B a thread where the rows are 16-byte aligned, else 4 B),
// rows and columns past cl zero-filled. ssd_kernel holds three 64-row
// tiles (G, X, decay; ~56 KB at p 64): four blocks to an SM.
//
// Products on the tensor cores near f32 accuracy, 3xTF32: each operand x
// is split into hi = tf32(x) and lo = tf32(x - hi) (round to nearest) as
// its fragment is read from shared memory, and a.b is taken as
// hi_a.hi_b + hi_a.lo_b + lo_a.hi_b by mma.sync.m16n8k8.tf32 with f32
// accumulation (the small terms first). The dropped lo.lo term and the
// roundings of lo are about 2^-21 relative per product; the tensor cores'
// own rounding of a long accumulation comes on top, so G keeps its small
// terms in an accumulator of their own, added once per tile (on the
// card, one accumulator for all three left the largest error near the
// tolerance). The three-term bf16 split (2^-16 per product) does not hold
// the reference's 1e-4 at n 128 and cl 256 (tests/test_torch_mamba2.py
// emulates both), so TF32 it is. That emulation sums in IEEE f32: it
// bounds the split's error only. The tensor cores' accumulation is held
// to the tolerance on the card alone (the gpu tests, chip_smoke.py).
//   G: three products per k8 step over n, 16 x 64 per warp in registers,
//   C and B fragments by ldmatrix, stored as f32: the same values the
//   second product would see had it computed them itself.
//   Y += (G o L) X: G o L is split in registers and used as the A
//   fragment directly: read as pairs of columns 2t, 2t + 1, so the k order
//   within each k8 step is permuted (position t is s = 2t, position t + 4
//   is s = 2t + 1) and X's fragment is read in the same order. On a
//   diagonal tile a warp skips the steps wholly above its rows.
// Why mma.sync and not wgmma/TMA: the register fragments let G o L feed
// the product without another trip through shared memory, and the
// kernels are a few times their bound; warpgroup MMA, TMA and warp
// specialisation are for a benchmark that shows them compute-bound.
//
// The decay is summed per column as a segment sum, the way the plain
// version's segsum does, not as the difference cum[l] - cum[s] of two
// chunk-long prefix sums (as the Pallas kernel does): that difference
// carries the rounding of the whole prefix (|cum| grows along the chunk)
// into every decay near 1, where a segment sum's error scales with the
// segment instead. Each column's sum up to the tile above is kept in
// shared memory (colsum) and 2 threads per column add the tile's rows in
// halves. The decay is selected, not multiplied by a mask: 0 is stored
// where l < s (where cum[l] - cum[s] is positive, its exp can overflow,
// and inf * 0 is NaN) and for rows or columns past cl (ragged chunks).
//
// Bound at the path's shape (mamba2_370m, batch 4 x 2048: (4, 8, 256, 32,
// 64), n 128, B and C from one group): x, y, dA and B, C once per group,
// 143.7 MB = 0.043 ms at 3.35 TB/s; 12.9 GFLOP of products on the lower
// triangle, at three TF32 products each (495 TFLOP/s), 0.078 ms:
// operations. With G shared by the heads the kernels do 0.34 of those
// products.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;            // rows per l tile and per s tile
constexpr int kThreads = 128;     // 4 warps of 16 rows
constexpr int kLS = kT + 8;       // row stride of the G and decay tiles
constexpr int kSmemMax = 232448;  // a block's shared memory on sm_90

struct Strides { long long b, c, l, h; };   // elements, of (b, nc, cl, h)

struct Params {
  const float* x; const float* dA; const float* B; const float* C;
  float* y;
  float* G;         // (b, nc, gh, clt, clt) scratch, lower-triangle tiles
  Strides sx, sdA, sB, sC, sy;
  int nc, cl, h, n;
  int gh;           // G per group: 1 (B, C shared by the heads) or h
  int clt;          // cl rounded up to the tile
  int vec;          // every row of x, B, C 16-byte aligned, n % 4 == 0
};

inline int round8(int n) { return (n + 7) / 8 * 8; }

inline size_t gram_smem_bytes(int n) {
  return sizeof(float) * 2 * static_cast<size_t>(kT) * (round8(n) + 4);
}

inline size_t smem_bytes(int p, int cl) {
  const size_t cl_tiles = (cl + kT - 1) / kT * kT;
  return sizeof(float) *
         (static_cast<size_t>(kT) * (2 * kLS + p + 4) + 3 * kT + cl_tiles);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// four 8 x 4 f32 matrices (8 x 8 of b16); lanes 8i .. 8i + 7 address the
// rows of matrix i, and each lane gets element (lane / 4, lane % 4) of each
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)) : "memory");
}

// x to TF32, to nearest with ties away from zero: cvt.rna.tf32.f32 on
// finite values, as two integer ops on the bits (they issue at a higher
// rate than the conversion instruction; the kernel splits ~10^3 values
// per warp and tile)
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

// 3xTF32: d += a * b from split operands, lo.lo dropped
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bh0, bh1);
}

// rows [r0, r0 + 64) of a (rows, w) matrix with row stride `ld` into a
// [64][ld_s] tile, zero-filled past row `end` and from column w to W (a
// multiple of 8 >= w); a warp per row, its lanes along the row; cp.async,
// committed and waited for by the caller
__device__ __forceinline__ void load_rows(float* dst, int ld_s,
                                          const float* src, long long ld,
                                          int r0, int end, int w, int W,
                                          bool vec, int warp, int lane) {
  for (int r = warp; r < kT; r += kThreads / 32) {
    const bool in = r0 + r < end;
    const float* srow = src + (r0 + r) * ld;
    float* drow = dst + r * ld_s;
    if (vec) {                     // w % 4 == 0 and 16-byte aligned rows
      for (int c = 4 * lane; c < W; c += 128) {
        if (in && c < w)
          cp_async16(drow + c, srow + c);
        else
          *reinterpret_cast<float4*>(drow + c) =
              make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
      for (int c = lane; c < W; c += 32) {
        if (in && c < w)
          cp_async4(drow + c, srow + c);
        else
          drow[c] = 0.f;
      }
    }
  }
}

// G tile (lt, st) of (b, chunk, group): blockIdx.x enumerates the pairs
// st <= lt, blockIdx.y the chunk, blockIdx.z = b * gh + group
__global__ void __launch_bounds__(kThreads) ssd_gram_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int n = p.n, NP = (n + 7) / 8 * 8, NS = NP + 4;
  float* Cs = smem;                // [kT][NS]  C rows of the l tile
  float* Bs = Cs + kT * NS;        // [kT][NS]  B rows of the s tile

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;          // fragment row, column
  const int w0 = warp * 16;                        // the warp's rows
  int lt = 0;
  while ((lt + 1) * (lt + 2) / 2 <= static_cast<int>(blockIdx.x)) ++lt;
  const int st = blockIdx.x - lt * (lt + 1) / 2;
  const int c = blockIdx.y, b = blockIdx.z / p.gh, gi = blockIdx.z % p.gh;
  load_rows(Cs, NS, p.C + b * p.sC.b + c * p.sC.c + gi * p.sC.h, p.sC.l,
            lt * kT, p.cl, n, NP, p.vec != 0, warp, lane);
  load_rows(Bs, NS, p.B + b * p.sB.b + c * p.sB.c + gi * p.sB.h, p.sB.l,
            st * kT, p.cl, n, NP, p.vec != 0, warp, lane);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // n8 tile j holds s = 8j .. 8j + 7 of the tile; sacc[j][2r + e] is row
  // w0 + g + 8r, s = 8j + 2t + e. All 8 tiles as straight-line code: the
  // 8 independent accumulators hide the latency of each one's dependent
  // products (a branch per tile would serialise them)
  float sacc[8][4], slo[8][4];     // hi.hi, and hi.lo + lo.hi apart
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sacc[j][e] = slo[j][e] = 0.f;
#pragma unroll 2
  for (int k0 = 0; k0 < NP; k0 += 8) {
    uint32_t ar[4], ah[4], al[4];
    ldsm_x4(ar, Cs + (w0 + (lane & 7) + ((lane >> 3) & 1) * 8) * NS + k0 +
                    (lane >> 4) * 4);
#pragma unroll
    for (int e = 0; e < 4; ++e) split(__uint_as_float(ar[e]), ah[e], al[e]);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {   // s tiles 2jj and 2jj + 1
      uint32_t br[4], bh[4], bl[4];
      ldsm_x4(br, Bs + (16 * jj + (lane & 7) + (lane >> 4) * 8) * NS + k0 +
                      ((lane >> 3) & 1) * 4);
#pragma unroll
      for (int e = 0; e < 4; ++e) split(__uint_as_float(br[e]), bh[e], bl[e]);
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        float (&d)[4] = sacc[2 * jj + h2];
        float (&dl)[4] = slo[2 * jj + h2];
        mma_tf32(dl, ah, bl[2 * h2], bl[2 * h2 + 1]);
        mma_tf32(dl, al, bh[2 * h2], bh[2 * h2 + 1]);
        mma_tf32(d, ah, bh[2 * h2], bh[2 * h2 + 1]);
      }
    }
  }

  float* G = p.G + ((static_cast<long long>(b) * p.nc + c) * p.gh + gi) *
                       p.clt * p.clt +
             static_cast<long long>(lt) * kT * p.clt + st * kT;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* grow = G + (w0 + g + 8 * r) * p.clt + 2 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(grow + 8 * j) =
          make_float2(sacc[j][2 * r] + slo[j][2 * r],
                      sacc[j][2 * r + 1] + slo[j][2 * r + 1]);
  }
}

template <int P>
__global__ void __launch_bounds__(kThreads) ssd_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int XS = P + 4;        // row stride of Xs
  constexpr int NX = P / 8;        // n8 tiles of Y
  float* Gs = smem;                // [kT][kLS] G tile (l tile, s tile)
  float* Xs = Gs + kT * kLS;       // [kT][XS]  X rows of the s tile
  float* Ls = Xs + kT * XS;        // [kT][kLS] decay
  float* dAs = Ls + kT * kLS;      // [kT]      dA of the l tile
  float* tot = dAs + kT;           // [2][kT]   per-half column sums
  float* colsum = tot + 2 * kT;    // [cl]      sum_{i=s+1..l0-1} dA[i]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;          // fragment row, column
  const int sl = tid & (kT - 1), half = tid >> 6;  // decay: column, half
  const int w0 = warp * 16;                        // the warp's rows
  const int hh = blockIdx.x, c = blockIdx.y, b = blockIdx.z, cl = p.cl;
  const int gi = p.gh == 1 ? 0 : hh;
  const float* x = p.x + b * p.sx.b + c * p.sx.c + hh * p.sx.h;
  const float* dA = p.dA + b * p.sdA.b + c * p.sdA.c + hh * p.sdA.h;
  const float* G = p.G + ((static_cast<long long>(b) * p.nc + c) * p.gh +
                          gi) * p.clt * p.clt;
  float* y = p.y + b * p.sy.b + c * p.sy.c + hh * p.sy.h;
  const bool vec = p.vec != 0;

  for (int l0 = 0; l0 < cl; l0 += kT) {
    // the last tile's reads of dAs ended at its final barrier
    if (tid < kT)
      dAs[tid] = l0 + tid < cl ? dA[(l0 + tid) * p.sdA.l] : 0.f;
    __syncthreads();               // dAs written

    float yacc[NX][4];
#pragma unroll
    for (int j = 0; j < NX; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[j][e] = 0.f;

    for (int s0 = 0; s0 <= l0; s0 += kT) {
      // G's tiles are whole (zero past cl) and 16-byte aligned
      load_rows(Gs, kLS, G + s0, p.clt, l0, l0 + kT, kT, kT, true, warp,
                lane);
      load_rows(Xs, XS, x, p.sx.l, s0, cl, P, P, vec, warp, lane);
      cp_async_commit();           // in flight while the decay is built

      // decay Ls[l][s] = exp(sum_{i=s+1..l} dA[i]) for l >= s, else 0;
      // thread (sl, half) sums rows 32 half .. 32 half + 31 of column s
      const bool diag = s0 == l0;
      const int s = s0 + sl;
      float base = diag ? 0.f : colsum[s];
      float run = 0.f, part[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int ll = half * 32 + r;
        if (!diag || ll > sl) run += dAs[ll];
        part[r] = run;
      }
      tot[half * kT + sl] = run;
      __syncthreads();             // tot written; every colsum[s] read
      if (half) base += tot[sl];
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int ll = half * 32 + r;
        const bool ok = (!diag || ll >= sl) && l0 + ll < cl && s < cl;
        Ls[ll * kLS + sl] = ok ? expf(base + part[r]) : 0.f;
      }
      if (half) colsum[s] = base + run;   // through the l tile's end
      cp_async_wait_all();
      __syncthreads();             // Ls written; G and X tiles landed

      // Y += (G o L) X over the k8 steps j (s = 8j + 2t at position t,
      // 8j + 2t + 1 at position t + 4); on a diagonal tile a warp skips
      // the steps wholly above its rows (their L is 0)
      const int jmax = diag ? 2 * warp + 2 : 8;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= jmax) continue;
        const int o0 = (w0 + g) * kLS + 8 * j + 2 * t, o1 = o0 + 8 * kLS;
        const float2 s0v = *reinterpret_cast<const float2*>(Gs + o0);
        const float2 s1v = *reinterpret_cast<const float2*>(Gs + o1);
        const float2 d0 = *reinterpret_cast<const float2*>(Ls + o0);
        const float2 d1 = *reinterpret_cast<const float2*>(Ls + o1);
        uint32_t ah[4], al[4];
        split(s0v.x * d0.x, ah[0], al[0]);
        split(s1v.x * d1.x, ah[1], al[1]);
        split(s0v.y * d0.y, ah[2], al[2]);
        split(s1v.y * d1.y, ah[3], al[3]);
        const float* xr = Xs + (8 * j + 2 * t) * XS + g;
#pragma unroll
        for (int pn = 0; pn < NX; ++pn) {
          uint32_t xh0, xl0, xh1, xl1;
          split(xr[pn * 8], xh0, xl0);
          split(xr[pn * 8 + XS], xh1, xl1);
          mma3(yacc[pn], ah, al, xh0, xh1, xl0, xl1);
        }
      }
      __syncthreads();             // Gs, Xs, Ls free for the next s tile
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int l = l0 + w0 + g + 8 * r;
      if (l >= cl) continue;
      float* yr = y + l * p.sy.l + 2 * t;
#pragma unroll
      for (int pn = 0; pn < NX; ++pn)
        *reinterpret_cast<float2*>(yr + pn * 8) =
            make_float2(yacc[pn][2 * r], yacc[pn][2 * r + 1]);
    }
  }
}

template <typename Kernel>
int launch(Kernel kernel, size_t smem, dim3 grid, const Params& p,
           cudaStream_t stream) {
  if (smem > static_cast<size_t>(kSmemMax))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int launch_both(const Params& p, int b, cudaStream_t stream) {
  const int tiles = p.clt / kT;
  int rc = launch(ssd_gram_kernel, gram_smem_bytes(p.n),
                  dim3(tiles * (tiles + 1) / 2, p.nc, b * p.gh), p, stream);
  if (rc != 0) return rc;
  return launch(ssd_kernel<P>, smem_bytes(P, p.cl), dim3(p.h, p.nc, b), p,
                stream);
}

Strides strides_at(const long long* s) { return {s[0], s[1], s[2], s[3]}; }

bool rows16(const void* ptr, const Strides& s) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && s.b % 4 == 0 &&
         s.c % 4 == 0 && s.l % 4 == 0 && s.h % 4 == 0;
}

}  // namespace

// C entry point (bound with ctypes). strides: 20 element strides, (b, nc,
// cl, h) of x, dA, B, C and y in that order; the last dimension of x, B,
// C and y must be contiguous and y's rows 8-byte aligned (the wrapper
// checks; it allocates y). gram: scratch of (b, nc, gh, clt, clt) f32,
// clt = cl rounded up to 64, 16-byte aligned; gh = 1 when B and C have a
// head stride of 0 (one G for every head), else h. Launches
// ssd_gram_kernel, then ssd_kernel, on `stream`. Returns the first
// nonzero cudaGetLastError() after a launch, or cudaErrorInvalidValue for
// a shape the kernels do not take (p not 32, 64 or 128; n or cl too large
// for shared memory; a grid too large).
extern "C" int ssd_intra_chunk_launch(const void* x, const void* dA,
                                      const void* B, const void* C, void* y,
                                      void* gram, const long long* strides,
                                      int b, int nc, int cl, int h, int p,
                                      int n, int gh, void* stream) {
  if (b <= 0 || b > 65535 || nc <= 0 || nc > 65535 || cl <= 0 || h <= 0 ||
      n <= 0 || (gh != 1 && gh != h) ||
      static_cast<long long>(b) * gh > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params prm;
  prm.x = static_cast<const float*>(x);
  prm.dA = static_cast<const float*>(dA);
  prm.B = static_cast<const float*>(B);
  prm.C = static_cast<const float*>(C);
  prm.y = static_cast<float*>(y);
  prm.G = static_cast<float*>(gram);
  prm.sx = strides_at(strides);
  prm.sdA = strides_at(strides + 4);
  prm.sB = strides_at(strides + 8);
  prm.sC = strides_at(strides + 12);
  prm.sy = strides_at(strides + 16);
  prm.nc = nc; prm.cl = cl; prm.h = h; prm.n = n; prm.gh = gh;
  prm.clt = (cl + kT - 1) / kT * kT;
  prm.vec = n % 4 == 0 && rows16(x, prm.sx) && rows16(B, prm.sB) &&
            rows16(C, prm.sC);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 32: return launch_both<32>(prm, b, s);
    case 64: return launch_both<64>(prm, b, s);
    case 128: return launch_both<128>(prm, b, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory per block of ssd_gram_kernel (which = 0) at state
// size n, or of ssd_kernel (which = 1) at head_dim p and chunk length cl,
// in bytes.
extern "C" long long ssd_intra_chunk_smem_bytes(int which, int p, int n,
                                                int cl) {
  return static_cast<long long>(which == 0 ? gram_smem_bytes(n)
                                           : smem_bytes(p, cl));
}
