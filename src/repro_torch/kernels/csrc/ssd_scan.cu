// ssd_scan: the Mamba2 SSD intra-chunk term (arXiv:2405.21060).
//
// Replaces the TPU Pallas kernel src/repro/kernels/ssd_scan.py
// (ssd_intra_chunk, body _kernel). Per (batch, chunk, head):
//
//   Y[l, :] = sum_{s <= l} (C[l] . B[s]) * exp(sum_{i=s+1..l} dA[i]) * X[s, :]
//
// xc (b, nc, cl, h, p), dAc (b, nc, cl, h), Bc and Cc (b, nc, cl, h, n),
// all f32 and contiguous; y (b, nc, cl, h, p) f32. IEEE f32 throughout
// (expf, no fast math, no TF32), for the reference's 1e-4.
//
// Layout on Hopper: one block per (b, c, h) walks 64-row tiles of l and,
// within each, the 64-row tiles of s <= l (the upper triangle is never
// computed). At full width (cl 256, n 128) B and C are 128 KB each, more
// than a block's shared memory holds beside each other, so the block
// keeps one 64 x n tile of C (for the l tile) and one of B and X (for
// the s tile) at a time: about 99 KB, two blocks to an SM. 256 threads;
// thread (ty, tx) = (tid / 16, tid % 16) owns rows ty + 16 i (i < 4) and
// columns tx + 16 j of the 64 x 64 score tile and of the Y tile: each
// value read from shared memory feeds 4 FMAs.
//
// The decay is summed per column as a segment sum, the way the plain
// version's segsum does, not as the difference cum[l] - cum[s] of two
// chunk-long prefix sums (as the Pallas kernel does): that difference
// carries the rounding of the whole prefix (|cum| grows along the
// chunk) into every decay near 1, where a segment sum's error scales
// with the segment instead. Each column's sum up to the tile above is
// kept in shared memory (colsum) and 4 threads per column add the
// tile's rows in quarters. The decay is selected, not multiplied by a mask: 0 is
// stored where l < s (where cum[l] - cum[s] is positive, its exp can
// overflow, and inf * 0 is NaN).
//
// Bound at the path's shape (mamba2_370m, batch 4 x 2048: (4, 8, 256, 32,
// 64), n 128): 403.7 MB moved = 0.121 ms at 3.35 TB/s, against 12.9 GFLOP
// on the lower triangle = 0.193 ms at the H100's 67 TFLOP/s of f32
// outside the tensor cores (TF32 is ruled out by the tolerance):
// operations. This first version is bound by shared-memory loads (one
// 4-byte load per 2 FMAs).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;            // rows per l tile and per s tile
constexpr int kThreads = 256;
constexpr int kSmemMax = 232448;  // a block's shared memory on sm_90

struct Params {
  const float* x; const float* dA; const float* B; const float* C;
  float* y;
  int nc, cl, h, n;
};

inline size_t smem_bytes(int p, int n, int cl) {
  const int cl_tiles = (cl + kT - 1) / kT * kT;
  return sizeof(float) * (2 * static_cast<size_t>(kT) * (n + 1) + kT * p +
                          kT * (kT + 1) + kT + 4 * kT + cl_tiles);
}

template <int P>
__global__ void __launch_bounds__(kThreads) ssd_kernel(const Params p) {
  extern __shared__ float smem[];
  constexpr int LS = kT + 1;       // padded row stride of Ls
  constexpr int NJ = P / 16;       // Y columns per thread
  const int NS = p.n + 1;          // padded row stride of Cs and Bs
  float* Cs = smem;                // [kT][NS]  C rows of the l tile
  float* Bs = Cs + kT * NS;        // [kT][NS]  B rows of the s tile
  float* Xs = Bs + kT * NS;        // [kT][P]   X rows of the s tile
  float* Ls = Xs + kT * P;         // [kT][LS]  decay, then scores
  float* dAs = Ls + kT * LS;       // [kT]      dA of the l tile
  float* tot = dAs + kT;           // [4][kT]   per-quarter column sums
  float* colsum = tot + 4 * kT;    // [cl]      sum_{i=s+1..l0-1} dA[i]

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int sl = tid & (kT - 1), qq = tid >> 6;   // decay: column, quarter
  const int hh = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int cl = p.cl, n = p.n, H = p.h;
  // element (b, c, l, hh, :) of a (b, nc, cl, h, width) tensor is at
  // ((row0 + l) * H + hh) * width
  const long long row0 = (static_cast<long long>(b) * p.nc + c) * cl;

  for (int l0 = 0; l0 < cl; l0 += kT) {
    __syncthreads();               // the last l tile's reads are done
    for (int i = tid; i < kT * n; i += kThreads) {
      const int r = i / n, kk = i % n, l = l0 + r;
      Cs[r * NS + kk] = l < cl ? p.C[((row0 + l) * H + hh) * n + kk] : 0.f;
    }
    if (tid < kT) {
      const int l = l0 + tid;
      dAs[tid] = l < cl ? p.dA[(row0 + l) * H + hh] : 0.f;
    }

    float acc[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

    for (int s0 = 0; s0 <= l0; s0 += kT) {
      for (int i = tid; i < kT * n; i += kThreads) {
        const int r = i / n, kk = i % n, s = s0 + r;
        Bs[r * NS + kk] = s < cl ? p.B[((row0 + s) * H + hh) * n + kk] : 0.f;
      }
      for (int i = tid; i < kT * P; i += kThreads) {
        const int r = i / P, j = i % P, s = s0 + r;
        Xs[r * P + j] = s < cl ? p.x[((row0 + s) * H + hh) * P + j] : 0.f;
      }
      __syncthreads();

      // decay Ls[l][s] = exp(sum_{i=s+1..l} dA[i]) for l >= s, else 0;
      // thread (sl, qq) sums rows 16 qq .. 16 qq + 15 of column s
      const bool diag = s0 == l0;
      const int s = s0 + sl;
      float base = diag ? 0.f : colsum[s];
      float run = 0.f, part[16];
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int ll = qq * 16 + r;
        if (!diag || ll > sl) run += dAs[ll];
        part[r] = run;
      }
      tot[qq * kT + sl] = run;
      __syncthreads();             // tot written; every colsum[s] read
      for (int q2 = 0; q2 < qq; ++q2) base += tot[q2 * kT + sl];
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int ll = qq * 16 + r;
        const bool ok = (!diag || ll >= sl) && l0 + ll < cl && s < cl;
        Ls[ll * LS + sl] = ok ? expf(base + part[r]) : 0.f;
      }
      if (qq == 3) colsum[s] = base + run;   // through the l tile's end
      __syncthreads();

      // scores = (C_l . B_s^T) * decay, written over the decay in place
      // (each thread rewrites only the entries it read)
      float sc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < n; ++kk) {
        float a[4], bb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Cs[(ty + 16 * i) * NS + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) bb[j] = Bs[(tx + 16 * j) * NS + kk];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], bb[j], sc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* e = &Ls[(ty + 16 * i) * LS + tx + 16 * j];
          *e = sc[i][j] * *e;
        }
      __syncthreads();

      // Y_l += scores . X_s
#pragma unroll 4
      for (int ss = 0; ss < kT; ++ss) {
        float a[4], xx[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Ls[(ty + 16 * i) * LS + ss];
#pragma unroll
        for (int j = 0; j < NJ; ++j) xx[j] = Xs[ss * P + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], xx[j], acc[i][j]);
      }
      __syncthreads();             // Bs, Xs, Ls free for the next s tile
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = l0 + ty + 16 * i;
      if (l >= cl) continue;
      float* yr = p.y + ((row0 + l) * H + hh) * P;
#pragma unroll
      for (int j = 0; j < NJ; ++j) yr[tx + 16 * j] = acc[i][j];
    }
  }
}

template <int P>
int launch(const Params& p, int b, cudaStream_t stream) {
  const size_t smem = smem_bytes(P, p.n, p.cl);
  if (smem > static_cast<size_t>(kSmemMax))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(p.h, p.nc, b);
  ssd_kernel<P><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point (bound with ctypes). All tensors f32 and contiguous (the
// wrapper checks). Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a shape the kernel does not take (p not 32,
// 64 or 128; n or cl too large for shared memory; a grid too large).
extern "C" int ssd_intra_chunk_launch(const void* x, const void* dA,
                                      const void* B, const void* C, void* y,
                                      int b, int nc, int cl, int h, int p,
                                      int n, void* stream) {
  if (b <= 0 || b > 65535 || nc <= 0 || nc > 65535 || cl <= 0 || h <= 0 ||
      n <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params prm;
  prm.x = static_cast<const float*>(x);
  prm.dA = static_cast<const float*>(dA);
  prm.B = static_cast<const float*>(B);
  prm.C = static_cast<const float*>(C);
  prm.y = static_cast<float*>(y);
  prm.nc = nc; prm.cl = cl; prm.h = h; prm.n = n;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 32: return launch<32>(prm, b, s);
    case 64: return launch<64>(prm, b, s);
    case 128: return launch<128>(prm, b, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
