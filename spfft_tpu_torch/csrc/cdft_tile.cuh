// Shared device code of the package's DFT kernels (dft2.cu,
// fused_compress.cu): one thread block computes a BM-row slab of a
// matrix product in planar f32,
//
//     Y[BM, N] = X[BM, K] * C[K, N],   C = Ma + i Mb, stored as separate
//                                       real and imaginary f32 arrays,
//
// in one of three modes (TileMode): complex X and Y (the complex DFT
// stages), real X (the real forward DFT: Yr = X Ma, Yi = X Mb), or real Y
// (the real inverse DFT: Y = Xr Ma + Xi Mb, hermitian weights folded into
// Ma and Mb at plan time),
//
// where the rows of X are z-sticks or plane lines already staged in shared
// memory by the calling kernel, C is a plan-time DFT matrix (any scale
// folded into its values) read from global memory (it stays in L2: 512 KB
// at 256), and Y is left in shared memory for the calling kernel's
// epilogue (a straight store, a store transposed within each plane, or a
// scatter of sparse values).
//
// Arithmetic: the plain 4-product complex form with FP32 FMA on the CUDA
// cores (no tensor cores: TF32 keeps about three decimal digits and fails
// the library's accuracy contract, as Precision.DEFAULT did on the TPU).
// Each thread sums one BK-deep slice of the contraction into a fresh
// partial and adds the partial to its running sum. A length-256
// contraction summed in one sequential chain loses about 4e-7 relative
// (l2); in slices of 16 it loses about 1.3e-7, which keeps three passes
// inside predicted_rel_error("single", 256) = 3.35e-7.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace spfft {

constexpr int BM = 16;        // rows per block
constexpr int BK = 16;        // depth of one matrix tile and of one partial sum
constexpr int BN = 256;       // output columns per pass over the matrix
constexpr int THREADS = 256;  // 4 row groups x 64 column groups
constexpr int TM = 4;         // rows per thread
constexpr int TN = 4;         // adjacent columns per thread

__host__ __device__ inline int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

enum TileMode {
  CC = 0,  // complex X, complex Y: Y = X (Ma + i Mb), 4 FMAs per element
  RC = 1,  // real X: Yr = X Ma, Yi = X Mb, 2 FMAs; no xi buffer
  CR = 2,  // complex X, real Y = Xr Ma + Xi Mb, 2 FMAs; no yi buffer
};

// Dynamic shared memory of one block for a (K, N) matrix: the staged rows
// X (transposed, k-major), one BK x BN matrix tile, and the result Y.
__host__ __device__ inline size_t tile_smem_bytes(int K, int N,
                                                  int mode = CC) {
  const size_t kp = (size_t)round_up(K, BK);
  const size_t x_planes = mode == RC ? 1 : 2;
  const size_t y_planes = mode == CR ? 1 : 2;
  return sizeof(float) * (x_planes * kp * BM + 2 * (size_t)BK * BN +
                          y_planes * (size_t)BM * (N + 1));
}

struct Tile {
  float* xr;  // [kp][BM]: X[r][k] at xr[k * BM + r]; zero for k >= K
  float* xi;  // null in mode RC
  float* cr;  // [BK][BN] current matrix tile
  float* ci;
  float* yr;  // [BM][ldy]: Y[r][n] at yr[r * ldy + n]
  float* yi;  // null in mode CR
  int kp;
  int ldy;    // N + 1: odd for even N, so a column read is conflict-free
};

template <int MODE>
__device__ inline Tile carve_tile(float* base, int K, int N) {
  Tile t;
  t.kp = round_up(K, BK);
  t.ldy = N + 1;
  float* p = base;
  t.xr = p;
  p += (size_t)t.kp * BM;
  t.xi = nullptr;
  if (MODE != RC) {
    t.xi = p;
    p += (size_t)t.kp * BM;
  }
  t.cr = p;
  t.ci = t.cr + BK * BN;
  t.yr = t.ci + BK * BN;
  t.yi = MODE == CR ? nullptr : t.yr + (size_t)BM * t.ldy;
  return t;
}

// Stage the block's rows: load(r, k) returns X[r][k] as (re, im) for
// r < BM, k < K (zero for rows past the end of the operand; im is not
// read in mode RC). Reads walk k fastest, so a dense row source is read
// coalesced.
template <int MODE, class Load>
__device__ inline void stage_rows(const Tile& t, int K, Load load) {
  for (int idx = threadIdx.x; idx < BM * t.kp; idx += THREADS) {
    const int r = idx / t.kp;
    const int k = idx - r * t.kp;
    float2 v = make_float2(0.f, 0.f);
    if (k < K) v = load(r, k);
    t.xr[k * BM + r] = v.x;
    if (MODE != RC) t.xi[k * BM + r] = v.y;
  }
  __syncthreads();
}

// Y = X * C for the staged rows in mode MODE; C is (K, N) row-major, real
// and imaginary parts (Ma, Mb) separate. Ends with Y complete in shared
// memory (after a barrier). In mode CR the two accumulators hold Xr Ma
// and Xi Mb, summed in the epilogue, as the plain form sums two products.
template <int MODE>
__device__ inline void tile_product(const Tile& t, int K, int N,
                                    const float* __restrict__ cr,
                                    const float* __restrict__ ci) {
  const int ty = threadIdx.x / (BN / TN);
  const int tx = threadIdx.x % (BN / TN);
  for (int n0 = 0; n0 < N; n0 += BN) {
    float accr[TM][TN], acci[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) accr[i][j] = acci[i][j] = 0.f;

    for (int k0 = 0; k0 < t.kp; k0 += BK) {
      for (int idx = threadIdx.x; idx < BK * BN; idx += THREADS) {
        const int kk = idx / BN;
        const int n = n0 + (idx - kk * BN);
        const int k = k0 + kk;
        const bool ok = k < K && n < N;
        const size_t g = (size_t)k * N + n;
        t.cr[idx] = ok ? cr[g] : 0.f;
        t.ci[idx] = ok ? ci[g] : 0.f;
      }
      __syncthreads();

      float pr[TM][TN], pi[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) pr[i][j] = pi[i][j] = 0.f;

#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 xr4 =
            *reinterpret_cast<const float4*>(t.xr + (k0 + kk) * BM + ty * TM);
        float4 xi4 = make_float4(0.f, 0.f, 0.f, 0.f);
        if (MODE != RC)
          xi4 = *reinterpret_cast<const float4*>(t.xi + (k0 + kk) * BM +
                                                 ty * TM);
        const float4 cr4 =
            *reinterpret_cast<const float4*>(t.cr + kk * BN + tx * TN);
        const float4 ci4 =
            *reinterpret_cast<const float4*>(t.ci + kk * BN + tx * TN);
        const float ar[TM] = {xr4.x, xr4.y, xr4.z, xr4.w};
        const float ai[TM] = {xi4.x, xi4.y, xi4.z, xi4.w};
        const float br[TN] = {cr4.x, cr4.y, cr4.z, cr4.w};
        const float bi[TN] = {ci4.x, ci4.y, ci4.z, ci4.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            if (MODE == CC) {
              pr[i][j] = fmaf(ar[i], br[j], pr[i][j]);
              pr[i][j] = fmaf(-ai[i], bi[j], pr[i][j]);
              pi[i][j] = fmaf(ar[i], bi[j], pi[i][j]);
              pi[i][j] = fmaf(ai[i], br[j], pi[i][j]);
            } else if (MODE == RC) {
              pr[i][j] = fmaf(ar[i], br[j], pr[i][j]);
              pi[i][j] = fmaf(ar[i], bi[j], pi[i][j]);
            } else {
              pr[i][j] = fmaf(ar[i], br[j], pr[i][j]);
              pi[i][j] = fmaf(ai[i], bi[j], pi[i][j]);
            }
          }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          accr[i][j] += pr[i][j];
          acci[i][j] += pi[i][j];
        }
      __syncthreads();  // the matrix tile is overwritten next
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = n0 + tx * TN + j;
        if (n < N) {
          if (MODE == CR) {
            t.yr[(ty * TM + i) * t.ldy + n] = accr[i][j] + acci[i][j];
          } else {
            t.yr[(ty * TM + i) * t.ldy + n] = accr[i][j];
            t.yi[(ty * TM + i) * t.ldy + n] = acci[i][j];
          }
        }
      }
  }
  __syncthreads();
}

// Allow a kernel more than the default 48 KB of dynamic shared memory.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace spfft
