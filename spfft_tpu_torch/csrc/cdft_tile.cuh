// Shared device code of the package's DFT kernels (dft2.cu,
// fused_compress.cu): one thread block computes a BM-row slab of a
// matrix product in planar reals of type T (float, or double for
// double-precision plans),
//
//     Y[BM, N] = X[BM, K] * C[K, N],   C = Ma + i Mb, stored as separate
//                                       real and imaginary arrays,
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
// Arithmetic: the plain 4-product complex form with FMA in T on the CUDA
// cores (no tensor cores: TF32 keeps about three decimal digits and fails
// the library's accuracy contract, as Precision.DEFAULT did on the TPU).
// A double block holds BM = 8 rows (TM = 2 a thread, one 16-byte double2
// of X), half a float block's 16, so that its shared memory at K = N =
// 512 (196,736 bytes) fits the 227 KB a block may have.
// Each thread sums one BK-deep slice of the contraction into a fresh
// partial and adds the partial to its running sum. A length-256
// contraction summed in one sequential chain loses about 4e-7 relative
// (l2); in slices of 16 it loses about 1.3e-7, which keeps three passes
// inside predicted_rel_error("single", 256) = 3.35e-7.
// Long axes (K or N above 512, to 1024: kernel B, dft2.cu) no longer fit
// whole: a double block at K = N = 1024 would take 327,808 bytes. There X
// is staged in chunks of KC = 256 k (tile_product_staged), re-read from
// global memory (L2) for each BN-wide pass over the output, and the same
// BK-slice partial sums run over every chunk; Y stays whole, BM (N + 1)
// a plane (double, K = N = 1024: 229,504 bytes with the matrix tile).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "real.cuh"

namespace spfft {

constexpr int BK = 16;        // depth of one matrix tile and of one partial sum
constexpr int BN = 256;       // output columns per pass over the matrix
constexpr int THREADS = 256;  // 4 row groups x 64 column groups
constexpr int TN = 4;         // adjacent columns per thread
constexpr int KC = 256;       // k of one staged chunk of X (long axes)

// The row shape of a T block: TM rows a thread (16 bytes of X: 4 floats,
// 2 doubles), BM = 4 TM rows a block.
template <class T>
struct Rows {
  static constexpr int TM = Real<T>::W;
  static constexpr int BM = 4 * TM;
};

__host__ __device__ inline int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

enum TileMode {
  CC = 0,  // complex X, complex Y: Y = X (Ma + i Mb), 4 FMAs per element
  RC = 1,  // real X: Yr = X Ma, Yi = X Mb, 2 FMAs; no xi buffer
  CR = 2,  // complex X, real Y = Xr Ma + Xi Mb, 2 FMAs; no yi buffer
};

// Dynamic shared memory of one block for a (K, N) matrix: the staged rows
// X (transposed, k-major; with `staged`, one chunk of KC k), one BK x BN
// matrix tile, and the result Y.
template <class T>
__host__ __device__ inline size_t tile_smem_bytes(int K, int N,
                                                  int mode = CC,
                                                  bool staged = false) {
  constexpr int BM = Rows<T>::BM;
  const size_t kp = (size_t)round_up(staged ? min(K, KC) : K, BK);
  const size_t x_planes = mode == RC ? 1 : 2;
  const size_t y_planes = mode == CR ? 1 : 2;
  return sizeof(T) * (x_planes * kp * BM + 2 * (size_t)BK * BN +
                      y_planes * (size_t)BM * (N + 1));
}

template <class T>
struct Tile {
  T* xr;  // [kp][BM]: X[r][k] at xr[k * BM + r]; zero for k >= K
  T* xi;  // null in mode RC
  T* cr;  // [BK][BN] current matrix tile
  T* ci;
  T* yr;  // [BM][ldy]: Y[r][n] at yr[r * ldy + n]
  T* yi;  // null in mode CR
  int kp;
  int ldy;  // N + 1: odd for even N, so a column read is conflict-free
};

template <int MODE, class T>
__device__ inline Tile<T> carve_tile(T* base, int K, int N) {
  constexpr int BM = Rows<T>::BM;
  Tile<T> t;
  t.kp = round_up(K, BK);
  t.ldy = N + 1;
  T* p = base;
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

// Stage the block's rows: load(r, k) returns X[r][k] as a (re, im) pair
// for r < BM, k < K (zero for rows past the end of the operand; im is not
// read in mode RC). Reads walk k fastest, so a dense row source is read
// coalesced.
template <int MODE, class T, class Load>
__device__ inline void stage_rows(const Tile<T>& t, int K, Load load) {
  constexpr int BM = Rows<T>::BM;
  for (int idx = threadIdx.x; idx < BM * t.kp; idx += THREADS) {
    const int r = idx / t.kp;
    const int k = idx - r * t.kp;
    typename Real<T>::Pair v = make_pair(T(0), T(0));
    if (k < K) v = load(r, k);
    t.xr[k * BM + r] = v.x;
    if (MODE != RC) t.xi[k * BM + r] = v.y;
  }
  __syncthreads();
}

// TN consecutive T of shared memory (16-byte aligned) into v
template <class T>
__device__ __forceinline__ void load_tn(const T* p, T (&v)[TN]) {
  constexpr int W = Real<T>::W;
#pragma unroll
  for (int q = 0; q < TN / W; ++q) {
    T w[W];
    load16(p + q * W, w);
#pragma unroll
    for (int t = 0; t < W; ++t) v[q * W + t] = w[t];
  }
}

// acc += X C[kbase .. kbase + kp) for the BN output columns from n0, with
// X's rows kbase .. kbase + kp - 1 staged in the tile (X[r][kbase + k] at
// xr[k * BM + r]); C is (K, N) row-major, real and imaginary parts (Ma,
// Mb) separate. In mode CR the two accumulators hold Xr Ma and Xi Mb.
template <int MODE, class T>
__device__ inline void tile_accumulate(const Tile<T>& t, int kbase, int K,
                                       int N, int n0, const T* __restrict__ cr,
                                       const T* __restrict__ ci,
                                       T (&accr)[Rows<T>::TM][TN],
                                       T (&acci)[Rows<T>::TM][TN]) {
  constexpr int TM = Rows<T>::TM;
  constexpr int BM = Rows<T>::BM;
  const int ty = threadIdx.x / (BN / TN);
  const int tx = threadIdx.x % (BN / TN);
  for (int k0 = 0; k0 < t.kp; k0 += BK) {
    for (int idx = threadIdx.x; idx < BK * BN; idx += THREADS) {
      const int kk = idx / BN;
      const int n = n0 + (idx - kk * BN);
      const int k = kbase + k0 + kk;
      const bool ok = k < K && n < N;
      const size_t g = (size_t)k * N + n;
      t.cr[idx] = ok ? cr[g] : T(0);
      t.ci[idx] = ok ? ci[g] : T(0);
    }
    __syncthreads();

    T pr[TM][TN], pi[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) pr[i][j] = pi[i][j] = T(0);

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      T ar[TM], ai[TM], br[TN], bi[TN];
      load16(t.xr + (k0 + kk) * BM + ty * TM, ar);
      if (MODE != RC) {
        load16(t.xi + (k0 + kk) * BM + ty * TM, ai);
      } else {
#pragma unroll
        for (int i = 0; i < TM; ++i) ai[i] = T(0);
      }
      load_tn(t.cr + kk * BN + tx * TN, br);
      load_tn(t.ci + kk * BN + tx * TN, bi);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          if (MODE == CC) {
            pr[i][j] = fma_t(ar[i], br[j], pr[i][j]);
            pr[i][j] = fma_t(-ai[i], bi[j], pr[i][j]);
            pi[i][j] = fma_t(ar[i], bi[j], pi[i][j]);
            pi[i][j] = fma_t(ai[i], br[j], pi[i][j]);
          } else if (MODE == RC) {
            pr[i][j] = fma_t(ar[i], br[j], pr[i][j]);
            pi[i][j] = fma_t(ar[i], bi[j], pi[i][j]);
          } else {
            pr[i][j] = fma_t(ar[i], br[j], pr[i][j]);
            pi[i][j] = fma_t(ai[i], bi[j], pi[i][j]);
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
}

// The BN output columns from n0 of the accumulators into Y (mode CR: their
// sum).
template <int MODE, class T>
__device__ inline void tile_store(const Tile<T>& t, int N, int n0,
                                  const T (&accr)[Rows<T>::TM][TN],
                                  const T (&acci)[Rows<T>::TM][TN]) {
  constexpr int TM = Rows<T>::TM;
  const int ty = threadIdx.x / (BN / TN);
  const int tx = threadIdx.x % (BN / TN);
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

// Y = X * C for the staged rows in mode MODE; C is (K, N) row-major, real
// and imaginary parts (Ma, Mb) separate. Ends with Y complete in shared
// memory (after a barrier). In mode CR the two accumulators hold Xr Ma
// and Xi Mb, summed in the epilogue, as the plain form sums two products.
template <int MODE, class T>
__device__ inline void tile_product(const Tile<T>& t, int K, int N,
                                    const T* __restrict__ cr,
                                    const T* __restrict__ ci) {
  constexpr int TM = Rows<T>::TM;
  for (int n0 = 0; n0 < N; n0 += BN) {
    T accr[TM][TN], acci[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) accr[i][j] = acci[i][j] = T(0);
    tile_accumulate<MODE>(t, 0, K, N, n0, cr, ci, accr, acci);
    tile_store<MODE>(t, N, n0, accr, acci);
  }
  __syncthreads();
}

// tile_product for a tile whose X holds one chunk of t.kp k (carved for
// min(K, KC)): for each BN-wide pass over the output, every chunk of the
// rows is staged through load(r, k) (stage_rows) and accumulated.
template <int MODE, class T, class Load>
__device__ inline void tile_product_staged(const Tile<T>& t, int K, int N,
                                           const T* __restrict__ cr,
                                           const T* __restrict__ ci,
                                           Load load) {
  constexpr int TM = Rows<T>::TM;
  for (int n0 = 0; n0 < N; n0 += BN) {
    T accr[TM][TN], acci[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) accr[i][j] = acci[i][j] = T(0);
    for (int kbase = 0; kbase < K; kbase += t.kp) {
      stage_rows<MODE>(t, min(t.kp, K - kbase),
                       [&](int r, int k) { return load(r, kbase + k); });
      tile_accumulate<MODE>(t, kbase, K, N, n0, cr, ci, accr, acci);
    }
    tile_store<MODE>(t, N, n0, accr, acci);
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
