// The xy DFT stage of the plan: port of the Pallas kernel
// spfft_tpu/ops/dft_kernel.py:_run2 in its three modes and swap_out,
//
//   "cc" (pdft2):    (P, A, B) --complex DFT over B (mats1, B x B')--> swap
//                    --complex DFT over A (mats2, A x A')--> (P, B', A'),
//   "rc" (prdft2):   real (P, A, B) --real DFT to the half spectrum over B
//                    (r2c matrices)--> swap --complex DFT over A-->
//                    planar (P, B', A'),   the R2C forward head,
//   "cr" (pdft2_cr): planar (P, A, B) --complex DFT over B--> swap --real
//                    inverse DFT over A (c2r matrices, out = Gr Ma + Gi Mb)
//                    --> real (P, B', A'),   the R2C backward tail,
//   "cc" + swap_out (pdft2_swapped): as "cc", stored back as (P, A', B'),
//                    the C2C xy stage of the distributed plan,
//
// in float, or double for double-precision plans (the entry
// spfft_dft_stage_f64), in the matrix form: each DFT a product against plan-time
// matrices. Since the complex stages moved to fft.cu (the FFT stage and
// cluster kernels, for every complex stage whose matrices carry their
// transform and whose length is 2^a 3^b 5^c) and the real stages to
// rfft.cu (the real FFT stage kernel, for every real stage whose matrices
// carry their transform and whose length is even with a 2^a 3^b 5^c
// half), this kernel serves only the rest: real stages of odd length or
// whose half has another prime factor (14, 22, ...), complex stages whose
// length has another prime factor (11, 13, ...), and matrix pairs passed
// without their transform. Each call is one stage kernel launched twice:
// the first launch stores its result transposed within each plane,
// (P, B', A'), and the second contracts the new minor axis and stores
// straight (pdft2_swapped: transposed once more, plane_rows = B'). The
// mode picks the tile product: "rc" a real-input first stage (RC: no
// imaginary operand, 2 FMAs per element), "cr" a real-output second stage
// (CR: 2 FMAs, one output array). The intermediate makes one round trip
// through device memory.
//
// Long axes (kernel B): a side K or N above 512, to 1024 (an unsplittable
// complex length such as 521 or 1021, a real length with no real FFT form
// such as 1022, whose half 511 = 7 x 73), runs the same kernel with its
// rows staged through shared memory in chunks of KC = 256 k
// (cdft_tile.cuh: tile_product_staged), since a whole contraction no
// longer fits a block; the result stays whole in shared memory for the
// same stores. Not cuBLAS: no cuBLAS call runs on the card.
//
// Bound on the H100: operations, for the matrix form. A 256^3 "cc" call
// in this form is 2 x 65,536 rows x 256 x 256 complex multiply-adds,
// 6.9e10 FLOP in the 4-product form, against 268 MB of operand traffic;
// at 67 TFLOP/s FP32 and 3.35 TB/s the FLOPs take about 13x longer than
// the bytes (which is why the complex stages are FFTs now). An "rc" or
// "cr" call at 256^3 (half spectrum 129 wide) is 2.6e10 FLOP against 135
// MB: about 7x. The design keeps every operand element in shared memory
// while it is reused (X for all N outputs of its rows, each matrix tile
// for the block's BM rows) and gives each thread a TM x 4 register tile,
// so the FMA pipe and not memory sets the pace. The ragged half-spectrum
// width (129) is covered by the zero-padded k tail and the n < N masks of
// the tile.

#include "cdft_tile.cuh"

using namespace spfft;

// plane_rows == 0: Y[m][n] stored at y[m * N + n].
// plane_rows == A > 0: row m = p * A + a, Y[m][n] stored at
//                      y[(p * N + n) * A + a] (transposed within a plane).
// xi is not read in mode RC; yi is not written in mode CR.
template <int MODE, bool STAGED, class T>
__global__ void __launch_bounds__(THREADS)
    dft_stage_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                     const T* __restrict__ cr, const T* __restrict__ ci,
                     T* __restrict__ yr, T* __restrict__ yi, long long M,
                     int K, int N, int plane_rows) {
  constexpr int BM = Rows<T>::BM;
  extern __shared__ float4 smem[];
  const Tile<T> t = carve_tile<MODE>(reinterpret_cast<T*>(smem),
                                     STAGED ? min(K, KC) : K, N);
  const long long m0 = (long long)blockIdx.x * BM;
  auto load = [&](int r, int k) {
    const long long m = m0 + r;
    if (m >= M) return make_pair(T(0), T(0));
    const long long g = m * K + k;
    return make_pair(xr[g], MODE == RC ? T(0) : xi[g]);
  };
  if constexpr (STAGED) {
    tile_product_staged<MODE>(t, K, N, cr, ci, load);
  } else {
    stage_rows<MODE>(t, K, load);
    tile_product<MODE>(t, K, N, cr, ci);
  }
  if (plane_rows == 0) {
    for (int idx = threadIdx.x; idx < BM * N; idx += THREADS) {
      const int r = idx / N;
      const int n = idx - r * N;
      const long long m = m0 + r;
      if (m < M) {
        yr[m * N + n] = t.yr[r * t.ldy + n];
        if (MODE != CR) yi[m * N + n] = t.yi[r * t.ldy + n];
      }
    }
  } else {
    // r fastest: neighbouring threads write neighbouring a of one plane
    for (int idx = threadIdx.x; idx < BM * N; idx += THREADS) {
      const int n = idx / BM;
      const int r = idx - n * BM;
      const long long m = m0 + r;
      if (m < M) {
        const long long p = m / plane_rows;
        const long long a = m - p * plane_rows;
        const long long g = (p * N + n) * plane_rows + a;
        yr[g] = t.yr[r * t.ldy + n];
        if (MODE != CR) yi[g] = t.yi[r * t.ldy + n];
      }
    }
  }
}

// the longest side of a contraction held whole in shared memory
constexpr int WHOLE_SIDE_MAX = 512;
// the longest side of any contraction (a long axis)
constexpr int SIDE_MAX = 1024;

template <int MODE, class T>
static int launch_stage(const T* xr, const T* xi, const T* cr, const T* ci,
                        T* yr, T* yi, long long M, int K, int N,
                        int plane_rows, void* stream) {
  constexpr int BM = Rows<T>::BM;
  if (K < 1 || N < 1 || K > SIDE_MAX || N > SIDE_MAX)
    return (int)cudaErrorInvalidValue;
  const bool staged = K > WHOLE_SIDE_MAX || N > WHOLE_SIDE_MAX;
  const size_t smem = tile_smem_bytes<T>(K, N, MODE, staged);
  auto kernel = staged ? dft_stage_kernel<MODE, true, T>
                       : dft_stage_kernel<MODE, false, T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((M + BM - 1) / BM);
  kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      xr, xi, cr, ci, yr, yi, M, K, N, plane_rows);
  return (int)cudaGetLastError();
}

template <class T>
static int launch_mode(int mode, const T* xr, const T* xi, const T* cr,
                       const T* ci, T* yr, T* yi, long long M, int K, int N,
                       int plane_rows, void* stream) {
  switch (mode) {
    case CC:
      return launch_stage<CC>(xr, xi, cr, ci, yr, yi, M, K, N, plane_rows,
                              stream);
    case RC:
      return launch_stage<RC>(xr, xi, cr, ci, yr, yi, M, K, N, plane_rows,
                              stream);
    case CR:
      return launch_stage<CR>(xr, xi, cr, ci, yr, yi, M, K, N, plane_rows,
                              stream);
  }
  return (int)cudaErrorInvalidValue;
}

// One launch of the stage kernel in `mode` (CC, RC or CR of cdft_tile.cuh):
// rows (M, K) of (xr, xi) against the pair (cr, ci) (K, N) into (yr, yi).
// xi is null in mode RC (real rows), yi in mode CR (real output). _f64: the
// same on double operands.
extern "C" int spfft_dft_stage(int mode, const float* xr, const float* xi,
                               const float* cr, const float* ci, float* yr,
                               float* yi, long long M, int K, int N,
                               int plane_rows, void* stream) {
  return launch_mode(mode, xr, xi, cr, ci, yr, yi, M, K, N, plane_rows,
                     stream);
}

extern "C" int spfft_dft_stage_f64(int mode, const double* xr,
                                   const double* xi, const double* cr,
                                   const double* ci, double* yr, double* yi,
                                   long long M, int K, int N, int plane_rows,
                                   void* stream) {
  return launch_mode(mode, xr, xi, cr, ci, yr, yi, M, K, N, plane_rows,
                     stream);
}
