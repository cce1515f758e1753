// Kernel B: a DFT of length n <= 1024 along the minor axis whose length
// has no FFT form of its own (a complex n with a prime of 13 or more and,
// above 512, no two-pass split, such as 13, 416 = 2^5 x 13, 509, 521, 997
// or 1021; a real n that is odd, such as 135 or 375, or whose half has such
// a prime, such as 510, 520 or 1022, whose halves 255 = 3 x 5 x 17, 260 =
// 4 x 5 x 13 and 511 = 7 x 73 have them), as Bluestein's chirp-z FFT:
// with w[j] = e^(sign i pi j^2 / n), j k = (j^2 + k^2 - (k - j)^2) / 2 gives
//
//   X[k] = w[k] sum_j (x[j] w[j]) conj(w[k - j]),
//
// a circular convolution of length M run as two length-M FFTs: a[j] =
// x[j] w[j] zero-padded to M, A = FFT_M(a), A times the plan-time
// spectrum B = FFT_M(conj(w) wrapped) / M (the caller's scale folded in),
// the inverse FFT_M, times w[k]. M (ops/dft.py: bluestein_length) is the
// smallest 2^a 3^b 5^c >= 2 n - 1 whose balanced split M = m1 m2 (m1 the
// largest divisor up to sqrt(M)) has factors from 2 to 32 or even ones of
// at most 64 (25 = 5 x 5 for 13, 200 = 10 x 20 for 100, 1080 = 30 x 36 for
// 521, 2000 = 40 x 50 for 997, 2048 = 32 x 64 for 1021 and 1022). Above
// 512 it is the port's counterpart of the JAX package's direct matmul DFT
// of such an axis (spfft_tpu/ops/dft.py, an XLA dot, not a Pallas kernel);
// up to 512 it stands for the Pallas stage kernels' dense product
// (spfft_tpu/ops/dft_kernel.py: pdft_last, :165, and _kernel2, :277).
// Either way it replaces the port's dense n x n product (dft2.cu), whose
// n^2 operations put its design bound above one torch.fft call (1.61 ms at
// 521 in the distributed C2C xy stage; 2.83 ms at 448 over a 448^3
// sphere's z sticks).
//
// Modes (dft2.cu's TileMode numbers): 0 cc, complex rows to complex bins;
// 1 rc, real rows (a zero imaginary part) to the bins of the half-spectrum
// window; 2 cr, the half-spectrum window (bin k times 1 for the
// self-conjugate bins 0 and n/2, 2 for the others: _irdft_mats' weights;
// every bin of the upper half 0) to the real part of the backward DFT.
// The input window costs nothing: a[j] is zero outside it. Input element
// q sits at position (x0 + q) mod L_in (L_in = n, or n/2 + 1 in mode cr),
// output o is position (y0 + o) mod L_out (n, or n/2 + 1 in mode rc);
// stores straight (y[g N + o]) or transposed within planes of plane_rows
// = A > 0 rows (row g = p A + a at y[(p N + o) A + a]).
//
// One block holds R whole rows of M in shared memory (the pass-1 layout P,
// sub-row (r, i2) of m1, and the pass-2 layout Q, sub-row (r, k1) of m2;
// bluestein.cuh holds the pieces this kernel shares with the fused z
// kernels of fused_bluestein.cu)
// and runs both FFTs as kernel A's four-step FFT (fft_long.cu): (S1) a
// work item takes column (r, i2), the m1 values a[i1 m2 + i2] made on the
// fly from the input and the chirp (loads coalesced across the warp), its
// FFT in registers, times W_M^(i2 k1) into Q; (S2) an item takes sub-row
// (r, k1): its FFT over i2 (bins k = k2 m1 + k1), times B[k], conjugated,
// back into the sub-row, the FFT over k2 again (bins j_a), times W_M^(k1
// j_a), into P; (S3) an item takes sub-row (r, j_a): its FFT over k1 (bins
// j_b) gives the conjugate of the convolution at j = j_a + m2 j_b, times
// w[j], stored straight from the registers or, for the transposed store,
// through P. The inverse FFT is the forward one between two conjugations,
// its passes in the reverse order, so every FFT reads the same forward
// tables and no bin is put in natural order in between. Three barriers a
// block; device memory sees each input element read once and each output
// element written once; the chirp, B and the twiddles (a few KB, shared by
// every block) are read through the read-only cache (L1).
//
// Registers set the pace (a phase's ablation showed the FFTs' latency, not
// memory, holding the block): a float factor above 32 is held by a lane
// pair (fft_reg.cuh: pair_fft), so every float row fits 128 registers and
// an SM holds two blocks (16 warps), where rows of 64 in one thread took
// 255 registers, one block and 8 warps, and ran 1.8x slower at 1021. The
// double instance holds rows of at most 32 in one thread; a longer double
// factor takes the shared-memory path in the same kernel (fft_reg.cuh:
// smem_rows), chosen at plan time (paths bit 0: m1, bit 1: m2).
//
// Every table is computed in float64 on the host and rounded once to T:
// the chirp w (2, n) with j^2 reduced mod 2n, B (2, M), and the forward
// twiddles e^(-2 pi i m / M) (2, M). No __sinf.
//
// Bound on the H100: bytes, for the function (each row read once and
// written once); the design does 2 x 5 M log2 M + 8 M FLOP a row, about
// 2.4x a length-n FFT's, which at 521 (M = 1080) is 0.11 ms for the 65,536
// rows of the distributed C2C xy stage against 0.16 ms of bytes. The
// templates on T (real.cuh) give the float and double instances (entries
// spfft_bluestein and spfft_bluestein_f64).

#include "bluestein.cuh"

using namespace spfft;
using namespace spfft::fft;

namespace {

enum BlueMode { BL_CC = 0, BL_RC = 1, BL_CR = 2 };

}  // namespace

// every register length of fft_reg.cuh
using KernelLens = BlueLens<2, 64>;

// a[j] of row g: the input at position j of the window (mode cr: times the
// hermitian weight) times w[j], or 0
template <class T>
__device__ __forceinline__ void bl_input(int mode, const T* __restrict__ xr,
                                         const T* __restrict__ xi,
                                         const T* __restrict__ chirp,
                                         long long g, int K, int n, int lin,
                                         int x0, int j, T& re, T& im) {
  re = im = T(0);
  if (j >= lin) return;
  int q = j - x0;
  if (q < 0) q += lin;
  if (q >= K) return;
  T ar = xr[g * K + q];
  T ai = mode == BL_RC ? T(0) : xi[g * K + q];
  if (mode == BL_CR && j != 0 && 2 * j != n) {
    ar += ar;
    ai += ai;
  }
  const T c = ro(chirp + j), s = ro(chirp + n + j);
  re = ar * c - ai * s;
  im = ar * s + ai * c;
}

// `rows` rows a block (count rows in all); s1 / s2 the factors (m1, m2:
// length, radices; sign -1, the tables' forward sign).
template <class T>
__global__ void __launch_bounds__(BL_THREADS, (BlueOcc<T>::BLOCKS))
    bluestein_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                     T* __restrict__ yr, T* __restrict__ yi,
                     const T* __restrict__ chirp, const T* __restrict__ spec,
                     const T* __restrict__ tw, long long count, int K, int N,
                     int plane_rows, int n, int x0, int y0, int rows,
                     FftSpec<T> s1, FftSpec<T> s2, int mode, int paths) {
  extern __shared__ float4 smem4[];
  T* smem = reinterpret_cast<T*>(smem4);
  const int m1 = s1.n, m2 = s2.n, mm = m1 * m2;
  const int st1 = row_stride(m1), st2 = row_stride(m2);
  // float rows always run in registers (the launcher refuses any other
  // path), so a float instance holds no shared-memory FFT
  constexpr bool FLOAT = sizeof(T) == 4;
  const bool reg1 = FLOAT || (paths & 1), reg2 = FLOAT || (paths & 2);
  const int wp = rows * m2 * st1, wq = rows * m1 * st2;
  T* pr = smem;  // pass-1 layout: sub-row (r, i2) of m1
  T* pi = pr + wp;
  T* qr = pi + wp;  // pass-2 layout: sub-row (r, k1) of m2
  T* qi = qr + wq;
  T* t1r = qi + wq;  // the factors' tables
  T* t1i = t1r + m1;
  T* t2r = t1i + m1;
  T* t2i = t2r + m2;
  for (int m = threadIdx.x; m < m1; m += blockDim.x) {
    t1r[m] = tw[m * m2];
    t1i[m] = tw[mm + m * m2];
  }
  for (int m = threadIdx.x; m < m2; m += blockDim.x) {
    t2r[m] = tw[m * m1];
    t2i[m] = tw[mm + m * m1];
  }
  const long long g0 = (long long)blockIdx.x * rows;
  const int valid = (int)min((long long)rows, count - g0);
  const int lin = mode == BL_CR ? n / 2 + 1 : n;
  const int lout = mode == BL_RC ? n / 2 + 1 : n;
  // a lane pair for a row above 32: two work items a row, (c2 >> 1, b)
  const int p1 = m1 > 32 ? 2 : 1, p2 = m2 > 32 ? 2 : 1;
  const int b1 = m1 > 32 ? (threadIdx.x & 1) : 0;
  const int b2 = m2 > 32 ? (threadIdx.x & 1) : 0;
  __syncthreads();

  // S1: a[j] = x[j] w[j] at j = i1 m2 + i2, FFT_M's pass over i1, times
  // W_M^(i2 k1), into the pass-2 layout
  if (reg1) {
    bl_len<T, KernelLens>(m1, [&](auto len) {
      constexpr int L = decltype(len)::value;
      for (int c2 = threadIdx.x; c2 < valid * m2 * p1; c2 += blockDim.x) {
        const int c = c2 / p1;  // column (r, i2)
        const int r = c / m2;
        const int i2 = c - r * m2;
        T* o_r = qr + r * L * st2 + pad(i2);
        T* o_i = qi + r * L * st2 + pad(i2);
        // loads coalesced across the warp (neighbouring i2)
        bl_row<L, T>(
            b1, t1r, t1i,
            [&](int i1, T& re, T& im) {
              bl_input(mode, xr, xi, chirp, g0 + r, K, n, lin, x0,
                       i1 * m2 + i2, re, im);
            },
            [&](int k1, T re, T im) {
              bl_tw_put(re, im, i2, k1, tw, mm, o_r, o_i, st2);
            });
      }
    });
  } else if constexpr (!FLOAT) {
    for (int f = threadIdx.x; f < valid * mm; f += blockDim.x) {
      const int r = f / mm;
      const int j = f - r * mm;
      const int i1 = j / m2;
      const int o = (r * m2 + j - i1 * m2) * st1 + pad(i1);
      bl_input(mode, xr, xi, chirp, g0 + r, K, n, lin, x0, j, pr[o], pi[o]);
    }
    __syncthreads();
    smem_rows<false>(pr, pi, valid * m2, st1, s1, t1r, t1i);
    for (int f = threadIdx.x; f < valid * mm; f += blockDim.x) {
      const int r = f / mm;  // (r, i2, k1), k1 fastest
      const int i2 = (f - r * mm) / m1;
      const int k1 = f - r * mm - i2 * m1;
      const int o = (r * m2 + i2) * st1 + pad(k1);
      bl_tw_put(pr[o], pi[o], i2, k1, tw, mm,
                qr + (r * m1) * st2 + pad(i2), qi + (r * m1) * st2 + pad(i2),
                st2);
    }
  }
  __syncthreads();

  // S2: FFT_M's pass over i2 (bins k = k2 m1 + k1), times B[k],
  // conjugated, back into the sub-row; the second FFT's pass over k2 (bins
  // j_a), times W_M^(k1 j_a), into the pass-1 layout
  if (reg2) {
    bl_len<T, KernelLens>(m2, [&](auto len) {
      constexpr int L = decltype(len)::value;
      for (int c2 = threadIdx.x; c2 < valid * m1 * p2; c2 += blockDim.x) {
        const int c = c2 / p2;  // sub-row (r, k1)
        const int r = c / m1;
        const int k1 = c - r * m1;
        T* q_r = qr + c * st2;
        T* q_i = qi + c * st2;
        bl_row<L, T>(
            b2, t2r, t2i,
            [&](int q, T& re, T& im) {
              re = q_r[pad(q)];
              im = q_i[pad(q)];
            },
            [&](int k2, T re, T im) {
              const T br = ro(spec + k2 * m1 + k1);
              const T bi = ro(spec + mm + k2 * m1 + k1);
              q_r[pad(k2)] = re * br - im * bi;
              q_i[pad(k2)] = -(re * bi + im * br);
            });
        // a pair's lanes read the bins the other wrote
        if (p2 == 2) __syncwarp(pair_mask());
        T* o_r = pr + r * L * st1 + pad(k1);
        T* o_i = pi + r * L * st1 + pad(k1);
        bl_row<L, T>(
            b2, t2r, t2i,
            [&](int q, T& re, T& im) {
              re = q_r[pad(q)];
              im = q_i[pad(q)];
            },
            [&](int ja, T re, T im) {
              bl_tw_put(re, im, k1, ja, tw, mm, o_r, o_i, st1);
            });
      }
    });
  } else if constexpr (!FLOAT) {
    smem_rows<false>(qr, qi, valid * m1, st2, s2, t2r, t2i);
    for (int f = threadIdx.x; f < valid * mm; f += blockDim.x) {
      const int c = f / m2;  // sub-row (r, k1), position k2
      const int k2 = f - c * m2;
      const int k = k2 * m1 + c - (c / m1) * m1;
      const int o = c * st2 + pad(k2);
      const T b_r = ro(spec + k), b_i = ro(spec + mm + k);
      const T ar = qr[o], ai = qi[o];
      qr[o] = ar * b_r - ai * b_i;
      qi[o] = -(ar * b_i + ai * b_r);
    }
    __syncthreads();
    smem_rows<false>(qr, qi, valid * m1, st2, s2, t2r, t2i);
    for (int f = threadIdx.x; f < valid * mm; f += blockDim.x) {
      const int c = f / m2;  // sub-row (r, k1), position j_a
      const int ja = f - c * m2;
      const int r = c / m1;
      const int k1 = c - r * m1;
      const int o = c * st2 + pad(ja);
      bl_tw_put(qr[o], qi[o], k1, ja, tw, mm,
                pr + (r * m2) * st1 + pad(k1), pi + (r * m2) * st1 + pad(k1),
                st1);
    }
  }
  __syncthreads();

  // S3: the pass over k1 (bins j_b): sub-row (r, j_a), bin j_b is the
  // conjugate u of the convolution at j = j_a + m2 j_b, and y[j] = conj(u)
  // w[j]. Straight stores go from the registers (neighbouring threads on
  // neighbouring j); the transposed store and the shared-memory path keep
  // u in the sub-row for the loop below.
  if (reg1) {
    const bool direct = plane_rows == 0;
    bl_len<T, KernelLens>(m1, [&](auto len) {
      constexpr int L = decltype(len)::value;
      for (int c2 = threadIdx.x; c2 < valid * m2 * p1; c2 += blockDim.x) {
        const int c = c2 / p1;  // sub-row (r, j_a)
        const int r = c / m2;
        const int ja = c - r * m2;
        T* p_r = pr + c * st1;
        T* p_i = pi + c * st1;
        const long long g = (g0 + r) * N;
        bl_row<L, T>(
            b1, t1r, t1i,
            [&](int q, T& re, T& im) {
              re = p_r[pad(q)];
              im = p_i[pad(q)];
            },
            [&](int jb, T re, T im) {
              if (!direct) {  // both lanes of a pair read before any writes
                p_r[pad(jb)] = re;
                p_i[pad(jb)] = im;
                return;
              }
              const int j = ja + jb * m2;
              if (j >= lout) return;
              int o = j - y0;
              if (o < 0) o += lout;
              if (o >= N) return;
              const T cw = ro(chirp + j), sw = ro(chirp + n + j);
              yr[g + o] = re * cw + im * sw;
              if (mode != BL_CR) yi[g + o] = re * sw - im * cw;
            });
      }
    });
    if (direct) return;
  } else if constexpr (!FLOAT) {
    smem_rows<false>(pr, pi, valid * m2, st1, s1, t1r, t1i);
  }
  __syncthreads();

  // the output window from the pass-1 layout: straight (o fastest) or
  // transposed within planes (rows fastest, so that neighbouring threads
  // write neighbouring a of one plane)
  const long long p0 = plane_rows ? g0 / plane_rows : 0;
  const int a0 = plane_rows ? (int)(g0 - p0 * plane_rows) : 0;
  for (int f = threadIdx.x; f < valid * N; f += blockDim.x) {
    int r, o;
    if (plane_rows == 0) {
      r = f / N;
      o = f - r * N;
    } else {
      o = f / valid;
      r = f - o * valid;
    }
    int j = y0 + o;
    if (j >= lout) j -= lout;
    const int jb = j / m2;
    const int e = (r * m2 + j - jb * m2) * st1 + pad(jb);
    const T ur = pr[e], ui = pi[e];
    const T cw = ro(chirp + j), sw = ro(chirp + n + j);
    long long d;
    if (plane_rows == 0) {
      d = (g0 + r) * N + o;
    } else {
      int a = a0 + r;
      long long p = p0;
      if (a >= plane_rows) {
        const int q = a / plane_rows;
        a -= q * plane_rows;
        p += q;
      }
      d = (p * N + o) * plane_rows + a;
    }
    yr[d] = ur * cw + ui * sw;
    if (mode != BL_CR) yi[d] = ur * sw - ui * cw;
  }
}

namespace {

template <class T>
int launch_bluestein(int mode, const T* xr, const T* xi, T* yr, T* yi,
                     const T* chirp, const T* spec, const T* tw,
                     long long count, int K, int N, int plane_rows, int n,
                     int x0, int y0, int mm, int m1, int m2, int rad1,
                     int rad2, int paths, void* stream) {
  const int L_in = mode == BL_CR ? n / 2 + 1 : n;
  const int L_out = mode == BL_RC ? n / 2 + 1 : n;
  if (mode < BL_CC || mode > BL_CR || count <= 0 || K < 1 || N < 1 ||
      K > L_in || N > L_out || x0 < 0 || x0 >= L_in || y0 < 0 ||
      y0 >= L_out || plane_rows < 0 ||
      !bl_split_ok<T, KernelLens>(n, mm, m1, m2, paths) ||
      (mode == BL_RC && (K != n || x0 != 0)) ||
      (mode == BL_CR && (N != n || y0 != 0)))
    return (int)cudaErrorInvalidValue;
  int rows, threads;
  size_t smem;
  bl_shape<T>(m1, m2, paths, false, &rows, &threads, &smem);
  auto kernel = bluestein_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((count + rows - 1) / rows);
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      xr, xi, yr, yi, chirp, spec, tw, count, K, N, plane_rows, n, x0, y0,
      rows, FftSpec<T>{m1, -1, T(1), 0, 0, rad1},
      FftSpec<T>{m2, -1, T(1), 0, 0, rad2}, mode, paths);
  return (int)cudaGetLastError();
}

}  // namespace

// The Bluestein DFT of `count` rows in `mode` (0 cc, 1 rc, 2 cr): rows of
// K inputs (xi null in mode rc) at positions (x0 + q) mod L_in into rows of
// N outputs from positions (y0 + o) mod L_out (yi null in mode cr),
// straight (plane_rows 0) or transposed within planes of plane_rows rows;
// n the DFT's length, chirp its (2, n) table w, spec the (2, mm) spectrum
// B (the scale folded in), tw the (2, mm) forward twiddles of the
// convolution's length mm = m1 m2; rad1 / rad2 the factors' stage radices
// (the shared-memory path; 0 for a direct DFT), paths bit 0 / bit 1: m1 /
// m2 in registers. _f64: the same on double operands.
extern "C" int spfft_bluestein(int mode, const float* xr, const float* xi,
                               float* yr, float* yi, const float* chirp,
                               const float* spec, const float* tw,
                               long long count, int K, int N, int plane_rows,
                               int n, int x0, int y0, int mm, int m1, int m2,
                               int rad1, int rad2, int paths, void* stream) {
  return launch_bluestein(mode, xr, xi, yr, yi, chirp, spec, tw, count, K, N,
                          plane_rows, n, x0, y0, mm, m1, m2, rad1, rad2, paths,
                          stream);
}

extern "C" int spfft_bluestein_f64(int mode, const double* xr,
                                   const double* xi, double* yr, double* yi,
                                   const double* chirp, const double* spec,
                                   const double* tw, long long count, int K,
                                   int N, int plane_rows, int n, int x0,
                                   int y0, int mm, int m1, int m2, int rad1,
                                   int rad2, int paths, void* stream) {
  return launch_bluestein(mode, xr, xi, yr, yi, chirp, spec, tw, count, K, N,
                          plane_rows, n, x0, y0, mm, m1, m2, rad1, rad2, paths,
                          stream);
}

// Has a factor of length L a register plan in the kernel of double (f64
// nonzero) or float (fft_reg.cuh: has_plan): the wrapper sets paths by it,
// and a float M (ops/dft.py: bluestein_length) must have one for both.
extern "C" int spfft_bluestein_reg_plan(int L, int f64) {
  return f64 ? bl_reg<double, KernelLens>(L) : bl_reg<float, KernelLens>(L);
}
