// Shared device code of the long-axis kernels (fft_long.cu, bluestein.cu):
// the FFT of one row held by one thread in registers, and the dispatch
// from a run-time length to the compile-time plan that holds it.
//
// A thread keeps a row of length L (2^a 3^b 5^c, at most 64) in two arrays
// of L reals and runs fft_tile.cuh's Stockham stages on them, every loop
// unrolled at compile time: the radices are fft_factors' (as many 4s as
// divide L, then a 2, 3s, 5s: next_radix), every index is a constant, so
// the row never leaves the registers and no stage meets a barrier. The
// twiddles come from the factor's table of L entries in shared memory
// (e^(sign 2 pi i m / L), every (n / L)-th entry of the plan's float64
// table rounded once to T), read at constant offsets: every thread of a
// warp reads the same word, a broadcast. A row of L complex values takes
// 2 L registers: rows of at most 32 fit 128 registers a thread (two
// blocks of 256 threads an SM), where a thread holding 64 needed all 255
// (one block, and too few warps to hide the latencies). So a float row of
// an even length in (32, 64] can be held by a lane pair (pair_fft, the
// Bluestein kernel's): each lane runs the FFT of half the row (its even or
// odd elements) and one shuffle exchange a bin completes the radix-2 step.
// Kernel A (fft_long.cu) keeps its rows in one thread: its lane-pair
// instance spilled at 128 registers and lost up to 16 % at 520 and 1080.
// The double instances hold rows of at most 32 (reg_max); every other
// factor takes the shared-memory FFT.
#pragma once

#include "fft_tile.cuh"

namespace spfft {
namespace fft {

// the radix of the next stage once the stages so far leave `rest` of the
// length (fft_factors' order)
__host__ __device__ constexpr int next_radix(int rest) {
  return rest % 4 == 0 ? 4 : rest % 2 == 0 ? 2 : rest % 3 == 0 ? 3 : 5;
}

// L has the form 2^a 3^b 5^c (L >= 1)
__host__ __device__ constexpr bool smooth(int L) {
  while (L % 2 == 0) L /= 2;
  while (L % 3 == 0) L /= 3;
  while (L % 5 == 0) L /= 5;
  return L == 1;
}

// the longest row a T instance holds in registers
template <class T>
__host__ __device__ constexpr int reg_max() {
  return sizeof(T) == 4 ? 64 : 32;
}

// L has a register plan among the lengths [LO, HI] that a kernel compiles
__host__ __device__ constexpr bool reg_len(int L, int LO, int HI) {
  return L >= 2 && L >= LO && L <= HI && smooth(L);
}

// the rows a lane pair holds (float): even, 2^a 3^b 5^c, in (32, 64]
__host__ __device__ constexpr bool pair_len(int L) {
  return L > 32 && L <= 64 && L % 2 == 0 && smooth(L);
}

// a factor's register plan in the Bluestein kernel of T: one thread's row
// (at most 32) or, in float, a lane pair's
template <class T>
__host__ __device__ constexpr bool has_plan(int L) {
  return reg_len(L, 2, 32) || (sizeof(T) == 4 && pair_len(L));
}

// the Stockham stages after those of product NS, on the thread's row; the
// factor's table read at every STRIDE-th entry
template <int L, int NS, int STRIDE, class T>
__device__ __forceinline__ void reg_stages(T (&xr)[L], T (&xi)[L],
                                           const T* twr, const T* twi,
                                           T s) {
  if constexpr (NS < L) {
    constexpr int P = next_radix(L / NS);
    constexpr int Q = L / P;
    constexpr int TS = L / (NS * P);
    T yr[L], yi[L];
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      const int k = j % NS;
      T vr[P], vi[P];
#pragma unroll
      for (int t = 0; t < P; ++t) {
        T ar = xr[j + t * Q], ai = xi[j + t * Q];
        if (t > 0 && k > 0) {
          const T c = twr[t * k * TS * STRIDE];
          const T sn = twi[t * k * TS * STRIDE];
          const T br = ar * c - ai * sn;
          ai = ar * sn + ai * c;
          ar = br;
        }
        vr[t] = ar;
        vi[t] = ai;
      }
      small_dft(vr, vi, s);
#pragma unroll
      for (int t = 0; t < P; ++t) {
        yr[(j - k) * P + k + t * NS] = vr[t];
        yi[(j - k) * P + k + t * NS] = vi[t];
      }
    }
#pragma unroll
    for (int q = 0; q < L; ++q) {
      xr[q] = yr[q];
      xi[q] = yi[q];
    }
    reg_stages<L, NS * P, STRIDE>(xr, xi, twr, twi, s);
  }
}

// The DFT of the thread's row (x[q], q < L) in place, natural order in and
// out, against the factor's table (twr, twi) of L STRIDE entries (entry m
// STRIDE is W_L^m); s is the sign.
template <int L, int STRIDE = 1, class T>
__device__ __forceinline__ void reg_fft(T (&xr)[L], T (&xi)[L],
                                        const T* twr, const T* twi, T s) {
  reg_stages<L, 1, STRIDE>(xr, xi, twr, twi, s);
}

// The halves of a lane pair's row of L = 2 h: lane b holds x[2 i + b], i <
// h; after pair_fft it holds bins k and k + h for k = i + b HA, i < HA (b =
// 0) or HB (b = 1).
template <int L>
struct Pair {
  static constexpr int H = L / 2;
  static constexpr int HA = (H + 1) / 2;
  static constexpr int HB = H - HA;
};

// the pair of lanes (2p, 2p + 1 of a warp) that holds the thread's row
__device__ __forceinline__ unsigned pair_mask() {
  return 3u << (threadIdx.x & 30);
}

// The DFT of a row of L = 2 h values held by a lane pair, b = the lane's
// place in it (threadIdx.x & 1): each lane runs the h-point FFT of its
// elements (E: the even ones, O: the odd ones; the table at stride 2), the
// lanes swap the bins the other needs (lane 0 keeps E[k], k < HA, and
// sends E[HA + i]; lane 1 keeps O[HA + i] and sends O[i]), and X[k] = E[k]
// + W_L^k O[k], X[k + h] = E[k] - W_L^k O[k] land in (yr, yi)[i] and [HA +
// i] for the lane's k = i + b HA. twr / twi: the factor's table of L
// entries; s: the sign. Both lanes of every pair call it.
template <int L, class T>
__device__ __forceinline__ void pair_fft(T (&xr)[L / 2], T (&xi)[L / 2],
                                         T (&yr)[2 * Pair<L>::HA],
                                         T (&yi)[2 * Pair<L>::HA], int b,
                                         const T* twr, const T* twi, T s) {
  constexpr int HA = Pair<L>::HA, HB = Pair<L>::HB;
  reg_fft<L / 2, 2>(xr, xi, twr, twi, s);
  const unsigned pm = pair_mask();
#pragma unroll
  for (int i = 0; i < HA; ++i) {
    const T sr = b ? xr[i] : (i < HB ? xr[HA + i] : T(0));
    const T si = b ? xi[i] : (i < HB ? xi[HA + i] : T(0));
    const T rr = __shfl_xor_sync(pm, sr, 1);
    const T ri = __shfl_xor_sync(pm, si, 1);
    const T er = b ? rr : xr[i], ei = b ? ri : xi[i];
    const T orr = b ? (i < HB ? xr[HA + i] : T(0)) : rr;
    const T oi = b ? (i < HB ? xi[HA + i] : T(0)) : ri;
    const int k = i + b * HA;
    const T c = twr[k], sn = twi[k];
    const T tr = orr * c - oi * sn, ti = orr * sn + oi * c;
    yr[i] = er + tr;
    yi[i] = ei + ti;
    yr[HA + i] = er - tr;
    yi[HA + i] = ei - ti;
  }
}

// A compiler barrier for memory: the loads of an FFT's epilogue (twiddles,
// the spectrum, the chirp) are not hoisted above it into the FFT, where
// they would hold registers beside the row.
__device__ __forceinline__ void fence_loads() { asm volatile("" ::: "memory"); }

template <int L>
struct Len {
  static constexpr int value = L;
};

// f(Len<L>{}) for the run-time length L, where L has a register plan in
// [LO, HI]; nothing for any other L (the launchers refuse those). A kernel
// calls it with its single rows' range [2, 32] and its pairs' (33, 64].
template <int LO, int HI, class F>
__device__ __forceinline__ void with_len(int L, F&& f) {
#define SPFFT_REG_LEN(X)                      \
  case X:                                     \
    if constexpr (X >= LO && X <= HI) f(Len<X>{}); \
    break;
  switch (L) {
    SPFFT_REG_LEN(2)
    SPFFT_REG_LEN(3)
    SPFFT_REG_LEN(4)
    SPFFT_REG_LEN(5)
    SPFFT_REG_LEN(6)
    SPFFT_REG_LEN(8)
    SPFFT_REG_LEN(9)
    SPFFT_REG_LEN(10)
    SPFFT_REG_LEN(12)
    SPFFT_REG_LEN(15)
    SPFFT_REG_LEN(16)
    SPFFT_REG_LEN(18)
    SPFFT_REG_LEN(20)
    SPFFT_REG_LEN(24)
    SPFFT_REG_LEN(25)
    SPFFT_REG_LEN(27)
    SPFFT_REG_LEN(30)
    SPFFT_REG_LEN(32)
    SPFFT_REG_LEN(36)
    SPFFT_REG_LEN(40)
    SPFFT_REG_LEN(45)
    SPFFT_REG_LEN(48)
    SPFFT_REG_LEN(50)
    SPFFT_REG_LEN(54)
    SPFFT_REG_LEN(60)
    SPFFT_REG_LEN(64)
    default:
      break;
  }
#undef SPFFT_REG_LEN
}

// The DFT of length L along the first `rows` rows of the buffer, in place,
// computed directly (a factor with another prime, 26 in 520 = 20 x 26):
// out[k] = sum_j x[j] W^(j k), W^m = (twr[m], twi[m]) the length-L table in
// shared memory, each output summed in slices of DSLICE terms. Rows go in
// chunks of blockDim.x E / L, so a thread holds at most E outputs in
// registers between the two barriers of a chunk (L <= blockDim.x E).
constexpr int DSLICE = 16;

template <int E, class T>
__device__ __forceinline__ void dft_rows_inline(T* re, T* im, int rows,
                                                int stride, int L,
                                                const T* twr, const T* twi) {
  const int chunk = max(1, (int)(blockDim.x * E) / L);
  for (int r0 = 0; r0 < rows; r0 += chunk) {
    T* cr = re + r0 * stride;
    T* ci = im + r0 * stride;
    const int total = min(chunk, rows - r0) * L;
    T yr[E], yi[E];
    Walk w(L);
#pragma unroll
    for (int e = 0; e < E; ++e, w.next()) {
      if (threadIdx.x + e * blockDim.x < total) {
        const T* xr = cr + w.row * stride;
        const T* xi = ci + w.row * stride;
        const int k = w.col;
        T sr = T(0), si = T(0);
        int t = 0;  // j k mod L
        for (int j0 = 0; j0 < L; j0 += DSLICE) {
          T pr = T(0), pi = T(0);
          const int j1 = min(j0 + DSLICE, L);
          for (int j = j0; j < j1; ++j) {
            const T a = xr[pad(j)], b = xi[pad(j)];
            const T c = twr[t], s = twi[t];
            pr = fma_t(a, c, pr);
            pr = fma_t(-b, s, pr);
            pi = fma_t(a, s, pi);
            pi = fma_t(b, c, pi);
            t += k;
            if (t >= L) t -= L;
          }
          sr += pr;
          si += pi;
        }
        yr[e] = sr;
        yi[e] = si;
      }
    }
    __syncthreads();
    w = Walk(L);
#pragma unroll
    for (int e = 0; e < E; ++e, w.next()) {
      if (threadIdx.x + e * blockDim.x < total) {
        cr[w.row * stride + pad(w.col)] = yr[e];
        ci[w.row * stride + pad(w.col)] = yi[e];
      }
    }
    __syncthreads();
  }
}

// dft_rows_inline in a function of its own (see fft_rows)
template <int E, class T>
__device__ __noinline__ void dft_rows(T* re, T* im, int rows, int stride,
                                      int L, const T* twr, const T* twi) {
  dft_rows_inline<E>(re, im, rows, stride, L, twr, twi);
}

// The transform of spec (length sp.n: its Stockham FFT where sp.radices
// is given, else its direct DFT) along the first `rows` rows of the
// buffer, in place, against its table (twr, twi) of sp.n entries: the
// shared-memory path of a factor with no register plan, INLINE or in
// functions of their own (fft_rows, dft_rows). ODD: the radices may hold
// 7 or 11 (fft_tile.cuh: fft_rows_inline), inline in the caller's ODD
// instance, or in fft_rows' ODD instance where odd_radices says so. Ends
// after a barrier.
template <bool INLINE, bool ODD = false, class T>
__device__ __forceinline__ void smem_rows(T* re, T* im, int rows, int stride,
                                          const FftSpec<T>& sp,
                                          const T* twr, const T* twi) {
  if (INLINE) {
    if (sp.radices)
      fft_rows_inline<false, ODD>(re, im, rows, stride, sp, twr, twi);
    else
      dft_rows_inline<8>(re, im, rows, stride, sp.n, twr, twi);
  } else {
    if (!sp.radices)
      dft_rows<8>(re, im, rows, stride, sp.n, twr, twi);
    else if (ODD && odd_radices(sp.radices))
      fft_rows<false, true>(re, im, rows, stride, sp, twr, twi);
    else
      fft_rows<false>(re, im, rows, stride, sp, twr, twi);
  }
}

}  // namespace fft
}  // namespace spfft
