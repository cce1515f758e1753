// The real DFT stage in FFT form: the port's counterpart of the real
// stages of the Pallas kernel spfft_tpu/ops/dft_kernel.py:_kernel2 in
// modes "rc" (prdft2, the R2C forward head) and "cr" (pdft2_cr, the R2C
// backward tail), launched at :277, and of the distributed R2C plan's x
// stage, for transforms the plan describes (ops/dft.py: DftMats of kind
// r2c / c2r) with an even length n <= 1024 whose half h = n / 2 is
// 2^a 3^b 5^c (the real axes above 512 too: ops/dft.py real_form). Other
// lengths stay in the matrix form (dft2.cu). At h = 512 a block holds 32
// rows in float (16 in double) of row_stride(513) = 529 slots: 135,424
// bytes of rows either way, within the 227 KB a block may have.
//
// A real transform of length n is a complex one of length h plus a pass
// over the pairs of bins (k, h - k), the textbook real FFT:
//
//   RC: rows (M, n) real -> (M, N) planar, bins (x0 + j) mod (h + 1) of
//       X[k] = scale sum_m x[m] e^(-2 pi i k m / n). Row m of the input is
//       loaded as h complex values z[m] = x[2m] + i x[2m+1] (the real row
//       is already interleaved), Z = FFT_h(z) forward, and for k = 0..h
//       (Z[h] = Z[0])
//         E = (Z[k] + conj Z[h-k]) / 2,  O = (Z[k] - conj Z[h-k]) / (2i),
//         X[k] = E + e^(-2 pi i k / n) O,  X[h-k] = conj(E - e^(..) O).
//   CR: rows (M, K) planar, bins at (x0 + k) mod (h + 1) of a zeroed half
//       spectrum, -> (M, n) real, x[m] = scale sum_k w_k (Re X[k]
//       cos(2 pi k m / n) - Im X[k] sin(2 pi k m / n)) with w = 1 at DC and
//       Nyquist and 2 elsewhere: so Im X[0] and Im X[h] are dropped, as the
//       matrices drop them. For k < h
//         Z[k] = (X[k] + conj X[h-k]) + i e^(2 pi i k / n) (X[k] - conj
//                X[h-k]),
//       z = FFT_h(Z) backward, x[2m] = Re z[m], x[2m+1] = Im z[m].
//
// One thread owns a pair (k, h - k) of a row: it reads both slots and
// writes both, so the pass runs in place in shared memory with no barrier
// inside it. The half spectrum needs h + 1 slots a row: rows are
// row_stride(h + 1) apart (odd, so column reads stay conflict-free). The
// stage twiddles (length h) and the post-twiddles e^(-+2 pi i k / n) both
// come from the plan's f64 table of length n rounded to the kernel's real
// type (its even entries are the length-h table), no __sinf.
//
// Blocks, buffer and launch follow fft.cu's fft_stage_kernel: stage_block
// (h)'s threads and rows, the FFT of fft_tile.cuh, and a store straight or
// transposed within planes of plane_rows rows (prdft2's first launch, so
// its complex stage over y follows as before). Loads and straight stores
// walk the block's rows as one flat run of floats (a block's rows are
// contiguous in device memory), 16 bytes a thread wherever the run is
// aligned, so the 129-wide half spectrum needs no padding in device memory.
//
// Bound on the H100: bytes. At 256^3 an RC or CR stage moves 65,536 rows
// of 256 reals (67.1 MB) and 65,536 rows of 129 bins (67.6 MB): 0.040 ms
// at 3.35 TB/s. The FFT needs 5 h log2 h + ~10 h FLOP a row, under 0.01 ms
// at 67 TFLOP/s. The matrix form did 2.6e10 FLOP for a prdft2 call and
// was bound by operations.
//
// The kernel is a template on the real type T (real.cuh): float, and
// double for double-precision plans (entry spfft_rfft_stage_f64), whose
// stage moves 269 MB at 256^3 (0.080 ms) with double2 accesses and whose
// blocks follow fft_tile.cuh's Bounds<double>.

#include "fft_tile.cuh"

using namespace spfft;
using namespace spfft::fft;

namespace {

constexpr int RC = 1;  // the codes of dft2.cu's modes (cdft_tile.cuh)
constexpr int CR = 2;
constexpr int MAX_ROWS = 512;  // a block's rows for short lengths

// Stage `valid` rows of K reals (a contiguous run in device memory from
// x + m0 * K) into shared memory: real f = r * K + k of the run goes to
// dst(k)[r * stride]. Each thread issues its loads of a round before its
// stores; 16 bytes a load where the run is aligned.
template <class T, class Dst>
__device__ __forceinline__ void load_flat(const T* __restrict__ x,
                                          long long m0, int valid, int K,
                                          int stride, Dst dst) {
  constexpr int V = 4;
  constexpr int W = Real<T>::W;
  const T* src = x + m0 * K;
  const int total = valid * K;
  const int nv = aligned16(src, src) ? total / W : 0;
  for (int v0 = 0; v0 < nv; v0 += V * blockDim.x) {
    T a[V][W];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int v = v0 + threadIdx.x + e * blockDim.x;
      if (v < nv) load16(src + W * v, a[e]);
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int v = v0 + threadIdx.x + e * blockDim.x;
      if (v < nv) {
        int r = (W * v) / K;
        int k = W * v - r * K;
#pragma unroll
        for (int t = 0; t < W; ++t) {
          dst(k)[r * stride] = a[e][t];
          if (++k == K) {
            k = 0;
            ++r;
          }
        }
      }
    }
  }
  for (int f = W * nv + threadIdx.x; f < total; f += blockDim.x) {
    const int r = f / K;
    dst(f - r * K)[r * stride] = src[f];
  }
}

// The mirror of load_flat: real f = r * N + j of the run from y + m0 * N
// is src(j)[r * stride] times sc.
template <class T, class Src>
__device__ __forceinline__ void store_flat(T* __restrict__ y, long long m0,
                                           int valid, int N, int stride,
                                           T sc, Src src) {
  constexpr int W = Real<T>::W;
  T* dst = y + m0 * N;
  const int total = valid * N;
  const int nv = aligned16(dst, dst) ? total / W : 0;
  for (int v = threadIdx.x; v < nv; v += blockDim.x) {
    int r = (W * v) / N;
    int j = W * v - r * N;
    T f[W];
#pragma unroll
    for (int t = 0; t < W; ++t) {
      f[t] = src(j)[r * stride] * sc;
      if (++j == N) {
        j = 0;
        ++r;
      }
    }
    store16(dst + W * v, f);
  }
  for (int f = W * nv + threadIdx.x; f < total; f += blockDim.x) {
    const int r = f / N;
    dst[f] = src(f - r * N)[r * stride] * sc;
  }
}

// Row m = p * plane_rows + a of the block (m0 <= m < m0 + valid), output
// j: src(j)[(m - m0) * stride] times sc, stored at
// y[(p * N + j) * plane_rows + a] (transposed within each plane): element
// (j, r), r fastest, 16 bytes along a where the plane allows.
template <class T, class Src>
__device__ __forceinline__ void store_planes(T* __restrict__ y, long long m0,
                                             int valid, int N, int stride,
                                             int plane_rows, T sc, Src src) {
  constexpr int W = Real<T>::W;
  const long long p0 = m0 / plane_rows;
  const int a0 = (int)(m0 - p0 * plane_rows);
  const int u = aligned16(y, y) && (plane_rows | valid | a0) % W == 0 ? W : 1;
  Walk w(valid / u);
  for (int id = threadIdx.x; id < valid * N / u; id += blockDim.x) {
    const int j = w.row;
    const int r = u * w.col;
    int a = a0 + r;
    long long pp = p0;
    if (a >= plane_rows) {
      const int d = a / plane_rows;
      a -= d * plane_rows;
      pp += d;
    }
    const long long g = (pp * N + j) * plane_rows + a;
    const T* s = src(j) + r * stride;
    if (u == W) {  // rows r .. r + W - 1: one plane, 16 bytes
      T f[W];
#pragma unroll
      for (int t = 0; t < W; ++t) f[t] = s[t * stride] * sc;
      store16(y + g, f);
    } else {
      y[g] = s[0] * sc;
    }
    w.next();
  }
}

}  // namespace

// RC: xr (M, n) real -> (yr, yi) (M, N), N <= h + 1 bins from sp.out0.
// CR: (xr, xi) (M, K), K <= h + 1 bins from sp.in0 -> yr (M, n) real.
// sp describes the complex FFT of length h (sign -1 in RC, +1 in CR) and
// carries the scale; tw is the plan's (2, n) table e^(sign 2 pi i m / n).
// plane_rows == 0: straight stores; plane_rows > 0: transposed within
// planes, as fft.cu's stage kernel stores.
template <int MODE, bool POW2, class T>
__global__ void __launch_bounds__(Bounds<T>::STAGE_THREADS)
    rfft_stage_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                      T* __restrict__ yr, T* __restrict__ yi,
                      const T* __restrict__ tw, long long M, int K, int N,
                      int plane_rows, int rows, FftSpec<T> sp) {
  constexpr T HALF = Consts<T>::HALF;
  extern __shared__ float4 smem4[];
  T* smem = reinterpret_cast<T*>(smem4);
  const int h = sp.n;
  const int n = 2 * h;
  const int xf = h + 1;
  const int hp = h / 2 + 1;  // pairs (k, h - k) a row, k = 0 .. h / 2
  const int stride = row_stride(xf);
  T* re = smem;
  T* im = re + rows * stride;
  T* twr = im + rows * stride;  // length-h stage table
  T* twi = twr + h;
  T* pwr = twi + h;  // post-twiddles e^(sign 2 pi i k / n), k < hp
  T* pwi = pwr + hp;
  const long long m0 = (long long)blockIdx.x * rows;
  const int valid = (int)min((long long)rows, M - m0);
  for (int m = threadIdx.x; m < h; m += blockDim.x) {
    twr[m] = tw[2 * m];
    twi[m] = tw[n + 2 * m];
  }
  for (int k = threadIdx.x; k < hp; k += blockDim.x) {
    pwr[k] = tw[k];
    pwi[k] = tw[n + k];
  }

  if (MODE == RC) {
    // real x[i] is Re (i even) or Im (i odd) of z[i / 2]
    load_flat(xr, m0, valid, n, stride, [&](int i) {
      return ((i & 1) ? im : re) + pad(i >> 1);
    });
    __syncthreads();
    fft_rows<POW2>(re, im, valid, stride, sp, twr, twi);
    __syncthreads();
    Walk w(hp);
    for (int id = threadIdx.x; id < valid * hp; id += blockDim.x) {
      T* rr = re + w.row * stride;
      T* ri = im + w.row * stride;
      const int k = w.col;
      const int qk = pad(k), qm = pad(k == 0 ? 0 : h - k);
      const T a = rr[qk], b = ri[qk], c = rr[qm], d = ri[qm];
      const T er = HALF * (a + c), ei = HALF * (b - d);
      const T orr = HALF * (b + d), oi = -HALF * (a - c);
      const T tr = pwr[k] * orr - pwi[k] * oi;
      const T ti = pwr[k] * oi + pwi[k] * orr;
      rr[qk] = er + tr;
      ri[qk] = ei + ti;
      if (h - k != k) {  // X[h - k] = conj(E - W O); k = 0 writes X[h]
        rr[pad(h - k)] = er - tr;
        ri[pad(h - k)] = ti - ei;
      }
      w.next();
    }
    __syncthreads();
    const int out0 = sp.out0;
    auto bin = [&](const T* base) {
      return [=](int j) { return base + pad(wrap(out0 + j, xf)); };
    };
    if (plane_rows == 0) {
      store_flat(yr, m0, valid, N, stride, sp.scale, bin(re));
      store_flat(yi, m0, valid, N, stride, sp.scale, bin(im));
    } else {
      store_planes(yr, m0, valid, N, stride, plane_rows, sp.scale, bin(re));
      store_planes(yi, m0, valid, N, stride, plane_rows, sp.scale, bin(im));
    }
  } else {
    if (K < xf) {  // bins outside the window are zero
      Walk w(xf);
      for (int id = threadIdx.x; id < valid * xf; id += blockDim.x) {
        re[w.row * stride + pad(w.col)] = T(0);
        im[w.row * stride + pad(w.col)] = T(0);
        w.next();
      }
      __syncthreads();
    }
    const int in0 = sp.in0;
    load_flat(xr, m0, valid, K, stride,
              [&](int k) { return re + pad(wrap(in0 + k, xf)); });
    load_flat(xi, m0, valid, K, stride,
              [&](int k) { return im + pad(wrap(in0 + k, xf)); });
    __syncthreads();
    Walk w(hp);
    for (int id = threadIdx.x; id < valid * hp; id += blockDim.x) {
      T* rr = re + w.row * stride;
      T* ri = im + w.row * stride;
      const int k = w.col;
      const int qk = pad(k), qm = pad(h - k);
      // Im X[0] and Im X[h] are not read: the matrices drop them
      const T a = rr[qk], c = rr[qm];
      const T b = k == 0 ? T(0) : ri[qk];
      const T d = k == 0 ? T(0) : ri[qm];
      const T ar = a + c, ai = b - d;
      const T br = a - c, bi = b + d;
      const T tr = pwr[k] * br - pwi[k] * bi;
      const T ti = pwr[k] * bi + pwi[k] * br;
      rr[qk] = ar - ti;  // Z[k] = A + i W B
      ri[qk] = ai + tr;
      if (k != 0 && h - k != k) {  // Z[h - k] = conj(A - i W B)
        rr[qm] = ar + ti;
        ri[qm] = tr - ai;
      }
      w.next();
    }
    __syncthreads();
    fft_rows<POW2>(re, im, valid, stride, sp, twr, twi);
    __syncthreads();
    // real x[i] is Re (i even) or Im (i odd) of z[i / 2]
    auto sample = [&](int i) { return ((i & 1) ? im : re) + pad(i >> 1); };
    if (plane_rows == 0)
      store_flat(yr, m0, valid, N, stride, sp.scale, sample);
    else
      store_planes(yr, m0, valid, N, stride, plane_rows, sp.scale, sample);
  }
}

namespace {

template <class T>
int launch_rfft(int mode, const T* xr, const T* xi, T* yr, T* yi,
                const T* tw, long long M, int K, int N, int plane_rows, int n,
                T scale, int x0, int radices, void* stream) {
  const int h = n / 2;
  const bool ok = n >= 2 && (n & 1) == 0 && M > 0 &&
                  (mode == RC ? K == n && N >= 1 && N <= h + 1
                              : mode == CR && N == n && K >= 1 && K <= h + 1);
  if (!ok) return (int)cudaErrorInvalidValue;
  int threads, rows;
  stage_block<T>(h, &threads, &rows);
  rows = min(rows, MAX_ROWS);
  const size_t smem =
      sizeof(T) * (2 * (size_t)rows * row_stride(h + 1) + 2 * (size_t)h +
                   2 * (size_t)(h / 2 + 1));
  const bool p2 = pow2(h);
  auto kernel = mode == RC ? (p2 ? rfft_stage_kernel<RC, true, T>
                                 : rfft_stage_kernel<RC, false, T>)
                           : (p2 ? rfft_stage_kernel<CR, true, T>
                                 : rfft_stage_kernel<CR, false, T>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((M + rows - 1) / rows);
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      xr, xi, yr, yi, tw, M, K, N, plane_rows, rows,
      FftSpec<T>{h, mode == RC ? -1 : 1, scale, x0, x0, radices});
  return (int)cudaGetLastError();
}

}  // namespace

// One launch of the real FFT stage in `mode` (1: RC, 2: CR, the codes of
// dft2.cu's spfft_dft_stage): rows (M, K) of (xr, xi) -> (M, N) of (yr,
// yi); xi is null in RC, yi in CR. The transform: even length n with
// h = n / 2 of the form 2^a 3^b 5^c (radices: h's stage radices, 3 bits
// each), the scale applied at the store, the half-spectrum window's first
// bin x0 (RC: output j is bin (x0 + j) mod (h + 1); CR: input k is that
// bin), and tw, the (2, n) table e^(sign 2 pi i m / n) with sign -1 in RC
// and +1 in CR. _f64: the same on double operands.
extern "C" int spfft_rfft_stage(int mode, const float* xr, const float* xi,
                                float* yr, float* yi, const float* tw,
                                long long M, int K, int N, int plane_rows,
                                int n, float scale, int x0, int radices,
                                void* stream) {
  return launch_rfft(mode, xr, xi, yr, yi, tw, M, K, N, plane_rows, n, scale,
                     x0, radices, stream);
}

extern "C" int spfft_rfft_stage_f64(int mode, const double* xr,
                                    const double* xi, double* yr, double* yi,
                                    const double* tw, long long M, int K,
                                    int N, int plane_rows, int n,
                                    double scale, int x0, int radices,
                                    void* stream) {
  return launch_rfft(mode, xr, xi, yr, yi, tw, M, K, N, plane_rows, n, scale,
                     x0, radices, stream);
}
