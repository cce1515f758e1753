// Shared device code of the package's FFT kernels (fft.cu, fused_fft.cu,
// rfft.cu): a block runs complex FFTs of length n <= 512 = 2^a 3^b 5^c
// along the rows of a buffer in shared memory, planar (separate real and
// imaginary arrays) in the real type T, float or double (real.cuh).
//
// Algorithm: the Stockham autosort FFT, mixed radix 4, 2, 3 and 5. Stage s
// of radix P, after stages whose radices multiply to Ns, maps butterfly j
// (0 <= j < n / P) of a row as
//
//     v[t] = x[j + t n / P] * w^(t (j mod Ns)),  w = e^(sign 2 pi i / (Ns P)),
//     v    = DFT_P(v),
//     y[(j - j mod Ns) P + j mod Ns + t Ns] = v[t],
//
// and leaves the row in natural order after the last stage: no bit
// reversal. The stage radices and the twiddle table come from the plan
// (ops/dft.py: fft_factors, fft_twiddles): the table holds e^(sign 2 pi i
// m / n), m < n, computed in float64 on the host and rounded to T, so
// w^(t k) is entry t k n / (Ns P). No __sinf / __cosf: an FFT's error then
// grows with log n, where a dense product's grows with sqrt(n). Every
// constant is a T (Consts<T>): a float constant left in a double instance
// would cost about 1e-8.
//
// Each thread reads its butterflies' P inputs into registers, the block
// meets at a barrier, and each thread writes its P outputs back into the
// same buffer: one buffer, two barriers per stage. A block holds at most
// EPT complex elements per thread (rows * n <= blockDim.x * EPT), so the
// register arrays have a size fixed at compile time. A double instance
// needs twice the registers and shared memory of a float one: its blocks
// have at most 512 threads (Bounds<double>), so that a thread may hold 128
// registers, and half the rows of a float block at n > 256, so that the
// buffer fits the 227 KB a block may have.
//
// Layout: element q of row r sits at r * stride + pad(q). pad() inserts one
// word after every 32, so the first stages' writes at power-of-two strides
// (P j + t) fall into distinct banks; the row stride is odd, so a column
// read across 32 rows (the transposed store, the cluster gather) is
// conflict-free too.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "real.cuh"

namespace spfft {
namespace fft {

constexpr int EPT = 16;  // complex elements of the buffer per thread
// complex elements per thread in one pass of the FFT: fft_rows works on
// chunks of blockDim.x * EPT_PASS / n rows, so that a stage holds at most
// 2 * ceil(EPT_PASS / P) * P reals a thread across its barrier
constexpr int EPT_PASS = 8;

// The launch bounds of a T instance: the most threads of a stage block
// (float: 1024 at 64 registers a thread; double: 512 at 128), and the
// cluster kernel's blocks an SM (512 threads each: float 2, double 1).
template <class T>
struct Bounds {
  static constexpr int STAGE_THREADS = sizeof(T) == 4 ? 1024 : 512;
  static constexpr int PLANE_BLOCKS = sizeof(T) == 4 ? 2 : 1;
};

__host__ __device__ __forceinline__ int pad(int i) { return i + (i >> 5); }
__host__ __device__ __forceinline__ int row_stride(int n) { return pad(n) | 1; }
__host__ __device__ __forceinline__ bool pow2(int n) { return (n & (n - 1)) == 0; }
// q mod n for 0 <= q < 2 n
__device__ __forceinline__ int wrap(int q, int n) { return q >= n ? q - n : q; }

// Threads and rows of a block that transforms whole rows of length n: 512
// threads up to n = 256, Bounds<T>::STAGE_THREADS above, and as many rows
// as fill EPT elements a thread (32 rows at n = 256; at n = 512, 32 in
// float and 16 in double).
template <class T>
inline void stage_block(int n, int* threads, int* rows) {
  *threads = n > 256 ? Bounds<T>::STAGE_THREADS : 512;
  *rows = (*threads * EPT) / n;
}

// Shared memory of such a block: its rows (real and imaginary) and the
// twiddle table.
template <class T>
inline size_t stage_smem(int n, int rows) {
  return sizeof(T) * (2 * (size_t)rows * row_stride(n) + 2 * (size_t)n);
}

// One transform as the plan describes it: length n, sign (+1 backward,
// -1 forward), the scale applied at the store, the position of input
// element 0 (in0: input k sits at (in0 + k) mod n, other positions are 0)
// and of output element 0 (out0: output j is position (out0 + j) mod n),
// and the stage radices, 3 bits each, the first stage lowest.
template <class T>
struct FftSpec {
  int n;
  int sign;
  T scale;
  int in0;
  int out0;
  int radices;
};

// sin and cos of 2 pi / 3, 2 pi / 5 and 4 pi / 5, each rounded once from
// its decimal expansion to T
template <class T>
struct Consts;

template <>
struct Consts<float> {
  static constexpr float HALF = 0.5f;
  static constexpr float S3 = 0.86602540378443864676f;
  static constexpr float C5_1 = 0.30901699437494742410f;
  static constexpr float C5_2 = -0.80901699437494742410f;
  static constexpr float S5_1 = 0.95105651629515357212f;
  static constexpr float S5_2 = 0.58778525229247312917f;
};

template <>
struct Consts<double> {
  static constexpr double HALF = 0.5;
  static constexpr double S3 = 0.86602540378443864676;
  static constexpr double C5_1 = 0.30901699437494742410;
  static constexpr double C5_2 = -0.80901699437494742410;
  static constexpr double S5_1 = 0.95105651629515357212;
  static constexpr double S5_2 = 0.58778525229247312917;
};

// v <- DFT_P(v) with kernel e^(sign 2 pi i jk / P), P the arrays' length;
// s is sign as a T
template <class T>
__device__ __forceinline__ void small_dft(T (&r)[2], T (&i)[2], T) {
  const T ar = r[0] - r[1], ai = i[0] - i[1];
  r[0] += r[1];
  i[0] += i[1];
  r[1] = ar;
  i[1] = ai;
}

template <class T>
__device__ __forceinline__ void small_dft(T (&r)[4], T (&i)[4], T s) {
  const T t0r = r[0] + r[2], t0i = i[0] + i[2];
  const T t1r = r[0] - r[2], t1i = i[0] - i[2];
  const T t2r = r[1] + r[3], t2i = i[1] + i[3];
  // (a1 - a3) * (s i)
  const T t3r = -s * (i[1] - i[3]), t3i = s * (r[1] - r[3]);
  r[0] = t0r + t2r;
  i[0] = t0i + t2i;
  r[2] = t0r - t2r;
  i[2] = t0i - t2i;
  r[1] = t1r + t3r;
  i[1] = t1i + t3i;
  r[3] = t1r - t3r;
  i[3] = t1i - t3i;
}

template <class T>
__device__ __forceinline__ void small_dft(T (&r)[3], T (&i)[3], T s) {
  using C = Consts<T>;
  const T tr = r[1] + r[2], ti = i[1] + i[2];
  const T dr = r[1] - r[2], di = i[1] - i[2];
  const T mr = r[0] - C::HALF * tr, mi = i[0] - C::HALF * ti;
  // s i (sqrt(3) / 2) d
  const T er = -s * C::S3 * di, ei = s * C::S3 * dr;
  r[0] += tr;
  i[0] += ti;
  r[1] = mr + er;
  i[1] = mi + ei;
  r[2] = mr - er;
  i[2] = mi - ei;
}

template <class T>
__device__ __forceinline__ void small_dft(T (&r)[5], T (&i)[5], T s) {
  using C = Consts<T>;
  const T b1r = r[1] + r[4], b1i = i[1] + i[4];
  const T b2r = r[2] + r[3], b2i = i[2] + i[3];
  const T d1r = r[1] - r[4], d1i = i[1] - i[4];
  const T d2r = r[2] - r[3], d2i = i[2] - i[3];
  const T m1r = r[0] + C::C5_1 * b1r + C::C5_2 * b2r;
  const T m1i = i[0] + C::C5_1 * b1i + C::C5_2 * b2i;
  const T m2r = r[0] + C::C5_2 * b1r + C::C5_1 * b2r;
  const T m2i = i[0] + C::C5_2 * b1i + C::C5_1 * b2i;
  // s i (S1 d1 + S2 d2) and s i (S2 d1 - S1 d2)
  const T e1r = -s * (C::S5_1 * d1i + C::S5_2 * d2i);
  const T e1i = s * (C::S5_1 * d1r + C::S5_2 * d2r);
  const T e2r = -s * (C::S5_2 * d1i - C::S5_1 * d2i);
  const T e2i = s * (C::S5_2 * d1r - C::S5_1 * d2r);
  r[0] += b1r + b2r;
  i[0] += b1i + b2i;
  r[1] = m1r + e1r;
  i[1] = m1i + e1i;
  r[4] = m1r - e1r;
  i[4] = m1i - e1i;
  r[2] = m2r + e2r;
  i[2] = m2i + e2i;
  r[3] = m2r - e2r;
  i[3] = m2i - e2i;
}

// One Stockham stage of radix P (after stages of product ns) over the
// first `rows` rows of the buffer; all threads of the block call it.
// Butterfly id = threadIdx.x + b blockDim.x is (row, j) = divmod(id, n / P).
// POW2 (n a power of two, blockDim.x a multiple of 256, so n / P divides
// blockDim.x): a thread keeps one j, k and set of twiddles for all its
// butterflies, and its rows step by blockDim.x / (n / P), with shifts and
// masks in place of divisions.
template <int P, bool POW2, class T>
__device__ __forceinline__ void stage(T* re, T* im, int rows, int n,
                                      int stride, int ns, const T* twr,
                                      const T* twi, T s) {
  constexpr int MAXB = (EPT_PASS + P - 1) / P;
  const int q = n / P;
  const int total = rows * q;
  const int tstep = n / (ns * P);
  const int qlog = __ffs(q) - 1;  // used where POW2
  T vr[MAXB][P], vi[MAXB][P];
  int row = POW2 ? threadIdx.x >> qlog : threadIdx.x / q;
  int j = threadIdx.x - row * q;
  int k = POW2 ? j & (ns - 1) : j % ns;
#pragma unroll
  for (int b = 0; b < MAXB; ++b) {
    const int id = threadIdx.x + b * blockDim.x;
    if (b > 0) {
      if (POW2) {
        row += blockDim.x >> qlog;
      } else {
        row = id / q;
        j = id - row * q;
        k = j % ns;
      }
    }
    if (id < total) {
      const T* xr = re + row * stride;
      const T* xi = im + row * stride;
#pragma unroll
      for (int t = 0; t < P; ++t) {
        const int a = pad(j + t * q);
        T ar = xr[a], ai = xi[a];
        if (t > 0 && k > 0) {
          const T c = twr[t * k * tstep], sn = twi[t * k * tstep];
          const T br = ar * c - ai * sn;
          ai = ar * sn + ai * c;
          ar = br;
        }
        vr[b][t] = ar;
        vi[b][t] = ai;
      }
      small_dft(vr[b], vi[b], s);
    }
  }
  __syncthreads();
  row = POW2 ? threadIdx.x >> qlog : threadIdx.x / q;
  j = threadIdx.x - row * q;
  k = POW2 ? j & (ns - 1) : j % ns;
#pragma unroll
  for (int b = 0; b < MAXB; ++b) {
    const int id = threadIdx.x + b * blockDim.x;
    if (b > 0) {
      if (POW2) {
        row += blockDim.x >> qlog;
      } else {
        row = id / q;
        j = id - row * q;
        k = j % ns;
      }
    }
    if (id < total) {
      const int base = (j - k) * P + k;
      T* yr = re + row * stride;
      T* yi = im + row * stride;
#pragma unroll
      for (int t = 0; t < P; ++t) {
        yr[pad(base + t * ns)] = vr[b][t];
        yi[pad(base + t * ns)] = vi[b][t];
      }
    }
  }
  __syncthreads();
}

// The FFT of sp along the first `rows` rows (rows * n <= blockDim.x * EPT),
// in place, natural order in and out, in chunks of blockDim.x * EPT_PASS / n
// rows; twr / twi are the plan's table in shared memory. Every thread of
// the block calls it. POW2: n is a power of two (radices 4 and 2 only) and
// blockDim.x a multiple of 256. Not inlined: its register allocation then
// does not share the calling kernel's live values (which made it spill).
template <bool POW2, class T>
__device__ __noinline__ void fft_rows(T* re, T* im, int rows, int stride,
                                      const FftSpec<T>& sp, const T* twr,
                                      const T* twi) {
  const T s = (T)sp.sign;
  const int chunk = blockDim.x * EPT_PASS / sp.n;
  for (int r0 = 0; r0 < rows; r0 += chunk) {
    T* cr = re + r0 * stride;
    T* ci = im + r0 * stride;
    const int nr = min(chunk, rows - r0);
    int ns = 1;
    for (int code = sp.radices; code != 0; code >>= 3) {
      const int p = code & 7;
      if (POW2) {
        if (p == 4)
          stage<4, true>(cr, ci, nr, sp.n, stride, ns, twr, twi, s);
        else
          stage<2, true>(cr, ci, nr, sp.n, stride, ns, twr, twi, s);
      } else {
        switch (p) {
          case 2:
            stage<2, false>(cr, ci, nr, sp.n, stride, ns, twr, twi, s);
            break;
          case 3:
            stage<3, false>(cr, ci, nr, sp.n, stride, ns, twr, twi, s);
            break;
          case 4:
            stage<4, false>(cr, ci, nr, sp.n, stride, ns, twr, twi, s);
            break;
          default:
            stage<5, false>(cr, ci, nr, sp.n, stride, ns, twr, twi, s);
            break;
        }
      }
      ns *= p;
    }
  }
}

// Copy the plan's twiddle table ((2, n): cos row, sin row) to shared memory.
template <class T>
__device__ __forceinline__ void load_twiddles(T* twr, T* twi,
                                              const T* __restrict__ tw,
                                              int n) {
  for (int m = threadIdx.x; m < n; m += blockDim.x) {
    twr[m] = tw[m];
    twi[m] = tw[n + m];
  }
}

// The thread's elements id = threadIdx.x + e * blockDim.x, e = 0, 1, ...,
// of a (rows, width) grid as (row, col) = divmod(id, width), one division
// at the start and none per step.
struct Walk {
  int row, col, width, drow, dcol;
  __device__ __forceinline__ explicit Walk(int w) : width(w) {
    row = threadIdx.x / w;
    col = threadIdx.x - row * w;
    drow = blockDim.x / w;
    dcol = blockDim.x - drow * w;
  }
  __device__ __forceinline__ void next() {
    row += drow;
    col += dcol;
    if (col >= width) {
      col -= width;
      ++row;
    }
  }
};

__device__ __forceinline__ bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) &
          15) == 0;
}

// Stage `valid` rows of K inputs (global rows row0, row0 + 1, ... of
// (xr, xi), K reals apart) into buffer rows 0..rows-1 (rows * n <=
// blockDim.x * EPT), each input k at position (in0 + k) mod n and every
// other position zero (rows past `valid` all zero). Each thread issues all
// its loads before its first shared-memory store. With the whole row given
// (K == n, in0 == 0, n a multiple of W = Real<T>::W, 16-byte aligned
// operands) it reads 16 bytes a thread.
template <class T>
__device__ __forceinline__ void load_rows(T* re, T* im, int rows, int valid,
                                          int stride, int n, int K, int in0,
                                          const T* __restrict__ xr,
                                          const T* __restrict__ xi,
                                          long long row0) {
  constexpr int W = Real<T>::W;
  if (K == n && in0 == 0 && n % W == 0 && aligned16(xr, xi)) {
    constexpr int V = EPT / W;
    const int nw = n / W;
    T a[V][W], b[V][W];
    Walk w(nw);
#pragma unroll
    for (int e = 0; e < V; ++e, w.next()) {
      if (w.row < valid) {
        const long long g = ((row0 + w.row) * nw + w.col) * W;
        load16(xr + g, a[e]);
        load16(xi + g, b[e]);
      } else {
#pragma unroll
        for (int t = 0; t < W; ++t) a[e][t] = b[e][t] = T(0);
      }
    }
    w = Walk(nw);
#pragma unroll
    for (int e = 0; e < V; ++e, w.next()) {
      if (w.row < rows) {
        // positions W col .. W col + W - 1 lie in one padded run
        const int o = w.row * stride + pad(W * w.col);
#pragma unroll
        for (int t = 0; t < W; ++t) {
          re[o + t] = a[e][t];
          im[o + t] = b[e][t];
        }
      }
    }
    return;
  }
  T a[EPT], b[EPT];
  Walk w(n);
#pragma unroll
  for (int e = 0; e < EPT; ++e, w.next()) {
    int k = w.col - in0;
    if (k < 0) k += n;
    a[e] = b[e] = T(0);
    if (w.row < valid && k < K) {
      const long long g = (row0 + w.row) * K + k;
      a[e] = xr[g];
      b[e] = xi[g];
    }
  }
  w = Walk(n);
#pragma unroll
  for (int e = 0; e < EPT; ++e, w.next()) {
    if (w.row < rows) {
      const int o = w.row * stride + pad(w.col);
      re[o] = a[e];
      im[o] = b[e];
    }
  }
}

// Store N outputs of each of the first `valid` buffer rows: output j of
// row r (position (out0 + j) mod n) times sc at (yr, yi)[(row0 + r) N + j].
// With out0 == 0, N a multiple of W and 16-byte aligned operands it stores
// 16 bytes a thread.
template <class T>
__device__ __forceinline__ void store_rows(const T* re, const T* im,
                                           int valid, int stride, int n,
                                           int N, int out0, T sc,
                                           T* __restrict__ yr,
                                           T* __restrict__ yi,
                                           long long row0) {
  constexpr int W = Real<T>::W;
  if (out0 == 0 && N % W == 0 && aligned16(yr, yi)) {
    const int NW = N / W;
    Walk w(NW);
    for (int id = threadIdx.x; id < valid * NW; id += blockDim.x) {
      const int o = w.row * stride + pad(W * w.col);
      const long long g = ((row0 + w.row) * NW + w.col) * W;
      T a[W], b[W];
#pragma unroll
      for (int t = 0; t < W; ++t) {
        a[t] = re[o + t] * sc;
        b[t] = im[o + t] * sc;
      }
      store16(yr + g, a);
      store16(yi + g, b);
      w.next();
    }
    return;
  }
  Walk w(N);
  for (int id = threadIdx.x; id < valid * N; id += blockDim.x) {
    const int o = w.row * stride + pad(wrap(out0 + w.col, n));
    const long long g = (row0 + w.row) * N + w.col;
    yr[g] = re[o] * sc;
    yi[g] = im[o] * sc;
    w.next();
  }
}

}  // namespace fft
}  // namespace spfft
