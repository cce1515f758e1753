// The two-pass FFT (kernel A of the long axes): a complex DFT of length
// n = n1 n2 > 512 along the rows of a planar operand, for transforms the
// plan describes (ops/dft.py: DftMats of form "two_pass", with n1 <= n2
// <= 512 the balanced split of two_stage_factor). It is the port's
// counterpart of the JAX package's two-stage matmul DFT
// (spfft_tpu/ops/dft.py:_pdft_two_stage), which XLA runs as two dots and a
// twiddle, not a Pallas kernel. With n = i1 n2 + i2 and k = k2 n1 + k1:
//
//   pass 1 (n1): a row viewed as (n1, n2); for every i2, the DFT over i1
//     of x[i1 n2 + i2], times the twiddle W_n^(i2 k1), at t[k1 n2 + i2];
//   pass 2 (n2): for every k1, the DFT over i2 of t[k1 n2 + i2], times the
//     scale; bin k2 of (k1) is output k = k2 n1 + k1, so the store puts the
//     bins in natural order: at y[m n + k], or with plane_rows = A > 0
//     transposed within planes as the stage kernels store (row m = p A + a
//     at y[(p n + k) A + a]).
//
// Two kernels:
//
//   fft_long_whole_kernel (pass 0): where a row fits a block (n <= WHOLE_N
//     = 4096), ONE launch: a block loads R = WHOLE_N / n whole rows (one
//     contiguous run), each into
//     the pass-1 layout of shared memory (sub-row (r, i2) holds i1), runs
//     pass 1, then moves the rows through registers into the pass-2
//     layout (sub-row (r, k1) holds i2), multiplying by W_n^(i2 k1) on the
//     way, runs pass 2 and stores. Device memory sees each element read
//     once and written once, as a single-pass FFT;
//   fft_long_kernel (passes 1 and 2, one launch each): any n, rows of one
//     pass's length L (n1 or n2) at a time, as fft.cu's stage kernel holds
//     them (stage_block), the intermediate t through device memory. Pass 1
//     reads and writes along i2, pass 2 reads its rows as one contiguous
//     run and stores along k1 (runs of n1) or, transposed, along a.
//
// A factor of the form 2^a 3^b 5^c runs fft_tile.cuh's Stockham FFT, any
// other (26 = 2 x 13 in 520 = 20 x 26) a direct DFT of the row in shared
// memory (dft_rows: each output summed in slices of 16 terms, as
// cdft_tile.cuh's matrix tile sums, against the sub-table). Every twiddle
// comes from the plan's table of length n, e^(sign 2 pi i m / n) computed
// in float64 on the host and rounded once to T: a pass's stage table is
// its every (n / L)-th entry, W_n^(i2 k1) is entry i2 k1 (< n). No
// __sinf. Offsets into the operands are 64-bit (a 768^3 grid is 453M
// elements a plane of the pair).
//
// Bound on the H100: bytes. One launch reads and writes the operand once:
// at 768^3 the xy stage moves 7.2 GB (2.2 ms at 3.35 TB/s) against 3.8e10
// FLOP (0.6 ms at 67 TFLOP/s); two launches move it twice. The templates
// on T (real.cuh) give the float and double instances (entries
// spfft_fft_long and spfft_fft_long_f64).

#include "fft_tile.cuh"

using namespace spfft;
using namespace spfft::fft;

namespace {

// terms of one partial sum of the direct DFT
constexpr int DSLICE = 16;

// The DFT of length L along the first `rows` rows of the buffer, in place,
// computed directly: out[k] = sum_j x[j] W^(j k), W^m = (twr[m], twi[m]) the
// length-L table in shared memory. rows * L <= blockDim.x * E, so a thread
// holds at most E outputs in registers between the two barriers.
template <int E, class T>
__device__ __noinline__ void dft_rows(T* re, T* im, int rows, int stride,
                                      int L, const T* twr, const T* twi) {
  T yr[E], yi[E];
  const int total = rows * L;
  Walk w(L);
#pragma unroll
  for (int e = 0; e < E; ++e, w.next()) {
    if (threadIdx.x + e * blockDim.x < total) {
      const T* xr = re + w.row * stride;
      const T* xi = im + w.row * stride;
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
      re[w.row * stride + pad(w.col)] = yr[e];
      im[w.row * stride + pad(w.col)] = yi[e];
    }
  }
  __syncthreads();
}

}  // namespace

// Pass `pass` (1 or 2) over the M rows of length n = n1 n2: buffer rows are
// the rows q = q0 .. q0 + valid - 1 of the pass's (M G, L) view (pass 1: L =
// n1, G = n2, row q = (m, i2); pass 2: L = n2, G = n1, row q = (m, k1)).
// sp describes the pass's transform of length L (sign, scale, radices); tw
// is the plan's (2, n) table.
template <bool POW2, bool DIRECT, class T>
__global__ void __launch_bounds__(Bounds<T>::STAGE_THREADS)
    fft_long_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                    T* __restrict__ yr, T* __restrict__ yi,
                    const T* __restrict__ tw, long long M, int n, int n1,
                    int n2, int pass, int plane_rows, int rows,
                    FftSpec<T> sp) {
  extern __shared__ float4 smem4[];
  T* smem = reinterpret_cast<T*>(smem4);
  const int L = sp.n;
  const int G = pass == 1 ? n2 : n1;
  const int stride = row_stride(L);
  T* re = smem;
  T* im = re + rows * stride;
  T* twr = im + rows * stride;
  T* twi = twr + L;
  const long long q0 = (long long)blockIdx.x * rows;
  const int valid = (int)min((long long)rows, M * G - q0);
  // row q0 + b is (m0 + (r0 + b) / G, (r0 + b) % G)
  const long long m0 = q0 / G;
  const int r0 = (int)(q0 - m0 * G);
  const int step = n / L;
  for (int m = threadIdx.x; m < L; m += blockDim.x) {
    twr[m] = tw[m * step];
    twi[m] = tw[n + m * step];
  }

  if (pass == 1) {  // element (i1, b), b fastest: neighbouring i2
    Walk w(valid);
    for (int id = threadIdx.x; id < valid * L; id += blockDim.x) {
      const int d = (r0 + w.col) / G;
      const int g = r0 + w.col - d * G;
      const long long a = (m0 + d) * n + (long long)w.row * n2 + g;
      re[w.col * stride + pad(w.row)] = xr[a];
      im[w.col * stride + pad(w.row)] = xi[a];
      w.next();
    }
  } else {  // the block's rows are one contiguous run of the intermediate
    const long long base = q0 * L;
    Walk w(L);
    for (int id = threadIdx.x; id < valid * L; id += blockDim.x) {
      re[w.row * stride + pad(w.col)] = xr[base + id];
      im[w.row * stride + pad(w.col)] = xi[base + id];
      w.next();
    }
  }
  __syncthreads();
  if constexpr (DIRECT)
    dft_rows<EPT>(re, im, valid, stride, L, twr, twi);
  else
    fft_rows<POW2>(re, im, valid, stride, sp, twr, twi);

  if (pass == 1) {  // times W_n^(i2 k1), stored in the input's view
    Walk w(valid);
    for (int id = threadIdx.x; id < valid * L; id += blockDim.x) {
      const int d = (r0 + w.col) / G;
      const int g = r0 + w.col - d * G;
      const int k1 = w.row;
      const long long a = (m0 + d) * n + (long long)k1 * n2 + g;
      const T vr = re[w.col * stride + pad(k1)];
      const T vi = im[w.col * stride + pad(k1)];
      const int t = g * k1;
      const T c = tw[t], s = tw[n + t];
      yr[a] = vr * c - vi * s;
      yi[a] = vr * s + vi * c;
      w.next();
    }
    return;
  }
  const T sc = sp.scale;
  if (plane_rows == 0) {  // element (k2, b), b fastest: runs of n1 along k
    Walk w(valid);
    for (int id = threadIdx.x; id < valid * L; id += blockDim.x) {
      const int d = (r0 + w.col) / G;
      const int g = r0 + w.col - d * G;
      const long long a = (m0 + d) * n + (long long)w.row * n1 + g;
      yr[a] = re[w.col * stride + pad(w.row)] * sc;
      yi[a] = im[w.col * stride + pad(w.row)] * sc;
      w.next();
    }
    return;
  }
  // transposed within planes: element (k2, k1, m), m fastest, so that
  // neighbouring threads write neighbouring a of one plane; the block's
  // rows span the rows m0 .. m0 + nm - 1
  const int nm = (int)((q0 + valid - 1) / G - m0 + 1);
  Walk w(nm);
  for (int id = threadIdx.x; id < nm * G * L; id += blockDim.x) {
    const int k2 = w.row / G;
    const int g = w.row - k2 * G;
    const int b = w.col * G + g - r0;
    if (b >= 0 && b < valid) {
      const long long m = m0 + w.col;
      const long long p = m / plane_rows;
      const long long a = m - p * plane_rows;
      const long long o = (p * n + (long long)k2 * n1 + g) * plane_rows + a;
      yr[o] = re[b * stride + pad(k2)] * sc;
      yi[o] = im[b * stride + pad(k2)] * sc;
    }
    w.next();
  }
}

// The thread's elements id = threadIdx.x + e blockDim.x, e = 0, 1, ..., of
// a (., nb, nc) grid as (a, b, c): id = (a nb + b) nc + c, with divisions
// only at the start (each step carries at most once, as dc < nc and db <
// nb).
struct Walk3 {
  int a, b, c, nb, nc, da, db, dc;
  __device__ __forceinline__ Walk3(int nb_, int nc_) : nb(nb_), nc(nc_) {
    const int bc = nb * nc;
    a = threadIdx.x / bc;
    int q = threadIdx.x - a * bc;
    b = q / nc;
    c = q - b * nc;
    da = blockDim.x / bc;
    q = blockDim.x - da * bc;
    db = q / nc;
    dc = q - db * nc;
  }
  __device__ __forceinline__ void next() {
    c += dc;
    if (c >= nc) {
      c -= nc;
      ++b;
    }
    b += db;
    if (b >= nb) {
      b -= nb;
      ++a;
    }
    a += da;
  }
};

// threads of a whole-row block, the elements each holds in registers when
// the rows change layout, and the longest row a block holds. Two blocks an
// SM (64 registers a thread): one block of 128-register threads left the
// SM a quarter occupied and ran slower than the two launches on the H100.
constexpr int WHOLE_THREADS = 512;
constexpr int WHOLE_EPT = 8;
constexpr int WHOLE_N = WHOLE_THREADS * WHOLE_EPT;

// Pass 0: the whole transform of `rows` rows a block (rows n <= blockDim.x
// WHOLE_EPT). s1 / s2 describe the passes (lengths n1 / n2, sign; s2
// carries the scale; radices 0: the factor's direct DFT). P1 / P2: that
// pass's factor is a power of two with an FFT form.
template <bool P1, bool P2, class T>
__global__ void __launch_bounds__(WHOLE_THREADS, 2)
    fft_long_whole_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                          T* __restrict__ yr, T* __restrict__ yi,
                          const T* __restrict__ tw, long long M, int n,
                          int plane_rows, int rows, FftSpec<T> s1,
                          FftSpec<T> s2) {
  extern __shared__ float4 smem4[];
  T* smem = reinterpret_cast<T*>(smem4);
  const int n1 = s1.n, n2 = s2.n;
  const int st1 = row_stride(n1), st2 = row_stride(n2);
  const int words = max(rows * n2 * st1, rows * n1 * st2);
  T* re = smem;
  T* im = re + words;
  T* t1r = im + words;
  T* t1i = t1r + n1;
  T* t2r = t1i + n1;
  T* t2i = t2r + n2;
  for (int m = threadIdx.x; m < n1; m += blockDim.x) {
    t1r[m] = tw[m * n2];
    t1i[m] = tw[n + m * n2];
  }
  for (int m = threadIdx.x; m < n2; m += blockDim.x) {
    t2r[m] = tw[m * n1];
    t2i[m] = tw[n + m * n1];
  }
  const long long m0 = (long long)blockIdx.x * rows;
  const int valid = (int)min((long long)rows, M - m0);
  const int total = valid * n;

  // element f = r n + i1 n2 + i2 of the block's run -> sub-row r n2 + i2,
  // position i1 (neighbouring threads: neighbouring i2, odd stride apart)
  const long long base = m0 * n;
  Walk3 w(n1, n2);
  for (int f = threadIdx.x; f < total; f += blockDim.x, w.next()) {
    const int o = (w.a * n2 + w.c) * st1 + pad(w.b);
    re[o] = xr[base + f];
    im[o] = xi[base + f];
  }
  __syncthreads();
  if (s1.radices)
    fft_rows<P1>(re, im, valid * n2, st1, s1, t1r, t1i);
  else
    dft_rows<WHOLE_EPT>(re, im, valid * n2, st1, n1, t1r, t1i);

  // sub-row (r, i2), position k1 -> sub-row (r, k1), position i2, times
  // W_n^(i2 k1): element id = r n + i2 n1 + k1, k1 fastest
  T vr[WHOLE_EPT], vi[WHOLE_EPT];
  w = Walk3(n2, n1);
#pragma unroll
  for (int e = 0; e < WHOLE_EPT; ++e, w.next()) {
    if (threadIdx.x + e * blockDim.x < total) {
      const int o = (w.a * n2 + w.b) * st1 + pad(w.c);
      const T ar = re[o], ai = im[o];
      const int t = w.b * w.c;
      const T c = tw[t], s = tw[n + t];
      vr[e] = ar * c - ai * s;
      vi[e] = ar * s + ai * c;
    }
  }
  __syncthreads();
  w = Walk3(n2, n1);
#pragma unroll
  for (int e = 0; e < WHOLE_EPT; ++e, w.next()) {
    if (threadIdx.x + e * blockDim.x < total) {
      const int o = (w.a * n1 + w.c) * st2 + pad(w.b);
      re[o] = vr[e];
      im[o] = vi[e];
    }
  }
  __syncthreads();
  if (s2.radices)
    fft_rows<P2>(re, im, valid * n1, st2, s2, t2r, t2i);
  else
    dft_rows<WHOLE_EPT>(re, im, valid * n1, st2, n2, t2r, t2i);

  const T sc = s2.scale;
  if (plane_rows == 0) {  // output f = r n + k2 n1 + k1: k1 fastest
    w = Walk3(n2, n1);
    for (int f = threadIdx.x; f < total; f += blockDim.x, w.next()) {
      const int o = (w.a * n1 + w.c) * st2 + pad(w.b);
      yr[base + f] = re[o] * sc;
      yi[base + f] = im[o] * sc;
    }
    return;
  }
  // transposed within planes: element (k2, k1, r), r fastest, so that
  // neighbouring threads write neighbouring a of one plane
  const long long p0 = m0 / plane_rows;
  const int a0 = (int)(m0 - p0 * plane_rows);
  w = Walk3(n1, valid);
  for (int id = threadIdx.x; id < total; id += blockDim.x, w.next()) {
    const int r = w.c;
    const int o = (r * n1 + w.b) * st2 + pad(w.a);
    const int k = w.a * n1 + w.b;
    int a = a0 + r;
    long long p = p0;
    if (a >= plane_rows) {
      const int d = a / plane_rows;
      a -= d * plane_rows;
      p += d;
    }
    const long long g = (p * n + k) * plane_rows + a;
    yr[g] = re[o] * sc;
    yi[g] = im[o] * sc;
  }
}

namespace {

template <class T>
int launch_whole(const T* xr, const T* xi, T* yr, T* yi, const T* tw,
                 long long M, int n, int n1, int n2, int plane_rows, int sign,
                 T scale, int rad1, int rad2, void* stream) {
  const int rows = WHOLE_N / n;
  const size_t words = (size_t)max(rows * n2 * row_stride(n1),
                                   rows * n1 * row_stride(n2));
  const size_t smem = sizeof(T) * (2 * words + 2 * (size_t)(n1 + n2));
  const bool p1 = rad1 != 0 && pow2(n1), p2 = rad2 != 0 && pow2(n2);
  auto kernel = p1 ? (p2 ? fft_long_whole_kernel<true, true, T>
                         : fft_long_whole_kernel<true, false, T>)
                   : (p2 ? fft_long_whole_kernel<false, true, T>
                         : fft_long_whole_kernel<false, false, T>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((M + rows - 1) / rows);
  kernel<<<blocks, WHOLE_THREADS, smem, (cudaStream_t)stream>>>(
      xr, xi, yr, yi, tw, M, n, plane_rows, rows,
      FftSpec<T>{n1, sign, T(1), 0, 0, rad1},
      FftSpec<T>{n2, sign, scale, 0, 0, rad2});
  return (int)cudaGetLastError();
}

template <class T>
int launch_long(int pass, const T* xr, const T* xi, T* yr, T* yi,
                const T* tw, long long M, int n, int n1, int n2,
                int plane_rows, int sign, T scale, int rad1, int rad2,
                void* stream) {
  if (pass < 0 || pass > 2 || n1 < 2 || n2 < 2 || n1 > 512 || n2 > 512 ||
      n1 * n2 != n || M <= 0 || plane_rows < 0 ||
      (pass == 0 && n > WHOLE_N))
    return (int)cudaErrorInvalidValue;
  if (pass == 0)
    return launch_whole(xr, xi, yr, yi, tw, M, n, n1, n2, plane_rows, sign,
                        scale, rad1, rad2, stream);
  const int L = pass == 1 ? n1 : n2;
  const int radices = pass == 1 ? rad1 : rad2;
  int threads, rows;
  stage_block<T>(L, &threads, &rows);
  const size_t smem = stage_smem<T>(L, rows);
  auto kernel = radices == 0 ? fft_long_kernel<false, true, T>
                : pow2(L)    ? fft_long_kernel<true, false, T>
                             : fft_long_kernel<false, false, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long G = pass == 1 ? n2 : n1;
  const unsigned blocks = (unsigned)((M * G + rows - 1) / rows);
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      xr, xi, yr, yi, tw, M, n, n1, n2, pass, plane_rows, rows,
      FftSpec<T>{L, sign, pass == 2 ? scale : T(1), 0, 0, radices});
  return (int)cudaGetLastError();
}

}  // namespace

// The two-pass FFT over M rows of length n = n1 n2: (xr, xi) -> (yr, yi),
// each (M, n). pass 0: the whole transform in one launch (n <= WHOLE_N);
// pass 1 or 2: that pass alone (any n; pass 1's output is pass 2's
// input). tw is the (2, n) table e^(sign 2 pi i m / n); plane_rows (the
// last pass) 0 for straight stores, A > 0 for stores transposed within
// planes of A rows; the scale is applied at the last pass's store; rad1 /
// rad2 the factors' stage radices (3 bits each, the first stage lowest), 0
// for a factor's direct DFT. _f64: the same on double operands.
extern "C" int spfft_fft_long(int pass, const float* xr, const float* xi,
                              float* yr, float* yi, const float* tw,
                              long long M, int n, int n1, int n2,
                              int plane_rows, int sign, float scale,
                              int rad1, int rad2, void* stream) {
  return launch_long(pass, xr, xi, yr, yi, tw, M, n, n1, n2, plane_rows, sign,
                     scale, rad1, rad2, stream);
}

extern "C" int spfft_fft_long_f64(int pass, const double* xr,
                                  const double* xi, double* yr, double* yi,
                                  const double* tw, long long M, int n,
                                  int n1, int n2, int plane_rows, int sign,
                                  double scale, int rad1, int rad2,
                                  void* stream) {
  return launch_long(pass, xr, xi, yr, yi, tw, M, n, n1, n2, plane_rows, sign,
                     scale, rad1, rad2, stream);
}

// The longest row pass 0 takes (WHOLE_N): the wrappers launch pass 0 up to
// it and passes 1 and 2 above it.
extern "C" int spfft_fft_long_whole_n() { return WHOLE_N; }
