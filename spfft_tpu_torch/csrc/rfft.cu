// The real DFT stage in FFT form: the port's counterpart of the real
// stages of the Pallas kernel spfft_tpu/ops/dft_kernel.py:_kernel2 in
// modes "rc" (prdft2, the R2C forward head) and "cr" (pdft2_cr, the R2C
// backward tail), launched at :277, and of the distributed R2C plan's x
// stage, for transforms the plan describes (ops/dft.py: DftMats of kind
// r2c / c2r) with an even length n <= 512 whose half h = n / 2 is
// 2^a 3^b 5^c. Other lengths stay in the matrix form (dft2.cu).
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
// come from the plan's f64 table of length n rounded to f32 (its even
// entries are the length-h table), no __sinf.
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

#include "fft_tile.cuh"

using namespace spfft::fft;

namespace {

constexpr int RC = 1;  // the codes of dft2.cu's modes (cdft_tile.cuh)
constexpr int CR = 2;
constexpr int MAX_ROWS = 512;  // a block's rows for short lengths

// Stage `valid` rows of K floats (a contiguous run in device memory from
// x + m0 * K) into shared memory: float f = r * K + k of the run goes to
// dst(k)[r * stride]. Each thread issues its loads of a round before its
// stores; 16 bytes a load where the run is aligned.
template <class Dst>
__device__ __forceinline__ void load_flat(const float* __restrict__ x,
                                          long long m0, int valid, int K,
                                          int stride, Dst dst) {
  constexpr int V = 4;
  const float* src = x + m0 * K;
  const int total = valid * K;
  const int nv = aligned16(src, src) ? total >> 2 : 0;
  const float4* src4 = reinterpret_cast<const float4*>(src);
  for (int v0 = 0; v0 < nv; v0 += V * blockDim.x) {
    float4 a[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int v = v0 + threadIdx.x + e * blockDim.x;
      if (v < nv) a[e] = src4[v];
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int v = v0 + threadIdx.x + e * blockDim.x;
      if (v < nv) {
        int r = (4 * v) / K;
        int k = 4 * v - r * K;
        const float f[4] = {a[e].x, a[e].y, a[e].z, a[e].w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          dst(k)[r * stride] = f[t];
          if (++k == K) {
            k = 0;
            ++r;
          }
        }
      }
    }
  }
  for (int f = 4 * nv + threadIdx.x; f < total; f += blockDim.x) {
    const int r = f / K;
    dst(f - r * K)[r * stride] = src[f];
  }
}

// The mirror of load_flat: float f = r * N + j of the run from y + m0 * N
// is src(j)[r * stride] times sc.
template <class Src>
__device__ __forceinline__ void store_flat(float* __restrict__ y,
                                           long long m0, int valid, int N,
                                           int stride, float sc, Src src) {
  float* dst = y + m0 * N;
  const int total = valid * N;
  const int nv = aligned16(dst, dst) ? total >> 2 : 0;
  for (int v = threadIdx.x; v < nv; v += blockDim.x) {
    int r = (4 * v) / N;
    int j = 4 * v - r * N;
    float f[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      f[t] = src(j)[r * stride] * sc;
      if (++j == N) {
        j = 0;
        ++r;
      }
    }
    reinterpret_cast<float4*>(dst)[v] = make_float4(f[0], f[1], f[2], f[3]);
  }
  for (int f = 4 * nv + threadIdx.x; f < total; f += blockDim.x) {
    const int r = f / N;
    dst[f] = src(f - r * N)[r * stride] * sc;
  }
}

// Row m = p * plane_rows + a of the block (m0 <= m < m0 + valid), output
// j: src(j)[(m - m0) * stride] times sc, stored at
// y[(p * N + j) * plane_rows + a] (transposed within each plane): element
// (j, r), r fastest, 16 bytes along a where the plane allows.
template <class Src>
__device__ __forceinline__ void store_planes(float* __restrict__ y,
                                             long long m0, int valid, int N,
                                             int stride, int plane_rows,
                                             float sc, Src src) {
  const long long p0 = m0 / plane_rows;
  const int a0 = (int)(m0 - p0 * plane_rows);
  const int u =
      aligned16(y, y) && ((plane_rows | valid | a0) & 3) == 0 ? 4 : 1;
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
    const float* s = src(j) + r * stride;
    if (u == 4) {  // rows r .. r + 3: one plane, 16 bytes
      reinterpret_cast<float4*>(y + g)[0] =
          make_float4(s[0] * sc, s[stride] * sc, s[2 * stride] * sc,
                      s[3 * stride] * sc);
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
template <int MODE, bool POW2>
__global__ void __launch_bounds__(1024)
    rfft_stage_kernel(const float* __restrict__ xr,
                      const float* __restrict__ xi, float* __restrict__ yr,
                      float* __restrict__ yi, const float* __restrict__ tw,
                      long long M, int K, int N, int plane_rows, int rows,
                      FftSpec sp) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int h = sp.n;
  const int n = 2 * h;
  const int xf = h + 1;
  const int hp = h / 2 + 1;  // pairs (k, h - k) a row, k = 0 .. h / 2
  const int stride = row_stride(xf);
  float* re = smem;
  float* im = re + rows * stride;
  float* twr = im + rows * stride;  // length-h stage table
  float* twi = twr + h;
  float* pwr = twi + h;  // post-twiddles e^(sign 2 pi i k / n), k < hp
  float* pwi = pwr + hp;
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
      float* rr = re + w.row * stride;
      float* ri = im + w.row * stride;
      const int k = w.col;
      const int qk = pad(k), qm = pad(k == 0 ? 0 : h - k);
      const float a = rr[qk], b = ri[qk], c = rr[qm], d = ri[qm];
      const float er = 0.5f * (a + c), ei = 0.5f * (b - d);
      const float orr = 0.5f * (b + d), oi = -0.5f * (a - c);
      const float tr = pwr[k] * orr - pwi[k] * oi;
      const float ti = pwr[k] * oi + pwi[k] * orr;
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
    auto bin = [&](const float* base) {
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
        re[w.row * stride + pad(w.col)] = 0.f;
        im[w.row * stride + pad(w.col)] = 0.f;
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
      float* rr = re + w.row * stride;
      float* ri = im + w.row * stride;
      const int k = w.col;
      const int qk = pad(k), qm = pad(h - k);
      // Im X[0] and Im X[h] are not read: the matrices drop them
      const float a = rr[qk], c = rr[qm];
      const float b = k == 0 ? 0.f : ri[qk];
      const float d = k == 0 ? 0.f : ri[qm];
      const float ar = a + c, ai = b - d;
      const float br = a - c, bi = b + d;
      const float tr = pwr[k] * br - pwi[k] * bi;
      const float ti = pwr[k] * bi + pwi[k] * br;
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

// One launch of the real FFT stage in `mode` (1: RC, 2: CR, the codes of
// dft2.cu's spfft_dft_stage): rows (M, K) of (xr, xi) -> (M, N) of (yr,
// yi); xi is null in RC, yi in CR. The transform: even length n with
// h = n / 2 of the form 2^a 3^b 5^c (radices: h's stage radices, 3 bits
// each), the scale applied at the store, the half-spectrum window's first
// bin x0 (RC: output j is bin (x0 + j) mod (h + 1); CR: input k is that
// bin), and tw, the (2, n) f32 table e^(sign 2 pi i m / n) with sign -1
// in RC and +1 in CR.
extern "C" int spfft_rfft_stage(int mode, const float* xr, const float* xi,
                                float* yr, float* yi, const float* tw,
                                long long M, int K, int N, int plane_rows,
                                int n, float scale, int x0, int radices,
                                void* stream) {
  const int h = n / 2;
  const bool ok = n >= 2 && (n & 1) == 0 && M > 0 &&
                  (mode == RC ? K == n && N >= 1 && N <= h + 1
                              : mode == CR && N == n && K >= 1 && K <= h + 1);
  if (!ok) return (int)cudaErrorInvalidValue;
  int threads, rows;
  stage_block(h, &threads, &rows);
  rows = min(rows, MAX_ROWS);
  const size_t smem =
      sizeof(float) * (2 * (size_t)rows * row_stride(h + 1) + 2 * (size_t)h +
                       2 * (size_t)(h / 2 + 1));
  const bool p2 = pow2(h);
  auto kernel = mode == RC ? (p2 ? rfft_stage_kernel<RC, true>
                                 : rfft_stage_kernel<RC, false>)
                           : (p2 ? rfft_stage_kernel<CR, true>
                                 : rfft_stage_kernel<CR, false>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((M + rows - 1) / rows);
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      xr, xi, yr, yi, tw, M, K, N, plane_rows, rows,
      FftSpec{h, mode == RC ? -1 : 1, scale, x0, x0, radices});
  return (int)cudaGetLastError();
}
