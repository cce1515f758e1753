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
// Three kernels:
//
//   fft_long_whole_kernel (pass 0): where a row fits a block (n <= WHOLE_N
//     = 4096), ONE launch, a four-step FFT in one block of R rows. Pass 1:
//     a thread takes one column (r, i2), the n1 elements i1 of one sub-row
//     (n2 apart in the row; neighbouring threads take neighbouring i2, so
//     the loads are coalesced), runs its n1-point FFT in registers
//     (fft_reg.cuh), multiplies by W_n^(i2 k1) from a shared-memory table
//     of the n entries and writes once into the pass-2 layout (sub-row (r,
//     k1) holds i2). After one barrier, pass 2: a thread reads one (r, k1)
//     sub-row of n2 values, runs its FFT in registers, scales and stores k
//     = k2 n1 + k1 (neighbouring threads write neighbouring k1), or, for
//     the transposed store, writes the bins back and, after a second
//     barrier, the block stores them with its rows fastest. One exchange
//     through shared memory a row and two barriers, where a Stockham FFT
//     in shared memory meets one a radix stage (six at 768 = 24 x 32).
//     Device memory sees each element read once and written once.
//   fft_long_col_kernel (pass 1 of a longer row whose n1 has a register
//     plan): the same column pass with no shared memory but the factor's
//     table, W_n^(i2 k1) read from the plan's table (L2), the intermediate
//     t stored in the input's view (coalesced along i2).
//   fft_long_kernel (passes 1 and 2 of a longer row, one launch each, the
//     shared-memory path): rows of one pass's length L (n1 or n2) at a
//     time, as fft.cu's stage kernel holds them (stage_block), the
//     intermediate t through device memory. Pass 1 reads and writes along
//     i2, pass 2 reads its rows as one contiguous run and stores along k1
//     (runs of n1) or, transposed, along a.
//
// A factor has a register plan where it is 2^a 3^b 5^c and at most
// reg_max<T>() (64 in float, 32 in double: fft_reg.cuh); the wrapper says
// which passes take it (paths: bit 0 pass 1, bit 1 pass 2), by length at
// plan time. Any other factor keeps the shared-memory path inside the same
// kernel: fft_tile.cuh's Stockham FFT for a 2^a 3^b 5^c 7^d 11^e factor
// above reg_max or with a 7 or 11 (28 in 896 = 28 x 32), a direct DFT of
// the row (dft_rows, summed in slices of 16) for a factor with a prime of
// 13 or more (26 in 520 = 20 x 26). Every twiddle comes
// from the plan's table of length n, e^(sign 2 pi i m / n) computed in
// float64 on the host and rounded once to T: a factor's table is its
// every (n / L)-th entry, W_n^(i2 k1) is entry i2 k1 (< n). No __sinf.
// Offsets into the operands are 64-bit (a 768^3 grid is 453M elements a
// plane of the pair).
//
// Bound on the H100: bytes. One launch reads and writes the operand once:
// at 768^3 the z stage moves 5.7 GB (1.70 ms at 3.35 TB/s) against 1.8e10
// FLOP (0.27 ms at 67 TFLOP/s); two launches move it twice. The whole
// kernel's threads and launch bounds come from ptxas: a class of register
// rows of at most 32 (float) runs two blocks of 256 threads an SM at up to
// 128 registers, one of 64 a block of 256 at up to 255; neither spills in
// float (chip_smoke.py prints ptxas' registers and spills per instance).
// The templates on T (real.cuh) give the float and double instances
// (entries spfft_fft_long and spfft_fft_long_f64).

#include "fft_reg.cuh"

using namespace spfft;
using namespace spfft::fft;

// Pass `pass` (1 or 2) over the M rows of length n = n1 n2: buffer rows are
// the rows q = q0 .. q0 + valid - 1 of the pass's (M G, L) view (pass 1: L =
// n1, G = n2, row q = (m, i2); pass 2: L = n2, G = n1, row q = (m, k1)).
// sp describes the pass's transform of length L (sign, scale, radices); tw
// is the plan's (2, n) table.
template <bool POW2, bool DIRECT, bool ODD, class T>
__global__ void __launch_bounds__(512)
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
    fft_rows<POW2, ODD>(re, im, valid, stride, sp, twr, twi);

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

// The one-launch kernel's shape: the longest row (WHOLE_N), the most
// threads of a block, and the complex elements a block holds at most (a
// buffer of 64 KB: float 8192, double 4096).
constexpr int WHOLE_N = 4096;
constexpr int WHOLE_THREADS = 256;

template <class T>
struct Whole {
  static constexpr int ELEMS = sizeof(T) == 4 ? 8192 : 4096;
};

// Blocks an SM of an instance whose register rows are at most MAXL long:
// float rows of 32 fit two blocks of 256 threads (128 registers a thread),
// rows of 64, double rows and an instance whose shared-memory FFT has
// radix 7 or 11 inline (ODD: at 128 registers it spilled) one.
template <int MAXL, bool ODD, class T>
struct Occupancy {
  static constexpr int BLOCKS =
      sizeof(T) == 4 && MAXL <= 32 && !ODD ? 2 : 1;
};

// The register lengths an instance of class MAXL compiles for each pass:
// class 32 every row whose register factors are at most 32, class 64 the
// rest (a factor in (32, 64] of n > 512: n1 >= 513 / 64 > 8, and n2 >= n1
// or n2 > 32).
template <int MAXL>
struct Lens {
  static constexpr int P1_LO = MAXL > 32 ? 9 : 2;
  static constexpr int P2_LO = MAXL > 32 ? 33 : 2;
};

template <int MAXL>
constexpr bool class_takes(bool reg1, int n1, bool reg2, int n2) {
  return (!reg1 || reg_len(n1, Lens<MAXL>::P1_LO, MAXL)) &&
         (!reg2 || reg_len(n2, Lens<MAXL>::P2_LO, MAXL));
}

// Pass 0: the whole transform of `rows` rows a block (rows n <=
// Whole<T>::ELEMS, or one row). s1 / s2 describe the passes (lengths n1 /
// n2, sign; s2 carries the scale; radices 0: the factor's direct DFT);
// paths bit 0 / bit 1: pass 1 / pass 2 in registers (a plan of at most
// MAXL). Shared memory: the pass-2 layout Q (sub-row (r, k1) of n2), the
// pass-1 layout P (sub-row (r, i2) of n1) where pass 1 takes the
// shared-memory path, the n-table padded as a row is (entry m at pad(m):
// W_n^(i2 k1) read by neighbouring i2 falls in distinct banks), and the
// factors' tables.
template <int MAXL, bool ODD, class T>
__global__ void __launch_bounds__(WHOLE_THREADS,
                                  (Occupancy<MAXL, ODD, T>::BLOCKS))
    fft_long_whole_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                          T* __restrict__ yr, T* __restrict__ yi,
                          const T* __restrict__ tw, long long M, int n,
                          int plane_rows, int rows, FftSpec<T> s1,
                          FftSpec<T> s2, int paths) {
  extern __shared__ float4 smem4[];
  T* smem = reinterpret_cast<T*>(smem4);
  const int n1 = s1.n, n2 = s2.n;
  const int st1 = row_stride(n1), st2 = row_stride(n2);
  const bool reg1 = paths & 1, reg2 = paths & 2;
  const int wq = rows * n1 * st2;
  const int wp = reg1 ? 0 : rows * n2 * st1;
  const int tn = pad(n - 1) + 1;
  T* qr = smem;
  T* qi = qr + wq;
  T* pr = qi + wq;
  T* pi = pr + wp;
  T* tbr = pi + wp;
  T* tbi = tbr + tn;
  T* t1r = tbi + tn;
  T* t1i = t1r + n1;
  T* t2r = t1i + n1;
  T* t2i = t2r + n2;
  for (int m = threadIdx.x; m < n; m += blockDim.x) {
    tbr[pad(m)] = tw[m];
    tbi[pad(m)] = tw[n + m];
  }
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
  const long long base = m0 * n;
  const T s = (T)s1.sign;
  // the shared-memory paths inline where the register rows are short (a
  // call there made the kernel spill), in functions of their own beside
  // rows of 64 (whose one instance takes radix 7 and 11 there: ODD is
  // false for it)
  constexpr bool INL = MAXL <= 32;
  constexpr bool SMEM_ODD = INL ? ODD : true;
  __syncthreads();

  if (reg1) {
    // column (r, i2): x[base + r n + i1 n2 + i2], i1 < n1, in registers;
    // bin k1 times W_n^(i2 k1) into sub-row (r, k1), position i2
    with_len<Lens<MAXL>::P1_LO, MAXL>(n1, [&](auto len) {
      constexpr int L = decltype(len)::value;
      for (int c = threadIdx.x; c < valid * n2; c += blockDim.x) {
        const int r = c / n2;
        const int i2 = c - r * n2;
        const long long a = base + (long long)r * n + i2;
        T vr[L], vi[L];
#pragma unroll
        for (int q = 0; q < L; ++q) {
          vr[q] = xr[a + q * n2];
          vi[q] = xi[a + q * n2];
        }
        reg_fft<L>(vr, vi, t1r, t1i, s);
        fence_loads();
        T* o_r = qr + r * L * st2 + pad(i2);
        T* o_i = qi + r * L * st2 + pad(i2);
        o_r[0] = vr[0];
        o_i[0] = vi[0];
#pragma unroll
        for (int k1 = 1; k1 < L; ++k1) {
          const int t = pad(i2 * k1);
          const T cw = tbr[t], sw = tbi[t];
          o_r[k1 * st2] = vr[k1] * cw - vi[k1] * sw;
          o_i[k1 * st2] = vr[k1] * sw + vi[k1] * cw;
        }
      }
    });
  } else {
    // the pass-1 layout: element f = r n + i1 n2 + i2 of the block's run
    // -> sub-row (r, i2), position i1; its transform in shared memory
    Walk3 w(n1, n2);
    for (int f = threadIdx.x; f < total; f += blockDim.x, w.next()) {
      const int o = (w.a * n2 + w.c) * st1 + pad(w.b);
      pr[o] = xr[base + f];
      pi[o] = xi[base + f];
    }
    __syncthreads();
    smem_rows<INL, SMEM_ODD>(pr, pi, valid * n2, st1, s1, t1r, t1i);
    // element (r, i2, k1), k1 fastest, times W_n^(i2 k1) into Q
    w = Walk3(n2, n1);
    for (int f = threadIdx.x; f < total; f += blockDim.x, w.next()) {
      const int o = (w.a * n2 + w.b) * st1 + pad(w.c);
      const T ar = pr[o], ai = pi[o];
      const int t = pad(w.b * w.c);
      const T cw = tbr[t], sw = tbi[t];
      const int d = (w.a * n1 + w.c) * st2 + pad(w.b);
      qr[d] = ar * cw - ai * sw;
      qi[d] = ar * sw + ai * cw;
    }
  }
  __syncthreads();

  const T sc = s2.scale;
  if (reg2) {
    // sub-row (r, k1) in registers; bin k2 is output k = k2 n1 + k1
    with_len<Lens<MAXL>::P2_LO, MAXL>(n2, [&](auto len) {
      constexpr int L = decltype(len)::value;
      for (int c = threadIdx.x; c < valid * n1; c += blockDim.x) {
        T* q_r = qr + c * st2;
        T* q_i = qi + c * st2;
        T vr[L], vi[L];
#pragma unroll
        for (int i2 = 0; i2 < L; ++i2) {
          vr[i2] = q_r[pad(i2)];
          vi[i2] = q_i[pad(i2)];
        }
        reg_fft<L>(vr, vi, t2r, t2i, s);
        if (plane_rows == 0) {
          const int r = c / n1;
          const long long a = base + (long long)r * n + (c - r * n1);
#pragma unroll
          for (int k2 = 0; k2 < L; ++k2) {
            yr[a + k2 * n1] = vr[k2] * sc;
            yi[a + k2 * n1] = vi[k2] * sc;
          }
        } else {  // back into the sub-row, for the transposed store
#pragma unroll
          for (int k2 = 0; k2 < L; ++k2) {
            q_r[pad(k2)] = vr[k2] * sc;
            q_i[pad(k2)] = vi[k2] * sc;
          }
        }
      }
    });
    if (plane_rows == 0) return;
  } else {
    smem_rows<INL, SMEM_ODD>(qr, qi, valid * n1, st2, s2, t2r, t2i);
    if (plane_rows == 0) {  // output f = r n + k2 n1 + k1: k1 fastest
      Walk3 w(n2, n1);
      for (int f = threadIdx.x; f < total; f += blockDim.x, w.next()) {
        const int o = (w.a * n1 + w.c) * st2 + pad(w.b);
        yr[base + f] = qr[o] * sc;
        yi[base + f] = qi[o] * sc;
      }
      return;
    }
  }
  __syncthreads();
  // transposed within planes: element (k2, k1, r), r fastest, so that
  // neighbouring threads write neighbouring a of one plane (the register
  // path wrote its bins scaled)
  const T tsc = reg2 ? T(1) : sc;
  const long long p0 = m0 / plane_rows;
  const int a0 = (int)(m0 - p0 * plane_rows);
  Walk3 w(n1, valid);
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
    yr[g] = qr[o] * tsc;
    yi[g] = qi[o] * tsc;
  }
}

// Pass 1 of a row longer than WHOLE_N whose n1 has a register plan: column
// (m, i2) of the M n2 columns a thread, x[m n + i1 n2 + i2] in registers,
// its n1-point FFT, bin k1 times W_n^(i2 k1) (the plan's table, read
// through L2) at t[m n + k1 n2 + i2]. Neighbouring threads take
// neighbouring i2: every load and store is coalesced. The bins wait in
// shared memory (bin k of thread t at k COL_THREADS + t), so that the
// epilogue's twiddle loads do not meet the whole row in registers.
constexpr int COL_THREADS = 128;

template <int MAXL, class T>
__global__ void __launch_bounds__(COL_THREADS, 1)
    fft_long_col_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                        T* __restrict__ yr, T* __restrict__ yi,
                        const T* __restrict__ tw, long long M, int n, int n1,
                        int n2, int sign) {
  __shared__ T t1r[MAXL], t1i[MAXL];
  extern __shared__ float4 smem4[];  // 2 n1 COL_THREADS
  T* br = reinterpret_cast<T*>(smem4);
  T* bi = br + n1 * COL_THREADS;
  for (int m = threadIdx.x; m < n1; m += blockDim.x) {
    t1r[m] = tw[(long long)m * n2];
    t1i[m] = tw[n + (long long)m * n2];
  }
  __syncthreads();
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= M * n2) return;
  const long long row = c / n2;
  const int i2 = (int)(c - row * n2);
  const long long a = row * n + i2;
  with_len<Lens<MAXL>::P1_LO, MAXL>(n1, [&](auto len) {
    constexpr int L = decltype(len)::value;
    T vr[L], vi[L];
#pragma unroll
    for (int q = 0; q < L; ++q) {
      vr[q] = xr[a + (long long)q * n2];
      vi[q] = xi[a + (long long)q * n2];
    }
    reg_fft<L>(vr, vi, t1r, t1i, (T)sign);
#pragma unroll
    for (int k = 0; k < L; ++k) {
      br[k * COL_THREADS + threadIdx.x] = vr[k];
      bi[k * COL_THREADS + threadIdx.x] = vi[k];
    }
  });
  fence_loads();
  yr[a] = br[threadIdx.x];
  yi[a] = bi[threadIdx.x];
  for (int k1 = 1; k1 < n1; ++k1) {
    const int t = i2 * k1;
    const T cw = tw[t], sw = tw[n + t];
    const T vr = br[k1 * COL_THREADS + threadIdx.x];
    const T vi = bi[k1 * COL_THREADS + threadIdx.x];
    yr[a + (long long)k1 * n2] = vr * cw - vi * sw;
    yi[a + (long long)k1 * n2] = vr * sw + vi * cw;
  }
}

namespace {

template <int MAXL, class T>
int launch_whole_class(const T* xr, const T* xi, T* yr, T* yi, const T* tw,
                       long long M, int n, int plane_rows, int rows,
                       int threads, size_t smem, FftSpec<T> s1,
                       FftSpec<T> s2, int paths, void* stream) {
  // radix 7 or 11 on an inline shared-memory path: the ODD instance
  const bool odd = MAXL <= 32 && (odd_radices(s1.radices) ||
                                  odd_radices(s2.radices));
  auto kernel = odd ? fft_long_whole_kernel<MAXL, MAXL <= 32, T>
                    : fft_long_whole_kernel<MAXL, false, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((M + rows - 1) / rows);
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      xr, xi, yr, yi, tw, M, n, plane_rows, rows, s1, s2, paths);
  return (int)cudaGetLastError();
}

template <class T>
int launch_whole(const T* xr, const T* xi, T* yr, T* yi, const T* tw,
                 long long M, int n, int n1, int n2, int plane_rows, int sign,
                 T scale, int rad1, int rad2, int paths, void* stream) {
  constexpr int RM = reg_max<T>();
  const bool reg1 = paths & 1, reg2 = paths & 2;
  // rows: about 256 threads of pass-1 columns, within ELEMS
  const int rows = max(1, min(WHOLE_THREADS / n2, Whole<T>::ELEMS / n));
  const int threads = min(WHOLE_THREADS, (rows * n2 + 31) / 32 * 32);
  const size_t wq = (size_t)rows * n1 * row_stride(n2);
  const size_t wp = reg1 ? 0 : (size_t)rows * n2 * row_stride(n1);
  const size_t smem = sizeof(T) * (2 * (wq + wp) + 2 * (size_t)(pad(n - 1) + 1)
                                   + 2 * (size_t)(n1 + n2));
  const FftSpec<T> s1{n1, sign, T(1), 0, 0, rad1};
  const FftSpec<T> s2{n2, sign, scale, 0, 0, rad2};
  // the class of the longest register row; a length outside the class's
  // compiled lengths is refused, never run
  const int longest = max(reg1 ? n1 : 0, reg2 ? n2 : 0);
  if (longest == 0)
    return launch_whole_class<0>(xr, xi, yr, yi, tw, M, n, plane_rows, rows,
                                 threads, smem, s1, s2, paths, stream);
  if (longest <= 32) {
    if (!class_takes<32>(reg1, n1, reg2, n2))
      return (int)cudaErrorInvalidValue;
    return launch_whole_class<32>(xr, xi, yr, yi, tw, M, n, plane_rows,
                                  rows, threads, smem, s1, s2, paths, stream);
  }
  if constexpr (RM > 32) {
    if (!class_takes<RM>(reg1, n1, reg2, n2))
      return (int)cudaErrorInvalidValue;
    return launch_whole_class<RM>(xr, xi, yr, yi, tw, M, n, plane_rows,
                                  rows, threads, smem, s1, s2, paths, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

template <class T>
int launch_long(int pass, const T* xr, const T* xi, T* yr, T* yi,
                const T* tw, long long M, int n, int n1, int n2,
                int plane_rows, int sign, T scale, int rad1, int rad2,
                int paths, void* stream) {
  if (pass < 0 || pass > 2 || n1 < 2 || n2 < 2 || n1 > 512 || n2 > 512 ||
      n1 * n2 != n || M <= 0 || plane_rows < 0 || paths < 0 || paths > 3 ||
      (pass == 0 && n > WHOLE_N) || (pass == 2 && (paths & 2)))
    return (int)cudaErrorInvalidValue;
  if (pass == 0)
    return launch_whole(xr, xi, yr, yi, tw, M, n, n1, n2, plane_rows, sign,
                        scale, rad1, rad2, paths, stream);
  if (pass == 1 && (paths & 1)) {
    constexpr int RM = reg_max<T>();
    if (!reg_len(n1, Lens<RM>::P1_LO, RM)) return (int)cudaErrorInvalidValue;
    const long long cols = M * n2;
    const unsigned blocks =
        (unsigned)((cols + COL_THREADS - 1) / COL_THREADS);
    const size_t smem = sizeof(T) * 2 * (size_t)n1 * COL_THREADS;
    auto kernel = fft_long_col_kernel<RM, T>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<blocks, COL_THREADS, smem, (cudaStream_t)stream>>>(
        xr, xi, yr, yi, tw, M, n, n1, n2, sign);
    return (int)cudaGetLastError();
  }
  const int L = pass == 1 ? n1 : n2;
  const int radices = pass == 1 ? rad1 : rad2;
  // fft.cu's stage block of at most 512 threads (128 registers a thread:
  // at 64, as 1024 threads would have, the shared-memory FFT spilled)
  int threads, rows;
  stage_block<T>(L, &threads, &rows);
  if (threads > 512) {
    rows = rows * 512 / threads;
    threads = 512;
  }
  const size_t smem = stage_smem<T>(L, rows);
  auto kernel = radices == 0
                    ? fft_long_kernel<false, true, false, T>
                    : tile_instance(L, radices,
                                    fft_long_kernel<true, false, false, T>,
                                    fft_long_kernel<false, false, true, T>,
                                    fft_long_kernel<false, false, false, T>);
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
// rad2 the factors' stage radices (4 bits each, the first stage lowest), 0
// for a factor's direct DFT; paths bit 0 / bit 1: pass 1 / pass 2 holds
// its factor's rows in registers (a 2^a 3^b 5^c factor of at most 64 in
// float, 32 in double; pass 2 of a two-launch row never). _f64: the same
// on double operands.
extern "C" int spfft_fft_long(int pass, const float* xr, const float* xi,
                              float* yr, float* yi, const float* tw,
                              long long M, int n, int n1, int n2,
                              int plane_rows, int sign, float scale,
                              int rad1, int rad2, int paths, void* stream) {
  return launch_long(pass, xr, xi, yr, yi, tw, M, n, n1, n2, plane_rows, sign,
                     scale, rad1, rad2, paths, stream);
}

extern "C" int spfft_fft_long_f64(int pass, const double* xr,
                                  const double* xi, double* yr, double* yi,
                                  const double* tw, long long M, int n,
                                  int n1, int n2, int plane_rows, int sign,
                                  double scale, int rad1, int rad2,
                                  int paths, void* stream) {
  return launch_long(pass, xr, xi, yr, yi, tw, M, n, n1, n2, plane_rows, sign,
                     scale, rad1, rad2, paths, stream);
}

// The longest row pass 0 takes (WHOLE_N): the wrappers launch pass 0 up to
// it and passes 1 and 2 above it.
extern "C" int spfft_fft_long_whole_n() { return WHOLE_N; }

// Has a factor of length L a register plan in the kernels of double (f64
// nonzero) or float (a 2^a 3^b 5^c length up to reg_max): the wrappers set
// paths by it.
extern "C" int spfft_fft_long_reg_plan(int L, int f64) {
  return f64 ? reg_len(L, 2, reg_max<double>())
             : reg_len(L, 2, reg_max<float>());
}
