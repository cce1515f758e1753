// Shared device and host code of the Bluestein kernels (bluestein.cu: kernel
// B, a DFT along rows; fused_bluestein.cu: the fused z kernels at a dim_z
// with a prime of 13 or more): the block's constants and shape, a register
// row's FFT, the twiddle product, and, for the fused kernels, the three
// phases of the chirp-z transform over the R whole rows a block owns, each
// factor a thread's register row (the M of a dim_z up to 512 splits into
// factors of at most 32: ops/dft.py's bluestein_length; kernel B runs the
// same phases written out in its own body, with its lane pairs and its
// double shared-memory path, whose register allocation sits at its float
// limit). The method and its bound
// are bluestein.cu's header; in short, with w[j] = e^(sign i pi j^2 / n), a
// row's DFT is
//
//   X[k] = w[k] sum_j (x[j] w[j]) conj(w[k - j]),
//
// a circular convolution of length M = m1 m2 run as two length-M FFTs
// (the second the forward one between two conjugations) in the four-step
// form: (S1) over i1 of the columns (r, i2) of a[j] = x[j] w[j], j = i1 m2
// + i2, into the pass-2 layout Q; (S2) over i2 of the sub-rows (r, k1),
// times the spectrum B, conjugated, over k2 again, into the pass-1 layout
// P; (S3) over k1 of the sub-rows (r, j_a): bin j_b is u = the conjugate
// of the convolution at j = j_a + m2 j_b, and X[j] = conj(u) w[j]. The
// fused kernels differ only in where a[j] comes from (bl_s1's loader) and
// where X[j] goes (a pass of the caller's own over u in P: bl_u). Each
// phase ends before a barrier the caller places.
#pragma once

#include "fft_reg.cuh"

namespace spfft {
namespace fft {

// the most threads of a block; the shared memory of one block, and of the
// two a float SM holds
constexpr int BL_THREADS = 256;
constexpr size_t BL_SMEM_MAX = 232448;
// the fetches a work item of S1 issues ahead of their makes (bl_s1)
constexpr int BL_FETCH = 4;

// Blocks an SM: two in float (128 registers a thread: every factor runs as
// a thread's row of at most 32 or a lane pair's), one in double.
template <class T>
struct BlueOcc {
  static constexpr int BLOCKS = sizeof(T) == 4 ? 2 : 1;
};

// a read through the read-only data cache: the chirp, the spectrum and the
// twiddles (a few KB, shared by every block) stay in L1
template <class T>
__device__ __forceinline__ T ro(const T* p) {
  return __ldg(p);
}

// bin k's value times W_M^(e k) at o[k st] (the other layout's sub-row)
template <class T>
__device__ __forceinline__ void bl_tw_put(T vr, T vi, int e, int k,
                                          const T* __restrict__ tw, int mm,
                                          T* o_r, T* o_i, int st) {
  const T cw = ro(tw + e * k), sw = ro(tw + mm + e * k);
  o_r[k * st] = vr * cw - vi * sw;
  o_i[k * st] = vr * sw + vi * cw;
}

// One register row of length L, a thread's (L <= 32) or a lane pair's:
// load(q, re, im) gives element q, the row's FFT against the factor's table
// (twr, twi), and put(k, re, im) takes bin k, each bin once (a pair's lanes
// split the bins). b: the lane's place in its pair (0 for a thread's row).
template <int L, class T, class Load, class Put>
__device__ __forceinline__ void bl_row(int b, const T* twr, const T* twi,
                                       Load load, Put put) {
  if constexpr (L <= 32) {
    T vr[L], vi[L];
#pragma unroll
    for (int q = 0; q < L; ++q) load(q, vr[q], vi[q]);
    reg_fft<L>(vr, vi, twr, twi, T(-1));
    fence_loads();
#pragma unroll
    for (int k = 0; k < L; ++k) put(k, vr[k], vi[k]);
  } else {
    constexpr int H = L / 2, HA = Pair<L>::HA, HB = Pair<L>::HB;
    T xr_[H], xi_[H], vr[2 * HA], vi[2 * HA];
#pragma unroll
    for (int q = 0; q < H; ++q) load(2 * q + b, xr_[q], xi_[q]);
    pair_fft<L>(xr_, xi_, vr, vi, b, twr, twi, T(-1));
    fence_loads();
#pragma unroll
    for (int i = 0; i < HA; ++i) {
      if (b == 0 || i < HB) {
        put(i + b * HA, vr[i], vi[i]);
        put(i + b * HA + H, vr[HA + i], vi[HA + i]);
      }
    }
  }
}

// The factor lengths a kernel compiles register plans for: those of
// with_len in [LO, HI] with a plan in T (fft_reg.cuh: has_plan). Kernel B
// takes any factor of a Bluestein M up to 2048 (2 to 64); the fused z
// kernels those of the M of a dim_z up to 512 (5 to 32: ops/dft.py's
// bluestein_length gives no other), which shortens their build.
template <int LO_, int HI_>
struct BlueLens {
  static constexpr int LO = LO_, HI = HI_;
};

// a factor of length L runs in registers in a T kernel of Lens
template <class T, class Lens>
__host__ __device__ constexpr bool bl_reg(int L) {
  return L >= Lens::LO && L <= Lens::HI && has_plan<T>(L);
}

// f(Len<L>{}) for a factor with a register plan in a T kernel of Lens
template <class T, class Lens, class F>
__device__ __forceinline__ void bl_len(int L, F&& f) {
  constexpr int HI = Lens::HI < reg_max<T>() ? Lens::HI : reg_max<T>();
  with_len<Lens::LO, HI>(L, [&](auto len) {
    if constexpr (has_plan<T>(decltype(len)::value)) f(len);
  });
}

// A block's shared memory: the pass-1 layout P (sub-row (r, i2) of m1),
// the pass-2 layout Q (sub-row (r, k1) of m2), the factors' tables, then
// the caller's ints (a CSR slice). Both factors run in registers (the
// launchers refuse any other split), in double too.
template <class T, class Lens>
struct BlueBlock {
  T *pr, *pi, *qr, *qi, *t1r, *t1i, *t2r, *t2i;
  int* ints;
  int m1, m2, mm, st1, st2;
};

// the block's layouts over `smem` for `rows` rows of the split m1 x m2,
// and the factors' tables loaded from the (2, M) twiddles tw (the caller's
// barrier follows)
template <class T, class Lens>
__device__ __forceinline__ BlueBlock<T, Lens> bl_block(
    T* smem, int rows, int m1, int m2, const T* __restrict__ tw) {
  BlueBlock<T, Lens> k;
  k.m1 = m1;
  k.m2 = m2;
  k.mm = k.m1 * k.m2;
  k.st1 = row_stride(k.m1);
  k.st2 = row_stride(k.m2);
  const int wp = rows * k.m2 * k.st1, wq = rows * k.m1 * k.st2;
  k.pr = smem;
  k.pi = k.pr + wp;
  k.qr = k.pi + wp;
  k.qi = k.qr + wq;
  k.t1r = k.qi + wq;
  k.t1i = k.t1r + k.m1;
  k.t2r = k.t1i + k.m1;
  k.t2i = k.t2r + k.m2;
  k.ints = reinterpret_cast<int*>(k.t2i + k.m2);
  for (int m = threadIdx.x; m < k.m1; m += blockDim.x) {
    k.t1r[m] = tw[m * k.m2];
    k.t1i[m] = tw[k.mm + m * k.m2];
  }
  for (int m = threadIdx.x; m < k.m2; m += blockDim.x) {
    k.t2r[m] = tw[m * k.m1];
    k.t2i[m] = tw[k.mm + m * k.m1];
  }
  return k;
}

// S1: a[j] at j = i1 m2 + i2 for the block's first `valid` rows, FFT_M's
// pass over i1, times W_M^(i2 k1), into the pass-2 layout. The loader ld
// gives a[j] in two steps: ld.fetch(r, j) makes the loads a[j] starts from
// (an input value, or the slot a gathered value sits in), ld.make(s, r, j,
// re, im) makes a[j] from them (x[j] w[j], or 0 beyond the row). A work
// item takes column (r, i2), so a warp's loads fall on neighbouring j, and
// issues BL_FETCH of its column's fetches before it makes the first of
// them, so that they are in flight together (fused_fft.cu's GATHER), a
// group at a time (more of them held beside the row would spill).
template <class T, class Lens, class Load>
__device__ __forceinline__ void bl_s1(const BlueBlock<T, Lens>& k, int valid,
                                      const T* __restrict__ tw,
                                      const Load& ld) {
  const int m2 = k.m2, mm = k.mm, st2 = k.st2;
  bl_len<T, Lens>(k.m1, [&](auto len) {
    constexpr int L = decltype(len)::value;
    // a lane pair for a row above 32: two work items a row, each with
    // every other element
    constexpr int P = L > 32 ? 2 : 1;
    const int b = L > 32 ? (threadIdx.x & 1) : 0;
    const int c2 = threadIdx.x;  // one work item a thread (bl_shape)
    if (c2 < valid * m2 * P) {
      const int c = c2 / P;  // column (r, i2)
      const int r = c / m2;
      const int i2 = c - r * m2;
      // the column's fetches, BL_FETCH at a time ahead of their makes
      typename Load::Slot sl[L / P];
      T* o_r = k.qr + r * L * st2 + pad(i2);
      T* o_i = k.qi + r * L * st2 + pad(i2);
      bl_row<L, T>(
          b, k.t1r, k.t1i,
          [&](int i1, T& re, T& im) {
            // the lane's q-th element (i1 = P q + b): a constant in the
            // unrolled row
            const int q = (i1 - b) / P;
            if (q % BL_FETCH == 0) {
              // no load of a later group is hoisted above this one's
              fence_loads();
#pragma unroll
              for (int f = q; f < q + BL_FETCH && f < L / P; ++f)
                sl[f] = ld.fetch(r, (P * f + b) * m2 + i2);
            }
            ld.make(sl[q], r, i1 * m2 + i2, re, im);
          },
          [&](int k1, T re, T im) {
            bl_tw_put(re, im, i2, k1, tw, mm, o_r, o_i, st2);
          });
    }
  });
}

// S2: FFT_M's pass over i2 (bins k = k2 m1 + k1), times the spectrum B[k]
// (spec, (2, M), the scale folded in), conjugated, back into the sub-row;
// the second FFT's pass over k2 (bins j_a), times W_M^(k1 j_a), into the
// pass-1 layout.
template <class T, class Lens>
__device__ __forceinline__ void bl_s2(const BlueBlock<T, Lens>& k, int valid,
                                      const T* __restrict__ spec,
                                      const T* __restrict__ tw) {
  const int m1 = k.m1, mm = k.mm, st1 = k.st1, st2 = k.st2;
  bl_len<T, Lens>(k.m2, [&](auto len) {
    constexpr int L = decltype(len)::value;
    constexpr int P = L > 32 ? 2 : 1;
    const int b = L > 32 ? (threadIdx.x & 1) : 0;
    const int c2 = threadIdx.x;  // one work item a thread (bl_shape)
    if (c2 < valid * m1 * P) {
      const int c = c2 / P;  // sub-row (r, k1)
      const int r = c / m1;
      const int k1 = c - r * m1;
      T* q_r = k.qr + c * st2;
      T* q_i = k.qi + c * st2;
      bl_row<L, T>(
          b, k.t2r, k.t2i,
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
      if (P == 2) __syncwarp(pair_mask());
      T* o_r = k.pr + r * L * st1 + pad(k1);
      T* o_i = k.pi + r * L * st1 + pad(k1);
      bl_row<L, T>(
          b, k.t2r, k.t2i,
          [&](int q, T& re, T& im) {
            re = q_r[pad(q)];
            im = q_i[pad(q)];
          },
          [&](int ja, T re, T im) {
            bl_tw_put(re, im, k1, ja, tw, mm, o_r, o_i, st1);
          });
    }
  });
}

// S3: the pass over k1 (bins j_b): sub-row (r, j_a), bin j_b is the
// conjugate u of the convolution at j = j_a + m2 j_b, kept in the pass-1
// layout for the caller to read through bl_u after a barrier.
template <class T, class Lens>
__device__ __forceinline__ void bl_s3(const BlueBlock<T, Lens>& k,
                                      int valid) {
  const int m2 = k.m2, st1 = k.st1;
  bl_len<T, Lens>(k.m1, [&](auto len) {
    constexpr int L = decltype(len)::value;
    constexpr int P = L > 32 ? 2 : 1;
    const int b = L > 32 ? (threadIdx.x & 1) : 0;
    const int c2 = threadIdx.x;  // one work item a thread (bl_shape)
    if (c2 < valid * m2 * P) {
      T* p_r = k.pr + (c2 / P) * st1;  // sub-row (r, j_a)
      T* p_i = k.pi + (c2 / P) * st1;
      bl_row<L, T>(
          b, k.t1r, k.t1i,
          [&](int q, T& re, T& im) {
            re = p_r[pad(q)];
            im = p_i[pad(q)];
          },
          [&](int jb, T re, T im) {
            // both lanes of a pair read before any writes
            p_r[pad(jb)] = re;
            p_i[pad(jb)] = im;
          });
    }
  });
}

// the offset in the pass-1 layout of row r's u at j (after bl_s3 kept it)
template <class T, class Lens>
__device__ __forceinline__ int bl_u(const BlueBlock<T, Lens>& k, int r,
                                    int j) {
  const int jb = j / k.m2;
  return (r * k.m2 + j - jb * k.m2) * k.st1 + pad(jb);
}

// X[j] = conj(u) w[j] from u at j and the (2, n) chirp
template <class T>
__device__ __forceinline__ void bl_out(T ur, T ui, int j, int n,
                                       const T* __restrict__ chirp, T& yr,
                                       T& yi) {
  const T cw = ro(chirp + j), sw = ro(chirp + n + j);
  yr = ur * cw + ui * sw;
  yi = ur * sw - ui * cw;
}

// a[j] = x w[j] from x at j and the (2, n) chirp
template <class T>
__device__ __forceinline__ void bl_in(T ar, T ai, int j, int n,
                                      const T* __restrict__ chirp, T& re,
                                      T& im) {
  const T c = ro(chirp + j), s = ro(chirp + n + j);
  re = ar * c - ai * s;
  im = ar * s + ai * c;
}

// the block's shared memory: both layouts, the factors' tables and `ints`
// ints of the caller's
template <class T>
size_t bl_smem(int rows, int m1, int m2, int ints) {
  return sizeof(T) * (2 * (size_t)rows * (m2 * row_stride(m1) +
                                          m1 * row_stride(m2)) +
                      2 * (size_t)(m1 + m2)) +
         sizeof(int) * (size_t)ints;
}

// A launch's block: `rows` rows of about BL_THREADS work items in the
// busier phase (a pair's row counts twice), within the shared memory of
// BlueOcc<T>::BLOCKS blocks an SM (with rows + 1 ints of a CSR slice where
// csr), and its threads and shared memory: every work item of a phase has
// a thread of its own (the phases' register paths take one each, which
// keeps no state across items and the fused kernels off their float
// register limit).
template <class T>
void bl_shape(int m1, int m2, int paths, bool csr, int* rows, int* threads,
              size_t* smem) {
  const bool reg1 = paths & 1, reg2 = paths & 2;
  const int p1 = reg1 && m1 > 32 ? 2 : 1, p2 = reg2 && m2 > 32 ? 2 : 1;
  const int items = max(m2 * p1, m1 * p2);
  const size_t smax = BL_SMEM_MAX / BlueOcc<T>::BLOCKS;
  int r = max(1, BL_THREADS / items);
  while (r > 1 && bl_smem<T>(r, m1, m2, csr ? r + 1 : 0) > smax) --r;
  *rows = r;
  *smem = bl_smem<T>(r, m1, m2, csr ? r + 1 : 0);
  *threads = min(BL_THREADS, (r * items + 31) / 32 * 32);
}

// The convolution's split is one a T kernel of Lens runs: m1 <= m2 <=
// 256, m1 m2 = mm >= 2 n - 1, each factor in registers where paths says so
// (in float, both).
template <class T, class Lens>
bool bl_split_ok(int n, int mm, int m1, int m2, int paths) {
  const bool reg1 = paths & 1, reg2 = paths & 2;
  return n >= 1 && m1 >= 1 && m2 >= m1 && m2 <= 256 && m1 * m2 == mm &&
         mm >= 2 * n - 1 && paths >= 0 && paths <= 3 &&
         (!reg1 || bl_reg<T, Lens>(m1)) && (!reg2 || bl_reg<T, Lens>(m2)) &&
         (sizeof(T) != 4 || paths == 3);
}

}  // namespace fft
}  // namespace spfft
