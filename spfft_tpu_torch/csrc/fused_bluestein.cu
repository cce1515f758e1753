// Sparse compression fused with the z-stick DFT in the Bluestein form: the
// ports of the Pallas kernels spfft_tpu/ops/fused_kernel.py:
// run_decompress_zdft (launched at :587) and run_zdft_compress (:783) for a
// z transform the plan describes (ops/dft.py: DftMats of the form
// "bluestein") at a dim_z <= 512 with a prime of 13 or more (13, 26, 416 =
// 2^5 x 13, 509, ...: 374 of the 512 lengths), which has no FFT form of
// its own. fused_fft.cu takes every other dim_z; fused_compress.cu's
// matrix form serves a plain matrix pair passed without its function, and
// no plan runs it.
//
// Each kernel is the chirp-z transform of bluestein.cu (kernel B) over the
// sticks a block owns, R whole sticks of the convolution's length M =
// ops/dft.py: bluestein_length(dim_z) (900 = 30 x 30 at 416, 1024 = 32 x 32
// at 509, 25 = 5 x 5 at 13), through bluestein.cuh's three phases with the
// length's own BluesteinTables (the chirp, the spectrum B with the scale
// folded in, the twiddles of M), read through the read-only cache; the
// gather and the compression take the places of kernel B's dense rows:
//
// decompress_zdft_bluestein_kernel (spfft_decompress_zdft_bluestein): S1
// makes a[j] = x[j] w[j] on the fly from the gather: slot q = (j - x0) mod
// dim_z of the block's stick reads slot_src (the block's slots are one
// contiguous run of the table, and a warp's items sit on neighbouring j,
// so those reads coalesce) and then the value it names (sentinel
// num_values = an empty slot, read as zero), a work item's slot_src loads
// issued four at a time ahead of their value loads (bluestein.cuh:
// BL_FETCH, as fused_fft.cu's GATHER). For an R2C plan that owns the (x=0,
// y=0) stick (zero_stick >= 0) the stick is completed by value, as
// fused_fft.cu does it: a slot whose value is exactly 0 takes the
// conjugate of its mirror slot (dim_z - q) % dim_z, read again from the
// sparse values. S3 keeps u in the pass-1 layout (a store straight from
// the registers, beside the gather's state, spilled), and the block then
// stores every slot of its sticks, output o from bin (y0 + o) mod dim_z,
// neighbouring threads on neighbouring slots (zeros and the trailing
// sentinel stick included). The raw sticks never reach device memory.
//
// zdft_compress_bluestein_kernel (spfft_zdft_compress_bluestein): S1 reads
// the raw sticks as kernel B reads its rows; S3 keeps the transformed
// sticks' u in the pass-1 layout, as kernel B's transposed store does; then
// the block walks its slice of the plan-time CSR by stick (stick_ptr staged
// in shared memory, val_id, val_z): entry e, found in its stick by a binary
// search of the staged stick_ptr, reads bin (y0 + val_z[e]) mod dim_z and
// writes value val_id[e] exactly once. No atomics; duplicate triplets each
// get their value. The transformed sticks never reach device memory.
//
// Both take a leading batch as blockIdx.y with the same tables for every
// band; each band's arithmetic is the single launch's, so a batched result
// equals B single launches bit for bit. Values are read and written in the
// plan's public layout (values.cuh). Blocks as kernel B's (bl_shape): about
// 256 work items in the busier phase, within the shared memory of two
// blocks a float SM holds (BlueOcc): R = 8 sticks of 900 at 416.
//
// Bound on the H100: bytes. At 416 over 65,536 sticks half full (13.6 M
// values) decompress moves 109.1 MB of slot_src, 109.1 MB of values and
// 218.1 MB of sticks (0.13 ms at 3.35 TB/s); the design does 2 x 5 M log2
// M + 8 M FLOP a stick, about 96 kFLOP at M = 900 and 6.3 GFLOP in all
// (0.09 ms at 67 TFLOP/s), where the matrix form did 6 dim_z^2 FLOP a stick
// (68 GFLOP, 1.02 ms) and was bound by operations. Compress moves the
// sticks, the CSR and the values.
//
// Both kernels are templates on the real type T (real.cuh): float, and
// double (entries with the suffix _f64), each factor of M (at most 32) a
// thread's register row in both; the launchers refuse any split with a
// factor off the register path (paths other than 3). With no shared-
// memory FFT beside the register rows, the double instance holds its
// rows in 254 registers with no spill (one block an SM).

#include "bluestein.cuh"
#include "values.cuh"

using namespace spfft;
using namespace spfft::fft;

// the factors of every Bluestein M of a dim_z up to 512: a thread's rows
using FusedLens = BlueLens<5, 32>;

// bl_s1's loader of raw sticks: slot q = (j - x0) mod n of the block's
// stick r, times the (2, n) chirp; it fetches nothing ahead (its loads need
// no address loaded first)
template <class T>
struct StickLoad {
  using Slot = char;
  const T* __restrict__ sr;
  const T* __restrict__ si;
  const T* __restrict__ chirp;
  int n, x0;

  __device__ __forceinline__ Slot fetch(int, int) const { return 0; }
  __device__ __forceinline__ void make(Slot, int r, int j, T& re,
                                       T& im) const {
    re = im = T(0);
    if (j >= n) return;
    int q = j - x0;
    if (q < 0) q += n;
    bl_in(sr[r * n + q], si[r * n + q], j, n, chirp, re, im);
  }
};

// bl_s1's loader of gathered sticks: slot q = (j - x0) mod n of the
// block's stick r names its value in slot_src (ss: the block's run of it;
// sentinel num_values = an empty slot, zero); in the zero stick (row zr of
// the block, or -1) a slot whose value is exactly 0 takes the conjugate of
// its mirror slot's, read again from the values; times the (2, n) chirp.
template <class T>
struct GatherLoad {
  using Slot = int;
  const T* __restrict__ values;
  const int* __restrict__ ss;
  const T* __restrict__ chirp;
  int n, x0, num_values, pair, zr;

  __device__ __forceinline__ int slot(int j) const {
    const int q = j - x0;
    return q < 0 ? q + n : q;
  }
  __device__ __forceinline__ int fetch(int r, int j) const {
    return j < n ? ss[r * n + slot(j)] : num_values;
  }
  __device__ __forceinline__ void make(int src, int r, int j, T& re,
                                       T& im) const {
    using Pair = typename Real<T>::Pair;
    re = im = T(0);
    if (j >= n) return;
    Pair v = (unsigned)src < (unsigned)num_values
                 ? read_value(values, pair, num_values, src)
                 : make_pair(T(0), T(0));
    if (r == zr && v.x == T(0) && v.y == T(0)) {
      const int q = slot(j);
      const int m = ss[r * n + (q == 0 ? 0 : n - q)];
      if ((unsigned)m < (unsigned)num_values) {
        const Pair c = read_value(values, pair, num_values, m);
        v = make_pair(c.x, -c.y);
      }
    }
    bl_in(v.x, v.y, j, n, chirp, re, im);
  }
};

// values (batch, N, 2) or (batch, 2, N) -> sticks (batch, num_sticks, n);
// rows sticks a block.
template <class T>
__global__ void __launch_bounds__(BL_THREADS, (BlueOcc<T>::BLOCKS))
    decompress_zdft_bluestein_kernel(
        const T* __restrict__ values, const int* __restrict__ slot_src,
        const T* __restrict__ chirp, const T* __restrict__ spec,
        const T* __restrict__ tw, T* __restrict__ sr, T* __restrict__ si,
        long long num_sticks, int num_values, int pair,
        long long zero_stick, int n, int x0, int y0, int rows, int m1,
        int m2) {
  extern __shared__ float4 smem4[];
  const BlueBlock<T, FusedLens> k = bl_block<T, FusedLens>(
      reinterpret_cast<T*>(smem4), rows, m1, m2, tw);
  const long long s0 = (long long)blockIdx.x * rows;
  const int valid = (int)min((long long)rows, num_sticks - s0);
  values += (long long)blockIdx.y * 2 * num_values;
  // this block's sticks
  sr += (long long)blockIdx.y * num_sticks * n + s0 * n;
  si += (long long)blockIdx.y * num_sticks * n + s0 * n;
  const int* ss = slot_src + s0 * n;  // this block's slots, stick-major
  // the zero stick's row in this block, or -1
  const long long zl = zero_stick - s0;
  const int zr = zero_stick >= 0 && zl >= 0 && zl < valid ? (int)zl : -1;
  __syncthreads();

  bl_s1(k, valid, tw,
        GatherLoad<T>{values, ss, chirp, n, x0, num_values, pair, zr});
  __syncthreads();
  bl_s2(k, valid, spec, tw);
  __syncthreads();
  // u stays in the pass-1 layout (a store straight from the registers,
  // beside the gather's state, would spill)
  bl_s3(k, valid);
  __syncthreads();
  // every slot of the block's sticks, neighbouring threads on neighbouring
  // slots
  for (int f = threadIdx.x; f < valid * n; f += blockDim.x) {
    const int r = f / n;
    const int o = f - r * n;
    const int j = wrap(y0 + o, n);
    const int e = bl_u(k, r, j);
    bl_out(k.pr[e], k.pi[e], j, n, chirp, sr[f], si[f]);
  }
}

// sticks (batch, num_sticks, n) -> values (batch, N, 2) or (batch, 2, N);
// rows sticks a block.
template <class T>
__global__ void __launch_bounds__(BL_THREADS, (BlueOcc<T>::BLOCKS))
    zdft_compress_bluestein_kernel(
        const T* __restrict__ sr, const T* __restrict__ si,
        const T* __restrict__ chirp, const T* __restrict__ spec,
        const T* __restrict__ tw, const int* __restrict__ stick_ptr,
        const int* __restrict__ val_id, const int* __restrict__ val_z,
        T* __restrict__ values, long long num_sticks, int num_values,
        int pair, int n, int x0, int y0, int rows, int m1, int m2) {
  extern __shared__ float4 smem4[];
  const BlueBlock<T, FusedLens> k = bl_block<T, FusedLens>(
      reinterpret_cast<T*>(smem4), rows, m1, m2, tw);
  int* ptr = k.ints;  // rows + 1 entries
  const long long s0 = (long long)blockIdx.x * rows;
  const int valid = (int)min((long long)rows, num_sticks - s0);
  sr += (long long)blockIdx.y * num_sticks * n + s0 * n;
  si += (long long)blockIdx.y * num_sticks * n + s0 * n;
  values += (long long)blockIdx.y * 2 * num_values;
  for (int i = threadIdx.x; i <= valid; i += blockDim.x)
    ptr[i] = stick_ptr[s0 + i];
  __syncthreads();

  bl_s1(k, valid, tw, StickLoad<T>{sr, si, chirp, n, x0});
  __syncthreads();
  bl_s2(k, valid, spec, tw);
  __syncthreads();
  bl_s3(k, valid);
  __syncthreads();

  const int hi_e = ptr[valid];
  for (int e = ptr[0] + threadIdx.x; e < hi_e; e += blockDim.x) {
    int lo = 0, hi = valid;  // ptr[lo] <= e < ptr[hi]
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (ptr[mid] <= e)
        lo = mid;
      else
        hi = mid;
    }
    const int j = wrap(y0 + val_z[e], n);
    const int u = bl_u(k, lo, j);
    T yr, yi;
    bl_out(k.pr[u], k.pi[u], j, n, chirp, yr, yi);
    write_value(values, pair, num_values, val_id[e], yr, yi);
  }
}

namespace {

// the transform's arguments are ones the kernels take: both factors in
// registers (paths 3)
template <class T>
bool fused_ok(long long num_sticks, int num_values, int batch, int n, int x0,
              int y0, int mm, int m1, int m2, int paths) {
  return num_sticks >= 0 && num_values >= 0 && batch >= 1 &&
         batch <= 65535 && x0 >= 0 && x0 < n && y0 >= 0 && y0 < n &&
         paths == 3 && bl_split_ok<T, FusedLens>(n, mm, m1, m2, paths);
}

template <class T>
int launch_decompress(const T* values, const int* slot_src, const T* chirp,
                      const T* spec, const T* tw, T* sr, T* si,
                      long long num_sticks, int num_values, int pair,
                      long long zero_stick, int batch, int n, int x0, int y0,
                      int mm, int m1, int m2, int paths, void* stream) {
  if (!fused_ok<T>(num_sticks, num_values, batch, n, x0, y0, mm, m1, m2,
                   paths) ||
      zero_stick < -1 || zero_stick >= num_sticks)
    return (int)cudaErrorInvalidValue;
  if (num_sticks == 0) return (int)cudaSuccess;
  int rows, threads;
  size_t smem;
  bl_shape<T>(m1, m2, paths, false, &rows, &threads, &smem);
  auto kernel = decompress_zdft_bluestein_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 blocks((unsigned)((num_sticks + rows - 1) / rows),
                    (unsigned)batch);
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      values, slot_src, chirp, spec, tw, sr, si, num_sticks, num_values,
      pair, zero_stick, n, x0, y0, rows, m1, m2);
  return (int)cudaGetLastError();
}

template <class T>
int launch_compress(const T* sr, const T* si, const T* chirp, const T* spec,
                    const T* tw, const int* stick_ptr, const int* val_id,
                    const int* val_z, T* values, long long num_sticks,
                    int num_values, int pair, int batch, int n, int x0,
                    int y0, int mm, int m1, int m2, int paths,
                    void* stream) {
  if (!fused_ok<T>(num_sticks, num_values, batch, n, x0, y0, mm, m1, m2,
                   paths))
    return (int)cudaErrorInvalidValue;
  if (num_sticks == 0) return (int)cudaSuccess;
  int rows, threads;
  size_t smem;
  bl_shape<T>(m1, m2, paths, true, &rows, &threads, &smem);
  auto kernel = zdft_compress_bluestein_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 blocks((unsigned)((num_sticks + rows - 1) / rows),
                    (unsigned)batch);
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      sr, si, chirp, spec, tw, stick_ptr, val_id, val_z, values, num_sticks,
      num_values, pair, n, x0, y0, rows, m1, m2);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch for `batch` transforms: values (batch, N, 2) or (batch, 2, N)
// through slot_src (num_sticks * n int32 entries, sentinel N) -> sticks
// (batch, num_sticks, n), the (0,0) stick zero_stick completed (-1: none);
// slot q at position (x0 + q) mod n, output o from position (y0 + o) mod n;
// chirp the (n, 4) table w, spec the (mm, 4) spectrum B (the scale folded
// in), tw the (mm, 4) forward twiddles of the convolution's length mm = m1
// m2; rad1, rad2 and paths as bluestein.cu's entry takes them (the split
// arguments ops/dft_kernel.py gives both): paths must be 3 (m1 and m2 in
// registers), and the radices, which only a shared-memory FFT reads, are
// not read. _f64: the same on double operands.
extern "C" int spfft_decompress_zdft_bluestein(
    const float* values, const int* slot_src, const float* chirp,
    const float* spec, const float* tw, float* sr, float* si,
    long long num_sticks, int num_values, int pair, long long zero_stick,
    int batch, int n, int x0, int y0, int mm, int m1, int m2, int /*rad1*/,
    int /*rad2*/, int paths, void* stream) {
  return launch_decompress(values, slot_src, chirp, spec, tw, sr, si,
                           num_sticks, num_values, pair, zero_stick, batch,
                           n, x0, y0, mm, m1, m2, paths, stream);
}

extern "C" int spfft_decompress_zdft_bluestein_f64(
    const double* values, const int* slot_src, const double* chirp,
    const double* spec, const double* tw, double* sr, double* si,
    long long num_sticks, int num_values, int pair, long long zero_stick,
    int batch, int n, int x0, int y0, int mm, int m1, int m2, int /*rad1*/,
    int /*rad2*/, int paths, void* stream) {
  return launch_decompress(values, slot_src, chirp, spec, tw, sr, si,
                           num_sticks, num_values, pair, zero_stick, batch,
                           n, x0, y0, mm, m1, m2, paths, stream);
}

// One launch for `batch` transforms: sticks (batch, num_sticks, n) ->
// values (batch, N, 2) or (batch, 2, N) through the CSR by stick
// (stick_ptr (num_sticks + 1,), val_id and val_z (N,), int32); the
// transform as for spfft_decompress_zdft_bluestein. _f64: the same on
// double operands.
extern "C" int spfft_zdft_compress_bluestein(
    const float* sr, const float* si, const float* chirp, const float* spec,
    const float* tw, const int* stick_ptr, const int* val_id,
    const int* val_z, float* values, long long num_sticks, int num_values,
    int pair, int batch, int n, int x0, int y0, int mm, int m1, int m2,
    int /*rad1*/, int /*rad2*/, int paths, void* stream) {
  return launch_compress(sr, si, chirp, spec, tw, stick_ptr, val_id, val_z,
                         values, num_sticks, num_values, pair, batch, n, x0,
                         y0, mm, m1, m2, paths, stream);
}

extern "C" int spfft_zdft_compress_bluestein_f64(
    const double* sr, const double* si, const double* chirp,
    const double* spec, const double* tw, const int* stick_ptr,
    const int* val_id, const int* val_z, double* values, long long num_sticks,
    int num_values, int pair, int batch, int n, int x0, int y0, int mm,
    int m1, int m2, int /*rad1*/, int /*rad2*/, int paths,
    void* stream) {
  return launch_compress(sr, si, chirp, spec, tw, stick_ptr, val_id, val_z,
                         values, num_sticks, num_values, pair, batch, n, x0,
                         y0, mm, m1, m2, paths, stream);
}

// Has a factor of length L a register plan in these kernels of double (f64
// nonzero) or float (fft_reg.cuh's has_plan from 5 to 32): the wrapper
// sets paths by it.
extern "C" int spfft_fused_bluestein_reg_plan(int L, int f64) {
  return f64 ? bl_reg<double, FusedLens>(L) : bl_reg<float, FusedLens>(L);
}
