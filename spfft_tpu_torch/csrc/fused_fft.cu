// Sparse compression fused with the z-stick DFT, in FFT form: the ports of
// the Pallas kernels spfft_tpu/ops/fused_kernel.py:run_decompress_zdft
// (launched at :587) and run_zdft_compress (:783) for z transforms the
// plan describes (ops/dft.py: DftMats) with a length dim_z <= 512 of the
// form 2^a 3^b 5^c. They compute what fused_compress.cu's matrix kernels
// compute, which stay for any other length; both run the Stockham FFT of
// fft_tile.cuh in shared memory, on blocks of stage_block's shape (512
// threads and 32 sticks at dim_z = 256, 1024 threads above 256).
//
// decompress_zdft_fft_kernel (spfft_decompress_zdft_fft): a block owns
// `rows` consecutive sticks. Each thread reads the slot_src entries of its
// slots (the block's slots are one contiguous run of the table, so the
// reads coalesce), then the values they name (sentinel num_values = an
// empty slot, read as zero), and only then stores them into the padded
// buffer: the two dependent loads are the latency to hide, so a thread
// keeps GATHER of each in flight. For an R2C plan that owns the (x=0, y=0)
// stick (zero_stick >= 0) the block holding it then completes that stick
// by value, as the TPU kernel's _complete_zero_stick does: a slot whose
// gathered value is exactly 0 takes the conjugate of its mirror slot
// (dim_z - z) % dim_z, read again from the sparse values in device memory,
// so the fill only ever sees values from before completion. Then the
// backward FFT, and a straight store of every slot of every stick (16
// bytes a thread), zeros and the trailing sentinel stick included, so no
// stale data survives between two transforms. The raw sticks never reach
// device memory.
//
// zdft_compress_fft_kernel (spfft_zdft_compress_fft): a block stages
// `rows` raw sticks (16-byte loads) and the slice of the plan-time CSR by
// stick (stick_ptr) that covers them, runs the forward FFT, and writes
// each sparse value of its sticks exactly once: entry e of the CSR (value
// val_id[e], slot val_z[e] of the stick whose range holds e, found by a
// binary search of the staged stick_ptr) reads position (out0 + val_z)
// mod dim_z of its buffer row, times the spec's scale (the FULL scale of
// a forward pair). No atomics; duplicate triplets each get their value.
// The transformed sticks never reach device memory.
//
// Both take a leading batch as blockIdx.y with the same tables for every
// band; each band's arithmetic is the single launch's, so a batched
// result equals B single launches bit for bit. Values are read and written
// in the plan's public layout (values.cuh).
//
// Bound on the H100: bytes. At 256^3 (51,432 sticks with the sentinel,
// 8,782,782 values) decompress moves 52.7 MB of slot_src, 70.3 MB of
// values and 105.3 MB of sticks (0.068 ms at 3.35 TB/s) and needs
// 5 n log2 n FLOP per stick, 0.5e9 in all (0.008 ms at 67 TFLOP/s);
// compress moves the sticks, the CSR and the values (0.074 ms). The matrix
// form did 51,431 x 256 x 256 complex multiply-adds, about 50 times the
// FFT's arithmetic, and was bound by operations.
//
// Both kernels are templates on the real type T (real.cuh): float, and
// double for double-precision plans (entries with the suffix _f64), which
// move twice the value and stick bytes (decompress 0.136 ms at 256^3)
// with 16-byte double2 values and sticks, complete the R2C zero stick in
// double and run on fft_tile.cuh's Bounds<double> blocks.

#include "fft_tile.cuh"
#include "values.cuh"

using namespace spfft;
using namespace spfft::fft;

// slots a thread gathers per round (its slot_src loads, then its value
// loads, then its shared-memory stores): EPT / GATHER rounds
constexpr int GATHER = 8;

// values (batch, N, 2) or (batch, 2, N) -> sticks (batch, num_sticks, n);
// rows sticks a block of stage_block's threads.
template <bool POW2, class T>
__global__ void __launch_bounds__(Bounds<T>::STAGE_THREADS)
    decompress_zdft_fft_kernel(const T* __restrict__ values,
                               const int* __restrict__ slot_src,
                               const T* __restrict__ tw, T* __restrict__ sr,
                               T* __restrict__ si, long long num_sticks,
                               int num_values, int pair, long long zero_stick,
                               int rows, FftSpec<T> sp) {
  using Pair = typename Real<T>::Pair;
  extern __shared__ float4 smem4[];
  T* smem = reinterpret_cast<T*>(smem4);
  const int n = sp.n;
  const int stride = row_stride(n);
  T* re = smem;
  T* im = re + rows * stride;
  T* twr = im + rows * stride;
  T* twi = twr + n;
  const long long s0 = (long long)blockIdx.x * rows;
  const int valid = (int)min((long long)rows, num_sticks - s0);
  values += (long long)blockIdx.y * 2 * num_values;
  sr += (long long)blockIdx.y * num_sticks * n;
  si += (long long)blockIdx.y * num_sticks * n;
  const int* ss = slot_src + s0 * n;  // this block's slots, stick-major
  const int total = valid * n;
  load_twiddles(twr, twi, tw, n);

  Walk w(n);
  for (int e0 = 0; e0 < EPT; e0 += GATHER) {
    int src[GATHER];
    Pair v[GATHER];
#pragma unroll
    for (int g = 0; g < GATHER; ++g) {
      const int id = threadIdx.x + (e0 + g) * blockDim.x;
      src[g] = id < total ? ss[id] : num_values;
    }
#pragma unroll
    for (int g = 0; g < GATHER; ++g) {
      v[g] = (unsigned)src[g] < (unsigned)num_values
                 ? read_value(values, pair, num_values, src[g])
                 : make_pair(T(0), T(0));
    }
#pragma unroll
    for (int g = 0; g < GATHER; ++g, w.next()) {
      if (w.row < rows) {
        const int o = w.row * stride + pad(wrap(sp.in0 + w.col, n));
        re[o] = v[g].x;
        im[o] = v[g].y;
      }
    }
  }

  const long long zr = zero_stick - s0;
  if (zero_stick >= 0 && zr >= 0 && zr < valid) {  // the same for the block
    __syncthreads();
    const int r = (int)zr;
    for (int z = threadIdx.x; z < n; z += blockDim.x) {
      const int o = r * stride + pad(wrap(sp.in0 + z, n));
      if (re[o] == T(0) && im[o] == T(0)) {
        const int m = ss[r * n + (z == 0 ? 0 : n - z)];
        if ((unsigned)m < (unsigned)num_values) {
          const Pair c = read_value(values, pair, num_values, m);
          re[o] = c.x;
          im[o] = -c.y;
        }
      }
    }
  }
  __syncthreads();
  fft_rows<POW2>(re, im, valid, stride, sp, twr, twi);
  store_rows(re, im, valid, stride, n, n, sp.out0, sp.scale, sr, si, s0);
}

// sticks (batch, num_sticks, n) -> values (batch, N, 2) or (batch, 2, N);
// rows sticks a block of stage_block's threads.
template <bool POW2, class T>
__global__ void __launch_bounds__(Bounds<T>::STAGE_THREADS)
    zdft_compress_fft_kernel(const T* __restrict__ sr,
                             const T* __restrict__ si,
                             const T* __restrict__ tw,
                             const int* __restrict__ stick_ptr,
                             const int* __restrict__ val_id,
                             const int* __restrict__ val_z,
                             T* __restrict__ values, long long num_sticks,
                             int num_values, int pair, int rows,
                             FftSpec<T> sp) {
  extern __shared__ float4 smem4[];
  T* smem = reinterpret_cast<T*>(smem4);
  const int n = sp.n;
  const int stride = row_stride(n);
  T* re = smem;
  T* im = re + rows * stride;
  T* twr = im + rows * stride;
  T* twi = twr + n;
  int* ptr = reinterpret_cast<int*>(twi + n);  // rows + 1 entries
  const long long s0 = (long long)blockIdx.x * rows;
  const int valid = (int)min((long long)rows, num_sticks - s0);
  sr += (long long)blockIdx.y * num_sticks * n;
  si += (long long)blockIdx.y * num_sticks * n;
  values += (long long)blockIdx.y * 2 * num_values;
  load_twiddles(twr, twi, tw, n);
  for (int i = threadIdx.x; i <= valid; i += blockDim.x)
    ptr[i] = stick_ptr[s0 + i];
  load_rows(re, im, rows, valid, stride, n, n, sp.in0, sr, si, s0);
  __syncthreads();
  fft_rows<POW2>(re, im, valid, stride, sp, twr, twi);

  const T sc = sp.scale;
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
    const int o = lo * stride + pad(wrap(sp.out0 + val_z[e], n));
    write_value(values, pair, num_values, val_id[e], re[o] * sc, im[o] * sc);
  }
}

namespace {

template <class T>
int launch_decompress(const T* values, const int* slot_src, const T* tw,
                      T* sr, T* si, long long num_sticks, int num_values,
                      int pair, long long zero_stick, int batch, int n,
                      int sign, T scale, int in0, int out0, int radices,
                      void* stream) {
  int threads, rows;
  stage_block<T>(n, &threads, &rows);
  const size_t smem = stage_smem<T>(n, rows);
  auto kernel = pow2(n) ? decompress_zdft_fft_kernel<true, T>
                        : decompress_zdft_fft_kernel<false, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 blocks((unsigned)((num_sticks + rows - 1) / rows),
                    (unsigned)batch);
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      values, slot_src, tw, sr, si, num_sticks, num_values, pair, zero_stick,
      rows, FftSpec<T>{n, sign, scale, in0, out0, radices});
  return (int)cudaGetLastError();
}

template <class T>
int launch_compress(const T* sr, const T* si, const T* tw,
                    const int* stick_ptr, const int* val_id,
                    const int* val_z, T* values, long long num_sticks,
                    int num_values, int pair, int batch, int n, int sign,
                    T scale, int in0, int out0, int radices, void* stream) {
  int threads, rows;
  stage_block<T>(n, &threads, &rows);
  const size_t smem = stage_smem<T>(n, rows) + sizeof(int) * (rows + 1);
  auto kernel = pow2(n) ? zdft_compress_fft_kernel<true, T>
                        : zdft_compress_fft_kernel<false, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 blocks((unsigned)((num_sticks + rows - 1) / rows),
                    (unsigned)batch);
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      sr, si, tw, stick_ptr, val_id, val_z, values, num_sticks, num_values,
      pair, rows, FftSpec<T>{n, sign, scale, in0, out0, radices});
  return (int)cudaGetLastError();
}

}  // namespace

// One launch for `batch` transforms: values (batch, N, 2) or (batch, 2, N)
// through slot_src (num_sticks * n int32 entries, sentinel N) -> sticks
// (batch, num_sticks, n); the transform (n, sign, scale, in0, out0,
// radices) with twiddle table tw ((2, n) on the device). _f64: the same on
// double operands.
extern "C" int spfft_decompress_zdft_fft(
    const float* values, const int* slot_src, const float* tw, float* sr,
    float* si, long long num_sticks, int num_values, int pair,
    long long zero_stick, int batch, int n, int sign, float scale, int in0,
    int out0, int radices, void* stream) {
  return launch_decompress(values, slot_src, tw, sr, si, num_sticks,
                           num_values, pair, zero_stick, batch, n, sign,
                           scale, in0, out0, radices, stream);
}

extern "C" int spfft_decompress_zdft_fft_f64(
    const double* values, const int* slot_src, const double* tw, double* sr,
    double* si, long long num_sticks, int num_values, int pair,
    long long zero_stick, int batch, int n, int sign, double scale, int in0,
    int out0, int radices, void* stream) {
  return launch_decompress(values, slot_src, tw, sr, si, num_sticks,
                           num_values, pair, zero_stick, batch, n, sign,
                           scale, in0, out0, radices, stream);
}

// One launch for `batch` transforms: sticks (batch, num_sticks, n) ->
// values (batch, N, 2) or (batch, 2, N) through the CSR by stick
// (stick_ptr (num_sticks + 1,), val_id and val_z (N,), int32); the
// transform as for spfft_decompress_zdft_fft. _f64: the same on double
// operands.
extern "C" int spfft_zdft_compress_fft(
    const float* sr, const float* si, const float* tw, const int* stick_ptr,
    const int* val_id, const int* val_z, float* values, long long num_sticks,
    int num_values, int pair, int batch, int n, int sign, float scale,
    int in0, int out0, int radices, void* stream) {
  return launch_compress(sr, si, tw, stick_ptr, val_id, val_z, values,
                         num_sticks, num_values, pair, batch, n, sign, scale,
                         in0, out0, radices, stream);
}

extern "C" int spfft_zdft_compress_fft_f64(
    const double* sr, const double* si, const double* tw,
    const int* stick_ptr, const int* val_id, const int* val_z,
    double* values, long long num_sticks, int num_values, int pair,
    int batch, int n, int sign, double scale, int in0, int out0,
    int radices, void* stream) {
  return launch_compress(sr, si, tw, stick_ptr, val_id, val_z, values,
                         num_sticks, num_values, pair, batch, n, sign, scale,
                         in0, out0, radices, stream);
}
