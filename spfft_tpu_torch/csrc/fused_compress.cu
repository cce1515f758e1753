// Sparse compression fused with the z-stick DFT, in matrix form: ports of
// the Pallas kernels spfft_tpu/ops/fused_kernel.py:run_decompress_zdft
// (backward) and run_zdft_compress (forward) for the z transforms the FFT
// form (fused_fft.cu) does not take: a length dim_z with a prime factor
// of 13 or more (the plan then hands these kernels the z matrices in the
// matrix form: ops/fused_kernel.py fused_z_form), or a plain matrix pair
// that does not carry its function (ops/fused_kernel.py: z_form). The
// z-DFT is a product against the plan's matrix pair.
//
// decompress_zdft: each block owns BM consecutive z-sticks (16 in float, 8
// in double: cdft_tile.cuh). It gathers their BM x dim_z slots from the
// sparse values through the plan-time inverse map slot_src (sentinel
// num_values = an empty slot, read as zero) straight into shared memory,
// transforms them there against the backward z matrix, and writes every
// slot of its output sticks, zeros included, so no stale data survives
// between two transforms. The raw sticks never
// reach device memory. For an R2C plan that owns the (x=0, y=0) stick
// (zero_stick >= 0) the gather also completes that stick before the
// z-DFT, as the TPU kernel's _complete_zero_stick does: a slot whose value
// is exactly 0 (or empty) takes the conjugate of its mirror slot
// (dim_z - z) % dim_z, read from the sparse values through slot_src, so
// the fill only ever sees values from before completion.
//
// zdft_compress: each block owns BM raw sticks (the output of the xy stage
// and the plane -> stick gather), transforms them in shared memory against
// the forward z matrix (any FULL scale already folded into it), and writes
// each sparse value of its sticks exactly once through a plan-time CSR by
// stick (stick_ptr, val_id, val_z): no atomics, and duplicate triplets
// each get their value. The transformed sticks never reach device memory.
//
// Values are read and written in the plan's public layout: interleaved
// (N, 2), or the planar pair (2, N) of large plans. Both kernels are
// templates on the real type (cdft_tile.cuh): float, and double for
// double-precision plans (entries with the suffix _f64).
//
// Batched grids (the TPU kernels' _kernel_dec_zdft_batched and
// _kernel_zdft_cmp_batched): both kernels take a leading batch of B
// independent transforms over one plan and run them in ONE launch, with
// blockIdx.y the batch element. The tables (slot_src, the CSR, the z
// matrices) are shared; per batch element the values advance by 2 N floats
// (both layouts) and the sticks by num_sticks x dim_z (for decompress that
// count includes the trailing sentinel stick), and the R2C (0,0)-stick
// completion reads the mirror values of its own batch element. Each row's
// arithmetic is that of the unbatched launch, so every band of a batched
// result equals the single launch bit for bit.
//
// What does not carry over from the TPU kernels: the 1024-slot tiles and
// selector words, the K-row DMA windows and super-tiles, the recompute
// model and the dim_z % 128 gate. These kernels take any dim_z up to
// MATMUL_DFT_MAX, so the plan never has to decline them.
//
// Bound on the H100: operations. At 256^3 (51,431 sticks, 8,782,782
// values) each kernel would do 51,431 x 256 x 256 complex multiply-adds,
// 2.7e10 FLOP in this 4-product form, against about 230 MB of traffic; at
// 67 TFLOP/s FP32 and 3.35 TB/s the FLOPs take about 6x longer than the
// bytes. So the main paths take the FFT form, whose arithmetic is about
// 50 times smaller and which is bound by bytes; this form stays for the
// lengths the FFT form does not cover. Fusing the gather takes the raw
// stick array's round trip off the memory side; the shared tile product
// keeps the FMA pipe fed. An R2C (0,0)-stick completion re-reads at most
// one mirror value for each slot of one stick.

#include "cdft_tile.cuh"
#include "values.cuh"

using namespace spfft;

// The value feeding slot z of stick s, zero for an empty slot.
template <class T>
__device__ inline typename Real<T>::Pair slot_value(
    const T* values, const int* __restrict__ slot_src, long long s, int z,
    int dim_z, long long num_values, int pair) {
  const long long src = slot_src[s * dim_z + z];
  if (src >= num_values) return make_pair(T(0), T(0));
  return read_value(values, pair, num_values, src);
}

template <class T>
__global__ void __launch_bounds__(THREADS)
    decompress_zdft_kernel(const T* __restrict__ values,
                           const int* __restrict__ slot_src,
                           const T* __restrict__ cr, const T* __restrict__ ci,
                           T* __restrict__ sr, T* __restrict__ si,
                           long long num_sticks, int dim_z,
                           long long num_values, int pair,
                           long long zero_stick) {
  constexpr int BM = Rows<T>::BM;
  extern __shared__ float4 smem[];
  const Tile<T> t =
      carve_tile<CC>(reinterpret_cast<T*>(smem), dim_z, dim_z);
  const long long s0 = (long long)blockIdx.x * BM;
  values += (long long)blockIdx.y * 2 * num_values;
  sr += (long long)blockIdx.y * num_sticks * dim_z;
  si += (long long)blockIdx.y * num_sticks * dim_z;
  stage_rows<CC>(t, dim_z, [&](int r, int z) {
    const long long s = s0 + r;
    if (s >= num_sticks) return make_pair(T(0), T(0));
    const auto v =
        slot_value(values, slot_src, s, z, dim_z, num_values, pair);
    if (s != zero_stick || v.x != T(0) || v.y != T(0)) return v;
    const auto m = slot_value(values, slot_src, s, z == 0 ? 0 : dim_z - z,
                              dim_z, num_values, pair);
    return make_pair(m.x, -m.y);
  });
  tile_product<CC>(t, dim_z, dim_z, cr, ci);
  for (int idx = threadIdx.x; idx < BM * dim_z; idx += THREADS) {
    const int r = idx / dim_z;
    const int z = idx - r * dim_z;
    const long long s = s0 + r;
    if (s < num_sticks) {
      sr[s * dim_z + z] = t.yr[r * t.ldy + z];
      si[s * dim_z + z] = t.yi[r * t.ldy + z];
    }
  }
}

template <class T>
__global__ void __launch_bounds__(THREADS)
    zdft_compress_kernel(const T* __restrict__ sr, const T* __restrict__ si,
                         const T* __restrict__ cr, const T* __restrict__ ci,
                         const int* __restrict__ stick_ptr,
                         const int* __restrict__ val_id,
                         const int* __restrict__ val_z,
                         T* __restrict__ values, long long num_sticks,
                         int dim_z, long long num_values, int pair) {
  constexpr int BM = Rows<T>::BM;
  extern __shared__ float4 smem[];
  const Tile<T> t =
      carve_tile<CC>(reinterpret_cast<T*>(smem), dim_z, dim_z);
  const long long s0 = (long long)blockIdx.x * BM;
  sr += (long long)blockIdx.y * num_sticks * dim_z;
  si += (long long)blockIdx.y * num_sticks * dim_z;
  values += (long long)blockIdx.y * 2 * num_values;
  stage_rows<CC>(t, dim_z, [&](int r, int z) {
    const long long s = s0 + r;
    if (s >= num_sticks) return make_pair(T(0), T(0));
    return make_pair(sr[s * dim_z + z], si[s * dim_z + z]);
  });
  tile_product<CC>(t, dim_z, dim_z, cr, ci);
  for (int r = 0; r < BM && s0 + r < num_sticks; ++r) {
    const int lo = stick_ptr[s0 + r];
    const int hi = stick_ptr[s0 + r + 1];
    for (int e = lo + threadIdx.x; e < hi; e += THREADS) {
      const int z = val_z[e];
      write_value(values, pair, num_values, val_id[e], t.yr[r * t.ldy + z],
                  t.yi[r * t.ldy + z]);
    }
  }
}

namespace {

template <class T>
int launch_decompress(const T* values, const int* slot_src, const T* cr,
                      const T* ci, T* sr, T* si, long long num_sticks,
                      int dim_z, long long num_values, int pair,
                      long long zero_stick, int batch, void* stream) {
  constexpr int BM = Rows<T>::BM;
  const size_t smem = tile_smem_bytes<T>(dim_z, dim_z);
  cudaError_t err = allow_smem(decompress_zdft_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 blocks((unsigned)((num_sticks + BM - 1) / BM), (unsigned)batch);
  decompress_zdft_kernel<T><<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      values, slot_src, cr, ci, sr, si, num_sticks, dim_z, num_values, pair,
      zero_stick);
  return (int)cudaGetLastError();
}

template <class T>
int launch_compress(const T* sr, const T* si, const T* cr, const T* ci,
                    const int* stick_ptr, const int* val_id,
                    const int* val_z, T* values, long long num_sticks,
                    int dim_z, long long num_values, int pair, int batch,
                    void* stream) {
  constexpr int BM = Rows<T>::BM;
  const size_t smem = tile_smem_bytes<T>(dim_z, dim_z);
  cudaError_t err = allow_smem(zdft_compress_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 blocks((unsigned)((num_sticks + BM - 1) / BM), (unsigned)batch);
  zdft_compress_kernel<T><<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      sr, si, cr, ci, stick_ptr, val_id, val_z, values, num_sticks, dim_z,
      num_values, pair);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch for `batch` transforms: values (batch, N, 2) or (batch, 2, N),
// sticks (batch, num_sticks, dim_z). _f64: the same on double operands.
extern "C" int spfft_decompress_zdft(const float* values, const int* slot_src,
                                     const float* cr, const float* ci,
                                     float* sr, float* si,
                                     long long num_sticks, int dim_z,
                                     long long num_values, int pair,
                                     long long zero_stick, int batch,
                                     void* stream) {
  return launch_decompress(values, slot_src, cr, ci, sr, si, num_sticks,
                           dim_z, num_values, pair, zero_stick, batch,
                           stream);
}

extern "C" int spfft_decompress_zdft_f64(
    const double* values, const int* slot_src, const double* cr,
    const double* ci, double* sr, double* si, long long num_sticks,
    int dim_z, long long num_values, int pair, long long zero_stick,
    int batch, void* stream) {
  return launch_decompress(values, slot_src, cr, ci, sr, si, num_sticks,
                           dim_z, num_values, pair, zero_stick, batch,
                           stream);
}

// One launch for `batch` transforms: sticks (batch, num_sticks, dim_z),
// values (batch, N, 2) or (batch, 2, N). _f64: the same on double
// operands.
extern "C" int spfft_zdft_compress(const float* sr, const float* si,
                                   const float* cr, const float* ci,
                                   const int* stick_ptr, const int* val_id,
                                   const int* val_z, float* values,
                                   long long num_sticks, int dim_z,
                                   long long num_values, int pair,
                                   int batch, void* stream) {
  return launch_compress(sr, si, cr, ci, stick_ptr, val_id, val_z, values,
                         num_sticks, dim_z, num_values, pair, batch, stream);
}

extern "C" int spfft_zdft_compress_f64(
    const double* sr, const double* si, const double* cr, const double* ci,
    const int* stick_ptr, const int* val_id, const int* val_z,
    double* values, long long num_sticks, int dim_z, long long num_values,
    int pair, int batch, void* stream) {
  return launch_compress(sr, si, cr, ci, stick_ptr, val_id, val_z, values,
                         num_sticks, dim_z, num_values, pair, batch, stream);
}
