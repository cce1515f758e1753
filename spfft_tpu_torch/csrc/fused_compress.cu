// Sparse compression fused with the z-stick DFT: ports of the Pallas
// kernels spfft_tpu/ops/fused_kernel.py:run_decompress_zdft (backward) and
// run_zdft_compress (forward).
//
// decompress_zdft: each block owns BM = 16 consecutive z-sticks. It gathers
// their 16 x dim_z slots from the sparse values through the plan-time
// inverse map slot_src (sentinel num_values = an empty slot, read as zero)
// straight into shared memory, transforms them there against the backward
// z matrix, and writes every slot of its output sticks, zeros included, so
// no stale data survives between two transforms. The raw sticks never
// reach device memory. For an R2C plan that owns the (x=0, y=0) stick
// (zero_stick >= 0) the gather also completes that stick before the
// z-DFT, as the TPU kernel's _complete_zero_stick does: a slot whose value
// is exactly 0 (or empty) takes the conjugate of its mirror slot
// (dim_z - z) % dim_z, read from the sparse values through slot_src, so
// the fill only ever sees values from before completion.
//
// zdft_compress: each block owns 16 raw sticks (the output of the xy stage
// and the plane -> stick gather), transforms them in shared memory against
// the forward z matrix (any FULL scale already folded into it), and writes
// each sparse value of its sticks exactly once through a plan-time CSR by
// stick (stick_ptr, val_id, val_z): no atomics, and duplicate triplets
// each get their value. The transformed sticks never reach device memory.
//
// Values are read and written in the plan's public layout: interleaved
// (N, 2), or the planar pair (2, N) of large plans.
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
// values) each kernel does 51,431 x 256 x 256 complex multiply-adds, 2.7e10
// FLOP in this 4-product form, against about 230 MB of traffic; at 67
// TFLOP/s FP32 and 3.35 TB/s the FLOPs take about 6x longer than the bytes.
// Fusing the gather takes the raw stick array's round trip (105 MB each
// way) off the memory side; the shared tile product keeps the FMA pipe fed.
// The 256^3 R2C half sphere (25,717 sticks, 4,391,393 values) is half of
// that work; its (0,0)-stick completion re-reads at most one mirror value
// for each of the 256 slots of one stick, nothing beside the rest.

#include "cdft_tile.cuh"

using namespace spfft;

// One value in the public layout: pair (2, N) or interleaved (N, 2).
__device__ inline float2 read_value(const float* values, int pair,
                                    long long num_values, long long v) {
  if (pair) return make_float2(values[v], values[num_values + v]);
  return reinterpret_cast<const float2*>(values)[v];
}

__device__ inline void write_value(float* values, int pair,
                                   long long num_values, long long v,
                                   float re, float im) {
  if (pair) {
    values[v] = re;
    values[num_values + v] = im;
  } else {
    reinterpret_cast<float2*>(values)[v] = make_float2(re, im);
  }
}

// The value feeding slot z of stick s, zero for an empty slot.
__device__ inline float2 slot_value(const float* values,
                                    const int* __restrict__ slot_src,
                                    long long s, int z, int dim_z,
                                    long long num_values, int pair) {
  const long long src = slot_src[s * dim_z + z];
  if (src >= num_values) return make_float2(0.f, 0.f);
  return read_value(values, pair, num_values, src);
}

__global__ void __launch_bounds__(THREADS)
    decompress_zdft_kernel(const float* __restrict__ values,
                           const int* __restrict__ slot_src,
                           const float* __restrict__ cr,
                           const float* __restrict__ ci,
                           float* __restrict__ sr, float* __restrict__ si,
                           long long num_sticks, int dim_z,
                           long long num_values, int pair,
                           long long zero_stick) {
  extern __shared__ float4 smem[];
  const Tile t =
      carve_tile<CC>(reinterpret_cast<float*>(smem), dim_z, dim_z);
  const long long s0 = (long long)blockIdx.x * BM;
  values += (long long)blockIdx.y * 2 * num_values;
  sr += (long long)blockIdx.y * num_sticks * dim_z;
  si += (long long)blockIdx.y * num_sticks * dim_z;
  stage_rows<CC>(t, dim_z, [&](int r, int z) {
    const long long s = s0 + r;
    if (s >= num_sticks) return make_float2(0.f, 0.f);
    const float2 v = slot_value(values, slot_src, s, z, dim_z, num_values,
                                pair);
    if (s != zero_stick || v.x != 0.f || v.y != 0.f) return v;
    const float2 m = slot_value(values, slot_src, s, z == 0 ? 0 : dim_z - z,
                                dim_z, num_values, pair);
    return make_float2(m.x, -m.y);
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

__global__ void __launch_bounds__(THREADS)
    zdft_compress_kernel(const float* __restrict__ sr,
                         const float* __restrict__ si,
                         const float* __restrict__ cr,
                         const float* __restrict__ ci,
                         const int* __restrict__ stick_ptr,
                         const int* __restrict__ val_id,
                         const int* __restrict__ val_z,
                         float* __restrict__ values, long long num_sticks,
                         int dim_z, long long num_values, int pair) {
  extern __shared__ float4 smem[];
  const Tile t =
      carve_tile<CC>(reinterpret_cast<float*>(smem), dim_z, dim_z);
  const long long s0 = (long long)blockIdx.x * BM;
  sr += (long long)blockIdx.y * num_sticks * dim_z;
  si += (long long)blockIdx.y * num_sticks * dim_z;
  values += (long long)blockIdx.y * 2 * num_values;
  stage_rows<CC>(t, dim_z, [&](int r, int z) {
    const long long s = s0 + r;
    if (s >= num_sticks) return make_float2(0.f, 0.f);
    return make_float2(sr[s * dim_z + z], si[s * dim_z + z]);
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

// One launch for `batch` transforms: values (batch, N, 2) or (batch, 2, N),
// sticks (batch, num_sticks, dim_z).
extern "C" int spfft_decompress_zdft(const float* values, const int* slot_src,
                                     const float* cr, const float* ci,
                                     float* sr, float* si,
                                     long long num_sticks, int dim_z,
                                     long long num_values, int pair,
                                     long long zero_stick, int batch,
                                     void* stream) {
  const size_t smem = tile_smem_bytes(dim_z, dim_z);
  cudaError_t err = allow_smem(decompress_zdft_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 blocks((unsigned)((num_sticks + BM - 1) / BM), (unsigned)batch);
  decompress_zdft_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      values, slot_src, cr, ci, sr, si, num_sticks, dim_z, num_values, pair,
      zero_stick);
  return (int)cudaGetLastError();
}

// One launch for `batch` transforms: sticks (batch, num_sticks, dim_z),
// values (batch, N, 2) or (batch, 2, N).
extern "C" int spfft_zdft_compress(const float* sr, const float* si,
                                   const float* cr, const float* ci,
                                   const int* stick_ptr, const int* val_id,
                                   const int* val_z, float* values,
                                   long long num_sticks, int dim_z,
                                   long long num_values, int pair,
                                   int batch, void* stream) {
  const size_t smem = tile_smem_bytes(dim_z, dim_z);
  cudaError_t err = allow_smem(zdft_compress_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 blocks((unsigned)((num_sticks + BM - 1) / BM), (unsigned)batch);
  zdft_compress_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      sr, si, cr, ci, stick_ptr, val_id, val_z, values, num_sticks, dim_z,
      num_values, pair);
  return (int)cudaGetLastError();
}
