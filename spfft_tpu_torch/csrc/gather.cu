// The sparse compression gather of the two-kernel route: port of the
// Pallas kernels spfft_tpu/ops/gather_kernel.py:_monotone_gather_call
// (with its aliased-carry form) and _wide_gather_call, both reached through
// run_gather. They compute one function,
//
//     out[b, j] = src[b, idx[j]]  if valid[j] and 0 <= idx[j] < num_src
//                 0               otherwise,
//
// on planar f32 (a real and an imaginary plane, each read and written
// through a batch stride and an element stride), for every batch element
// b in one launch. The plan runs it in both directions: decompress (the
// sparse values -> every slot of the z-sticks, idx = the inverse slot map
// slot_src, whose sentinel num_values is an empty slot) and compress (the
// transformed sticks -> the sparse values, idx = value_indices). The value
// side is in the plan's public layout: interleaved (N, 2) is a pair of
// planes with element stride 2, the planar pair (2, N) one of stride 1;
// sticks are two separate planes of stride 1.
//
// What does not carry over from the TPU kernels: the K-row source windows
// and their DMAs, the lane selector words, the 1024-slot output tiles, the
// chunk segments under SEG_CHUNK_LIMIT and the aliased carry between
// segment launches. Those decompose an arbitrary gather into the
// contiguous copies and in-register lane gathers a TPU can do. A GPU reads
// any address from any thread, so here each thread owns one output slot j:
// neighbouring threads write neighbouring slots (coalesced stores), and for
// the stick-major, z-ascending value order the plans use, idx is nearly
// monotone, so their reads are nearly contiguous too. The TPU kernel's
// batch grid axis becomes a loop inside the thread: each index (and valid
// flag) is read once and serves every batch element. Offsets are 64-bit
// (B x S x dim_z passes 2^31 at 512^3 with a few bands).
//
// Bound on the H100: bytes. At 256^3 (8,782,782 values, 51,432 x 256 stick
// slots with the sentinel stick) decompress reads about 70 MB of values
// and 53 MB of index and writes 105 MB of sticks; compress reads 35 MB of
// index and 70 MB of values' worth of stick slots and writes 70 MB. There
// is no arithmetic. A simple grid-stride kernel is the first form;
// cp.async or TMA staging of the index comes later.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    gather_kernel(const float* __restrict__ src_re,
                  const float* __restrict__ src_im, long long src_stride,
                  long long src_bstride, long long num_src,
                  const int* __restrict__ idx,
                  const unsigned char* __restrict__ valid,
                  float* __restrict__ out_re, float* __restrict__ out_im,
                  long long out_stride, long long out_bstride,
                  long long num_out, int batch) {
  const long long step = (long long)gridDim.x * THREADS;
  for (long long j = (long long)blockIdx.x * THREADS + threadIdx.x;
       j < num_out; j += step) {
    const long long i = idx[j];
    const bool ok =
        i >= 0 && i < num_src && (valid == nullptr || valid[j] != 0);
    const long long s = i * src_stride;
    const long long o = j * out_stride;
    for (int b = 0; b < batch; ++b) {
      float re = 0.f, im = 0.f;
      if (ok) {
        re = src_re[b * src_bstride + s];
        im = src_im[b * src_bstride + s];
      }
      out_re[b * out_bstride + o] = re;
      out_im[b * out_bstride + o] = im;
    }
  }
}

}  // namespace

// One launch: out[b, j] of (out_re, out_im) for b < batch, j < num_out.
// valid may be null (every slot valid; idx out of [0, num_src) still
// gives 0).
extern "C" int spfft_gather(const float* src_re, const float* src_im,
                            long long src_stride, long long src_bstride,
                            long long num_src, const int* idx,
                            const unsigned char* valid, float* out_re,
                            float* out_im, long long out_stride,
                            long long out_bstride, long long num_out,
                            int batch, void* stream) {
  long long blocks = (num_out + THREADS - 1) / THREADS;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // grid-stride beyond this
  gather_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      src_re, src_im, src_stride, src_bstride, num_src, idx, valid, out_re,
      out_im, out_stride, out_bstride, num_out, batch);
  return (int)cudaGetLastError();
}
