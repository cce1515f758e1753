// The int8 rung of the distributed exchange's wire ladder. The JAX package
// computes it with XLA elementwise ops, not Pallas
// (spfft_tpu/parallel/exchange.py: quantize_blocks_int8 :124,
// dequantize_blocks_int8 :156); here it is two kernels of one template,
// float and double (the entries spfft_wire_quantize / _f64 and
// spfft_wire_dequantize / _f64).
//
// A padded exchange block (G, S, max_sticks, max_planes) — G the batch
// and source shards, S the destination slots — is quantized per quant
// row: the rows are the sticks (quant axis 1, the backward exchange) or
// the planes (quant axis 2, the forward one), each row's elements the
// other axis. For each (g, slot, row), on the planar pair (re, im)
// converted to float (the JAX package casts the interleaved block to
// float32, even in a double plan):
//
//     absmax = max |x| over the row's re and im
//     scale  = absmax / 127        (1 where absmax is 0)
//     q      = clip(rint(x / scale), -127, 127)        as int8
//
// and dequantize is (float)q * scale, cast to the plan's real type. The
// division is IEEE (__fdiv_rn), rintf rounds half to even as jnp.round
// and torch.round do, and the product is one rounded multiply, so the
// payload, the scales and the dequantized values equal the plain
// versions' bit for bit. The library builds without fast math.
//
// Layouts. quantize reads the block through element strides (g, slot,
// row, element), so the exchange's packed views need no copy; it writes
// the payload row-major by quant row, (G, S, rows, elements) int8 for
// each of re and im, and the scales (G, S, rows) float: what the exchange
// moves. dequantize reads that layout and writes the block (G, S,
// max_sticks, max_planes) contiguous, each thread one output element (the
// stores coalesce; quant axis 2 reads its int8 payload across rows).
//
// Design: a warp per row when a row holds at most LONG_ROW elements
// (the backward's rows, max_planes long), a block of 256 threads per row
// otherwise (the forward's rows, max_sticks long); each reads its row
// twice, once for absmax and once to quantize (the second read hits L2:
// a row is at most a few hundred kB).

#include <cuda_runtime.h>
#include <stdint.h>

#include "real.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr long long LONG_ROW = 1024;

template <class T>
struct QuantArgs {
  const T* re;
  const T* im;
  long long g_st, s_st, r_st, e_st;  // element strides of the input
  long long groups, slots, rows, len;
  int8_t* q_re;
  int8_t* q_im;
  float* scales;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int8_t quant(float x, float scale) {
  const float r = rintf(__fdiv_rn(x, scale));
  return (int8_t)fminf(fmaxf(r, -127.0f), 127.0f);
}

// One row: base points at its first element in (re, im); the threads
// [t0, t0 + nt) of the caller share it. Returns the row's scale in every
// thread of the group (reduce() combines the group's partial maxima).
template <class T, class Reduce>
__device__ __forceinline__ void quantize_row(const QuantArgs<T>& a,
                                             long long row, int t, int nt,
                                             Reduce reduce) {
  const long long rows = a.rows;
  const long long gs = row / rows, r = row - gs * rows;
  const long long g = gs / a.slots, s = gs - g * a.slots;
  const long long base = g * a.g_st + s * a.s_st + r * a.r_st;
  float m = 0.0f;
  for (long long e = t; e < a.len; e += nt) {
    const long long i = base + e * a.e_st;
    m = fmaxf(m, fmaxf(fabsf((float)a.re[i]), fabsf((float)a.im[i])));
  }
  const float absmax = reduce(m);
  const float scale = absmax > 0.0f ? __fdiv_rn(absmax, 127.0f) : 1.0f;
  if (t == 0) a.scales[row] = scale;
  int8_t* qr = a.q_re + row * a.len;
  int8_t* qi = a.q_im + row * a.len;
  for (long long e = t; e < a.len; e += nt) {
    const long long i = base + e * a.e_st;
    qr[e] = quant((float)a.re[i], scale);
    qi[e] = quant((float)a.im[i], scale);
  }
}

template <class T>
__global__ void __launch_bounds__(THREADS)
    quantize_warp_rows(const QuantArgs<T> a, long long total_rows) {
  const int lane = threadIdx.x & 31;
  const long long step = (long long)gridDim.x * WARPS;
  for (long long row = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
       row < total_rows; row += step)
    quantize_row(a, row, lane, 32, [](float m) { return warp_max(m); });
}

template <class T>
__global__ void __launch_bounds__(THREADS)
    quantize_block_rows(const QuantArgs<T> a, long long total_rows) {
  __shared__ float part[WARPS];
  for (long long row = blockIdx.x; row < total_rows; row += gridDim.x) {
    quantize_row(a, row, threadIdx.x, THREADS, [&](float m) {
      m = warp_max(m);
      __syncthreads();  // part[] of the previous row is read
      if ((threadIdx.x & 31) == 0) part[threadIdx.x / 32] = m;
      __syncthreads();
      float v = part[0];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) v = fmaxf(v, part[w]);
      return v;
    });
  }
}

template <class T>
__global__ void __launch_bounds__(THREADS)
    dequantize_kernel(const int8_t* q_re, const int8_t* q_im,
                      const float* scales, long long slots_groups,
                      long long ms, long long mp, int axis, T* out_re,
                      T* out_im) {
  const long long total = slots_groups * ms * mp;
  const long long step = (long long)gridDim.x * THREADS;
  for (long long o = (long long)blockIdx.x * THREADS + threadIdx.x;
       o < total; o += step) {
    const long long gs = o / (ms * mp);
    const long long ip = o - gs * ms * mp;
    const long long i = ip / mp, p = ip - i * mp;
    long long q, row;
    if (axis == 1) {  // rows are sticks: the payload is in block order
      q = o;
      row = gs * ms + i;
    } else {  // rows are planes: (gs, p, i)
      q = (gs * mp + p) * ms + i;
      row = gs * mp + p;
    }
    const float sc = scales[row];
    out_re[o] = (T)__fmul_rn((float)q_re[q], sc);
    out_im[o] = (T)__fmul_rn((float)q_im[q], sc);
  }
}

long long grid_of(long long work, long long per_block) {
  long long b = (work + per_block - 1) / per_block;
  if (b > (1LL << 20)) b = 1LL << 20;
  return b < 1 ? 1 : b;
}

template <class T>
int launch_quantize(const T* re, const T* im, long long g_st, long long s_st,
                    long long r_st, long long e_st, long long groups,
                    long long slots, long long rows, long long len,
                    int8_t* q_re, int8_t* q_im, float* scales, void* stream) {
  const QuantArgs<T> a{re, im, g_st, s_st, r_st, e_st, groups, slots,
                       rows, len, q_re, q_im, scales};
  const long long total_rows = groups * slots * rows;
  if (total_rows == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (len <= LONG_ROW) {
    quantize_warp_rows<T><<<(unsigned)grid_of(total_rows, WARPS), THREADS,
                            0, st>>>(a, total_rows);
  } else {
    quantize_block_rows<T><<<(unsigned)grid_of(total_rows, 1), THREADS, 0,
                             st>>>(a, total_rows);
  }
  return (int)cudaGetLastError();
}

template <class T>
int launch_dequantize(const int8_t* q_re, const int8_t* q_im,
                      const float* scales, long long slots_groups,
                      long long ms, long long mp, int axis, T* out_re,
                      T* out_im, void* stream) {
  if (axis != 1 && axis != 2) return cudaErrorInvalidValue;
  const long long total = slots_groups * ms * mp;
  if (total == 0) return 0;
  dequantize_kernel<T><<<(unsigned)grid_of(total, THREADS), THREADS, 0,
                         (cudaStream_t)stream>>>(
      q_re, q_im, scales, slots_groups, ms, mp, axis, out_re, out_im);
  return (int)cudaGetLastError();
}

}  // namespace

// quantize: the block (re, im) read at g * g_st + s * s_st + r * r_st +
// e * e_st for g < groups, s < slots, quant row r < rows, element e < len;
// writes q_re, q_im (groups, slots, rows, len) int8 and scales (groups,
// slots, rows) float. _f64: a double block.
extern "C" int spfft_wire_quantize(const float* re, const float* im,
                                   long long g_st, long long s_st,
                                   long long r_st, long long e_st,
                                   long long groups, long long slots,
                                   long long rows, long long len,
                                   int8_t* q_re, int8_t* q_im, float* scales,
                                   void* stream) {
  return launch_quantize(re, im, g_st, s_st, r_st, e_st, groups, slots,
                         rows, len, q_re, q_im, scales, stream);
}

extern "C" int spfft_wire_quantize_f64(const double* re, const double* im,
                                       long long g_st, long long s_st,
                                       long long r_st, long long e_st,
                                       long long groups, long long slots,
                                       long long rows, long long len,
                                       int8_t* q_re, int8_t* q_im,
                                       float* scales, void* stream) {
  return launch_quantize(re, im, g_st, s_st, r_st, e_st, groups, slots,
                         rows, len, q_re, q_im, scales, stream);
}

// dequantize: the payload of quantize (rows sticks where axis is 1,
// planes where it is 2) and its scales -> the block (slots_groups, ms,
// mp) contiguous, (re, im). _f64: a double block.
extern "C" int spfft_wire_dequantize(const int8_t* q_re, const int8_t* q_im,
                                     const float* scales,
                                     long long slots_groups, long long ms,
                                     long long mp, int axis, float* out_re,
                                     float* out_im, void* stream) {
  return launch_dequantize(q_re, q_im, scales, slots_groups, ms, mp, axis,
                           out_re, out_im, stream);
}

extern "C" int spfft_wire_dequantize_f64(const int8_t* q_re,
                                         const int8_t* q_im,
                                         const float* scales,
                                         long long slots_groups,
                                         long long ms, long long mp,
                                         int axis, double* out_re,
                                         double* out_im, void* stream) {
  return launch_dequantize(q_re, q_im, scales, slots_groups, ms, mp, axis,
                           out_re, out_im, stream);
}
