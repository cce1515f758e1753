// The sparse compression gather of the two-kernel route, redesigned for
// Hopper. It replaces the Pallas kernels that spfft_tpu/ops/gather_kernel.py
// reaches through run_gather (:1177): _monotone_gather_call (:751/:778)
// with its aliased-carry form _monotone_gather_call_aliased (:824/:848)
// and its batched body _kernel_batched (:627), and _wide_gather_call
// (:1119/:1145) with its batched body _kernel_wide_batched (:960). They
// compute one function,
//
//     out[s, b, j] = src[s, b, idx[s, j]]  if valid[s, j] and
//                                            0 <= idx[s, j] < num_src
//                    0                     otherwise,
//
// on planar reals (a real and an imaginary plane, each read and written
// through an element, a batch and a shard stride; float, or double for
// double-precision plans: the entry spfft_gather_f64), for every shard s and
// batch element b in one launch. A local plan is one shard. The
// distributed plan stacks its shards' tables, padded to the largest
// shard with indices past the source's extent (the kernel reads them as
// 0, so no per-shard extent is needed), as the JAX package stacks
// its per-shard tables (pad_tables_to, gather_kernel.py:528) to run all
// shards as one program. The plans run it in both directions: decompress
// (the sparse values -> every slot of the z-sticks, idx = the inverse
// slot map slot_src, whose sentinel marks an empty slot) and compress
// (the transformed sticks -> the sparse values, idx = value_indices).
// The value side is in the plan's public layout: interleaved (N, 2) is a
// pair of planes with element stride 2, the planar pair (2, N) one of
// stride 1; sticks are two separate planes of stride 1.
//
// Bound on the H100: bytes, with no arithmetic. At 256^3 C2C (8,782,782
// values, 51,432 x 256 stick slots with the sentinel stick) a decompress
// reads 70 MB of values and 53 MB of slot map and writes 105 MB of
// sticks: 228 MB, 0.068 ms at 3.35 TB/s. A compress reads 35 MB of
// value_indices and 70 MB of stick slots and writes 70 MB. In double the
// values and sticks take twice the bytes (decompress 403 MB, 0.120 ms).
//
// What holds such a gather back is latency: each output slot is a chain
// of two dependent loads (the index, then the value). The design keeps
// many chains in flight and moves each byte in as few accesses as the
// layout allows:
// * a thread owns V = 4 consecutive output slots; it loads their
//   indices (one 16-byte load where the table's rows are aligned) and
//   valid flags (one 4-byte word), then issues every value load of a
//   chunk of up to NB = 4 batch elements, V x NB independent loads
//   through the read-only path (__ldg), and only then stores, each an
//   explicit write-back store (__stwb: with plain stores ptxas spilled
//   the four-band instance, which then read slower);
// * an interleaved (re, im) value is one float2 (8 bytes) or double2
//   (16 bytes) load; a planar output takes 16-byte stores, one float4 or
//   two double2s per plane per 4 slots; an interleaved float output one
//   float4 per 2 slots, an interleaved double output one double2 per
//   slot. The gathered side (the values of a decompress, the stick slots
//   of a compress) is read through the index, one access per value;
// * the wrapper sets the layout word from the operands' addresses and
//   strides, reckoned in the element's size. A ragged last group (num_out
//   not a multiple of V) and views that are not aligned (a view into a
//   shard's rows, an offset of one element) take a scalar path inside the
//   same kernel;
// * grid (groups / THREADS, S): one block per 1,024 slots of a shard;
//   offsets are 64-bit (B x S x dim_z passes 2^31 at 512^3 with a few
//   bands) and the grid's x extent is capped at 2^20 blocks, beyond
//   which each thread strides.
// Tried on the H100 (PERF.md): V = 8, loads through the coherent path,
// streaming stores and a grid of the blocks the card holds at once; none
// read faster than this form, which is the simplest of them.
// What does not carry over from the TPU kernels: the K-row source windows
// and their DMAs, the lane selector words, the 1024-slot output tiles, the
// chunk segments and the aliased carry between segment launches. Those
// decompose an arbitrary gather into the contiguous copies and in-register
// lane gathers a TPU can do; a GPU thread reads any address.

#include <cuda_runtime.h>
#include <stdint.h>

#include "real.cuh"

using namespace spfft;

namespace {

constexpr int THREADS = 256;
constexpr int V = 4;  // output slots a thread
constexpr long long MAX_BLOCKS = 1LL << 20;

// The layout word: which accesses may be wide for every group of slots.
// The wrapper reckons each condition in the element's size (E bytes).
enum : int {
  IDX_VEC = 1,      // idx rows 16-byte aligned: one int4 per 4 slots
  VALID_VEC = 2,    // valid rows 4-byte aligned: one 32-bit word per 4
  SRC_PAIR = 4,     // interleaved source, 2E-byte aligned: one pair load
  OUT_PLANAR = 8,   // planar output, 16-byte aligned: 16-byte stores
  OUT_PAIR = 16,    // interleaved output, 2E-byte aligned. float: one
                    // float4 per 2 slots (float2, float4s, float2 on a row
                    // that starts 8 bytes off 16); double: one double2
                    // per slot
};

template <class T>
struct Args {
  const T* src_re;
  const T* src_im;
  long long src_stride, src_bstride, src_sstride, num_src;
  const int* idx;
  long long idx_sstride;
  const unsigned char* valid;  // or null: every slot valid
  long long valid_sstride;
  T* out_re;
  T* out_im;
  long long out_stride, out_bstride, out_sstride, num_out;
  int batch, layout;
};

// The stores of one whole group of V slots of one batch element in a
// wide layout: OUT_PLANAR at (re, im) + j0, OUT_PAIR at re + 2 j0.
__device__ __forceinline__ void store_planar(float* re, float* im,
                                             const float2 (&w)[V]) {
#pragma unroll
  for (int q = 0; q < V / 4; ++q) {
    const float2* x = w + 4 * q;
    __stwb(reinterpret_cast<float4*>(re) + q,
           make_float4(x[0].x, x[1].x, x[2].x, x[3].x));
    __stwb(reinterpret_cast<float4*>(im) + q,
           make_float4(x[0].y, x[1].y, x[2].y, x[3].y));
  }
}

__device__ __forceinline__ void store_planar(double* re, double* im,
                                             const double2 (&w)[V]) {
#pragma unroll
  for (int q = 0; q < V / 2; ++q) {
    __stwb(reinterpret_cast<double2*>(re) + q,
           make_double2(w[2 * q].x, w[2 * q + 1].x));
    __stwb(reinterpret_cast<double2*>(im) + q,
           make_double2(w[2 * q].y, w[2 * q + 1].y));
  }
}

__device__ __forceinline__ void store_pairs(float* o, const float2 (&w)[V]) {
  if ((reinterpret_cast<uintptr_t>(o) & 15) == 0) {
#pragma unroll
    for (int q = 0; q < V / 2; ++q)
      __stwb(reinterpret_cast<float4*>(o) + q,
             make_float4(w[2 * q].x, w[2 * q].y, w[2 * q + 1].x,
                         w[2 * q + 1].y));
  } else {  // the row's groups start 8 bytes off 16
    __stwb(reinterpret_cast<float2*>(o), w[0]);
#pragma unroll
    for (int q = 0; q < V / 2 - 1; ++q)
      __stwb(reinterpret_cast<float4*>(o + 2) + q,
             make_float4(w[2 * q + 1].x, w[2 * q + 1].y, w[2 * q + 2].x,
                         w[2 * q + 2].y));
    __stwb(reinterpret_cast<float2*>(o) + V - 1, w[V - 1]);
  }
}

__device__ __forceinline__ void store_pairs(double* o,
                                            const double2 (&w)[V]) {
#pragma unroll
  for (int k = 0; k < V; ++k) __stwb(reinterpret_cast<double2*>(o) + k, w[k]);
}

// One shard (blockIdx.y) of the gather, NB batch elements a chunk, with
// the source and output layouts fixed: PAIR_SRC reads a value as one
// pair, OUT is 0 (scalar stores), OUT_PLANAR or OUT_PAIR.
template <class T, int NB, bool PAIR_SRC, int OUT>
__device__ __forceinline__ void gather_shard(const Args<T>& a) {
  using Pair = typename Real<T>::Pair;
  const long long s = blockIdx.y;
  const int* idx = a.idx + s * a.idx_sstride;
  const unsigned char* valid =
      a.valid == nullptr ? nullptr : a.valid + s * a.valid_sstride;
  const T* src_re = a.src_re + s * a.src_sstride;
  const T* src_im = a.src_im + s * a.src_sstride;
  T* out_re = a.out_re + s * a.out_sstride;
  T* out_im = a.out_im + s * a.out_sstride;
  const long long num_out = a.num_out;
  const long long groups = (num_out + V - 1) / V;
  const long long step = (long long)gridDim.x * THREADS;
  for (long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
       g < groups; g += step) {
    const long long j0 = g * V;
    const bool whole = j0 + V <= num_out;
    int i[V];
    if (whole && (a.layout & IDX_VEC)) {
#pragma unroll
      for (int q = 0; q < V / 4; ++q) {
        const int4 w = __ldg(reinterpret_cast<const int4*>(idx + j0) + q);
        i[4 * q] = w.x;
        i[4 * q + 1] = w.y;
        i[4 * q + 2] = w.z;
        i[4 * q + 3] = w.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k)
        i[k] = j0 + k < num_out ? __ldg(idx + j0 + k) : -1;
    }
    bool ok[V];
#pragma unroll
    for (int k = 0; k < V; ++k) ok[k] = i[k] >= 0 && i[k] < a.num_src;
    if (valid != nullptr) {
      if (whole && (a.layout & VALID_VEC)) {
#pragma unroll
        for (int q = 0; q < V / 4; ++q) {
          const unsigned w =
              __ldg(reinterpret_cast<const unsigned*>(valid + j0) + q);
#pragma unroll
          for (int k = 0; k < 4; ++k)
            ok[4 * q + k] = ok[4 * q + k] && ((w >> (8 * k)) & 0xffu) != 0;
        }
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k)
          if (j0 + k < num_out) ok[k] = ok[k] && __ldg(valid + j0 + k);
      }
    }
    for (int b0 = 0; b0 < a.batch; b0 += NB) {
      // every load of the chunk first ...
      Pair v[NB][V];
#pragma unroll
      for (int bb = 0; bb < NB; ++bb) {
        const bool live = NB == 1 || b0 + bb < a.batch;
        const long long sb = (long long)(b0 + bb) * a.src_bstride;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          v[bb][k] = make_pair(T(0), T(0));
          if (live && ok[k]) {
            const long long e = sb + (long long)i[k] * a.src_stride;
            if constexpr (PAIR_SRC) {
              v[bb][k] = __ldg(reinterpret_cast<const Pair*>(src_re + e));
            } else {
              v[bb][k] = make_pair(__ldg(src_re + e), __ldg(src_im + e));
            }
          }
        }
      }
      // ... then every store
#pragma unroll
      for (int bb = 0; bb < NB; ++bb) {
        if (NB > 1 && b0 + bb >= a.batch) break;
        const long long ob = (long long)(b0 + bb) * a.out_bstride;
        if (OUT == OUT_PLANAR && whole) {
          store_planar(out_re + ob + j0, out_im + ob + j0, v[bb]);
        } else if (OUT == OUT_PAIR && whole) {
          store_pairs(out_re + ob + 2 * j0, v[bb]);
        } else {
#pragma unroll
          for (int k = 0; k < V; ++k) {
            if (j0 + k < num_out) {
              const long long o = ob + (j0 + k) * a.out_stride;
              __stwb(out_re + o, v[bb][k].x);
              __stwb(out_im + o, v[bb][k].y);
            }
          }
        }
      }
    }
  }
}

template <class T, int NB, bool PAIR_SRC>
__device__ __forceinline__ void by_output(const Args<T>& a) {
  if (a.layout & OUT_PLANAR) {
    gather_shard<T, NB, PAIR_SRC, OUT_PLANAR>(a);
  } else if (a.layout & OUT_PAIR) {
    gather_shard<T, NB, PAIR_SRC, OUT_PAIR>(a);
  } else {
    gather_shard<T, NB, PAIR_SRC, 0>(a);
  }
}

template <class T, int NB>
__global__ void __launch_bounds__(THREADS) gather_kernel(const Args<T> a) {
  if (a.layout & SRC_PAIR) {
    by_output<T, NB, true>(a);
  } else {
    by_output<T, NB, false>(a);
  }
}

template <class T>
int launch_gather(const T* src_re, const T* src_im, long long src_stride,
                  long long src_bstride, long long src_sstride,
                  long long num_src, const int* idx, long long idx_sstride,
                  const unsigned char* valid, long long valid_sstride,
                  T* out_re, T* out_im, long long out_stride,
                  long long out_bstride, long long out_sstride,
                  long long num_out, int batch, int shards, int layout,
                  void* stream) {
  if (shards < 1 || shards > 65535 || batch < 1) return cudaErrorInvalidValue;
  const Args<T> a{src_re, src_im, src_stride, src_bstride, src_sstride,
                  num_src, idx, idx_sstride, valid, valid_sstride,
                  out_re, out_im, out_stride, out_bstride, out_sstride,
                  num_out, batch, layout};
  long long blocks = ((num_out + V - 1) / V + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;  // grid-stride beyond this
  const dim3 grid((unsigned)blocks, (unsigned)shards);
  const cudaStream_t st = (cudaStream_t)stream;
  if (batch == 1) {
    gather_kernel<T, 1><<<grid, THREADS, 0, st>>>(a);
  } else {
    gather_kernel<T, 4><<<grid, THREADS, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// One launch: out[s, b, j] of (out_re, out_im) for s < shards, b < batch,
// j < num_out, one block per THREADS x V slots of a shard. valid may be
// null (every slot valid; idx out of [0, num_src) still gives 0). layout
// is the word above. A batch of one runs chunks of one batch element, any
// other batch chunks of four. _f64: the same on double planes.
extern "C" int spfft_gather(
    const float* src_re, const float* src_im, long long src_stride,
    long long src_bstride, long long src_sstride, long long num_src,
    const int* idx, long long idx_sstride, const unsigned char* valid,
    long long valid_sstride, float* out_re, float* out_im,
    long long out_stride, long long out_bstride, long long out_sstride,
    long long num_out, int batch, int shards, int layout, void* stream) {
  return launch_gather(src_re, src_im, src_stride, src_bstride, src_sstride,
                       num_src, idx, idx_sstride, valid, valid_sstride,
                       out_re, out_im, out_stride, out_bstride, out_sstride,
                       num_out, batch, shards, layout, stream);
}

extern "C" int spfft_gather_f64(
    const double* src_re, const double* src_im, long long src_stride,
    long long src_bstride, long long src_sstride, long long num_src,
    const int* idx, long long idx_sstride, const unsigned char* valid,
    long long valid_sstride, double* out_re, double* out_im,
    long long out_stride, long long out_bstride, long long out_sstride,
    long long num_out, int batch, int shards, int layout, void* stream) {
  return launch_gather(src_re, src_im, src_stride, src_bstride, src_sstride,
                       num_src, idx, idx_sstride, valid, valid_sstride,
                       out_re, out_im, out_stride, out_bstride, out_sstride,
                       num_out, batch, shards, layout, stream);
}
