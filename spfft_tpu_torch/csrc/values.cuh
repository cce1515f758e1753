// The sparse values in the plans' public layouts, shared by the fused
// z kernels (fused_compress.cu, fused_fft.cu): interleaved (N, 2), or the
// planar pair (2, N) of large plans (pair != 0), in the real type T: an
// interleaved value is one 8-byte float2 or one 16-byte double2.
#pragma once

#include <cuda_runtime.h>

#include "real.cuh"

namespace spfft {

template <class T>
__device__ __forceinline__ typename Real<T>::Pair read_value(
    const T* values, int pair, long long num_values, long long v) {
  using Pair = typename Real<T>::Pair;
  if (pair) return make_pair(values[v], values[num_values + v]);
  return reinterpret_cast<const Pair*>(values)[v];
}

template <class T>
__device__ __forceinline__ void write_value(T* values, int pair,
                                            long long num_values,
                                            long long v, T re, T im) {
  using Pair = typename Real<T>::Pair;
  if (pair) {
    values[v] = re;
    values[num_values + v] = im;
  } else {
    reinterpret_cast<Pair*>(values)[v] = make_pair(re, im);
  }
}

}  // namespace spfft
