// The sparse values in the plans' public layouts, shared by the fused
// z kernels (fused_compress.cu, fused_fft.cu): interleaved (N, 2), or the
// planar pair (2, N) of large plans (pair != 0).
#pragma once

#include <cuda_runtime.h>

namespace spfft {

__device__ __forceinline__ float2 read_value(const float* values, int pair,
                                             long long num_values,
                                             long long v) {
  if (pair) return make_float2(values[v], values[num_values + v]);
  return reinterpret_cast<const float2*>(values)[v];
}

__device__ __forceinline__ void write_value(float* values, int pair,
                                            long long num_values,
                                            long long v, float re,
                                            float im) {
  if (pair) {
    values[v] = re;
    values[num_values + v] = im;
  } else {
    reinterpret_cast<float2*>(values)[v] = make_float2(re, im);
  }
}

}  // namespace spfft
