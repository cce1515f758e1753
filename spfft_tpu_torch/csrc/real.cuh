// The real types every kernel of the package is instanced for, float and
// double, and what differs between them: the complex pair type, the
// 16-byte vector (4 floats or 2 doubles) and its loads and stores, and
// fused multiply-add. A kernel written on these compiles to the same
// instructions for float as it did before it was templated; its double
// instance moves 16-byte double2s where the float one moves float4s.
#pragma once

#include <cuda_runtime.h>

namespace spfft {

template <class T>
struct Real;

template <>
struct Real<float> {
  using Pair = float2;        // one complex value (re, im)
  static constexpr int W = 4;  // elements in 16 bytes
};

template <>
struct Real<double> {
  using Pair = double2;
  static constexpr int W = 2;
};

__host__ __device__ __forceinline__ float2 make_pair(float x, float y) {
  return make_float2(x, y);
}
__host__ __device__ __forceinline__ double2 make_pair(double x, double y) {
  return make_double2(x, y);
}

// v <- the 16 bytes at p (16-byte aligned)
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}
__device__ __forceinline__ void load16(const double* p, double (&v)[2]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  v[0] = a.x;
  v[1] = a.y;
}

// the 16 bytes at p (16-byte aligned) <- v
__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(double* p, const double (&v)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

}  // namespace spfft
