// The complex DFT stage in FFT form: the port's counterpart of the Pallas
// kernels spfft_tpu/ops/dft_kernel.py:pdft_last (_stage_kernel, launched at
// :165) and _run2 in mode "cc" (launched at :277; pdft2 and pdft2_swapped),
// for transforms the plan describes (ops/dft.py: DftMats) with a length
// n <= 512 of the form 2^a 3^b 5^c 7^d 11^e. Two kernels, both on
// fft_tile.cuh:
//
//   fft_stage_kernel (spfft_fft_stage): rows (M, K) -> (M, N), one FFT per
//     row in shared memory: the K inputs scattered into a zeroed length-n
//     row at their positions, the FFT, the N selected outputs times the
//     scale, stored straight or transposed within each plane of
//     plane_rows rows (a block holds at least 32 rows for n <= 512, so a
//     transposed store writes 128-byte runs along the plane's rows).
//     pdft_last is one launch; a plane transform that does not fit one
//     cluster is two (the first stored transposed).
//
//   fft_plane_kernel (spfft_fft_plane): planar (P, A, B) -> (P, B', A')
//     (pdft2) or (P, A', B') (pdft2_swapped) in ONE launch, one cluster of
//     8 blocks per plane. Block c transforms rows [c RA, (c + 1) RA) of the
//     plane over B (RA = ceil(A / 8)); after cluster.sync() it gathers
//     columns [c RB, (c + 1) RB) of the B' outputs (RB = ceil(B' / 8)) for
//     all A rows from the eight blocks' shared memory (distributed shared
//     memory, through registers), meets the cluster again before it
//     overwrites its own buffer, transforms them over A and stores. That is
//     what the TPU kernel did in VMEM: both DFTs and the swap between them
//     with the intermediate never in device memory. No block reads another
//     block's shared memory after the second cluster.sync(), so a block may
//     exit once it has stored.
//
// Bound on the H100: bytes. An FFT needs 5 n log2 n FLOP per complex line:
// a 256^3 pdft2 call is 1.3e9 FLOP (0.02 ms at 67 TFLOP/s FP32) against
// 268 MB of operands read and written once (0.08 ms at 3.35 TB/s);
// pdft_last over 51,432 sticks of 256 0.008 ms of FLOP against 0.063 ms of
// bytes. The matrix form (dft2.cu) needed 6.9e10 FLOP for the same pdft2
// call and was bound by operations. So the design moves each byte once:
// rows are staged with 16-byte loads where the whole row is given, the
// intermediate of a plane transform stays on chip, stores are coalesced
// (128-byte runs in every transposed store), and the twiddles come from
// the plan's table in shared memory.
//
// Both kernels are templates on the real type T (real.cuh): float, and
// double for double-precision plans, whose entries carry the suffix _f64.
// A double instance moves twice the bytes (a 256^3 pdft2 call 537 MB,
// 0.16 ms at 3.35 TB/s) with 16-byte double2 accesses where the float one
// moves float4s; its FLOPs (FP64 CUDA cores, 34 TFLOP/s) stay under its
// bytes' time. Its stage blocks have at most 512 threads and its cluster
// blocks run one an SM (fft_tile.cuh: Bounds), so that a thread may hold
// 128 registers; a 256^2 plane's cluster block then takes 143,872 bytes
// of shared memory.

#include <cooperative_groups.h>

#include "fft_tile.cuh"

namespace cg = cooperative_groups;
using namespace spfft;
using namespace spfft::fft;

namespace {

constexpr int CLUSTER = 8;  // blocks per plane: the portable size
// threads of a cluster block: EPT elements each hold a 256 x 256 plane's
// share (32 rows of 256); Bounds<T>::PLANE_BLOCKS blocks an SM (float:
// two, at 64 registers a thread; double: one, at 128)
constexpr int PLANE_THREADS = 512;

// Shared memory of one cluster block: its buffer (the larger of RA rows of
// n1 and RB rows of n2, real and imaginary) and both twiddle tables.
template <class T>
size_t plane_smem(int A, int Bo, int n1, int n2) {
  const int RA = (A + CLUSTER - 1) / CLUSTER;
  const int RB = (Bo + CLUSTER - 1) / CLUSTER;
  const size_t words = (size_t)max(RA * row_stride(n1), RB * row_stride(n2));
  return sizeof(T) * (2 * words + 2 * (size_t)(n1 + n2));
}

}  // namespace

// plane_rows == 0: Y[m][j] stored at y[m * N + j].
// plane_rows == A > 0: row m = p * A + a, Y[m][j] stored at
//                      y[(p * N + j) * A + a] (transposed within a plane).
template <bool POW2, bool ODD, class T>
__global__ void __launch_bounds__(Bounds<T>::stage_threads(ODD))
    fft_stage_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                     T* __restrict__ yr, T* __restrict__ yi,
                     const T* __restrict__ tw, long long M, int K, int N,
                     int plane_rows, int rows, FftSpec<T> sp) {
  constexpr int W = Real<T>::W;
  extern __shared__ float4 smem4[];
  T* smem = reinterpret_cast<T*>(smem4);
  const int n = sp.n;
  const int stride = row_stride(n);
  T* re = smem;
  T* im = re + rows * stride;
  T* twr = im + rows * stride;
  T* twi = twr + n;
  const long long m0 = (long long)blockIdx.x * rows;
  const int valid = (int)min((long long)rows, M - m0);
  load_twiddles(twr, twi, tw, n);
  load_rows(re, im, rows, valid, stride, n, K, sp.in0, xr, xi, m0);
  __syncthreads();
  fft_rows<POW2, ODD>(re, im, valid, stride, sp, twr, twi);
  const T sc = sp.scale;
  if (plane_rows == 0) {
    store_rows(re, im, valid, stride, n, N, sp.out0, sc, yr, yi, m0);
    return;
  }
  const bool vec = aligned16(yr, yi);
  // transposed: element (j, r), r fastest, so neighbouring threads write
  // neighbouring a of one plane; the block's first row is (p0, a0)
  const long long p0 = m0 / plane_rows;
  const int a0 = (int)(m0 - p0 * plane_rows);
  const int u = vec && (plane_rows | valid | a0) % W == 0 ? W : 1;
  Walk w(valid / u);
  for (int id = threadIdx.x; id < valid * N / u; id += blockDim.x) {
    const int j = w.row;
    const int r = u * w.col;
    const int q = pad(wrap(sp.out0 + j, n));
    int a = a0 + r;
    long long pp = p0;
    if (a >= plane_rows) {
      const int d = a / plane_rows;
      a -= d * plane_rows;
      pp += d;
    }
    const long long g = (pp * N + j) * plane_rows + a;
    if (u == W) {  // rows r .. r + W - 1: one plane, 16 bytes
      const int o = r * stride + q;
      T vr[W], vi[W];
#pragma unroll
      for (int t = 0; t < W; ++t) {
        vr[t] = re[o + t * stride] * sc;
        vi[t] = im[o + t * stride] * sc;
      }
      store16(yr + g, vr);
      store16(yi + g, vi);
    } else {
      yr[g] = re[r * stride + q] * sc;
      yi[g] = im[r * stride + q] * sc;
    }
    w.next();
  }
}

// One plane per cluster of CLUSTER blocks; grid = P * CLUSTER blocks.
// s1 transforms B (the minor axis, B inputs, Bo outputs), s2 transforms A
// (A inputs, Ao outputs); s2's scale (the product of both transforms'
// scales) is applied at the store. The caller guarantees RA * n1 and
// RB * n2 <= PLANE_THREADS * EPT.
template <bool POW2, class T>
__global__ void __cluster_dims__(CLUSTER, 1, 1)
    __launch_bounds__(PLANE_THREADS, Bounds<T>::PLANE_BLOCKS)
        fft_plane_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                         T* __restrict__ yr, T* __restrict__ yi,
                         const T* __restrict__ tw1,
                         const T* __restrict__ tw2, int A, int B, int Bo,
                         int Ao, FftSpec<T> s1, FftSpec<T> s2,
                         int swap_out) {
  constexpr int W = Real<T>::W;
  extern __shared__ float4 smem4[];
  T* smem = reinterpret_cast<T*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank();
  const long long p = blockIdx.x / CLUSTER;
  const int n1 = s1.n, n2 = s2.n;
  const int st1 = row_stride(n1), st2 = row_stride(n2);
  const int RA = (A + CLUSTER - 1) / CLUSTER;
  const int RB = (Bo + CLUSTER - 1) / CLUSTER;
  const int words = max(RA * st1, RB * st2);
  T* re = smem;
  T* im = re + words;
  T* twr1 = im + words;
  T* twi1 = twr1 + n1;
  T* twr2 = twi1 + n1;
  T* twi2 = twr2 + n2;
  load_twiddles(twr1, twi1, tw1, n1);
  load_twiddles(twr2, twi2, tw2, n2);

  // stage 1: this block's rows of the plane over B
  const int a0 = c * RA;
  const int ra = max(0, min(RA, A - a0));
  load_rows(re, im, ra, ra, st1, n1, B, s1.in0, xr, xi, p * A + a0);
  __syncthreads();
  fft_rows<POW2>(re, im, ra, st1, s1, twr1, twi1);
  cluster.sync();

  // gather this block's Bo columns (j0 + jj) of every row a from the block
  // that holds it: element (a, jj), jj fastest, so that a warp reads one
  // run of a remote row. a / RA by a float reciprocal: exact for a < 2^12.
  const int j0 = c * RB;
  const int rb = max(0, min(RB, Bo - j0));
  const float inv_ra = 1.f / (float)RA;
  T gr[EPT], gi[EPT];
  Walk w(max(rb, 1));
#pragma unroll
  for (int e = 0; e < EPT; ++e, w.next()) {
    if (w.row < A && rb > 0) {
      const int src = (int)(((float)w.row + 0.5f) * inv_ra);
      const int o =
          (w.row - src * RA) * st1 + pad(wrap(s1.out0 + j0 + w.col, n1));
      gr[e] = cluster.map_shared_rank(re, src)[o];
      gi[e] = cluster.map_shared_rank(im, src)[o];
    }
  }
  // every block has read this block's stage-1 rows; no block reads another
  // block's shared memory after this point
  cluster.sync();

  // stage 2: buffer row jj is column j0 + jj, input a at position
  // (in0 + a) mod n2; the positions no input reaches are zero
  w = Walk(max(rb, 1));
#pragma unroll
  for (int e = 0; e < EPT; ++e, w.next()) {
    if (w.row < A && rb > 0) {
      const int o = w.col * st2 + pad(wrap(s2.in0 + w.row, n2));
      re[o] = gr[e];
      im[o] = gi[e];
    }
  }
  w = Walk(max(rb, 1));
  for (int id = threadIdx.x; id < rb * (n2 - A); id += PLANE_THREADS) {
    const int o = w.col * st2 + pad(wrap(s2.in0 + A + w.row, n2));
    re[o] = T(0);
    im[o] = T(0);
    w.next();
  }
  __syncthreads();
  fft_rows<POW2>(re, im, rb, st2, s2, twr2, twi2);

  const T sc = s2.scale;
  const bool vec = aligned16(yr, yi);
  T vr[W], vi[W];
  if (!swap_out) {  // (P, Bo, Ao): element (jj, i), i fastest
    const int u = vec && s2.out0 == 0 && Ao % W == 0 ? W : 1;
    w = Walk(Ao / u);
    for (int id = threadIdx.x; id < rb * Ao / u; id += PLANE_THREADS) {
      const int i = u * w.col;
      const long long g = (p * Bo + j0 + w.row) * Ao + i;
      if (u == W) {  // positions i .. i + W - 1: one padded run
        const int o = w.row * st2 + pad(i);
#pragma unroll
        for (int t = 0; t < W; ++t) {
          vr[t] = re[o + t] * sc;
          vi[t] = im[o + t] * sc;
        }
        store16(yr + g, vr);
        store16(yi + g, vi);
      } else {
        const int o = w.row * st2 + pad(wrap(s2.out0 + i, n2));
        yr[g] = re[o] * sc;
        yi[g] = im[o] * sc;
      }
      w.next();
    }
  } else {  // (P, Ao, Bo): element (i, jj), jj fastest, runs of RB along B'
    const int u = vec && Bo % W == 0 && RB % W == 0 ? W : 1;
    w = Walk(max(rb / u, 1));
    for (int id = threadIdx.x; id < rb * Ao / u; id += PLANE_THREADS) {
      const int jj = u * w.col;
      const int o = jj * st2 + pad(wrap(s2.out0 + w.row, n2));
      const long long g = (p * Ao + w.row) * Bo + j0 + jj;
      if (u == W) {  // columns jj .. jj + W - 1: 16 bytes
#pragma unroll
        for (int t = 0; t < W; ++t) {
          vr[t] = re[o + t * st2] * sc;
          vi[t] = im[o + t * st2] * sc;
        }
        store16(yr + g, vr);
        store16(yi + g, vi);
      } else {
        yr[g] = re[o] * sc;
        yi[g] = im[o] * sc;
      }
      w.next();
    }
  }
}

namespace {

template <class T>
int launch_stage(const T* xr, const T* xi, T* yr, T* yi, const T* tw,
                 long long M, int K, int N, int plane_rows, int n, int sign,
                 T scale, int in0, int out0, int radices, void* stream) {
  int threads, rows;
  stage_block<T>(n, &threads, &rows, odd_radices(radices));
  const size_t smem = stage_smem<T>(n, rows);
  auto kernel = tile_instance(n, radices, fft_stage_kernel<true, false, T>,
                              fft_stage_kernel<false, true, T>,
                              fft_stage_kernel<false, false, T>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((M + rows - 1) / rows);
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      xr, xi, yr, yi, tw, M, K, N, plane_rows, rows,
      FftSpec<T>{n, sign, scale, in0, out0, radices});
  return (int)cudaGetLastError();
}

template <class T>
int launch_plane(const T* xr, const T* xi, T* yr, T* yi, const T* tw1,
                 const T* tw2, int P, int A, int B, int Bo, int Ao, int n1,
                 int sign1, int in1, int out1, int rad1, int n2, int sign2,
                 int in2, int out2, int rad2, T scale, int swap_out,
                 void* stream) {
  // radix 7 and 11 run in two stage launches (ops/dft_kernel.py:
  // plane_forms): on an H100 they ran faster there than in an instance of
  // this kernel for them, which held one block an SM and spilled
  if (odd_radices(rad1) || odd_radices(rad2))
    return (int)cudaErrorInvalidValue;
  const size_t smem = plane_smem<T>(A, Bo, n1, n2);
  auto kernel = pow2(n1) && pow2(n2) ? fft_plane_kernel<true, T>
                                     : fft_plane_kernel<false, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)P * CLUSTER, PLANE_THREADS, smem,
           (cudaStream_t)stream>>>(
      xr, xi, yr, yi, tw1, tw2, A, B, Bo, Ao,
      FftSpec<T>{n1, sign1, T(1), in1, out1, rad1},
      FftSpec<T>{n2, sign2, scale, in2, out2, rad2}, swap_out);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch of the FFT stage: rows (M, K) of (xr, xi) -> (yr, yi) (M, N),
// the transform (n, sign, scale, in0, out0, radices) with twiddle table tw
// ((2, n) on the device), stored as plane_rows says. _f64: the same on
// double operands.
extern "C" int spfft_fft_stage(const float* xr, const float* xi, float* yr,
                               float* yi, const float* tw, long long M,
                               int K, int N, int plane_rows, int n, int sign,
                               float scale, int in0, int out0, int radices,
                               void* stream) {
  return launch_stage(xr, xi, yr, yi, tw, M, K, N, plane_rows, n, sign,
                      scale, in0, out0, radices, stream);
}

extern "C" int spfft_fft_stage_f64(const double* xr, const double* xi,
                                   double* yr, double* yi, const double* tw,
                                   long long M, int K, int N, int plane_rows,
                                   int n, int sign, double scale, int in0,
                                   int out0, int radices, void* stream) {
  return launch_stage(xr, xi, yr, yi, tw, M, K, N, plane_rows, n, sign,
                      scale, in0, out0, radices, stream);
}

// One launch of the cluster plane kernel over P planes (A, B) -> (Bo, Ao)
// or, with swap_out, (Ao, Bo): transform 1 over B, transform 2 over A, the
// product `scale` of their scales applied at the store. _f64: the same on
// double operands.
extern "C" int spfft_fft_plane(const float* xr, const float* xi, float* yr,
                               float* yi, const float* tw1, const float* tw2,
                               int P, int A, int B, int Bo, int Ao, int n1,
                               int sign1, int in1, int out1, int rad1, int n2,
                               int sign2, int in2, int out2, int rad2,
                               float scale, int swap_out, void* stream) {
  return launch_plane(xr, xi, yr, yi, tw1, tw2, P, A, B, Bo, Ao, n1, sign1,
                      in1, out1, rad1, n2, sign2, in2, out2, rad2, scale,
                      swap_out, stream);
}

extern "C" int spfft_fft_plane_f64(const double* xr, const double* xi,
                                   double* yr, double* yi, const double* tw1,
                                   const double* tw2, int P, int A, int B,
                                   int Bo, int Ao, int n1, int sign1, int in1,
                                   int out1, int rad1, int n2, int sign2,
                                   int in2, int out2, int rad2, double scale,
                                   int swap_out, void* stream) {
  return launch_plane(xr, xi, yr, yi, tw1, tw2, P, A, B, Bo, Ao, n1, sign1,
                      in1, out1, rad1, n2, sign2, in2, out2, rad2, scale,
                      swap_out, stream);
}
