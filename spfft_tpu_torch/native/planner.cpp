// The port's native index planner: sparse frequency triplets -> z-stick
// tables, the semantics of the reference index conversion (reference:
// src/compression/indices.hpp:120-186 convert_index_triplets, :49-55
// to_storage_index). The numpy path in spfft_tpu_torch/indexing.py is the
// executable specification; this library exists because the sort-based
// np.unique over every value's stick key takes seconds at 256^3 (8.8M
// triplets) and tens of seconds at 768^3, while the dense bitmap-rank pass
// here is O(n + dim_x * dim_y).
//
// The same C ABI as spfft_tpu/native/planner.cpp's spfft_tpu_plan_indices
// and spfft_tpu_inverse_map, loaded with ctypes by native/planner.py
// (g++ -O3 -std=c++17 -fopenmp -shared -fPIC into build/torch_native/).

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstring>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

// Error codes mirrored in native/planner.py.
constexpr int64_t kErrInvalidBounds = -1;
constexpr int64_t kErrTooManyValues = -2;
// Allocation failure / grid too large for the dense-bitmap algorithm — the
// caller takes the numpy path (no C++ exception may cross the C ABI).
constexpr int64_t kErrNoNativePath = -3;

}  // namespace

extern "C" {

// Convert (n, 3) int64 row-major triplets into per-value flat indices and
// the ascending unique stick-key list.
//
// Outputs:
//   value_indices[n]  int32 : stick_id * dim_z + z_storage  per value
//   stick_keys[n]     int32 : first num_sticks entries hold the ascending
//                             unique keys x_storage * dim_y + y_storage
//   centered_out      int32 : 1 if any index was negative
// Returns num_sticks (>= 0) or a negative error code.
int64_t spfft_tpu_plan_indices(int32_t hermitian, int64_t dim_x,
                               int64_t dim_y, int64_t dim_z,
                               const int64_t* xyz, int64_t n,
                               int32_t* value_indices, int32_t* stick_keys,
                               int32_t* centered_out) {
  if (n > dim_x * dim_y * dim_z) return kErrTooManyValues;

  // Pass 1: centered detection (any negative index, indices.hpp:129-135).
  bool centered = false;
#pragma omp parallel for reduction(|| : centered) schedule(static)
  for (int64_t i = 0; i < 3 * n; ++i) centered = centered || (xyz[i] < 0);
  *centered_out = centered ? 1 : 0;

  // Bounds, exactly as reference indices.hpp:137-149.
  const int64_t max_x = (hermitian || centered ? dim_x / 2 + 1 : dim_x) - 1;
  const int64_t max_y = (centered ? dim_y / 2 + 1 : dim_y) - 1;
  const int64_t max_z = (centered ? dim_z / 2 + 1 : dim_z) - 1;
  const int64_t min_x = hermitian ? 0 : max_x - dim_x + 1;
  const int64_t min_y = max_y - dim_y + 1;
  const int64_t min_z = max_z - dim_z + 1;

  const int64_t plane = dim_x * dim_y;
  std::vector<uint8_t> present;
  std::vector<int32_t> rank;
  try {
    present.assign(static_cast<size_t>(plane), 0);
    rank.resize(static_cast<size_t>(plane));
  } catch (...) {
    return kErrNoNativePath;
  }

  // Pass 2: bounds check + mark present stick keys. Benign write races on
  // the bitmap (all writers store 1).
  bool oob = false;
#pragma omp parallel for reduction(|| : oob) schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const int64_t x = xyz[3 * i], y = xyz[3 * i + 1], z = xyz[3 * i + 2];
    if (x < min_x || x > max_x || y < min_y || y > max_y || z < min_z ||
        z > max_z) {
      oob = true;
      continue;
    }
    const int64_t xs = x < 0 ? x + dim_x : x;
    const int64_t ys = y < 0 ? y + dim_y : y;
    // Relaxed atomic store: many threads may mark the same key; all store 1.
    __atomic_store_n(&present[static_cast<size_t>(xs * dim_y + ys)],
                     static_cast<uint8_t>(1), __ATOMIC_RELAXED);
  }
  if (oob) return kErrInvalidBounds;

  // Pass 3: rank present keys in ascending order (the ordered-map semantics
  // of indices.hpp:152-165, without the map).
  int32_t num_sticks = 0;
  for (int64_t k = 0; k < plane; ++k) {
    if (present[static_cast<size_t>(k)]) {
      rank[static_cast<size_t>(k)] = num_sticks;
      stick_keys[num_sticks++] = static_cast<int32_t>(k);
    }
  }

  // Pass 4: per-value flat index stick_id * dim_z + z (indices.hpp:168-176).
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const int64_t x = xyz[3 * i], y = xyz[3 * i + 1], z = xyz[3 * i + 2];
    const int64_t xs = x < 0 ? x + dim_x : x;
    const int64_t ys = y < 0 ? y + dim_y : y;
    const int64_t zs = z < 0 ? z + dim_z : z;
    value_indices[i] = static_cast<int32_t>(
        static_cast<int64_t>(rank[static_cast<size_t>(xs * dim_y + ys)]) *
            dim_z +
        zs);
  }
  return num_sticks;
}

// Inverse maps (indexing.inverse_slot_map / inverse_col_map): scatter of
// iota, included so the whole plan build can run natively. The scatter loop
// is serial so that duplicate indices resolve to the *last* occurrence,
// matching the numpy path's fancy-assignment semantics. Returns 0, or
// -1 if any index is out of [0, num_slots).
int32_t spfft_tpu_inverse_map(const int32_t* indices, int64_t n,
                              int32_t* out, int64_t num_slots,
                              int32_t sentinel) {
  bool oob = false;
#pragma omp parallel for reduction(|| : oob) schedule(static)
  for (int64_t i = 0; i < n; ++i)
    oob = oob || indices[i] < 0 || indices[i] >= num_slots;
  if (oob) return -1;
#pragma omp parallel for schedule(static)
  for (int64_t s = 0; s < num_slots; ++s) out[s] = sentinel;
  for (int64_t i = 0; i < n; ++i) out[indices[i]] = static_cast<int32_t>(i);
  return 0;
}

}  // extern "C"
