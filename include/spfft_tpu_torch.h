/*
 * spfft_tpu_torch C API — native entry points for C/C++/Fortran callers of
 * the PyTorch / CUDA port.
 *
 * The same symbols, signatures and enum values as include/spfft_tpu.h
 * (ABI version 2): a program built against either header links against
 * either library, libspfft_tpu.so (the JAX package) or
 * libspfft_tpu_torch.so (this port), unchanged. Behind these calls is an
 * embedded CPython interpreter inside libspfft_tpu_torch.so that imports
 * spfft_tpu_torch.capi_bridge (see spfft_tpu_torch/native/capi.cpp); every
 * transform runs the port's plans on an NVIDIA GPU through its
 * hand-written CUDA kernels.
 *
 * Build: python3 -c "from spfft_tpu_torch.native import build_capi;
 * print(build_capi())" (or `make capi-torch`) compiles the library into
 * build/torch_capi/libspfft_tpu_torch.so. Link with
 *   -Lbuild/torch_capi -lspfft_tpu_torch -Wl,-rpath,<that directory>
 * The embedded interpreter must be able to import torch and
 * spfft_tpu_torch: pass the repository root to spfft_tpu_init (or set
 * PYTHONPATH).
 *
 * Device: SPFFT_TPU_TORCH_DEVICE, read at plan creation, picks where a
 * plan runs:
 *   unset or "cuda": the current CUDA device; with no CUDA device
 *                    plan creation returns SPFFT_TPU_DEVICE_ERROR and runs
 *                    nothing on the host;
 *   "cpu":           the kernels' plain PyTorch versions on the host;
 *   anything else:   SPFFT_TPU_INVALID_PARAMETER_ERROR.
 *
 * Buffers are host memory (identical layouts to the Python API, and to the
 * reference's space-domain layout (z*Ny + y)*Nx + x, docs/source/details.rst
 * "Indexing"):
 *   - frequency values: interleaved complex, 2*num_values reals
 *   - C2C space domain: interleaved complex, 2*dimX*dimY*dimZ reals
 *   - R2C space domain: dimX*dimY*dimZ reals
 *   - element type: float for SPFFT_TPU_PREC_SINGLE, double for DOUBLE
 * Each call copies its input to the card once and its result back once,
 * straight into the caller's buffer.
 *
 * Thread-safety: calls may come from any thread; the library runs one call
 * at a time. A plan handle must not be used after spfft_tpu_plan_destroy.
 */

#ifndef SPFFT_TPU_TORCH_H
#define SPFFT_TPU_TORCH_H

#ifdef __cplusplus
extern "C" {
#endif

/* Error codes, equal to spfft_tpu_torch.ErrorCode (Python), which mirrors
 * the reference SpfftError enum (reference: include/spfft/errors.h:33-126).
 * Codes 14 and 17-21 are this port's additions to include/spfft_tpu.h's
 * list; the values of the common codes are the same. */
typedef enum SpfftTpuError {
  SPFFT_TPU_SUCCESS = 0,
  SPFFT_TPU_UNKNOWN_ERROR = 1,
  SPFFT_TPU_INVALID_HANDLE_ERROR = 2,
  SPFFT_TPU_OVERFLOW_ERROR = 3,
  SPFFT_TPU_ALLOCATION_ERROR = 4,
  SPFFT_TPU_INVALID_PARAMETER_ERROR = 5,
  SPFFT_TPU_DUPLICATE_INDICES_ERROR = 6,
  SPFFT_TPU_INVALID_INDICES_ERROR = 7,
  SPFFT_TPU_DISTRIBUTED_SUPPORT_ERROR = 8,
  SPFFT_TPU_DISTRIBUTED_ERROR = 9,
  SPFFT_TPU_PARAMETER_MISMATCH_ERROR = 10,
  SPFFT_TPU_HOST_EXECUTION_ERROR = 11,
  SPFFT_TPU_FFT_ERROR = 12,
  /* a CUDA failure, or no CUDA device where one is needed */
  SPFFT_TPU_DEVICE_ERROR = 13,
  SPFFT_TPU_DEVICE_PRECEDING_ERROR = 14,
  SPFFT_TPU_DEVICE_SUPPORT_ERROR = 15,
  SPFFT_TPU_DEVICE_ALLOCATION_ERROR = 16,
  SPFFT_TPU_DEVICE_LAUNCH_ERROR = 17,
  SPFFT_TPU_DEVICE_NO_DEVICE_ERROR = 18,
  SPFFT_TPU_DEVICE_INVALID_VALUE_ERROR = 19,
  SPFFT_TPU_DEVICE_INVALID_DEVICE_PTR_ERROR = 20,
  SPFFT_TPU_DEVICE_COPY_ERROR = 21,
  SPFFT_TPU_DEVICE_FFT_ERROR = 22,
  /* C-layer-only: the embedded interpreter could not be started or
   * spfft_tpu_torch (or torch) could not be imported. */
  SPFFT_TPU_RUNTIME_INIT_ERROR = 100
} SpfftTpuError;

/* Transform type (reference: types.h:85-95). */
typedef enum SpfftTpuTransformType {
  SPFFT_TPU_TRANS_C2C = 0,
  SPFFT_TPU_TRANS_R2C = 1
} SpfftTpuTransformType;

/* Forward-transform scaling (reference: types.h:97-106). */
typedef enum SpfftTpuScalingType {
  SPFFT_TPU_NO_SCALING = 0,
  SPFFT_TPU_FULL_SCALING = 1
} SpfftTpuScalingType;

/* Element precision: float32 or float64 on the card (native FP64). */
typedef enum SpfftTpuPrecision {
  SPFFT_TPU_PREC_SINGLE = 0,
  SPFFT_TPU_PREC_DOUBLE = 1
} SpfftTpuPrecision;

/* Distributed exchange algorithm (reference: SpfftExchangeType,
 * types.h:33-62 — same order/meaning). The port runs DEFAULT and
 * BUFFERED (the block exchange between the shards on one card); it
 * refuses COMPACT_BUFFERED, the two FLOAT variants and UNBUFFERED with
 * SPFFT_TPU_INVALID_PARAMETER_ERROR, naming the reason on stderr. */
typedef enum SpfftTpuExchangeType {
  SPFFT_TPU_EXCH_DEFAULT = 0,
  SPFFT_TPU_EXCH_BUFFERED = 1,
  SPFFT_TPU_EXCH_BUFFERED_FLOAT = 2,
  SPFFT_TPU_EXCH_COMPACT_BUFFERED = 3,
  SPFFT_TPU_EXCH_COMPACT_BUFFERED_FLOAT = 4,
  SPFFT_TPU_EXCH_UNBUFFERED = 5
} SpfftTpuExchangeType;

/* The z-stage route (the names are the JAX package's, whose compression
 * kernels are Pallas kernels): AUTO and ON run the fused compression +
 * z-FFT CUDA kernels; OFF runs the two-kernel route (the gather kernel and
 * the z-FFT kernel). All three run hand-written kernels on the card, with
 * bit-identical results. */
typedef enum SpfftTpuPallasMode {
  SPFFT_TPU_PALLAS_AUTO = -1,
  SPFFT_TPU_PALLAS_OFF = 0,
  SPFFT_TPU_PALLAS_ON = 1
} SpfftTpuPallasMode;

/*
 * ABI version of this header, equal to include/spfft_tpu.h's. Check
 *   spfft_tpu_abi_version() == SPFFT_TPU_ABI_VERSION
 * once at startup to fail loudly on a library built from another ABI.
 */
#define SPFFT_TPU_ABI_VERSION 2

/* Opaque plan handle (reference: SpfftTransform, transform.h). */
typedef void* SpfftTpuPlan;

/* The ABI version the loaded library was BUILT with (compare against
 * SPFFT_TPU_ABI_VERSION from the header you compiled against). */
int spfft_tpu_abi_version(void);

/*
 * Start the embedded interpreter and import spfft_tpu_torch. package_path
 * may name a directory to prepend to the module search path (pass NULL if
 * spfft_tpu_torch is already importable). Safe to call more than once;
 * implicit on first plan creation. Returns SPFFT_TPU_RUNTIME_INIT_ERROR
 * when the import fails (torch missing, for one).
 */
int spfft_tpu_init(const char* package_path);

/*
 * Create a plan for a local sparse 3D FFT on the device that
 * SPFFT_TPU_TORCH_DEVICE names (reference: spfft_grid_create +
 * spfft_transform_create collapsed into one call).
 *
 * index_triplets: num_values x 3 ints (x, y, z per value), centered
 * (negative) or storage indexing (reference: types.h SPFFT_INDEX_TRIPLETS).
 * use_pallas: an SpfftTpuPallasMode value (pass SPFFT_TPU_PALLAS_AUTO).
 */
int spfft_tpu_plan_create(SpfftTpuPlan* plan, int transform_type, int dim_x,
                          int dim_y, int dim_z, long long num_values,
                          const int* index_triplets, int precision,
                          int use_pallas);

/*
 * Distributed plan over num_shards shards, all held on the one device
 * that SPFFT_TPU_TORCH_DEVICE names (reference:
 * spfft_grid_create_distributed + spfft_transform_create, grid.h — the MPI
 * communicator is replaced by num_shards shards on one card, with the
 * exchange between them on that card).
 *
 * values_per_shard: num_shards counts; index_triplets: the per-shard
 * triplet lists concatenated in shard order (sum(values_per_shard) x 3
 * ints); planes_per_shard: slab heights, summing to dim_z. A z-stick must
 * live wholly on one shard.
 *
 * I/O convention for backward/forward on a distributed plan: values are
 * the per-shard value arrays concatenated in shard order (interleaved
 * reals); space is the FULL (dim_z, dim_y, dim_x) cube in global z order
 * (slabs concatenated), interleaved complex for C2C / real for R2C.
 *
 * exchange_type: an SpfftTpuExchangeType value (DEFAULT or BUFFERED).
 * use_pallas: an SpfftTpuPallasMode value (pass SPFFT_TPU_PALLAS_AUTO).
 */
int spfft_tpu_plan_create_distributed(SpfftTpuPlan* plan, int transform_type,
                                      int dim_x, int dim_y, int dim_z,
                                      int num_shards,
                                      const long long* values_per_shard,
                                      const int* index_triplets,
                                      const int* planes_per_shard,
                                      int precision, int exchange_type,
                                      int use_pallas);

int spfft_tpu_plan_destroy(SpfftTpuPlan plan);

/*
 * Frequency -> space (reference: spfft_transform_backward, transform.h).
 * values: 2*num_values reals (interleaved). space: the full local cube in
 * the layout documented above. Unnormalised inverse DFT.
 */
int spfft_tpu_backward(SpfftTpuPlan plan, const void* values, void* space);

/*
 * Space -> frequency (reference: spfft_transform_forward, transform.h).
 * scaling: SPFFT_TPU_NO_SCALING or SPFFT_TPU_FULL_SCALING (1/(Nx*Ny*Nz)).
 */
int spfft_tpu_forward(SpfftTpuPlan plan, const void* space, int scaling,
                      void* values);

/*
 * Round trip: backward, then forward with the given scaling, with the
 * space domain kept on the card — the plane-wave-code inner loop (the
 * reference benchmark's repeated backward+forward pair,
 * tests/programs/benchmark.cpp:84-96): one copy of the values to the card
 * and one back, where spfft_tpu_backward + spfft_tpu_forward move the
 * space domain across twice.
 *
 * values_in/values_out: 2*num_values reals each (interleaved; per-shard
 * arrays concatenated in shard order for distributed plans). In-place
 * operation (values_out == values_in) is allowed. With
 * SPFFT_TPU_FULL_SCALING the pair is the identity up to roundoff.
 */
int spfft_tpu_execute_pair(SpfftTpuPlan plan, const void* values_in,
                           int scaling, void* values_out);

/*
 * Batched execution of num_transforms independent transforms (reference:
 * spfft_multi_transform_backward / _forward, multi_transform.h:37-72).
 * plans/values/spaces are arrays of num_transforms entries; buffer layouts
 * per entry are exactly those of spfft_tpu_backward / spfft_tpu_forward.
 * The SAME local plan handle for every entry runs the batch as one batched
 * execution (one launch of each kernel per direction) up to the port's
 * batching limit (spfft_tpu_torch.multi.FUSED_BATCH_MAX_GRID elements in
 * all); otherwise, and for distributed handles, the transforms run one at
 * a time, every one queued on the card before the first result is copied
 * back.
 */
int spfft_tpu_multi_backward(int num_transforms, const SpfftTpuPlan* plans,
                             const void* const* values, void* const* spaces);
int spfft_tpu_multi_forward(int num_transforms, const SpfftTpuPlan* plans,
                            const void* const* spaces, int scaling,
                            void* const* values);

/* Getters (reference: spfft_transform_get_* accessors, transform.h:84-245).
 * Each writes one value and returns an error code. */
int spfft_tpu_plan_dim_x(SpfftTpuPlan plan, int* out);
int spfft_tpu_plan_dim_y(SpfftTpuPlan plan, int* out);
int spfft_tpu_plan_dim_z(SpfftTpuPlan plan, int* out);
int spfft_tpu_plan_num_values(SpfftTpuPlan plan, long long* out);
int spfft_tpu_plan_transform_type(SpfftTpuPlan plan, int* out);
/* 1 for local plans, the shard count for distributed plans. */
int spfft_tpu_plan_num_shards(SpfftTpuPlan plan, int* out);
/* dim_x * dim_y * dim_z (reference: Transform::global_size). */
int spfft_tpu_plan_global_size(SpfftTpuPlan plan, long long* out);
/* Total sparse elements across shards (== num_values; reference:
 * num_global_elements). */
int spfft_tpu_plan_num_global_elements(SpfftTpuPlan plan, long long* out);
/* Per-shard accessors (reference per-rank getters: local_z_offset,
 * local_z_length, local_slice_size, num_local_elements — transform.h).
 * shard must be in [0, num_shards); local plans accept shard 0 only. */
int spfft_tpu_plan_local_z_offset(SpfftTpuPlan plan, int shard, int* out);
int spfft_tpu_plan_local_z_length(SpfftTpuPlan plan, int shard, int* out);
int spfft_tpu_plan_local_slice_size(SpfftTpuPlan plan, int shard,
                                    long long* out);
int spfft_tpu_plan_num_local_elements(SpfftTpuPlan plan, int shard,
                                      long long* out);
/* The SpfftTpuExchangeType of a distributed plan (DEFAULT for local). */
int spfft_tpu_plan_exchange_type(SpfftTpuPlan plan, int* out);
/* 1 when the plan runs the fused compression + z-FFT kernels (PALLAS_AUTO
 * or PALLAS_ON), 0 on the two-kernel route (PALLAS_OFF). */
int spfft_tpu_plan_pallas_active(SpfftTpuPlan plan, int* out);

/* Static message for an error code (never NULL). */
const char* spfft_tpu_error_string(int code);

#ifdef __cplusplus
}
#endif

#endif /* SPFFT_TPU_TORCH_H */
