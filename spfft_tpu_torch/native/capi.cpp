// Native C API host of the PyTorch / CUDA port: embeds CPython and
// dispatches to spfft_tpu_torch.capi_bridge.
//
// The port's copy of spfft_tpu/native/capi.cpp, with the same interpreter
// lifecycle, GIL handling and marshalling; it imports
// spfft_tpu_torch.capi_bridge and names every code of the port's ErrorCode.
// This translation unit owns only the runtime embedding: interpreter
// lifecycle, the GIL, and marshalling plain integers across the ABI
// (include/spfft_tpu_torch.h, the same symbols and signatures as
// include/spfft_tpu.h). All argument validation, buffer wrapping, the
// host<->device copies and error-code mapping happen in
// spfft_tpu_torch/capi_bridge.py, which returns (code, payload) tuples and
// never raises across the boundary.
//
// Loaded into a running Python process (ctypes), the library shares that
// interpreter; linked into a C or Fortran program, it starts its own.
//
// Build (spfft_tpu_torch.native.build_capi, `make capi-torch`):
//   g++ -O3 -std=c++17 -shared -fPIC -Iinclude -I<INCLUDEPY> capi.cpp
//       -o build/torch_capi/libspfft_tpu_torch.so -L<LIBDIR> -lpython3.X
//       -Wl,-Bsymbolic
// -Bsymbolic binds the library's own calls to its own definitions, so a
// process that also holds libspfft_tpu.so (the same symbols) cannot mix
// the two.

#include <Python.h>

#include <cstdint>
#include <cstdio>
#include <initializer_list>
#include <mutex>

#include "spfft_tpu_torch.h"  // keep definitions checked against the public ABI

namespace {

constexpr int kSuccess = 0;
constexpr int kInvalidHandle = 2;        // SPFFT_TPU_INVALID_HANDLE_ERROR
constexpr int kInvalidParameter = 5;     // SPFFT_TPU_INVALID_PARAMETER_ERROR
constexpr int kUnknown = 1;              // SPFFT_TPU_UNKNOWN_ERROR
constexpr int kRuntimeInit = 100;        // SPFFT_TPU_RUNTIME_INIT_ERROR

std::mutex g_init_mutex;
PyObject* g_bridge = nullptr;  // spfft_tpu_torch.capi_bridge module (owned)
bool g_we_initialized = false;

// Plan handles are the bridge's integer plan ids, stored directly in the
// opaque pointer (id 0 is never issued).
inline void* id_to_handle(long long id) {
  return reinterpret_cast<void*>(static_cast<intptr_t>(id));
}
inline long long handle_to_id(void* h) {
  return static_cast<long long>(reinterpret_cast<intptr_t>(h));
}

// Ensure the interpreter is running and the bridge module is imported.
// Returns 0 or an error code. On success the caller still must take the
// GIL via PyGILState_Ensure for its own calls.
int ensure_runtime(const char* package_path) {
  std::lock_guard<std::mutex> lock(g_init_mutex);
  if (g_bridge != nullptr) return kSuccess;
  if (!Py_IsInitialized()) {
    Py_InitializeEx(/*install_sigint_handler=*/0);
    if (!Py_IsInitialized()) return kRuntimeInit;
    g_we_initialized = true;
  }
  PyGILState_STATE st = PyGILState_Ensure();
  int code = kSuccess;
  if (package_path != nullptr) {
    PyObject* sys_path = PySys_GetObject("path");  // borrowed
    PyObject* p = PyUnicode_FromString(package_path);
    if (sys_path == nullptr || p == nullptr ||
        PyList_Insert(sys_path, 0, p) != 0) {
      code = kRuntimeInit;
    }
    Py_XDECREF(p);
  }
  if (code == kSuccess) {
    g_bridge = PyImport_ImportModule("spfft_tpu_torch.capi_bridge");
    if (g_bridge == nullptr) {
      PyErr_Print();
      code = kRuntimeInit;
    }
  }
  PyGILState_Release(st);
  // If we started the interpreter, detach this thread's state so any
  // thread (including this one) can re-acquire via PyGILState_Ensure —
  // unconditionally, or a failed import would leave the GIL held forever
  // and deadlock every later call instead of returning an error code.
  static bool detached = false;
  if (g_we_initialized && !detached) {
    PyEval_SaveThread();
    detached = true;
  }
  return code;
}

// Call bridge.<fn>(args...) where every argument is a long long; the bridge
// returns (code, payload). Writes payload to *payload_out if non-null.
int call_bridge(const char* fn, std::initializer_list<long long> args,
                long long* payload_out) {
  int code = ensure_runtime(nullptr);
  if (code != kSuccess) return code;
  PyGILState_STATE st = PyGILState_Ensure();
  PyObject* tuple = PyTuple_New(static_cast<Py_ssize_t>(args.size()));
  if (tuple == nullptr) {
    PyErr_Clear();
    PyGILState_Release(st);
    return kUnknown;
  }
  Py_ssize_t i = 0;
  for (long long a : args) {
    PyObject* v = PyLong_FromLongLong(a);
    if (v == nullptr) {
      PyErr_Clear();
      Py_DECREF(tuple);
      PyGILState_Release(st);
      return kUnknown;
    }
    PyTuple_SET_ITEM(tuple, i++, v);
  }
  PyObject* callable = PyObject_GetAttrString(g_bridge, fn);
  PyObject* result =
      callable != nullptr ? PyObject_CallObject(callable, tuple) : nullptr;
  Py_XDECREF(callable);
  Py_DECREF(tuple);
  if (result == nullptr) {
    PyErr_Print();
    PyGILState_Release(st);
    return kUnknown;
  }
  long long payload = 0;
  if (PyTuple_Check(result) && PyTuple_GET_SIZE(result) == 2) {
    code = static_cast<int>(PyLong_AsLongLong(PyTuple_GET_ITEM(result, 0)));
    payload = PyLong_AsLongLong(PyTuple_GET_ITEM(result, 1));
  } else {
    code = kUnknown;
  }
  Py_DECREF(result);
  if (PyErr_Occurred()) {
    PyErr_Print();
    code = kUnknown;
  }
  if (payload_out != nullptr) *payload_out = payload;
  PyGILState_Release(st);
  return code;
}

}  // namespace

extern "C" {

int spfft_tpu_abi_version(void) {
  return 2;  // keep equal to SPFFT_TPU_ABI_VERSION in include/spfft_tpu_torch.h
}

int spfft_tpu_init(const char* package_path) {
  return ensure_runtime(package_path);
}

int spfft_tpu_plan_create(void** plan, int transform_type, int dim_x,
                          int dim_y, int dim_z, long long num_values,
                          const int* index_triplets, int precision,
                          int use_pallas) {
  if (plan == nullptr || (index_triplets == nullptr && num_values > 0)) {
    return kInvalidParameter;
  }
  long long pid = 0;
  int code = call_bridge(
      "plan_create",
      {transform_type, dim_x, dim_y, dim_z, num_values,
       static_cast<long long>(reinterpret_cast<intptr_t>(index_triplets)),
       precision, use_pallas},
      &pid);
  if (code == kSuccess) *plan = id_to_handle(pid);
  return code;
}

int spfft_tpu_plan_create_distributed(void** plan, int transform_type,
                                      int dim_x, int dim_y, int dim_z,
                                      int num_shards,
                                      const long long* values_per_shard,
                                      const int* index_triplets,
                                      const int* planes_per_shard,
                                      int precision, int exchange_type,
                                      int use_pallas) {
  if (plan == nullptr || values_per_shard == nullptr ||
      planes_per_shard == nullptr || num_shards < 1) {
    return kInvalidParameter;
  }
  long long total = 0;
  for (int r = 0; r < num_shards; ++r) total += values_per_shard[r];
  if (index_triplets == nullptr && total > 0) return kInvalidParameter;
  long long pid = 0;
  int code = call_bridge(
      "plan_create_distributed",
      {transform_type, dim_x, dim_y, dim_z, num_shards,
       static_cast<long long>(reinterpret_cast<intptr_t>(values_per_shard)),
       static_cast<long long>(reinterpret_cast<intptr_t>(index_triplets)),
       static_cast<long long>(reinterpret_cast<intptr_t>(planes_per_shard)),
       precision, exchange_type, use_pallas},
      &pid);
  if (code == kSuccess) *plan = id_to_handle(pid);
  return code;
}

int spfft_tpu_multi_backward(int num_transforms, void* const* plans,
                             const void* const* values,
                             void* const* spaces) {
  if (num_transforms < 1 || plans == nullptr || values == nullptr ||
      spaces == nullptr) {
    return kInvalidParameter;
  }
  for (int i = 0; i < num_transforms; ++i) {
    if (values[i] == nullptr || spaces[i] == nullptr) {
      return kInvalidParameter;
    }
  }
  return call_bridge(
      "multi_backward",
      {num_transforms,
       static_cast<long long>(reinterpret_cast<intptr_t>(plans)),
       static_cast<long long>(reinterpret_cast<intptr_t>(values)),
       static_cast<long long>(reinterpret_cast<intptr_t>(spaces))},
      nullptr);
}

int spfft_tpu_multi_forward(int num_transforms, void* const* plans,
                            const void* const* spaces, int scaling,
                            void* const* values) {
  if (num_transforms < 1 || plans == nullptr || values == nullptr ||
      spaces == nullptr) {
    return kInvalidParameter;
  }
  for (int i = 0; i < num_transforms; ++i) {
    if (values[i] == nullptr || spaces[i] == nullptr) {
      return kInvalidParameter;
    }
  }
  return call_bridge(
      "multi_forward",
      {num_transforms,
       static_cast<long long>(reinterpret_cast<intptr_t>(plans)),
       static_cast<long long>(reinterpret_cast<intptr_t>(spaces)), scaling,
       static_cast<long long>(reinterpret_cast<intptr_t>(values))},
      nullptr);
}

int spfft_tpu_plan_destroy(void* plan) {
  return call_bridge("plan_destroy", {handle_to_id(plan)}, nullptr);
}

int spfft_tpu_backward(void* plan, const void* values, void* space) {
  if (values == nullptr || space == nullptr) return kInvalidParameter;
  return call_bridge(
      "backward",
      {handle_to_id(plan),
       static_cast<long long>(reinterpret_cast<intptr_t>(values)),
       static_cast<long long>(reinterpret_cast<intptr_t>(space))},
      nullptr);
}

int spfft_tpu_forward(void* plan, const void* space, int scaling,
                      void* values) {
  if (values == nullptr || space == nullptr) return kInvalidParameter;
  return call_bridge(
      "forward",
      {handle_to_id(plan),
       static_cast<long long>(reinterpret_cast<intptr_t>(space)), scaling,
       static_cast<long long>(reinterpret_cast<intptr_t>(values))},
      nullptr);
}

int spfft_tpu_execute_pair(void* plan, const void* values_in, int scaling,
                           void* values_out) {
  if (values_in == nullptr || values_out == nullptr) return kInvalidParameter;
  return call_bridge(
      "execute_pair",
      {handle_to_id(plan),
       static_cast<long long>(reinterpret_cast<intptr_t>(values_in)), scaling,
       static_cast<long long>(reinterpret_cast<intptr_t>(values_out))},
      nullptr);
}

static int plan_info(void* plan, int what, long long* out,
                     long long shard = 0) {
  if (out == nullptr) return kInvalidParameter;
  return call_bridge("plan_info", {handle_to_id(plan), what, shard}, out);
}

static int plan_info_int(void* plan, int what, int* out,
                         long long shard = 0) {
  if (out == nullptr) return kInvalidParameter;
  long long v = 0;
  int code = plan_info(plan, what, &v, shard);
  if (code == kSuccess) *out = static_cast<int>(v);
  return code;
}

int spfft_tpu_plan_dim_x(void* plan, int* out) {
  if (out == nullptr) return kInvalidParameter;
  long long v = 0;
  int code = plan_info(plan, 0, &v);
  if (code == kSuccess) *out = static_cast<int>(v);
  return code;
}

int spfft_tpu_plan_dim_y(void* plan, int* out) {
  if (out == nullptr) return kInvalidParameter;
  long long v = 0;
  int code = plan_info(plan, 1, &v);
  if (code == kSuccess) *out = static_cast<int>(v);
  return code;
}

int spfft_tpu_plan_dim_z(void* plan, int* out) {
  if (out == nullptr) return kInvalidParameter;
  long long v = 0;
  int code = plan_info(plan, 2, &v);
  if (code == kSuccess) *out = static_cast<int>(v);
  return code;
}

int spfft_tpu_plan_num_values(void* plan, long long* out) {
  return plan_info(plan, 3, out);
}

int spfft_tpu_plan_transform_type(void* plan, int* out) {
  if (out == nullptr) return kInvalidParameter;
  long long v = 0;
  int code = plan_info(plan, 4, &v);
  if (code == kSuccess) *out = static_cast<int>(v);
  return code;
}

int spfft_tpu_plan_num_shards(void* plan, int* out) {
  if (out == nullptr) return kInvalidParameter;
  long long v = 0;
  int code = plan_info(plan, 5, &v);
  if (code == kSuccess) *out = static_cast<int>(v);
  return code;
}

int spfft_tpu_plan_global_size(void* plan, long long* out) {
  return plan_info(plan, 6, out);
}

int spfft_tpu_plan_num_global_elements(void* plan, long long* out) {
  return plan_info(plan, 7, out);
}

int spfft_tpu_plan_local_z_offset(void* plan, int shard, int* out) {
  return plan_info_int(plan, 8, out, shard);
}

int spfft_tpu_plan_local_z_length(void* plan, int shard, int* out) {
  return plan_info_int(plan, 9, out, shard);
}

int spfft_tpu_plan_local_slice_size(void* plan, int shard, long long* out) {
  return plan_info(plan, 10, out, shard);
}

int spfft_tpu_plan_num_local_elements(void* plan, int shard,
                                      long long* out) {
  return plan_info(plan, 11, out, shard);
}

int spfft_tpu_plan_exchange_type(void* plan, int* out) {
  return plan_info_int(plan, 12, out);
}

int spfft_tpu_plan_pallas_active(void* plan, int* out) {
  return plan_info_int(plan, 13, out);
}

const char* spfft_tpu_error_string(int code) {
  switch (code) {
    case 0: return "success";
    case 1: return "unknown error";
    case 2: return "invalid plan handle";
    case 3: return "size overflow";
    case 4: return "allocation failure";
    case 5: return "invalid parameter";
    case 6: return "duplicate z-stick indices";
    case 7: return "frequency index out of bounds";
    case 8: return "distributed support missing";
    case 9: return "distributed/collective failure";
    case 10: return "plan parameters mismatch across shards";
    case 11: return "host execution failure";
    case 12: return "FFT backend failure";
    case 13: return "device (CUDA) failure";
    case 14: return "device failure from a preceding call";
    case 15: return "device support missing";
    case 16: return "device allocation failure";
    case 17: return "device kernel launch failure";
    case 18: return "no CUDA device";
    case 19: return "invalid value passed to the device";
    case 20: return "invalid device pointer";
    case 21: return "device copy failure";
    case 22: return "device FFT failure";
    case 100: return "embedded Python runtime initialisation failed";
    default: return "unrecognised error code";
  }
}

}  // extern "C"
