!> spfft_tpu_torch Fortran interface — bind(C) declarations over the C API
!> of the PyTorch / CUDA port.
!>
!> The same bind(C) names, argument kinds and constants as
!> include/spfft_tpu.f90 (ABI version 2), in a module of its own name:
!> compile this file into your Fortran project and link against
!> libspfft_tpu_torch.so (built into build/torch_capi/ by
!> spfft_tpu_torch.native.build_capi, or `make capi-torch`). Every call
!> runs the port's plans on an NVIDIA GPU through its hand-written CUDA
!> kernels; buffers are host memory. SPFFT_TPU_TORCH_DEVICE ("cuda", the
!> default, or "cpu") picks the device at plan creation; see
!> include/spfft_tpu_torch.h for the buffer-layout, device and threading
!> contracts and for the exchanges the port refuses.
!>
!> No Fortran compiler is needed to check it: tests/test_torch_capi.py
!> pins every bind(C) declaration to the C header (names, argument counts,
!> constant values) and calls every declared function through argument
!> types taken only from the kinds declared here.

module spfft_tpu_torch
  use iso_c_binding
  implicit none

  ! Error codes (include/spfft_tpu_torch.h SpfftTpuError)
  integer(c_int), parameter :: SPFFT_TPU_SUCCESS = 0
  integer(c_int), parameter :: SPFFT_TPU_UNKNOWN_ERROR = 1
  integer(c_int), parameter :: SPFFT_TPU_INVALID_HANDLE_ERROR = 2
  integer(c_int), parameter :: SPFFT_TPU_OVERFLOW_ERROR = 3
  integer(c_int), parameter :: SPFFT_TPU_ALLOCATION_ERROR = 4
  integer(c_int), parameter :: SPFFT_TPU_INVALID_PARAMETER_ERROR = 5
  integer(c_int), parameter :: SPFFT_TPU_DUPLICATE_INDICES_ERROR = 6
  integer(c_int), parameter :: SPFFT_TPU_INVALID_INDICES_ERROR = 7
  integer(c_int), parameter :: SPFFT_TPU_DISTRIBUTED_SUPPORT_ERROR = 8
  integer(c_int), parameter :: SPFFT_TPU_DISTRIBUTED_ERROR = 9
  integer(c_int), parameter :: SPFFT_TPU_PARAMETER_MISMATCH_ERROR = 10
  integer(c_int), parameter :: SPFFT_TPU_HOST_EXECUTION_ERROR = 11
  integer(c_int), parameter :: SPFFT_TPU_FFT_ERROR = 12
  integer(c_int), parameter :: SPFFT_TPU_DEVICE_ERROR = 13
  integer(c_int), parameter :: SPFFT_TPU_DEVICE_PRECEDING_ERROR = 14
  integer(c_int), parameter :: SPFFT_TPU_DEVICE_SUPPORT_ERROR = 15
  integer(c_int), parameter :: SPFFT_TPU_DEVICE_ALLOCATION_ERROR = 16
  integer(c_int), parameter :: SPFFT_TPU_DEVICE_LAUNCH_ERROR = 17
  integer(c_int), parameter :: SPFFT_TPU_DEVICE_NO_DEVICE_ERROR = 18
  integer(c_int), parameter :: SPFFT_TPU_DEVICE_INVALID_VALUE_ERROR = 19
  integer(c_int), parameter :: SPFFT_TPU_DEVICE_INVALID_DEVICE_PTR_ERROR = 20
  integer(c_int), parameter :: SPFFT_TPU_DEVICE_COPY_ERROR = 21
  integer(c_int), parameter :: SPFFT_TPU_DEVICE_FFT_ERROR = 22
  integer(c_int), parameter :: SPFFT_TPU_RUNTIME_INIT_ERROR = 100

  ! Transform types (SpfftTpuTransformType)
  integer(c_int), parameter :: SPFFT_TPU_TRANS_C2C = 0
  integer(c_int), parameter :: SPFFT_TPU_TRANS_R2C = 1

  ! Scaling (SpfftTpuScalingType)
  integer(c_int), parameter :: SPFFT_TPU_NO_SCALING = 0
  integer(c_int), parameter :: SPFFT_TPU_FULL_SCALING = 1

  ! Precision (SpfftTpuPrecision)
  integer(c_int), parameter :: SPFFT_TPU_PREC_SINGLE = 0
  integer(c_int), parameter :: SPFFT_TPU_PREC_DOUBLE = 1

  ! Exchange algorithm (SpfftTpuExchangeType; reference types.h:33-62)
  integer(c_int), parameter :: SPFFT_TPU_EXCH_DEFAULT = 0
  integer(c_int), parameter :: SPFFT_TPU_EXCH_BUFFERED = 1
  integer(c_int), parameter :: SPFFT_TPU_EXCH_BUFFERED_FLOAT = 2
  integer(c_int), parameter :: SPFFT_TPU_EXCH_COMPACT_BUFFERED = 3
  integer(c_int), parameter :: SPFFT_TPU_EXCH_COMPACT_BUFFERED_FLOAT = 4
  integer(c_int), parameter :: SPFFT_TPU_EXCH_UNBUFFERED = 5

  ! z-stage route (SpfftTpuPallasMode): AUTO and ON the fused kernels,
  ! OFF the two-kernel route
  integer(c_int), parameter :: SPFFT_TPU_PALLAS_AUTO = -1
  integer(c_int), parameter :: SPFFT_TPU_PALLAS_OFF = 0
  integer(c_int), parameter :: SPFFT_TPU_PALLAS_ON = 1

  ! ABI version of the header these declarations mirror
  ! (include/spfft_tpu_torch.h SPFFT_TPU_ABI_VERSION)
  integer(c_int), parameter :: SPFFT_TPU_ABI_VERSION = 2

  interface

    integer(c_int) function spfft_tpu_abi_version() &
        bind(C, name="spfft_tpu_abi_version")
      use iso_c_binding
    end function

    integer(c_int) function spfft_tpu_init(package_path) &
        bind(C, name="spfft_tpu_init")
      use iso_c_binding
      type(c_ptr), value :: package_path
    end function

    integer(c_int) function spfft_tpu_plan_create(plan, transform_type, &
        dim_x, dim_y, dim_z, num_values, index_triplets, precision, &
        use_pallas) &
        bind(C, name="spfft_tpu_plan_create")
      use iso_c_binding
      type(c_ptr), intent(out) :: plan
      integer(c_int), value :: transform_type
      integer(c_int), value :: dim_x
      integer(c_int), value :: dim_y
      integer(c_int), value :: dim_z
      integer(c_long_long), value :: num_values
      integer(c_int), dimension(*), intent(in) :: index_triplets
      integer(c_int), value :: precision
      integer(c_int), value :: use_pallas
    end function

    integer(c_int) function spfft_tpu_plan_create_distributed(plan, &
        transform_type, dim_x, dim_y, dim_z, num_shards, values_per_shard, &
        index_triplets, planes_per_shard, precision, exchange_type, &
        use_pallas) &
        bind(C, name="spfft_tpu_plan_create_distributed")
      use iso_c_binding
      type(c_ptr), intent(out) :: plan
      integer(c_int), value :: transform_type
      integer(c_int), value :: dim_x
      integer(c_int), value :: dim_y
      integer(c_int), value :: dim_z
      integer(c_int), value :: num_shards
      integer(c_long_long), dimension(*), intent(in) :: values_per_shard
      integer(c_int), dimension(*), intent(in) :: index_triplets
      integer(c_int), dimension(*), intent(in) :: planes_per_shard
      integer(c_int), value :: precision
      integer(c_int), value :: exchange_type
      integer(c_int), value :: use_pallas
    end function

    integer(c_int) function spfft_tpu_plan_destroy(plan) &
        bind(C, name="spfft_tpu_plan_destroy")
      use iso_c_binding
      type(c_ptr), value :: plan
    end function

    integer(c_int) function spfft_tpu_backward(plan, values, space) &
        bind(C, name="spfft_tpu_backward")
      use iso_c_binding
      type(c_ptr), value :: plan
      type(c_ptr), value :: values
      type(c_ptr), value :: space
    end function

    integer(c_int) function spfft_tpu_forward(plan, space, scaling, values) &
        bind(C, name="spfft_tpu_forward")
      use iso_c_binding
      type(c_ptr), value :: plan
      type(c_ptr), value :: space
      integer(c_int), value :: scaling
      type(c_ptr), value :: values
    end function

    !> Backward+forward round trip with the space domain kept on the
    !> card (the benchmark pair / SCF inner loop); values_out may equal
    !> values_in.
    integer(c_int) function spfft_tpu_execute_pair(plan, values_in, &
        scaling, values_out) bind(C, name="spfft_tpu_execute_pair")
      use iso_c_binding
      type(c_ptr), value :: plan
      type(c_ptr), value :: values_in
      integer(c_int), value :: scaling
      type(c_ptr), value :: values_out
    end function

    integer(c_int) function spfft_tpu_plan_dim_x(plan, out) &
        bind(C, name="spfft_tpu_plan_dim_x")
      use iso_c_binding
      type(c_ptr), value :: plan
      integer(c_int), intent(out) :: out
    end function

    integer(c_int) function spfft_tpu_plan_dim_y(plan, out) &
        bind(C, name="spfft_tpu_plan_dim_y")
      use iso_c_binding
      type(c_ptr), value :: plan
      integer(c_int), intent(out) :: out
    end function

    integer(c_int) function spfft_tpu_plan_dim_z(plan, out) &
        bind(C, name="spfft_tpu_plan_dim_z")
      use iso_c_binding
      type(c_ptr), value :: plan
      integer(c_int), intent(out) :: out
    end function

    integer(c_int) function spfft_tpu_plan_num_values(plan, out) &
        bind(C, name="spfft_tpu_plan_num_values")
      use iso_c_binding
      type(c_ptr), value :: plan
      integer(c_long_long), intent(out) :: out
    end function

    integer(c_int) function spfft_tpu_plan_transform_type(plan, out) &
        bind(C, name="spfft_tpu_plan_transform_type")
      use iso_c_binding
      type(c_ptr), value :: plan
      integer(c_int), intent(out) :: out
    end function

    integer(c_int) function spfft_tpu_plan_num_shards(plan, out) &
        bind(C, name="spfft_tpu_plan_num_shards")
      use iso_c_binding
      type(c_ptr), value :: plan
      integer(c_int), intent(out) :: out
    end function

    integer(c_int) function spfft_tpu_multi_backward(num_transforms, &
        plans, values, spaces) bind(C, name="spfft_tpu_multi_backward")
      use iso_c_binding
      integer(c_int), value :: num_transforms
      type(c_ptr), dimension(*), intent(in) :: plans
      type(c_ptr), dimension(*), intent(in) :: values
      type(c_ptr), dimension(*), intent(in) :: spaces
    end function

    integer(c_int) function spfft_tpu_multi_forward(num_transforms, &
        plans, spaces, scaling, values) &
        bind(C, name="spfft_tpu_multi_forward")
      use iso_c_binding
      integer(c_int), value :: num_transforms
      type(c_ptr), dimension(*), intent(in) :: plans
      type(c_ptr), dimension(*), intent(in) :: spaces
      integer(c_int), value :: scaling
      type(c_ptr), dimension(*), intent(in) :: values
    end function

    integer(c_int) function spfft_tpu_plan_global_size(plan, out) &
        bind(C, name="spfft_tpu_plan_global_size")
      use iso_c_binding
      type(c_ptr), value :: plan
      integer(c_long_long), intent(out) :: out
    end function

    integer(c_int) function spfft_tpu_plan_num_global_elements(plan, out) &
        bind(C, name="spfft_tpu_plan_num_global_elements")
      use iso_c_binding
      type(c_ptr), value :: plan
      integer(c_long_long), intent(out) :: out
    end function

    integer(c_int) function spfft_tpu_plan_local_z_offset(plan, shard, &
        out) bind(C, name="spfft_tpu_plan_local_z_offset")
      use iso_c_binding
      type(c_ptr), value :: plan
      integer(c_int), value :: shard
      integer(c_int), intent(out) :: out
    end function

    integer(c_int) function spfft_tpu_plan_local_z_length(plan, shard, &
        out) bind(C, name="spfft_tpu_plan_local_z_length")
      use iso_c_binding
      type(c_ptr), value :: plan
      integer(c_int), value :: shard
      integer(c_int), intent(out) :: out
    end function

    integer(c_int) function spfft_tpu_plan_local_slice_size(plan, shard, &
        out) bind(C, name="spfft_tpu_plan_local_slice_size")
      use iso_c_binding
      type(c_ptr), value :: plan
      integer(c_int), value :: shard
      integer(c_long_long), intent(out) :: out
    end function

    integer(c_int) function spfft_tpu_plan_num_local_elements(plan, &
        shard, out) bind(C, name="spfft_tpu_plan_num_local_elements")
      use iso_c_binding
      type(c_ptr), value :: plan
      integer(c_int), value :: shard
      integer(c_long_long), intent(out) :: out
    end function

    integer(c_int) function spfft_tpu_plan_exchange_type(plan, out) &
        bind(C, name="spfft_tpu_plan_exchange_type")
      use iso_c_binding
      type(c_ptr), value :: plan
      integer(c_int), intent(out) :: out
    end function

    integer(c_int) function spfft_tpu_plan_pallas_active(plan, out) &
        bind(C, name="spfft_tpu_plan_pallas_active")
      use iso_c_binding
      type(c_ptr), value :: plan
      integer(c_int), intent(out) :: out
    end function

  end interface

end module spfft_tpu_torch
