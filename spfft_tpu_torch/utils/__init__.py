"""Host-side helpers of spfft_tpu_torch: the interleaved-real <-> complex
boundary and the precision names, re-exported as the JAX package's
``spfft_tpu.utils`` re-exports them."""

from .dtypes import (as_complex_np, as_interleaved, complex_dtype,
                     complex_to_interleaved, interleaved_to_complex,
                     real_dtype)

__all__ = ["as_complex_np", "as_interleaved", "complex_dtype",
           "interleaved_to_complex", "complex_to_interleaved", "real_dtype"]
