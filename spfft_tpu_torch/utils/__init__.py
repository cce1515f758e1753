"""Host-side helpers of spfft_tpu_torch."""
