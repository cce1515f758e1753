"""Pipeline stages and kernels of spfft_tpu_torch."""
