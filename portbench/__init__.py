"""The benchmark of spfft_tpu_torch on one NVIDIA H100 (``run.py``)."""
