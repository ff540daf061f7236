"""Hand-written CUDA kernels of the PyTorch port and their wrappers."""
from .flash_attention import (decode_attention, flash_attention,
                              launch_counts, paged_decode_attention,
                              paged_verify_decode_attention,
                              reset_launch_counts, verify_decode_attention)

__all__ = ["flash_attention", "decode_attention", "paged_decode_attention",
           "verify_decode_attention", "paged_verify_decode_attention",
           "launch_counts", "reset_launch_counts"]
