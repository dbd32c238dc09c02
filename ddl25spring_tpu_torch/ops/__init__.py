"""Kernels and their plain PyTorch versions (``flash_attention``) plus the
builder that compiles the CUDA sources under ``csrc/`` (``_ext``)."""
