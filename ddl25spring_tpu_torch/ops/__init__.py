"""Kernels and their plain PyTorch versions (``flash_attention``,
``pallas_adam``), the plain ops around them (``losses``, ``adam``), and the
builder that compiles the CUDA sources under ``csrc/`` (``_ext``)."""
