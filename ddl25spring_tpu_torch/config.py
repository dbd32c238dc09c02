"""Model configuration: the port's own copy of ``LlamaConfig``.

Same fields and defaults as the JAX package's ``config.LlamaConfig`` (the
canonical tiny-Llama: vocab 32000, dmodel 288, 6 heads of dim 48, 6
layers, ctx 256), so a config built for one package means the same model
in the other.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class LlamaConfig:
    """tiny-Llama model configuration."""

    vocab_size: int = 32000
    dmodel: int = 288
    num_heads: int = 6
    n_layers: int = 6
    ctx_size: int = 256
    ffn_hidden: Optional[int] = None   # None -> 4 * dmodel (SwiGLU-gated)
    padding_idx: Optional[int] = None
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    dtype: str = "float32"             # computation dtype
    param_dtype: str = "float32"
    # Attention backend: "xla" is the plain PyTorch attention; "pallas" is
    # the hand-written CUDA flash kernel (ops/flash_attention.py) and raises
    # on CPU tensors; "auto" takes the kernel iff the tensors are on CUDA
    # and the sequence is at least ``flash_min_seq`` long.
    attention_impl: str = "auto"
    flash_min_seq: int = 256
    # Kernel operand layout: [B·H, Dh, T] when True, else [B, T, H, Dh] as
    # given. The CUDA kernel reads either through strides.
    flash_dh_major: bool = True
    # Block-size cap handed to flash_attention for signature parity; the
    # CUDA kernel picks its own tiles.
    flash_block: int = 512
    # Dtype of the materialized [B·H, T, T] score tensor on the plain path.
    softmax_dtype: str = "float32"
    # Activation rematerialization in the backward: a training option,
    # carried for parity (the inference slice has no backward).
    remat: bool = False

    @property
    def head_dim(self) -> int:
        if self.dmodel % self.num_heads:
            raise ValueError(f"dmodel={self.dmodel} is not a multiple of "
                             f"num_heads={self.num_heads}")
        return self.dmodel // self.num_heads

    @property
    def ffn_dim(self) -> int:
        return self.ffn_hidden if self.ffn_hidden is not None else 4 * self.dmodel

    def replace(self, **kw) -> "LlamaConfig":
        return dataclasses.replace(self, **kw)


def torch_dtype(name: str) -> torch.dtype:
    """``"float32"`` / ``"bfloat16"`` / ... -> the torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt
