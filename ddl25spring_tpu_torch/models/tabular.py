"""Tabular classifier for the heart-disease task: counterpart of the JAX
package's ``models/tabular.py``, on the same parameter tree.

A list of dense layers ``[in, 64, 128, 256, 2]`` (the defaults) with
LeakyReLU between them and dropout(0.1) before the last layer. Dropout is
live iff a ``generator`` (or a precomputed ``keep`` mask) is given;
evaluation passes neither and is deterministic.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .. import nn
from ..device import resolve_device

NUM_CLASSES = 2
DROPOUT = 0.1


def init(generator: torch.Generator, in_dim: int = 30,
         hidden: Sequence[int] = (64, 128, 256), device=None) -> list:
    """Layer stack ``[in, *hidden, 2]``, drawn from ``generator`` in layer
    order and moved to ``device``."""
    return nn.mlp_init(generator, [in_dim, *hidden, NUM_CLASSES],
                       device=resolve_device(device))


def apply(params: list, x: torch.Tensor, *,
          generator: Optional[torch.Generator] = None,
          keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [B, in_dim] -> logits [B, 2]."""
    for layer in params[:-1]:
        x = nn.leaky_relu(nn.dense(layer, x))
    x = nn.dropout(x, DROPOUT, generator=generator, keep=keep)
    return nn.dense(params[-1], x)
