"""MNIST CNN, the horizontal-FL model: counterpart of the JAX package's
``models/mnist_cnn.py``, on the same parameter tree.

conv1(1→32, 3) → relu → conv2(32→64, 3) → relu → maxpool(2) →
dropout(0.25) → flatten (64·12·12 = 9216, in C·H·W order) →
fc1(9216→128) → relu → dropout(0.5) → fc2(128→10) → logits. Inputs are
NCHW ``[B, 1, 28, 28]``, normalized. Tree: ``conv1``/``conv2`` with
``w [O, I, 3, 3]`` and ``b``; ``fc1``/``fc2`` with ``w [in, out]`` and
``b``; 1,199,882 parameters.

Dropout is live iff ``dropout`` is given: a ``torch.Generator`` to draw
from, or the pair of keep-masks ``dropout_masks`` draws (the form
``torch.func.vmap`` needs, since a generator cannot be batched).
``apply.dropout_masks`` names the mask maker, which the FL local solvers
look for: an ``apply_fn`` without it trains with dropout off.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

from .. import nn
from ..device import resolve_device

NUM_CLASSES = 10
RATES = (0.25, 0.5)            # after the pool, after fc1
_SHAPES = ((64, 12, 12), (128,))


def init(generator: torch.Generator, device=None) -> dict:
    """Kaiming-uniform parameters in the JAX init's layout, drawn from
    ``generator`` (on its own device) in a fixed order, then moved to
    ``device``. To compare with the JAX package, convert its init with
    ``convert.mnist_params_from_jax``."""
    dev = resolve_device(device)
    return {
        "conv1": nn.conv2d_init(generator, 1, 32, 3, device=dev),
        "conv2": nn.conv2d_init(generator, 32, 64, 3, device=dev),
        "fc1": nn.dense_init(generator, 64 * 12 * 12, 128, device=dev),
        "fc2": nn.dense_init(generator, 128, NUM_CLASSES, device=dev),
    }


def dropout_masks(generator: torch.Generator, batch: Sequence[int]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two keep-masks of one forward over ``batch`` leading dims
    (``[*batch, 64, 12, 12]`` and ``[*batch, 128]``), drawn in that order
    on the generator's device."""
    return tuple(nn.dropout_keep(generator, (*batch, *shape), rate)
                 for rate, shape in zip(RATES, _SHAPES))


Dropout = Union[None, torch.Generator, Tuple[torch.Tensor, torch.Tensor]]


def apply(params: dict, x: torch.Tensor, *, dropout: Dropout = None
          ) -> torch.Tensor:
    """x: [B, 1, 28, 28] -> logits [B, 10]."""
    if isinstance(dropout, torch.Generator):
        dropout = dropout_masks(dropout, x.shape[:1])
    keep1, keep2 = dropout if dropout is not None else (None, None)
    h = nn.relu(nn.conv2d(params["conv1"], x))
    h = nn.relu(nn.conv2d(params["conv2"], h))
    h = nn.max_pool2d(h)
    h = nn.dropout(h, RATES[0], keep=keep1)
    h = h.reshape(h.shape[0], -1)
    h = nn.relu(nn.dense(params["fc1"], h))
    h = nn.dropout(h, RATES[1], keep=keep2)
    return nn.dense(params["fc2"], h)


apply.dropout_masks = dropout_masks

