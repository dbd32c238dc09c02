"""Host-side minibatching: counterpart of the JAX package's
``train/batching.py``. The remainder is zero-padded to a whole batch and
masked, not dropped, so losses and accuracies weighted by the mask count
every row once."""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch


def pad_batches(arrays: Sequence[np.ndarray], y: np.ndarray, batch_size: int,
                device: torch.device
                ) -> Tuple[tuple, torch.Tensor, torch.Tensor]:
    """Reshape each array (and the labels) to ``[n_batches, batch_size,
    ...]`` on ``device``. Returns ``(xs, y_batched, mask)``: ``xs`` one
    tensor per input array (VFL passes one per party), ``mask`` 1.0 on
    real rows."""
    n = y.shape[0]
    n_batches = math.ceil(n / batch_size)
    pad = n_batches * batch_size - n
    def pad_reshape(a):
        a = np.concatenate([a, np.zeros((pad, *a.shape[1:]), a.dtype)])
        return torch.from_numpy(np.ascontiguousarray(
            a.reshape(n_batches, batch_size, *a.shape[1:]))).to(device)

    xs = tuple(pad_reshape(a) for a in arrays)
    return xs, pad_reshape(y), pad_reshape(np.ones(n, np.float32))
