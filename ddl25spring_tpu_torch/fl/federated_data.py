"""Client-axis data layout for federated learning: counterpart of the JAX
package's ``fl/federated_data.py``.

Every client's subset is stacked along a leading client axis, padded to
the largest subset and masked: ``x [N, S, ...]``, ``y [N, S]`` (int64),
``mask [N, S]`` (1.0 for real samples), ``sample_counts [N]`` (the true
sizes, FedAvg's weights). The tensors live on one device, once; a round
gathers its sampled clients by index there.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device


@dataclass
class FederatedDataset:
    x: torch.Tensor              # [N, S, ...] padded client inputs
    y: torch.Tensor              # [N, S] padded labels (int64)
    mask: torch.Tensor           # [N, S] 1.0 for real samples, 0.0 padding
    sample_counts: torch.Tensor  # [N] true subset sizes (int64)

    @property
    def nr_clients(self) -> int:
        return self.x.shape[0]

    def to(self, device) -> "FederatedDataset":
        return FederatedDataset(*(t.to(device) for t in (
            self.x, self.y, self.mask, self.sample_counts)))


def federate(x: np.ndarray, y: np.ndarray, subsets: Sequence[np.ndarray],
             device=None) -> FederatedDataset:
    """Stack per-client index subsets into the padded client-axis layout
    on ``device`` (built in numpy, copied once)."""
    dev = resolve_device(device)
    n = len(subsets)
    s_max = max(len(s) for s in subsets)
    xs = np.zeros((n, s_max) + x.shape[1:], dtype=x.dtype)
    ys = np.zeros((n, s_max), dtype=np.int64)
    mask = np.zeros((n, s_max), dtype=np.float32)
    counts = np.zeros((n,), dtype=np.int64)
    for i, idx in enumerate(subsets):
        k = len(idx)
        xs[i, :k] = x[idx]
        ys[i, :k] = y[idx]
        mask[i, :k] = 1.0
        counts[i] = k
    return FederatedDataset(*(torch.from_numpy(a).to(dev)
                              for a in (xs, ys, mask, counts)))
