"""Byzantine client attacks: counterpart of the JAX package's
``fl/attacks.py``.

- ``GradientReversion``: return −scale·Δ.
- ``PartialGradientReversion``: flip the leading ``fraction`` of the
  flattened Δ (sorted-key leaf order: conv1's bias first) by ×(−factor).
- ``UntargetedLabelFlip``: train on (y+1) mod 10, return scale·Δ.
- ``TargetedLabelFlip``: flip source-class labels to the target class,
  return scale·Δ.
- ``PatternBackdoor``: stamp a 5×3 pattern at (3, 23) with an extreme
  pixel value into a proportion of each client's samples, relabel them to
  the backdoor label, return scale·Δ.

Protocol, on one client (``FedAvgGradServer`` applies it to the malicious
ones): ``poisons_data``; ``poison(x, y, generator) -> (x, y)`` on the
client's padded subset; ``transform(delta, params) -> delta`` on its Δ
tree.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..tree import flatten, tree_scale


class Attack:
    poisons_data: bool = False

    def poison(self, x, y, generator):
        return x, y

    def transform(self, delta: dict, params: dict) -> dict:
        return delta


@dataclass
class GradientReversion(Attack):
    """Return −scale·Δ."""
    scale: float = 5.0
    poisons_data = False

    def transform(self, delta, params):
        return tree_scale(delta, -self.scale)


@dataclass
class PartialGradientReversion(Attack):
    """Flip a tiny leading slice of the flattened update by ×(−factor):
    large damage, small L2 displacement, which evades Krum-style distance
    filtering."""
    factor: float = 1000.0
    fraction: float = 1e-5
    poisons_data = False

    def transform(self, delta, params):
        flat, unflatten = flatten(delta)
        k = max(1, int(flat.shape[0] * self.fraction))
        flat = flat.clone()
        flat[:k] *= -self.factor
        return unflatten(flat)


@dataclass
class UntargetedLabelFlip(Attack):
    """Labels become (y+1) mod num_classes; update scaled."""
    num_classes: int = 10
    scale: float = 5.0
    poisons_data = True

    def poison(self, x, y, generator):
        return x, (y + 1) % self.num_classes

    def transform(self, delta, params):
        return tree_scale(delta, self.scale)


@dataclass
class TargetedLabelFlip(Attack):
    """Only source-class labels flip to the target class; update scaled."""
    source: int = 0
    target: int = 6
    scale: float = 5.0
    poisons_data = True

    def poison(self, x, y, generator):
        return x, torch.where(y == self.source, self.target, y)

    def transform(self, delta, params):
        return tree_scale(delta, self.scale)


@dataclass
class PatternBackdoor(Attack):
    """Pixel-pattern backdoor: stamp ``pattern_value`` (in normalized
    space, far outside MNIST's range) into a ``proportion`` of the client's
    samples and relabel them ``backdoor_label``; scale the update."""
    proportion: float = 0.3
    backdoor_label: int = 0
    scale: float = 2.0
    row: int = 3
    col: int = 23
    height: int = 5
    width: int = 3
    pattern_value: float = -10.0
    poisons_data = True

    def _stamp(self, x) -> torch.Tensor:
        """x: [..., 28, 28] (NCHW, normalized), numpy or a tensor; a
        stamped copy."""
        x = torch.as_tensor(x).clone()
        x[..., self.row:self.row + self.height,
          self.col:self.col + self.width] = self.pattern_value
        return x

    def poison(self, x, y, generator):
        """Each sample poisoned with probability ``proportion`` (a uniform
        draw from ``generator`` below it)."""
        poisoned = torch.rand(y.shape, generator=generator,
                              device=generator.device) < self.proportion
        x = torch.where(poisoned[:, None, None, None], self._stamp(x), x)
        y = torch.where(poisoned, self.backdoor_label, y)
        return x, y

    def transform(self, delta, params):
        return tree_scale(delta, self.scale)

    def trigger_test_set(self, x) -> torch.Tensor:
        """Fully-triggered copy of a test set, for the attack success
        rate."""
        return self._stamp(x)


def injection_mask(nr_clients: int, fraction: float, seed: int) -> np.ndarray:
    """Mark ``int(fraction · nr_clients)`` random clients malicious (numpy
    ``default_rng(seed)``: the JAX package's mask for the same seed)."""
    rng = np.random.default_rng(seed)
    n_mal = int(fraction * nr_clients)
    mask = np.zeros(nr_clients, dtype=bool)
    mask[rng.choice(nr_clients, n_mal, replace=False)] = True
    return mask
