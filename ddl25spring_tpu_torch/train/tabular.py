"""Centralized tabular training, the heart-disease classifier baseline:
counterpart of the JAX package's ``train/tabular.py``.

Minibatch Adam on the tabular MLP (dropout live while training), the
test set evaluated every epoch with dropout off, and the parameters of
the best epoch by test accuracy kept (a strict ``>``, so a tie keeps the
earlier epoch). Also the evaluator of the synthetic-data protocol
(``train/generative.py``): the same trainer on another training set.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Tuple

import numpy as np
import torch

from .. import rng
from ..device import resolve_device
from ..models import tabular
from ..ops.adam import apply_optimizer, fused_adam
from ..ops.losses import cross_entropy_loss
from ..tree import tree_map, trainable, value_and_grad
from .batching import pad_batches


@dataclass
class ClassifierReport:
    train_losses: List[float] = field(default_factory=list)   # per epoch
    test_accuracies: List[float] = field(default_factory=list)
    best_accuracy: float = 0.0
    best_epoch: int = -1


def train_classifier(x_train: np.ndarray, y_train: np.ndarray,
                     x_test: np.ndarray, y_test: np.ndarray, *,
                     epochs: int = 200, batch_size: int = 64, lr: float = 1e-3,
                     hidden=(64, 128, 256), seed: int = 0,
                     log_every: int = 0,
                     log_fn: Callable[[str], None] = print,
                     device=None) -> Tuple[list, ClassifierReport]:
    """Returns ``(best_params, report)``. The initial parameters are
    ``tabular.init`` drawn from a CPU generator seeded ``seed`` (the same
    on every device); dropout draws from a generator on the device seeded
    ``seed + 1``."""
    dev = resolve_device(device)
    in_dim = int(x_train.shape[1])
    params = trainable(tabular.init(rng.generator(seed), in_dim, hidden,
                                    device=dev))
    optimizer = fused_adam(lr)
    opt_state = optimizer.init(params)

    (xb,), yb, mb = pad_batches([np.asarray(x_train, np.float32)],
                                np.asarray(y_train, np.int64), batch_size,
                                dev)
    n = mb.sum()
    xt = torch.as_tensor(np.asarray(x_test, np.float32), device=dev)
    yt = torch.as_tensor(np.asarray(y_test, np.int64), device=dev)
    dropout = rng.generator(seed + 1, dev)

    report = ClassifierReport()
    with torch.no_grad():
        best_params = tree_map(torch.clone, params)
        for epoch in range(epochs):
            loss_sum = torch.zeros((), device=dev)
            for b in range(yb.shape[0]):
                x, y, m = xb[b], yb[b], mb[b]
                loss, grads = value_and_grad(lambda p: cross_entropy_loss(
                    tabular.apply(p, x, generator=dropout), y, m), params)
                params, opt_state = apply_optimizer(optimizer, grads,
                                                    opt_state, params)
                loss_sum += loss.detach() * m.sum()
            acc = (tabular.apply(params, xt).argmax(-1) == yt).float().mean()
            acc = float(acc)
            report.train_losses.append(float(loss_sum / n))
            report.test_accuracies.append(acc)
            if acc > report.best_accuracy:
                report.best_accuracy, report.best_epoch = acc, epoch
                best_params = tree_map(torch.clone, params)
            if log_every and epoch % log_every == 0:
                log_fn(f"epoch {epoch}: loss {report.train_losses[-1]:.4f} "
                       f"test acc {acc:.4f}")
    return best_params, report
