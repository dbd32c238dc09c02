"""Generative modeling: VAE training and the synthetic-data evaluation
protocol, counterpart of the JAX package's ``train/generative.py``.

- ``train_vae``: minibatch Adam on the BatchNorm-MLP VAE with the summed
  squared error + KL loss. BatchNorm needs full batches, so the remainder
  is dropped (a training set smaller than a batch is one batch).
- ``synthetic_data_eval``: one VAE per class; each draws as many rows as
  its class has (from a generator seeded ``seed + label``) and labels
  them with its class; one evaluator classifier trains on the real rows
  and one on the synthetic rows, both scored on the same real test set.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from .. import rng
from ..config import VAEConfig
from ..device import resolve_device
from ..models import vae
from ..ops.adam import apply_optimizer, fused_adam
from ..tree import tree_map, trainable, value_and_grad
from .tabular import ClassifierReport, train_classifier


@dataclass
class VAEReport:
    total_losses: List[float] = field(default_factory=list)   # per epoch means
    mse_losses: List[float] = field(default_factory=list)
    kld_losses: List[float] = field(default_factory=list)


def train_vae(x_train: np.ndarray, cfg: Optional[VAEConfig] = None, *,
              log_every: int = 0, log_fn: Callable[[str], None] = print,
              device=None) -> Tuple[dict, dict, VAEReport]:
    """Train the VAE; returns ``(params, batchnorm_state, report)``. The
    initial parameters are ``vae.init`` drawn from a CPU generator seeded
    ``cfg.seed``; the reparameterization noise comes from a generator on
    the device seeded ``cfg.seed + 1``."""
    dev = resolve_device(device)
    cfg = cfg or VAEConfig(input_dim=int(x_train.shape[1]))
    params, state = vae.init(rng.generator(cfg.seed), cfg, device=dev)
    params = trainable(params)
    optimizer = fused_adam(cfg.lr)
    opt_state = optimizer.init(params)

    n = x_train.shape[0]
    bs = min(cfg.batch_size, n)
    n_batches = n // bs
    xb = torch.as_tensor(np.asarray(x_train[:n_batches * bs], np.float32)
                         .reshape(n_batches, bs, -1), device=dev)
    noise = rng.generator(cfg.seed + 1, dev)

    def loss_fn(p, x, st):
        recon, mu, logvar, new_state = vae.apply(p, st, x, noise, train=True)
        total, mse, kld = vae.loss_fn(recon, x, mu, logvar)
        return total, (mse, kld, new_state)

    epochs = []
    report = VAEReport()
    with torch.no_grad():
        for epoch in range(cfg.epochs):
            per_batch = []
            for b in range(n_batches):
                (total, (mse, kld, state)), grads = value_and_grad(
                    lambda p: loss_fn(p, xb[b], state), params, has_aux=True)
                params, opt_state = apply_optimizer(optimizer, grads,
                                                    opt_state, params)
                per_batch.append(torch.stack([total.detach(), mse, kld]))
            epochs.append(torch.stack(per_batch).mean(0))
            if log_every and epoch % log_every == 0:
                tot, mse, kld = epochs[-1].tolist()
                log_fn(f"epoch {epoch}: loss {tot:.2f} (mse {mse:.2f} "
                       f"kld {kld:.2f})")
        for tot, mse, kld in torch.stack(epochs).tolist():
            report.total_losses.append(tot)
            report.mse_losses.append(mse)
            report.kld_losses.append(kld)
    return tree_map(torch.Tensor.detach, params), state, report


@dataclass
class SyntheticEvalResult:
    real_accuracy: float
    synthetic_accuracy: float
    vae_reports: List[VAEReport] = field(default_factory=list)
    # The real-trained and the synthetic-trained evaluator's reports.
    evaluator_reports: List[ClassifierReport] = field(default_factory=list)


def synthetic_data_eval(x_train: np.ndarray, y_train: np.ndarray,
                        x_test: np.ndarray, y_test: np.ndarray,
                        cfg: Optional[VAEConfig] = None, *,
                        evaluator_epochs: int = 200, seed: int = 0,
                        device=None) -> SyntheticEvalResult:
    """The real-vs-synthetic protocol on a binary tabular task."""
    dev = resolve_device(device)
    cfg = cfg or VAEConfig(input_dim=int(x_train.shape[1]))
    synth_x, synth_y, reports = [], [], []
    for label in np.unique(y_train):
        rows = x_train[y_train == label]
        params, state, rep = train_vae(rows, cfg, device=dev)
        reports.append(rep)
        with torch.no_grad():
            out = vae.sample(rng.generator(seed + int(label), dev), params,
                             state, len(rows), cfg.latent_dim)
        synth_x.append(out.cpu().numpy())
        synth_y.append(np.full(len(rows), label, y_train.dtype))
    synth_x = np.concatenate(synth_x)
    synth_y = np.concatenate(synth_y)

    _, real_rep = train_classifier(x_train, y_train, x_test, y_test,
                                   epochs=evaluator_epochs, seed=seed,
                                   device=dev)
    _, synth_rep = train_classifier(synth_x, synth_y, x_test, y_test,
                                    epochs=evaluator_epochs, seed=seed,
                                    device=dev)
    return SyntheticEvalResult(real_rep.best_accuracy,
                               synth_rep.best_accuracy, reports,
                               [real_rep, synth_rep])
