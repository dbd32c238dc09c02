"""Vertical-FL / split-learning trainers: counterpart of the JAX package's
``train/vfl.py``.

- ``train_vfl``: joint training of the parties' bottom models and the
  server's top model over vertically partitioned features, minibatch by
  minibatch (the tail padded and masked), train loss and accuracy per
  epoch, test accuracy at the end.
- ``train_vfl_vae``: the homework-2 VFL-VAE hybrid, full batch per epoch
  with fresh reparameterization noise.

``train_vfl`` has the JAX trainer's two modes. By default every parameter
trains on each minibatch's own gradient with Adam and evaluation runs with
dropout off. ``faithful=True`` reproduces the four quirks of the reference
protocol, each of which a keyword toggles alone (None follows
``faithful``):
  ``train_bottoms=False``: the bottoms get gradients but are never
  stepped (their updates are zeroed, so no weight decay reaches them);
  ``weight_decay``: AdamW's decoupled decay (1e-2 when faithful);
  ``accumulate_epoch_grads``: gradients are zeroed once per epoch, so
  step k applies the sum of the epoch's gradients 1..k;
  ``eval_dropout``: the reported test accuracy is one draw with dropout
  on. ``report.test_accuracy_clean`` is always the dropout-off number.
Dropout is always live while training.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import rng
from ..config import VFLConfig
from ..device import resolve_device
from ..models import vfl_nets
from ..ops.adam import adamw, apply_optimizer, apply_updates, fused_adam
from ..ops.losses import cross_entropy_loss
from ..tree import tree_leaves, tree_map, tree_unflatten, trainable, \
    value_and_grad
from .batching import pad_batches


@dataclass
class VFLReport:
    train_losses: List[float] = field(default_factory=list)   # per epoch
    train_accuracies: List[float] = field(default_factory=list)
    test_accuracy: float = 0.0        # under the trainer's own eval protocol
    test_accuracy_clean: float = 0.0  # always dropout-off (intended eval)


def train_vfl(xs_train: Sequence[np.ndarray], y_train: np.ndarray,
              xs_test: Sequence[np.ndarray], y_test: np.ndarray,
              cfg: Optional[VFLConfig] = None, *,
              faithful: bool = False,
              train_bottoms: Optional[bool] = None,
              accumulate_epoch_grads: Optional[bool] = None,
              eval_dropout: Optional[bool] = None,
              weight_decay: Optional[float] = None,
              log_every: int = 0,
              log_fn: Callable[[str], None] = print,
              device=None) -> Tuple[dict, VFLReport]:
    """Jointly train bottoms and top; ``xs_train[i]`` is party i's feature
    slice ``[N, d_i]``. Returns the trained parameters and the report.
    The initial parameters are ``vfl_nets.init_vfl`` drawn from a CPU
    generator seeded ``cfg.seed``; dropout draws from a generator on the
    device seeded ``cfg.seed + 1`` (the dropout evaluation from one seeded
    ``cfg.seed + 2``)."""
    dev = resolve_device(device)
    cfg = cfg or VFLConfig()
    bottoms_train = ((not faithful) if train_bottoms is None
                     else train_bottoms)
    accumulate = (faithful if accumulate_epoch_grads is None
                  else accumulate_epoch_grads)
    drop_eval = faithful if eval_dropout is None else eval_dropout
    wd = (1e-2 if faithful else 0.0) if weight_decay is None else weight_decay

    feature_dims = [int(a.shape[1]) for a in xs_train]
    params = trainable(vfl_nets.init_vfl(
        rng.generator(cfg.seed), feature_dims,
        bottom_out_mult=cfg.bottom_out_mult, device=dev))
    optimizer = adamw(cfg.lr, weight_decay=wd)
    opt_state = optimizer.init(params)
    # The leaves that take their updates: all, or the top model's alone.
    stepped = params if bottoms_train else {"top": params["top"]}

    xs_b, y_b, m_b = pad_batches(
        [np.asarray(a, np.float32) for a in xs_train],
        np.asarray(y_train, np.int64), cfg.batch_size, dev)
    n = m_b.sum()
    dropout = rng.generator(cfg.seed + 1, dev)

    def loss_fn(p, xs, y, m):
        logits = vfl_nets.vfl_forward(p, xs, generator=dropout)
        return cross_entropy_loss(logits, y, m), logits

    epochs = []
    report = VFLReport()
    with torch.no_grad():
        for epoch in range(cfg.epochs):
            loss_sum = torch.zeros((), device=dev)
            correct = torch.zeros((), device=dev)
            accum = None
            for b in range(y_b.shape[0]):
                xs, y, m = [x[b] for x in xs_b], y_b[b], m_b[b]
                (loss, logits), grads = value_and_grad(
                    lambda p: loss_fn(p, xs, y, m), params, has_aux=True)
                if accumulate:
                    # Step k applies the running sum of the epoch's
                    # gradients 1..k.
                    accum = (tree_leaves(grads) if accum is None else
                             torch._foreach_add(accum, tree_leaves(grads)))
                    grads = tree_unflatten(params, accum)
                updates, opt_state = optimizer.update(grads, opt_state,
                                                      params)
                if not bottoms_train:
                    updates = {"top": updates["top"]}
                apply_updates(stepped, updates)
                loss_sum += loss.detach() * m.sum()
                correct += ((logits.argmax(-1) == y) * m).sum()
            epochs.append(torch.stack([loss_sum / n, correct / n]))
            if log_every and epoch % log_every == 0:
                loss_e, acc_e = epochs[-1].tolist()
                log_fn(f"epoch {epoch}: loss {loss_e:.4f} acc {acc_e:.4f}")
        for loss_e, acc_e in torch.stack(epochs).tolist():
            report.train_losses.append(loss_e)
            report.train_accuracies.append(acc_e)

        xs_te = [torch.as_tensor(np.asarray(a, np.float32), device=dev)
                 for a in xs_test]
        y_te = torch.as_tensor(np.asarray(y_test, np.int64), device=dev)

        def test_acc(generator=None):
            logits = vfl_nets.vfl_forward(params, xs_te, generator=generator)
            return float((logits.argmax(-1) == y_te).float().mean())

        report.test_accuracy_clean = test_acc()
        # One draw with dropout on: what the reference reports.
        report.test_accuracy = (test_acc(rng.generator(cfg.seed + 2, dev))
                                if drop_eval else report.test_accuracy_clean)
    return tree_map(torch.Tensor.detach, params), report


# ------------------------------------------------------------- VFL-VAE hybrid

@dataclass
class VFLVAEReport:
    total_losses: List[float] = field(default_factory=list)   # per epoch
    recon_losses: List[float] = field(default_factory=list)
    kl_losses: List[float] = field(default_factory=list)


def train_vfl_vae(xs_train: Sequence[np.ndarray],
                  cfg: Optional[VFLConfig] = None, *,
                  epochs: int = 1000,
                  client_latent: int = 4,
                  log_every: int = 0,
                  log_fn: Callable[[str], None] = print,
                  device=None) -> Tuple[dict, VFLVAEReport]:
    """Train the VFL-VAE on vertically partitioned features, every party's
    encoder and decoder and the server VAE, full batch per epoch. The
    initial parameters are ``vfl_nets.init_vfl_vae`` drawn from a CPU
    generator seeded ``cfg.seed``; the reparameterization noise comes from
    a generator on the device seeded ``cfg.seed + 1``."""
    dev = resolve_device(device)
    cfg = cfg or VFLConfig()
    feature_dims = [int(a.shape[1]) for a in xs_train]
    params = vfl_nets.init_vfl_vae(rng.generator(cfg.seed), feature_dims,
                                   client_latent=client_latent, device=dev)
    # client_latent is an int of the tree, not a parameter.
    static = {"client_latent": params.pop("client_latent")}
    params = trainable(params)
    optimizer = fused_adam(cfg.lr)
    opt_state = optimizer.init(params)
    xs = [torch.as_tensor(np.asarray(a, np.float32), device=dev)
          for a in xs_train]
    noise = rng.generator(cfg.seed + 1, dev)

    def loss_fn(p):
        recons, mu, logvar = vfl_nets.vfl_vae_forward({**p, **static}, xs,
                                                      noise)
        total, recon, kl = vfl_nets.vfl_vae_loss(recons, xs, mu, logvar)
        return total, (recon, kl)

    rows = []
    report = VFLVAEReport()
    with torch.no_grad():
        for epoch in range(epochs):
            (total, (recon, kl)), grads = value_and_grad(loss_fn, params,
                                                         has_aux=True)
            params, opt_state = apply_optimizer(optimizer, grads, opt_state,
                                                params)
            rows.append(torch.stack([total.detach(), recon.detach(),
                                     kl.detach()]))
            if log_every and epoch % log_every == 0:
                t, r, k = rows[-1].tolist()
                log_fn(f"epoch {epoch}: total {t:.4f} (recon {r:.4f} "
                       f"kl {k:.4f})")
        for t, r, k in torch.stack(rows).tolist():
            report.total_losses.append(t)
            report.recon_losses.append(r)
            report.kl_losses.append(k)
    return {**tree_map(torch.Tensor.detach, params), **static}, report
