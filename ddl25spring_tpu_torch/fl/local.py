"""Client-local training: counterpart of the JAX package's ``fl/local.py``,
over a stacked client axis.

``masked_mean_loss`` is one client's objective. The solvers take the
sampled clients' padded subsets stacked on a leading axis (``x [m, S,
...]``, ``y [m, S]``, ``mask [m, S]``) and the global parameters (one
tree), and run every client at once: ``torch.func.vmap`` over
``torch.func.grad`` of the functional loss. Minibatches are fixed-order
slices of the subset with the tail padded (``_batched``); an all-padding
batch takes no step.

Dropout: ``apply_fn(params, x, *, dropout=None)`` is live iff it is given
keep-masks. ``generators`` (one ``torch.Generator`` per client) turns it
on where ``apply_fn.dropout_masks`` exists: each client's masks for a
step are drawn from its own generator outside the vmap (vmap's own
randomness uses the global generator) and passed in stacked.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
from torch.func import grad_and_value, vmap

from ..tree import tree_map

# apply_fn(params, x, *, dropout=None) -> logits
ApplyFn = Callable[..., torch.Tensor]
Generators = Optional[Sequence[torch.Generator]]


def masked_mean_loss(apply_fn: ApplyFn, params: dict, x: torch.Tensor,
                     y: torch.Tensor, mask: torch.Tensor,
                     dropout=None) -> torch.Tensor:
    """Cross-entropy averaged over one client's real (unmasked) samples;
    a subset of padding only gives 0."""
    logits = (apply_fn(params, x) if dropout is None
              else apply_fn(params, x, dropout=dropout))
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, 1, y[:, None])[:, 0]
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _draw_dropout(apply_fn: ApplyFn, generators: Generators, batch: int):
    """Each client's keep-masks for one forward over ``batch`` samples,
    stacked on the client axis; None when dropout is off."""
    make = getattr(apply_fn, "dropout_masks", None)
    if generators is None or make is None:
        return None
    per_client = [make(g, (batch,)) for g in generators]
    return tuple(torch.stack(masks) for masks in zip(*per_client))


def _client_grads(apply_fn: ApplyFn, params: dict, x, y, mask, dropout,
                  params_stacked: bool) -> Tuple[dict, torch.Tensor]:
    """(grads [m, ...], loss [m]) of every client's ``masked_mean_loss``."""
    def loss(p, xi, yi, mi, di):
        return masked_mean_loss(apply_fn, p, xi, yi, mi, di)

    in_dims = (0 if params_stacked else None, 0, 0, 0,
               None if dropout is None else 0)
    return vmap(grad_and_value(loss), in_dims=in_dims)(params, x, y, mask,
                                                       dropout)


def full_batch_grad(apply_fn: ApplyFn, params: dict, x: torch.Tensor,
                    y: torch.Tensor, mask: torch.Tensor,
                    generators: Generators = None) -> Tuple[torch.Tensor, dict]:
    """One gradient per client over its whole subset, FedSGD's client step
    (dropout live when generators are given). Returns (loss [m], grads
    with a leading client axis)."""
    dropout = _draw_dropout(apply_fn, generators, x.shape[1])
    grads, loss = _client_grads(apply_fn, params, x, y, mask, dropout,
                                params_stacked=False)
    return loss, grads


def _batched(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
             batch_size: int):
    """Stacked subsets [m, S, ...] -> [m, n_batches, B, ...], the tail
    padded; B = -1 (or B > S) means one batch of the whole subset."""
    m, s = x.shape[:2]
    if batch_size <= 0 or batch_size > s:
        batch_size = s
    n_batches = -(-s // batch_size)
    pad = n_batches * batch_size - s
    if pad:
        x = torch.cat([x, x.new_zeros((m, pad) + x.shape[2:])], 1)
        y = torch.cat([y, y.new_zeros((m, pad))], 1)
        mask = torch.cat([mask, mask.new_zeros((m, pad))], 1)
    return (x.reshape((m, n_batches, batch_size) + x.shape[2:]),
            y.reshape(m, n_batches, batch_size),
            mask.reshape(m, n_batches, batch_size))


def _per_client(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """[m] -> [m, 1, ..., 1], broadcastable against a stacked leaf."""
    return v.reshape((-1,) + (1,) * (like.dim() - 1))


def local_prox_sgd(apply_fn: ApplyFn, params: dict, x: torch.Tensor,
                   y: torch.Tensor, mask: torch.Tensor, *, epochs: int,
                   batch_size: int, lr: float, mu: float,
                   generators: Generators = None) -> dict:
    """FedProx's local solver: E epochs of fixed-order minibatch SGD on
    every client from the global ``params``, each minibatch objective plus
    (μ/2)·‖w − w_global‖² (gradient μ·(w − w_global), added explicitly).
    At ``mu == 0`` the step carries no proximal arithmetic at all. Returns
    the clients' parameters stacked on the client axis."""
    m = x.shape[0]
    xb, yb, mb = _batched(x, y, mask, batch_size)
    p = tree_map(lambda w: w.expand((m,) + w.shape).clone(), params)
    for _ in range(epochs):
        for b in range(xb.shape[1]):
            bx, by, bm = xb[:, b], yb[:, b], mb[:, b]
            dropout = _draw_dropout(apply_fn, generators, bx.shape[1])
            grads, _ = _client_grads(apply_fn, p, bx, by, bm, dropout,
                                     params_stacked=True)
            # An all-padding batch steps by 0.
            step = lr * (bm.sum(1) > 0).to(torch.float32)
            if mu == 0.0:
                p = tree_map(lambda w, g: w - _per_client(step, w) * g,
                             p, grads)
            else:
                p = tree_map(lambda w, g, w0: w - _per_client(step, w) * (
                    g + mu * (w - w0)), p, grads, params)
    return p


def local_sgd(apply_fn: ApplyFn, params: dict, x: torch.Tensor,
              y: torch.Tensor, mask: torch.Tensor, *, epochs: int,
              batch_size: int, lr: float,
              generators: Generators = None) -> dict:
    """E epochs of plain SGD over fixed-order minibatches on every client:
    ``local_prox_sgd`` at μ = 0."""
    return local_prox_sgd(apply_fn, params, x, y, mask, epochs=epochs,
                          batch_size=batch_size, lr=lr, mu=0.0,
                          generators=generators)
