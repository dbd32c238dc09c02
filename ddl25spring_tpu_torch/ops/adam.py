"""Adam in plain PyTorch: counterpart of the JAX package's ``ops/adam.py``.

``fused_adam`` is the single-expression Adam rule per leaf,

    m ← β1·m + (1−β1)·g
    v ← β2·v + (1−β2)·g²
    u = −lr · (m/(1−β1^t)) / (√(v/(1−β2^t)) + ε)

with the optax surface the JAX package gives it: ``init(params)`` and a pure
``update(grads, state, params) -> (updates, state)`` over trees of tensors
(nested dicts, ``tree.py``). ``optax.adam``, the trainer's default, is the
same recurrence up to float re-association, so the port serves both with
this one rule. ``apply_optimizer`` applies an optimizer's step to the
parameters, in place (the JAX program returns new arrays; on the card its
kernel aliases them in place too), through ``apply_gradients`` where the
optimizer has it (``ops.pallas_adam.FusedApplyAdam``).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ..tree import tree_leaves, tree_map


class GradientTransformation(NamedTuple):
    """optax's ``(init, update)`` pair."""

    init: Callable
    update: Callable


class FusedAdamState(NamedTuple):
    count: Any   # [] int32 tensor on the parameters' device
    mu: Any
    nu: Any


def bias_corrections(count: torch.Tensor, b1: float, b2: float):
    """``(1 − β1^t, 1 − β2^t)`` as fp32 tensors on the count's device, as
    the JAX package computes them (fp32 power of the step count)."""
    cf = count.float()
    return 1.0 - b1 ** cf, 1.0 - b2 ** cf


def adam_leaf_math(g, m, v, c1, c2, *, lr: float, b1: float, b2: float,
                   eps: float):
    """The per-leaf Adam recurrence, in the JAX package's operation order
    (``csrc/adam.cu`` mirrors it operation for operation). Returns
    ``(update, m, v)``; the update is the signed step before it is added
    to the parameters."""
    m = b1 * m + (1.0 - b1) * g
    v = b2 * v + (1.0 - b2) * torch.square(g)
    u = (-lr) * (m / c1) / (torch.sqrt(v / c2) + eps)
    return u, m, v


def _init(params) -> FusedAdamState:
    leaves = tree_leaves(params)
    zeros = lambda p: torch.zeros_like(p, requires_grad=False)
    return FusedAdamState(
        torch.zeros((), dtype=torch.int32, device=leaves[0].device),
        tree_map(zeros, params), tree_map(zeros, params))


def fused_adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8) -> GradientTransformation:
    def update_fn(grads, state: FusedAdamState, params=None):
        del params
        count = state.count + 1
        c1, c2 = bias_corrections(count, b1, b2)
        triples = tree_map(
            lambda g, m, v: adam_leaf_math(g, m, v, c1, c2, lr=learning_rate,
                                           b1=b1, b2=b2, eps=eps),
            grads, state.mu, state.nu)
        pick = lambda i: tree_map(lambda _, t: t[i], grads, triples)
        updates = tree_map(lambda g, u: u.to(g.dtype), grads, pick(0))
        return updates, FusedAdamState(count, pick(1), pick(2))

    return GradientTransformation(_init, update_fn)


def apply_optimizer(optimizer, grads, opt_state, params):
    """One optimizer application, in place on ``params``: the optimizer's
    ``apply_gradients`` where it has one (one fused pass over p, m, v, g),
    else its ``update`` followed by ``p += u``. Returns
    ``(params, opt_state)``."""
    if hasattr(optimizer, "apply_gradients"):
        return optimizer.apply_gradients(params, grads, opt_state)
    updates, opt_state = optimizer.update(grads, opt_state, params)
    with torch.no_grad():
        for p, u in zip(tree_leaves(params), tree_leaves(updates)):
            p.add_(u.to(p.dtype))
    return params, opt_state
