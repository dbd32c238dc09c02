"""Adam in plain PyTorch: counterpart of the JAX package's ``ops/adam.py``.

``fused_adam`` is the single-expression Adam rule,

    m ← β1·m + (1−β1)·g
    v ← β2·v + (1−β2)·g²
    u = −lr · (m/(1−β1^t)) / (√(v/(1−β2^t)) + ε)

with the optax surface the JAX package gives it: ``init(params)`` and a pure
``update(grads, state, params) -> (updates, state)`` over trees of tensors
(nested dicts and lists, ``tree.py``). ``optax.adam``, the trainer's
default, is the same recurrence up to float re-association, so the port
serves both with this one rule. ``adamw`` is the same rule with optax's
decoupled weight decay, ``u = −lr·(m̂/(√v̂ + ε) + wd·p)``. ``adam_math``
is the rule's one body, over lists of leaves (one ``torch._foreach_*``
call per operation); the CUDA kernel's plain version
(``ops.pallas_adam``) runs it on one leaf. ``apply_optimizer`` applies an
optimizer's step to the parameters, in place (the JAX program returns new
arrays; on the card its kernel aliases them in place too), through
``apply_gradients`` where the optimizer has it
(``ops.pallas_adam.FusedApplyAdam``). ``resize_zero_padded`` moves a
ZeRO-1 flat vector between data-parallel world sizes (``parallel.dp``,
``checkpoint.py``).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..tree import tree_leaves, tree_map, tree_unflatten


class GradientTransformation(NamedTuple):
    """optax's ``(init, update)`` pair."""

    init: Callable
    update: Callable


class FusedAdamState(NamedTuple):
    count: Any   # [] int32 tensor on the parameters' device
    mu: Any
    nu: Any


def resize_zero_padded(vec, new_len: int) -> np.ndarray:
    """Resize a ZeRO-1 padded flat vector (the params, Adam mu or nu slices
    of every rank, concatenated) from its N-way padded length to an M-way
    one: truncate or extend the zero tail. The pad region of such a vector
    is exactly zero forever (the padded gradient tail is zero, so the
    moments there stay 0 and the parameter steps by 0), so the result is
    the vector an M-way setup would build from the same content. Raises if
    a truncated tail is not all zero: that vector is no zero-padded ZeRO-1
    vector. Numpy in, numpy out (``vec`` itself when the length holds)."""
    vec = np.asarray(vec)
    if vec.ndim != 1:
        raise ValueError(f"resize_zero_padded wants a flat vector, got "
                         f"shape {vec.shape}")
    if new_len == vec.shape[0]:
        return vec
    if new_len < vec.shape[0]:
        tail = vec[new_len:]
        if tail.any():
            raise ValueError(
                f"cannot truncate {vec.shape[0]} -> {new_len}: tail is not "
                f"all-zero (max |tail| = {np.abs(tail).max()}): not a "
                "zero-padded ZeRO-1 vector")
        return vec[:new_len]
    return np.concatenate([vec, np.zeros(new_len - vec.shape[0], vec.dtype)])


def bias_corrections(count: torch.Tensor, b1: float, b2: float):
    """``(1 − β1^t, 1 − β2^t)`` as fp32 tensors on the count's device, as
    the JAX package computes them (fp32 power of the step count)."""
    cf = count.float()
    return 1.0 - b1 ** cf, 1.0 - b2 ** cf


def adam_math(gs, ms, vs, c1, c2, ps=None, *, lr: float, b1: float,
              b2: float, eps: float, weight_decay: float = 0.0):
    """The Adam recurrence over lists of leaves, in the JAX package's
    operation order (``csrc/adam.cu`` mirrors it operation for operation).
    Returns the lists ``(updates, m, v)``; an update is the signed step
    before it is added to the parameters. With ``weight_decay`` the update
    is optax's ``adamw``, ``(-lr) · ((m/c1) / (√(v/c2) + ε) + wd·p)``, and
    needs the parameters ``ps``."""
    m = torch._foreach_mul(ms, b1)
    torch._foreach_add_(m, torch._foreach_mul(gs, 1.0 - b1))
    v = torch._foreach_mul(vs, b2)
    torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(gs, gs),
                                              1.0 - b2))
    denom = torch._foreach_div(v, c2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    u = torch._foreach_div(m, c1)
    if weight_decay:
        torch._foreach_div_(u, denom)
        torch._foreach_add_(u, torch._foreach_mul(ps, weight_decay))
        torch._foreach_mul_(u, -lr)
    else:
        torch._foreach_mul_(u, -lr)
        torch._foreach_div_(u, denom)
    return u, m, v


def _init(params) -> FusedAdamState:
    leaves = tree_leaves(params)
    zeros = lambda p: torch.zeros_like(p, requires_grad=False)
    return FusedAdamState(
        torch.zeros((), dtype=torch.int32, device=leaves[0].device),
        tree_map(zeros, params), tree_map(zeros, params))


def fused_adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8, weight_decay: float = 0.0
               ) -> GradientTransformation:
    def update_fn(grads, state: FusedAdamState, params=None):
        count = state.count + 1
        c1, c2 = bias_corrections(count, b1, b2)
        gs = tree_leaves(grads)
        u, m, v = adam_math(
            gs, tree_leaves(state.mu), tree_leaves(state.nu), c1, c2,
            tree_leaves(params) if weight_decay else None, lr=learning_rate,
            b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
        like = lambda leaves: tree_unflatten(grads, leaves)
        updates = like([x.to(g.dtype) for x, g in zip(u, gs)])
        return updates, FusedAdamState(count, like(m), like(v))

    return GradientTransformation(_init, update_fn)


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4
          ) -> GradientTransformation:
    """optax's ``adamw``: the Adam rule plus decoupled weight decay on every
    leaf (``update`` needs ``params``)."""
    return fused_adam(learning_rate, b1, b2, eps, weight_decay)


def apply_updates(params, updates) -> None:
    """``p += u`` on every leaf, in place, in ``p``'s dtype."""
    ps = tree_leaves(params)
    with torch.no_grad():
        torch._foreach_add_(ps, [u.to(p.dtype) for p, u in
                                 zip(ps, tree_leaves(updates))])


def apply_optimizer(optimizer, grads, opt_state, params):
    """One optimizer application, in place on ``params``: the optimizer's
    ``apply_gradients`` where it has one (one fused pass over p, m, v, g),
    else its ``update`` followed by ``p += u``. Returns
    ``(params, opt_state)``."""
    if hasattr(optimizer, "apply_gradients"):
        return optimizer.apply_gradients(params, grads, opt_state)
    updates, opt_state = optimizer.update(grads, opt_state, params)
    apply_updates(params, updates)
    return params, opt_state
