"""Data-parallel training step: counterpart of the JAX package's
``parallel/dp.py`` at a world of one process.

The JAX step is an SPMD program over a ``data`` mesh axis: local gradients,
a ``pmean`` over the axis, one optimizer apply. At a world of one the mean
over the data axis is the identity, so this step has no collective; the
multi-process step (``torch.distributed``, NCCL) is ROADMAP.md queue A.
What the JAX step body does around the collective is kept: gradient
accumulation over ``accum_steps`` microbatches into an fp32 sum, the
optimizer apply through ``apply_optimizer`` (``apply_gradients`` where the
optimizer has it), the ``guard_nonfinite`` skip, and the ``step`` count.

The state is updated in place (parameters and moments), where the JAX
program returns new arrays: ``TrainState.params`` is the model's own
parameter tree, so the model a caller holds is the trained one.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from ..ops.adam import apply_optimizer
from ..tree import tree_leaves, tree_unflatten


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: torch.Tensor


def init_state(params, optimizer) -> TrainState:
    """``params``: a tree of tensors (``Llama.tree()``)."""
    device = tree_leaves(params)[0].device
    return TrainState(params, optimizer.init(params),
                      torch.zeros((), dtype=torch.int32, device=device))


def _make_local_grad_step(loss_fn: Callable, optimizer, accum_steps: int,
                          guard_nonfinite: bool) -> Callable:
    """The step body: ``loss_fn(params, batch)`` differentiated by autograd,
    accumulated over ``accum_steps`` microbatches (the batch's leading dim
    must divide), then one optimizer apply."""

    def local_step(state: TrainState, batch: torch.Tensor
                   ) -> Tuple[TrainState, torch.Tensor]:
        leaves = tree_leaves(state.params)
        if accum_steps == 1:
            loss = loss_fn(state.params, batch)
            grads = list(torch.autograd.grad(loss, leaves))
            loss = loss.detach()
        else:
            if batch.shape[0] % accum_steps:
                raise ValueError(f"batch of {batch.shape[0]} does not split "
                                 f"into accum_steps={accum_steps}")
            micro = batch.reshape((accum_steps, -1) + tuple(batch.shape[1:]))
            # Accumulate in fp32 whatever the parameter dtype: a bf16
            # running sum would round away small microbatch contributions.
            gsum = [torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for p in leaves]
            loss = torch.zeros((), dtype=torch.float32, device=batch.device)
            for mb in micro:
                l = loss_fn(state.params, mb)
                for acc, g in zip(gsum, torch.autograd.grad(l, leaves)):
                    acc += g.float()
                loss = loss + l.detach().float()
            loss = loss / accum_steps
            grads = [(g / accum_steps).to(p.dtype)
                     for g, p in zip(gsum, leaves)]
        if guard_nonfinite:
            # A non-finite loss or gradient leaves the state as it was and
            # the step count where it was (the JAX step's select-back). The
            # state is updated in place, so the check comes first, and it
            # waits for the device.
            ok = torch.isfinite(loss)
            for g in grads:
                ok &= torch.isfinite(g).all()
            if not bool(ok):
                return state, loss
        params, opt_state = apply_optimizer(
            optimizer, tree_unflatten(state.params, grads), state.opt_state,
            state.params)
        return TrainState(params, opt_state, state.step + 1), loss

    return local_step


def make_grad_aggregation_step(loss_fn: Callable, optimizer,
                               accum_steps: int = 1,
                               guard_nonfinite: bool = False) -> Callable:
    """``step(state, batch) -> (state, loss)`` for a world of one:
    gradients of ``loss_fn(params, batch) -> scalar``, averaged over
    ``accum_steps`` microbatches, then one optimizer apply. The loss
    returned is the device scalar, not synced.

    ``guard_nonfinite=True``: a step whose loss or gradient holds a NaN/Inf
    is skipped (state unchanged, ``step`` not advanced) and its loss is
    returned as it came."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1 (got {accum_steps})")
    return _make_local_grad_step(loss_fn, optimizer, accum_steps,
                                 guard_nonfinite)
