"""Expert parallelism: the MoE expert bank sharded over an ``expert``
axis, counterpart of the JAX package's ``parallel/ep.py``.

The JAX module runs each step as one SPMD program under ``shard_map``
over a ``(data, expert)`` mesh. The port goes back to processes: each
(data row, expert shard) is one OS process of a gloo group
(``distributed.expert_mesh``: rank ``d·E + e``), holding ``n_experts /
ep`` experts of every block's bank and a full copy of every other leaf.
Every expert shard of a row sees the row's tokens and routes them against
all experts (the router is tiny and replicated), so capacity comes from
the row's ``B·T``, as inside JAX's ``shard_map``; each shard runs only its
experts' products, and the combine is a sum over the expert group
(``distributed.psum_ad``, unrecorded: the raw ``lax.psum`` inside
``moe_mlp``, whose backward is a sum too).

Gradient accounting, JAX's (as ``parallel/tp.py``'s): each shard's loss is
divided by ep before differentiation, so the expert leaves' gradients are
exact locally and the replicated leaves' gradients are partials, summed
over the expert group after the backward (``ep_replicated_grads``, one
record per leaf); then everything is averaged over data
(``grad_allreduce``, ``loss_allreduce``). States are updated in place.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from . import distributed as dist
from . import tp
from .dp import TrainState
from ..config import MoEConfig
from ..convert import MOE_EXPERT_LEAVES
from ..models import moe
from ..ops.adam import apply_optimizer
from ..ops.losses import causal_lm_loss
from ..tree import tree_leaves, tree_map, tree_unflatten

_EXPERT_LEAVES = set(MOE_EXPERT_LEAVES)      # leading [L, E, ...] axis


def param_specs(params: dict) -> dict:
    """Which dimension of each leaf the expert axis slices (JAX's
    PartitionSpecs): 1 (the ``[E]`` axis after the stacked-layer axis) for
    the expert bank, None for a replicated leaf."""
    return {k: ({name: tree_map(lambda _, s=1 if name in _EXPERT_LEAVES
                                else None: s, leaf)
                 for name, leaf in v.items()} if k == "blocks"
                else tree_map(lambda _: None, v))
            for k, v in params.items()}


def shard_params(mesh: dist.AxisMesh, params: dict, device=None) -> dict:
    """Expert shard ``mesh.i``'s part of a whole JAX-layout MoE tree (the
    port's tree or ``convert.moe_params_to_numpy``'s numpy tree): its
    ``E/ep`` experts of each bank and the other leaves whole, as fresh
    tensors on ``device`` (None: CUDA) that require grad."""
    return tp.local_slices(params, param_specs(params), mesh.size, mesh.i,
                           device)


def init_state(mesh: dist.AxisMesh, params: dict, optimizer,
               device=None) -> TrainState:
    """This rank's state from the whole tree: its slices
    (``shard_params``) and the optimizer state for them alone."""
    local = shard_params(mesh, params, device)
    return TrainState(local, optimizer.init(local),
                      torch.zeros((), dtype=torch.int32,
                                  device=tree_leaves(local)[0].device))


def _expert_sum(mesh: dist.AxisMesh) -> Callable:
    return lambda y: dist.psum_ad(y, mesh.group)


def ep_forward(params: dict, tokens: torch.Tensor, cfg: MoEConfig,
               mesh: dist.AxisMesh,
               routes: Optional[List[torch.Tensor]] = None):
    """``(logits, aux)`` of the expert-parallel forward on this rank's
    slices (``shard_params``) and ``tokens``, the same on every shard of
    the expert group. ``routes``: ``moe.forward``'s."""
    with torch.no_grad():
        return moe.forward(params, tokens, cfg, _expert_sum(mesh),
                           shard=mesh.i, routes=routes)


def _ep_loss(params: dict, tokens: torch.Tensor, cfg: MoEConfig,
             mesh: dist.AxisMesh, routes=None) -> torch.Tensor:
    logits, aux = moe.forward(params, tokens, cfg, _expert_sum(mesh),
                              shard=mesh.i, routes=routes)
    loss = causal_lm_loss(logits, tokens) + cfg.aux_loss_coef * aux
    return loss / mesh.size


def loss_and_grad(params: dict, tokens: torch.Tensor, cfg: MoEConfig,
                  mesh: dist.AxisMesh, routes=None):
    """The step's loss and this rank's gradient tree on its data row
    (``shard_batch``), reduced as the step reduces them: the replicated
    leaves summed over the expert group, the expert leaves local, both
    averaged over data; the loss the same on every rank."""
    leaves = tree_leaves(params)
    loss = _ep_loss(params, tokens, cfg, mesh, routes)
    grads = list(torch.autograd.grad(loss, leaves))
    specs = tree_leaves(param_specs(params))
    idx = [i for i, s in enumerate(specs) if s is None]
    for i, g in zip(idx, dist.psum_each([grads[i] for i in idx], mesh.group,
                                        label="ep_replicated_grads")):
        grads[i] = g
    grads = tree_unflatten(params, grads)
    loss = loss.detach() * mesh.size             # undo the 1/ep scaling
    if mesh.data > 1:
        grads = dist.pmean_tree(grads, label="grad_allreduce",
                                group=mesh.data_group)
        loss = dist.pmean(loss, label="loss_allreduce",
                          group=mesh.data_group)
    return loss, grads


def make_ep_train_step(cfg: MoEConfig, optimizer, mesh: dist.AxisMesh,
                       device=None) -> Callable:
    """The MoE step on a ``(data, expert)`` mesh: ``step(state, tokens) ->
    (state, loss)`` on ``init_state``'s state and this rank's data row
    ``[B, T]`` (``shard_batch``), updating the state in place (every
    optimizer the port ships is elementwise, so each shard updates its
    own experts); the loss averaged over the data rows, the same on every
    rank."""
    dev = dist.rank_device(device)

    def step(state: TrainState, tokens):
        tokens = torch.as_tensor(tokens, dtype=torch.long, device=dev)
        loss, grads = loss_and_grad(state.params, tokens, cfg, mesh)
        params, opt_state = apply_optimizer(optimizer, grads,
                                            state.opt_state, state.params)
        return TrainState(params, opt_state, state.step + 1), loss

    return step


shard_batch = tp.shard_batch   # this rank's data row of a [D·B, T] batch
