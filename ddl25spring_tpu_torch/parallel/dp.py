"""Data-parallel training steps: counterpart of the JAX package's
``parallel/dp.py``.

The JAX steps are SPMD programs over a ``data`` mesh axis; here each rank
is a process of a ``torch.distributed`` group (``parallel.distributed``)
that calls the step on its own batch, and the collectives are
``distributed``'s. Without a group the world is one, every collective is
the identity, and the steps are the world-of-one steps they were.

- Gradient aggregation (``make_grad_aggregation_step``): local gradients,
  accumulated in fp32 over ``accum_steps`` microbatches, then ``pmean`` of
  the gradients and of the loss, then one optimizer apply through
  ``apply_optimizer`` (``apply_gradients`` where the optimizer has it).
- K-step dispatch (``make_multi_step``): a loop of K such steps over a
  ``[K, B, T]`` window; it reads nothing on the host inside the window and
  returns the ``[K]`` losses on the device, bitwise K per-step calls.
- Weight aggregation (``make_weight_aggregation_step``): a local step
  through ``optimizer.update`` and ``p += u`` (the plain rule, as the JAX
  step's ``optax.apply_updates``), then ``pmean`` of the parameters, of
  the optimizer state's floating leaves (the JAX package's documented
  deviation from the reference, which keeps per-rank moments) and of the
  loss.
- ZeRO-1 (``make_zero1_step``, ``make_zero1_multi_step``): the gradient is
  raveled into one fp32 vector padded to a multiple of the world,
  ``psum_scatter`` gives each rank the mean of its ``1/n`` slice, the
  optimizer updates that slice of the parameters against moments that
  exist for that slice only, and ``all_gather`` brings every slice back
  into the replicated parameters.

On a hierarchical layout (``distributed.hier_data_mesh``: ``dcn`` islands
of ``data`` ranks) the plain steps above would average over the whole
group as if it were flat; given such a layout as ``mesh=`` they refuse it
with the JAX package's error and point to the two-level ring step
(``parallel/compress.py``). ``slice_index`` is the one ownership rule of
ZeRO-1's slices and the ring's reduced chunks: the rank on a flat layout,
``s·D + d`` for replica ``s`` of island ``d`` on a hierarchical one.

``guard_nonfinite`` skips a step whose averaged loss or gradient holds a
NaN or Inf: the state stays as it was and ``step`` does not advance. Every
rank reaches the same verdict (it is taken on the averaged values, or on
ZeRO-1 ranks' verdicts summed in a 4-byte ``psum``), and it is read on the
host before the in-place update.

The state is updated in place (parameters and moments), where the JAX
programs return new arrays: ``TrainState.params`` is the model's own
parameter tree, so the model a caller holds is the trained one. Each rank
holds the full parameters; only ZeRO-1 splits the moments, and its state
carries the slice geometry (``TrainState.zero1``). ``host_snapshot`` and
``reshard_state`` move states to the host and back, per-rank leaves
stacked ``[n, ...]`` in rank order as the JAX package shards them, and
across world sizes (``checkpoint.py``, the elastic re-mesh of
``resilience/elastic.py``): ZeRO-1's flat moment vectors and the ring
step's error-feedback residuals resize to the new world.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import distributed as dist
from ..telemetry import comm as _comm
from ..ops.adam import apply_optimizer, apply_updates, resize_zero_padded
from ..tree import (nested_leaves, nested_unflatten, tree_copy,
                    tree_leaves, tree_unflatten)


@dataclass(frozen=True)
class Zero1Geometry:
    """The padded flat-vector geometry of a ZeRO-1 state
    (``_flat_geometry``): world ``n``, ``pad`` zeros after the ``total``
    parameters, ``local`` elements per rank, and the slice index ``rank``
    (``slice_index``) whose slice ``[rank·local, (rank+1)·local)`` this
    state's moments cover. ``position`` is this process's rank, the block
    its moments take in a stack gathered in rank order (``host_snapshot``);
    it differs from ``rank`` only on a hierarchical layout."""

    n: int
    pad: int
    local: int
    total: int
    rank: int
    position: Optional[int] = None

    @property
    def mine(self) -> slice:
        return slice(self.rank * self.local, (self.rank + 1) * self.local)

    @property
    def stored(self) -> slice:
        p = self.rank if self.position is None else self.position
        return slice(p * self.local, (p + 1) * self.local)


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: torch.Tensor
    zero1: Optional[Zero1Geometry] = None   # set on ZeRO-1 states only
    pp: Any = None      # pipeline stage states only (``pp.StageGeometry``)


def init_state(params, optimizer) -> TrainState:
    """``params``: a tree of tensors (``Llama.tree()``)."""
    device = tree_leaves(params)[0].device
    return TrainState(params, optimizer.init(params),
                      torch.zeros((), dtype=torch.int32, device=device))


def _local_loss_and_grads(loss_fn: Callable, params, batch: torch.Tensor,
                          accum_steps: int):
    """``loss_fn(params, batch)`` and its gradient leaves by autograd,
    averaged over ``accum_steps`` microbatches (the batch's leading dim
    must divide) with an fp32 running sum."""
    leaves = tree_leaves(params)
    if accum_steps == 1:
        loss = loss_fn(params, batch)
        return loss.detach(), list(torch.autograd.grad(loss, leaves))
    if batch.shape[0] % accum_steps:
        raise ValueError(f"batch of {batch.shape[0]} does not split into "
                         f"accum_steps={accum_steps}")
    micro = batch.reshape((accum_steps, -1) + tuple(batch.shape[1:]))
    # Accumulate in fp32 whatever the parameter dtype: a bf16 running sum
    # would round away small microbatch contributions.
    gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in leaves]
    loss = torch.zeros((), dtype=torch.float32, device=batch.device)
    for mb in micro:
        l = loss_fn(params, mb)
        for acc, g in zip(gsum, torch.autograd.grad(l, leaves)):
            acc += g.float()
        loss = loss + l.detach().float()
    return (loss / accum_steps,
            [(g / accum_steps).to(p.dtype) for g, p in zip(gsum, leaves)])


def _all_finite(loss: torch.Tensor, tensors) -> torch.Tensor:
    ok = torch.isfinite(loss)
    for x in tensors:
        ok &= torch.isfinite(x).all()
    return ok


def _pre_update_copy(params, numerics):
    """The parameters before an in-place update, for the numerics summary
    (None when numerics are off)."""
    if numerics is None:
        return None
    return tree_unflatten(params, [p.detach().clone()
                                   for p in tree_leaves(params)])


def _make_local_grad_step(loss_fn: Callable, optimizer, accum_steps: int,
                          guard_nonfinite: bool, numerics=None) -> Callable:
    """The gradient-aggregation step body shared by
    ``make_grad_aggregation_step`` and ``make_multi_step``.

    ``numerics`` (``telemetry.introspect.NumericsHandle``): the step's
    second output becomes ``(loss, NumericsSummary)`` of the averaged
    gradient and the update, from a copy of the parameters taken before
    the in-place update; losses and parameters do not change. A step the
    guard skips reports the update it refused, as the JAX body does: the
    optimizer runs on copies of the parameters and moments, which are
    summarized and dropped (only skipped steps with numerics on pay for
    the copies)."""

    def local_step(state: TrainState, batch: torch.Tensor
                   ) -> Tuple[TrainState, torch.Tensor]:
        loss, grads = _local_loss_and_grads(loss_fn, state.params, batch,
                                            accum_steps)
        grads = dist.pmean_tree(grads, label="grad_allreduce")
        loss = dist.pmean(loss, label="loss_allreduce")
        old = _pre_update_copy(state.params, numerics)
        grad_tree = tree_unflatten(state.params, grads)
        # The averaged values are the same on every rank, and so is the
        # verdict. The state is updated in place, so the check comes
        # first, and it waits for the device.
        if guard_nonfinite and not bool(_all_finite(loss, grads)):
            if numerics is not None:
                refused, _ = apply_optimizer(
                    optimizer, grad_tree, tree_copy(state.opt_state),
                    _pre_update_copy(state.params, numerics))
                return state, (loss, numerics.summarize(old, grad_tree,
                                                        refused))
            return state, loss
        params, opt_state = apply_optimizer(
            optimizer, grad_tree, state.opt_state, state.params)
        new_state = TrainState(params, opt_state, state.step + 1)
        if numerics is not None:
            return new_state, (loss, numerics.summarize(old, grad_tree,
                                                        params))
        return new_state, loss

    return local_step


def make_grad_aggregation_step(loss_fn: Callable, optimizer,
                               accum_steps: int = 1,
                               guard_nonfinite: bool = False,
                               numerics=None, *, mesh=None) -> Callable:
    """``step(state, batch) -> (state, loss)`` on this rank's ``batch``:
    gradients of ``loss_fn(params, batch) -> scalar``, averaged over
    ``accum_steps`` microbatches, then over the ranks, then one optimizer
    apply. Parameters and moments stay bitwise replicated, since every rank
    applies the same averaged gradient. The loss returned is the device
    scalar averaged over the ranks, not synced.

    ``guard_nonfinite=True``: a step whose averaged loss or gradient holds a
    NaN/Inf (one poisoned rank poisons the mean for every rank) is skipped
    (state unchanged, ``step`` not advanced) and its loss is returned as it
    came. ``numerics``: see ``_make_local_grad_step``. ``mesh``: a
    hierarchical layout raises (``_require_flat_data_mesh``)."""
    _require_flat_data_mesh(mesh, "make_grad_aggregation_step")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1 (got {accum_steps})")
    return _make_local_grad_step(loss_fn, optimizer, accum_steps,
                                 guard_nonfinite, numerics)


def _loop(local_step: Callable) -> Callable:
    """K calls of ``local_step`` over a ``[K, B, T]`` window, the losses
    (and numerics summaries, field by field) stacked on the device."""
    from ..telemetry.introspect import NumericsSummary, split_step_output

    def multi(state: TrainState, window: torch.Tensor):
        losses, summaries = [], []
        for batch in window:
            state, out = local_step(state, batch)
            loss, summary = split_step_output(out)
            losses.append(loss)
            if summary is not None:
                summaries.append(summary)
        if summaries:
            return state, (torch.stack(losses), NumericsSummary(
                *(torch.stack(f) for f in zip(*summaries))))
        return state, torch.stack(losses)

    return multi


def make_multi_step(loss_fn: Callable, optimizer, accum_steps: int = 1,
                    guard_nonfinite: bool = False, numerics=None, *,
                    mesh=None) -> Callable:
    """K-step loop: ``step(state, window) -> (state, losses)`` where
    ``window`` is this rank's ``[K, B, T]`` batches of K consecutive steps
    and ``losses`` the ``[K]`` per-step losses, on the device. The body is
    ``make_grad_aggregation_step``'s, so the losses and the final state are
    bitwise K per-step calls. K is the window's leading dim, so one loop
    serves every window size."""
    _require_flat_data_mesh(mesh, "make_multi_step")
    return _loop(make_grad_aggregation_step(loss_fn, optimizer, accum_steps,
                                            guard_nonfinite, numerics))


def _pmean_float_leaves(tree, label: str):
    """``pmean`` of every floating tensor leaf of a tree of dicts, lists
    and tuples, in place; other leaves (an int32 step count, equal on
    every rank) stay. Recorded as the JAX step's ``pmean`` of the whole
    tree, under ``label``."""
    _comm.record("pmean", label, tree)
    leaves = [x for x in nested_leaves(tree)
              if isinstance(x, torch.Tensor) and x.is_floating_point()]
    with torch.no_grad():
        for x, mean in zip(leaves, dist.pmean_tree(leaves, record=False)):
            if mean is not x:
                x.copy_(mean)
    return tree


def make_weight_aggregation_step(loss_fn: Callable, optimizer, *,
                                 mesh=None) -> Callable:
    """``step(state, batch) -> (state, loss)``: one local optimizer step on
    this rank's gradient (``optimizer.update`` and ``p += u``), then the
    parameters, the optimizer state's floating leaves and the loss
    averaged over the ranks: the reference's weight aggregation with the
    averages written back (its script leaves them unused)."""
    _require_flat_data_mesh(mesh, "make_weight_aggregation_step")

    def step(state: TrainState, batch: torch.Tensor):
        leaves = tree_leaves(state.params)
        loss = loss_fn(state.params, batch)
        grads = torch.autograd.grad(loss, leaves)
        updates, opt_state = optimizer.update(
            tree_unflatten(state.params, list(grads)), state.opt_state,
            state.params)
        apply_updates(state.params, updates)
        _pmean_float_leaves(state.params, "weight_allreduce")
        _pmean_float_leaves(opt_state, "optstate_allreduce")
        return (TrainState(state.params, opt_state, state.step + 1),
                dist.pmean(loss.detach(), label="loss_allreduce"))

    return step


# ------------------------------------------------------------- topology

def data_axes(mesh=None) -> Tuple[str, ...]:
    """The axes that together form the data-parallel world, outermost
    first: ``("dcn", "data")`` on a hierarchical layout with more than one
    island (``distributed.hier_data_mesh``), ``("data",)`` otherwise
    (``mesh`` None: the whole process group)."""
    if mesh is not None and mesh.shape.get("dcn", 1) > 1:
        return ("dcn", "data")
    return ("data",)


def data_partition(mesh=None):
    """The JAX package's PartitionSpec entry for a dim split over the data
    world: one axis name, or the tuple of the hierarchical axes whose size
    exceeds 1. The port places nothing by it; it names the layout."""
    axes = data_axes(mesh)
    if len(axes) == 1:
        return axes[0]
    axes = tuple(a for a in axes if mesh.shape[a] > 1)
    return axes if len(axes) > 1 else axes[0]


def hier_slice_index(mesh) -> int:
    """The hierarchical slice-ownership map: replica ``s`` of island ``d``
    owns flat slice ``s·D + d``, the slice the two-level reduce-scatter's
    chunk lands on (``compress.hier_reduce_scatter``)."""
    return mesh.s * mesh.dcn + mesh.d


def slice_index(mesh=None) -> int:
    """This rank's slice of the padded flat parameter vector: its index on
    the data axis (the rank, ``mesh`` None), ``hier_slice_index`` on a
    hierarchical layout."""
    if mesh is None:
        return dist.get_rank()
    if len(data_axes(mesh)) == 1:
        return mesh.data_group.index
    return hier_slice_index(mesh)


def _require_flat_data_mesh(mesh, what: str) -> None:
    """The plain steps reduce over the ``data`` axis only: on a
    hierarchical layout they would aggregate within islands (the JAX
    package's error, pointing to the two-level ring step)."""
    if mesh is not None and mesh.shape.get("dcn", 1) > 1:
        raise ValueError(
            f"{what} reduces over the 'data' axis only and would silently "
            "aggregate per-island on a hierarchical (dcn x data) mesh; "
            "use the two-level ring driver (parallel/compress.py "
            "make_overlap_step / make_overlap_multi_step with "
            'wire={"ici": ..., "dcn": ...})')


def shard_batch(batch, *, device) -> torch.Tensor:
    """This rank's rows of a global ``[n·B, ...]`` batch on ``device``:
    rank r reads rows ``[r·B, (r+1)·B)``. On a hierarchical layout rank
    ``d·S + s`` is replica (d, s), so the rows are island-major, as the
    JAX package's ``shard_batch`` places them."""
    n, r = dist.world_size(), dist.get_rank()
    b = batch.shape[0] // n
    return torch.as_tensor(batch[r * b:(r + 1) * b], dtype=torch.long,
                           device=device)


def shard_batch_window(window, *, device) -> torch.Tensor:
    """This rank's ``[K, B, T]`` part of a ``[K, n·B, T]`` window (the
    second axis split as ``shard_batch`` splits the first)."""
    n, r = dist.world_size(), dist.get_rank()
    b = window.shape[1] // n
    return torch.as_tensor(window[:, r * b:(r + 1) * b], dtype=torch.long,
                           device=device)


# -------------------------------------------------------------------- ZeRO-1

def _flat_geometry(params) -> Tuple[int, int, int, int]:
    """``(n, pad, local, total)`` of the padded flat parameter vector: n is
    the world (``dcn·data`` on a hierarchical layout: the whole group),
    total the parameter count, pad brings it to a multiple of n, and local
    = (total + pad) / n is one rank's slice."""
    n = dist.world_size()
    total = sum(x.numel() for x in tree_leaves(params))
    pad = (-total) % n
    return n, pad, (total + pad) // n, total


def _flat_fp32(leaves, pad: int) -> torch.Tensor:
    """The leaves raveled in order into one fp32 vector, ``pad`` zeros
    after them (``ravel_pytree``, then ``jnp.pad``)."""
    parts = [x.detach().reshape(-1).float() for x in leaves]
    if pad:
        parts.append(torch.zeros(pad, dtype=torch.float32,
                                 device=parts[0].device))
    return torch.cat(parts)


def _zero1_setup(optimizer, params, mesh=None) -> TrainState:
    """The initial ZeRO-1 state: the replicated parameters, and optimizer
    state for this rank's ``1/n`` slice (``slice_index(mesh)``) of the
    padded fp32 flat vector only."""
    n, pad, local, total = _flat_geometry(params)
    geom = Zero1Geometry(n, pad, local, total, slice_index(mesh),
                         dist.get_rank())
    mine = _flat_fp32(tree_leaves(params), pad)[geom.mine].clone()
    return TrainState(params, optimizer.init(mine),
                      torch.zeros((), dtype=torch.int32, device=mine.device),
                      geom)


def _make_zero1_local_step(loss_fn: Callable, optimizer, *,
                           guard_nonfinite: bool = False,
                           numerics=None) -> Callable:
    """The ZeRO-1 step body shared by ``make_zero1_step`` and
    ``make_zero1_multi_step``: local gradients → ``psum_scatter`` (this
    rank's averaged slice) → the optimizer on the slice → ``all_gather`` of
    the updated slices, cut to the parameter count and cast back into the
    parameters. Under ``guard_nonfinite`` a non-finite value lands only in
    the slice whose owner summed it, so the ranks' verdicts are summed in
    a 4-byte ``psum`` before anyone applies an update. ``numerics`` (built
    with ``psum_axis``: the local gradients differ per rank) summarizes the
    local gradients and the post-guard update, as the JAX body does."""

    def local_step(state: TrainState, batch: torch.Tensor):
        geom = state.zero1
        leaves = tree_leaves(state.params)
        loss = loss_fn(state.params, batch)
        grads = torch.autograd.grad(loss, leaves)
        g_mine = dist.psum_scatter(_flat_fp32(grads, geom.pad),
                                   label="zero1_grad_scatter") / geom.n
        p_mine = _flat_fp32(leaves, geom.pad)[geom.mine].clone()
        loss = dist.pmean(loss.detach(), label="loss_allreduce")
        old = _pre_update_copy(state.params, numerics)

        def out(new_state):
            if numerics is None:
                return new_state, loss
            return new_state, (loss, numerics.summarize(
                old, tree_unflatten(state.params, list(grads)),
                state.params))

        if guard_nonfinite:
            ok = _all_finite(loss, [g_mine]).to(torch.int32)
            if int(dist.psum(ok, label="zero1_guard_verdict")) != geom.n:
                return out(state)
        p_mine, opt_state = apply_optimizer(optimizer, g_mine,
                                            state.opt_state, p_mine)
        flat_new = dist.all_gather(p_mine,
                                   label="zero1_param_gather")[:geom.total]
        with torch.no_grad():
            for p, piece in zip(leaves, flat_new.split(
                    [p.numel() for p in leaves])):
                p.copy_(piece.view(p.shape))
        return out(state._replace(opt_state=opt_state, step=state.step + 1))

    return local_step


def make_zero1_step(loss_fn: Callable, optimizer, params, *,
                    guard_nonfinite: bool = False, numerics=None,
                    mesh=None) -> Tuple[TrainState, Callable]:
    """ZeRO-1 data parallelism: ``(state, step)``, the initial state (the
    parameters ``params``, moments for this rank's slice only) and
    ``step(state, batch) -> (state, loss)``. Adam is elementwise, so the
    sliced update equals the replicated one up to float re-association.
    On this route ``psum_scatter`` and ``all_gather`` are each a full
    all-reduce of the padded vector. ``mesh``: a hierarchical layout
    raises (``_require_flat_data_mesh``)."""
    _require_flat_data_mesh(mesh, "make_zero1_step")
    return (_zero1_setup(optimizer, params),
            _make_zero1_local_step(loss_fn, optimizer,
                                   guard_nonfinite=guard_nonfinite,
                                   numerics=numerics))


def make_zero1_multi_step(loss_fn: Callable, optimizer, params, *,
                          guard_nonfinite: bool = False, numerics=None,
                          mesh=None) -> Tuple[TrainState, Callable]:
    """``make_zero1_step`` inside the K-step loop: ``step(state, window)
    -> (state, losses)`` over a ``[K, B, T]`` window, bitwise K calls of
    the per-step function."""
    _require_flat_data_mesh(mesh, "make_zero1_multi_step")
    state, step = make_zero1_step(loss_fn, optimizer, params,
                                  guard_nonfinite=guard_nonfinite,
                                  numerics=numerics)
    return state, _loop(step)


# ------------------------------------------------------ host snapshots

def _slice_mask(state, *, resizable: bool = False) -> List[bool]:
    """Per ``nested_leaves(state)`` leaf: whether each rank holds its own
    block of it (stacked in rank order along dim 0 in a snapshot): a
    ZeRO-1 state's optimizer-state tensors of ndim >= 1 (its count stays
    replicated), and every tensor of the fields a state type names in
    ``PER_RANK_FIELDS`` (``compress.EFTrainState``'s and
    ``compress.OverlapEFState``'s error-feedback residuals).
    ``resizable``: only those per-rank leaves ``reshard_state`` may bring
    from another world, the ZeRO-1 slices and the fields a state type
    names in ``RESIZABLE_FIELDS`` (the ring step's residuals)."""
    fields = getattr(state, "_fields", None)
    geom = getattr(state, "zero1", None)
    per_rank = getattr(type(state), "RESIZABLE_FIELDS" if resizable
                       else "PER_RANK_FIELDS", ())
    if fields is None or (geom is None and not per_rank):
        return [False] * len(nested_leaves(state))
    mask: List[bool] = []
    for name, value in zip(fields, state):
        leaves = nested_leaves(value)
        if name in per_rank:
            mask += [isinstance(x, torch.Tensor) for x in leaves]
        elif name == "opt_state" and geom is not None:
            mask += [isinstance(x, torch.Tensor) and x.dim() >= 1
                     for x in leaves]
        else:
            mask += [False] * len(leaves)
    return mask


def global_shapes(state) -> List[Optional[tuple]]:
    """The shape of every ``nested_leaves`` leaf as the whole world holds
    it (a per-rank block as the stack of every rank's blocks along dim 0:
    a ZeRO-1 slice as the ``[n·local]`` vector), None for a leaf that is
    no tensor."""
    n = dist.world_size()
    return [None if not isinstance(x, torch.Tensor)
            else (n * x.shape[0],) + tuple(x.shape[1:]) if is_slice
            else tuple(x.shape)
            for x, is_slice in zip(nested_leaves(state), _slice_mask(state))]


def host_snapshot(state):
    """A host-RAM copy of a state (any tree of dicts, lists and tuples):
    every tensor leaf as a CPU tensor, each per-rank leaf (``_slice_mask``:
    ZeRO-1 moment slices, error-feedback residuals) gathered from every
    rank and stacked along dim 0 in rank order (a collective: every rank
    calls it). Other leaves stay as they are."""
    def copy(x, is_slice):
        if not isinstance(x, torch.Tensor):
            return x
        if not is_slice:
            return x.detach().cpu().clone()
        stacked = dist.all_gather(x.detach().reshape(-1))
        return stacked.reshape((-1,) + tuple(x.shape[1:])).cpu().clone()

    return nested_unflatten(state, [copy(x, s) for x, s in zip(
        nested_leaves(state), _slice_mask(state))])


def reshard_state(host_state, template_state):
    """Place a host snapshot (``host_snapshot``'s CPU tensors or numpy
    arrays; a checkpoint's leaves; an elastic mirror) into
    ``template_state``'s layout, on its devices and dtypes. The snapshot
    may come from another world size: this is the cross-topology reshard
    of the elastic re-mesh and of a checkpoint restored at another world.

    A per-rank leaf (``_slice_mask``) takes this rank's block of the saved
    stack, after the stack is brought to the template's world:

    - a flat vector (ZeRO-1 moment slices, the ring step's gather
      residuals) passes through ``resize_zero_padded`` to the template's
      ``n·local`` (the pad swap; a non-zero truncated tail raises);
    - ``OverlapEFState.ring_residual`` (``[n, ring_len]`` stacked) goes
      row by row through ``_resize_ring_residual``: surviving rows
      pad-swap, each row's own chunk is re-zeroed in the new geometry and
      new rows start at zero. At ``comm_buckets > 1`` the residuals are
      per-bucket tuples and resize bucket by bucket; the bucket counts
      must match, and every interior bucket must keep its coordinate span
      across the worlds (the JAX package's "indivisible bucket×shard
      factorization" error otherwise);
    - any other per-rank leaf (the legacy int8 step's residual tree) must
      come from the template's world, and raises otherwise.

    Every other leaf must keep its shape. Leaves that are no tensor in the
    template come from the template. Returns a new state; the template is
    not changed. Every surviving coordinate is a bitwise copy, so a run
    continued from the result is a fresh run of the new world restored
    from the same snapshot."""
    geom = getattr(template_state, "zero1", None)
    pos = (geom.position if geom is not None and geom.position is not None
           else dist.get_rank())
    n = dist.world_size()
    host_state = _resize_ring_residuals(host_state, template_state, n)

    def place(h, t, is_slice, resizable):
        if not isinstance(t, torch.Tensor):
            return t
        h = (h.detach().cpu() if isinstance(h, torch.Tensor)
             else torch.from_numpy(np.array(h)))
        if is_slice:
            rows = t.shape[0]
            if h.shape[0] != n * rows:
                if not resizable or h.dim() != 1:
                    raise ValueError(
                        f"a per-rank leaf saved as {tuple(h.shape)} does "
                        f"not stack {n} blocks of the template's "
                        f"{tuple(t.shape)}: only the ZeRO-1 moment slices "
                        "and the ring step's error-feedback residuals "
                        "resize across worlds")
                h = torch.from_numpy(resize_zero_padded(h.numpy(), n * rows))
            h = h[pos * rows:(pos + 1) * rows]
        if tuple(h.shape) != tuple(t.shape):
            raise ValueError(f"leaf of shape {tuple(h.shape)} does not fit "
                             f"the template's {tuple(t.shape)}")
        return h.to(device=t.device, dtype=t.dtype,
                    copy=True).requires_grad_(t.requires_grad)

    hs, ts = nested_leaves(host_state), nested_leaves(template_state)
    if len(hs) != len(ts):
        raise ValueError(f"snapshot has {len(hs)} leaves, template {len(ts)}")
    return nested_unflatten(template_state, [
        place(*args) for args in zip(
            hs, ts, _slice_mask(template_state),
            _slice_mask(template_state, resizable=True))])


def _resize_ring_residuals(host_state, template_state, n: int):
    """The ring-residual pre-pass of ``reshard_state``: a snapshot's
    ``ring_residual`` (one ``[n_old, ring_len_old]`` stack, or a tuple of
    per-bucket stacks) resized to the template's world ``n``, as the JAX
    package's ``reshard_state`` does before its leaf pass. A per-rank slot
    is ``[1, ring_len]`` (the composed layout's ``[ring_len]`` is one row
    of a 1-D stack and takes the flat-vector rule instead)."""
    h_rr = getattr(host_state, "ring_residual", None)
    t_rr = getattr(template_state, "ring_residual", None)
    if h_rr is None or t_rr is None:
        return host_state
    h_tup, t_tup = isinstance(h_rr, tuple), isinstance(t_rr, tuple)
    if h_tup != t_tup or (h_tup and len(h_rr) != len(t_rr)):
        raise ValueError(
            f"comm_buckets mismatch: the snapshot carries "
            f"{len(h_rr) if h_tup else 1} EF residual bucket(s), the "
            f"template {len(t_rr) if t_tup else 1} — rebucketing a "
            f"live EF state is not defined; rebuild the trainer with "
            f"the snapshot's comm_buckets")
    hs, ts = (list(h_rr), list(t_rr)) if h_tup else ([h_rr], [t_rr])
    if ts[0].dim() != 2 or all(tuple(h.shape) == (n, int(t.shape[-1]))
                               for h, t in zip(hs, ts)):
        return host_state       # the composed layout, or the same world
    if h_tup:
        for b, (h, t) in enumerate(zip(hs[:-1], ts[:-1])):
            if int(h.shape[-1]) != int(t.shape[-1]):
                raise ValueError(
                    f"indivisible bucket×shard factorization: "
                    f"interior bucket {b} covers "
                    f"{int(h.shape[-1])} coordinates in "
                    f"the snapshot but {int(t.shape[-1])} in the "
                    f"template — bucket boundaries move with the data "
                    f"world unless the per-shard slice divides "
                    f"evenly; resize via comm_buckets=1 or choose a "
                    f"(world, comm_buckets) pair that preserves the "
                    f"interior bucket spans")
    out = [torch.from_numpy(_resize_ring_residual(
        h.detach().cpu().numpy() if isinstance(h, torch.Tensor)
        else np.asarray(h), (n, int(t.shape[-1])))) for h, t in zip(hs, ts)]
    return host_state._replace(
        ring_residual=tuple(out) if h_tup else out[0])


def _resize_ring_residual(h: np.ndarray, new_shape) -> np.ndarray:
    """Resize an int8-ring EF ``ring_residual`` ``[n_old, ring_len_old]``
    to a new world's ``[n_new, ring_len_new]`` (the JAX package's rule).
    Row r is shard r's pending quantization error over the flat padded
    vector: each surviving row pad-swaps as a ZeRO-1 slice stack does (a
    non-zero truncated tail raises), new rows (a grow) start at zero, and
    each row's own chunk is re-zeroed in the new geometry (the owner never
    quantizes its own chunk, and the chunk boundaries moved with ``n``).
    Dropped rows (a shrink) leave with their shards."""
    n_new, len_new = int(new_shape[0]), int(new_shape[1])
    n_old, _ = h.shape
    if len_new % n_new:
        raise ValueError(f"ring_len {len_new} is not a multiple of the "
                         f"data world {n_new} — not a flat-ring residual")
    local_new = len_new // n_new
    out = np.zeros((n_new, len_new), h.dtype)
    for r in range(min(n_old, n_new)):
        out[r] = resize_zero_padded(np.asarray(h[r]), len_new)
        out[r, r * local_new:(r + 1) * local_new] = 0.0
    return out


def _resize_act_residual(h: np.ndarray, new_shape) -> np.ndarray:
    """Resize a PSA ``act_residual`` stack ``[n_data, tp, L, 2, B, T, D]``
    (``tp.TPActState``) across a data-world resize (the JAX package's
    rule). Row r is data row r's pending activation error over its own
    fixed-size batch, so the data axis follows ``_resize_ring_residual``'s
    row rule: surviving rows copy bitwise, new rows (a grow) start at zero,
    dropped rows (a shrink) leave with their shards. Every other dimension
    is topology-independent, and a change there raises."""
    if h.shape[1:] != tuple(new_shape[1:]):
        raise ValueError(
            f"act_residual resize only moves the data axis: snapshot "
            f"{h.shape} vs template {tuple(new_shape)} differ beyond "
            f"dimension 0 — changing tp/layers/batch geometry across a "
            f"re-mesh is not a resize")
    n_new = int(new_shape[0])
    out = np.zeros(tuple(new_shape), h.dtype)
    n_keep = min(h.shape[0], n_new)
    out[:n_keep] = h[:n_keep]
    return out
