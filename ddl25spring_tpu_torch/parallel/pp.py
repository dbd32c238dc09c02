"""Pipeline parallelism: counterpart of the JAX package's ``parallel/pp.py``
(GPipe, 1F1B and interleaved schedules, the steps, the layout of
interleaved parameters, the stage-stacked numerics, the DP×PP ring drivers
and the stage re-partition of the elastic re-mesh).

The JAX package runs one SPMD program over a ``stage`` mesh axis: a
``lax.scan`` over ticks, the activation hop a ``ppermute``, the backward
pipeline the autodiff transpose of the scan. The port goes back to the
reference's homework: each stage is one OS process of a gloo group
(``distributed.pipeline_mesh``: rank ``d·S + s`` is stage ``s`` of data row
``d``), holding only its own parameters, and the hops are point-to-point
sends and receives with a tag per (microbatch, direction, lap)
(``distributed.Hops``; on the card each hop is staged through the host).
Each schedule computes only valid work: the JAX program's bubble ticks,
which run on garbage and are masked out, have no counterpart.

- **GPipe** (``_pipeline_loss_and_grad``): all M microbatches forward,
  keeping each autograd graph, then backward in reverse order; the last
  stage seeds each microbatch's loss with ``1/M`` (JAX's ``loss_sum /
  n_microbatches``). ``n_microbatches=1`` is the reference's naive
  staged pipeline.
- **1F1B** (``_pipeline_1f1b_loss_and_grad``), JAX's variant: iteration
  ``j`` runs a forward of microbatch ``j − s`` without a graph, stashing
  only its input in ``min(2S−1, M)`` slots, then a backward of
  microbatch ``j − 2(S−1) + s`` that recomputes the stage from its
  stashed input under autograd. So each stage runs its blocks' forward
  twice per microbatch, and holds at most ``2S−1`` inputs.
- **Interleaved** (``_pipeline_interleaved_loss_and_grad``, v =
  ``n_chunks``): stage ``s`` holds the layer chunks ``c·S + s``
  (``interleave_params`` permutes them into its contiguous slice), and
  each microbatch rides the ring v times; the last→first hop carries real
  activations between laps. M must be a multiple of S.

``_reduce_loss_and_grads``: block gradients need no reduction over
stages, and since each stage holds only the leaves it reads (``embed`` on
the first, ``final_norm`` and ``lm_head`` on the last: ``llama.
split_stages``), their gradients live on their one owner, so the JAX
package's ``pp_replicated_grads`` psum over ``stage`` has no counterpart.
The loss goes from the last stage to every rank of its stage group (a
``psum`` of zeros elsewhere, the JAX ``pp_loss_allreduce``), so that rank
0 can log it. At ``data > 1`` gradients and loss are averaged over the
data group for every stage (the reference's first-stage-only all-reduce
is a recorded bug the JAX package does not reproduce either).

The optimizer runs on the stage's local leaves (every optimizer the port
ships is elementwise), and the interleaved layout tag is put back after
every update. A stage state is a ``dp.TrainState`` whose ``pp`` field (a
``StageGeometry``) says where it sits in the whole model: ``checkpoint``
writes the merged JAX-layout state (``host_snapshot``, a gather over the
stage group) and re-slices it on resume (``slice_state``).

With a ``model`` axis (``pipeline_mesh(D, S, T)``: rank ``(d·S + s)·T +
m``) each stage runs Megatron tensor parallelism inside (``parallel/tp.py``'s
layout and sums, JAX's ``pp.py`` at ``tp > 1``): a (stage, model) cell holds
its stage's leaves with the column leaves (``wq wk wv w_gate w_up``) sliced
on their last dimension and the row leaves (``wo w_down``) on their middle
one (``_cell_tree``); the blocks sum their partial outputs over
``model_group`` (``tp._model_sum``), each model shard seeds ``loss / tp``,
and the replicated leaves' gradients (norm scales, and the owner stage's
``embed`` / ``final_norm`` / ``lm_head``) are summed over ``model_group``
(``tp_replicated_grads``) before the data sync. Every model shard of a
stage issues the same hops and sums in the same order, so their gloo
groups never wait on each other crosswise.

The DP×PP ring drivers (``make_pipeline_overlap_step``) sync the data axis
through ``compress``'s ring instead of the mean: each (stage, model) cell
rings the flat vector of its own leaves. Their per-rank state (ZeRO-1 moments, the int8
residuals) goes to the host in the whole model's coordinates
(``_stage_coord_ids``), so ``slice_state`` places it at any data × stage
grid: the checkpoint's resume and the elastic re-mesh's stage
re-partition (``repartition_stage_state``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import compress, dp, tp
from . import distributed as dist
from .compress import BucketMap
from .dp import TrainState, _loop
from ..config import LlamaConfig, torch_dtype
from ..models import llama
from ..ops.adam import apply_optimizer
from ..telemetry import introspect
from ..tree import (nested_leaves, nested_unflatten, trainable, tree_leaves,
                    tree_map, tree_unflatten)

_LAYOUT_KEY = "blocks_layout"
_FWD, _BWD = 0, 1


# ------------------------------------------------------- interleaved layout

def _layout_tag(n_stages: int, n_chunks: int) -> float:
    return float(n_stages * 1000 + n_chunks)


def _interleave_order(n_layers: int, n_stages: int,
                      n_chunks: int) -> List[int]:
    """Position ``s·(L/S) + c·per + l`` of the interleaved layout holds
    layer ``(c·S + s)·per + l``, with ``per = L/(S·v)``."""
    assert n_layers % (n_stages * n_chunks) == 0, (n_layers, n_stages,
                                                   n_chunks)
    per = n_layers // (n_stages * n_chunks)
    return [(c * n_stages + s) * per + l
            for s in range(n_stages)
            for c in range(n_chunks)
            for l in range(per)]


def interleave_blocks(blocks, n_stages: int, n_chunks: int):
    """Permute the stacked ``[L]`` block axis into the interleaved
    layout, so that stage s's contiguous slice holds its chunks ``c·S +
    s`` in chunk order."""
    def perm(x):
        order = _interleave_order(x.shape[0], n_stages, n_chunks)
        return x[torch.tensor(order, device=x.device)]

    return tree_map(perm, blocks)


def deinterleave_blocks(blocks, n_stages: int, n_chunks: int):
    """Inverse of ``interleave_blocks``."""
    def inv(x):
        order = _interleave_order(x.shape[0], n_stages, n_chunks)
        inverse = [0] * len(order)
        for pos, layer in enumerate(order):
            inverse[layer] = pos
        return x[torch.tensor(inverse, device=x.device)]

    return tree_map(inv, blocks)


def interleave_params(params, n_stages: int, n_chunks: int) -> dict:
    """``interleave_blocks`` over the parameter tree, plus the layout tag
    (an fp32 scalar ``S·1000 + v`` under ``blocks_layout``), which the
    steps check on their first call: the layouts have the same shapes, so
    a mistake could not be seen in the arrays."""
    params = llama.as_tree(params)
    out = dict(params, blocks=interleave_blocks(params["blocks"], n_stages,
                                                n_chunks))
    out[_LAYOUT_KEY] = torch.tensor(_layout_tag(n_stages, n_chunks),
                                    dtype=torch.float32,
                                    device=params["embed"].device)
    return out


def deinterleave_params(params, n_stages: int, n_chunks: int) -> dict:
    """Inverse of ``interleave_params`` (natural layer order, no tag)."""
    out = dict(params, blocks=deinterleave_blocks(params["blocks"], n_stages,
                                                  n_chunks))
    out.pop(_LAYOUT_KEY, None)
    return out


def _check_layout(params_tag, schedule: str, n_stages: int,
                  n_chunks: int) -> None:
    """``schedule="interleaved"`` demands the tag of exactly this (S, v);
    any other schedule demands its absence."""
    if schedule == "interleaved":
        want = _layout_tag(n_stages, n_chunks)
        if params_tag is None:
            raise ValueError(
                "schedule='interleaved' requires params permuted with "
                "interleave_params(params, n_stages, n_chunks) before "
                "init_state — natural-layout blocks would run layers "
                "in the wrong order")
        got = float(params_tag.detach())
        if got != want:
            raise ValueError(
                f"params were interleaved for a different topology "
                f"(tag {got:.0f}, expected {want:.0f} = "
                f"stages*1000+chunks)")
    elif params_tag is not None:
        raise ValueError(
            f"params carry the interleaved layout tag but "
            f"schedule={schedule!r} expects natural layer order — "
            f"undo with deinterleave_params first")


def _layout_guarded(step: Callable, schedule: str, n_stages: int,
                    n_chunks: int) -> Callable:
    """The layout check on the first call of ``step``."""
    checked = []

    def guarded(state: TrainState, tokens):
        if not checked:
            _check_layout(state.params.get(_LAYOUT_KEY), schedule,
                          n_stages, n_chunks)
            checked.append(True)
        return step(state, tokens)

    return guarded


# ------------------------------------------------------------ stage states

@dataclass(frozen=True)
class PPFlat:
    """The flat geometry of a DP×PP ring state (``_pp_overlap_setup``):
    this stage's padded flat vector of ``total`` coordinates and ``pad``
    zeros over ``n`` data rows of ``local`` each, whether the optimizer
    state is ZeRO-1 slices, and the bucket map (None at one bucket)."""

    n: int
    pad: int
    local: int
    total: int
    zero1: bool
    bm: Optional[BucketMap] = None


@dataclass(frozen=True)
class StageGeometry:
    """Where a stage state sits: the mesh, and ``skeleton``, the whole
    model's parameter tree (JAX layout, the layout tag included) as
    shapes on the ``meta`` device, from which ``host_snapshot`` sizes the
    leaves this stage does not hold. ``flat``: a ring state's flat
    geometry (None for the plain step's state)."""

    mesh: dist.PipelineMesh
    skeleton: dict
    flat: Optional[PPFlat] = None


class PPOverlapEFState(NamedTuple):
    """A stage's DP×PP ring state under ``wire="int8_ef"``: parameters,
    optimizer state and step as ``dp.TrainState``'s, this rank's ring
    residual (``[n·local]`` over its stage's flat vector; JAX's ``[n, S,
    n·local]`` stack row) and second-leg residual (``[local]``), per-bucket
    tuples at ``comm_buckets > 1``, and the stage geometry."""
    params: Any
    opt_state: Any
    step: torch.Tensor
    ring_residual: Any
    gather_residual: Any
    pp: StageGeometry

    PER_RANK_FIELDS = ("ring_residual", "gather_residual")


def _stage_tree(params: dict, n_stages: int, s: int) -> dict:
    """Stage ``s``'s slice of a whole (JAX-layout) tree, the layout tag
    on every stage."""
    tag = params.get(_LAYOUT_KEY)
    local = llama.split_stages(
        {k: v for k, v in params.items() if k != _LAYOUT_KEY}, n_stages)[s]
    if tag is not None:
        local[_LAYOUT_KEY] = tag
    return local


def _take(x, dim: Optional[int], n: int, index: int):
    """Slice ``index`` of ``n`` of ``x`` (a tensor or numpy array) along
    ``dim`` (None: ``x`` itself), as a view."""
    if dim is None or n == 1:
        return x
    size = x.shape[dim] // n
    return x[(slice(None),) * dim + (slice(index * size,
                                           (index + 1) * size),)]


def _model_specs(local: dict) -> dict:
    """``tp.param_specs`` of a stage tree: the sliced dimension of each
    column and row block leaf, None elsewhere (the layout tag too)."""
    return {k: (tp.param_specs({"blocks": v})["blocks"] if k == "blocks"
                else tree_map(lambda _: None, v)) for k, v in local.items()}


def _cell_tree(params: dict, mesh: dist.PipelineMesh) -> dict:
    """This (stage, model) cell's slice of a whole tree: ``_stage_tree``,
    then model shard ``mesh.m``'s slice of each column leaf (last dim) and
    row leaf (middle dim), JAX's ``P("stage", None, "model")`` /
    ``P("stage", "model", None)``; views."""
    local = _stage_tree(params, mesh.stage, mesh.s)
    if mesh.model == 1:
        return local
    specs = _model_specs(local)
    for x, d in zip(tree_leaves(local), tree_leaves(specs)):
        if d is not None and x.shape[d] % mesh.model:
            raise ValueError(f"a block leaf of shape {tuple(x.shape)} does "
                             f"not split over model={mesh.model} on dim {d}")
    return tree_map(lambda x, d: _take(x, d, mesh.model, mesh.m), local,
                    specs)


def _replicated(local: dict) -> list:
    """Per leaf of a stage tree (``tree_leaves`` order): whether every
    model shard holds it whole."""
    return [d is None for d in tree_leaves(_model_specs(local))]


def init_state(mesh: dist.PipelineMesh, params, optimizer,
               device=None) -> TrainState:
    """This rank's stage state from the whole parameter tree (a ``Llama``
    or its tree, JAX layout; ``interleave_params``'s for the interleaved
    schedule): its cell's leaves (``_cell_tree``: the stage's, model-sliced
    on a model axis) as fresh tensors on ``device`` (None: CUDA, raising
    without a card), the optimizer state for them alone."""
    dev = dist.rank_device(device)
    params = llama.as_tree(params)
    skeleton = tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                              device="meta"), params)
    local = trainable(tree_map(
        lambda x: x.detach().to(dev, copy=True).contiguous(),
        _cell_tree(params, mesh)))
    return TrainState(local, optimizer.init(local),
                      torch.zeros((), dtype=torch.int32, device=dev),
                      pp=StageGeometry(mesh, skeleton))


def _params_like(node, keys) -> bool:
    return isinstance(node, dict) and set(node) == keys


def _map_params_like(node, keys, fn, other):
    """Walk a state (tuples, NamedTuples, dicts): ``fn`` on every subtree
    shaped like the stage's parameter tree (parameters, moments, master
    weights), ``other`` on every other leaf."""
    if _params_like(node, keys):
        return fn(node)
    if isinstance(node, tuple):
        items = [_map_params_like(x, keys, fn, other) for x in node]
        return type(node)(*items) if hasattr(node, "_fields") \
            else tuple(items)
    return other(node)


def _whole(local: dict, skeleton: dict, make: Callable) -> dict:
    """A tree of ``skeleton``'s structure and shapes, each top-level entry
    in the dtype of this stage's own copy (its blocks' dtype for an entry
    it does not hold); ``make(shape, dtype)`` makes each leaf."""
    fallback = tree_leaves(local["blocks"])[0].dtype
    out = {}
    for key, sub in skeleton.items():
        dtype = tree_leaves(local[key])[0].dtype if key in local else fallback
        out[key] = tree_map(lambda x, dt=dtype: make(x.shape, dt), sub)
    return out


def _sum_cells(x, mesh: dist.PipelineMesh):
    """A tree or tensor summed over the stage group, then over the model
    group (a collective over the data row)."""
    summed = (dist.psum_tree if isinstance(x, dict) else
              lambda t, **kw: dist.psum(t, **kw))
    x = summed(x, record=False, group=mesh.stage_group)
    if mesh.model > 1:
        x = summed(x, record=False, group=mesh.model_group)
    return x


def _merge_params_like(local: dict, geom: StageGeometry) -> dict:
    """The whole tree from every cell's ``local`` (a collective over the
    data row): each rank writes the rows, model slices and leaves it holds
    into a zero tree of the skeleton's shapes (a replicated leaf from model
    shard 0 only, the layout tag from cell (0, 0) only), and the trees are
    summed over the stages and the model shards."""
    mesh = geom.mesh
    device = tree_leaves(local["blocks"])[0].device
    whole = _whole(local, geom.skeleton, lambda shape, dt: torch.zeros(
        shape, dtype=dt, device=device))
    specs = _model_specs(local)
    with torch.no_grad():
        for key, sub in local.items():
            if key == "blocks":
                per = tree_leaves(sub)[0].shape[0]
                rows = slice(mesh.s * per, (mesh.s + 1) * per)
                tree_map(lambda w, x, d: _take(w[rows], d, mesh.model,
                                               mesh.m).copy_(x)
                         if d is not None or mesh.m == 0 else None,
                         whole[key], sub, specs[key])
            elif (key != _LAYOUT_KEY or mesh.s == 0) and mesh.m == 0:
                tree_map(lambda w, x: w.copy_(x), whole[key], sub)
    return _sum_cells(whole, mesh)


def host_snapshot(state: TrainState) -> TrainState:
    """The merged JAX-layout state of a stage state, as CPU tensors: the
    stages' parameters and every parameter-shaped part of the optimizer
    state (moments, master weights) joined by ``merge_stages``'s rule
    (a collective: every rank of the stage group calls it); the step and
    the optimizer's count are the same on every stage. A data-parallel
    state of the same model has this structure, so one checkpoint file
    format serves both."""
    geom = state.pp
    if geom.flat is not None:
        return _ring_snapshot(state)
    keys = set(state.params)

    def merge(node):
        return tree_map(lambda x: x.detach().cpu().clone(),
                        _merge_params_like(node, geom))

    def other(x):
        return x.detach().cpu().clone() if isinstance(x, torch.Tensor) else x

    params = merge(state.params)
    opt_state = _map_params_like(state.opt_state, keys, merge, other)
    return TrainState(params, opt_state, other(state.step))


def merged_template(state: TrainState) -> TrainState:
    """``host_snapshot``'s structure and shapes for a stage state, on the
    ``meta`` device (no collective): the template a checkpoint reads
    into before ``slice_state``."""
    geom = state.pp
    keys = set(state.params)

    def whole(node):
        return _whole(node, geom.skeleton, lambda shape, dt: torch.empty(
            shape, dtype=dt, device="meta"))

    if geom.flat is not None:
        return _ring_template(state, whole(state.params))
    return TrainState(whole(state.params),
                      _map_params_like(state.opt_state, keys, whole,
                                       lambda x: x),
                      state.step)


def slice_state(host: TrainState, template: TrainState) -> TrainState:
    """A merged host state (``host_snapshot``'s, or a data-parallel
    checkpoint of the same model) re-sliced to ``template``'s stage, on
    its devices and dtypes. Returns a new state."""
    mesh = template.pp.mesh
    keys = set(template.params)
    if template.pp.flat is not None:
        return _place_ring_state(host, template)

    def place(h, t):
        h = (h.detach().cpu() if isinstance(h, torch.Tensor)
             else torch.from_numpy(np.array(h)))
        if tuple(h.shape) != tuple(t.shape):
            raise ValueError(f"leaf of shape {tuple(h.shape)} does not fit "
                             f"the stage's {tuple(t.shape)}")
        return h.to(device=t.device, dtype=t.dtype,
                    copy=True).requires_grad_(t.requires_grad)

    def walk(h, t):
        if _params_like(t, keys):
            return tree_map(place, _cell_tree(h, mesh), t)
        if isinstance(t, tuple):
            items = [walk(a, b) for a, b in zip(h, t)]
            return type(t)(*items) if hasattr(t, "_fields") else tuple(items)
        return place(h, t) if isinstance(t, torch.Tensor) else t

    return TrainState(walk(host.params, template.params),
                      walk(host.opt_state, template.opt_state),
                      walk(host.step, template.step), pp=template.pp)


def _place_leaf(h, t):
    """A host leaf (tensor or array) as a copy on ``t``'s device and
    dtype, its shape checked."""
    h = (h.detach().cpu() if isinstance(h, torch.Tensor)
         else torch.from_numpy(np.array(h)))
    if tuple(h.shape) != tuple(t.shape):
        raise ValueError(f"leaf of shape {tuple(h.shape)} does not fit "
                         f"the stage's {tuple(t.shape)}")
    return h.to(device=t.device, dtype=t.dtype,
                copy=True).requires_grad_(t.requires_grad)


def global_leaf_map(state: TrainState) -> Dict[int, int]:
    """1-based leaf index of the whole tree (``tree_leaves`` order, the
    JAX package's) → 1-based index of the same leaf in this stage's tree,
    for the leaves this stage holds (every block leaf, as a slice): the
    ``FaultPlan`` targets of a stage process."""
    local = introspect.leaf_paths(state.params)
    return {i + 1: local.index(p) + 1 for i, p in
            enumerate(introspect.leaf_paths(state.pp.skeleton))
            if p in local}


# ------------------------------------------------------------ the schedules

def _tag(lap: int, i: int, direction: int, n_microbatches: int) -> int:
    return (lap * n_microbatches + i) * 2 + direction


def _run_stage(p: dict, x, tok, cfg: LlamaConfig, *, first: bool,
               last: bool, blocks=None, tp_sum=None):
    """One stage on one microbatch: embeds ``tok`` if first (``x`` is
    then unused), runs ``blocks`` (default the stage's; ``tp_sum``, the
    model-axis sum of a tensor-parallel cell), and returns the head's loss
    if last, else the activations."""
    h = llama.embed(p, tok, cfg) if first else x
    h = llama.blocks_apply(p["blocks"] if blocks is None else blocks, h, cfg,
                           tp_sum=tp_sum)
    return llama.head_loss(p, h, tok, cfg) if last else h


def _backward(out, seed, x, leaves, acc, hops, to: int, tag: int):
    """Differentiate ``out`` against ``seed`` with respect to the stage's
    ``leaves`` (leaves this microbatch did not read get zeros) and, if
    ``x`` is an input that came over a hop, send its cotangent back to
    stage ``to``. Returns the gradients added to ``acc``."""
    inputs = leaves if x is None else leaves + [x]
    gs = list(torch.autograd.grad(out, inputs, seed, allow_unused=True,
                                  materialize_grads=True))
    if x is not None:
        hops.send(gs.pop(), to, tag=tag, label="pp_cotangent_hop")
    return gs if acc is None else [a + g for a, g in zip(acc, gs)]


class _Step:
    """What a schedule needs for one call: the stage's place, the
    microbatches, the hop shape and dtype, the loss seed (``1/(M·tp)``:
    every model shard seeds its replica of the loss, JAX's ``loss_sum /
    n_microbatches / tp``) and the model-axis sum."""

    def __init__(self, mesh, tokens, cfg: LlamaConfig, n_microbatches: int):
        b, t = tokens.shape
        assert b % n_microbatches == 0, (b, n_microbatches)
        self.s, self.n = mesh.s, mesh.stage
        self.first, self.last = self.s == 0, self.s == self.n - 1
        self.m, self.tp = n_microbatches, mesh.model
        self.tp_sum = (tp._model_sum(mesh.model_group) if mesh.model > 1
                       else None)
        self.mbs = tokens.reshape(n_microbatches, b // n_microbatches, t)
        self.shape = (b // n_microbatches, t, cfg.dmodel)
        self.dtype = torch_dtype(cfg.dtype)
        self.seed = torch.tensor(1.0 / (n_microbatches * self.tp),
                                 dtype=torch.float32, device=tokens.device)
        self.loss_sum = torch.zeros((), dtype=torch.float32,
                                    device=tokens.device)

    def recv(self, hops, frm: int, tag: int) -> torch.Tensor:
        return hops.recv(frm, self.shape, self.dtype,
                         tag=tag).requires_grad_()


def _pipeline_loss_and_grad(params: dict, leaves: list, tokens, cfg,
                            mesh, n_microbatches: int, hops):
    """GPipe: every microbatch forward with its graph kept, then backward
    in reverse. Returns this stage's loss (the microbatch mean over tp on
    the last stage, 0 elsewhere) and its gradients, one per ``leaves``."""
    st = _Step(mesh, tokens, cfg, n_microbatches)
    tape = []
    for i in range(st.m):
        x = None if st.first else st.recv(hops, st.s - 1,
                                          _tag(0, i, _FWD, st.m))
        out = _run_stage(params, x, st.mbs[i], cfg, first=st.first,
                         last=st.last, tp_sum=st.tp_sum)
        if st.last:
            st.loss_sum = st.loss_sum + out.detach()
        else:
            hops.send(out, st.s + 1, tag=_tag(0, i, _FWD, st.m),
                      label="pp_activation_hop")
        tape.append((x, out))
    grads = None
    for i in reversed(range(st.m)):
        x, out = tape.pop()
        seed = st.seed if st.last else hops.recv(
            st.s + 1, st.shape, st.dtype, tag=_tag(0, i, _BWD, st.m))
        grads = _backward(out, seed, x, leaves, grads, hops, st.s - 1,
                          _tag(0, i, _BWD, st.m))
    return st.loss_sum / st.m / st.tp, grads


def _pipeline_1f1b_loss_and_grad(params: dict, leaves: list, tokens, cfg,
                                 mesh, n_microbatches: int, hops):
    """1F1B, the JAX variant: iteration j forwards microbatch ``j − s``
    without a graph (stashing only its input) and backs up microbatch
    ``j − 2(S−1) + s`` by recomputing the stage from its stash. The last
    stage backs up a microbatch in the iteration that forwards it; a
    cotangent moves one stage down per iteration."""
    st = _Step(mesh, tokens, cfg, n_microbatches)
    n_slots = min(2 * st.n - 1, st.m)
    stash: List[Optional[torch.Tensor]] = [None] * n_slots
    grads = None
    for j in range(st.m + 2 * (st.n - 1)):
        i_f = j - st.s
        if 0 <= i_f < st.m:
            x = None if st.first else hops.recv(
                st.s - 1, st.shape, st.dtype, tag=_tag(0, i_f, _FWD, st.m))
            stash[i_f % n_slots] = x
            with torch.no_grad():
                # The last stage's output goes nowhere (JAX's program
                # runs it alike): its blocks only, no head.
                h = _run_stage(params, x, st.mbs[i_f], cfg, first=st.first,
                               last=False, tp_sum=st.tp_sum)
            if not st.last:
                hops.send(h, st.s + 1, tag=_tag(0, i_f, _FWD, st.m),
                          label="pp_activation_hop")
        i_b = j - 2 * (st.n - 1) + st.s
        if 0 <= i_b < st.m:
            x = stash[i_b % n_slots]
            if x is not None:
                x = x.detach().requires_grad_()
            out = _run_stage(params, x, st.mbs[i_b], cfg, first=st.first,
                             last=st.last, tp_sum=st.tp_sum)
            if st.last:
                st.loss_sum = st.loss_sum + out.detach()
                seed = st.seed
            else:
                seed = hops.recv(st.s + 1, st.shape, st.dtype,
                                 tag=_tag(0, i_b, _BWD, st.m))
            grads = _backward(out, seed, x, leaves, grads, hops, st.s - 1,
                              _tag(0, i_b, _BWD, st.m))
    return st.loss_sum / st.m / st.tp, grads


def _pipeline_interleaved_loss_and_grad(params: dict, leaves: list, tokens,
                                        cfg, mesh, n_microbatches: int,
                                        hops, n_chunks: int = 2):
    """Interleaved virtual stages: stage s runs chunk c (layers ``c·S +
    s``, the c-th ``per``-layer slice of its interleaved blocks) of each
    microbatch, in JAX's tick order: relative tick r is microbatch ``g·S +
    (r mod S)`` of group ``g = r // (v·S)`` on chunk ``(r mod v·S) // S``.
    A microbatch enters on stage 0's chunk 0 and leaves, with its loss,
    on stage S−1's chunk v−1; between laps stage S−1 hands it to stage 0.
    Backward in reverse tick order, GPipe's rule."""
    st = _Step(mesh, tokens, cfg, n_microbatches)
    v, n = n_chunks, st.n
    assert st.m % n == 0, (st.m, n)
    per = tree_leaves(params["blocks"])[0].shape[0] // v
    chunks = [tree_map(lambda x, c=c: x[c * per:(c + 1) * per],
                       params["blocks"]) for c in range(v)]
    prev, nxt = (st.s - 1) % n, (st.s + 1) % n
    tape = []
    for r in range(v * st.m):
        cyc = r % (v * n)
        c, i = cyc // n, r // (v * n) * n + cyc % n
        embeds = st.first and c == 0
        exits = st.last and c == v - 1
        x = None if embeds else st.recv(
            hops, prev, _tag(c if st.s else c - 1, i, _FWD, st.m))
        out = _run_stage(params, x, st.mbs[i], cfg, first=embeds,
                         last=exits, blocks=chunks[c], tp_sum=st.tp_sum)
        if exits:
            st.loss_sum = st.loss_sum + out.detach()
        else:
            hops.send(out, nxt, tag=_tag(c, i, _FWD, st.m),
                      label="pp_activation_hop")
        tape.append((c, i, x, out, exits))
    grads = None
    while tape:
        c, i, x, out, exits = tape.pop()
        seed = st.seed if exits else hops.recv(
            nxt, st.shape, st.dtype,
            tag=_tag(c if not st.last else c + 1, i, _BWD, st.m))
        grads = _backward(out, seed, x, leaves, grads, hops, prev,
                          _tag(c, i, _BWD, st.m))
    return st.loss_sum / st.m / st.tp, grads


def _schedule_body(schedule: str, n_chunks: int) -> Callable:
    """The loss-and-gradient body of a schedule name: the one lookup every
    step factory goes through."""
    if schedule == "interleaved":
        return lambda *a: _pipeline_interleaved_loss_and_grad(
            *a, n_chunks=n_chunks)
    try:
        return {"gpipe": _pipeline_loss_and_grad,
                "1f1b": _pipeline_1f1b_loss_and_grad}[schedule]
    except KeyError:
        raise ValueError(f"unknown schedule {schedule!r}: expected 'gpipe', "
                         "'1f1b' or 'interleaved'") from None


def _reduce_loss_and_grads(loss, grads, params, mesh,
                           data_sync: bool = True):
    """The loss from the last stage to every stage (a ``psum`` over the
    stage group, zeros elsewhere, times tp to undo the seed's 1/tp); on a
    model axis the replicated leaves' gradients summed over the model
    group (``tp_replicated_grads``, one record per leaf, JAX's per-leaf
    psum; ``params`` gives their places); at ``data > 1`` (and
    ``data_sync``) the gradients and the loss averaged over the data
    group, for every stage. Block gradients need no reduction over stages,
    and the gradients of ``embed``, ``final_norm`` and ``lm_head`` live on
    their one owner stage. The ring drivers pass ``data_sync=False``: their
    ring is the data sync."""
    loss = dist.psum(loss, label="pp_loss_allreduce",
                     group=mesh.stage_group) * mesh.model
    if mesh.model > 1:
        grads = tree_unflatten(grads, tp._sum_replicated(
            params, tree_leaves(grads), mesh.model_group))
    if mesh.data > 1 and data_sync:
        grads = dist.pmean_tree(grads, label="grad_allreduce",
                                group=mesh.data_group)
        loss = dist.pmean(loss, label="loss_allreduce",
                          group=mesh.data_group)
    return loss, grads


# ---------------------------------------------------------------- the steps

def _loss_and_grad(body: Callable, params: dict, tokens, cfg, mesh,
                   n_microbatches: int, device, data_sync: bool = True):
    """One schedule over this stage's ``params``: the reduced loss and the
    stage's gradient tree (zeros for the layout tag), every hop done."""
    diff = {k: p for k, p in params.items() if k != _LAYOUT_KEY}
    hops = dist.Hops(mesh.stage_group, device)
    loss, grads = body(params, tree_leaves(diff), tokens, cfg, mesh,
                       n_microbatches, hops)
    hops.finish()
    grad_tree = tree_unflatten(diff, grads)
    if _LAYOUT_KEY in params:
        grad_tree[_LAYOUT_KEY] = torch.zeros_like(params[_LAYOUT_KEY])
    return _reduce_loss_and_grads(loss, grad_tree, params, mesh, data_sync)


def loss_and_grad(state: TrainState, tokens, cfg: LlamaConfig,
                  mesh: dist.PipelineMesh, n_microbatches: int = 1,
                  schedule: str = "gpipe", n_chunks: int = 2,
                  device=None):
    """The step's loss and this stage's gradient tree (averaged over the
    data rows), without an optimizer apply: what ``make_pipeline_step``
    feeds its optimizer, for checks against a world of one."""
    dev = dist.rank_device(device)
    _check_layout(state.params.get(_LAYOUT_KEY), schedule, mesh.stage,
                  n_chunks)
    return _loss_and_grad(_schedule_body(schedule, n_chunks), state.params,
                          torch.as_tensor(tokens, dtype=torch.long,
                                          device=dev),
                          cfg, mesh, n_microbatches, dev)


def _make_pp_local_step(cfg: LlamaConfig, optimizer, body: Callable,
                        mesh: dist.PipelineMesh, n_microbatches: int,
                        device: torch.device, numerics=None) -> Callable:
    """The stage's step body, shared by ``make_pipeline_step`` and
    ``make_pipeline_multi_step`` (so K-step is K per-step calls by
    construction): the schedule, the reductions, the optimizer on the
    stage's leaves in place, the layout tag put back. ``numerics``
    (``make_pp_numerics``): the second output becomes ``(loss,
    NumericsSummary)``, from a copy of the parameters taken before the
    update."""

    def local_step(state: TrainState, tokens: torch.Tensor):
        params = state.params
        tag = params.get(_LAYOUT_KEY)
        loss, grad_tree = _loss_and_grad(body, params, tokens, cfg, mesh,
                                         n_microbatches, device)
        old = (tree_map(lambda x: x.detach().clone(), params)
               if numerics is not None else None)
        pinned = tag.detach().clone() if tag is not None else None
        params, opt_state = apply_optimizer(optimizer, grad_tree,
                                            state.opt_state, params)
        if tag is not None:
            with torch.no_grad():
                params[_LAYOUT_KEY].copy_(pinned)
        new_state = state._replace(opt_state=opt_state, step=state.step + 1)
        if numerics is not None:
            return new_state, (loss, numerics.summarize(old, grad_tree,
                                                        params))
        return new_state, loss

    return local_step


def make_pipeline_step(cfg: LlamaConfig, optimizer, mesh: dist.PipelineMesh,
                       n_microbatches: int = 1, schedule: str = "gpipe",
                       n_chunks: int = 2, numerics=None,
                       device=None) -> Callable:
    """``step(state, tokens) -> (state, loss)`` for this rank's stage
    (``init_state``'s state) on its data row's ``[B, T]`` batch (every
    stage of a row gets the same tokens: the first embeds them, the last
    takes its labels from them), on ``device`` (None: CUDA, raising
    without a card). ``schedule``: "gpipe", "1f1b" or "interleaved" (with
    ``n_chunks`` chunks per stage, parameters from ``interleave_params``,
    M a multiple of S); the layout is checked on the first call. The loss
    is the data rows' mean of the microbatch mean, the same on every
    rank. ``optimizer`` must be elementwise (every one the port ships)."""
    dev = dist.rank_device(device)
    local = _make_pp_local_step(cfg, optimizer,
                                _schedule_body(schedule, n_chunks), mesh,
                                n_microbatches, dev, numerics)

    def step(state: TrainState, tokens):
        return local(state, torch.as_tensor(tokens, dtype=torch.long,
                                            device=dev))

    return _layout_guarded(step, schedule, mesh.stage, n_chunks)


def make_pipeline_multi_step(cfg: LlamaConfig, optimizer,
                             mesh: dist.PipelineMesh, n_microbatches: int = 1,
                             schedule: str = "gpipe", n_chunks: int = 2,
                             numerics=None, device=None) -> Callable:
    """``step(state, window) -> (state, losses)`` over a ``[K, B, T]``
    window of K consecutive steps: K calls of ``make_pipeline_step``'s
    body, so the losses and the state are bitwise K per-step calls. K is
    the window's leading dim."""
    dev = dist.rank_device(device)
    multi = _loop(_make_pp_local_step(cfg, optimizer,
                                      _schedule_body(schedule, n_chunks),
                                      mesh, n_microbatches, dev, numerics))

    def step(state: TrainState, window):
        return multi(state, torch.as_tensor(window, dtype=torch.long,
                                            device=dev))

    return _layout_guarded(step, schedule, mesh.stage, n_chunks)


def shard_batch(mesh: dist.PipelineMesh, batch, device=None) -> torch.Tensor:
    """This rank's data row of a global ``[D·B, T]`` batch, on ``device``
    (the JAX ``shard_batch`` over ``data``)."""
    b = batch.shape[-2] // mesh.data
    return torch.as_tensor(batch[..., mesh.d * b:(mesh.d + 1) * b, :],
                           dtype=torch.long, device=dist.rank_device(device))


def shard_batch_window(mesh: dist.PipelineMesh, window,
                       device=None) -> torch.Tensor:
    """This rank's data row of a ``[K, D·B, T]`` window."""
    return shard_batch(mesh, window, device)


# ------------------------------------------------- the DP×PP ring drivers
# The JAX package's DP×PP composition: the data-axis gradient sync of a
# pipeline step routed through PR 13's compressed and overlapped ring
# (``compress._make_overlap_local_step``), with ZeRO-1 moments and the
# int8 residuals per (data row, stage). The port keeps its own stage
# layout: each stage rings the flat vector of the leaves it holds (its
# block slice, ``embed`` on the first, ``final_norm`` and ``lm_head`` on
# the last), where every JAX stage carries the stage-replicated leaves in
# its vector and agrees its int8 scales over ``stage`` to keep those
# replicas equal. Here nothing is replicated over stages, so at model 1 the
# scales are the data row's alone, and the per-stage vectors differ in
# length. On a model axis each (stage, model) cell rings its own flat
# vector (column and row leaves at 1/tp, JAX's ``[n, S, tp, ·]`` layout
# rule), and the cells of a stage carry the model-replicated leaves (norm
# scales, the owner's embed and head), so their int8 scales are agreed
# over the model group (JAX agrees them over ``("stage", "model")``; the
# stage part has nothing to protect here).


def _pp_flat_geometry(mesh: dist.PipelineMesh, params
                      ) -> Tuple[int, int, int, int]:
    """``(n, pad, local, total)`` of this cell's padded flat vector: the
    stage's own leaves (the layout tag included; column and row leaves at
    1/tp on a model axis, JAX's count) over ``n`` = the data axis size.
    Unlike the JAX geometry, the length differs per stage."""
    local = _cell_tree(llama.as_tree(params), mesh)
    total = sum(x.numel() for x in tree_leaves(local))
    n = mesh.data
    pad = (-total) % n
    return n, pad, (total + pad) // n, total


def _pp_bucket_map(mesh: dist.PipelineMesh, params, comm_buckets: int):
    """The DP×PP ``BucketMap``: ``compress.make_bucket_map`` over this
    cell's own leaves; None at ``comm_buckets == 1``."""
    if int(comm_buckets) < 1:
        raise ValueError(
            f"comm_buckets must be >= 1 (got {comm_buckets})")
    if int(comm_buckets) == 1:
        return None
    return compress.make_bucket_map(_cell_tree(llama.as_tree(params), mesh),
                                    mesh.data, comm_buckets)


def _pp_overlap_setup(optimizer, mesh: dist.PipelineMesh, params, wire: str,
                      aggregation: str, schedule: str, n_chunks: int,
                      comm_buckets: int = 1, device=None):
    """This rank's DP×PP ring state, with JAX's validations in its order
    and with its texts: the cell's leaves, the optimizer state (ZeRO-1:
    over this data row's chunk of the cell's flat vector, per bucket at
    ``comm_buckets > 1``; else over the cell's leaves), and under
    ``int8_ef`` the ring residual ``[n·local]`` and second-leg residual
    ``[local]`` of this (data row, stage[, model shard]), zero (JAX's
    ``[n, S(, tp), ·]`` stacks, one row each). The geometry rides in
    ``state.pp.flat``."""
    if aggregation not in ("gradient", "zero1"):
        raise ValueError("the DP×PP overlap driver supports gradient/zero1 "
                         f"aggregation only (got {aggregation!r})")
    if wire not in ("fp32", "bf16", "int8_ef"):
        raise ValueError(f"unknown wire format {wire!r}")
    if "data" not in mesh.shape:
        raise ValueError("the DP×PP overlap driver needs a mesh with a "
                         "'data' axis (size 1 is fine) — build it with "
                         'make_mesh({"data": d, "stage": s})')
    if mesh.shape.get("dcn", 1) > 1:
        raise ValueError("the DP×PP overlap driver runs the flat data ring "
                         "only; the hierarchical (dcn x data) tier is the "
                         "DP trainer's (parallel/compress.py)")
    params = llama.as_tree(params)
    _check_layout(params.get(_LAYOUT_KEY), schedule, mesh.stage, n_chunks)
    n, pad, local, total = _pp_flat_geometry(mesh, params)
    bm = _pp_bucket_map(mesh, params, comm_buckets)
    dev = dist.rank_device(device)
    skeleton = tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                              device="meta"), params)
    mine = trainable(tree_map(
        lambda x: x.detach().to(dev, copy=True).contiguous(),
        _cell_tree(params, mesh)))
    d = mesh.d
    if aggregation == "zero1":
        if bm is None:
            flat = dp._flat_fp32(tree_leaves(mine), pad)
            opt_state = optimizer.init(
                flat[d * local:(d + 1) * local].clone())
        else:
            vecs = compress._bucket_vectors(bm, mine)
            opt_state = tuple(optimizer.init(
                vecs[b][d * bm.sizes[b]:(d + 1) * bm.sizes[b]].clone())
                for b in range(bm.nbuckets))
    else:
        opt_state = optimizer.init(mine)
    geom = StageGeometry(mesh, skeleton, PPFlat(n, pad, local, total,
                                                aggregation == "zero1", bm))
    step = torch.zeros((), dtype=torch.int32, device=dev)
    if wire != "int8_ef":
        return TrainState(mine, opt_state, step, pp=geom)

    def zeros(k):
        return torch.zeros(k, dtype=torch.float32, device=dev)

    if bm is None:
        ring, gather = zeros(n * local), zeros(local)
    else:
        ring = tuple(zeros(n * sz) for sz in bm.sizes)
        gather = tuple(zeros(sz) for sz in bm.sizes)
    return PPOverlapEFState(mine, opt_state, step, ring, gather, geom)


def _make_pp_overlap_local_step(cfg: LlamaConfig, optimizer, body: Callable,
                                mesh: dist.PipelineMesh, n_microbatches: int,
                                device: torch.device, flat: PPFlat, *,
                                microbatches: int, wire: str,
                                aggregation: str, numerics=None) -> Callable:
    """The stage's overlapped step, shared by ``make_pipeline_overlap_step``
    and ``make_pipeline_overlap_multi_step`` (the JAX body, in eager
    order): ``compress._make_overlap_local_step`` over the data group,
    slice ``mesh.d``, labels ``pp_...``. The local batch splits into M
    sync microbatches; each runs the whole pipeline schedule (its own
    ``n_microbatches``) with the stage group's loss sum but without the
    data-axis mean, and hands the stage's gradient to the ring thread,
    which rings it over the data group while the next microbatch's
    schedule runs. The reduced chunks feed the ZeRO-1 slice update and the
    parameter gather (an int8 delta under ``int8_ef``), or the gradient
    gather and the replicated update. The interleaved layout tag is put
    back after the update. On a model axis the int8 scales are agreed over
    the model group (the ring thread's on ``ring_model_group``, the gather
    leg's on ``model_group``), so every model shard decodes the replicated
    leaves alike and their replicas stay bitwise equal."""

    def grads(params, leaves, batch, ringer, m):
        loss, grad_tree = _loss_and_grad(body, params, batch, cfg, mesh,
                                         n_microbatches, device,
                                         data_sync=False)
        g = tree_leaves(grad_tree)
        ringer.put(m, g)
        return loss, g

    inner = compress._make_overlap_local_step(
        None, optimizer, flat.n, flat.pad, flat.local, flat.total,
        microbatches=microbatches, wire=wire, aggregation=aggregation,
        bucket_map=flat.bm, numerics=numerics, grads_fn=grads, prefix="pp_",
        shard=mesh.d, data_group=mesh.data_group,
        scale_sync_groups=((mesh.ring_model_group, mesh.model_group)
                           if mesh.model > 1 else (None, None)))

    def local_step(state, tokens: torch.Tensor):
        tag = state.params.get(_LAYOUT_KEY)
        pinned = tag.detach().clone() if tag is not None else None
        new_state, out = inner(state, tokens)
        if pinned is not None:
            with torch.no_grad():
                new_state.params[_LAYOUT_KEY].copy_(pinned)
        return new_state, out

    return local_step


def _overlap_driver(cfg, optimizer, mesh, params, *, n_microbatches,
                    schedule, n_chunks, aggregation, wire,
                    overlap_microbatches, comm_buckets, numerics, device):
    dev = dist.rank_device(device)
    body = _schedule_body(schedule, n_chunks)
    state = _pp_overlap_setup(optimizer, mesh, params, wire, aggregation,
                              schedule, n_chunks, comm_buckets, dev)
    return state, dev, _make_pp_overlap_local_step(
        cfg, optimizer, body, mesh, n_microbatches, dev, state.pp.flat,
        microbatches=overlap_microbatches, wire=wire,
        aggregation=aggregation, numerics=numerics)


def make_pipeline_overlap_step(cfg: LlamaConfig, optimizer,
                               mesh: dist.PipelineMesh, params, *,
                               n_microbatches: int = 1,
                               schedule: str = "gpipe", n_chunks: int = 2,
                               aggregation: str = "zero1",
                               wire: str = "fp32",
                               overlap_microbatches: int = 1,
                               comm_buckets: int = 1, numerics=None,
                               device=None):
    """The per-step DP×PP ring driver: ``(state, step)``, ``step(state,
    tokens) -> (state, loss)`` on this rank's data row ``[B, T]``, with
    the data-axis gradient sync through the compressed and overlapped ring
    (semantics in ``_make_pp_overlap_local_step``; ``params`` the whole
    JAX-layout tree, ``interleave_params``'s for the interleaved
    schedule). The state is a ``PPOverlapEFState`` under
    ``wire="int8_ef"``, a ``dp.TrainState`` otherwise, with ZeRO-1
    moments per (data row, stage) under ``aggregation="zero1"``;
    ``comm_buckets > 1``: per-bucket rings."""
    state, dev, local = _overlap_driver(
        cfg, optimizer, mesh, params, n_microbatches=n_microbatches,
        schedule=schedule, n_chunks=n_chunks, aggregation=aggregation,
        wire=wire, overlap_microbatches=overlap_microbatches,
        comm_buckets=comm_buckets, numerics=numerics, device=device)

    def step(state, tokens):
        return local(state, torch.as_tensor(tokens, dtype=torch.long,
                                            device=dev))

    return state, step


def make_pipeline_overlap_multi_step(cfg: LlamaConfig, optimizer,
                                     mesh: dist.PipelineMesh, params, *,
                                     n_microbatches: int = 1,
                                     schedule: str = "gpipe",
                                     n_chunks: int = 2,
                                     aggregation: str = "zero1",
                                     wire: str = "fp32",
                                     overlap_microbatches: int = 1,
                                     comm_buckets: int = 1, numerics=None,
                                     device=None):
    """``make_pipeline_overlap_step``'s body over a ``[K, B, T]`` window:
    the losses and the final state (moments and residuals included) are
    bitwise K per-step calls."""
    state, dev, local = _overlap_driver(
        cfg, optimizer, mesh, params, n_microbatches=n_microbatches,
        schedule=schedule, n_chunks=n_chunks, aggregation=aggregation,
        wire=wire, overlap_microbatches=overlap_microbatches,
        comm_buckets=comm_buckets, numerics=numerics, device=device)
    multi = _loop(local)

    def step(state, window):
        return multi(state, torch.as_tensor(window, dtype=torch.long,
                                            device=dev))

    return state, step


# ------------------------------------- ring states on the host, any topology

def _stage_coord_ids(skeleton: dict, n: int, n_stages: int, s: int,
                     comm_buckets: int = 1, model: int = 1, m: int = 0):
    """Cell ``(s, m)``'s slots in the global coordinate space, at ``n``
    data rows, ``n_stages`` stages and ``model`` model shards. A
    coordinate's global id is its position in the whole JAX-layout tree
    (``skeleton``), its leaves raveled in ``tree_leaves`` order:
    topology-invariant. Returns ``(ids, owned, sizes, total_coords)``: per
    ring bucket ``b``, ``ids[b]`` maps each slot of the cell's
    ``[n·sizes[b]]`` bucket vector (the padded flat vector at one bucket;
    row ``r`` owns ``[r·sizes[b], (r+1)·sizes[b])``) to its id, ``-1`` on
    pad slots; ``owned[b]`` marks the slots whose value this cell writes
    into a snapshot: all but the layout tag's off cell (0, 0) and a
    model-replicated leaf's off model shard 0. The port's stage holds no
    leaf another stage holds, so where JAX keeps "the highest surviving
    stage's" residual for a stage-replicated leaf, a coordinate here has
    one owning stage."""
    paths = introspect.leaf_paths(skeleton)
    base, off = {}, 0
    for p, x in zip(paths, tree_leaves(skeleton)):
        base[p] = off
        off += x.numel()
    for p, x in zip(paths, tree_leaves(skeleton)):
        if p.split("/")[0] == "blocks" and x.shape[0] % n_stages:
            raise ValueError(f"blocks leaf of {x.numel()} elements does not "
                             f"split over {n_stages} stages")
    cell = dist.PipelineMesh(n, n_stages, 0, s, None, None, model, m)
    local = _cell_tree(skeleton, cell)
    dims = tree_leaves(_model_specs(_stage_tree(skeleton, n_stages, s)))
    by_path = dict(zip(paths, tree_leaves(skeleton)))
    lids, own = [], []
    for p, x, dim in zip(introspect.leaf_paths(local), tree_leaves(local),
                         dims):
        top = p.split("/")[0]
        whole = by_path[p]
        if top != "blocks":
            lids.append(np.arange(base[p], base[p] + x.numel(),
                                  dtype=np.int64))
        else:
            per = whole.shape[0] // n_stages
            idx = np.arange(whole.numel(), dtype=np.int64).reshape(
                tuple(whole.shape))[s * per:(s + 1) * per]
            lids.append(base[p] + np.ascontiguousarray(
                _take(idx, dim, model, m)).reshape(-1))
        own.append((top != _LAYOUT_KEY or s == 0)
                   and (dim is not None or m == 0))
    if int(comm_buckets) == 1:
        total = sum(len(a) for a in lids)
        pad = (-total) % n
        pieces = [[(li, 0, len(a)) for li, a in enumerate(lids)]]
        sizes: Tuple[int, ...] = ((total + pad) // n,)
    else:
        bm = compress.make_bucket_map(local, n, comm_buckets)
        pieces, pad, sizes = bm.pieces, bm.pad, bm.sizes
    ids, owned = [], []
    for b, pcs in enumerate(pieces):
        parts = [lids[li][st:st + sz] for li, st, sz in pcs]
        mask = [np.full(sz, own[li]) for li, st, sz in pcs]
        if b == len(pieces) - 1 and pad:
            parts.append(np.full(pad, -1, np.int64))
            mask.append(np.zeros(pad, bool))
        ids.append(np.concatenate(parts))
        owned.append(np.concatenate(mask))
    return ids, owned, sizes, off


def _scatter(g: np.ndarray, vals: np.ndarray, ids: np.ndarray,
             owned: np.ndarray, what: str) -> None:
    """Write a bucket vector's values into the global vector ``g`` by id;
    its pad slots must hold exactly zero."""
    pad = ids < 0
    if np.any(vals[pad] != 0):
        raise ValueError(
            f"nonzero {what} values in the flat pad tail — the snapshot "
            "does not look like a zero-padded DP×PP stack")
    keep = owned & ~pad
    g[ids[keep]] = vals[keep]


def _gather(g: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """A bucket vector read back from the global vector ``g`` by id, zero
    on pad slots."""
    return np.where(ids >= 0, g[np.clip(ids, 0, None)], 0).astype(g.dtype)


def _tree_to_global(tree) -> np.ndarray:
    return np.concatenate([np.asarray(x.detach().cpu() if
                                      isinstance(x, torch.Tensor) else x,
                                      dtype=np.float32).reshape(-1)
                           for x in tree_leaves(tree)])


def _global_to_tree(g: np.ndarray, skeleton: dict) -> dict:
    leaves, off = [], 0
    for x in tree_leaves(skeleton):
        leaves.append(torch.from_numpy(
            g[off:off + x.numel()].reshape(tuple(x.shape)).copy()))
        off += x.numel()
    return tree_unflatten(skeleton, leaves)


def _vector_leaf(x) -> bool:
    return isinstance(x, torch.Tensor) and x.dim() >= 1


def _ring_snapshot(state):
    """``host_snapshot`` of a ring state (a collective over the world):
    the parameters merged as the plain state's, and every per-rank flat
    vector gathered over the data row and scattered by global id
    (``_stage_coord_ids``) into the whole model's coordinates, summed over
    the stages and the model shards: each ZeRO-1 moment leaf a whole JAX-layout tree (so one
    optimizer state, whatever the bucket count), the ring residual
    ``[n, total_coords]`` (row r data row r's pending error), the second
    leg's ``[total_coords]``; per-bucket tuples of residuals, each holding
    its own bucket's coordinates. The form does not depend on the stage
    count or the bucket boundaries, so ``slice_state`` places it at any
    (data, stage) topology, and back at its own on a model axis."""
    geom = state.pp
    mesh, flat = geom.mesh, geom.flat
    nb = flat.bm.nbuckets if flat.bm is not None else 1
    ids, owned, sizes, total = _stage_coord_ids(
        geom.skeleton, flat.n, mesh.stage, mesh.s, nb, mesh.model, mesh.m)
    keys = set(state.params)

    def rows(x) -> np.ndarray:
        g = dist.all_gather(x.detach().reshape(-1).contiguous(),
                            group=mesh.data_group)
        return g.reshape(mesh.data, -1).cpu().numpy()

    def stage_sum(g: np.ndarray) -> torch.Tensor:
        return _sum_cells(torch.from_numpy(g), mesh)

    def chunks_global(per_bucket, what) -> torch.Tensor:
        """Per-bucket per-rank chunks ``[sizes[b]]`` → the global vector."""
        g = None
        for b, x in enumerate(per_bucket):
            r = rows(x)
            if g is None:
                g = np.zeros(total, r.dtype)
            _scatter(g, r.reshape(-1), ids[b], owned[b], what)
        return stage_sum(g)

    params = tree_map(lambda x: x.detach().cpu().clone(),
                      _merge_params_like(state.params, geom))
    if flat.zero1:
        opts = (list(state.opt_state) if flat.bm is not None
                else [state.opt_state])
        per_leaf = [nested_leaves(o) for o in opts]
        merged = []
        for j, x in enumerate(per_leaf[0]):
            if _vector_leaf(x):
                g = chunks_global([p[j] for p in per_leaf], "opt_state")
                merged.append(_global_to_tree(g.numpy(), geom.skeleton))
            else:
                merged.append(x.detach().cpu().clone()
                              if isinstance(x, torch.Tensor) else x)
        opt_state = nested_unflatten(opts[0], merged)
    else:
        opt_state = _map_params_like(
            state.opt_state, keys,
            lambda node: tree_map(lambda x: x.detach().cpu().clone(),
                                  _merge_params_like(node, geom)),
            lambda x: x.detach().cpu().clone()
            if isinstance(x, torch.Tensor) else x)
    out = TrainState(params, opt_state, state.step.detach().cpu().clone())
    if not isinstance(state, PPOverlapEFState):
        return out
    ring_in = (list(state.ring_residual) if flat.bm is not None
               else [state.ring_residual])
    gather_in = (list(state.gather_residual) if flat.bm is not None
                 else [state.gather_residual])
    ring_out, gather_out = [], []
    for b in range(nb):
        r = rows(ring_in[b])          # [n, n·sizes[b]]: row r's residual
        g = np.zeros((mesh.data, total), np.float32)
        for row in range(mesh.data):
            _scatter(g[row], r[row], ids[b], owned[b], "ring_residual")
        ring_out.append(stage_sum(g))
        gv = np.zeros(total, np.float32)
        _scatter(gv, rows(gather_in[b]).reshape(-1), ids[b], owned[b],
                 "gather_residual")
        gather_out.append(stage_sum(gv))
    pack = (lambda xs: tuple(xs)) if flat.bm is not None else \
        (lambda xs: xs[0])
    return PPOverlapEFState(out.params, out.opt_state, out.step,
                            pack(ring_out), pack(gather_out), None)


def _ring_template(state, whole_params):
    """``merged_template`` of a ring state: ``_ring_snapshot``'s structure
    and shapes on the ``meta`` device."""
    geom = state.pp
    flat = geom.flat
    keys = set(state.params)
    total = sum(x.numel() for x in tree_leaves(geom.skeleton))
    meta = geom.skeleton

    def whole32(_):
        return tree_map(lambda x: torch.empty(x.shape, dtype=torch.float32,
                                              device="meta"), meta)

    if flat.zero1:
        first = state.opt_state[0] if flat.bm is not None else state.opt_state
        opt_state = nested_unflatten(first, [
            whole32(x) if _vector_leaf(x) else x
            for x in nested_leaves(first)])
    else:
        opt_state = _map_params_like(
            state.opt_state, keys,
            lambda node: _whole(node, meta, lambda shape, dt: torch.empty(
                shape, dtype=dt, device="meta")), lambda x: x)
    if not isinstance(state, PPOverlapEFState):
        return TrainState(whole_params, opt_state, state.step)
    nb = flat.bm.nbuckets if flat.bm is not None else 1

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device="meta")

    ring = [empty(flat.n, total) for _ in range(nb)]
    gather = [empty(total) for _ in range(nb)]
    pack = (lambda xs: tuple(xs)) if flat.bm is not None else \
        (lambda xs: xs[0])
    return PPOverlapEFState(whole_params, opt_state, state.step, pack(ring),
                            pack(gather), None)


def _host_nodes(like, host) -> list:
    """``host``'s nodes at the leaf positions of ``like`` (a per-rank
    optimizer state against its merged form, whose vector leaves are whole
    trees)."""
    if isinstance(like, dict):
        return [x for k in sorted(like) for x in _host_nodes(like[k],
                                                             host[k])]
    if isinstance(like, (list, tuple)):
        return [x for a, b in zip(like, host) for x in _host_nodes(a, b)]
    return [host]


def repartition_stage_state(host_state, template_state):
    """A ring state's host snapshot (``_ring_snapshot``'s form, taken at
    any ``(n, S)`` data × stage topology) placed at ``template_state``'s
    ``(n', S')`` rank: the stage re-partition and data reshard of the
    elastic re-mesh, and a checkpoint restored at another topology.

    Mechanism: every coordinate has a topology-invariant global id
    (``_stage_coord_ids``); the snapshot already holds every field in
    those coordinates (the old per-rank slices scattered by id), and the
    template's slices gather by id. The parameters re-slice as the plain
    state's. JAX's rules hold: values in pad slots must be exactly zero (a
    hard error, in the scatter); ring rows beyond the new data world are
    dropped, new rows start at zero, and each row's own chunk re-zeros in
    the new geometry; a model axis in the template, a bucket-count
    mismatch, an interleaved layout across a stage-count change, and an
    ``S'`` that does not divide ``n_layers`` raise JAX's errors. The port's
    rule for a stage-replicated leaf: there is none, each coordinate has
    one owning stage (the layout tag's is stage 0, and the tag is pinned),
    so no "highest surviving stage" choice arises."""
    if template_state.pp.mesh.model > 1:
        raise ValueError(
            "elastic re-mesh of the DP×PP×TP overlap state is unsupported "
            "— the (data, stage, model) stacks have no reshard rule; run "
            "elastic DP×PP at model=1")
    return _place_ring_state(host_state, template_state)


def _place_ring_state(host_state, template_state):
    """``repartition_stage_state``'s placement, at any template (a
    checkpoint's resume on a model axis comes here through ``slice_state``,
    at its own topology)."""
    geom = template_state.pp
    mesh, flat = geom.mesh, geom.flat
    keys = set(template_state.params)
    params = llama.as_tree(host_state.params)
    n_layers = tree_leaves(params["blocks"])[0].shape[0]
    if n_layers % mesh.stage:
        raise ValueError(
            f"stage re-partition: the template's stage count {mesh.stage} "
            f"does not divide n_layers={n_layers} — layers shard as equal "
            "[n_layers/S] blocks, so S' must divide n_layers")
    tag = params.get(_LAYOUT_KEY)
    if tag is not None and int(float(tag) // 1000) != mesh.stage:
        raise ValueError(
            "stage re-partition of an interleaved layout is unsupported: "
            "the chunk-major layer order breaks the blocked [L/S] stage "
            "slices the re-partition re-slices — run elastic PP with "
            "schedule='gpipe' or '1f1b'")
    nb = flat.bm.nbuckets if flat.bm is not None else 1
    ef = isinstance(template_state, PPOverlapEFState)
    if ef:
        h_rr = getattr(host_state, "ring_residual", None)
        h_n = (0 if h_rr is None else len(h_rr) if isinstance(h_rr, tuple)
               else 1)
        t_n = nb if flat.bm is not None else 1
        if h_n != t_n or isinstance(h_rr, tuple) != (flat.bm is not None):
            raise ValueError(
                f"comm_buckets mismatch: the snapshot carries {h_n} EF "
                f"residual bucket(s), the template {t_n} — rebucketing a "
                "live EF state is not defined; rebuild the trainer with "
                "the snapshot's comm_buckets")
    ids, _, sizes, total = _stage_coord_ids(
        geom.skeleton, flat.n, mesh.stage, mesh.s, nb, mesh.model, mesh.m)
    d = mesh.d

    def mine(g: np.ndarray, b: int) -> np.ndarray:
        return _gather(g, ids[b])[d * sizes[b]:(d + 1) * sizes[b]]

    def walk(h, t):
        if _params_like(t, keys):
            return tree_map(_place_leaf, _cell_tree(h, mesh), t)
        if isinstance(t, tuple):
            items = [walk(a, b) for a, b in zip(h, t)]
            return type(t)(*items) if hasattr(t, "_fields") else tuple(items)
        return _place_leaf(h, t) if isinstance(t, torch.Tensor) else t

    new_params = walk(host_state.params, template_state.params)
    if flat.zero1:
        opts = (list(template_state.opt_state) if flat.bm is not None
                else [template_state.opt_state])
        placed = []
        for b, o in enumerate(opts):
            leaves = []
            for h, t in zip(_host_nodes(o, host_state.opt_state),
                            nested_leaves(o)):
                if _vector_leaf(t):
                    leaves.append(_place_leaf(mine(_tree_to_global(h), b),
                                              t))
                else:
                    leaves.append(_place_leaf(h, t)
                                  if isinstance(t, torch.Tensor) else t)
            placed.append(nested_unflatten(o, leaves))
        opt_state = tuple(placed) if flat.bm is not None else placed[0]
    else:
        opt_state = walk(host_state.opt_state, template_state.opt_state)
    step = _place_leaf(host_state.step, template_state.step)
    if not ef:
        return TrainState(new_params, opt_state, step, pp=geom)

    def pooled(x) -> np.ndarray:
        xs = list(x) if isinstance(x, tuple) else [x]
        return sum(np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor)
                              else v, dtype=np.float32) for v in xs)

    ring_g, gather_g = pooled(host_state.ring_residual), \
        pooled(host_state.gather_residual)
    t_ring = (list(template_state.ring_residual) if flat.bm is not None
              else [template_state.ring_residual])
    t_gather = (list(template_state.gather_residual) if flat.bm is not None
                else [template_state.gather_residual])
    ring, gather = [], []
    for b in range(nb):
        if d < ring_g.shape[0]:
            row = _gather(ring_g[d], ids[b])
            # The owner never quantizes its own chunk; the chunk
            # boundaries moved with (n', S').
            row[d * sizes[b]:(d + 1) * sizes[b]] = 0.0
        else:
            row = np.zeros(flat.n * sizes[b], np.float32)
        ring.append(_place_leaf(row, t_ring[b]))
        gather.append(_place_leaf(mine(gather_g, b), t_gather[b]))
    pack = (lambda xs: tuple(xs)) if flat.bm is not None else \
        (lambda xs: xs[0])
    return PPOverlapEFState(new_params, opt_state, step, pack(ring),
                            pack(gather), geom)


# --------------------------------------------------- stage-stacked numerics

NUMERICS_MODEL_AXIS = (
    "make_pp_numerics supports model=1 meshes: its per-group "
    "summaries are not model-axis psum-agreed, so stats would "
    "differ per TP shard. The overlap/ring drivers themselves DO "
    "compose with model>1 now (DP×PP×TP, see _pp_overlap_setup); "
    "for model-axis-agreed numerics use a TP mesh with "
    "tp.make_tp_numerics.")


def make_pp_numerics(params, mesh: dist.PipelineMesh, *,
                     psum_data: bool = False) -> introspect.NumericsHandle:
    """The numerics summarizer of a stage process, JAX's
    ``make_pp_numerics``: group statistics stacked ``[S, G]`` over the
    stages, on the geometry of one stage's template (its ``[L/S]`` block
    slice and the model's other leaves, from the whole tree ``params``).
    Host-side, block groups are stage-qualified (``stage1/blocks/0`` is
    the second stage's first local layer) and the other groups come once,
    from row 0. Each rank fills its own row for its block groups and row
    0 for the other leaves it holds; a ``psum`` over the stage group then
    gives every rank the whole stack. ``psum_data=True`` also sums the
    gradient statistics and the finite mask over the data group (the ring
    drivers, whose local gradients differ per data row; JAX's rule). A
    mesh with a model axis raises JAX's error, which names
    ``tp.make_tp_numerics``."""
    if mesh.model > 1:
        raise ValueError(NUMERICS_MODEL_AXIS)
    params = llama.as_tree(params)
    n = mesh.stage
    template = {k: (tree_map(lambda x: x[: x.shape[0] // n], v)
                    if k == "blocks" else v) for k, v in params.items()}
    base = introspect.make_summarizer(template)
    col = {g: i for i, g in enumerate(base.groups)}
    leaf_col = {p: i for i, p in enumerate(base.paths)}

    def stage_expand(names, block_flags):
        rows, cols, out = [], [], []
        for s in range(n):
            for i, name in enumerate(names):
                if block_flags[i]:
                    rows.append(s)
                    cols.append(i)
                    out.append(f"stage{s}/{name}")
        for i, name in enumerate(names):
            if not block_flags[i]:
                rows.append(0)
                cols.append(i)
                out.append(name)
        return (np.asarray(rows), np.asarray(cols)), out

    g_idx, groups = stage_expand(
        base.groups, [g.startswith("blocks/") for g in base.groups])
    l_idx, paths = stage_expand(
        base.paths, [p.startswith("blocks/") for p in base.paths])

    def summarize(old_params, grads, new_params):
        flat = introspect._flatten_with_path(grads)
        dev = flat[0][1].device
        sq = torch.zeros(3, n, len(base.groups), dtype=torch.float32,
                         device=dev)
        bad = torch.zeros(n, len(base.paths), dtype=torch.int32, device=dev)
        for (path, g), o, p in zip(flat, tree_leaves(old_params),
                                   tree_leaves(new_params)):
            block = path[0] == "blocks"
            row = mesh.s if block else 0
            bad[row, leaf_col[introspect.path_str(path)]] = (
                ~torch.isfinite(g.detach()).all()).to(torch.int32)
            for k, x in enumerate((g.detach().float(), p.detach().float(),
                                   p.detach().float() - o.detach().float())):
                if block:
                    c = col["blocks/0"]
                    sq[k, row, c:c + x.shape[0]] += (
                        x.reshape(x.shape[0], -1) ** 2).sum(dim=1)
                else:
                    sq[k, row, col[path[0]]] += (x ** 2).sum()
        sq = dist.psum(sq, record=False, group=mesh.stage_group)
        bad = dist.psum(bad, record=False, group=mesh.stage_group)
        if psum_data:
            sq = torch.cat([dist.psum(sq[:1], record=False,
                                      group=mesh.data_group), sq[1:]])
            bad = dist.psum(bad, record=False, group=mesh.data_group)
        return introspect.NumericsSummary(grad_sq=sq[0], param_sq=sq[1],
                                          update_sq=sq[2],
                                          grad_finite=bad == 0)

    class _PPHandle(introspect.NumericsHandle):
        def event_fields(self, summary, *, index=None, top=4):
            def host(x):
                a = (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                     else np.asarray(x))
                return a[index] if index is not None else a

            flat = introspect.NumericsSummary(
                grad_sq=host(summary.grad_sq)[g_idx],
                param_sq=host(summary.param_sq)[g_idx],
                update_sq=host(summary.update_sq)[g_idx],
                grad_finite=host(summary.grad_finite)[l_idx])
            return introspect.NumericsHandle.event_fields(
                self, flat, index=None, top=top)

    return _PPHandle(groups, paths, summarize)
