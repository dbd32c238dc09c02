"""Pipeline parallelism: counterpart of the JAX package's ``parallel/pp.py``
plain path (GPipe, 1F1B and interleaved schedules, the steps, the layout
of interleaved parameters and the stage-stacked numerics).

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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import distributed as dist
from .dp import TrainState, _loop
from ..config import LlamaConfig, torch_dtype
from ..models import llama
from ..ops.adam import apply_optimizer
from ..telemetry import introspect
from ..tree import trainable, tree_leaves, tree_map, tree_unflatten

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
class StageGeometry:
    """Where a stage state sits: the mesh, and ``skeleton``, the whole
    model's parameter tree (JAX layout, the layout tag included) as
    shapes on the ``meta`` device, from which ``host_snapshot`` sizes the
    leaves this stage does not hold."""

    mesh: dist.PipelineMesh
    skeleton: dict


def _stage_tree(params: dict, n_stages: int, s: int) -> dict:
    """Stage ``s``'s slice of a whole (JAX-layout) tree, the layout tag
    on every stage."""
    tag = params.get(_LAYOUT_KEY)
    local = llama.split_stages(
        {k: v for k, v in params.items() if k != _LAYOUT_KEY}, n_stages)[s]
    if tag is not None:
        local[_LAYOUT_KEY] = tag
    return local


def init_state(mesh: dist.PipelineMesh, params, optimizer,
               device=None) -> TrainState:
    """This rank's stage state from the whole parameter tree (a ``Llama``
    or its tree, JAX layout; ``interleave_params``'s for the interleaved
    schedule): its stage's leaves as fresh tensors on ``device`` (None:
    CUDA, raising without a card), the optimizer state for them alone."""
    dev = dist.rank_device(device)
    params = llama.as_tree(params)
    skeleton = tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                              device="meta"), params)
    local = trainable(tree_map(lambda x: x.detach().to(dev),
                               _stage_tree(params, mesh.stage, mesh.s)))
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


def _merge_params_like(local: dict, geom: StageGeometry) -> dict:
    """The whole tree from every stage's ``local`` (a collective over the
    stage group): each rank writes the rows and leaves it holds into a
    zero tree of the skeleton's shapes, and the trees are summed."""
    mesh = geom.mesh
    device = tree_leaves(local["blocks"])[0].device
    whole = _whole(local, geom.skeleton, lambda shape, dt: torch.zeros(
        shape, dtype=dt, device=device))
    with torch.no_grad():
        for key, sub in local.items():
            if key == "blocks":
                per = tree_leaves(sub)[0].shape[0]
                rows = slice(mesh.s * per, (mesh.s + 1) * per)
                tree_map(lambda w, x: w[rows].copy_(x), whole[key], sub)
            elif key != _LAYOUT_KEY or mesh.s == 0:
                tree_map(lambda w, x: w.copy_(x), whole[key], sub)
    return dist.psum_tree(whole, record=False, group=mesh.stage_group)


def host_snapshot(state: TrainState) -> TrainState:
    """The merged JAX-layout state of a stage state, as CPU tensors: the
    stages' parameters and every parameter-shaped part of the optimizer
    state (moments, master weights) joined by ``merge_stages``'s rule
    (a collective: every rank of the stage group calls it); the step and
    the optimizer's count are the same on every stage. A data-parallel
    state of the same model has this structure, so one checkpoint file
    format serves both."""
    geom = state.pp
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
            return tree_map(place, _stage_tree(h, mesh.stage, mesh.s), t)
        if isinstance(t, tuple):
            items = [walk(a, b) for a, b in zip(h, t)]
            return type(t)(*items) if hasattr(t, "_fields") else tuple(items)
        return place(h, t) if isinstance(t, torch.Tensor) else t

    return TrainState(walk(host.params, template.params),
                      walk(host.opt_state, template.opt_state),
                      walk(host.step, template.step), pp=template.pp)


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
               last: bool, blocks=None):
    """One stage on one microbatch: embeds ``tok`` if first (``x`` is
    then unused), runs ``blocks`` (default the stage's), and returns the
    head's loss if last, else the activations."""
    h = llama.embed(p, tok, cfg) if first else x
    h = llama.blocks_apply(p["blocks"] if blocks is None else blocks, h, cfg)
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
    microbatches, the hop shape and dtype, the loss seed."""

    def __init__(self, mesh, tokens, cfg: LlamaConfig, n_microbatches: int):
        b, t = tokens.shape
        assert b % n_microbatches == 0, (b, n_microbatches)
        self.s, self.n = mesh.s, mesh.stage
        self.first, self.last = self.s == 0, self.s == self.n - 1
        self.m = n_microbatches
        self.mbs = tokens.reshape(n_microbatches, b // n_microbatches, t)
        self.shape = (b // n_microbatches, t, cfg.dmodel)
        self.dtype = torch_dtype(cfg.dtype)
        self.seed = torch.tensor(1.0 / n_microbatches, dtype=torch.float32,
                                 device=tokens.device)
        self.loss_sum = torch.zeros((), dtype=torch.float32,
                                    device=tokens.device)

    def recv(self, hops, frm: int, tag: int) -> torch.Tensor:
        return hops.recv(frm, self.shape, self.dtype,
                         tag=tag).requires_grad_()


def _pipeline_loss_and_grad(params: dict, leaves: list, tokens, cfg,
                            mesh, n_microbatches: int, hops):
    """GPipe: every microbatch forward with its graph kept, then backward
    in reverse. Returns this stage's loss (the microbatch mean on the
    last stage, 0 elsewhere) and its gradients, one per ``leaves``."""
    st = _Step(mesh, tokens, cfg, n_microbatches)
    tape = []
    for i in range(st.m):
        x = None if st.first else st.recv(hops, st.s - 1,
                                          _tag(0, i, _FWD, st.m))
        out = _run_stage(params, x, st.mbs[i], cfg, first=st.first,
                         last=st.last)
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
    return st.loss_sum / st.m, grads


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
                               last=False)
            if not st.last:
                hops.send(h, st.s + 1, tag=_tag(0, i_f, _FWD, st.m),
                          label="pp_activation_hop")
        i_b = j - 2 * (st.n - 1) + st.s
        if 0 <= i_b < st.m:
            x = stash[i_b % n_slots]
            if x is not None:
                x = x.detach().requires_grad_()
            out = _run_stage(params, x, st.mbs[i_b], cfg, first=st.first,
                             last=st.last)
            if st.last:
                st.loss_sum = st.loss_sum + out.detach()
                seed = st.seed
            else:
                seed = hops.recv(st.s + 1, st.shape, st.dtype,
                                 tag=_tag(0, i_b, _BWD, st.m))
            grads = _backward(out, seed, x, leaves, grads, hops, st.s - 1,
                              _tag(0, i_b, _BWD, st.m))
    return st.loss_sum / st.m, grads


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
                         last=exits, blocks=chunks[c])
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
    return st.loss_sum / st.m, grads


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


def _reduce_loss_and_grads(loss, grads, mesh):
    """The loss from the last stage to every stage (a ``psum`` over the
    stage group, zeros elsewhere); at ``data > 1`` the gradients and the
    loss averaged over the data group, for every stage. Block gradients
    need no reduction over stages, and the gradients of ``embed``,
    ``final_norm`` and ``lm_head`` live on their one owner."""
    loss = dist.psum(loss, label="pp_loss_allreduce", group=mesh.stage_group)
    if mesh.data > 1:
        grads = dist.pmean_tree(grads, label="grad_allreduce",
                                group=mesh.data_group)
        loss = dist.pmean(loss, label="loss_allreduce",
                          group=mesh.data_group)
    return loss, grads


# ---------------------------------------------------------------- the steps

def _loss_and_grad(body: Callable, params: dict, tokens, cfg, mesh,
                   n_microbatches: int, device):
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
    return _reduce_loss_and_grads(loss, grad_tree, mesh)


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


# --------------------------------------------------- stage-stacked numerics

def make_pp_numerics(params, mesh: dist.PipelineMesh
                     ) -> introspect.NumericsHandle:
    """The numerics summarizer of a stage process, JAX's
    ``make_pp_numerics``: group statistics stacked ``[S, G]`` over the
    stages, on the geometry of one stage's template (its ``[L/S]`` block
    slice and the model's other leaves, from the whole tree ``params``).
    Host-side, block groups are stage-qualified (``stage1/blocks/0`` is
    the second stage's first local layer) and the other groups come once,
    from row 0. Each rank fills its own row for its block groups and row
    0 for the other leaves it holds; a ``psum`` over the stage group then
    gives every rank the whole stack."""
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
