"""Compressed and overlapped gradient sync for data parallelism: counterpart
of the JAX package's ``parallel/compress.py``.

The JAX module runs each factory as one SPMD program over a ``data`` mesh
axis (``("dcn", "data")`` on a hierarchical mesh); here each rank is a
process of a gloo group (``parallel.distributed``) that calls the step on
its own batch, and each ``lax`` collective is a collective over a
``distributed.Group``: ``ppermute`` a ring shift over the point-to-point
hops, ``pmax`` and ``all_gather`` on host copies in the operand's own
dtype. Every collective records its bytes under the JAX call site's label
and axis, so the comm profiles of the two packages agree byte for byte.

- **bf16 wire** (``make_bf16_grad_step``): the gradient all-reduce in bf16.
- **int8 + error feedback** (``make_int8_ef_grad_step``): one ``pmax`` of
  the stacked per-leaf maxima, one int8 all-gather of the concatenated
  payload, an exact int32 sum; the quantization remainder is fed back
  into the next step (``EFTrainState.residual``, one slot per rank).
- **The ring** (``ring_reduce_scatter``): a reduce-scatter of a padded flat
  vector over ``n − 1`` ring hops whose in-flight partials travel in fp32,
  bf16 or int8 with error feedback, in the documented summation order;
  ``hier_reduce_scatter`` runs it within each island, then across the
  ``dcn`` axis only.
- **The overlap step** (``make_overlap_step``, ``make_overlap_multi_step``):
  the local batch splits into M microbatches, and the rings run on a
  thread of their own (``_Ringer``): autograd hands each parameter's
  gradient over as the backward produces it, and a bucket's ring starts
  once every leaf it covers is in, while the backward and the next
  microbatches go on (on a card the thread works on a side stream that
  waits only for those gradients). The reduced chunk feeds the replicated
  update (gradient aggregation) or the ZeRO-1 slice update, and comes back
  by an all-gather in the wire format (an int8 parameter delta with its
  own residual under ZeRO-1). ``comm_buckets > 1`` cuts the flat space
  into buckets in the order the backward emits gradients
  (``make_bucket_map``), each ringing on its own.

The JAX module proves its overlap from the jaxpr. Eager PyTorch has none:
the step keeps a record of each hop (its microbatch, its bucket, and
whether every gradient it carries was in before the last microbatch's
backward had produced the layer stack's gradients), and
``ring_overlap_evidence`` reads it. At M = 1 without buckets every hop
waits; with buckets, those holding only the head's and the final norm's
gradients ring during the layers' backward; at M > 1 every microbatch but
the last rings during a later one's.

States are updated in place, as ``parallel.dp``'s: the parameters are the
model's own tree. The error-feedback residuals are per rank (JAX's
``[n, ...]`` stacks, one slot each): ``dp.host_snapshot`` gathers them in
rank order for a checkpoint and ``dp.reshard_state`` gives each rank its
own slot back at the same world.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from . import distributed as dist
from . import dp
from ..ops.adam import apply_optimizer
from ..tree import tree_copy, tree_leaves, tree_unflatten

_TINY = torch.finfo(torch.float32).tiny
WIRES = ("fp32", "bf16", "int8_ef")


# ------------------------------------------------------- legacy per-step

def _pmean_bf16(grads: List[torch.Tensor], group) -> List[torch.Tensor]:
    """``pmean`` of the gradient leaves with a bf16 wire: the leaves cast
    to bf16, summed over the ranks in bf16 on a host copy, divided by the
    world, cast back. Recorded as one ``pmean`` of the bf16 tree."""
    down = [g.detach().to(torch.bfloat16) for g in grads]
    dist._record("pmean", "grad_allreduce_bf16", down, group)
    n = group.size
    if n == 1:
        return [d.to(g.dtype) for d, g in zip(down, grads)]
    flat = torch.cat([d.reshape(-1) for d in down]).to("cpu")
    torch.distributed.all_reduce(flat, group=group.pg)
    flat = (flat / n).to(grads[0].device)
    return [piece.view(g.shape).to(g.dtype) for piece, g in zip(
        flat.split([g.numel() for g in grads]), grads)]


def make_bf16_grad_step(loss_fn: Callable, optimizer) -> Callable:
    """The gradient-aggregation step with a bf16 collective:
    ``step(state, batch) -> (state, loss)`` on ``dp.TrainState``; only the
    gradient all-reduce's wire format changes."""
    group = dist.data_group()

    def step(state: dp.TrainState, batch: torch.Tensor):
        leaves = tree_leaves(state.params)
        loss = loss_fn(state.params, batch)
        grads = _pmean_bf16(list(torch.autograd.grad(loss, leaves)), group)
        loss = dist.pmean(loss.detach(), label="loss_allreduce", group=group)
        params, opt_state = apply_optimizer(
            optimizer, tree_unflatten(state.params, grads), state.opt_state,
            state.params)
        return dp.TrainState(params, opt_state, state.step + 1), loss

    return step


class EFTrainState(NamedTuple):
    """``dp.TrainState`` and this rank's error-feedback residual tree: the
    parameters' structure, each leaf ``[1, *shape]`` (its slot of the JAX
    package's ``[n, ...]`` stack)."""
    params: Any
    opt_state: Any
    step: torch.Tensor
    residual: Any

    PER_RANK_FIELDS = ("residual",)


def init_ef_state(params, optimizer) -> EFTrainState:
    """The legacy int8 step's state: ``dp.init_state`` and a zero residual
    slot per leaf."""
    base = dp.init_state(params, optimizer)
    residual = tree_unflatten(params, [
        torch.zeros((1,) + tuple(p.shape), dtype=p.dtype, device=p.device)
        for p in tree_leaves(params)])
    return EFTrainState(base.params, base.opt_state, base.step, residual)


def make_int8_ef_grad_step(loss_fn: Callable, optimizer) -> Callable:
    """DP step with an int8 gradient all-gather and error feedback, per
    rank: ``c = g + residual`` per leaf → one ``pmax`` of the stacked
    per-leaf maxima (every rank on the same grids) → ``q = round(c/s)`` in
    int8 → one int8 all-gather of the concatenated payload → an exact
    int32 sum → ``g_avg = s·Σq/n`` per leaf, new residual ``c − s·q``."""
    group = dist.data_group()
    n = group.size

    def step(state: EFTrainState, batch: torch.Tensor):
        leaves = tree_leaves(state.params)
        loss = loss_fn(state.params, batch)
        grads = torch.autograd.grad(loss, leaves)
        loss = dist.pmean(loss.detach(), label="loss_allreduce", group=group)
        res = tree_leaves(state.residual)
        c_leaves = [g + r[0] for g, r in zip(grads, res)]
        local_max = torch.stack([c.abs().max().float() for c in c_leaves])
        scales = torch.clamp_min(
            dist.pmax(local_max, label="int8_scale_pmax", group=group) / 127.0,
            _TINY)
        q_leaves = [torch.clamp(torch.round(c / scales[i].to(c.dtype)),
                                -127, 127).to(torch.int8)
                    for i, c in enumerate(c_leaves)]
        payload = torch.cat([q.reshape(-1) for q in q_leaves])
        gathered = dist.all_gather(payload, label="int8_grad_gather",
                                   group=group).view(n, -1)
        totals = gathered.to(torch.int32).sum(dim=0)
        g_avg, new_res = [], []
        off = 0
        for i, (g, c, q) in enumerate(zip(grads, c_leaves, q_leaves)):
            s = scales[i].to(c.dtype)
            tot = totals[off:off + g.numel()].view(g.shape)
            off += g.numel()
            g_avg.append((s * tot.to(c.dtype) / n).to(g.dtype))
            new_res.append(_fma(c, -s, q).to(c.dtype)[None])
        params, opt_state = apply_optimizer(
            optimizer, tree_unflatten(state.params, g_avg), state.opt_state,
            state.params)
        return EFTrainState(params, opt_state, state.step + 1,
                            tree_unflatten(state.params, new_res)), loss

    return step


# ------------------------------------------------------------------ the ring

# The overlap evidence: while a step runs, each ring hop appends its
# context (``_HOP_CTX``) to the active log (``_HOP_LOG``).
_HOP_LOG: contextvars.ContextVar[Optional[list]] = contextvars.ContextVar(
    "ddl25_ring_hops", default=None)
_HOP_CTX: contextvars.ContextVar[Optional[dict]] = contextvars.ContextVar(
    "ddl25_ring_hop_ctx", default=None)


def _log_hop(label: str, axis: str) -> None:
    log = _HOP_LOG.get()
    if log is not None:
        log.append({**(_HOP_CTX.get() or {}), "label": label, "axis": axis})


def _fma(a: torch.Tensor, s: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``a + s·q`` rounded once to fp32 (a fused multiply-add), for an fp32
    ``a``, an fp32 scale ``s`` and int8 values ``q``: computed in float64,
    where ``s·q`` is exact, so one rounding to fp32 remains. The JAX
    package's compiled program contracts both places this is used (the
    quantization remainder and the dequantize-and-add) into FMAs."""
    return (a.double() + s.double() * q.double()).float()


def _int8_encode(c: torch.Tensor, scale_sync_group=None):
    """Symmetric int8 quantization of ``c`` around ``max|c|``: ``(q, s,
    residual)`` with ``c ≈ s·q`` and ``residual = c − s·q``; ``s =
    max(m/127, tiny)`` in fp32, ``round`` half to even (``jnp.round``'s
    rule), the remainder rounded once (``_fma``). ``scale_sync_group`` (a
    ``Group``): ``pmax`` the maximum over it
    first, a 4-byte collective that is not accounted (the composed DP×TP
    and DP×PP steps keep replicated entries on one grid with it)."""
    m = c.abs().max()
    if scale_sync_group is not None:
        m = dist.pmax(m, record=False, group=scale_sync_group)
    s = torch.clamp_min(m / 127.0, _TINY)
    q = torch.clamp(torch.round(c / s), -127, 127).to(torch.int8)
    return q, s, _fma(c, -s, q)


def ring_reduce_scatter(x: torch.Tensor, group, *, wire: str = "fp32",
                        residual: Optional[torch.Tensor] = None,
                        label: str = "ring_grad",
                        scale_sync_group=None):
    """Ring reduce-scatter of the padded flat fp32 vector ``x`` (``[n·chunk]``,
    n = ``group.size``) over ``n − 1`` ring shifts. Returns ``(owned,
    residual')``: ``owned`` is chunk ``group.index`` of the sum over the
    group (``psum_scatter``'s ownership), ``residual'`` the int8 error
    feedback state (flat ``[n·chunk]``, slot c this rank's error on chunk
    c's partial; ``None`` passes through for fp32 and bf16).

    Summation order, the JAX function's spec: chunk c's partial starts at
    index c+1 and travels c+1 → c+2 → ... → c, each rank adding its own
    part on receipt, so it associates as (((g_{c+1} + g_{c+2}) + ...) +
    g_c), the owner's part added last, in fp32. Hop t sends chunk
    ``(r − 1 − t) % n``, an involution of the chunk index, which also
    writes the residual back in chunk-indexed layout.

    Wire formats of each hop's partial: ``"fp32"`` as is; ``"bf16"`` cast
    to bf16 on the wire and accumulated in fp32; ``"int8_ef"`` quantized
    around a per-hop scale that travels as a 4-byte sideband, the sender's
    error fed back into its next send of the same chunk, the receiver's
    ``s·q + own`` rounded once (``_fma``). Each hop records
    op ``ppermute`` under ``{label}_{f32|bf16|int8|scale}`` on the group's
    axis: ``n − 1`` trips of the chunk per call. Identity at n = 1."""
    if residual is not None and wire != "int8_ef":
        raise ValueError(f"residual is int8_ef-only (got wire={wire!r})")
    n = group.size
    if n == 1:
        return x, residual
    chunk = x.numel() // n
    chunks = x.reshape(n, chunk)
    r = group.index
    idx = [(r - 1 - t) % n for t in range(n)]
    res_rolled = (residual.reshape(n, chunk)[idx]
                  if residual is not None else None)
    new_res = []
    partial = chunks[idx[0]]
    for t in range(n - 1):
        if wire == "int8_ef":
            c = partial + res_rolled[t]
            q, s, err = _int8_encode(c, scale_sync_group)
            new_res.append(err)
            _log_hop(f"{label}_int8", group.axis)
            q = dist.ppermute(q, label=f"{label}_int8", group=group)
            _log_hop(f"{label}_scale", group.axis)
            s = dist.ppermute(s, label=f"{label}_scale", group=group)
            partial = _fma(chunks[idx[t + 1]], s, q)
            continue
        elif wire == "bf16":
            _log_hop(f"{label}_bf16", group.axis)
            got = dist.ppermute(partial.to(torch.bfloat16),
                                label=f"{label}_bf16",
                                group=group).to(torch.float32)
        elif wire == "fp32":
            _log_hop(f"{label}_f32", group.axis)
            got = dist.ppermute(partial, label=f"{label}_f32", group=group)
        else:
            raise ValueError(f"unknown ring wire format {wire!r}")
        partial = got + chunks[idx[t + 1]]
    if residual is not None:
        new_res.append(res_rolled[n - 1])     # the owner's slot: untouched
        residual = torch.stack(new_res)[idx].reshape(-1)
    return partial, residual


def hier_reduce_scatter(x: torch.Tensor, mesh, *, wire_ici: str = "fp32",
                        wire_dcn: str = "int8_ef",
                        residual: Optional[torch.Tensor] = None,
                        label: str = "ring_grad"):
    """Two-level reduce-scatter on a hierarchical layout
    (``distributed.hier_data_mesh``): the ring within each island
    (``wire_ici`` ∈ {fp32, bf16}) scatters S superchunks of D·chunk, then
    the ring across the ``dcn`` axis (``wire_dcn`` ∈ {fp32, bf16,
    int8_ef}) scatters each superchunk's D chunks, so 1/S of the vector
    crosses DCN. Replica (d, s) ends up owning chunk ``s·D + d``
    (``dp.slice_index``). ``residual``: the DCN ring's error feedback
    (flat ``[D·chunk]``). Each hop records on its own axis. At D = 1 or
    S = 1 one ring is the identity and this is the flat ring bitwise."""
    if wire_ici not in ("fp32", "bf16"):
        raise ValueError(
            "the ICI tier is the full-precision tier: wire_ici must be "
            f"'fp32' or 'bf16' (got {wire_ici!r}) — int8+EF belongs on "
            "the scarce DCN axis")
    superchunk, _ = ring_reduce_scatter(
        x, mesh.data_group, wire=wire_ici, residual=None,
        label=f"{label}_ici")
    return ring_reduce_scatter(
        superchunk, mesh.dcn_group, wire=wire_dcn, residual=residual,
        label=f"{label}_dcn")


# ------------------------------------------------- bucketed backward sync

class BucketMap(NamedTuple):
    """Ordered bucket decomposition of the padded flat gradient space (the
    JAX ``BucketMap``): ``local`` (one rank's slice) splits into per-bucket
    chunk ``sizes`` (``local // B`` each, the remainder over the leading
    buckets, so ``sum(sizes) == local``); bucket b covers the ordered
    coordinates ``[n·offsets[b], n·offsets[b] + n·sizes[b])``, the global
    ``pad`` rides the tail of the last bucket, and ``pieces[b]`` lists the
    ``(leaf_idx, start, size)`` slices of the ``tree_leaves``-order leaf
    ravels it concatenates. Rank r owns chunk r of every bucket."""
    n: int
    pad: int
    local: int
    total: int
    sizes: Tuple[int, ...]
    offsets: Tuple[int, ...]
    pieces: Tuple[Tuple[Tuple[int, int, int], ...], ...]

    @property
    def nbuckets(self) -> int:
        return len(self.sizes)


def _keyed_leaves(params) -> List[Tuple[Optional[str], Any]]:
    """``(top-level key, leaf)`` in ``tree_leaves`` order (key None when
    the tree is not a dict)."""
    if not isinstance(params, dict):
        return [(None, x) for x in tree_leaves(params)]
    return [(k, x) for k in sorted(params) for x in tree_leaves(params[k])]


def _ordered_pieces(params, leaf_local=None):
    """The local flat space in the order the backward emits gradients:
    ``(leaf_idx, start, size)`` pieces ordered ``lm_head`` → ``final_norm``
    → the stacked ``blocks`` layer groups from the top layer down → other
    leaves (tree order) → ``embed`` last. Trees without those keys keep
    tree order. ``leaf_local(key, leaf) -> (size, layers)`` overrides the
    per-rank leaf sizes (composed steps)."""
    head, norm, embed, other, blocks = [], [], [], [], []
    for li, (key, leaf) in enumerate(_keyed_leaves(params)):
        if leaf_local is not None:
            size, layers = leaf_local(key, leaf)
        else:
            size = int(leaf.numel())
            layers = (int(leaf.shape[0])
                      if key == "blocks" and leaf.dim() >= 1 else None)
        if size == 0:
            continue
        whole = (li, 0, size)
        if key == "lm_head":
            head.append(whole)
        elif key == "final_norm":
            norm.append(whole)
        elif key == "embed":
            embed.append(whole)
        elif key == "blocks" and layers and size % layers == 0:
            blocks.append((li, size // layers, layers))
        else:
            other.append(whole)
    pieces = head + norm
    if blocks:
        n_layers = max(layers for _, _, layers in blocks)
        for layer in range(n_layers - 1, -1, -1):
            for li, per_layer, layers in blocks:
                if layer < layers:
                    pieces.append((li, layer * per_layer, per_layer))
    return pieces + other + embed


def make_bucket_map(params, n: int, comm_buckets: int, *,
                    leaf_local=None) -> BucketMap:
    """The ``BucketMap`` of ``params`` over an ``n``-rank data world:
    ``_ordered_pieces`` cut at the ``n·sizes[b]`` bucket boundaries (a
    piece straddling one splits). Raises for a bucket count below 1 or
    above the per-rank slice."""
    B = int(comm_buckets)
    if B < 1:
        raise ValueError(f"comm_buckets must be >= 1 (got {comm_buckets})")
    pieces = _ordered_pieces(params, leaf_local)
    total = sum(sz for _, _, sz in pieces)
    pad = (-total) % n
    local = (total + pad) // n
    if B > local:
        raise ValueError(
            f"comm_buckets={B} exceeds the per-shard slice ({local} "
            f"coordinates at data world {n}) — every bucket needs at "
            "least one coordinate per shard")
    base, rem = divmod(local, B)
    sizes = tuple(base + (1 if b < rem else 0) for b in range(B))
    offsets = tuple(sum(sizes[:b]) for b in range(B))
    buckets, cur = [], []
    need = n * sizes[0]
    for li, st, sz in pieces:
        while sz:
            if need == 0:
                buckets.append(tuple(cur))
                cur = []
                need = n * sizes[len(buckets)]
            take = min(sz, need)
            cur.append((li, st, take))
            st += take
            sz -= take
            need -= take
    buckets.append(tuple(cur))
    return BucketMap(n, pad, local, total, sizes, offsets, tuple(buckets))


def _bucket_vector(bm: BucketMap, leaves, b: int) -> torch.Tensor:
    """Bucket b's fp32 ring vector ``[n·sizes[b]]`` from the leaves (in
    ``tree_leaves`` order), the global pad on the last bucket's tail."""
    parts = [leaves[li].detach().reshape(-1)[st:st + sz].float()
             for li, st, sz in bm.pieces[b]]
    if b == bm.nbuckets - 1 and bm.pad:
        parts.append(torch.zeros(bm.pad, dtype=torch.float32,
                                 device=parts[0].device))
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _bucket_vectors(bm: BucketMap, tree) -> List[torch.Tensor]:
    """Every bucket's ring vector (``_bucket_vector``) from a tree's
    leaves, or a list of them."""
    leaves = tree_leaves(tree) if isinstance(tree, dict) else list(tree)
    return [_bucket_vector(bm, leaves, b) for b in range(bm.nbuckets)]


def _scatter_buckets(bm: BucketMap, vecs, ref_tree):
    """The inverse of ``_bucket_vectors``: a tree of ``ref_tree``'s
    structure from per-bucket full vectors ``[n·sizes[b]]``, each leaf in
    its reference dtype."""
    ref_leaves = tree_leaves(ref_tree)
    per_leaf: Dict[int, list] = {}
    for b, pieces in enumerate(bm.pieces):
        pos = 0
        for li, st, sz in pieces:
            per_leaf.setdefault(li, []).append((st, b, pos, sz))
            pos += sz
    out = []
    for li, ref in enumerate(ref_leaves):
        segs = sorted(per_leaf[li])
        parts = [vecs[b][pos:pos + sz] for _, b, pos, sz in segs]
        flat = parts[0] if len(parts) == 1 else torch.cat(parts)
        out.append(flat.reshape(ref.shape).to(ref.dtype))
    return tree_unflatten(ref_tree, out)


def _bucket_slices(bm: BucketMap, gathered: torch.Tensor,
                   lead: int = 1) -> List[torch.Tensor]:
    """Per-bucket full vectors from a rank-major gathered stack
    ``[ranks·local]`` (each rank's slot its concat of per-bucket chunks);
    ``lead = D`` where each slot is itself a concat of ``[D·sizes[b]]``
    superchunk blocks (the hierarchical int8 parameter gather)."""
    g = gathered.reshape(-1, lead * bm.local)
    return [g[:, lead * bm.offsets[b]:
              lead * (bm.offsets[b] + bm.sizes[b])].reshape(-1)
            for b in range(bm.nbuckets)]


def ring_overlap_evidence(fn, *args) -> Dict[str, Any]:
    """The JAX function's five keys, from the hops that one call
    ``fn(*args)`` makes (it runs: every rank of the group must call it,
    on a copy of the state). A hop is independent when every gradient it
    carries was in before the last microbatch's backward had produced the
    layer stack's gradients (``blocks``: the JAX evidence's anchor, the
    layers' backward scan), so it can ring while that backward runs; it
    waits otherwise::

        {"n_ring_hops", "waited_hops", "independent_hops",
         "overlap_fraction", "first_hop_independent"}

    Unbucketed at M = 1 every hop waits (the sanity negative); bucketed,
    the buckets of the head and the final norm are independent; at M > 1
    so is every hop of every microbatch but the last."""
    hops: list = []
    token = _HOP_LOG.set(hops)
    try:
        fn(*args)
    finally:
        _HOP_LOG.reset(token)
    independent = sum(1 for h in hops if h.get("independent"))
    return {"n_ring_hops": len(hops), "waited_hops": len(hops) - independent,
            "independent_hops": independent,
            "overlap_fraction": (independent / len(hops)) if hops else 0.0,
            "first_hop_independent": bool(hops)
            and bool(hops[0].get("independent"))}


# ----------------------------------------------------- the overlap step

class OverlapEFState(NamedTuple):
    """``dp.TrainState`` and the two error-feedback residuals of the int8
    ring step, this rank's slot of each (the JAX package's ``[n, ...]``
    stacks), zero at init:

    - ``ring_residual`` ``[1, ring_len]``: the chunk-indexed per-hop error
      of the gradient ring (flat: ring_len = the padded vector; hierarchical:
      D·local, the DCN ring's only);
    - ``gather_residual`` ``[local]``: the error of the second leg's
      quantization (the ZeRO-1 parameter delta, or the reduced gradient
      slice; hierarchically, the DCN leg).

    At ``comm_buckets > 1`` both are tuples of per-bucket tensors. ``zero1``
    carries the ZeRO-1 slice geometry (None under gradient aggregation)."""
    params: Any
    opt_state: Any
    step: torch.Tensor
    ring_residual: Any
    gather_residual: Any
    zero1: Optional[dp.Zero1Geometry] = None

    PER_RANK_FIELDS = ("ring_residual", "gather_residual")
    # Both resize across worlds (``dp.reshard_state``: the elastic re-mesh).
    RESIZABLE_FIELDS = ("ring_residual", "gather_residual")


def _zero1_bucket_setup(optimizer, params, bm: BucketMap, mesh):
    """ZeRO-1 at ``comm_buckets > 1``: one optimizer state per bucket, over
    this rank's chunk ``[sizes[b]]`` of that bucket's vector (the JAX
    storage layout: each bucket's moment stack is one contiguous range)."""
    shard = dp.slice_index(mesh)
    vecs = _bucket_vectors(bm, params)
    opt_state = tuple(
        optimizer.init(vecs[b][shard * bm.sizes[b]:
                               (shard + 1) * bm.sizes[b]].clone())
        for b in range(bm.nbuckets))
    geom = dp.Zero1Geometry(bm.n, bm.pad, bm.local, bm.total, shard,
                            dist.get_rank())
    step = torch.zeros((), dtype=torch.int32, device=vecs[0].device)
    return dp.TrainState(params, opt_state, step, geom)


def check_wire(wire, aggregation: str, shape: Dict[str, int]):
    """The overlap step's validations of ``aggregation`` and ``wire`` on
    a layout of ``shape`` (``{"data": n}``, or ``{"dcn": D, "data": S}``),
    in the JAX function's order and with its messages. Returns
    ``(hier_shape, ef)``: (D, S) on the two-level path (else None), and
    whether a tier runs ``int8_ef``."""
    if aggregation not in ("gradient", "zero1"):
        raise ValueError("overlap driver supports gradient/zero1 "
                         f"aggregation only (got {aggregation!r})")
    if isinstance(wire, dict):
        if set(wire) != {"ici", "dcn"}:
            raise ValueError("per-axis wire must be "
                             '{"ici": fmt, "dcn": fmt} '
                             f"(got keys {sorted(wire)})")
        if "dcn" not in shape:
            raise ValueError(
                "per-axis wire formats need a hierarchical mesh with a "
                "'dcn' axis (parallel/distributed.py:hier_data_mesh)")
        if wire["ici"] not in ("fp32", "bf16"):
            raise ValueError(
                "the ICI tier is the full-precision tier: wire['ici'] "
                f"must be 'fp32' or 'bf16' (got {wire['ici']!r}) — "
                "int8+EF belongs on the scarce DCN axis")
        if wire["dcn"] not in WIRES:
            raise ValueError(f"unknown DCN wire format {wire['dcn']!r}")
        return (shape["dcn"], shape["data"]), wire["dcn"] == "int8_ef"
    if wire not in WIRES:
        raise ValueError(f"unknown wire format {wire!r}")
    if shape.get("dcn", 1) > 1:
        raise ValueError(
            "a hierarchical (dcn x data) mesh needs the per-axis wire "
            'dict ({"ici": ..., "dcn": ...}) — a flat wire string '
            "would run the ring over the 'data' axis only and never "
            "cross DCN")
    return None, wire == "int8_ef"


def _overlap_setup(params, optimizer, wire, aggregation: str,
                   comm_buckets: int = 1, mesh=None):
    """State and geometry of the overlap step, with the JAX function's
    validations in its order. ``wire``: a format string for the flat data
    ring, or ``{"ici": ..., "dcn": ...}`` for the two-level path on a
    hierarchical ``mesh``. Returns ``(state, n, pad, local, total,
    hier_shape, bm)``: ``hier_shape`` = (D, S) on the two-level path,
    ``bm`` None at ``comm_buckets == 1``."""
    shape = mesh.shape if mesh is not None else {"data": dist.world_size()}
    hier_shape, ef = check_wire(wire, aggregation, shape)
    n, pad, local, total = dp._flat_geometry(params)
    if int(comm_buckets) < 1:
        raise ValueError(
            f"comm_buckets must be >= 1 (got {comm_buckets})")
    bm = (make_bucket_map(params, n, comm_buckets)
          if int(comm_buckets) > 1 else None)
    if aggregation == "zero1":
        base = (_zero1_bucket_setup(optimizer, params, bm, mesh)
                if bm is not None else dp._zero1_setup(optimizer, params,
                                                       mesh))
    else:
        base = dp.init_state(params, optimizer)
    if not ef:
        return base, n, pad, local, total, hier_shape, bm
    ring_n = hier_shape[0] if hier_shape is not None else n
    device = base.step.device
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32,  # noqa: E731
                                   device=device)
    if bm is not None:
        ring_res = tuple(zeros(1, ring_n * sz) for sz in bm.sizes)
        gather_res = tuple(zeros(sz) for sz in bm.sizes)
    else:
        ring_res, gather_res = zeros(1, ring_n * local), zeros(local)
    state = OverlapEFState(base.params, base.opt_state, base.step, ring_res,
                           gather_res, base.zero1)
    return state, n, pad, local, total, hier_shape, bm


class _Ringer:
    """The rings of one step, on a thread of their own: task ``(m, b)``,
    bucket b of microbatch m (the whole padded vector without a bucket
    map), rings once the backward has produced every leaf it covers,
    while the backward and the next microbatches go on. ``hooks(m)``
    hands each leaf's gradient over as autograd produces it (with an
    event on its stream, on a card). Tasks run in (m, b) order on every
    rank, so the ranks' collectives pair up; the residual threads through
    them in that order. A task is independent (the overlap evidence) when
    its leaves were all in before the last microbatch's backward had
    produced the layer stack's gradients (``anchor``: the leaves under
    ``blocks``, all leaves without them), the JAX evidence's anchor, the
    backward scan over the layers. On a card the thread works on the side
    stream ``side``; ``finish`` makes the main stream wait for it."""

    def __init__(self, leaves, anchor: List[int], bm: Optional[BucketMap],
                 pad: int, M: int, reduce_fn: Callable, ring_res, side):
        self.leaves, self.bm, self.pad, self.M = leaves, bm, pad, M
        self.anchor = anchor
        self.reduce_fn, self.ring_res, self.side = reduce_fn, ring_res, side
        self.need = ([sorted({li for li, _, _ in pieces})
                      for pieces in bm.pieces] if bm is not None
                     else [list(range(len(leaves)))])
        self.grads: Dict[Tuple[int, int], Any] = {}
        self.ready: Dict[Tuple[int, int], bool] = {}
        self.reds: List[List[torch.Tensor]] = [[] for _ in range(M)]
        self.error: Optional[BaseException] = None
        self.closed = False
        self.cond = threading.Condition()
        self.thread = threading.Thread(
            target=contextvars.copy_context().run, args=(self._run,),
            daemon=True)
        self.thread.start()

    @contextlib.contextmanager
    def hooks(self, m: int):
        handles = [leaf.register_hook(self._hook(m, i))
                   for i, leaf in enumerate(self.leaves)]
        try:
            yield
        finally:
            for h in handles:
                h.remove()

    def _hook(self, m: int, i: int):
        def hook(g: torch.Tensor):
            ev = None
            if g.is_cuda:
                ev = torch.cuda.Event()
                ev.record()
            with self.cond:
                self.grads[(m, i)] = (g, ev)
                complete = all((m, j) in self.grads for j in self.anchor)
                for b, need in enumerate(self.need):
                    if (m, b) not in self.ready and all(
                            (m, j) in self.grads for j in need):
                        self.ready[(m, b)] = (m < self.M - 1
                                              or not complete)
                self.cond.notify_all()
        return hook

    def put(self, m: int, grads) -> None:
        """Hand microbatch m's gradient leaves over at once (a composed
        step whose gradients are complete only after a collective of its
        own, as tensor parallelism's replicated leaves)."""
        for i, g in enumerate(grads):
            self._hook(m, i)(g)

    def _vector(self, m: int, b: int) -> torch.Tensor:
        grads = []
        for j in range(len(self.leaves)):
            g, ev = self.grads.get((m, j), (None, None))
            if ev is not None and j in self.need[b]:
                self.side.wait_event(ev)
            grads.append(g)
        if self.bm is None:
            return dp._flat_fp32(grads, self.pad)
        return _bucket_vector(self.bm, grads, b)

    def _run(self) -> None:
        try:
            ctx = (torch.cuda.stream(self.side) if self.side is not None
                   else contextlib.nullcontext())
            with ctx:
                for m in range(self.M):
                    for b in range(len(self.need)):
                        with self.cond:
                            self.cond.wait_for(lambda: (m, b) in self.ready
                                               or self.closed)
                            if (m, b) not in self.ready:
                                return
                            independent = self.ready[(m, b)]
                        vec = self._vector(m, b)
                        token = _HOP_CTX.set(
                            {"microbatch": m, "independent": independent,
                             **({} if self.bm is None else {"bucket": b})})
                        try:
                            if self.bm is None:
                                red, self.ring_res = self.reduce_fn(
                                    vec, self.ring_res)
                            else:
                                red, res_b = self.reduce_fn(
                                    vec, None if self.ring_res is None
                                    else self.ring_res[b], b)
                                if self.ring_res is not None:
                                    self.ring_res[b] = res_b
                        finally:
                            _HOP_CTX.reset(token)
                        self.reds[m].append(red)
                    with self.cond:     # microbatch m's gradients are done
                        for j in range(len(self.leaves)):
                            self.grads.pop((m, j), None)
        except BaseException as e:      # raised again by ``finish``
            self.error = e

    def finish(self):
        """Wait for every task; returns the per-microbatch owned slices
        (the per-bucket chunks concatenated) and the residual."""
        self.thread.join(timeout=dist.GROUP_TIMEOUT.total_seconds())
        if self.thread.is_alive():
            raise TimeoutError("the ring thread did not finish within "
                               f"{dist.GROUP_TIMEOUT}")
        if self.error is not None:
            raise self.error
        res = self.ring_res
        if self.side is not None:
            main = torch.cuda.current_stream(self.side.device)
            done = torch.cuda.Event()
            done.record(self.side)
            main.wait_event(done)
            for t in [x for r in self.reds for x in r] + (
                    [] if res is None else [res] if torch.is_tensor(res)
                    else list(res)):
                t.record_stream(main)
        return [r[0] if len(r) == 1 else torch.cat(r)
                for r in self.reds], res

    def close(self) -> None:
        """Release the thread (a step that raised leaves tasks unready)."""
        with self.cond:
            self.closed = True
            self.cond.notify_all()
        self.thread.join(timeout=dist.GROUP_TIMEOUT.total_seconds())


def _make_overlap_local_step(loss_fn: Callable, optimizer, n: int, pad: int,
                             local: int, total: int, *, microbatches: int,
                             wire, aggregation: str, mesh=None,
                             hier_shape=None, bucket_map=None,
                             guard_nonfinite: bool = False,
                             numerics=None, grads_fn=None,
                             prefix: Optional[str] = None,
                             shard: Optional[int] = None,
                             data_group=None,
                             scale_sync_groups=(None, None)) -> Callable:
    """The per-rank overlapped step shared by ``make_overlap_step`` and
    ``make_overlap_multi_step`` (the JAX body, in eager order), and by the
    DP×TP drivers (``parallel/tp.py``).

    Per step: the local batch splits into M microbatches, each forward and
    backward launched in turn while the ring thread (``_Ringer``) rings
    each bucket of each microbatch, in order, as soon as the backward has
    produced its gradients (on a card: on a side stream that waits on
    those gradients alone). The reduced chunks sum in fp32 on the owner,
    microbatch by microbatch; their mean over n·M feeds
    the ZeRO-1 slice update and the parameter gather (an int8 delta with
    its own residual under ``int8_ef``), or the gradient gather in the
    wire format and the replicated update. On the hierarchical path the
    reduce is ``hier_reduce_scatter``, the slice is ``s·D + d`` and the
    gather runs its DCN leg first (compressed under ``wire["dcn"] =
    "int8_ef"``), then the island's.

    ``guard_nonfinite``: the verdict on (loss, owned gradient slice) is
    summed over every data axis in a 4-byte ``psum`` and read on the host
    before anything is written; a bad step leaves the whole state (the
    residuals included) as it was and ``step`` does not advance; its loss
    comes back as it was. ``numerics``: the second output is ``(loss,
    NumericsSummary)`` over the local microbatch-mean gradient and the
    attempted update, which a skipped step computes on copies of the
    moments (only skipped steps with numerics on pay for them).

    ``bucket_map``: each microbatch's gradient is cut into per-bucket ring
    vectors that ring under ``ring_grad_b{b}``; the owned slice is the
    concat of the per-bucket chunks and the gather legs stay one
    collective each.

    A composed step (the flat ring only) passes ``grads_fn(params, leaves,
    batch, ringer, m) -> (loss, grads)``, which hands microbatch m's
    gradients to ``ringer`` itself (default: ``loss_fn`` under
    ``ringer.hooks(m)``); ``prefix``, the label prefix of its ring and
    gathers (``{prefix}ring_grad``, ``{prefix}param_gather``, ...; default
    ``ring_grad`` and ``overlap_...``); ``shard``, its slice index
    (default ``dp.slice_index(mesh)``); ``data_group``, the group its ring
    runs over; and ``scale_sync_groups``, the groups the int8 scales are
    agreed over (the ring thread's, the gather leg's). A per-rank ring
    residual of one dimension (the composed layout) stays so."""
    M = microbatches
    bm = bucket_map
    B = bm.nbuckets if bm is not None else 1
    hier = hier_shape is not None
    if data_group is not None:
        dgroup, cgroup = data_group, None
    elif mesh is None:            # the whole process group as one axis
        dgroup, cgroup = dist.data_group(), None
    else:
        dgroup, cgroup = mesh.data_group, mesh.dcn_group
    ring_sync, gather_sync = scale_sync_groups
    ring_label = f"{prefix or ''}ring_grad"
    gp = prefix or "overlap_"     # the flat ring's gather labels
    if hier:
        D, S = hier_shape
        wire_ici, wire_dcn = wire["ici"], wire["dcn"]
        ef = wire_dcn == "int8_ef"
    else:
        ef = wire == "int8_ef"
    streams: Dict[torch.device, Any] = {}
    anchor: List[int] = []

    def _reduce(vec, ring_res, bucket=None):
        label = ring_label if bucket is None else f"{ring_label}_b{bucket}"
        if hier:
            return hier_reduce_scatter(
                vec, mesh, wire_ici=wire_ici, wire_dcn=wire_dcn,
                residual=ring_res, label=label)
        return ring_reduce_scatter(vec, dgroup, wire=wire,
                                   residual=ring_res, label=label,
                                   scale_sync_group=ring_sync)

    def _hooked(params, leaves, batch, ringer, m):
        # Each leaf's gradient goes to the ring thread as the backward
        # produces it: a bucket rings once its leaves are in, while the
        # backward (and the next microbatch) go on.
        with ringer.hooks(m):
            l = loss_fn(params, batch)
            g = torch.autograd.grad(l, leaves)
        return l.detach(), g

    grads_of = grads_fn or _hooked

    def local_step(state, batch: torch.Tensor):
        if batch.shape[0] % M:
            raise ValueError(f"local batch {batch.shape[0]} not divisible "
                             f"by overlap_microbatches={M}")
        params = state.params
        leaves = tree_leaves(params)
        device = leaves[0].device
        if not anchor:
            keyed = _keyed_leaves(params)
            anchor.extend([i for i, (k, _) in enumerate(keyed)
                           if k == "blocks"] or range(len(keyed)))
        if ef:
            first = (state.ring_residual if bm is None
                     else state.ring_residual[0])
            lead = first.dim() == 2     # [1, n·local]; composed: [n·local]
            if bm is None:
                ring_res = first[0] if lead else first
            else:
                ring_res = [r[0] if lead else r for r in state.ring_residual]
        else:
            ring_res = None
        micro = batch.reshape((M, -1) + tuple(batch.shape[1:]))
        loss_sum = torch.zeros((), dtype=torch.float32, device=device)
        gacc = None
        side = (streams.setdefault(device, torch.cuda.Stream(device))
                if device.type == "cuda" else None)
        ringer = _Ringer(leaves, anchor, bm, pad, M, _reduce, ring_res,
                         side)
        try:
            for m in range(M):
                l, g = grads_of(params, leaves, micro[m], ringer, m)
                loss_sum = loss_sum + l.float()
                if numerics is not None:
                    gacc = ([x.float() for x in g] if gacc is None
                            else [a + x.float() for a, x in zip(gacc, g)])
                del g
            reds, ring_res = ringer.finish()
        finally:
            ringer.close()
        acc = torch.zeros(local, dtype=torch.float32, device=device)
        for red in reds:                  # microbatch order, as JAX adds
            acc = acc + red
        g_mine = acc / (n * M)
        loss = dist.pmean(loss_sum / M, label="loss_allreduce", group=dgroup)
        if hier:
            loss = dist.pmean(loss, label="loss_allreduce_dcn",
                              group=cgroup)

        ok = True
        if guard_nonfinite:
            okv = (torch.isfinite(loss)
                   & torch.isfinite(g_mine).all()).to(torch.int32)
            oki = dist.psum(okv, label="overlap_guard_verdict", group=dgroup)
            if hier:
                oki = dist.psum(oki, label="overlap_guard_verdict_dcn",
                                group=cgroup)
            ok = int(oki) == n
            if not ok and numerics is None:
                return state, loss
        opt_in = state.opt_state if ok else tree_copy(state.opt_state)

        if bm is None:
            flat_p = dp._flat_fp32(leaves, pad)
            pvecs = None
        else:
            flat_p = None
            pvecs = _bucket_vectors(bm, params)
        gather_res = None
        old = None
        if aggregation == "zero1":
            mine = dp.slice_index(mesh) if shard is None else shard
            if bm is None:
                p_mine = flat_p[mine * local:(mine + 1) * local].clone()
                new_p_mine, opt_state = apply_optimizer(
                    optimizer, g_mine, opt_in, p_mine.clone())
            else:
                p_chunks = [pvecs[b][mine * bm.sizes[b]:
                                     (mine + 1) * bm.sizes[b]]
                            for b in range(B)]
                new_chunks, opts = [], []
                for b in range(B):
                    np_b, opt_b = apply_optimizer(
                        optimizer,
                        g_mine[bm.offsets[b]:bm.offsets[b] + bm.sizes[b]],
                        opt_in[b], p_chunks[b].clone())
                    new_chunks.append(np_b)
                    opts.append(opt_b)
                p_mine = torch.cat(p_chunks)
                new_p_mine = torch.cat(new_chunks)
                opt_state = tuple(opts)
            vec_new = None
            if hier:
                if wire_dcn == "int8_ef":
                    gres = (torch.cat(state.gather_residual)
                            if bm is not None else state.gather_residual)
                    q, s, gather_res = _int8_encode(
                        (new_p_mine - p_mine) + gres)
                    q_all = dist.all_gather(
                        q, label="overlap_delta_gather_int8", group=cgroup)
                    s_all = dist.all_gather(
                        s.reshape(1), label="overlap_delta_scale_gather",
                        group=cgroup)
                    isle = mesh.s
                    if bm is None:
                        p_super = flat_p[isle * D * local:
                                         (isle + 1) * D * local]
                        super_new = _fma(p_super,
                                         s_all.repeat_interleave(local),
                                         q_all)
                    else:
                        q_slc = _bucket_slices(bm, q_all)
                        super_new = torch.cat([
                            _fma(pvecs[b][isle * D * bm.sizes[b]:
                                          (isle + 1) * D * bm.sizes[b]],
                                 s_all.repeat_interleave(bm.sizes[b]),
                                 q_slc[b])
                            for b in range(B)])
                else:
                    super_new = dist.all_gather(
                        new_p_mine, label="overlap_param_gather_dcn",
                        group=cgroup)
                flat_new = dist.all_gather(
                    super_new, label="overlap_param_gather_ici",
                    group=dgroup)
                if bm is not None:
                    vec_new = _bucket_slices(
                        bm, flat_new,
                        lead=(D if wire_dcn == "int8_ef" else 1))
            elif wire == "int8_ef":
                gres = (torch.cat(state.gather_residual)
                        if bm is not None else state.gather_residual)
                q, s, gather_res = _int8_encode((new_p_mine - p_mine) + gres,
                                                gather_sync)
                q_all = dist.all_gather(q, label=f"{gp}delta_gather_int8",
                                        group=dgroup)
                s_all = dist.all_gather(s.reshape(1),
                                        label=f"{gp}delta_scale_gather",
                                        group=dgroup)
                if bm is None:
                    flat_new = _fma(flat_p, s_all.repeat_interleave(local),
                                    q_all)
                else:
                    q_slc = _bucket_slices(bm, q_all)
                    vec_new = [_fma(pvecs[b],
                                    s_all.repeat_interleave(bm.sizes[b]),
                                    q_slc[b]) for b in range(B)]
            else:
                flat_new = dist.all_gather(new_p_mine,
                                           label=f"{gp}param_gather",
                                           group=dgroup)
                if bm is not None:
                    vec_new = _bucket_slices(bm, flat_new)
            if bm is None:
                new_leaves = [piece.view(p.shape).to(p.dtype) for p, piece
                              in zip(leaves, flat_new[:total].split(
                                  [p.numel() for p in leaves]))]
            else:
                new_leaves = tree_leaves(_scatter_buckets(bm, vec_new,
                                                          params))
            new_tree = tree_unflatten(params, new_leaves)
        else:                                           # replicated update
            gres = None
            if ef:
                gres = (torch.cat(state.gather_residual) if bm is not None
                        else state.gather_residual)
            if hier:
                if wire_dcn == "int8_ef":
                    q, s, gather_res = _int8_encode(g_mine + gres)
                    q_all = dist.all_gather(
                        q, label="overlap_grad_gather_int8", group=cgroup)
                    s_all = dist.all_gather(
                        s.reshape(1), label="overlap_grad_scale_gather",
                        group=cgroup)
                    super_g = (s_all.repeat_interleave(local)
                               * q_all.to(torch.float32))
                elif wire_dcn == "bf16":
                    super_g = dist.all_gather(
                        g_mine.to(torch.bfloat16),
                        label="overlap_grad_gather_dcn_bf16",
                        group=cgroup).to(torch.float32)
                else:
                    super_g = dist.all_gather(
                        g_mine, label="overlap_grad_gather_dcn", group=cgroup)
                if wire_ici == "bf16":
                    flat_g = dist.all_gather(
                        super_g.to(torch.bfloat16),
                        label="overlap_grad_gather_ici_bf16",
                        group=dgroup).to(torch.float32)
                else:
                    flat_g = dist.all_gather(
                        super_g, label="overlap_grad_gather_ici",
                        group=dgroup)
            elif wire == "int8_ef":
                q, s, gather_res = _int8_encode(g_mine + gres, gather_sync)
                q_all = dist.all_gather(q, label=f"{gp}grad_gather_int8",
                                        group=dgroup)
                s_all = dist.all_gather(s.reshape(1),
                                        label=f"{gp}grad_scale_gather",
                                        group=dgroup)
                flat_g = (s_all.repeat_interleave(local)
                          * q_all.to(torch.float32))
            elif wire == "bf16":
                flat_g = dist.all_gather(
                    g_mine.to(torch.bfloat16),
                    label=f"{gp}grad_gather_bf16",
                    group=dgroup).to(torch.float32)
            else:
                flat_g = dist.all_gather(g_mine, label=f"{gp}grad_gather",
                                         group=dgroup)
            if bm is None:
                grad_leaves = [piece.view(p.shape).to(p.dtype) for p, piece
                               in zip(leaves, flat_g[:total].split(
                                   [p.numel() for p in leaves]))]
                grads = tree_unflatten(params, grad_leaves)
            else:
                grads = _scatter_buckets(bm, _bucket_slices(bm, flat_g),
                                         params)
            if numerics is not None or not ok:
                old = tree_unflatten(params, [p.detach().clone()
                                              for p in leaves])
            target = params if ok else tree_unflatten(
                params, [p.detach().clone() for p in leaves])
            new_tree, opt_state = apply_optimizer(optimizer, grads, opt_in,
                                                  target)
        summary = None
        if numerics is not None:
            summary = numerics.summarize(
                params if old is None else old,
                tree_unflatten(params, [x / M for x in gacc]), new_tree)
        out = (loss, summary) if summary is not None else loss
        if not ok:
            return state, out
        if aggregation == "zero1":
            with torch.no_grad():
                for p, x in zip(leaves, tree_leaves(new_tree)):
                    p.copy_(x)
        step = state.step + 1
        if not ef:
            return state._replace(opt_state=opt_state, step=step), out
        if bm is not None:
            ring_res = tuple(r[None] if lead else r for r in ring_res)
            gather_res = tuple(
                gather_res[bm.offsets[b]:bm.offsets[b] + bm.sizes[b]]
                for b in range(B))
        elif lead:
            ring_res = ring_res[None]
        return state._replace(opt_state=opt_state, step=step,
                              ring_residual=ring_res,
                              gather_residual=gather_res), out

    return local_step


def make_overlap_step(loss_fn: Callable, optimizer, params, *, mesh=None,
                      microbatches: int = 1, wire="fp32",
                      aggregation: str = "gradient", comm_buckets: int = 1,
                      guard_nonfinite: bool = False, numerics=None,
                      device=None):
    """The per-step overlapped and compressed gradient-sync step on this
    rank: ``(state, step)``, ``step(state, batch) -> (state, loss)`` on this
    rank's ``[B, T]`` rows. The state is an ``OverlapEFState`` when a tier
    runs ``int8_ef``, a ``dp.TrainState`` otherwise (ZeRO-1 slices under
    ``aggregation="zero1"``). ``params`` (the model's tree) must lie on
    ``device`` ("cpu", or None for CUDA: raises when no card is present)
    and are updated in place.

    ``wire``: a format string runs the flat ring over the data world
    (``mesh`` None: the whole process group); ``{"ici": "fp32"|"bf16",
    "dcn": "fp32"|"bf16"|"int8_ef"}`` runs the two-level reduction on a
    hierarchical ``mesh`` (``distributed.hier_data_mesh``).
    ``comm_buckets > 1``: the bucketed backward. ``guard_nonfinite``,
    ``numerics``: see ``_make_overlap_local_step``."""
    dev = dist.rank_device(device)
    if any(p.device != dev for p in tree_leaves(params)):
        raise ValueError(f"make_overlap_step runs on {dev}: the parameters "
                         "must lie there")
    (state, n, pad, local, total, hier_shape,
     bm) = _overlap_setup(params, optimizer, wire, aggregation,
                          comm_buckets, mesh)
    return state, _make_overlap_local_step(
        loss_fn, optimizer, n, pad, local, total, microbatches=microbatches,
        wire=wire, aggregation=aggregation, mesh=mesh, hier_shape=hier_shape,
        bucket_map=bm, guard_nonfinite=guard_nonfinite, numerics=numerics)


def make_overlap_multi_step(loss_fn: Callable, optimizer, params, *,
                            mesh=None, microbatches: int = 1, wire="fp32",
                            aggregation: str = "gradient",
                            comm_buckets: int = 1,
                            guard_nonfinite: bool = False, numerics=None,
                            device=None):
    """``make_overlap_step`` inside the K-step loop: ``step(state, window)
    -> (state, losses)`` over this rank's ``[K, B, T]`` window. The body is
    the per-step one, so the losses and the final state (residuals
    included) are bitwise K per-step calls."""
    state, step = make_overlap_step(
        loss_fn, optimizer, params, mesh=mesh, microbatches=microbatches,
        wire=wire, aggregation=aggregation, comm_buckets=comm_buckets,
        guard_nonfinite=guard_nonfinite, numerics=numerics, device=device)
    return state, dp._loop(step)
