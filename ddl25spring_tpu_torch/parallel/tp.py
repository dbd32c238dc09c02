"""Tensor (model) parallelism: counterpart of the JAX package's
``parallel/tp.py`` (Megatron-sharded blocks, the partially synchronized
activation modes, the shared-body and K-step drivers, the model-agreed
numerics and the DP×TP ring drivers).

The JAX module runs each step as one SPMD program under ``shard_map`` over
a ``(data, model)`` mesh. The port goes back to processes: each (data row,
model shard) is one OS process of a gloo group (``distributed.tp_mesh``:
rank ``d·M + m``), holding only its slices of the sharded leaves and a
full copy of the rest, and each ``lax.psum(·, "model")`` is a sum over the
row's ``model_group``, each collective over ``data`` one over the column's
``data_group``. Every model shard of a row sees the same tokens; only the
data axis splits the batch.

Sharding layout (per block; the leading ``[n_layers]`` axis is never
sliced): wq, wk, wv, w_gate, w_up ``[L, D, ·]`` by columns (dim 2), so each
shard runs ``num_heads / tp`` heads and ``ffn / tp`` hidden units end to
end; wo, w_down ``[L, ·, D]`` by rows (dim 1), whose partial outputs are
summed over the model group inside ``llama.attention`` / ``llama.mlp``;
norms, ``embed`` and ``lm_head`` replicated.

Gradient accounting, JAX's exactly: each shard's loss is divided by tp
before differentiation, and the in-model sum is ``distributed.psum_ad``,
whose backward is a sum too (the transpose of ``lax.psum`` under
``shard_map(check_vma=False)``). Sharded leaves then get exact gradients
locally; the replicated leaves' gradients are partials, summed over the
model group after the backward (``tp_replicated_grads``). Every model
shard computes the full embed, head and cross-entropy, as JAX's does.

Partially synchronized activations (``psa``, arXiv 2506.19645): ``""`` is
the raw in-model sum (bitwise ``make_tp_train_step``), ``"full"`` the same
sums recorded as ``psa_full_sync``, ``"defer:L"`` no sync inside a group of
L layers and one boundary correction ``psum(h) − (tp−1)·h0``, and
``"int8_ef"`` an int8 all-gather of each sub-layer's error-compensated
partial with the per-shard residual in the state (``TPActState``). The
relaxed modes swap the combined value in on the forward while the backward
keeps the exact sum's transpose (``_PsumSTE``). Only forward syncs are
recorded, never the backward's and never a rematerialized forward's, so
the totals per label equal JAX's trace-time accounting byte for byte.

States are updated in place. A state carries its ``TPGeometry``;
``host_snapshot`` merges the model slices into the JAX global layout and
stacks the per-rank leaves (the activation and ring residuals, ZeRO-1
moments) ``[n_data, tp, ...]`` in JAX's shard order, ``slice_state`` gives
each rank its own part back (``checkpoint.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from . import compress, dp
from . import distributed as dist
from .dp import _loop
from .. import nn
from ..config import LlamaConfig, torch_dtype
from ..models import llama
from ..ops.adam import apply_optimizer
from ..telemetry import comm as _comm
from ..telemetry import introspect
from ..tree import tree_leaves, tree_map, tree_unflatten

_COL = {"wq", "wk", "wv", "w_gate", "w_up"}   # shard the last dim (columns)
_ROW = {"wo", "w_down"}                        # shard the middle dim (rows)


# ------------------------------------------------------------- the layout

def param_specs(params) -> dict:
    """Which dimension of each leaf the model axis slices (JAX's
    PartitionSpecs): 2 for the column-sharded block leaves, 1 for the
    row-sharded ones, None for a replicated leaf."""
    params = llama.as_tree(params)

    def block_spec(name):
        return 2 if name in _COL else 1 if name in _ROW else None

    return {k: ({name: tree_map(lambda _, s=block_spec(name): s, leaf)
                 for name, leaf in v.items()} if k == "blocks"
                else tree_map(lambda _: None, v))
            for k, v in params.items()}


def _sharded_mask(params) -> dict:
    """True for the model-sharded leaves (complete gradients locally),
    False for the replicated ones (partials needing a sum over model)."""
    return tree_map(lambda s: s is not None, param_specs(params))


def _slice(x, dim: Optional[int], tp: int, m: int):
    if dim is None:
        return x
    size = x.shape[dim] // tp
    return x.narrow(dim, m * size, size)


def local_slices(params, specs, n: int, index: int, device=None) -> dict:
    """Slice ``index`` of ``n`` of each leaf of a whole tree (tensors or
    numpy arrays) along the dimension its spec names (None: the whole
    leaf), as fresh tensors on ``device`` (None: CUDA) that require grad."""
    dev = dist.rank_device(device)

    def take(x, s):
        x = (torch.from_numpy(np.array(x)) if isinstance(x, np.ndarray)
             else x.detach())
        return _slice(x, s, n, index).to(dev).clone().requires_grad_()

    return tree_map(take, params, specs)


def shard_params(mesh: dist.TPMesh, params, device=None) -> dict:
    """Model shard ``mesh.m``'s slices of a whole JAX-layout tree (a
    ``Llama``, its tree, or ``convert.params_to_numpy``'s numpy tree), as
    fresh tensors on ``device`` (None: CUDA) that require grad: the weight
    bridge to tensor parallelism."""
    params = llama.as_tree(params)
    return local_slices(params, param_specs(params), mesh.model, mesh.m,
                        device)


@dataclass(frozen=True)
class TPGeometry:
    """Where a TP state sits: its mesh, and whether its optimizer state is
    a ZeRO-1 slice (``[local]`` vectors per (data, model) rank)."""

    mesh: dist.TPMesh
    zero1: bool = False


class TPState(NamedTuple):
    """The JAX ``TrainState`` of one (data, model) rank: its parameter
    slices, their optimizer state, the step, and the geometry."""
    params: Any
    opt_state: Any
    step: torch.Tensor
    tp: TPGeometry

    PER_RANK_FIELDS = ()


class TPActState(NamedTuple):
    """``TPState`` and the PSA activation error-feedback residual of
    ``psa="int8_ef"``: this rank's ``[L, 2, B, T, D]`` fp32 slot of JAX's
    ``[n_data, tp, L, 2, B, T, D]`` stack (slot [l, 0] layer l's attention
    output, [l, 1] its MLP output). It rides the K-step loop and the
    checkpoint, so error feedback survives both exactly."""
    params: Any
    opt_state: Any
    step: torch.Tensor
    act_residual: torch.Tensor
    tp: TPGeometry

    PER_RANK_FIELDS = ("act_residual",)
    # Resizes across data worlds (``dp._resize_act_residual``, in
    # ``slice_state``): the elastic re-mesh of a data row.
    RESIZABLE_FIELDS = ("act_residual",)


class TPOverlapEFState(NamedTuple):
    """The DP×TP ring state under ``wire="int8_ef"`` (JAX's
    ``OverlapEFState`` on the TP mesh): this rank's slot of the ring
    residual (``[n·local]``, JAX's ``[n, tp, n·local]``) and of the second
    leg's (``[local]``); per-bucket tuples at ``comm_buckets > 1``."""
    params: Any
    opt_state: Any
    step: torch.Tensor
    ring_residual: Any
    gather_residual: Any
    tp: TPGeometry

    PER_RANK_FIELDS = ("ring_residual", "gather_residual")


def init_state(mesh: dist.TPMesh, params, optimizer,
               device=None) -> TPState:
    """This rank's state from the whole parameter tree: its slices
    (``shard_params``) and the optimizer state for them alone."""
    local = shard_params(mesh, params, device)
    return TPState(local, optimizer.init(local),
                   torch.zeros((), dtype=torch.int32,
                               device=tree_leaves(local)[0].device),
                   TPGeometry(mesh))


def shard_batch(mesh: dist.TPMesh, batch, device=None) -> torch.Tensor:
    """This rank's data row of a global ``[D·B, T]`` batch on ``device``
    (every model shard of the row gets the same rows)."""
    b = batch.shape[-2] // mesh.data
    return torch.as_tensor(batch[..., mesh.d * b:(mesh.d + 1) * b, :],
                           dtype=torch.long, device=dist.rank_device(device))


def shard_batch_window(mesh: dist.TPMesh, window,
                       device=None) -> torch.Tensor:
    """This rank's data row of a ``[K, D·B, T]`` window."""
    return shard_batch(mesh, window, device)


# ----------------------------------------------------- forward and loss

def _remat(cfg: LlamaConfig, fn: Callable, *args):
    """``fn(*args)``, under ``cfg.remat`` (with autograd recording) in
    ``torch.utils.checkpoint``: its backward runs ``fn`` again, with the
    collectives the first run recorded left unrecorded."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn(*args)
    runs = []

    def run(*a):
        runs.append(1)
        if len(runs) == 1:
            return fn(*a)
        with _comm.quiet():
            return fn(*a)

    return torch.utils.checkpoint.checkpoint(
        run, *args, use_reentrant=False, preserve_rng_state=False)


def _model_sum(group: dist.Group) -> Callable:
    """The in-model sum over the model group: ``psum_ad``, unrecorded (the
    JAX model's raw ``lax.psum``)."""
    return lambda y: dist.psum_ad(y, group)


def tp_forward(params: dict, tokens: torch.Tensor, cfg: LlamaConfig,
               mesh: dist.TPMesh) -> torch.Tensor:
    """Full fp32 logits ``[B, T, V]`` through the tensor-parallel forward,
    from this rank's slices (``shard_params``); the same on every shard."""
    h = llama.embed(params, tokens, cfg)
    h = llama.blocks_apply(params["blocks"], h, cfg,
                           tp_sum=_model_sum(mesh.model_group))
    return llama.head(params, h, cfg)


def _parse_psa(psa: str, n_layers: int) -> Tuple[str, int]:
    """Validate a ``TrainConfig.psa`` string → ``(mode, defer_period)``
    with mode ∈ {"", "full", "defer", "int8_ef"} (JAX's messages)."""
    if psa in ("", "full", "int8_ef"):
        return psa, 0
    if psa.startswith("defer:"):
        try:
            period = int(psa.split(":", 1)[1])
        except ValueError:
            period = 0
        if period < 1:
            raise ValueError(f"bad PSA defer period in {psa!r}: want "
                             "'defer:L' with integer L >= 1")
        if n_layers % period:
            raise ValueError(
                f"psa='defer:{period}' needs n_layers divisible by the "
                f"defer period (got n_layers={n_layers}) — the last layer "
                "group must end on a sync boundary or shards never agree")
        return "defer", period
    raise ValueError(f"unknown psa mode {psa!r}: expected '', 'full', "
                     "'defer:L' or 'int8_ef'")


def psa_sync_wire_bytes(cfg: LlamaConfig, psa: str, tp: int,
                        batch: int, seq: int) -> int:
    """Analytic per-rank per-step model-axis activation-sync wire bytes of
    one forward, as the recorded forward syncs count them (JAX's
    formulas): ``""``/``"full"`` 2L sums of ``[B, T, D]`` →
    ``2L · 2(tp−1)/tp · B·T·D·itemsize``; ``"defer:P"`` one boundary sum
    per P layers; ``"int8_ef"`` 2L int8 all-gathers and a 4-byte scale
    gather each → ``2L · (tp−1) · (B·T·D + 4)``."""
    mode, period = _parse_psa(psa, cfg.n_layers)
    act = batch * seq * cfg.dmodel
    item = torch.empty((), dtype=torch_dtype(cfg.dtype)).element_size()
    if mode == "int8_ef":
        return 2 * cfg.n_layers * (tp - 1) * (act + 4)
    syncs = (cfg.n_layers // period) if mode == "defer" else 2 * cfg.n_layers
    return int(syncs * (2 * (tp - 1) / tp) * act * item)


class _PsumSTE(torch.autograd.Function):
    """Swap a shard's partial sub-layer output ``y`` for the externally
    combined ``summed`` on the forward, while the backward keeps the exact
    sum's transpose (a sum of the cotangent over the group, unrecorded) for
    ``y`` and sends nothing to ``summed``: the 1/tp accounting carries
    over to the compressed sync unchanged."""

    @staticmethod
    def forward(ctx, y, summed, group):
        ctx.group = group
        return summed.clone()

    @staticmethod
    def backward(ctx, ct):
        return dist._sum_over(ct.contiguous(), ctx.group), None, None


def _psa_int8_sync(y: torch.Tensor, res: torch.Tensor,
                   group: dist.Group):
    """One compressed activation sync over the model group: quantize the
    error-compensated partial ``y + res`` to int8 (``compress.
    _int8_encode``), all-gather (q, s) from every shard in int8 and fp32
    (``psa_act_int8``, ``psa_act_scale``) and sum the dequantized partials
    here. Returns ``(combined, residual')``."""
    c = y.detach().float() + res
    q, s, new_res = compress._int8_encode(c)
    q_all = dist.all_gather(q, label="psa_act_int8", group=group)
    s_all = dist.all_gather(s.reshape(1), label="psa_act_scale", group=group)
    summed = torch.einsum("i,i...->...", s_all,
                          q_all.view((group.size,) + q.shape).float())
    return _PsumSTE.apply(y, summed.to(y.dtype), group), new_res


def _psa_blocks_apply(blocks: dict, h: torch.Tensor, cfg: LlamaConfig,
                      group: dist.Group, mode: str, period: int, act_res):
    """The transformer stack with the per-sub-layer model-axis sync of
    ``mode``; returns ``(h, act_res')`` (the residual None but under
    ``"int8_ef"``). ``""`` is ``llama.blocks_apply`` over the group;
    ``"full"`` the same sums, recorded; ``"defer"`` partial sub-layer
    outputs within a group of ``period`` layers, then ``psum(h) −
    (tp−1)·h0``; ``"int8_ef"`` ``_psa_int8_sync`` after each sub-layer."""
    if mode == "":
        return (llama.blocks_apply(blocks, h, cfg, tp_sum=_model_sum(group)),
                act_res)
    t = h.shape[1]
    cos, sin = llama.rope_angles(torch.arange(t, device=h.device),
                                 cfg.head_dim, cfg.rope_theta)
    n_layers = blocks["wq"].shape[0]

    def normed(block, key, c):
        return nn.rmsnorm(block[key], c, eps=cfg.norm_eps)

    if mode == "full":
        def full_layer(block, c):
            a = llama.attention(block, normed(block, "attn_norm", c), cfg,
                                cos, sin)
            c = c + dist.psum_ad(a, group, label="psa_full_sync")
            m = llama.mlp(block, normed(block, "mlp_norm", c))
            return c + dist.psum_ad(m, group, label="psa_full_sync")

        for i in range(n_layers):
            h = _remat(cfg, full_layer, llama.layer(blocks, i), h)
        return h, act_res

    if mode == "defer":
        tp = group.size
        for g in range(n_layers // period):
            h0 = h
            for i in range(g * period, (g + 1) * period):
                h = _remat(cfg, llama.block_apply, llama.layer(blocks, i), h,
                           cfg, cos, sin)
            h = dist.psum_ad(h, group, label="psa_defer_sync") - (tp - 1) * h0
        return h, act_res

    def int8_layer(block, res_pair, c):
        a = llama.attention(block, normed(block, "attn_norm", c), cfg, cos,
                            sin)
        a, r0 = _psa_int8_sync(a, res_pair[0], group)
        c = c + a
        m = llama.mlp(block, normed(block, "mlp_norm", c))
        m, r1 = _psa_int8_sync(m, res_pair[1], group)
        return c + m, torch.stack([r0, r1])

    new_res = []
    for i in range(n_layers):
        h, r = _remat(cfg, int8_layer, llama.layer(blocks, i), act_res[i], h)
        new_res.append(r.detach())
    return h, torch.stack(new_res)


def _tp_psa_loss(params: dict, tokens, cfg: LlamaConfig, group: dist.Group,
                 mode: str, period: int, act_res):
    """Per-shard loss / tp (the module docstring says why /tp) through the
    fused head, and the new activation residual."""
    h = llama.embed(params, tokens, cfg)
    h, new_res = _psa_blocks_apply(params["blocks"], h, cfg, group, mode,
                                   period, act_res)
    return llama.head_loss(params, h, tokens, cfg) / group.size, new_res


def _sum_replicated(params: dict, grads: List[torch.Tensor],
                    group: dist.Group) -> List[torch.Tensor]:
    """The replicated leaves' gradients summed over the model group, each
    recorded as its own ``tp_replicated_grads`` psum (JAX's per-leaf
    call); one host round trip per dtype carries them all."""
    mask = tree_leaves(_sharded_mask(params))
    idx = [i for i, s in enumerate(mask) if not s]
    out = list(grads)
    for i, g in zip(idx, dist.psum_each([grads[i] for i in idx], group,
                                        label="tp_replicated_grads")):
        out[i] = g
    return out


def _act_residual_setup(mesh: dist.TPMesh, cfg: LlamaConfig,
                        batch_shape: Optional[Tuple[int, int]], device):
    """This rank's zero activation-EF residual ``[L, 2, B, T, D]``, sized
    by the local batch, which the factory cannot infer."""
    if batch_shape is None:
        raise ValueError(
            "psa='int8_ef' carries a per-(model shard, sub-layer) "
            "activation EF residual sized by the local batch — pass "
            "batch_shape=(per_data_shard_batch, seq_len) to the factory")
    b, t = batch_shape
    return torch.zeros((cfg.n_layers, 2, b, t, cfg.dmodel),
                       dtype=torch.float32, device=device)


# ----------------------------------------------------- the plain steps

def _make_tp_local_step(cfg: LlamaConfig, optimizer, mesh: dist.TPMesh, *,
                        mode: str, period: int,
                        numerics=None) -> Callable:
    """The per-rank TP step body shared by ``make_tp_train_step``,
    ``make_tp_step`` and ``make_tp_multi_step``: the PSA loss and its
    gradients, the replicated leaves summed over model, gradients and loss
    averaged over data, the optimizer on the local slices in place (every
    optimizer the port ships is elementwise). ``numerics``: the second
    output becomes ``(loss, NumericsSummary)``."""
    ef = mode == "int8_ef"
    tp = mesh.model

    def local_step(state, tokens: torch.Tensor):
        params = state.params
        leaves = tree_leaves(params)
        loss, new_res = _tp_psa_loss(params, tokens, cfg, mesh.model_group,
                                     mode, period,
                                     state.act_residual if ef else None)
        grads = _sum_replicated(params,
                                list(torch.autograd.grad(loss, leaves)),
                                mesh.model_group)
        loss = loss.detach() * tp                 # undo the 1/tp scaling
        if mesh.data > 1:
            grads = dist.pmean_tree(grads, label="grad_allreduce",
                                    group=mesh.data_group)
            loss = dist.pmean(loss, label="loss_allreduce",
                              group=mesh.data_group)
        old = (tree_unflatten(params, [p.detach().clone() for p in leaves])
               if numerics is not None else None)
        grad_tree = tree_unflatten(params, grads)
        params, opt_state = apply_optimizer(optimizer, grad_tree,
                                            state.opt_state, params)
        step = state.step + 1
        if ef:
            new_state = TPActState(params, opt_state, step, new_res,
                                   state.tp)
        else:
            new_state = state._replace(opt_state=opt_state, step=step)
        if numerics is not None:
            return new_state, (loss, numerics.summarize(old, grad_tree,
                                                        params))
        return new_state, loss

    return local_step


def _on_device(fn: Callable, dev: torch.device) -> Callable:
    def step(state, tokens):
        return fn(state, torch.as_tensor(tokens, dtype=torch.long,
                                         device=dev))
    return step


def make_tp_train_step(cfg: LlamaConfig, optimizer, mesh: dist.TPMesh,
                       device=None) -> Callable:
    """The reference TP step: ``step(state, tokens) -> (state, loss)`` on
    ``init_state``'s state and this rank's data row (``shard_batch``); the
    loss averaged over the data rows, the same on every rank."""
    return _on_device(_make_tp_local_step(cfg, optimizer, mesh, mode="",
                                          period=0),
                      dist.rank_device(device))


def _tp_setup(cfg, optimizer, mesh, params, psa, batch_shape, device):
    mode, period = _parse_psa(psa, cfg.n_layers)
    dev = dist.rank_device(device)
    state = init_state(mesh, params, optimizer, dev)
    if mode == "int8_ef":
        res = _act_residual_setup(mesh, cfg, batch_shape, dev)
        state = TPActState(state.params, state.opt_state, state.step, res,
                           state.tp)
    return state, mode, period, dev


def make_tp_step(cfg: LlamaConfig, optimizer, mesh: dist.TPMesh, params, *,
                 psa: str = "", batch_shape: Optional[Tuple[int, int]] = None,
                 numerics=None, device=None):
    """The per-step shared-body TP driver: ``(state, step)`` with
    ``step(state, tokens) -> (state, loss)`` on this rank's data row, from
    the whole parameter tree ``params`` (sliced here), on ``device`` (None:
    CUDA, raising without a card). The state is a ``TPActState`` under
    ``psa="int8_ef"`` (``batch_shape = (B per data row, T)`` required), a
    ``TPState`` otherwise. ``psa`` "" and "full" are bitwise
    ``make_tp_train_step``; ``numerics`` (``make_tp_numerics``) adds the
    summary to the output only."""
    state, mode, period, dev = _tp_setup(cfg, optimizer, mesh, params, psa,
                                         batch_shape, device)
    return state, _on_device(_make_tp_local_step(
        cfg, optimizer, mesh, mode=mode, period=period, numerics=numerics),
        dev)


def make_tp_multi_step(cfg: LlamaConfig, optimizer, mesh: dist.TPMesh,
                       params, *, psa: str = "",
                       batch_shape: Optional[Tuple[int, int]] = None,
                       numerics=None, device=None):
    """``make_tp_step``'s body over a ``[K, B, T]`` window of K steps:
    ``step(state, window) -> (state, losses)``, bitwise K per-step calls
    (the activation residual threads through them). K is the window's
    leading dim."""
    state, mode, period, dev = _tp_setup(cfg, optimizer, mesh, params, psa,
                                         batch_shape, device)
    return state, _on_device(_loop(_make_tp_local_step(
        cfg, optimizer, mesh, mode=mode, period=period, numerics=numerics)),
        dev)


# ----------------------------------------------- model-agreed numerics

def make_tp_numerics(params, mesh: dist.TPMesh, *,
                     psum_data: bool = False) -> introspect.NumericsHandle:
    """The numerics summarizer of a TP rank (JAX's ``make_tp_numerics``):
    the replicated leaves pre-scaled by tp^(−1/2) before squaring, so that
    the sum over the model group counts them once; the sharded leaves'
    local squares summed over model give the global ones. Every rank
    returns the same summary. ``psum_data``: the gradient statistics and
    the finite mask are summed over the data group too (the ring path,
    where local gradients differ per data row)."""
    params = llama.as_tree(params)
    base = introspect.make_summarizer(params)
    scale = mesh.model ** -0.5
    mask = tree_leaves(_sharded_mask(params))

    def prescale(tree):
        return tree_unflatten(tree, [x if s else x * scale for x, s in
                                     zip(tree_leaves(tree), mask)])

    def agree(x, with_data: bool):
        x = dist.psum(x, record=False, group=mesh.model_group)
        if with_data:
            x = dist.psum(x, record=False, group=mesh.data_group)
        return x

    def summarize(old, grads, new) -> introspect.NumericsSummary:
        s = base.summarize(prescale(old), prescale(grads), prescale(new))
        bad = (~s.grad_finite).to(torch.int32)
        return introspect.NumericsSummary(
            grad_sq=agree(s.grad_sq, psum_data),
            param_sq=agree(s.param_sq, False),
            update_sq=agree(s.update_sq, False),
            grad_finite=agree(bad, psum_data) == 0)

    return introspect.NumericsHandle(base.groups, base.paths, summarize)


# -------------------------------------------- DP×TP data-axis ring drivers

def _local_template(params, tp: int) -> dict:
    """The per-model-shard tree's shapes and dtypes (``meta`` tensors)."""
    params = llama.as_tree(params)
    return tree_map(
        lambda x, s: torch.empty(
            tuple(d // tp if i == s else d for i, d in enumerate(x.shape)),
            dtype=torch.as_tensor(np.zeros((), x.dtype)).dtype
            if isinstance(x, np.ndarray) else x.dtype, device="meta"),
        params, param_specs(params))


def _tp_flat_geometry(mesh: dist.TPMesh, params) -> Tuple[int, int, int, int]:
    """``(n, pad, local, total)`` of the padded flat vector of one model
    shard's local tree (sharded block leaves at 1/tp, the rest whole: the
    same length on every shard), n = the data axis size."""
    n = mesh.data
    total = sum(x.numel() for x in tree_leaves(_local_template(params,
                                                               mesh.model)))
    pad = (-total) % n
    return n, pad, (total + pad) // n, total


def _tp_bucket_map(mesh: dist.TPMesh, params, comm_buckets: int):
    """The DP×TP ``BucketMap``: ``compress.make_bucket_map`` over one
    model shard's leaf geometry; None at ``comm_buckets == 1``."""
    if int(comm_buckets) < 1:
        raise ValueError(
            f"comm_buckets must be >= 1 (got {comm_buckets})")
    if int(comm_buckets) == 1:
        return None
    return compress.make_bucket_map(_local_template(params, mesh.model),
                                    mesh.data, comm_buckets)


def _tp_overlap_setup_checks(wire: str, aggregation: str, psa: str,
                             n_layers: int, shape: dict) -> Tuple[str, int]:
    """The DP×TP ring drivers' validations on a mesh of ``shape``, in
    JAX's order and with its texts; returns the parsed PSA mode."""
    mode, period = _parse_psa(psa, n_layers)
    if aggregation not in ("gradient", "zero1"):
        raise ValueError("the DP×TP overlap driver supports gradient/zero1 "
                         f"aggregation only (got {aggregation!r})")
    if wire not in ("fp32", "bf16", "int8_ef"):
        raise ValueError(f"unknown wire format {wire!r}")
    if "data" not in shape:
        raise ValueError("the DP×TP overlap driver needs a mesh with a "
                         "'data' axis (size 1 is fine) — build it with "
                         'make_mesh({"data": d, "model": t})')
    if shape.get("dcn", 1) > 1:
        raise ValueError("the DP×TP overlap driver runs the flat data ring "
                         "only; the hierarchical (dcn x data) tier is the "
                         "DP trainer's (parallel/compress.py)")
    if shape.get("model", 1) < 2:
        raise ValueError("the DP×TP overlap driver needs model >= 2 — on a "
                         "model=1 mesh the flat DP ring driver "
                         "(parallel/compress.py) is the same machinery "
                         "without the model axis")
    if mode == "int8_ef":
        raise ValueError(
            "psa='int8_ef' × the overlap ring driver is deferred: the "
            "activation EF residual tree does not yet thread the "
            "OverlapEFState scan carry — use psa in {'', 'full', "
            "'defer:L'} with the ring, or psa='int8_ef' on the non-overlap "
            "TP factories (make_tp_step / make_tp_multi_step)")
    return mode, period


def _tp_overlap_setup(optimizer, mesh, params, wire: str, aggregation: str,
                      psa: str, n_layers: int, comm_buckets: int = 1,
                      device=None):
    """State and flat geometry of the DP×TP ring drivers, with JAX's
    validations in its order and with its texts. Returns ``(state, n, pad,
    local, total, mode, period, bm)``."""
    mode, period = _tp_overlap_setup_checks(wire, aggregation, psa,
                                            n_layers, mesh.shape)
    n, pad, local, total = _tp_flat_geometry(mesh, params)
    bm = _tp_bucket_map(mesh, params, comm_buckets)
    dev = dist.rank_device(device)
    base = init_state(mesh, params, optimizer, dev)
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32,  # noqa: E731
                                   device=dev)
    opt_state = base.opt_state
    if aggregation == "zero1":
        shard = mesh.d
        if bm is None:
            flat = dp._flat_fp32(tree_leaves(base.params), pad)
            opt_state = optimizer.init(
                flat[shard * local:(shard + 1) * local].clone())
        else:
            vecs = compress._bucket_vectors(bm, base.params)
            opt_state = tuple(optimizer.init(
                vecs[b][shard * bm.sizes[b]:(shard + 1) * bm.sizes[b]]
                .clone()) for b in range(bm.nbuckets))
    geom = TPGeometry(mesh, zero1=aggregation == "zero1")
    if wire != "int8_ef":
        return (TPState(base.params, opt_state, base.step, geom), n, pad,
                local, total, mode, period, bm)
    if bm is None:
        ring_res, gather_res = zeros(n * local), zeros(local)
    else:
        ring_res = tuple(zeros(n * sz) for sz in bm.sizes)
        gather_res = tuple(zeros(sz) for sz in bm.sizes)
    return (TPOverlapEFState(base.params, opt_state, base.step, ring_res,
                             gather_res, geom),
            n, pad, local, total, mode, period, bm)


def _make_tp_overlap_local_step(cfg: LlamaConfig, optimizer, mesh, *,
                                mode: str, period: int, n: int, pad: int,
                                local: int, total: int, microbatches: int,
                                wire: str, aggregation: str,
                                bucket_map=None, numerics=None) -> Callable:
    """The per-rank DP×TP overlapped step shared by ``make_tp_overlap_step``
    and ``make_tp_overlap_multi_step`` (the JAX body, in eager order):
    ``compress._make_overlap_local_step`` over the data group, slice
    ``mesh.d``, labels ``tp_...``. Each microbatch runs the PSA loss and
    its backward and sums its replicated leaves' gradients over the model
    group (only then is a gradient complete) before handing the local tree
    to the ring thread, which rings it while the next microbatch computes.
    The int8 scales are agreed over the model group (the ring thread's on
    its own gloo group, ``ring_model_group``), so the replicated
    coordinates decode alike on every model shard."""
    mgroup = mesh.model_group

    def grads(params, leaves, batch, ringer, m):
        l, _ = _tp_psa_loss(params, batch, cfg, mgroup, mode, period, None)
        g = _sum_replicated(params, list(torch.autograd.grad(l, leaves)),
                            mgroup)
        ringer.put(m, g)
        return l.detach() * mesh.model, g

    return compress._make_overlap_local_step(
        None, optimizer, n, pad, local, total, microbatches=microbatches,
        wire=wire, aggregation=aggregation, bucket_map=bucket_map,
        numerics=numerics, grads_fn=grads, prefix="tp_", shard=mesh.d,
        data_group=mesh.data_group,
        scale_sync_groups=(mesh.ring_model_group, mgroup))


def make_tp_overlap_step(cfg: LlamaConfig, optimizer, mesh: dist.TPMesh,
                         params, *, aggregation: str = "zero1",
                         wire: str = "fp32", overlap_microbatches: int = 1,
                         psa: str = "", comm_buckets: int = 1,
                         numerics=None, device=None):
    """The per-step DP×TP driver: ``(state, step)``, ``step(state, tokens)
    -> (state, loss)`` on this rank's data row, with the data-axis
    gradient sync through the compressed and overlapped ring (semantics in
    ``_make_tp_overlap_local_step``). The state is a ``TPOverlapEFState``
    under ``wire="int8_ef"``, a ``TPState`` otherwise, ZeRO-1 moments per
    (data, model) rank under ``aggregation="zero1"``. ``comm_buckets > 1``:
    per-bucket rings."""
    (state, n, pad, local, total, mode, period,
     bm) = _tp_overlap_setup(optimizer, mesh, params, wire, aggregation,
                             psa, cfg.n_layers, comm_buckets, device)
    return state, _on_device(_make_tp_overlap_local_step(
        cfg, optimizer, mesh, mode=mode, period=period, n=n, pad=pad,
        local=local, total=total, microbatches=overlap_microbatches,
        wire=wire, aggregation=aggregation, bucket_map=bm,
        numerics=numerics), state.step.device)


def make_tp_overlap_multi_step(cfg: LlamaConfig, optimizer,
                               mesh: dist.TPMesh, params, *,
                               aggregation: str = "zero1",
                               wire: str = "fp32",
                               overlap_microbatches: int = 1, psa: str = "",
                               comm_buckets: int = 1, numerics=None,
                               device=None):
    """``make_tp_overlap_step``'s body over a ``[K, B, T]`` window: the
    losses and the final state (moments and residuals included) bitwise K
    per-step calls."""
    (state, n, pad, local, total, mode, period,
     bm) = _tp_overlap_setup(optimizer, mesh, params, wire, aggregation,
                             psa, cfg.n_layers, comm_buckets, device)
    return state, _on_device(_loop(_make_tp_overlap_local_step(
        cfg, optimizer, mesh, mode=mode, period=period, n=n, pad=pad,
        local=local, total=total, microbatches=overlap_microbatches,
        wire=wire, aggregation=aggregation, bucket_map=bm,
        numerics=numerics)), state.step.device)


# ------------------------------------------------------ state on the host

def _is_state(state) -> bool:
    return isinstance(getattr(state, "tp", None), TPGeometry)


def _per_rank(state) -> List[bool]:
    """Per ``nested_leaves`` leaf of a TP state: whether each rank holds
    its own block of it (the ``PER_RANK_FIELDS``, and the vector leaves of
    a ZeRO-1 optimizer state)."""
    from ..tree import nested_leaves
    out: List[bool] = []
    for name, value in zip(state._fields, state):
        leaves = nested_leaves(value)
        if name in type(state).PER_RANK_FIELDS:
            out += [isinstance(x, torch.Tensor) for x in leaves]
        elif name == "opt_state" and state.tp.zero1:
            out += [isinstance(x, torch.Tensor) and x.dim() >= 1
                    for x in leaves]
        else:
            out += [False] * len(leaves)
    return out


def _params_like(state):
    """Whether a node is shaped like the parameter tree of ``state``."""
    keys = set(state.params)
    return lambda node: isinstance(node, dict) and set(node) == keys


def _map_state(state, on_params: Callable, on_rank: Callable,
               other: Callable):
    """Rebuild a TP state: ``on_params`` on every subtree shaped like the
    parameters (outside the per-rank leaves), ``on_rank`` on each per-rank
    leaf, ``other`` on every other leaf; the geometry kept."""
    from ..tree import nested_leaves
    like = _params_like(state)
    rank_mask = iter(_per_rank(state))

    def walk(node):
        if like(node):
            for _ in nested_leaves(node):
                next(rank_mask)
            return on_params(node)
        if isinstance(node, TPGeometry):
            next(rank_mask)
            return node
        if isinstance(node, tuple):
            items = [walk(x) for x in node]
            return type(node)(*items) if hasattr(node, "_fields") \
                else tuple(items)
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [walk(x) for x in node]
        return on_rank(node) if next(rank_mask) else other(node)

    return walk(state)


def _host(x):
    return x.detach().cpu().clone() if isinstance(x, torch.Tensor) else x


def host_snapshot(state):
    """The JAX global layout of a TP state, as CPU tensors (a collective:
    every rank calls it): the parameters and every parameter-shaped part
    of the optimizer state with their model slices joined (an all-gather
    over the model group), each per-rank leaf stacked ``[n_data, tp,
    ...]`` over the whole group in rank order (JAX's shard order). The
    geometry stays behind (``tp`` None)."""
    mesh = state.tp.mesh
    specs = param_specs(state.params)

    def merge(tree):
        def join(x, s):
            if s is None or mesh.model == 1:
                return _host(x)
            parts = dist.all_gather(x.detach().contiguous().reshape(-1),
                                    group=mesh.model_group)
            return torch.cat(parts.view((mesh.model,) + tuple(x.shape))
                             .unbind(0), dim=s).cpu().clone()
        return tree_map(join, tree, specs)

    def stack(x):
        g = dist.all_gather(x.detach().contiguous().reshape(-1))
        return g.reshape((mesh.data, mesh.model) + tuple(x.shape)
                         ).cpu().clone()

    # The geometry (its process groups) stays behind: a snapshot travels
    # between processes (the elastic re-mesh's mirror).
    return _map_state(state, merge, stack, _host)._replace(tp=None)


def merged_template(state):
    """``host_snapshot``'s structure and shapes for a TP state, on the
    ``meta`` device (no collective): the template a checkpoint reads into
    before ``slice_state``."""
    mesh = state.tp.mesh
    specs = param_specs(state.params)

    def whole(tree):
        return tree_map(lambda x, s: torch.empty(
            tuple(d * mesh.model if i == s else d
                  for i, d in enumerate(x.shape)), dtype=x.dtype,
            device="meta"), tree, specs)

    def stacked(x):
        return torch.empty((mesh.data, mesh.model) + tuple(x.shape),
                           dtype=x.dtype, device="meta")

    return _map_state(state, whole, stacked, lambda x: x)


def slice_state(host, template):
    """A merged host state (``host_snapshot``'s) re-sliced to
    ``template``'s rank, on its devices and dtypes: its model slices of
    the parameter-shaped trees, its ``[d, m]`` block of each per-rank
    stack. A ``RESIZABLE_FIELDS`` stack saved at another data world is
    first brought to the template's (``dp._resize_act_residual``). Returns
    a new state."""
    from ..tree import nested_leaves, nested_unflatten
    mesh = template.tp.mesh
    merged = merged_template(template)
    for name in getattr(type(template), "RESIZABLE_FIELDS", ()):
        h, want = getattr(host, name), getattr(merged, name)
        if tuple(h.shape) != tuple(want.shape):
            h = (h.detach().cpu().numpy() if isinstance(h, torch.Tensor)
                 else np.asarray(h))
            host = host._replace(**{name: torch.from_numpy(
                dp._resize_act_residual(h, tuple(want.shape)))})
    h_leaves = nested_leaves(host)
    m_leaves = nested_leaves(merged)
    if len(h_leaves) != len(m_leaves):
        raise ValueError(f"snapshot has {len(h_leaves)} leaves, the TP "
                         f"state {len(m_leaves)}")

    def shape_ok(h, want):
        h = (h.detach().cpu() if isinstance(h, torch.Tensor)
             else torch.from_numpy(np.array(h)))
        if tuple(h.shape) != tuple(want.shape):
            raise ValueError(f"leaf of shape {tuple(h.shape)} does not fit "
                             f"the merged {tuple(want.shape)}")
        return h

    host = nested_unflatten(merged, [
        shape_ok(h, w) if isinstance(w, torch.Tensor) else w
        for h, w in zip(h_leaves, m_leaves)])
    specs = param_specs(template.params)
    like = _params_like(template)
    mask = iter(_per_rank(template))

    def place(h, t):
        return h.to(device=t.device, dtype=t.dtype,
                    copy=True).requires_grad_(t.requires_grad)

    def walk(h, t):
        if like(t):
            for _ in nested_leaves(t):
                next(mask)
            return tree_map(lambda a, b, s: place(
                _slice(a, s, mesh.model, mesh.m), b), h, t, specs)
        if isinstance(t, TPGeometry):
            next(mask)
            return t
        if isinstance(t, tuple):
            items = [walk(a, b) for a, b in zip(h, t)]
            return type(t)(*items) if hasattr(t, "_fields") else tuple(items)
        if isinstance(t, dict):
            return {k: walk(h[k], t[k]) for k in sorted(t)}
        if isinstance(t, list):
            return [walk(a, b) for a, b in zip(h, t)]
        if not isinstance(t, torch.Tensor):
            next(mask)
            return t
        return place(h[mesh.d, mesh.m] if next(mask) else h, t)

    return walk(host, template)

