"""Sequence (context) parallelism: ring attention over a ``seq`` axis and
the sequence-parallel train step, counterpart of the JAX package's
``parallel/sp.py``.

The JAX module runs each step as one SPMD program under ``shard_map``
over a ``(data, seq)`` mesh. The port goes back to processes: each (data
row, seq shard) is one OS process of a gloo group
(``distributed.seq_mesh``: rank ``d·S + s``). Every seq shard of a row
holds the whole parameter tree and the row's whole ``[B, T]`` token batch
(int tokens are tiny; activations are what SP shards), and computes its
own window of ``T/S`` positions: embed, the blocks with global RoPE
offsets, the head and its share of the loss.

Ring attention: K/V chunks travel around the seq group
(``distributed.ppermute_ad``: shard s sends to s+1, so after t hops it
holds the chunk of s−t) while each shard's queries accumulate the
online-softmax statistics. The per-hop attention is plain PyTorch products
with the online softmax, as JAX's is (no flash kernel per hop: the hop's
``[T/S, T/S]`` blocks sit below the kernel's crossover at this head
dimension). Masked entries get a finite ``-1e30`` logit and an explicit
zero probability, so a fully masked chunk adds nothing and its gradient
stays finite. The backward is autograd through the shifts, whose backward
shifts the cotangents the other way; K and V shift together in one
autograd node per hop, with a tag per (layer, hop, direction), so every
rank posts the backward's hops in one order. Each call makes ``S`` hops of
K and of V, the last one unused, as JAX's scan does, and records each
(``ring_kv_hop``); the backward's hops are not recorded, as JAX documents.

Loss and gradient accounting, JAX's: each shard's loss is its share of the
global mean (``_sp_loss``), differentiated locally; loss and gradients are
summed over the seq group after the backward (``sp_grad_allreduce``,
``sp_loss_allreduce``), then averaged over data (``grad_allreduce``,
``loss_allreduce``).
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from . import distributed as dist
from .dp import TrainState
from . import tp
from .tp import _remat
from ..config import LlamaConfig
from ..models import llama
from ..ops.adam import apply_optimizer
from ..tree import tree_leaves, tree_map, tree_unflatten

_NEG_INF = -1e30
# Tags of the ring's hops: a block per (layer, hop), the forward's K and V
# then the backward's (``distributed.ppermute_ad``).
_TAG_BASE = 1000
_TAGS_PER_HOP = 4


# --------------------------------------------------------------- the ring

def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group: dist.Group, *, causal: bool = True,
                   layer: int = 0) -> torch.Tensor:
    """Ring attention over the sequence shards of ``group``: q, k, v are
    this shard's ``[B, T_local, H, Dh]`` whose global positions are
    ``group.index · T_local + arange(T_local)``; returns ``[B, T_local, H,
    Dh]``, each query attending over the whole global sequence (causally
    masked). ``layer`` numbers the call's hops' tags; every rank of the
    group must make the same calls in the same order."""
    n, s = group.size, group.index
    b, tl, h, dh = q.shape
    scale = 1.0 / (dh ** 0.5)
    dev = q.device
    qpos = torch.arange(tl, device=dev)[:, None] + s * tl         # [tl, 1]
    m = torch.full((b, h, tl, 1), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, tl, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, tl, dh), dtype=torch.float32, device=dev)
    k_c, v_c = k, v
    for t in range(n):
        owner = (s - t) % n                                     # chunk origin
        scores = torch.einsum("bthd,bshd->bhts", q, k_c).float() * scale
        kpos = torch.arange(tl, device=dev)[None, :] + owner * tl
        visible = (qpos >= kpos) if causal else torch.ones(
            tl, tl, dtype=torch.bool, device=dev)
        scores = torch.where(visible, scores, _NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        # Explicit zeroing (not just the −1e30 logits): a fully masked
        # chunk has m_new == m == −1e30, where exp(scores − m_new) is 1.
        p = torch.where(visible, torch.exp(scores - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bhts,bshd->bhtd", p.to(v_c.dtype), v_c).float()
        m = m_new
        k_c, v_c = dist.ppermute_ad(
            (k_c, v_c), group, label="ring_kv_hop",
            tag=_TAG_BASE + (layer * n + t) * _TAGS_PER_HOP)
    out = acc / torch.where(l == 0.0, 1.0, l)
    return out.transpose(1, 2).to(q.dtype)                   # [b,tl,h,dh]


# ------------------------------------------------------- sequence-parallel LM

def _local_window(tokens: torch.Tensor, s: int, tl: int) -> torch.Tensor:
    """Shard s's ``[B, tl]`` window of the row's ``[B, T]`` batch."""
    return tokens[:, s * tl:(s + 1) * tl]


def _sp_logits(params: dict, tokens: torch.Tensor, cfg: LlamaConfig,
               group: dist.Group) -> torch.Tensor:
    """This shard's fp32 logits ``[B, T/S, V]`` for its window."""
    n, s = group.size, group.index
    t = tokens.shape[1]
    if t % n:
        raise ValueError(f"sequence length {t} does not split over a seq "
                         f"ring of {n}")
    tl = t // n
    local_tok = _local_window(tokens, s, tl)
    positions = torch.arange(tl, device=tokens.device) + s * tl  # global RoPE
    cos, sin = llama.rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    h = llama.embed(params, local_tok, cfg)
    blocks = params["blocks"]
    for i in range(blocks["wq"].shape[0]):
        attn = functools.partial(ring_attention, group=group, causal=True,
                                 layer=i)
        h = _remat(cfg, llama.block_apply, llama.layer(blocks, i), h, cfg,
                   cos, sin, None, attn)
    return llama.head(params, h, cfg)


def _sp_loss(params: dict, tokens: torch.Tensor, cfg: LlamaConfig,
             group: dist.Group) -> torch.Tensor:
    """This shard's share of the causal LM loss (mean NLL over the
    ``B·(T−1)`` next-token positions): the sum over the seq group is the
    single-device loss. The shift crosses shard boundaries: targets come
    from the row's batch rolled left by one, the global last position
    masked. No sum inside: callers sum loss and gradients over the group
    after differentiating."""
    n, s = group.size, group.index
    b, t = tokens.shape
    tl = t // n
    logits = _sp_logits(params, tokens, cfg, group)
    targets = _local_window(torch.roll(tokens, -1, dims=1), s, tl)
    gpos = torch.arange(tl, device=tokens.device) + s * tl
    valid = (gpos < t - 1)[None, :]
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    return (nll * valid).sum() / (b * (t - 1))


def sp_forward(params, tokens: torch.Tensor, cfg: LlamaConfig,
               mesh: dist.AxisMesh) -> torch.Tensor:
    """The full fp32 logits ``[B, T, V]`` of the row's batch computed
    sequence-parallel, the same on every shard of the seq group (the
    windows gathered in seq order)."""
    params = llama.as_tree(params)
    local = _sp_logits(params, tokens, cfg, mesh.group)
    if mesh.size == 1:
        return local
    whole = dist.all_gather(local.detach().contiguous().reshape(-1),
                            group=mesh.group)
    b, tl, v = local.shape
    return whole.view(mesh.size, b, tl, v).permute(1, 0, 2, 3).reshape(
        b, mesh.size * tl, v)


def init_state(mesh: dist.AxisMesh, params, optimizer,
               device=None) -> TrainState:
    """This rank's replicated state from the whole parameter tree (a
    ``Llama``, its tree, or ``convert.params_to_numpy``'s numpy tree), as
    fresh tensors on ``device`` (None: CUDA) that require grad."""
    tree = llama.as_tree(params)
    tree = tp.local_slices(tree, tree_map(lambda _: None, tree), 1, 0,
                           device)
    return TrainState(tree, optimizer.init(tree),
                      torch.zeros((), dtype=torch.int32,
                                  device=tree_leaves(tree)[0].device))


def loss_and_grad(params: dict, tokens: torch.Tensor, cfg: LlamaConfig,
                  mesh: dist.AxisMesh):
    """The step's loss and gradient tree on this rank's data row
    (``shard_batch``), reduced as the step reduces them: summed over the
    seq group, averaged over data; the same on every rank."""
    leaves = tree_leaves(params)
    loss = _sp_loss(params, tokens, cfg, mesh.group)
    grads = tree_unflatten(params, list(torch.autograd.grad(loss, leaves)))
    # Each shard's gradient comes from its slice of the (globally scaled)
    # loss: the total is the sum over shards.
    grads = dist.psum_tree(grads, label="sp_grad_allreduce", group=mesh.group)
    loss = dist.psum(loss.detach(), label="sp_loss_allreduce",
                     group=mesh.group)
    if mesh.data > 1:
        grads = dist.pmean_tree(grads, label="grad_allreduce",
                                group=mesh.data_group)
        loss = dist.pmean(loss, label="loss_allreduce",
                          group=mesh.data_group)
    return loss, grads


def make_sp_train_step(cfg: LlamaConfig, optimizer, mesh: dist.AxisMesh,
                       device=None) -> Callable:
    """The sequence-parallel step on a ``(data, seq)`` mesh: ``step(state,
    tokens) -> (state, loss)`` on ``init_state``'s state and this rank's
    data row ``[B, T]`` (``shard_batch``; the whole row: each shard slices
    its own window), updating the state in place; the loss averaged over
    the data rows, the same on every rank."""
    dev = dist.rank_device(device)

    def step(state: TrainState, tokens):
        tokens = torch.as_tensor(tokens, dtype=torch.long, device=dev)
        loss, grads = loss_and_grad(state.params, tokens, cfg, mesh)
        params, opt_state = apply_optimizer(optimizer, grads,
                                            state.opt_state, state.params)
        return TrainState(params, opt_state, state.step + 1), loss

    return step


shard_batch = tp.shard_batch   # this rank's data row of a [D·B, T] batch
