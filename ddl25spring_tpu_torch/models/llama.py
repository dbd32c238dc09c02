"""tiny-Llama in PyTorch: counterpart of the JAX package's ``models/llama.py``.

The parameters keep the JAX tree exactly (``init_llama``'s layout):
``embed [V, D]``; ``blocks`` with every leaf stacked on a leading ``[L]``
axis; weights stored ``[in, out]`` and applied as ``x @ w`` (not
``nn.Linear``'s ``[out, in]``); ``final_norm.scale``; ``lm_head [D, V]``.
``Llama`` is the ``nn.Module`` holding them, under the same dotted names;
the math is plain functions over the nested-dict view ``Llama.tree()``,
with the JAX names kept, so each function's counterpart is easy to find.

Pre-norm RMSNorm, RoPE over the two halves of each head (not interleaved
pairs; fp32 angles), fused QKV (wq|wk|wv), causal attention, SwiGLU MLP
(gate|up). Attention dispatch: the CUDA flash kernel for CUDA tensors at
``T >= flash_min_seq`` under ``attention_impl="auto"``, else the plain
PyTorch attention (``_xla_attention``, named after its JAX twin).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple, Union

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn as tnn

from .. import nn
from ..config import LlamaConfig, torch_dtype
from ..device import check_on_device, resolve_device
from ..ops.flash_attention import flash_attention
from ..ops.losses import fused_linear_cross_entropy
from ..tree import tree_leaves, tree_map

# ------------------------------------------------------------ parameter tree


def layer(blocks: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked ``[L, ...]`` block tree (views)."""
    return tree_map(lambda x: x[i], blocks)


class _Tree(tnn.Module):
    """A module whose parameters mirror a nested dict of tensors: a dict
    becomes a submodule, a tensor a parameter, under the same names."""

    def __init__(self, tree: dict):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, _Tree(val))
            else:
                self.register_parameter(key, tnn.Parameter(val))

    def tree(self) -> dict:
        """The parameters as the JAX-shaped nested dict (no copies)."""
        out: dict = {}
        for name, p in self.named_parameters():
            *path, leaf = name.split(".")
            d = out
            for key in path:
                d = d.setdefault(key, {})
            d[leaf] = p
        return out


class Llama(_Tree):
    """The model's parameters (``embed``, ``blocks.*``, ``final_norm.scale``,
    ``lm_head``) plus its config; ``model(tokens)`` is ``forward``."""

    def __init__(self, cfg: LlamaConfig, tree: dict):
        super().__init__(tree)
        self.cfg = cfg

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        return forward(self, tokens, self.cfg, positions)


def as_tree(params: Union[Llama, dict]) -> dict:
    """Accept a ``Llama`` or its tree wherever the math takes params."""
    return params.tree() if isinstance(params, tnn.Module) else params


# ---------------------------------------------------------------------- init

def init_llama(cfg: LlamaConfig, generator: torch.Generator,
               device=None) -> Llama:
    """Random parameters in the JAX init's layout and distribution: normal
    with std 0.02, the residual-out projections (``wo``, ``w_down``) scaled
    down by sqrt(2·L), norms at one, the ``padding_idx`` embedding row zero.
    Draws come from ``generator`` (on its own device) in a fixed order,
    then move to ``device``; on ``torch.device("meta")`` nothing is drawn
    (the shapes and dtypes only, as ``telemetry.memory.preflight`` needs). jax.random and torch cannot give the same
    numbers: to compare with the JAX package, convert its init with
    ``convert.params_from_jax``."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg.param_dtype)
    d, f, n = cfg.dmodel, cfg.ffn_dim, cfg.n_layers

    def normal(shape, std):
        if dev.type == "meta":          # shapes only: no draw, no memory
            return torch.empty(shape, dtype=dt, device=dev)
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device) * std
        return x.to(device=dev, dtype=dt)

    out_std = 0.02 / math.sqrt(2 * n)
    embed = normal((cfg.vocab_size, d), 0.02)
    if cfg.padding_idx is not None:
        embed[cfg.padding_idx] = 0.0
    blocks = {
        "attn_norm": {"scale": torch.ones(n, d, dtype=dt, device=dev)},
        "wq": normal((n, d, d), 0.02),
        "wk": normal((n, d, d), 0.02),
        "wv": normal((n, d, d), 0.02),
        "wo": normal((n, d, d), out_std),
        "mlp_norm": {"scale": torch.ones(n, d, dtype=dt, device=dev)},
        "w_gate": normal((n, d, f), 0.02),
        "w_up": normal((n, d, f), 0.02),
        "w_down": normal((n, f, d), out_std),
    }
    return Llama(cfg, {
        "embed": embed,
        "blocks": blocks,
        "final_norm": nn.rmsnorm_init(d, dt, dev),
        "lm_head": normal((d, cfg.vocab_size), 0.02),
    })


# ---------------------------------------------------------------------- RoPE

def rope_angles(positions: torch.Tensor, head_dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables ``[T, half]`` (fp32) for absolute ``positions [T]``."""
    half = head_dim // 2
    inv_freq = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                             device=positions.device) / half))
    ang = positions.float()[:, None] * inv_freq[None, :]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x ``[B, T, H, Dh]``; rotate (x[..., :half], x[..., half:])."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[None, :, None, :].to(x.dtype)
    s = sin[None, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


# ----------------------------------------------------------------- attention

def qkv_proj(block: dict, x: torch.Tensor, head_dim: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused QKV projection: x ``[B, T, D]`` → q, k, v ``[B, T, H, Dh]``."""
    b, t, _ = x.shape
    dl = block["wq"].shape[1]
    h = dl // head_dim
    w_qkv = torch.cat([block["wq"], block["wk"], block["wv"]],
                      dim=1).to(x.dtype)
    qkv = x @ w_qkv
    q = qkv[..., :dl].reshape(b, t, h, head_dim)
    k = qkv[..., dl:2 * dl].reshape(b, t, h, head_dim)
    v = qkv[..., 2 * dl:].reshape(b, t, h, head_dim)
    return q, k, v


def _xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, q_offset: int = 0,
                   softmax_dtype: str = "float32") -> torch.Tensor:
    """Plain ``[B, T, H, Dh]`` attention with heads folded into the batch
    (the JAX layout). ``softmax_dtype="bfloat16"`` keeps the score tensor
    in bf16 while the row max and sum are taken in fp32."""
    b, tq, h, dh = q.shape
    tk = k.shape[1]
    scale = 1.0 / math.sqrt(dh)
    st = torch_dtype(softmax_dtype)
    qm = q.permute(0, 2, 1, 3).reshape(b * h, tq, dh)
    km = k.permute(0, 2, 1, 3).reshape(b * h, tk, dh)
    vm = v.permute(0, 2, 1, 3).reshape(b * h, tk, dh)
    scores = torch.bmm(qm.to(st), km.to(st).transpose(1, 2)) * scale
    if causal:
        qpos = torch.arange(tq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(tk, device=q.device)[None, :]
        scores = scores.masked_fill(qpos < kpos, float("-inf"))
    if st == torch.float32:
        probs = torch.softmax(scores, dim=-1)
    else:
        m = scores.float().amax(dim=-1, keepdim=True)
        e = torch.exp(scores - m.to(st)).float()
        probs = e / e.sum(dim=-1, keepdim=True)
    out = torch.bmm(probs.to(q.dtype), vm)
    return out.reshape(b, h, tq, dh).permute(0, 2, 1, 3)


def attention(block: dict, x: torch.Tensor, cfg: LlamaConfig,
              cos: torch.Tensor, sin: torch.Tensor,
              tp_sum: Optional[Callable] = None,
              attn_fn: Optional[Callable] = None) -> torch.Tensor:
    """Causal self-attention of ``x [B, T, D]``. Under tensor parallelism
    the block holds this shard's columns of wq/wk/wv and rows of wo: its
    ``H/tp`` heads run end to end and ``tp_sum`` (the JAX ``lax.psum(·,
    tp_axis)``: a differentiable sum over the model axis) adds up the
    partial ``wo`` outputs. ``attn_fn(q, k, v) -> out`` (all ``[B, T, H,
    Dh]``, after RoPE) replaces the inner attention: the hook sequence
    parallelism swaps ring attention in through."""
    b, t, _ = x.shape
    dh = cfg.head_dim
    q, k, v = qkv_proj(block, x, dh)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    impl = cfg.attention_impl
    if impl not in ("xla", "pallas", "auto"):
        raise ValueError(f"attention_impl must be 'xla', 'pallas' or 'auto', "
                         f"got {impl!r}")
    if attn_fn is not None:
        out = attn_fn(q, k, v)
    elif impl == "pallas" or (impl == "auto" and q.is_cuda
                              and t >= cfg.flash_min_seq):
        if not q.is_cuda:
            raise RuntimeError(
                "attention_impl='pallas' runs the CUDA flash kernel, but the "
                f"tensors are on {q.device}; use 'xla' or 'auto' off CUDA")
        blk = min(t, cfg.flash_block)
        out = flash_attention(q, k, v, causal=True,
                              dh_major=cfg.flash_dh_major,
                              block_q=blk, block_k=blk)
    else:
        out = _xla_attention(q, k, v, causal=True,
                             softmax_dtype=cfg.softmax_dtype)
    y = out.reshape(b, t, -1) @ block["wo"].to(x.dtype)
    return y if tp_sum is None else tp_sum(y)


def mlp(block: dict, x: torch.Tensor,
        tp_sum: Optional[Callable] = None) -> torch.Tensor:
    """SwiGLU MLP with the gate|up projection fused into one matmul. Under
    tensor parallelism the block holds this shard's columns of
    w_gate/w_up and rows of w_down, and ``tp_sum`` adds up the partial
    outputs."""
    f = block["w_gate"].shape[1]
    w_gu = torch.cat([block["w_gate"], block["w_up"]], dim=1).to(x.dtype)
    gu = x @ w_gu
    y = (F.silu(gu[..., :f]) * gu[..., f:]) @ block["w_down"].to(x.dtype)
    return y if tp_sum is None else tp_sum(y)


def block_apply(block: dict, x: torch.Tensor, cfg: LlamaConfig,
                cos: torch.Tensor, sin: torch.Tensor,
                tp_sum: Optional[Callable] = None,
                attn_fn: Optional[Callable] = None) -> torch.Tensor:
    x = x + attention(block, nn.rmsnorm(block["attn_norm"], x,
                                        eps=cfg.norm_eps), cfg, cos, sin,
                      tp_sum, attn_fn)
    x = x + mlp(block, nn.rmsnorm(block["mlp_norm"], x, eps=cfg.norm_eps),
                tp_sum)
    return x


# ----------------------------------------------------------- embed and head

def embed(params: dict, tokens: torch.Tensor, cfg: LlamaConfig
          ) -> torch.Tensor:
    """tokens ``[B, T]`` → activations ``[B, T, D]`` in the compute dtype.
    ``padding_idx`` positions give zero vectors."""
    h = params["embed"][tokens]
    if cfg.padding_idx is not None:
        h = h.masked_fill((tokens == cfg.padding_idx)[..., None], 0.0)
    return h.to(torch_dtype(cfg.dtype))


def blocks_apply(blocks: dict, h: torch.Tensor, cfg: LlamaConfig,
                 positions: Optional[torch.Tensor] = None,
                 tp_sum: Optional[Callable] = None,
                 attn_fn: Optional[Callable] = None) -> torch.Tensor:
    """Apply the stacked blocks in order (the JAX ``lax.scan``).

    ``cfg.remat`` (with autograd recording): each block runs under
    ``torch.utils.checkpoint.checkpoint``, the counterpart of the JAX
    ``jax.checkpoint``: only the block's input is kept, and the backward
    runs the block's forward again (the flash forward kernel and its
    layout copies included) before differentiating it. The gradients are
    those of the plain path: the recomputation repeats the same operations
    on the same inputs (under tensor parallelism its sums too, in the same
    order on every shard). ``tp_sum``: a tensor-parallel shard's sum over
    the model axis (``attention``, ``mlp``); ``attn_fn``: the inner
    attention of every block (``attention``)."""
    if positions is None:
        positions = torch.arange(h.shape[1], device=h.device)
    cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(blocks["wq"].shape[0]):
        if remat:
            # The block draws no random numbers: no RNG state to replay.
            h = torch.utils.checkpoint.checkpoint(
                block_apply, layer(blocks, i), h, cfg, cos, sin, tp_sum,
                attn_fn, use_reentrant=False, preserve_rng_state=False)
        else:
            h = block_apply(layer(blocks, i), h, cfg, cos, sin, tp_sum,
                            attn_fn)
    return h


def head(params: dict, h: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """activations ``[B, T, D]`` → fp32 logits ``[B, T, V]``."""
    h = nn.rmsnorm(params["final_norm"], h, eps=cfg.norm_eps)
    return (h @ params["lm_head"].to(h.dtype)).float()


def forward(params, tokens: torch.Tensor, cfg: LlamaConfig,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full causal LM: tokens ``[B, T]`` → logits ``[B, T, V]``, on the
    device the parameters live on."""
    params = as_tree(params)
    check_on_device(tokens, params["embed"].device, "tokens")
    h = embed(params, tokens, cfg)
    h = blocks_apply(params["blocks"], h, cfg, positions)
    return head(params, h, cfg)


def head_loss(params: dict, h: torch.Tensor, tokens: torch.Tensor,
              cfg: LlamaConfig, chunk_size: int = 512) -> torch.Tensor:
    """Fused final-norm + lm_head + next-token cross-entropy: the value of
    ``causal_lm_loss(head(params, h, cfg), tokens)`` without the
    ``[B, T, V]`` logits (``ops.losses.fused_linear_cross_entropy``)."""
    h = nn.rmsnorm(params["final_norm"], h, eps=cfg.norm_eps)
    shift_h = h[:, :-1, :].reshape(-1, h.shape[-1])
    labels = tokens[:, 1:].reshape(-1)
    return fused_linear_cross_entropy(shift_h, params["lm_head"], labels,
                                      chunk_size=chunk_size)


def forward_loss(params, tokens: torch.Tensor, cfg: LlamaConfig,
                 positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The training loss: tokens ``[B, T]`` → mean next-token cross-entropy
    (fp32 scalar) through the fused head. Differentiable: call it with
    autograd on (outside ``inference_mode``); on CUDA the attention's
    backward is the flash dQ and dK/dV kernels."""
    params = as_tree(params)
    check_on_device(tokens, params["embed"].device, "tokens")
    h = embed(params, tokens, cfg)
    h = blocks_apply(params["blocks"], h, cfg, positions)
    return head_loss(params, h, tokens, cfg)


def param_count(params) -> int:
    return sum(int(x.numel()) for x in tree_leaves(as_tree(params)))


# ---------------------------------------------------------- pipeline stages

def split_stages(params, n_stages: int) -> list:
    """Slice the stacked block axis into ``n_stages`` contiguous stage
    trees (views): stage 0 carries ``embed``, the last stage
    ``final_norm`` and ``lm_head``, the reference's First/Stage/Last
    split."""
    params = as_tree(params)
    n_layers = tree_leaves(params["blocks"])[0].shape[0]
    assert n_layers % n_stages == 0, (n_layers, n_stages)
    per = n_layers // n_stages
    stages = []
    for s in range(n_stages):
        stage = {"blocks": tree_map(lambda x: x[s * per:(s + 1) * per],
                                    params["blocks"])}
        if s == 0:
            stage["embed"] = params["embed"]
        if s == n_stages - 1:
            stage["final_norm"] = params["final_norm"]
            stage["lm_head"] = params["lm_head"]
        stages.append(stage)
    return stages


def merge_stages(stages: list) -> dict:
    """Inverse of ``split_stages``: the JAX tree, name for name."""
    return {
        "embed": stages[0]["embed"],
        "blocks": tree_map(lambda *xs: torch.cat(xs, dim=0),
                           *[s["blocks"] for s in stages]),
        "final_norm": stages[-1]["final_norm"],
        "lm_head": stages[-1]["lm_head"],
    }


def stage_apply(stage: dict, x: torch.Tensor, cfg: LlamaConfig, *,
                is_first: bool, is_last: bool,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run one pipeline stage: tokens ``[B, T]`` on the first stage,
    activations ``[B, T, D]`` otherwise; embeds if first, returns the
    logits if last."""
    h = embed(stage, x, cfg) if is_first else x
    h = blocks_apply(stage["blocks"], h, cfg, positions)
    return head(stage, h, cfg) if is_last else h
