"""Mixture-of-Experts tiny-Llama with capacity-based top-k routing:
counterpart of the JAX package's ``models/moe.py``.

The parameters keep the JAX tree exactly (``init_moe_llama``'s layout):
llama's ``embed``, ``final_norm`` and ``lm_head``; ``blocks`` stacked on a
leading ``[L]`` axis with llama's attention leaves and norms, a
``router [L, D, E]`` and the expert bank ``w_gate``/``w_up [L, E, D, F]``,
``w_down [L, E, F, D]``.

Routing is dense one-hot dispatch and combine at static shapes, as in
JAX (N = B·T tokens, E experts, C capacity):
- router logits ``[N, E]`` → top-k probabilities, renormalized over the
  chosen k; ties go to the lowest expert index (``lax.top_k``'s order,
  kept here by a stable descending sort);
- dispatch ``[N, E, C]`` one-hot: token n holds slot c of expert e, slots
  given first-come-first-served over all tokens' first choices, then all
  second choices; a token past an expert's capacity is dropped and its
  residual passes through unchanged (Switch semantics);
- experts see the unscaled token; combine = dispatch · probability on the
  way out.
The auxiliary load-balance loss is Switch's ``E · Σ_e fraction_tokens(e)
· mean_router_prob(e)``; ``forward`` returns it beside the logits.

Under expert parallelism (``parallel/ep.py``) a block holds this shard's
slice of the expert bank: routing runs against every expert (the router
is replicated), the shard keeps its experts' columns of dispatch and
combine, and the partial outputs are summed over the expert group by
``expert_sum`` (``distributed.psum_ad``, the raw in-model ``lax.psum``).
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from .. import nn
from ..config import MoEConfig, torch_dtype
from ..device import resolve_device
from ..tree import tree_leaves
from . import llama


# ------------------------------------------------------------------ init

def init_moe_llama(cfg: MoEConfig, generator: torch.Generator,
                   device=None) -> dict:
    """Random parameters in the JAX init's layout and distribution (normal
    with std 0.02, ``wo`` and ``w_down`` scaled down by sqrt(2·L), norms
    at one), drawn from ``generator`` in a fixed order and moved to
    ``device``. To compare with the JAX package, convert its init with
    ``convert.moe_params_from_jax``."""
    dev = resolve_device(device)
    base = cfg.base
    dt = torch_dtype(base.param_dtype)
    d, f, e, n = base.dmodel, base.ffn_dim, cfg.n_experts, base.n_layers

    def normal(shape, std):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device) * std
        return x.to(device=dev, dtype=dt)

    out_std = 0.02 / math.sqrt(2 * n)
    return {
        "embed": normal((base.vocab_size, d), 0.02),
        "blocks": {
            "attn_norm": {"scale": torch.ones(n, d, dtype=dt, device=dev)},
            "wq": normal((n, d, d), 0.02),
            "wk": normal((n, d, d), 0.02),
            "wv": normal((n, d, d), 0.02),
            "wo": normal((n, d, d), out_std),
            "mlp_norm": {"scale": torch.ones(n, d, dtype=dt, device=dev)},
            "router": normal((n, d, e), 0.02),
            "w_gate": normal((n, e, d, f), 0.02),
            "w_up": normal((n, e, d, f), 0.02),
            "w_down": normal((n, e, f, d), out_std),
        },
        "final_norm": nn.rmsnorm_init(d, dt, dev),
        "lm_head": normal((d, base.vocab_size), 0.02),
    }


def capacity(n_tokens: int, cfg: MoEConfig) -> int:
    c = math.ceil(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(c, cfg.top_k)


# ------------------------------------------------------------------ routing

def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of each row and their indices, ties to the
    lowest index first (``lax.top_k``'s order, on any device)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(router_logits: torch.Tensor, cfg: MoEConfig, cap: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k dispatch: router logits ``[N, E]`` → (dispatch ``[N, E, C]``
    binary, combine ``[N, E, C]`` probability-weighted, aux loss), all
    fp32. Slot assignment is first-come-first-served in token order over
    the ``k·N`` assignments, all first choices before all second choices;
    an overflowing assignment is dropped."""
    n, e = router_logits.shape
    probs = torch.softmax(router_logits.float(), dim=-1)
    top_p, top_idx = top_k(probs, cfg.top_k)                  # [N, k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # The aux loss takes the router probabilities before renormalization
    # and the realized primary assignments (Switch eq. 4).
    assign1 = F.one_hot(top_idx[:, 0], e).float()
    aux = e * torch.sum(assign1.mean(0) * probs.mean(0))

    # Each assignment's slot = the number of earlier assignments to its
    # expert, over the flattened (k·N) sequence.
    flat_idx = top_idx.t().reshape(-1)                        # [k·N]
    onehot = F.one_hot(flat_idx, e)                           # [k·N, E]
    pos_in_expert = torch.cumsum(onehot, dim=0) - onehot      # exclusive
    slot = (pos_in_expert * onehot).sum(-1)                   # [k·N]
    keep = slot < cap
    slot_oh = (F.one_hot(torch.clamp(slot, max=cap - 1), cap).float()
               * keep[:, None])                               # [k·N, C]
    # A (token, expert, slot) triple is unique, so summing over k keeps
    # dispatch binary.
    disp = (onehot[:, :, None] * slot_oh[:, None, :]).reshape(
        cfg.top_k, n, e, cap)
    weights = top_p.t().reshape(cfg.top_k, n, 1, 1)
    return disp.sum(0), (disp * weights).sum(0), aux


def moe_mlp(block: dict, x: torch.Tensor, cfg: MoEConfig,
            expert_sum: Optional[Callable] = None, *, shard: int = 0,
            routes: Optional[List[torch.Tensor]] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routed expert MLP: x ``[B, T, D]`` → (``[B, T, D]``, aux loss).
    Under expert parallelism the block holds expert shard ``shard``'s
    slice of the bank (``E/ep`` experts), routing runs against every
    expert, the shard processes its experts' slots and ``expert_sum`` adds
    the partial outputs over the expert group. ``routes``: each call's
    dispatch is appended (observability: the routing digest, dropped
    slots)."""
    b, t, d = x.shape
    xf = x.reshape(b * t, d)
    logits = xf @ block["router"].to(x.dtype)                 # [N, E_global]
    e_local = block["w_gate"].shape[0]
    cap = capacity(b * t, cfg)
    dispatch, combine, aux = route(logits, cfg, cap)          # [N, E, C] ×2
    if routes is not None:
        routes.append(dispatch.detach())
    if expert_sum is not None:
        lo = shard * e_local
        dispatch = dispatch[:, lo:lo + e_local]               # local experts
        combine = combine[:, lo:lo + e_local]
    dispatch = dispatch.to(x.dtype)
    combine = combine.to(x.dtype)
    expert_in = torch.einsum("nec,nd->ecd", dispatch, xf)     # [E_l, C, D]
    gate = F.silu(torch.einsum("ecd,edf->ecf", expert_in,
                               block["w_gate"].to(x.dtype)))
    up = torch.einsum("ecd,edf->ecf", expert_in, block["w_up"].to(x.dtype))
    expert_out = torch.einsum("ecf,efd->ecd", gate * up,
                              block["w_down"].to(x.dtype))
    y = torch.einsum("nec,ecd->nd", combine, expert_out)
    if expert_sum is not None:
        y = expert_sum(y)
    return y.reshape(b, t, d), aux


# ------------------------------------------------------------------ forward

def moe_block_apply(block: dict, x: torch.Tensor, cfg: MoEConfig,
                    cos: torch.Tensor, sin: torch.Tensor,
                    expert_sum: Optional[Callable] = None, shard: int = 0,
                    routes: Optional[List[torch.Tensor]] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    base = cfg.base
    x = x + llama.attention(
        block, nn.rmsnorm(block["attn_norm"], x, eps=base.norm_eps),
        base, cos, sin)
    y, aux = moe_mlp(block, nn.rmsnorm(block["mlp_norm"], x,
                                       eps=base.norm_eps),
                     cfg, expert_sum, shard=shard, routes=routes)
    return x + y, aux


def forward(params: dict, tokens: torch.Tensor, cfg: MoEConfig,
            expert_sum: Optional[Callable] = None, shard: int = 0,
            routes: Optional[List[torch.Tensor]] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens ``[B, T]`` → (fp32 logits ``[B, T, V]``, the aux loss summed
    over the blocks). ``base.remat`` (with autograd recording): each block
    runs under ``torch.utils.checkpoint``, as ``llama.blocks_apply``
    does. ``expert_sum`` / ``shard``: expert parallelism (``moe_mlp``)."""
    base = cfg.base
    h = llama.embed(params, tokens, base)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    cos, sin = llama.rope_angles(positions, base.head_dim, base.rope_theta)
    remat = base.remat and torch.is_grad_enabled()
    aux_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    blocks = params["blocks"]
    for i in range(blocks["wq"].shape[0]):
        args = (llama.layer(blocks, i), h, cfg, cos, sin, expert_sum, shard,
                routes)
        if remat:
            # The block draws no random numbers: no RNG state to replay.
            # Its recomputation appends nothing to ``routes``.
            h, aux = torch.utils.checkpoint.checkpoint(
                _block_once, *args, [], use_reentrant=False,
                preserve_rng_state=False)
        else:
            h, aux = moe_block_apply(*args)
        aux_sum = aux_sum + aux
    return llama.head(params, h, base), aux_sum


def _block_once(block, h, cfg, cos, sin, expert_sum, shard, routes, runs):
    """``moe_block_apply`` whose later runs (a rematerialization) append
    no routes."""
    runs.append(1)
    return moe_block_apply(block, h, cfg, cos, sin, expert_sum, shard,
                           routes if len(runs) == 1 else None)


def param_count(params) -> int:
    return sum(int(x.numel()) for x in tree_leaves(params))
