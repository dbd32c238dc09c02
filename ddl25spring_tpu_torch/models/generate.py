"""Autoregressive decoding: KV cache + sampling. Counterpart of the JAX
package's ``models/generate.py``.

The cache is a pair of ``[L, B, max_len, H, Dh]`` tensors written in place
(the port may update in place where JAX returns new arrays; it saves a
cache-sized copy per token). Decode attention masks by absolute position
(``kpos <= pos``), so the cache's unwritten tail is never read unmasked.
Prefill and every decode step run the same fused-block math as the paged
serving engine (``serving/engine.py``), which holds its streams against
``generate`` token for token.

Randomness: ``jax.random`` keys become one ``torch.Generator`` on the
logits' device; each sampled step draws one ``[B, V]`` block of uniforms
(Gumbel-max, as ``jax.random.categorical``), greedy steps draw nothing.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .. import nn
from ..config import LlamaConfig, torch_dtype
from ..device import check_on_device, resolve_device
from . import llama


def init_cache(cfg: LlamaConfig, batch: int, max_len: int,
               kv_dtype: Optional[str] = None, device=None) -> dict:
    """Zeroed KV cache: {"k","v"} each ``[L, B, max_len, H, Dh]``.
    ``kv_dtype`` overrides the storage dtype (default: the compute dtype)."""
    dt = torch_dtype(kv_dtype or cfg.dtype)
    shape = (cfg.n_layers, batch, max_len, cfg.num_heads, cfg.head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def _attend_cached(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                   q_positions: torch.Tensor) -> torch.Tensor:
    """q ``[B, Tq, H, Dh]`` over the full cache ``[B, Tmax, H, Dh]``,
    masked to ``kpos <= q_position`` per query row; fp32 softmax, heads
    folded into the batch."""
    b, tq, h, dh = q.shape
    tmax = ck.shape[1]
    scale = 1.0 / math.sqrt(dh)
    qm = q.permute(0, 2, 1, 3).reshape(b * h, tq, dh)
    km = ck.permute(0, 2, 1, 3).reshape(b * h, tmax, dh).to(q.dtype)
    vm = cv.permute(0, 2, 1, 3).reshape(b * h, tmax, dh).to(q.dtype)
    scores = torch.bmm(qm.float(), km.float().transpose(1, 2)) * scale
    kpos = torch.arange(tmax, device=q.device)
    scores = scores.masked_fill(q_positions[:, None] < kpos[None, :],
                                float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.bmm(probs, vm)
    return out.reshape(b, h, tq, dh).permute(0, 2, 1, 3)


def _fuse_blocks(blocks: dict) -> dict:
    """Concatenate each layer's QKV and gate/up weights once per call
    (leading ``[L]`` axis kept), so the decode loop reads each weight once
    per token instead of re-concatenating it."""
    return {
        "attn_norm": blocks["attn_norm"],
        "mlp_norm": blocks["mlp_norm"],
        "w_qkv": torch.cat([blocks["wq"], blocks["wk"], blocks["wv"]], dim=-1),
        "wo": blocks["wo"],
        "w_gu": torch.cat([blocks["w_gate"], blocks["w_up"]], dim=-1),
        "w_down": blocks["w_down"],
    }


def _block_with_cache(block: dict, ck: torch.Tensor, cv: torch.Tensor,
                      x: torch.Tensor, positions: torch.Tensor, start: int,
                      cfg: LlamaConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One pre-fused block over x ``[B, T, D]`` at absolute ``positions``
    ``[T]``: writes this call's K/V into the cache at ``start`` (in place)
    and attends over the whole cache."""
    b, t, _ = x.shape
    dh = cfg.head_dim
    xn = nn.rmsnorm(block["attn_norm"], x, eps=cfg.norm_eps)
    qkv = xn @ block["w_qkv"].to(x.dtype)
    dl = qkv.shape[-1] // 3
    h = dl // dh
    q = qkv[..., :dl].reshape(b, t, h, dh)
    k = qkv[..., dl:2 * dl].reshape(b, t, h, dh)
    v = qkv[..., 2 * dl:].reshape(b, t, h, dh)
    cos, sin = llama.rope_angles(positions, dh, cfg.rope_theta)
    q = llama.apply_rope(q, cos, sin)
    k = llama.apply_rope(k, cos, sin)          # cached K is stored post-RoPE
    ck[:, start:start + t] = k.to(ck.dtype)
    cv[:, start:start + t] = v.to(cv.dtype)
    out = _attend_cached(q, ck, cv, positions)
    x = x + out.reshape(b, t, h * dh) @ block["wo"].to(x.dtype)
    xn = nn.rmsnorm(block["mlp_norm"], x, eps=cfg.norm_eps)
    gu = xn @ block["w_gu"].to(x.dtype)
    f = gu.shape[-1] // 2
    x = x + (F.silu(gu[..., :f]) * gu[..., f:]) @ block["w_down"].to(x.dtype)
    return x, ck, cv


def _forward_fused(params: dict, fused_blocks: dict, tokens: torch.Tensor,
                   cache: dict, start: int, cfg: LlamaConfig
                   ) -> Tuple[torch.Tensor, dict]:
    """Body of ``forward_cached`` on blocks already through _fuse_blocks."""
    t = tokens.shape[1]
    positions = start + torch.arange(t, device=tokens.device)
    h = llama.embed(params, tokens, cfg)
    for i in range(cache["k"].shape[0]):
        h, _, _ = _block_with_cache(llama.layer(fused_blocks, i),
                                    cache["k"][i], cache["v"][i], h,
                                    positions, start, cfg)
    logits = llama.head(params, h[:, -1:, :], cfg)[:, 0, :]
    return logits, cache


def forward_cached(params, tokens: torch.Tensor, cache: dict, start: int,
                   cfg: LlamaConfig) -> Tuple[torch.Tensor, dict]:
    """tokens ``[B, T]`` at absolute positions ``start..start+T`` →
    (fp32 logits of the LAST position ``[B, V]``, the cache updated in
    place)."""
    params = llama.as_tree(params)
    return _forward_fused(params, _fuse_blocks(params["blocks"]), tokens,
                          cache, start, cfg)


def filter_logits(logits: torch.Tensor, top_k: Optional[int],
                  top_p: Optional[float]) -> torch.Tensor:
    """top_k then top_p (nucleus) filters on temperature-scaled logits
    ``[B, V]``. A token survives top_p iff the mass of strictly better
    tokens is below p. The serving engine's sampler calls this too."""
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p is not None:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        mass_before = torch.cumsum(probs, dim=-1) - probs
        kept = mass_before < top_p
        thresh = torch.where(kept, sorted_logits,
                             torch.full_like(sorted_logits, float("inf"))
                             ).amin(dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < thresh, float("-inf"))
    return logits


def categorical(generator: torch.Generator, logits: torch.Tensor
                ) -> torch.Tensor:
    """One sample per row of ``logits [B, V]`` by the Gumbel-max trick,
    drawing one ``[B, V]`` block of uniforms from ``generator``."""
    u = torch.rand(logits.shape, generator=generator, dtype=torch.float32,
                   device=logits.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def _sample(generator: Optional[torch.Generator], logits: torch.Tensor,
            temperature: float, top_k: Optional[int],
            top_p: Optional[float]) -> torch.Tensor:
    """logits ``[B, V]`` → token ids ``[B]``. temperature 0 = greedy."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    return categorical(generator,
                       filter_logits(logits / temperature, top_k, top_p))


@torch.inference_mode()
def generate(params, prompt, cfg: LlamaConfig, max_new_tokens: int, *,
             generator: Optional[torch.Generator] = None,
             temperature: float = 0.0, top_k: Optional[int] = None,
             top_p: Optional[float] = None, max_len: Optional[int] = None,
             kv_dtype: Optional[str] = None, device=None) -> torch.Tensor:
    """prompt ``[B, Tp]`` → generated ids ``[B, max_new_tokens]``.

    Prefill over the prompt, then one single-token decode step per new
    token, with in-place cache writes. Greedy by default;
    ``temperature``/``top_k``/``top_p`` sample, from ``generator`` (on the
    run's device), which is then required. ``max_len`` sizes the cache
    (default ``Tp + max_new_tokens``)."""
    dev = resolve_device(device)
    params = llama.as_tree(params)
    check_on_device(params["embed"], dev, "params")
    prompt = torch.as_tensor(prompt, device=dev).long()
    if prompt.dim() != 2:
        raise ValueError(f"prompt must be [B, Tp], got {tuple(prompt.shape)}")
    b, tp = prompt.shape
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if max_len is None:
        max_len = tp + max_new_tokens
    if max_len < tp + max_new_tokens:
        raise ValueError(
            f"prompt_len + max_new_tokens = {tp} + {max_new_tokens} = "
            f"{tp + max_new_tokens} exceeds max_len={max_len}: the KV cache "
            f"only holds max_len positions, so the request cannot fit — "
            f"raise max_len or shorten the request")
    if generator is None and temperature != 0.0:
        raise ValueError("sampling (temperature>0) requires a generator")
    cache = init_cache(cfg, b, max_len, kv_dtype, dev)
    fused = _fuse_blocks(params["blocks"])
    logits, cache = _forward_fused(params, fused, prompt, cache, 0, cfg)
    tok = _sample(generator, logits, temperature, top_k, top_p)
    out = [tok]
    for pos in range(tp, tp + max_new_tokens - 1):
        logits, cache = _forward_fused(params, fused, tok[:, None], cache,
                                       pos, cfg)
        tok = _sample(generator, logits, temperature, top_k, top_p)
        out.append(tok)
    return torch.stack(out, dim=1)


@torch.inference_mode()
def speculative_stream(params, draft_params, prompt, cfg: LlamaConfig,
                       max_new_tokens: int, *, k: int,
                       draft_cfg: Optional[LlamaConfig] = None,
                       device=None):
    """The reference greedy speculative decoding (the JAX function of the
    same name): the draft proposes ``k`` tokens by argmax over its own full
    forward, the target scores the whole window in one forward, and the
    accepted prefix plus one correction or bonus token extends the stream.
    Each round re-runs full forwards (no cache): a hand-checkable twin of
    the serving engine's draft-propose and verify round
    (``serving/speculate.py``), not a fast path.

    Greedy speculation emits the greedy stream exactly: every emitted token
    is the target's own argmax, so the tokens equal ``generate(params,
    prompt, cfg, max_new_tokens)``'s at any ``k`` and any draft. Returns
    ``(tokens, stats)``; ``stats`` counts the proposed and accepted draft
    tokens and the target rounds, with the horizon rule: only ``min(k,
    remaining)`` proposals of a round count as proposed, so truncation at
    ``max_new_tokens`` never reads as rejection. ``prompt`` is one
    sequence; ``device`` (None: CUDA) must hold both models."""
    dcfg = draft_cfg or cfg
    if k < 1 or max_new_tokens < 1:
        raise ValueError(f"k={k}, max_new_tokens={max_new_tokens}")
    dev = resolve_device(device)
    params, draft_params = llama.as_tree(params), llama.as_tree(draft_params)
    check_on_device(params["embed"], dev, "params")
    check_on_device(draft_params["embed"], dev, "draft_params")
    seq = torch.as_tensor(prompt, device=dev).long().reshape(1, -1)
    out = []
    stats = {"proposed": 0, "accepted": 0, "rounds": 0, "k": k}
    while len(out) < max_new_tokens:
        d_seq = seq
        drafts = []
        for _ in range(k):
            d_tok = torch.argmax(
                llama.forward(draft_params, d_seq, dcfg)[:, -1, :], dim=-1)
            drafts.append(int(d_tok[0]))
            d_seq = torch.cat([d_seq, d_tok[:, None]], dim=1)
        window = torch.cat([seq, torch.tensor([drafts], device=dev)], dim=1)
        t_log = llama.forward(params, window, cfg)[0]          # [T, V]
        base = seq.shape[1] - 1
        targets = torch.argmax(t_log[base:base + k + 1], dim=-1).tolist()
        a = 0
        while a < k and targets[a] == drafts[a]:
            a += 1
        remaining = max_new_tokens - len(out)
        emit = targets[:a + 1][:remaining]
        stats["proposed"] += min(k, remaining)
        stats["accepted"] += min(a, len(emit))
        stats["rounds"] += 1
        out.extend(emit)
        seq = torch.cat([seq, torch.tensor([emit], device=dev)], dim=1)
    return out, stats
