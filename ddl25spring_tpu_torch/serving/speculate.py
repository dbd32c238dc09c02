"""Speculative decoding on the paged serving engine: draft-propose, verify.
Counterpart of the JAX package's ``serving/speculate.py``.

A draft model proposes ``k`` tokens with ``k`` single-token decode
dispatches over its own paged pool; the target scores all ``k + 1`` window
positions in ONE dispatch over the block-table cache
(``make_verify_step``) and accepts a prefix:

- **greedy** (``temperature == 0``): accept while ``argmax(target) ==
  draft``. Every accepted token is the target's own argmax at that
  position, and so is the one correction or bonus token after them, so a
  greedy speculative stream is the stream ``generate()`` emits alone, for
  any ``k`` and any draft.
- **stochastic** (``temperature > 0``): rejection sampling. Proposal
  ``d ~ q`` is accepted with probability ``min(1, p(d)/q(d))``; the first
  rejection resamples from the normalized residual ``max(p - q, 0)``, and a
  fully accepted window draws a bonus token from ``p``. The emitted tokens
  are distributed as ``p``, but not along ``generate()``'s sample path.

Randomness is ``torch.Generator``s. A sampling request's draft owns a
generator seeded ``rng.derived_seed(seed, KEY_SALT)`` from the request's
seed (its generator's ``initial_seed()``). Per verify dispatch each active
sampling slot draws exactly ``2k + 2`` uniforms from its target generator,
wherever the rejection lands (``u[2i]`` decides proposal ``i``,
``u[2i+1]`` resamples at ``i``, ``u[2k+1]`` is the bonus; ``u[2k]`` is
unused, matching the JAX package's fold-in indices); inactive and greedy
slots draw nothing. Residual and bonus are drawn by inverse CDF.

Cache discipline: the verify dispatch writes K/V for every window position
``pos .. pos + k``; positions past the accepted prefix hold rejected
drafts' K/V, which the next window rewrites before any query can attend
to them (in-window rows are scattered before the gather, later positions
are masked). The draft runs ``k + 1`` dispatches per round, the last one
only filling its cache with its final proposal, so its pool is whole
through ``pos + k`` even when everything is accepted. Near the horizon,
``live = min(k + 1, remaining)`` masks window rows whose writes would
spill past the reservation to the trash block. A weight swap lands between
``step()`` calls, i.e. at a verify boundary.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from .. import rng
from ..config import LlamaConfig
from ..device import check_on_device
from ..models import generate, llama
from ..telemetry import introspect
from .engine import (_forward_paged, inverse_cdf, make_decode_step,
                     make_prefill_chunk, sampling_probs)
from .kvcache import TRASH_BLOCK, PagedKVConfig, init_pool

# Salt of a sampling request's draft generator: the target's generator must
# advance exactly as generate()'s does, so the draft cannot share it.
KEY_SALT = 0x5bec


@dataclass(frozen=True)
class SpecConfig:
    """Speculative decoding for one engine: propose ``k`` tokens per round
    with a draft holding ``draft_params`` (``draft_cfg=None``: the target's
    config, with the draft's own weights; a same-weights draft accepts
    every greedy proposal). The draft must share the target's vocabulary:
    its proposals are token ids the target scores."""

    k: int
    draft_params: object
    draft_cfg: Optional[LlamaConfig] = None

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"SpecConfig.k={self.k}: propose at least one "
                             "token per round")


class DraftEngine:
    """The draft half of speculation: its own block pool, of the target's
    geometry, so the TARGET's block tables index it unchanged (one
    allocator serves both); its own prefill and decode programs; its own
    per-slot generators. The parent ``Engine`` drives it with the host
    slot state it feeds its own programs."""

    def __init__(self, spec: SpecConfig, target_cfg: LlamaConfig,
                 paged: PagedKVConfig, num_slots: int, *,
                 prefill_chunk: int, top_k: Optional[int],
                 top_p: Optional[float], device: torch.device,
                 engine_id: Optional[int] = None, decode_shapes: int = 1):
        self.cfg = spec.draft_cfg or target_cfg
        if self.cfg.vocab_size != target_cfg.vocab_size:
            raise ValueError(
                f"draft vocab {self.cfg.vocab_size} != target vocab "
                f"{target_cfg.vocab_size}: proposals are token ids the "
                "target must be able to score")
        self.k = spec.k
        self.device = device
        self.params = llama.as_tree(spec.draft_params)
        check_on_device(self.params["embed"], device, "draft params")
        self.fused = generate._fuse_blocks(self.params["blocks"])
        self.pool = init_pool(self.cfg, paged, device)
        self.generators: List[Optional[torch.Generator]] = [None] * num_slots
        tag = "" if engine_id is None else f"[{engine_id}]"
        self._prefill = introspect.watch(
            make_prefill_chunk(self.cfg, paged, prefill_chunk, top_k, top_p),
            name=f"serving/draft_prefill{tag}", max_caches=1)
        self._decode = introspect.watch(
            make_decode_step(self.cfg, paged, top_k, top_p,
                             return_probs=True),
            name=f"serving/draft_decode{tag}", max_caches=decode_shapes)

    def admit(self, s: int, temperature: float,
              generator: Optional[torch.Generator]) -> None:
        """Seed slot ``s``'s proposal stream from the request's generator's
        seed (``KEY_SALT``); greedy requests draw nothing."""
        gen = None
        if temperature > 0 and generator is not None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(rng.derived_seed(generator.initial_seed(),
                                             KEY_SALT))
        self.generators[s] = gen

    def prefill_chunk(self, table_row, chunk, off: int, n_valid: int,
                      write_from: int) -> None:
        """Mirror one prompt chunk into the draft pool: a cache write only
        (the draft's first proposal comes from decoding the target's first
        token), so no logits and no draw."""
        self.pool, _ = self._prefill(self.pool, self.params, self.fused,
                                     table_row, chunk, off, n_valid,
                                     write_from, False, None, 0.0)

    def propose(self, tables: torch.Tensor, last_tok: torch.Tensor,
                pos: torch.Tensor, temps: np.ndarray, active: np.ndarray,
                live: np.ndarray):
        """One round: ``k`` decode dispatches from the target's last tokens,
        then the cache-fill dispatch on the final proposal. Rows past a
        slot's ``live`` window are inactive (writes to trash, nothing
        drawn). Returns (proposals ``[S, k]``, their distributions
        ``[S, k, V]``)."""
        cur = last_tok
        toks, probs = [], []
        for j in range(self.k + 1):
            self.pool, cur, q = self._decode(
                self.pool, self.params, self.fused, tables, cur, pos + j,
                self.generators, temps, active & (j < live))
            if j < self.k:
                toks.append(cur)
                probs.append(q)
        return torch.stack(toks, dim=1), torch.stack(probs, dim=1)


# ------------------------------------------------------------- acceptance

def rejection_decide(u_accept: torch.Tensor, p: torch.Tensor,
                     q: torch.Tensor, drafts: torch.Tensor) -> torch.Tensor:
    """How many leading proposals are accepted: proposal ``i`` passes while
    ``u_i · q_i(d_i) < p_i(d_i)``. ``u_accept [..., k]``, ``p [..., k+1,
    V]`` (or ``[..., k, V]``), ``q [..., k, V]``, ``drafts [..., k]`` →
    ``[...]``. The JAX package's comparison, in float32."""
    k = q.shape[-2]
    idx = drafts[..., None].long()
    p_tok = torch.gather(p[..., :k, :], -1, idx)[..., 0]
    q_tok = torch.gather(q, -1, idx)[..., 0]
    accept = u_accept * torch.clamp(q_tok, min=1e-30) < p_tok
    return torch.cumprod(accept.to(torch.int64), dim=-1).sum(dim=-1)


def rejection_accept(u: torch.Tensor, p: torch.Tensor, q: torch.Tensor,
                     drafts: torch.Tensor):
    """Speculative rejection sampling over a batch of windows: uniforms
    ``u [..., 2k+2]``, the target's distributions ``p [..., k+1, V]``, the
    draft's ``q [..., k, V]`` and its proposals ``drafts [..., k]`` →
    (accepted count ``[...]``, correction token ``[...]``). The emitted
    window is the accepted proposals then the correction: a residual
    ``max(p - q, 0)`` draw at the first rejection (``p`` itself where the
    residual is all zero), else the bonus drawn from ``p``'s last row."""
    k = q.shape[-2]
    s_acc = rejection_decide(u[..., 0:2 * k:2], p, q, drafts)
    resid = torch.clamp(p[..., :k, :] - q, min=0.0)
    ok = resid.sum(dim=-1, keepdim=True) > 0
    resid = torch.where(ok, resid, p[..., :k, :])
    resampled = inverse_cdf(resid, u[..., 1:2 * k:2])              # [..., k]
    bonus = inverse_cdf(p[..., k, :], u[..., 2 * k + 1])
    at = torch.clamp(s_acc, max=k - 1)[..., None]
    corr = torch.where(s_acc < k, torch.gather(resampled, -1, at)[..., 0],
                       bonus)
    return s_acc, corr


def make_verify_step(cfg: LlamaConfig, paged: PagedKVConfig, k: int,
                     top_k: Optional[int], top_p: Optional[float]):
    """One dispatch scoring ``k + 1`` positions per slot over the block-
    table cache, with a head at every position and the acceptance rule
    applied in the same call.

    Inputs: ``window [S, k+1]`` (the last emitted token, then the
    proposals), ``draft_probs [S, k, V]``, ``live [S]`` (host) masking rows
    past a slot's remaining horizon. Returns (pool, out tokens
    ``[S, k+1]``, accepted ``[S]``): the host emits ``out[s, :min(accepted
    + 1, remaining)]``."""
    bl = paged.block_len
    kp1 = k + 1

    @torch.inference_mode()
    def verify_step(pool: dict, params: dict, fused: dict,
                    tables: torch.Tensor, window: torch.Tensor,
                    draft_probs: torch.Tensor, pos: torch.Tensor,
                    live: np.ndarray, generators: list, temps: np.ndarray,
                    active: np.ndarray):
        dev = tables.device
        mb = tables.shape[1]
        rows = torch.arange(kp1, device=dev)
        positions = pos[:, None] + rows[None, :]                  # [S, k+1]
        writable = (torch.as_tensor(active, device=dev)[:, None]
                    & (rows[None, :] < torch.as_tensor(live,
                                                       device=dev)[:, None]))
        blk_idx = torch.clamp(positions // bl, max=mb - 1)
        own = torch.gather(tables, 1, blk_idx)
        wblk = torch.where(writable, own, torch.full_like(own, TRASH_BLOCK))
        woff = positions % bl
        h, pool = _forward_paged(params, fused, window, pool, tables,
                                 positions, wblk, woff, cfg)
        logits = llama.head(params, h, cfg)                    # [S, k+1, V]
        # Greedy: the target's argmax at every position; accept the longest
        # prefix where it equals the proposals.
        out = torch.argmax(logits, dim=-1)
        drafts = window[:, 1:]
        accepted = torch.cumprod((out[:, :k] == drafts).to(torch.int64),
                                 dim=1).sum(dim=1)
        sampled = np.nonzero(active & (temps > 0))[0]
        if len(sampled):
            sel = torch.as_tensor(sampled, device=dev)
            p = sampling_probs(logits[sel],
                               torch.as_tensor(temps[sampled], device=dev),
                               top_k, top_p)
            u = torch.stack([torch.rand(2 * k + 2, generator=generators[s],
                                        device=dev) for s in sampled])
            s_acc, corr = rejection_accept(u, p, draft_probs[sel],
                                           drafts[sel])
            base = torch.cat([drafts[sel],
                              torch.zeros_like(drafts[sel][:, :1])], dim=1)
            out[sel] = torch.where(rows[None, :] == s_acc[:, None],
                                   corr[:, None], base)
            accepted[sel] = s_acc
        return pool, out, accepted

    return verify_step
