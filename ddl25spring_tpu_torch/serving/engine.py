"""Step-level serving engine over a fixed slot axis. Counterpart of the JAX
package's ``serving/engine.py``.

Two programs, built once per engine by ``make_prefill_chunk`` and
``make_decode_step``:

- ``prefill_chunk``: one slot's prompt chunk ``[1, Tc]`` through the model,
  writing K/V into the slot's pool blocks; the final chunk also samples the
  first token. Chunking lets a long prompt interleave with in-flight decode.
- ``decode_step``: one token for ALL slots ``[S]`` at once; each slot feeds
  back its last token at its own position, writes into its own blocks
  (inactive slots write to trash), and samples with its own generator.

Both are built from the same pieces as ``models.generate`` (fused blocks,
``llama.embed``/``head``, the fp32-softmax attention of ``_attend_cached``),
so a request served here, at any slot and in any company, emits the tokens
``generate()`` emits for it alone (held in ``tests/test_torch_serving.py``).
Every op is row-independent, and the gathered cache is padded to
``paged.max_seq_len`` and masked by absolute position.

Randomness follows ``generate``: each sampling slot owns a
``torch.Generator``; the final prefill chunk draws once, and then only
ACTIVE (decoding) slots draw, once per token, so a slot's stream does not
depend on how many steps ran before its admission finished.

Not ported yet (raise ``NotImplementedError``): speculative decoding,
copy-on-write prefix sharing and bucketed gather narrowing.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import nn
from ..config import LlamaConfig
from ..device import check_on_device, resolve_device
from ..models import generate, llama
from .kvcache import (TRASH_BLOCK, BlockAllocator, PagedKVConfig, blocks_for,
                      init_pool)

_NOT_PORTED = ("is not ported yet: ROADMAP.md, queue A "
               "(speculate / prefix_share / gather_buckets)")


def _leaves(tree: dict, path: str = ""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{path}.{k}")
        else:
            yield f"{path}.{k}", v


def check_swappable(old, new) -> None:
    """Raise unless ``new`` matches ``old`` leaf for leaf in tree
    structure, shape, dtype and device: the contract of a weight hot-swap."""
    o = dict(_leaves(llama.as_tree(old)))
    n = dict(_leaves(llama.as_tree(new)))
    if o.keys() != n.keys():
        raise ValueError("swap_params: new params tree structure does "
                         "not match the serving engine's")
    for name, ov in o.items():
        nv = n[name]
        if (ov.shape != nv.shape or ov.dtype != nv.dtype
                or ov.device != nv.device):
            raise ValueError(
                f"swap_params: leaf {name} is {tuple(nv.shape)}/{nv.dtype}/"
                f"{nv.device}, the engine's is {tuple(ov.shape)}/{ov.dtype}/"
                f"{ov.device}")


# ------------------------------------------------------------- paged forward

def _attend_paged(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                  q_positions: torch.Tensor) -> torch.Tensor:
    """``generate._attend_cached`` with a per-slot position mask: q
    ``[S, Tq, H, Dh]`` over the gathered cache ``[S, Tmax, H, Dh]``, masked
    to ``kpos <= q_position`` per (slot, query row)."""
    b, tq, h, dh = q.shape
    tmax = ck.shape[1]
    scale = 1.0 / math.sqrt(dh)
    qm = q.permute(0, 2, 1, 3).reshape(b * h, tq, dh)
    km = ck.permute(0, 2, 1, 3).reshape(b * h, tmax, dh).to(q.dtype)
    vm = cv.permute(0, 2, 1, 3).reshape(b * h, tmax, dh).to(q.dtype)
    scores = torch.bmm(qm.float(), km.float().transpose(1, 2)) * scale
    qpos = q_positions[:, None, :].expand(b, h, tq).reshape(b * h, tq)
    kpos = torch.arange(tmax, device=q.device)
    scores = scores.masked_fill(qpos[:, :, None] < kpos[None, None, :],
                                float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.bmm(probs, vm)
    return out.reshape(b, h, tq, dh).permute(0, 2, 1, 3)


def _apply_rope_slots(x: torch.Tensor, cos: torch.Tensor,
                      sin: torch.Tensor) -> torch.Tensor:
    """``llama.apply_rope`` with per-slot tables cos/sin ``[S, T, half]``."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def _block_paged(block: dict, pk: torch.Tensor, pv: torch.Tensor,
                 x: torch.Tensor, positions: torch.Tensor,
                 tables: torch.Tensor, wblk: torch.Tensor, woff: torch.Tensor,
                 cfg: LlamaConfig):
    """One pre-fused block over x ``[S, T, D]`` at per-slot ``positions``
    ``[S, T]``: scatters this call's K/V into pool blocks at (``wblk``,
    ``woff``) ``[S, T]`` (in place) and attends over each slot's gathered
    block table. The paged twin of ``generate._block_with_cache``."""
    s, t, _ = x.shape
    dh = cfg.head_dim
    xn = nn.rmsnorm(block["attn_norm"], x, eps=cfg.norm_eps)
    qkv = xn @ block["w_qkv"].to(x.dtype)
    dl = qkv.shape[-1] // 3
    h = dl // dh
    q = qkv[..., :dl].reshape(s, t, h, dh)
    k = qkv[..., dl:2 * dl].reshape(s, t, h, dh)
    v = qkv[..., 2 * dl:].reshape(s, t, h, dh)
    cos, sin = llama.rope_angles(positions.reshape(-1), dh, cfg.rope_theta)
    cos = cos.reshape(s, t, -1)
    sin = sin.reshape(s, t, -1)
    q = _apply_rope_slots(q, cos, sin)
    k = _apply_rope_slots(k, cos, sin)       # cached K is stored post-RoPE
    # Distinct (block, offset) targets are guaranteed by block ownership;
    # only TRASH_BLOCK collides, and it is never read unmasked.
    pk[wblk, woff] = k.to(pk.dtype)
    pv[wblk, woff] = v.to(pv.dtype)
    ck = pk[tables].reshape(s, -1, h, dh)    # [S, Tmax, H, Dh]
    cv = pv[tables].reshape(s, -1, h, dh)
    out = _attend_paged(q, ck, cv, positions)
    x = x + out.reshape(s, t, h * dh) @ block["wo"].to(x.dtype)
    xn = nn.rmsnorm(block["mlp_norm"], x, eps=cfg.norm_eps)
    gu = xn @ block["w_gu"].to(x.dtype)
    f = gu.shape[-1] // 2
    x = x + (F.silu(gu[..., :f]) * gu[..., f:]) @ block["w_down"].to(x.dtype)
    return x, pk, pv


def _forward_paged(params: dict, fused_blocks: dict, tokens: torch.Tensor,
                   pool: dict, tables: torch.Tensor, positions: torch.Tensor,
                   wblk: torch.Tensor, woff: torch.Tensor, cfg: LlamaConfig):
    """tokens ``[S, T]`` at per-slot ``positions [S, T]`` → (hidden
    ``[S, T, D]``, the pool updated in place). The paged twin of
    ``generate._forward_fused``."""
    h = llama.embed(params, tokens, cfg)
    for i in range(pool["k"].shape[0]):
        h, _, _ = _block_paged(llama.layer(fused_blocks, i), pool["k"][i],
                               pool["v"][i], h, positions, tables, wblk,
                               woff, cfg)
    return h, pool


def _sample_slot(generator: Optional[torch.Generator], logits: torch.Tensor,
                 temperature: float, top_k: Optional[int],
                 top_p: Optional[float]) -> torch.Tensor:
    """One slot's sample: logits ``[1, V]`` → token ``[1]``, with the same
    ops as ``generate._sample`` (one filter implementation)."""
    return generate._sample(generator, logits, temperature, top_k, top_p)


# ------------------------------------------------------------------ programs

def make_prefill_chunk(cfg: LlamaConfig, paged: PagedKVConfig,
                       chunk_len: int, top_k: Optional[int],
                       top_p: Optional[float]):
    """One slot's prompt chunk ``[chunk_len]`` through the model, K/V
    scattered into the slot's blocks. The final chunk (``is_final``) also
    samples the next token from the chunk's last VALID row; earlier chunks
    compute no logits and draw nothing."""
    bl, mb = paged.block_len, paged.max_blocks_per_seq

    @torch.inference_mode()
    def prefill_chunk(pool: dict, params: dict, fused: dict,
                      table_row: torch.Tensor, tokens: torch.Tensor,
                      start: int, n_valid: int, is_final: bool,
                      generator: Optional[torch.Generator],
                      temperature: float):
        dev = tokens.device
        pos = start + torch.arange(chunk_len, device=dev)            # [Tc]
        valid = torch.arange(chunk_len, device=dev) < n_valid
        blk_idx = torch.clamp(pos // bl, max=mb - 1)
        wblk = torch.where(valid, table_row[blk_idx],
                           torch.full_like(blk_idx, TRASH_BLOCK))
        woff = pos % bl
        h, pool = _forward_paged(params, fused, tokens[None], pool,
                                 table_row[None], pos[None], wblk[None],
                                 woff[None], cfg)
        if not is_final:
            return pool, None
        logits = llama.head(params, h[:, n_valid - 1:n_valid, :],
                            cfg)[:, 0, :]                          # [1, V]
        tok = _sample_slot(generator, logits, temperature, top_k, top_p)
        return pool, tok[0]

    return prefill_chunk


def make_decode_step(cfg: LlamaConfig, paged: PagedKVConfig,
                     top_k: Optional[int], top_p: Optional[float]):
    """One token for every slot of the block table ``[S, ...]`` passed in.
    ``active`` and ``temps`` are host arrays ``[S]``; only active slots with
    a temperature draw from their generators, greedy and inactive slots
    draw nothing."""
    bl = paged.block_len

    @torch.inference_mode()
    def decode_step(pool: dict, params: dict, fused: dict,
                    tables: torch.Tensor, last_tok: torch.Tensor,
                    pos: torch.Tensor, generators: list, temps: np.ndarray,
                    active: np.ndarray):
        mb = tables.shape[1]
        blk_idx = torch.clamp(pos // bl, max=mb - 1)
        own = torch.gather(tables, 1, blk_idx[:, None])[:, 0]
        active_t = torch.as_tensor(active, device=tables.device)
        wblk = torch.where(active_t, own, torch.full_like(own, TRASH_BLOCK))
        woff = pos % bl
        h, pool = _forward_paged(params, fused, last_tok[:, None], pool,
                                 tables, pos[:, None], wblk[:, None],
                                 woff[:, None], cfg)
        logits = llama.head(params, h, cfg)[:, 0, :]               # [S, V]
        toks = torch.argmax(logits, dim=-1)
        for s in np.nonzero(active & (temps > 0))[0]:
            toks[s] = _sample_slot(generators[s], logits[s:s + 1],
                                   float(temps[s]), top_k, top_p)[0]
        return pool, toks

    return decode_step


# ---------------------------------------------------------------- the engine

class TokenEvent(NamedTuple):
    """One emitted token: ``first`` marks the first token of a request
    (sampled by its final prefill chunk), ``done`` that the slot retired."""
    slot: int
    token: int
    first: bool
    done: bool


class _Slot:
    __slots__ = ("blocks", "prompt", "max_new", "produced", "prefill_off",
                 "phase", "seq")

    def __init__(self, blocks, prompt, max_new, seq):
        self.blocks = blocks          # owned pool block indices
        self.prompt = prompt          # np.int64 [Tp]
        self.max_new = max_new
        self.produced = 0
        self.prefill_off = 0          # prompt tokens already prefilled
        self.phase = "prefill"        # "prefill" -> "decode"
        self.seq = seq                # admission order: prefill is FCFS by it


class Engine:
    """Slots + the two programs + block plumbing. Queueing, time and
    telemetry live one layer up (scheduler.py). ``step()`` is one token
    boundary: at most one prefill chunk (FCFS over mid-prefill slots), then
    one decode step if any slot is decoding; it returns the
    ``TokenEvent``s produced."""

    def __init__(self, params, cfg: LlamaConfig, paged: PagedKVConfig,
                 num_slots: int, *, prefill_chunk: int = 16,
                 top_k: Optional[int] = None, top_p: Optional[float] = None,
                 speculate=None, prefix_share: bool = False,
                 gather_buckets: bool = False, device=None):
        if speculate is not None:
            raise NotImplementedError("speculative decoding " + _NOT_PORTED)
        if prefix_share:
            raise NotImplementedError("prefix sharing " + _NOT_PORTED)
        if gather_buckets:
            raise NotImplementedError("gather narrowing " + _NOT_PORTED)
        if num_slots < 1 or prefill_chunk < 1:
            raise ValueError(f"num_slots={num_slots}, "
                             f"prefill_chunk={prefill_chunk}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.paged = paged
        self.num_slots = num_slots
        self.prefill_chunk_len = prefill_chunk
        self.params = llama.as_tree(params)
        check_on_device(self.params["embed"], self.device, "params")
        self.fused = generate._fuse_blocks(self.params["blocks"])
        self.pool = init_pool(cfg, paged, self.device)
        self.allocator = BlockAllocator(paged.num_blocks)
        self._admit_seq = 0
        self.slots: List[Optional[_Slot]] = [None] * num_slots
        # Host-side slot state, copied to the device each step.
        self.tables = np.full((num_slots, paged.max_blocks_per_seq),
                              TRASH_BLOCK, np.int64)
        self.pos = np.zeros(num_slots, np.int64)
        self.last_tok = np.zeros(num_slots, np.int64)
        self.temps = np.zeros(num_slots, np.float64)
        self.generators: List[Optional[torch.Generator]] = [None] * num_slots
        self._prefill = make_prefill_chunk(cfg, paged, prefill_chunk, top_k,
                                           top_p)
        self._decode = make_decode_step(cfg, paged, top_k, top_p)
        self.decode_dispatches = 0
        self.decode_tokens = 0

    def watches(self) -> list:
        """Compile watches of the JAX engine's programs: nothing is traced
        or compiled here, so there are none."""
        return []

    # ------------------------------------------------------------- admission
    def required_blocks(self, prompt_len: int, max_new: int) -> int:
        """Positions written are ``0..prompt_len+max_new-2``."""
        return blocks_for(prompt_len + max_new - 1, self.paged.block_len)

    def free_slot(self) -> Optional[int]:
        for s, slot in enumerate(self.slots):
            if slot is None:
                return s
        return None

    def can_admit(self, prompt_len: int, max_new: int) -> bool:
        return (self.free_slot() is not None
                and self.required_blocks(prompt_len, max_new)
                <= self.allocator.free_blocks)

    def admit(self, prompt, max_new: int, *, temperature: float = 0.0,
              generator: Optional[torch.Generator] = None) -> int:
        """Place a request into a free slot and reserve its WORST-CASE
        blocks up front (all or nothing), so an admitted request always
        runs to completion and pool exhaustion only ever queues."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        tp, mx = len(prompt), int(max_new)
        if tp < 1 or mx < 1:
            raise ValueError(f"empty request: prompt_len={tp}, max_new={mx}")
        if tp + mx - 1 > self.paged.max_seq_len:
            raise ValueError(
                f"request needs {tp + mx - 1} cache positions but the pool "
                f"serves at most max_blocks_per_seq * block_len = "
                f"{self.paged.max_seq_len}")
        if temperature > 0 and generator is None:
            raise ValueError("sampling (temperature>0) requires a generator")
        s = self.free_slot()
        if s is None:
            raise RuntimeError("no free slot")
        blocks = self.allocator.alloc(self.required_blocks(tp, mx))
        if blocks is None:
            raise RuntimeError("pool exhausted")
        self._admit_seq += 1
        self.slots[s] = _Slot(blocks, prompt, mx, self._admit_seq)
        self.tables[s] = TRASH_BLOCK
        self.tables[s, :len(blocks)] = blocks
        self.pos[s] = 0
        self.temps[s] = float(temperature)
        self.generators[s] = generator
        return s

    @property
    def busy(self) -> bool:
        return any(slot is not None for slot in self.slots)

    def blocks_in_use(self) -> int:
        return self.allocator.in_use

    # ------------------------------------------------------- weight hot-swap
    def swap_params(self, params, *, fused: Optional[dict] = None) -> None:
        """Swap to new weights at the current token boundary (between
        ``step()`` calls). In-flight streams continue under the new weights
        over the K/V they already wrote. The new tree must match the old one
        leaf for leaf (``check_swappable``)."""
        params = llama.as_tree(params)
        check_swappable(self.params, params)
        self.params = params
        self.fused = (fused if fused is not None
                      else generate._fuse_blocks(params["blocks"]))

    # ------------------------------------------------------- one boundary
    def step(self) -> List[TokenEvent]:
        events: List[TokenEvent] = []
        prefilling = [(sl.seq, i) for i, sl in enumerate(self.slots)
                      if sl is not None and sl.phase == "prefill"]
        if prefilling:
            events.extend(self._advance_prefill(min(prefilling)[1]))
        if any(sl is not None and sl.phase == "decode" for sl in self.slots):
            events.extend(self._advance_decode())
        return events

    def _advance_prefill(self, s: int) -> List[TokenEvent]:
        slot = self.slots[s]
        tc = self.prefill_chunk_len
        off = slot.prefill_off
        n_valid = min(tc, len(slot.prompt) - off)
        chunk = np.zeros(tc, np.int64)
        chunk[:n_valid] = slot.prompt[off:off + n_valid]
        is_final = off + n_valid >= len(slot.prompt)
        self.pool, tok = self._prefill(
            self.pool, self.params, self.fused,
            torch.tensor(self.tables[s], device=self.device),
            torch.tensor(chunk, device=self.device), off, n_valid, is_final,
            self.generators[s], float(self.temps[s]))
        slot.prefill_off = off + n_valid
        if not is_final:
            return []
        first = int(tok)
        slot.phase = "decode"
        slot.produced = 1
        self.pos[s] = len(slot.prompt)
        self.last_tok[s] = first
        done = slot.produced >= slot.max_new
        if done:
            self._retire(s)
        return [TokenEvent(s, first, first=True, done=done)]

    def _advance_decode(self) -> List[TokenEvent]:
        active = np.array([sl is not None and sl.phase == "decode"
                           for sl in self.slots])
        self.pool, toks = self._decode(
            self.pool, self.params, self.fused,
            torch.tensor(self.tables, device=self.device),
            torch.tensor(self.last_tok, device=self.device),
            torch.tensor(self.pos, device=self.device), self.generators,
            self.temps, active)
        toks = toks.tolist()
        events = []
        for s in np.nonzero(active)[0]:
            slot = self.slots[s]
            tok = int(toks[s])
            slot.produced += 1
            self.pos[s] += 1
            self.last_tok[s] = tok
            done = slot.produced >= slot.max_new
            if done:
                self._retire(s)
            events.append(TokenEvent(int(s), tok, first=False, done=done))
        self.decode_dispatches += 1
        self.decode_tokens += len(events)
        return events

    def retire(self, s: int) -> None:
        """Retire slot ``s`` before its ``max_new`` horizon (the
        scheduler's EOS path); its whole reservation returns to the pool."""
        if self.slots[s] is None:
            raise ValueError(f"retire({s}): slot is not active")
        self._retire(s)

    def _retire(self, s: int) -> None:
        self.allocator.free(self.slots[s].blocks)
        self.slots[s] = None
        self.tables[s] = TRASH_BLOCK
        self.pos[s] = 0
        self.temps[s] = 0.0
        self.generators[s] = None
