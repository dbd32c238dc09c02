"""Step-level serving engine over a fixed slot axis. Counterpart of the JAX
package's ``serving/engine.py``.

Two programs, built once per engine by ``make_prefill_chunk`` and
``make_decode_step`` (and, with speculation, ``speculate.make_verify_step``):

- ``prefill_chunk``: one slot's prompt chunk ``[1, Tc]`` through the model,
  writing K/V into the slot's pool blocks; the final chunk also samples the
  first token. Chunking lets a long prompt interleave with in-flight decode.
- ``decode_step``: one token for ALL slots ``[S]`` at once; each slot feeds
  back its last token at its own position, writes into its own blocks
  (inactive slots write to trash), and samples with its own generator.
- ``verify_step`` (``speculate=SpecConfig(...)``): the decode step widened
  to a ``k+1``-position window per slot, scoring a draft's ``k`` proposals
  in one dispatch (``serving/speculate.py``).

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

Options, each off by default:

- ``prefix_share``: copy-on-write prefix sharing. Full prompt blocks that a
  live request has already written are mapped read-only into a later
  request with the identical token prefix (an allocator reference, not a
  new block), and that request's prefill writes nothing below the shared
  region (``write_from``: those rows go to the trash block). The pool is
  written in place here, where the JAX engine's is a donated copy, so one
  unmasked write would change the donor's cache: the mask is what keeps
  the shared blocks' bytes fixed (``tests/test_torch_prefix_share.py``).
- ``gather_buckets``: decode and verify gather only the smallest
  power-of-two prefix of the block table that covers every active slot's
  live blocks, and count the bytes gathered and saved.
- ``speculate``: a draft proposes ``k`` tokens per round, the target
  verifies them in one dispatch (``serving/speculate.py``).
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import nn
from ..config import LlamaConfig
from ..device import check_on_device, resolve_device
from ..models import generate, llama
from ..telemetry import introspect
from .kvcache import (TRASH_BLOCK, BlockAllocator, PagedKVConfig, blocks_for,
                      init_pool, kv_bytes_per_token)


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
    compute no logits and draw nothing.

    ``write_from`` (prefix sharing): rows at positions below it write to
    the trash block, because the slot reads those positions from blocks it
    shares with an earlier request of the same prefix. Their recomputed
    K/V equal the shared ones (same tokens, positions and weights), so
    nothing is lost; 0 writes every valid row."""
    bl, mb = paged.block_len, paged.max_blocks_per_seq

    @torch.inference_mode()
    def prefill_chunk(pool: dict, params: dict, fused: dict,
                      table_row: torch.Tensor, tokens: torch.Tensor,
                      start: int, n_valid: int, write_from: int,
                      is_final: bool, generator: Optional[torch.Generator],
                      temperature: float):
        dev = tokens.device
        pos = start + torch.arange(chunk_len, device=dev)            # [Tc]
        valid = ((torch.arange(chunk_len, device=dev) < n_valid)
                 & (pos >= write_from))
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


def inverse_cdf(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """One draw per row of ``probs [..., V]`` (non-negative, not
    necessarily normalized) from uniforms ``u [...]`` in [0, 1): the first
    index whose cumulative mass exceeds ``u`` times the row's total. A
    zero-probability index is never returned."""
    c = torch.cumsum(probs, dim=-1).contiguous()
    x = (u.to(c.dtype) * c[..., -1]).unsqueeze(-1).contiguous()
    idx = torch.searchsorted(c, x, right=True).squeeze(-1)
    last = (probs.shape[-1] - 1
            - torch.argmax((probs.flip(-1) > 0).to(torch.int32), dim=-1))
    return torch.minimum(idx, last)


def sampling_probs(logits: torch.Tensor, temps: torch.Tensor,
                   top_k: Optional[int], top_p: Optional[float]
                   ) -> torch.Tensor:
    """The distribution a sampling slot draws from: logits ``[S, ..., V]``
    over the slot's temperature ``temps [S]``, then ``filter_logits``, then
    the softmax. The draft's ``q`` and the verifier's ``p`` both come from
    here, so a same-weights draft proposes from the target's own
    distribution."""
    t = temps.to(logits.dtype).reshape(-1, *([1] * (logits.dim() - 1)))
    return torch.softmax(generate.filter_logits(logits / t, top_k, top_p),
                         dim=-1)


def make_decode_step(cfg: LlamaConfig, paged: PagedKVConfig,
                     top_k: Optional[int], top_p: Optional[float], *,
                     return_probs: bool = False):
    """One token for every slot of the block table ``[S, ...]`` passed in
    (its width may be a narrowed prefix of the full table). ``active`` and
    ``temps`` are host arrays ``[S]``; only active slots with a temperature
    draw from their generators, greedy and inactive slots draw nothing.

    ``return_probs=True`` is the draft variant (``serving/speculate.py``):
    it also returns each slot's sampling distribution ``q [S, V]``
    (``sampling_probs``), and a sampling slot's token is drawn from that
    same tensor, by ``inverse_cdf`` of one uniform from its generator, so
    the rejection test sees exactly the distribution the proposal came
    from."""
    bl = paged.block_len

    @torch.inference_mode()
    def decode_step(pool: dict, params: dict, fused: dict,
                    tables: torch.Tensor, last_tok: torch.Tensor,
                    pos: torch.Tensor, generators: list, temps: np.ndarray,
                    active: np.ndarray):
        dev = tables.device
        mb = tables.shape[1]
        blk_idx = torch.clamp(pos // bl, max=mb - 1)
        own = torch.gather(tables, 1, blk_idx[:, None])[:, 0]
        active_t = torch.as_tensor(active, device=dev)
        wblk = torch.where(active_t, own, torch.full_like(own, TRASH_BLOCK))
        woff = pos % bl
        h, pool = _forward_paged(params, fused, last_tok[:, None], pool,
                                 tables, pos[:, None], wblk[:, None],
                                 woff[:, None], cfg)
        logits = llama.head(params, h, cfg)[:, 0, :]               # [S, V]
        toks = torch.argmax(logits, dim=-1)
        sampled = np.nonzero(active & (temps > 0))[0]
        if not return_probs:
            for s in sampled:
                toks[s] = _sample_slot(generators[s], logits[s:s + 1],
                                       float(temps[s]), top_k, top_p)[0]
            return pool, toks
        safe_t = torch.as_tensor(np.where(temps > 0, temps, 1.0),
                                 device=dev)
        q = sampling_probs(logits, safe_t, top_k, top_p)
        if len(sampled):
            u = torch.stack([torch.rand((), generator=generators[s],
                                        device=dev) for s in sampled])
            sel = torch.as_tensor(sampled, device=dev)
            toks[sel] = inverse_cdf(q[sel], u)
        return pool, toks, q

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
                 "phase", "seq", "shared", "prompt_key", "registered")

    def __init__(self, blocks, prompt, max_new, seq, *, shared=0,
                 prompt_key=None):
        self.blocks = blocks          # pool block indices (the first
                                      # ``shared`` are references to
                                      # another request's prompt blocks)
        self.prompt = prompt          # np.int64 [Tp]
        self.max_new = max_new
        self.produced = 0
        self.prefill_off = 0          # prompt tokens already prefilled
        self.phase = "prefill"        # "prefill" -> "decode"
        self.seq = seq                # admission order: prefill is FCFS by it
        self.shared = shared          # leading blocks mapped read-only
        self.prompt_key = prompt_key  # tuple(prompt), for prefix-cache keys
        self.registered = shared      # full prompt blocks in the prefix cache


class Engine:
    """Slots + the programs + block plumbing. Queueing, time and telemetry
    live one layer up (scheduler.py). ``step()`` is one token boundary: at
    most one prefill chunk (FCFS over mid-prefill slots), then one decode
    step, or one draft-propose + verify round with ``speculate``, if any
    slot is decoding; it returns the ``TokenEvent``s produced.

    ``engine_id`` labels the engine in a fleet (``serving/fleet.py``);
    the scheduler tags its events with it."""

    def __init__(self, params, cfg: LlamaConfig, paged: PagedKVConfig,
                 num_slots: int, *, prefill_chunk: int = 16,
                 top_k: Optional[int] = None, top_p: Optional[float] = None,
                 engine_id: Optional[int] = None, speculate=None,
                 prefix_share: bool = False, gather_buckets: bool = False,
                 device=None):
        if num_slots < 1 or prefill_chunk < 1:
            raise ValueError(f"num_slots={num_slots}, "
                             f"prefill_chunk={prefill_chunk}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.paged = paged
        self.num_slots = num_slots
        self.prefill_chunk_len = prefill_chunk
        self.engine_id = engine_id
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
        self.decode_dispatches = 0     # decode or verify dispatches
        self.decode_tokens = 0         # tokens those dispatches emitted
        self.draft_dispatches = 0
        # Prefix sharing: the leading n·block_len prompt tokens -> the
        # block holding tokens [(n-1)·bl, n·bl), published once the owner's
        # prefill has written it and evicted when the block is freed.
        self.prefix_share = prefix_share
        self._prefix_blocks: Dict[tuple, int] = {}
        self._block_key: Dict[int, tuple] = {}
        # Gather narrowing: the table widths a dispatch may gather.
        self.gather_buckets = gather_buckets
        mb = paged.max_blocks_per_seq
        self._buckets = sorted({min(1 << i, mb)
                                for i in range(mb.bit_length() + 1)} | {mb})
        self.gather_bytes = 0          # KV bytes gathered, as narrowed
        self.gather_bytes_saved = 0    # bytes the full-width gather adds
        n_shapes = len(self._buckets) if gather_buckets else 1
        # The JAX engine's program budget, as call signatures
        # (telemetry.introspect.CompileWatch): one prefill shape, one decode
        # (and verify) shape per gather width; admission, retirement and
        # raggedness are data, never shapes. A signature past the budget is
        # a retrace; the scheduler binds its event stream to the watches.
        tag = "" if engine_id is None else f"[{engine_id}]"
        self._prefill = introspect.watch(
            make_prefill_chunk(cfg, paged, prefill_chunk, top_k, top_p),
            name=f"serving/prefill_chunk{tag}", max_caches=1)
        self._decode = introspect.watch(
            make_decode_step(cfg, paged, top_k, top_p),
            name=f"serving/decode_step{tag}", max_caches=n_shapes)
        self.spec = speculate
        self.last_spec: Optional[dict] = None
        if speculate is not None:
            from .speculate import DraftEngine, make_verify_step
            self.draft = DraftEngine(speculate, cfg, paged, num_slots,
                                     prefill_chunk=prefill_chunk,
                                     top_k=top_k, top_p=top_p,
                                     device=self.device, engine_id=engine_id,
                                     decode_shapes=n_shapes)
            self._verify = introspect.watch(
                make_verify_step(cfg, paged, speculate.k, top_k, top_p),
                name=f"serving/verify_step{tag}", max_caches=n_shapes)
        else:
            self.draft = None
            self._verify = None

    def watches(self) -> list:
        """The engine's ``CompileWatch`` set, its documented program
        budget: prefill and decode, plus verify and the draft's prefill and
        decode with speculation. ``compiles`` counts the call signatures
        seen (the JAX engine's compiled programs), ``retraces`` those past
        the budget."""
        ws = [self._prefill, self._decode]
        if self.spec is not None:
            ws += [self._verify, self.draft._prefill, self.draft._decode]
        return ws

    # ------------------------------------------------------------- admission
    def required_blocks(self, prompt_len: int, max_new: int) -> int:
        """Positions written are ``0..prompt_len+max_new-2``."""
        return blocks_for(prompt_len + max_new - 1, self.paged.block_len)

    def _shared_prefix(self, prompt) -> List[int]:
        """The blocks an admission of ``prompt`` can map read-only: the
        longest chain of full prompt blocks whose exact token prefix is in
        the prefix cache. Registration is prefix-ordered, so the walk stops
        at the first miss."""
        if not self.prefix_share:
            return []
        bl = self.paged.block_len
        key = tuple(int(t) for t in prompt)
        shared: List[int] = []
        for n in range(1, len(key) // bl + 1):
            b = self._prefix_blocks.get(key[:n * bl])
            if b is None:
                break
            shared.append(b)
        return shared

    def free_slot(self) -> Optional[int]:
        for s, slot in enumerate(self.slots):
            if slot is None:
                return s
        return None

    def can_admit(self, prompt_len: int, max_new: int, prompt=None) -> bool:
        """``prompt`` (the token ids) credits the blocks a shared prefix
        saves; without it the check is the full reservation's."""
        if self.free_slot() is None:
            return False
        need = self.required_blocks(prompt_len, max_new)
        if prompt is not None:
            need -= len(self._shared_prefix(prompt))
        return need <= self.allocator.free_blocks

    def admit(self, prompt, max_new: int, *, temperature: float = 0.0,
              generator: Optional[torch.Generator] = None) -> int:
        """Place a request into a free slot and reserve its WORST-CASE
        blocks up front (all or nothing), so an admitted request always
        runs to completion and pool exhaustion only ever queues.

        With ``prefix_share`` the full prompt blocks already written by a
        live request of the identical prefix are mapped read-only (one
        more allocator reference each), the reservation shrinks by as
        many blocks, and the prefill starts at the chunk that holds the
        first unshared position, or at the last prompt token (its hidden
        state samples the first token), writing nothing below the shared
        region."""
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
        shared = self._shared_prefix(prompt)
        fresh = self.allocator.alloc(self.required_blocks(tp, mx)
                                     - len(shared))
        if fresh is None:
            raise RuntimeError("pool exhausted")
        if shared:
            self.allocator.share(shared)
        blocks = shared + fresh
        self._admit_seq += 1
        slot = _Slot(blocks, prompt, mx, self._admit_seq, shared=len(shared),
                     prompt_key=(tuple(int(t) for t in prompt)
                                 if self.prefix_share else None))
        slot.prefill_off = min(len(shared) * self.paged.block_len, tp - 1)
        self.slots[s] = slot
        self.tables[s] = TRASH_BLOCK
        self.tables[s, :len(blocks)] = blocks
        self.pos[s] = 0
        self.temps[s] = float(temperature)
        self.generators[s] = generator
        if self.draft is not None:
            self.draft.admit(s, temperature, generator)
        return s

    @property
    def busy(self) -> bool:
        return any(slot is not None for slot in self.slots)

    def blocks_in_use(self) -> int:
        return self.allocator.in_use

    # ------------------------------------------------------- weight hot-swap
    def swap_params(self, params, *, fused: Optional[dict] = None) -> None:
        """Swap to new weights at the current token boundary (between
        ``step()`` calls; with speculation, a verify boundary). In-flight
        streams continue under the new weights over the K/V they already
        wrote; the draft keeps its own weights. The new tree must match the
        old one leaf for leaf (``check_swappable``)."""
        params = llama.as_tree(params)
        check_swappable(self.params, params)
        self.params = params
        self.fused = (fused if fused is not None
                      else generate._fuse_blocks(params["blocks"]))

    # ------------------------------------------------------- one boundary
    def step(self) -> List[TokenEvent]:
        events: List[TokenEvent] = []
        self.last_spec = None
        prefilling = [(sl.seq, i) for i, sl in enumerate(self.slots)
                      if sl is not None and sl.phase == "prefill"]
        if prefilling:
            events.extend(self._advance_prefill(min(prefilling)[1]))
        if any(sl is not None and sl.phase == "decode" for sl in self.slots):
            events.extend(self._advance_spec_decode()
                          if self.spec is not None
                          else self._advance_decode())
        return events

    def _register_prefix_blocks(self, s: int) -> None:
        """Publish the full prompt blocks slot ``s`` has now written (or
        shares) into the prefix cache; the first writer of a prefix wins."""
        slot = self.slots[s]
        bl = self.paged.block_len
        while ((slot.registered + 1) * bl <= slot.prefill_off
               and (slot.registered + 1) * bl <= len(slot.prompt)):
            n = slot.registered + 1
            key = slot.prompt_key[:n * bl]
            block = int(self.tables[s, n - 1])
            if key not in self._prefix_blocks:
                self._prefix_blocks[key] = block
                self._block_key[block] = key
            slot.registered = n

    def _advance_prefill(self, s: int) -> List[TokenEvent]:
        slot = self.slots[s]
        tc = self.prefill_chunk_len
        off = slot.prefill_off
        n_valid = min(tc, len(slot.prompt) - off)
        chunk = np.zeros(tc, np.int64)
        chunk[:n_valid] = slot.prompt[off:off + n_valid]
        is_final = off + n_valid >= len(slot.prompt)
        write_from = slot.shared * self.paged.block_len
        table_row = torch.tensor(self.tables[s], device=self.device)
        chunk_t = torch.tensor(chunk, device=self.device)
        self.pool, tok = self._prefill(
            self.pool, self.params, self.fused, table_row, chunk_t, off,
            n_valid, write_from, is_final, self.generators[s],
            float(self.temps[s]))
        if self.draft is not None:
            # The same chunk into the draft pool (same table row, so shared
            # blocks are shared there too), counted as a draft dispatch.
            self.draft.prefill_chunk(table_row, chunk_t, off, n_valid,
                                     write_from)
            self.draft_dispatches += 1
        slot.prefill_off = off + n_valid
        if self.prefix_share:
            self._register_prefix_blocks(s)
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

    def _gathered_tables(self, active: np.ndarray, tq: int) -> np.ndarray:
        """The block-table columns a decode or verify dispatch gathers: the
        full width, or with ``gather_buckets`` the smallest bucket covering
        every active slot's reads (positions below ``pos + tq``; a verify
        window at the horizon may ask past the table, and its overflow rows
        are masked to trash, so the need caps at the width). Counts the
        KV bytes gathered and saved."""
        bl, mb = self.paged.block_len, self.paged.max_blocks_per_seq
        per_block = bl * kv_bytes_per_token(self.cfg, self.paged.kv_dtype)
        if not self.gather_buckets:
            self.gather_bytes += self.num_slots * mb * per_block
            return self.tables
        need = 1
        for s in np.nonzero(active)[0]:
            need = max(need, -(-(int(self.pos[s]) + tq) // bl))
        cols = next(b for b in self._buckets if b >= min(need, mb))
        self.gather_bytes += self.num_slots * cols * per_block
        self.gather_bytes_saved += self.num_slots * (mb - cols) * per_block
        return self.tables[:, :cols]

    def _advance_decode(self) -> List[TokenEvent]:
        active = np.array([sl is not None and sl.phase == "decode"
                           for sl in self.slots])
        tables = self._gathered_tables(active, 1)
        self.pool, toks = self._decode(
            self.pool, self.params, self.fused,
            torch.tensor(tables, device=self.device),
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

    def _advance_spec_decode(self) -> List[TokenEvent]:
        """One speculative round: ``k`` draft dispatches propose and one
        fills the draft's cache, one target verify dispatch scores all
        ``k+1`` window positions and accepts a prefix. Emits
        ``min(accepted + 1, remaining)`` tokens per active slot and records
        the round in ``last_spec`` (the scheduler's ``speculate`` event)."""
        k = self.spec.k
        dev = self.device
        active = np.array([sl is not None and sl.phase == "decode"
                           for sl in self.slots])
        remaining = np.array([sl.max_new - sl.produced if a else 0
                              for a, sl in zip(active, self.slots)],
                             np.int64)
        live = np.minimum(k + 1, np.maximum(remaining, 1))
        tables = torch.tensor(self._gathered_tables(active, k + 1),
                              device=dev)
        pos = torch.tensor(self.pos, device=dev)
        last = torch.tensor(self.last_tok, device=dev)
        drafts, draft_probs = self.draft.propose(tables, last, pos,
                                                 self.temps, active, live)
        self.draft_dispatches += k + 1
        window = torch.cat([last[:, None], drafts], dim=1)
        self.pool, out, accepted = self._verify(
            self.pool, self.params, self.fused, tables, window, draft_probs,
            pos, live, self.generators, self.temps, active)
        out = out.tolist()
        accepted = accepted.tolist()
        self.decode_dispatches += 1
        events: List[TokenEvent] = []
        used = proposed = 0
        for s in np.nonzero(active)[0]:
            slot = self.slots[s]
            emit = min(int(accepted[s]) + 1, int(remaining[s]))
            # Proposals past the horizon are masked, not rejected.
            proposed += min(k, int(remaining[s]))
            used += min(int(accepted[s]), emit)
            for i in range(emit):
                tok = int(out[s][i])
                slot.produced += 1
                self.pos[s] += 1
                self.last_tok[s] = tok
                done = slot.produced >= slot.max_new
                if done:
                    self._retire(s)
                events.append(TokenEvent(int(s), tok, first=False,
                                         done=done))
        self.decode_tokens += len(events)
        self.last_spec = {"k": k, "slots": int(active.sum()),
                          "proposed": proposed, "accepted": used,
                          "rejected": proposed - used,
                          "emitted": len(events)}
        return events

    def retire(self, s: int) -> None:
        """Retire slot ``s`` before its ``max_new`` horizon (the
        scheduler's EOS path); its whole reservation returns to the pool."""
        if self.slots[s] is None:
            raise ValueError(f"retire({s}): slot is not active")
        self._retire(s)

    def _retire(self, s: int) -> None:
        """Free the slot's blocks (shared ones lose one reference); blocks
        that return to the pool leave the prefix cache with them."""
        for b in self.allocator.free(self.slots[s].blocks):
            key = self._block_key.pop(b, None)
            if key is not None:
                self._prefix_blocks.pop(key, None)
        self.slots[s] = None
        self.tables[s] = TRASH_BLOCK
        self.pos[s] = 0
        self.temps[s] = 0.0
        self.generators[s] = None
        if self.draft is not None:
            self.draft.generators[s] = None
