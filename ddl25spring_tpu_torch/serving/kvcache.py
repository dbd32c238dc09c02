"""Paged KV cache: a fixed-size device block pool + a host-side allocator.
Counterpart of the JAX package's ``serving/kvcache.py``.

- The device side is a pair of ``[L, num_blocks, block_len, H, Dh]``
  tensors (layer-major, so each layer's blocks are one slice). The engine
  writes them in place.
- The host side hands out block indices from a free list; each live
  sequence owns a row of a ``[num_slots, max_blocks_per_seq]`` block table
  mapping its logical positions to pool blocks, and attention gathers
  through that row, so physical placement never reaches the math.
- Block 0 is the TRASH block: inactive slots and padded prefill tails write
  there, and unallocated table entries point at it. Its contents are never
  read unmasked (attention masks by absolute position).

A request with prompt ``P`` generating ``M`` tokens writes positions
``0..P+M-2`` (the last sampled token is never fed back), so it needs
``ceil((P+M-1)/block_len)`` blocks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch

from ..config import LlamaConfig, torch_dtype
from ..device import resolve_device

# Never allocated: absorbs the writes of inactive slots and padded tails.
TRASH_BLOCK = 0


@dataclass(frozen=True)
class PagedKVConfig:
    """Pool geometry. ``num_blocks`` INCLUDES the trash block;
    ``max_seq_len`` is the longest prompt+generation the engine serves and
    the padded length every attention gather sees."""

    num_blocks: int
    block_len: int
    max_blocks_per_seq: int
    kv_dtype: Optional[str] = None

    def __post_init__(self):
        if self.num_blocks < 2:
            raise ValueError(f"num_blocks={self.num_blocks}: need at least "
                             "one allocatable block beside the trash block")
        if self.block_len < 1 or self.max_blocks_per_seq < 1:
            raise ValueError(f"bad pool geometry: {self}")

    @property
    def max_seq_len(self) -> int:
        return self.block_len * self.max_blocks_per_seq


def blocks_for(n_tokens: int, block_len: int) -> int:
    """Blocks needed to hold ``n_tokens`` cache positions."""
    return -(-max(0, n_tokens) // block_len)


def init_pool(cfg: LlamaConfig, paged: PagedKVConfig, device=None) -> dict:
    """Zeroed block pool: {"k","v"} each ``[L, num_blocks, block_len, H,
    Dh]`` in ``paged.kv_dtype`` (default: the compute dtype)."""
    dt = torch_dtype(paged.kv_dtype or cfg.dtype)
    shape = (cfg.n_layers, paged.num_blocks, paged.block_len,
             cfg.num_heads, cfg.head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def kv_bytes_per_token(cfg: LlamaConfig,
                       kv_dtype: Optional[str] = None) -> int:
    """K+V bytes one cache position occupies across all layers."""
    item = torch_dtype(kv_dtype or cfg.dtype).itemsize
    return 2 * cfg.n_layers * cfg.num_heads * cfg.head_dim * item


def pool_bytes(cfg: LlamaConfig, paged: PagedKVConfig) -> int:
    """Device bytes of the block pool."""
    return (paged.num_blocks * paged.block_len
            * kv_bytes_per_token(cfg, paged.kv_dtype))


def naive_cache_bytes(cfg: LlamaConfig, n_streams: int, max_len: int,
                      kv_dtype: Optional[str] = None) -> int:
    """What ``generate`` would allocate for ``n_streams`` concurrent
    requests: one whole ``max_len`` cache each."""
    return n_streams * max_len * kv_bytes_per_token(cfg, kv_dtype)


class BlockAllocator:
    """Host-side free list over block indices ``1..num_blocks-1`` with
    per-block reference counts.

    ``alloc`` is all-or-nothing (a sequence's whole reservation or None),
    so admission can never strand a half-provisioned request. Blocks are
    handed out lowest index first. ``share`` takes extra references on
    allocated blocks; ``free`` drops references and returns a block to the
    free list only at zero, reporting which blocks physically freed.
    ``in_use`` and ``peak_in_use`` count physical blocks."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(f"num_blocks={num_blocks}: nothing to allocate")
        self.num_blocks = num_blocks
        self._free = list(range(num_blocks - 1, 0, -1))   # pop() -> lowest
        self._refs: dict = {}
        self.peak_in_use = 0

    @property
    def capacity(self) -> int:
        return self.num_blocks - 1

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.capacity - len(self._free)

    def refcount(self, block: int) -> int:
        return self._refs.get(block, 0)

    def fragmentation(self) -> dict:
        """Free-list census: ``holes`` is the number of maximal runs of
        consecutive free indices, ``largest_run`` the longest (0 and 0 for
        an empty free list; one hole of ``capacity`` for an empty pool)."""
        if not self._free:
            return {"holes": 0, "largest_run": 0}
        holes, run, largest = 1, 1, 1
        ordered = sorted(self._free)
        for prev, cur in zip(ordered, ordered[1:]):
            if cur == prev + 1:
                run += 1
            else:
                holes += 1
                run = 1
            largest = max(largest, run)
        return {"holes": holes, "largest_run": largest}

    @property
    def holes(self) -> int:
        return self.fragmentation()["holes"]

    @property
    def largest_run(self) -> int:
        return self.fragmentation()["largest_run"]

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` blocks, or None if the pool cannot cover them."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        got = [self._free.pop() for _ in range(n)]
        for b in got:
            self._refs[b] = 1
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return got

    def share(self, blocks: List[int]) -> None:
        """One more reference on each (already allocated) block."""
        for b in blocks:
            if self._refs.get(b, 0) < 1:
                raise ValueError(f"share({b}): block is not allocated")
        for b in blocks:
            self._refs[b] += 1

    def free(self, blocks: List[int]) -> List[int]:
        """Drop one reference per block; returns the blocks that reached
        zero and went back to the free list."""
        for b in blocks:
            if not 1 <= b < self.num_blocks:
                raise ValueError(f"free({b}): not an allocatable block")
        counts: dict = {}
        for b in blocks:
            counts[b] = counts.get(b, 0) + 1
        for b, n in counts.items():
            if self._refs.get(b, 0) < n:
                raise ValueError(f"free({b}): double free")
        freed = []
        for b, n in counts.items():
            self._refs[b] -= n
            if self._refs[b] == 0:
                del self._refs[b]
                freed.append(b)
        if freed:   # keep the free list lowest-first whatever the order
            self._free = sorted(set(self._free) | set(freed), reverse=True)
        return freed
