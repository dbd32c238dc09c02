"""Token-stream data pipeline for LLM training: the port's own copy of the
JAX package's ``data/tokens.py`` (numpy only). Batches come out as numpy
int32 arrays; the trainer moves them to its device.

Capability target: simplellm's ``TinyStories(tokenizer, batch_size, seq_l,
skip=...)`` iterable yielding ``[batch_size, seq_l]`` int batches, where
``skip`` offsets the stream so DP ranks see disjoint data (reference:
lab/tutorial_1b/DP/gradient_aggr/intro_DP_GA.py:29).

Offline-capable: reads a text corpus (one document per line) when one is
available ($DDL_TINYSTORIES or ./data/tinystories.txt), else generates a
deterministic synthetic story corpus from a template grammar — structured
enough that a tiny causal LM shows the reference's loss-curve character
(≈10.5 → ≈6 over a few thousand steps, BASELINE.md) without network access.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional

import numpy as np

# ------------------------------------------------------------ synthetic corpus

_NAMES = ["Lily", "Tom", "Mia", "Ben", "Sara", "Max", "Anna", "Leo", "Ella", "Sam",
          "Lucy", "Tim", "Amy", "Jack", "Rosa", "Finn"]
_ANIMALS = ["cat", "dog", "bird", "bunny", "frog", "duck", "fox", "bear", "mouse", "owl"]
_OBJECTS = ["ball", "kite", "book", "toy", "hat", "cake", "flower", "boat", "drum", "star"]
_PLACES = ["park", "garden", "forest", "house", "beach", "hill", "farm", "pond", "yard", "school"]
_ADJS = ["happy", "little", "big", "red", "shiny", "soft", "brave", "silly", "kind", "tiny"]
_VERBS = ["played", "jumped", "ran", "laughed", "sang", "danced", "walked", "smiled", "looked", "hopped"]

_TEMPLATES = [
    "Once upon a time there was a {adj} {animal} named {name}. {name} loved to play with a {obj} in the {place}. One day {name} {verb} all day long. The {animal} was very {adj2}. At the end of the day {name} went home and slept.",
    "{name} and {name2} went to the {place}. They found a {adj} {obj}. {name} said, I want to share this {obj} with you. {name2} {verb} with joy. They were {adj2} friends forever.",
    "One day a {adj} {animal} found a {obj} near the {place}. The {animal} {verb} and {verb2}. A {adj2} {animal2} came to help. Together they played until the sun went down.",
    "Little {name} had a {adj} {obj}. Every morning {name} took the {obj} to the {place}. One day the {obj} was lost. {name} {verb} everywhere. A {adj2} {animal} found it and {name} was happy again.",
]


def synthetic_story(rng: np.random.Generator) -> str:
    t = _TEMPLATES[rng.integers(len(_TEMPLATES))]
    return t.format(
        name=_NAMES[rng.integers(len(_NAMES))],
        name2=_NAMES[rng.integers(len(_NAMES))],
        animal=_ANIMALS[rng.integers(len(_ANIMALS))],
        animal2=_ANIMALS[rng.integers(len(_ANIMALS))],
        obj=_OBJECTS[rng.integers(len(_OBJECTS))],
        place=_PLACES[rng.integers(len(_PLACES))],
        adj=_ADJS[rng.integers(len(_ADJS))],
        adj2=_ADJS[rng.integers(len(_ADJS))],
        verb=_VERBS[rng.integers(len(_VERBS))],
        verb2=_VERBS[rng.integers(len(_VERBS))],
    )


def synthetic_documents(seed: int = 0) -> Iterator[str]:
    rng = np.random.default_rng(seed)
    while True:
        yield synthetic_story(rng)


_DEFAULT_CORPUS = ("data/tinystories.txt",)


def _document_source(path: Optional[str], seed: int) -> Iterator[str]:
    candidates = [path, os.environ.get("DDL_TINYSTORIES"), *_DEFAULT_CORPUS]
    for c in candidates:
        if c and os.path.exists(c):
            def file_docs(p=c):
                while True:  # cycle the corpus like a streaming dataset
                    yielded = False
                    with open(p, "r", encoding="utf-8") as f:
                        for line in f:
                            line = line.strip()
                            if line:
                                yielded = True
                                yield line
                    if not yielded:
                        raise ValueError(f"corpus file {p} contains no non-empty lines")
            return file_docs()
    return synthetic_documents(seed)


class TokenStream:
    """Iterable of ``[batch_size, seq_len]`` int32 batches.

    ``skip`` counts *sequences* to drop from the head of the stream — the
    reference passes ``skip=rank*5000`` so each DP rank reads a disjoint
    window (intro_DP_GA.py:29). For an SPMD program, pass the per-shard skip
    and stack shard batches, or use `sharded_batches`.
    """

    def __init__(self, tokenizer, batch_size: int, seq_len: int, *,
                 skip: int = 0, path: Optional[str] = None, seed: int = 0):
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.skip = skip
        self._docs = _document_source(path, seed)
        self._buf: List[int] = []
        self._skipped = False

    def _next_seq(self) -> np.ndarray:
        need = self.seq_len
        eos = getattr(self.tokenizer, "eos_id", -1)
        while len(self._buf) < need:
            ids = self.tokenizer.encode(next(self._docs), add_bos=True)
            if eos >= 0:
                ids.append(eos)
            self._buf.extend(ids)
        seq = self._buf[:need]
        del self._buf[:need]
        return np.asarray(seq, dtype=np.int32)

    def __iter__(self):
        if not self._skipped:
            for _ in range(self.skip):
                self._next_seq()
            self._skipped = True
        while True:
            yield np.stack([self._next_seq() for _ in range(self.batch_size)])


def shard_batches(tokenizer, per_shard_batch: int, seq_len: int, shard: int, *,
                  shard_skip: int = 5000, path: Optional[str] = None,
                  seed: int = 0):
    """Shard ``shard``'s ``[per_shard_batch, seq_len]`` batches of
    ``sharded_batches``: the window the reference's rank ``shard`` reads
    (skip = shard·shard_skip). A data-parallel rank builds only its own
    stream."""
    return iter(TokenStream(tokenizer, per_shard_batch, seq_len,
                            skip=shard * shard_skip, path=path, seed=seed))


def sharded_batches(tokenizer, per_shard_batch: int, seq_len: int, n_shards: int, *,
                    shard_skip: int = 5000, path: Optional[str] = None, seed: int = 0):
    """Yield ``[n_shards, per_shard_batch, seq_len]`` global batches where
    shard ``i`` reads the window the reference's rank ``i`` would have read
    (skip = i·shard_skip). Feed directly to a shard_map'd step with the
    leading axis sharded over the ``data`` mesh axis."""
    streams = [
        iter(TokenStream(tokenizer, per_shard_batch, seq_len,
                         skip=i * shard_skip, path=path, seed=seed))
        for i in range(n_shards)
    ]
    while True:
        yield np.stack([next(s) for s in streams])
