"""A plain numpy statement of the ring reduce-scatter's specification, for
every rank at once: what ``compress.ring_reduce_scatter`` and
``compress.hier_reduce_scatter`` must return, bit for bit, on each rank.

Chunk c of the sum starts at rank c+1 and travels c+1 → c+2 → ... → c, each
rank adding its own chunk c on receipt, the owner last, in fp32. What
travels is the partial in the wire format: as is (``"fp32"``), rounded to
bf16 to nearest even (``"bf16"``), or quantized to int8 around ``s =
max(max|c|/127, tiny)`` after the sender's residual for that chunk is added,
the sender keeping ``c − s·q`` as its new residual and the receiver adding
``s·q`` to its own chunk, each of the two rounded once to fp32 as a fused
multiply-add (``"int8_ef"``). The
hierarchical reduce is the ring within each island of S ranks over
superchunks of D chunks, then the ring across the D islands of each column.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

F32 = np.float32
TINY = np.finfo(np.float32).tiny


def to_bf16(x: np.ndarray) -> np.ndarray:
    """fp32 values rounded to the nearest bf16 (ties to even), as fp32."""
    b = np.ascontiguousarray(x, dtype=F32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(F32)


def int8_encode(c: np.ndarray, peak=None
                ) -> Tuple[np.ndarray, np.float32, np.ndarray]:
    """``(q, s, c − s·q)``: symmetric int8 quantization around max|c|, or
    around ``peak`` (an agreed maximum) when given."""
    m = np.max(np.abs(c)).astype(F32) if peak is None else F32(peak)
    s = np.maximum(m / F32(127.0), TINY).astype(F32)
    q = np.clip(np.rint(c / s), -127, 127).astype(np.int8)
    return q, s, fma(c, -s, q)


def fma(a: np.ndarray, s, q: np.ndarray) -> np.ndarray:
    """``a + s·q`` rounded once to fp32 (``s·q`` is exact in float64)."""
    return (np.asarray(a, np.float64)
            + np.float64(s) * np.asarray(q, np.float64)).astype(F32)


def ring(xs: Sequence[np.ndarray], wire: str = "fp32",
         residuals: Optional[Sequence[np.ndarray]] = None
         ) -> Tuple[List[np.ndarray], Optional[List[np.ndarray]]]:
    """Every rank's ``(owned chunk, new residual)`` of the ring over the n
    ranks' flat fp32 vectors ``xs`` (residuals: int8_ef only)."""
    owned, res = agreed_rings([xs], wire,
                              None if residuals is None else [residuals])
    return owned[0], (None if res is None else res[0])


def agreed_rings(xss: Sequence[Sequence[np.ndarray]], wire: str = "fp32",
                 residualss=None):
    """Several rings of the same length and rank count in lockstep, rank r
    of every ring agreeing its int8 scale per hop: the maximum over the
    rings of each one's max|c| (``compress._int8_encode``'s
    ``scale_sync_group`` joining the rings' rank r, e.g. the model shards
    of one (data row, stage)). Returns ``(owned, residuals)``, each a list
    per ring of ``ring``'s per-rank lists; one ring is ``ring``."""
    g_n, n = len(xss), len(xss[0])
    if n == 1:
        return ([[np.asarray(xs[0], F32)] for xs in xss],
                None if residualss is None else
                [[np.asarray(rs[0])] for rs in residualss])
    chunk = len(xss[0][0]) // n
    chunks = [[np.asarray(x, F32).reshape(n, chunk) for x in xs]
              for xs in xss]
    res = (None if residualss is None else
           [[np.asarray(r, F32).reshape(n, chunk).copy() for r in rs]
            for rs in residualss])
    partial = [[chunks[g][r][(r - 1) % n].copy() for r in range(n)]
               for g in range(g_n)]
    for t in range(n - 1):
        c_idx = [(r - 1 - t) % n for r in range(n)]
        if wire == "int8_ef":
            cs = [[(partial[g][r] + res[g][r][c_idx[r]]).astype(F32)
                   for r in range(n)] for g in range(g_n)]
            peaks = [max(np.max(np.abs(cs[g][r])).astype(F32)
                         for g in range(g_n)) for r in range(n)]
        sent = [[None] * n for _ in range(g_n)]
        for g in range(g_n):
            for r in range(n):
                if wire == "int8_ef":
                    q, s, err = int8_encode(cs[g][r], peaks[r])
                    res[g][r][c_idx[r]] = err
                    sent[g][r] = (s, q)
                elif wire == "bf16":
                    sent[g][r] = to_bf16(partial[g][r])
                else:
                    sent[g][r] = partial[g][r]
        partial = [[fma(chunks[g][r][(r - 2 - t) % n], *sent[g][(r - 1) % n])
                    if wire == "int8_ef" else
                    (sent[g][(r - 1) % n] + chunks[g][r][(r - 2 - t) % n])
                    .astype(F32) for r in range(n)] for g in range(g_n)]
    return partial, (None if res is None else
                     [[x.reshape(-1) for x in rs] for rs in res])


def hier(xs: Sequence[np.ndarray], D: int, S: int, wire_ici: str = "fp32",
         wire_dcn: str = "int8_ef",
         residuals: Optional[Sequence[np.ndarray]] = None
         ) -> Tuple[List[np.ndarray], Optional[List[np.ndarray]]]:
    """Every rank's ``(owned chunk, new DCN residual)`` of the two-level
    reduce over ``D × S`` ranks (rank ``d·S + s``; residuals ``[D·chunk]``
    per rank)."""
    supers: List[Optional[np.ndarray]] = [None] * (D * S)
    for d in range(D):
        got, _ = ring([xs[d * S + s] for s in range(S)], wire_ici)
        for s in range(S):
            supers[d * S + s] = got[s]
    owned: List[Optional[np.ndarray]] = [None] * (D * S)
    new_res: List[Optional[np.ndarray]] = [None] * (D * S)
    for s in range(S):
        col = [d * S + s for d in range(D)]
        got, res = ring([supers[r] for r in col], wire_dcn,
                        None if residuals is None
                        else [residuals[r] for r in col])
        for d, r in enumerate(col):
            owned[r] = got[d]
            if res is not None:
                new_res[r] = res[d]
    return owned, (None if residuals is None else new_res)
