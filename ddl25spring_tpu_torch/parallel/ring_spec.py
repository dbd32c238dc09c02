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


def int8_encode(c: np.ndarray) -> Tuple[np.ndarray, np.float32, np.ndarray]:
    """``(q, s, c − s·q)``: symmetric int8 quantization around max|c|."""
    m = np.max(np.abs(c)).astype(F32)
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
    n = len(xs)
    if n == 1:
        return [np.asarray(xs[0], F32)], (None if residuals is None
                                          else [np.asarray(residuals[0])])
    chunk = len(xs[0]) // n
    chunks = [np.asarray(x, F32).reshape(n, chunk) for x in xs]
    res = (None if residuals is None else
           [np.asarray(r, F32).reshape(n, chunk).copy() for r in residuals])
    partial = [chunks[r][(r - 1) % n].copy() for r in range(n)]
    for t in range(n - 1):
        sent = []
        for r in range(n):
            c_idx = (r - 1 - t) % n
            if wire == "int8_ef":
                c = (partial[r] + res[r][c_idx]).astype(F32)
                q, s, err = int8_encode(c)
                res[r][c_idx] = err
                sent.append((s, q))
            elif wire == "bf16":
                sent.append(to_bf16(partial[r]))
            else:
                sent.append(partial[r])
        partial = [fma(chunks[r][(r - 2 - t) % n], *sent[(r - 1) % n])
                   if wire == "int8_ef" else
                   (sent[(r - 1) % n] + chunks[r][(r - 2 - t) % n])
                   .astype(F32) for r in range(n)]
    return partial, (None if res is None else [x.reshape(-1) for x in res])


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
