"""Self-contained SentencePiece tokenizer: the port's own copy of the JAX
package's ``tokenizers/spm.py`` (pure Python, no framework imports).

Capability target: simplellm's `SPTokenizer` surface — ``.vocab_size``,
``.pad_id``, encode/decode — backed by the vendored Llama SentencePiece model
(reference: lab/requirements.txt:9, lab/llama-tokenizer.model; log evidence
lab/out_b1_0.txt:1-4). The `sentencepiece` wheel is not available in this
image, so this module reads the ``.model`` file directly: it is a protobuf
(ModelProto) whose field 1 is the repeated (piece, score, type) vocabulary,
and unigram segmentation is a Viterbi pass over those scores.

No external deps: a ~60-line protobuf wire-format reader + Viterbi encoder +
byte-fallback. A `ByteTokenizer` stands in when no model file is present
(zero-egress containers), keeping every downstream pipeline runnable.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional, Tuple

# SentencePiece piece types (ModelProto.SentencePiece.Type)
_NORMAL, _UNKNOWN, _CONTROL, _USER_DEFINED, _BYTE, _UNUSED = 1, 2, 3, 4, 6, 5
_WS = "▁"  # the ▁ whitespace marker


# ------------------------------------------------------------ protobuf reader

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a protobuf message body."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:      # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:    # 64-bit
            val = buf[pos:pos + 8]; pos += 8
        elif wire == 2:    # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]; pos += ln
        elif wire == 5:    # 32-bit
            val = buf[pos:pos + 4]; pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def parse_model_proto(data: bytes) -> Tuple[List[Tuple[str, float, int]], int]:
    """Extract ([(piece, score, type), ...], model_type) from a SentencePiece
    ModelProto. model_type: 1=unigram, 2=bpe (TrainerSpec.model_type)."""
    pieces = []
    model_type = 1
    for field, wire, val in _iter_fields(data):
        if field == 1 and wire == 2:  # repeated SentencePiece pieces
            piece, score, ptype = "", 0.0, _NORMAL
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1:
                    piece = v2.decode("utf-8")
                elif f2 == 2:
                    score = struct.unpack("<f", v2)[0]
                elif f2 == 3:
                    ptype = v2
            pieces.append((piece, score, ptype))
        elif field == 2 and wire == 2:  # TrainerSpec
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 3 and w2 == 0:  # model_type enum
                    model_type = v2
    return pieces, model_type


# ------------------------------------------------------------ tokenizers

class SentencePieceTokenizer:
    """Unigram-model tokenizer with byte fallback (Llama convention)."""

    def __init__(self, model_path: str):
        with open(model_path, "rb") as f:
            pieces, model_type = parse_model_proto(f.read())
        self._setup(pieces, model_type == 2)

    @classmethod
    def from_pieces(cls, pieces: List[Tuple[str, float, int]], *,
                    is_bpe: bool = False) -> "SentencePieceTokenizer":
        """Build from an in-memory (piece, score, type) table — used by tests
        and by the native-pipeline parity harness."""
        self = cls.__new__(cls)
        self._setup(pieces, is_bpe)
        return self

    def _setup(self, pieces: List[Tuple[str, float, int]], is_bpe: bool) -> None:
        self.pieces = pieces
        self.is_bpe = is_bpe
        self.vocab_size = len(pieces)
        self._piece_to_id: Dict[str, int] = {}
        self._byte_to_id: Dict[int, int] = {}
        self.unk_id = 0
        self.bos_id = -1
        self.eos_id = -1
        for i, (piece, score, ptype) in enumerate(pieces):
            if ptype == _BYTE:
                # pieces look like "<0x0A>"
                self._byte_to_id[int(piece[1:-1], 16)] = i
            elif ptype == _UNKNOWN:
                self.unk_id = i
            elif ptype == _CONTROL:
                if piece == "<s>":
                    self.bos_id = i
                elif piece == "</s>":
                    self.eos_id = i
            else:
                self._piece_to_id[piece] = i
        # Llama's SP model has no pad piece; simplellm uses unk as pad. Keep
        # pad_id distinct-but-valid: eos if present else unk.
        self.pad_id = self.eos_id if self.eos_id >= 0 else self.unk_id
        self._scores = [score for _, score, _ in pieces]
        self._max_piece_len = max((len(p) for p, _, t in pieces if t == _NORMAL), default=1)

    def encode(self, text: str, *, add_bos: bool = False) -> List[int]:
        """Segment text: BPE greedy-merge for BPE models (the Llama tokenizer
        stores score = -merge_rank), Viterbi max-score for unigram models."""
        s = _WS + text.replace(" ", _WS)
        if self.is_bpe:
            ids = self._encode_bpe(s)
        else:
            ids = self._encode_unigram(s)
        if add_bos and self.bos_id >= 0:
            ids.insert(0, self.bos_id)
        return ids

    def _fallback_ids(self, piece: str) -> List[int]:
        """Byte-fallback for a substring not in the vocab."""
        bs = piece.encode("utf-8")
        if all(b in self._byte_to_id for b in bs):
            return [self._byte_to_id[b] for b in bs]
        return [self.unk_id]

    def _encode_bpe(self, s: str) -> List[int]:
        """SentencePiece-BPE: start from characters, repeatedly merge the
        adjacent pair whose concatenation is the best-scored vocab piece."""
        import heapq

        parts: List[str] = list(s)
        if not parts:
            return []
        # Doubly-linked list over parts; heap of candidate merges.
        nxt = list(range(1, len(parts))) + [-1]
        prv = [-1] + list(range(len(parts) - 1))
        alive = [True] * len(parts)
        heap: List[Tuple[float, int, int]] = []

        def push(i: int):
            j = nxt[i]
            if j == -1:
                return
            pid = self._piece_to_id.get(parts[i] + parts[j])
            if pid is not None:
                heapq.heappush(heap, (-self._scores[pid], i, j))

        for i in range(len(parts) - 1):
            push(i)
        while heap:
            negscore, i, j = heapq.heappop(heap)
            if not (alive[i] and alive[j]) or nxt[i] != j:
                continue  # stale entry
            parts[i] = parts[i] + parts[j]
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[j] != -1:
                prv[nxt[j]] = i
            if prv[i] != -1:
                push(prv[i])
            push(i)
        ids: List[int] = []
        i = 0
        while i != -1:
            if alive[i]:
                pid = self._piece_to_id.get(parts[i])
                ids.extend([pid] if pid is not None else self._fallback_ids(parts[i]))
            i = nxt[i]
        return ids

    def _encode_unigram(self, s: str) -> List[int]:
        """Viterbi segmentation maximizing total piece score (unigram LM)."""
        n = len(s)
        NEG = -1e18
        best = [NEG] * (n + 1)
        back: List[Optional[Tuple[int, int]]] = [None] * (n + 1)  # (start, id)
        best[0] = 0.0
        unk_penalty = min(self._scores) - 10.0 if self._scores else -20.0
        for end in range(1, n + 1):
            lo = max(0, end - self._max_piece_len)
            for start in range(lo, end):
                if best[start] <= NEG / 2:
                    continue
                pid = self._piece_to_id.get(s[start:end])
                if pid is not None:
                    sc = best[start] + self._scores[pid]
                    if sc > best[end]:
                        best[end], back[end] = sc, (start, pid)
            # unk/byte fallback: single char from best[end-1]
            if back[end] is None and best[end - 1] > NEG / 2:
                best[end], back[end] = best[end - 1] + unk_penalty, (end - 1, -1)
        ids: List[int] = []
        pos = n
        while pos > 0:
            start, pid = back[pos]
            if pid >= 0:
                ids.append(pid)
            else:
                ch = s[start:pos]
                bs = ch.encode("utf-8")
                if all(b in self._byte_to_id for b in bs):
                    ids.extend(self._byte_to_id[b] for b in reversed(bs))
                else:
                    ids.append(self.unk_id)
            pos = start
        ids.reverse()
        return ids

    def decode(self, ids: List[int]) -> str:
        out: List[str] = []
        byte_buf: List[int] = []
        inv_bytes = {v: k for k, v in self._byte_to_id.items()}

        def flush():
            if byte_buf:
                out.append(bytes(byte_buf).decode("utf-8", errors="replace"))
                byte_buf.clear()

        for i in ids:
            piece, _, ptype = self.pieces[i]
            if ptype == _BYTE:
                byte_buf.append(inv_bytes[i])
                continue
            flush()
            if ptype in (_CONTROL, _UNKNOWN):
                continue
            out.append(piece)
        flush()
        text = "".join(out).replace(_WS, " ")
        # Remove exactly the one dummy-prefix space encode() added — real
        # SentencePiece semantics; lstrip would eat genuine leading spaces.
        return text[1:] if text.startswith(" ") else text


class ByteTokenizer:
    """Offline fallback: UTF-8 bytes + specials; same interface."""

    def __init__(self):
        self.vocab_size = 259
        self.pad_id = 256
        self.bos_id = 257
        self.eos_id = 258
        self.unk_id = 256

    def encode(self, text: str, *, add_bos: bool = False) -> List[int]:
        ids = list(text.encode("utf-8"))
        return ([self.bos_id] + ids) if add_bos else ids

    def decode(self, ids: List[int]) -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8", errors="replace")


_DEFAULT_PATHS = (
    "data/llama-tokenizer.model",
)


def load_tokenizer(model_path: Optional[str] = None):
    """Load the SentencePiece model if one can be found, else ByteTokenizer.

    Search order: explicit arg, $DDL_TOKENIZER_MODEL, ./data/. Falls back
    to bytes so zero-asset environments still run.
    """
    candidates = [model_path, os.environ.get("DDL_TOKENIZER_MODEL"), *_DEFAULT_PATHS]
    for c in candidates:
        if c and os.path.exists(c):
            return SentencePieceTokenizer(c)
    return ByteTokenizer()
