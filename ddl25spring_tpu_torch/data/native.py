"""ctypes binding of the native (C++) token pipeline: counterpart of the
JAX package's ``data/native.py``.

The engine is the checkout's ``native/tokenstream.cpp``: SentencePiece-
compatible encoding, sequence packing with skip offsets, and a producer
thread with a bounded prefetch ring, so tokenization overlaps the step.
``NativeTokenStream`` gives the batches of ``data.tokens.TokenStream`` (the
same shapes, skip and corpus rules).

The library is built on first use with ``g++`` and the flags of
``native/Makefile`` into the git-ignored ``build/native/`` at the root of
the checkout, named by a hash of the source and the flags, so an edited
source builds anew; nothing is written into ``native/``. A build holds a
file lock, so processes sharing the checkout build it once. If the build
fails, ``NativeBuildError`` says why: there is no fallback to the Python
stream (``native_available()`` reports which world this is).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np

from .tokens import _DEFAULT_CORPUS

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "tokenstream.cpp"
BUILD_DIR = ROOT / "build" / "native"
# native/Makefile's CXXFLAGS and link line.
CXXFLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra")
LDFLAGS = ("-shared",)
LIBS = ("-lpthread",)
_lib = None


class NativeBuildError(OSError):
    """The native token pipeline could not be built or loaded."""


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXXFLAGS + LDFLAGS + LIBS).encode())
    return BUILD_DIR / f"libtokenstream-{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    """One ``g++`` run into a temporary file, renamed into place."""
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXXFLAGS, *LDFLAGS, "-o", str(tmp), str(SOURCE), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise NativeBuildError(f"native tokenstream build failed to run "
                               f"({' '.join(cmd)}): {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(
            f"native tokenstream build failed ({' '.join(cmd)}):\n"
            f"{proc.stderr}")
    os.replace(tmp, path)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not SOURCE.exists():
        raise NativeBuildError(f"native tokenstream source {SOURCE} is "
                               "missing")
    path = library_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / "build.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not path.exists():
                _build(path)
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise NativeBuildError(f"native tokenstream library {path} does "
                               f"not load: {e}") from e
    lib.ts_create.restype = ctypes.c_void_p
    lib.ts_create.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_char_p, ctypes.c_uint64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int64, ctypes.c_int32,
    ]
    lib.ts_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
    lib.ts_encode.restype = ctypes.c_int64
    lib.ts_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
    ]
    lib.ts_batches_produced.restype = ctypes.c_int64
    lib.ts_batches_produced.argtypes = [ctypes.c_void_p]
    lib.ts_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def native_available() -> bool:
    """Whether the library builds and loads here."""
    try:
        _load()
        return True
    except NativeBuildError:
        return False


def _vocab_arrays(tokenizer) -> Tuple[bytes, np.ndarray, np.ndarray,
                                      np.ndarray, bool]:
    """A ``SentencePieceTokenizer``'s piece table as the (pieces blob,
    offsets, scores, types, is_bpe) arrays the C interface takes."""
    pieces: List[Tuple[str, float, int]] = tokenizer.pieces
    blobs = [p.encode("utf-8") for p, _, _ in pieces]
    offsets = np.zeros(len(blobs) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in blobs], out=offsets[1:])
    return (b"".join(blobs), offsets,
            np.asarray([s for _, s, _ in pieces], dtype=np.float32),
            np.asarray([t for _, _, t in pieces], dtype=np.int32),
            bool(tokenizer.is_bpe))


class NativeTokenStream:
    """``data.tokens.TokenStream``'s batches from the C++ engine: a
    ``SentencePieceTokenizer``'s pieces cross the C interface (another
    tokenizer raises ``TypeError``: use the Python stream). ``prefetch``
    batches are produced ahead on the engine's thread."""

    def __init__(self, tokenizer, batch_size: int, seq_len: int, *,
                 skip: int = 0, path: Optional[str] = None, seed: int = 0,
                 prefetch: int = 4):
        if not hasattr(tokenizer, "pieces"):
            raise TypeError("NativeTokenStream needs a SentencePieceTokenizer "
                            "(piece table); use data.tokens.TokenStream")
        lib = _load()
        self.batch_size = batch_size
        self.seq_len = seq_len
        blob, offsets, scores, types, is_bpe = _vocab_arrays(tokenizer)
        # The corpus the Python stream would read.
        corpus = b""
        for c in (path, os.environ.get("DDL_TINYSTORIES"), *_DEFAULT_CORPUS):
            if c and os.path.exists(c):
                corpus = os.path.abspath(c).encode()
                break
        self._lib = lib
        self._handle = lib.ts_create(
            blob, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            types.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(types), int(is_bpe), corpus, seed,
            batch_size, seq_len, skip, prefetch)
        # ts_create copies the arrays before it returns.
        del blob, offsets, scores, types

    def encode(self, text: str, *, add_bos: bool = False) -> List[int]:
        """The engine's encoding of ``text`` (``spm.py``'s ids)."""
        data = text.encode("utf-8")
        cap = max(4 * len(data) + 8, 64)
        out = np.empty(cap, dtype=np.int32)
        n = self._lib.ts_encode(
            self._handle, data, len(data), int(add_bos),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap)
        if n > cap:             # the engine says how much it needs
            out = np.empty(n, dtype=np.int32)
            n = self._lib.ts_encode(
                self._handle, data, len(data), int(add_bos),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n)
        return out[:n].tolist()

    def next_batch(self) -> np.ndarray:
        out = np.empty((self.batch_size, self.seq_len), dtype=np.int32)
        self._lib.ts_next(
            self._handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out

    def batches_produced(self) -> int:
        return int(self._lib.ts_batches_produced(self._handle))

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            yield self.next_batch()

    def close(self) -> None:
        """Free the engine (a second call does nothing)."""
        if self._handle:
            self._lib.ts_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
