"""The port's native token pipeline (``data/native.py``, the checkout's
``native/tokenstream.cpp`` built with g++ into ``build/native/``) against
the port's Python stream (``data/tokens.py`` with ``tokenizers/spm.py``)
and against the JAX package's ``NativeTokenStream``, as JAX's
``tests/test_native.py`` holds its own: the same piece table and corpus
give the same encodings and the same packed batches, skip included; the
producer runs ahead of the consumer; ``close`` twice is harmless."""

import time
from pathlib import Path

import numpy as np
import pytest

from ddl25spring_tpu.data.native import NativeTokenStream as JaxNativeStream
from ddl25spring_tpu.tokenizers.spm import \
    SentencePieceTokenizer as JaxSentencePieceTokenizer
from ddl25spring_tpu_torch.data import native
from ddl25spring_tpu_torch.data.native import (NativeBuildError,
                                               NativeTokenStream,
                                               native_available)
from ddl25spring_tpu_torch.data.tokens import TokenStream
from ddl25spring_tpu_torch.tokenizers.spm import (_BYTE, _CONTROL, _NORMAL,
                                                  _UNKNOWN,
                                                  SentencePieceTokenizer)

ROOT = Path(__file__).resolve().parents[1]


def _toy_pieces():
    """A tiny vocab exercising merges, byte fallback and specials (JAX's
    ``tests/test_native.py`` table)."""
    pieces = [("<unk>", 0.0, _UNKNOWN), ("<s>", 0.0, _CONTROL),
              ("</s>", 0.0, _CONTROL)]
    words = ["▁the", "▁cat", "▁dog", "▁sat", "▁on", "▁mat", "▁a", "the",
             "cat", "▁", "c", "a", "t", "s", "o", "n", "h", "e", "d", "g",
             "m", "▁ca", "at", "▁th", "▁sa", "▁o", "▁m", "▁d"]
    for i, w in enumerate(words):
        pieces.append((w, -float(i + 1) / 4.0, _NORMAL))
    for b in range(256):
        pieces.append((f"<0x{b:02X}>", 0.0, _BYTE))
    return pieces


TEXTS = ["the cat sat on the mat", "a dog", "cats and dogs", "héllo wörld",
         "", "   spaces   galore "]


@pytest.fixture(scope="module", params=[False, True], ids=["unigram", "bpe"])
def tokenizers(request):
    """(port tokenizer, JAX tokenizer) on the same piece table."""
    return (SentencePieceTokenizer.from_pieces(_toy_pieces(),
                                               is_bpe=request.param),
            JaxSentencePieceTokenizer.from_pieces(_toy_pieces(),
                                                  is_bpe=request.param))


def test_library_builds_under_build_and_writes_nothing_in_native():
    """The port builds the checkout's source into ``build/native/`` under
    its own hashed name; nothing of its build lands in ``native/`` (where
    the JAX package's ``make`` writes its own library)."""
    assert native_available()
    path = native.library_path()
    assert path.exists() and path.parent == ROOT / "build" / "native"
    assert path.name.startswith("libtokenstream-")
    assert native.SOURCE == ROOT / "native" / "tokenstream.cpp"
    assert not [p for p in (ROOT / "native").iterdir()
                if p.name.startswith("libtokenstream-")]


def test_encode_parity(tokenizers):
    py, jpy = tokenizers
    nat = NativeTokenStream(py, batch_size=2, seq_len=16, seed=3)
    jnat = JaxNativeStream(jpy, batch_size=2, seq_len=16, seed=3)
    for text in TEXTS:
        for bos in (True, False):
            got = nat.encode(text, add_bos=bos)
            assert got == py.encode(text, add_bos=bos), text
            assert got == jnat.encode(text, add_bos=bos), text
    nat.close()
    jnat.close()


def test_batch_parity_on_corpus(tmp_path, tokenizers):
    """Same corpus file: bitwise the same packed batches as the port's
    Python stream and as JAX's native stream, skip included."""
    py, jpy = tokenizers
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("the cat sat on the mat\na dog sat\nthe mat\n" * 5)
    kw = dict(batch_size=2, seq_len=16, skip=3, path=str(corpus))
    py_stream = iter(TokenStream(py, **kw))
    nat = NativeTokenStream(py, **kw)
    jnat = JaxNativeStream(jpy, **kw)
    for _ in range(5):
        got = nat.next_batch()
        assert got.shape == (2, 16) and got.dtype == np.int32
        np.testing.assert_array_equal(got, next(py_stream))
        np.testing.assert_array_equal(got, jnat.next_batch())
    nat.close()
    jnat.close()


def test_synthetic_batches_are_jax_and_deterministic(tokenizers):
    py, jpy = tokenizers
    a = NativeTokenStream(py, batch_size=3, seq_len=24, seed=7)
    b = NativeTokenStream(py, batch_size=3, seq_len=24, seed=7)
    j = JaxNativeStream(jpy, batch_size=3, seq_len=24, seed=7)
    ba = a.next_batch()
    assert ba.shape == (3, 24) and ba.dtype == np.int32
    np.testing.assert_array_equal(ba, b.next_batch())
    np.testing.assert_array_equal(ba, j.next_batch())
    for s in (a, b, j):
        s.close()


def test_prefetch_runs_ahead_and_close_twice(tokenizers):
    py, _ = tokenizers
    nat = NativeTokenStream(py, batch_size=2, seq_len=16, prefetch=4)
    assert nat.next_batch().shape == (2, 16)
    deadline = time.time() + 5.0
    while nat.batches_produced() < 3 and time.time() < deadline:
        time.sleep(0.01)
    assert nat.batches_produced() >= 3       # ahead of the one consumed
    nat.close()
    assert nat._handle is None
    nat.close()                              # a second close does nothing
    nat.__del__()                            # nor does finalization


def test_other_tokenizers_are_refused():
    from ddl25spring_tpu_torch.tokenizers import ByteTokenizer
    with pytest.raises(TypeError, match="SentencePieceTokenizer"):
        NativeTokenStream(ByteTokenizer(), batch_size=1, seq_len=4)


def test_a_failed_build_raises_a_named_error(monkeypatch, tmp_path):
    """No silent fallback: a source that does not compile raises
    ``NativeBuildError`` with the compiler's message, and
    ``native_available`` says False."""
    bad = tmp_path / "tokenstream.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(NativeBuildError, match="build failed"):
        native._load()
    assert not native_available()
