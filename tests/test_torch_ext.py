"""The port's kernel build keys (``ops/_ext.py``) on the CPU: a library's
path follows its source, every shared header in ``csrc/`` and the flags,
so an edited header never leaves a stale library loaded."""

import re
import shutil

import pytest

from ddl25spring_tpu_torch.ops import _ext


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A private copy of ``csrc/`` that ``_ext`` reads instead."""
    copy = tmp_path / "csrc"
    shutil.copytree(_ext._CSRC, copy)
    monkeypatch.setattr(_ext, "_CSRC", copy)
    return copy


def _paths():
    return {name: _ext.library_path(name) for name in _ext.KERNELS}


def test_editing_a_header_changes_every_library_path(csrc):
    before = _paths()
    header = csrc / "mma_bf16.cuh"
    text = header.read_text()
    header.write_text(text + "\n// edited\n")
    edited = _paths()
    assert all(edited[n] != before[n] for n in before)
    header.write_text(text)
    assert _paths() == before


def test_editing_a_source_changes_only_its_library_path(csrc):
    before = _paths()
    src = csrc / _ext.KERNELS["flash_fwd"][0]
    src.write_text(src.read_text() + "\n// edited\n")
    after = _paths()
    assert after["flash_fwd"] != before["flash_fwd"]
    assert {n: p for n, p in after.items() if n != "flash_fwd"} == \
        {n: p for n, p in before.items() if n != "flash_fwd"}


def test_a_new_header_changes_the_paths(csrc):
    before = _paths()
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert all(p != before[n] for n, p in _paths().items())


def test_every_quoted_include_is_a_header_in_csrc():
    """Sources include headers by a path relative to ``csrc/``, so the
    headers the key hashes are the ones nvcc reads."""
    for name, (source, _) in _ext.KERNELS.items():
        text = (_ext._CSRC / source).read_text()
        for inc in re.findall(r'#include "([^"]+)"', text):
            assert (_ext._CSRC / inc).is_file() and inc.endswith(".cuh"), \
                (name, inc)
