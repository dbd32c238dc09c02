"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``. The
sources include no PyTorch header, so a build takes seconds rather than
the minutes a ``torch.utils.cpp_extension`` build takes; the wrappers pass
``tensor.data_ptr()`` and the current stream as integers.

Builds happen at first use, never at import. Libraries go to
``build/kernels/`` at the root of the checkout (git-ignored), named by a
hash of the source, the shared headers (``csrc/*.cuh``) and the flags, so
an edited source or header is rebuilt and an unchanged one is loaded as
it is. ``build()`` starts one ``nvcc`` per
stale source, all at once, and waits for them together, holding a file
lock (``build/kernels/build.lock``, ``fcntl.flock``) so that processes
sharing the checkout, such as data-parallel ranks, build each library
once; the kernel releases the lock if its holder dies.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Iterator, Optional

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# name -> (source file, C functions with their ctypes signatures)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LP = ctypes.POINTER(ctypes.c_longlong)   # a host array of int64
KERNELS: Dict[str, tuple] = {
    "flash_fwd": ("flash_fwd.cu", {
        "ddl_flash_fwd": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _F,
                           _I, _P], _I),
    }),
    "flash_bwd": ("flash_bwd.cu", {
        "ddl_flash_bwd_dq": ([_P] * 7 + [_I] * 5 + [_P, _F, _I, _P], _I),
        "ddl_flash_bwd_dkv": ([_P] * 8 + [_I] * 5 + [_P, _F, _I, _P], _I),
    }),
    "adam": ("adam.cu", {
        "ddl_adam": ([_LP, _LP, _I, _P] + [_F] * 6 + [_P], _I),
        "ddl_adam_table_size": ([], _I),
        "ddl_adam_chunk": ([], _I),
    }),
}

NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-lineinfo", "--ptxas-options=-v", "-shared", "-Xcompiler",
              "-fPIC")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (neither on PATH nor under CUDA_HOME): "
                       "the port's CUDA kernels are built from source at "
                       "first use and need the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where kernel ``name``'s library lives: keyed by its source, every
    header in ``csrc/`` (a source may include any of them) and the flags."""
    h = hashlib.sha256((_CSRC / KERNELS[name][0]).read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


@contextlib.contextmanager
def _build_lock() -> Iterator[None]:
    """Hold ``BUILD_DIR/build.lock`` exclusively across processes."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _build_stale(names) -> None:
    """One ``nvcc`` per stale library of ``names``, all started together;
    raises with the compiler's output if any fails."""
    procs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(_CSRC / KERNELS[name][0])]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        out.with_suffix(".so.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)   # atomic: a concurrent loader sees all or none
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


def build(names: Optional[Iterable[str]] = None) -> float:
    """Compile every stale kernel library in ``names`` (default: all), one
    ``nvcc`` per source, all started together. Returns the wall seconds.
    Raises with the compiler's output if any build fails. ``ptxas``'s
    register and shared-memory report is kept beside each library as
    ``<library>.log``."""
    t0 = time.perf_counter()
    with _build_lock():
        _build_stale(list(KERNELS if names is None else names))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, (argtypes, restype) in KERNELS[name][1].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _loaded[name] = lib
        return lib

