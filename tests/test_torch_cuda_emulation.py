"""The port's CUDA flash kernels, from their sources, under a CPU emulation
of the CUDA features they use (``tests/cuda_emu/emu.h``): the sources
compile with the host's g++ and each case runs one kernel launch per
kernel against a float64 reference of the same function, in both operand
layouts, mixed layouts, ragged and unaligned lengths, padded head dims and
both types. This checks the kernels' indexing (tiles, fragments, masks,
staging paths) on the CPU; their timing, and the PTX they compile to, only
show on the card (``chip_smoke.py``)."""

import re
import shutil
import subprocess
from pathlib import Path

import pytest

from ddl25spring_tpu_torch.ops import _ext

EMU = Path(__file__).resolve().parent / "cuda_emu"
# Each header's inline-PTX helpers, which emu.h defines for the CPU.
PTX_HELPERS = {
    "mma_bf16.cuh": ("ldsm_x4", "ldsm_x4_trans", "mma_bf16", "fast_exp2",
                     "cp_async_16", "cp_async_4", "cp_async_commit",
                     "cp_async_wait"),
    "mma_tf32.cuh": ("mma_tf32",),
    "bulk_copy.cuh": ("evict_first_policy", "mbar_init", "mbar_init_fence",
                      "mbar_arrive", "mbar_arrive_expect_tx", "mbar_wait",
                      "bulk_load", "bulk_store", "bulk_commit",
                      "bulk_wait_read", "bulk_wait", "fence_proxy_async"),
}


def _prepare(src_dir: Path, out_dir: Path) -> None:
    """Copy the sources for the host compiler: headers lose the PTX
    helpers, ``kernel<<<grid, threads, smem, stream>>>(args)`` becomes
    ``emu_launch(grid, threads, smem, [&] { kernel(args); })``."""
    for path in src_dir.glob("*.cu*"):
        text = path.read_text()
        if path.suffix == ".cuh":
            for name in PTX_HELPERS[path.name]:
                text, n = re.subn(
                    r"(template <int N>\n)?__device__ __forceinline__ \w+ "
                    + name + r"\(.*?\n}\n", "", text, flags=re.S)
                assert n == 1, (path.name, name)
        else:
            text = re.sub(
                r"(\w+(?:<[^;<>]*>)?)<<<([^>]*)>>>\((.*?)\);",
                lambda m: "emu_launch(%s, [&] { %s(%s); });" % (
                    m.group(2).rsplit(",", 1)[0], m.group(1), m.group(3)),
                text, flags=re.S)
        (out_dir / path.name).write_text(text)
    for name in ("cuda_runtime.h", "cuda_bf16.h"):
        (out_dir / name).write_text("")


@pytest.fixture(scope="module")
def binaries(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the CPU emulation of the CUDA kernels")
    work = tmp_path_factory.mktemp("cuda_emu")
    _prepare(_ext._CSRC, work)
    # *_hi_only: the fp32 kernels with one TF32 product (hi * hi) per
    # 3xTF32 step, which the emulated tensor cores must show off fp32.
    procs = {}
    for name, flags in (("fwd", ["-DEMU_FWD"]), ("bwd", []),
                        ("fwd_hi_only", ["-DEMU_FWD", "-DDDL_TF32_HI_ONLY"]),
                        ("bwd_hi_only", ["-DDDL_TF32_HI_ONLY"])):
        out = work / f"emu_{name}"
        procs[name] = (out, subprocess.Popen(
            [gxx, "-std=c++20", "-O1", "-fsanitize=address",
             "-Wno-unknown-pragmas", *flags, "-I", str(work), "-include",
             str(EMU / "emu.h"), "-o", str(out), str(EMU / "emu_main.cpp"),
             "-lpthread"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    built = {}
    for name, (out, proc) in procs.items():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-4000:]
        built[name] = out
    return built


def _run(binary: Path, *args) -> None:
    proc = subprocess.run([str(binary), *map(str, args)],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-4000:]


# (T, Dh, bf16, layout q, k, v, out, offset, causal): layout 0 row-major,
# 1 dh-major; offset misaligns q and v (element staging). dh-major T=100
# has rows of 200 bytes, which take the element staging path too.
FWD_CASES = [
    (100, 48, 1, 0, 0, 0, 0, 0, 1),
    (100, 48, 1, 1, 1, 1, 1, 0, 1),
    (200, 48, 1, 1, 1, 1, 1, 0, 0),
    (200, 48, 1, 0, 1, 0, 1, 0, 1),
    (64, 48, 1, 1, 0, 1, 0, 1, 1),
    (100, 40, 1, 0, 0, 0, 0, 0, 0),
    (100, 44, 1, 1, 1, 1, 0, 0, 1),
    (130, 128, 1, 1, 1, 1, 1, 0, 1),
    # fp32 (3xTF32 on the emulated tensor cores), the same coverage, Dh 16
    # and 64, and one long row: the last rows of T=512 sum 512 keys over 8
    # tiles of the truncating tensor-core sums.
    (100, 48, 0, 1, 1, 1, 1, 0, 1),
    (100, 48, 0, 0, 0, 0, 0, 0, 1),
    (200, 48, 0, 1, 1, 1, 1, 0, 0),
    (200, 48, 0, 0, 1, 0, 1, 0, 1),
    (64, 48, 0, 1, 0, 1, 0, 1, 1),
    (100, 40, 0, 0, 0, 0, 0, 0, 0),
    (100, 44, 0, 1, 1, 1, 0, 0, 1),
    (130, 128, 0, 1, 1, 1, 1, 0, 1),
    (100, 16, 0, 0, 0, 0, 0, 0, 1),
    (100, 64, 0, 0, 1, 0, 1, 0, 1),
    (512, 48, 0, 1, 1, 1, 1, 0, 1),
]


@pytest.mark.parametrize("case", FWD_CASES)
def test_flash_fwd_kernel_under_emulation(binaries, case):
    _run(binaries["fwd"], *case)


# (T, Dh, bf16, layout q, k, v, dk, offset, causal, layout dO, layout dq,
# dq offset). The dq offset misaligns dq (the epilogue's element stores);
# a dh-major dO, or q, k, v in different layouts, take the kernels'
# instantiation that reads every layout at run time.
BWD_CASES = [
    (100, 48, 1, 0, 0, 0, 0, 0, 1, 0, 0, 0),
    (100, 48, 1, 1, 1, 1, 0, 0, 1, 0, 0, 0),
    (200, 48, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0),
    (200, 48, 1, 0, 1, 0, 1, 0, 1, 1, 0, 0),
    (64, 48, 1, 1, 0, 1, 0, 1, 1, 0, 0, 0),
    (100, 40, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0),
    (100, 44, 1, 1, 1, 1, 0, 0, 1, 1, 0, 0),
    (130, 128, 1, 1, 1, 1, 1, 0, 1, 0, 0, 0),
    (100, 48, 0, 1, 1, 1, 1, 0, 1, 0, 0, 0),
    (128, 48, 1, 1, 1, 1, 0, 0, 1, 0, 1, 0),
    (100, 48, 1, 0, 0, 0, 0, 0, 1, 0, 0, 1),
    (100, 16, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0),
    (200, 48, 1, 1, 0, 1, 0, 1, 1, 1, 1, 1),
    # fp32 (3xTF32 on the emulated tensor cores), the same coverage.
    (100, 48, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0),
    (100, 48, 0, 1, 1, 1, 0, 0, 1, 0, 0, 0),
    (200, 48, 0, 1, 1, 1, 1, 0, 0, 0, 0, 0),
    (200, 48, 0, 0, 1, 0, 1, 0, 1, 1, 0, 0),
    (64, 48, 0, 1, 0, 1, 0, 1, 1, 0, 0, 0),
    (100, 40, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0),
    (100, 44, 0, 1, 1, 1, 0, 0, 1, 1, 0, 0),
    (130, 128, 0, 1, 1, 1, 1, 0, 1, 0, 0, 0),
    (64, 100, 0, 1, 1, 1, 1, 0, 1, 0, 0, 0),
    (100, 64, 0, 0, 1, 0, 1, 0, 1, 0, 0, 0),
    (128, 48, 0, 1, 1, 1, 0, 0, 1, 0, 1, 0),
    (100, 48, 0, 0, 0, 0, 0, 0, 1, 0, 0, 1),
    (100, 16, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0),
    (200, 48, 0, 1, 0, 1, 0, 1, 1, 1, 1, 1),
]


@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_bwd_kernels_under_emulation(binaries, case):
    _run(binaries["bwd"], *case)


def test_flash_fwd_fp32_needs_the_lo_products(binaries):
    """With one TF32 product per step (no lo parts) the fp32 forward's
    output misses the 1e-4 limit that 3xTF32 holds."""
    proc = subprocess.run(
        [str(binaries["fwd_hi_only"]),
         *map(str, (100, 48, 0, 1, 1, 1, 1, 0, 1))],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1, proc.stdout + proc.stderr[-4000:]
    line = next(x for x in proc.stdout.splitlines() if x.startswith("out "))
    assert line.endswith("MISS"), proc.stdout


def test_flash_bwd_fp32_needs_the_lo_products(binaries):
    """With one TF32 product per step (no lo parts) every fp32 gradient
    misses the 1e-4 limit that 3xTF32 holds: the emulation models the
    tensor cores' TF32 operands."""
    proc = subprocess.run(
        [str(binaries["bwd_hi_only"]),
         *map(str, (100, 48, 0, 1, 1, 1, 0, 0, 1, 0, 0, 0))],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1, proc.stdout + proc.stderr[-4000:]
    for name in ("dq", "dk", "dv"):
        line = next(x for x in proc.stdout.splitlines()
                    if x.startswith(name + " "))
        assert line.endswith("MISS"), proc.stdout
