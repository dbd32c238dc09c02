"""The port's fused-Adam kernel (``ops/csrc/adam.cu``), from its source,
under the CPU emulation of the CUDA features it uses
(``tests/cuda_emu/emu.h``): the source compiles with the host's g++ in each
of its builds (the bulk-copy ring at 4, 3 and 2 stages, the register path,
one grid per leaf), and each case runs one ``ddl_adam`` call over a ragged
table of leaves (``tests/cuda_emu/emu_adam.cpp``), holding every p, m and v
element bitwise against a float reference of the same operations in the
same order, the guard elements around every array untouched, and the
launch count. This is where the kernel's chunk-to-leaf mapping and its ring
of stages (mbarrier parity across wraps, short last chunks, stores waited
for before a stage is reloaded) run on the CPU; its speed, and the PTX it
compiles to, only show on the card (``chip_smoke.py`` phase 3c)."""

import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

import pytest

from ddl25spring_tpu_torch.ops import _ext
from test_torch_cuda_emulation import EMU, _prepare

# build name -> the compile-time switch of adam.cu it sets
BUILDS = {
    "bulk4": [],
    "bulk3": ["-DDDL_ADAM_STAGES=3"],
    "bulk2": ["-DDDL_ADAM_STAGES=2"],
    "register": ["-DDDL_ADAM_STAGES=0"],
    "per_leaf": ["-DDDL_ADAM_PER_LEAF"],
}

# (SMs, blocks per SM, leaf sizes): "c" counts from the build's chunk.
CASES = {
    # One leaf of 65,536 + 512 elements through one block: 65 chunks (33 in
    # the register build) wrap the ring of stages many times.
    "one leaf, one block": (1, 1, ["66048"]),
    # Phase 3c's ragged table: the smallest leaf, one lane row, a leaf just
    # past the kernel's threshold, and a chunk less and more than 512.
    "ragged table": (2, 2, ["4", "512", "66048", "c-512", "c+512", "c", "8"]),
    # More leaves than a launch's table holds: two launches.
    "two tables": (3, 1, ["4", "512", "c+512", "8", "c-512", "1028"] * 8
                   + ["c", "4"]),
    # A grid of more blocks than chunks.
    "grid wider than the work": (64, 4, ["4", "c+4"]),
}


@pytest.fixture(scope="module")
def binaries(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the CPU emulation of the CUDA kernels")
    work = tmp_path_factory.mktemp("adam_emu")
    _prepare(_ext._CSRC, work)

    def build(item):
        name, flags = item
        out = work / f"emu_adam_{name}"
        proc = subprocess.run(
            [gxx, "-std=c++20", "-O1", "-fsanitize=address",
             "-ffp-contract=off", "-Wno-unknown-pragmas", *flags, "-I",
             str(work), "-include", str(EMU / "emu.h"), "-o", str(out),
             str(EMU / "emu_adam.cpp"), "-lpthread"],
            capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, (name, proc.stderr[-4000:])
        return name, out

    with ThreadPoolExecutor(len(BUILDS)) as pool:
        return dict(pool.map(build, BUILDS.items()))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("build", BUILDS)
def test_adam_kernel_under_emulation(binaries, build, case):
    sms, per_sm, sizes = CASES[case]
    proc = subprocess.run([str(binaries[build]), str(sms), str(per_sm),
                           *sizes], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-4000:]
    assert proc.stdout.rstrip().endswith(" ok"), proc.stdout
