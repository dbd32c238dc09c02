"""What holds the fused-Adam kernel back, on one CUDA card: each build of
``ops/csrc/adam.cu`` timed in turns with ``torch._fused_adam_`` on the 9
leaves of a training step.

    python -m ddl25spring_tpu_torch.adam_ab [--variants a,b,...] [--pairs 7]

The builds (``VARIANTS``) set the source's compile-time switch: one
grid-stride launch per leaf (the baseline), the persistent multi-leaf grid
with register-path loads, and the multi-leaf bulk-copy ring at 2, 3 and 4
stages. Each is compiled with the real libraries' nvcc flags into the
git-ignored ``build/adam_ab/`` (one nvcc each, all at once) and swapped in
under the real wrapper (``ops.pallas_adam._adam_leaves_pallas``). Each is
first held bitwise against the plain rule (``_leaf_plain``) on the leaves;
then each is timed against the library call in ``--pairs`` pairs of 100
calls (``bench_utils.kernel_time_us``), the order alternating from pair to
pair. Prints the card, each build's ptxas report, and one JSON line per
variant: both medians and ranges, the per-pair ratio, achieved TB/s against
the bound (28 bytes per element over 3.35 TB/s).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import statistics
import subprocess
import time

import torch

from .bench_utils import kernel_time_us
from .config import LlamaConfig
from .models import llama
from .ops import _ext
from .ops import pallas_adam as padam
from .ops.adam import bias_corrections
from .tree import tree_leaves

BUILD = _ext.BUILD_DIR.parent / "adam_ab"
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
VARIANTS = {
    "per-leaf grid-stride": ["-DDDL_ADAM_PER_LEAF"],
    "multi-leaf register path": ["-DDDL_ADAM_STAGES=0"],
    "multi-leaf bulk copy 2 stages": ["-DDDL_ADAM_STAGES=2"],
    "multi-leaf bulk copy 3 stages": ["-DDDL_ADAM_STAGES=3"],
    "multi-leaf bulk copy 4 stages": ["-DDDL_ADAM_STAGES=4"],
}
HYPER = dict(lr=8e-4, b1=0.9, b2=0.999, eps=1e-8)


def build(names) -> tuple:
    """{variant: ctypes.CDLL} and {variant: ptxas lines}."""
    shutil.rmtree(BUILD, ignore_errors=True)
    BUILD.mkdir(parents=True)
    procs = []
    for v in names:
        slug = re.sub(r"\W+", "_", v)
        out = BUILD / f"libadam_{slug}.so"
        cmd = [_ext._nvcc(), *_ext.NVCC_FLAGS, *VARIANTS[v], "-o", str(out),
               str(_ext._CSRC / "adam.cu")]
        procs.append((v, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs, ptxas = {}, {}
    for v, out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{v}: adam.cu failed to build\n{log}")
        ptxas[v] = [line.split(":", 1)[-1].strip() for line in log.splitlines()
                    if "Compiling entry" in line or "registers" in line]
        lib = ctypes.CDLL(str(out))
        for fn, (argtypes, restype) in _ext.KERNELS["adam"][1].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        libs[v] = lib
    return libs, ptxas


def kernel_leaf_shapes() -> list:
    """The shapes of the canonical model's leaves that take the kernel (9 at
    vocab 32000), in tree order."""
    shapes = [tuple(x.shape) for x in tree_leaves(llama.init_llama(
        LlamaConfig(), torch.Generator().manual_seed(0), device="cpu").tree())]
    return [s for s in shapes if padam._pallas_eligible(
        *[torch.empty(s, device="meta")] * 2)]


def random_leaves(shapes, dev, gen) -> list:
    """(p, m, v, g) of each shape: normal p and g, m at a tenth of that, v
    positive and small, as Adam's state is after a few steps."""
    leaves = []
    for shape in shapes:
        p, m, v, g = (torch.randn(shape, generator=gen, device=dev)
                      for _ in range(4))
        leaves.append((p, 0.1 * m, v.abs() * 0.01, g))
    return leaves


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated names from VARIANTS")
    ap.add_argument("--pairs", type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("adam_ab: needs a CUDA card")
    names = [v for v in args.variants.split(",") if v]
    card = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    print(card)
    t0 = time.perf_counter()
    libs, ptxas = build(names)
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for v in names:
        print(f"ptxas {v}: {ptxas[v]}")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    leaves = random_leaves(kernel_leaf_shapes(), dev, gen)
    n = sum(p.numel() for p, *_ in leaves)
    bound_us = 28 * n / HBM_BYTES_PER_S * 1e6
    c1, c2 = bias_corrections(torch.tensor(3, device=dev), 0.9, 0.999)
    corr = torch.stack([c1, c2])
    cols = [list(x) for x in zip(*leaves)]
    steps = [torch.tensor(3.0, device=dev) for _ in leaves]
    fused = lambda: torch._fused_adam_(
        cols[0], cols[3], cols[1], cols[2], [], steps, lr=HYPER["lr"],
        beta1=HYPER["b1"], beta2=HYPER["b2"], weight_decay=0.0,
        eps=HYPER["eps"], amsgrad=False, maximize=False)

    real = _ext.library
    try:
        bitwise = {}
        for v in names:
            _ext.library = lambda name, v=v: libs[v]
            want = [[x.clone() for x in leaf[:3]] for leaf in leaves]
            for (p, m, vv), g in zip(want, cols[3]):
                padam._leaf_plain(p, m, vv, g, c1, c2, **HYPER)
            got = [[x.clone() for x in leaf[:3]] for leaf in leaves]
            padam._adam_leaves_pallas(*map(list, zip(*got)), cols[3], corr,
                                      **HYPER)
            torch.cuda.synchronize()
            bitwise[v] = all(torch.equal(a, b) for ga, wa in zip(got, want)
                             for a, b in zip(ga, wa))
            if not bitwise[v]:
                raise RuntimeError(f"{v}: results differ from the plain rule")
        for v in names:
            _ext.library = lambda name, v=v: libs[v]
            kernel = lambda: padam._adam_leaves_pallas(*cols, corr, **HYPER)
            ks, fs = [], []
            for i in range(args.pairs):
                order = ((kernel, ks), (fused, fs))
                for fn, dst in (order if i % 2 == 0 else order[::-1]):
                    dst.append(kernel_time_us(fn, reps=100, burst=5))
            ratios = [k / f for k, f in zip(ks, fs)]
            k_med = statistics.median(ks)
            print(json.dumps({
                "variant": v, "card": card, "leaves": len(leaves),
                "elements": n, "bitwise_plain": bitwise[v],
                "pairs": args.pairs, "calls_per_side": 100,
                "kernel_median_us": k_med, "kernel_us": ks,
                "fused_adam_median_us": statistics.median(fs),
                "fused_adam_us": fs, "ratio_median": statistics.median(ratios),
                "ratio_spread": [min(ratios), max(ratios)],
                "tb_per_s": 28 * n / (k_med * 1e-6) / 1e12,
                "fused_adam_tb_per_s": 28 * n / (statistics.median(fs) * 1e-6)
                / 1e12,
                "bound_us": bound_us, "ptxas": ptxas[v]}))
    finally:
        _ext.library = real
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
