"""What holds the flash kernels back, on one CUDA card: variants of the
forward, dQ and dK/dV kernels timed against the kernels as they are.

    python -m ddl25spring_tpu_torch.flash_ab [--dtype bf16|fp32]
        [--variants a,b,...] [--dh 48] [--baseline DIR] [--trainer]

Each variant is a copy of ``ops/csrc`` with a few lines patched, built with
the same nvcc flags as the real libraries (only the ``--dh`` instantiation,
so a build takes seconds) into the git-ignored ``build/flash_ab/``, and
swapped in under the real wrappers. ``--baseline DIR`` adds DIR (another
checkout's ``ops/csrc``, e.g. a parent commit unpacked with ``git
archive``) as the variant "baseline", built the same way. Every variant is timed on the
same inputs with ``bench_utils.kernel_time_us``, in two rounds in opposite
orders, on one card: bf16 at the training shape (B=64 T=256 H=6 Dh=48
dh-major, causal) and at B=8; fp32 (the 3xTF32 forward, dQ and dK/dV) at
B=8 and at the trainer's B=3, dh-major, and at B=8 row-major. Variants that
keep the arithmetic are held bitwise against the kernels as they are; the
diagnostics, which skip work, are not; every fp32 variant is held within
1e-4 of the plain version (out, lse and the gradients). Prints one line per
variant and shape, then one JSON line.

The bf16 variants (``VARIANTS``): each design choice undone (each kernel's
layout read at run time, the forward's and dQ's K and V in one copy group,
the libm ``exp2f``, no register cap), two diagnostics that time part of the
work (no tile loads after the first, one tile per CTA), and changes that
were tried and measured slower. The fp32 variants (``VARIANTS_FP32``): the
forward's registers left to ptxas (no launch bound), and its numerics:
64-key steps instead of 32,
the O update as one fmaf instead of two roundings, the softmax exponent as
the backward forms it, alone and together; the backward's tile height, where its held
fragments' lo parts come from, and its step of streamed positions; the
libm exponential; and TF32 hi parts rounded to nearest instead of
truncated. ``--baseline`` with a parent's ``ops/csrc`` times the kernels
that this tree replaced (the fp32 FMA forward before the 3xTF32 one).

``--trainer`` (fp32) then runs ``chip_smoke.py`` phase 16f's trainers
(``parallel.programs``: ``TRAIN_16F`` at a world of one, ``trainer_pair``
on two ranks) with each variant whose results are not bitwise the kernels
as built (and the baseline), and prints 16f's two comparisons. Their
step-9 loss spike moves with the last bits of the attention, so this shows
where each build lands against 16f's limits.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from .bench_utils import kernel_time_us
from .ops import _ext
from .ops import flash_attention as fa

BUILD = _ext.BUILD_DIR.parent / "flash_ab"
FWD, BWD = "flash_fwd.cu", "flash_bwd.cu"

# name -> [(source file, text, replacement)], applied to the current sources.
VARIANTS = {
    "as built": [],
    # Design choices, each undone.
    "forward: layout at run time": [
        (FWD, "const int layout = (md.k & kDhMajor) == lq && (md.v & kDhMajor) == lq ? lq "
              ": kAnyLayout;", "const int layout = kAnyLayout;")],
    "dQ: layout at run time": [
        (BWD, "switch (layout_of(md)) {\n    case 0: return launch_dq_mma_l",
         "switch (kAnyLayout) {\n    case 0: return launch_dq_mma_l")],
    "dK/dV: layout at run time": [
        (BWD, "switch (layout_of(md)) {\n    case 0: return launch_dkv_mma_l",
         "switch (kAnyLayout) {\n    case 0: return launch_dkv_mma_l")],
    "forward: K and V in one copy group": [
        (FWD, """  cp_async_commit();
  stage_tile<DP, kMmaThreads>(vs, vb, sv, md.v, 0, seq, dh);""", """
  stage_tile<DP, kMmaThreads>(vs, vb, sv, md.v, 0, seq, dh);"""),
        (FWD, """    }
    cp_async_commit();
    if (kt + 1 < n_k) {
      stage_tile<DP, kMmaThreads>(vs""", """      stage_tile<DP, kMmaThreads>(vs"""),
        (FWD, "    cp_async_wait<3>();", "    cp_async_wait<1>();"),
        (FWD, "    cp_async_wait<2>();   // V of this tile\n    __syncthreads();\n", "")],
    "dQ: K and V in one copy group": [
        (BWD, """  stage_tile<DP, kMmaThreads>(ks, kb, sk, md.k, 0, seq, dh);
  cp_async_commit();""", """  stage_tile<DP, kMmaThreads>(ks, kb, sk, md.k, 0, seq, dh);"""),
        (BWD, """    }
    cp_async_commit();
    if (kt + 1 < n_k) {
      stage_tile<DP, kMmaThreads>(vs""", """      stage_tile<DP, kMmaThreads>(vs"""),
        (BWD, "    cp_async_wait<3>();", "    cp_async_wait<1>();"),
        (BWD, """      if (sub == 0) {
        cp_async_wait<2>();   // V of this tile
        __syncthreads();
      }
""", "")],
    "libm exp2f": [(FWD, "fast_exp2(", "exp2f("), (BWD, "fast_exp2(", "exp2f(")],
    "no register cap": [
        (FWD, "__launch_bounds__(kMmaThreads, DP <= 64 ? 4 : 1)",
         "__launch_bounds__(kMmaThreads)"),
        (BWD, "__launch_bounds__(kMmaThreads, DP <= 64 ? 4 : 1)",
         "__launch_bounds__(kMmaThreads)"),
        (BWD, "__launch_bounds__(kMmaThreads, DP <= 64 ? 3 : 1)",
         "__launch_bounds__(kMmaThreads)")],
    # Diagnostics (wrong results): the loop without the loads of the tiles
    # after the first, and each CTA's first tile only.
    "no later loads": [
        (FWD, "if (kt + 1 < n_k) {\n      stage_tile", "if (false) {\n      stage_tile"),
        (BWD, "if (kt + 1 < n_k) {\n      stage_tile", "if (false) {\n      stage_tile"),
        (BWD, "if (qt + 1 < n_q) stage_queries", "if (false) stage_queries")],
    "first tile only": [
        (FWD, "const int n_k = ((causal ? q_last + 1 : seq) + kBlockK - 1) / kBlockK;",
         "const int n_k = 1;"),
        (BWD, "const int n_k = ((causal ? q_last + 1 : seq) + kBlock - 1) / kBlock;",
         "const int n_k = 1;"),
        (BWD, "for (int qt = first; qt < n_q; ++qt) {",
         "for (int qt = first; qt < first + 1; ++qt) {")],
    # Tried and slower: CTAs of one head adjacent in launch order; dK/dV
    # capped at 128 registers (4 CTAs per SM); dQ capped at 168 (3 CTAs per
    # SM); dQ's products over 16 or 64 keys per step instead of 32.
    "head-major grid": [
        (FWD, "  const int bh = blockIdx.x;\n  const int b = bh / heads;\n"
              "  const int h = bh % heads;\n"
              "  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;\n  const int warp",
         "  const int bh = blockIdx.y;\n  const int b = bh / heads;\n"
         "  const int h = bh % heads;\n"
         "  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;\n  const int warp"),
        (FWD, "  const dim3 grid(batch * heads, (seq + kBlockQ - 1) / kBlockQ);\n"
              "  flash_fwd_mma_kernel",
         "  const dim3 grid((seq + kBlockQ - 1) / kBlockQ, batch * heads);\n"
         "  flash_fwd_mma_kernel"),
        (BWD, "  const int bh = blockIdx.x;\n  const int b = bh / heads;\n"
              "  const int h = bh % heads;\n"
              "  const int k0 = blockIdx.y * kBlock;\n  const int warp",
         "  const int bh = blockIdx.y;\n  const int b = bh / heads;\n"
         "  const int h = bh % heads;\n"
         "  const int k0 = blockIdx.x * kBlock;\n  const int warp"),
        (BWD, "const int first = causal ? blockIdx.y : 0;",
         "const int first = causal ? blockIdx.x : 0;"),
        (BWD, "  const dim3 grid(a.batch * a.heads, (a.seq + kBlock - 1) / kBlock);\n"
              "  flash_bwd_dkv_mma_kernel",
         "  const dim3 grid((a.seq + kBlock - 1) / kBlock, a.batch * a.heads);\n"
         "  flash_bwd_dkv_mma_kernel")],
    "dK/dV at 4 CTAs per SM": [
        (BWD, "__launch_bounds__(kMmaThreads, DP <= 64 ? 3 : 1)",
         "__launch_bounds__(kMmaThreads, DP <= 64 ? 4 : 1)")],
    "dQ at 3 CTAs per SM": [
        (BWD, "__launch_bounds__(kMmaThreads, DP <= 64 ? 4 : 1)",
         "__launch_bounds__(kMmaThreads, DP <= 64 ? 3 : 1)")],
    "dQ: 16-key steps": [(BWD, "constexpr int kKSub = 32;", "constexpr int kKSub = 16;")],
    "dQ: 64-key steps": [(BWD, "constexpr int kKSub = 32;", "constexpr int kKSub = 64;")],
}
# The fp32 forward's numerics, each against the kernel as built: 64-key
# steps (one online-softmax step per tile), the O update as one fmaf
# (O alpha + P.V rounded once), the softmax exponent as the backward forms
# it (exp2(fmaf(s, c, -m)) on the raw scores, one rounding where s * c, then
# s - m, takes two; the lines of the 3xTF32 kernel, by their indentation),
# and TF32 hi parts rounded to nearest (every 3xTF32 kernel). With
# --trainer each shows where phase 16f's loss spike lands.
K64 = [(FWD, "constexpr int kTf32Sub = 32;", "constexpr int kTf32Sub = 64;")]
O_FMAF = [
    (FWD, "acc[n0 + i][e] = __fadd_rn(__fmul_rn(acc[n0 + i][e], alpha[e >> 1]), part[i][e]);",
     "acc[n0 + i][e] = fmaf(acc[n0 + i][e], alpha[e >> 1], part[i][e]);")]
EXP_FMAF = [
    (FWD, "          s[j][e] = visible ? s[j][e] * c : kNegInf;",
     "          s[j][e] = visible ? s[j][e] : kNegInf;"),
    (FWD, "        const float m_new = fmaxf(m[i], mx);",
     "        const float m_new = fmaxf(m[i], mx * c);"),
    (FWD, "            const float p = s[j][e] == kNegInf ? 0.f : fast_exp2(s[j][e] - m_new);",
     "            const float p = s[j][e] == kNegInf ? 0.f : fast_exp2(fmaf(s[j][e], c, -m_new));")]
HI_RN = ("mma_tf32.cuh", "hi = __float_as_uint(x) & 0xffffe000u;",
         "hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;")
# The 3xTF32 kernels (fp32): each choice against its alternative.
VARIANTS_FP32 = {
    "as built": [],
    "forward: registers left to ptxas": [
        (FWD, "__launch_bounds__(kTf32Threads, 1)", "__launch_bounds__(kTf32Threads)")],
    "forward: 64-key steps": K64,
    "forward: O by one fmaf": O_FMAF,
    "forward: 64-key steps and O by one fmaf": K64 + O_FMAF,
    "forward: exponent and O by one fmaf": EXP_FMAF + O_FMAF,
    "forward: 64-key steps and exponent and O by one fmaf": K64 + EXP_FMAF + O_FMAF,
    "hi rounded to nearest and O by one fmaf": [HI_RN] + O_FMAF,
    "hi rounded to nearest and 64-key steps and O by one fmaf": [HI_RN] + K64 + O_FMAF,
    "hi rounded to nearest and 64-key steps and exponent and O by one fmaf": (
        [HI_RN] + K64 + EXP_FMAF + O_FMAF),
    "32-row tiles (2 warps)": [
        (BWD, "constexpr int kTf32Warps = 4;", "constexpr int kTf32Warps = 2;")],
    "lo parts held": [
        (BWD, "constexpr bool kTf32HoldLo = false;", "constexpr bool kTf32HoldLo = true;")],
    "16-position steps": [
        (BWD, "constexpr int kTf32Sub = 32;", "constexpr int kTf32Sub = 16;")],
    "64-position steps": [
        (BWD, "constexpr int kTf32Sub = 32;", "constexpr int kTf32Sub = 64;")],
    "libm exp2f": [(BWD, "fast_exp2(fmaf(", "exp2f(fmaf(")],
    "hi rounded to nearest": [HI_RN],
}
DIAGNOSTICS = ("no later loads", "first tile only")
BASELINE = "baseline"
# (B, T, H, Dh, dh-major) per type.
SHAPES = {"bf16": ((64, 256, 6, 48, True), (8, 256, 6, 48, True)),
          "fp32": ((8, 256, 6, 48, True), (3, 256, 6, 48, True), (8, 256, 6, 48, False))}


def _sources(patches, dh: int, csrc: Path = _ext._CSRC) -> dict:
    """The csrc files (of `csrc`) with `patches` applied and only the
    instantiation of head dim `dh` (rounded to 16) left in each flash
    dispatch."""
    n = (dh + 15) // 16
    out = {}
    for path in csrc.glob("*.cu*"):
        text = path.read_text()
        for name, old, new in patches:
            if name == path.name:
                if old not in text:
                    raise ValueError(f"patch does not apply to {name}: {old[:60]!r}")
                text = text.replace(old, new)
        if path.name == FWD:
            text = re.sub(r"    DDL_CASE\((\d)\)\n",
                          lambda m: m.group(0) if int(m.group(1)) == n else "", text)
        elif path.name == BWD:
            text = re.sub(r"    (case \d|default): return static_cast<int>\(launch<(\d+)>"
                          r"\(a, bf, is_dq, st\)\);\n",
                          lambda m: m.group(0).replace(m.group(1), "default")
                          if int(m.group(2)) == 16 * n else "", text)
        out[path.name] = text
    return out


def build(names, dh: int, variants: dict, baseline=None):
    """{variant: {library: ctypes.CDLL}} and {variant: ptxas lines};
    `baseline` is the csrc directory of the variant BASELINE."""
    procs, ptxas, libs = [], {}, {}
    for v in names:
        d = _variant_dir(v)
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        sources = (_sources([], dh, Path(baseline)) if v == BASELINE
                   else _sources(variants[v], dh))
        for fname, text in sources.items():
            (d / fname).write_text(text)
        for lib in ("flash_fwd", "flash_bwd"):
            out = d / f"lib{lib}.so"
            cmd = [_ext._nvcc(), *_ext.NVCC_FLAGS, "-o", str(out), str(d / f"{lib}.cu")]
            procs.append((v, lib, out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for v, lib, out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{v}: {lib} failed to build\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            m = re.search(r"([a-z_0-9]+_kernel)I\w*?Li(\d+)E(?:Li(\d+)E)?", line)
            if "Compiling entry" in line and m:
                kern = f"{m.group(1)}<{m.group(2)}" + (
                    f", layout {m.group(3)}>" if m.group(3) else ">")
                ptxas.setdefault(v, {})[kern] = " | ".join(
                    x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                    if "registers" in x or "spill" in x)
        handle = ctypes.CDLL(str(out))
        for fn, (argtypes, restype) in _ext.KERNELS[lib][1].items():
            getattr(handle, fn).argtypes = argtypes
            getattr(handle, fn).restype = restype
        libs.setdefault(v, {})[lib] = handle
    return libs, ptxas


def _variant_dir(v: str) -> Path:
    return BUILD / re.sub(r"\W+", "_", v)


def trainer_losses(v: str, libs: dict, card: str) -> dict:
    """Phase 16f's trainers with variant ``v``'s kernels and 16f's two
    comparisons: ``psa=""`` against the world of one (max|d|) and
    ``psa="int8_ef"`` against ``psa=""`` (max|d|/|loss|, each step), which
    ``chip_smoke.py`` holds to ``TOL_TP_VS_DP`` and ``TOL_TP_INT8_REL``."""
    from .config import TrainConfig
    from .parallel import distributed, programs
    from .train.llm import train_llm_dp
    real = _ext.library
    _ext.library = lambda name: libs[name] if name in libs else real(name)
    try:
        one = train_llm_dp(None, TrainConfig(**programs.TRAIN_16F), log_every=0,
                           device=torch.device("cuda")).losses
    finally:
        _ext.library = real
    with tempfile.TemporaryDirectory() as tmp:
        pair = distributed.run_ranks(programs.trainer_pair, 2, tmp, str(_variant_dir(v)),
                                     timeout=600)[0]
    plain, int8 = pair["trainer_plain"]["losses"], pair["trainer"]["losses"]
    out = {"vs_one": max(abs(a - b) for a, b in zip(plain, one)),
           "int8_rel": max(abs(a - b) / abs(b) for a, b in zip(int8, plain)),
           "one": one, "plain": plain, "int8_ef": int8}
    print(f"16f {v:>24}: psa='' vs world of one max|d| {out['vs_one']:.3g}, "
          f"int8_ef vs psa='' max|d|/|loss| {out['int8_rel']:.4f}; step 9: "
          f"one {one[9]:.4f}, psa='' {plain[9]:.4f}, int8_ef {int8[9]:.4f} [{card}]")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=("bf16", "fp32"), default="bf16")
    ap.add_argument("--variants", default=None,
                    help="comma-separated names from VARIANTS (bf16) or "
                         "VARIANTS_FP32 (fp32); default: all of them")
    ap.add_argument("--dh", type=int, default=48)
    ap.add_argument("--baseline", default=None,
                    help="another ops/csrc directory, timed as the variant "
                         f"{BASELINE!r}")
    ap.add_argument("--trainer", action="store_true",
                    help="fp32: also run phase 16f's trainers with each variant's kernels "
                         "(two ranks on the card)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("flash_ab: needs a CUDA card")
    variants = VARIANTS if args.dtype == "bf16" else VARIANTS_FP32
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    tol = 2e-2 if args.dtype == "bf16" else 1e-4
    names = ["as built"] + [v for v in (args.variants or ",".join(variants)).split(",")
                            if v and v != "as built"]
    if args.baseline:
        names.append(BASELINE)
    card = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    print(card)
    t0 = time.perf_counter()
    libs, ptxas = build(names, args.dh, variants, args.baseline)
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for v in names:
        print(f"ptxas {v}: {ptxas.get(v)}")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cases, plain = {}, {}
    for b, t, h, _, dh_major in SHAPES[args.dtype]:
        dh = args.dh
        q, k, v, do = (torch.randn(b, t, h, dh, generator=gen, device=dev).to(dtype)
                       for _ in range(4))
        q4, k4, v4, out, lse = fa._fwd(q, k, v, causal=True, dh_major=dh_major)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).reshape(b * h, t)
        ref_out, ref_lse = fa.flash_attention_reference(q, k, v)
        err = (out.float() - ref_out.float()).abs().max().item()
        if not err <= tol:
            raise RuntimeError(f"the kernel as built is off its plain version: {err}")
        o4 = torch.empty_like(q4)
        grads = [torch.empty(b, t, h, dh, device=dev, dtype=dtype).permute(0, 2, 1, 3)
                 for _ in range(3)]
        key = (b, t, h, dh, "dh-major" if dh_major else "row-major")
        cases[key] = ((q4, k4, v4, o4), torch.empty_like(lse),
                      (q4, k4, v4, do.permute(0, 2, 1, 3)), grads, lse, delta)
        plain[key] = (ref_out.permute(0, 2, 1, 3), ref_lse,
                      *(g.permute(0, 2, 1, 3) for g in
                        fa.flash_attention_bwd_reference(q, k, v, out, lse, do)))

    real = _ext.library
    results = {v: {} for v in names}
    errors = {}

    def run(v, check):
        _ext.library = lambda name: libs[v][name]
        try:
            for shape, (fops, flse, bops, grads, lse, delta) in cases.items():
                fwd = lambda: fa._launch(*fops, flse, causal=True)
                dq = lambda: fa._launch_bwd("ddl_flash_bwd_dq", bops, grads[:1], lse, delta,
                                            causal=True)
                dkv = lambda: fa._launch_bwd("ddl_flash_bwd_dkv", bops, grads[1:], lse, delta,
                                             causal=True)
                if check:
                    fwd(), dq(), dkv()
                    torch.cuda.synchronize()
                    got = [x.clone() for x in (fops[3], flse, *grads)]
                    if args.dtype == "fp32":
                        err = max((g - r).abs().max().item()
                                  for g, r in zip(got, plain[shape]))
                        errors.setdefault(v, {})[str(shape)] = err
                        if not err <= tol:
                            raise RuntimeError(f"{v} at {shape}: max|d| {err:.3g} from "
                                               f"the plain version, over {tol}")
                    if v == "as built":
                        ref[shape] = got
                    elif v not in DIAGNOSTICS and v != BASELINE:
                        same = all(torch.equal(a, r) for a, r in zip(got, ref[shape]))
                        bitwise.setdefault(v, True)
                        bitwise[v] &= same
                        if not same:
                            print(f"{v}: results differ from the kernels as built at {shape}")
                    continue
                r = results[v].setdefault(str(shape), {"fwd_us": [], "dq_us": [], "dkv_us": []})
                r["fwd_us"].append(kernel_time_us(fwd))
                r["dq_us"].append(kernel_time_us(dq))
                r["dkv_us"].append(kernel_time_us(dkv))
        finally:
            _ext.library = real

    ref, bitwise = {}, {}
    for v in names:
        run(v, True)
    for order in (names, names[::-1]):
        for v in order:
            run(v, False)
    sdpa, sdpa_bwd = {}, {}
    for b, t, h, dh, _ in cases:
        qs, ks, vs = (torch.randn(b, h, t, dh, generator=gen, device=dev).to(dtype)
                      .requires_grad_() for _ in range(3))
        sdpa[str((b, t, h, dh))] = kernel_time_us(
            lambda: torch.nn.functional.scaled_dot_product_attention(qs, ks, vs,
                                                                     is_causal=True))
        out = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        do_s = torch.randn_like(out)
        sdpa_bwd[str((b, t, h, dh))] = kernel_time_us(
            lambda: torch.autograd.grad(out, (qs, ks, vs), do_s, retain_graph=True))
    for shape in cases:
        sd = str(shape[:4])
        print(f"{shape}: SDPA forward {sdpa[sd]:.1f} us, backward (dq, dk, dv) "
              f"{sdpa_bwd[sd]:.1f} us [{card}]")
        for v in names:
            r = results[v][str(shape)]
            print(f"{shape} {v:>24}: forward {r['fwd_us'][0]:.1f} / {r['fwd_us'][1]:.1f} us, "
                  f"dQ {r['dq_us'][0]:.1f} / {r['dq_us'][1]:.1f} us, "
                  f"dK/dV {r['dkv_us'][0]:.1f} / {r['dkv_us'][1]:.1f} us [{card}]")
    # A variant bitwise the kernels as built trains as they do.
    trainer = ({v: trainer_losses(v, libs[v], card) for v in names
                if v not in DIAGNOSTICS and not bitwise.get(v)}
               if args.trainer and args.dtype == "fp32" else None)
    print(json.dumps({"card": card, "dtype": args.dtype, "dh": args.dh, "variants": results,
                      "bitwise_as_built": bitwise, "max_abs_err_plain": errors,
                      "ptxas": ptxas, "sdpa_fwd_us": sdpa, "sdpa_bwd_us": sdpa_bwd,
                      "trainer_16f": trainer}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
