#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ddl25spring_tpu_torch``) on one CUDA card
and check it end to end.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each of which raises on failure (exit code 1, no result line):

1. device  — the card's name and power limit (nvidia-smi); every number
             line below carries them.
2. build   — compile the CUDA kernels from the sources in the checkout
             (nvcc, into the git-ignored build/kernels/).
3. kernels — each kernel against its plain PyTorch version on the card, at
             the shapes the model gives it, with per-call times (CUDA
             events, median of 100) beside the plain version, one PyTorch
             library call for the same function, and the least time the
             card could take (bytes over HBM rate vs operations over peak).
4. forward — the canonical tiny-Llama (vocab 32000, dmodel 288, 6 heads of
             48, 6 layers, ctx 256) at B=8, T=256, seeded random weights:
             logits through the kernel ("auto") vs the plain path ("xla"),
             and the kernel launch count per forward (one per layer).
5. serving — ``run_serving`` at full width, 32 Poisson requests on 8 slots:
             every request completes with max_new tokens, and every greedy
             stream equals the port's ``generate()`` for it alone, or
             differs first at a near-tie of the reference's logits.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero without printing a
result when no CUDA device is available or the package is missing.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import torch

# Peak rates of one H100 SXM (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12,        # fp32 outside the tensor cores
              torch.bfloat16: 989e12}      # bf16 tensor cores

TOL_OUT = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
TOL_LSE = 1e-4
TOL_LOGITS = 1e-3
NEAR_TIE = 1e-4


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def time_us(fn, reps: int = 100, burst: int = 10) -> float:
    """Median device time of one call, in microseconds: CUDA events around
    each call. Every burst of calls is queued behind a GPU sleep longer
    than the host needs to enqueue the burst, so the calls run back to
    back on the device and host dispatch time does not count."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # At most 2e9 cycles/s, so this sleeps at least the time it asks for.
    sleep_cycles = int(2e9 * (2 * burst * enqueue_s + 2e-3))
    times = []
    for _ in range(reps // burst):
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(burst)]
        torch.cuda._sleep(sleep_cycles)
        for start, end in pairs:
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        times += [start.elapsed_time(end) * 1e3 for start, end in pairs]
    return statistics.median(times)


def wall_us(fn, reps: int = 20) -> float:
    """Median host wall time of one call ending in a synchronize, in
    microseconds: what a caller waits, host dispatch included."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e6)
    return statistics.median(times)


def attention_bound_us(b, t, h, dh, dtype) -> tuple:
    """Least time for causal attention forward over [B, T, H, Dh]: q, k, v
    read once, out written once (input dtype), lse written once (fp32);
    4·Dh operations per visible (query, key) pair (two multiply-adds)."""
    item = torch.empty((), dtype=dtype).element_size()
    nbytes = 4 * b * t * h * dh * item + b * h * t * 4
    flops = 4 * dh * b * h * (t * (t + 1) // 2)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e6
    t_ops = flops / PEAK_FLOPS[dtype] * 1e6
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from ddl25spring_tpu_torch.config import LlamaConfig
    from ddl25spring_tpu_torch.models import llama
    from ddl25spring_tpu_torch.ops import _ext
    from ddl25spring_tpu_torch.ops import flash_attention as fa
    from ddl25spring_tpu_torch.serving import (PagedKVConfig, reference_stream,
                                               run_serving, synthetic_workload)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. device -----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi)
    card = f"[{smi}]"
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind} count {torch.cuda.device_count()} "
          f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    # 2. build ------------------------------------------------------------
    build_s = _ext.build()
    print(f"build: {build_s:.1f} s {card}")
    for name in _ext.KERNELS:
        log = _ext.library_path(name).with_suffix(".so.log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {name}: {line.strip()}")

    # 3. kernels vs plain -------------------------------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cases = [(8, 256, 6, 48, torch.float32, False),
             (8, 256, 6, 48, torch.float32, True),
             (8, 256, 6, 48, torch.bfloat16, False),
             (8, 256, 6, 48, torch.bfloat16, True),
             (2, 200, 6, 48, torch.float32, False),
             (2, 200, 6, 48, torch.float32, True)]
    layouts = []
    for b, t, h, dh, dtype, dh_major in cases:
        q, k, v = (torch.randn(b, t, h, dh, generator=gen, device=dev
                               ).to(dtype) for _ in range(3))
        out, lse = fa.flash_attention_fwd(q, k, v, dh_major=dh_major)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_reference(q, k, v)
        err = (out.float() - ref_out.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        tag = (f"B={b} T={t} H={h} Dh={dh} {str(dtype)[6:]} "
               f"dh_major={dh_major}")
        check(math.isfinite(err) and err <= TOL_OUT[dtype],
              f"flash_fwd out {tag}: max|d|={err:.3g} > {TOL_OUT[dtype]}")
        check(math.isfinite(lse_err) and lse_err <= TOL_LSE,
              f"flash_fwd lse {tag}: max|d|={lse_err:.3g} > {TOL_LSE}")
        # The kernel alone, on operands already in the layout it reads.
        ops = fa.kernel_operands(q, k, v, dh_major)
        lse_buf = torch.empty(b * h, t, dtype=torch.float32, device=dev)
        kernel_us = time_us(lambda: fa._launch(*ops, lse_buf, causal=True))
        wrapper_us = time_us(lambda: fa.flash_attention(
            q, k, v, dh_major=dh_major))
        plain_us = time_us(lambda: fa.flash_attention_reference(q, k, v))
        qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))
        sdpa_us = time_us(lambda: torch.nn.functional.
                          scaled_dot_product_attention(qs, ks, vs,
                                                       is_causal=True))
        bound_us, bound_by = attention_bound_us(b, t, h, dh, dtype)
        layouts.append({
            "shape": [b, t, h, dh], "dtype": str(dtype)[6:],
            "dh_major": dh_major,
            "replaces": ("ddl25spring_tpu/ops/flash_attention.py:321"
                         if dh_major else
                         "ddl25spring_tpu/ops/flash_attention.py:49"),
            "max_abs_err": err, "lse_max_abs_err": lse_err,
            "kernel_us": kernel_us, "wrapper_us": wrapper_us,
            "plain_us": plain_us, "sdpa_us": sdpa_us,
            "bound_us": bound_us, "bound_by": bound_by})
        print(f"flash_fwd {tag}: max|d| out {err:.3g} lse {lse_err:.3g}; "
              f"kernel {kernel_us:.1f} us, wrapper {wrapper_us:.1f} us, "
              f"plain {plain_us:.1f} us, sdpa {sdpa_us:.1f} us, "
              f"bound {bound_us:.2f} us ({bound_by}) {card}")

    # 4. forward at full width (the main path of the kernel) -------------
    cfg = LlamaConfig()
    wgen = torch.Generator()
    wgen.manual_seed(0)
    model = llama.init_llama(cfg, wgen, device=dev)
    tgen = torch.Generator(device=dev)
    tgen.manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (8, cfg.ctx_size),
                           generator=tgen, device=dev)
    plain_cfg = cfg.replace(attention_impl="xla")
    with torch.inference_mode():
        fa.launches = 0
        logits = llama.forward(model, tokens, cfg)
        torch.cuda.synchronize()
        main_launches = fa.launches
        check(main_launches == cfg.n_layers,
              f"forward launched flash_fwd {main_launches} times, expected "
              f"{cfg.n_layers} (one per layer)")
        plain = llama.forward(model, tokens, plain_cfg)
        check(fa.launches == main_launches, "the plain path launched the "
              "kernel")
        check(tuple(logits.shape) == (8, cfg.ctx_size, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()),
              f"forward logits shape {tuple(logits.shape)} or non-finite")
        ferr = (logits - plain).abs().max().item()
        check(ferr <= TOL_LOGITS, f"forward logits kernel vs plain "
              f"max|d|={ferr:.3g} > {TOL_LOGITS}")
        fwd = {}
        for name, c in (("kernel", cfg), ("plain", plain_cfg)):
            call = lambda c=c: llama.forward(model, tokens, c)
            fwd[name] = (wall_us(call), time_us(call, reps=20, burst=2))
    n_tok = tokens.numel()
    print(f"forward B=8 T={cfg.ctx_size}: flash_fwd launches {main_launches} "
          f"per forward; logits max|d| kernel vs plain {ferr:.3g} {card}")
    for name, (wall, device) in fwd.items():
        print(f"forward ({name} attention): {n_tok / wall * 1e6:.0f} tok/s "
              f"wall ({wall / 1e3:.3f} ms per forward), device "
              f"{device / 1e3:.3f} ms per forward {card}")

    # 5. serving at full width -------------------------------------------
    paged = PagedKVConfig(num_blocks=129, block_len=16, max_blocks_per_seq=16)
    wl = synthetic_workload(seed=0, n_requests=32, rate_rps=50.0,
                            vocab_size=cfg.vocab_size,
                            prompt_lens=(16, 64, 192), max_news=(16, 32, 64),
                            temperatures=(0.0, 0.8))
    fa.launches = 0
    rep = run_serving(model, cfg, paged, wl, num_slots=8, prefill_chunk=16,
                      device=dev)
    torch.cuda.synchronize()
    serve_launches = fa.launches
    check(rep.aggregates["completed"] == len(wl),
          f"served {rep.aggregates['completed']} of {len(wl)} requests")
    for r in wl:
        n = len(rep.records[r.rid].tokens)
        check(n == r.max_new, f"{r.rid}: {n} tokens, max_new {r.max_new}")
    exact = near_tie = 0
    for r in wl:
        if r.temperature > 0:
            continue
        got = rep.records[r.rid].tokens
        ref = reference_stream(model, cfg, paged, r, device=dev)
        if got == ref:
            exact += 1
            continue
        i = next(j for j, (a, b) in enumerate(zip(got, ref)) if a != b)
        seq = torch.tensor([list(r.prompt) + ref[:i]], device=dev)
        with torch.inference_mode():
            last = llama.forward(model, seq, plain_cfg)[0, -1]
        top2 = torch.topk(last, 2).values
        gap = (top2[0] - top2[1]).item()
        check(gap < NEAR_TIE, f"{r.rid}: stream differs from generate() at "
              f"token {i} where the reference's top-2 gap is {gap:.3g}")
        near_tie += 1
    agg = rep.aggregates
    print(f"serving: {agg['completed']}/{len(wl)} requests, "
          f"{agg['total_tokens']} tokens; greedy streams equal to generate(): "
          f"{exact} exact, {near_tie} near-tie; sustained "
          f"{agg['sustained_tokens_per_sec']:.0f} tok/s, TTFT p50 "
          f"{agg['ttft_s']['p50'] * 1e3:.1f} ms p99 "
          f"{agg['ttft_s']['p99'] * 1e3:.1f} ms, peak blocks "
          f"{rep.peak_blocks_in_use}/{rep.pool_blocks}, decode tokens per "
          f"dispatch {rep.tokens_per_dispatch:.2f}, flash_fwd launches "
          f"{serve_launches} (paged attention is plain PyTorch) {card}")

    main = next(x for x in layouts if x["shape"] == [8, 256, 6, 48]
                and x["dtype"] == "float32" and x["dh_major"]
                == cfg.flash_dh_major)
    print(json.dumps({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "ddl25spring_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": main["replaces"], "launches": main_launches,
        "max_abs_err": main["max_abs_err"],
        "ms": main["kernel_us"] / 1e3, "plain_ms": main["plain_us"] / 1e3,
        "bound_ms": main["bound_us"] / 1e3, "bound_by": main["bound_by"],
        "library_ms": main["sdpa_us"] / 1e3,
        "layouts": layouts, "card": smi, "ok": True}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
