"""Where the training step's device time goes, on one CUDA card.

    python -m ddl25spring_tpu_torch.profile_step [--batch 64] [--steps 3]

Builds the step ``bench_utils.time_train_step`` times (the canonical
tiny-Llama, bf16 compute, flash kernels in the dh-major layout, the fused
Adam kernel; ``--batch`` × 256 random tokens), warms it up, then traces
``--steps`` steps with ``torch.profiler``. Prints one JSON line: the summed
kernel milliseconds per step (the device time: a step launches more kernels
than the launch queue holds, so it cannot be timed as one queued burst),
the kernel time per category (the port's own kernels, matrix products,
reductions, copies, other elementwise) and the heaviest kernels by name.
The wall time and busy share it reports are those of the profiled window,
whose host is slowed by the profiler; time the wall step without it
(``bench_utils.time_train_step``). Needs a card; raises without one.
``trace`` profiles any warmed-up callable the same way (``chip_smoke.py``
traces FedAvg rounds with it), and ``Window`` a slice of a loop that runs
anyway (epochs of a trainer, through its ``log_fn``).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from .bench_utils import build_train_step
from .config import LlamaConfig

# Name fragments of the port's own kernels, of cuDNN convolutions (the FL
# path's), of cuBLAS/cutlass products, and of reductions/copies, in the
# order they are tried.
_CATEGORIES = (
    ("flash_fwd (port)", ("flash_fwd_",)),
    ("flash_bwd dq (port)", ("flash_bwd_dq_",)),
    ("flash_bwd dkv (port)", ("flash_bwd_dkv_",)),
    ("adam (port)", ("adam_kernel",)),
    ("convolution", ("fprop", "dgrad", "wgrad", "conv2d", "cudnn")),
    ("matmul", ("gemm", "cutlass", "sm90_xmma", "cublas", "nvjet")),
    ("reduction", ("reduce", "softmax", "logsumexp")),
    ("copy/cast", ("copy", "cat", "fill", "index", "scatter", "gather")),
)


def _category(name: str) -> str:
    low = name.lower()
    for cat, keys in _CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other elementwise"


_ACTIVITIES = [torch.profiler.ProfilerActivity.CPU,
               torch.profiler.ProfilerActivity.CUDA]


def trace(fn, steps: int) -> dict:
    """Trace ``steps`` calls of ``fn`` (warmed up by the caller) with
    ``torch.profiler``: kernel ms per call, by category and by name,
    launches per call, and the busy share of the profiled window."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=_ACTIVITIES) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    return _summary(prof.events(), wall_s, steps)


class Window:
    """Trace a slice of a loop that is running anyway: call ``tick()`` at
    the end of each step (a trainer's ``log_fn`` at ``log_every=1``); the
    profiler records steps ``start + 1`` to ``start + steps``, and
    ``result`` then holds ``trace``'s summary of them."""

    def __init__(self, start: int, steps: int):
        self.start, self.steps, self.n, self.result = start, steps, 0, None

    def tick(self, *_) -> None:
        self.n += 1
        if self.n == self.start:
            torch.cuda.synchronize()
            self._prof = torch.profiler.profile(activities=_ACTIVITIES)
            self._prof.start()
            self._t0 = time.perf_counter()
        elif self.n == self.start + self.steps:
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - self._t0
            self._prof.stop()
            self.result = _summary(self._prof.events(), wall_s, self.steps)


def _summary(events, wall_s: float, steps: int) -> dict:
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")
    # Busy share: the union of kernel intervals over the traced window.
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    by_cat: dict = {}
    for name, us in by_name.items():
        by_cat[_category(name)] = by_cat.get(_category(name), 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    return {
        "steps": steps,
        "profiled_wall_ms_per_step": wall_s * 1e3 / steps,
        "kernel_ms_per_step": sum(by_name.values()) / 1e3 / steps,
        "profiled_busy_share": busy / wall_s / 1e6,
        "kernels_per_step": len(kernels) / steps,
        "ms_per_step_by_category": {k: v / 1e3 / steps for k, v in
                                    sorted(by_cat.items(),
                                           key=lambda kv: -kv[1])},
        "top_kernels_ms_per_step": [(n[:120], us / 1e3 / steps)
                                    for n, us in top],
    }


def profile(batch: int = 64, steps: int = 3, device=None) -> dict:
    cfg = LlamaConfig(dtype="bfloat16", attention_impl="pallas",
                      flash_dh_major=True, flash_block=512)
    state, step, tokens = build_train_step(cfg, batch, opt_name="pallas",
                                           device=device)
    for _ in range(3):
        state, loss = step(state, tokens)
    carry = [state, loss]

    def one():
        carry[0], carry[1] = step(carry[0], tokens)

    out = trace(one, steps)
    return {"batch": batch, "seq": cfg.ctx_size, "loss": float(carry[1]),
            **out}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device available")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = profile(args.batch, args.steps)
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
