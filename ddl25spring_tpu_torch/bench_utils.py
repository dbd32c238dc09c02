"""Benchmark timing core for the training step: counterpart of the JAX
package's ``bench_utils.py`` (``make_optimizer``, ``time_train_step``).

The port times the data-parallel step at a world of one process, with
per-step gradient aggregation and no compressed wire; the other levers of
the JAX function raise ``NotImplementedError`` naming ROADMAP.md. Timing
is sync-honest: the timed chain ends in a host read of the last loss,
which waits for the device. ``kernel_time_us`` times one kernel call on
the device alone (``chip_smoke.py``, ``flash_ab``).
"""

from __future__ import annotations

import statistics
import time
from typing import Optional

import torch

from .config import LlamaConfig
from .device import resolve_device
from .models import llama
from .ops.adam import fused_adam
from .parallel import dp


def make_optimizer(opt_name: str, lr: float = 8e-4):
    """"fused" = the single-expression Adam rule per leaf (ops/adam.py);
    "pallas" = the fused apply whose large leaves run the CUDA kernel
    (ops/pallas_adam.py). "master" (fp32 master weights for bf16 params)
    is not ported yet."""
    if opt_name == "pallas":
        from .ops.pallas_adam import FusedApplyAdam
        return FusedApplyAdam(lr)
    if opt_name == "master":
        raise NotImplementedError(
            "optimizer 'master' (ops/mixed_precision.py) is not ported yet: "
            "ROADMAP.md, queue A item 3")
    if opt_name != "fused":
        raise ValueError(f"unknown optimizer {opt_name!r}: expected one of "
                         "'fused', 'pallas', 'master'")
    return fused_adam(lr)


def build_train_step(cfg: LlamaConfig, batch_size: int, *,
                     seq: Optional[int] = None, opt_name: str = "fused",
                     device=None):
    """What ``time_train_step`` times: ``(state, step, tokens)`` — a fresh
    train state from ``init_llama`` seeded 0, the world-of-one gradient
    aggregation step over ``llama.forward_loss``, and a ``[batch_size,
    seq]`` batch of tokens drawn from a generator seeded 1 on the device."""
    if cfg.remat:
        raise NotImplementedError("LlamaConfig.remat is not ported yet: "
                                  "ROADMAP.md, queue A")
    dev = resolve_device(device)
    seq = seq or cfg.ctx_size
    model = llama.init_llama(cfg, torch.Generator().manual_seed(0),
                             device=dev)
    opt = make_optimizer(opt_name)
    step = dp.make_grad_aggregation_step(
        lambda p, batch: llama.forward_loss(p, batch, cfg), opt)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (batch_size, seq),
                           generator=gen, device=dev)
    return dp.init_state(model.tree(), opt), step, tokens


def time_train_step(cfg: LlamaConfig, batch_size: int, *,
                    seq: Optional[int] = None, opt_name: str = "fused",
                    wire: Optional[str] = None,
                    warmup: int = 3, timed_steps: int = 20,
                    steps_per_dispatch: int = 1,
                    aggregation: str = "gradient",
                    overlap_microbatches: int = 0,
                    comm_buckets: int = 1, device=None) -> float:
    """Tokens/sec of the train step at ``batch_size`` on one device (the
    JAX function's per-chip batch, at a world of one), wall clock: the
    timer starts after ``warmup`` steps on a host read of the loss and
    stops on a host read of the last timed loss. ``seq`` defaults to
    ``cfg.ctx_size``."""
    for name, val, default, where in (
            ("wire", wire, None, "queue A item 8 (compressed collectives)"),
            ("steps_per_dispatch", steps_per_dispatch, 1,
             "queue A item 2 (multi-step dispatch)"),
            ("aggregation", aggregation, "gradient",
             "queue A item 2 (weight aggregation, ZeRO-1)"),
            ("overlap_microbatches", overlap_microbatches, 0,
             "queue A item 8 (overlapped ring sync)"),
            ("comm_buckets", comm_buckets, 1,
             "queue A item 8 (overlapped ring sync)")):
        if val != default:
            raise NotImplementedError(
                f"time_train_step({name}={val!r}) is not ported yet: "
                f"ROADMAP.md, {where}")
    seq = seq or cfg.ctx_size
    state, step, tokens = build_train_step(cfg, batch_size, seq=seq,
                                           opt_name=opt_name, device=device)
    for _ in range(warmup):
        state, loss = step(state, tokens)
    float(loss)                                  # hard sync before the timer
    t0 = time.perf_counter()
    for _ in range(timed_steps):
        state, loss = step(state, tokens)
    float(loss)                                  # waits for the timed chain
    dt = time.perf_counter() - t0
    return batch_size * seq * timed_steps / dt


def kernel_time_us(fn, reps: int = 100, burst: int = 10) -> float:
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
