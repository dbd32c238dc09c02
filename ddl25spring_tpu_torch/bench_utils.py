"""Benchmark timing core for the training step: counterpart of the JAX
package's ``bench_utils.py`` (``make_optimizer``, ``time_train_step``).

The port times the data-parallel step (gradient aggregation per step or
K steps per window, weight aggregation, ZeRO-1, the compressed and
overlapped ring step and the legacy bf16 and int8 steps of
``parallel/compress.py``) in the caller's process group, or at a world of
one without one, and the tensor-parallel step of ``parallel/tp.py`` on a
``data × model`` layout (``time_tp_train_step``). Timing is
sync-honest: the timed chain ends in a host read of the last loss, which
waits for the device, and at a world above one in a barrier after it.
``kernel_time_us`` times one kernel call on the device alone
(``chip_smoke.py``, ``flash_ab``).
"""

from __future__ import annotations

import statistics
import time
from typing import Optional

import torch

from .config import LlamaConfig
from .models import llama
from .ops.adam import fused_adam
from .parallel import compress, dp
from .parallel import distributed as dist


def make_optimizer(opt_name: str, lr: float = 8e-4):
    """"fused" = the single-expression Adam rule per leaf (ops/adam.py);
    "pallas" = the fused apply whose large leaves run the CUDA kernel
    (ops/pallas_adam.py); "master" = fp32 master weights for bf16
    parameters (ops/mixed_precision.py: pair with
    ``param_dtype="bfloat16"``)."""
    if opt_name == "pallas":
        from .ops.pallas_adam import FusedApplyAdam
        return FusedApplyAdam(lr)
    if opt_name == "master":
        from .ops.mixed_precision import master_weight_adam
        return master_weight_adam(lr)
    if opt_name != "fused":
        raise ValueError(f"unknown optimizer {opt_name!r}: expected one of "
                         "'fused', 'pallas', 'master'")
    return fused_adam(lr)


def build_train_step(cfg: LlamaConfig, batch_size: int, *,
                     seq: Optional[int] = None, opt_name: str = "fused",
                     aggregation: str = "gradient",
                     steps_per_dispatch: int = 1, wire: Optional[str] = None,
                     overlap_microbatches: int = 0, comm_buckets: int = 1,
                     device=None):
    """What ``time_train_step`` times: ``(state, step, tokens)`` — a fresh
    train state from ``init_llama`` seeded 0, the step of ``aggregation``
    over ``llama.forward_loss`` (K = ``steps_per_dispatch`` > 1: the K-step
    loop, for gradient and zero1), and this rank's rows of a ``[n ·
    batch_size, seq]`` batch of tokens drawn from a generator seeded 1 on
    the device (the JAX function's one batch, sharded over the n ranks).
    ``cfg.remat`` rematerializes each block in the backward.

    The JAX function's composition rules: ``overlap_microbatches`` = M >=
    1 takes the ring step (``wire`` or fp32, ``comm_buckets``, gradient
    or zero1, any K); at M = 0 a ``wire`` ("bf16", "int8_ef") takes the
    legacy per-step steps (gradient aggregation, K = 1 only), and
    ``comm_buckets > 1`` raises."""
    dev = dist.rank_device(device)
    seq = seq or cfg.ctx_size
    K = max(1, int(steps_per_dispatch))
    M = int(overlap_microbatches)
    B = max(1, int(comm_buckets))
    if M == 0 and wire is not None and (aggregation != "gradient" or K != 1):
        raise ValueError("wire compression composes with per-step gradient "
                         "aggregation only (pass overlap_microbatches >= 1 "
                         "for the composing ring driver)")
    if M == 0 and B > 1:
        raise ValueError("comm_buckets > 1 needs the overlapped ring driver "
                         "(pass overlap_microbatches >= 1)")
    model = llama.init_llama(cfg, torch.Generator().manual_seed(0),
                             device=dev)
    opt = make_optimizer(opt_name)
    loss_fn = lambda p, batch: llama.forward_loss(p, batch, cfg)
    multi = K > 1
    if M >= 1:
        make = (compress.make_overlap_multi_step if multi
                else compress.make_overlap_step)
        state, step = make(loss_fn, opt, model.tree(), microbatches=M, wire=wire or "fp32",
                           aggregation=aggregation, comm_buckets=B,
                           device=dev)
    elif wire == "bf16":
        step = compress.make_bf16_grad_step(loss_fn, opt)
        state = dp.init_state(model.tree(), opt)
    elif wire == "int8_ef":
        state = compress.init_ef_state(model.tree(), opt)
        step = compress.make_int8_ef_grad_step(loss_fn, opt)
    elif wire is not None:
        raise ValueError(f"unknown wire format {wire!r}")
    elif aggregation == "zero1":
        make = dp.make_zero1_multi_step if multi else dp.make_zero1_step
        state, step = make(loss_fn, opt, model.tree())
    elif aggregation == "gradient":
        make = dp.make_multi_step if multi else dp.make_grad_aggregation_step
        step = make(loss_fn, opt)
        state = dp.init_state(model.tree(), opt)
    elif aggregation == "weight" and not multi:
        step = dp.make_weight_aggregation_step(loss_fn, opt)
        state = dp.init_state(model.tree(), opt)
    else:
        raise ValueError(f"aggregation {aggregation!r} with "
                         f"steps_per_dispatch={steps_per_dispatch}: expected "
                         "'gradient' or 'zero1' (any K), 'weight' (K = 1)")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    n, r = dist.world_size(), dist.get_rank()
    tokens = torch.randint(0, cfg.vocab_size, (n * batch_size, seq),
                           generator=gen, device=dev)
    return state, step, tokens[r * batch_size:(r + 1) * batch_size]


def time_train_step(cfg: LlamaConfig, batch_size: int, *,
                    seq: Optional[int] = None, opt_name: str = "fused",
                    wire: Optional[str] = None,
                    warmup: int = 3, timed_steps: int = 20,
                    steps_per_dispatch: int = 1,
                    aggregation: str = "gradient",
                    overlap_microbatches: int = 0,
                    comm_buckets: int = 1, device=None) -> float:
    """All ranks' tokens/sec of the train step at ``batch_size`` per rank
    (the JAX function's per-chip batch), wall clock; every rank of the
    caller's group calls it (a world of one without a group). The timer
    starts after ``warmup`` steps on a host read of the loss and stops on
    a host read of the last timed loss followed by a barrier, so it waits
    for the slowest rank. ``steps_per_dispatch`` = K > 1 runs the K-step
    loop over a window of K copies of the batch, the step budgets
    ceil-divided into windows. ``aggregation``: "gradient", "zero1" (any
    K) or "weight" (K = 1). ``wire``, ``overlap_microbatches`` and
    ``comm_buckets`` compose as ``build_train_step`` says.
    ``seq`` defaults to ``cfg.ctx_size``."""
    seq = seq or cfg.ctx_size
    K = max(1, int(steps_per_dispatch))
    state, step, tokens = build_train_step(
        cfg, batch_size, seq=seq, opt_name=opt_name, aggregation=aggregation,
        steps_per_dispatch=K, wire=wire,
        overlap_microbatches=overlap_microbatches,
        comm_buckets=comm_buckets, device=device)
    batch = tokens.expand(K, *tokens.shape) if K > 1 else tokens
    warm, timed = ((max(1, -(-warmup // K)), max(1, -(-timed_steps // K)))
                   if K > 1 else (warmup, timed_steps))
    for _ in range(warm):
        state, loss = step(state, batch)
    float(loss.reshape(-1)[-1])                  # hard sync before the timer
    dist.barrier(tokens.device)
    t0 = time.perf_counter()
    for _ in range(timed):
        state, loss = step(state, batch)
    float(loss.reshape(-1)[-1])                  # waits for the timed chain
    dist.barrier(tokens.device)
    dt = time.perf_counter() - t0
    return dist.world_size() * batch_size * seq * timed * K / dt


def time_tp_train_step(mesh, cfg: LlamaConfig, batch_size: int, *,
                       seq: Optional[int] = None, opt_name: str = "fused",
                       psa: str = "", wire: Optional[str] = None,
                       warmup: int = 3, timed_steps: int = 20,
                       steps_per_dispatch: int = 1,
                       aggregation: str = "gradient",
                       overlap_microbatches: int = 0,
                       device=None) -> float:
    """Total tokens/sec of the tensor-parallel train step on ``mesh``
    (``distributed.tp_mesh``; every rank of the group calls it):
    ``time_train_step``'s contract, the JAX function's composition rules.
    ``batch_size`` is per data row, and the return counts ``n_data ·
    batch_size · seq`` tokens per step, since the model shards of a row
    share one batch. ``steps_per_dispatch`` = K > 1 times the K-step
    drivers; ``overlap_microbatches`` = M >= 1 routes the data-axis sync
    through the DP×TP ring (``wire``, ``aggregation="zero1"``); at M = 0
    a ``wire`` or zero1 raises. ``psa``: the activation sync mode."""
    from .parallel import tp

    dev = dist.rank_device(device)
    seq = seq or cfg.ctx_size
    K = max(1, int(steps_per_dispatch))
    M = int(overlap_microbatches)
    params = llama.init_llama(cfg, torch.Generator().manual_seed(0),
                              device="cpu").tree()
    opt = make_optimizer(opt_name)
    if M >= 1:
        make = (tp.make_tp_overlap_multi_step if K > 1
                else tp.make_tp_overlap_step)
        state, step = make(cfg, opt, mesh, params, aggregation=aggregation,
                           wire=wire or "fp32", overlap_microbatches=M,
                           psa=psa, device=dev)
    else:
        if wire is not None or aggregation != "gradient":
            raise ValueError("TP wire compression / zero1 route through "
                             "the ring driver: pass "
                             "overlap_microbatches >= 1")
        make = tp.make_tp_multi_step if K > 1 else tp.make_tp_step
        state, step = make(cfg, opt, mesh, params, psa=psa,
                           batch_shape=(batch_size, seq), device=dev)
    del params
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (mesh.data * batch_size, seq),
                           generator=gen, device=dev)
    batch = tp.shard_batch(mesh, tokens, dev)
    if K > 1:
        batch = batch.expand(K, *batch.shape)
    warm, timed = ((max(1, -(-warmup // K)), max(1, -(-timed_steps // K)))
                   if K > 1 else (warmup, timed_steps))
    for _ in range(warm):
        state, loss = step(state, batch)
    float(loss.reshape(-1)[-1])                  # hard sync before the timer
    dist.barrier(dev)
    t0 = time.perf_counter()
    for _ in range(timed):
        state, loss = step(state, batch)
    float(loss.reshape(-1)[-1])                  # waits for the timed chain
    dist.barrier(dev)
    dt = time.perf_counter() - t0
    return mesh.data * batch_size * seq * timed * K / dt


def time_pp_train_step(mesh, cfg: LlamaConfig, batch_size: int, *,
                       seq: Optional[int] = None, n_microbatches: int = 1,
                       schedule: str = "gpipe", opt_name: str = "fused",
                       wire: Optional[str] = None, warmup: int = 3,
                       timed_steps: int = 20, steps_per_dispatch: int = 1,
                       aggregation: str = "gradient",
                       overlap_microbatches: int = 0, device=None) -> float:
    """Total tokens/sec of the pipeline train step on ``mesh``
    (``distributed.pipeline_mesh``; every rank of the group calls it):
    ``time_train_step``'s contract, the JAX function's composition rules.
    ``batch_size`` is per data row (it must divide by ``n_microbatches``),
    and the return counts ``n_data · batch_size · seq`` tokens per step,
    since the stages of a row share one batch. ``steps_per_dispatch`` = K
    > 1 times the K-step drivers; ``overlap_microbatches`` = M >= 1 routes
    the data-axis sync through the DP×PP ring (``wire``,
    ``aggregation="zero1"``); at M = 0 a ``wire`` or zero1 raises."""
    from .parallel import pp

    dev = dist.rank_device(device)
    seq = seq or cfg.ctx_size
    K = max(1, int(steps_per_dispatch))
    M = int(overlap_microbatches)
    params = llama.init_llama(cfg, torch.Generator().manual_seed(0),
                              device="cpu").tree()
    opt = make_optimizer(opt_name)
    if M >= 1:
        make = (pp.make_pipeline_overlap_multi_step if K > 1
                else pp.make_pipeline_overlap_step)
        state, step = make(cfg, opt, mesh, params,
                           n_microbatches=n_microbatches, schedule=schedule,
                           aggregation=aggregation, wire=wire or "fp32",
                           overlap_microbatches=M, device=dev)
    else:
        if wire is not None or aggregation != "gradient":
            raise ValueError("PP wire compression / zero1 route through "
                             "the ring driver: pass "
                             "overlap_microbatches >= 1")
        state = pp.init_state(mesh, params, opt, device=dev)
        make = (pp.make_pipeline_multi_step if K > 1
                else pp.make_pipeline_step)
        step = make(cfg, opt, mesh, n_microbatches=n_microbatches,
                    schedule=schedule, device=dev)
    del params
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (mesh.data * batch_size, seq),
                           generator=gen, device=dev)
    batch = pp.shard_batch(mesh, tokens, dev)
    if K > 1:
        batch = batch.expand(K, *batch.shape)
    warm, timed = ((max(1, -(-warmup // K)), max(1, -(-timed_steps // K)))
                   if K > 1 else (warmup, timed_steps))
    for _ in range(warm):
        state, loss = step(state, batch)
    float(loss.reshape(-1)[-1])                  # hard sync before the timer
    dist.barrier(dev)
    t0 = time.perf_counter()
    for _ in range(timed):
        state, loss = step(state, batch)
    float(loss.reshape(-1)[-1])                  # waits for the timed chain
    dist.barrier(dev)
    dt = time.perf_counter() - t0
    return mesh.data * batch_size * seq * timed * K / dt


def time_decode(cfg: LlamaConfig, batch: int, prompt_len: int = 64,
                new_tokens: int = 128, bf16_params: bool = False,
                kv_dtype: Optional[str] = None, reps: int = 3,
                device=None) -> float:
    """Generated tokens/sec of the KV-cache decode loop
    (``models.generate.generate``, greedy), the JAX function's contract:
    one warm call, then ``reps`` timed calls. The two serving levers:
    ``bf16_params`` casts a copy of the fp32 weights to bf16 (the weight
    bytes dominate at batch 1), ``kv_dtype="bfloat16"`` halves the cache
    bytes (they dominate once the batch amortizes the weights). The
    weights and the prompt come from explicit generators (seeds 0 and 1)
    on ``device`` (None: CUDA, raising without a card)."""
    from .device import resolve_device, synchronize
    from .models import generate as gen
    from .tree import tree_map

    dev = resolve_device(device)
    params = tree_map(
        lambda a: (a.to(torch.bfloat16) if bf16_params
                   and a.dtype == torch.float32 else a).to(dev),
        llama.init_llama(cfg, torch.Generator().manual_seed(0),
                         device="cpu").tree())
    g = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=g).to(dev)
    out = gen.generate(params, prompt, cfg, new_tokens, kv_dtype=kv_dtype,
                       device=dev)
    synchronize(dev)                                 # warm
    t0 = time.perf_counter()
    for _ in range(reps):
        out = gen.generate(params, prompt, cfg, new_tokens,
                           kv_dtype=kv_dtype, device=dev)
    int(out[0, -1])                                  # waits for the chain
    return batch * new_tokens * reps / (time.perf_counter() - t0)


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
