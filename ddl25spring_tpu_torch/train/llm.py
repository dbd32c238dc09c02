"""End-to-end LLM training entry point: counterpart of the JAX package's
``train/llm.py`` (``train_llm_dp``, ``eval_llm``, ``LLMTrainReport``).

``train_llm_dp`` runs the data-parallel trainer: tokenizer → token stream
(each rank its own shard) → ``parallel.dp`` step over
``llama.forward_loss`` (gradient aggregation, per step or K steps per
dispatch; weight aggregation; ZeRO-1) → optimizer apply, with the JAX
loop's loss list, ``loss_sink``, ``log_every``, checkpoints with resume,
and throughput accounting (all ranks' tokens, timed after
``warmup_steps_excluded`` steps, on a host read of the loss). At
``TrainConfig.data > 1`` it runs as ``data`` processes joined by a gloo
group (``parallel.distributed``): a call from a plain process starts them
and returns rank 0's report; a call inside a group uses that group. The
rest of the JAX trainer (hierarchical DP, compressed and overlapped
collectives, resilience, elastic mode, telemetry, numerics, remat) raises
``NotImplementedError`` naming its ROADMAP.md entry. ``on_checkpoint`` is
the checkpoint publication hook of the train→deploy conveyor
(``serving/deploy.py``).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field, fields
from typing import Callable, List, Optional

import numpy as np
import torch

from ..bench_utils import make_optimizer
from ..config import LlamaConfig, TrainConfig
from ..data.tokens import TokenStream, shard_batches
from ..metrics import ResilienceStats
from ..models import llama
from ..ops.adam import fused_adam
from ..parallel import distributed as dist
from ..parallel import dp
from ..tokenizers import load_tokenizer
from ..tree import tree_leaves


@dataclass
class LLMTrainReport:
    losses: List[float] = field(default_factory=list)
    tokens_per_sec: float = 0.0
    steps: int = 0
    wall_time: float = 0.0
    start_step: int = 0       # > 0 when the run resumed from a checkpoint
    resilience: ResilienceStats = field(default_factory=ResilienceStats)


# TrainConfig fields the port does not run yet at a non-default value, with
# the ROADMAP.md entry that ports each.
_QUEUED = {
    "dcn": "queue A item 8 (hierarchical collectives)",
    "stage": "queue A item 4 (pipeline parallelism)",
    "model": "queue A item 8 (tensor parallelism)",
    "seq": "queue A item 8 (sequence parallelism)",
    "wire": "queue A item 8 (compressed collectives)",
    "wire_dcn": "queue A item 8 (compressed collectives)",
    "overlap_microbatches": "queue A item 8 (overlapped ring sync)",
    "comm_buckets": "queue A item 8 (overlapped ring sync)",
    "numerics_every": "queue A item 9 (telemetry)",
    "psa": "queue A item 8 (tensor parallelism)",
    "remat": "queue A item 9 (activation rematerialization)",
}


def unsupported_train_fields(train_cfg: TrainConfig) -> List[str]:
    """Names of the fields of ``train_cfg`` this trainer does not run,
    each with its ROADMAP.md entry."""
    default = TrainConfig()
    return [f"{f.name}={getattr(train_cfg, f.name)!r} ({_QUEUED[f.name]})"
            for f in fields(TrainConfig) if f.name in _QUEUED
            and getattr(train_cfg, f.name) != getattr(default, f.name)]


def eval_llm(params, model_cfg: LlamaConfig, *, n_batches: int = 16,
             batch_size: int = 8, skip: int = 0, tokenizer=None,
             seed: int = 1, stream=None) -> dict:
    """Held-out evaluation on the parameters' device: mean next-token loss
    and perplexity over ``n_batches`` through the fused head. On the
    synthetic corpus a different ``seed`` is a disjoint corpus; for a
    file corpus pass ``skip`` past the training window. Returns
    ``{"loss", "perplexity", "n_tokens"}``."""
    tok = tokenizer or load_tokenizer()
    model_cfg = model_cfg.replace(vocab_size=tok.vocab_size)
    device = tree_leaves(llama.as_tree(params))[0].device
    if stream is None:
        stream = TokenStream(tok, batch_size, model_cfg.ctx_size, skip=skip,
                             seed=seed)
    stream = iter(stream)
    total = 0.0
    n_tokens = 0
    with torch.no_grad():
        for _ in range(n_batches):
            batch = torch.as_tensor(next(stream), dtype=torch.long,
                                    device=device)
            total += float(llama.forward_loss(params, batch, model_cfg))
            n_tokens += batch.shape[0] * (batch.shape[1] - 1)
    mean = total / n_batches
    return {"loss": mean, "perplexity": math.exp(min(mean, 30.0)),
            "n_tokens": n_tokens}


def _make_trainer_optimizer(train_cfg: TrainConfig):
    """TrainConfig.optimizer → optimizer: "adam" (the reference's optax
    Adam) is the same recurrence as "fused"; the rest go through
    ``bench_utils.make_optimizer`` ("fused", "pallas", "master")."""
    if train_cfg.optimizer == "adam":
        return fused_adam(train_cfg.lr)
    return make_optimizer(train_cfg.optimizer, train_cfg.lr)


def _setup_checkpoint(checkpoint_dir: Optional[str], state, iters: int,
                      log_fn: Callable[[str], None], *,
                      stats: Optional[ResilienceStats] = None):
    """The resume preamble: open the checkpoint directory and restore the
    newest step that verifies into ``state``'s layout (a corrupt newest
    step falls back to the one before, ``checkpoint.py``). Returns
    ``(ckpt, state, start_step, done)``; ``done`` means the checkpoint is
    already at or past ``iters``."""
    if checkpoint_dir is None:
        return None, state, 0, False
    from ..checkpoint import Checkpointer
    ckpt = Checkpointer(checkpoint_dir, stats=stats)
    start_step = 0
    if ckpt.latest_step() is not None:
        state = ckpt.restore(state)
        # The step that restored, not latest_step(): after a corrupt-step
        # fallback they differ, and resuming from the corrupt step's index
        # would skip data the weights never saw.
        start_step = int(ckpt.restored_step)
        if start_step != int(ckpt.latest_step()):
            log_fn(f"latest step {int(ckpt.latest_step())} unreadable; "
                   f"fell back to step {start_step}")
        log_fn(f"resumed from step {start_step}")
    if start_step >= iters:
        log_fn(f"checkpoint already at step {start_step} >= iters {iters}; "
               "nothing to train")
        ckpt.close()
        return ckpt, state, start_step, True
    return ckpt, state, start_step, False


def _notify_checkpoint(hook, step: int, state, log_fn) -> None:
    """Call the publication hook after a successful save with the step and
    the live state, so a serving fleet can take the weights while training
    goes on. A hook that raises loses that publication, never the run."""
    if hook is None:
        return
    try:
        hook(step, state)
    except Exception as e:
        log_fn(f"checkpoint publication hook at step {step} failed "
               f"({type(e).__name__}: {e}); continuing")


def _run_loop(step_fn, state, batches, train_cfg: TrainConfig,
              to_device: Callable, *, n_data: int, start_step: int, ckpt,
              checkpoint_every: int, loss_sink, sink_every: int,
              log_every: int, log_fn, warmup_steps_excluded: int,
              stats: ResilienceStats, steps_per_dispatch: int = 1,
              on_checkpoint=None) -> LLMTrainReport:
    """The training loop. Iterations before ``start_step`` (a resume) only
    consume their batches, so the data order is an uninterrupted run's.

    Per step (``steps_per_dispatch`` 1): one step per batch; device losses
    are buffered and read to host floats at sink boundaries (every
    ``sink_every`` steps and at the end); the timer starts on a host read
    of the loss after ``warmup_steps_excluded`` steps; a checkpoint every
    ``checkpoint_every`` steps and one at the end.

    Windowed (K = ``steps_per_dispatch`` > 1): chunks end on multiples of K
    (a resume from another step realigns with one shorter first chunk);
    each chunk's ``[k, B, T]`` window goes to the device in one copy, the
    next chunk's is staged on the host while the device runs this one, and
    the step returns the ``[k]`` losses; warmup, sink flushes and
    checkpoints fall on chunk edges (a checkpoint at the first edge at or
    after each ``checkpoint_every`` boundary). ``on_checkpoint(step,
    state)`` follows every save that succeeded."""
    report = LLMTrainReport(start_step=start_step, resilience=stats)
    tokens_per_step = n_data * train_cfg.batch_size * train_cfg.seq_len
    shape = (train_cfg.batch_size, train_cfg.seq_len)
    t_start = None
    excluded_steps = warmup_steps_excluded
    last_saved = -1
    pending = []   # (first step index, device loss or [k] losses)

    def _flush_losses():
        for it0, ls in pending:
            for j, v in enumerate(ls.reshape(-1).tolist()):
                i = it0 + j
                report.losses.append(v)
                if loss_sink is not None and (i % sink_every == 0
                                              or i == train_cfg.iters - 1):
                    loss_sink(i, v)
        pending.clear()

    def _checkpoint(at: int) -> None:
        nonlocal last_saved
        try:
            # overwrite: after a corrupt-latest fallback resume the loop
            # re-treads step indices the dead lineage already wrote.
            ckpt.save(at, state, overwrite=True)
            last_saved = at
        except OSError as e:
            log_fn(f"periodic checkpoint at {at} failed after retries "
                   f"({type(e).__name__}: {e}); continuing")
            return
        _notify_checkpoint(on_checkpoint, at, state, log_fn)

    K = steps_per_dispatch
    if K <= 1:
        for it in range(train_cfg.iters):
            host_batch = next(batches).reshape(shape)
            if it < start_step:
                continue            # resume: replay the stream
            state, loss = step_fn(state, to_device(host_batch))
            if it + 1 == start_step + warmup_steps_excluded:
                float(loss)             # hard sync before starting the timer
                t_start = time.perf_counter()
            pending.append((it, loss))
            if it % sink_every == 0 or it == train_cfg.iters - 1:
                _flush_losses()
            if log_every and it % log_every == 0:
                log_fn(f"iter {it}: loss {float(loss):.4f}")
            if ckpt is not None and (it + 1) % checkpoint_every == 0:
                _checkpoint(it + 1)
    else:
        chunks = []
        edge = start_step
        while edge < train_cfg.iters:
            nxt = min(train_cfg.iters, (edge // K + 1) * K)
            chunks.append((edge, nxt))
            edge = nxt

        def _window(it0, it1):
            return np.stack([next(batches).reshape(shape)
                             for _ in range(it1 - it0)])

        for _ in range(start_step):     # resume: replay the stream
            next(batches)
        staged = None
        last_flush_edge = start_step
        for ci, (it0, it1) in enumerate(chunks):
            window = staged if staged is not None else _window(it0, it1)
            state, losses = step_fn(state, to_device(window))
            # Stage the next window while the device runs this one.
            staged = _window(*chunks[ci + 1]) if ci + 1 < len(chunks) \
                else None
            pending.append((it0, losses))
            if log_every:
                for i in range(it0, it1):
                    if i % log_every == 0:
                        log_fn(f"iter {i}: loss {float(losses[i - it0]):.4f}")
            if t_start is None:
                float(losses[-1])   # warmup quantized to the first chunk
                t_start = time.perf_counter()
                excluded_steps = it1 - it0
            if (it1 - last_flush_edge >= sink_every
                    or it1 == train_cfg.iters):
                _flush_losses()
                last_flush_edge = it1
            if ckpt is not None and (it1 // checkpoint_every
                                     > it0 // checkpoint_every):
                _checkpoint(it1)
    if ckpt is not None:
        if train_cfg.iters != last_saved:
            ckpt.save(train_cfg.iters, state, overwrite=True)
            _notify_checkpoint(on_checkpoint, train_cfg.iters, state, log_fn)
        ckpt.close()
    _flush_losses()
    report.steps = train_cfg.iters - start_step
    if t_start is not None and report.steps > excluded_steps:
        report.wall_time = time.perf_counter() - t_start
        timed = report.steps - excluded_steps
        report.tokens_per_sec = tokens_per_step * timed / report.wall_time
    return report


def _check_dispatch(train_cfg: TrainConfig, aggregation: str) -> None:
    """The JAX trainer's ValueErrors for what does not compose."""
    if train_cfg.steps_per_dispatch < 1:
        raise ValueError(f"steps_per_dispatch must be >= 1 (got "
                         f"{train_cfg.steps_per_dispatch})")
    if aggregation == "zero1":
        if train_cfg.accum_steps != 1:
            raise ValueError("accum_steps composes with gradient aggregation "
                             "only (zero1 scatters the raw local gradient)")
    elif aggregation == "weight":
        if train_cfg.accum_steps != 1:
            raise ValueError("accum_steps needs gradient aggregation")
        if train_cfg.steps_per_dispatch != 1:
            raise ValueError("steps_per_dispatch > 1 supports gradient and "
                             "zero1 aggregation only")
    elif aggregation != "gradient":
        raise ValueError(f"unknown aggregation {aggregation!r}: expected "
                         "'gradient', 'weight' or 'zero1'")


def _train_rank(model_cfg, train_cfg, kwargs: dict, *, device):
    """One rank of a ``train_llm_dp`` call that started its own ranks."""
    return train_llm_dp(model_cfg, train_cfg, device=device, **kwargs)


def _quiet(*_args) -> None:
    """The log of every rank but 0."""


def train_llm_dp(model_cfg: Optional[LlamaConfig] = None,
                 train_cfg: Optional[TrainConfig] = None, *,
                 tokenizer=None,
                 aggregation: str = "gradient",
                 log_every: int = 100,
                 log_fn: Callable[[str], None] = print,
                 warmup_steps_excluded: int = 2,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 1000,
                 loss_sink: Optional[Callable[[int, float], None]] = None,
                 sink_every: int = 10,
                 resilience=None,
                 fault_plan=None,
                 telemetry=None,
                 on_checkpoint=None,
                 scale_hook=None,
                 device=None) -> LLMTrainReport:
    """Train the tiny-Llama data-parallel over ``train_cfg.data`` ranks on
    ``device`` (default CUDA, rank r on ``cuda:(r % device_count)``;
    raises when no card is present); returns the losses (averaged over the
    ranks) and all ranks' throughput.

    ``aggregation``: "gradient" (per step, or ``steps_per_dispatch`` = K
    steps per window), "weight" (no ``accum_steps``, no K > 1) or "zero1"
    (no ``accum_steps``). With no process group, ``data > 1`` starts
    ``data`` ranks (``distributed.run_ranks``) and returns rank 0's report;
    ``log_fn`` and ``loss_sink`` then run in rank 0's process and must
    pickle (a module-level function). Inside a group, the group's size
    must be ``data``, and rank 0 alone logs and sinks.

    The model's vocab is the tokenizer's (``load_tokenizer``: the
    SentencePiece model when one is found, else bytes, vocab 259). Rank
    i's batches are ``batch_size × seq_len`` windows of shard i's stream
    (``shard_batches``, skip i·5000: the JAX trainer's data order), weights
    come from ``llama.init_llama`` seeded ``train_cfg.seed`` (the same on
    every rank), ``accum_steps`` splits each batch into microbatches.

    ``checkpoint_dir``: restore the newest valid step there and skip the
    iterations it covers, save every ``checkpoint_every`` steps and at the
    end. ``loss_sink(it, loss)`` fires every ``sink_every`` iterations
    (and at the last) with the host loss. ``on_checkpoint(step, state)``
    runs after every successful save (periodic and final; on every rank of
    a group), e.g. ``serving.CheckpointPublisher``; a hook that raises is
    logged and training goes on. ``resilience``, ``fault_plan``,
    ``telemetry``, ``scale_hook`` and the ``TrainConfig`` fields
    ``unsupported_train_fields`` names raise ``NotImplementedError``
    naming ROADMAP.md."""
    train_cfg = train_cfg or TrainConfig()
    queued = unsupported_train_fields(train_cfg)
    for name, val, where in (
            ("resilience", resilience, "queue A item 9"),
            ("fault_plan", fault_plan, "queue A item 9"),
            ("telemetry", telemetry, "queue A item 9"),
            ("scale_hook", scale_hook, "queue A item 9")):
        if val is not None:
            queued.append(f"{name} ({where})")
    if model_cfg is not None and model_cfg.remat:
        queued.append("LlamaConfig.remat (queue A item 9)")
    if queued:
        raise NotImplementedError(
            "train_llm_dp does not run these yet; see ROADMAP.md: "
            + "; ".join(queued))
    _check_dispatch(train_cfg, aggregation)
    if train_cfg.data > 1 and not dist.is_initialized():
        kwargs = dict(tokenizer=tokenizer, aggregation=aggregation,
                      log_every=log_every, log_fn=log_fn,
                      warmup_steps_excluded=warmup_steps_excluded,
                      checkpoint_dir=checkpoint_dir,
                      checkpoint_every=checkpoint_every, loss_sink=loss_sink,
                      sink_every=sink_every, on_checkpoint=on_checkpoint)
        return dist.run_ranks(_train_rank, train_cfg.data, model_cfg,
                              train_cfg, kwargs, device=device)[0]
    n_data = dist.world_size()
    if n_data != train_cfg.data:
        raise ValueError(f"TrainConfig.data={train_cfg.data} but the process "
                         f"group has {n_data} ranks")
    dev = dist.rank_device(device)
    rank = dist.get_rank()
    if rank != 0:
        log_fn, loss_sink = _quiet, None
    tok = tokenizer or load_tokenizer()
    model_cfg = (model_cfg or LlamaConfig()).replace(
        vocab_size=tok.vocab_size)
    model = llama.init_llama(model_cfg,
                             torch.Generator().manual_seed(train_cfg.seed),
                             device=dev)
    optimizer = _make_trainer_optimizer(train_cfg)

    def loss_fn(p, batch):
        return llama.forward_loss(p, batch, model_cfg)

    params = model.tree()
    spd = train_cfg.steps_per_dispatch
    if aggregation == "zero1":
        make = dp.make_zero1_multi_step if spd > 1 else dp.make_zero1_step
        state, step_fn = make(loss_fn, optimizer, params)
    else:
        if aggregation == "weight":
            step_fn = dp.make_weight_aggregation_step(loss_fn, optimizer)
        else:
            make = (dp.make_multi_step if spd > 1
                    else dp.make_grad_aggregation_step)
            step_fn = make(loss_fn, optimizer,
                           accum_steps=train_cfg.accum_steps)
        state = dp.init_state(params, optimizer)
    stats = ResilienceStats()
    ckpt, state, start_step, done = _setup_checkpoint(
        checkpoint_dir, state, train_cfg.iters, log_fn, stats=stats)
    if done:
        return LLMTrainReport(start_step=start_step, resilience=stats)
    batches = shard_batches(tok, train_cfg.batch_size, train_cfg.seq_len,
                            rank, shard_skip=5000, seed=train_cfg.seed)
    return _run_loop(
        step_fn, state, batches, train_cfg,
        lambda b: torch.as_tensor(b, dtype=torch.long, device=dev),
        n_data=n_data, start_step=start_step, ckpt=ckpt,
        checkpoint_every=checkpoint_every, loss_sink=loss_sink,
        sink_every=sink_every, log_every=log_every, log_fn=log_fn,
        warmup_steps_excluded=warmup_steps_excluded, stats=stats,
        steps_per_dispatch=spd, on_checkpoint=on_checkpoint)
