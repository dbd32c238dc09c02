"""End-to-end LLM training entry point: counterpart of the JAX package's
``train/llm.py`` (``train_llm_dp``, ``eval_llm``, ``LLMTrainReport``).

``train_llm_dp`` runs the data-parallel gradient-aggregation trainer at a
world of one process: tokenizer → token stream → ``parallel.dp`` step over
``llama.forward_loss`` → optimizer apply, with the JAX loop's loss list,
``loss_sink``, ``log_every`` and throughput accounting (timed after
``warmup_steps_excluded`` steps, on a host read of the loss). The rest of
the JAX trainer (multi-process DP, checkpoints, resilience, elastic mode,
telemetry, the fused and compressed dispatch paths) raises
``NotImplementedError`` naming its ROADMAP.md entry.
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
from ..data.tokens import TokenStream, sharded_batches
from ..device import resolve_device
from ..models import llama
from ..ops.adam import fused_adam
from ..parallel import dp
from ..tokenizers import load_tokenizer
from ..tree import tree_leaves


@dataclass
class LLMTrainReport:
    losses: List[float] = field(default_factory=list)
    tokens_per_sec: float = 0.0
    steps: int = 0
    wall_time: float = 0.0


# TrainConfig fields the port does not run yet at a non-default value, with
# the ROADMAP.md entry that ports each.
_QUEUED = {
    "data": "queue A item 2 (multi-process DP, torch.distributed)",
    "dcn": "queue A item 8 (hierarchical collectives)",
    "stage": "queue A item 4 (pipeline parallelism)",
    "model": "queue A item 8 (tensor parallelism)",
    "seq": "queue A item 8 (sequence parallelism)",
    "wire": "queue A item 8 (compressed collectives)",
    "wire_dcn": "queue A item 8 (compressed collectives)",
    "steps_per_dispatch": "queue A item 2 (multi-step dispatch)",
    "overlap_microbatches": "queue A item 8 (overlapped ring sync)",
    "comm_buckets": "queue A item 8 (overlapped ring sync)",
    "numerics_every": "queue A item 9 (telemetry)",
    "psa": "queue A item 8 (tensor parallelism)",
    "remat": "queue A (activation rematerialization)",
}


def unsupported_train_fields(train_cfg: TrainConfig) -> List[str]:
    """Names of the fields of ``train_cfg`` this trainer does not run,
    each with its ROADMAP.md entry."""
    default = TrainConfig()
    out = [f"{f.name}={getattr(train_cfg, f.name)!r} ({_QUEUED[f.name]})"
           for f in fields(TrainConfig) if f.name in _QUEUED
           and getattr(train_cfg, f.name) != getattr(default, f.name)]
    if train_cfg.optimizer == "master":
        out.append("optimizer='master' (queue A item 3)")
    return out


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
    ``bench_utils.make_optimizer``."""
    if train_cfg.optimizer == "adam":
        return fused_adam(train_cfg.lr)
    return make_optimizer(train_cfg.optimizer, train_cfg.lr)


def _run_loop(step_fn, state, batches, train_cfg: TrainConfig,
              to_device: Callable, *, loss_sink, sink_every: int,
              log_every: int, log_fn,
              warmup_steps_excluded: int) -> LLMTrainReport:
    """The training loop: one step per batch, device losses buffered and
    read to host floats at sink boundaries (every ``sink_every`` steps and
    at the end), ``log_every`` logging, and throughput timed from a host
    read of the loss after ``warmup_steps_excluded`` steps to the end."""
    report = LLMTrainReport()
    tokens_per_step = train_cfg.batch_size * train_cfg.seq_len
    t_start = None
    pending = []     # (step index, device loss): bounded by sink_every

    def _flush_losses():
        for i, loss in pending:
            v = float(loss)
            report.losses.append(v)
            if loss_sink is not None and (i % sink_every == 0
                                          or i == train_cfg.iters - 1):
                loss_sink(i, v)
        pending.clear()

    for it in range(train_cfg.iters):
        host_batch = next(batches).reshape(train_cfg.batch_size,
                                           train_cfg.seq_len)
        state, loss = step_fn(state, to_device(host_batch))
        if it + 1 == warmup_steps_excluded:
            float(loss)                 # hard sync before starting the timer
            t_start = time.perf_counter()
        pending.append((it, loss))
        if it % sink_every == 0 or it == train_cfg.iters - 1:
            _flush_losses()
        if log_every and it % log_every == 0:
            log_fn(f"iter {it}: loss {float(loss):.4f}")
    _flush_losses()
    report.steps = train_cfg.iters
    if t_start is not None and report.steps > warmup_steps_excluded:
        report.wall_time = time.perf_counter() - t_start
        timed = report.steps - warmup_steps_excluded
        report.tokens_per_sec = tokens_per_step * timed / report.wall_time
    return report


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
    """Train the tiny-Llama with data-parallel gradient aggregation at a
    world of one process on ``device`` (default CUDA; raises when no card
    is present); returns the losses and throughput.

    The model's vocab is the tokenizer's (``load_tokenizer``: the
    SentencePiece model when one is found, else bytes, vocab 259). Batches
    are ``train_cfg.batch_size × seq_len`` windows of the token stream
    (``sharded_batches`` shard 0, the JAX trainer's data order), weights
    come from ``llama.init_llama`` seeded ``train_cfg.seed``, and
    ``train_cfg.accum_steps`` splits each batch into microbatches.

    ``loss_sink(it, loss)`` fires every ``sink_every`` iterations (and at
    the last) with the host loss. ``checkpoint_every`` is accepted for
    parity and does nothing without ``checkpoint_dir``, which, like
    ``resilience``, ``fault_plan``, ``telemetry``, ``on_checkpoint``,
    ``scale_hook``, aggregation other than "gradient" and the
    ``TrainConfig`` fields ``unsupported_train_fields`` names, raises
    ``NotImplementedError`` naming ROADMAP.md."""
    del checkpoint_every
    train_cfg = train_cfg or TrainConfig()
    queued = unsupported_train_fields(train_cfg)
    for name, val, where in (
            ("checkpoint_dir", checkpoint_dir, "queue A item 2"),
            ("resilience", resilience, "queue A item 9"),
            ("fault_plan", fault_plan, "queue A item 9"),
            ("telemetry", telemetry, "queue A item 9"),
            ("on_checkpoint", on_checkpoint, "queue A item 7"),
            ("scale_hook", scale_hook, "queue A item 9")):
        if val is not None:
            queued.append(f"{name} ({where})")
    if aggregation != "gradient":
        queued.append(f"aggregation={aggregation!r} (queue A item 2)")
    if queued:
        raise NotImplementedError(
            "train_llm_dp does not run these yet; see ROADMAP.md: "
            + "; ".join(queued))
    dev = resolve_device(device)
    tok = tokenizer or load_tokenizer()
    model_cfg = (model_cfg or LlamaConfig()).replace(
        vocab_size=tok.vocab_size)
    if model_cfg.remat:
        raise NotImplementedError("LlamaConfig.remat is not ported yet: "
                                  "ROADMAP.md, queue A")
    model = llama.init_llama(model_cfg,
                             torch.Generator().manual_seed(train_cfg.seed),
                             device=dev)
    optimizer = _make_trainer_optimizer(train_cfg)
    step_fn = dp.make_grad_aggregation_step(
        lambda p, batch: llama.forward_loss(p, batch, model_cfg), optimizer,
        accum_steps=train_cfg.accum_steps)
    state = dp.init_state(llama.as_tree(model), optimizer)
    # Shard 0 of the JAX trainer's disjoint per-shard windows.
    batches = sharded_batches(tok, train_cfg.batch_size, train_cfg.seq_len,
                              1, shard_skip=5000, seed=train_cfg.seed)
    return _run_loop(
        step_fn, state, batches, train_cfg,
        lambda b: torch.as_tensor(np.asarray(b), dtype=torch.long,
                                  device=dev),
        loss_sink=loss_sink, sink_every=sink_every, log_every=log_every,
        log_fn=log_fn, warmup_steps_excluded=warmup_steps_excluded)
