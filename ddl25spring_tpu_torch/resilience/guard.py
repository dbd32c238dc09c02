"""StepGuard: the port's counterpart of the JAX package's
``resilience/guard.py``, a self-healing wrapper around a training step.

``step_fn(state, batch) -> (state, loss)`` in, the same signature out, plus:

- **all-finite check** on the loss and the updated parameters;
- **skip-and-count**: a bad step is discarded (the state is its pre-step
  value again) and ``stats.skipped_steps`` counts it;
- **EMA update-norm anomaly detector**: a finite step whose parameter-delta
  norm exceeds ``anomaly_factor`` × the running EMA (after ``ema_warmup``
  good steps) is a spike, counted in ``stats.anomalies`` and skipped;
- **rollback**: after ``max_consecutive_bad`` consecutive bad steps, the
  newest valid checkpoint (``Checkpointer.restore``, with its corrupt-step
  fallback) replaces the weights; the caller's data stream goes on, so
  the faulted window's batches are consumed, not learned.

The port's steps update the state in place (``TrainState.params`` is the
model's own parameter tree), where the JAX steps donate their input and
return new arrays. So the guard clones the whole state before the step,
and on a skip, an anomaly or a rollback it ``copy_``s the clone (or the
restored checkpoint) back INTO the live tensors of the state it was given,
and returns that state: returning the clone instead would leave the NaNs
in the model the caller holds.

Fault-free transparency: on a good step the guard returns the step's
outputs untouched, so a guarded run is bitwise an unguarded one. Its cost
is the clone of the state and one host read of the verdict per step
(``measure_overhead``).

Chunked stepping (``steps_per_dispatch`` > 1): the loss is the window's
``[K]`` vector, and a skip counts ``K`` steps.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Tuple

import torch

from ..device import resolve_device
from ..metrics import ResilienceStats
from ..tree import nested_leaves, tree_copy, tree_leaves


def _copy_into(live, src) -> None:
    """``copy_`` every tensor leaf of ``src`` into the same leaf of
    ``live`` (trees of one structure), in place."""
    with torch.no_grad():
        for dst, s in zip(nested_leaves(live), nested_leaves(src)):
            if isinstance(dst, torch.Tensor):
                dst.copy_(s)


@torch.no_grad()
def _verdict(old_params, new_params, loss, group=None,
             shared=None) -> Tuple[bool, float]:
    """``(all finite, update L2 norm)``: one pass over the leaves, one host
    read. ``group`` (a ``distributed.Group``: the stage group of a
    pipeline, the model group of a tensor-parallel shard; or a tuple of
    groups, a pipeline stage's and then its model shards'): this rank
    holds only its part of the model, so the count of non-finite values
    and the squared norm are summed over the group (each in turn), and
    every rank takes the same decision on the whole model's update.
    ``shared``: per leaf, whether every rank of the (last) group holds it
    whole (a replicated leaf), whose square then counts once in the
    sum."""
    groups = (() if group is None else tuple(group)
              if isinstance(group, (tuple, list)) else (group,))
    finite = torch.isfinite(loss).all()
    sq = torch.zeros((), dtype=torch.float32, device=loss.device)
    for i, (o, n) in enumerate(zip(tree_leaves(old_params),
                                   tree_leaves(new_params))):
        d = (n - o).float()
        finite = finite & torch.isfinite(n).all()
        term = (d * d).sum()
        sq = sq + (term / groups[-1].size
                   if shared is not None and shared[i] else term)
    if groups:
        from ..parallel import distributed as dist
        verdict = torch.stack([(~finite).float(), sq])
        for g in groups:
            verdict = dist.psum(verdict, record=False, group=g)
        bad, sq = verdict
        finite = bad == 0
    ok, norm = torch.stack([finite.float(), sq.sqrt()]).tolist()
    return bool(ok), norm


class StepGuard:
    """Wraps a training step with skip, anomaly and rollback self-healing.

    ``step_fn(state, batch) -> (state, loss)`` (or ``(state, (loss,
    NumericsSummary))``); ``state`` exposes ``.params``. ``ckpt``: a
    ``checkpoint.Checkpointer`` for rollback after ``max_consecutive_bad``
    consecutive bad steps (without one the guard skips indefinitely).
    ``stats``: the ``metrics.ResilienceStats`` to count into.
    ``ema_decay`` / ``anomaly_factor`` / ``ema_warmup``: the update-norm
    detector, which learns from good steps only and arms after
    ``ema_warmup`` of them; ``anomaly_factor <= 0`` disables it.
    ``group``, ``shared``: the group whose ranks hold the parts of the
    model (a pipeline's stages, a tensor-parallel row's model shards), so
    that the verdict covers the whole model, and the leaves each of them
    holds whole (``_verdict``)."""

    def __init__(self, step_fn: Callable, *,
                 ckpt=None,
                 stats: Optional[ResilienceStats] = None,
                 max_consecutive_bad: int = 3,
                 ema_decay: float = 0.98,
                 anomaly_factor: float = 10.0,
                 ema_warmup: int = 20,
                 group=None, shared=None):
        self._step_fn = step_fn
        self._group, self._shared = group, shared
        self._ckpt = ckpt
        self.stats = stats if stats is not None else ResilienceStats()
        self.max_consecutive_bad = max_consecutive_bad
        self.ema_decay = ema_decay
        self.anomaly_factor = anomaly_factor
        self.ema_warmup = ema_warmup
        self._ema: Optional[float] = None
        self._good_steps = 0
        self._consecutive_bad = 0
        self._last_trip: Optional[dict] = None

    def pop_trip(self) -> Optional[dict]:
        """The attribution of the latest bad step, then cleared: the leaf
        paths of the rejected state that held NaN/Inf, whether the loss was
        non-finite, the update norm. The training loop attaches it to the
        ``fault`` event, so a flight-recorder bundle names the leaf."""
        trip, self._last_trip = self._last_trip, None
        return trip

    def __call__(self, state, batch):
        old = tree_copy(state)
        new_state, out = self._step_fn(state, batch)
        loss = out[0] if isinstance(out, tuple) else out
        ok, upd_norm = _verdict(old.params, new_state.params, loss,
                                self._group, self._shared)
        anomalous = False
        if (ok and self.anomaly_factor > 0 and self._ema is not None
                and self._good_steps >= self.ema_warmup):
            anomalous = upd_norm > self.anomaly_factor * self._ema
        if ok and not anomalous:
            self._ema = (upd_norm if self._ema is None
                         else self.ema_decay * self._ema
                         + (1.0 - self.ema_decay) * upd_norm)
            self._good_steps += 1
            self._consecutive_bad = 0
            return new_state, out
        # A bad step: count it, name what went non-finite while the
        # rejected state is still there, then put the pre-step values back.
        if anomalous:
            self.stats.anomalies += 1
        else:
            self.stats.skipped_steps += int(loss.numel())
        try:
            from ..telemetry.introspect import nonfinite_leaves
            self._last_trip = {
                "anomalous": anomalous,
                "loss_nonfinite": not bool(torch.isfinite(loss).all()),
                "update_norm": upd_norm,
                "nonfinite_params": nonfinite_leaves(new_state.params),
            }
        except Exception:
            self._last_trip = None
        _copy_into(state, old)
        self._consecutive_bad += 1
        if (self._ckpt is not None
                and self._consecutive_bad >= self.max_consecutive_bad):
            try:
                restored = self._ckpt.restore(old)
            except FileNotFoundError:
                return state, out       # nothing on disk yet; keep skipping
            _copy_into(state, restored)
            self.stats.rollbacks += 1
            self._consecutive_bad = 0
        return state, out


def measure_overhead(make_state_and_step, batch, *, steps: int = 20,
                     warmup: int = 3, device=None,
                     report: Optional[dict] = None
                     ) -> Tuple[float, ResilienceStats]:
    """The fault-free guard tax: ``steps`` raw steps against ``steps``
    guarded steps, each from a fresh ``make_state_and_step() -> (state,
    step_fn)``, on ``device`` (default CUDA; raises without a card),
    timed in turns (raw, guarded, guarded, raw) so that a first-run
    effect or a drift lands on both sides alike. Returns
    ``(100 · (t_guarded / t_raw − 1), guard stats)``; all-zero stats show
    the run was fault-free. ``report`` (a dict) receives
    ``raw_ms_per_step`` and ``guarded_ms_per_step``, each the mean of its
    two turns, and ``turns_ms_per_step``, the four in order. Each timing
    ends on a host read of the last loss, which waits for the device."""
    dev = resolve_device(device)
    batch = batch.to(dev)
    stats = ResilienceStats()

    def run(guarded: bool) -> float:
        state, step = make_state_and_step()
        fn = StepGuard(step, stats=stats) if guarded else step
        loss = None
        for _ in range(warmup):
            state, loss = fn(state, batch)
        if loss is not None:
            float(loss.reshape(-1)[-1])
        t0 = time.perf_counter()
        for _ in range(steps):
            state, loss = fn(state, batch)
        float(loss.reshape(-1)[-1])
        return time.perf_counter() - t0

    order = (False, True, True, False)
    turns = [run(guarded) for guarded in order]
    t_raw = sum(t for t, g in zip(turns, order) if not g)
    t_guarded = sum(t for t, g in zip(turns, order) if g)
    if report is not None:
        report["raw_ms_per_step"] = t_raw / (2 * steps) * 1e3
        report["guarded_ms_per_step"] = t_guarded / (2 * steps) * 1e3
        report["turns_ms_per_step"] = [t / steps * 1e3 for t in turns]
    return 100.0 * (t_guarded / max(t_raw, 1e-9) - 1.0), stats
