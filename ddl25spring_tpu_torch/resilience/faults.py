"""Deterministic fault injection: the port's copy of the JAX package's
``resilience/faults.py``, the adversary half of the resilience layer.

A ``FaultPlan`` is a seedable, fully deterministic schedule of benign faults
— the infrastructure counterpart of fl/attacks.py's Byzantine adversaries.
It can, at chosen steps/rounds:

- corrupt gradients (``nan_grad`` / ``inf_grad`` / ``spike_grad``) by
  wrapping a train step (`wrap_step`) so the post-update state and loss are
  poisoned exactly as a non-finite or exploded gradient would poison them;
- drop (``drop_client``) or time out (``delay_client``) FL clients for a
  round — the servers re-weight aggregation over the survivors;
- corrupt the newest checkpoint on disk (`corrupt_latest_checkpoint`, on
  the port's ``<step>.pt`` files);
- deliver a simulated preemption (``preempt``: SIGTERM to this process) at
  a step boundary;
- kill data-parallel replicas (``device_loss``: the wrapped step raises
  ``ReplicaLossError`` instead of dispatching, modeling the dispatch dying
  with the device; ``resilience/elastic.py`` recovers from it);
- return previously-lost replicas (``device_return``: the wrapped step
  raises ``ReplicaReturnSignal`` instead of dispatching, modeling the
  cluster scheduler handing capacity back at a dispatch boundary).

Plans parse from a compact spec string so bench.py / experiments can take
them straight off a CLI flag or config field::

    "nan_grad@10"                 NaN gradient at step 10 (all leaves)
    "nan_grad@10:3"               NaN confined to leaf #3 (1-based index in
                                  tree-flatten-with-path order — the order
                                  telemetry.introspect.leaf_paths reports;
                                  what the NaN-attribution tests inject)
    "spike_grad@5:100"            gradient scaled by 100 at step 5
    "preempt@25"                  SIGTERM delivered before step 25
    "drop_client@3:2"             2 clients vanish in round 3
    "delay_client@1:1"            1 client straggles past deadline, round 1
    "device_loss@4"               1 DP replica dies at dispatch 4
    "device_loss@4:2"             2 DP replicas die at dispatch 4
    "device_return@6"             1 lost replica comes back at dispatch 6
    "device_return@6:2"           2 lost replicas come back at dispatch 6
    "nan_grad@10,preempt@25"      comma-composed

Determinism contract: the same (spec, seed) always injects the same faults
on the same steps and picks the same client subsets and victims, in this
package and in the JAX package alike (the choices are numpy's).
"""

from __future__ import annotations

import os
import re
import signal
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..tree import tree_leaves

GRAD_FAULTS = ("nan_grad", "inf_grad", "spike_grad")
CLIENT_FAULTS = ("drop_client", "delay_client")
KINDS = GRAD_FAULTS + CLIENT_FAULTS + ("preempt", "corrupt_ckpt",
                                       "device_loss", "device_return")

# Seed-stream salt for ReplicaLossError.victims, the JAX package's: frozen,
# not len(KINDS), so a committed (spec, seed) pair keeps its victims.
_VICTIM_SALT = 8


class ReplicaLossError(RuntimeError):
    """A data-parallel replica (device) died at dispatch ``step``.

    Raised by ``FaultPlan.wrap_step`` in place of running the scheduled
    dispatch — the injection-side model of a device failure surfacing as a
    failed dispatch. Without an elastic controller
    (``resilience.elastic.ElasticController``) it propagates and ends the
    run.

    ``victims(n)`` picks WHICH of the ``n`` current devices died — a
    seeded deterministic choice (same (seed, step) → same victims, the
    FaultPlan determinism contract, the JAX package's choice), always
    leaving at least one survivor."""

    def __init__(self, step: int, count: int = 1, seed: int = 0):
        super().__init__(f"replica loss at dispatch {step} "
                         f"({count} replica{'s' if count != 1 else ''})")
        self.step = int(step)
        self.count = max(1, int(count))
        self.seed = int(seed)

    def victims(self, n: int) -> List[int]:
        k = min(self.count, n - 1)
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.step, _VICTIM_SALT]))
        return sorted(int(i) for i in rng.choice(n, size=k, replace=False))


class ReplicaReturnSignal(RuntimeError):
    """Previously-lost data-parallel capacity came back at dispatch ``step``.

    The scale-UP twin of ``ReplicaLossError``: raised by
    ``FaultPlan.wrap_step`` in place of running the scheduled dispatch,
    with the incoming state untouched. Without an elastic controller
    (``resilience.elastic.ElasticController``) it propagates and ends the
    run.

    ``arrivals(lost)`` picks WHICH of the currently-lost replica slots
    come back — a seeded deterministic choice over the lost pool (same
    (seed, step, pool) → same arrivals), capped at the pool size. A
    distinct salt keeps the arrival stream independent of the victim
    stream even at a shared (seed, step)."""

    def __init__(self, step: int, count: int = 1, seed: int = 0):
        super().__init__(f"replica return at dispatch {step} "
                         f"({count} replica{'s' if count != 1 else ''})")
        self.step = int(step)
        self.count = max(1, int(count))
        self.seed = int(seed)

    def arrivals(self, lost: List[int]) -> List[int]:
        pool = sorted(int(i) for i in lost)
        k = min(self.count, len(pool))
        if k == 0:
            return []
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.step, _VICTIM_SALT + 1]))
        picked = rng.choice(len(pool), size=k, replace=False)
        return sorted(pool[int(i)] for i in picked)


@dataclass(frozen=True)
class FaultEvent:
    kind: str        # one of KINDS
    step: int        # train step (grad/preempt) or FL round (client faults)
    arg: float = 0.0  # spike scale / client count / unused

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(expected one of {KINDS})")


def parse_spec(spec: str) -> List[FaultEvent]:
    """``"kind@step[:arg],..."`` -> events. Whitespace-tolerant; empty spec
    -> no events."""
    events: List[FaultEvent] = []
    for part in filter(None, (p.strip() for p in spec.split(","))):
        if "@" not in part:
            raise ValueError(f"fault spec {part!r} lacks '@step'")
        kind, _, rest = part.partition("@")
        step_s, _, arg_s = rest.partition(":")
        events.append(FaultEvent(kind.strip(), int(step_s),
                                 float(arg_s) if arg_s else 0.0))
    return events


@dataclass
class FaultPlan:
    """A deterministic fault schedule plus the injection mechanics.

    ``events``: what happens when. ``seed``: drives every random choice the
    plan makes (which clients drop) — two plans with equal (events, seed)
    behave identically. An empty plan injects nothing and wraps steps as
    identity, so it is safe to thread through fault-free runs.
    """

    events: List[FaultEvent] = field(default_factory=list)
    seed: int = 0

    @classmethod
    def from_spec(cls, spec: str, *, seed: int = 0) -> "FaultPlan":
        return cls(parse_spec(spec), seed=seed)

    def __bool__(self) -> bool:
        return bool(self.events)

    # ----------------------------------------------------------- queries

    def _at(self, kinds: Tuple[str, ...], step: int) -> Optional[FaultEvent]:
        for e in self.events:
            if e.kind in kinds and e.step == step:
                return e
        return None

    def grad_fault_at(self, step: int) -> Optional[FaultEvent]:
        return self._at(GRAD_FAULTS, step)

    def preempt_at(self, step: int) -> bool:
        return self._at(("preempt",), step) is not None

    def surviving_clients(self, round_idx: int,
                          sampled_idx: np.ndarray) -> Tuple[np.ndarray, int, int]:
        """(bool mask over ``sampled_idx``, n_dropped, n_stragglers) for this
        round. Which of the sampled clients vanish/straggle is a seeded
        choice over the sampled set — deterministic per (plan, round), and
        independent of array memory layout. At least one survivor is kept
        whenever possible is NOT guaranteed: a plan may kill the whole
        round; servers handle the empty round by skipping it."""
        mask = np.ones(len(sampled_idx), dtype=bool)
        dropped = stragglers = 0
        for kind in CLIENT_FAULTS:
            e = self._at((kind,), round_idx)
            if e is None:
                continue
            n = max(1, int(e.arg)) if e.arg else 1
            n = min(n, int(mask.sum()))
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, round_idx,
                                        CLIENT_FAULTS.index(kind)]))
            victims = rng.choice(np.flatnonzero(mask), size=n, replace=False)
            mask[victims] = False
            if kind == "drop_client":
                dropped += n
            else:
                stragglers += n
        return mask, dropped, stragglers

    # --------------------------------------------------------- injection

    def device_loss_at(self, step: int) -> Optional[FaultEvent]:
        return self._at(("device_loss",), step)

    def device_return_at(self, step: int) -> Optional[FaultEvent]:
        return self._at(("device_return",), step)

    def wrap_step(self, step_fn, stats=None, *, start: int = 0,
                  leaf_map=None):
        """Wrap ``step_fn(state, batch) -> (state, loss)`` so gradient
        faults, simulated preemptions and replica losses fire at their
        scheduled steps (call indices from the wrap point, offset by
        ``start``).

        ``device_loss`` / ``device_return`` raise ``ReplicaLossError`` /
        ``ReplicaReturnSignal`` before the step runs; ``preempt`` sends
        SIGTERM to this process before the step runs. Gradient faults
        poison the step's outputs as the corrupted gradient would have:
        ``nan_grad`` / ``inf_grad`` write NaN/Inf into every updated
        parameter (or, with a nonzero ``arg``, into leaf #``arg`` only,
        1-based in ``tree_leaves`` order, which is the JAX package's
        flatten order) and the loss; ``spike_grad`` re-applies the step's
        parameter delta scaled by ``arg`` (default 100x) and scales the
        loss.

        The port's step updates the state in place, where the JAX step
        returns new arrays: the poison is written into the live parameter
        tensors, and ``spike_grad`` clones the parameters before the step
        (the JAX wrapper relies on its own pre-step copy). Fault-free
        steps pay nothing. A step that returns ``(loss, NumericsSummary)``
        keeps its summary; the poison lands on the loss.

        ``leaf_map`` (a pipeline stage: ``pp.global_leaf_map``) maps a
        leaf number of the whole model to this stage's own leaf number; a
        stage that holds no part of the targeted leaf poisons only the
        loss, and sees the fault through the guard's verdict."""
        counter = {"step": start}

        def wrapped(state, batch):
            step = counter["step"]
            counter["step"] += 1
            dl = self.device_loss_at(step)
            if dl is not None:
                raise ReplicaLossError(step, int(dl.arg) if dl.arg else 1,
                                       seed=self.seed)
            dr = self.device_return_at(step)
            if dr is not None:
                raise ReplicaReturnSignal(step,
                                          int(dr.arg) if dr.arg else 1,
                                          seed=self.seed)
            if self.preempt_at(step):
                os.kill(os.getpid(), signal.SIGTERM)
            e = self.grad_fault_at(step)
            old_params = None
            if e is not None and e.kind == "spike_grad":
                old_params = [p.detach().clone()
                              for p in tree_leaves(state.params)]
            new_state, out = step_fn(state, batch)
            if e is None:
                return new_state, out
            loss, aux = (out if isinstance(out, tuple) else (out, None))
            leaves = tree_leaves(new_state.params)
            with torch.no_grad():
                if e.kind == "spike_grad":
                    scale = e.arg if e.arg else 100.0
                    for old, new in zip(old_params, leaves):
                        new.copy_(old + scale * (new - old))
                    loss = loss * scale
                else:
                    bad = float("nan") if e.kind == "nan_grad" \
                        else float("inf")
                    target = int(e.arg) if e.arg else 0     # 0: every leaf
                    if target and leaf_map is not None:
                        target = leaf_map.get(target, -1)
                    for i, p in enumerate(leaves):
                        if target in (0, i + 1):
                            p.fill_(bad)
                    loss = torch.full_like(loss, bad)
            out = (loss, aux) if aux is not None else loss
            return new_state, out

        return wrapped


_STEP_FILE = re.compile(r"^(\d+)\.pt$")


def corrupt_latest_checkpoint(directory: str) -> str:
    """Corrupt the newest checkpoint step under ``directory`` on disk (the
    port's ``<step>.pt`` file): truncate it to half and append garbage,
    modeling a mid-write kill or a disk fault. Its digest manifest then
    fails, and ``Checkpointer.restore`` falls back to the step before.
    Returns the corrupted file's path. Deterministic."""
    steps = []
    for name in os.listdir(directory):
        m = _STEP_FILE.match(name)
        p = os.path.join(directory, name)
        if m and os.path.isfile(p):
            steps.append((int(m.group(1)), p))
    if not steps:
        raise FileNotFoundError(f"no checkpoint steps under {directory}")
    _, latest = max(steps)
    size = os.path.getsize(latest)
    with open(latest, "r+b" if size else "wb") as f:
        f.truncate(size // 2)
        f.seek(0, os.SEEK_END)
        f.write(b"\x00CORRUPT\x00")
    return latest
