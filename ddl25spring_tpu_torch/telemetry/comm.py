"""Communication-volume accounting for the data-parallel collectives: the
port's counterpart of the JAX package's ``telemetry/comm.py``.

The JAX package records each collective of a step while tracing it
abstractly (``jax.eval_shape``), once per program, scaled by scan trips.
The port cannot trace abstractly, so the collectives of
``parallel/distributed.py`` (``psum``, ``pmean``, ``pmean_tree``,
``psum_tree``, ``psum_scatter``, ``all_gather``, ``broadcast``) and its
pipeline hops (op ``ppermute`` on the ``stage`` axis, one record per
send) record into the active ``collecting()`` list as they run, each
under its call site's label and over its group's axis, and
``measure_comm`` runs one real call of the step (the trainer gives it a
copy of the state). A K-step dispatch runs its collectives K times and so
records K records of scale 1, which ``CommProfile``'s aggregates sum to
what the JAX package's one record of scale K gives.

Accounting semantics (the reference's):
- ``payload_bytes`` is the local operand size in its dtype;
- ``wire_bytes_per_device`` applies the ring algorithm's factors to the
  payload: all-reduce (psum/pmean/pmax) ``2·(n−1)/n``, all_gather ``(n−1)``
  × the local piece, psum_scatter ``(n−1)/n``; n = 1 makes every reduce's
  wire cost 0. (The port's gloo route runs psum_scatter and all_gather as
  full all-reduces; the profile counts the algorithm the JAX program runs,
  so the two packages' profiles compare.)
- ``scale`` multiplies a record (1 for every record the port makes).
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

_collector: contextvars.ContextVar[Optional[list]] = \
    contextvars.ContextVar("ddl25_comm_collector", default=None)

AXIS = "data"       # the default axis: the whole process group


@dataclass(frozen=True)
class CommRecord:
    """One collective call site, as seen at trace time."""
    op: str                  # pmean | psum | pmax | all_gather | ...
    label: str               # call-site semantic name ("grad_allreduce", ...)
    axis: str                # mesh axis name
    axis_size: Optional[int]  # None when not resolvable at trace time
    payload_bytes: int       # local operand bytes in the wire dtype
    scale: int               # executions per step (scan trip count, ...)

    @property
    def wire_bytes_per_device(self) -> float:
        """Ring-algorithm per-device wire estimate for ONE execution.

        An unknown axis size reports factor 1.0 rather than the 0 of a
        world of one."""
        n = self.axis_size
        if n is None:
            return float(self.payload_bytes)
        if self.op in ("pmean", "psum", "pmax"):
            factor = 2.0 * (n - 1) / n
        elif self.op == "all_gather":
            factor = float(n - 1)
        elif self.op == "psum_scatter":
            factor = (n - 1) / n
        elif self.op == "ppermute":
            factor = 1.0 if n > 1 else 0.0
        else:
            factor = 1.0
        return factor * self.payload_bytes

    def as_dict(self) -> dict:
        return {"op": self.op, "label": self.label, "axis": self.axis,
                "axis_size": self.axis_size,
                "payload_bytes": int(self.payload_bytes),
                "scale": int(self.scale),
                "wire_bytes_per_device": self.wire_bytes_per_device}


@dataclass
class CommProfile:
    """All collectives of one traced step, with per-step aggregates."""
    records: List[CommRecord] = field(default_factory=list)

    @property
    def payload_bytes_per_step(self) -> int:
        return sum(r.payload_bytes * r.scale for r in self.records)

    @property
    def wire_bytes_per_device_per_step(self) -> float:
        return sum(r.wire_bytes_per_device * r.scale for r in self.records)

    def by_label(self) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        for r in self.records:
            agg = out.setdefault(r.label, {
                "op": r.op, "axis": r.axis, "axis_size": r.axis_size,
                "calls": 0, "payload_bytes": 0,
                "wire_bytes_per_device": 0.0})
            agg["calls"] += r.scale
            agg["payload_bytes"] += r.payload_bytes * r.scale
            agg["wire_bytes_per_device"] += r.wire_bytes_per_device * r.scale
        return out

    def by_axis(self) -> Dict[str, dict]:
        """Per-axis aggregates (``data``, and ``stage`` under pipeline
        parallelism)."""
        out: Dict[str, dict] = {}
        for r in self.records:
            agg = out.setdefault(r.axis, {
                "axis_size": r.axis_size, "calls": 0, "payload_bytes": 0,
                "wire_bytes_per_device": 0.0})
            agg["calls"] += r.scale
            agg["payload_bytes"] += r.payload_bytes * r.scale
            agg["wire_bytes_per_device"] += r.wire_bytes_per_device * r.scale
        return out

    def as_dict(self, *, steps_per_dispatch: int = 1,
                overlap_microbatches: int = 1) -> dict:
        """JSON-able shape for the run manifest: the per-call totals,
        ``collectives`` (``by_label``) and ``axes``. With
        ``steps_per_dispatch`` = K > 1 one call is one dispatch of K steps,
        and the per-train-step figures (the totals divided by K only) ride
        alongside, as in the JAX package."""
        d = {
            "payload_bytes_per_step": self.payload_bytes_per_step,
            "wire_bytes_per_device_per_step":
                self.wire_bytes_per_device_per_step,
            "collectives": self.by_label(),
            "axes": {
                ax: {**agg, **({"wire_bytes_per_device_per_train_step":
                                agg["wire_bytes_per_device"]
                                / steps_per_dispatch}
                               if steps_per_dispatch > 1 else {})}
                for ax, agg in self.by_axis().items()
            },
        }
        if steps_per_dispatch > 1:
            d["steps_per_dispatch"] = int(steps_per_dispatch)
            d["payload_bytes_per_train_step"] = \
                self.payload_bytes_per_step / steps_per_dispatch
            d["wire_bytes_per_device_per_train_step"] = \
                self.wire_bytes_per_device_per_step / steps_per_dispatch
        if overlap_microbatches > 1:
            d["overlap_microbatches"] = int(overlap_microbatches)
            per_step = (self.wire_bytes_per_device_per_step
                        / steps_per_dispatch)
            d["wire_bytes_per_device_per_microbatch"] = \
                per_step / overlap_microbatches
        return d


def tree_bytes(tree: Any) -> int:
    """Exact byte count of a tree's leaves (dicts, lists, tuples and
    NamedTuples of tensors or arrays): shape × dtype itemsize. A leaf with
    no dtype counts 4 bytes per element, as in the JAX package."""
    from ..tree import nested_leaves

    total = 0
    for leaf in nested_leaves(tree):
        if leaf is None:
            continue
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
            continue
        shape = tuple(getattr(leaf, "shape", ()))
        dtype = getattr(leaf, "dtype", None)
        itemsize = np.dtype(dtype).itemsize if dtype is not None else 4
        total += int(math.prod(shape)) * itemsize
    return total


def record(op: str, label: Optional[str], operand: Any,
           scale: int = 1, *, axis: str = AXIS,
           axis_size: Optional[int] = None) -> None:
    """Add one collective (or point-to-point hop) to the active collector
    (no-op without one): ``operand``'s bytes, over ``axis`` of
    ``axis_size`` ranks (default: the process group's ``data`` axis, all
    of the group's ranks)."""
    col = _collector.get()
    if col is None:
        return
    if axis_size is None:
        from ..parallel import distributed as dist
        axis_size = dist.world_size()
    col.append(CommRecord(op=op, label=label or op, axis=axis,
                          axis_size=axis_size,
                          payload_bytes=tree_bytes(operand),
                          scale=int(scale)))


@contextlib.contextmanager
def collecting() -> Iterator[List[CommRecord]]:
    """Install a fresh collector for the block: every collective that runs
    inside lands its record in the yielded list."""
    records: List[CommRecord] = []
    token = _collector.set(records)
    try:
        yield records
    finally:
        _collector.reset(token)


def measure_comm(fn, *args, **kwargs) -> Optional[CommProfile]:
    """The communication profile of one call ``fn(*args, **kwargs)``, which
    runs (every rank of a group must make it, as the collectives are
    real). A step updates its state in place: pass a copy of the state,
    or the live state before training starts. None when the call
    raises."""
    with collecting() as records:
        try:
            fn(*args, **kwargs)
        except Exception:
            return None
    return CommProfile(list(records))


@contextlib.contextmanager
def quiet() -> Iterator[None]:
    """Record nothing inside the block (a rematerialized forward repeats
    collectives the first forward recorded)."""
    token = _collector.set(None)
    try:
        yield
    finally:
        _collector.reset(token)
