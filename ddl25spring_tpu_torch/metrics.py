"""Experiment records and metrics of federated learning (numpy), and the
fault-handling counters of the resilience layer.

The port's own copy of the JAX package's ``metrics.py`` (which it may not
import): ``RunResult`` holds the algorithm, N/C/B/E/η/seed and per-round
wall time, cumulative message count and test accuracy; the message count
of a round is ``2·(round+1)·clients_per_round`` (one message down and one
up per sampled client, cumulative). ``ResilienceStats`` counts retries,
checkpoint fallbacks and reshards (``checkpoint.py``) and the counters of
the rest of the resilience layer. Arrays may be numpy arrays or tensors
on any device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclass
class RunResult:
    algorithm: str
    nr_clients: int                # N
    client_fraction: float         # C
    batch_size: int                # B (-1 ⇒ ∞)
    epochs: int                    # E
    lr: float                      # η
    seed: int
    wall_time: List[float] = field(default_factory=list)
    message_count: List[int] = field(default_factory=list)
    test_accuracy: List[float] = field(default_factory=list)

    def record_round(self, wall_time: float, message_count: int,
                     test_accuracy: float) -> None:
        self.wall_time.append(float(wall_time))
        self.message_count.append(int(message_count))
        self.test_accuracy.append(float(test_accuracy))

    @property
    def rounds(self) -> int:
        return len(self.test_accuracy)

    def as_df(self):
        """Pandas rendering (η column, B=-1 shown as ∞). Imports pandas
        only when called."""
        import pandas as pd

        b = "∞" if self.batch_size == -1 else self.batch_size
        return pd.DataFrame({
            "algorithm": self.algorithm, "N": self.nr_clients,
            "C": self.client_fraction, "B": b, "E": self.epochs,
            "η": self.lr, "seed": self.seed,
            "round": np.arange(1, self.rounds + 1),
            "wall_time": np.asarray(self.wall_time),
            "message_count": np.asarray(self.message_count),
            "test_accuracy": np.asarray(self.test_accuracy)})


@dataclass
class ResilienceStats:
    """Fault-handling counters shared by the resilience layer: one instance
    threads through a run (the checkpointer counts ``retries``,
    ``ckpt_fallbacks`` and ``ckpt_reshards``), and ``as_dict`` shows a
    fault-free run's zeros."""

    skipped_steps: int = 0       # non-finite loss/params: the step is a no-op
    anomalies: int = 0           # update-norm outliers
    rollbacks: int = 0           # consecutive bad steps: restore
    retries: int = 0             # retry_call invocations that re-tried IO
    ckpt_fallbacks: int = 0      # Checkpointer.restore skipped corrupt steps
    dropped_clients: int = 0     # FL: vanished clients excluded from rounds
    straggler_clients: int = 0   # FL: over-deadline clients excluded
    skipped_rounds: int = 0      # FL: rounds with zero surviving clients
    preemptions: int = 0         # SIGTERM force-save exits
    remeshes: int = 0            # elastic: replica-loss re-mesh recoveries
    ckpt_reshards: int = 0       # cross-topology checkpoint restores

    def as_dict(self) -> dict:
        return {k: int(v) for k, v in self.__dict__.items()}

    def merge(self, other: "ResilienceStats") -> "ResilienceStats":
        for k, v in other.__dict__.items():
            setattr(self, k, getattr(self, k) + v)
        return self

    def delta(self, prev: dict) -> dict:
        """Counters that moved since the ``prev`` snapshot (an ``as_dict``
        result); empty when nothing changed."""
        return {k: v - prev.get(k, 0) for k, v in self.as_dict().items()
                if v != prev.get(k, 0)}

    @property
    def total_faults_handled(self) -> int:
        return sum(self.__dict__.values())


def message_count(round_idx: int, clients_per_round: int) -> int:
    """Cumulative messages after round ``round_idx`` (0-based)."""
    return 2 * (round_idx + 1) * clients_per_round


def accuracy(logits, labels) -> float:
    """Top-1 accuracy."""
    return float((_np(logits).argmax(-1) == _np(labels)).mean())


def confusion_matrix(predictions, labels, num_classes: int) -> np.ndarray:
    """Rows are true labels, columns predictions."""
    predictions = _np(predictions).reshape(-1)
    labels = _np(labels).reshape(-1)
    cm = np.zeros((num_classes, num_classes), dtype=np.int64)
    np.add.at(cm, (labels, predictions), 1)
    return cm


def backdoor_metrics(clean_predictions, clean_labels, triggered_predictions,
                     backdoor_label: int) -> tuple:
    """(clean accuracy, attack success rate): the share of the triggered
    test set classified as the backdoor label, over the samples whose true
    label is not already the backdoor label (0.0 when there are none)."""
    clean_predictions = _np(clean_predictions)
    clean_labels = _np(clean_labels)
    triggered_predictions = _np(triggered_predictions)
    clean_acc = float((clean_predictions == clean_labels).mean())
    mask = clean_labels != backdoor_label
    if not mask.any():
        return clean_acc, 0.0
    asr = float((triggered_predictions[mask] == backdoor_label).mean())
    return clean_acc, asr
