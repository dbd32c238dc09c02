"""SLO-driven autoscaler: counterpart of the JAX package's
``resilience/autoscale.py``, the policy half of the elasticity control
plane, copied as standard-library host logic.

``Autoscaler.tick`` reads one rolling p95 TTFT (``router_ttft_p95`` over
the serving ``Router``'s per-engine windows) and returns a
``ScaleDecision`` or None:

====================  ====================================================
signal                action
====================  ====================================================
p95 TTFT >= pressure  sustained ``sustain`` ticks -> move ``step`` replicas
(pressure_frac·SLO)   train -> serve
p95 TTFT <= ebb       sustained ``sustain`` ticks -> move ``step`` engines
(ebb_frac·SLO), or    serve -> train
no traffic at all
====================  ====================================================

The scale-out line sits below the SLO (``pressure_frac`` < 1), so capacity
arrives before requests miss their budget; ``cooldown`` ticks of inaction
after every move stop flapping (streaks still accumulate through them); a
train→serve move is vetoed while the caller's pool headroom sits below
``min_headroom_frac``; the ``min_``/``max_`` bounds are walls.

The loop touches neither the trainer nor the fleet, so the same
measurement sequence gives the same decisions. The caller applies them:
``ServingFleet.set_active(decision.serve_engines)`` on the serving side,
with ``ServingFleet.pool_headroom`` of the post-move set as the headroom
feed. On the training side ``train_llm_dp(scale_hook=)`` polls a hook at
every chunk edge on the world's rank 0, and a hook that returns
``decision.train_world`` re-meshes the data world through
``ElasticController.resize`` (``resilience/elastic.py``), with nothing
replayed. Every decision emits one ``scale`` event with the post-move
allocation, the signal and its value.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional

from ..telemetry.events import EventLog
from ..telemetry.registry import percentile


@dataclass(frozen=True)
class AutoscalePolicy:
    """Thresholds and guard rails for ``Autoscaler``.

    ``ttft_slo_s`` is the serving SLO the whole loop protects (same
    number slo_monitor's ``--ttft`` takes). ``pressure_frac`` /
    ``ebb_frac`` scale it into the scale-out / scale-in trigger lines;
    pressure MUST be < 1.0 or the trigger only fires after a violation
    has already happened. ``sustain`` consecutive ticks must agree before
    a move; ``cooldown`` ticks are skipped after one. ``step`` replicas
    move per decision. The ``min_``/``max_`` bounds are hard walls — a
    decision that would cross one is simply not made (training never
    drains below ``min_train_world``; serving never below
    ``min_serve_engines``).

    ``min_headroom_frac`` > 0 arms the MEMORY guard rail (schema v9's
    headroom SLO, telemetry/memory.py): a train→serve move is vetoed
    while the caller-supplied pool headroom (min free fraction across
    the engines the move would activate — ``ServingFleet.pool_headroom``)
    sits below it. Latency pressure never justifies scaling serving up
    into KV pools that cannot fit the load — that converts an SLO miss
    into admission stalls (or an OOM on a real accelerator)."""

    ttft_slo_s: float
    max_train_world: int
    max_serve_engines: int
    pressure_frac: float = 0.8
    ebb_frac: float = 0.3
    sustain: int = 2
    cooldown: int = 2
    min_train_world: int = 1
    min_serve_engines: int = 1
    step: int = 1
    min_headroom_frac: float = 0.0

    def __post_init__(self):
        if not self.ttft_slo_s > 0:
            raise ValueError(f"ttft_slo_s={self.ttft_slo_s} must be > 0")
        if not 0 < self.pressure_frac < 1:
            raise ValueError(
                f"pressure_frac={self.pressure_frac} must be in (0, 1) — "
                "at >= 1 the autoscaler only reacts AFTER an SLO violation")
        if not 0 <= self.ebb_frac < self.pressure_frac:
            raise ValueError(
                f"ebb_frac={self.ebb_frac} must be in [0, pressure_frac) — "
                "overlapping bands would scale both ways on one signal")
        if self.sustain < 1 or self.cooldown < 0 or self.step < 1:
            raise ValueError(
                f"sustain={self.sustain} (>=1), cooldown={self.cooldown} "
                f"(>=0), step={self.step} (>=1)")
        if not 1 <= self.min_train_world <= self.max_train_world:
            raise ValueError(
                f"need 1 <= min_train_world={self.min_train_world} <= "
                f"max_train_world={self.max_train_world}")
        if not 1 <= self.min_serve_engines <= self.max_serve_engines:
            raise ValueError(
                f"need 1 <= min_serve_engines={self.min_serve_engines} <= "
                f"max_serve_engines={self.max_serve_engines}")
        if not 0 <= self.min_headroom_frac < 1:
            raise ValueError(
                f"min_headroom_frac={self.min_headroom_frac} must be in "
                "[0, 1) — a fraction of pool capacity, and requiring a "
                "FULLY free pool would veto every scale-out")


class ScaleDecision(NamedTuple):
    """One capacity move, POST-transition allocation (matches the
    ``scale`` telemetry event's required fields)."""

    direction: str      # "train_to_serve" | "serve_to_train"
    train_world: int    # training data-parallel world AFTER the move
    serve_engines: int  # active serving engines AFTER the move
    signal: str         # "ttft_pressure" | "traffic_ebb"
    value: float        # the p95 TTFT that triggered it (0.0 for idle)


class Autoscaler:
    """Streak-and-cooldown policy loop over a TTFT measurement feed.

    Holds the control plane's view of the allocation (``train_world``,
    ``serve_engines``); ``tick`` advances it. The caller is responsible
    for actually applying each returned ``ScaleDecision`` — the loop
    assumes every decision it makes lands (a serving fleet applies one
    through ``set_active`` before the next tick, so the view and the
    fleet agree at every decision point)."""

    def __init__(self, policy: AutoscalePolicy, *, train_world: int,
                 serve_engines: int, events: Optional[EventLog] = None,
                 log_fn=print):
        p = policy
        if not p.min_train_world <= train_world <= p.max_train_world:
            raise ValueError(f"train_world={train_world} outside policy "
                             f"[{p.min_train_world}, {p.max_train_world}]")
        if not p.min_serve_engines <= serve_engines <= p.max_serve_engines:
            raise ValueError(f"serve_engines={serve_engines} outside policy "
                             f"[{p.min_serve_engines}, {p.max_serve_engines}]")
        self.policy = p
        self.train_world = int(train_world)
        self.serve_engines = int(serve_engines)
        self.decisions: List[ScaleDecision] = []
        self.events = events
        self.log_fn = log_fn
        self._hot = 0       # consecutive ticks at/above the pressure line
        self._ebb = 0       # consecutive ticks at/below the ebb line
        self._cool = 0      # ticks of enforced inaction remaining

    def tick(self, ttft_p95_s: Optional[float],
             it: Optional[int] = None,
             headroom_frac: Optional[float] = None
             ) -> Optional[ScaleDecision]:
        """One policy step. ``ttft_p95_s`` is the current rolling p95 TTFT
        (None = no completed requests in the window, which reads as ebb:
        an idle fleet is over-provisioned by definition). ``it`` tags the
        telemetry event with the training iteration. ``headroom_frac`` is
        the memory guard-rail feed (``ServingFleet.pool_headroom`` of the
        POST-move active set): with ``policy.min_headroom_frac`` armed, a
        train→serve move is vetoed while headroom sits below the floor —
        the streak keeps accumulating, so the move fires the first tick
        the pool drains enough. None (no feed) never vetoes. Returns the
        decision to apply, or None."""
        p = self.policy
        hot = (ttft_p95_s is not None
               and ttft_p95_s >= p.pressure_frac * p.ttft_slo_s)
        ebb = (ttft_p95_s is None
               or ttft_p95_s <= p.ebb_frac * p.ttft_slo_s)
        # Streaks accumulate THROUGH cooldown (pressure that persists
        # across a move should act the first tick cooldown expires), but
        # decisions do not.
        self._hot = self._hot + 1 if hot else 0
        self._ebb = self._ebb + 1 if ebb else 0
        if self._cool > 0:
            self._cool -= 1
            return None
        want_out = (self._hot >= p.sustain
                    and self.train_world - p.step >= p.min_train_world
                    and self.serve_engines + p.step <= p.max_serve_engines)
        starved = (want_out and p.min_headroom_frac > 0
                   and headroom_frac is not None
                   and headroom_frac < p.min_headroom_frac)
        if want_out and not starved:
            decision = ScaleDecision(
                "train_to_serve", self.train_world - p.step,
                self.serve_engines + p.step, "ttft_pressure",
                float(ttft_p95_s))
        elif starved:
            if self.log_fn is not None:
                self.log_fn(f"[autoscale] train_to_serve vetoed: pool "
                            f"headroom {headroom_frac:.2f} < floor "
                            f"{p.min_headroom_frac:.2f} — not scaling "
                            "serving into a pool that can't fit it")
            return None
        elif (self._ebb >= p.sustain
                and self.serve_engines - p.step >= p.min_serve_engines
                and self.train_world + p.step <= p.max_train_world):
            decision = ScaleDecision(
                "serve_to_train", self.train_world + p.step,
                self.serve_engines - p.step, "traffic_ebb",
                0.0 if ttft_p95_s is None else float(ttft_p95_s))
        else:
            return None
        self.train_world = decision.train_world
        self.serve_engines = decision.serve_engines
        self._hot = self._ebb = 0
        self._cool = p.cooldown
        self.decisions.append(decision)
        if self.events is not None:
            self.events.scale(direction=decision.direction,
                              train_world=decision.train_world,
                              serve_engines=decision.serve_engines,
                              signal=decision.signal, value=decision.value,
                              **({} if it is None else {"it": int(it)}))
        if self.log_fn is not None:
            self.log_fn(f"[autoscale] {decision.direction} on "
                        f"{decision.signal} (p95 ttft "
                        f"{decision.value * 1e3:.1f} ms vs slo "
                        f"{p.ttft_slo_s * 1e3:.1f} ms) -> train_world="
                        f"{decision.train_world} serve_engines="
                        f"{decision.serve_engines}")
        return decision


def router_ttft_p95(router) -> Optional[float]:
    """Current fleet-wide p95 TTFT from a serving ``Router``'s per-engine
    rolling windows (the same windows ``predicted_ttft`` routing reads).
    None when no window holds a sample. Call ``router.harvest(now)``
    first to fold freshly completed requests in and expire old ones."""
    vals = [ttft for window in router._ttft for _, ttft in window]
    return percentile(vals, 95.0) if vals else None
