"""Autoscale twin: one diurnal traffic curve drives train ⇄ serve moves,
the port's twin of the JAX package's ``experiments/autoscale_smoke.py`` at
its sizes.

An elastic ZeRO-1 training run of four ranks and a two-engine serving
fleet share one pool while an ``Autoscaler`` watches the fleet router's
rolling TTFT windows. The JAX smoke runs both in one process; here the
trainer's ranks are processes, and the fleet and the autoscaler live in
the process that is the training world's rank 0, which calls
``scale_hook`` (``ServeHook``) at every interior chunk edge. A seeded
diurnal arrival curve peaks, p95 TTFT climbs past the pressure line
(0.8 × SLO, below the violation line), and the policy drains training at a
chunk edge, shrinks the world and activates the second engine; when
traffic ebbs the move reverses. Each decision reaches the trainer through
``ElasticController.resize``, with the just-drained state pinned as the
mirror, so a planned move replays nothing.

The bars, checked: zero SLO violations (the serving clock is a tick
counter, so TTFT counts queueing ticks and every request's TTFT must stay
within the SLO; the stream, ``--telemetry-dir``, is there for the JAX
package's ``experiments/slo_monitor.py --check`` too); zero lost steps
(every loss present and finite, ``steps_replayed == 0`` on every move); no
retrace of any world's step or of any fleet engine; moves in both
directions; every ``scale`` event schema-valid.

    python -m ddl25spring_tpu_torch.experiments.autoscale_smoke \\
        --out autoscale-smoke.json --telemetry-dir autoscale-telemetry \\
        [--device cpu]

Exit code 0 only when every bar holds.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

TINY = dict(vocab_size=259, dmodel=20, num_heads=2, n_layers=2, ctx_size=16)
SERVE = dict(vocab_size=97, dmodel=32, num_heads=4, n_layers=2, ctx_size=32)
PAGED = dict(num_blocks=24, block_len=4, max_blocks_per_seq=8)
SPD = 2
WORLD = 4


class _TickClock:
    """Deterministic serving clock: a tick count × ``dt``, advanced only by
    the control loop, so TTFT counts queueing ticks on any machine."""

    def __init__(self, dt: float):
        self.t = 0.0
        self.dt = dt

    def __call__(self) -> float:
        return self.t

    def advance(self) -> None:
        self.t += self.dt


class ServeHook:
    """The control plane as a ``scale_hook``: at each training chunk edge
    it advances the serving clock, injects the tick's arrivals, serves
    them on the active engines, reads the router's p95 TTFT, ticks the
    ``Autoscaler`` and applies its decision to the fleet, returning the
    new training world. The fleet is built on the first call, in the
    process that makes it (the training world's rank 0); ``telemetry``'s
    stream takes its ``scale`` and serving events."""

    def __init__(self, iters: int, slo_s: float, device, telemetry=None):
        self.iters, self.slo_s = iters, slo_s
        self.device, self.telemetry = device, telemetry
        self.fleet = None

    def _setup(self) -> None:
        import numpy as np
        import torch

        from ..config import LlamaConfig
        from ..models import llama
        from ..resilience import Autoscaler, AutoscalePolicy
        from ..serving import PagedKVConfig, ServingFleet

        events = (self.telemetry.events if self.telemetry is not None
                  else None)
        self.clock = _TickClock(dt=0.05)
        cfg = LlamaConfig(**SERVE)
        params = llama.init_llama(cfg, torch.Generator().manual_seed(0),
                                  device=self.device)
        # window_s spans ~2 control ticks (edge gap 1.0 s): the pressure
        # signal follows the current load, and an ebb empties the windows.
        self.fleet = ServingFleet(params, cfg, PagedKVConfig(**PAGED),
                                  num_engines=2, num_slots=2,
                                  prefill_chunk=4, events=events,
                                  token_events=False, clock=self.clock,
                                  window_s=2.0, device=self.device)
        self.fleet.set_active(1)                 # serving starts minimal
        self.scaler = Autoscaler(
            AutoscalePolicy(ttft_slo_s=self.slo_s, pressure_frac=0.8,
                            ebb_frac=0.3, sustain=2, cooldown=2,
                            min_train_world=3, max_train_world=WORLD,
                            min_serve_engines=1, max_serve_engines=2),
            train_world=WORLD, serve_engines=1, events=events)
        # One day of sinusoidal load over the interior chunk edges.
        self.ticks = self.iters // SPD - 1
        rng = np.random.default_rng(7)
        self.curve = [max(0, round(4.0 + 4.0 * math.sin(
            2 * math.pi * i / self.ticks))) for i in range(self.ticks)]
        self.prompts = [tuple(int(t) for t in rng.integers(1, 97, size=6))
                        for _ in range(sum(self.curve))]
        self.p95_trace = []
        self._rid = iter(range(len(self.prompts)))

    def __call__(self, it: int, train_world: int):
        from ..resilience import router_ttft_p95
        from ..serving import Request

        if self.fleet is None:
            self._setup()
        self.clock.t += 1.0                      # inter-edge gap
        edge = it // SPD - 1
        for _ in range(self.curve[edge] if 0 <= edge < self.ticks else 0):
            rid = next(self._rid)
            self.fleet.submit(Request(rid=f"r{rid}", prompt=self.prompts[rid],
                                      max_new=6), now=self.clock())
        while self.fleet.outstanding:
            self.fleet.tick()
            self.clock.advance()
        self.fleet.router.harvest(self.clock())
        p95 = router_ttft_p95(self.fleet.router)
        self.p95_trace.append(None if p95 is None else round(p95, 4))
        decision = self.scaler.tick(p95, it=it)
        if decision is None:
            return None
        self.fleet.set_active(decision.serve_engines)
        return decision.train_world

    def summary(self) -> dict:
        recs = self.fleet.records
        ttfts = [r.ttft_s for r in recs.values()]
        return {"curve": self.curve, "p95_trace": self.p95_trace,
                "decisions": [d._asdict() for d in self.scaler.decisions],
                "train_world": self.scaler.train_world,
                "retraces": self.fleet.retraces(),
                "requests": len(self.prompts), "served": len(recs),
                "complete": all(len(r.tokens) == r.max_new
                                for r in recs.values()),
                "max_ttft_s": max((t for t in ttfts if t is not None),
                                  default=None),
                "ttft_missing": sum(t is None for t in ttfts)}


def rank_program(iters: int, slo_s: float, telemetry, *, device) -> dict:
    """One rank: the elastic ZeRO-1 trainer with ``ServeHook``; returns
    the report and, from the rank whose process ran the hook, its
    summary."""
    from ..config import LlamaConfig, ResilienceConfig, TrainConfig
    from ..parallel.programs import _report_dict
    from ..tokenizers import ByteTokenizer
    from ..train.llm import train_llm_dp

    hook = ServeHook(iters, slo_s, device, telemetry)
    rep = train_llm_dp(
        LlamaConfig(**TINY),
        TrainConfig(batch_size=2, seq_len=16, lr=3e-3, iters=iters,
                    data=WORLD, steps_per_dispatch=SPD),
        tokenizer=ByteTokenizer(), aggregation="zero1", log_every=0,
        resilience=ResilienceConfig(elastic=True, mirror_every=1),
        telemetry=telemetry, scale_hook=hook, device=device)
    return {"report": _report_dict(rep),
            "hook": hook.summary() if hook.fleet is not None else None}


def run(out_path: str, telemetry_dir: str = None, iters: int = 24,
        slo_s: float = 1.2, device=None) -> int:
    from ..parallel import distributed
    from ..telemetry import Telemetry, read_events, validate_event

    telemetry = Telemetry(telemetry_dir) if telemetry_dir else None
    try:
        ranks = distributed.run_ranks(rank_program, WORLD, iters, slo_s,
                                      telemetry, device=device, timeout=900)
    finally:
        if telemetry is not None:
            telemetry.close()
    report = ranks[0]["report"]
    hooks = [r["hook"] for r in ranks if r["hook"] is not None]
    if len(hooks) != 1:
        raise RuntimeError(f"the scale hook ran in {len(hooks)} processes")
    hook = hooks[0]
    decisions = hook["decisions"]
    directions = [d["direction"] for d in decisions]
    moves = report["remeshes"]
    checks = {
        "both_directions_driven": ("train_to_serve" in directions
                                   and "serve_to_train" in directions),
        "every_decision_applied": (
            bool(moves) and len(moves) == len(decisions)
            and moves[-1]["new_world"] == hook["train_world"]
            and all(r["direction"] == ("shrink" if d["direction"]
                                       == "train_to_serve" else "grow")
                    for r, d in zip(moves, decisions))),
        "zero_lost_steps": (len(report["losses"]) == iters
                            and all(math.isfinite(x)
                                    for x in report["losses"])
                            and all(r["steps_replayed"] == 0
                                    for r in moves)),
        "fleet_zero_retraces": all(r == 0 for r in hook["retraces"]),
        "all_requests_served": (hook["complete"]
                                and hook["served"] == sum(hook["curve"])),
        "zero_slo_violations": (hook["ttft_missing"] == 0
                                and hook["max_ttft_s"] is not None
                                and hook["max_ttft_s"] <= slo_s),
    }
    per_world_compiles = {}
    if telemetry_dir:
        stream = read_events(telemetry.events_path)
        scale_events = [e for e in stream if e.get("type") == "scale"]
        checks["scale_events_valid"] = (
            len(scale_events) == len(decisions)
            and all(validate_event(e) == [] for e in scale_events))
        for e in stream:
            if e.get("type") == "compile":
                row = per_world_compiles.setdefault(
                    e.get("name"), {"compiles": 0, "retraces": 0})
                row["compiles"] += 1
                row["retraces"] += int(bool(e.get("retrace")))
        checks["train_zero_retraces_per_world"] = (
            per_world_compiles != {} and all(
                v["retraces"] == 0 for v in per_world_compiles.values()))
    seconds = [r["seconds"] for r in moves]
    result = {
        "ok": all(checks.values()),
        "iters": iters,
        "ttft_slo_s": slo_s,
        "curve": hook["curve"],
        "p95_trace": hook["p95_trace"],
        "decisions": decisions,
        "scale_remeshes": moves,
        "per_world_compiles": per_world_compiles,
        "max_ttft_s": hook["max_ttft_s"],
        "requests_served": hook["served"],
        "checks": checks,
        "rows": [
            {"metric": "remesh_seconds_scale",
             "value": max(seconds) if seconds else 0.0,
             "variant": "autoscale-smoke"},
            {"metric": "steps_replayed_scale",
             "value": float(sum(r["steps_replayed"] for r in moves)),
             "variant": "autoscale-smoke"},
        ],
    }
    with open(out_path, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result, indent=2))
    if not result["ok"]:
        failed = [k for k, v in checks.items() if not v]
        print(f"autoscale smoke FAILED checks: {failed}", file=sys.stderr)
    return 0 if result["ok"] else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="autoscale-smoke.json",
                    help="acceptance-evidence JSON path")
    ap.add_argument("--telemetry-dir", default=None,
                    help="write the shared train+serve events.jsonl here")
    ap.add_argument("--iters", type=int, default=24)
    ap.add_argument("--ttft-slo", type=float, default=1.2,
                    help="serving TTFT SLO in (tick clock) seconds; the "
                         "policy scales at 0.8x this line")
    ap.add_argument("--device", default=None,
                    help="'cpu', or the default CUDA (every rank shares it)")
    a = ap.parse_args(argv)
    return run(a.out, a.telemetry_dir, a.iters, a.ttft_slo, a.device)


if __name__ == "__main__":
    sys.exit(main())
