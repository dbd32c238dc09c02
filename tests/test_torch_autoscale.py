"""The port's SLO autoscaler (``resilience/autoscale.py``) against the JAX
package's: for the same TTFT and headroom series the decisions, the log
lines and the ``scale`` events' fields are equal (a headroom veto, a
cooldown, both walls and ``None`` ticks included); ``router_ttft_p95``
reads the port's ``Router`` windows as a direct percentile does; the
policy's validation messages are JAX's; and the serving wiring on a
2-engine fleet at a tiny width moves engines both ways under a load that
rises and ebbs, with the same decisions as the JAX fleet under the same
script and every greedy stream equal to ``reference_stream``."""

import math
from collections import deque

import jax
import numpy as np
import pytest
import torch

from ddl25spring_tpu.config import LlamaConfig as JaxLlamaConfig
from ddl25spring_tpu.models import llama as jllama
from ddl25spring_tpu.resilience import autoscale as jas
from ddl25spring_tpu.serving import PagedKVConfig as JaxPagedKVConfig
from ddl25spring_tpu.serving import Request as JaxRequest
from ddl25spring_tpu.serving import ServingFleet as JaxServingFleet
from ddl25spring_tpu.telemetry.events import EventLog as JaxEventLog
from ddl25spring_tpu.telemetry.events import read_events, validate_event
from ddl25spring_tpu_torch.config import LlamaConfig
from ddl25spring_tpu_torch.convert import params_from_jax
from ddl25spring_tpu_torch.resilience import (Autoscaler, AutoscalePolicy,
                                              ScaleDecision, router_ttft_p95)
from ddl25spring_tpu_torch.resilience import autoscale as pas
from ddl25spring_tpu_torch.serving import (PagedKVConfig, Request, Router,
                                           ServingFleet, reference_stream)
from ddl25spring_tpu_torch.telemetry.events import EventLog
from ddl25spring_tpu_torch.telemetry.registry import percentile

torch.set_num_threads(1)

POLICY = dict(ttft_slo_s=1.0, pressure_frac=0.8, ebb_frac=0.3, sustain=2,
              cooldown=2, min_train_world=2, max_train_world=4,
              min_serve_engines=1, max_serve_engines=3, min_headroom_frac=0.2)
# (p95 TTFT, headroom): pressure held through a veto (headroom 0.1 < 0.2),
# a move once the pool drains, a cooldown that swallows a sustained streak,
# the serve wall (3 engines), None ticks read as ebb, the train wall.
SERIES = [(0.85, 0.5), (0.9, 0.1), (0.95, 0.1), (0.9, 0.6), (0.9, 0.6),
          (0.95, 0.6), (0.99, 0.6), (1.2, 0.6), (0.9, 0.6), (1.1, 0.6),
          (0.5, 0.9), (None, 1.0), (None, 1.0), (0.2, 1.0), (0.1, 1.0),
          (None, None), (0.05, 1.0), (None, 1.0), (0.1, 1.0), (None, 1.0),
          (0.9, None), (0.85, 0.05), (0.9, 0.05), (0.3, 1.0), (0.31, 1.0)]


def _replay(module, event_log, path, series, **kw):
    logs = []
    scaler = module.Autoscaler(module.AutoscalePolicy(**kw), train_world=4,
                               serve_engines=1, events=event_log(path),
                               log_fn=logs.append)
    out = [scaler.tick(v, it=i, headroom_frac=h)
           for i, (v, h) in enumerate(series)]
    scaler.events.close()
    return out, logs, scaler


@pytest.mark.parametrize("step", [1, 2])
def test_decisions_and_scale_events_equal_jax(tmp_path, step):
    kw = dict(POLICY, step=step,
              max_train_world=4 if step == 1 else 6,
              max_serve_engines=3 if step == 1 else 5, min_train_world=1)
    got, got_logs, port = _replay(pas, EventLog, str(tmp_path / "p.jsonl"),
                                  SERIES, **kw)
    want, want_logs, ref = _replay(jas, JaxEventLog,
                                   str(tmp_path / "j.jsonl"), SERIES, **kw)
    assert [None if d is None else tuple(d) for d in got] == \
        [None if d is None else tuple(d) for d in want]
    assert got_logs == want_logs
    assert any("vetoed" in line for line in got_logs)
    directions = {d.direction for d in port.decisions}
    assert directions == {"train_to_serve", "serve_to_train"}
    keys = ("type", "direction", "train_world", "serve_engines", "signal",
            "value", "it")
    pe = read_events(str(tmp_path / "p.jsonl"), strict=True)
    je = read_events(str(tmp_path / "j.jsonl"), strict=True)
    assert [{k: e.get(k) for k in keys} for e in pe] == \
        [{k: e.get(k) for k in keys} for e in je]
    assert len(pe) == len(port.decisions) and all(
        validate_event(e) == [] for e in pe)
    assert (port.train_world, port.serve_engines) == (ref.train_world,
                                                      ref.serve_engines)


def test_walls_hold_under_sustained_pressure():
    scaler = Autoscaler(AutoscalePolicy(**POLICY), train_world=4,
                        serve_engines=1, log_fn=None)
    for _ in range(40):
        scaler.tick(2.0, headroom_frac=1.0)
    assert (scaler.train_world, scaler.serve_engines) == (2, 3)
    for _ in range(40):
        scaler.tick(None)
    assert (scaler.train_world, scaler.serve_engines) == (4, 1)
    assert isinstance(scaler.decisions[0], ScaleDecision)


BAD_POLICIES = [dict(ttft_slo_s=0.0), dict(pressure_frac=1.0),
                dict(ebb_frac=0.9), dict(sustain=0), dict(cooldown=-1),
                dict(step=0), dict(min_train_world=5),
                dict(min_serve_engines=4), dict(min_headroom_frac=1.0)]


@pytest.mark.parametrize("bad", BAD_POLICIES, ids=range(len(BAD_POLICIES)))
def test_policy_validation_matches_jax(bad):
    kw = dict(POLICY, **bad)
    with pytest.raises(ValueError) as want:
        jas.AutoscalePolicy(**kw)
    with pytest.raises(ValueError) as got:
        AutoscalePolicy(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("world,engines", [(1, 1), (4, 4), (5, 1)])
def test_autoscaler_start_validation_matches_jax(world, engines):
    with pytest.raises(ValueError) as want:
        jas.Autoscaler(jas.AutoscalePolicy(**POLICY), train_world=world,
                       serve_engines=engines)
    with pytest.raises(ValueError) as got:
        Autoscaler(AutoscalePolicy(**POLICY), train_world=world,
                   serve_engines=engines)
    assert str(got.value) == str(want.value)


class _Sched:
    """What ``Router.harvest`` reads of a scheduler."""

    def __init__(self, done):
        self.recent_done = list(done)
        self.outstanding = 0


def test_router_ttft_p95_is_a_percentile_of_the_windows():
    g = np.random.default_rng(0)
    scheds = [_Sched([(float(t), float(v)) for t, v in
                      zip(g.uniform(0, 10, 9), g.exponential(1.0, 9))]),
              _Sched([(float(t), None) for t in g.uniform(0, 10, 3)]),
              _Sched([(float(t), float(v)) for t, v in
                      zip(g.uniform(0, 10, 5), g.exponential(2.0, 5))])]
    router = Router(scheds, window_s=4.0)
    assert router_ttft_p95(router) is None
    router.harvest(10.0)
    vals = [v for s in router._ttft for _, v in s]
    assert 0 < len(vals) < 14
    assert router_ttft_p95(router) == percentile(vals, 95.0)
    assert router_ttft_p95(router) == pytest.approx(
        float(np.percentile(vals, 95)), rel=1e-12)
    jrouter = type("R", (), {"_ttft": [deque(w) for w in router._ttft]})()
    assert jas.router_ttft_p95(jrouter) == router_ttft_p95(router)


# ------------------------------------------------- the serving wiring

SMALL = dict(vocab_size=97, dmodel=32, num_heads=4, n_layers=2, ctx_size=64)
PAGED = dict(num_blocks=24, block_len=4, max_blocks_per_seq=8)
WIRING = dict(ttft_slo_s=0.6, pressure_frac=0.8, ebb_frac=0.3, sustain=2,
              cooldown=2, min_train_world=3, max_train_world=4,
              min_serve_engines=1, max_serve_engines=2,
              min_headroom_frac=0.1)


class TickClock:
    """Serving time as ticks × dt, advanced only by the control loop."""

    def __init__(self, dt):
        self.t = 0.0
        self.dt = dt

    def __call__(self):
        return self.t


def _drive(fleet, request_cls, module, clock, curve, prompts):
    scaler = module.Autoscaler(module.AutoscalePolicy(**WIRING),
                               train_world=4, serve_engines=1, log_fn=None)
    fleet.set_active(1)
    rid = 0
    for i, n in enumerate(curve):
        clock.t += 1.0
        for _ in range(n):
            fleet.submit(request_cls(rid=f"r{rid}", prompt=prompts[rid],
                                     max_new=4), now=clock())
            rid += 1
        while fleet.outstanding:
            fleet.tick()
            clock.t += clock.dt
        fleet.router.harvest(clock())
        headroom = fleet.pool_headroom(min(scaler.serve_engines + 1, 2))
        d = scaler.tick(module.router_ttft_p95(fleet.router), it=i,
                        headroom_frac=headroom)
        if d is not None:
            fleet.set_active(d.serve_engines)
    return scaler


def test_fleet_wiring_moves_both_ways_as_jax_with_exact_streams():
    jp = jllama.init_llama(jax.random.PRNGKey(0), JaxLlamaConfig(**SMALL))
    cfg = LlamaConfig(**SMALL)
    params = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    curve = [max(0, round(6 + 6 * math.sin(2 * math.pi * i / 9)))
             for i in range(9)]
    g = np.random.default_rng(7)
    prompts = [tuple(int(t) for t in g.integers(1, 97, size=6))
               for _ in range(sum(curve))]
    clock = TickClock(0.05)
    fleet = ServingFleet(params, cfg, PagedKVConfig(**PAGED), num_engines=2,
                         num_slots=2, prefill_chunk=4, token_events=False,
                         clock=clock, window_s=2.0, device="cpu")
    port = _drive(fleet, Request, pas, clock, curve, prompts)
    jclock = TickClock(0.05)
    jfleet = JaxServingFleet(jp, JaxLlamaConfig(**SMALL),
                             JaxPagedKVConfig(**PAGED), num_engines=2,
                             num_slots=2, prefill_chunk=4, token_events=False,
                             clock=jclock, window_s=2.0)
    ref = _drive(jfleet, JaxRequest, jas, jclock, curve, prompts)
    directions = [d.direction for d in port.decisions]
    assert "train_to_serve" in directions and "serve_to_train" in directions
    assert [tuple(d) for d in port.decisions] == \
        [tuple(d) for d in ref.decisions]
    recs = fleet.records
    assert len(recs) == sum(curve)
    for rid, rec in recs.items():
        req = Request(rid=rid, prompt=prompts[int(rid[1:])], max_new=4)
        assert rec.tokens == reference_stream(params, cfg,
                                              PagedKVConfig(**PAGED), req,
                                              device="cpu")
    assert {fleet.engine_of[r] for r in recs} == {0, 1}
    assert all(r == 0 for r in fleet.retraces())
