"""The port's serving fleet (``serving/fleet.py``) and train→deploy conveyor
(``serving/deploy.py``) against the JAX package's: streams equal at any
engine count, least-loaded routing equal to JAX's ``Router``, weight
publishes that change nothing before their boundary, the publication round
trip through checkpoints, the trainer's ``on_checkpoint`` hook, the
multi-tenant workload, and the ``route``/``deploy``/``speculate`` events
under JAX's validator."""

import jax
import numpy as np
import pytest
import torch

from ddl25spring_tpu.config import LlamaConfig as JaxLlamaConfig
from ddl25spring_tpu.models import llama as jllama
from ddl25spring_tpu.serving import ServingFleet as JaxServingFleet
from ddl25spring_tpu.serving import TrafficClass as JaxTrafficClass
from ddl25spring_tpu.serving import class_slos as jax_class_slos
from ddl25spring_tpu.serving import \
    multi_tenant_workload as jax_multi_tenant_workload
from ddl25spring_tpu.serving import synthetic_workload as jax_workload
from ddl25spring_tpu.telemetry.events import read_events, validate_event
from ddl25spring_tpu.telemetry.trace import trace_trees, tree_check
from ddl25spring_tpu_torch.config import LlamaConfig, TrainConfig
from ddl25spring_tpu_torch.convert import params_from_jax
from ddl25spring_tpu_torch.models import llama
from ddl25spring_tpu_torch.serving import (CheckpointPublisher, Engine,
                                           PagedKVConfig, Request, Scheduler,
                                           ServingFleet, SpecConfig,
                                           TrafficClass, WeightPublisher,
                                           class_slos, multi_tenant_workload,
                                           reference_stream,
                                           run_serving_fleet,
                                           synthetic_workload)
from ddl25spring_tpu_torch.telemetry.events import EventLog
from ddl25spring_tpu_torch.tokenizers import ByteTokenizer
from ddl25spring_tpu_torch.train.llm import train_llm_dp
from ddl25spring_tpu_torch.tree import tree_leaves, tree_map

torch.set_num_threads(1)

SMALL = dict(vocab_size=97, dmodel=32, num_heads=4, n_layers=2, ctx_size=32)
CFG = LlamaConfig(**SMALL)
PAGED = PagedKVConfig(num_blocks=24, block_len=4, max_blocks_per_seq=8)


def _pair(seed):
    jp = jllama.init_llama(jax.random.PRNGKey(seed), JaxLlamaConfig(**SMALL))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), CFG,
                               device="cpu")


@pytest.fixture(scope="module")
def target():
    return _pair(0)


@pytest.fixture(scope="module")
def other():
    """Other weights of the same tree, for the new-weights swaps."""
    return _pair(42)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _workload(seed, n=8):
    return synthetic_workload(seed=seed, n_requests=n, rate_rps=500.0,
                              vocab_size=97, prompt_lens=(2, 5, 9),
                              max_news=(3, 5, 8), temperatures=(0.0, 0.7))


def _ref(model, req, cfg=CFG):
    return reference_stream(model, cfg, PAGED, req, device="cpu")


def _drive(params, requests, *, num_engines, swap_at_tick=None,
           swap_params=None, num_slots=2, events=None,
           policy="least_loaded"):
    """Submit everything at t=0 and tick to the end, publishing at a fixed
    tick. Returns (fleet, prefix): ``prefix[rid]`` holds the tokens the
    request had when its engine swapped."""
    clock = FakeClock()
    fleet = ServingFleet(params, CFG, PAGED, num_engines=num_engines,
                         num_slots=num_slots, prefill_chunk=4, events=events,
                         clock=clock, policy=policy, device="cpu")
    for r in requests:
        fleet.submit(r, now=0.0)
    prefix, tick = {}, 0
    while fleet.outstanding or fleet.swap_pending:
        if swap_at_tick is not None and tick == swap_at_tick:
            fleet.publish(swap_params, version="test-swap")
        eid = fleet.next_swap()
        if eid is not None:
            prefix.update({rid: list(rec.tokens) for rid, rec in
                           fleet.scheds[eid].records.items()})
        clock.t += 0.01
        fleet.tick()
        tick += 1
        assert tick < 500, "the fleet failed to drain"
    return fleet, prefix


# ------------------------------------------------------------------ routing

def test_fleet_streams_equal_generate_at_any_engine_count(target):
    _, model = target
    wl = _workload(3, n=10)
    reps = {n: run_serving_fleet(model, CFG, PAGED, wl, num_engines=n,
                                 num_slots=2, prefill_chunk=4,
                                 policy="predicted_ttft", device="cpu")
            for n in (1, 3)}
    for r in wl:
        want = _ref(model, r)
        for n, rep in reps.items():
            assert rep.records[r.rid].tokens == want, (r.rid, n)
    assert set(reps[3].per_engine) == {0, 1, 2}
    assert len(set(reps[3].engine_of.values())) == 3


def test_least_loaded_assignments_equal_jax_router(target):
    """One request submitted per tick, so loads rise and fall: the port's
    router sends every request where the JAX package's does."""
    jp, model = target
    kw = dict(seed=19, n_requests=12, rate_rps=500.0, vocab_size=97,
              prompt_lens=(2, 5, 9), max_news=(2, 4, 7),
              temperatures=(0.0, 0.7))
    picks = {}
    for name, fleet, wl in (
            ("port", ServingFleet(model, CFG, PAGED, num_engines=3,
                                  num_slots=2, prefill_chunk=4,
                                  clock=FakeClock(), device="cpu"),
             synthetic_workload(**kw)),
            ("jax", JaxServingFleet(jp, JaxLlamaConfig(**SMALL), PAGED,
                                    num_engines=3, num_slots=2,
                                    prefill_chunk=4, clock=FakeClock()),
             jax_workload(**kw))):
        for r in wl:
            fleet.submit(r, now=0.0)
            fleet.tick()
        while fleet.outstanding:
            fleet.tick()
        picks[name] = dict(fleet.engine_of)
    assert picks["port"] == picks["jax"]
    assert len(set(picks["port"].values())) == 3


def test_predicted_ttft_prefers_the_unloaded_engine(target):
    _, model = target
    fleet = ServingFleet(model, CFG, PAGED, num_engines=2, num_slots=2,
                         prefill_chunk=4, clock=FakeClock(),
                         policy="predicted_ttft", device="cpu")
    router = fleet.router
    assert router.predicted_ttft(0) is None        # no sample anywhere
    router._ttft[0].append((0.0, 0.1))
    router._ttft[1].append((0.0, 0.1))
    fleet.scheds[0].submit(Request(rid="busy", prompt=(1, 2), max_new=4),
                           now=0.0)
    assert router.predicted_ttft(0) > router.predicted_ttft(1)
    assert fleet.submit(Request(rid="new", prompt=(1, 2), max_new=2),
                        now=0.0) == 1
    while fleet.outstanding:
        fleet.tick()


def test_set_active_drains_and_headroom(target):
    _, model = target
    fleet = ServingFleet(model, CFG, PAGED, num_engines=2, num_slots=2,
                         prefill_chunk=4, clock=FakeClock(), device="cpu")
    assert fleet.pool_headroom() == 1.0
    fleet.submit(Request(rid="a", prompt=(1, 2, 3), max_new=6), now=0.0)
    fleet.submit(Request(rid="b", prompt=(1, 2, 3), max_new=6), now=0.0)
    fleet.tick()
    fleet.set_active(1)
    assert fleet.active_engines == 1
    assert fleet.submit(Request(rid="c", prompt=(4,), max_new=2)) == 0
    assert fleet.pool_headroom(2) < 1.0
    while fleet.outstanding:
        fleet.tick()
    assert fleet.completed == 3
    with pytest.raises(ValueError, match="set_active"):
        fleet.set_active(3)


# ----------------------------------------------------------- weight swaps

def test_same_weights_publish_is_invisible(target):
    _, model = target
    wl = _workload(7)
    base, _ = _drive(model, wl, num_engines=2)
    copy = tree_map(lambda x: x.detach().clone(), llama.as_tree(model))
    swapped, prefix = _drive(model, wl, num_engines=2, swap_at_tick=3,
                             swap_params=copy)
    assert prefix
    for r in wl:
        assert (swapped.records[r.rid].tokens
                == base.records[r.rid].tokens), r.rid
    assert [d["engine"] for d in swapped.deploys] == [0, 1]


def test_new_weights_change_only_tokens_after_the_boundary(target, other):
    _, model = target
    _, model2 = other
    wl = _workload(11, n=6)
    base, _ = _drive(model, wl, num_engines=2, num_slots=3)
    swapped, prefix = _drive(model, wl, num_engines=2, num_slots=3,
                             swap_at_tick=4, swap_params=model2)
    assert any(prefix.values())
    changed = 0
    for r in wl:
        got = swapped.records[r.rid].tokens
        want = base.records[r.rid].tokens
        pre = prefix.get(r.rid, [])
        assert len(got) == len(want) == r.max_new
        assert got[:len(pre)] == want[:len(pre)] == pre, r.rid
        changed += got != want
    assert changed > 0


def test_a_mismatched_tree_is_rejected(target):
    _, model = target
    eng = Engine(model, CFG, PAGED, 1, device="cpu")
    bad = tree_map(lambda x: x[..., None], llama.as_tree(model))
    with pytest.raises(ValueError, match="leaf"):
        eng.swap_params(bad)
    with pytest.raises(ValueError, match="tree structure"):
        eng.swap_params({"embed": llama.as_tree(model)["embed"]})


def test_a_bad_publish_fails_atomically(target):
    _, model = target
    wl = _workload(17, n=4)
    fleet = ServingFleet(model, CFG, PAGED, num_engines=2, num_slots=2,
                         prefill_chunk=4, clock=FakeClock(), device="cpu")
    for r in wl:
        fleet.submit(r, now=0.0)
    fleet.tick()
    bad = tree_map(lambda x: x[..., :1], llama.as_tree(model))
    with pytest.raises(ValueError, match="leaf"):
        fleet.publish(bad, version="bad")
    assert not fleet.swap_pending and fleet.deploys == []
    fleet.publish(model, version="good")
    while fleet.outstanding or fleet.swap_pending:
        fleet.tick()
    assert [d["version"] for d in fleet.deploys] == ["good", "good"]
    for r in wl:
        assert fleet.records[r.rid].tokens == _ref(model, r), r.rid


def test_publish_while_a_rollout_is_pending_raises(target):
    _, model = target
    fleet = ServingFleet(model, CFG, PAGED, num_engines=2, num_slots=1,
                         prefill_chunk=4, clock=FakeClock(), device="cpu")
    fleet.publish(model, version=1)
    with pytest.raises(RuntimeError, match="still rolling out"):
        fleet.publish(model, version=2)
    fleet.tick(), fleet.tick()
    fleet.publish(model, version=2)


# ------------------------------------------------------------ train→deploy

def _leaves_equal(a, b):
    return all(torch.equal(x.detach(), y.detach())
               for x, y in zip(tree_leaves(llama.as_tree(a)),
                               tree_leaves(llama.as_tree(b))))


def test_weight_publisher_round_trip_and_staleness(target, other, tmp_path):
    _, model = target
    _, model2 = other
    pub_dir = str(tmp_path / "publish")
    wp = WeightPublisher(pub_dir, model)
    assert wp.poll() is None                      # nothing published yet
    with CheckpointPublisher(pub_dir, log_fn=lambda *_: None) as pub:
        pub(100, llama.as_tree(model2))
        assert pub.published == [100]
    step, got = wp.poll()
    assert step == 100 and _leaves_equal(got, model2)
    assert wp.poll() is None                      # nothing new
    with CheckpointPublisher(pub_dir, log_fn=lambda *_: None) as pub:
        pub(200, llama.as_tree(model))
    assert wp.poll()[0] == 200
    fleet = ServingFleet(model, CFG, PAGED, num_engines=2, num_slots=1,
                         prefill_chunk=4, clock=FakeClock(), device="cpu")
    with CheckpointPublisher(pub_dir, log_fn=lambda *_: None) as pub:
        pub(300, llama.as_tree(model2))
    assert wp.publish_to(fleet) == 300
    while fleet.swap_pending:
        fleet.tick()
    assert all(_leaves_equal(e.params, model2) for e in fleet.engines)
    assert wp.publish_to(fleet) is None           # stale: no second rollout


TRAIN_CFG = LlamaConfig(vocab_size=259, dmodel=16, num_heads=2, n_layers=2,
                        ctx_size=16)


def test_the_trainer_hook_publishes_and_the_fleet_serves_it(tmp_path):
    """``train_llm_dp(on_checkpoint=CheckpointPublisher)`` publishes at every
    save; the served parameters after ``publish_to`` are the trainer's
    final parameters bitwise, and the hot swap changes no token emitted
    before its boundary."""
    pub_dir = str(tmp_path / "publish")
    pub = CheckpointPublisher(pub_dir, log_fn=lambda *_: None)
    final = {}

    def hook(step, state):
        final[step] = tree_map(lambda x: x.detach().clone(), state.params)
        pub(step, state)

    train_llm_dp(TRAIN_CFG, TrainConfig(iters=4, batch_size=2, seq_len=16,
                                        seed=3),
                 tokenizer=ByteTokenizer(), log_every=0,
                 warmup_steps_excluded=1, checkpoint_dir=str(tmp_path / "ck"),
                 checkpoint_every=2, on_checkpoint=hook, device="cpu")
    assert pub.published == [2, 4] and sorted(final) == [2, 4]
    boot = llama.init_llama(TRAIN_CFG, torch.Generator().manual_seed(9),
                            device="cpu")
    wl = [Request(rid=f"q{i}", prompt=tuple(range(3 + i, 9 + i)), max_new=8)
          for i in range(4)]

    def serve(publish_at):
        clock = FakeClock()
        fleet = ServingFleet(boot, TRAIN_CFG, PAGED, num_engines=2,
                             num_slots=2, prefill_chunk=4, clock=clock,
                             device="cpu")
        wp = WeightPublisher(pub_dir, boot)
        for r in wl:
            fleet.submit(r, now=0.0)
        tick, prefix = 0, {}
        while fleet.outstanding or fleet.swap_pending:
            if tick == publish_at:
                assert wp.publish_to(fleet) == 4
            eid = fleet.next_swap()
            if eid is not None:
                prefix.update({rid: list(rec.tokens) for rid, rec in
                               fleet.scheds[eid].records.items()})
            fleet.tick()
            tick += 1
        return fleet, prefix

    base, _ = serve(None)
    fleet, prefix = serve(2)
    assert all(_leaves_equal(e.params, final[4]) for e in fleet.engines)
    assert any(prefix.values())
    for r in wl:
        pre = prefix[r.rid]
        assert fleet.records[r.rid].tokens[:len(pre)] == pre == \
            base.records[r.rid].tokens[:len(pre)]


def test_a_broken_hook_never_stops_training(tmp_path):
    calls, logged = [], []

    def hook(step, state):
        calls.append(step)
        raise RuntimeError("publisher down")

    report = train_llm_dp(TRAIN_CFG, TrainConfig(iters=4, batch_size=2,
                                                 seq_len=16, seed=3),
                          tokenizer=ByteTokenizer(), log_every=0,
                          warmup_steps_excluded=1,
                          checkpoint_dir=str(tmp_path / "ck"),
                          checkpoint_every=2, on_checkpoint=hook,
                          log_fn=logged.append, device="cpu")
    assert calls == [2, 4] and len(report.losses) == 4
    assert sum("publisher down" in m for m in logged) == 2


# ------------------------------------------------- workload and telemetry

def test_multi_tenant_workload_and_class_slos_equal_jax():
    kw = [dict(name="chat", rate_rps=50.0, priority=1, ttft_p99_s=1.0,
               prompt_lens=(4, 9), max_news=(3, 6)),
          dict(name="batch", rate_rps=10.0, queue_p99_s=5.0),
          dict(name="bulk", rate_rps=5.0)]
    ours = [TrafficClass(**c) for c in kw]
    theirs = [JaxTrafficClass(**c) for c in kw]
    for n in (5, {"chat": 3, "batch": 1, "bulk": 2}):
        a = multi_tenant_workload(seed=4, classes=ours, n_per_class=n,
                                  vocab_size=64)
        b = jax_multi_tenant_workload(seed=4, classes=theirs, n_per_class=n,
                                      vocab_size=64)
        assert [(r.rid, r.prompt, r.max_new, r.temperature, r.seed,
                 r.arrival, r.tenant, r.priority) for r in a] == [
            (r.rid, r.prompt, r.max_new, r.temperature, r.seed, r.arrival,
             r.tenant, r.priority) for r in b]
    assert class_slos(ours) == jax_class_slos(theirs) == {
        "chat": {"ttft_p99_s": 1.0}, "batch": {"queue_p99_s": 5.0}}


def test_fleet_events_pass_the_jax_validator(target, tmp_path):
    """route, deploy (event and span) and speculate events, and engine-
    tagged request events: JAX's strict reader accepts the stream, and
    the traces are whole."""
    _, model = target
    wl = _workload(5, n=6)
    path = str(tmp_path / "events.jsonl")
    with EventLog(path, run_id="fleet") as log:
        _drive(model, wl, num_engines=2, swap_at_tick=2, swap_params=model,
               events=log)
        eng = Engine(model, CFG, PAGED, 2, prefill_chunk=4, engine_id=5,
                     speculate=SpecConfig(k=2, draft_params=model),
                     device="cpu")
        sched = Scheduler(eng, events=log)
        for r in synthetic_workload(seed=9, n_requests=3, rate_rps=500.0,
                                    vocab_size=97, prompt_lens=(2, 5),
                                    max_news=(4, 6), rid_prefix="spec"):
            sched.submit(r)
        while sched.outstanding:
            sched.tick()
    events = read_events(path, strict=True)
    assert all(validate_event(e) == [] for e in events)
    routes = [e for e in events if e["type"] == "route"]
    deploys = [e for e in events if e["type"] == "deploy"]
    specs = [e for e in events if e["type"] == "speculate"]
    assert {e["req"] for e in routes} == {r.rid for r in wl}
    assert sorted(e["engine"] for e in deploys) == [0, 1]
    assert specs and all(e["engine"] == 5 and e["k"] == 2 for e in specs)
    assert sum(e["emitted"] for e in specs) == eng.decode_tokens
    route_of = {e["req"]: e["engine"] for e in routes}
    done = [e for e in events if e["type"] == "request_done"]
    assert all(route_of.get(e["req"], 5) == e["engine"] for e in done)
    assert any(e["type"] == "span" and e.get("name") == "deploy"
               for e in events)
    trees = trace_trees([e for e in events
                         if not str(e.get("trace_id", "")).startswith(
                             "deploy-")])
    assert all(tree_check(t) == {"roots": 1, "orphans": 0, "imbalanced": 0}
               for t in trees.values())
