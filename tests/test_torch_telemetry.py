"""The port's telemetry layer (``telemetry/``) against the JAX package's, on
the CPU at a small size (2 layers, dmodel 32).

Held exactly: the event stream (a port stream passes the JAX package's
``validate_event`` and strict reader, and its ``obs_report`` renders it),
the registry's snapshot for the same observations, tree paths in the same
order, the communication profile per step of every data-parallel
aggregation at ``data=2`` and of the K-step loop at K=4 (two gloo ranks on
the CPU against the JAX ``data=2`` mesh), and the serving engine's compile
and retrace counts. Numerics summaries within 1e-5 relative (fp32 sums of
squares in different orders)."""

import io
import json
import os
import pickle
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl25spring_tpu.config import LlamaConfig as JaxLlamaConfig
from ddl25spring_tpu.metrics import ResilienceStats as JaxResilienceStats
from ddl25spring_tpu.models import llama as jllama
from ddl25spring_tpu.ops.adam import fused_adam as jfused_adam
from ddl25spring_tpu.parallel import dp as jdp
from ddl25spring_tpu.parallel import make_mesh
from ddl25spring_tpu.serving import PagedKVConfig as JaxPagedKVConfig
from ddl25spring_tpu.serving import SpecConfig as JaxSpecConfig
from ddl25spring_tpu.serving import run_serving as jrun_serving
from ddl25spring_tpu.serving import synthetic_workload as jworkload
from ddl25spring_tpu.telemetry import events as jevents
from ddl25spring_tpu.telemetry import introspect as jintro
from ddl25spring_tpu.telemetry.comm import measure_comm as jmeasure_comm
from ddl25spring_tpu.telemetry.registry import MetricsRegistry as JaxRegistry
from ddl25spring_tpu.telemetry.trace import Spans as JaxSpans
from ddl25spring_tpu.telemetry.trace import StepTimer as JaxStepTimer
from ddl25spring_tpu_torch.config import (LlamaConfig, ResilienceConfig,
                                          TrainConfig)
from ddl25spring_tpu_torch.convert import params_from_jax
from ddl25spring_tpu_torch.metrics import ResilienceStats
from ddl25spring_tpu_torch.models import llama
from ddl25spring_tpu_torch.ops.adam import fused_adam
from ddl25spring_tpu_torch.parallel import distributed, dp, programs
from ddl25spring_tpu_torch.resilience import FaultPlan
from ddl25spring_tpu_torch.serving import (PagedKVConfig, SpecConfig,
                                           run_serving, synthetic_workload)
from ddl25spring_tpu_torch.telemetry import (EventLog, Heartbeat,
                                             MetricsRegistry, Spans,
                                             Telemetry, introspect,
                                             read_events, read_heartbeat,
                                             trace_trees, tree_check,
                                             validate_event)
from ddl25spring_tpu_torch.telemetry.comm import measure_comm
from ddl25spring_tpu_torch.telemetry.costs import (flops_crosscheck,
                                                   hlo_cost,
                                                   train_flops_per_token)
from ddl25spring_tpu_torch.telemetry.trace import StepTimer
from ddl25spring_tpu_torch.tokenizers import ByteTokenizer
from ddl25spring_tpu_torch.train import llm
from ddl25spring_tpu_torch.tree import tree_leaves
from experiments import obs_report, trace_export

torch.set_num_threads(1)

SMALL = dict(vocab_size=64, dmodel=32, num_heads=2, n_layers=2, ctx_size=16)
MCFG = dict(dmodel=32, num_heads=2, n_layers=2, ctx_size=16)
N, B, T = 2, 2, 16
TREE = jax.tree.map(np.asarray, jllama.init_llama(
    jax.random.PRNGKey(0), JaxLlamaConfig(**SMALL)))


def _faulted_run(out_dir, iters=8):
    """A port trainer run with every telemetry source on: faults (a NaN in
    leaf #4 at step 5), the guard, numerics every 3 steps."""
    tel = Telemetry(str(out_dir), step_every=2)
    rep = llm.train_llm_dp(
        LlamaConfig(**MCFG), TrainConfig(iters=iters, batch_size=2,
                                         seq_len=16, numerics_every=3),
        tokenizer=ByteTokenizer(), log_every=0, device="cpu",
        resilience=ResilienceConfig(ema_warmup=2),
        fault_plan=FaultPlan.from_spec("nan_grad@2,nan_grad@5:4"),
        telemetry=tel)
    tel.close()
    return rep, read_events(os.path.join(str(out_dir), "events.jsonl"))


@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    d = tmp_path_factory.mktemp("tel")
    rep, events = _faulted_run(d)
    return d, rep, events


# ------------------------------------------------------------ event stream

def test_port_stream_passes_the_jax_validator_and_strict_reader(stream):
    d, rep, events = stream
    types = [e["type"] for e in events]
    for t in ("manifest", "step", "fault", "numerics", "compile", "memory",
              "span", "run_end"):
        assert t in types, t
    for e in events:
        assert jevents.validate_event(e) == [], e
        assert validate_event(e) == [], e
    assert len(jevents.read_events(os.path.join(str(d), "events.jsonl"),
                                   strict=True)) == len(events)


def test_obs_report_and_trace_export_read_a_port_stream(stream):
    d, _, events = stream
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert obs_report.main([str(d)]) == 0
    text = buf.getvalue()
    assert "trainer: dp" in text and "grad_allreduce" in text
    assert "skipped_steps" in text
    trace = trace_export.chrome_trace(events)
    assert trace["traceEvents"]


def test_span_trees_have_no_orphans(stream):
    _, _, events = stream
    trees = trace_trees(events)
    assert trees
    for t in trees.values():
        check = tree_check(t)
        assert check["orphans"] == 0 and check["imbalanced"] == 0


def test_fault_events_name_the_poisoned_leaf_as_jax_does(stream):
    d, rep, events = stream
    paths = jintro.leaf_paths(TREE)
    faults = [e for e in events if e["type"] == "fault"]
    assert [e["it"] for e in faults] == [2, 5]
    assert faults[1]["attribution"]["nonfinite_params"] == [paths[3]]
    assert paths[3] == "blocks/w_gate"
    bundles = introspect.find_bundles(str(d))
    assert len(bundles) == 2
    last = introspect.load_bundle(bundles[-1])
    assert last["attribution"]["nonfinite_params"] == [paths[3]]
    assert last["manifest"]["trainer"] == "dp"
    assert last["last_numerics"] is not None


def test_manifest_carries_comm_preflight_and_peaks(stream):
    _, _, events = stream
    m = events[0]
    assert m["type"] == "manifest" and m["jax_version"] is None
    assert m["comm"]["wire_bytes_per_device_per_step"] == 0.0
    assert m["preflight"]["window_bytes"] == 2 * 16 * 8
    assert m["peaks"]["flops_per_sec"] > 0
    end = events[-1]
    assert end["type"] == "run_end"
    assert end["metrics"]["counters"]["faults/skipped_steps"] == 2
    assert end["metrics"]["histograms"]["host_iter_s"]["count"] == 8


@pytest.mark.parametrize("event", [
    {"type": "step"}, {"schema": 9, "run_id": "r", "seq": 1, "t": 0.0,
                       "type": "nope"},
    {"schema": 10, "run_id": "r", "seq": 1, "t": 0.0, "type": "step",
     "it": 0},
    {"schema": 9, "run_id": "r", "seq": 1, "t": 0.0, "type": "memory"}])
def test_validate_event_matches_jax(event):
    assert validate_event(event) == jevents.validate_event(event)


def test_a_reopened_log_heals_a_torn_line(tmp_path):
    path = str(tmp_path / "events.jsonl")
    log = EventLog(path, run_id="a")
    log.step(it=0, loss=float("nan"))
    log.close()
    with open(path, "ab") as f:
        f.write(b'{"schema":9,"tor')
    assert len(read_events(path)) == 1
    log = EventLog(path, run_id="b")
    log.step(it=1)
    log.close()
    got = read_events(path, strict=True)
    assert [e["it"] for e in got] == [0, 1] and got[0]["loss"] == "nan"


def test_heartbeat_roundtrip(tmp_path):
    hb = Heartbeat(str(tmp_path / "hb.json"))
    assert hb.beat(step=3, phase="x") and hb.beat(step=4)
    got = read_heartbeat(str(tmp_path / "hb.json"))
    assert got["step"] == 4 and got["seq"] == 2 and hb.seq == 2
    assert read_heartbeat(str(tmp_path / "none.json")) is None


def test_telemetry_pickles_to_its_settings_and_counter(tmp_path):
    tel = Telemetry(str(tmp_path), run_id="r1", step_every=3)
    tel.events.step(it=0)
    copy = pickle.loads(pickle.dumps(tel))
    copy.events.step(it=1)
    copy.close()
    tel.close()
    got = read_events(tel.events_path)
    assert [e["seq"] for e in got] == [1, 2]
    assert copy.step_every == 3 and copy.run_id == "r1"


# --------------------------------------------------------------- registry

def test_registry_snapshot_matches_jax():
    ours, theirs = MetricsRegistry(), JaxRegistry()
    spans, jspans = Spans(), JaxSpans()
    for name, secs in (("data", 0.5), ("dispatch", 1.25), ("data", 0.25)):
        spans.add(name, secs)
        jspans.add(name, secs)
    stats, jstats = ResilienceStats(), JaxResilienceStats()
    for s in (stats, jstats):
        s.skipped_steps, s.rollbacks, s.dropped_clients = 3, 1, 2
    timer, jtimer = StepTimer(), JaxStepTimer()
    timer.times[:] = jtimer.times[:] = [0.5, 0.25, 1.0]
    for reg, sp, st, tm in ((ours, spans, stats, timer),
                            (theirs, jspans, jstats, jtimer)):
        for v in (0.3, 0.1, 0.7, 0.2, 0.9):
            reg.observe("host_iter_s", v)
        reg.counter_inc("steps", 5)
        reg.gauge_set("lr", 8e-4)
        reg.absorb_spans(sp)
        reg.absorb_resilience(st)
        reg.absorb_step_timer(tm)
    assert ours.snapshot() == theirs.snapshot()


def test_step_timer_needs_a_start():
    timer = StepTimer()
    with pytest.raises(RuntimeError, match="start"):
        timer.tick()
    timer.start()
    assert timer.tick(torch.ones(2)) >= 0 and len(timer.times) == 1


# ------------------------------------------------- tree paths and numerics

def test_leaf_paths_match_jax_in_order():
    model = params_from_jax(TREE, LlamaConfig(**SMALL), "cpu")
    assert introspect.leaf_paths(model.tree()) == jintro.leaf_paths(TREE)
    opt, jopt = fused_adam(1e-3), jfused_adam(1e-3)
    state = dp.init_state(model.tree(), opt)
    jstate = jdp.TrainState(TREE, jopt.init(TREE), jnp.zeros((), jnp.int32))
    assert introspect.leaf_paths(state) == jintro.leaf_paths(jstate)
    mixed = {"b": [np.zeros(2), {"z": np.ones(1), "a": np.ones(3)}],
             "a": np.zeros(1)}
    assert introspect.leaf_paths(mixed) == jintro.leaf_paths(mixed)


def test_nonfinite_leaves_names_the_poisoned_leaves():
    model = params_from_jax(TREE, LlamaConfig(**SMALL), "cpu")
    tree = model.tree()
    with torch.no_grad():
        tree["blocks"]["wq"][1, 0, 0] = float("inf")
        tree["embed"][0, 0] = float("nan")
    jtree = jax.tree.map(lambda x: x.copy(), TREE)
    jtree["blocks"]["wq"][1, 0, 0] = np.inf
    jtree["embed"][0, 0] = np.nan
    assert (introspect.nonfinite_leaves(tree)
            == jintro.nonfinite_leaves(jtree) == ["blocks/wq", "embed"])


def test_make_summarizer_matches_jax():
    rng = np.random.default_rng(0)
    grads = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
        np.float32), TREE)
    grads["lm_head"][0, 0] = np.nan
    new = jax.tree.map(lambda p, g: p - 1e-2 * np.nan_to_num(g), TREE, grads)
    jh = jintro.make_summarizer(TREE)
    jfields = jh.event_fields(jax.jit(jh.summarize)(TREE, grads, new))
    as_t = lambda t: jax.tree.map(lambda x: torch.tensor(np.array(x)), t)
    h = introspect.make_summarizer(as_t(TREE))
    fields = h.event_fields(h.summarize(as_t(TREE), as_t(grads), as_t(new)))
    assert h.groups == jh.groups and h.paths == jh.paths
    assert fields["nonfinite_grads"] == jfields["nonfinite_grads"] == [
        "lm_head"]
    assert fields["worst_group"] == jfields["worst_group"]
    assert list(fields["groups"]) == list(jfields["groups"])
    for g, want in jfields["groups"].items():
        for k, v in want.items():
            np.testing.assert_allclose(fields["groups"][g][k], v, rtol=1e-5)
    for name in ("blocks/0", "blocks/1", "embed", "final_norm"):
        s = h.summarize(as_t(TREE), as_t(grads), as_t(new))
        i = h.groups.index(name)
        js = jh.summarize(TREE, grads, new)
        np.testing.assert_allclose(float(s.grad_sq[i]),
                                   float(js.grad_sq[i]), rtol=1e-5)


def test_numerics_leave_losses_and_params_unchanged():
    runs = [llm.train_llm_dp(LlamaConfig(**MCFG),
                             TrainConfig(iters=4, batch_size=2, seq_len=16,
                                         numerics_every=every),
                             tokenizer=ByteTokenizer(), log_every=0,
                             device="cpu") for every in (0, 1)]
    assert runs[0].losses == runs[1].losses


def test_numerics_event_grad_norm_is_the_gradient_norm(tmp_path):
    """The numerics event of step 0 against the gradient of step 0's loss
    recomputed directly from the same weights and batch."""
    tel = Telemetry(str(tmp_path))
    llm.train_llm_dp(LlamaConfig(**MCFG),
                     TrainConfig(iters=1, batch_size=2, seq_len=16,
                                 numerics_every=1),
                     tokenizer=ByteTokenizer(), log_every=0, device="cpu",
                     telemetry=tel)
    tel.close()
    ev = [e for e in read_events(tel.events_path)
          if e["type"] == "numerics"]
    from ddl25spring_tpu_torch.data.tokens import shard_batches
    cfg = LlamaConfig(**MCFG, vocab_size=259)
    model = llama.init_llama(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    batch = next(shard_batches(ByteTokenizer(), 2, 16, 0, shard_skip=5000,
                               seed=0))
    loss = llama.forward_loss(model, torch.as_tensor(batch).reshape(2, 16),
                              cfg)
    g = torch.autograd.grad(loss, tree_leaves(model.tree()))
    want = float(torch.sqrt(sum((x.double() ** 2).sum() for x in g)))
    np.testing.assert_allclose(ev[0]["grad_norm"], want, rtol=1e-5)


def _hold_fields(got, want, path=""):
    """Event fields held to JAX's: the same keys, strings equal, NaN where
    JAX has NaN, other numbers within 1e-5 relative."""
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _hold_fields(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, float):
        assert np.isnan(got) == np.isnan(want), path
        if not np.isnan(want):
            np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=path)
    else:
        assert got == want, path


def test_guard_skipped_step_summarizes_the_refused_update_as_jax():
    """A NaN loss under ``guard_nonfinite``: the step is skipped, and its
    numerics describe the update it refused (NaN parameter norms), as the
    JAX body's do; the state stays as it was."""
    batch = np.random.default_rng(2).integers(0, SMALL["vocab_size"], (B, T))
    jcfg = JaxLlamaConfig(**SMALL)
    params = jax.tree.map(jnp.asarray, TREE)
    jh = jintro.make_summarizer(params)
    jopt = jfused_adam(8e-4)
    jstep = jdp.make_grad_aggregation_step(
        lambda p, b: jllama.forward_loss(p, b, jcfg) * jnp.nan, jopt,
        make_mesh({"data": 1}), guard_nonfinite=True, numerics=jh)
    jstate, (_, jsum) = jstep(jdp.init_state(params, jopt), jnp.asarray(batch))
    want = jh.event_fields(jsum)

    cfg = LlamaConfig(**SMALL)
    tree = params_from_jax(TREE, cfg, "cpu").tree()
    h = introspect.make_summarizer(tree)
    opt = fused_adam(8e-4)
    step = dp.make_grad_aggregation_step(
        lambda p, b: llama.forward_loss(p, b, cfg) * float("nan"), opt,
        guard_nonfinite=True, numerics=h)
    before = [x.detach().clone() for x in tree_leaves(tree)]
    state, (_, summary) = step(dp.init_state(tree, opt),
                               torch.as_tensor(batch))
    got = h.event_fields(summary)
    assert np.isnan(want["groups"]["blocks/0"]["param_norm"])
    _hold_fields(got, want)
    assert int(state.step) == int(jstate.step) == 0
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(tree)))


# ---------------------------------------------------- communication bytes

@pytest.fixture(scope="module")
def comm_ranks():
    batch = np.random.default_rng(1).integers(0, SMALL["vocab_size"],
                                              (N * B, T))
    ranks = distributed.run_ranks(programs.comm_profiles, N, SMALL, TREE,
                                  batch, device="cpu")
    return ranks


def _jax_profile(name):
    jcfg = JaxLlamaConfig(**SMALL)
    mesh = make_mesh({"data": N})
    opt = jfused_adam(8e-4)
    loss = lambda p, b: jllama.forward_loss(p, b, jcfg)
    params = jax.tree.map(jnp.asarray, TREE)
    shape = (N * B, T) if name != "k4" else (4, N * B, T)
    batch = jax.ShapeDtypeStruct(shape, jnp.int32)
    if name == "zero1":
        state, step = jdp.make_zero1_step(loss, opt, mesh, params)
    else:
        state = jdp.replicate(mesh, jdp.init_state(params, opt))
        step = {"gradient": jdp.make_grad_aggregation_step,
                "weight": jdp.make_weight_aggregation_step,
                "k4": jdp.make_multi_step}[name](loss, opt, mesh)
    return jmeasure_comm(step, state, batch).as_dict(
        steps_per_dispatch=4 if name == "k4" else 1)


@pytest.mark.parametrize("name", ["gradient", "zero1", "weight", "k4"])
def test_comm_profile_per_step_matches_jax_at_data_2(comm_ranks, name):
    want = _jax_profile(name)
    for rank in comm_ranks:
        assert rank[name] == want
    if name in ("gradient", "k4"):
        grad = want["collectives"]["grad_allreduce"]
        assert grad["payload_bytes"] == (4 if name == "k4" else 1) * sum(
            x.size * 4 for x in jax.tree.leaves(TREE))


def test_comm_profile_at_world_one_is_zero_wire():
    cfg = LlamaConfig(**SMALL)
    model = params_from_jax(TREE, cfg, "cpu")
    opt = fused_adam(8e-4)
    step = dp.make_grad_aggregation_step(
        lambda p, b: llama.forward_loss(p, b, cfg), opt)
    prof = measure_comm(step, dp.init_state(model.tree(), opt),
                        torch.zeros((2, 16), dtype=torch.long))
    assert prof.wire_bytes_per_device_per_step == 0.0
    assert prof.payload_bytes_per_step == sum(
        x.size * 4 for x in jax.tree.leaves(TREE)) + 4


# ---------------------------------------------------- compiles and costs

@pytest.mark.parametrize("spec", [False, True])
def test_compile_watch_counts_the_jax_engines_compiles(spec):
    """The same workload through both engines: the port's call signatures
    are the JAX engine's compiled programs (2 plain: prefill and decode; 4
    speculating: prefill, verify and the draft's two), and nothing
    retraces."""
    jcfg = JaxLlamaConfig(**SMALL)
    paged = dict(num_blocks=24, block_len=4, max_blocks_per_seq=8)
    jparams = jax.tree.map(jnp.asarray, TREE)
    wl = dict(seed=3, n_requests=6, rate_rps=500.0, vocab_size=64,
              prompt_lens=(2, 5, 9), max_news=(3, 5), temperatures=(0.0,))
    model = params_from_jax(TREE, LlamaConfig(**SMALL), "cpu")
    jspec = JaxSpecConfig(k=2, draft_params=jparams) if spec else None
    tspec = SpecConfig(k=2, draft_params=model) if spec else None
    jrep = jrun_serving(jparams, jcfg, JaxPagedKVConfig(**paged),
                        jworkload(**wl), num_slots=3, prefill_chunk=4,
                        speculate=jspec)
    rep = run_serving(model, LlamaConfig(**SMALL), PagedKVConfig(**paged),
                      synthetic_workload(**wl), num_slots=3,
                      prefill_chunk=4, speculate=tspec, device="cpu")
    assert rep.compiles == jrep.compiles == (4 if spec else 2)
    assert rep.retraces == jrep.retraces == 0


def test_compile_watch_flags_a_retrace():
    w = introspect.watch(lambda x: x + 1, name="f", max_caches=1)
    w(torch.zeros(2))
    w(torch.ones(2))
    assert len(w.compiles) == 1 and w.retraces == 0
    w(torch.zeros(3))
    assert len(w.compiles) == 2 and w.retraces == 1
    assert w.compiles[-1].retrace


def test_costs_are_analytic_without_a_compiled_program():
    assert hlo_cost(lambda: None) is None
    assert flops_crosscheck(1e9, None)["flops_source"] == "analytic"
    canonical = LlamaConfig()
    assert round(train_flops_per_token(canonical, 256) / 1e6, 1) == 108.4


def test_platform_peaks_are_the_h100s():
    peaks = introspect.platform_peaks("gpu")
    assert peaks["flops_per_sec"] == 989e12
    assert peaks["hbm_bytes_per_sec"] == 3.35e12
    assert peaks["fp32_flops_per_sec"] == 67e12
    assert introspect.platform_peaks("cpu")["flops_per_sec"] > 0
    att = introspect.attainment(2e12, 1e9, 1.0, peaks)
    assert att == jintro.attainment(2e12, 1e9, 1.0, peaks)
    json.dumps(peaks)


def test_trainer_at_data_2_writes_one_stream_from_rank_0(tmp_path):
    """Two gloo ranks, ZeRO-1, the guard and a NaN fault: the bundle
    travels to the ranks, rank 0 alone writes, and every rank runs the
    comm probe (its collectives are real)."""
    tel = Telemetry(str(tmp_path), step_every=2)
    rep = llm.train_llm_dp(
        LlamaConfig(**MCFG), TrainConfig(data=2, batch_size=2, seq_len=16,
                                         iters=4, numerics_every=2),
        tokenizer=ByteTokenizer(), log_every=0, aggregation="zero1",
        resilience=ResilienceConfig(),
        fault_plan=FaultPlan.from_spec("nan_grad@2"), telemetry=tel,
        device="cpu")
    tel.close()
    events = read_events(tel.events_path)
    assert [e["type"] for e in events].count("manifest") == 1
    assert [e["type"] for e in events].count("run_end") == 1
    assert all(jevents.validate_event(e) == [] for e in events)
    comm = events[0]["comm"]["collectives"]
    assert set(comm) == {"zero1_grad_scatter", "loss_allreduce",
                         "zero1_param_gather"}
    assert all(c["axis_size"] == 2 for c in comm.values())
    assert rep.resilience.skipped_steps == 1 and len(rep.losses) == 4
    assert [e["it"] for e in events if e["type"] == "fault"] == [2]


def test_device_trace_puts_host_spans_on_the_profile(tmp_path):
    from ddl25spring_tpu_torch.telemetry import Tracer, device_trace
    log = EventLog(str(tmp_path / "events.jsonl"))
    tracer = Tracer(log)
    with device_trace(str(tmp_path / "trace")) as prof:
        with tracer.span("stage", trace="t"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    with tracer.span("outside", trace="t"):
        pass
    log.close()
    names = {e.key for e in prof.key_averages()}
    assert "stage" in names and "outside" not in names
    assert os.path.exists(str(tmp_path / "trace" / "trace.json"))
    assert [e["name"] for e in read_events(log.path)] == ["stage", "outside"]
