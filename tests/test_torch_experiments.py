"""The port's experiment twins (``ddl25spring_tpu_torch/experiments/``) on
the CPU at their quick sizes: each exits 0 and writes its JSON with every
check passed; the serving twin's event streams pass the JAX package's
``experiments/slo_monitor.py --check`` (the single engine under a TTFT and
queue-wait ceiling, the fleet under its per-class SLOs) and export through
``experiments/trace_export.chrome_trace`` with one complete event per
span, a ``deploy`` span among them after a hot swap; the memory twin's
stream passes the monitor's headroom gate against a roomy budget and
fails it against a tight one; the sequence-parallel memory twin's losses
agree over rings 1, 2 and 4 (no memory number off the card); the
long-context twin times its points in subprocesses and raises for a point
that fails; the elastic twin's three bitwise legs hold and its stream's
``remesh`` event is JAX-valid; the autoscale twin's moves go both ways
with nothing replayed, and its stream passes the monitor's TTFT gate at
the twin's SLO."""

import json

import pytest
import torch

from ddl25spring_tpu.telemetry.events import read_events, validate_event
from ddl25spring_tpu_torch.experiments import (autoscale_smoke,
                                               comm_wire_smoke,
                                               elastic_smoke, fleet_smoke,
                                               longctx_bench, memory_smoke,
                                               pp_fusion_smoke,
                                               serving_bench, sp_bench,
                                               tp_fusion_smoke)
from ddl25spring_tpu_torch.serving import TrafficClass, class_slos
from experiments import slo_monitor
from experiments.trace_export import chrome_trace

torch.set_num_threads(1)


def _result(path):
    with open(path) as f:
        return json.loads(f.readline())


def test_fleet_smoke_quick_on_the_cpu(tmp_path):
    out = tmp_path / "fleet.json"
    tel = tmp_path / "tel"
    rc = fleet_smoke.main(["--device", "cpu", "--quick", "--out", str(out),
                           "--telemetry-dir", str(tel)])
    res = _result(out)
    assert rc == 0 and res["ok"], res["checks"]
    assert res["clients"] == res["sampled_per_round"] == 20_000
    assert res["control_ragged_bitwise"]
    events = read_events(str(tel / "events.jsonl"), strict=True)
    cohorts = [e for e in events if e["type"] == "fl_cohort"]
    assert sum(e["clients"] for e in cohorts) == 20_000
    assert all(validate_event(e) == [] for e in events)


@pytest.fixture(scope="module")
def serving_runs(tmp_path_factory):
    """The serving twin once on one engine and once as a 2-engine fleet
    with a hot swap, each with its stream."""
    runs = {}
    for name, extra in (("single", []),
                        ("fleet", ["--engines", "2", "--hot-swap"])):
        d = tmp_path_factory.mktemp(name)
        rc = serving_bench.main(["--device", "cpu", "--quick", "--out",
                                 str(d / "out.json"), "--telemetry-dir",
                                 str(d / "tel")] + extra)
        runs[name] = (rc, _result(d / "out.json"), d / "tel")
    return runs


@pytest.mark.parametrize("name", ["single", "fleet"])
def test_serving_bench_quick_on_the_cpu(serving_runs, name):
    rc, res, _ = serving_runs[name]
    assert rc == 0 and res["ok"], res["checks"]
    assert res["verified_bitwise"] == 6 and res["parity_mismatches"] == []


def test_serving_stream_passes_the_slo_monitor(serving_runs):
    _, _, tel = serving_runs["single"]
    assert slo_monitor.main([str(tel), "--check", "--ttft-p99", "120",
                             "--queue-p99", "120", "--no-emit"]) == 0


def test_fleet_stream_passes_its_class_slos(serving_runs):
    _, res, tel = serving_runs["fleet"]
    classes = (TrafficClass("chat", 1.0, ttft_p99_s=120.0, queue_p99_s=120.0),
               TrafficClass("batch", 1.0, ttft_p99_s=240.0,
                            queue_p99_s=240.0))
    stream = read_events(str(tel / "events.jsonl"))
    monitor = slo_monitor.replay_monitor(stream, slo_monitor.SLOConfig(
        window_s=30.0, per_class=class_slos(classes)))
    assert monitor.violations == []
    assert set(res["per_class"]) == {"chat", "batch"}


@pytest.mark.parametrize("name", ["single", "fleet"])
def test_serving_stream_exports_to_chrome_trace(serving_runs, name):
    _, _, tel = serving_runs[name]
    stream = read_events(str(tel / "events.jsonl"), strict=True)
    assert all(validate_event(e) == [] for e in stream)
    exported = json.loads(json.dumps(chrome_trace(stream)))
    spans = sum(e.get("type") == "span" for e in stream)
    complete = [ev for ev in exported["traceEvents"] if ev.get("ph") == "X"]
    assert len(complete) == spans > 0
    if name == "fleet":
        assert any(ev.get("name") == "deploy" for ev in complete)


def test_memory_smoke_on_the_cpu_and_its_headroom_gate(tmp_path):
    out = tmp_path / "memory.json"
    tel = tmp_path / "tel"
    rc = memory_smoke.main(["--device", "cpu", "--out", str(out),
                            "--telemetry-dir", str(tel)])
    with open(out) as f:
        res = json.load(f)
    assert rc == 0 and res["ok"], res["checks"]
    assert res["fit"]["rel_err"] < 0.10
    peak = res["peak_device_bytes"]
    path = str(tel / "events.jsonl")
    assert slo_monitor.main([path, "--check", "--slo-headroom", "0.2",
                             "--device-bytes", str(peak * 10),
                             "--no-emit"]) == 0
    assert slo_monitor.main([path, "--check", "--slo-headroom", "0.2",
                             "--device-bytes", str(peak * 1.1),
                             "--no-emit"]) != 0


def test_comm_wire_smoke_on_the_cpu(tmp_path):
    """The twin at its quick size (four gloo ranks, K = 2): every check
    holds, the ratios sit under their budgets and the ring accounting is
    exact."""
    out = tmp_path / "comm-wire.json"
    rc = comm_wire_smoke.main(["--device", "cpu", "--quick", "--out",
                               str(out)])
    with open(out) as f:
        res = json.load(f)
    assert rc == 0 and res["ok"], {k: v["ok"] for k, v in
                                   res["checks"].items()}
    assert res["checks"]["wire_ratio"]["value"] <= 0.26
    assert res["checks"]["hier_dcn_ratio"]["value"] <= 0.30
    ev = res["checks"]["bucket_grid"]["overlap_evidence"]
    assert ev["m1_b8"]["first_hop_independent"]
    assert ev["m2_b1"]["first_hop_independent"]
    assert not ev["m1_b1"]["first_hop_independent"]


def test_tp_fusion_smoke_on_the_cpu(tmp_path):
    """The twin at its quick size (four gloo ranks, 2 × 2, K = 2): the
    relaxed PSA modes under their budgets and below full sync, the ring
    accounting exact, no retrace, the trainer's windows stamped."""
    out = tmp_path / "tp-fusion.json"
    rc = tp_fusion_smoke.main(["--device", "cpu", "--quick", "--out",
                               str(out)])
    with open(out) as f:
        res = json.load(f)
    assert rc == 0 and res["ok"], {k: v["ok"] for k, v in
                                   res["checks"].items()}
    modes = res["checks"]["psa_wire_budget"]["modes"]
    assert modes["full"]["measured"] == modes["full"]["budget"]
    assert modes["int8_ef"]["reduction_vs_full"] < 0.3
    assert res["checks"]["tp_ring_analytic"]["ok"]


def test_pp_fusion_smoke_on_the_cpu(tmp_path):
    """The twin at its quick size (four gloo ranks, 2 × 2, K = 2): each
    stage's int8_ef ZeRO-1 data-axis wire at most 0.27 of the plain step's,
    the ring and gather bytes exact per stage, no retrace, the trainer's
    windows stamped."""
    out = tmp_path / "pp-fusion.json"
    rc = pp_fusion_smoke.main(["--device", "cpu", "--quick", "--out",
                               str(out)])
    with open(out) as f:
        res = json.load(f)
    assert rc == 0 and res["ok"], {k: v["ok"] for k, v in
                                   res["checks"].items()}
    stages = res["checks"]["pp_data_wire_ratio"]["stages"]
    assert set(stages) == {"stage0", "stage1"}
    assert all(v["value"] <= 0.27 for v in stages.values())
    for v in res["checks"]["pp_ring_analytic"]["stages"].values():
        assert v["got"] == v["want"]


def test_sp_bench_on_the_cpu(tmp_path):
    """The twin's quick rings (1, 2, 4) at T = 128, one layer: one SP step
    each, the losses equal across the rings, no memory number on the
    CPU."""
    out = tmp_path / "sp-bench.json"
    rc = sp_bench.main(["--device", "cpu", "--quick", "--seq", "128",
                        "--layers", "1", "--out", str(out)])
    with open(out) as f:
        res = json.load(f)
    assert rc == 0 and res["ok"], res["checks"]
    assert [r["n_seq"] for r in res["rows"]] == [1, 2, 4]
    assert all(p is None for r in res["rows"]
               for p in r["peak_bytes_per_rank"])


def test_longctx_bench_on_the_cpu_and_a_failed_point_raises(tmp_path):
    out = tmp_path / "longctx.json"
    doc = longctx_bench.run(str(out), [(64, 2), (128, 1)], ["xla"],
                            config="tiny", steps=2, device="cpu")
    assert [(r["seq"], r["batch"]) for r in doc["rows"]] == [(64, 2),
                                                             (128, 1)]
    assert all(r["tokens_per_sec"] > 0 and r["step_ms"] > 0
               for r in doc["rows"])
    with pytest.raises(RuntimeError, match="T=64 flash failed"):
        longctx_bench.run(str(out), [(64, 2)], ["flash"], config="tiny",
                          steps=1, device="cpu")


def test_elastic_smoke_on_the_cpu(tmp_path):
    out, tel = tmp_path / "elastic.json", tmp_path / "tel"
    rc = elastic_smoke.main(["--device", "cpu", "--out", str(out),
                             "--telemetry-dir", str(tel)])
    with open(out) as f:
        res = json.load(f)
    assert rc == 0 and res["ok"]
    assert res["zero_fault_bitwise"] and res["post_remesh_bitwise"]
    assert res["round_trip_bitwise"] and res["steps_replayed"] == 0
    assert res["pp_data_shrink_ok"] and res["pp_stage_repartition_bitwise"]
    assert [(r["axis"], r["old_shape"], r["new_shape"])
            for r in res["pp_remeshes"]] == [("data", [2, 2], [1, 2]),
                                             ("stage", [1, 4], [1, 2])]
    events = read_events(str(tel / "events.jsonl"), strict=True)
    remesh = [e for e in events if e["type"] == "remesh"]
    assert len(remesh) == 1 and validate_event(remesh[0]) == []
    assert (remesh[0]["old_world"], remesh[0]["new_world"]) == (4, 3)


def test_autoscale_smoke_on_the_cpu(tmp_path):
    out, tel = tmp_path / "autoscale.json", tmp_path / "tel"
    rc = autoscale_smoke.main(["--device", "cpu", "--out", str(out),
                               "--telemetry-dir", str(tel)])
    with open(out) as f:
        res = json.load(f)
    assert rc == 0 and res["ok"], res["checks"]
    assert all(res["checks"].values()) and len(res["checks"]) == 8
    assert [d["direction"] for d in res["decisions"]] == [
        "train_to_serve", "serve_to_train"]
    assert all(r["steps_replayed"] == 0 for r in res["scale_remeshes"])
    assert slo_monitor.main([str(tel), "--check", "--ttft-p99",
                             str(res["ttft_slo_s"]), "--no-emit"]) == 0
    events = read_events(str(tel / "events.jsonl"), strict=True)
    scale = [e for e in events if e["type"] == "scale"]
    assert len(scale) == 2 and all(validate_event(e) == [] for e in scale)
