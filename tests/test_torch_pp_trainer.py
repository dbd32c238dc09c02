"""The port's pipeline trainer (``train.llm.train_llm_pp``) against the JAX
package's on the CPU mesh, at the byte tokenizer's vocab (259), dmodel 16,
2 heads, 3 layers, ctx 16, batch 3 × 16 per data row in 3 microbatches,
fused Adam; both trainers start from the port's seed-0 init (the JAX init
patched to return it).

Two launches of stage processes for the module (``programs.
pp_trainer_calls``), each running several trainer calls inside its group:
``stage=3`` (the reference's 3-stage run) and ``data=2, stage=3`` (its
2 pipelines × 3 stages). Held:

- losses within 1e-5 of JAX's over 3 steps, GPipe and 1F1B;
- a run resumed from a step-2 checkpoint within 1e-6 of the uninterrupted
  run, and the checkpoint in the data-parallel file format;
- a guarded fault-free run bitwise the unguarded one;
- a NaN fault in a leaf only the last stage holds, skipped on every rank:
  the merged checkpoint after the skip bitwise a run that stopped before
  it, the counters equal to JAX's;
- the numerics events (``numerics_every=1``) against JAX's: group names
  equal, values within 1e-5;
- every option the JAX trainer refuses refused with the same exception
  type;
- the DP×PP ring drivers (fp32 gradient and ZeRO-1, int8_ef ZeRO-1 at two
  buckets) and elastic mode with no fault, within 1e-5 of JAX's losses
  (1e-3 for the int8 wire)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl25spring_tpu.config import LlamaConfig as JaxLlamaConfig
from ddl25spring_tpu.config import ResilienceConfig as JaxResilienceConfig
from ddl25spring_tpu.config import TrainConfig as JaxTrainConfig
from ddl25spring_tpu.resilience import FaultPlan as JaxFaultPlan
from ddl25spring_tpu.telemetry import Telemetry as JaxTelemetry
from ddl25spring_tpu.telemetry import read_events as jread_events
from ddl25spring_tpu.tokenizers import ByteTokenizer as JaxByteTokenizer
from ddl25spring_tpu.train import llm as jllm
from ddl25spring_tpu_torch.config import (LlamaConfig, ResilienceConfig,
                                          TrainConfig)
from ddl25spring_tpu_torch.convert import params_to_numpy
from ddl25spring_tpu_torch.models import llama
from ddl25spring_tpu_torch.parallel import distributed, programs
from ddl25spring_tpu_torch.telemetry import Telemetry, read_events
from ddl25spring_tpu_torch.tokenizers import ByteTokenizer
from ddl25spring_tpu_torch.train import llm

torch.set_num_threads(1)

MCFG = dict(dmodel=16, num_heads=2, n_layers=3, ctx_size=16)
TCFG = dict(batch_size=3, seq_len=16, iters=3, stage=3, microbatches=3,
            optimizer="fused")
LM_HEAD = 12      # 1-based leaf number of lm_head in the whole tree
RING_AND_ELASTIC = [
    (dict(overlap_microbatches=1), "gradient", None),
    (dict(overlap_microbatches=1), "zero1", None),
    (dict(overlap_microbatches=1, wire="int8_ef", comm_buckets=2), "zero1",
     None),
    ({}, "gradient", ResilienceConfig(elastic=True))]


def _port_init():
    cfg = LlamaConfig(**MCFG, vocab_size=259)
    return params_to_numpy(llama.init_llama(
        cfg, torch.Generator().manual_seed(0), device="cpu"))


def _jax_run(monkeypatch, tcfg, **kw):
    tree = _port_init()
    monkeypatch.setattr(jllm.llama, "init_llama",
                        lambda key, cfg: jax.tree.map(jnp.asarray, tree))
    return jllm.train_llm_pp(JaxLlamaConfig(**MCFG), JaxTrainConfig(**tcfg),
                             tokenizer=JaxByteTokenizer(), log_every=0,
                             **kw)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return tmp_path_factory.mktemp("pp_trainer")


@pytest.fixture(scope="module")
def stage3(dirs):
    """One launch of three stage processes: every ``stage=3`` call."""
    ck, clean, faulted = (str(dirs / n) for n in ("ck", "clean", "faulted"))
    tel = Telemetry(str(dirs / "tel"))
    calls = {
        "gpipe": (MCFG, TCFG, {}),
        "1f1b": (MCFG, TCFG, {"schedule": "1f1b"}),
        "first": (MCFG, dict(TCFG, iters=2),
                  {"checkpoint_dir": ck, "checkpoint_every": 100}),
        "resumed": (MCFG, TCFG,
                    {"checkpoint_dir": ck, "checkpoint_every": 100}),
        "guarded": (MCFG, TCFG, {"resilience": ResilienceConfig()}),
        "clean": (MCFG, dict(TCFG, iters=1), {"checkpoint_dir": clean}),
        "faulted": (MCFG, dict(TCFG, iters=2),
                    {"checkpoint_dir": faulted,
                     "resilience": ResilienceConfig(),
                     "fault_plan": f"nan_grad@1:{LM_HEAD}"}),
        "numerics": (MCFG, dict(TCFG, iters=2, numerics_every=1),
                     {"telemetry": tel}),
    }
    for i, (tcfg, aggregation, resilience) in enumerate(RING_AND_ELASTIC):
        calls[f"ring{i}"] = (MCFG, dict(TCFG, **tcfg),
                             {"aggregation": aggregation,
                              "resilience": resilience})
    ranks = distributed.run_ranks(programs.pp_trainer_calls, 3,
                                  list(calls.values()), device="cpu",
                                  timeout=600)
    tel.close()
    out = {name: [r[i] for r in ranks] for i, name in enumerate(calls)}
    out["dirs"] = dict(ck=ck, clean=clean, faulted=faulted,
                       tel=str(dirs / "tel"))
    return out


@pytest.fixture(scope="module")
def data2_stage3():
    """One launch of six processes: two pipelines of three stages."""
    tcfg = dict(TCFG, data=2)
    ranks = distributed.run_ranks(programs.pp_trainer_calls, 6,
                                  [(MCFG, tcfg, {}),
                                   (MCFG, tcfg, {"schedule": "1f1b"})],
                                  device="cpu", timeout=600)
    return {"gpipe": [r[0] for r in ranks], "1f1b": [r[1] for r in ranks]}


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_stage3_losses_match_jax(stage3, monkeypatch, schedule):
    jrep = _jax_run(monkeypatch, TCFG, schedule=schedule)
    for r in stage3[schedule]:
        assert r["steps"] == 3 and len(r["losses"]) == 3
        np.testing.assert_allclose(r["losses"], jrep.losses, atol=1e-5)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_data2_stage3_losses_match_jax(data2_stage3, monkeypatch, schedule):
    jrep = _jax_run(monkeypatch, dict(TCFG, data=2), schedule=schedule)
    for r in data2_stage3[schedule]:
        assert r["steps"] == 3
        np.testing.assert_allclose(r["losses"], jrep.losses, atol=1e-5)


def test_resume_continues_the_uninterrupted_run(stage3):
    first, resumed = stage3["first"][0], stage3["resumed"][0]
    assert resumed["start_step"] == 2 and len(resumed["losses"]) == 1
    np.testing.assert_allclose(first["losses"] + resumed["losses"],
                               stage3["gpipe"][0]["losses"], atol=1e-6)


def test_checkpoint_is_the_merged_jax_layout_state(stage3):
    """Rank 0 wrote the whole model: the file a data-parallel state of the
    same model writes, and ``train_llm_dp``'s state restores from it."""
    from ddl25spring_tpu_torch.checkpoint import Checkpointer
    from ddl25spring_tpu_torch.ops.adam import fused_adam
    from ddl25spring_tpu_torch.parallel import dp

    cfg = LlamaConfig(**MCFG, vocab_size=259)
    model = llama.init_llama(cfg, torch.Generator().manual_seed(1),
                             device="cpu")
    template = dp.init_state(model.tree(), fused_adam(8e-4))
    state = Checkpointer(stage3["dirs"]["ck"]).restore(template)
    assert int(state.step) == 3 and int(state.opt_state.count) == 3
    assert state.params["blocks"]["wq"].shape[0] == 3
    assert all(bool(torch.isfinite(x).all()) for x in
               jax.tree.leaves(jax.tree.map(lambda t: t.detach(),
                                            state.params)))


def test_guarded_fault_free_run_is_bitwise_unguarded(stage3):
    for g, u in zip(stage3["guarded"], stage3["gpipe"]):
        assert g["losses"] == u["losses"]
        assert g["resilience"]["skipped_steps"] == 0


def test_fault_is_skipped_on_every_rank(stage3, monkeypatch):
    """``nan_grad@1`` in ``lm_head``, which only the last stage holds: every
    rank skips step 1 (the loss is NaN everywhere), and the merged state
    after it is bitwise the state after step 0 alone."""
    jrep = _jax_run(monkeypatch, dict(TCFG, iters=2),
                    resilience=JaxResilienceConfig(),
                    fault_plan=JaxFaultPlan.from_spec(f"nan_grad@1:{LM_HEAD}"))
    for r in stage3["faulted"]:
        assert r["resilience"] == stage3["faulted"][0]["resilience"]
        assert r["resilience"]["skipped_steps"] == \
            jrep.resilience.skipped_steps == 1
        assert r["resilience"]["rollbacks"] == jrep.resilience.rollbacks == 0
        assert np.isnan(r["losses"][1]) and np.isnan(jrep.losses[1])
        np.testing.assert_allclose(r["losses"][0], jrep.losses[0], atol=1e-5)
    d = stage3["dirs"]
    after = torch.load(os.path.join(d["faulted"], "2.pt"))["tensors"]
    before = torch.load(os.path.join(d["clean"], "1.pt"))["tensors"]
    assert len(after) == len(before)
    for a, b in zip(after, before):
        assert torch.equal(a, b)


def test_numerics_events_match_jax(stage3, monkeypatch, tmp_path):
    jtel = JaxTelemetry(str(tmp_path))
    _jax_run(monkeypatch, dict(TCFG, iters=2, numerics_every=1),
             telemetry=jtel)
    jtel.close()
    want = [e for e in jread_events(os.path.join(str(tmp_path),
                                                 "events.jsonl"))
            if e["type"] == "numerics"]
    got = [e for e in read_events(os.path.join(stage3["dirs"]["tel"],
                                               "events.jsonl"))
           if e["type"] == "numerics"]
    assert [e["it"] for e in got] == [e["it"] for e in want] == [0, 1]
    manifest = next(e for e in read_events(os.path.join(
        stage3["dirs"]["tel"], "events.jsonl")) if e["type"] == "manifest")
    assert manifest["trainer"] == "pp"
    assert manifest["mesh"] == {"data": 1, "stage": 3}
    for g, w in zip(got, want):
        assert g["worst_group"] == w["worst_group"]
        assert list(g["groups"]) == list(w["groups"])
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-5)
        for name, vals in w["groups"].items():
            for k, v in vals.items():
                np.testing.assert_allclose(g["groups"][name][k], v,
                                           rtol=1e-5)


REFUSED = [
    (dict(accum_steps=2), "gradient"),
    (dict(dcn=2), "gradient"),
    (dict(wire_dcn="int8_ef"), "gradient"),
    (dict(wire="bf16"), "gradient"),
    (dict(comm_buckets=2), "gradient"),
    (dict(steps_per_dispatch=0), "gradient"),
    (dict(overlap_microbatches=-1), "gradient"),
    ({}, "zero1"),
    ({}, "weight"),
]


@pytest.mark.parametrize("tcfg,aggregation", REFUSED)
def test_refuses_what_jax_refuses(tcfg, aggregation):
    cfg = dict(TCFG, **tcfg)
    with pytest.raises(ValueError) as jerr:
        jllm.train_llm_pp(JaxLlamaConfig(**MCFG), JaxTrainConfig(**cfg),
                          tokenizer=JaxByteTokenizer(), log_every=0,
                          aggregation=aggregation)
    with pytest.raises(ValueError) as err:
        llm.train_llm_pp(LlamaConfig(**MCFG), TrainConfig(**cfg),
                         tokenizer=ByteTokenizer(), aggregation=aggregation,
                         device="cpu")
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("resilience,scale_hook", [
    (dict(injit_guard=True, guard=False), None),
    ({}, lambda *a: None)])
def test_refuses_the_guard_and_hook_jax_refuses(resilience, scale_hook):
    with pytest.raises(ValueError) as jerr:
        jllm.train_llm_pp(JaxLlamaConfig(**MCFG), JaxTrainConfig(**TCFG),
                          tokenizer=JaxByteTokenizer(),
                          resilience=JaxResilienceConfig(**resilience),
                          scale_hook=scale_hook)
    with pytest.raises(ValueError) as err:
        llm.train_llm_pp(LlamaConfig(**MCFG), TrainConfig(**TCFG),
                         tokenizer=ByteTokenizer(),
                         resilience=ResilienceConfig(**resilience),
                         scale_hook=scale_hook, device="cpu")
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("tcfg,aggregation,resilience", RING_AND_ELASTIC)
def test_ring_drivers_and_elastic_name_roadmap(stage3, monkeypatch,
                                               record_property, tcfg,
                                               aggregation, resilience):
    """The ring drivers and elastic mode run at ``stage=3`` and match
    JAX's losses: within 1e-5, and within 1e-3 for the int8 wire, whose
    second leg quantizes each stage's own vector where JAX's agrees its
    scales over the stages."""
    i = RING_AND_ELASTIC.index((tcfg, aggregation, resilience))
    jrep = _jax_run(monkeypatch, dict(TCFG, **tcfg), aggregation=aggregation,
                    resilience=(None if resilience is None else
                                JaxResilienceConfig(elastic=True)))
    tol = 1e-3 if tcfg.get("wire") == "int8_ef" else 1e-5
    record_property("loss_abs_err", float(np.max(np.abs(
        np.asarray(stage3[f"ring{i}"][0]["losses"])
        - np.asarray(jrep.losses)))))
    for r in stage3[f"ring{i}"]:
        assert len(r["losses"]) == 3
        np.testing.assert_allclose(r["losses"], jrep.losses, atol=tol,
                                   rtol=0)
