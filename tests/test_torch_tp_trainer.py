"""The port's tensor-parallel trainer (``train.llm.train_llm_tp``) against
the JAX package's on the CPU mesh, at the byte tokenizer's vocab (259),
dmodel 32, 4 heads, 2 layers, ctx 16, batch 4 × 16 per data row, fused
Adam; both trainers start from the port's seed-0 init (the JAX init
patched to return it).

Three launches for the module (``programs.tp_cases``, driver "trainer"),
each running several trainer calls inside its group: ``model=2``,
``data=2 × model=2``, and ``model=2`` at half the canonical width and its
full depth (dmodel 144, 6 heads, 6 layers, ctx 256). Held:

- losses within 1e-5 of JAX's over 3 steps: the plain step, ``psa``
  int8_ef at K = 2, and the DP×TP ring (M = 2, int8_ef, ZeRO-1);
- at half width over 8 steps, through the loss spike of step 6 that the
  reference's plain trajectory has there: the plain step within 1e-4 of
  JAX's, ``psa="int8_ef"`` at K = 2 within 1% of JAX's loss at every step,
  and both spike at the same step as JAX;
- a run resumed from a step-2 checkpoint bitwise the uninterrupted run;
- a guarded fault-free run bitwise the unguarded one, and a ``nan_grad``
  in ``wq`` injected on model shard 1 alone skipped on both shards (the
  guard's verdict is summed over the model group), the merged state after
  it bitwise the state before the fault;
- the manifest (``trainer="tp"``, the mesh, a comm profile with the
  ``model`` axis) and the compile events (JAX's name, one program per
  window size);
- every error of ``tests/test_tp.py``'s two error tests with JAX's type
  and text;
- elastic mode, with and without a ``scale_hook``, bitwise the plain run
  at no fault."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl25spring_tpu.config import LlamaConfig as JaxLlamaConfig
from ddl25spring_tpu.config import ResilienceConfig as JaxResilienceConfig
from ddl25spring_tpu.resilience import FaultPlan as JaxFaultPlan
from ddl25spring_tpu.config import TrainConfig as JaxTrainConfig
from ddl25spring_tpu.parallel import make_mesh
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

MCFG = dict(dmodel=32, num_heads=4, n_layers=2, ctx_size=16)
TCFG = dict(batch_size=4, seq_len=16, iters=3, model=2, optimizer="fused",
            lr=3e-3)
RING = dict(overlap_microbatches=2, wire="int8_ef")
WQ = 8            # 1-based leaf number of wq (sharded) in the whole tree


def _port_init(mcfg=MCFG):
    cfg = LlamaConfig(**mcfg, vocab_size=259)
    return params_to_numpy(llama.init_llama(
        cfg, torch.Generator().manual_seed(0), device="cpu"))


def _jax_run(monkeypatch, tcfg, mcfg=MCFG, **kw):
    tree = _port_init(mcfg)
    monkeypatch.setattr(jllm.llama, "init_llama",
                        lambda key, cfg: jax.tree.map(jnp.asarray, tree))
    d, m = tcfg.get("data", 1), tcfg["model"]
    mesh = make_mesh({"data": d, "model": m}, devices=jax.devices()[:d * m])
    return jllm.train_llm_tp(JaxLlamaConfig(**mcfg), JaxTrainConfig(**tcfg),
                             mesh=mesh, tokenizer=JaxByteTokenizer(),
                             log_every=0, **kw)


def _call(tcfg, **kwargs):
    d, m = tcfg.get("data", 1), tcfg["model"]
    return dict(cfg=MCFG, train_cfg=tcfg, kwargs=kwargs, data=d, model=m,
                driver="trainer")


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return tmp_path_factory.mktemp("tp_trainer")


@pytest.fixture(scope="module")
def model2(dirs):
    """One launch of two ranks: every ``model=2`` call."""
    ck, clean, faulted = (str(dirs / n) for n in ("ck", "clean", "faulted"))
    tel = Telemetry(str(dirs / "tel"))
    calls = {
        "plain": _call(TCFG),
        "int8_k2": _call(dict(TCFG, psa="int8_ef", steps_per_dispatch=2)),
        "first": _call(dict(TCFG, iters=2), checkpoint_dir=ck,
                       checkpoint_every=100),
        "resumed": _call(TCFG, checkpoint_dir=ck, checkpoint_every=100),
        "observed": _call(dict(TCFG, psa="defer:2"), telemetry=tel),
        "guarded": _call(TCFG, resilience=ResilienceConfig()),
        "clean": _call(dict(TCFG, iters=1), checkpoint_dir=clean),
        "faulted": dict(_call(dict(TCFG, iters=2), checkpoint_dir=faulted,
                              resilience=ResilienceConfig(),
                              fault_plan=f"nan_grad@1:{WQ}"),
                        fault_ranks=[1]),
        "elastic": _call(TCFG, resilience=ResilienceConfig(elastic=True)),
        "elastic_hook": _call(TCFG, resilience=ResilienceConfig(elastic=True),
                              scale_hook=programs.KeepWorldHook()),
    }
    ranks = distributed.run_ranks(programs.tp_cases, 2, list(calls.values()),
                                  device="cpu", timeout=600)
    tel.close()
    out = {name: [r[i] for r in ranks] for i, name in enumerate(calls)}
    out["dirs"] = dict(tel=str(dirs / "tel"), clean=clean, faulted=faulted)
    return out


HALF = dict(dmodel=144, num_heads=6, n_layers=6, ctx_size=256)
HALF_TCFG = dict(batch_size=4, seq_len=256, iters=8, model=2,
                 optimizer="fused")
HALF_RUNS = {"plain": HALF_TCFG,
             "int8_k2": dict(HALF_TCFG, psa="int8_ef", steps_per_dispatch=2)}


@pytest.fixture(scope="module")
def half_width():
    """One launch of two ranks at half width: the plain and int8_ef runs."""
    calls = [dict(_call(t), cfg=HALF) for t in HALF_RUNS.values()]
    ranks = distributed.run_ranks(programs.tp_cases, 2, calls, device="cpu",
                                  timeout=600)
    return {name: [r[i] for r in ranks] for i, name in enumerate(HALF_RUNS)}


@pytest.fixture(scope="module")
def data2_model2():
    """One launch of four ranks: two data rows of two model shards."""
    tcfg = dict(TCFG, data=2)
    calls = [_call(tcfg), _call(dict(tcfg, **RING), aggregation="zero1")]
    ranks = distributed.run_ranks(programs.tp_cases, 4, calls,
                                  device="cpu", timeout=600)
    return {"plain": [r[0] for r in ranks], "ring": [r[1] for r in ranks]}


@pytest.mark.parametrize("name,tcfg", [
    ("plain", TCFG),
    ("int8_k2", dict(TCFG, psa="int8_ef", steps_per_dispatch=2))])
def test_model2_losses_match_jax(model2, monkeypatch, name, tcfg):
    jrep = _jax_run(monkeypatch, tcfg)
    for r in model2[name]:
        assert r["steps"] == 3 and len(r["losses"]) == 3
        np.testing.assert_allclose(r["losses"], jrep.losses, atol=1e-5)


@pytest.mark.parametrize("name,tcfg,kw", [
    ("plain", dict(TCFG, data=2), {}),
    ("ring", dict(TCFG, data=2, **RING), {"aggregation": "zero1"})])
def test_data2_model2_losses_match_jax(data2_model2, monkeypatch, name,
                                       tcfg, kw):
    jrep = _jax_run(monkeypatch, tcfg, **kw)
    for r in data2_model2[name]:
        assert r["steps"] == 3
        np.testing.assert_allclose(r["losses"], jrep.losses, atol=1e-5)


@pytest.mark.parametrize("name", list(HALF_RUNS))
def test_half_width_trajectory_matches_jax_through_its_spike(
        half_width, monkeypatch, name):
    """8 steps at half width and full depth: the reference's own plain
    trajectory rises at step 6 and falls back at step 7, and the port's
    does so at the same step, in both modes."""
    jl = np.array(_jax_run(monkeypatch, HALF_RUNS[name], mcfg=HALF).losses)
    for r in half_width[name]:
        got = np.array(r["losses"])
        assert len(got) == 8
        if name == "plain":
            np.testing.assert_allclose(got, jl, atol=1e-4)
        else:
            np.testing.assert_allclose(got, jl, rtol=1e-2)
        assert np.argmax(np.diff(got)) == np.argmax(np.diff(jl))


def test_resume_continues_the_uninterrupted_run(model2):
    for first, resumed, plain in zip(model2["first"], model2["resumed"],
                                     model2["plain"]):
        assert resumed["start_step"] == 2 and len(resumed["losses"]) == 1
        assert first["losses"] + resumed["losses"] == plain["losses"]


def test_guarded_fault_free_run_is_bitwise_unguarded(model2):
    for g, u in zip(model2["guarded"], model2["plain"]):
        assert g["losses"] == u["losses"]
        assert g["resilience"]["skipped_steps"] == 0
        assert g["resilience"]["anomalies"] == 0


def test_fault_on_one_shard_is_skipped_on_both(model2, monkeypatch):
    """``nan_grad@1`` in wq, which each shard holds a slice of, injected on
    shard 1 alone: shard 0 sees finite values, yet both skip step 1 (as
    JAX's guard skips the poisoned global step), and the merged state
    after it is bitwise the state after step 0 alone."""
    jrep = _jax_run(monkeypatch, dict(TCFG, iters=2),
                    resilience=JaxResilienceConfig(),
                    fault_plan=JaxFaultPlan.from_spec(f"nan_grad@1:{WQ}"))
    shard0, shard1 = model2["faulted"]
    for r in (shard0, shard1):
        assert r["resilience"] == shard0["resilience"]
        assert r["resilience"]["skipped_steps"] == \
            jrep.resilience.skipped_steps == 1
        assert r["resilience"]["rollbacks"] == jrep.resilience.rollbacks == 0
        np.testing.assert_allclose(r["losses"][0], jrep.losses[0], atol=1e-5)
    assert np.isnan(shard1["losses"][1]) and np.isnan(jrep.losses[1])
    assert np.isfinite(shard0["losses"][1])
    d = model2["dirs"]
    after = torch.load(os.path.join(d["faulted"], "2.pt"))["tensors"]
    before = torch.load(os.path.join(d["clean"], "1.pt"))["tensors"]
    assert len(after) == len(before)
    for a, b in zip(after, before):
        assert torch.equal(a, b)


def test_manifest_and_compile_events(model2):
    events = read_events(os.path.join(model2["dirs"]["tel"],
                                      "events.jsonl"))
    manifest = next(e for e in events if e["type"] == "manifest")
    assert manifest["trainer"] == "tp"
    assert manifest["mesh"] == {"data": 1, "model": 2}
    axes = manifest["comm"]["axes"]
    assert "model" in axes and axes["model"]["wire_bytes_per_device"] > 0
    assert "psa_defer_sync" in manifest["comm"]["collectives"]
    compiles = [e for e in events if e["type"] == "compile"]
    assert [e["name"] for e in compiles] == ["train/tp-psa-defer2"]
    assert not any(e.get("retrace") for e in compiles)


# --------------------------------------------------------------- errors

BASE = dict(batch_size=4, seq_len=16, iters=2, lr=3e-3, model=4)
REFUSED = [
    (dict(accum_steps=4), "gradient", {}),
    (dict(dcn=2, wire_dcn="int8_ef"), "gradient", {}),
    (dict(wire="int8_ef"), "gradient", {}),
    ({}, "zero1", {}),
    (dict(overlap_microbatches=1), "zero1", {"elastic": True}),
    (dict(psa="int8_ef", numerics_every=1), "gradient", {"elastic": True}),
    ({}, "gradient", {"scale_hook": True}),
    ({}, "gradient", {"injit_guard": True, "guard": False}),
    (dict(model=1), "gradient", {}),
    (dict(psa="bogus"), "gradient", {}),
    (dict(psa="defer:3"), "gradient", {}),
    (dict(comm_buckets=2), "gradient", {}),
    (dict(steps_per_dispatch=0), "gradient", {}),
    (dict(overlap_microbatches=1, psa="int8_ef"), "zero1", {}),
    ({}, "weight", {}),
]


@pytest.mark.parametrize("tcfg,aggregation,extra", REFUSED)
def test_refuses_what_jax_refuses(tcfg, aggregation, extra):
    extra = dict(extra)
    hook = (lambda *a: None) if extra.pop("scale_hook", False) else None
    cfg = dict(BASE, **tcfg)
    m = cfg["model"]
    with pytest.raises(ValueError) as jerr:
        jllm.train_llm_tp(
            JaxLlamaConfig(**MCFG), JaxTrainConfig(**cfg),
            mesh=make_mesh({"data": 1, "model": m},
                           devices=jax.devices()[:m]),
            tokenizer=JaxByteTokenizer(), log_every=0,
            aggregation=aggregation, scale_hook=hook,
            resilience=JaxResilienceConfig(**extra) if extra else None)
    with pytest.raises(ValueError) as err:
        llm.train_llm_tp(LlamaConfig(**MCFG), TrainConfig(**cfg),
                         tokenizer=ByteTokenizer(), aggregation=aggregation,
                         scale_hook=hook,
                         resilience=ResilienceConfig(**extra) if extra
                         else None, device="cpu")
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("hook", [False, True])
def test_elastic_and_scale_hook_name_roadmap(model2, hook):
    """Elastic mode (and a ``scale_hook`` that asks for no change) with no
    fault: bitwise the plain run, no re-mesh."""
    for e, u in zip(model2["elastic_hook" if hook else "elastic"],
                    model2["plain"]):
        assert e["losses"] == u["losses"] and len(e["losses"]) == 3
        assert e["resilience"]["remeshes"] == 0
