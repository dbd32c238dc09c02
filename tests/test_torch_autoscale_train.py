"""The autoscaler's training side on the port: ``train_llm_dp(
scale_hook=)`` re-meshing the elastic trainer through
``ElasticController.resize``, against the JAX package's on the CPU mesh,
at ``tests/test_elastic.py``'s tiny config (vocab 259, dmodel 20, 2
heads, 2 layers, ctx 16, batch 2 × 16 per rank, lr 3e-3, fused Adam).

One launch of four ranks for the module (``programs.elastic_calls``): the
same scripted p95 TTFT series drives an ``Autoscaler`` inside the port's
trainer (``programs.SeriesScaleHook``, on the world's rank 0) and inside
JAX's (a closure), ZeRO-1 at K = 2 and gradient aggregation at K = 1.
Held: the decisions, their ``scale`` events and the trainer's worlds are
JAX's; every planned move replays nothing (``steps_replayed == 0``) and
loses no step; the losses are within 1e-5 of JAX's from the port's seed-0
init; and a hook asking for a world outside the pool raises JAX's
error."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl25spring_tpu.config import LlamaConfig as JaxLlamaConfig
from ddl25spring_tpu.config import ResilienceConfig as JaxResilienceConfig
from ddl25spring_tpu.config import TrainConfig as JaxTrainConfig
from ddl25spring_tpu.parallel import make_mesh
from ddl25spring_tpu.resilience.autoscale import (Autoscaler as JaxScaler,
                                                  AutoscalePolicy as JaxPolicy)
from ddl25spring_tpu.telemetry import EventLog as JaxEventLog
from ddl25spring_tpu.telemetry import read_events as jax_read_events
from ddl25spring_tpu.telemetry import validate_event
from ddl25spring_tpu.tokenizers import ByteTokenizer as JaxByteTokenizer
from ddl25spring_tpu.train import llm as jllm
from ddl25spring_tpu_torch.config import LlamaConfig, ResilienceConfig
from ddl25spring_tpu_torch.convert import params_to_numpy
from ddl25spring_tpu_torch.models import llama
from ddl25spring_tpu_torch.parallel import distributed, programs
from ddl25spring_tpu_torch.telemetry import read_events

torch.set_num_threads(1)

TINY = dict(vocab_size=259, dmodel=20, num_heads=2, n_layers=2, ctx_size=16)
BASE = dict(batch_size=2, seq_len=16, lr=3e-3, optimizer="fused")
POLICY = dict(ttft_slo_s=1.2, pressure_frac=0.8, ebb_frac=0.3, sustain=2,
              cooldown=1, min_train_world=2, max_train_world=4,
              min_serve_engines=1, max_serve_engines=3)
# One p95 per interior chunk edge: pressure builds (4 -> 3 -> 2), then
# traffic ebbs (2 -> 3 -> 4).
SERIES = [1.0, 1.0, 1.0, 1.0, 0.1, 0.1, 0.1, None, 0.2, 0.1, 0.1]
# Its ebb asks for a fifth rank of a pool of four.
TOO_BIG = dict(POLICY, sustain=1, cooldown=0, max_train_world=5,
               max_serve_engines=2)
CASES = {"zero1_k2": dict(aggregation="zero1", spd=2, iters=24),
         "gradient_k1": dict(aggregation="gradient", spd=1, iters=12)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("autoscale_train")
    calls = []
    for name, c in CASES.items():
        hook = programs.SeriesScaleHook(
            SERIES, POLICY, train_world=4, serve_engines=1,
            events_path=str(d / f"{name}.jsonl"))
        calls.append(dict(
            cfg=TINY, train_cfg=dict(BASE, iters=c["iters"], data=4,
                                     steps_per_dispatch=c["spd"]),
            kwargs=dict(aggregation=c["aggregation"], scale_hook=hook,
                        resilience=ResilienceConfig(elastic=True))))
    # A hook that asks for more ranks than the pool holds.
    calls.append(dict(cfg=TINY, train_cfg=dict(BASE, iters=4, data=4,
                                               steps_per_dispatch=2),
                      kwargs=dict(aggregation="zero1",
                                  scale_hook=programs.SeriesScaleHook(
                                      [0.1], TOO_BIG, train_world=4,
                                      serve_engines=2),
                                  resilience=ResilienceConfig(
                                      elastic=True))))
    ranks = distributed.run_ranks(programs.elastic_calls, 4, calls,
                                  device="cpu", timeout=600)
    out = {name: [r[i] for r in ranks] for i, name in enumerate(CASES)}
    out["too_big"] = [r[len(CASES)] for r in ranks]
    out["dir"] = str(d)
    return out


def _jax(monkeypatch, devices, tmp_path, name, policy=POLICY,
         series=SERIES, serve=1):
    c = CASES[name]
    tree = params_to_numpy(llama.init_llama(
        LlamaConfig(**TINY), torch.Generator().manual_seed(0), device="cpu"))
    monkeypatch.setattr(jllm.llama, "init_llama",
                        lambda key, cfg: jax.tree.map(jnp.asarray, tree))
    log = JaxEventLog(str(tmp_path / f"{name}.jsonl"))
    scaler = JaxScaler(JaxPolicy(**policy), train_world=4,
                       serve_engines=serve, events=log, log_fn=None)
    series = iter(series)

    def tick(it, world):
        d = scaler.tick(next(series, None), it=it)
        return None if d is None else d.train_world

    rep = jllm.train_llm_dp(
        JaxLlamaConfig(**TINY),
        JaxTrainConfig(**BASE, iters=c["iters"], data=4,
                       steps_per_dispatch=c["spd"]),
        mesh=make_mesh({"data": 4}, devices=devices[:4]),
        tokenizer=JaxByteTokenizer(), aggregation=c["aggregation"],
        log_every=0, resilience=JaxResilienceConfig(elastic=True),
        scale_hook=tick)
    log.close()
    return rep, jax_read_events(log.path, strict=True)


def _plan(remeshes):
    return [{k: v for k, v in r.items() if k != "seconds"}
            for r in remeshes]


@pytest.mark.parametrize("name", list(CASES))
def test_worlds_scale_events_and_losses_are_jaxs(runs, monkeypatch,
                                                 devices, tmp_path, name):
    want, jevents = _jax(monkeypatch, devices, tmp_path, name)
    got = runs[name]
    for r in got:
        assert _plan(r["remeshes"]) == _plan(want.remeshes)
        assert r["losses"] == got[0]["losses"]
    rep = got[0]
    assert [(r["old_world"], r["new_world"]) for r in rep["remeshes"]] == \
        [(4, 3), (3, 2), (2, 3), (3, 4)]
    assert all(r["steps_replayed"] == 0 and r["detected_at"] ==
               r["resume_step"] for r in rep["remeshes"])
    assert len(rep["losses"]) == CASES[name]["iters"]
    assert np.isfinite(rep["losses"]).all()
    np.testing.assert_allclose(rep["losses"], want.losses, atol=1e-5)
    events = read_events(os.path.join(runs["dir"], f"{name}.jsonl"),
                         strict=True)
    fields = ("type", "direction", "train_world", "serve_engines", "signal",
              "value", "it")
    assert [tuple(e.get(k) for k in fields) for e in events] == \
        [tuple(e.get(k) for k in fields) for e in jevents]
    assert all(validate_event(e) == [] for e in events)
    assert len(events) == len(rep["remeshes"])


def test_a_world_beyond_the_pool_raises_jaxs_error(runs, monkeypatch,
                                                   devices, tmp_path):
    with pytest.raises(ValueError) as want:
        _jax(monkeypatch, devices, tmp_path, "zero1_k2", policy=TOO_BIG,
             series=[0.1], serve=2)
    for r in runs["too_big"]:
        assert r["error"] == ["ValueError", str(want.value)]
