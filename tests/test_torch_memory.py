"""The port's memory observability (``telemetry/memory.py``) against the
JAX package's, on the CPU at small sizes.

Held exactly: the preflight's ``params_bytes`` and ``opt_state_bytes``
(ZeRO-1's 1/n slice included) for every optimizer and world, its window at
twice the JAX figure (the port's token ids are int64, JAX's int32), the
state bytes equal to the live state's, the allocator census, and the
served streams with the census on equal to those without it."""

import os

import jax
import numpy as np
import pytest
import torch

from ddl25spring_tpu.config import LlamaConfig as JaxLlamaConfig
from ddl25spring_tpu.config import TrainConfig as JaxTrainConfig
from ddl25spring_tpu.serving import PagedKVConfig as JaxPagedKVConfig
from ddl25spring_tpu.serving.kvcache import BlockAllocator as JaxAllocator
from ddl25spring_tpu.telemetry import memory as jmemory
from ddl25spring_tpu.telemetry.comm import tree_bytes as jtree_bytes
from ddl25spring_tpu_torch.bench_utils import make_optimizer
from ddl25spring_tpu_torch.config import LlamaConfig, TrainConfig
from ddl25spring_tpu_torch.models import llama
from ddl25spring_tpu_torch.ops.adam import fused_adam
from ddl25spring_tpu_torch.parallel import dp
from ddl25spring_tpu_torch.serving import (Engine, PagedKVConfig, Scheduler,
                                           run_serving_fleet,
                                           synthetic_workload)
from ddl25spring_tpu_torch.serving.kvcache import BlockAllocator
from ddl25spring_tpu_torch.telemetry import EventLog, read_events
from ddl25spring_tpu_torch.telemetry.memory import (MemoryMeter,
                                                    allocator_census,
                                                    compiled_memory,
                                                    host_rss_bytes,
                                                    np_tree_bytes, preflight,
                                                    program_memory,
                                                    tree_state_bytes)
from ddl25spring_tpu_torch.tree import tree_leaves

torch.set_num_threads(1)

SMALL = dict(vocab_size=64, dmodel=32, num_heads=2, n_layers=2, ctx_size=16)
PAGED = dict(num_blocks=24, block_len=4, max_blocks_per_seq=8)


@pytest.mark.parametrize("aggregation,data,optimizer,k", [
    ("gradient", 1, "adam", 1), ("gradient", 2, "pallas", 4),
    ("zero1", 2, "adam", 1), ("zero1", 3, "fused", 2),
    ("weight", 2, "master", 1)])
def test_preflight_matches_jax_component_by_component(aggregation, data,
                                                      optimizer, k):
    tc = dict(batch_size=3, seq_len=16, data=data, optimizer=optimizer,
              steps_per_dispatch=k)
    mcfg = dict(SMALL, param_dtype="bfloat16" if optimizer == "master"
                else "float32")
    want = jmemory.preflight(JaxLlamaConfig(**mcfg), JaxTrainConfig(**tc),
                             aggregation=aggregation)
    got = preflight(LlamaConfig(**mcfg), TrainConfig(**tc),
                    aggregation=aggregation)
    for key in ("n_data", "param_count", "params_bytes", "opt_state_bytes",
                "opt_state_replicated_bytes", "residual_bytes",
                "kv_pool_bytes"):
        assert got[key] == want[key], key
    # The one difference: int64 token ids against JAX's int32.
    assert got["window_bytes"] == 2 * want["window_bytes"] == k * 3 * 16 * 8
    assert got["state_bytes"] == want["state_bytes"]
    if aggregation == "zero1":
        assert got["opt_state_bytes"] < got["opt_state_replicated_bytes"]


def test_preflight_kv_pool_matches_jax():
    got = preflight(LlamaConfig(**SMALL), paged=PagedKVConfig(**PAGED))
    want = jmemory.preflight(JaxLlamaConfig(**SMALL),
                             paged=JaxPagedKVConfig(**PAGED))
    assert got["kv_pool_bytes"] == want["kv_pool_bytes"] > 0


@pytest.mark.parametrize("aggregation", ["gradient", "zero1"])
def test_preflight_state_bytes_equal_the_live_state(aggregation):
    cfg = LlamaConfig(**SMALL)
    opt = make_optimizer("pallas")
    model = llama.init_llama(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    if aggregation == "zero1":
        state, _ = dp.make_zero1_step(lambda p, b: 0, opt, model.tree())
    else:
        state = dp.init_state(model.tree(), opt)
    pre = preflight(cfg, TrainConfig(optimizer="pallas"),
                    aggregation=aggregation, optimizer=opt)
    live = tree_state_bytes(state.params) + tree_state_bytes(state.opt_state)
    assert pre["state_bytes"] == live


def test_tree_bytes_match_jax():
    tree = {"a": np.zeros((3, 4), np.float32), "b": [np.zeros(5, np.int32),
                                                     np.zeros(2, np.float16)]}
    as_t = jax.tree.map(torch.from_numpy, tree)
    assert tree_state_bytes(as_t) == jtree_bytes(tree) == 48 + 20 + 4
    assert np_tree_bytes(tree) == jmemory.np_tree_bytes(tree)


def test_allocator_census_matches_jax():
    ours, theirs = BlockAllocator(16), JaxAllocator(16)
    for a in (ours, theirs):
        first = a.alloc(5)
        a.alloc(3)
        a.free(first[1:3])
    got = allocator_census(ours, bytes_per_block=128)
    assert got == jmemory.allocator_census(theirs, bytes_per_block=128)
    assert got["pool_used_bytes"] == got["blocks_in_use"] * 128


def test_memory_meter_merges_notes_and_tracks_peaks(tmp_path):
    log = EventLog(str(tmp_path / "events.jsonl"))
    meter = MemoryMeter(log, source="train", device="cpu")
    meter.note(params_bytes=100, opt_state_bytes=200, residual_bytes=None)
    meter.sample(it=0, pool_used_bytes=50)
    rec = meter.sample(it=1)
    log.close()
    assert rec["device_bytes"] == 300.0 and rec["rss_bytes"] > 0
    assert meter.peaks["device_bytes"] == 350.0 and meter.samples == 2
    events = read_events(str(tmp_path / "events.jsonl"))
    assert [e["source"] for e in events] == ["train", "train"]
    assert host_rss_bytes() > 0


def test_measured_peak_is_none_on_the_cpu():
    calls = []
    assert program_memory(lambda x: calls.append(x), torch.ones(3)) is None
    assert compiled_memory(lambda: calls.append(1)) is None
    assert len(calls) == 2          # the call runs all the same


def _serve(memory_every, events=None):
    """Every request queued at time 0 on a clock that stands still, so the
    scheduler's ticks are the same with the census on or off."""
    cfg = LlamaConfig(**SMALL)
    model = llama.init_llama(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    wl = synthetic_workload(seed=2, n_requests=6, rate_rps=400.0,
                            vocab_size=64, prompt_lens=(2, 5, 9),
                            max_news=(3, 6), temperatures=(0.0, 0.7))
    sched = Scheduler(Engine(model, cfg, PagedKVConfig(**PAGED), 3,
                             prefill_chunk=4, device="cpu"),
                      events=events, clock=lambda: 0.0,
                      memory_every=memory_every)
    for r in wl:
        sched.submit(r, now=0.0)
    while sched.outstanding:
        sched.tick()
    return sched.records


def test_memory_every_leaves_the_streams_bitwise_unchanged(tmp_path):
    log = EventLog(str(tmp_path / "events.jsonl"))
    with_census = _serve(4, events=log)
    log.close()
    without = _serve(0)
    assert len(without) == 6
    for rid, rec in without.items():
        assert with_census[rid].tokens == rec.tokens
    mem = [e for e in read_events(str(tmp_path / "events.jsonl"))
           if e["type"] == "memory"]
    assert mem and all(e["source"] == "serve" for e in mem)
    assert [e["tick"] for e in mem] == [4 * (i + 1) for i in range(len(mem))]
    assert all(e["params_bytes"] > 0 and "holes" in e and
               e["pool_capacity_bytes"] > 0 for e in mem)


def test_fleet_memory_census_is_tagged_per_engine(tmp_path):
    cfg = LlamaConfig(**SMALL)
    model = llama.init_llama(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    wl = synthetic_workload(seed=5, n_requests=6, rate_rps=400.0,
                            vocab_size=64, prompt_lens=(2, 5),
                            max_news=(3, 4), temperatures=(0.0,))
    log = EventLog(str(tmp_path / "events.jsonl"))
    rep = run_serving_fleet(model, cfg, PagedKVConfig(**PAGED), wl,
                            num_engines=2, num_slots=2, events=log,
                            memory_every=2, device="cpu")
    log.close()
    mem = [e for e in read_events(str(tmp_path / "events.jsonl"))
           if e["type"] == "memory"]
    assert {e["engine"] for e in mem} == {0, 1}
    assert rep.compiles == [2, 2] and rep.retraces == [0, 0]


def test_trainer_memory_samples_carry_the_preflight(tmp_path):
    from ddl25spring_tpu_torch.telemetry import Telemetry
    from ddl25spring_tpu_torch.tokenizers import ByteTokenizer
    from ddl25spring_tpu_torch.train import llm
    tel = Telemetry(str(tmp_path), step_every=1)
    cfg = dict(SMALL)
    cfg.pop("vocab_size")
    llm.train_llm_dp(LlamaConfig(**cfg), TrainConfig(iters=2, batch_size=2,
                                                     seq_len=16),
                     tokenizer=ByteTokenizer(), log_every=0, device="cpu",
                     telemetry=tel)
    tel.close()
    events = read_events(os.path.join(str(tmp_path), "events.jsonl"))
    pre = events[0]["preflight"]
    mem = [e for e in events if e["type"] == "memory"]
    assert len(mem) == 2
    assert mem[0]["params_bytes"] == pre["params_bytes"]
    assert mem[0]["device_bytes"] == pre["device_bytes"]
    model = llama.init_llama(LlamaConfig(**cfg, vocab_size=259),
                             torch.Generator(), device="cpu")
    assert pre["params_bytes"] == sum(x.numel() * 4
                                      for x in tree_leaves(model.tree()))
    assert pre["opt_state_bytes"] == 4 + 2 * pre["params_bytes"]
    assert tree_state_bytes(fused_adam(1e-3).init(model.tree())) \
        == pre["opt_state_bytes"]
