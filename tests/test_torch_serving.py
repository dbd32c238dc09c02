"""The port's serving layer: block accounting, the engine's streams against
the port's own ``generate()`` (token for token at any slot, greedy and
sampled, with chunked prefill straddling blocks), ``run_serving`` under
load, and the greedy streams against the JAX package's ``generate``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl25spring_tpu.config import LlamaConfig as JaxLlamaConfig
from ddl25spring_tpu.models import generate as jgen
from ddl25spring_tpu.models import llama as jllama
from ddl25spring_tpu.serving import synthetic_workload as jax_workload
from ddl25spring_tpu.telemetry.events import read_events, validate_event
from ddl25spring_tpu.telemetry.trace import trace_trees, tree_check
from ddl25spring_tpu_torch.config import LlamaConfig
from ddl25spring_tpu_torch.convert import params_from_jax
from ddl25spring_tpu_torch.serving import (BlockAllocator, Engine,
                                           PagedKVConfig, Request, Scheduler,
                                           blocks_for, naive_cache_bytes,
                                           pool_bytes, reference_stream,
                                           run_serving, synthetic_workload)
from ddl25spring_tpu_torch.telemetry.events import EventLog

torch.set_num_threads(1)

SMALL = dict(vocab_size=128, dmodel=96, num_heads=2, n_layers=2, ctx_size=64)
CFG = LlamaConfig(**SMALL)
PAGED = PagedKVConfig(num_blocks=24, block_len=4, max_blocks_per_seq=8)


@pytest.fixture(scope="module")
def pair():
    jcfg = JaxLlamaConfig(**SMALL)
    jp = jllama.init_llama(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), CFG,
                                     device="cpu")


def _ref(model, req, paged=PAGED):
    return reference_stream(model, CFG, paged, req, device="cpu")


# ---------------------------------------------------------------- allocator

def _alloc_never_trash():
    a = BlockAllocator(8)
    got = a.alloc(7)
    assert 0 not in got and sorted(got) == list(range(1, 8))


def _alloc_all_or_nothing():
    a = BlockAllocator(6)
    x = a.alloc(3)
    assert a.alloc(3) is None and a.in_use == 3
    a.free(x)
    assert a.in_use == 0 and a.peak_in_use == 3
    assert a.alloc(5) is not None


def _alloc_free_validates():
    a = BlockAllocator(4)
    got = a.alloc(2)
    with pytest.raises(ValueError, match="not an allocatable"):
        a.free([0])
    a.free(got)
    with pytest.raises(ValueError, match="double free"):
        a.free([got[0]])


def _alloc_refcounts():
    a = BlockAllocator(8)
    got = a.alloc(3)
    a.share(got[:2])
    assert a.in_use == 3 and a.refcount(got[0]) == 2
    assert a.free(got) == [got[2]]
    assert sorted(a.free(got[:2])) == sorted(got[:2]) and a.in_use == 0
    with pytest.raises(ValueError, match="not allocated"):
        a.share([got[0]])


def _alloc_lowest_first_after_free():
    a = BlockAllocator(6)
    got = a.alloc(5)
    a.free([got[3], got[1]])
    assert a.alloc(2) == [got[1], got[3]]


def _sizing_math():
    assert [blocks_for(n, 4) for n in (0, 1, 4, 5)] == [0, 1, 1, 2]
    per_pos = 2 * CFG.n_layers * CFG.num_heads * CFG.head_dim * 4
    assert pool_bytes(CFG, PAGED) == 24 * 4 * per_pos
    assert naive_cache_bytes(CFG, 3, 32) == 3 * 32 * per_pos


@pytest.mark.parametrize("case", [_alloc_never_trash, _alloc_all_or_nothing,
                                  _alloc_free_validates, _alloc_refcounts,
                                  _alloc_lowest_first_after_free,
                                  _sizing_math], ids=lambda f: f.__name__)
def test_block_accounting(case):
    case()


# ------------------------------------------------------------------ engine

def test_engine_streams_equal_generate_at_any_slot(pair):
    """Greedy and sampled requests, prompts straddling several blocks and
    prefill chunks, admitted into every slot in turn: each stream equals
    the port's generate() for the request alone."""
    _, _, model = pair
    reqs = [Request(rid=f"r{i}", prompt=tuple(range(3 + 5 * i, 14 + 6 * i)),
                    max_new=6 + i, temperature=(0.0, 0.8)[i % 2], seed=40 + i)
            for i in range(4)]
    slots_used = set()
    for n_fill in range(3):
        # Fillers ahead in the queue push each request to another slot.
        fill = [Request(rid=f"f{i}", prompt=(1, 2), max_new=9)
                for i in range(n_fill)]
        eng = Engine(model, CFG, PAGED, 3, prefill_chunk=3, device="cpu")
        sched = Scheduler(eng)
        for r in fill + reqs:
            sched.submit(r, now=0.0)
        while sched.outstanding:
            sched.tick()
            slots_used |= {(s, r.rid) for s, r in sched._by_slot.items()}
        for r in fill + reqs:
            assert sched.records[r.rid].tokens == _ref(model, r), (
                n_fill, r.rid)
    for r in reqs:      # every request was served from more than one slot
        assert len({s for s, rid in slots_used if rid == r.rid}) > 1


def test_engine_rejects_what_it_cannot_serve(pair):
    _, _, model = pair
    eng = Engine(model, CFG, PAGED, 1, device="cpu")
    with pytest.raises(ValueError, match="cache positions"):
        eng.admit(np.zeros(30, np.int64), 8)       # 37 > max_seq_len 32
    with pytest.raises(ValueError, match="generator"):
        eng.admit(np.zeros(3, np.int64), 2, temperature=0.5)
    sched = Scheduler(eng)
    with pytest.raises(ValueError, match="oversized"):
        sched.submit(Request(rid="x", prompt=tuple(range(20)), max_new=60))


def test_prefill_is_fcfs_by_admission_not_slot_index(pair):
    eng = Engine(pair[2], CFG, PAGED, 2, prefill_chunk=2, device="cpu")
    eng.admit(np.arange(2), 1)                      # slot 0, retires at once
    b = eng.admit(np.arange(8), 2)                  # slot 1, four chunks
    assert [e.done for e in eng.step() if e.first] == [True]
    c = eng.admit(np.arange(4), 2)                  # the freed slot 0
    order = []
    while eng.busy:
        order += [ev.slot for ev in eng.step() if ev.first]
    assert (b, c) == (1, 0) and order == [b, c]


def test_eos_retires_early_and_keeps_the_stream(pair):
    _, _, model = pair
    prompt = tuple(range(2, 8))
    full = _ref(model, Request(rid="p", prompt=prompt, max_new=12))
    eos = full[1]
    eng = Engine(model, CFG, PAGED, 1, prefill_chunk=8, device="cpu")
    sched = Scheduler(eng)
    sched.submit(Request(rid="a", prompt=prompt, max_new=12, eos_id=eos))
    while sched.outstanding:
        sched.tick()
    assert sched.records["a"].tokens == full[:full.index(eos) + 1]
    assert eng.allocator.in_use == 0


# ------------------------------------------------------------- run_serving

def test_run_serving_retires_every_request_and_matches_generate(pair):
    _, _, model = pair
    wl = synthetic_workload(seed=3, n_requests=10, rate_rps=200.0,
                            vocab_size=CFG.vocab_size, prompt_lens=(2, 5, 9),
                            max_news=(3, 5, 8), temperatures=(0.0, 0.7))
    rep = run_serving(model, CFG, PAGED, wl, num_slots=3, prefill_chunk=4,
                      device="cpu")
    assert rep.aggregates["completed"] == len(wl)
    assert rep.peak_blocks_in_use <= rep.pool_blocks
    for r in wl:
        assert len(rep.records[r.rid].tokens) == r.max_new
        assert rep.records[r.rid].tokens == _ref(model, r), r.rid


def test_tight_pool_queues_and_never_deadlocks(pair):
    _, _, model = pair
    tiny = PagedKVConfig(num_blocks=7, block_len=4, max_blocks_per_seq=8)
    wl = synthetic_workload(seed=11, n_requests=8, rate_rps=1000.0,
                            vocab_size=CFG.vocab_size, prompt_lens=(4, 8),
                            max_news=(4, 6), temperatures=(0.0,))
    rep = run_serving(model, CFG, tiny, wl, num_slots=4, prefill_chunk=4,
                      device="cpu")
    assert rep.aggregates["completed"] == len(wl)
    assert rep.peak_blocks_in_use <= rep.pool_blocks == 6
    assert any(rep.records[r.rid].queue_wait_s > 0 for r in wl)


def test_workload_and_served_greedy_streams_match_jax(pair):
    """The same seed gives both packages the same requests, and each greedy
    served stream is the JAX package's generate() token for token."""
    jcfg, jp, model = pair
    kw = dict(seed=5, n_requests=6, rate_rps=300.0, vocab_size=128,
              prompt_lens=(3, 7, 11), max_news=(4, 9), temperatures=(0.0,))
    wl = synthetic_workload(**kw)
    assert [(r.prompt, r.max_new, r.seed, r.arrival) for r in wl] == [
        (r.prompt, r.max_new, r.seed, r.arrival) for r in jax_workload(**kw)]
    rep = run_serving(model, CFG, PAGED, wl, num_slots=3, prefill_chunk=4,
                      device="cpu")
    for r in wl:
        want = np.asarray(jgen.generate(jp, jnp.asarray([r.prompt]), jcfg,
                                        r.max_new,
                                        max_len=PAGED.max_seq_len))[0]
        assert rep.records[r.rid].tokens == want.tolist(), r.rid


def test_events_are_valid_for_the_jax_readers(pair, tmp_path):
    """The port's request_* and span events follow the reference schema:
    the JAX package's validator accepts them and every request's trace
    tree is complete."""
    _, _, model = pair
    wl = synthetic_workload(seed=1, n_requests=4, rate_rps=500.0,
                            vocab_size=CFG.vocab_size, prompt_lens=(3, 6),
                            max_news=(3, 4), temperatures=(0.0,))
    path = str(tmp_path / "events.jsonl")
    with EventLog(path) as log:
        run_serving(model, CFG, PAGED, wl, num_slots=2, prefill_chunk=4,
                    events=log, device="cpu")
    events = read_events(path, strict=True)
    assert all(validate_event(e) == [] for e in events)
    kinds = {e["type"] for e in events}
    assert {"request_enqueue", "request_prefill", "request_token",
            "request_done", "span"} <= kinds
    trees = trace_trees(events)
    assert set(trees) == {r.rid for r in wl}
    for tree in trees.values():
        assert tree_check(tree) == {"roots": 1, "orphans": 0,
                                    "imbalanced": 0}
