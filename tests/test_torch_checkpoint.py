"""The port's checkpoints (``checkpoint.py``) and what they stand on
(``resilience/retry.py``, ``metrics.ResilienceStats``), held to the JAX
package's contract: a save and restore round trip is bitwise; a corrupt
newest step falls back to the one before it; a ZeRO-1 state saved at a
world of 2 restores at 1 and at 3 with its moments bitwise the saved ones;
``train_llm_dp`` resumed from a checkpoint gives an uninterrupted run's
losses bitwise. The retry schedule and the counters are the JAX package's,
float for float and field for field. Multi-rank runs are processes on the
CPU joined by gloo (``distributed.run_ranks``)."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from ddl25spring_tpu import metrics as jmetrics
from ddl25spring_tpu.config import LlamaConfig as JaxLlamaConfig
from ddl25spring_tpu.models import llama as jllama
from ddl25spring_tpu.resilience import retry as jretry
from ddl25spring_tpu_torch import checkpoint, metrics
from ddl25spring_tpu_torch.bench_utils import make_optimizer
from ddl25spring_tpu_torch.config import LlamaConfig
from ddl25spring_tpu_torch.models import llama
from ddl25spring_tpu_torch.parallel import distributed, dp, programs
from ddl25spring_tpu_torch.resilience import retry
from ddl25spring_tpu_torch.tree import nested_leaves

torch.set_num_threads(1)

SMALL = dict(vocab_size=64, dmodel=32, num_heads=2, n_layers=2, ctx_size=16)
TREE = jax.tree.map(np.asarray, jllama.init_llama(
    jax.random.PRNGKey(0), JaxLlamaConfig(**SMALL)))
BATCHES = np.random.default_rng(1).integers(0, 64, (2, 4, 16))
TRAIN_M = dict(dmodel=32, num_heads=2, n_layers=2, ctx_size=16)
TRAIN_T = dict(batch_size=2, seq_len=16, data=2)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """One launch of two ranks: a ZeRO-1 state saved after two steps, and
    train_llm_dp for 6 iterations uninterrupted, then for 3 and resumed to
    6 on one checkpoint directory."""
    root = tmp_path_factory.mktemp("ckpt")
    zdir, tdir = str(root / "zero1"), str(root / "trainer")
    calls = [(TRAIN_M, dict(TRAIN_T, iters=6), {}),
             (TRAIN_M, dict(TRAIN_T, iters=3),
              dict(checkpoint_dir=tdir, checkpoint_every=3)),
             (TRAIN_M, dict(TRAIN_T, iters=6),
              dict(checkpoint_dir=tdir, checkpoint_every=3))]
    ranks = distributed.run_ranks(
        programs.sequence, 2, [("zero1_save", (zdir, SMALL, TREE, BATCHES)),
                               ("trainer_calls", (calls,))], device="cpu")
    return {"zero1_dir": zdir, "zero1": [r[0] for r in ranks],
            "trainer": [r[1] for r in ranks]}


def _state(optimizer="fused", dtype="float32"):
    """A world-of-one train state after one step on the CPU."""
    cfg = LlamaConfig(**SMALL, param_dtype=dtype, dtype=dtype)
    model = llama.init_llama(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    opt = make_optimizer(optimizer)
    step = dp.make_grad_aggregation_step(
        lambda p, b: llama.forward_loss(p, b, cfg), opt)
    state = dp.init_state(model.tree(), opt)
    state, _ = step(state, torch.as_tensor(BATCHES[0], dtype=torch.long))
    return state


def _fresh(optimizer="fused", dtype="float32"):
    cfg = LlamaConfig(**SMALL, param_dtype=dtype, dtype=dtype)
    model = llama.init_llama(cfg, torch.Generator().manual_seed(5),
                             device="cpu")
    return dp.init_state(model.tree(), make_optimizer(optimizer))


def _bitwise(a, b):
    la, lb = nested_leaves(a), nested_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert torch.equal(x.view(torch.uint8) if x.dim() else x,
                               y.view(torch.uint8) if y.dim() else y)
        else:
            assert x == y


@pytest.mark.parametrize("optimizer,dtype", [("fused", "float32"),
                                             ("master", "bfloat16")])
def test_round_trip_is_bitwise(tmp_path, optimizer, dtype):
    state = _state(optimizer, dtype)
    with checkpoint.Checkpointer(str(tmp_path)) as ckpt:
        assert ckpt.save(1, state) and ckpt.latest_step() == 1
        back = ckpt.restore(_fresh(optimizer, dtype))
    assert ckpt.restored_step == 1 and ckpt.stats.ckpt_reshards == 0
    _bitwise(back, state)
    for p in nested_leaves(back.params):
        assert p.requires_grad


def test_manifest_records_digest_and_leaves(tmp_path):
    ckpt = checkpoint.Checkpointer(str(tmp_path))
    state = _state()
    ckpt.save(7, state)
    with open(tmp_path / "digests" / "7.json") as f:
        manifest = json.load(f)
    assert manifest["step"] == 7 and set(manifest["files"]) == {"7.pt"}
    assert manifest["files"]["7.pt"] == checkpoint._sha256_file(
        str(tmp_path / "7.pt"))
    assert manifest["leaves"] == [
        {"shape": list(x.shape), "dtype": str(x.dtype)}
        if isinstance(x, torch.Tensor) else None
        for x in nested_leaves(state)]


def test_corrupt_newest_step_falls_back_to_the_previous(tmp_path):
    state = _state()
    ckpt = checkpoint.Checkpointer(str(tmp_path))
    ckpt.save(1, state)
    ckpt.save(2, _fresh())
    with open(tmp_path / "2.pt", "r+b") as f:    # flip one byte
        f.seek(os.path.getsize(tmp_path / "2.pt") // 2)
        byte = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([byte[0] ^ 0xFF]))
    back = ckpt.restore(_fresh())
    assert ckpt.restored_step == 1 and ckpt.stats.ckpt_fallbacks == 1
    _bitwise(back, state)
    with pytest.raises(ValueError, match="integrity"):
        ckpt.restore(_fresh(), step=2)        # a named step does not fall back


def test_save_refuses_an_existing_step_and_keeps_max_to_keep(tmp_path):
    ckpt = checkpoint.Checkpointer(str(tmp_path), max_to_keep=2)
    state = _state()
    for s in (1, 2, 3):
        ckpt.save(s, state)
    assert ckpt.all_steps() == [2, 3]
    assert sorted(os.listdir(tmp_path / "digests")) == ["2.json", "3.json"]
    with pytest.raises(ValueError, match="already exists"):
        ckpt.save(3, state)
    ckpt.save(3, state, overwrite=True)
    with pytest.raises(FileNotFoundError):
        checkpoint.Checkpointer(str(tmp_path / "empty")).restore(state)


def test_save_retries_a_failing_write(tmp_path, monkeypatch):
    real, calls = torch.save, []

    def flaky(obj, f):
        calls.append(1)
        if len(calls) == 1:
            raise OSError("disk full")
        real(obj, f)

    monkeypatch.setattr(checkpoint.torch, "save", flaky)
    ckpt = checkpoint.Checkpointer(str(tmp_path), retry_base_delay=0.0)
    ckpt.save(1, _state())
    assert ckpt.stats.retries == 1 and len(calls) == 2
    _bitwise(ckpt.restore(_fresh()), _state())


@pytest.mark.parametrize("world", [1, 3])
def test_zero1_saved_at_world2_restores_at_another_world(world2, world):
    saved = world2["zero1"]
    args = (world2["zero1_dir"], SMALL, TREE)
    if world == 1:
        ranks = [programs.zero1_restore(*args, device="cpu")]
    else:
        ranks = distributed.run_ranks(programs.zero1_restore, world, *args,
                                      device="cpu")
    total = sum(x.size for x in jax.tree.leaves(TREE))
    # Padded to a multiple of 3, the vector grows; at 1 and 2 it has no
    # pad (37,024 parameters), so world 1 restores it as saved.
    resized = world * ranks[0]["local"] != 2 * len(saved[0]["mu"])
    assert resized == (world == 3)
    for field in ("mu", "nu"):
        before = np.concatenate([r[field] for r in saved])
        after = np.concatenate([r[field] for r in ranks])
        assert after.shape == (world * ranks[0]["local"],)
        assert after[:total].tobytes() == before[:total].tobytes()
        assert not after[total:].any() and not before[total:].any()
    for r in ranks:
        assert r["restored_step"] == 2 and r["step"] == saved[0]["step"] == 2
        assert r["count"] == 2
        assert r["stats"]["ckpt_reshards"] == int(resized)
        for a, b in zip(jax.tree.leaves(r["params"]),
                        jax.tree.leaves(saved[0]["params"])):
            np.testing.assert_array_equal(a, b)


def test_zero1_restores_at_its_own_world_without_reshard(world2):
    ranks = distributed.run_ranks(programs.zero1_restore, 2,
                                  world2["zero1_dir"], SMALL, TREE,
                                  device="cpu")
    for got, want in zip(ranks, world2["zero1"]):
        assert got["stats"]["ckpt_reshards"] == 0
        assert got["mu"].tobytes() == want["mu"].tobytes()


def test_train_llm_dp_resume_matches_an_uninterrupted_run(world2):
    for full, first, second in world2["trainer"]:
        assert first["steps"] == 3 and second["start_step"] == 3
        assert second["steps"] == 3
        assert first["losses"] + second["losses"] == full["losses"]


def test_save_best_and_load_best_round_trip(tmp_path):
    state = _state("master", "bfloat16")
    path = str(tmp_path / "best.npz")
    checkpoint.save_best(path, state.params)
    back = checkpoint.load_best(path, _fresh("master", "bfloat16").params)
    _bitwise(back, state.params)


# ---------------------------------------------------------- retry, counters

def test_backoff_schedule_is_the_jax_packages():
    for kw in (dict(), dict(base=0.5, max_delay=1.0, jitter=0.5, seed=3)):
        assert retry.backoff_schedule(6, **kw) == \
            jretry.backoff_schedule(6, **kw)


def test_retry_call_retries_then_raises_and_counts():
    slept, seen = [], []

    def flaky(box):
        box.append(1)
        if len(box) < 3:
            raise OSError("transient")
        return len(box)

    box = []
    assert retry.retry_call(flaky, box, attempts=3, sleep=slept.append,
                            on_retry=lambda i, e: seen.append(i)) == 3
    assert seen == [0, 1] and slept == retry.backoff_schedule(2)
    with pytest.raises(OSError):
        retry.retry_call(flaky, [], attempts=2, sleep=slept.append)
    with pytest.raises(KeyError):       # not retried: not in retry_on
        retry.retry_call(lambda: {}["x"], retry_on=(OSError,),
                         sleep=slept.append)
    wrapped = retry.with_retry(3, sleep=slept.append)(flaky)
    assert wrapped([]) == 3


def test_resilience_stats_has_the_jax_fields():
    names = [f.name for f in dataclasses.fields(metrics.ResilienceStats)]
    assert names == [f.name for f in
                     dataclasses.fields(jmetrics.ResilienceStats)]
    a = metrics.ResilienceStats(retries=2)
    snap = a.as_dict()
    a.merge(metrics.ResilienceStats(retries=1, ckpt_fallbacks=1))
    assert a.delta(snap) == {"retries": 1, "ckpt_fallbacks": 1}
    assert a.total_faults_handled == 4
