"""The port's resilience layer (``resilience/``: fault plans, the step
guard, preemption; the trainer's and the FL servers' wiring) against the
JAX package's, on the CPU at a small size (2 layers, dmodel 32, the byte
tokenizer's vocab 259).

Tolerances: fault plans choose the same steps, clients and victims
exactly (numpy draws on both sides); a guarded fault-free run is bitwise
an unguarded one; a rollback restores the checkpoint bitwise; a resumed
run's losses are within 1e-6 of an uninterrupted one's; the trainer with
the whole layer on is within 1e-5 of the JAX trainer's losses (the
frameworks sum products in different orders); FL survivor re-weighting is
within 1e-6 of the round run over the surviving subset directly."""

import os

import jax
import numpy as np
import pytest
import torch

from ddl25spring_tpu.config import LlamaConfig as JaxLlamaConfig
from ddl25spring_tpu.config import ResilienceConfig as JaxResilienceConfig
from ddl25spring_tpu.config import TrainConfig as JaxTrainConfig
from ddl25spring_tpu.models import llama as jllama
from ddl25spring_tpu.resilience import faults as jfaults
from ddl25spring_tpu.telemetry import Telemetry as JaxTelemetry
from ddl25spring_tpu.tokenizers import ByteTokenizer as JaxByteTokenizer
from ddl25spring_tpu.train import llm as jllm
from ddl25spring_tpu_torch import fl
from ddl25spring_tpu_torch.checkpoint import Checkpointer
from ddl25spring_tpu_torch.config import (FLConfig, LlamaConfig,
                                          ResilienceConfig, TrainConfig)
from ddl25spring_tpu_torch.convert import params_from_jax
from ddl25spring_tpu_torch.data import mnist
from ddl25spring_tpu_torch.metrics import ResilienceStats
from ddl25spring_tpu_torch.models import llama, mnist_cnn
from ddl25spring_tpu_torch.ops.adam import fused_adam
from ddl25spring_tpu_torch.parallel import dp
from ddl25spring_tpu_torch.resilience import (FaultPlan, PreemptionHandler,
                                              ReplicaLossError,
                                              ReplicaReturnSignal, StepGuard,
                                              corrupt_latest_checkpoint,
                                              faults, measure_overhead,
                                              parse_spec)
from ddl25spring_tpu_torch.telemetry import Telemetry, read_events
from ddl25spring_tpu_torch.tokenizers import ByteTokenizer
from ddl25spring_tpu_torch.train import llm
from ddl25spring_tpu_torch.tree import tree_leaves

torch.set_num_threads(1)

MCFG = dict(dmodel=32, num_heads=2, n_layers=2, ctx_size=16)
CFG = LlamaConfig(**MCFG)
TCFG = dict(batch_size=2, seq_len=16)
SPECS = ["nan_grad@10", "nan_grad@10:3,spike_grad@5:100",
         " preempt@25 , drop_client@3:2,delay_client@1:1",
         "device_loss@4:2,device_return@6,inf_grad@2"]


def _train(iters, **kw):
    kw.setdefault("log_every", 0)
    return llm.train_llm_dp(CFG, TrainConfig(iters=iters, **TCFG),
                            tokenizer=ByteTokenizer(), device="cpu", **kw)


def _params(ckpt_dir, step):
    """The parameters of the checkpoint at ``step``, as numpy leaves."""
    model = llama.init_llama(CFG.replace(vocab_size=259),
                             torch.Generator().manual_seed(0), device="cpu")
    state = dp.init_state(model.tree(), fused_adam(8e-4))
    state = Checkpointer(ckpt_dir).restore(state, step=step)
    return [x.detach().numpy().copy() for x in tree_leaves(state.params)]


# ------------------------------------------------------------ fault plans

@pytest.mark.parametrize("spec", SPECS)
def test_parse_spec_matches_jax(spec):
    got = [(e.kind, e.step, e.arg) for e in parse_spec(spec)]
    want = [(e.kind, e.step, e.arg) for e in jfaults.parse_spec(spec)]
    assert got == want and got


@pytest.mark.parametrize("spec,seed", [
    ("drop_client@1:2,delay_client@1:1", 4),
    ("drop_client@0:3", 0), ("delay_client@2:2,drop_client@2", 7),
    ("drop_client@0:20", 1)])
def test_surviving_clients_match_jax(spec, seed):
    sampled = np.array([3, 17, 5, 42, 8, 11])
    for r in range(3):
        got = FaultPlan.from_spec(spec, seed=seed).surviving_clients(
            r, sampled)
        want = jfaults.FaultPlan.from_spec(spec, seed=seed) \
            .surviving_clients(r, sampled)
        assert np.array_equal(got[0], want[0]) and got[1:] == want[1:]


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_victims_and_arrivals_match_jax(seed):
    for step, count, n in ((4, 1, 4), (7, 2, 8), (2, 5, 3)):
        assert (ReplicaLossError(step, count, seed).victims(n)
                == jfaults.ReplicaLossError(step, count, seed).victims(n))
        lost = [1, 5, 6]
        assert (ReplicaReturnSignal(step, count, seed).arrivals(lost)
                == jfaults.ReplicaReturnSignal(step, count,
                                               seed).arrivals(lost))
    assert faults._VICTIM_SALT == jfaults._VICTIM_SALT


def test_device_faults_raise_before_the_step():
    calls = []
    wrapped = FaultPlan.from_spec("device_loss@1,device_return@2").wrap_step(
        lambda s, b: (calls.append(1) or s, torch.zeros(())))
    wrapped(None, None)
    with pytest.raises(ReplicaLossError):
        wrapped(None, None)
    with pytest.raises(ReplicaReturnSignal):
        wrapped(None, None)
    assert len(calls) == 1


# ------------------------------------------------------------- the guard

def test_guarded_fault_free_run_is_bitwise_unguarded():
    plain = _train(6)
    guarded = _train(6, resilience=ResilienceConfig())
    assert guarded.losses == plain.losses
    assert guarded.resilience.as_dict() == ResilienceStats().as_dict()


def test_nan_steps_are_skipped_and_the_spike_is_caught():
    plan = FaultPlan.from_spec("nan_grad@3,nan_grad@5:4,spike_grad@9:100")
    rep = _train(11, resilience=ResilienceConfig(ema_warmup=3),
                 fault_plan=plan)
    assert rep.resilience.skipped_steps == 2
    assert rep.resilience.anomalies == 1
    assert rep.resilience.rollbacks == 0
    bad = {3, 5, 9}
    assert all(np.isfinite(v) for i, v in enumerate(rep.losses)
               if i not in bad)
    assert not np.isfinite(rep.losses[3]) and not np.isfinite(rep.losses[5])


def _guarded_step(plan, **kw):
    model = llama.init_llama(CFG.replace(vocab_size=64),
                             torch.Generator().manual_seed(0), device="cpu")
    opt = fused_adam(8e-4)
    step = dp.make_grad_aggregation_step(
        lambda p, b: llama.forward_loss(p, b, CFG.replace(vocab_size=64)),
        opt)
    guard = StepGuard(plan.wrap_step(step), **kw)
    return model, dp.init_state(model.tree(), opt), guard


def test_a_skip_restores_the_live_tensors():
    """The step updates the model's own tensors in place and the fault
    poisons them; after the skip the tensors the caller holds are their
    pre-step values (a guard that returned its clone instead would leave
    the NaNs in the model)."""
    model, state, guard = _guarded_step(FaultPlan.from_spec("nan_grad@1"))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 64,
                                                                (2, 16)))
    state, _ = guard(state, tokens)
    before = [p.detach().clone() for p in model.parameters()]
    mu_before = [m.clone() for m in tree_leaves(state.opt_state.mu)]
    state, loss = guard(state, tokens)
    assert not torch.isfinite(loss) and guard.stats.skipped_steps == 1
    for p, q in zip(model.parameters(), before):
        assert torch.equal(p.detach(), q)
    assert all(p is q for p, q in zip(tree_leaves(state.params),
                                      tree_leaves(model.tree())))
    for m, q in zip(tree_leaves(state.opt_state.mu), mu_before):
        assert torch.equal(m, q)
    trip = guard.pop_trip()
    assert trip["loss_nonfinite"] and len(trip["nonfinite_params"]) == 9
    state, loss = guard(state, tokens)
    assert torch.isfinite(loss)
    assert all(bool(torch.isfinite(p).all()) for p in model.parameters())


def test_rollback_after_k_bad_steps_restores_the_checkpoint(tmp_path):
    ck = str(tmp_path / "ck")
    rep = _train(9, resilience=ResilienceConfig(),
                 fault_plan=FaultPlan.from_spec(
                     "nan_grad@6,nan_grad@7,nan_grad@8"),
                 checkpoint_dir=ck, checkpoint_every=5)
    assert rep.resilience.skipped_steps == 3
    assert rep.resilience.rollbacks == 1
    # The final save (step 9) holds the rolled-back weights: step 5's.
    for a, b in zip(_params(ck, 9), _params(ck, 5)):
        assert np.array_equal(a, b)


def test_preempted_run_resumes_to_the_uninterrupted_losses(tmp_path):
    ck = str(tmp_path / "ck")
    full = _train(8)
    first = _train(8, fault_plan=FaultPlan.from_spec("preempt@4"),
                   checkpoint_dir=ck, checkpoint_every=100)
    assert first.preempted and first.resilience.preemptions == 1
    assert first.steps == len(first.losses) < 8
    second = _train(8, checkpoint_dir=ck, checkpoint_every=100)
    assert not second.preempted and second.start_step == len(first.losses)
    np.testing.assert_allclose(first.losses + second.losses, full.losses,
                               rtol=0, atol=1e-6)


def test_preemption_handler_sets_its_flag_and_restores_the_handler():
    import signal
    prev = signal.getsignal(signal.SIGTERM)
    with PreemptionHandler() as pre:
        assert not pre.requested
        os.kill(os.getpid(), signal.SIGTERM)
        assert pre.requested
    assert signal.getsignal(signal.SIGTERM) == prev


def test_a_corrupt_latest_checkpoint_falls_back(tmp_path):
    ck = str(tmp_path / "ck")
    _train(4, checkpoint_dir=ck, checkpoint_every=2)
    path = corrupt_latest_checkpoint(ck)
    assert path.endswith("4.pt")
    rep = _train(6, checkpoint_dir=ck, checkpoint_every=2)
    assert rep.start_step == 2 and rep.resilience.ckpt_fallbacks == 1


def test_injit_guard_skips_and_excludes_the_host_guard():
    rep = _train(5, resilience=ResilienceConfig(guard=False,
                                                injit_guard=True),
                 fault_plan=FaultPlan.from_spec("nan_grad@2"))
    # The fault poisons the state after the step, so the in-step guard
    # sees the poisoned parameters' loss on the next step and skips it.
    assert rep.resilience.skipped_steps >= 1
    with pytest.raises(ValueError, match="mutually exclusive"):
        _train(2, resilience=ResilienceConfig(injit_guard=True))


@pytest.mark.parametrize("kw", [
    dict(resilience=ResilienceConfig(elastic=True)),
    dict(scale_hook=lambda it, world: None)])
def test_elastic_mode_and_scale_hook_name_item_8(kw):
    # Item 8e-1 runs elastic mode: at a world of one, fault-free, it is
    # the plain run; a scale_hook still needs it (the JAX trainer's
    # error, held against JAX in tests/test_torch_elastic.py).
    if "scale_hook" in kw:
        with pytest.raises(ValueError, match="scale_hook requires "
                                             "resilience.elastic=True"):
            _train(2, **kw)
        return
    got = _train(2, **kw)
    assert got.losses == _train(2).losses and got.remeshes == []


def test_measure_overhead_is_fault_free_on_the_cpu():
    cfg = CFG.replace(vocab_size=64)

    def make():
        model = llama.init_llama(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
        opt = fused_adam(8e-4)
        return dp.init_state(model.tree(), opt), \
            dp.make_grad_aggregation_step(
                lambda p, b: llama.forward_loss(p, b, cfg), opt)

    times = {}
    pct, stats = measure_overhead(make, torch.zeros((2, 16),
                                                    dtype=torch.long),
                                  steps=2, warmup=1, device="cpu",
                                  report=times)
    assert stats.as_dict() == ResilienceStats().as_dict()
    assert np.isfinite(pct) and times["guarded_ms_per_step"] > 0
    # Timed in turns (raw, guarded, guarded, raw), each side the mean of two.
    turns = times["turns_ms_per_step"]
    assert len(turns) == 4
    assert times["raw_ms_per_step"] == pytest.approx(
        (turns[0] + turns[3]) / 2)
    assert times["guarded_ms_per_step"] == pytest.approx(
        (turns[1] + turns[2]) / 2)


# ------------------------------------------------- against the JAX trainer

def test_trainer_with_the_whole_layer_matches_jax(monkeypatch, tmp_path):
    """Both trainers from the same weights with a guard, telemetry,
    numerics every 2 steps and a preemption at step 3: the same losses,
    the same counters, and both report the preemption."""
    tcfg = dict(**TCFG, iters=6, numerics_every=2)
    tree = jax.tree.map(np.asarray, jllama.init_llama(
        jax.random.PRNGKey(0), JaxLlamaConfig(**MCFG, vocab_size=259)))
    jtel = JaxTelemetry(str(tmp_path / "jax"))
    jrep = jllm.train_llm_dp(
        JaxLlamaConfig(**MCFG), JaxTrainConfig(**tcfg),
        tokenizer=JaxByteTokenizer(), log_every=0,
        resilience=JaxResilienceConfig(),
        fault_plan=jfaults.FaultPlan.from_spec("preempt@3"), telemetry=jtel)
    jtel.close()
    monkeypatch.setattr(llm.llama, "init_llama",
                        lambda cfg, gen, device=None:
                        params_from_jax(tree, cfg, device))
    tel = Telemetry(str(tmp_path / "port"))
    rep = llm.train_llm_dp(
        LlamaConfig(**MCFG), TrainConfig(**tcfg), tokenizer=ByteTokenizer(),
        log_every=0, resilience=ResilienceConfig(),
        fault_plan=FaultPlan.from_spec("preempt@3"), telemetry=tel,
        device="cpu")
    tel.close()
    assert rep.preempted and jrep.preempted
    assert len(rep.losses) == len(jrep.losses) == rep.steps
    np.testing.assert_allclose(rep.losses, jrep.losses, rtol=0, atol=1e-5)
    assert rep.resilience.as_dict() == jrep.resilience.as_dict()
    events = read_events(os.path.join(str(tmp_path / "port"),
                                      "events.jsonl"))
    assert [e["it"] for e in events if e["type"] == "numerics"] == [0, 2]
    assert events[-1]["type"] == "run_end" and events[-1]["preempted"]


# ------------------------------------------------------------- FL servers

FL = dict(nr_clients=10, client_fraction=0.5, batch_size=20, epochs=1,
          lr=0.05, rounds=2, seed=3)


@pytest.fixture(scope="module")
def fl_setup():
    x, y, xt, yt = mnist.load_mnist(n_train=400, n_test=100, seed=0)
    x, xt = mnist.normalize(x), mnist.normalize(xt)
    subsets = mnist.split(y, FL["nr_clients"], iid=True, seed=FL["seed"])
    data = fl.federate(x, y, subsets, device="cpu")
    params = mnist_cnn.init(torch.Generator().manual_seed(0), device="cpu")
    return params, data, xt, yt


def _server(s, **kw):
    params, data, xt, yt = s
    return fl.FedAvgServer(params, lambda p, x: mnist_cnn.apply(p, x), data,
                           xt, yt, FLConfig(**FL), device="cpu", **kw)


def test_fl_survivor_reweighting_equals_the_direct_subset(fl_setup):
    plan = FaultPlan.from_spec("drop_client@0:2,delay_client@1:1", seed=5)
    faulted = _server(fl_setup, fault_plan=plan)
    direct = _server(fl_setup)
    kept = {}
    for r in range(2):
        idx = direct._sample(r)
        mask, _, _ = plan.surviving_clients(r, idx)
        kept[r] = idx[mask]
    direct._sample = lambda r: kept[r]
    faulted.run()
    direct.run()
    assert faulted.resilience.dropped_clients == 2
    assert faulted.resilience.straggler_clients == 1
    for a, b in zip(tree_leaves(faulted.params), tree_leaves(direct.params)):
        assert float((a - b).abs().max()) <= 1e-6



_PRIVATE_SERVERS = {
    "dp": lambda: (fl.DPFedAvgServer, dict(clip_norm=1.0,
                                           noise_multiplier=0.5)),
    "secagg": lambda: (fl.SecureAggFedAvgServer, dict(clip_norm=5.0)),
}


@pytest.mark.parametrize("kind", sorted(_PRIVATE_SERVERS))
def test_fl_private_servers_reweight_over_survivors(fl_setup, kind):
    """DP-FedAvg and secure aggregation take the fault plan too: a round
    equals the round over the surviving subset (DP's σ and the masks are
    those of that subset), and a round that loses every client is
    skipped with the parameters untouched."""
    cls, kw = _PRIVATE_SERVERS[kind]()
    params, data, xt, yt = fl_setup

    def make(**extra):
        return cls(params, lambda p, x: mnist_cnn.apply(p, x), data, xt, yt,
                   FLConfig(**FL), device="cpu", **kw, **extra)

    plan = FaultPlan.from_spec("drop_client@0:2,delay_client@1:1", seed=5)
    faulted, direct = make(fault_plan=plan), make()
    kept = {}
    for r in range(2):
        idx = direct._sample(r)
        mask, _, _ = plan.surviving_clients(r, idx)
        kept[r] = idx[mask]
    direct._sample = lambda r: kept[r]
    faulted.run()
    direct.run()
    assert faulted.resilience.dropped_clients == 2
    assert faulted.resilience.straggler_clients == 1
    for a, b in zip(tree_leaves(faulted.params), tree_leaves(direct.params)):
        assert float((a - b).abs().max()) <= 1e-6

    lost = make(fault_plan=FaultPlan.from_spec("drop_client@0:20"))
    before = [x.clone() for x in tree_leaves(lost.params)]
    lost.run(1)
    assert lost.resilience.skipped_rounds == 1
    assert all(torch.equal(a, b)
               for a, b in zip(tree_leaves(lost.params), before))

def test_fl_round_losing_every_client_is_skipped(fl_setup, tmp_path):
    tel = Telemetry(str(tmp_path))
    server = _server(fl_setup, fault_plan=FaultPlan.from_spec(
        "drop_client@0:20"), telemetry=tel)
    before = [x.clone() for x in tree_leaves(server.params)]
    server.run(1)
    tel.close()
    assert server.resilience.skipped_rounds == 1
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(server.params),
                                                 before))
    events = read_events(os.path.join(str(tmp_path), "events.jsonl"))
    rounds = [e for e in events if e["type"] == "fl_round"]
    assert len(rounds) == 1 and rounds[0]["faults"] == {
        "dropped_clients": 5, "skipped_rounds": 1}
