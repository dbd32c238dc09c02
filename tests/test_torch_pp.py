"""The port's pipeline steps (``parallel/pp.py``) against the JAX package's
``make_pipeline_step`` on the CPU mesh (``tests/conftest.py`` gives 8
virtual CPU devices), at ``tests/test_pp.py``'s sizes (vocab 64, dmodel 16,
2 heads, ctx 8; 4 layers at 2 stages, 6 at 3).

The port's stages are processes on the CPU joined by gloo
(``distributed.run_ranks``), one launch per topology for the module
(``programs.pp_cases``): 2 stages, 3 stages, and 2 data rows × 2 stages.
For each schedule (GPipe, 1F1B, interleaved at two chunks) and
microbatch count M ∈ {1, S, 2S} the schedule allows:

- loss within 1e-5, and every gradient leaf within 1e-4 of that leaf's
  largest entry; a gradient is a step's SGD update divided by −lr, at
  lr 1024, where the update stands far above the parameters' rounding;
- 1F1B against GPipe in the port within 1e-6 of each leaf's largest
  entry (they sum the microbatches' gradients in different orders);
- the K-step driver at K = 4 bitwise four per-step calls (fused Adam);
- the stage-stacked numerics' groups equal to JAX's ``make_pp_numerics``
  and their values within 1e-5 relative;
- per-label communication bytes against the relation between the JAX
  program's static profile and what the stages send (``_want_comm``).

The layout guard runs at a world of one."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddl25spring_tpu.config import LlamaConfig as JaxLlamaConfig
from ddl25spring_tpu.models import llama as jllama
from ddl25spring_tpu.parallel import make_mesh
from ddl25spring_tpu.parallel import pp as jpp
from ddl25spring_tpu.telemetry.comm import measure_comm as jmeasure_comm
from ddl25spring_tpu_torch.config import LlamaConfig
from ddl25spring_tpu_torch.convert import params_from_jax
from ddl25spring_tpu_torch.models import llama
from ddl25spring_tpu_torch.ops.adam import fused_adam
from ddl25spring_tpu_torch.parallel import distributed, pp, programs

torch.set_num_threads(1)

LR = 1024.0
ADAM_LR = 8e-4
V = 2                                  # chunks per stage, interleaved
CFG = {2: dict(vocab_size=64, dmodel=16, num_heads=2, n_layers=4,
               ctx_size=8),
       3: dict(vocab_size=64, dmodel=16, num_heads=2, n_layers=6,
               ctx_size=8)}
B, T = {2: 4, 3: 6}, 8                 # batch per data row, sequence
TOPOLOGIES = {"s2": (1, 2), "s3": (1, 3), "d2s2": (2, 2)}


def _schedules(s):
    """(schedule, M) pairs at S stages: M ∈ {1, S, 2S}, interleaved only
    where S divides M."""
    return [(name, m) for name in ("gpipe", "1f1b", "interleaved")
            for m in (1, s, 2 * s) if name != "interleaved" or m % s == 0]


def _tree(s):
    return jax.tree.map(np.asarray, jllama.init_llama(
        jax.random.PRNGKey(s), JaxLlamaConfig(**CFG[s])))


def _batches(topo, n, seed):
    d, s = TOPOLOGIES[topo]
    return np.random.default_rng(seed).integers(
        0, CFG[s]["vocab_size"], (n, d * B[s], T))


@functools.lru_cache(maxsize=None)
def _cases(topo):
    """Every case of one topology's launch, by name."""
    d, s = TOPOLOGIES[topo]
    base = dict(cfg=CFG[s], params=_tree(s), data=d, stage=s)
    cases = {(name, m): dict(base, schedule=name, microbatches=m,
                             batches=_batches(topo, 1, 1))
             for name, m in (_schedules(s) if d == 1 else
                             [("gpipe", 2), ("1f1b", 2), ("interleaved", 2)])}
    cases[("gpipe", s, "numerics")] = dict(
        base, schedule="gpipe", microbatches=s, numerics=True,
        batches=_batches(topo, 1, 1))
    if topo == "s2":
        steps = _batches(topo, 4, 2)
        for name in ("gpipe", "1f1b", "interleaved"):
            k = dict(base, schedule=name, microbatches=2, optimizer="fused",
                     lr=ADAM_LR)
            cases[(name, "per_step")] = dict(k, batches=steps)
            cases[(name, "window")] = dict(k, batches=steps[None],
                                           window=True)
    return cases


_LAUNCHED = {}


def _results(topo):
    """One launch per topology, made on first use: ``{case key: every
    rank's result}``."""
    if topo not in _LAUNCHED:
        d, s = TOPOLOGIES[topo]
        cases = _cases(topo)
        ranks = distributed.run_ranks(programs.pp_cases, d * s,
                                      list(cases.values()), device="cpu",
                                      timeout=600)
        _LAUNCHED[topo] = {key: [r[i] for r in ranks]
                           for i, key in enumerate(cases)}
    return _LAUNCHED[topo]


def _step_keys(topo):
    return [k for k in _cases(topo) if len(k) == 2 and isinstance(k[1], int)]


STEP_CASES = [(topo, key) for topo in TOPOLOGIES for key in _step_keys(topo)]


def _merged(ranks, s):
    """Data row 0's stages joined into the whole tree (numpy), the JAX
    layout: ``merge_stages`` and the layout tag from stage 0."""
    locs = [r["params"] for r in ranks if r["d"] == 0]
    out = {"embed": locs[0]["embed"], "final_norm": locs[-1]["final_norm"],
           "lm_head": locs[-1]["lm_head"],
           "blocks": jax.tree.map(lambda *xs: np.concatenate(xs, 0),
                                  *[x["blocks"] for x in locs])}
    if "blocks_layout" in locs[0]:
        out["blocks_layout"] = locs[0]["blocks_layout"]
    assert [r["s"] for r in ranks if r["d"] == 0] == list(range(s))
    return out


@functools.lru_cache(maxsize=None)
def _jax_step(topo, key, numerics=False):
    """The JAX pipeline step (SGD at ``LR``) from the case's parameters
    over its first batch: ``(params before, state after, loss, (numerics
    handle, summary), step, tokens)``."""
    case, optimizer = _cases(topo)[key], optax.sgd(LR)
    d, s = TOPOLOGIES[topo]
    mesh = make_mesh({"data": d, "stage": s}, devices=jax.devices()[:d * s])
    jcfg = JaxLlamaConfig(**CFG[s])
    params = jax.tree.map(jnp.asarray, case["params"])
    if case["schedule"] == "interleaved":
        params = jpp.interleave_params(params, s, V)
    handle = jpp.make_pp_numerics(params, mesh) if numerics else None
    before = jax.tree.map(np.asarray, params)
    state = jpp.init_state(mesh, params, optimizer)
    step = jpp.make_pipeline_step(jcfg, optimizer, mesh,
                                  case["microbatches"], case["schedule"],
                                  n_chunks=V, numerics=handle)
    tokens = jpp.shard_batch(mesh, jnp.asarray(case["batches"][0]))
    state, out = step(state, tokens)
    loss, summary = out if numerics else (out, None)
    return before, state, float(loss), (handle, summary), step, tokens


def _grads(before, after):
    return jax.tree.map(lambda a, b: (np.asarray(a, np.float64)
                                      - np.asarray(b, np.float64)) / LR,
                        before, after)


def _hold(got, want, rel):
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        scale = np.abs(w).max()
        assert np.abs(g - w).max() <= rel * scale, (np.abs(g - w).max(),
                                                     scale)


@pytest.mark.parametrize("topo,key", STEP_CASES,
                         ids=[f"{t}-{k[0]}-m{k[1]}" for t, k in STEP_CASES])
def test_pipeline_step_matches_jax(topo, key):
    """Loss and every gradient leaf of each schedule and microbatch count
    against the JAX step on the same parameters and batch."""
    before, state, loss, _, _, _ = _jax_step(topo, key)
    ranks = _results(topo)[key]
    for r in ranks:
        np.testing.assert_allclose(r["losses"], [loss], atol=1e-5)
        assert r["step"] == 1
    d, s = TOPOLOGIES[topo]
    want = _grads(before, jax.device_get(state.params))
    _hold(_grads(before, _merged(ranks, s)), want, 1e-4)
    if d > 1:     # the data rows hold the same stages, bitwise
        for a, b in zip(ranks[:s], ranks[s:]):
            for x, y in zip(jax.tree.leaves(a["params"]),
                            jax.tree.leaves(b["params"])):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", list(TOPOLOGIES))
def test_1f1b_matches_gpipe_in_the_port(name):
    results = _results(name)
    s = TOPOLOGIES[name][1]
    before = _tree(s)
    for key in _step_keys(name):
        if key[0] != "1f1b":
            continue
        got = _grads(before, _merged(results[key], s))
        want = _grads(before, _merged(results[("gpipe", key[1])], s))
        _hold(got, want, 1e-6)
        assert results[key][0]["losses"] == pytest.approx(
            results[("gpipe", key[1])][0]["losses"], abs=1e-6)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b", "interleaved"])
def test_k_step_is_bitwise_per_step(schedule):
    results = _results("s2")
    for per, win in zip(results[(schedule, "per_step")],
                        results[(schedule, "window")]):
        assert per["losses"] == win["losses"] and len(per["losses"]) == 4
        assert per["step"] == win["step"] == 4
        for x, y in zip(jax.tree.leaves(per["params"]),
                        jax.tree.leaves(win["params"])):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", list(TOPOLOGIES))
def test_numerics_match_jax_make_pp_numerics(name):
    results = _results(name)
    s = TOPOLOGIES[name][1]
    key = ("gpipe", s, "numerics")
    _, _, _, (handle, summary), _, _ = _jax_step(name, key, True)
    want = handle.event_fields(summary)
    for r in results[key]:
        got = r["numerics"]
        assert got["groups"] == handle.groups and got["paths"] == handle.paths
        fields = got["fields"]
        assert fields["worst_group"] == want["worst_group"]
        assert list(fields["groups"]) == list(want["groups"])
        np.testing.assert_allclose(fields["grad_norm"], want["grad_norm"],
                                   rtol=1e-5)
        for g, vals in want["groups"].items():
            for k, v in vals.items():
                np.testing.assert_allclose(fields["groups"][g][k], v,
                                           rtol=1e-5)
    assert any(g.startswith(f"stage{s - 1}/blocks/") for g in handle.groups)


def _want_comm(jax_prof, schedule, m, s, n_stages, port_local_bytes):
    """The port's profile on stage ``s`` from the JAX program's static one.

    - ``pp_activation_hop``: JAX counts one ppermute per tick (``M + S −
      1``; 1F1B ``M + 2(S − 1)``; interleaved ``v·M + S − 1``), bubble
      ticks included; a stage process sends only real activations: M
      (v·M interleaved) from every stage but the last, which sends none
      (interleaved: ``(v − 1)·M``, the laps' last→first hops). Same bytes
      per hop.
    - ``pp_cotangent_hop``: JAX records the 1F1B ones only (its other
      backward hops are autodiff's, which its profile does not see); the
      port sends every stage's but the first's: M (interleaved v·M, the
      first ``(v − 1)·M``).
    - ``pp_replicated_grads``: JAX's psum of the stage-replicated leaves'
      gradients; none in the port (those leaves live on one stage).
    - ``pp_loss_allreduce``, ``loss_allreduce``: equal.
    - ``grad_allreduce``: JAX's local tree holds the replicated leaves on
      every stage; the port's stage holds its own leaves only."""
    coll = jax_prof["collectives"]
    hop = coll["pp_activation_hop"]
    per_hop = hop["payload_bytes"] // hop["calls"]
    v = V if schedule == "interleaved" else 1
    first, last = s == 0, s == n_stages - 1
    want = {}
    sends = {"pp_activation_hop": v * m - (m if last else 0),
             "pp_cotangent_hop": v * m - (m if first else 0)}
    for label, calls in sends.items():
        if calls:
            want[label] = ("ppermute", "stage", n_stages, calls,
                           calls * per_hop)
    for label in ("pp_loss_allreduce", "loss_allreduce"):
        if label in coll:
            c = coll[label]
            want[label] = (c["op"], c["axis"], c["axis_size"], c["calls"],
                           c["payload_bytes"])
    if "grad_allreduce" in coll:
        c = coll["grad_allreduce"]
        want["grad_allreduce"] = (c["op"], c["axis"], c["axis_size"], 1,
                                  port_local_bytes)
    return want


@pytest.mark.parametrize("name", list(TOPOLOGIES))
def test_comm_bytes_per_label_follow_the_jax_profile(name):
    results = _results(name)
    d, n_stages = TOPOLOGIES[name]
    for key in _step_keys(name):
        m = key[1]
        _, state, _, _, step, tokens = _jax_step(name, key)
        jprof = jmeasure_comm(step, state, tokens).as_dict()
        ticks = {"gpipe": m + n_stages - 1, "1f1b": m + 2 * (n_stages - 1),
                 "interleaved": V * m + n_stages - 1}[key[0]]
        assert jprof["collectives"]["pp_activation_hop"]["calls"] == ticks
        assert "pp_replicated_grads" in jprof["collectives"]
        for r in results[key]:
            local = sum(np.asarray(x).nbytes
                        for x in jax.tree.leaves(r["params"]))
            got = {label: (c["op"], c["axis"], c["axis_size"], c["calls"],
                           c["payload_bytes"])
                   for label, c in r["comm"]["collectives"].items()}
            assert got == _want_comm(jprof, key[0], m, r["s"], n_stages,
                                     local), (key, r["s"])


# ------------------------------------------------------------ world of one

SMALL = CFG[2]


def _one_stage(schedule, params):
    mesh = distributed.pipeline_mesh(1, 1)
    cfg = LlamaConfig(**SMALL)
    opt = fused_adam(ADAM_LR)
    step = pp.make_pipeline_step(cfg, opt, mesh, 2, schedule, n_chunks=2,
                                 device="cpu")
    tokens = torch.zeros((4, T), dtype=torch.long)
    return lambda: step(pp.init_state(mesh, params, opt, device="cpu"),
                        tokens)


def test_layout_guard_raises_as_jax_does():
    """Natural parameters under the interleaved schedule, interleaved ones
    under another (S, v) or under GPipe: each raises on the first call
    with the JAX package's message."""
    model = params_from_jax(_tree(2), LlamaConfig(**SMALL), "cpu")
    natural = model.tree()
    with pytest.raises(ValueError, match="interleave_params"):
        _one_stage("interleaved", natural)()
    wrong = pp.interleave_params(natural, 1, 4)
    with pytest.raises(ValueError, match="different topology"):
        _one_stage("interleaved", wrong)()
    with pytest.raises(ValueError, match="natural layer order"):
        _one_stage("gpipe", pp.interleave_params(natural, 1, 2))()
    with pytest.raises(ValueError, match="unknown schedule"):
        _one_stage("zigzag", natural)


def test_interleave_order_is_jax():
    for n_layers, s, v in ((4, 2, 2), (6, 3, 2), (8, 2, 4)):
        assert pp._interleave_order(n_layers, s, v) == np.asarray(
            jpp._interleave_order(n_layers, s, v)).tolist()
    blocks = {"w": torch.arange(8.0)[:, None]}
    back = pp.deinterleave_blocks(pp.interleave_blocks(blocks, 2, 2), 2, 2)
    assert torch.equal(back["w"], blocks["w"])


def test_split_and_merge_stages_are_the_jax_tree():
    cfg = LlamaConfig(**CFG[3])
    tree = _tree(3)
    model = params_from_jax(tree, cfg, "cpu")
    stages = llama.split_stages(model, 3)
    jstages = jllama.split_stages(jax.tree.map(jnp.asarray, tree), 3)
    for got, want in zip(stages, jstages):
        assert sorted(got) == sorted(want)
        for x, y in zip(jax.tree.leaves(jax.tree.map(
                lambda t: t.detach().numpy(), got)), jax.tree.leaves(want)):
            np.testing.assert_array_equal(x, np.asarray(y))
    merged = llama.merge_stages(stages)
    for x, y in zip(jax.tree.leaves(jax.tree.map(
            lambda t: t.detach().numpy(), merged)), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(x, y)
    tok = torch.as_tensor(np.random.default_rng(0).integers(0, 64, (2, 8)))
    h = tok
    for s, stage in enumerate(stages):
        h = llama.stage_apply(stage, h, cfg, is_first=s == 0, is_last=s == 2)
    want = jllama.forward(jax.tree.map(jnp.asarray, tree),
                          jnp.asarray(tok.numpy()), JaxLlamaConfig(**CFG[3]))
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(want),
                               atol=1e-5)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b", "interleaved"])
def test_one_stage_pipeline_is_the_plain_step(schedule):
    """At one stage (interleaved: a stage handing each microbatch to itself
    between its two chunks) the schedule's loss and gradient are the
    world-of-one microbatch mean's, the interleaved one back in natural
    order through ``deinterleave_params``."""
    cfg = LlamaConfig(**SMALL)
    natural = params_from_jax(_tree(2), cfg, "cpu").tree()
    params = (pp.interleave_params(natural, 1, 2)
              if schedule == "interleaved" else natural)
    mesh = distributed.pipeline_mesh(1, 1)
    state = pp.init_state(mesh, params, fused_adam(ADAM_LR), device="cpu")
    tokens = torch.as_tensor(_batches("s2", 1, 3)[0])
    loss, grads = pp.loss_and_grad(state, tokens, cfg, mesh, 2, schedule,
                                   device="cpu")
    if schedule == "interleaved":
        assert float(grads["blocks_layout"]) == 0.0
        grads = pp.deinterleave_params(grads, 1, 2)
    halves = tokens.reshape(2, -1, T)
    want = sum(llama.forward_loss(natural, h, cfg) for h in halves) / 2
    want_grads = torch.autograd.grad(want, jax.tree.leaves(natural))
    np.testing.assert_allclose(float(loss), float(want), atol=1e-6)
    for g, w in zip(jax.tree.leaves(grads), want_grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(),
                                   atol=1e-6 * float(w.abs().max()))


def test_stage_checkpoint_round_trips_the_interleaved_state(tmp_path):
    """A stage state (interleaved: with the layout tag) saved as the whole
    model's state and restored into a fresh stage state, bitwise."""
    from ddl25spring_tpu_torch.checkpoint import Checkpointer

    cfg = LlamaConfig(**SMALL)
    params = pp.interleave_params(
        params_from_jax(_tree(2), cfg, "cpu").tree(), 1, 2)
    mesh = distributed.pipeline_mesh(1, 1)
    opt = fused_adam(ADAM_LR)
    step = pp.make_pipeline_step(cfg, opt, mesh, 2, "interleaved",
                                 device="cpu")
    state, _ = step(pp.init_state(mesh, params, opt, device="cpu"),
                    torch.as_tensor(_batches("s2", 1, 4)[0]))
    Checkpointer(str(tmp_path)).save(1, state)
    back = Checkpointer(str(tmp_path)).restore(
        pp.init_state(mesh, params, opt, device="cpu"))
    assert back.pp.mesh is state.pp.mesh and int(back.step) == 1
    for a, b in zip(jax.tree.leaves(back[:3]), jax.tree.leaves(state[:3])):
        assert torch.equal(a, b)
