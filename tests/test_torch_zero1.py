"""The port's ZeRO-1 against the JAX package's on the ``data=2`` mesh, and
the optimizer pieces that go with it: ``master_weight_adam`` on bf16
parameters, ``resize_zero_padded``, and the optimizer-state bridges of
``convert``. The ZeRO-1 runs are two ranks on the CPU joined by gloo, one
launch for the module (``programs.dp_cases``).

Tolerances: losses within 1e-5; each rank's moment slice after the
steps, leaf by leaf of the raveled tree, within 1e-4 of that leaf's
largest JAX moment (step 1's gradients agree within 1e-5 of each leaf's
largest entry, and the parameters the later steps differentiate at differ
by up to lr where a gradient is near ε: measured 2.2e-5); parameters
after Adam steps within lr, all but a share of 1e-4 within 1e-6
(ROADMAP.md § C); the port's ZeRO-1
against the port's gradient aggregation bitwise (the same elementwise
Adam on the same averaged gradient); the master-weight rule per step
within 1e-6 (the same operations in the same order)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddl25spring_tpu.config import LlamaConfig as JaxLlamaConfig
from ddl25spring_tpu.models import llama as jllama
from ddl25spring_tpu.ops import adam as jadam
from ddl25spring_tpu.ops import mixed_precision as jmp
from ddl25spring_tpu.parallel import dp as jdp
from ddl25spring_tpu.parallel import make_mesh
from ddl25spring_tpu_torch import convert
from ddl25spring_tpu_torch.ops import adam, mixed_precision
from ddl25spring_tpu_torch.parallel import distributed, programs

torch.set_num_threads(1)

SMALL = dict(vocab_size=64, dmodel=32, num_heads=2, n_layers=2, ctx_size=16)
LR = 8e-4
N, B, T = 2, 2, 16


def _batches(n_steps, seed, k=None):
    rng = np.random.default_rng(seed)
    shape = (n_steps, N * B, T) if k is None else (n_steps, k, N * B, T)
    return rng.integers(0, SMALL["vocab_size"], shape)


TREE = jax.tree.map(np.asarray, jllama.init_llama(
    jax.random.PRNGKey(0), JaxLlamaConfig(**SMALL)))
STEPS = _batches(3, 1)
WINDOWS = _batches(2, 2, k=2)          # two windows of K = 2
CASES = {
    "zero1": dict(mode="zero1", batches=STEPS),
    "gradient": dict(mode="gradient", batches=STEPS),
    "zero1_multi": dict(mode="zero1_multi", batches=WINDOWS),
    "zero1_per_step": dict(mode="zero1", batches=WINDOWS.reshape(
        4, N * B, T)),
    # Rank 1's second loss is NaN: the guarded step skips it on both ranks.
    "guard": dict(mode="zero1", batches=STEPS, guard=True, poison=(1, 2)),
    "skip_ref": dict(mode="zero1", batches=STEPS[[0, 2]]),
}


@pytest.fixture(scope="module")
def port():
    cases = [dict(cfg=SMALL, params=TREE, lr=LR, **c) for c in CASES.values()]
    ranks = distributed.run_ranks(programs.dp_cases, N, cases, device="cpu")
    return {name: [r[i] for r in ranks] for i, name in enumerate(CASES)}


def _jax_zero1(make, batches):
    mesh = make_mesh({"data": N})
    jcfg = JaxLlamaConfig(**SMALL)
    state, step = make(lambda p, b: jllama.forward_loss(p, b, jcfg),
                       jadam.fused_adam(LR), mesh,
                       jax.tree.map(jnp.asarray, TREE))
    losses = []
    for b in batches:
        if b.ndim == 3:
            state, ls = step(state, jdp.shard_batch_window(mesh,
                                                           jnp.asarray(b)))
            losses += np.asarray(ls).tolist()
        else:
            state, loss = step(state, jdp.shard_batch(mesh, jnp.asarray(b)))
            losses.append(float(loss))
    return losses, state


def _hold_params(got, want):
    diff = np.concatenate([np.abs(a - np.asarray(b)).ravel() for a, b in
                           zip(jax.tree.leaves(got), jax.tree.leaves(want))])
    assert diff.max() <= LR
    assert (diff > 1e-6).mean() <= 1e-4


@pytest.mark.parametrize("name,make,batches", [
    ("zero1", jdp.make_zero1_step, STEPS),
    ("zero1_multi", jdp.make_zero1_multi_step, WINDOWS)])
def test_zero1_matches_jax_data2(port, name, make, batches):
    losses, state = _jax_zero1(make, batches)
    local = np.asarray(state.opt_state.mu).shape[0] // N
    bounds = np.cumsum([0] + [x.size for x in jax.tree.leaves(TREE)])
    for field in ("mu", "nu"):
        want = np.asarray(getattr(state.opt_state, field))
        got = np.concatenate([getattr(r["opt_state"], field)
                              for r in port[name]])
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            np.testing.assert_allclose(
                got[lo:hi], want[lo:hi],
                atol=1e-4 * np.abs(want[lo:hi]).max())
        np.testing.assert_array_equal(got[bounds[-1]:], 0.0)    # the pad
    for rank in port[name]:
        np.testing.assert_allclose(rank["losses"], losses, atol=1e-5)
        _hold_params(rank["params"], state.params)
        assert rank["opt_state"].mu.shape == (local,)
        assert int(rank["opt_state"].count) == int(state.opt_state.count)
        assert rank["step"] == int(state.step)


def test_zero1_matches_grad_aggregation_bitwise(port):
    for z, g in zip(port["zero1"], port["gradient"]):
        assert z["losses"] == g["losses"]
        for a, b in zip(jax.tree.leaves(z["params"]),
                        jax.tree.leaves(g["params"])):
            np.testing.assert_array_equal(a, b)
    # The slices are the replicated moments, raveled and cut in two.
    full_mu = np.concatenate([r["opt_state"].mu for r in port["zero1"]])
    want = np.concatenate([x.ravel() for x in jax.tree.leaves(
        port["gradient"][0]["opt_state"].mu)])
    np.testing.assert_array_equal(full_mu[:want.size], want)


def test_zero1_multi_step_bitwise_matches_per_step(port):
    for m, p in zip(port["zero1_multi"], port["zero1_per_step"]):
        assert m["losses"] == p["losses"] and m["step"] == p["step"] == 4
        for a, b in zip(jax.tree.leaves(m["params"]),
                        jax.tree.leaves(p["params"])):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(m["opt_state"].nu, p["opt_state"].nu)


def test_zero1_guard_skips_a_nonfinite_rank_on_every_rank(port):
    guard, ref = port["guard"], port["skip_ref"]
    for g, s in zip(guard, ref):
        assert np.isnan(g["losses"][1]) and g["step"] == 2
        assert g["losses"][0] == s["losses"][0]
        assert g["losses"][2] == s["losses"][1]
        # The skipped step left the state as it was: the run is steps 1
        # and 3 alone, on both ranks, with nothing non-finite.
        for a, b in zip(jax.tree.leaves(g["params"]),
                        jax.tree.leaves(s["params"])):
            np.testing.assert_array_equal(a, b)
            assert np.isfinite(a).all()
        np.testing.assert_array_equal(g["opt_state"].mu, s["opt_state"].mu)
    for a, b in zip(jax.tree.leaves(guard[0]["params"]),
                    jax.tree.leaves(guard[1]["params"])):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ master weights

def _bf16_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((4, 64)).astype(np.float32),
            "b": [rng.standard_normal(64).astype(np.float32)]}


def test_master_weight_adam_matches_jax_on_bf16_params():
    init = _bf16_tree(0)
    jopt, opt = jmp.master_weight_adam(1e-3), mixed_precision.\
        master_weight_adam(1e-3)
    jp = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), init)
    p = {"w": torch.from_numpy(init["w"]).bfloat16(),
         "b": [torch.from_numpy(init["b"][0]).bfloat16()]}
    js, s = jopt.init(jp), opt.init(p)
    assert s.count.dtype == torch.int32
    for leaf in jax.tree.leaves((s.mu, s.nu, s.master)):
        assert leaf.dtype == torch.float32
    for step in range(4):
        g = _bf16_tree(10 + step)
        ju, js = jopt.update(jax.tree.map(
            lambda x: jnp.asarray(x, jnp.bfloat16), g), js, jp)
        jp = optax.apply_updates(jp, ju)
        u, s = opt.update({"w": torch.from_numpy(g["w"]).bfloat16(),
                           "b": [torch.from_numpy(g["b"][0]).bfloat16()]},
                          s, p)
        adam.apply_updates(p, u)
        got = convert.opt_state_to_numpy(s)
        for field in ("mu", "nu", "master"):
            for a, b in zip(jax.tree.leaves(getattr(got, field)),
                            jax.tree.leaves(getattr(js, field))):
                np.testing.assert_allclose(a, np.asarray(b), atol=1e-6)
        for leaf, w in zip(jax.tree.leaves(p), jax.tree.leaves(s.master)):
            assert leaf.dtype == torch.bfloat16
            assert torch.equal(leaf, w.to(torch.bfloat16))
        for a, b in zip(jax.tree.leaves(p), jax.tree.leaves(jp)):
            np.testing.assert_array_equal(a.float().numpy(),
                                          np.asarray(b, np.float32))


def test_master_weight_adam_prevents_vanishing_updates():
    """tests/test_mixed_precision.py's case: a relative step of 2^-12
    vanishes in bf16 but accumulates in the fp32 master."""
    tiny = 2.0 ** -12
    assert float(torch.tensor(1.0, dtype=torch.bfloat16)
                 + torch.tensor(tiny, dtype=torch.bfloat16)) == 1.0
    opt = mixed_precision.master_weight_adam(tiny, b1=0.0, b2=0.0, eps=0.0)
    params = {"w": torch.ones(8, dtype=torch.bfloat16)}
    state = opt.init(params)
    for _ in range(600):
        updates, state = opt.update({"w": torch.ones(8,
                                                     dtype=torch.bfloat16)},
                                    state, params)
        adam.apply_updates(params, updates)
    assert float(state.master["w"][0]) < 1.0 - 0.1
    assert float(params["w"][0]) < 1.0


# --------------------------------------------------------- resize and bridges

@pytest.mark.parametrize("new_len", [6, 3, 4, 9])
def test_resize_zero_padded_matches_jax_bitwise(new_len):
    v = np.array([1.5, -2.0, 3.25, 0.0], np.float32)
    got, want = adam.resize_zero_padded(v, new_len), \
        jadam.resize_zero_padded(v, new_len)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("vec,new_len", [
    (np.array([1.0, 2.0, 3.0, 0.0], np.float32), 2),
    (np.ones((2, 2), np.float32), 2)])
def test_resize_zero_padded_raises_where_jax_raises(vec, new_len):
    with pytest.raises(ValueError):
        jadam.resize_zero_padded(vec, new_len)
    with pytest.raises(ValueError):
        adam.resize_zero_padded(vec, new_len)


def _same(a, b):
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


@pytest.mark.parametrize("make", [
    lambda: jadam.fused_adam(1e-3), lambda: optax.adam(1e-3),
    lambda: jmp.master_weight_adam(1e-3)])
def test_opt_state_round_trips_from_jax_bitwise(make):
    params = jax.tree.map(jnp.asarray, _bf16_tree(1))
    opt = make()
    state = opt.init(params)
    _, state = opt.update(jax.tree.map(jnp.ones_like, params), state, params)
    host = jax.tree.map(np.asarray, state)
    back = convert.opt_state_to_numpy(
        convert.opt_state_from_jax(host, device="cpu"))
    count, mu, nu = convert._adam_fields(host)
    _same((back.count, back.mu, back.nu), (count, mu, nu))
    if hasattr(host, "master"):
        assert isinstance(back, mixed_precision.MasterAdamState)
        _same(back.master, host.master)


def test_zero1_opt_state_splits_per_rank_and_rejoins_bitwise():
    mesh = make_mesh({"data": N})
    jcfg = JaxLlamaConfig(**SMALL)
    state, step = jdp.make_zero1_step(
        lambda p, b: jllama.forward_loss(p, b, jcfg), jadam.fused_adam(LR),
        mesh, jax.tree.map(jnp.asarray, TREE))
    state, _ = step(state, jdp.shard_batch(mesh, jnp.asarray(STEPS[0])))
    host = jax.tree.map(np.asarray, state.opt_state)
    slices = [convert.zero1_opt_state_from_jax(host, r, N, device="cpu")
              for r in range(N)]
    assert slices[1].mu.shape == (host.mu.shape[0] // N,)
    _same(convert.zero1_opt_state_to_numpy(slices), host)
