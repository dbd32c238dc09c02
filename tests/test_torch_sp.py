"""The port's sequence parallelism (``parallel/sp.py``) against the JAX
package's on the CPU mesh, at ``tests/test_sp.py``'s sizes (vocab 128,
dmodel 32, 4 heads, 2 layers, ctx 64), on the same weights (a JAX
``init_llama`` tree) and the same numpy inputs.

The port's ranks are four processes joined by gloo, one launch for the
module (``programs.sp_cases``): a ring of 4 (``seq_mesh(1, 4)``), rings of
2 (each data row of ``seq_mesh(2, 2)`` on its own) and ``data=2 × seq=2``.
The launch has a hard timeout, so a ring whose hops were posted out of
order fails instead of hanging. Held:

- ``ring_attention`` at ring 2 and 4, causal and not, against JAX's under
  ``shard_map``: out within 1e-5, the q/k/v gradients within 1e-5 of
  their largest entries, and the hop bytes by label JAX's;
- ``sp_forward`` within 1e-5 of JAX's;
- one ``make_sp_train_step`` step (Adam, lr 1e-3) at seq 4 and at data 2 ×
  seq 2 against JAX's: loss within 1e-5, every leaf within 1e-4 of its
  largest entry, every rank's parameters bitwise the same, and the comm
  profile by label JAX's to the byte;
- the seq-4 step under ``remat=True``: losses, parameters and comm by
  label bitwise the plain step's (one thread)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ddl25spring_tpu.config import LlamaConfig as JaxLlamaConfig
from ddl25spring_tpu.models import llama as jllama
from ddl25spring_tpu.parallel import make_mesh
from ddl25spring_tpu.parallel import sp as jsp
from ddl25spring_tpu.parallel._compat import shard_map
from ddl25spring_tpu.telemetry.comm import measure_comm as jmeasure_comm
from ddl25spring_tpu_torch.parallel import distributed, programs
from ddl25spring_tpu_torch.tree import tree_leaves

torch.set_num_threads(1)

CFG = dict(vocab_size=128, dmodel=32, num_heads=4, n_layers=2, ctx_size=64)
B = 2                                         # batch per data row
RING = dict(b=2, t=64, h=4, dh=16)
ADAM = 1e-3
# name -> (data, seq, each data row on its own)
MESHES = {"s4": (1, 4, False), "s2": (2, 2, True), "d2s2": (2, 2, False)}


@functools.lru_cache(maxsize=None)
def _params():
    return jax.tree.map(np.asarray, jllama.init_llama(
        jax.random.key(0), JaxLlamaConfig(**CFG)))


@functools.lru_cache(maxsize=None)
def _ring_inputs():
    rng = np.random.default_rng(0)
    shape = (RING["b"], RING["t"], RING["h"], RING["dh"])
    return {x: rng.standard_normal(shape).astype(np.float32)
            for x in ("q", "k", "v", "ct")}


def _tokens(data, seed=1):
    return np.random.default_rng(seed).integers(
        0, CFG["vocab_size"], (1, data * B, CFG["ctx_size"]))


def _mesh_case(name):
    d, n, row = MESHES[name]
    return dict(axis="seq", data=d, size=n, row=row)


@functools.lru_cache(maxsize=None)
def _cases():
    cases = {}
    for name in ("s4", "s2"):
        for causal in (True, False):
            cases[("ring", name, causal)] = dict(
                _mesh_case(name), run="ring", causal=causal,
                **_ring_inputs())
        cases[("forward", name)] = dict(_mesh_case(name), run="forward",
                                        cfg=CFG, params=_params(),
                                        batches=_tokens(1))
    for name in ("s4", "d2s2"):
        d = MESHES[name][0]
        cases[("step", name)] = dict(_mesh_case(name), run="step",
                                     cfg=CFG, params=_params(), lr=ADAM,
                                     batches=_tokens(d))
    cases[("step-remat", "s4")] = dict(cases[("step", "s4")],
                                       cfg=dict(CFG, remat=True))
    return cases


_LAUNCHED = {}


def _results():
    """The module's one launch, made on first use: ``{case key: every
    rank's result}``."""
    if not _LAUNCHED:
        cases = _cases()
        ranks = distributed.run_ranks(programs.sp_cases, 4,
                                      list(cases.values()), device="cpu",
                                      timeout=300)
        _LAUNCHED.update({key: [r[i] for r in ranks]
                          for i, key in enumerate(cases)})
    return _LAUNCHED


def _jmesh(name):
    d, n, row = MESHES[name]
    if row or d == 1:
        return make_mesh({"seq": n}, devices=jax.devices()[:n])
    return make_mesh({"data": d, "seq": n}, devices=jax.devices()[:d * n])


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _jax_ring(name, causal):
    """JAX's ring under shard_map: (out, (dq, dk, dv), comm by label)."""
    mesh = _jmesh(name)
    fn = shard_map(lambda q, k, v: jsp.ring_attention(q, k, v, "seq",
                                                      causal=causal),
                   mesh=mesh, in_specs=P(None, "seq"),
                   out_specs=P(None, "seq"), check_vma=False)
    x = _ring_inputs()

    @jax.jit
    def out_and_grads(q, k, v, ct):
        out, vjp = jax.vjp(fn, q, k, v)
        return out, vjp(ct)

    out, grads = out_and_grads(x["q"], x["k"], x["v"], x["ct"])
    comm = jmeasure_comm(jax.jit(fn), *(jax.ShapeDtypeStruct(
        x["q"].shape, jnp.float32) for _ in range(3))).by_label()
    return np.asarray(out), [np.asarray(g) for g in grads], comm


def _by_label(comm):
    return {k: (v["calls"], v["payload_bytes"]) for k, v in comm.items()}


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("name", ["s4", "s2"])
def test_ring_attention_matches_jax(name, causal):
    out, grads, comm = _jax_ring(name, causal)
    tl = RING["t"] // MESHES[name][1]
    for r in _results()[("ring", name, causal)]:
        win = slice(r["i"] * tl, (r["i"] + 1) * tl)
        np.testing.assert_allclose(r["out"], out[:, win], atol=1e-5, rtol=0)
        for x, g in zip("qkv", grads):
            assert _rel(r[f"d{x}"], g[:, win]) <= 1e-5, x
        assert _by_label(r["comm"]) == _by_label(comm)


@pytest.mark.parametrize("name", ["s4", "s2"])
def test_sp_forward_matches_jax(name):
    toks = _tokens(1)[0]
    want = np.asarray(jsp.sp_forward(_params(), toks,
                                     JaxLlamaConfig(**CFG), _jmesh(name)))
    for r in _results()[("forward", name)]:
        np.testing.assert_allclose(r["logits"], want, atol=1e-5, rtol=0)


@functools.lru_cache(maxsize=None)
def _jax_step(name):
    """JAX's one Adam step: (loss, params leaves, comm by label)."""
    mesh = _jmesh(name)
    cfg = JaxLlamaConfig(**CFG)
    opt = optax.adam(ADAM)
    step = jsp.make_sp_train_step(cfg, opt, mesh)
    d = MESHES[name][0]
    comm = jmeasure_comm(step, jsp.init_state(mesh, _params(), opt),
                         jax.ShapeDtypeStruct((d * B, CFG["ctx_size"]),
                                              jnp.int32)).by_label()
    state, loss = step(jsp.init_state(mesh, _params(), opt),
                       jsp.shard_batch(mesh, _tokens(d)[0]))
    return (float(loss), jax.tree.leaves(jax.device_get(state.params)),
            comm)


@pytest.mark.parametrize("name", ["s4", "d2s2"])
def test_sp_step_matches_jax(name):
    loss, leaves, comm = _jax_step(name)
    ranks = _results()[("step", name)]
    for r in ranks:
        np.testing.assert_allclose(r["losses"], [loss], atol=1e-5, rtol=0)
        assert _by_label(r["comm"]) == _by_label(comm)
        for a, b in zip(tree_leaves(r["params"]),
                        tree_leaves(ranks[0]["params"])):
            np.testing.assert_array_equal(a, b)
    got = tree_leaves(ranks[0]["params"])
    assert max(_rel(a, b) for a, b in zip(got, leaves)) <= 1e-4


def test_sp_step_under_remat_is_bitwise_the_plain_step():
    plain = _results()[("step", "s4")]
    remat = _results()[("step-remat", "s4")]
    for p, r in zip(plain, remat):
        assert r["losses"] == p["losses"]
        assert _by_label(r["comm"]) == _by_label(p["comm"])
        for a, b in zip(tree_leaves(r["params"]), tree_leaves(p["params"])):
            np.testing.assert_array_equal(a, b)
