"""The port's tensor parallelism (``parallel/tp.py``) against the JAX
package's on the CPU mesh, at ``tests/test_tp.py``'s sizes (vocab 128,
dmodel 32, 4 heads, 2 layers, ctx 32), on the same weights (a JAX
``init_llama`` tree) and the same numpy tokens.

The port's ranks are processes joined by gloo (``distributed.run_ranks``),
one launch per layout for the module (``programs.tp_cases``): ``model=2``,
``model=4`` and ``data=2 × model=2``. Held:

- ``tp_forward`` within 2e-4 of JAX's; the plain step over 3 steps: loss
  within 1e-5, every merged leaf within 1e-4 of its largest entry (plain
  SGD at lr 1, so a leaf's difference is its gradients'; Adam's ε makes
  near-zero gradients' rounding visible);
- ``psa`` "" and "full" bitwise each other and ``make_tp_train_step``;
  "defer:2" and "int8_ef" against JAX's same mode (Adam): loss within
  1e-4, leaves within 2e-3, at most 1% of elements beyond 1e-5; JAX's
  error-feedback property of ``_psa_int8_sync``;
- K = 2 windows bitwise two per-step calls, for "" and "int8_ef";
  numerics on and off bitwise, the summary within 1e-5 of
  ``make_tp_numerics``'s;
- the DP×TP ring drivers against ``make_tp_overlap_step`` in fp32 ×
  {gradient, zero1} × M ∈ {1, 2} (the plain step's bars), an int8_ef
  zero1 cell and a ``comm_buckets=3`` cell (the int8 bars); the comm
  profile by label JAX's byte for byte; data and model replicas bitwise;
  the bucket map JAX's tuple for tuple;
- save and resume bitwise 4 uninterrupted steps through the EF residuals,
  for the PSA step and the ring driver, and the checkpoint in JAX's
  global layout."""

import functools
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddl25spring_tpu.config import LlamaConfig as JaxLlamaConfig
from ddl25spring_tpu.models import llama as jllama
from ddl25spring_tpu.parallel import make_mesh
from ddl25spring_tpu.parallel import tp as jtp
from ddl25spring_tpu.telemetry.comm import measure_comm as jmeasure_comm
from ddl25spring_tpu_torch.config import LlamaConfig
from ddl25spring_tpu_torch.parallel import distributed, programs, tp
from ddl25spring_tpu_torch.tree import tree_leaves

torch.set_num_threads(1)

CFG = dict(vocab_size=128, dmodel=32, num_heads=4, n_layers=2, ctx_size=32)
B = 4                                       # batch per data row
ADAM = 1e-3
LAYOUTS = {"m2": (1, 2), "m4": (1, 4), "d2m2": (2, 2)}
RING_CELLS = {
    "grad_m1": dict(aggregation="gradient", wire="fp32", microbatches=1),
    "grad_m2": dict(aggregation="gradient", wire="fp32", microbatches=2),
    "zero1_m1": dict(aggregation="zero1", wire="fp32", microbatches=1),
    "zero1_m2": dict(aggregation="zero1", wire="fp32", microbatches=2),
    "int8_zero1_m2": dict(aggregation="zero1", wire="int8_ef",
                          microbatches=2, optimizer="adam"),
    "int8_zero1_b3": dict(aggregation="zero1", wire="int8_ef",
                          microbatches=1, comm_buckets=3, optimizer="adam"),
}
INT8_CELLS = ("int8_zero1_m2", "int8_zero1_b3")
RESUME = {"m2": dict(psa="int8_ef", batch_shape=(B, CFG["ctx_size"])),
          "d2m2": dict(driver="overlap", aggregation="zero1", wire="int8_ef",
                       microbatches=1)}


@functools.lru_cache(maxsize=None)
def _ckpt_dir(layout):
    return tempfile.mkdtemp(prefix=f"tp-resume-{layout}-")


@functools.lru_cache(maxsize=None)
def _params():
    return jax.tree.map(np.asarray, jllama.init_llama(
        jax.random.key(0), JaxLlamaConfig(**CFG)))


def _tokens(layout, n=3, seed=1):
    d, _ = LAYOUTS[layout]
    return np.random.default_rng(seed).integers(
        0, CFG["vocab_size"], (n, d * B, CFG["ctx_size"]))


def _base(layout):
    d, m = LAYOUTS[layout]
    return dict(cfg=CFG, params=_params(), data=d, model=m)


@functools.lru_cache(maxsize=None)
def _cases(layout):
    base = _base(layout)
    toks = _tokens(layout)
    cases = {"forward": dict(base, driver="forward", batches=toks[:1]),
             "sgd": dict(base, optimizer="sgd", lr=1.0, batches=toks,
                         numerics=True)}
    if layout == "m2":
        bshape = (B, CFG["ctx_size"])
        for psa in ("", "full", "defer:2", "int8_ef"):
            cases[("adam", psa)] = dict(base, psa=psa, batch_shape=bshape,
                                        lr=ADAM, batches=toks)
        cases["train"] = dict(base, driver="train", lr=ADAM, batches=toks)
        cases["sgd_off"] = dict(base, optimizer="sgd", lr=1.0, batches=toks)
        y = np.linspace(-1.0, 1.0, 2 * 8 * 16,
                        dtype=np.float32).reshape(2, 8, 16)
        cases["int8_sync"] = dict(base, driver="int8_sync", y=y)
        window = _tokens(layout, n=2, seed=3)
        for psa in ("", "int8_ef"):
            kw = dict(base, psa=psa, batch_shape=bshape, lr=ADAM)
            cases[("per_step", psa)] = dict(kw, batches=window)
            cases[("window", psa)] = dict(kw, driver="multi",
                                          batches=window[None])
    if layout in RESUME:
        four = _tokens(layout, n=4, seed=4)
        kw = dict(base, lr=ADAM, **RESUME[layout])
        cases["straight"] = dict(kw, batches=four)
        cases["first"] = dict(kw, batches=four[:2],
                              checkpoint=_ckpt_dir(layout))
        cases["resumed"] = dict(kw, batches=four[2:],
                                restore=_ckpt_dir(layout))
    if layout == "d2m2":
        for name, cell in RING_CELLS.items():
            cell = dict(cell)
            opt = cell.pop("optimizer", "sgd")
            cases[name] = dict(base, driver="overlap", optimizer=(
                "fused" if opt == "adam" else "sgd"),
                lr=ADAM if opt == "adam" else 1.0, batches=toks, **cell)
        cases["ring_numerics"] = dict(
            base, driver="overlap", optimizer="sgd", lr=1.0, batches=toks,
            numerics=True, **RING_CELLS["zero1_m2"])
    return cases


_LAUNCHED = {}


def _results(layout):
    """One launch per layout, made on first use: ``{case key: every
    rank's result}``."""
    if layout not in _LAUNCHED:
        d, m = LAYOUTS[layout]
        cases = _cases(layout)
        ranks = distributed.run_ranks(programs.tp_cases, d * m,
                                      list(cases.values()), device="cpu",
                                      timeout=600)
        _LAUNCHED[layout] = {key: [r[i] for r in ranks]
                             for i, key in enumerate(cases)}
    return _LAUNCHED[layout]


def _mesh(layout):
    d, m = LAYOUTS[layout]
    devs = jax.devices()[:d * m]
    return make_mesh({"model": m} if d == 1 else {"data": d, "model": m},
                     devices=devs)


@functools.lru_cache(maxsize=None)
def _jax_run(layout, key, n_steps=3):
    """JAX's run of a case: ``(losses, params leaves, comm by label,
    numerics summaries)``."""
    case = _cases(layout)[key]
    mesh = _mesh(layout)
    cfg = JaxLlamaConfig(**CFG)
    opt = (optax.sgd(case["lr"]) if case.get("optimizer") == "sgd"
           else optax.adam(case["lr"]))
    numerics = None
    if case.get("driver") == "overlap":
        if case.get("numerics"):
            numerics = jtp.make_tp_numerics(_params(), mesh, psum_data=True)
        state, step = jtp.make_tp_overlap_step(
            cfg, opt, mesh, _params(), aggregation=case["aggregation"],
            wire=case["wire"], overlap_microbatches=case["microbatches"],
            comm_buckets=case.get("comm_buckets", 1), numerics=numerics)
    else:
        if case.get("numerics"):
            numerics = jtp.make_tp_numerics(_params(), mesh)
        state, step = jtp.make_tp_step(
            cfg, opt, mesh, _params(), psa=case.get("psa", ""),
            batch_shape=case.get("batch_shape"), numerics=numerics)
    d = LAYOUTS[layout][0]
    comm = jmeasure_comm(step, state, jax.ShapeDtypeStruct(
        (d * B, CFG["ctx_size"]), jnp.int32)).by_label()
    losses, summaries = [], []
    for batch in case["batches"][:n_steps]:
        state, out = step(state, jtp.shard_batch(mesh, batch))
        if numerics is not None:
            out, summary = out
            summaries.append(numerics.event_fields(summary))
        losses.append(float(out))
    return (losses, jax.tree.leaves(jax.device_get(state.params)), comm,
            summaries)


def _leaf_rel(got, want):
    return max(float(np.abs(a - b).max() / np.abs(b).max())
               for a, b in zip(got, want))


def _int8_bars(got_losses, want_losses, got, want):
    np.testing.assert_allclose(got_losses, want_losses, atol=1e-4, rtol=0)
    assert _leaf_rel(got, want) <= 2e-3
    beyond = sum(int((np.abs(a - b) > 1e-5).sum()) for a, b in zip(got, want))
    assert beyond <= 0.01 * sum(a.size for a in want)


# ------------------------------------------------------------- forward

@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tp_forward_matches_jax(layout):
    mesh = _mesh(layout)
    toks = _cases(layout)["forward"]["batches"][0]
    want = np.asarray(jtp.tp_forward(jtp.shard_params(mesh, _params()),
                                     toks, JaxLlamaConfig(**CFG), mesh))
    for r in _results(layout)["forward"]:
        rows = want[r["d"] * B:(r["d"] + 1) * B]
        np.testing.assert_allclose(r["logits"], rows, atol=2e-4, rtol=2e-3)


# ---------------------------------------------------------- plain step

@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_plain_step_matches_jax_make_tp_step(layout):
    losses, leaves, comm, _ = _jax_run(layout, "sgd")
    ranks = _results(layout)["sgd"]
    for r in ranks:
        np.testing.assert_allclose(r["losses"], losses, atol=1e-5, rtol=0)
    assert _leaf_rel(tree_leaves(ranks[0]["merged"]), leaves) <= 1e-4
    got = ranks[0]["comm"]["collectives"]
    assert {k: (v["calls"], v["payload_bytes"]) for k, v in got.items()} \
        == {k: (v["calls"], v["payload_bytes"]) for k, v in comm.items()}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_plain_step_numerics_match_jax(layout):
    _, _, _, want = _jax_run(layout, "sgd")
    got = _results(layout)["sgd"]
    for r in got:
        assert len(r["numerics"]) == 3
        for g, w in zip(r["numerics"], want):
            assert g["worst_group"] == w["worst_group"]
            assert list(g["groups"]) == list(w["groups"])
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                       rtol=1e-5)
            for name, vals in w["groups"].items():
                for k, v in vals.items():
                    np.testing.assert_allclose(g["groups"][name][k], v,
                                               rtol=1e-5, atol=1e-7)


def test_numerics_on_off_bitwise():
    res = _results("m2")
    for on, off in zip(res["sgd"], res["sgd_off"]):
        assert on["losses"] == off["losses"]
        for a, b in zip(tree_leaves(on["params"]), tree_leaves(off["params"])):
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------ PSA

def test_psa_off_full_and_train_step_bitwise():
    res = _results("m2")
    ref = res["train"]
    for key in (("adam", ""), ("adam", "full")):
        for a, b in zip(res[key], ref):
            assert a["losses"] == b["losses"]
            for x, y in zip(tree_leaves(a["params"]), tree_leaves(b["params"])):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("psa", ["", "full", "defer:2", "int8_ef"])
def test_psa_modes_match_jax(psa):
    losses, leaves, comm, _ = _jax_run("m2", ("adam", psa))
    ranks = _results("m2")[("adam", psa)]
    _int8_bars(ranks[0]["losses"], losses,
               tree_leaves(ranks[0]["merged"]), leaves)
    assert ranks[1]["losses"] == ranks[0]["losses"]
    got = ranks[0]["comm"]["collectives"]
    assert {k: (v["calls"], v["payload_bytes"]) for k, v in got.items()} \
        == {k: (v["calls"], v["payload_bytes"]) for k, v in comm.items()}


def test_psa_wire_bytes_match_the_analytic_budget():
    for psa in ("full", "defer:2", "int8_ef"):
        comm = _results("m2")[("adam", psa)][0]["comm"]["collectives"]
        labels = ("psa_full_sync", "psa_defer_sync", "psa_act_int8",
                  "psa_act_scale")
        wire = sum(comm[k]["wire_bytes_per_device"] for k in labels
                   if k in comm)
        assert wire == tp.psa_sync_wire_bytes(
            LlamaConfig(**CFG), psa, 2, B, CFG["ctx_size"]) == \
            jtp.psa_sync_wire_bytes(JaxLlamaConfig(**CFG), psa, 2, B,
                                    CFG["ctx_size"])


def test_psa_int8_error_feedback_property():
    """``tests/test_tp.py``'s telescoping property at two shards: one
    sync's error and two syncs' cumulative error within one quantization
    step of the shards, the residual within one step."""
    ranks = _results("m2")["int8_sync"]
    for r in ranks:
        e1 = np.abs(r["out1"] - r["exact"]).max()
        assert e1 <= 2 * 2.0 / 254 + 1e-6
        cum = np.abs(r["out1"] + r["out2"] - 2 * r["exact"]).max()
        assert cum <= 2 * 2.0 / 254 + 1e-6
        assert np.abs(r["res2"]).max() <= 2.0 / 254 + 1e-6
    # The shards agree on the combined value bitwise.
    np.testing.assert_array_equal(ranks[0]["out2"], ranks[1]["out2"])


@pytest.mark.parametrize("psa", ["", "int8_ef"])
def test_k_step_window_bitwise_per_step(psa):
    res = _results("m2")
    for a, b in zip(res[("per_step", psa)], res[("window", psa)]):
        assert a["losses"] == b["losses"]
        for x, y in zip(tree_leaves(a["params"]), tree_leaves(b["params"])):
            np.testing.assert_array_equal(x, y)
    sa, sb = res[("per_step", psa)][0], res[("window", psa)][0]
    for x, y in zip(sa["snapshot"], sb["snapshot"]):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("psa", ["defer:3", "bogus", "defer:x", "int8_ef"])
def test_psa_named_errors_are_jax_s(psa):
    mesh = distributed.TPMesh(
        1, 4, 0, 0, distributed.Group("model", (0, 1, 2, 3), 0),
        distributed.Group("data", (0,), 0),
        distributed.Group("model", (0, 1, 2, 3), 0))
    jmesh = _mesh("m4")
    with pytest.raises(ValueError) as jerr:
        jtp.make_tp_step(JaxLlamaConfig(**CFG), optax.adam(1e-3), jmesh,
                         _params(), psa=psa)
    with pytest.raises(ValueError) as err:
        tp.make_tp_step(LlamaConfig(**CFG), programs.sgd(1.0), mesh,
                        _params(), psa=psa, device="cpu")
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("case", ["int8_psa_ring", "no_model_axis"])
def test_ring_named_errors_are_jax_s(case):
    if case == "int8_psa_ring":
        d, m, jmesh = 2, 4, make_mesh({"data": 2, "model": 4})
        kw = dict(aggregation="zero1", wire="int8_ef",
                  overlap_microbatches=1, psa="int8_ef")
    else:
        d, m = 4, 1
        jmesh = make_mesh({"data": 4}, devices=jax.devices()[:4])
        kw = dict(aggregation="zero1", wire="fp32", overlap_microbatches=1)
    mesh = distributed.TPMesh(
        d, m, 0, 0, distributed.Group("model", tuple(range(m)), 0),
        distributed.Group("data", tuple(range(0, d * m, m)), 0),
        distributed.Group("model", tuple(range(m)), 0))
    with pytest.raises(ValueError) as jerr:
        jtp.make_tp_overlap_step(JaxLlamaConfig(**CFG), optax.adam(1e-3),
                                 jmesh, _params(), **kw)
    with pytest.raises(ValueError) as err:
        tp.make_tp_overlap_step(LlamaConfig(**CFG), programs.sgd(1.0), mesh,
                                _params(), device="cpu", **kw)
    assert str(err.value) == str(jerr.value)


# ---------------------------------------------------------- DP×TP ring

@pytest.mark.parametrize("cell", list(RING_CELLS))
def test_ring_driver_matches_jax(cell):
    losses, leaves, comm, _ = _jax_run("d2m2", cell)
    ranks = _results("d2m2")[cell]
    got_leaves = tree_leaves(ranks[0]["merged"])
    if cell in INT8_CELLS:
        _int8_bars(ranks[0]["losses"], losses, got_leaves, leaves)
    else:
        np.testing.assert_allclose(ranks[0]["losses"], losses, atol=1e-5,
                                   rtol=0)
        assert _leaf_rel(got_leaves, leaves) <= 1e-4
    got = ranks[0]["comm"]["collectives"]
    assert {k: (v["op"] if "op" in v else None, v["calls"],
                v["payload_bytes"], v["wire_bytes_per_device"])
            for k, v in got.items()} == \
        {k: (v["op"] if "op" in v else None, v["calls"], v["payload_bytes"],
             v["wire_bytes_per_device"]) for k, v in comm.items()}


@pytest.mark.parametrize("cell", list(RING_CELLS))
def test_ring_replicas_bitwise(cell):
    """Data replicas of every leaf, and model replicas of the replicated
    leaves, hold the same bits after 3 steps."""
    ranks = _results("d2m2")[cell]
    by_m = {}
    for r in ranks:
        by_m.setdefault(r["m"], []).append(r)
        assert r["losses"] == ranks[0]["losses"]
    for group in by_m.values():
        for x, y in zip(tree_leaves(group[0]["params"]),
                        tree_leaves(group[1]["params"])):
            np.testing.assert_array_equal(x, y)
    for key in ("embed", "lm_head"):
        for r in ranks[1:]:
            np.testing.assert_array_equal(r["params"][key],
                                          ranks[0]["params"][key])


def test_ring_numerics_match_jax():
    _, _, _, want = _jax_run("d2m2", "ring_numerics")
    for r in _results("d2m2")["ring_numerics"]:
        for g, w in zip(r["numerics"], want):
            assert list(g["groups"]) == list(w["groups"])
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                       rtol=1e-5)


@pytest.mark.parametrize("buckets", [2, 3, 8])
def test_bucket_map_is_jax_s(buckets):
    mesh = distributed.TPMesh(
        2, 2, 0, 0, distributed.Group("model", (0, 1), 0),
        distributed.Group("data", (0, 2), 0),
        distributed.Group("model", (0, 1), 0))
    got = tp._tp_bucket_map(mesh, _params(), buckets)
    want = jtp._tp_bucket_map(_mesh("d2m2"), _params(), buckets)
    assert tuple(got) == tuple(want)
    assert tp._tp_flat_geometry(mesh, _params()) == \
        jtp._tp_flat_geometry(_mesh("d2m2"), _params())


# ------------------------------------------------------ save and resume

@pytest.mark.parametrize("layout", list(RESUME))
def test_resume_is_bitwise_the_uninterrupted_run(layout):
    res = _results(layout)
    for s, f, r in zip(res["straight"], res["first"], res["resumed"]):
        assert f["losses"] + r["losses"] == s["losses"]
        assert r["step"] == s["step"] == 4
        for x, y in zip(tree_leaves(s["params"]), tree_leaves(r["params"])):
            np.testing.assert_array_equal(x, y)
    # Residuals and moments included: the whole merged state.
    for x, y in zip(res["straight"][0]["snapshot"],
                    res["resumed"][0]["snapshot"]):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("layout", list(RESUME))
def test_checkpoint_holds_the_jax_global_layout(layout):
    d, m = LAYOUTS[layout]
    saved = torch.load(os.path.join(_ckpt_dir(layout), "2.pt"))["tensors"]
    shapes = [tuple(x.shape) for x in saved]
    full = [tuple(x.shape) for x in jax.tree.leaves(_params())]
    assert all(s in shapes for s in full)          # merged parameters
    if layout == "m2":
        assert (d, m, CFG["n_layers"], 2, B, CFG["ctx_size"],
                CFG["dmodel"]) in shapes           # the activation residual
    else:
        n, _, local, _ = jtp._tp_flat_geometry(_mesh(layout), _params())
        assert shapes.count((d, m, local)) >= 3     # moments, gather residual
        assert (d, m, n * local) in shapes         # ring residual
