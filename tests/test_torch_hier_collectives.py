"""The port's hierarchical collectives (``distributed.hier_data_mesh``,
``compress.hier_reduce_scatter`` and the two-level ring step) against
the numpy statement of the spec (``parallel/ring_spec.py``) and the JAX
package's ``parallel/compress.py`` on its ``hier_data_mesh``. Four gloo
ranks on the CPU, one ``run_ranks`` launch for the module
(``programs.sequence``).

Bars:
- ``hier_reduce_scatter`` bitwise the flat ring at (D, S) = (1, 4) and
  (4, 1), and bitwise the spec at (2, 2) in fp32/int8_ef and bf16/bf16,
  the DCN residual included over two calls;
- the driver at 2 × 2 (replica (d, s) is rank d·2 + s and owns slice
  s·2 + d) against JAX's from the same weights over 3 steps: fp32 on
  both tiers, losses within 1e-5 and every parameter leaf within 1e-4 of
  its largest entry; with an int8_ef or bf16 tier, losses within 1e-4,
  parameters within 2e-3 of each leaf's largest entry, at most 1% of the
  elements beyond 1e-5 of it; every replica bitwise the others;
- the comm profile per label and per axis (``by_axis``) equal to JAX's;
- a save after 2 steps and a resume bitwise the uninterrupted 4 steps at
  2 × 2 under ZeRO-1 with an int8_ef DCN tier, residuals included;
- the in-step guard with numerics: a NaN on one replica skips the step on
  every rank (the state bitwise the state before it), and the summary of
  the refused update equals JAX's (norms within 1e-4, the same NaN
  groups, the same non-finite leaves);
- the hierarchical validation errors equal JAX's texts.
"""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl25spring_tpu.config import LlamaConfig as JaxLlamaConfig
from ddl25spring_tpu.models import llama as jllama
from ddl25spring_tpu.ops import adam as jadam
from ddl25spring_tpu.parallel import compress as jcompress
from ddl25spring_tpu.parallel import dp as jdp
from ddl25spring_tpu.parallel import make_mesh
from ddl25spring_tpu.parallel.distributed import (
    hier_data_mesh as jhier_data_mesh)
from ddl25spring_tpu.telemetry import comm as jcomm
from ddl25spring_tpu.telemetry import introspect as jintro

from ddl25spring_tpu_torch.parallel import compress, distributed, dp
from ddl25spring_tpu_torch.parallel import programs, ring_spec

torch.set_num_threads(1)

SMALL = dict(vocab_size=64, dmodel=16, num_heads=2, n_layers=2, ctx_size=16)
LR = 3e-3
D, S, B, T = 2, 2, 2, 16
N = D * S
NAN_TOKEN = 63
TREE = jax.tree.map(np.asarray, jllama.init_llama(
    jax.random.PRNGKey(0), JaxLlamaConfig(**SMALL)))
_rng = np.random.default_rng(5)
STEPS = _rng.integers(0, NAN_TOKEN, (4, N * B, T))
FAULTED = STEPS[:3].copy()
FAULTED[1, 2 * B, 0] = NAN_TOKEN          # replica (1, 0), step 2


def _ring_cases():
    rng = np.random.default_rng(7)
    L = N * 24
    xs = rng.standard_normal((N, L)).astype(np.float32)
    res = (rng.standard_normal((N, L // S)) * 1e-2).astype(np.float32)
    return {
        "flat_fp32": dict(xs=xs, wire="fp32"),
        "flat_int8": dict(xs=xs, wire="int8_ef",
                          residuals=np.zeros((N, L), np.float32)),
        "h14": dict(xs=xs, hier=(1, 4), wire_ici="fp32", wire_dcn="int8_ef"),
        "h41": dict(xs=xs, hier=(4, 1), wire_ici="fp32", wire_dcn="int8_ef",
                    residuals=np.zeros((N, L), np.float32)),
        "h22": dict(xs=xs, hier=(2, 2), wire_ici="fp32", wire_dcn="int8_ef",
                    residuals=res, calls=2),
        "h22_bf16": dict(xs=xs, hier=(2, 2), wire_ici="bf16",
                         wire_dcn="bf16"),
    }


WIRE_I8 = {"ici": "fp32", "dcn": "int8_ef"}
STEP_CASES = {
    # name: (wire, aggregation, microbatches, comm_buckets)
    "z_f32_f32": ({"ici": "fp32", "dcn": "fp32"}, "zero1", 1, 1),
    "g_f32_i8": (WIRE_I8, "gradient", 1, 1),
    "z_f32_i8_m2": (WIRE_I8, "zero1", 2, 1),
    "z_f32_i8_b2": (WIRE_I8, "zero1", 1, 2),
    "g_bf16_f32": ({"ici": "bf16", "dcn": "fp32"}, "gradient", 1, 1),
    "g_f32_i8_b2": (WIRE_I8, "gradient", 2, 2),
}


def _case(wire, agg, m, b, **kw):
    return dict(dict(cfg=SMALL, params=TREE, lr=LR, optimizer="fused",
                     wire=wire, aggregation=agg, microbatches=m,
                     comm_buckets=b, hier=(D, S), batches=STEPS[:3]), **kw)


@pytest.fixture(scope="module")
def ranks():
    ckpt = tempfile.mkdtemp(prefix="ddl-hier-ckpt-")
    rings = _ring_cases()
    overlap_runs = {name: _case(*spec) for name, spec in STEP_CASES.items()}
    overlap_runs["save"] = _case(WIRE_I8, "zero1", 2, 1, batches=STEPS[:2],
                            checkpoint=ckpt)
    overlap_runs["resume"] = _case(WIRE_I8, "zero1", 2, 1, batches=STEPS[2:],
                              restore=ckpt)
    overlap_runs["full"] = _case(WIRE_I8, "zero1", 2, 1, batches=STEPS)
    overlap_runs["guard"] = _case(WIRE_I8, "gradient", 1, 1, batches=FAULTED,
                             guard=True, numerics=True, nan_token=NAN_TOKEN)
    out = distributed.run_ranks(
        programs.sequence, N, [("ring_cases", (list(rings.values()),)),
                               ("overlap_cases", (list(overlap_runs.values()),))],
        device="cpu")
    return (rings, {k: [r[0][i] for r in out] for i, k in enumerate(rings)},
            {k: [r[1][i] for r in out] for i, k in enumerate(overlap_runs)})


def test_two_level_reduce_is_the_flat_ring_at_1x4_and_4x1(ranks):
    rings, got, _ = ranks
    for layout, flat in (("h14", "flat_fp32"), ("h41", "flat_int8")):
        for a, b in zip(got[layout], got[flat]):
            np.testing.assert_array_equal(a["owned"], b["owned"])
            if layout == "h41":
                np.testing.assert_array_equal(a["residual"], b["residual"])
    want, _ = ring_spec.ring(list(rings["flat_int8"]["xs"]), "int8_ef",
                             list(rings["flat_int8"]["residuals"]))
    for r, rank in enumerate(got["h41"]):
        np.testing.assert_array_equal(rank["owned"], want[r])


@pytest.mark.parametrize("name", ["h22", "h22_bf16"])
def test_two_level_reduce_bitwise_the_spec_at_2x2(ranks, name):
    rings, got, _ = ranks
    case = rings[name]
    res = case.get("residuals")
    res = None if res is None else list(res)
    for _ in range(case.get("calls", 1)):
        want, res = ring_spec.hier(list(case["xs"]), 2, 2, case["wire_ici"],
                                   case["wire_dcn"], res)
    for r, rank in enumerate(got[name]):
        np.testing.assert_array_equal(rank["owned"], want[r])
        if res is not None:
            np.testing.assert_array_equal(rank["residual"], res[r])
    axes = got[name][0]["by_axis"]
    chunk = case["xs"].shape[1] // N
    width = {"fp32": 4, "bf16": 2}
    calls = case.get("calls", 1)
    assert axes["data"]["payload_bytes"] == \
        calls * (S - 1) * D * chunk * width[case["wire_ici"]]
    dcn = (calls * (D - 1) * (chunk + 4) if case["wire_dcn"] == "int8_ef"
           else calls * (D - 1) * chunk * width[case["wire_dcn"]])
    assert axes["dcn"]["payload_bytes"] == dcn


def _jax_loss_fn():
    jcfg = JaxLlamaConfig(**SMALL)

    def loss_fn(p, b):
        loss = jllama.forward_loss(p, b, jcfg)
        return loss * jnp.where(b[0, 0] == NAN_TOKEN, jnp.nan, 1.0)

    return loss_fn


def _jax_run(batches, *, numerics=False, **kw):
    mesh = jhier_data_mesh(D, S)
    params = jax.tree.map(jnp.asarray, TREE)
    handle = (jintro.make_summarizer(params, psum_axis=("dcn", "data"))
              if numerics else None)
    state, step = jcompress.make_overlap_step(
        _jax_loss_fn(), jadam.fused_adam(LR), mesh, params,
        numerics=handle, **kw)
    prof = jcomm.measure_comm(step, state,
                              jdp.shard_batch(mesh, jnp.asarray(batches[0])))
    losses, fields, steps = [], [], []
    for b in batches:
        state, out = step(state, jdp.shard_batch(mesh, jnp.asarray(b)))
        loss, summary = out if numerics else (out, None)
        losses.append(float(loss))
        steps.append(int(state.step))
        if summary is not None:
            fields.append(handle.event_fields(summary))
    return losses, state, prof, fields, steps


def _leaf_errs(got, want):
    out = []
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        b = np.asarray(b)
        top = np.abs(b).max()
        d = np.abs(a - b)
        out.append((d.max() / top, (d > 1e-5 * top).mean()))
    return out


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_hier_step_matches_jax_at_2x2(ranks, name):
    wire, agg, m, b = STEP_CASES[name]
    losses, state, prof, _, _ = _jax_run(
        STEPS[:3], microbatches=m, wire=wire, aggregation=agg,
        comm_buckets=b)
    reps = ranks[2][name]
    for rank in reps[1:]:
        assert rank["losses"] == reps[0]["losses"]
        for x, y in zip(jax.tree.leaves(rank["params"]),
                        jax.tree.leaves(reps[0]["params"])):
            np.testing.assert_array_equal(x, y)
    errs = _leaf_errs(reps[0]["params"], state.params)
    if wire == {"ici": "fp32", "dcn": "fp32"}:
        np.testing.assert_allclose(reps[0]["losses"], losses, atol=1e-5)
        assert max(e for e, _ in errs) <= 1e-4
    else:
        np.testing.assert_allclose(reps[0]["losses"], losses, atol=1e-4)
        assert max(e for e, _ in errs) <= 2e-3
        assert max(s for _, s in errs) <= 1e-2
    comm = reps[0]["comm"]
    want = prof.by_label()
    assert set(comm["collectives"]) == set(want)
    for label, w in want.items():
        g = comm["collectives"][label]
        assert (g["op"], g["axis"], g["axis_size"], g["calls"],
                g["payload_bytes"], g["wire_bytes_per_device"]) == (
            w["op"], w["axis"], w["axis_size"], w["calls"],
            w["payload_bytes"], w["wire_bytes_per_device"]), label
    for axis, w in prof.by_axis().items():
        g = comm["axes"][axis]
        assert (g["calls"], g["payload_bytes"],
                g["wire_bytes_per_device"]) == (
            w["calls"], w["payload_bytes"], w["wire_bytes_per_device"])


def test_hier_resume_bitwise_with_residuals(ranks):
    drv = ranks[2]
    for full, first, second in zip(drv["full"], drv["save"], drv["resume"]):
        assert first["losses"] + second["losses"] == full["losses"]
        for p, q in zip(second["snapshot"], full["snapshot"]):
            np.testing.assert_array_equal(p, q)


def test_guard_and_numerics_compose_at_2x2(ranks):
    losses, state, _, fields, steps = _jax_run(
        FAULTED, microbatches=1, wire=WIRE_I8, aggregation="gradient",
        guard_nonfinite=True, numerics=True)
    reps = ranks[2]["guard"]
    assert steps == [1, 1, 2]
    for rank in reps:
        assert rank["steps"] == steps
        assert np.isnan(rank["losses"][1]) and np.isnan(losses[1])
        np.testing.assert_allclose(
            [rank["losses"][i] for i in (0, 2)], [losses[0], losses[2]],
            atol=1e-4)
        for x, y in zip(jax.tree.leaves(rank["params"]),
                        jax.tree.leaves(reps[0]["params"])):
            np.testing.assert_array_equal(x, y)
    got = reps[0]["numerics"][1]
    want = fields[1]
    assert got.get("nonfinite_grads") == want.get("nonfinite_grads")
    assert set(got["groups"]) == set(want["groups"])
    for g, vals in want["groups"].items():
        for k, v in vals.items():
            u = got["groups"][g][k]
            assert np.isnan(u) == np.isnan(v), (g, k)
            if not np.isnan(v):
                np.testing.assert_allclose(u, v, rtol=1e-4)
    assert np.isnan(got["grad_norm"]) == np.isnan(want["grad_norm"])


HIER_REFUSED = [
    ({"ici": "fp32"}, (2, 2)),
    ({"ici": "fp32", "dcn": "int8_ef"}, None),
    ({"ici": "int8_ef", "dcn": "int8_ef"}, (2, 2)),
    ({"ici": "fp32", "dcn": "int4"}, (2, 2)),
    ("int8_ef", (2, 2)),
]


@pytest.mark.parametrize("wire,layout", HIER_REFUSED)
def test_hier_validation_errors_equal_jax(wire, layout):
    mesh = (jhier_data_mesh(*layout) if layout is not None
            else make_mesh({"data": 4}))
    with pytest.raises(ValueError) as jerr:
        jcompress.make_overlap_step(_jax_loss_fn(), jadam.fused_adam(LR),
                                    mesh, jax.tree.map(jnp.asarray, TREE),
                                    wire=wire)
    shape = ({"dcn": layout[0], "data": layout[1]} if layout is not None
             else {"data": 4})
    with pytest.raises(ValueError) as err:
        compress.check_wire(wire, "gradient", shape)
    assert str(err.value) == str(jerr.value)


class _Layout:
    shape = {"dcn": 2, "data": 2}


@pytest.mark.parametrize("what", ["make_grad_aggregation_step",
                                  "make_multi_step",
                                  "make_weight_aggregation_step"])
def test_plain_steps_refuse_a_hierarchical_layout_as_jax(what):
    mesh = jhier_data_mesh(D, S)
    with pytest.raises(ValueError) as jerr:
        getattr(jdp, what)(_jax_loss_fn(), jadam.fused_adam(LR), mesh)
    with pytest.raises(ValueError) as err:
        getattr(dp, what)(lambda p, b: None, None, mesh=_Layout())
    assert str(err.value) == str(jerr.value)


def test_hier_wire_refused_at_world_one_and_layout_size_checked():
    with pytest.raises(ValueError, match="needs 4 ranks"):
        distributed.hier_data_mesh(2, 2)
    mesh = distributed.hier_data_mesh(1, 1)
    assert mesh.shape == {"dcn": 1, "data": 1} and (mesh.d, mesh.s) == (0, 0)
    assert dp.slice_index(mesh) == 0 and dp.data_axes(mesh) == ("data",)
