"""The port's compressed and overlapped gradient sync
(``ddl25spring_tpu_torch/parallel/compress.py``) against the JAX package's
``parallel/compress.py`` on the CPU: gloo ranks for the port (one
``run_ranks`` launch per world), the virtual CPU mesh for JAX.

Bars:
- the bucket map's pieces, sizes and offsets equal JAX's, tuple for tuple;
- ``_int8_encode`` bitwise JAX's on numpy inputs; with ``scale_sync_group``
  every rank on the group's largest entry's grid, its ``pmax`` unaccounted;
- ``ring_reduce_scatter`` at n ∈ {2, 3, 4}: bitwise the numpy statement of
  the spec (``parallel/ring_spec.py``) in every wire format, the int8
  residual included, over two calls; bitwise JAX's ring on
  integer-valued inputs in every format (and equal to JAX's
  ``psum_scatter`` there), except the int8 residual's slots written after
  the first hop (n ≥ 3), held within 1e-6 of the sum's largest entry: XLA
  computes the partial it quantizes and the partial it subtracts the
  quantum from in two fusions, one with a fused multiply-add and one
  without, so its own residual parts from its sent value by an ulp of the
  partial there;
  a residual with an fp32 or bf16 wire raises;
- the overlap step from the same weights (``convert.params_from_jax``)
  against JAX's ``make_overlap_step`` over 3 steps: fp32 losses within
  1e-5 and every parameter leaf within 1e-4 of its largest entry
  (measured: 9.5e-7 and 9.1e-6); bf16 and int8_ef losses within 1e-4,
  parameters within 2e-3 of each leaf's largest entry with at most 1% of
  elements beyond 1e-5 of it (measured: 9.5e-7, 1.4e-3 and 0.2%, the
  largest under int8 ZeRO-1, whose parameter delta travels in int8: a
  one-ulp difference upstream can flip a rounding by a whole quantum, and
  the share bounds how many do);
- the replicas bitwise identical in every case; K = 2 windows bitwise
  per-step calls; a save after 2 steps and a resume bitwise the
  uninterrupted 4 steps, residuals included;
- the legacy bf16 and int8 steps: fp32-level against JAX's (losses within
  1e-5, parameters within 1e-4 of each leaf's largest entry), the int8
  residual stack in JAX's ``[n, ...]`` layout within 1% of its largest
  entry (a residual is under half a quantum: it shows the gradients'
  1e-7-level differences at full size, and a flipped rounding would move
  it by a whole quantum);
- every comm profile equal to JAX's static profile per label, byte for
  byte;
- the trainer's composition errors equal to JAX's texts; ``train_llm_dp``
  through the fp32 ring and the legacy int8 step within 1e-5 of JAX's
  losses; a resumed run bitwise the uninterrupted one under the legacy int8
  step and the int8 ring (K=2, M=2, ZeRO-1), residuals included;
- ``ring_overlap_evidence`` positive at M = 2 and at M = 1, B = 16 (the
  head's bucket rings during the layers' backward), negative at M = 1,
  B = 1 and B = 3 (every bucket holds a piece of the layer stack).
"""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl25spring_tpu.config import LlamaConfig as JaxLlamaConfig
from ddl25spring_tpu.config import TrainConfig as JaxTrainConfig
from ddl25spring_tpu.models import llama as jllama
from ddl25spring_tpu.ops import adam as jadam
from ddl25spring_tpu.parallel import compress as jcompress
from ddl25spring_tpu.parallel import dp as jdp
from ddl25spring_tpu.parallel import make_mesh
from ddl25spring_tpu.parallel._compat import shard_map
from ddl25spring_tpu.telemetry import comm as jcomm
from ddl25spring_tpu.tokenizers import ByteTokenizer as JaxByteTokenizer
from ddl25spring_tpu.train import llm as jllm
from jax.sharding import NamedSharding, PartitionSpec as P

from ddl25spring_tpu_torch import convert
from ddl25spring_tpu_torch.config import LlamaConfig, TrainConfig
from ddl25spring_tpu_torch.models import llama
from ddl25spring_tpu_torch.parallel import compress, distributed, programs
from ddl25spring_tpu_torch.parallel import ring_spec
from ddl25spring_tpu_torch.tokenizers import ByteTokenizer
from ddl25spring_tpu_torch.train import llm

torch.set_num_threads(1)

SMALL = dict(vocab_size=64, dmodel=16, num_heads=2, n_layers=2, ctx_size=16)
LR = 3e-3
N, B, T = 2, 4, 16
TREE = jax.tree.map(np.asarray, jllama.init_llama(
    jax.random.PRNGKey(0), JaxLlamaConfig(**SMALL)))
STEPS = np.random.default_rng(1).integers(0, 64, (4, N * B, T))


# ---------------------------------------------------------------- host logic

@pytest.mark.parametrize("buckets", [1, 2, 8])
def test_bucket_map_equals_jax(buckets):
    port_tree = llama.init_llama(LlamaConfig(**SMALL),
                                 torch.Generator().manual_seed(0),
                                 device="cpu").tree()
    for n in (1, 2, 3):
        got = compress.make_bucket_map(port_tree, n, buckets)
        want = jcompress.make_bucket_map(TREE, n, buckets)
        assert tuple(got) == tuple(want)


def test_bucket_map_refuses_what_jax_refuses():
    port_tree = {"w": torch.zeros(4)}
    for n, b in ((1, 0), (2, 3)):
        with pytest.raises(ValueError) as jerr:
            jcompress.make_bucket_map({"w": np.zeros(4)}, n, b)
        with pytest.raises(ValueError) as err:
            compress.make_bucket_map(port_tree, n, b)
        assert str(err.value) == str(jerr.value)


def test_bucket_vectors_round_trip():
    tree = llama.init_llama(LlamaConfig(**SMALL),
                            torch.Generator().manual_seed(0),
                            device="cpu").tree()
    bm = compress.make_bucket_map(tree, 3, 4)
    vecs = compress._bucket_vectors(bm, tree)
    assert [v.numel() for v in vecs] == [3 * s for s in bm.sizes]
    back = compress._scatter_buckets(bm, vecs, tree)
    for a, b in zip(jax.tree.leaves(convert.tree_to_numpy(back)),
                    jax.tree.leaves(convert.tree_to_numpy(tree))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e4])
def test_int8_encode_bitwise_jax(scale):
    x = (np.random.default_rng(3).standard_normal(4099) * scale
         ).astype(np.float32)
    x[7] = 127.5 * x.max() / 127.0                  # a rounding tie region
    q, s, r = compress._int8_encode(torch.from_numpy(x))
    jq, js, jr = jax.jit(jcompress._int8_encode)(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    sq, ss, sr = ring_spec.int8_encode(x)
    np.testing.assert_array_equal(q.numpy(), sq)
    np.testing.assert_array_equal(r.numpy(), sr)


def test_residual_with_a_full_precision_wire_raises():
    group = distributed.data_group()
    for wire in ("fp32", "bf16"):
        with pytest.raises(ValueError, match="int8_ef-only"):
            compress.ring_reduce_scatter(torch.zeros(4), group, wire=wire,
                                         residual=torch.zeros(4))


# ------------------------------------------------------------------ the ring

def _ring_cases(n):
    rng = np.random.default_rng(10 + n)
    L = n * 40
    xs = rng.standard_normal((n, L)).astype(np.float32)
    ints = rng.integers(-1000, 1000, (n, L)).astype(np.float32)
    res = (rng.standard_normal((n, L)) * 1e-2).astype(np.float32)
    cases = {f"{w}": dict(xs=xs, wire=w) for w in ("fp32", "bf16")}
    cases["int8_ef"] = dict(xs=xs, wire="int8_ef", residuals=res, calls=2)
    for w in ("fp32", "bf16"):
        cases[f"int_{w}"] = dict(xs=ints, wire=w)
    cases["int_int8_ef"] = dict(xs=ints, wire="int8_ef",
                                residuals=np.zeros_like(ints))
    cases["encode_synced"] = dict(xs=xs * np.arange(1, n + 1)[:, None]
                                  .astype(np.float32), encode=True)
    return cases


@pytest.fixture(scope="module")
def rings():
    out = {}
    for n in (2, 3, 4):
        cases = _ring_cases(n)
        ranks = distributed.run_ranks(programs.ring_cases, n,
                                      list(cases.values()), device="cpu")
        out[n] = (cases, {name: [r[i] for r in ranks]
                          for i, name in enumerate(cases)})
    return out


def _jax_ring(xs, wire, residual=None):
    n = xs.shape[0]
    mesh = make_mesh({"data": n})

    def f(v, r):
        out, res = jcompress.ring_reduce_scatter(
            v, "data", wire=wire,
            residual=r if wire == "int8_ef" else None)
        return out, (res if res is not None else r)

    g = jax.jit(shard_map(f, mesh=mesh, in_specs=(P("data"), P("data")),
                          out_specs=(P("data"), P("data")),
                          check_vma=False))
    put = lambda a: jax.device_put(jnp.asarray(a.reshape(-1)),  # noqa: E731
                                   NamedSharding(mesh, P("data")))
    res = residual if residual is not None else np.zeros_like(xs)
    out, r = g(put(xs), put(res))
    return np.asarray(out).reshape(n, -1), np.asarray(r).reshape(n, -1)


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("wire", ["fp32", "bf16", "int8_ef"])
def test_ring_bitwise_the_spec(rings, n, wire):
    cases, got = rings[n]
    case = cases[wire]
    res = case.get("residuals")
    res = None if res is None else list(res)
    for _ in range(case.get("calls", 1)):
        want, res = ring_spec.ring(list(case["xs"]), wire, res)
    for r, rank in enumerate(got[wire]):
        np.testing.assert_array_equal(rank["owned"], want[r])
        if res is not None:
            np.testing.assert_array_equal(rank["residual"], res[r])
    chunk = case["xs"].shape[1] // n
    labels = rank["by_label"]
    if wire == "int8_ef":
        assert labels["ring_grad_int8"]["payload_bytes"] == 2 * (n - 1) * chunk
        assert labels["ring_grad_scale"]["payload_bytes"] == 2 * (n - 1) * 4
    else:
        key = "ring_grad_f32" if wire == "fp32" else "ring_grad_bf16"
        width = 4 if wire == "fp32" else 2
        assert labels[key]["payload_bytes"] == (n - 1) * chunk * width
        assert labels[key]["calls"] == n - 1


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("wire", ["fp32", "bf16", "int8_ef"])
def test_ring_bitwise_jax_on_integer_values(rings, n, wire):
    cases, got = rings[n]
    case = cases[f"int_{wire}"]
    want, wres = _jax_ring(case["xs"], wire, case.get("residuals"))
    for r, rank in enumerate(got[f"int_{wire}"]):
        np.testing.assert_array_equal(rank["owned"], want[r])
        if wire == "int8_ef" and n == 2:
            np.testing.assert_array_equal(rank["residual"], wres[r])
        elif wire == "int8_ef":
            top = np.abs(case["xs"]).sum(axis=0).max()
            np.testing.assert_allclose(rank["residual"], wres[r],
                                       rtol=0, atol=1e-6 * top)
    if wire == "fp32":
        mesh = make_mesh({"data": n})
        scat = jax.jit(shard_map(
            lambda v: jax.lax.psum_scatter(v, "data", scatter_dimension=0,
                                           tiled=True),
            mesh=mesh, in_specs=P("data"), out_specs=P("data"),
            check_vma=False))
        ref = np.asarray(scat(jax.device_put(
            jnp.asarray(case["xs"].reshape(-1)),
            NamedSharding(mesh, P("data"))))).reshape(n, -1)
        for r, rank in enumerate(got["int_fp32"]):
            np.testing.assert_array_equal(rank["owned"], ref[r])


@pytest.mark.parametrize("n", [2, 3, 4])
def test_int8_encode_scale_sync_takes_the_group_max_unaccounted(rings, n):
    """``scale_sync_group``: every rank quantizes on the grid of the
    group's largest entry (rank n's here), and the 4-byte ``pmax`` leaves
    no comm record."""
    cases, got = rings[n]
    xs = cases["encode_synced"]["xs"]
    s = np.maximum(np.float32(np.abs(xs).max()) / np.float32(127.0),
                   ring_spec.TINY).astype(np.float32)
    for r, rank in enumerate(got["encode_synced"]):
        q = np.clip(np.rint(xs[r] / s), -127, 127).astype(np.int8)
        assert rank["scale"] == float(s)
        np.testing.assert_array_equal(rank["owned"], q)
        np.testing.assert_array_equal(rank["residual"],
                                      ring_spec.fma(xs[r], -s, q))
        assert rank["by_label"] == {}


# ------------------------------------------------------- the overlap step

GRID = {
    # name: (wire, aggregation, microbatches, comm_buckets)
    "f32_g_m1_b1": ("fp32", "gradient", 1, 1),
    "f32_g_m2_b1": ("fp32", "gradient", 2, 1),
    "f32_g_m1_b3": ("fp32", "gradient", 1, 3),
    "f32_g_m2_b3": ("fp32", "gradient", 2, 3),
    "f32_z_m1_b1": ("fp32", "zero1", 1, 1),
    "f32_z_m2_b1": ("fp32", "zero1", 2, 1),
    "f32_z_m1_b3": ("fp32", "zero1", 1, 3),
    "f32_z_m2_b3": ("fp32", "zero1", 2, 3),
    "bf16_g_m2_b1": ("bf16", "gradient", 2, 1),
    "bf16_z_m1_b3": ("bf16", "zero1", 1, 3),
    "i8_g_m1_b1": ("int8_ef", "gradient", 1, 1),
    "i8_g_m2_b3": ("int8_ef", "gradient", 2, 3),
    "i8_z_m1_b1": ("int8_ef", "zero1", 1, 1),
    "i8_z_m2_b3": ("int8_ef", "zero1", 2, 3),
}
WINDOWS = STEPS.reshape(2, 2, N * B, T)


def _case(wire, agg, m, b, **kw):
    return dict(dict(cfg=SMALL, params=TREE, lr=LR, optimizer="fused",
                     wire=wire, aggregation=agg, microbatches=m,
                     comm_buckets=b, batches=STEPS[:3]), **kw)


@pytest.fixture(scope="module")
def overlap_runs():
    ckpt = tempfile.mkdtemp(prefix="ddl-compress-ckpt-")
    cases = {name: _case(*spec) for name, spec in GRID.items()}
    cases["i8_z_m2_b2_per_step"] = _case("int8_ef", "zero1", 2, 2,
                                         batches=STEPS)
    cases["i8_z_m2_b2_multi"] = _case("int8_ef", "zero1", 2, 2,
                                      batches=WINDOWS, multi=True)
    cases["i8_g_save"] = _case("int8_ef", "gradient", 2, 1,
                               batches=STEPS[:2], checkpoint=ckpt + "/g")
    cases["i8_g_resume"] = _case("int8_ef", "gradient", 2, 1,
                                 batches=STEPS[2:], restore=ckpt + "/g")
    cases["i8_g_full"] = _case("int8_ef", "gradient", 2, 1, batches=STEPS)
    cases["i8_z_b2_save"] = _case("int8_ef", "zero1", 1, 2,
                                  batches=STEPS[:2], checkpoint=ckpt + "/z")
    cases["i8_z_b2_resume"] = _case("int8_ef", "zero1", 1, 2,
                                    batches=STEPS[2:], restore=ckpt + "/z")
    cases["i8_z_b2_full"] = _case("int8_ef", "zero1", 1, 2, batches=STEPS)
    cases["evidence_m2"] = _case("fp32", "gradient", 2, 1,
                                 batches=STEPS[:1], evidence=True)
    cases["evidence_m1"] = _case("fp32", "gradient", 1, 1,
                                 batches=STEPS[:1], evidence=True)
    cases["evidence_m1_b3"] = _case("int8_ef", "zero1", 1, 3,
                                    batches=STEPS[:1], evidence=True)
    cases["evidence_m1_b16"] = _case("int8_ef", "zero1", 1, 16,
                                     batches=STEPS[:1], evidence=True)
    cases["legacy_bf16"] = _case(None, None, 1, 1, legacy="bf16")
    cases["legacy_int8"] = _case(None, None, 1, 1, legacy="int8_ef")
    ranks = distributed.run_ranks(programs.overlap_cases, N,
                                  list(cases.values()), device="cpu")
    return {name: [r[i] for r in ranks] for i, name in enumerate(cases)}


def _jax_loss_fn():
    jcfg = JaxLlamaConfig(**SMALL)
    return lambda p, b: jllama.forward_loss(p, b, jcfg)


def _jax_run(make, batches, **kw):
    mesh = make_mesh({"data": N})
    params = jax.tree.map(jnp.asarray, TREE)
    opt = jadam.fused_adam(LR)
    if make == "bf16":
        state = jdp.replicate(mesh, jdp.init_state(params, opt))
        step = jcompress.make_bf16_grad_step(_jax_loss_fn(), opt, mesh)
    elif make == "int8_ef":
        state = jcompress.init_ef_state(mesh, params, opt)
        step = jcompress.make_int8_ef_grad_step(_jax_loss_fn(), opt, mesh)
    else:
        state, step = jcompress.make_overlap_step(_jax_loss_fn(), opt, mesh,
                                                  params, **kw)
    prof = jcomm.measure_comm(step, state,
                              jdp.shard_batch(mesh, jnp.asarray(batches[0])))
    losses = []
    for b in batches:
        state, loss = step(state, jdp.shard_batch(mesh, jnp.asarray(b)))
        losses.append(float(loss))
    return losses, state, prof


def _leaf_errs(got, want):
    """Per leaf: (max |d| / max |want|, share of elements beyond 1e-5 of
    the leaf's largest entry)."""
    out = []
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        b = np.asarray(b)
        top = np.abs(b).max()
        d = np.abs(a - b)
        out.append((d.max() / top, (d > 1e-5 * top).mean()))
    return out


def _hold_comm(port_comm, jprof):
    want = jprof.by_label()
    got = port_comm["collectives"]
    assert set(got) == set(want)
    for label, w in want.items():
        g = got[label]
        assert (g["op"], g["axis"], g["axis_size"], g["calls"],
                g["payload_bytes"]) == (w["op"], w["axis"], w["axis_size"],
                                        w["calls"], w["payload_bytes"]), label
        assert g["wire_bytes_per_device"] == w["wire_bytes_per_device"]


@pytest.mark.parametrize("name", list(GRID))
def test_overlap_step_matches_jax(overlap_runs, name):
    wire, agg, m, b = GRID[name]
    losses, state, prof = _jax_run(None, STEPS[:3], microbatches=m,
                                   wire=wire, aggregation=agg,
                                   comm_buckets=b)
    r0, r1 = overlap_runs[name]
    for x, y in zip(jax.tree.leaves(r0["params"]),
                    jax.tree.leaves(r1["params"])):
        np.testing.assert_array_equal(x, y)           # replicas bitwise
    assert r0["losses"] == r1["losses"]
    assert r0["steps"] == [1, 2, 3]
    errs = _leaf_errs(r0["params"], state.params)
    if wire == "fp32":
        np.testing.assert_allclose(r0["losses"], losses, atol=1e-5)
        assert max(e for e, _ in errs) <= 1e-4
    else:
        np.testing.assert_allclose(r0["losses"], losses, atol=1e-4)
        assert max(e for e, _ in errs) <= 2e-3
        assert max(s for _, s in errs) <= 1e-2
    _hold_comm(r0["comm"], prof)


def test_overlap_multi_step_bitwise_per_step(overlap_runs):
    a, k = overlap_runs["i8_z_m2_b2_per_step"], overlap_runs["i8_z_m2_b2_multi"]
    for x, y in zip(a, k):
        assert x["losses"] == y["losses"]
        for p, q in zip(jax.tree.leaves(x["params"]),
                        jax.tree.leaves(y["params"])):
            np.testing.assert_array_equal(p, q)
        for p, q in zip(x["snapshot"], y["snapshot"]):
            np.testing.assert_array_equal(p, q)


@pytest.mark.parametrize("prefix", ["i8_g", "i8_z_b2"])
def test_preempt_and_resume_bitwise_with_residuals(overlap_runs, prefix):
    full = overlap_runs[f"{prefix}_full"][0]
    first = overlap_runs[f"{prefix}_save"][0]
    second = overlap_runs[f"{prefix}_resume"][0]
    assert first["losses"] + second["losses"] == full["losses"]
    assert second["steps"] == [3, 4]
    for p, q in zip(second["snapshot"], full["snapshot"]):
        np.testing.assert_array_equal(p, q)
    # The residuals are real state: a zeroed one would not reproduce this.
    assert any(np.abs(x).max() > 0 for x in full["snapshot"][-2:]
               if isinstance(x, np.ndarray))


def test_overlap_evidence_positive_at_m2_negative_at_m1(overlap_runs):
    pos = overlap_runs["evidence_m2"][0]["evidence"]
    neg = overlap_runs["evidence_m1"][0]["evidence"]
    assert pos["first_hop_independent"] and pos["overlap_fraction"] == 0.5
    assert pos["n_ring_hops"] == 2
    assert not neg["first_hop_independent"]
    assert neg["overlap_fraction"] == 0.0 and neg["n_ring_hops"] == 1
    # Buckets at M = 1: at this size every one of 3 buckets holds a piece
    # of the layer stack, so each waits for the layers' backward; of 16,
    # the first holds only the head and rings during it.
    b3 = overlap_runs["evidence_m1_b3"][0]["evidence"]
    assert b3["n_ring_hops"] == 6 and b3["independent_hops"] == 0
    b16 = overlap_runs["evidence_m1_b16"][0]["evidence"]
    assert b16["n_ring_hops"] == 32 and b16["first_hop_independent"]
    assert 0 < b16["overlap_fraction"] < 1


@pytest.mark.parametrize("legacy", ["bf16", "int8_ef"])
def test_legacy_steps_match_jax(overlap_runs, legacy):
    losses, state, prof = _jax_run(legacy, STEPS[:3])
    r0, r1 = overlap_runs["legacy_bf16" if legacy == "bf16" else "legacy_int8"]
    assert r0["losses"] == r1["losses"]
    np.testing.assert_allclose(r0["losses"], losses, atol=1e-5)
    assert max(e for e, _ in _leaf_errs(r0["params"], state.params)) <= 1e-4
    _hold_comm(r0["comm"], prof)
    if legacy == "int8_ef":
        # The residual stack [n, ...] per leaf, in JAX's layout.
        want = jax.tree.leaves(state.residual)
        got = r0["snapshot"][-len(want):]
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, atol=1e-2 * np.abs(w).max())


# ------------------------------------------------------------ the trainer

MCFG = dict(dmodel=16, num_heads=2, n_layers=2, ctx_size=16)
TBASE = dict(batch_size=2, seq_len=16, iters=4, lr=3e-3, data=2,
             optimizer="fused")
REFUSED = [
    (dict(overlap_microbatches=-1), "gradient"),
    (dict(comm_buckets=0), "gradient"),
    (dict(comm_buckets=2), "gradient"),
    (dict(wire_dcn="int8_ef"), "gradient"),
    (dict(dcn=2), "gradient"),
    (dict(overlap_microbatches=2, wire="bf16"), "weight"),
    (dict(overlap_microbatches=2, accum_steps=2), "gradient"),
    (dict(wire="bf16"), "zero1"),
    (dict(wire="int8_ef", steps_per_dispatch=2), "gradient"),
    (dict(wire="int8_ef", accum_steps=2), "gradient"),
    (dict(wire="int8", overlap_microbatches=0), "gradient"),
    (dict(wire="bf16", numerics_every=1), "gradient"),
]


@pytest.mark.parametrize("tcfg,aggregation", REFUSED)
def test_trainer_composition_errors_equal_jax(tcfg, aggregation):
    with pytest.raises(ValueError) as jerr:
        jllm.train_llm_dp(JaxLlamaConfig(**MCFG),
                          JaxTrainConfig(**TBASE, **tcfg),
                          tokenizer=JaxByteTokenizer(),
                          aggregation=aggregation, log_every=0)
    with pytest.raises(ValueError) as err:
        llm.train_llm_dp(LlamaConfig(**MCFG), TrainConfig(**TBASE, **tcfg),
                         tokenizer=ByteTokenizer(), aggregation=aggregation,
                         log_every=0, device="cpu")
    assert str(err.value) == str(jerr.value)


@pytest.fixture(scope="module")
def trainers():
    """One two-rank launch of every ``train_llm_dp`` call below: the fp32
    ring at M=1, bf16 ZeRO-1 at M=2 per step and at K=2, the legacy int8
    step, and the legacy int8 step and int8 ZeRO-1 at M=2, K=2 each
    uninterrupted for 6 steps and as 3 (4) steps saved and resumed."""
    d = tempfile.mkdtemp(prefix="ddl-compress-trainer-")
    legacy = dict(TBASE, wire="int8_ef")
    ring = dict(TBASE, wire="int8_ef", overlap_microbatches=2,
                steps_per_dispatch=2)
    z1 = dict(aggregation="zero1")
    calls = [
        (MCFG, dict(TBASE, overlap_microbatches=1), {}),
        (MCFG, dict(TBASE, wire="bf16", overlap_microbatches=2), z1),
        (MCFG, dict(TBASE, wire="bf16", overlap_microbatches=2,
                    steps_per_dispatch=2), z1),
        (MCFG, legacy, {}),
        (MCFG, dict(legacy, iters=6), {}),
        (MCFG, dict(legacy, iters=3),
         dict(checkpoint_dir=d + "/l", checkpoint_every=100)),
        (MCFG, dict(legacy, iters=6),
         dict(checkpoint_dir=d + "/l", checkpoint_every=100)),
        (MCFG, dict(ring, iters=6), z1),
        (MCFG, dict(ring, iters=4),
         dict(z1, checkpoint_dir=d + "/r", checkpoint_every=100)),
        (MCFG, dict(ring, iters=6),
         dict(z1, checkpoint_dir=d + "/r", checkpoint_every=100)),
    ]
    got = distributed.run_ranks(programs.trainer_calls, 2, calls,
                                device="cpu")[0]
    return calls, got


def test_trainer_ring_matches_jax_and_composes(trainers, monkeypatch):
    """``train_llm_dp`` at ``data=2`` through the ring step: fp32 at M=1
    within 1e-5 of JAX's losses from the port's initial weights; bf16 zero1
    M=2 at K=2 bitwise its own K=1 run; the legacy int8 step's losses
    within 1e-5 of JAX's."""
    calls, got = trainers
    mesh = make_mesh({"data": 2})
    tree = convert.tree_to_numpy(llama.init_llama(
        LlamaConfig(**MCFG, vocab_size=259), torch.Generator().manual_seed(0),
        device="cpu").tree())
    monkeypatch.setattr(jllm.llama, "init_llama",
                        lambda key, cfg: jax.tree.map(jnp.asarray, tree))
    for (mc, tc, kw), rep in zip([calls[0], calls[3]], [got[0], got[3]]):
        want = jllm.train_llm_dp(JaxLlamaConfig(**mc), JaxTrainConfig(**tc),
                                 tokenizer=JaxByteTokenizer(), mesh=mesh,
                                 log_every=0, **kw)
        np.testing.assert_allclose(rep["losses"], want.losses, atol=1e-5)
    assert got[1]["losses"] == got[2]["losses"]
    assert all(np.isfinite(got[1]["losses"]))


@pytest.mark.parametrize("first", [4, 7], ids=["legacy_int8", "ring_int8"])
def test_trainer_resume_keeps_error_feedback_bitwise(trainers, first):
    """A resumed run walks the uninterrupted trajectory bitwise only if
    both ranks' residuals come back from the checkpoint exactly (a zeroed
    residual shifts every loss after the resume)."""
    _, got = trainers
    full, a, b = got[first], got[first + 1], got[first + 2]
    assert b["start_step"] == len(a["losses"])
    assert a["losses"] + b["losses"] == full["losses"]
