"""The port's fleet engine (``ddl25spring_tpu_torch.fl.fleet``) against the
JAX package's ``fl/fleet.py`` on the CPU, at ``tests/test_fleet.py``'s
size (40 synthetic clients, 12 per round, the linear model).

Held, with the tolerance at each check:

- ``SyntheticFleetSource``: the same bytes as JAX's per (seed, client id)
  and for ``test_set``;
- the validation errors: JAX's messages, in JAX's order;
- the streamed round against the port's ``vmapped_round_reference`` at a
  ragged width, and against ``FedAvgGradServer``: bitwise, at one thread
  (MKL's results depend on buffer alignment with several);
- E=1 bitwise the flat round, E=3 within 1e-6 of it (the edges
  re-associate the weighted sum);
- the port against the JAX fleet from the same weights and the same
  sampled clients: flat, E=2 and a server-tier defense within 1e-4 of each
  leaf's largest entry after 2 rounds; the MNIST CNN's flat round too;
- secure aggregation: within one quantum of JAX's round, and bitwise the
  port's ``SecureAggFedAvgServer`` at E=1;
- DP at the edge with z=0: within 1e-4 of JAX's;
- the edge Multi-Krum: the selection equal to ``FedAvgGradServer(
  defense=multi_krum)``'s;
- telemetry: ``fl_cohort`` / ``fl_tier`` payload bytes equal to JAX's, the
  events valid under the JAX package's ``validate_event``, the span tree
  complete with no server-tier span at E=1, and no retrace.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl25spring_tpu import fl as jfl
from ddl25spring_tpu.config import FLConfig as JFLConfig
from ddl25spring_tpu.fl import defenses as jdef
from ddl25spring_tpu.fl.federated_data import (
    FederatedDataset as JFederatedDataset)
from ddl25spring_tpu.models import mnist_cnn as jcnn
from ddl25spring_tpu.telemetry import Telemetry as JTelemetry
from ddl25spring_tpu.telemetry.events import read_events, validate_event
from ddl25spring_tpu.telemetry.trace import trace_trees, tree_check
from ddl25spring_tpu_torch import convert
from ddl25spring_tpu_torch.config import FLConfig
from ddl25spring_tpu_torch.fl import (FederatedArraySource, FedAvgGradServer,
                                      FleetConfig, FleetFedAvgServer,
                                      SecureAggFedAvgServer,
                                      SyntheticFleetSource, TierPolicy,
                                      vmapped_round_reference)
from ddl25spring_tpu_torch.fl import defenses
from ddl25spring_tpu_torch.fl.federated_data import FederatedDataset
from ddl25spring_tpu_torch.fl.secure_agg import secagg_scale
from ddl25spring_tpu_torch.models import mnist_cnn
from ddl25spring_tpu_torch.telemetry import Telemetry

torch.set_num_threads(1)

CFG = dict(nr_clients=40, client_fraction=0.3, batch_size=3, epochs=2,
           lr=0.1, rounds=2, seed=7)
# The two rounds' sampled clients, fixed on both sides for the
# cross-framework checks (the samplers' streams differ by construction).
FIXED = [np.array([3, 17, 0, 22, 9, 31, 14, 5, 38, 26, 11, 20]),
         np.array([1, 8, 33, 12, 27, 4, 39, 16, 23, 6, 35, 19])]
TOL_JAX = 1e-4
TOL_EDGES = 1e-6
CLIP, BITS = 5.0, 20


def apply_fn(p, x):
    return x @ p["w"] + p["b"]


def japply_fn(p, x, key=None):
    return x @ p["w"] + p["b"]


@pytest.fixture(scope="module")
def setup():
    src = SyntheticFleetSource(40, samples_per_client=6, features=8,
                               classes=4, seed=3)
    xt, yt = src.test_set(64)
    g = np.random.default_rng(0)
    w0 = {"w": (0.1 * g.normal(size=(8, 4))).astype(np.float32),
          "b": np.zeros(4, np.float32)}
    params = {k: torch.from_numpy(v.copy()) for k, v in w0.items()}
    xs, ys, ms = src.cohort(np.arange(40))
    counts = src.counts(np.arange(40))
    data = FederatedDataset(torch.from_numpy(xs),
                            torch.from_numpy(ys.astype(np.int64)),
                            torch.from_numpy(ms),
                            torch.from_numpy(counts.astype(np.int64)))
    jdata = JFederatedDataset(jnp.asarray(xs), jnp.asarray(ys),
                              jnp.asarray(ms), jnp.asarray(counts))
    return dict(src=src, jsrc=jfl.SyntheticFleetSource(
        40, samples_per_client=6, features=8, classes=4, seed=3),
        xt=xt, yt=yt, w0=w0, params=params, data=data, jdata=jdata)


def _fleet(s, fleet, **kw):
    return FleetFedAvgServer(s["params"], apply_fn, s["src"], s["xt"],
                             s["yt"], FLConfig(**CFG), fleet, device="cpu",
                             **kw)


def _jfleet(s, fleet, **kw):
    return jfl.FleetFedAvgServer(
        {k: jnp.asarray(v) for k, v in s["w0"].items()}, japply_fn,
        s["jsrc"], s["xt"], s["yt"], JFLConfig(**CFG), fleet, **kw)


def _fixed(server):
    server._sample = lambda r: FIXED[r]
    return server


def _eq(a, b):
    return all(bool(torch.equal(a[k], b[k])) for k in a)


def _rel(a, b):
    """Largest |a − b| per leaf over that leaf's largest |b|; b may be a
    JAX tree."""
    out = 0.0
    for k in a:
        x = a[k].detach().numpy().astype(np.float64)
        y = np.asarray(b[k], np.float64)
        out = max(out, float(np.abs(x - y).max()
                             / max(np.abs(y).max(), 1e-30)))
    return out


# ------------------------------------------------------------ the sources

@pytest.mark.parametrize("seed,ids", [(3, [0, 5, 39]), (0, [7, 99_999, 12]),
                                      (11, [1, 2, 3, 4])])
def test_synthetic_source_bytes_equal_jax(seed, ids):
    kw = dict(samples_per_client=5, features=7, classes=6, seed=seed)
    port = SyntheticFleetSource(100_000, **kw)
    ref = jfl.SyntheticFleetSource(100_000, **kw)
    idx = np.asarray(ids)
    for a, b in zip(port.cohort(idx), ref.cohort(idx)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    np.testing.assert_array_equal(port.counts(idx), ref.counts(idx))
    for a, b in zip(port.test_set(33, seed=2), ref.test_set(33, seed=2)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_array_source_wraps_federated_dataset(setup):
    """``FederatedArraySource`` over the same clients gives the round
    bitwise."""
    s = setup
    a = _fleet(s, FleetConfig(cohort_width=4))
    b = FleetFedAvgServer(s["params"], apply_fn,
                          FederatedArraySource(s["data"]), s["xt"], s["yt"],
                          FLConfig(**CFG), FleetConfig(cohort_width=4),
                          device="cpu")
    assert _eq(a._round(a.params, 0), b._round(b.params, 0))


# ------------------------------------------------------------ validation

BAD = [
    dict(edge=TierPolicy(secure_agg=(5.0, 20))),
    dict(weighting="uniform", edge=TierPolicy(dp_noise_multiplier=1.0)),
    dict(weighting="uniform", server=TierPolicy(secure_agg=(5.0, 20))),
    dict(weighting="uniform", edge=TierPolicy(
        defense="krum", dp_clip=1.0, dp_noise_multiplier=1.0)),
    dict(cohort_width=0),
    dict(edges=6),
    dict(weighting="median"),
    dict(weighting="uniform", edge=TierPolicy(secure_agg=(5.0, 20),
                                              dp_clip=1.0)),
]


@pytest.mark.parametrize("kw", BAD, ids=range(len(BAD)))
def test_validation_errors_match_jax(kw):
    src = SyntheticFleetSource(10, samples_per_client=2, features=4,
                               classes=2, seed=0)
    xt, yt = src.test_set(8)
    cfg = dict(nr_clients=10, client_fraction=0.5, seed=0)

    def jax_kw(k):
        return {n: (jfl.TierPolicy(defense=v.defense, dp_clip=v.dp_clip,
                                   dp_noise_multiplier=v.dp_noise_multiplier,
                                   secure_agg=v.secure_agg)
                    if isinstance(v, TierPolicy) else v)
                for n, v in k.items()}

    with pytest.raises(ValueError) as want:
        jfl.FleetFedAvgServer({"w": jnp.zeros((4, 2)), "b": jnp.zeros(2)},
                              japply_fn, src, xt, yt, JFLConfig(**cfg),
                              jfl.FleetConfig(**jax_kw(kw)))
    with pytest.raises(ValueError) as got:
        FleetFedAvgServer({"w": torch.zeros(4, 2), "b": torch.zeros(2)},
                          apply_fn, src, xt, yt, FLConfig(**cfg),
                          FleetConfig(**kw), device="cpu")
    assert str(got.value) == str(want.value)


# ------------------------------------------- streamed against vmapped

@pytest.mark.parametrize("width", [1, 5, 12])
def test_streamed_round_is_the_vmapped_reference_bitwise(setup, width):
    """12 clients at widths 1, 5 (5 + 5 + 2, a padded last cohort) and 12:
    bitwise the all-at-once reference at one CPU thread."""
    s = setup
    f = _fleet(s, FleetConfig(cohort_width=width))
    idx = f._sample(0)
    ref = vmapped_round_reference(s["params"], apply_fn, s["src"], idx,
                                  FLConfig(**CFG), 0, device="cpu")
    assert _eq(f._round(f.params, 0), ref)


def test_streamed_round_is_fedavg_grad_server_bitwise(setup):
    s = setup
    f = _fleet(s, FleetConfig(cohort_width=4))
    srv = FedAvgGradServer(s["params"], apply_fn, s["data"], s["xt"],
                           s["yt"], FLConfig(**CFG), device="cpu")
    assert _eq(f._round(f.params, 0), srv._round(srv.params, 0))


def test_edges_one_is_flat_bitwise_and_three_within_tolerance(setup):
    s = setup
    flat = _fleet(s, FleetConfig(cohort_width=4))._round(s["params"], 0)
    one = _fleet(s, FleetConfig(cohort_width=4, edges=1))
    ref = vmapped_round_reference(s["params"], apply_fn, s["src"],
                                  one._sample(0), FLConfig(**CFG), 0,
                                  device="cpu")
    assert _eq(one._round(s["params"], 0), ref) and _eq(flat, ref)
    three = _fleet(s, FleetConfig(cohort_width=4, edges=3))
    got = three._round(s["params"], 0)
    assert max(float((got[k] - flat[k]).abs().max()) for k in got) \
        <= TOL_EDGES


# --------------------------------------------------- against the JAX fleet

def _two_rounds(s, port_fleet, jax_fleet):
    p = _fixed(_fleet(s, port_fleet))
    j = _fixed(_jfleet(s, jax_fleet))
    p.run(2)
    j.run(2)
    return p.params, j.params


@pytest.mark.parametrize("case", ["flat", "edges2", "server_median"])
def test_port_matches_jax_fleet_after_two_rounds(setup, case):
    s = setup
    if case == "flat":
        pf, jf = FleetConfig(cohort_width=5), jfl.FleetConfig(cohort_width=5)
    elif case == "edges2":
        pf = FleetConfig(cohort_width=4, edges=2)
        jf = jfl.FleetConfig(cohort_width=4, edges=2)
    else:
        pf = FleetConfig(cohort_width=4, edges=3, server=TierPolicy(
            defense=defenses.coordinate_defense(
                defenses.coordinate_median)))
        jf = jfl.FleetConfig(cohort_width=4, edges=3, server=jfl.TierPolicy(
            defense=jdef.coordinate_defense(jdef.coordinate_median)))
    got, want = _two_rounds(s, pf, jf)
    assert _rel(got, want) <= TOL_JAX


def test_cnn_flat_round_matches_jax_fleet():
    """The MNIST CNN through both fleets, one round of 4 clients at width 3
    (3 + 1), dropout off, weights from the JAX init
    (``convert.mnist_params_from_jax``)."""
    g = np.random.default_rng(1)
    n, spc = 6, 10
    x = g.normal(size=(n, spc, 1, 28, 28)).astype(np.float32)
    y = g.integers(0, 10, (n, spc))
    m = np.ones((n, spc), np.float32)
    c = np.full(n, spc)
    jp = jax.tree.map(np.asarray, jcnn.init(jax.random.key(0)))
    cfg = dict(nr_clients=n, client_fraction=0.67, batch_size=5, epochs=1,
               lr=0.05, seed=2)
    xt, yt = x[0], y[0]
    port = FleetFedAvgServer(
        convert.mnist_params_from_jax(jp, device="cpu"),
        lambda p, xx: mnist_cnn.apply(p, xx),
        FederatedArraySource(FederatedDataset(*(torch.from_numpy(a) for a in
                                                (x, y, m, c)))),
        xt, yt, FLConfig(**cfg), FleetConfig(cohort_width=3), device="cpu")
    jax_s = jfl.FleetFedAvgServer(
        jax.tree.map(jnp.asarray, jp), lambda p, xx, key=None: jcnn.apply(
            p, xx), jfl.FederatedArraySource(JFederatedDataset(
                jnp.asarray(x), jnp.asarray(y.astype(np.int32)),
                jnp.asarray(m), jnp.asarray(c.astype(np.int32)))),
        xt, yt.astype(np.int32), JFLConfig(**cfg),
        jfl.FleetConfig(cohort_width=3))
    fixed = np.array([4, 1, 5, 2])
    port._sample = jax_s._sample = lambda r: fixed
    got = port._round(port.params, 0)
    want = jax_s._round(jax_s.params, 0)
    for k in ("conv1", "conv2", "fc1", "fc2"):
        for leaf in ("w", "b"):
            a = got[k][leaf].numpy()
            b = np.asarray(want[k][leaf])
            assert np.abs(a - b).max() <= TOL_JAX * np.abs(b).max()


# ------------------------------------------------------------ the tiers

def test_secure_agg_edge_within_a_quantum_of_jax_and_bitwise_its_server(
        setup):
    s = setup
    pol = dict(weighting="uniform")
    port = _fixed(_fleet(s, FleetConfig(
        cohort_width=4, edge=TierPolicy(secure_agg=(CLIP, BITS)), **pol)))
    got = port._round(port.params, 0)
    j = _fixed(_jfleet(s, jfl.FleetConfig(
        cohort_width=4, edge=jfl.TierPolicy(secure_agg=(CLIP, BITS)), **pol)))
    want = j._round(j.params, 0)
    quantum = secagg_scale(CLIP, BITS)
    for k in got:
        assert np.abs(got[k].numpy() - np.asarray(want[k])).max() \
            <= quantum * (1 + 1e-3)
    srv = _fixed(SecureAggFedAvgServer(s["params"], apply_fn, s["data"],
                                       s["xt"], s["yt"], FLConfig(**CFG),
                                       clip_norm=CLIP, bits=BITS,
                                       device="cpu"))
    assert _eq(got, srv._round(srv.params, 0))


def test_secure_agg_two_edges_matches_jax_within_a_quantum(setup):
    s = setup
    kw = dict(cohort_width=4, edges=2, weighting="uniform")
    port = _fixed(_fleet(s, FleetConfig(
        edge=TierPolicy(secure_agg=(CLIP, BITS)), **kw)))
    j = _fixed(_jfleet(s, jfl.FleetConfig(
        edge=jfl.TierPolicy(secure_agg=(CLIP, BITS)), **kw)))
    got, want = port._round(port.params, 0), j._round(j.params, 0)
    quantum = secagg_scale(CLIP, BITS)
    for k in got:
        assert np.abs(got[k].numpy() - np.asarray(want[k])).max() \
            <= quantum * (1 + 1e-3)


@pytest.mark.parametrize("edges", [1, 2])
def test_dp_edge_at_z0_matches_jax(setup, edges):
    s = setup
    port = _fixed(_fleet(s, FleetConfig(
        cohort_width=4, edges=edges, weighting="uniform",
        edge=TierPolicy(dp_clip=0.05))))
    j = _fixed(_jfleet(s, jfl.FleetConfig(
        cohort_width=4, edges=edges, weighting="uniform",
        edge=jfl.TierPolicy(dp_clip=0.05))))
    assert _rel(port._round(port.params, 0), j._round(j.params, 0)) \
        <= TOL_JAX


def test_dp_noise_is_seeded_and_distinct_per_tier_and_edge(setup):
    s = setup

    def run(**kw):
        f = _fleet(s, FleetConfig(cohort_width=4, weighting="uniform", **kw))
        return f._round(s["params"], 0)

    clean = run(edge=TierPolicy(dp_clip=1.0))
    a = run(edge=TierPolicy(dp_clip=1.0, dp_noise_multiplier=1.0))
    b = run(edge=TierPolicy(dp_clip=1.0, dp_noise_multiplier=1.0))
    c = run(edge=TierPolicy(dp_clip=1.0),
            server=TierPolicy(dp_clip=10.0, dp_noise_multiplier=1.0))
    assert _eq(a, b) and not _eq(a, clean) and not _eq(c, a)
    f = _fleet(s, FleetConfig(cohort_width=4, weighting="uniform"))
    seeds = {f._noise_generator(r, t, e).initial_seed()
             for r, t, e in ((0, 0, 0), (0, 0, 1), (0, 1, 0), (1, 0, 0))}
    assert len(seeds) == 4


def test_edge_multi_krum_selection_equals_fedavg_grad_server(setup):
    s = setup
    picks = {"fleet": [], "server": []}

    def recording(into):
        def rule(flat, n_malicious, k):
            sel = defenses.multi_krum(flat, n_malicious, k)
            picks[into].append(sorted(int(i) for i in sel))
            return sel
        return defenses.selection_defense(rule, n_malicious=2, k=3)

    f = _fleet(s, FleetConfig(cohort_width=4,
                              edge=TierPolicy(defense=recording("fleet"))))
    srv = FedAvgGradServer(s["params"], apply_fn, s["data"], s["xt"],
                           s["yt"], FLConfig(**CFG),
                           defense=recording("server"), device="cpu")
    a, b = f._round(f.params, 0), srv._round(srv.params, 0)
    assert picks["fleet"] == picks["server"] and len(picks["fleet"]) == 1
    assert _rel(a, b) <= 1e-6


def test_two_tier_krum_composition_against_jax(setup):
    s = setup
    port = _fixed(_fleet(s, FleetConfig(
        cohort_width=3, edges=2, edge=TierPolicy(
            defense=defenses.selection_defense(defenses.multi_krum,
                                               n_malicious=1, k=2)))))
    j = _fixed(_jfleet(s, jfl.FleetConfig(
        cohort_width=3, edges=2, edge=jfl.TierPolicy(
            defense=jdef.selection_defense(jdef.multi_krum, n_malicious=1,
                                           k=2)))))
    assert _rel(port._round(port.params, 0), j._round(j.params, 0)) \
        <= TOL_JAX


# ------------------------------------------------------------ telemetry

@pytest.fixture(scope="module")
def streams(setup, tmp_path_factory):
    """One telemetered round of each engine at width 5, E=2, and of the
    port at E=1."""
    s = setup
    out = {}
    for name, edges in (("port", 2), ("port_flat", 1)):
        d = tmp_path_factory.mktemp(name)
        with Telemetry(str(d)) as tel:
            f = _fleet(s, FleetConfig(cohort_width=5, edges=edges),
                       telemetry=tel)
            f.run(1)
        out[name] = (read_events(tel.events_path, strict=True), f)
    d = tmp_path_factory.mktemp("jax")
    with JTelemetry(str(d)) as tel:
        _jfleet(s, jfl.FleetConfig(cohort_width=5, edges=2),
                telemetry=tel).run(1)
    out["jax"] = (read_events(tel.events_path, strict=True), None)
    return out


def _by_type(events, t):
    return [e for e in events if e["type"] == t]


def test_cohort_and_tier_payload_bytes_equal_jax(streams):
    keys = ("round", "tier", "cohort", "edge", "clients", "payload_bytes")
    got = [{k: e.get(k) for k in keys}
           for e in _by_type(streams["port"][0], "fl_cohort")]
    want = [{k: e.get(k) for k in keys}
            for e in _by_type(streams["jax"][0], "fl_cohort")]
    assert got == want and len(got) == 4
    tkeys = ("round", "tier", "edges", "clients", "inputs", "payload_bytes",
             "wire")
    assert ([{k: e.get(k) for k in tkeys}
             for e in _by_type(streams["port"][0], "fl_tier")]
            == [{k: e.get(k) for k in tkeys}
                for e in _by_type(streams["jax"][0], "fl_tier")])


@pytest.mark.parametrize("name", ["port", "port_flat"])
def test_events_pass_the_jax_validator(streams, name):
    events = streams[name][0]
    assert events and all(validate_event(e) == [] for e in events)
    manifest = _by_type(events, "manifest")[0]
    assert manifest["fleet"]["cohort_width"] == 5


def test_span_tree_complete_with_tiers(streams):
    events, _ = streams["port"]
    t = trace_trees(events)["fleet"]
    assert tree_check(t) == {"roots": 1, "orphans": 0, "imbalanced": 0}
    root = t["roots"][0]
    tiers = t["children"][root["span_id"]]
    edge_tiers = [k for k in tiers if k.get("tier") == "edge"]
    assert len(edge_tiers) == 2 and sum(
        k.get("tier") == "server" for k in tiers) == 1
    cohorts = _by_type(events, "fl_cohort")
    for e, et in enumerate(edge_tiers):
        kids = t["children"].get(et["span_id"], [])
        assert [k["clients"] for k in kids] == [
            ev["clients"] for ev in cohorts if ev["edge"] == e]


def test_flat_round_has_no_server_tier_span(streams):
    t = trace_trees(streams["port_flat"][0])["fleet"]
    tiers = t["children"][t["roots"][0]["span_id"]]
    assert [k.get("tier") for k in tiers] == ["edge"]


@pytest.mark.parametrize("name", ["port", "port_flat"])
def test_cohort_steps_never_retrace(streams, name):
    _, f = streams[name]
    assert f._stream_step.retraces == 0 and len(f._stream_step.compiles) == 1
    compiles = _by_type(streams[name][0], "compile")
    assert [e["name"] for e in compiles] == ["fleet/stream_step"]
    assert not any(e["retrace"] for e in compiles)


def test_device_none_raises_naming_cuda(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    s = setup
    with pytest.raises(RuntimeError, match="CUDA"):
        FleetFedAvgServer(s["params"], apply_fn, s["src"], s["xt"], s["yt"],
                          FLConfig(**CFG))
