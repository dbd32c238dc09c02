"""The port's FL servers against the JAX package's at ``tests/test_fl.py``'s
size (1,000 train and 300 test images, N=10, C=0.3, B=50): with the same
clients sampled on both sides and dropout off, every server's parameters
stay within 1e-4 of each leaf's largest entry after 2 rounds (the
centralized baseline in float64, for the reason its test gives). Then the
port alone with dropout live: FedAvg learns and counts messages, FedSGD's
gradient and weight uploads agree (the homework's golden check), the
Δ-framing equals the weight framing, and FedProx at μ = 0 is FedAvg
bitwise."""

import jax
import numpy as np
import pytest
import torch

from ddl25spring_tpu import fl as jfl
from ddl25spring_tpu.config import FLConfig as JFLConfig
from ddl25spring_tpu.data import mnist as jmnist
from ddl25spring_tpu.models import mnist_cnn as jcnn
from ddl25spring_tpu_torch import convert, fl
from ddl25spring_tpu_torch.config import FLConfig
from ddl25spring_tpu_torch.models import mnist_cnn
from ddl25spring_tpu_torch.tree import tree_leaves

torch.set_num_threads(1)

CFG = dict(nr_clients=10, client_fraction=0.3, batch_size=50, epochs=1,
           lr=0.05, rounds=2, seed=10)
FIXED = [np.array([1, 4, 7]), np.array([0, 2, 9])]


def japply(p, x, key=None):
    return jcnn.apply(p, x)


def tapply(p, x):
    return mnist_cnn.apply(p, x)


@pytest.fixture(scope="module")
def setup():
    x_raw, y, xt_raw, yt = jmnist.load_mnist(n_train=1000, n_test=300, seed=0)
    x, xt = jmnist.normalize(x_raw), jmnist.normalize(xt_raw)
    subsets = jmnist.split(y, CFG["nr_clients"], iid=True, seed=CFG["seed"])
    jdata = jfl.federate(x, y.astype(np.int32), subsets)
    data = fl.federate(x, y, subsets, device="cpu")
    jparams = jcnn.init(jax.random.key(0))
    params = convert.mnist_params_from_jax(
        jax.tree.map(np.asarray, jparams), device="cpu")
    return dict(x=x, y=y, xt=xt, yt=yt, jdata=jdata, data=data,
                jparams=jparams, params=params, subsets=subsets)


def _pair(name, s):
    """(JAX server, port server) of one kind on the same inputs, dropout
    off, the same fixed clients sampled."""
    jcfg, cfg = JFLConfig(**CFG), FLConfig(**CFG)
    yt32 = s["yt"].astype(np.int32)
    jcls, tcls, kw = {
        "fedsgd": (jfl.FedSgdGradientServer, fl.FedSgdGradientServer, {}),
        "fedsgd-w": (jfl.FedSgdWeightServer, fl.FedSgdWeightServer, {}),
        "fedavg": (jfl.FedAvgServer, fl.FedAvgServer, {}),
        "fedavg-grad": (jfl.FedAvgGradServer, fl.FedAvgGradServer, {}),
        "fedprox": (jfl.FedProxServer, fl.FedProxServer, {"mu": 0.01}),
    }[name]
    js = jcls(s["jparams"], japply, s["jdata"], s["xt"], yt32, jcfg, **kw)
    ts = tcls(s["params"], tapply, s["data"], s["xt"], s["yt"], cfg,
              device="cpu", **kw)
    js._sample = ts._sample = lambda r: FIXED[r]
    return js, ts


def _assert_close(ts, js, jr, tr, name):
    assert tr.algorithm == jr.algorithm
    assert tr.message_count == jr.message_count
    got, want = tree_leaves(ts.params), jax.tree.leaves(js.params)
    for a, b in zip(got, want):
        b = np.asarray(b)
        err = float(np.abs(a.numpy() - b).max())
        assert err <= 1e-4 * float(np.abs(b).max()), (name, b.shape, err)
    # 300 test images: the parameters' agreement leaves at most a near-tie.
    for a, b in zip(tr.test_accuracy, jr.test_accuracy):
        assert abs(a - b) <= 1.5 / 300


@pytest.mark.parametrize("name", ["fedsgd", "fedsgd-w", "fedavg",
                                  "fedavg-grad", "fedprox"])
def test_two_rounds_match_the_jax_server(setup, name):
    js, ts = _pair(name, setup)
    _assert_close(ts, js, js.run(2), ts.run(2), name)


def test_centralized_two_rounds_match_the_jax_server_in_float64(setup):
    """The baseline takes 40 sequential SGD steps in 2 rounds. In fp32 a
    max-pool window whose top two values lie ~1e-8 apart (about one per
    50-sample batch) orders them differently in the two frameworks, so
    the gradient of that window lands on another input patch and the
    trajectories part after a few steps. In float64 on both sides such
    near-ties vanish and the same arithmetic is held to the same bound.
    Both sides take the JAX round's reshuffle."""
    s = setup
    cfg = FLConfig(**CFG)
    x64, xt64 = s["x"].astype(np.float64), s["xt"].astype(np.float64)
    n = len(s["y"])
    with jax.enable_x64(True):
        jparams = jax.tree.map(lambda a: np.asarray(a, np.float64),
                               s["jparams"])
        js = jfl.CentralizedServer(jparams, japply, x64,
                                   s["y"].astype(np.int32), xt64,
                                   s["yt"].astype(np.int32),
                                   JFLConfig(**CFG))
        jr = js.run(2)
        perms = [np.asarray(jax.random.permutation(jax.random.fold_in(
            jax.random.key(cfg.seed), r), n)) for r in range(2)]
    ts = fl.CentralizedServer(convert.mnist_params_from_jax(jparams,
                                                            device="cpu"),
                              tapply, x64, s["y"], xt64, s["yt"], cfg,
                              device="cpu")
    ts._permutation = lambda r: torch.from_numpy(perms[r].astype(np.int64))
    tr = ts.run(2)
    assert ts.params["fc1"]["w"].dtype == torch.float64
    _assert_close(ts, js, jr, tr, "centralized")


def test_fedavg_learns_with_dropout_and_counts_messages(setup):
    s = setup
    server = fl.FedAvgServer(s["params"], mnist_cnn.apply, s["data"],
                             s["xt"], s["yt"], FLConfig(**CFG), device="cpu")
    before = server.test()
    result = server.run(3)
    assert result.rounds == 3
    assert result.message_count == [6, 12, 18]
    assert result.test_accuracy[-1] > before + 0.08
    assert len(result.wall_time) == 3 and min(result.wall_time) > 0
    df = result.as_df()
    assert len(df) == 3 and df["algorithm"].iloc[0] == "fedavg"


def test_fedsgd_gradient_vs_weight_equivalence_with_dropout(setup):
    s = setup
    args = (s["params"], mnist_cnn.apply, s["data"], s["xt"], s["yt"],
            FLConfig(**CFG))
    a = fl.FedSgdGradientServer(*args, device="cpu")
    b = fl.FedSgdWeightServer(*args, device="cpu")
    ra, rb = a.run(2), b.run(2)
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=2e-4, atol=1e-6)
    assert abs(ra.test_accuracy[-1] - rb.test_accuracy[-1]) < 2e-4


def test_delta_framing_matches_weight_framing_with_dropout(setup):
    s = setup
    args = (s["params"], mnist_cnn.apply, s["data"], s["xt"], s["yt"],
            FLConfig(**CFG))
    a = fl.FedAvgServer(*args, device="cpu")
    b = fl.FedAvgGradServer(*args, device="cpu")
    a.run(2)
    b.run(2)
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=2e-4, atol=1e-5)


def test_fedprox_at_mu_zero_is_fedavg_bitwise(setup):
    s = setup
    cfg = FLConfig(**{**CFG, "epochs": 2})
    args = (s["params"], mnist_cnn.apply, s["data"], s["xt"], s["yt"], cfg)
    a = fl.FedAvgServer(*args, device="cpu")
    b = fl.FedProxServer(*args, mu=0.0, device="cpu")
    ra, rb = a.run(2), b.run(2)
    assert rb.algorithm == "fedprox"
    assert ra.test_accuracy == rb.test_accuracy
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(x, y)


def test_client_sampling_and_seeds(setup):
    s = setup
    server = fl.FedAvgServer(s["params"], tapply, s["data"], s["xt"],
                             s["yt"], FLConfig(**CFG), device="cpu")
    idx = server._sample(0)
    assert len(idx) == 3 and len(np.unique(idx)) == 3
    assert np.array_equal(idx, server._sample(0))
    m = server.cfg.clients_per_round
    assert list(server.client_seeds(4, idx)) == [
        CFG["seed"] + int(i) + 1 + 4 * m for i in idx]


def test_centralized_baseline_learns_and_sends_nothing(setup):
    s = setup
    server = fl.CentralizedServer(s["params"], mnist_cnn.apply, s["x"],
                                  s["y"], s["xt"], s["yt"], FLConfig(**CFG),
                                  device="cpu")
    result = server.run(2)
    assert result.test_accuracy[-1] > 0.3
    assert result.message_count == [0, 0]
    assert result.nr_clients == 1 and result.client_fraction == 1.0


def test_non_iid_fedavg_runs(setup):
    s = setup
    subsets = jmnist.split(s["y"], CFG["nr_clients"], iid=False,
                           seed=CFG["seed"])
    data = fl.federate(s["x"], s["y"], subsets, device="cpu")
    server = fl.FedAvgServer(s["params"], mnist_cnn.apply, data, s["xt"],
                             s["yt"], FLConfig(**CFG), device="cpu")
    assert np.isfinite(server.run(2).test_accuracy).all()
