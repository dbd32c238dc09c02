"""The port's DP-FedAvg against the JAX package's on the CPU at
``tests/test_fl.py``'s size (1,000 train and 300 test images, N=10,
C=0.3, B=50): per-client clipping, the accountant over a (q, z, T, δ) grid
and at the point ``tests/test_privacy_accounting.py`` pins, and the server
at z = 0 after 2 rounds with the same clients sampled and dropout off;
then the port alone: the noise is calibrated (σ = z·clip/m), fresh every
round, and from the server's own stream. Tolerances are stated at each
check."""

import itertools

import jax
import numpy as np
import pytest
import torch

from ddl25spring_tpu import fl as jfl
from ddl25spring_tpu.config import FLConfig as JFLConfig
from ddl25spring_tpu.data import mnist as jmnist
from ddl25spring_tpu.fl import privacy as jpriv
from ddl25spring_tpu.models import mnist_cnn as jcnn
from ddl25spring_tpu_torch import convert, fl
from ddl25spring_tpu_torch.config import FLConfig
from ddl25spring_tpu_torch.fl import privacy
from ddl25spring_tpu_torch.models import mnist_cnn
from ddl25spring_tpu_torch.tree import tree_leaves, tree_map

torch.set_num_threads(1)

CFG = dict(nr_clients=10, client_fraction=0.3, batch_size=50, epochs=1,
           lr=0.05, rounds=2, seed=10)
FIXED = [np.array([1, 4, 7]), np.array([0, 2, 9])]
TOL_CLIP = 1e-6       # clipped trees, of each leaf's largest entry
TOL_EPS = 1e-12       # the accountant: the same float math
TOL_SERVER = 1e-4     # parameters after 2 rounds, of each leaf's largest entry


@pytest.fixture(scope="module")
def setup():
    x_raw, y, xt_raw, yt = jmnist.load_mnist(n_train=1000, n_test=300, seed=0)
    x, xt = jmnist.normalize(x_raw), jmnist.normalize(xt_raw)
    subsets = jmnist.split(y, CFG["nr_clients"], iid=True, seed=CFG["seed"])
    jparams = jcnn.init(jax.random.key(0))
    return dict(xt=xt, yt=yt, jdata=jfl.federate(x, y.astype(np.int32),
                                                 subsets),
                data=fl.federate(x, y, subsets, device="cpu"),
                jparams=jparams, params=convert.mnist_params_from_jax(
                    jax.tree.map(np.asarray, jparams), device="cpu"))


def _tree(seed, lead=()):
    r = np.random.default_rng(seed)
    return {"a": r.standard_normal(lead + (3, 4)).astype(np.float32) * 2,
            "b": [r.standard_normal(lead + (5,)).astype(np.float32),
                  r.standard_normal(lead + (2, 2)).astype(np.float32)]}


@pytest.mark.parametrize("clip", [0.1, 1.0, 100.0])
def test_clip_by_global_norm_matches(clip):
    tree = _tree(0)
    got = privacy.clip_by_global_norm(tree_map(torch.from_numpy, tree), clip)
    want = jpriv.clip_by_global_norm(tree, clip)
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), b, atol=TOL_CLIP, rtol=TOL_CLIP)
    stacked = _tree(1, (4,))
    stacked["a"][2] *= 1e-3                   # one client already within
    got = privacy.clip_by_global_norm(tree_map(torch.from_numpy, stacked),
                                      clip, stacked=True)
    want = jax.vmap(lambda t: jpriv.clip_by_global_norm(t, clip))(stacked)
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), b, atol=TOL_CLIP, rtol=TOL_CLIP)


GRID = list(itertools.product((1e-4, 0.01, 0.1, 0.3, 1.0),
                              (0.5, 1.0, 4.0), (1, 10, 1000),
                              (1e-5, 1e-6)))


@pytest.mark.parametrize("q,z,t,delta", GRID[::3] + [(1e-4, 1.0, 10_000, 1e-6)])
def test_accountant_equals_the_jax_one(q, z, t, delta):
    for got, want in (
            (privacy.dp_epsilon_tight(z, t, q, delta),
             jpriv.dp_epsilon_tight(z, t, q, delta)),
            (privacy.dp_epsilon(z, t, delta), jpriv.dp_epsilon(z, t, delta))):
        assert abs(got - want) <= TOL_EPS * max(1.0, abs(want))
    assert privacy.privacy_spend(z, t, q, delta) == \
        pytest.approx(jpriv.privacy_spend(z, t, q, delta), rel=TOL_EPS)


def test_accountant_pinned_point_and_edges():
    spend = privacy.privacy_spend(1.0, 10_000, 1e-4, delta=1e-6)
    assert spend["eps_rdp_tight"] == pytest.approx(0.5887, abs=0.01)
    assert spend["eps_advanced_composition"] > 1000 * spend["eps_rdp_tight"]
    assert privacy.dp_epsilon(0.0, 10) == float("inf")
    assert privacy.dp_epsilon_tight(0.0, 10, 0.1) == float("inf")
    assert privacy.dp_epsilon_tight(1.0, 0, 0.1) == 0.0


def test_dp_fedavg_zero_noise_matches_the_jax_server(setup):
    """Clip 1.0 (active: the deltas are larger), z = 0: the same clients
    on both sides and dropout off; every leaf within 1e-4 of its largest
    entry after 2 rounds."""
    s = setup
    kw = dict(clip_norm=1.0, noise_multiplier=0.0)
    js = jpriv.DPFedAvgServer(s["jparams"], lambda p, x, key=None:
                              jcnn.apply(p, x), s["jdata"], s["xt"],
                              s["yt"].astype(np.int32), JFLConfig(**CFG), **kw)
    ts = privacy.DPFedAvgServer(s["params"], lambda p, x: mnist_cnn.apply(p, x),
                                s["data"], s["xt"], s["yt"], FLConfig(**CFG),
                                device="cpu", **kw)
    js._sample = ts._sample = lambda r: FIXED[r]
    jr, tr = js.run(2), ts.run(2)
    assert tr.algorithm == jr.algorithm == "dp-fedavg"
    for a, b in zip(tree_leaves(ts.params), jax.tree.leaves(js.params)):
        b = np.asarray(b)
        err = float(np.abs(a.numpy() - b).max())
        assert err <= TOL_SERVER * float(np.abs(b).max()), (b.shape, err)
    for a, b in zip(tr.test_accuracy, jr.test_accuracy):
        assert abs(a - b) <= 1.5 / 300


def test_dp_fedavg_noise_is_calibrated_and_fresh(setup):
    s = setup
    args = (s["params"], lambda p, x: mnist_cnn.apply(p, x), s["data"],
            s["xt"], s["yt"], FLConfig(**CFG))
    quiet = privacy.DPFedAvgServer(*args, clip_norm=1.0, noise_multiplier=0.0,
                                   device="cpu")
    noisy = privacy.DPFedAvgServer(*args, clip_norm=1.0, noise_multiplier=1.0,
                                   device="cpu")
    with torch.no_grad():
        base = quiet._round(quiet.params, 0)
        got = noisy._round(noisy.params, 0)
    noise = torch.cat([(b - g).reshape(-1) for g, b in
                       zip(tree_leaves(got), tree_leaves(base))])
    sigma = 1.0 * 1.0 / 3
    # 1.2 M samples: the empirical std is within 1% of σ.
    assert abs(noise.std().item() - sigma) <= 0.01 * sigma
    assert abs(noise.mean().item()) <= 0.01 * sigma
    a = privacy.gaussian_noise_like(noisy.noise_generator(0), s["params"], 1.0)
    b = privacy.gaussian_noise_like(noisy.noise_generator(1), s["params"], 1.0)
    c = privacy.gaussian_noise_like(noisy.noise_generator(0), s["params"], 1.0)
    assert not torch.equal(tree_leaves(a)[0], tree_leaves(b)[0])
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(c)))
    with pytest.raises(ValueError):
        privacy.DPFedAvgServer(*args, clip_norm=None, noise_multiplier=1.0,
                               device="cpu")


def test_dp_fedavg_learns_under_clipping(setup):
    s = setup
    server = fl.DPFedAvgServer(s["params"], mnist_cnn.apply, s["data"],
                               s["xt"], s["yt"], FLConfig(**CFG),
                               clip_norm=1.0, device="cpu")
    before = server.test()
    res = server.run(3)
    assert res.test_accuracy[-1] > before + 0.05


@pytest.mark.parametrize("server", ["DPFedAvgServer",
                                    "SecureAggFedAvgServer"])
def test_fl_servers_default_to_cuda(setup, server):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would use it")
    s = setup
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(fl, server)(s["params"], mnist_cnn.apply, s["data"], s["xt"],
                            s["yt"], FLConfig(**CFG))
