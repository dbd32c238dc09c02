"""The port's Byzantine attacks against the JAX package's: every attack's
``transform`` and deterministic ``poison`` are equal, the backdoor stamp is
equal and its random draw keeps the proportion; the attacked and defended
Δ-upload server stays within 1e-4 of each leaf's largest entry of the JAX
one after 2 rounds (same clients, dropout off, float64 on both sides for
the reason that test gives); and with dropout live the
port reproduces ``tests/test_attacks_defenses.py``'s experiments:
gradient reversion bites, the coordinate median restores learning, and the
backdoor's attack success rate is computable."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl25spring_tpu import fl as jfl
from ddl25spring_tpu import rng as jrng
from ddl25spring_tpu.config import FLConfig as JFLConfig
from ddl25spring_tpu.data import mnist as jmnist
from ddl25spring_tpu.fl import attacks as jatk
from ddl25spring_tpu.fl import defenses as jdef
from ddl25spring_tpu.models import mnist_cnn as jcnn
from ddl25spring_tpu_torch import convert, fl
from ddl25spring_tpu_torch.config import FLConfig
from ddl25spring_tpu_torch.fl import attacks as tatk
from ddl25spring_tpu_torch.fl import defenses as tdef
from ddl25spring_tpu_torch.metrics import backdoor_metrics
from ddl25spring_tpu_torch.models import mnist_cnn
from ddl25spring_tpu_torch.tree import tree_leaves, tree_map

torch.set_num_threads(1)


def japply(p, x, key=None):
    return jcnn.apply(p, x)


def tapply(p, x):
    return mnist_cnn.apply(p, x)


@pytest.fixture(scope="module")
def params():
    jparams = jax.tree.map(np.asarray, jcnn.init(jax.random.key(0)))
    return jparams, convert.mnist_params_from_jax(jparams, device="cpu")


def _delta(jparams, seed=0):
    r = np.random.default_rng(seed)
    return jax.tree.map(lambda a: r.normal(size=a.shape).astype(np.float32),
                        jparams)


def _same(got, want):
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


ATTACKS = {
    "GradientReversion": lambda m: m.GradientReversion(scale=5.0),
    "PartialGradientReversion": lambda m: m.PartialGradientReversion(),
    "UntargetedLabelFlip": lambda m: m.UntargetedLabelFlip(),
    "TargetedLabelFlip": lambda m: m.TargetedLabelFlip(source=0, target=6),
    "PatternBackdoor": lambda m: m.PatternBackdoor(scale=2.0),
}


@pytest.mark.parametrize("name", sorted(ATTACKS))
def test_transform_is_identical(params, name):
    jparams, tp = params
    delta = _delta(jparams)
    got = ATTACKS[name](tatk).transform(tree_map(torch.from_numpy, delta), tp)
    want = ATTACKS[name](jatk).transform(
        jax.tree.map(jnp.asarray, delta), jparams)
    _same(got, want)


def test_partial_reversion_flips_conv1_bias_first(params):
    jparams, tp = params
    delta = tree_map(torch.ones_like, tp)
    out = tatk.PartialGradientReversion().transform(delta, tp)
    k = max(1, int(1_199_882 * 1e-5))
    assert k == 11
    assert (out["conv1"]["b"][:k] == -1000.0).all()
    assert (out["conv1"]["b"][k:] == 1.0).all()
    assert all(bool((x == 1.0).all()) for x in tree_leaves(out)[1:])
    assert (delta["conv1"]["b"] == 1.0).all()          # input untouched


@pytest.mark.parametrize("name", ["UntargetedLabelFlip", "TargetedLabelFlip"])
def test_label_flip_poison_is_identical(name):
    y = np.array([0, 1, 9, 6, 0, 3], np.int64)
    x = np.zeros((6, 1, 28, 28), np.float32)
    _, got = ATTACKS[name](tatk).poison(torch.from_numpy(x),
                                        torch.from_numpy(y), None)
    _, want = ATTACKS[name](jatk).poison(x, jnp.asarray(y.astype(np.int32)),
                                         None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_backdoor_stamp_and_full_poison_are_identical():
    x = np.random.default_rng(0).normal(size=(4, 1, 28, 28)).astype(np.float32)
    y = np.array([3, 4, 5, 6])
    t, j = (tatk.PatternBackdoor(proportion=1.0, backdoor_label=0),
            jatk.PatternBackdoor(proportion=1.0, backdoor_label=0))
    np.testing.assert_array_equal(t.trigger_test_set(x).numpy(),
                                  np.asarray(j.trigger_test_set(x)))
    px, py = t.poison(torch.from_numpy(x), torch.from_numpy(y),
                      torch.Generator().manual_seed(0))
    jx, jy = j.poison(jnp.asarray(x), jnp.asarray(y), jax.random.key(0))
    np.testing.assert_array_equal(px.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(py.numpy(), np.asarray(jy))
    assert (px[:, 0, 3:8, 23:26] == -10.0).all()


def test_backdoor_draw_keeps_the_proportion_and_replays():
    atk = tatk.PatternBackdoor(proportion=0.3, backdoor_label=0)
    n = 20000
    x = torch.zeros(n, 1, 28, 28)
    y = torch.full((n,), 7)
    px, py = atk.poison(x, y, torch.Generator().manual_seed(1))
    hit = py == 0
    assert abs(hit.float().mean().item() - 0.3) < 0.01
    assert (px[hit, 0, 3:8, 23:26] == -10.0).all()
    assert (px[~hit] == 0.0).all()
    _, again = atk.poison(x, y, torch.Generator().manual_seed(1))
    assert torch.equal(again, py)


CFG = dict(nr_clients=10, client_fraction=0.3, batch_size=50, epochs=1,
           lr=0.05, rounds=2, seed=10)


@pytest.fixture(scope="module")
def small64(params):
    """``tests/test_fl.py``'s size in float64 (see the test below)."""
    x_raw, y, xt_raw, yt = jmnist.load_mnist(n_train=1000, n_test=300, seed=0)
    x = jmnist.normalize(x_raw).astype(np.float64)
    xt = jmnist.normalize(xt_raw).astype(np.float64)
    subsets = jmnist.split(y, 10, iid=True, seed=10)
    jparams = jax.tree.map(lambda a: a.astype(np.float64), params[0])
    with jax.enable_x64(True):
        jdata = jfl.federate(x, y.astype(np.int32), subsets)
    return dict(jdata=jdata, data=fl.federate(x, y, subsets, device="cpu"),
                xt=xt, yt=yt, jparams=jparams,
                params=convert.mnist_params_from_jax(jparams, device="cpu"))


@pytest.mark.parametrize("attack, defense", [
    ("GradientReversion", "median"),
    ("UntargetedLabelFlip", "krum"),
    ("UntargetedLabelFlip", None),
    ("PartialGradientReversion", None),
    ("TargetedLabelFlip", "trimmed_mean"),
])
def test_attacked_round_matches_the_jax_server(small64, attack, defense):
    """Both sides in float64: the attacks scale Δ by 5 to 1000, which
    multiplies the frameworks' float differences as much, and in fp32 a
    max-pool window whose top two values lie ~1e-8 apart (about one per
    50-sample batch) routes its gradient to another input patch in one of
    the two frameworks; scaled by 5, that alone passes 1e-4."""
    s = small64
    mask = tatk.injection_mask(10, 0.2, seed=1)
    bad = np.flatnonzero(mask)
    good = np.flatnonzero(~mask)
    fixed = [np.array([bad[0], good[0], bad[1]]),
             np.array([good[1], bad[1], good[2]])]
    hooks = {
        None: lambda d: None,
        "median": lambda d: d.coordinate_defense(d.coordinate_median),
        "krum": lambda d: d.selection_defense(d.krum, n_malicious=1),
        "trimmed_mean": lambda d: d.coordinate_defense(d.trimmed_mean,
                                                       beta=0.34),
    }
    with jax.enable_x64(True):
        js = jfl.FedAvgGradServer(
            s["jparams"], japply, s["jdata"], s["xt"],
            s["yt"].astype(np.int32), JFLConfig(**CFG),
            adversary=(jnp.asarray(mask), ATTACKS[attack](jatk)),
            defense=hooks[defense](jdef))
        js._sample = lambda r: fixed[r]
        js.run(2)
        want = [np.asarray(b) for b in jax.tree.leaves(js.params)]
    ts = fl.FedAvgGradServer(
        s["params"], tapply, s["data"], s["xt"], s["yt"], FLConfig(**CFG),
        adversary=(mask, ATTACKS[attack](tatk)),
        defense=hooks[defense](tdef), device="cpu")
    ts._sample = lambda r: fixed[r]
    ts.run(2)
    for a, b in zip(tree_leaves(ts.params), want):
        assert a.dtype == torch.float64 and b.dtype == np.float64
        err = float(np.abs(a.numpy() - b).max())
        assert err <= 1e-4 * float(np.abs(b).max()), (b.shape, err)


@pytest.fixture(scope="module")
def attack_setup(params):
    """``tests/test_attacks_defenses.py``'s configuration."""
    x_raw, y, xt_raw, yt = jmnist.load_mnist(n_train=800, n_test=300, seed=0)
    x, xt = jmnist.normalize(x_raw), jmnist.normalize(xt_raw)
    cfg = FLConfig(nr_clients=10, client_fraction=0.5, batch_size=40,
                   epochs=1, lr=0.1, rounds=3, seed=42)
    subsets = jmnist.split(y, cfg.nr_clients, iid=True, seed=cfg.seed)
    data = fl.federate(x, y, subsets, device="cpu")
    return params[1], data, xt, yt, cfg


def test_gradient_reversion_hurts_and_median_defends(attack_setup):
    """The clients sampled are the JAX package's for this seed (1, 2 and 2
    of the 2 attackers in the three rounds), so the experiment is the one
    its test calibrated; dropout is the port's own."""
    tp, data, xt, yt, cfg = attack_setup
    mask = tatk.injection_mask(cfg.nr_clients, 0.2, seed=1)
    atk = tatk.GradientReversion(scale=5.0)

    def final(**kw):
        server = fl.FedAvgGradServer(tp, mnist_cnn.apply, data, xt, yt, cfg,
                                     device="cpu", **kw)
        server._sample = lambda r: np.asarray(jrng.sample_clients(
            cfg.seed, r, cfg.nr_clients, cfg.clients_per_round))
        return server.run(3).test_accuracy[-1]

    acc_honest = final()
    acc_attacked = final(adversary=(mask, atk))
    acc_defended = final(adversary=(mask, atk), defense=tdef.coordinate_defense(
        tdef.coordinate_median))
    assert acc_attacked < acc_honest - 0.1
    assert acc_defended > acc_attacked + 0.1


def test_backdoor_asr_pipeline(attack_setup):
    tp, data, xt, yt, cfg = attack_setup
    mask = tatk.injection_mask(cfg.nr_clients, 0.5, seed=1)
    atk = tatk.PatternBackdoor(proportion=0.5, backdoor_label=0, scale=2.0)
    server = fl.FedAvgGradServer(tp, mnist_cnn.apply, data, xt, yt, cfg,
                                 adversary=(mask, atk), device="cpu")
    server.run(2)
    with torch.no_grad():
        clean = server.apply_fn(server.params, server.test_x).argmax(-1)
        trig = server.apply_fn(server.params, atk.trigger_test_set(
            server.test_x)).argmax(-1)
    clean_acc, asr = backdoor_metrics(clean, yt, trig, 0)
    assert 0.0 <= asr <= 1.0 and 0.0 < clean_acc <= 1.0
