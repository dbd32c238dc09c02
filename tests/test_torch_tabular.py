"""The port's tabular pieces against the JAX package's on the CPU: the
heart-disease data module byte for byte (every function, several seeds
and party counts), tree leaves of list-bearing trees in
``jax.tree.leaves`` order, the MLP, LeakyReLU and BatchNorm primitives,
the tabular classifier, optax's ``adam`` / ``adamw`` step, the tabular
bridges, and ``train_classifier``'s first epochs from one init with
dropout off on both sides. Tolerances are stated at each check."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

from ddl25spring_tpu import nn as jnn
from ddl25spring_tpu.data import tabular as jtab
from ddl25spring_tpu.models import tabular as jtabm
from ddl25spring_tpu.train import tabular as jtrain
from ddl25spring_tpu_torch import convert, nn, rng
from ddl25spring_tpu_torch import config as tconfig
from ddl25spring_tpu_torch.data import tabular as ttab
from ddl25spring_tpu_torch.models import tabular as ttabm
from ddl25spring_tpu_torch.ops import adam as tadam
from ddl25spring_tpu_torch.train import tabular as ttrain
from ddl25spring_tpu_torch.tree import (flatten, tree_leaves, tree_map,
                                        tree_unflatten)

torch.set_num_threads(1)

TOL_FWD = 1e-5        # forwards, losses, gradients (fp32, same init)
TOL_BN = 1e-6         # BatchNorm outputs and running state
TOL_ADAM = 1e-6       # one optimizer step
TOL_TRAJ = 1e-4       # the first epochs' mean losses


def _same(a, b):
    """Same dtype, shape and bytes."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.fixture(scope="module")
def heart():
    X, y = jtab.load_heart()
    feats, names = jtab.preprocess(X)
    return X, y, feats, names


# ------------------------------------------------------------ data module

@pytest.mark.parametrize("n,seed", [(1025, 7), (300, 0), (64, 123)])
def test_synthetic_heart_is_byte_identical(n, seed):
    for a, b in zip(ttab.synthetic_heart(n, seed), jtab.synthetic_heart(n, seed)):
        _same(a, b)


def test_load_heart_falls_back_and_reads_a_csv(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("DDL_HEART_CSV", raising=False)
    for a, b in zip(ttab.load_heart(), jtab.synthetic_heart()):
        _same(a, b)
    X, y = jtab.synthetic_heart(50, 3)
    path = tmp_path / "h.csv"
    np.savetxt(path, np.concatenate([X, y[:, None]], 1), delimiter=",",
               header=",".join(jtab.COLUMNS + [jtab.TARGET]), comments="")
    for got in (ttab.load_heart(str(path)),):
        for a, b in zip(got, jtab.load_heart(str(path))):
            _same(a, b)
    monkeypatch.setenv("DDL_HEART_CSV", str(path))
    for a, b in zip(ttab.load_heart(), jtab.load_heart(str(path))):
        _same(a, b)


@pytest.mark.parametrize("onehot", [True, False])
def test_preprocess_is_byte_identical(heart, onehot):
    X = heart[0]
    (fa, na), (fb, nb) = ttab.preprocess(X, onehot=onehot), \
        jtab.preprocess(X, onehot=onehot)
    _same(fa, fb)
    assert na == nb


@pytest.mark.parametrize("seed,dedup,frac", [(0, False, 0.2), (5, False, 0.3),
                                             (0, True, 0.2), (9, True, 0.25)])
def test_train_test_split_is_byte_identical(heart, seed, dedup, frac):
    _, y, feats, _ = heart
    got = ttab.train_test_split(feats, y, seed=seed, dedup=dedup,
                                test_fraction=frac)
    want = jtab.train_test_split(feats, y, seed=seed, dedup=dedup,
                                 test_fraction=frac)
    for a, b in zip(got, want):
        _same(a, b)


@pytest.mark.parametrize("clients", [1, 2, 3, 4, 7, 13])
@pytest.mark.parametrize("seed", [None, 0, 3])
def test_split_features_evenly_is_identical(heart, clients, seed):
    names = heart[3]
    assert ttab.base_feature_groups(names) == jtab.base_feature_groups(names)
    assert (ttab.split_features_evenly(names, clients, seed=seed)
            == jtab.split_features_evenly(names, clients, seed=seed))


@pytest.mark.parametrize("clients,min_features,seed",
                         [(4, 2, 0), (7, 2, 1), (13, 3, 2), (20, 2, 0),
                          (3, 30, 4)])
def test_split_features_with_minimum_is_identical(heart, clients,
                                                  min_features, seed):
    names = heart[3]
    assert (ttab.split_features_with_minimum(names, clients,
                                             min_features=min_features,
                                             seed=seed)
            == jtab.split_features_with_minimum(names, clients,
                                                min_features=min_features,
                                                seed=seed))


# ------------------------------------------------------------ trees

def _nested(seed=0):
    r = np.random.default_rng(seed)
    a = lambda *s: r.standard_normal(s).astype(np.float32)
    return {"top": [{"w": a(3, 2), "b": a(2)}, {"w": a(2, 2), "b": a(2)}],
            "bottoms": [[{"w": a(4, 3), "b": a(3)}], [{"w": a(1, 5),
                                                      "b": a(5)}]],
            "enc": [{"lin": {"w": a(2, 2), "b": a(2)},
                     "bn": {"scale": a(2), "bias": a(2)}}]}


def test_tree_leaves_follow_jax_order_on_lists():
    tree = _nested()
    got = tree_leaves(tree_map(torch.from_numpy, tree))
    want = jax.tree.leaves(tree)
    assert len(got) == len(want) == 12
    for a, b in zip(got, want):
        _same(a.numpy(), b)
    flat, unflatten = flatten(tree_map(torch.from_numpy, tree))
    _same(flat.numpy(), np.asarray(ravel_pytree(tree)[0]))
    back = unflatten(flat)
    assert isinstance(back["bottoms"], list) and isinstance(
        back["bottoms"][0], list)
    for a, b in zip(tree_leaves(back), want):
        _same(a.numpy(), b)
    rebuilt = tree_unflatten(tree, [torch.from_numpy(x) for x in want])
    assert jax.tree.structure(tree_map(lambda t: t.numpy(), rebuilt)) == \
        jax.tree.structure(tree)


def test_dict_only_trees_keep_their_order():
    tree = {"b": {"y": np.ones(2), "x": np.zeros(1)}, "a": np.full(3, 2.0)}
    assert [x.shape for x in tree_leaves(tree)] == \
        [x.shape for x in jax.tree.leaves(tree)]


# ------------------------------------------------------------ primitives

def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_mlp_forward_and_gradient_match(heart):
    jp = jnn.mlp_init(jax.random.key(1), [27, 16, 8, 2])
    tp = convert.tree_from_numpy(jax.tree.map(np.asarray, jp), nn.mlp_init(
        rng.generator(1), [27, 16, 8, 2], device="cpu"), device="cpu")
    x = _x((33, 27))
    for act, fin, tact, tfin in ((jnn.relu, None, nn.relu, None),
                                 (jnn.leaky_relu, jnn.leaky_relu,
                                  nn.leaky_relu, nn.leaky_relu)):
        want = jnn.mlp(jp, x, activation=act, final_activation=fin)
        got = nn.mlp(tp, torch.from_numpy(x), activation=tact,
                     final_activation=tfin)
        np.testing.assert_allclose(got.numpy(), want, atol=TOL_FWD)
        jg = jax.grad(lambda p: jnp.sum(jnn.mlp(p, x, activation=act,
                                                final_activation=fin) ** 2))(jp)
        leaves = [t.clone().requires_grad_() for t in tree_leaves(tp)]
        tq = tree_unflatten(tp, leaves)
        loss = torch.sum(nn.mlp(tq, torch.from_numpy(x), activation=tact,
                                final_activation=tfin) ** 2)
        for a, b in zip(torch.autograd.grad(loss, leaves), jax.tree.leaves(jg)):
            np.testing.assert_allclose(a.numpy(), b, atol=TOL_FWD * max(
                1.0, float(np.abs(b).max())))


def test_leaky_relu_slope():
    x = np.linspace(-3, 3, 101).astype(np.float32)
    np.testing.assert_array_equal(nn.leaky_relu(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnn.leaky_relu(x)))


@pytest.mark.parametrize("n", [2, 7, 64])
def test_batchnorm_train_and_eval_match(n):
    x = _x((n, 5)) * 3 + 1
    jp, js = jnn.batchnorm_init(5)
    jp = {"scale": jnp.asarray(_x((5,), 1)), "bias": jnp.asarray(_x((5,), 2))}
    tp, ts = nn.batchnorm_init(5)
    tp = tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    for a, b in zip(tree_leaves(ts), jax.tree.leaves(js)):
        _same(a.numpy(), b)
    jy, js2 = jnn.batchnorm(jp, js, x, train=True)
    ty, ts2 = nn.batchnorm(tp, ts, torch.from_numpy(x), train=True)
    np.testing.assert_allclose(ty.numpy(), jy, atol=TOL_BN)
    for k in ("mean", "var"):
        np.testing.assert_allclose(ts2[k].numpy(), js2[k], atol=TOL_BN,
                                   rtol=TOL_BN)
    jy, js3 = jnn.batchnorm(jp, js2, x, train=False)
    ty, ts3 = nn.batchnorm(tp, ts2, torch.from_numpy(x), train=False)
    np.testing.assert_allclose(ty.numpy(), jy, atol=TOL_BN, rtol=TOL_BN)
    assert ts3 is ts2


def test_tabular_model_forward_and_gradient_match():
    jp = jtabm.init(jax.random.key(3), 27)
    tp = convert.tree_from_numpy(jax.tree.map(np.asarray, jp), ttabm.init(
        rng.generator(3), 27, device="cpu"), device="cpu")
    x, y = _x((40, 27)), np.arange(40) % 2
    np.testing.assert_allclose(
        ttabm.apply(tp, torch.from_numpy(x)).numpy(), jtabm.apply(jp, x),
        atol=TOL_FWD)
    jl = lambda p: optax.softmax_cross_entropy_with_integer_labels(
        jtabm.apply(p, x), y).mean()
    jg = jax.grad(jl)(jp)
    leaves = [t.clone().requires_grad_() for t in tree_leaves(tp)]
    logits = ttabm.apply(tree_unflatten(tp, leaves), torch.from_numpy(x))
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(y))
    assert abs(loss.item() - float(jl(jp))) <= TOL_FWD
    for a, b in zip(torch.autograd.grad(loss, leaves), jax.tree.leaves(jg)):
        np.testing.assert_allclose(a.numpy(), b, atol=TOL_FWD)
    # Dropout is live only with a generator, and then changes the logits.
    g = rng.generator(0)
    assert not torch.equal(ttabm.apply(tp, torch.from_numpy(x), generator=g),
                           ttabm.apply(tp, torch.from_numpy(x)))


def test_tabular_bridge_round_trips_and_checks_shapes():
    jp = jax.tree.map(np.asarray, jtabm.init(jax.random.key(0), 27))
    like = ttabm.init(rng.generator(0), 27, device="cpu")
    tp = convert.tree_from_numpy(jp, like, device="cpu")
    back = convert.tree_to_numpy(tp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        _same(a, b)
    bad = [dict(layer) for layer in jp]
    bad[1] = {"w": np.zeros((5, 128), np.float32),
              "b": np.zeros(128, np.float32)}
    with pytest.raises(ValueError):
        convert.tree_from_numpy(bad, like, device="cpu")


# ------------------------------------------------------------ optimizers

@pytest.mark.parametrize("wd", [0.0, 1e-2])
def test_adam_and_adamw_steps_match_optax(wd):
    jp = jax.tree.map(np.asarray, _nested(1))
    grads = [jax.tree.map(lambda a, s=s: a * 0 + _x(a.shape, s), jp)
             for s in (5, 6, 7)]
    jopt = optax.adamw(1e-3, weight_decay=wd) if wd else optax.adam(1e-3)
    topt = tadam.adamw(1e-3, weight_decay=wd)
    js, jparams = jopt.init(jp), jp
    tparams = tree_map(torch.from_numpy, jp)
    ts = topt.init(tparams)
    for g in grads:
        ju, js = jopt.update(g, js, jparams)
        jparams = optax.apply_updates(jparams, ju)
        tu, ts = topt.update(tree_map(torch.from_numpy, g), ts, tparams)
        for a, b in zip(tree_leaves(tu), jax.tree.leaves(ju)):
            np.testing.assert_allclose(a.numpy(), b, atol=TOL_ADAM, rtol=0)
        tadam.apply_updates(tparams, tu)
    for a, b in zip(tree_leaves(tparams), jax.tree.leaves(jparams)):
        np.testing.assert_allclose(a.numpy(), b, atol=TOL_ADAM, rtol=0)


def test_adam_tree_step_is_the_kernel_plain_rule_bitwise():
    """The whole-tree step the trainers take and the CUDA kernel's plain
    version, one leaf at a time, are one body: bitwise equal."""
    from ddl25spring_tpu_torch.ops import pallas_adam
    p = tree_map(torch.from_numpy, _nested(2))
    g = tree_map(lambda t: t * 0.5 - 0.1, p)
    q = tree_map(torch.clone, p)
    opt = tadam.fused_adam(1e-3)
    s, ms, vs = opt.init(p), opt.init(q).mu, opt.init(q).nu
    for t in range(1, 4):
        p, s = tadam.apply_optimizer(opt, g, s, p)
        c1, c2 = tadam.bias_corrections(torch.tensor(t), 0.9, 0.999)
        for leaf in zip(tree_leaves(q), tree_leaves(ms), tree_leaves(vs),
                        tree_leaves(g)):
            pallas_adam._leaf_plain(*leaf, c1, c2, lr=1e-3, b1=0.9,
                                    b2=0.999, eps=1e-8)
        for a, b in zip(tree_leaves(p) + tree_leaves(s.nu),
                        tree_leaves(q) + tree_leaves(vs)):
            assert torch.equal(a, b)


# ------------------------------------------------------------ trainer

def test_config_copies_match():
    from ddl25spring_tpu import config as jconfig
    for name in ("VFLConfig", "VAEConfig"):
        assert dataclasses.asdict(getattr(tconfig, name)()) == \
            dataclasses.asdict(getattr(jconfig, name)())


def test_train_classifier_first_epochs_match_jax(heart, monkeypatch):
    """Dropout off on both sides (rate 0 passes through both ``dropout``s)
    and the port's seeded init bridged to the JAX trainer: the first 3
    epochs' mean losses within 1e-4, the test accuracies equal."""
    _, y, feats, _ = heart
    xtr, ytr, xte, yte = jtab.train_test_split(feats, y, seed=0)
    monkeypatch.setattr(ttabm, "DROPOUT", 0.0)
    monkeypatch.setattr(jtabm, "DROPOUT", 0.0)
    init = convert.tree_to_numpy(ttabm.init(rng.generator(0), 27,
                                            device="cpu"))
    monkeypatch.setattr(jtabm, "init", lambda key, in_dim, hidden: jax.tree.map(
        jnp.asarray, init))
    _, jrep = jtrain.train_classifier(xtr, ytr, xte, yte, epochs=3)
    params, trep = ttrain.train_classifier(xtr, ytr, xte, yte, epochs=3,
                                           device="cpu")
    np.testing.assert_allclose(trep.train_losses, jrep.train_losses,
                               atol=TOL_TRAJ, rtol=0)
    assert trep.test_accuracies == pytest.approx(jrep.test_accuracies,
                                                 abs=1.5 / len(yte))
    assert trep.best_epoch == jrep.best_epoch
    assert all(not t.requires_grad for t in tree_leaves(params))


def test_train_classifier_keeps_the_first_best_epoch(heart):
    _, y, feats, _ = heart
    xtr, ytr, xte, yte = jtab.train_test_split(feats, y, seed=0)
    params, rep = ttrain.train_classifier(xtr, ytr, xte, yte, epochs=6,
                                          device="cpu")
    best = max(rep.test_accuracies)
    assert rep.best_accuracy == best
    assert rep.best_epoch == rep.test_accuracies.index(best)
    acc = (ttabm.apply(params, torch.from_numpy(xte)).argmax(-1).numpy()
           == yte).mean()
    assert acc == pytest.approx(best, abs=1e-6)
