"""The port's MNIST CNN, parameter bridge, tree helpers and local solvers
against the JAX package's, on the JAX init and the same seeded data:
logits within 1e-5; the loss and one whole-subset gradient within 1e-5 of
each leaf's largest entry, with ragged masks; local SGD and FedProx's
solver (μ = 0 and 0.01, B = 50 with a padded tail, and B = -1) within
1e-4 of each leaf's largest entry. Dropout is off on both sides for the
comparisons; its masks are held against the port's own draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from ddl25spring_tpu.data import mnist as jmnist
from ddl25spring_tpu.fl import federate as jfederate
from ddl25spring_tpu.fl import local as jlocal
from ddl25spring_tpu.models import mnist_cnn as jcnn
from ddl25spring_tpu.utils import pytree as jpt
from ddl25spring_tpu_torch import convert, nn
from ddl25spring_tpu_torch.fl import federate, local
from ddl25spring_tpu_torch.models import mnist_cnn
from ddl25spring_tpu_torch.tree import (flatten, tree_leaves, tree_map,
                                        tree_weighted_fold)

torch.set_num_threads(1)


def japply(p, x, key=None):          # dropout off on the JAX side
    return jcnn.apply(p, x)


def tapply(p, x):                    # ... and on the port's (no masks maker)
    return mnist_cnn.apply(p, x)


@pytest.fixture(scope="module")
def setup():
    x_raw, y, _, _ = jmnist.load_mnist(n_train=1000, n_test=10, seed=0)
    x = jmnist.normalize(x_raw)
    subsets = jmnist.split(y, 7, iid=True, seed=10)          # 143 / 142
    jdata = jfederate(x, y.astype(np.int32), subsets)
    data = federate(x, y, subsets, device="cpu")
    # Ragged masks: client 1 keeps 57 samples, client 2 none.
    mask = data.mask.clone()
    mask[1, 57:] = 0.0
    mask[2] = 0.0
    jparams = jax.tree.map(np.asarray, jcnn.init(jax.random.key(0)))
    params = convert.mnist_params_from_jax(jparams, device="cpu")
    return jparams, params, jdata, data, mask


def _assert_leaves_close(got, want, rel):
    got, want = tree_leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a = a.detach().numpy()
        b = np.asarray(b)
        assert a.shape == b.shape
        scale = max(float(np.abs(b).max()), 1e-30)
        err = float(np.abs(a - b).max())
        assert err <= rel * scale, (a.shape, err, scale)


def test_tree_layout_and_parameter_count(setup):
    jparams, params, *_ = setup
    assert jax.tree.structure(jparams) == jax.tree.structure(
        tree_map(lambda t: 0, params))
    assert sum(x.numel() for x in tree_leaves(params)) == 1_199_882
    init = mnist_cnn.init(torch.Generator().manual_seed(0), device="cpu")
    for a, b in zip(tree_leaves(init), tree_leaves(params)):
        assert a.shape == b.shape and a.dtype == b.dtype
    # Kaiming-uniform bounds, as the JAX init: 1/sqrt(fan_in).
    assert float(init["fc1"]["w"].abs().max()) <= 1 / np.sqrt(9216)
    assert float(init["conv1"]["w"].abs().max()) <= 1 / 3


def test_bridge_round_trips_bitwise_and_checks_shapes(setup):
    jparams, params, *_ = setup
    back = convert.mnist_params_to_numpy(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, b)
    bad = dict(jparams, fc2={"w": np.zeros((10, 128), np.float32),
                             "b": jparams["fc2"]["b"]})
    with pytest.raises(ValueError, match="fc2.w"):
        convert.mnist_params_from_jax(bad, device="cpu")


def test_logits_match(setup):
    jparams, params, jdata, data, _ = setup
    x = data.x[0, :64]
    got = mnist_cnn.apply(params, x)
    want = np.asarray(jcnn.apply(jparams, jnp.asarray(x.numpy())))
    assert got.shape == (64, 10)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)


def test_flatten_is_ravel_pytree_order(setup):
    jparams, params, *_ = setup
    flat, unflatten = flatten(params)
    want, _ = ravel_pytree(jparams)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(want))
    # conv1's bias leads: PartialGradientReversion's slice lands there.
    np.testing.assert_array_equal(flat[:32].numpy(), jparams["conv1"]["b"])
    for a, b in zip(tree_leaves(unflatten(flat)), tree_leaves(params)):
        assert torch.equal(a, b)


def test_weighted_fold_matches_and_zero_weight_rows_are_exact_noops():
    r = np.random.default_rng(0)
    stack = {"a": r.normal(size=(5, 3, 4)).astype(np.float32),
             "b": {"c": r.normal(size=(5, 7)).astype(np.float32)}}
    w = np.array([0.1, 0.3, 0.2, 0.25, 0.15], np.float32)
    tstack = tree_map(torch.from_numpy, stack)
    got = tree_weighted_fold(tstack, torch.from_numpy(w))
    want = jpt.tree_weighted_fold(stack, jnp.asarray(w))
    _assert_leaves_close(got, want, 1e-6)
    # Rows at weight 0 (here copies of row 0 and garbage) change no bit.
    padded = tree_map(lambda x: torch.cat([x, x[:1], 1e30 * x[1:2]]), tstack)
    wp = torch.cat([torch.from_numpy(w), torch.zeros(2)])
    for a, b in zip(tree_leaves(tree_weighted_fold(padded, wp)),
                    tree_leaves(got)):
        assert torch.equal(a, b)


def test_loss_and_full_batch_grad_match_with_ragged_masks(setup):
    jparams, params, jdata, data, mask = setup
    xs, ys = data.x[:3], data.y[:3]
    loss, grads = local.full_batch_grad(tapply, params, xs, ys, mask[:3])
    assert loss.shape == (3,) and float(loss[2]) == 0.0
    for c in range(3):
        jloss, jgrads = jlocal.full_batch_grad(
            japply, jparams, jnp.asarray(xs[c].numpy()),
            jnp.asarray(ys[c].numpy().astype(np.int32)),
            jnp.asarray(mask[c].numpy()))
        one = local.masked_mean_loss(tapply, params, xs[c], ys[c], mask[c])
        assert abs(float(one) - float(jloss)) <= 1e-5 * max(1.0, abs(float(jloss)))
        assert abs(float(loss[c]) - float(jloss)) <= 1e-5 * max(1.0, abs(float(jloss)))
        if c == 2:      # no real sample: zero gradient on both sides
            assert all(float(g[c].abs().max()) == 0.0 for g in tree_leaves(grads))
            continue
        _assert_leaves_close(tree_map(lambda g: g[c], grads), jgrads, 1e-5)


@pytest.mark.parametrize("mu", [0.0, 0.01])
@pytest.mark.parametrize("batch_size", [50, -1])
def test_local_solvers_match(setup, mu, batch_size):
    jparams, params, jdata, data, mask = setup
    xs, ys, ms = data.x[:3], data.y[:3], mask[:3]
    kw = dict(epochs=2, batch_size=batch_size, lr=0.05)
    if mu == 0.0:
        got = local.local_sgd(tapply, params, xs, ys, ms, **kw)
    else:
        got = local.local_prox_sgd(tapply, params, xs, ys, ms, mu=mu, **kw)
    want = jax.vmap(lambda x, y, m: jlocal.local_prox_sgd(
        japply, jparams, x, y, m, mu=mu, **kw))(
        jnp.asarray(xs.numpy()), jnp.asarray(ys.numpy().astype(np.int32)),
        jnp.asarray(ms.numpy()))
    _assert_leaves_close(got, want, 1e-4)
    # The client with no real sample took no step at all.
    for a, b in zip(tree_leaves(got), tree_leaves(params)):
        assert torch.equal(a[2], b)


def test_prox_term_tethers_clients(setup):
    _, params, _, data, mask = setup
    kw = dict(epochs=3, batch_size=50, lr=0.05)
    free = local.local_prox_sgd(tapply, params, data.x[:1], data.y[:1],
                                mask[:1], mu=0.0, **kw)
    tied = local.local_prox_sgd(tapply, params, data.x[:1], data.y[:1],
                                mask[:1], mu=10.0, **kw)

    def drift(p):
        return sum(float(((a[0] - b) ** 2).sum())
                   for a, b in zip(tree_leaves(p), tree_leaves(params))) ** 0.5

    assert drift(tied) < 0.5 * drift(free)


def test_dropout_masks_keep_their_rates_and_replay_from_the_generator_state(
        setup):
    _, params, _, data, _ = setup
    g = torch.Generator().manual_seed(3)
    keep1, keep2 = mnist_cnn.dropout_masks(g, (400,))
    assert keep1.shape == (400, 64, 12, 12) and keep2.shape == (400, 128)
    assert abs(keep1.float().mean().item() - 0.75) < 0.01
    assert abs(keep2.float().mean().item() - 0.5) < 0.01
    x = data.x[0, :16]
    a = mnist_cnn.apply(params, x, dropout=torch.Generator().manual_seed(5))
    masks = mnist_cnn.dropout_masks(torch.Generator().manual_seed(5), (16,))
    b = mnist_cnn.apply(params, x, dropout=masks)
    assert torch.equal(a, b)
    assert not torch.equal(a, mnist_cnn.apply(params, x))
    # Kept entries are scaled by 1/(1 - rate), the others zero.
    h = torch.ones(4, 8)
    keep = nn.dropout_keep(torch.Generator().manual_seed(0), h.shape, 0.5)
    out = nn.dropout(h, 0.5, keep=keep)
    assert torch.equal(out, torch.where(keep, 2.0, 0.0))


def test_local_sgd_with_dropout_is_reproducible_per_client(setup):
    """A client's trajectory depends on its own generator only: the same
    seed gives the same parameters whatever its neighbours draw."""
    _, params, _, data, mask = setup
    kw = dict(epochs=1, batch_size=50, lr=0.05)

    def run(seeds):
        gens = [torch.Generator().manual_seed(s) for s in seeds]
        return local.local_sgd(mnist_cnn.apply, params, data.x[:2],
                               data.y[:2], mask[:2], generators=gens, **kw)

    a, b = run([11, 12]), run([11, 99])
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x[0], y[0])
        assert not torch.equal(x[1], y[1])
