"""The port's tabular VAE against the JAX package's on the CPU, from one
bridged init: ``reparameterize`` with a given ε, the evaluation pass, a
train-mode pass (outputs and BatchNorm running state) and the loss and
its gradients with the JAX draw's ε, decoding; then the trainers, held by
loss bars (``jax.random`` and torch draw different noise): ``train_vae``'s
loss falls and ends within 10% of the JAX trainer's from the same init,
and the synthetic-data protocol runs per class. Tolerances are stated at
each check."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl25spring_tpu.config import VAEConfig as JVAEConfig
from ddl25spring_tpu.data import tabular as jtab
from ddl25spring_tpu.models import vae as jvae
from ddl25spring_tpu.train import generative as jgen
from ddl25spring_tpu_torch import convert, rng
from ddl25spring_tpu_torch.config import VAEConfig
from ddl25spring_tpu_torch.models import vae
from ddl25spring_tpu_torch.train import generative
from ddl25spring_tpu_torch.tree import tree_leaves, tree_unflatten

torch.set_num_threads(1)

TOL_FWD = 1e-5        # forwards, losses and gradients, of the largest entry
TOL_BN = 1e-6         # BatchNorm running state
LOSS_BAR = 0.10       # final train_vae loss, relative to the JAX trainer's

CFG = dict(input_dim=27, hidden_dims=(16, 6), latent_dim=3, epochs=12,
           batch_size=32, seed=0)


@pytest.fixture(scope="module")
def data():
    X, y = jtab.load_heart()
    feats, _ = jtab.preprocess(X)
    return jtab.train_test_split(feats, y, seed=0)


@pytest.fixture(scope="module")
def bridged():
    jp, js = jvae.init(jax.random.key(0), JVAEConfig(**CFG))
    jp, js = jax.tree.map(np.asarray, (jp, js))
    like = vae.init(rng.generator(0), VAEConfig(**CFG), device="cpu")
    tp, ts = (convert.tree_from_numpy(t, l, device="cpu")
              for t, l in zip((jp, js), like))
    return jp, js, tp, ts


def _close(a, b, tol, what):
    b = np.asarray(b)
    err = float(np.abs(np.asarray(a) - b).max())
    assert err <= tol * max(1.0, float(np.abs(b).max())), (what, err)


def test_init_layout_matches_and_bridges_back(bridged):
    jp, js, tp, ts = bridged
    mine, mine_s = vae.init(rng.generator(0), VAEConfig(**CFG), device="cpu")
    assert [t.shape for t in tree_leaves(mine)] == \
        [a.shape for a in jax.tree.leaves(jp)]
    assert [t.shape for t in tree_leaves(mine_s)] == \
        [a.shape for a in jax.tree.leaves(js)]
    back_p, back_s = map(convert.tree_to_numpy, (tp, ts))
    for a, b in zip(jax.tree.leaves((back_p, back_s)),
                    jax.tree.leaves((jp, js))):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        convert.tree_from_numpy({"enc": js["enc"][:1], "dec": js["dec"]},
                                mine_s, device="cpu")


def test_reparameterize_with_a_given_eps():
    r = np.random.default_rng(0)
    mu, logvar = (r.standard_normal((9, 3)).astype(np.float32)
                  for _ in range(2))
    key = jax.random.key(4)
    want = jvae.reparameterize(key, mu, logvar)
    eps = np.array(jax.random.normal(key, mu.shape, jnp.float32))
    got = vae.reparameterize(torch.from_numpy(mu), torch.from_numpy(logvar),
                             eps=torch.from_numpy(eps))
    _close(got.numpy(), want, TOL_FWD, "reparameterize")
    g = rng.generator(0)
    drawn = vae.reparameterize(torch.from_numpy(mu), torch.from_numpy(logvar),
                               generator=g)
    assert drawn.shape == (9, 3) and torch.isfinite(drawn).all()


def test_eval_and_train_passes_match(bridged, data):
    jp, js, tp, ts = bridged
    x = data[0][:32].astype(np.float32)
    xt = torch.from_numpy(x)
    # Evaluation: z = mu, running statistics.
    jr = jvae.apply(jp, js, x, None, train=False)
    tr = vae.apply(tp, ts, xt, train=False)
    for a, b, what in zip(tr[:3], jr[:3], ("recon", "mu", "logvar")):
        _close(a.numpy(), b, TOL_FWD, what)
    # One train-mode pass with the JAX draw's eps: outputs and state.
    key = jax.random.key(9)
    jr = jvae.apply(jp, js, x, key, train=True)
    mu = vae.encode(tp, ts, xt, train=True)[0]
    eps = torch.from_numpy(np.array(jax.random.normal(key, mu.shape)))
    tr = vae.apply(tp, ts, xt, train=True, eps=eps)
    for a, b, what in zip(tr[:3], jr[:3], ("recon", "mu", "logvar")):
        _close(a.numpy(), b, TOL_FWD, what)
    for a, b in zip(tree_leaves(tr[3]), jax.tree.leaves(jr[3])):
        np.testing.assert_allclose(a.numpy(), b, atol=TOL_BN, rtol=TOL_BN)
    # The loss and its gradient.
    jloss = lambda p: jvae.loss_fn(*jvae.apply(p, js, x, key, train=True)[:1],
                                   x, *jvae.apply(p, js, x, key,
                                                  train=True)[1:3])[0]
    jg = jax.grad(jloss)(jp)
    leaves = [t.clone().requires_grad_() for t in tree_leaves(tp)]
    p = tree_unflatten(tp, leaves)
    recon, mu, logvar, _ = vae.apply(p, ts, xt, train=True, eps=eps)
    total, mse, kld = vae.loss_fn(recon, xt, mu, logvar)
    jt, jm, jk = jvae.loss_fn(*jr[:1], x, *jr[1:3])
    for a, b in ((total, jt), (mse, jm), (kld, jk)):
        _close(a.item(), b, TOL_FWD, "loss")
    # Gradients against the largest entry of the whole gradient tree: a
    # dense bias right before BatchNorm has a true gradient of 0 (the
    # normalization removes it), so its computed entries are rounding
    # noise of the other terms, ~1e-5 in both frameworks.
    scale = max(float(np.abs(b).max()) for b in jax.tree.leaves(jg))
    for a, b in zip(torch.autograd.grad(total, leaves), jax.tree.leaves(jg)):
        err = float(np.abs(a.numpy() - np.asarray(b)).max())
        assert err <= TOL_FWD * scale, ("grad", err, scale)


def test_decode_and_sample(bridged):
    jp, js, tp, ts = bridged
    z = np.random.default_rng(1).standard_normal((10, 3)).astype(np.float32)
    _close(vae.decode(tp, ts, torch.from_numpy(z), train=False)[0].numpy(),
           jvae.decode(jp, js, z, train=False)[0], TOL_FWD, "decode")
    a = vae.sample(rng.generator(5), tp, ts, 10, 3)
    b = vae.sample(rng.generator(5), tp, ts, 10, 3)
    assert a.shape == (10, 27) and torch.equal(a, b)


def test_train_vae_loss_falls_and_lands_near_jax(data, monkeypatch):
    """Same init on both sides (the port's seeded draw, bridged), noise
    from each framework's own generator: the per-epoch loss falls, and
    the final one is within 10% of the JAX trainer's."""
    xtr = data[0]
    tp, ts = vae.init(rng.generator(0), VAEConfig(**CFG), device="cpu")
    init = tuple(map(convert.tree_to_numpy, (tp, ts)))
    monkeypatch.setattr(jvae, "init", lambda key, cfg: jax.tree.map(
        jnp.asarray, init))
    _, _, jrep = jgen.train_vae(xtr, JVAEConfig(**CFG))
    params, state, rep = generative.train_vae(xtr, VAEConfig(**CFG),
                                              device="cpu")
    assert len(rep.total_losses) == CFG["epochs"]
    assert rep.total_losses[-1] < rep.total_losses[0]
    assert abs(rep.total_losses[-1] - jrep.total_losses[-1]) <= \
        LOSS_BAR * jrep.total_losses[-1]
    np.testing.assert_allclose(rep.total_losses,
                               np.add(rep.mse_losses, rep.kld_losses),
                               rtol=1e-5)
    assert not any(t.requires_grad for t in tree_leaves(params))


def test_train_vae_drops_the_remainder_and_takes_small_sets_whole(data):
    """BatchNorm needs full batches: 40 rows at batch 32 train on one
    batch; 20 rows (fewer than a batch) on one batch of 20."""
    for n in (40, 20):
        _, state, rep = generative.train_vae(
            data[0][:n], VAEConfig(**{**CFG, "epochs": 2}), device="cpu")
        assert len(rep.total_losses) == 2
        assert all(np.isfinite(rep.total_losses))


def test_synthetic_data_eval_runs_per_class(data):
    xtr, ytr, xte, yte = data
    res = generative.synthetic_data_eval(
        xtr, ytr, xte, yte, VAEConfig(**{**CFG, "epochs": 3}),
        evaluator_epochs=3, device="cpu")
    assert len(res.vae_reports) == len(np.unique(ytr)) == 2
    assert [len(r.train_losses) for r in res.evaluator_reports] == [3, 3]
    assert 0.0 <= res.synthetic_accuracy <= 1.0
    assert 0.0 < res.real_accuracy <= 1.0
