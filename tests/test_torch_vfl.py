"""The port's vertical-FL stack against the JAX package's on the CPU, from
one bridged init: bottoms, top and full forward with their gradients,
the VFL-VAE forward, loss and gradients with the JAX draw's ε; then
``train_vfl`` in both modes and with each quirk toggled alone, dropout off
on both sides (rate 0 passes through both ``dropout``s): the first 3
epochs' losses within 1e-4; ``train_vfl_vae`` likewise with the
reparameterization noise fixed on both sides. Tolerances are stated at
each check."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl25spring_tpu.config import VFLConfig as JVFLConfig
from ddl25spring_tpu.data import tabular as jtab
from ddl25spring_tpu.models import vfl_nets as jnets
from ddl25spring_tpu.ops import cross_entropy_loss as jce
from ddl25spring_tpu.train import vfl as jvfl
from ddl25spring_tpu_torch import convert, rng
from ddl25spring_tpu_torch.config import VFLConfig
from ddl25spring_tpu_torch.models import vfl_nets
from ddl25spring_tpu_torch.ops.losses import cross_entropy_loss
from ddl25spring_tpu_torch.train import vfl
from ddl25spring_tpu_torch.tree import tree_leaves, tree_unflatten

torch.set_num_threads(1)

TOL_FWD = 1e-5        # forwards, losses, gradients: of each leaf's largest entry
TOL_TRAJ = 1e-4       # the first epochs' mean losses
EPOCHS = 3


@pytest.fixture(scope="module")
def heart():
    X, y = jtab.load_heart()
    feats, names = jtab.preprocess(X)
    xtr, ytr, xte, yte = jtab.train_test_split(feats, y, seed=0)
    parts = jtab.split_features_evenly(names, 4)
    split = lambda x: [np.ascontiguousarray(x[:, p]) for p in parts]
    return split(xtr), ytr, split(xte), yte


def _close(a, b, tol, what):
    b = np.asarray(b)
    err = float(np.abs(np.asarray(a) - b).max())
    assert err <= tol * max(1.0, float(np.abs(b).max())), (what, err)


def _grad_check(tp, loss_of, jgrads):
    leaves = [t.clone().requires_grad_() for t in tree_leaves(tp)]
    loss = loss_of(tree_unflatten(tp, leaves))
    for a, b in zip(torch.autograd.grad(loss, leaves),
                    jax.tree.leaves(jgrads)):
        _close(a.numpy(), b, TOL_FWD, "grad")
    return loss


def test_vfl_forward_and_gradients_match(heart):
    xs, y = [x[:50] for x in heart[0]], heart[1][:50]
    dims = [x.shape[1] for x in xs]
    jp = jax.tree.map(np.asarray, jnets.init_vfl(jax.random.key(0), dims))
    tp = convert.tree_from_numpy(jp, vfl_nets.init_vfl(
        rng.generator(0), dims, device="cpu"), device="cpu")
    txs = [torch.from_numpy(x) for x in xs]
    for a, b in zip(vfl_nets.bottoms_forward(tp, txs),
                    jnets.bottoms_forward(jp, xs)):
        _close(a.numpy(), b, TOL_FWD, "bottoms")
    _close(vfl_nets.vfl_forward(tp, txs).numpy(), jnets.vfl_forward(jp, xs),
           TOL_FWD, "logits")
    cut = np.concatenate([np.asarray(b) for b in jnets.bottoms_forward(jp, xs)], 1)
    _close(vfl_nets.top_forward(tp, torch.from_numpy(cut)).numpy(),
           jnets.top_forward(jp, cut), TOL_FWD, "top")
    jloss = lambda p: jce(jnets.vfl_forward(p, xs), y)
    loss = _grad_check(tp, lambda p: cross_entropy_loss(
        vfl_nets.vfl_forward(p, txs), torch.from_numpy(y)),
        jax.grad(jloss)(jp))
    assert abs(loss.item() - float(jloss(jp))) <= TOL_FWD
    # The port's own init has the JAX layout, and bridges back.
    mine = vfl_nets.init_vfl(rng.generator(0), dims, device="cpu")
    back = convert.tree_to_numpy(mine)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    assert [a.shape for a in jax.tree.leaves(back)] == \
        [a.shape for a in jax.tree.leaves(jp)]


def test_top_forward_keeps_the_output_quirk():
    """LeakyReLU on the output logits, and dropout there when live."""
    tp = vfl_nets.init_vfl(rng.generator(0), [3, 2], device="cpu")
    cut = torch.randn(64, 10, generator=rng.generator(1))
    out = vfl_nets.top_forward(tp, cut)
    raw = out.clone()
    last = tp["top"][-1]
    pre = torch.nn.functional.leaky_relu(torch.nn.functional.leaky_relu(
        torch.nn.functional.leaky_relu(cut @ tp["top"][0]["w"]
                                       + tp["top"][0]["b"], 0.01)
        @ tp["top"][1]["w"] + tp["top"][1]["b"], 0.01) @ last["w"]
        + last["b"], 0.01)
    torch.testing.assert_close(raw, pre)
    dropped = vfl_nets.top_forward(tp, cut, generator=rng.generator(2))
    assert bool((dropped == 0).any()) and not bool((raw == 0).any())


def test_vfl_vae_forward_loss_and_gradients_match(heart):
    xs = [x[:40] for x in heart[0]]
    dims = [x.shape[1] for x in xs]
    jp = jnets.init_vfl_vae(jax.random.key(1), dims)
    jnp_tree = {k: (v if k == "client_latent" else jax.tree.map(np.asarray, v))
                for k, v in jp.items()}
    tp = convert.tree_from_numpy(jnp_tree, vfl_nets.init_vfl_vae(
        rng.generator(1), dims, device="cpu"), device="cpu")
    assert tp["client_latent"] == 4 and isinstance(tp["client_latent"], int)
    key = jax.random.key(3)
    jrec, jmu, jlv = jnets.vfl_vae_forward(jp, xs, key)
    eps = torch.from_numpy(np.array(jax.random.normal(key, jmu.shape)))
    txs = [torch.from_numpy(x) for x in xs]
    rec, mu, lv = vfl_nets.vfl_vae_forward(tp, txs, eps=eps)
    for a, b in zip(rec + [mu, lv], list(jrec) + [jmu, jlv]):
        _close(a.numpy(), b, TOL_FWD, "vfl-vae forward")
    static = {"client_latent": tp["client_latent"]}
    tensors = {k: v for k, v in tp.items() if k != "client_latent"}
    jt = {k: v for k, v in jp.items() if k != "client_latent"}
    jloss = lambda p: jnets.vfl_vae_loss(*jnets.vfl_vae_forward(
        {**p, "client_latent": 4}, xs, key)[:1], xs,
        *jnets.vfl_vae_forward({**p, "client_latent": 4}, xs, key)[1:])[0]

    def tloss(p):
        r, m, l = vfl_nets.vfl_vae_forward({**p, **static}, txs, eps=eps)
        total, recon, kl = vfl_nets.vfl_vae_loss(r, txs, m, l)
        assert abs(total.item() - (recon + kl).item()) <= 1e-6
        return total

    loss = _grad_check(tensors, tloss, jax.grad(jloss)(jt))
    assert abs(loss.item() - float(jloss(jt))) <= TOL_FWD
    back = convert.tree_to_numpy(tp)
    assert back["client_latent"] == 4


def _bridge_vfl_init(monkeypatch, dims, cfg):
    """Dropout off on both sides; the JAX trainer starts from the port's
    seeded init."""
    monkeypatch.setattr(vfl_nets, "DROPOUT", 0.0)
    monkeypatch.setattr(jnets, "DROPOUT", 0.0)
    init = convert.tree_to_numpy(vfl_nets.init_vfl(
        rng.generator(cfg.seed), dims, bottom_out_mult=cfg.bottom_out_mult,
        device="cpu"))
    monkeypatch.setattr(jnets, "init_vfl", lambda key, d, bottom_out_mult:
                        jax.tree.map(jnp.asarray, init))
    return init


MODES = {
    "default": {},
    "faithful": {"faithful": True},
    "frozen_bottoms": {"train_bottoms": False},
    "adamw": {"weight_decay": 1e-2},
    "accumulate": {"accumulate_epoch_grads": True},
    "eval_dropout": {"eval_dropout": True},
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_train_vfl_first_epochs_match_jax(heart, monkeypatch, mode):
    xs_tr, ytr, xs_te, yte = heart
    cfg = dict(epochs=EPOCHS)
    init = _bridge_vfl_init(monkeypatch, [x.shape[1] for x in xs_tr],
                            VFLConfig(**cfg))
    kw = MODES[mode]
    jparams, jrep = jvfl.train_vfl(xs_tr, ytr, xs_te, yte,
                                   JVFLConfig(**cfg), **kw)
    params, rep = vfl.train_vfl(xs_tr, ytr, xs_te, yte, VFLConfig(**cfg),
                                device="cpu", **kw)
    np.testing.assert_allclose(rep.train_losses, jrep.train_losses,
                               atol=TOL_TRAJ, rtol=0)
    np.testing.assert_allclose(rep.train_accuracies, jrep.train_accuracies,
                               atol=1.5 / len(ytr), rtol=0)
    assert abs(rep.test_accuracy_clean - jrep.test_accuracy_clean) <= \
        1.5 / len(yte)
    # Dropout is off, so the dropout evaluation is the clean one.
    assert rep.test_accuracy == rep.test_accuracy_clean
    frozen = kw.get("faithful", False) or kw.get("train_bottoms") is False
    for a, b in zip(tree_leaves(params["bottoms"]),
                    jax.tree.leaves(init["bottoms"])):
        assert np.array_equal(a.numpy(), b) == frozen
    for a, b in zip(tree_leaves(params), jax.tree.leaves(jparams)):
        np.testing.assert_allclose(a.numpy(), b, atol=10 * TOL_TRAJ, rtol=0)


def test_train_vfl_with_dropout_learns_and_reports(heart):
    xs_tr, ytr, xs_te, yte = heart
    params, rep = vfl.train_vfl(xs_tr, ytr, xs_te, yte, VFLConfig(epochs=4),
                                faithful=True, device="cpu")
    assert len(rep.train_losses) == 4
    assert rep.train_losses[-1] < rep.train_losses[0]
    assert 0.0 <= rep.test_accuracy <= 1.0
    assert not any(t.requires_grad for t in tree_leaves(params))


def test_train_vfl_vae_first_epochs_match_jax(heart, monkeypatch):
    """The reparameterization noise fixed to one ε on both sides, and the
    JAX trainer started from the port's seeded init: the first 3 epochs'
    total, recon and KL within 1e-4; total = recon + kl."""
    xs_tr = heart[0]
    dims = [x.shape[1] for x in xs_tr]
    n = len(xs_tr[0])
    eps = np.random.default_rng(0).standard_normal((n, 8)).astype(np.float32)
    monkeypatch.setattr(jnets, "reparameterize", lambda key, mu, logvar:
                        mu + jnp.exp(0.5 * logvar) * eps)
    teps = torch.from_numpy(eps)
    real = vfl_nets.reparameterize
    monkeypatch.setattr(vfl_nets, "reparameterize",
                        lambda mu, logvar, generator=None, eps=None:
                        real(mu, logvar, eps=teps))
    init = convert.tree_to_numpy(vfl_nets.init_vfl_vae(
        rng.generator(0), dims, device="cpu"))
    monkeypatch.setattr(jnets, "init_vfl_vae", lambda key, d, client_latent:
                        {**jax.tree.map(jnp.asarray, {
                            k: v for k, v in init.items()
                            if k != "client_latent"}),
                         "client_latent": init["client_latent"]})
    jparams, jrep = jvfl.train_vfl_vae(xs_tr, JVFLConfig(), epochs=EPOCHS)
    params, rep = vfl.train_vfl_vae(xs_tr, VFLConfig(), epochs=EPOCHS,
                                    device="cpu")
    for got, want in ((rep.total_losses, jrep.total_losses),
                      (rep.recon_losses, jrep.recon_losses),
                      (rep.kl_losses, jrep.kl_losses)):
        np.testing.assert_allclose(got, want, atol=TOL_TRAJ, rtol=0)
    np.testing.assert_allclose(rep.total_losses,
                               np.add(rep.recon_losses, rep.kl_losses),
                               rtol=1e-5)
    assert params["client_latent"] == jparams["client_latent"] == 4


def test_train_vfl_vae_loss_falls(heart):
    params, rep = vfl.train_vfl_vae(heart[0], VFLConfig(), epochs=30,
                                    device="cpu")
    assert rep.total_losses[-1] < rep.total_losses[0]
    assert isinstance(params["client_latent"], int)


@pytest.mark.parametrize("entry", ["train_vfl", "train_vfl_vae", "train_vae",
                                   "synthetic_data_eval", "train_classifier"])
def test_trainers_default_to_cuda(heart, entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would use it")
    from ddl25spring_tpu_torch import train
    xs_tr, ytr, xs_te, yte = heart
    x, xt = np.concatenate(xs_tr, 1), np.concatenate(xs_te, 1)
    args = {"train_vfl": (xs_tr, ytr, xs_te, yte),
            "train_vfl_vae": (xs_tr,), "train_vae": (x,),
            "synthetic_data_eval": (x, ytr, xt, yte),
            "train_classifier": (x, ytr, xt, yte)}[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(train, entry)(*args)
