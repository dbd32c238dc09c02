#!/usr/bin/env python3
"""The JAX package's FedAvg on the CPU from the PyTorch port's initial
parameters: the reference accuracy that ``chip_smoke.py``'s phase 8 holds
the port to.

    JAX_PLATFORMS=cpu python3 fl_reference_bar.py [--init-seed 0] [--rounds 10]

Homework 1's defaults (``FLConfig()``: N=100, C=0.1, B=100, E=1, lr 0.01,
seed 10) on ``synthetic_mnist(60000, 10000, seed=0)``, IID, dropout live,
through ``ddl25spring_tpu.fl.FedAvgServer``; the initial parameters are
``ddl25spring_tpu_torch.models.mnist_cnn.init`` with a CPU generator seeded
``--init-seed`` (what phase 8 starts from), converted name for name. The
two packages cannot draw the same initial parameters from a seed, and at
this size the final accuracy depends on the draw by more than the
phase's 0.03 margin, so the reference runs from the port's draw. Prints the
accuracy per round and, last, a JSON line. Runs on the CPU only (about
8 minutes on 8 cores).

    JAX_PLATFORMS=cpu python3 fl_reference_bar.py --save-init PATH

writes the JAX package's own init (``mnist_cnn.init(jax.random.key(0))``,
as ``examples/hfl.py`` draws it) and its sampled clients for ``--rounds``
rounds to an .npz instead, for ``python -m ddl25spring_tpu_torch.fl_spread
--init-npz PATH``.

    JAX_PLATFORMS=cpu python3 fl_reference_bar.py --tabular

runs the tabular half instead: the bars of ``chip_smoke.py``'s phase 9,
the JAX package's trainers on ``preprocess(synthetic_heart())`` split with
``train_test_split(seed=0)``, each from the PyTorch port's initial
parameters for the same seed (its CPU generator's draw, converted name
for name; the JAX init functions are replaced for the run, the package
itself is not edited): ``train_classifier`` at its defaults, ``train_vfl``
at ``VFLConfig()`` over 4 parties (``split_features_evenly``) in both
modes, ``train_vfl_vae`` for 1,000 epochs, ``train_vae`` at
``VAEConfig(input_dim=27)`` and ``synthetic_data_eval`` with 200
evaluator epochs. Dropout and the VAE noise come from ``jax.random``, so
phase 9 holds the port to these with a margin. Prints one line per
trainer and, last, a JSON line (under a minute on 8 CPU cores).
"""

from __future__ import annotations

import argparse
import json
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--init-seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--save-init", default=None)
    ap.add_argument("--tabular", action="store_true")
    args = ap.parse_args()
    if args.tabular:
        tabular_bars()
        return

    import jax
    jax.config.update("jax_platforms", "cpu")
    import torch

    from ddl25spring_tpu.config import FLConfig
    from ddl25spring_tpu.data import mnist
    from ddl25spring_tpu.fl import FedAvgServer, federate
    from ddl25spring_tpu.models import mnist_cnn as jcnn
    from ddl25spring_tpu_torch.convert import mnist_params_to_numpy
    from ddl25spring_tpu_torch.models import mnist_cnn

    cfg = FLConfig()
    if args.save_init:
        import numpy as np

        from ddl25spring_tpu.rng import sample_clients
        init = jcnn.init(jax.random.key(0))
        np.savez(args.save_init, samples=np.stack([
            np.asarray(sample_clients(cfg.seed, r, cfg.nr_clients,
                                      cfg.clients_per_round))
            for r in range(args.rounds)]), **{
            f"{layer}.{leaf}": np.asarray(v)
            for layer, d in init.items() for leaf, v in d.items()})
        return
    x_raw, y, xt_raw, yt = mnist.synthetic_mnist(60000, 10000, seed=0)
    x, xt = mnist.normalize(x_raw), mnist.normalize(xt_raw)
    data = federate(x, y.astype("int32"), mnist.split(
        y, cfg.nr_clients, iid=True, seed=cfg.seed))
    params = mnist_params_to_numpy(mnist_cnn.init(
        torch.Generator().manual_seed(args.init_seed), device="cpu"))
    server = FedAvgServer(params, jcnn.apply, data, xt, yt.astype("int32"),
                          cfg)
    t0 = time.perf_counter()
    result = server.run(args.rounds)
    for r, acc in enumerate(result.test_accuracy):
        print(f"round {r + 1}: test accuracy {acc:.4f}")
    print(json.dumps({"init_seed": args.init_seed, "rounds": args.rounds,
                      "test_accuracy": result.test_accuracy,
                      "final_accuracy": result.test_accuracy[-1],
                      "platform": jax.devices()[0].platform,
                      "jax": jax.__version__,
                      "wall_s": time.perf_counter() - t0}))


def _seed_of(key) -> int:
    """The integer a ``jax.random.key(seed)`` was made from (small seeds)."""
    import jax
    return int(jax.random.key_data(key)[-1])


def tabular_bars() -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from ddl25spring_tpu.config import VAEConfig, VFLConfig
    from ddl25spring_tpu.data import tabular as tab
    from ddl25spring_tpu.models import tabular as jtab
    from ddl25spring_tpu.models import vae as jvae
    from ddl25spring_tpu.models import vfl_nets as jnets
    from ddl25spring_tpu.train import generative as jgen
    from ddl25spring_tpu.train import (synthetic_data_eval, train_classifier,
                                       train_vae, train_vfl, train_vfl_vae)
    from ddl25spring_tpu_torch import convert, rng
    from ddl25spring_tpu_torch.config import VAEConfig as TVAEConfig
    from ddl25spring_tpu_torch.models import tabular as ttab
    from ddl25spring_tpu_torch.models import vae as tvae
    from ddl25spring_tpu_torch.models import vfl_nets as tnets

    as_jax = lambda tree: jax.tree.map(jnp.asarray, tree)
    jtab.init = lambda key, in_dim=30, hidden=(64, 128, 256): as_jax(
        convert.tree_to_numpy(ttab.init(
            rng.generator(_seed_of(key)), in_dim, hidden, device="cpu")))
    jvae.init = lambda key, cfg: as_jax(tuple(map(
        convert.tree_to_numpy, tvae.init(
            rng.generator(_seed_of(key)), TVAEConfig(
                input_dim=cfg.input_dim, hidden_dims=tuple(cfg.hidden_dims),
                latent_dim=cfg.latent_dim), device="cpu"))))
    jnets.init_vfl = lambda key, dims, bottom_out_mult=2: as_jax(
        convert.tree_to_numpy(tnets.init_vfl(
            rng.generator(_seed_of(key)), dims,
            bottom_out_mult=bottom_out_mult, device="cpu")))

    def vfl_vae_init(key, dims, client_latent=4):
        tree = convert.tree_to_numpy(tnets.init_vfl_vae(
            rng.generator(_seed_of(key)), dims, client_latent=client_latent,
            device="cpu"))
        lat = tree.pop("client_latent")
        return {**as_jax(tree), "client_latent": lat}

    jnets.init_vfl_vae = vfl_vae_init
    # The synthetic-data protocol's two evaluators, recorded as they run.
    evaluators = []

    def recorded_classifier(*args, **kw):
        evaluators.append(train_classifier(*args, **kw)[1])
        return None, evaluators[-1]

    jgen.train_classifier = recorded_classifier

    X, y = tab.load_heart()
    feats, names = tab.preprocess(X)
    xtr, ytr, xte, yte = tab.train_test_split(feats, y, seed=0)
    parts = tab.split_features_evenly(names, 4)
    split = lambda x: [np.ascontiguousarray(x[:, p]) for p in parts]
    majority = float(max(yte.mean(), 1 - yte.mean()))
    out = {"majority_test_rate": majority, "n_train": int(len(ytr)),
           "n_test": int(len(yte)), "positive_rate": float(y.mean())}
    t0 = time.perf_counter()
    _, rep = train_classifier(xtr, ytr, xte, yte)
    out["classifier_best_accuracy"] = rep.best_accuracy
    out["classifier_losses_first_last"] = [rep.train_losses[0],
                                           rep.train_losses[-1]]
    print(f"train_classifier: best accuracy {rep.best_accuracy:.4f} "
          f"(epoch {rep.best_epoch}); majority {majority:.4f}")
    for faithful in (False, True):
        _, rep = train_vfl(split(xtr), ytr, split(xte), yte, VFLConfig(),
                           faithful=faithful)
        key = "vfl_faithful" if faithful else "vfl_default"
        out[key] = {"test_accuracy_clean": rep.test_accuracy_clean,
                    "test_accuracy": rep.test_accuracy,
                    "losses_first_last": [rep.train_losses[0],
                                          rep.train_losses[-1]]}
        print(f"train_vfl faithful={faithful}: clean accuracy "
              f"{rep.test_accuracy_clean:.4f}, reported "
              f"{rep.test_accuracy:.4f}; majority {majority:.4f}")
    _, rep = train_vfl_vae(split(xtr), VFLConfig(), epochs=1000)
    out["vfl_vae_final_total"] = rep.total_losses[-1]
    print(f"train_vfl_vae: total {rep.total_losses[0]:.4f} -> "
          f"{rep.total_losses[-1]:.4f}")
    _, _, rep = train_vae(xtr, VAEConfig(input_dim=27))
    out["vae_final_total"] = rep.total_losses[-1]
    print(f"train_vae: total {rep.total_losses[0]:.2f} -> "
          f"{rep.total_losses[-1]:.2f}")
    res = synthetic_data_eval(xtr, ytr, xte, yte, VAEConfig(input_dim=27),
                              evaluator_epochs=200)
    out["synthetic_eval"] = {"real_accuracy": res.real_accuracy,
                             "synthetic_accuracy": res.synthetic_accuracy,
                             "evaluator_final_losses": [
                                 r.train_losses[-1] for r in evaluators]}
    print(f"synthetic_data_eval: real {res.real_accuracy:.4f}, synthetic "
          f"{res.synthetic_accuracy:.4f}; majority {majority:.4f}")
    out.update(platform=jax.devices()[0].platform, jax=jax.__version__,
               wall_s=time.perf_counter() - t0)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
