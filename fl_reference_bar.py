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
    args = ap.parse_args()

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


if __name__ == "__main__":
    main()
