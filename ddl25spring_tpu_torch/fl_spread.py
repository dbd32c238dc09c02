"""How far FedAvg's accuracy after 10 rounds at homework 1's defaults
depends on the initial parameters and on the clients sampled.

    python -m ddl25spring_tpu_torch.fl_spread [--init-npz PATH] [--seeds 6]

Runs ``FedAvgServer`` (N=100, C=0.1, B=100, E=1, lr 0.01, IID, dropout
live) on ``synthetic_mnist(60000, 10000, seed=0)`` on the card: from the
port's init with CPU generators seeded 0 .. seeds-1, then the seed-0 init
under three other ``FLConfig.seed`` values (other clients and dropout).
With ``--init-npz`` (written by ``fl_reference_bar.py --save-init``: the
JAX package's init and its sampled clients) it also runs from that init,
with the port's sampling and with the JAX package's clients. Prints one
line per run and, last, a JSON object of the final accuracies.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from . import fl
from .config import FLConfig
from .convert import mnist_params_from_jax
from .data import mnist
from .device import resolve_device
from .models import mnist_cnn


def _load_npz(path: str, device):
    z = np.load(path)
    tree = {}
    for k in z.files:
        if "." in k:
            layer, leaf = k.split(".")
            tree.setdefault(layer, {})[leaf] = z[k]
    return mnist_params_from_jax(tree, device=device), z["samples"]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--init-npz", default=None)
    ap.add_argument("--seeds", type=int, default=6)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip())
    cfg = FLConfig()
    x_raw, y, xt_raw, yt = mnist.synthetic_mnist(60000, 10000, seed=0)
    x, xt = mnist.normalize(x_raw), mnist.normalize(xt_raw)
    data = fl.federate(x, y, mnist.split(y, cfg.nr_clients, iid=True,
                                         seed=cfg.seed), device=dev)
    finals = {}

    def run(name, params, seed=cfg.seed, samples=None):
        server = fl.FedAvgServer(params, mnist_cnn.apply, data, xt, yt,
                                 FLConfig(seed=seed), device=dev)
        if samples is not None:
            server._sample = lambda r: samples[r]
        t0 = time.perf_counter()
        acc = server.run(cfg.rounds).test_accuracy
        finals[name] = acc[-1]
        print(f"{name}: accuracy {[round(a, 4) for a in acc]} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)

    def port_init(seed):
        return mnist_cnn.init(torch.Generator().manual_seed(seed), device=dev)

    for s in range(args.seeds):
        run(f"port_init{s}", port_init(s))
    for seed in (11, 12, 13):
        run(f"port_init0_cfgseed{seed}", port_init(0), seed=seed)
    if args.init_npz:
        params, samples = _load_npz(args.init_npz, dev)
        run("npz_init", params)
        run("npz_init_npz_samples", params, samples=samples)
        run("port_init0_npz_samples", port_init(0), samples=samples)
        for seed in (11, 12, 13):
            run(f"npz_init_cfgseed{seed}", params, seed=seed)
    print(json.dumps({"final_accuracy": finals}))


if __name__ == "__main__":
    main()
