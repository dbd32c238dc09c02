"""Fleet-scale FL smoke: one cohort-streamed FedAvg round over 100,000
simulated clients, with its checks. Twin of the JAX package's
``experiments/fleet_smoke.py``.

Every client of ``SyntheticFleetSource(--clients, features 64, 16
classes, 8 samples each)`` takes part in one round of the linear model at
cohort width 64 (``fl.FleetFedAvgServer``), and the script checks:

- memory: on the card, the growth of ``torch.cuda.max_memory_allocated``
  over the round stays below four cohorts' bytes plus the parameters'
  (O(cohort), not O(clients)); on the CPU, the resident set grows less
  than ``--rss-budget-mb``. The all-at-once estimate (``naive_resident_mb``)
  stands beside it;
- correctness on an 80-client control slice: at cohort width 80 (the
  reference's shapes) bitwise ``vmapped_round_reference``; at width 32 (a
  padded last cohort) within 1e-6 of each leaf's largest entry, and
  whether it was bitwise; 8 edges within 1e-5 of the flat round;
- defenses: Multi-Krum over the streamed ``[80, P]`` delta stack selects
  the clients the all-at-once stack selects; its cost is timed at 64 and
  ``--krum-probe-clients`` clients;
- no cohort step retraces;
- ``privacy_spend`` at q = 1e-4 (a 1,000-client cohort of a 10M fleet).

It reports clients/s, the round's wall time and the host's share of it
(generating the clients' data and their generators). Writes one JSON line
(``--out``) and the ``fl_cohort`` / ``fl_tier`` stream
(``--telemetry-dir``); exits 1 when a check fails.

    python -m ddl25spring_tpu_torch.experiments.fleet_smoke --out fleet.json
    python -m ddl25spring_tpu_torch.experiments.fleet_smoke --device cpu \\
        --quick
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..config import FLConfig
from ..device import fp32_products, resolve_device, synchronize
from ..fl import (FleetConfig, FleetFedAvgServer, SyntheticFleetSource,
                  privacy_spend, vmapped_round_reference)
from ..fl.defenses import multi_krum
from ..telemetry import Telemetry
from ..telemetry.memory import host_rss_bytes

CLASSES = 16
SAMPLES = 8
CONTROL = 80                 # clients in the control slice
CONTROL_WIDTH = 32           # 32 + 32 + 16: a padded last cohort
TOL_RAGGED = 1e-6            # of each leaf's largest entry
TOL_EDGES = 1e-5             # absolute, as the JAX smoke's


def apply_fn(p, x):
    return x @ p["w"] + p["b"]


def init_params(features: int, seed: int, device) -> dict:
    g = np.random.default_rng(seed)
    return {"w": torch.from_numpy((0.01 * g.normal(size=(features, CLASSES))
                                   ).astype(np.float32)).to(device),
            "b": torch.zeros(CLASSES, device=device)}


def rel_diff(a: dict, b: dict) -> float:
    """Largest |a − b| of a leaf over that leaf's largest |b|."""
    return max(float((a[k] - b[k]).abs().max()
                     / torch.clamp(b[k].abs().max(), min=1e-30))
               for k in a)


def abs_diff(a: dict, b: dict) -> float:
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def bitwise(a: dict, b: dict) -> bool:
    return all(bool(torch.equal(a[k], b[k])) for k in a)


class _TimedSource:
    """A source that adds the seconds spent generating cohorts to
    ``seconds``."""

    def __init__(self, source):
        self._source = source
        self.seconds = 0.0

    def __getattr__(self, attr):
        return getattr(self._source, attr)

    def cohort(self, idx):
        t0 = time.perf_counter()
        out = self._source.cohort(idx)
        self.seconds += time.perf_counter() - t0
        return out


def _time_generators(server) -> list:
    """Wrap the server's per-cohort generator construction; returns a
    one-element list holding its seconds."""
    spent = [0.0]
    make = server._generators

    def timed(r, cidx):
        t0 = time.perf_counter()
        out = make(r, cidx)
        spent[0] += time.perf_counter() - t0
        return out

    server._generators = timed
    return spent


def run(a) -> dict:
    dev = resolve_device(a.device)
    features = a.features
    src = SyntheticFleetSource(a.clients, samples_per_client=SAMPLES,
                               features=features, classes=CLASSES,
                               seed=a.seed)
    xt, yt = src.test_set(512)
    params = init_params(features, a.seed, dev)
    param_floats = features * CLASSES + CLASSES
    cfg = FLConfig(nr_clients=a.clients, client_fraction=1.0,
                   batch_size=SAMPLES, epochs=1, lr=0.5, rounds=1,
                   seed=a.seed)
    naive_resident_mb = a.clients * (SAMPLES * features + param_floats) * 4 / 1e6
    # One cohort on the device: x, y (int64), mask, and one delta per
    # client.
    cohort_bytes = a.cohort * (SAMPLES * features * 4 + SAMPLES * 8
                               + SAMPLES * 4 + param_floats * 4)
    memory_bound = 4 * cohort_bytes + param_floats * 4
    checks = {}

    tel = Telemetry(a.telemetry_dir) if a.telemetry_dir else None
    timed = _TimedSource(src)
    server = FleetFedAvgServer(params, apply_fn, timed, xt, yt, cfg,
                               FleetConfig(cohort_width=a.cohort,
                                           edges=a.edges),
                               telemetry=tel, device=dev)
    gen_s = _time_generators(server)
    if dev.type == "cuda":
        synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    rss0 = host_rss_bytes() or 0
    t0 = time.perf_counter()
    result = server.run(1)
    round_wall = time.perf_counter() - t0
    if dev.type == "cuda":
        growth = torch.cuda.max_memory_allocated(dev) - base
        checks["device_memory_bounded"] = growth < memory_bound
    else:
        growth = (host_rss_bytes() or 0) - rss0
        checks["rss_bounded"] = growth / 2**20 < a.rss_budget_mb
    acc = result.test_accuracy[-1]
    checks["round_completed"] = bool(result.rounds == 1 and np.isfinite(acc))
    checks["learned_above_chance"] = acc > 1.5 / CLASSES
    host_s = timed.seconds + gen_s[0]

    # The control slice: the same 80 sampled clients streamed and all at
    # once.
    ctl_cfg = FLConfig(nr_clients=a.clients,
                       client_fraction=CONTROL / a.clients,
                       batch_size=SAMPLES, epochs=1, lr=0.5, rounds=1,
                       seed=a.seed)

    def fleet(width, edges=1):
        return FleetFedAvgServer(params, apply_fn, src, xt, yt, ctl_cfg,
                                 FleetConfig(cohort_width=width,
                                             edges=edges), device=dev)

    equal_shape = fleet(CONTROL)
    ctl_idx = equal_shape._sample(0)
    ref = vmapped_round_reference(params, apply_fn, src, ctl_idx, ctl_cfg, 0,
                                  device=dev)
    with torch.no_grad(), fp32_products():
        got_equal = equal_shape._round(params, 0)
        ragged = fleet(CONTROL_WIDTH)
        got = ragged._round(params, 0)
        hier = fleet(CONTROL_WIDTH, edges=8)
        hier_diff = abs_diff(hier._round(params, 0), got)
    checks["control_equal_shapes_bitwise"] = bitwise(got_equal, ref)
    ragged_rel = rel_diff(got, ref)
    checks["control_ragged_within_1e-6"] = ragged_rel <= TOL_RAGGED
    checks["hierarchical_matches_flat"] = hier_diff < TOL_EDGES

    # Multi-Krum over the streamed stack and over the all-at-once stack.
    with torch.no_grad(), fp32_products():
        kdef = fleet(CONTROL_WIDTH)
        streamed = kdef._collect_edge(params, 0, 0, ctl_idx).to(dev)
        xs, ys, ms = (torch.from_numpy(np.asarray(t)).to(dev)
                      for t in src.cohort(ctl_idx))
        whole = kdef._collect_cohort(params, xs, ys.long(), ms,
                                     kdef._generators(0, ctl_idx))
    sel_stream = sorted(int(i) for i in multi_krum(streamed, 8, 16))
    sel_whole = sorted(int(i) for i in multi_krum(whole, 8, 16))
    checks["krum_streamed_selection_matches"] = sel_stream == sel_whole
    checks["zero_retraces"] = all(
        w.retraces == 0 for s in (server, equal_shape, ragged, hier, kdef)
        for w in (s._stream_step, s._collect_step, s._secagg_step))
    checks["one_call_signature_per_stream_step"] = (
        len(server._stream_step.compiles) == 1)

    krum_probe = {}
    for n in (64, a.krum_probe_clients):
        flat = torch.from_numpy(np.random.default_rng(0).normal(
            size=(n, param_floats)).astype(np.float32)).to(dev)
        multi_krum(flat, n // 5, n // 4)            # warm-up
        synchronize(dev)
        t1 = time.perf_counter()
        multi_krum(flat, n // 5, n // 4)
        synchronize(dev)
        krum_probe[f"n{n}_seconds"] = time.perf_counter() - t1

    privacy = {
        "fleet_q1e-4": privacy_spend(1.0, 10000, 1e-4),
        "this_smoke": privacy_spend(
            1.0, 10000, min(1.0, cfg.clients_per_round / a.clients)),
    }
    if tel is not None:
        tel.close()
    return {
        "metric": "fleet_smoke",
        "device": str(dev),
        "clients": a.clients,
        "sampled_per_round": cfg.clients_per_round,
        "cohort_width": a.cohort,
        "edges": a.edges,
        "param_floats": param_floats,
        "round_wall_s": round_wall,
        "clients_per_s": cfg.clients_per_round / round_wall,
        "host_data_and_generators_s": host_s,
        "host_share": host_s / round_wall,
        "test_accuracy": acc,
        "memory_growth_bytes": growth,
        "memory_bound_bytes": (memory_bound if dev.type == "cuda"
                               else a.rss_budget_mb * 2**20),
        "cohort_bytes": cohort_bytes,
        "naive_resident_mb": naive_resident_mb,
        "control_ragged_bitwise": bitwise(got, ref),
        "control_ragged_rel_diff": ragged_rel,
        "hierarchical_max_diff": hier_diff,
        "krum_selection": sel_stream,
        "krum_probe": krum_probe,
        "privacy": privacy,
        "checks": checks,
        "ok": all(checks.values()),
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--clients", type=int, default=100_000)
    ap.add_argument("--cohort", type=int, default=64)
    ap.add_argument("--edges", type=int, default=1)
    ap.add_argument("--features", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rss-budget-mb", type=float, default=400.0,
                    help="on the CPU: the largest allowed growth of the "
                         "resident set over the round")
    ap.add_argument("--krum-probe-clients", type=int, default=512)
    ap.add_argument("--quick", action="store_true",
                    help="20,000 clients at most")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    ap.add_argument("--out", default=None, help="result JSON path")
    ap.add_argument("--telemetry-dir", default=None)
    a = ap.parse_args(argv)
    if a.quick:
        a.clients = min(a.clients, 20_000)
    return a


def main(argv=None) -> int:
    a = parse_args(argv)
    out = run(a)
    line = json.dumps(out)
    if a.out:
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(line)
    if not out["ok"]:
        failed = [k for k, v in out["checks"].items() if not v]
        print(f"fleet smoke FAILED checks: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
