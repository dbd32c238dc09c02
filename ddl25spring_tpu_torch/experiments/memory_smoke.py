"""Memory smoke: the byte accounting of training and serving, armed end to
end, with its checks. Twin of the JAX package's
``experiments/memory_smoke.py``.

One process trains a tiny Llama (``train_llm_dp``, one rank) and serves
another through the paged engine, each with its ``MemoryMeter`` armed, and
checks:

- the meter costs nothing: the metered training run's losses are bitwise
  an unmetered run's, the metered scheduler's streams bitwise an
  unmetered one's, and no compile event is a retrace;
- the preflight (the manifest's estimate from the configs alone) gives the
  state's bytes within 10% of the live state's (parameters and optimizer
  moments, read from the final checkpoint's state);
- the stream's ``memory`` events are valid, come from both ``train`` and
  ``serve``, and the serving ones carry the pool census (holes, largest
  free run, pool bytes in use).

The JAX smoke trains on four data ranks with ZeRO-1 (its preflight is held
to the compiled program's argument bytes, which eager PyTorch does not
have) and gates the stream with ``experiments/slo_monitor.py``, which
imports the JAX package: this twin runs one rank and writes the stream
(``--telemetry-dir``) for the monitor to read. Writes a JSON result
(``--out``); exits 1 when a check fails.

    python -m ddl25spring_tpu_torch.experiments.memory_smoke \\
        --out memory-smoke.json --telemetry-dir memory-telemetry
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile

import numpy as np
import torch

from ..config import LlamaConfig, TrainConfig
from ..device import resolve_device
from ..models import llama
from ..serving import Engine, PagedKVConfig, Request, Scheduler
from ..telemetry import Telemetry, read_events, validate_event
from ..telemetry.memory import tree_state_bytes
from ..tokenizers import ByteTokenizer
from ..train.llm import train_llm_dp

TOL_PREFLIGHT = 0.10


def run(out_path: str, telemetry_dir=None, iters: int = 6,
        device=None) -> int:
    dev = resolve_device(device)
    tiny = LlamaConfig(vocab_size=259, dmodel=16, num_heads=2, n_layers=2,
                       ctx_size=16)
    serve_cfg = LlamaConfig(vocab_size=97, dmodel=32, num_heads=4,
                            n_layers=2, ctx_size=32)
    paged = PagedKVConfig(num_blocks=24, block_len=4, max_blocks_per_seq=8)
    tc = TrainConfig(batch_size=2, seq_len=16, lr=3e-3, iters=iters,
                     steps_per_dispatch=2)
    checks = {}

    # ---- training: metered against bare, bitwise -----------------------
    live = {}

    def keep_final(step, state):
        live["state_bytes"] = (tree_state_bytes(state.params)
                               + tree_state_bytes(state.opt_state))

    def train(tel, ckpt=None):
        return train_llm_dp(tiny, tc, tokenizer=ByteTokenizer(),
                            log_every=0, telemetry=tel, device=dev,
                            **({} if ckpt is None else dict(
                                checkpoint_dir=ckpt,
                                checkpoint_every=1000,
                                on_checkpoint=keep_final)))

    bare = train(None)
    telemetry = Telemetry(telemetry_dir or out_path + ".telemetry")
    with tempfile.TemporaryDirectory() as ckpt:
        metered = train(telemetry, ckpt)
    checks["train_losses_bitwise"] = (
        list(metered.losses) == list(bare.losses)
        and bool(np.isfinite(metered.losses).all()))

    # ---- serving: the meter armed against off, bitwise -----------------
    params = llama.init_llama(serve_cfg, torch.Generator().manual_seed(0),
                              device=dev)
    g = np.random.default_rng(3)
    workload = [Request(rid=f"r{i}",
                        prompt=tuple(int(t) for t in
                                     g.integers(1, 97, size=4 + i % 5)),
                        max_new=3 + i % 4)
                for i in range(8)]

    def serve(events, memory_every):
        eng = Engine(params, serve_cfg, paged, 2, prefill_chunk=4,
                     device=dev)
        sched = Scheduler(eng, events=events, memory_every=memory_every,
                          clock=lambda: 0.0)
        for req in workload:
            sched.submit(req, now=0.0)
        while sched.outstanding:
            sched.tick()
        return sched

    srv_metered = serve(telemetry.events, memory_every=2)
    srv_plain = serve(None, memory_every=0)
    checks["serve_streams_bitwise"] = all(
        srv_metered.records[r.rid].tokens == srv_plain.records[r.rid].tokens
        for r in workload)
    telemetry.close()

    # ---- the stream ----------------------------------------------------
    stream = read_events(telemetry.events_path)
    mems = [e for e in stream if e.get("type") == "memory"]
    sources = {e.get("source") for e in mems}
    checks["memory_events_valid"] = (
        bool(mems) and all(validate_event(e) == [] for e in mems))
    checks["both_sources_sampled"] = {"train", "serve"} <= sources
    serve_mems = [e for e in mems if e.get("source") == "serve"]
    checks["pool_census_present"] = bool(serve_mems) and all(
        "holes" in e and "largest_run" in e and "pool_used_bytes" in e
        for e in serve_mems)

    # ---- the preflight against the live state -------------------------
    manifest = next((e for e in stream if e.get("type") == "manifest"), {})
    pre = manifest.get("preflight") or {}
    fit = {}
    if pre and live:
        fit = {"predicted_state_bytes": pre["state_bytes"],
               "live_state_bytes": live["state_bytes"],
               "rel_err": abs(live["state_bytes"] - pre["state_bytes"])
               / pre["state_bytes"]}
    checks["preflight_within_10pct"] = bool(fit) and (
        fit["rel_err"] < TOL_PREFLIGHT)
    compiles = [e for e in stream if e.get("type") == "compile"]
    checks["zero_retraces"] = all(not e.get("retrace") for e in compiles)

    def peak(source, field):
        vals = [e[field] for e in mems if e.get("source") == source
                and isinstance(e.get(field), (int, float))]
        return float(max(vals)) if vals else 0.0

    result = {
        "ok": all(checks.values()),
        "device": str(dev),
        "iters": iters,
        "preflight": pre,
        "fit": fit,
        "memory_events": len(mems),
        "sources": sorted(s for s in sources if s),
        "peak_device_bytes": max((e.get("device_bytes", 0) for e in mems),
                                 default=0),
        "peaks": {"train_device_bytes": peak("train", "device_bytes"),
                  "serve_device_bytes": peak("serve", "device_bytes"),
                  "serve_pool_used_bytes": peak("serve", "pool_used_bytes")},
        "checks": checks,
    }
    with open(out_path, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result, indent=2))
    if not result["ok"]:
        failed = [k for k, v in checks.items() if not v]
        print(f"memory smoke FAILED checks: {failed}", file=sys.stderr)
    return 0 if result["ok"] else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="memory-smoke.json",
                    help="result JSON path")
    ap.add_argument("--telemetry-dir", default=None,
                    help="write the train and serve events.jsonl here")
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    a = ap.parse_args(argv)
    return run(a.out, a.telemetry_dir, a.iters, a.device)


if __name__ == "__main__":
    sys.exit(main())
