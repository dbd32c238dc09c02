"""Serving smoke and load bench: seeded Poisson traffic through the port's
engine or fleet, with its checks. Twin of the JAX package's
``experiments/serving_bench.py``.

Single engine (the default): ~100 seeded Poisson requests of mixed prompt
and output lengths through the continuous-batching scheduler, checking
that every request retires with exactly ``max_new`` tokens, that the
telemetry stream carries each token once, that a sample of the streams
equals ``generate()`` run alone on its request, that the allocator stays
inside a pool sized below the slots' worst case (so admissions queue and
completing them all shows no deadlock) and that the pool's bytes stay
below separate ``max_len`` caches; the span tree of every request is
complete. ``--speculate K`` runs the workload again through one slot,
plain and speculating with a same-weights draft (acceptance exactly 1,
greedy streams equal, the compile sets 2 and 4, no retrace, tokens per
dispatch at least twice plain's at K ≥ 3); ``--prefix-share`` and
``--gather-buckets`` arm copy-on-write prefix sharing and gather narrowing
(streams must not move; the bytes saved are reported).

``--engines N`` (N > 1): a two-class multi-tenant workload across N
engines behind the router (``--policy``, ``--admission``), with
``--hot-swap`` publishing the same weights mid-run through the deploy
path (checkpoint, digest-checked restore, one engine swapped per tick):
every engine used, two programs each and no retrace across the swap, the
deploy rolled out to every engine and its events in the stream, streams
equal ``generate()``'s.

The JAX smoke also replays the stream through ``experiments/slo_monitor.py``
and exports it with ``experiments/trace_export.py``; both import the JAX
package, so this twin writes the stream (``--telemetry-dir``) for them to
read instead. Writes one JSON line (``--out``); exits 1 when a check fails.

    python -m ddl25spring_tpu_torch.experiments.serving_bench --out s.json
    python -m ddl25spring_tpu_torch.experiments.serving_bench --engines 3 \\
        --hot-swap --telemetry-dir /tmp/fleet
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ..config import LlamaConfig
from ..device import resolve_device
from ..models import llama
from ..serving import (CheckpointPublisher, PagedKVConfig, SpecConfig,
                       TrafficClass, WeightPublisher, blocks_for,
                       multi_tenant_workload, naive_cache_bytes,
                       reference_stream, run_serving, run_serving_fleet,
                       synthetic_workload)
from ..telemetry import Telemetry, read_events, trace_trees, tree_check


def _stream_no_drop_no_dup(stream, workload) -> bool:
    """Every (request, index) token exactly once in the event stream."""
    seen = {}
    for e in stream:
        if e.get("type") == "request_token":
            seen.setdefault(e["req"], []).append(e["i"])
    return all(sorted(seen.get(r.rid, [])) == list(range(r.max_new))
               for r in workload)


def _bitwise_sample(workload, recs, params, cfg, paged, *, seed, verify,
                    device):
    """Streams of a seeded sample of requests against ``generate()`` run
    alone on each: (sample size, mismatched request ids)."""
    g = np.random.default_rng(seed + 1)
    sample = (list(workload) if verify >= len(workload) else
              [workload[i] for i in g.choice(len(workload), verify,
                                             replace=False)])
    mismatches = [r.rid for r in sample
                  if reference_stream(params, cfg, paged, r, device=device)
                  != recs[r.rid].tokens]
    return len(sample), mismatches


def _build(seed: int, device):
    """The JAX smoke's reduced model: the checks are structural, so width
    only costs time."""
    cfg = LlamaConfig(vocab_size=512, dmodel=64, num_heads=2, n_layers=2,
                      ctx_size=64, attention_impl="xla")
    return cfg, llama.init_llama(cfg, torch.Generator().manual_seed(seed),
                                 device=device)


def _manifest(events, **fields) -> None:
    events.manifest(jax_version=None, torch_version=torch.__version__,
                    **fields)


def run(a) -> dict:
    dev = resolve_device(a.device)
    cfg, params = _build(a.seed, dev)
    paged = PagedKVConfig(num_blocks=a.blocks, block_len=a.block_len,
                          max_blocks_per_seq=a.max_blocks_per_seq)
    prompt_lens, max_news = (4, 12, 24), (4, 8, 16)
    workload = synthetic_workload(
        seed=a.seed, n_requests=a.requests, rate_rps=a.rate,
        vocab_size=cfg.vocab_size, prompt_lens=prompt_lens,
        max_news=max_news, temperatures=(0.0, 0.8))
    worst = blocks_for(max(prompt_lens) + max(max_news) - 1, a.block_len)
    naive_peak_blocks = a.slots * worst
    checks = {"pool_below_naive_demand":
              paged.num_blocks - 1 < naive_peak_blocks}

    tel = Telemetry(a.telemetry_dir) if a.telemetry_dir else None
    events = tel.events if tel else None
    if events:
        _manifest(events, platform=dev.type, trainer="serving",
                  slots=a.slots, blocks=a.blocks, block_len=a.block_len,
                  requests=a.requests)
    t0 = time.perf_counter()
    report = run_serving(params, cfg, paged, workload, num_slots=a.slots,
                         prefill_chunk=a.prefill_chunk, events=events,
                         prefix_share=a.prefix_share,
                         gather_buckets=a.gather_buckets, device=dev)
    wall = time.perf_counter() - t0

    spec_block = None
    if a.speculate:
        # One slot, every request at t=0: the dispatch-bound regime where
        # plain decoding is exactly one token per dispatch and speculation
        # multiplies it by the accepted window.
        saturated = [dataclasses.replace(r, arrival=0.0) for r in workload]
        kw = dict(num_slots=1, prefill_chunk=a.prefill_chunk,
                  prefix_share=a.prefix_share,
                  gather_buckets=a.gather_buckets, device=dev)
        plain_sat = run_serving(params, cfg, paged, saturated, **kw)
        spec_tel = (Telemetry(os.path.join(a.telemetry_dir, "spec"))
                    if a.telemetry_dir else None)
        spec_report = run_serving(
            params, cfg, paged, saturated,
            events=spec_tel.events if spec_tel else None,
            speculate=SpecConfig(k=a.speculate, draft_params=params), **kw)
        if spec_tel:
            spec_tel.close()
            spec_stream = read_events(spec_tel.events_path)
            checks["spec_events_per_dispatch"] = (
                sum(e.get("type") == "speculate" for e in spec_stream)
                == spec_report.decode_dispatches)
            checks["spec_stream_no_drop_no_dup"] = _stream_no_drop_no_dup(
                spec_stream, workload)
        checks["spec_greedy_streams_identical"] = all(
            spec_report.records[r.rid].tokens == report.records[r.rid].tokens
            for r in workload if r.temperature == 0.0)
        checks["spec_zero_retraces_on_off_grid"] = (
            report.retraces == 0 and plain_sat.retraces == 0
            and spec_report.retraces == 0)
        if not a.gather_buckets:
            checks["spec_compile_contract"] = (report.compiles == 2
                                               and spec_report.compiles == 4)
        checks["spec_acceptance_sane"] = (
            spec_report.acceptance_rate is not None
            and 0.0 <= spec_report.acceptance_rate <= 1.0)
        checks["spec_acceptance_is_one_for_same_weights"] = (
            spec_report.acceptance_rate == 1.0)
        if a.speculate >= 3:
            checks["spec_tokens_per_dispatch_2x"] = (
                spec_report.tokens_per_dispatch
                >= 2 * plain_sat.tokens_per_dispatch)
        spec_block = {
            "k": a.speculate,
            "tokens_per_dispatch": spec_report.tokens_per_dispatch,
            "tokens_per_dispatch_plain": plain_sat.tokens_per_dispatch,
            "acceptance_rate": spec_report.acceptance_rate,
            "decode_dispatches": spec_report.decode_dispatches,
            "decode_dispatches_plain": plain_sat.decode_dispatches,
            "draft_dispatches": spec_report.draft_dispatches,
            "sustained_tokens_per_sec":
                spec_report.aggregates.get("sustained_tokens_per_sec"),
        }

    recs = report.records
    checks["all_completed"] = (
        report.aggregates.get("completed") == a.requests)
    checks["token_counts_exact"] = all(
        len(recs[r.rid].tokens) == r.max_new for r in workload)
    tree_problems = None
    if events:
        events.run_end(steps=report.aggregates.get("completed", 0),
                       wall_s=wall, **{
                           k: report.aggregates.get(k) for k in
                           ("total_tokens", "sustained_tokens_per_sec")})
        tel.close()
        stream = read_events(tel.events_path)
        checks["stream_no_drop_no_dup"] = _stream_no_drop_no_dup(stream,
                                                                 workload)
        trees = trace_trees(stream)
        tree_problems = []
        for r in workload:
            t = trees.get(r.rid)
            c = tree_check(t) if t is not None else None
            if c is None or c["roots"] != 1 or c["orphans"] != 0:
                tree_problems.append(r.rid)
        checks["span_trees_complete"] = not tree_problems

    n_verified, mismatches = _bitwise_sample(
        workload, recs, params, cfg, paged, seed=a.seed, verify=a.verify,
        device=dev)
    checks["bitwise_parity_vs_generate"] = not mismatches
    checks["pool_never_exceeded"] = (report.peak_blocks_in_use
                                     <= report.pool_blocks)
    checks["zero_retraces"] = report.retraces == 0
    if not a.gather_buckets:
        # Narrowing adds one decode program per gather width (5 in both
        # packages at --quick), which the JAX smoke's check does not allow
        # for.
        checks["two_compiled_programs"] = report.compiles == 2
    checks["kv_bytes_below_naive"] = (
        report.pool_bytes < naive_cache_bytes(cfg, a.slots,
                                              paged.max_seq_len))
    if report.peak_concurrency >= a.slots:
        checks["kv_bytes_below_naive_at_observed_peak"] = (
            report.pool_bytes < report.naive_bytes_at_peak)

    out = {
        "metric": "serving_smoke",
        "device": str(dev),
        "requests": a.requests,
        "slots": a.slots,
        "pool_blocks": report.pool_blocks,
        "peak_blocks_in_use": report.peak_blocks_in_use,
        "peak_concurrency": report.peak_concurrency,
        "pool_bytes": report.pool_bytes,
        "naive_bytes_at_peak": report.naive_bytes_at_peak,
        "naive_peak_blocks": naive_peak_blocks,
        "wall_s": wall,
        "compiles": report.compiles,
        "retraces": report.retraces,
        "verified_bitwise": n_verified,
        "parity_mismatches": mismatches,
        "span_tree_problems": tree_problems,
        "aggregates": report.aggregates,
        "tokens_per_dispatch": report.tokens_per_dispatch,
        "speculate": spec_block,
        "prefix_share": bool(a.prefix_share),
        "gather_bytes_saved": report.gather_bytes_saved,
        "checks": checks,
        "ok": all(checks.values()),
    }
    if spec_block is not None:
        out["spec_tokens_per_dispatch"] = spec_block["tokens_per_dispatch"]
    return out


def run_fleet(a) -> dict:
    """The N-engine fleet smoke (module docstring)."""
    dev = resolve_device(a.device)
    cfg, params = _build(a.seed, dev)
    paged = PagedKVConfig(num_blocks=a.blocks, block_len=a.block_len,
                          max_blocks_per_seq=a.max_blocks_per_seq)
    # Latency-sensitive chat (higher priority) and throughput batch; the
    # SLO ceilings are generous: the verdict is slo_monitor's, over the
    # stream.
    classes = (
        TrafficClass("chat", rate_rps=a.rate * 2 / 3, prompt_lens=(4, 12),
                     max_news=(4, 8), temperatures=(0.0, 0.8), priority=1,
                     ttft_p99_s=120.0, queue_p99_s=120.0),
        TrafficClass("batch", rate_rps=a.rate / 3, prompt_lens=(12, 24),
                     max_news=(8, 16), temperatures=(0.0,), priority=0,
                     ttft_p99_s=240.0, queue_p99_s=240.0),
    )
    n_chat = (a.requests * 2) // 3
    workload = multi_tenant_workload(
        seed=a.seed, classes=classes,
        n_per_class={"chat": n_chat, "batch": a.requests - n_chat},
        vocab_size=cfg.vocab_size)
    checks = {"pool_below_naive_demand": (
        paged.num_blocks - 1 < a.slots * blocks_for(24 + 16 - 1,
                                                    a.block_len))}

    tel = Telemetry(a.telemetry_dir) if a.telemetry_dir else None
    events = tel.events if tel else None
    if events:
        _manifest(events, platform=dev.type, trainer="serving-fleet",
                  engines=a.engines, slots=a.slots, blocks=a.blocks,
                  block_len=a.block_len, requests=len(workload),
                  policy=a.policy, admission=a.admission)

    # The mid-run publication goes through the deploy path: the same
    # weights, saved, digest-checked and restored at the saved shapes.
    publish_after = publish_params = publish_version = None
    if a.hot_swap:
        pub_dir = os.path.join(a.telemetry_dir or tempfile.mkdtemp(),
                               "publish")
        tree = llama.as_tree(params)
        with CheckpointPublisher(pub_dir) as pub:
            pub(1200, tree)                # "the trainer's step 1200"
        got = WeightPublisher(pub_dir, tree).poll()
        checks["publish_roundtrip"] = got is not None
        if got is not None:
            publish_version, publish_params = got
            publish_after = max(1, a.requests // 3)

    spec = (SpecConfig(k=a.speculate, draft_params=params)
            if a.speculate else None)
    t0 = time.perf_counter()
    report = run_serving_fleet(
        params, cfg, paged, workload, num_engines=a.engines,
        num_slots=a.slots, prefill_chunk=a.prefill_chunk, events=events,
        policy=a.policy, admission=a.admission, speculate=spec,
        prefix_share=a.prefix_share, publish_after=publish_after,
        publish_params=publish_params, publish_version=publish_version,
        device=dev)
    wall = time.perf_counter() - t0

    recs = report.records
    checks["all_completed"] = (report.aggregates.get("completed")
                               == len(workload))
    checks["token_counts_exact"] = all(
        len(recs[r.rid].tokens) == r.max_new for r in workload)
    checks["engines_all_used"] = all(
        agg["completed"] > 0 for agg in report.per_engine.values())
    want_programs = 4 if a.speculate else 2
    checks["documented_programs_per_engine"] = all(
        c == want_programs for c in report.compiles)
    checks["zero_retraces_per_engine"] = all(r == 0 for r in report.retraces)
    if a.hot_swap:
        checks["deploy_rolled_out_all_engines"] = (
            sorted(d["engine"] for d in report.deploys)
            == list(range(a.engines)))
    if events:
        events.run_end(steps=report.aggregates.get("completed", 0),
                       wall_s=wall, **{
                           k: report.aggregates.get(k) for k in
                           ("total_tokens", "sustained_tokens_per_sec")})
        tel.close()
        stream = read_events(tel.events_path)
        checks["stream_no_drop_no_dup"] = _stream_no_drop_no_dup(stream,
                                                                 workload)
        if a.hot_swap:
            checks["deploy_events_per_engine"] = sorted(
                e.get("engine") for e in stream
                if e.get("type") == "deploy") == list(range(a.engines))
            checks["deploy_spans_in_stream"] = any(
                e.get("type") == "span" and e.get("name") == "deploy"
                for e in stream)

    # Greedy streams only under speculation (sampled ones agree in
    # distribution, not path).
    pool = ([r for r in workload if r.temperature == 0.0]
            if a.speculate else workload)
    n_verified, mismatches = _bitwise_sample(
        pool, recs, params, cfg, paged, seed=a.seed, verify=a.verify,
        device=dev)
    checks["bitwise_parity_vs_generate"] = not mismatches
    checks["pool_never_exceeded"] = all(
        p <= report.pool_blocks for p in report.peak_blocks_per_engine)
    return {
        "metric": "fleet_serving_smoke",
        "device": str(dev),
        "engines": a.engines,
        "policy": a.policy,
        "admission": a.admission,
        "requests": len(workload),
        "hot_swap": bool(a.hot_swap),
        "deploys": report.deploys,
        "pool_blocks": report.pool_blocks,
        "peak_blocks_per_engine": report.peak_blocks_per_engine,
        "compiles": report.compiles,
        "retraces": report.retraces,
        "wall_s": wall,
        "verified_bitwise": n_verified,
        "parity_mismatches": mismatches,
        "aggregates": report.aggregates,
        "per_class": report.per_class,
        "per_engine": {str(k): v for k, v in report.per_engine.items()},
        "checks": checks,
        "ok": all(checks.values()),
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=100)
    ap.add_argument("--rate", type=float, default=50.0,
                    help="Poisson arrival rate (requests/sec)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--blocks", type=int, default=33,
                    help="pool blocks incl. the reserved trash block")
    ap.add_argument("--block-len", type=int, default=8)
    ap.add_argument("--max-blocks-per-seq", type=int, default=8)
    ap.add_argument("--prefill-chunk", type=int, default=8)
    ap.add_argument("--verify", type=int, default=12,
                    help="requests to check against generate()")
    ap.add_argument("--speculate", type=int, default=0, metavar="K",
                    help="single engine: a second pass speculating with a "
                         "same-weights draft proposing K tokens a round")
    ap.add_argument("--prefix-share", action="store_true",
                    help="copy-on-write prefix sharing (streams must not "
                         "move)")
    ap.add_argument("--gather-buckets", action="store_true",
                    help="narrow the decode gather to bucketed live block "
                         "counts; the bytes saved land in the JSON")
    ap.add_argument("--quick", action="store_true",
                    help="30 requests, 6 checked")
    ap.add_argument("--engines", type=int, default=1,
                    help="serving engines; > 1 runs the fleet smoke")
    ap.add_argument("--policy", default="predicted_ttft",
                    choices=("least_loaded", "predicted_ttft"))
    ap.add_argument("--admission", default="fcfs", choices=("fcfs", "sjf"))
    ap.add_argument("--hot-swap", action="store_true",
                    help="fleet: one mid-run publication of the same "
                         "weights through the deploy path")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    ap.add_argument("--out", default=None, help="result JSON path")
    ap.add_argument("--telemetry-dir", default=None)
    a = ap.parse_args(argv)
    if a.quick:
        a.requests = min(a.requests, 30)
        a.verify = min(a.verify, 6)
    return a


def main(argv=None) -> int:
    a = parse_args(argv)
    out = run_fleet(a) if a.engines > 1 else run(a)
    line = json.dumps(out)
    if a.out:
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(line)
    if not out["ok"]:
        failed = [k for k, v in out["checks"].items() if not v]
        print(f"serving smoke FAILED checks: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
