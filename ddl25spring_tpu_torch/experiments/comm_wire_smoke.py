"""Comm-wire smoke: the overlapped and compressed sync's wire claims,
checked. Twin of the JAX package's ``experiments/comm_wire_smoke.py``.

Four ranks (``distributed.run_ranks``, one launch) build the ring step's
``int8_ef + zero1`` K-step composition beside the fp32 gradient all-reduce
on the same model, read both comm profiles (``telemetry.comm.measure_comm``:
one real call each; the port records collectives as they run) and check:

1. the compressed composition's wire bytes per train step are at most
   0.26 of the fp32 all-reduce's;
2. the ring accounting is exact: the int8 hops and their scale sidebands
   equal the analytic ``K·M·(n−1)·chunk_bytes`` to the byte;
3. no retrace over the mode grid (wire × microbatches at zero1, K steps
   per dispatch; ``introspect.watch`` sees one call signature each);
4. the hierarchical 2 × 2 layout (fp32 within each island, int8_ef
   across ``dcn``) keeps the DCN-axis bytes per step at most 0.30 of the
   flat fp32 all-reduce, with the DCN ring and the DCN leg of the int8
   delta gather exact to the analytic count, and no retrace at 1 × 4,
   2 × 2 and 4 × 1;
5. the bucket grid (``comm_buckets`` ∈ {1, 2, 8}): each bucket's ring legs
   exact, the fp32 total and the int8 chunk bytes invariant in the bucket
   count, every count under the 0.26 ratio and traced once; and the
   overlap evidence (``compress.ring_overlap_evidence``, from the step's
   record of its hops): at B = 8 the first hop rings before the layers'
   backward is done and B = 1 none does (the JAX smoke's check), and at
   M = 2 the first microbatch's hops are free too.

Writes a JSON result (``--out``); exits 1 when a check fails. On the card
by default (every rank shares it); ``--device cpu`` runs on the host.

    python -m ddl25spring_tpu_torch.experiments.comm_wire_smoke \\
        --out comm-wire.json
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..bench_utils import make_optimizer
from ..config import LlamaConfig
from ..models import llama
from ..parallel import compress, dp
from ..parallel import distributed as dist
from ..telemetry import introspect
from ..telemetry.comm import measure_comm
from ..tree import tree_copy

WORLD = 4
RATIO_BUDGET = 0.26
DCN_BUDGET = 0.30
CFG = dict(vocab_size=259, dmodel=32, num_heads=2, n_layers=2, ctx_size=16)
BSZ = 2                                   # rows per rank


def _rank(K: int, *, device) -> dict:
    """Every check on this rank (all four ranks run the same calls);
    returns rank 0's document."""
    cfg = LlamaConfig(**CFG)
    n, r = dist.world_size(), dist.get_rank()

    def loss_fn(p, b):
        return llama.forward_loss(p, b, cfg)

    def fresh():
        return llama.init_llama(cfg, torch.Generator().manual_seed(0),
                                device=device).tree()

    opt = lambda: make_optimizer("fused", 1e-3)  # noqa: E731
    rng = np.random.default_rng(0)
    window = rng.integers(0, cfg.vocab_size, (K, n * BSZ, cfg.ctx_size))
    local_w = dp.shard_batch_window(window, device=device)
    checks, rows, profiles = {}, [], {}

    base_state = dp.init_state(fresh(), opt())
    base_prof = measure_comm(dp.make_grad_aggregation_step(loss_fn, opt()),
                             base_state, local_w[0])
    base_wire = base_prof.wire_bytes_per_device_per_step
    profiles["f32_allreduce"] = base_prof.as_dict()
    rows.append({"metric": "wire_bytes_per_train_step", "value": base_wire,
                 "variant": "f32-allreduce"})

    cand_state, cand_step = compress.make_overlap_multi_step(
        loss_fn, opt(), fresh(), microbatches=1, wire="int8_ef",
        aggregation="zero1", device=device)
    cand_prof = measure_comm(cand_step, tree_copy(cand_state), local_w)
    cand_wire = cand_prof.wire_bytes_per_device_per_step / K
    profiles["int8ef_zero1_k"] = cand_prof.as_dict(steps_per_dispatch=K)
    rows.append({"metric": "wire_bytes_per_train_step", "value": cand_wire,
                 "variant": f"int8ef+zero1+k{K}"})
    ratio = cand_wire / base_wire
    checks["wire_ratio"] = {"value": ratio, "budget": RATIO_BUDGET,
                            "ok": ratio <= RATIO_BUDGET,
                            "f32_allreduce_bytes": base_wire,
                            "int8_ring_bytes": cand_wire}

    _, _, local, _ = dp._flat_geometry(fresh())
    by = cand_prof.by_label()
    got = {"payload": by["ring_grad_int8"]["payload_bytes"],
           "scales": by["ring_grad_scale"]["payload_bytes"],
           "wire": by["ring_grad_int8"]["wire_bytes_per_device"]}
    want = {"payload": K * (n - 1) * local, "scales": K * (n - 1) * 4,
            "wire": K * (n - 1) * local}
    checks["ring_analytic"] = {"got": got, "want": want, "ok": got == want}

    D, S = 2, 2
    hmesh = dist.hier_data_mesh(D, S)
    hwire = {"ici": "fp32", "dcn": "int8_ef"}
    hstate, hstep = compress.make_overlap_multi_step(
        loss_fn, opt(), fresh(), mesh=hmesh, microbatches=1, wire=hwire,
        aggregation="zero1", device=device)
    hprof = measure_comm(hstep, tree_copy(hstate), local_w)
    profiles["hier_fp32ici_int8dcn_zero1_k"] = hprof.as_dict(
        steps_per_dispatch=K)
    by_axis = hprof.by_axis()
    dcn_wire = by_axis["dcn"]["wire_bytes_per_device"] / K
    rows.append({"metric": "wire_bytes_dcn_per_train_step",
                 "value": dcn_wire, "variant": f"hier-int8dcn+zero1+k{K}"})
    dcn_ratio = dcn_wire / base_wire
    checks["hier_dcn_ratio"] = {
        "value": dcn_ratio, "budget": DCN_BUDGET,
        "ok": dcn_ratio <= DCN_BUDGET, "dcn_axis_bytes": dcn_wire,
        "by_axis": {ax: agg["wire_bytes_per_device"] / K
                    for ax, agg in by_axis.items()}}
    hby = hprof.by_label()
    got = {"ring_payload": hby["ring_grad_dcn_int8"]["payload_bytes"],
           "ring_scales": hby["ring_grad_dcn_scale"]["payload_bytes"],
           "ring_wire": hby["ring_grad_dcn_int8"]["wire_bytes_per_device"],
           "gather_wire":
               hby["overlap_delta_gather_int8"]["wire_bytes_per_device"]}
    want = {"ring_payload": K * (D - 1) * local,
            "ring_scales": K * (D - 1) * 4,
            "ring_wire": K * (D - 1) * local,
            "gather_wire": K * (D - 1) * local}
    checks["hier_dcn_analytic"] = {"got": got, "want": want,
                                   "ok": got == want}

    def watched_runs(name, state, step):
        step = introspect.watch(step, name=name, max_caches=1)
        loss = None
        for _ in range(3):
            state, losses = step(state, local_w)
            loss = float(losses[-1])
        return {"compiles": len(step.compiles),
                "retraces": sum(1 for c in step.compiles if c.retrace),
                "final_loss": loss,
                "ok": bool(len(step.compiles) == 1
                           and not any(c.retrace for c in step.compiles)
                           and np.isfinite(loss))}

    hier_grid = {}
    for hd, hs in ((1, 4), (2, 2), (4, 1)):
        st, fn = compress.make_overlap_multi_step(
            loss_fn, opt(), fresh(), mesh=dist.hier_data_mesh(hd, hs),
            microbatches=1, wire=hwire, aggregation="zero1", device=device)
        hier_grid[f"{hd}x{hs}"] = watched_runs(f"smoke/hier-{hd}x{hs}", st,
                                               fn)
    checks["hier_retraces"] = {
        "grid": hier_grid, "ok": all(v["ok"] for v in hier_grid.values())}

    grid = {}
    for wire in compress.WIRES:
        for m in (1, 2):
            st, fn = compress.make_overlap_multi_step(
                loss_fn, opt(), fresh(), microbatches=m, wire=wire,
                aggregation="zero1", device=device)
            grid[f"{wire}-m{m}"] = watched_runs(f"smoke/{wire}-m{m}", st, fn)
    checks["retraces"] = {"grid": grid,
                          "ok": all(v["ok"] for v in grid.values())}

    bucket_grid, fp32_totals, int8_chunks = {}, {}, {}
    for b in (1, 2, 8):
        sizes = compress.make_bucket_map(fresh(), n, b).sizes
        fst, ffn = compress.make_overlap_multi_step(
            loss_fn, opt(), fresh(), microbatches=1, wire="fp32",
            aggregation="zero1", comm_buckets=b, device=device)
        fp32_totals[b] = measure_comm(
            ffn, fst, local_w).wire_bytes_per_device_per_step
        st, fn = compress.make_overlap_multi_step(
            loss_fn, opt(), fresh(), microbatches=1, wire="int8_ef",
            aggregation="zero1", comm_buckets=b, device=device)
        prof = measure_comm(fn, tree_copy(st), local_w)
        runs = watched_runs(f"smoke/int8-b{b}", st, fn)
        byb = prof.by_label()
        per_bucket, chunk_total = {}, 0
        for i, sz in enumerate(sizes):
            stem = "ring_grad" if b == 1 else f"ring_grad_b{i}"
            gp = int(byb[f"{stem}_int8"]["payload_bytes"])
            gs = int(byb[f"{stem}_scale"]["payload_bytes"])
            chunk_total += gp
            per_bucket[stem] = {
                "payload": {"got": gp, "want": K * (n - 1) * sz},
                "scales": {"got": gs, "want": K * (n - 1) * 4},
                "ok": gp == K * (n - 1) * sz and gs == K * (n - 1) * 4}
        int8_chunks[b] = chunk_total
        wire_b = prof.wire_bytes_per_device_per_step / K
        bucket_grid[f"b{b}"] = {
            "per_bucket": per_bucket, "wire_bytes_per_step": wire_b,
            "wire_ratio_vs_f32": wire_b / base_wire, **runs,
            "ok": bool(all(v["ok"] for v in per_bucket.values())
                       and wire_b / base_wire <= RATIO_BUDGET
                       and runs["ok"])}
        rows.append({"metric": "wire_bytes_per_train_step", "value": wire_b,
                     "variant": f"int8ef+zero1+k{K}-b{b}"})

    ev = {}
    batch1 = local_w[0]
    for name, m, b in (("m1_b1", 1, 1), ("m2_b1", 2, 1), ("m1_b8", 1, 8)):
        st, fn = compress.make_overlap_step(
            loss_fn, opt(), fresh(), microbatches=m, wire="int8_ef",
            aggregation="zero1", comm_buckets=b, device=device)
        ev[name] = compress.ring_overlap_evidence(fn, st, batch1)
    checks["bucket_grid"] = {
        "grid": bucket_grid,
        "fp32_wire_invariant": len(set(fp32_totals.values())) == 1,
        "int8_chunk_invariant": len(set(int8_chunks.values())) == 1,
        "overlap_evidence": ev,
        "ok": (all(v["ok"] for v in bucket_grid.values())
               and len(set(fp32_totals.values())) == 1
               and len(set(int8_chunks.values())) == 1
               and ev["m1_b8"]["first_hop_independent"]
               and not ev["m1_b1"]["first_hop_independent"]
               and ev["m1_b8"]["overlap_fraction"]
               > ev["m1_b1"]["overlap_fraction"]
               and ev["m2_b1"]["first_hop_independent"])}
    rows.append({"metric": "overlap_fraction",
                 "value": ev["m1_b8"]["overlap_fraction"],
                 "variant": "int8ef+zero1-b8"})
    if r != 0:
        return {}
    return {"ok": all(c["ok"] for c in checks.values()), "n_ranks": n,
            "steps_per_dispatch": K, "model": CFG, "checks": checks,
            "rows": rows, "profiles": profiles}


def run(out_path: str, K: int = 4, device=None) -> int:
    from . import comm_wire_smoke as mod     # picklable by its import path
    doc = dist.run_ranks(mod._rank, WORLD, K, device=device,
                         timeout=1800)[0]
    platform = str(dist.rank_device(device, 0).type)
    doc["platform"] = platform
    for row in doc["rows"]:
        row.update(unit="bytes/device/step" if row["metric"].startswith(
            "wire") else "fraction", platform=platform)
    with open(out_path, "w") as f:
        json.dump(doc, f, indent=2)
    c = doc["checks"]
    print(f"comm-wire smoke ({platform}, {WORLD} ranks, K={K}): ratio "
          f"{c['wire_ratio']['value']:.3f} (budget {RATIO_BUDGET}), dcn "
          f"ratio {c['hier_dcn_ratio']['value']:.3f} (budget {DCN_BUDGET}), "
          f"ring accounting {'exact' if c['ring_analytic']['ok'] else 'WRONG'}"
          f", dcn accounting "
          f"{'exact' if c['hier_dcn_analytic']['ok'] else 'WRONG'}, buckets "
          f"{'exact' if c['bucket_grid']['ok'] else 'WRONG'}, overlap b8 "
          f"{c['bucket_grid']['overlap_evidence']['m1_b8']['overlap_fraction']:.2f}"
          f", retraces {'clean' if c['retraces']['ok'] and c['hier_retraces']['ok'] else 'DIRTY'}"
          f" -> {out_path}", file=sys.stderr)
    return 0 if doc["ok"] else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="comm-wire.json",
                    help="result JSON path")
    ap.add_argument("--steps-per-dispatch", type=int, default=4,
                    help="K steps per dispatch of the K-step loop")
    ap.add_argument("--quick", action="store_true",
                    help="K = 2 (the CPU test's size)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    a = ap.parse_args(argv)
    return run(a.out, 2 if a.quick else a.steps_per_dispatch, a.device)


if __name__ == "__main__":
    sys.exit(main())
