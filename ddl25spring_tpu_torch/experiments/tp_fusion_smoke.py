"""TP-fusion smoke: the tensor-parallel composition's claims, checked. Twin
of the JAX package's ``experiments/tp_fusion_smoke.py``.

Four ranks laid out ``data=2 × model=2`` (``distributed.run_ranks``, one
launch) read their comm profiles (``telemetry.comm.measure_comm``: one
real call each; the port records collectives as they run) and check:

1. the model-axis activation wire of the relaxed PSA modes
   (``TrainConfig.psa`` = "defer:2", "int8_ef") is at most the analytic
   budget (``tp.psa_sync_wire_bytes``) and below the full-sync baseline
   measured in the same run (``psa="full"``, which must equal its budget);
2. the DP×TP ring and delta-gather accounting of the ``int8_ef + zero1``
   K-step driver (``tp.make_tp_overlap_multi_step``) is exact: the int8
   hops, their scale sidebands and the delta gather equal
   ``K·M·(n−1)·chunk_bytes`` to the byte;
3. no retrace over the psa × K grid (``tp.make_tp_multi_step``) and the
   wire × K grid at zero1 (the ring driver): ``introspect.watch`` sees one
   call signature each over three dispatches;
4. the trainer's compile events carry the window size: ``train_llm_tp``
   at 3 steps and K = 2 compiles twice, stamped 2 and 1.

Writes a JSON result (``--out``); exits 1 when a check fails. On the card
by default (every rank shares it); ``--device cpu`` runs on the host.

    python -m ddl25spring_tpu_torch.experiments.tp_fusion_smoke \\
        --out tp-fusion.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

from ..bench_utils import make_optimizer
from ..config import LlamaConfig, TrainConfig
from ..models import llama
from ..parallel import distributed as dist
from ..parallel import tp
from ..telemetry import introspect
from ..telemetry.comm import measure_comm
from ..tokenizers import ByteTokenizer
from ..tree import tree_copy

N_DATA, TP = 2, 2
CFG = dict(vocab_size=259, dmodel=32, num_heads=2, n_layers=4, ctx_size=16)
BSZ = 4                                   # rows per data row
PSA_LABELS = ("psa_full_sync", "psa_defer_sync", "psa_act_int8",
              "psa_act_scale")


def _watched_runs(make, name: str, window) -> dict:
    """Three dispatches of a fresh step over ``window`` under a
    ``CompileWatch`` of one signature."""
    state, step = make()
    step = introspect.watch(step, name=name, max_caches=1)
    loss = None
    for _ in range(3):
        state, losses = step(state, window)
        loss = float(losses[-1])
    return {"compiles": len(step.compiles),
            "retraces": sum(1 for c in step.compiles if c.retrace),
            "final_loss": loss,
            "ok": bool(len(step.compiles) == 1
                       and not any(c.retrace for c in step.compiles)
                       and np.isfinite(loss))}


def _rank(K: int, telemetry, *, device) -> dict:
    """One rank's part: every check's measurements; rank 0 returns the
    result document."""
    mesh = dist.tp_mesh(N_DATA, TP)
    cfg = LlamaConfig(**CFG)
    n = mesh.data

    def fresh():
        return llama.init_llama(cfg, torch.Generator().manual_seed(0),
                                device="cpu").tree()

    def opt():
        return make_optimizer("fused", 1e-3)

    bshape = (BSZ, cfg.ctx_size)
    batch = torch.zeros(bshape, dtype=torch.long, device=device)
    window = torch.zeros((K,) + bshape, dtype=torch.long, device=device)
    checks, rows, profiles = {}, [], {}

    # 1. PSA: measured model-axis activation wire against the budget.
    def psa_wire(psa):
        state, step = tp.make_tp_step(cfg, opt(), mesh, fresh(), psa=psa,
                                      batch_shape=bshape, device=device)
        prof = measure_comm(step, tree_copy(state), batch)
        by = prof.by_label()
        return sum(by[k]["wire_bytes_per_device"] for k in PSA_LABELS
                   if k in by), prof

    modes = {}
    full_wire, full_prof = psa_wire("full")
    profiles["tp_psa_full"] = full_prof.as_dict()
    full_budget = tp.psa_sync_wire_bytes(cfg, "full", TP, *bshape)
    modes["full"] = {"measured": full_wire, "budget": full_budget,
                     "ok": full_wire == full_budget}
    rows.append({"metric": "wire_bytes_model_per_train_step",
                 "value": full_wire, "variant": "tp2-psa-full"})
    for psa in ("defer:2", "int8_ef"):
        wire, prof = psa_wire(psa)
        budget = tp.psa_sync_wire_bytes(cfg, psa, TP, *bshape)
        modes[psa] = {"measured": wire, "budget": budget,
                      "full_sync_measured": full_wire,
                      "reduction_vs_full": wire / full_wire,
                      "ok": bool(wire <= budget and wire < full_wire)}
        profiles[f"tp_psa_{psa.replace(':', '')}"] = prof.as_dict()
        rows.append({"metric": "wire_bytes_model_per_train_step",
                     "value": wire,
                     "variant": f"tp2-psa-{psa.replace(':', '')}"})
    checks["psa_wire_budget"] = {
        "modes": modes, "ok": all(v["ok"] for v in modes.values())}

    # 2. exact DP×TP ring and gather accounting.
    state, step = tp.make_tp_overlap_multi_step(
        cfg, opt(), mesh, fresh(), aggregation="zero1", wire="int8_ef",
        overlap_microbatches=1, device=device)
    prof = measure_comm(step, tree_copy(state), window)
    profiles["tp_int8ef_zero1_scan"] = prof.as_dict(steps_per_dispatch=K)
    _, _, local, _ = tp._tp_flat_geometry(mesh, fresh())
    by = prof.by_label()
    got = {"ring_payload": by["tp_ring_grad_int8"]["payload_bytes"],
           "ring_scales": by["tp_ring_grad_scale"]["payload_bytes"],
           "ring_wire": by["tp_ring_grad_int8"]["wire_bytes_per_device"],
           "gather_wire":
               by["tp_delta_gather_int8"]["wire_bytes_per_device"]}
    want = {"ring_payload": K * 1 * (n - 1) * local,
            "ring_scales": K * 1 * (n - 1) * 4,
            "ring_wire": K * 1 * (n - 1) * local,
            "gather_wire": K * (n - 1) * local}
    checks["tp_ring_analytic"] = {"got": got, "want": want,
                                  "ok": got == want}
    del state, step

    # 3. no retrace over the psa × K and wire × K grids.
    gen = torch.Generator().manual_seed(0)
    psa_grid, wire_grid = {}, {}
    for k in (1, 2):
        win = torch.randint(0, cfg.vocab_size, (k,) + bshape,
                            generator=gen).to(device)
        for psa in ("", "full", "defer:2", "int8_ef"):
            psa_grid[f"psa{psa.replace(':', '') or 'off'}-k{k}"] = \
                _watched_runs(lambda psa=psa: tp.make_tp_multi_step(
                    cfg, opt(), mesh, fresh(), psa=psa, batch_shape=bshape,
                    device=device), f"smoke/tp-psa{psa}-k{k}", win)
        for wire in ("fp32", "bf16", "int8_ef"):
            wire_grid[f"{wire}-k{k}"] = _watched_runs(
                lambda wire=wire: tp.make_tp_overlap_multi_step(
                    cfg, opt(), mesh, fresh(), aggregation="zero1",
                    wire=wire, overlap_microbatches=1, device=device),
                f"smoke/tp-{wire}-k{k}", win)
    checks["psa_retraces"] = {
        "grid": psa_grid, "ok": all(v["ok"] for v in psa_grid.values())}
    checks["overlap_retraces"] = {
        "grid": wire_grid, "ok": all(v["ok"] for v in wire_grid.values())}

    # 4. the trainer's compile events carry the window size.
    from ..train.llm import train_llm_tp
    train_llm_tp(cfg, TrainConfig(batch_size=BSZ, seq_len=cfg.ctx_size,
                                  iters=3, lr=3e-3, data=N_DATA, model=TP,
                                  psa="int8_ef", steps_per_dispatch=2),
                 tokenizer=ByteTokenizer(), log_every=0,
                 telemetry=telemetry, device=device)
    if mesh.d or mesh.m:
        return {}
    telemetry.close()
    events = []
    with open(os.path.join(telemetry.out_dir, "events.jsonl")) as f:
        for line in f:
            e = json.loads(line)
            if e.get("type") == "compile" and \
                    str(e.get("name", "")).startswith("train/tp"):
                events.append(e)
    stamped = sorted((e.get("steps_per_dispatch") or 0) for e in events)
    checks["trainer_compile_meta"] = {
        "events": [{"name": e.get("name"),
                    "steps_per_dispatch": e.get("steps_per_dispatch")}
                   for e in events],
        "want_window_sizes": [1, 2], "ok": stamped == [1, 2]}
    return {"ok": all(c["ok"] for c in checks.values()), "n_data": n,
            "tp": TP, "steps_per_dispatch": K, "model": CFG,
            "checks": checks, "rows": rows, "profiles": profiles}


def run(out_path: str, K: int = 4, device=None) -> int:
    from . import tp_fusion_smoke as mod      # picklable by its import path
    from ..telemetry import Telemetry
    with tempfile.TemporaryDirectory(prefix="tp-fusion-smoke-") as tdir:
        tel = Telemetry(tdir)
        doc = dist.run_ranks(mod._rank, N_DATA * TP, K, tel, device=device,
                             timeout=1800)[0]
        tel.close()
    platform = str(dist.rank_device(device, 0).type)
    doc["platform"] = platform
    for row in doc["rows"]:
        row.update(unit="bytes/device/step", platform=platform)
    with open(out_path, "w") as f:
        json.dump(doc, f, indent=2)
    c = doc["checks"]
    print(f"tp-fusion smoke ({platform}, {N_DATA}x{TP} ranks, K={K}): psa "
          f"int8 model-axis wire "
          f"{c['psa_wire_budget']['modes']['int8_ef']['reduction_vs_full']:.3f}"
          f"x of full sync (budget-gated), ring accounting "
          f"{'exact' if c['tp_ring_analytic']['ok'] else 'WRONG'}, retraces "
          f"{'clean' if c['psa_retraces']['ok'] and c['overlap_retraces']['ok'] else 'DIRTY'}"
          f", compile meta "
          f"{'stamped' if c['trainer_compile_meta']['ok'] else 'MISSING'}"
          f" -> {out_path}", file=sys.stderr)
    return 0 if doc["ok"] else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="tp-fusion.json",
                    help="result JSON path")
    ap.add_argument("--steps-per-dispatch", type=int, default=4,
                    help="K steps per dispatch of the ring driver's loop")
    ap.add_argument("--quick", action="store_true",
                    help="K = 2 (the CPU test's size)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    a = ap.parse_args(argv)
    return run(a.out, 2 if a.quick else a.steps_per_dispatch, a.device)


if __name__ == "__main__":
    sys.exit(main())
