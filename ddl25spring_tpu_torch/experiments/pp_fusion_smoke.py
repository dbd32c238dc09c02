"""PP-fusion smoke: the DP×PP composition's claims, checked. Twin of the
JAX package's ``experiments/pp_fusion_smoke.py``.

Four ranks laid out ``data=2 × stage=2`` (``distributed.run_ranks``, one
launch) read their comm profiles (``telemetry.comm.measure_comm``: one
real call each; the port records collectives as they run) and check, on
each stage's own geometry (a port stage rings only the leaves it holds,
where every JAX stage carries the stage-replicated ones too):

1. the data-axis wire of the ``int8_ef + zero1`` K-step ring driver
   (``pp.make_pipeline_overlap_multi_step``), per train step, is at most
   0.27 of the plain DP×PP step's fp32 gradient mean on the same stage
   (``CommProfile.by_axis``; the stage hops are the same in both and not
   counted);
2. the ring and delta-gather accounting is exact per stage: the int8 hops,
   their scale sidebands and the delta gather equal ``K·M·(n−1)·chunk``
   bytes, ``chunk`` the stage's own slice (``pp._pp_flat_geometry``);
3. no retrace over the wire × K grid at zero1 (the ring driver) and the
   schedule × K grid (``pp.make_pipeline_multi_step``): ``introspect.
   watch`` sees one call signature each over three dispatches;
4. the trainer's compile events carry the window size: ``train_llm_pp``
   at 3 steps and K = 2 compiles twice, stamped 2 and 1.

Writes a JSON result (``--out``); exits 1 when a check fails. On the card
by default (every rank shares it); ``--device cpu`` runs on the host.

    python -m ddl25spring_tpu_torch.experiments.pp_fusion_smoke \\
        --out pp-fusion.json
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
from ..parallel import pp
from ..telemetry import introspect
from ..telemetry.comm import measure_comm
from ..tokenizers import ByteTokenizer
from ..tree import tree_copy

N_DATA, STAGES = 2, 2
# 4 layers: divisible by S·v = 4, so the interleaved schedule's grid entry
# runs on the same model as everything else.
CFG = dict(vocab_size=259, dmodel=32, num_heads=2, n_layers=4, ctx_size=16)
BSZ = 4                                   # rows per data row
MB = 2                                    # pipeline microbatches
BUDGET = 0.27


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
    """One rank's part: its stage's measurements of checks 1-3, and on
    rank 0 check 4."""
    mesh = dist.pipeline_mesh(N_DATA, STAGES)
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
    out = {"d": mesh.d, "s": mesh.s, "profiles": {}}

    # 1. the plain step's data-axis wire against the int8 ring's.
    state = pp.init_state(mesh, fresh(), opt(), device=device)
    step = pp.make_pipeline_step(cfg, opt(), mesh, MB, device=device)
    prof = measure_comm(step, tree_copy(state), batch)
    base = prof.by_axis()["data"]["wire_bytes_per_device"]
    out["profiles"]["pp_f32_pmean"] = prof.as_dict()
    state, step = pp.make_pipeline_overlap_multi_step(
        cfg, opt(), mesh, fresh(), n_microbatches=MB, aggregation="zero1",
        wire="int8_ef", overlap_microbatches=1, device=device)
    prof = measure_comm(step, tree_copy(state), window)
    cand = prof.by_axis()["data"]["wire_bytes_per_device"] / K
    out["profiles"]["pp_int8ef_zero1_scan"] = prof.as_dict(
        steps_per_dispatch=K)
    out["ratio"] = {"value": cand / base, "budget": BUDGET,
                    "ok": cand / base <= BUDGET, "f32_pmean_bytes": base,
                    "int8_ring_bytes": cand}

    # 2. exact ring and gather accounting on this stage's geometry.
    _, _, local, total = pp._pp_flat_geometry(mesh, fresh())
    by = prof.by_label()
    got = {"ring_payload": by["pp_ring_grad_int8"]["payload_bytes"],
           "ring_scales": by["pp_ring_grad_scale"]["payload_bytes"],
           "ring_wire": by["pp_ring_grad_int8"]["wire_bytes_per_device"],
           "gather_wire":
               by["pp_delta_gather_int8"]["wire_bytes_per_device"]}
    want = {"ring_payload": K * 1 * (n - 1) * local,
            "ring_scales": K * 1 * (n - 1) * 4,
            "ring_wire": K * 1 * (n - 1) * local,
            "gather_wire": K * (n - 1) * local}
    out["analytic"] = {"got": got, "want": want, "chunk": local,
                       "stage_coordinates": total, "ok": got == want}
    del state, step

    # 3. no retrace over the wire × K and schedule × K grids.
    gen = torch.Generator().manual_seed(0)
    wire_grid, sched_grid = {}, {}
    for k in (1, 2):
        win = torch.randint(0, cfg.vocab_size, (k,) + bshape,
                            generator=gen).to(device)
        for wire in ("fp32", "bf16", "int8_ef"):
            wire_grid[f"{wire}-k{k}"] = _watched_runs(
                lambda wire=wire: pp.make_pipeline_overlap_multi_step(
                    cfg, opt(), mesh, fresh(), n_microbatches=MB,
                    aggregation="zero1", wire=wire, overlap_microbatches=1,
                    device=device), f"smoke/pp-{wire}-k{k}", win)
    win = torch.randint(0, cfg.vocab_size, (2,) + bshape,
                        generator=gen).to(device)
    for schedule in ("gpipe", "1f1b", "interleaved"):
        def make(schedule=schedule):
            params = fresh()
            if schedule == "interleaved":
                params = pp.interleave_params(params, STAGES, 2)
            return (pp.init_state(mesh, params, opt(), device=device),
                    pp.make_pipeline_multi_step(cfg, opt(), mesh, MB,
                                                schedule, device=device))
        sched_grid[f"{schedule}-k2"] = _watched_runs(
            make, f"smoke/pp-{schedule}-k2", win)
    out["overlap_retraces"] = {
        "grid": wire_grid, "ok": all(v["ok"] for v in wire_grid.values())}
    out["multi_step_retraces"] = {
        "grid": sched_grid, "ok": all(v["ok"] for v in sched_grid.values())}

    # 4. the trainer's compile events carry the window size.
    from ..train.llm import train_llm_pp
    train_llm_pp(cfg, TrainConfig(batch_size=BSZ, seq_len=cfg.ctx_size,
                                  iters=3, lr=3e-3, data=N_DATA,
                                  stage=STAGES, microbatches=MB,
                                  steps_per_dispatch=2),
                 tokenizer=ByteTokenizer(), log_every=0,
                 telemetry=telemetry, device=device)
    if dist.get_rank():
        return out
    telemetry.close()
    events = []
    with open(os.path.join(telemetry.out_dir, "events.jsonl")) as f:
        for line in f:
            e = json.loads(line)
            if e.get("type") == "compile" and \
                    str(e.get("name", "")).startswith("train/pp-"):
                events.append(e)
    stamped = sorted((e.get("steps_per_dispatch") or 0) for e in events)
    out["trainer_compile_meta"] = {
        "events": [{"name": e.get("name"),
                    "steps_per_dispatch": e.get("steps_per_dispatch")}
                   for e in events],
        "want_window_sizes": [1, 2], "ok": stamped == [1, 2]}
    return out


def run(out_path: str, K: int = 4, device=None) -> int:
    from . import pp_fusion_smoke as mod      # picklable by its import path
    from ..telemetry import Telemetry
    with tempfile.TemporaryDirectory(prefix="pp-fusion-smoke-") as tdir:
        tel = Telemetry(tdir)
        ranks = dist.run_ranks(mod._rank, N_DATA * STAGES, K, tel,
                               device=device, timeout=1800)
        tel.close()
    platform = str(dist.rank_device(device, 0).type)
    by_stage = {f"stage{r['s']}": r for r in ranks if r["d"] == 0}
    checks = {
        "pp_data_wire_ratio": {
            "stages": {k: r["ratio"] for k, r in by_stage.items()},
            "ok": all(r["ratio"]["ok"] for r in ranks)},
        "pp_ring_analytic": {
            "stages": {k: r["analytic"] for k, r in by_stage.items()},
            "ok": all(r["analytic"]["ok"] for r in ranks)},
        "overlap_retraces": {
            "grid": ranks[0]["overlap_retraces"]["grid"],
            "ok": all(r["overlap_retraces"]["ok"] for r in ranks)},
        "multi_step_retraces": {
            "grid": ranks[0]["multi_step_retraces"]["grid"],
            "ok": all(r["multi_step_retraces"]["ok"] for r in ranks)},
        "trainer_compile_meta": ranks[0]["trainer_compile_meta"]}
    rows = [{"metric": "wire_bytes_pp_data_axis_per_train_step",
             "value": r["ratio"][key], "unit": "bytes/device/step",
             "platform": platform,
             "variant": f"dp2pp2-{k}-{variant}"}
            for k, r in by_stage.items()
            for key, variant in (("f32_pmean_bytes", "f32-pmean"),
                                 ("int8_ring_bytes",
                                  "int8ring+zero1+scan"))]
    doc = {"ok": all(c["ok"] for c in checks.values()), "n_data": N_DATA,
           "n_stages": STAGES, "steps_per_dispatch": K, "model": CFG,
           "platform": platform, "checks": checks, "rows": rows,
           "profiles": {k: r["profiles"] for k, r in by_stage.items()}}
    with open(out_path, "w") as f:
        json.dump(doc, f, indent=2)
    ratios = ", ".join(f"{k} {r['ratio']['value']:.3f}"
                       for k, r in by_stage.items())
    print(f"pp-fusion smoke ({platform}, {N_DATA}x{STAGES} ranks, K={K}): "
          f"data-axis ratio {ratios} (budget {BUDGET}), ring accounting "
          f"{'exact' if checks['pp_ring_analytic']['ok'] else 'WRONG'}, "
          f"retraces "
          f"{'clean' if checks['overlap_retraces']['ok'] and checks['multi_step_retraces']['ok'] else 'DIRTY'}"
          f", compile meta "
          f"{'stamped' if checks['trainer_compile_meta']['ok'] else 'MISSING'}"
          f" -> {out_path}", file=sys.stderr)
    return 0 if doc["ok"] else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="pp-fusion.json",
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
