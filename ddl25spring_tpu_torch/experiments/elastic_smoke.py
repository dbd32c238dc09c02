"""Elastic re-mesh twin: 4 → 3 (and back) on four ranks, with evidence:
the port's twin of the JAX package's ``experiments/elastic_smoke.py``.

A 4-rank ZeRO-1 run takes a ``device_loss`` fault mid-run, re-forms its
world over the 3 survivors, reshards and finishes; the script checks the
bars rather than that it ran:

- a zero-fault elastic run is bitwise the non-elastic run;
- the post-remesh losses are bitwise a fresh 3-rank run restored from the
  recovery state;
- ``device_loss`` then ``device_return`` walk 4 → 3 → 4, the grow rejoins
  the rank the shrink lost, and the post-grow losses are bitwise a fresh
  4-rank run restored from the grow point.

Two DP×PP legs (``train_llm_pp``, 4 layers): a 2×2 grid loses one rank
and drops the victim's data row (2×2 → 1×2, a pure reshard); a 1×4 grid
loses one rank, no data row survives whole, and the layers re-partition
onto two stages (1×4 → 1×2), the post-re-partition losses bitwise a fresh
1×2 run restored from the recovery checkpoint.

Every run is a call of one launch of four ranks (``parallel.programs.elastic_calls``); the recovery times, steps
replayed and post-remesh throughput land in the JSON (``--out``), with
``rows`` lower-is-better, and ``--telemetry-dir`` keeps the shrink run's
stream (with its ``remesh`` event and span tree).

    python -m ddl25spring_tpu_torch.experiments.elastic_smoke --out e.json \\
        --telemetry-dir elastic-telemetry [--device cpu]

Exit code 0 only when every check holds.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import sys
import tempfile

TINY = dict(vocab_size=259, dmodel=20, num_heads=2, n_layers=2, ctx_size=16)
BASE = dict(batch_size=2, seq_len=16, lr=3e-3, steps_per_dispatch=2)
WORLD = 4


def _call(iters, *, world=WORLD, ckpt=None, res=None, tel=None,
          prune=None) -> dict:
    from ..config import ResilienceConfig
    kwargs = dict(aggregation="zero1", checkpoint_every=1000,
                  resilience=(ResilienceConfig(**res) if res is not None
                              else None))
    if ckpt is not None:
        kwargs["checkpoint_dir"] = ckpt
    if tel is not None:
        kwargs["telemetry"] = tel
    return dict(cfg=TINY, train_cfg=dict(BASE, iters=iters, data=world),
                kwargs=kwargs, world=world, prune=prune)


def _pp_call(d, s, iters, *, ckpt=None, res=None, prune=None) -> dict:
    from ..config import ResilienceConfig
    kwargs = dict(checkpoint_every=1000,
                  resilience=(ResilienceConfig(**res) if res is not None
                              else None))
    if ckpt is not None:
        kwargs["checkpoint_dir"] = ckpt
    return dict(trainer="pp", cfg=dict(TINY, n_layers=4),
                train_cfg=dict(BASE, iters=iters, data=d, stage=s,
                               microbatches=2),
                kwargs=kwargs, world=d * s, prune=prune)


def run(out_path: str, telemetry_dir: str = None, iters: int = 8,
        device=None) -> int:
    from ..parallel import distributed, programs
    from ..telemetry import Telemetry

    work = tempfile.mkdtemp(prefix="elastic-smoke-")
    telemetry = Telemetry(telemetry_dir) if telemetry_dir else None
    rt_iters = iters + 4      # the return (dispatch 5) on an interior edge
    el, rt = os.path.join(work, "el"), os.path.join(work, "rt")
    calls = [
        _call(iters),                                             # 0 ref
        _call(iters, res=dict(elastic=True)),                     # 1 idle
        _call(iters, ckpt=el, tel=telemetry,                      # 2 shrink
              res=dict(elastic=True, faults="device_loss@2")),
        _call(iters, world=3, ckpt=os.path.join(work, "cmp"),     # 3
              prune=(el, os.path.join(work, "cmp"), 2, 0)),
        _call(rt_iters, ckpt=rt, res=dict(                        # 4 trip
            elastic=True, mirror_every=1,
            faults="device_loss@2,device_return@5")),
        _call(rt_iters, ckpt=os.path.join(work, "rt-cmp"),        # 5
              prune=(rt, os.path.join(work, "rt-cmp"), 4, 1)),
        _pp_call(2, 2, iters, res=dict(elastic=True,              # 6 rows
                                       faults="device_loss@2")),
        _pp_call(1, 4, iters, ckpt=os.path.join(work, "pp"),      # 7 stage
                 res=dict(elastic=True, faults="device_loss@2")),
        _pp_call(1, 2, iters, ckpt=os.path.join(work, "pp-cmp"),  # 8
                 prune=(os.path.join(work, "pp"),
                        os.path.join(work, "pp-cmp"), 7, 0)),
    ]
    try:
        ranks = distributed.run_ranks(programs.elastic_calls, WORLD, calls,
                                      device=device, timeout=900)
    finally:
        if telemetry is not None:
            telemetry.close()
        shutil.rmtree(work, ignore_errors=True)
    ref4, idle, shrink, ref3, trip, ref4g, pp_d, pp_s, ref_pp = ranks[0]
    zero_fault_bitwise = (idle["losses"] == ref4["losses"]
                          and idle["remeshes"] == [])
    rec = shrink["remeshes"][0] if len(shrink["remeshes"]) == 1 else None
    post_remesh_bitwise = bool(
        rec is not None and ref3["start_step"] == rec["resume_step"]
        and shrink["losses"][rec["resume_step"]:] == ref3["losses"])
    rt_shrink, rt_grow = (trip["remeshes"] if len(trip["remeshes"]) == 2
                          else (None, None))
    round_trip_bitwise = bool(
        rt_grow is not None and rt_grow["direction"] == "grow"
        and rt_grow["returned"] == rt_shrink["lost"]
        and ref4g["start_step"] == rt_grow["resume_step"]
        and trip["losses"][rt_grow["resume_step"]:] == ref4g["losses"])
    finite = all(math.isfinite(x) for r in (shrink, trip)
                 for x in r["losses"])
    pp_data = pp_d["remeshes"][0] if pp_d.get("remeshes") else None
    pp_data_ok = bool(
        pp_data is not None and pp_data["axis"] == "data"
        and pp_data["old_shape"] == [2, 2] and pp_data["new_shape"] == [1, 2]
        and all(math.isfinite(x) for x in pp_d["losses"]))
    pp_stage = pp_s["remeshes"][0] if pp_s.get("remeshes") else None
    pp_stage_bitwise = bool(
        pp_stage is not None and pp_stage["axis"] == "stage"
        and pp_stage["new_shape"] == [1, 2]
        and ref_pp["start_step"] == pp_stage["resume_step"]
        and pp_s["losses"][pp_stage["resume_step"]:] == ref_pp["losses"])
    ok = bool(zero_fault_bitwise and post_remesh_bitwise
              and round_trip_bitwise and finite and pp_data_ok
              and pp_stage_bitwise)
    result = {
        "ok": ok,
        "iters": iters,
        "zero_fault_bitwise": bool(zero_fault_bitwise),
        "post_remesh_bitwise": post_remesh_bitwise,
        "round_trip_bitwise": round_trip_bitwise,
        "pp_data_shrink_ok": pp_data_ok,
        "pp_stage_repartition_bitwise": pp_stage_bitwise,
        "pp_remeshes": [r for r in (pp_data, pp_stage) if r],
        "remesh": rec,
        "round_trip_remeshes": trip["remeshes"],
        "recovery_s": rec["seconds"] if rec else None,
        "steps_replayed": rec["steps_replayed"] if rec else None,
        "tokens_per_sec": shrink["tokens_per_sec"],
        "post_remesh_tokens_per_sec": shrink["post_remesh_tokens_per_sec"],
        "losses_finite": finite,
        "resilience": {k: v for k, v in shrink["resilience"].items() if v},
        "rows": [
            {"metric": "remesh_seconds_shrink",
             "value": rec["seconds"] if rec else 0.0,
             "variant": "elastic-smoke"},
            {"metric": "steps_replayed_shrink",
             "value": float(rec["steps_replayed"]) if rec else 0.0,
             "variant": "elastic-smoke"},
            {"metric": "remesh_seconds_grow",
             "value": rt_grow["seconds"] if rt_grow else 0.0,
             "variant": "elastic-smoke"},
            {"metric": "steps_replayed_grow",
             "value": float(rt_grow["steps_replayed"]) if rt_grow else 0.0,
             "variant": "elastic-smoke"},
            {"metric": "remesh_seconds_pp_data",
             "value": pp_data["seconds"] if pp_data else 0.0,
             "variant": "elastic-smoke"},
            {"metric": "steps_replayed_pp_data",
             "value": float(pp_data["steps_replayed"]) if pp_data else 0.0,
             "variant": "elastic-smoke"},
            {"metric": "remesh_seconds_pp_stage",
             "value": pp_stage["seconds"] if pp_stage else 0.0,
             "variant": "elastic-smoke"},
            {"metric": "steps_replayed_pp_stage",
             "value": float(pp_stage["steps_replayed"]) if pp_stage else 0.0,
             "variant": "elastic-smoke"},
        ],
    }
    with open(out_path, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result, indent=2))
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="elastic-recovery.json",
                    help="recovery-evidence JSON path")
    ap.add_argument("--telemetry-dir", default=None,
                    help="write the shrink run's events.jsonl here")
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="'cpu', or the default CUDA (every rank shares it)")
    a = ap.parse_args(argv)
    return run(a.out, a.telemetry_dir, a.iters, a.device)


if __name__ == "__main__":
    sys.exit(main())
