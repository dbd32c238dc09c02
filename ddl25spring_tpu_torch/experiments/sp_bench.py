"""Sequence-parallel (ring attention) memory against ring size: twin of
the JAX package's ``experiments/sp_bench.py``.

Ring attention's point is that each rank's activations, and the per-hop
``[T/n, T/n]`` score blocks, shrink with the ring, so context scales with
the ranks. The JAX bench reads the compiled step's per-device temp bytes
on the virtual CPU mesh; the port runs real ranks, so on the card each
rank's "memory" is ``torch.cuda.max_memory_allocated`` over one
``make_sp_train_step`` step (SGD at lr 0.1, JAX's), its peak above the
state held before the step beside it. On the CPU the twin runs the same
steps and reports their losses (equal at every ring size: SP is exact)
but no memory number: the host allocator keeps no peak.

The JAX bench's configuration: vocab 512, dmodel 64, 4 heads, 4 layers,
B = 2, T = 2048 and 8192, rings 1, 2, 4, 8 (``--quick``: T = 2048, rings
1, 2, 4). Each (T, ring) point is one ``distributed.run_ranks`` launch of
``ring`` ranks; on one card every rank shares it.

    python -m ddl25spring_tpu_torch.experiments.sp_bench [--quick] \\
        [--out sp-bench.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Dict, Optional

import torch

from ..config import LlamaConfig
from ..models import llama
from ..parallel import distributed as dist
from ..parallel import sp
from ..parallel.programs import sgd

CFG = dict(vocab_size=512, dmodel=64, num_heads=4, n_layers=4)
BATCH = 2
GRID = [(2048, (1, 2, 4, 8)), (8192, (1, 2, 4, 8))]
QUICK_GRID = [(2048, (1, 2, 4))]


def step_peak(cfg: LlamaConfig, seq_len: int, mesh: dist.AxisMesh,
              batch: int, device) -> Dict[str, Optional[float]]:
    """One SP step of ``init_llama`` (seed 0) on a ``[batch, seq_len]``
    batch (seed 1) over ``mesh``: the loss and, on the card, this rank's
    peak allocated bytes over the step (``peak_bytes``) and above what was
    allocated before it (``step_bytes``); None on the CPU."""
    dev = torch.device(device)
    params = llama.init_llama(cfg, torch.Generator().manual_seed(0),
                              device="cpu").tree()
    opt = sgd(0.1)
    state = sp.init_state(mesh, params, opt, dev)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq_len),
                           generator=torch.Generator().manual_seed(1))
    step = sp.make_sp_train_step(cfg, opt, mesh, dev)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
    state, loss = step(state, tokens)
    out = {"loss": float(loss), "peak_bytes": None, "step_bytes": None}
    if cuda:
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        out.update(peak_bytes=float(peak), step_bytes=float(peak - before))
    del state, step
    return out


def _rank(seq_len: int, cfg: dict, batch: int, *, device) -> dict:
    n = dist.world_size()
    return step_peak(LlamaConfig(ctx_size=seq_len, **cfg), seq_len,
                     dist.seq_mesh(1, n), batch, device)


def run(out_path: str, grid, device=None, cfg: Optional[dict] = None,
        batch: int = BATCH) -> int:
    from . import sp_bench as mod             # picklable by its import path
    cfg = dict(CFG, **(cfg or {}))
    platform = str(dist.rank_device(device, 0).type)
    rows = []
    for seq_len, rings in grid:
        for n in rings:
            ranks = dist.run_ranks(mod._rank, n, seq_len, cfg, batch,
                                   device=device, timeout=1800)
            peaks = [r["peak_bytes"] for r in ranks]
            rows.append({"seq_len": seq_len, "n_seq": n,
                         "loss": ranks[0]["loss"],
                         "losses": [r["loss"] for r in ranks],
                         "peak_bytes_per_rank": peaks,
                         "step_bytes_per_rank": [r["step_bytes"]
                                                 for r in ranks],
                         "platform": platform})
            mem = ("not measured" if peaks[0] is None else
                   f"peak {max(peaks) / 1e6:9.1f} MB per rank")
            print(f"T={seq_len:5d} ring={n}: loss {ranks[0]['loss']:.6f}, "
                  f"{mem}", file=sys.stderr, flush=True)
    checks = {}
    for seq_len in sorted({r["seq_len"] for r in rows}):
        mine = [r for r in rows if r["seq_len"] == seq_len]
        ref = mine[0]["loss"]
        checks[f"t{seq_len}_losses_agree"] = all(
            math.isfinite(x) and abs(x - ref) <= 1e-4 * abs(ref)
            for r in mine for x in r["losses"])
        if platform == "cuda":
            peaks = [max(r["peak_bytes_per_rank"]) for r in mine]
            checks[f"t{seq_len}_peak_falls_with_ring"] = all(
                b < a for a, b in zip(peaks, peaks[1:]))
    doc = {"ok": all(checks.values()), "platform": platform,
           "model": dict(cfg, batch=batch), "checks": checks, "rows": rows}
    with open(out_path, "w") as f:
        json.dump(doc, f, indent=2)
    print(f"sp_bench ({platform}): {checks} -> {out_path}", file=sys.stderr)
    return 0 if doc["ok"] else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="sp-bench.json", help="result JSON path")
    ap.add_argument("--quick", action="store_true",
                    help="T = 2048 at rings 1, 2, 4")
    ap.add_argument("--seq", type=int, default=None,
                    help="one sequence length instead of the grid's")
    ap.add_argument("--layers", type=int, default=None,
                    help="the model's depth (default: the JAX bench's 4)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    a = ap.parse_args(argv)
    grid = QUICK_GRID if a.quick else GRID
    if a.seq is not None:
        grid = [(a.seq, grid[0][1])]
    cfg = {} if a.layers is None else {"n_layers": a.layers}
    return run(a.out, grid, a.device, cfg)


if __name__ == "__main__":
    sys.exit(main())
