"""Long-context train-step throughput: twin of the JAX package's
``experiments/longctx_bench.py``.

The whole train step (fused head and cross-entropy, fused Adam) of the
canonical model at bf16, at long sequence lengths with the tokens per step
held near 16k, so tokens/s shows what the quadratic attention leg costs in a real
step when the rest of it is linear in T. Two variants: "flash" (the CUDA
flash kernels, dh-major: forward, dQ and dK/dV) and "xla" (the plain
PyTorch attention, which materializes the ``[B·H, T, T]`` scores).

Each (T, variant) point runs in a subprocess with a timeout
(``bench_utils.time_train_step``), which keeps one point's memory from
the next. Unlike the JAX bench, a failed point raises: its error is the
result, not a skipped row. ``--grid`` takes other points, ``--config
tiny`` a narrow model for the CPU (where only "xla" runs: the flash
kernels are CUDA's).

    python -m ddl25spring_tpu_torch.experiments.longctx_bench \\
        [--quick] [--grid 1024:16,4096:4] [--out longctx.json]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

# (seq_len, per-step batch): ~16k tokens per step at every row.
GRID = [(256, 64), (1024, 16), (2048, 8), (4096, 4), (8192, 2)]
VARIANTS = {
    "flash": {"attention_impl": "pallas", "flash_dh_major": True,
              "flash_block": 512},
    "xla": {"attention_impl": "xla"},
}
CONFIGS = {"canonical": {},
           "tiny": dict(vocab_size=259, dmodel=32, num_heads=2, n_layers=2)}
TIMEOUT_S = 900
ROOT = Path(__file__).resolve().parents[2]


def _child(variant: str, seq: int, batch: int, config: str, steps: int,
           device) -> None:
    """Time one (variant, seq) point; print ``tok/s step_ms``."""
    from ..bench_utils import time_train_step
    from ..config import LlamaConfig

    cfg = LlamaConfig(dtype="bfloat16", ctx_size=seq, **CONFIGS[config],
                      **VARIANTS[variant])
    tps = time_train_step(cfg, batch, seq=seq, warmup=2, timed_steps=steps,
                          device=device)
    print(tps, batch * seq / tps * 1e3)


def point(variant: str, seq: int, batch: int, *, config: str = "canonical",
          steps: int = 10, device=None) -> dict:
    """One point in its own process: ``{"tokens_per_sec", "step_ms"}``.
    Raises with the child's error when it fails or outlives
    ``TIMEOUT_S``."""
    cmd = [sys.executable, "-m", "ddl25spring_tpu_torch.experiments."
           "longctx_bench", "--one", variant, str(seq), str(batch),
           "--config", config, "--steps", str(steps)]
    if device is not None:
        cmd += ["--device", str(device)]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          cwd=str(ROOT), timeout=TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"longctx point T={seq} {variant} failed "
                           f"(exit {proc.returncode}):\n{proc.stderr[-4000:]}")
    tps, step_ms = map(float, proc.stdout.split()[-2:])
    return {"tokens_per_sec": tps, "step_ms": step_ms}


def run(out_path: str, grid, variants, *, config: str = "canonical",
        steps: int = 10, device=None) -> dict:
    from ..device import resolve_device
    platform = resolve_device(device).type      # raises without a card
    rows = []
    for seq, batch in grid:
        for variant in variants:
            res = point(variant, seq, batch, config=config, steps=steps,
                        device=device)
            rows.append({"seq": seq, "batch": batch, "variant": variant,
                         "platform": platform, **res})
            print(f"T={seq:5d} {variant:5s}: {res['tokens_per_sec']:10.0f} "
                  f"tok/s ({res['step_ms']:.1f} ms/step)", file=sys.stderr,
                  flush=True)
    doc = {"platform": platform, "config": config, "steps": steps,
           "rows": rows}
    with open(out_path, "w") as f:
        json.dump(doc, f, indent=2)
    return doc


def _grid(text: str):
    return [tuple(int(x) for x in p.split(":")) for p in text.split(",")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="longctx.json", help="result JSON path")
    ap.add_argument("--quick", action="store_true",
                    help="the first two points of the grid")
    ap.add_argument("--grid", type=_grid, default=None,
                    help="points as T:B,T:B (default: the JAX bench's)")
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated, of " + ", ".join(VARIANTS))
    ap.add_argument("--config", choices=sorted(CONFIGS), default="canonical")
    ap.add_argument("--steps", type=int, default=10, help="timed steps")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    ap.add_argument("--one", nargs=3, metavar=("VARIANT", "T", "B"),
                    help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.one:
        _child(a.one[0], int(a.one[1]), int(a.one[2]), a.config, a.steps,
               a.device)
        return 0
    grid = a.grid or (GRID[:2] if a.quick else GRID)
    run(a.out, grid, a.variants.split(","), config=a.config, steps=a.steps,
        device=a.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
