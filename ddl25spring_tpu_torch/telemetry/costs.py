"""Cost accounting: the port's counterpart of the JAX package's
``telemetry/costs.py``.

The JAX package asks XLA's cost model for the compiled step's FLOPs and
holds them against the analytic count. Eager PyTorch compiles no program,
so ``hlo_cost`` and ``compiled_cost`` return None, and
``flops_crosscheck`` reports ``"analytic"``, as the JAX function does on a
jaxlib without ``cost_analysis``. ``train_flops_per_token`` is the analytic
count chip_smoke.py and PERF.md use (108.4 MFLOP per token for the
canonical tiny-Llama at T = 256).
"""

from __future__ import annotations

from typing import Optional


def hlo_cost(fn, *args, **kwargs) -> Optional[dict]:
    """None: there is no compiled program to cost."""
    return None


def compiled_cost(compiled) -> Optional[dict]:
    """None: there is no compiled program to cost."""
    return None


def train_flops_per_token(cfg, seq: int) -> float:
    """Analytic FLOPs per token of one training step (forward and backward
    are 3x the forward's products; attention 4·T·d per layer)."""
    d, f, n, v = cfg.dmodel, cfg.ffn_dim, cfg.n_layers, cfg.vocab_size
    per_layer = 8 * d * d + 6 * d * f + 4 * seq * d
    return 3.0 * (n * per_layer + 2 * d * v)


def flops_crosscheck(analytic_flops: float, hlo: Optional[dict],
                     tolerance: float = 0.10) -> dict:
    """The analytic FLOP count against a compiled program's:
    ``{"flops_source", "hlo_flops", "rel_err"}``, "hlo" when the program's
    count is within ``tolerance`` of the analytic one, else "analytic"
    (always, here: ``hlo`` is None)."""
    if hlo is None or not analytic_flops:
        return {"flops_source": "analytic", "hlo_flops": None,
                "rel_err": None}
    rel = abs(hlo["flops"] - analytic_flops) / analytic_flops
    source = "hlo" if rel <= tolerance else "analytic"
    return {"flops_source": source, "hlo_flops": hlo["flops"],
            "rel_err": rel}
