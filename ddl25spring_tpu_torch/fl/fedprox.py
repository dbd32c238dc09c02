"""FedProx: FedAvg with a proximal local objective (Li et al., MLSys 2020);
counterpart of the JAX package's ``fl/fedprox.py``.

Each client minimizes F_k(w) + (μ/2)·‖w − w_t‖², which tethers divergent
non-IID updates to the global model. Same round and weighting as
``FedAvgServer``; only the local solver changes
(``fl.local.local_prox_sgd``). At ``mu=0`` the solver is FedAvg's
exactly.
"""

from __future__ import annotations

from .local import local_prox_sgd
from .servers import FedAvgServer


class FedProxServer(FedAvgServer):
    """``FedAvgServer`` with the proximal local solver; ``mu`` is the
    proximal coefficient (0 ⇒ FedAvg)."""

    def __init__(self, *args, mu: float = 0.01, **kw):
        self.mu = float(mu)  # before super(): _local_solver reads it
        super().__init__(*args, algorithm="fedprox", **kw)

    def _local_solver(self):
        cfg, apply_fn, mu = self.cfg, self.apply_fn, self.mu
        return lambda p, x, y, m, gens: local_prox_sgd(
            apply_fn, p, x, y, m, epochs=cfg.epochs,
            batch_size=cfg.batch_size, lr=cfg.lr, mu=mu, generators=gens)
