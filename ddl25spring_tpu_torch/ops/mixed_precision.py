"""Mixed-precision training, bf16 parameters with fp32 master weights: the
counterpart of the JAX package's ``ops/mixed_precision.py``.

The model's parameters live in bf16 while the optimizer accumulates in
fp32, so small updates are not rounded away (bf16 keeps ~8 bits of
mantissa; an Adam step of relative size below 2^-9 would vanish in bf16).
``master_weight_adam`` is an optax-style ``(init, update)`` pair, so every
step factory of ``parallel.dp`` takes it:

- state: ``MasterAdamState(count, mu, nu, master)``, the fp32 master the
  parameters upcast at ``init``;
- ``update(grads, state, params)`` runs the shared Adam rule
  (``ops.adam.adam_math``) in fp32 against the master and returns
  ``updates = master_new.to(p.dtype) - params``, so ``params + updates``
  lands the parameters on the downcast master (exact under Sterbenz's
  lemma for Adam-sized steps).

It is the plain rule, as in the JAX package: the fused CUDA apply
(``ops.pallas_adam``) takes fp32 leaves only.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .adam import GradientTransformation, adam_math, bias_corrections
from ..tree import tree_leaves, tree_map, tree_unflatten


class MasterAdamState(NamedTuple):
    count: Any    # [] int32 tensor on the parameters' device
    mu: Any       # fp32
    nu: Any       # fp32
    master: Any   # fp32 master weights


def master_weight_adam(learning_rate: float, b1: float = 0.9,
                       b2: float = 0.999, eps: float = 1e-8
                       ) -> GradientTransformation:
    def init_fn(params) -> MasterAdamState:
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        f32 = lambda p: p.detach().to(torch.float32, copy=True)
        return MasterAdamState(
            torch.zeros((), dtype=torch.int32,
                        device=tree_leaves(params)[0].device),
            tree_map(zeros, params), tree_map(zeros, params),
            tree_map(f32, params))

    def update_fn(grads, state: MasterAdamState, params=None):
        if params is None:
            raise ValueError("master_weight_adam needs params (every step "
                             "factory of parallel.dp passes them)")
        count = state.count + 1
        c1, c2 = bias_corrections(count, b1, b2)
        gs = tree_leaves(grads)
        u, m, v = adam_math([g.float() for g in gs], tree_leaves(state.mu),
                            tree_leaves(state.nu), c1, c2, lr=learning_rate,
                            b1=b1, b2=b2, eps=eps)
        master = torch._foreach_add(tree_leaves(state.master), u)
        ps = tree_leaves(params)
        # Defined so that params + updates is exactly the downcast master.
        updates = [w.to(p.dtype) - p.detach() for w, p in zip(master, ps)]
        like = lambda leaves: tree_unflatten(grads, leaves)
        return like(updates), MasterAdamState(count, like(m), like(v),
                                              like(master))

    return GradientTransformation(init_fn, update_fn)
