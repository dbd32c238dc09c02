"""Horizontal-FL servers: counterpart of the JAX package's ``fl/servers.py``.

- ``FedSgdGradientServer``: each sampled client returns one gradient over
  its whole subset; the server takes one SGD step on their sample-count
  weighted average.
- ``FedSgdWeightServer``: the same round with the step taken on the
  clients, which upload weights (equal up to float association).
- ``FedAvgServer``: E local epochs of minibatch SGD per sampled client,
  weight upload, sample-count weighted average (``_local_solver`` is the
  hook ``FedProxServer`` overrides).
- ``FedAvgGradServer``: clients upload Δ = w_global − w_local; the server
  applies w ← w − aggregate(Δ). Attacks (``adversary=(mask, attack)``) and
  Byzantine defenses (``defense=``) plug in here.
- ``CentralizedServer``: the non-federated baseline, one reshuffled epoch
  of minibatch SGD over the whole training set per round.

A round gathers the sampled clients' padded subsets by index from the
client-axis tensors on the device, runs every client at once
(``fl.local``), and folds their uploads in index order with the weights
computed once per round. Client sampling and the per-(client, round)
seeds stay on the host, observable; each client's randomness is a
``torch.Generator`` seeded with its seed, on the device. Products run in
full fp32 (``device.fp32_products``).

Every server takes ``fault_plan=`` (``resilience.FaultPlan``: scheduled
client dropout and stragglers; the round re-weights over the survivors,
and a round that loses every client is skipped, counted in
``server.resilience``; ``fl.DPFedAvgServer`` and
``fl.SecureAggFedAvgServer`` too, whose JAX counterparts ignore the plan) and ``telemetry=`` (``telemetry.Telemetry``: a
manifest, one ``fl_round`` event and a heartbeat per round, ``fl_round_s``
in the registry, a ``run_end`` snapshot).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from .. import rng
from ..config import FLConfig
from ..device import fp32_products, resolve_device, synchronize
from ..metrics import ResilienceStats, RunResult, message_count
from ..tree import tree_index, tree_leaves, tree_map, tree_sub, \
    tree_weighted_fold
from .federated_data import FederatedDataset
from .local import full_batch_grad, local_sgd

# Where the poison stream of a client is keyed apart from its local-SGD
# stream, so honest trajectories are those of FedAvgServer.
_POISON_STREAM = 0x7EA


def _weights_for(counts: torch.Tensor) -> torch.Tensor:
    """Sample-count FedAvg weights over the sampled clients."""
    c = counts.to(torch.float32)
    return c / torch.clamp(c.sum(), min=1.0)


class _ServerBase:
    """Shared plumbing: test(), client sampling, per-round records."""

    def __init__(self, init_params: dict, apply_fn, data: FederatedDataset,
                 test_x, test_y, cfg: FLConfig, algorithm: str,
                 fault_plan=None, telemetry=None, device=None):
        self.device = dev = resolve_device(device)
        self.apply_fn = apply_fn
        self.params = tree_map(lambda t: torch.as_tensor(t).to(dev),
                               init_params)
        self.data = self._place_data(data)
        self.test_x = torch.as_tensor(test_x).to(dev)
        self.test_y = torch.as_tensor(test_y).to(dev, torch.int64)
        self.cfg = cfg
        # Benign faults (resilience.FaultPlan): scheduled client dropout
        # and stragglers per round, counted in ``self.resilience``.
        self.fault_plan = fault_plan
        # telemetry.Telemetry: ``run`` emits a manifest, one ``fl_round``
        # event and a heartbeat per round, and a run_end snapshot.
        self.telemetry = telemetry
        self.resilience = ResilienceStats()
        self.result = RunResult(algorithm, cfg.nr_clients,
                                cfg.client_fraction, cfg.batch_size,
                                cfg.epochs, cfg.lr, cfg.seed)

    def _place_data(self, data):
        """Where the clients' data lives: the client-axis tensors, once on
        the server's device (the fleet server keeps its streaming source
        as it is)."""
        return data.to(self.device)

    def test(self) -> float:
        """Accuracy on the whole test set, in one batch."""
        with torch.no_grad(), fp32_products():
            logits = self.apply_fn(self.params, self.test_x)
            return (logits.argmax(-1) == self.test_y).float().mean().item()

    def _sample(self, round_idx: int) -> np.ndarray:
        return rng.sample_clients(self.cfg.seed, round_idx,
                                  self.cfg.nr_clients,
                                  self.cfg.clients_per_round).numpy()

    def client_seeds(self, round_idx: int, client_idx) -> np.ndarray:
        """``seed + ind + 1 + round·m`` with ind each sampled client's
        global index: its randomness does not depend on its position in
        the sample."""
        m = self.cfg.clients_per_round
        return np.asarray([rng.per_client_seed(self.cfg.seed, round_idx,
                                               int(i), m)
                           for i in client_idx])

    def _record(self, round_idx: int, wall: float) -> None:
        self.result.record_round(
            wall, message_count(round_idx, self.cfg.clients_per_round),
            self.test())

    def _gather(self, idx: np.ndarray):
        i = torch.tensor(np.asarray(idx, dtype=np.int64), device=self.device)
        return self.data.x[i], self.data.y[i], self.data.mask[i], i

    def _survivors(self, r: int, idx: np.ndarray) -> Optional[np.ndarray]:
        """The sampled clients of round ``r`` that the fault plan keeps
        (``idx`` itself without a plan), counting the dropped and the
        stragglers; None when every client is lost (the round is skipped
        and counted). The weights then renormalize over the survivors,
        and each survivor's randomness is that of the fault-free round
        (its seed comes from its global index), so the round equals the
        fault-free round over that subset. The JAX servers pad the set back
        to its width at weight 0 to keep one compiled shape, which their
        fold makes bitwise the filtered round; eager PyTorch filters."""
        if self.fault_plan is None:
            return idx
        mask, dropped, stragglers = self.fault_plan.surviving_clients(r, idx)
        self.resilience.dropped_clients += dropped
        self.resilience.straggler_clients += stragglers
        if not mask.any():
            self.resilience.skipped_rounds += 1
            return None
        return idx[mask]

    def _round(self, params: dict, r: int) -> dict:
        idx = self._survivors(r, self._sample(r))
        if idx is None:
            return params
        gens = [rng.client_generator(self.cfg.seed, r, int(i),
                                     self.cfg.clients_per_round, self.device)
                for i in idx]
        return self._round_step(params, idx, gens)

    def run(self, nr_rounds: Optional[int] = None) -> RunResult:
        nr_rounds = self.cfg.rounds if nr_rounds is None else nr_rounds
        tel = self.telemetry
        if tel is not None:
            tel.events.manifest(
                trainer=f"fl/{self.result.algorithm}", jax_version=None,
                torch_version=torch.__version__,
                platform=("gpu" if self.device.type == "cuda"
                          else self.device.type),
                fl_cfg=dataclasses.asdict(self.cfg), rounds=nr_rounds,
                **getattr(self, "_manifest_extra", {}))
            prev_counters = self.resilience.as_dict()
        for r in range(nr_rounds):
            t0 = time.perf_counter()
            with torch.no_grad(), fp32_products():
                self.params = self._round(self.params, r)
            synchronize(self.device)
            self._record(r, time.perf_counter() - t0)
            if tel is not None:
                tel.heartbeat.beat(step=r, phase="fl_round")
                wall = self.result.wall_time[-1]
                tel.registry.observe("fl_round_s", wall)
                delta = self.resilience.delta(prev_counters)
                prev_counters = self.resilience.as_dict()
                tel.events.fl_round(
                    round=r, wall_s=wall,
                    test_accuracy=self.result.test_accuracy[-1],
                    messages=self.result.message_count[-1],
                    **({"faults": delta} if delta else {}))
        if tel is not None:
            tel.registry.absorb_resilience(self.resilience)
            tel.events.run_end(steps=nr_rounds,
                               final_accuracy=(self.result.test_accuracy[-1]
                                               if self.result.rounds
                                               else None),
                               metrics=tel.registry.snapshot())
        return self.result


class FedSgdGradientServer(_ServerBase):
    """One whole-subset gradient per sampled client, weighted-averaged, one
    server SGD step per round."""

    def __init__(self, *args, **kw):
        super().__init__(*args, algorithm="fedsgd", **kw)

    def _round_step(self, params, idx, gens):
        xs, ys, ms, i = self._gather(idx)
        _, grads = full_batch_grad(self.apply_fn, params, xs, ys, ms, gens)
        agg = tree_weighted_fold(grads, _weights_for(
            self.data.sample_counts[i]))
        return tree_map(lambda p, g: p - self.cfg.lr * g, params, agg)


class FedSgdWeightServer(_ServerBase):
    """FedSGD with the step on the clients: they upload lr-stepped weights
    and the server weighted-averages them."""

    def __init__(self, *args, **kw):
        super().__init__(*args, algorithm="fedsgd-w", **kw)

    def _round_step(self, params, idx, gens):
        xs, ys, ms, i = self._gather(idx)
        _, grads = full_batch_grad(self.apply_fn, params, xs, ys, ms, gens)
        new = tree_map(lambda p, g: p - self.cfg.lr * g, params, grads)
        return tree_weighted_fold(new, _weights_for(
            self.data.sample_counts[i]))


class FedAvgServer(_ServerBase):
    """E local SGD epochs per sampled client, weight upload, sample-count
    weighted average. Subclasses swap the local solver through
    ``_local_solver``: ``solver(params, x, y, mask, generators)`` ->
    the clients' new parameters, stacked."""

    def __init__(self, *args, algorithm: str = "fedavg", **kw):
        super().__init__(*args, algorithm=algorithm, **kw)
        self._solver = self._local_solver()

    def _local_solver(self):
        cfg, apply_fn = self.cfg, self.apply_fn
        return lambda p, x, y, m, gens: local_sgd(
            apply_fn, p, x, y, m, epochs=cfg.epochs,
            batch_size=cfg.batch_size, lr=cfg.lr, generators=gens)

    def _round_step(self, params, idx, gens):
        xs, ys, ms, i = self._gather(idx)
        new = self._solver(params, xs, ys, ms, gens)
        return tree_weighted_fold(new, _weights_for(
            self.data.sample_counts[i]))


class FedAvgGradServer(_ServerBase):
    """Δ-upload FedAvg: clients return Δ = w_global − w_local and the
    server applies w ← w − aggregate(Δ).

    ``adversary``: optional (mask, attack); mask [N] bool marks the
    Byzantine clients, whose local data ``attack.poison`` transforms (when
    ``attack.poisons_data``) and whose Δ ``attack.transform`` replaces.
    ``defense``: optional ``defense(deltas, weights) -> aggregated Δ``
    (``fl.defenses``) in place of the weighted average.
    """

    def __init__(self, *args, adversary=None, defense=None, **kw):
        super().__init__(*args, algorithm="fedavg-grad", **kw)
        self.adversary = adversary
        self.defense = defense
        self._malicious = (None if adversary is None else
                           np.asarray(torch.as_tensor(adversary[0]).cpu(),
                                      dtype=bool))

    def _round_step(self, params, idx, gens):
        cfg = self.cfg
        xs, ys, ms, i = self._gather(idx)
        attack = self.adversary[1] if self.adversary is not None else None
        bad = (np.flatnonzero(self._malicious[idx]) if attack is not None
               else ())
        if attack is not None and attack.poisons_data:
            for c in bad:
                g = rng.generator(rng.derived_seed(gens[c].initial_seed(),
                                                   _POISON_STREAM),
                                  self.device)
                xs[c], ys[c] = attack.poison(xs[c], ys[c], g)
        new = local_sgd(self.apply_fn, params, xs, ys, ms, epochs=cfg.epochs,
                        batch_size=cfg.batch_size, lr=cfg.lr,
                        generators=gens)
        deltas = tree_map(torch.sub, params, new)         # Δ = w0 − w_final
        for c in bad:
            forged = attack.transform(tree_index(deltas, c), params)
            for leaf, f in zip(tree_leaves(deltas), tree_leaves(forged)):
                leaf[c] = f
        w = _weights_for(self.data.sample_counts[i])
        agg = (tree_weighted_fold(deltas, w) if self.defense is None
               else self.defense(deltas, w))
        return tree_sub(params, agg)


class CentralizedServer(_ServerBase):
    """Non-federated baseline: plain minibatch SGD over the whole training
    set, one reshuffled epoch per round, no messages."""

    def __init__(self, init_params, apply_fn, x, y, test_x, test_y,
                 cfg: FLConfig, telemetry=None, device=None):
        dev = resolve_device(device)
        x = torch.as_tensor(x).to(dev)
        y = torch.as_tensor(y).to(dev, torch.int64)
        data = FederatedDataset(x[None], y[None],
                                torch.ones((1,) + y.shape, device=dev),
                                torch.tensor([y.shape[0]], device=dev))
        super().__init__(init_params, apply_fn, data, test_x, test_y, cfg,
                         algorithm="centralized", telemetry=telemetry,
                         device=dev)
        # One node: N=1, C=1, E=1 (cfg.epochs is a federated knob).
        self.result = RunResult("centralized", 1, 1.0, cfg.batch_size, 1,
                                cfg.lr, cfg.seed)

    def _permutation(self, r: int) -> torch.Tensor:
        """The order of round ``r``'s epoch."""
        g = rng.generator(rng.derived_seed(self.cfg.seed, r), self.device)
        return torch.randperm(self.data.y.shape[1], generator=g,
                              device=self.device)

    def _round(self, params, r):
        perm = self._permutation(r)
        d = self.data
        gen = rng.generator(rng.derived_seed(self.cfg.seed + 1, r),
                            self.device)
        new = local_sgd(self.apply_fn, params, d.x[:, perm], d.y[:, perm],
                        d.mask[:, perm], epochs=1,
                        batch_size=self.cfg.batch_size, lr=self.cfg.lr,
                        generators=[gen])
        return tree_index(new, 0)

    def _record(self, round_idx: int, wall: float) -> None:
        self.result.record_round(wall, 0, self.test())
