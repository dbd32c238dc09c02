"""Fleet-scale federated learning: counterpart of the JAX package's
``fl/fleet.py``. Cohort-streamed rounds with an optional edge → server
hierarchy.

The vmapped servers (``fl/servers.py``) hold every sampled client on the
device at once: O(clients · (subset + params)) device bytes per round. The
fleet engine streams the sampled clients through a fixed-width cohort
instead:

- a round samples its clients on the host (``rng.sample_clients``), then
  runs W clients at a time through one cohort step (``local_sgd`` over the
  cohort, the same ops as ``FedAvgGradServer``'s clients), each client's
  randomness a ``torch.Generator`` keyed by its global index;
- the aggregate is carried across cohorts and folded in client order
  (``tree.tree_weighted_fold(..., init=acc)``), so device memory is
  O(cohort) and the chunked fold's association is the one-shot fold's;
- the last cohort is filled to W with duplicates of a real client at
  weight 0 (the fold selects around a weight-0 row exactly), so every
  cohort step sees one call signature: ``CompileWatch`` counts no retrace,
  and a captured CUDA graph would serve every cohort.

``FleetConfig.edges = E > 1`` splits the sampled clients over E edges
(``np.array_split``); each edge streams its own cohorts to an edge
aggregate with weights normalized inside the edge, and a server tier
reduces the E aggregates, weighted by each edge's sample mass. ``E = 1``
with an empty server policy runs no server tier at all, so the flat path
is the single edge bitwise. ``TierPolicy`` sets what each tier does to its
inputs: a defense (``fl.defenses`` hooks; the edge then collects its
clients' flat deltas ``[m_e, P]`` on the host, O(m_e · P) host floats),
secure aggregation (edge tier only: pairwise-masked int32 uploads summed on
the 2^32 ring across cohorts, dequantized once with ``scale / m_e``), and
DP (clip each input, add σ = z · clip / n from a generator keyed by
(seed ^ 0xF1EE7D0E, round, tier, edge)).

Client data never lives on the device in bulk: a source materializes a
cohort on demand (``FederatedArraySource`` gathers from host numpy arrays;
``SyntheticFleetSource`` generates each client's subset from (seed, id)
with numpy, the same bytes as the JAX package's).

Telemetry: one ``fl_cohort`` event per cohort, one ``fl_tier`` event per
tier per round with the exact payload bytes (``tree_bytes`` of one client's
upload times the inputs), the span tree ``fl_round`` → ``tier`` →
``cohort`` on the ``"fleet"`` trace (no server-tier span at E = 1), and
``fleet`` in the run manifest.
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from .. import rng
from ..config import FLConfig
from ..device import fp32_products, resolve_device
from ..telemetry.comm import tree_bytes
from ..telemetry.introspect import watch
from ..telemetry.trace import Tracer
from ..tree import (tree_index, tree_map, tree_sub, tree_weighted_fold,
                    unflattener)
from .defenses import stack_flat, unstack_flat
from .federated_data import FederatedDataset
from .local import local_sgd
from .privacy import clip_by_global_norm, gaussian_noise_like
from .secure_agg import (_MASK_SALT, add_pair_masks, check_secagg_capacity,
                         dequantize_tree, quantize_tree, ring_sum,
                         secagg_scale, wrap_int32)
from .servers import _ServerBase, _weights_for

# The per-tier DP noise stream, salted apart from the client streams and
# from DPFedAvgServer's.
_FLEET_NOISE_SALT = 0xF1EE7D0E


def _host(t) -> np.ndarray:
    return (t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t))


# ------------------------------------------------------------- data sources

class FederatedArraySource:
    """Cohorts gathered by index from a ``FederatedDataset``'s client-axis
    arrays, kept in host numpy: only the gathered cohort goes to the
    device."""

    def __init__(self, data: FederatedDataset):
        self._x = _host(data.x)
        self._y = _host(data.y)
        self._mask = _host(data.mask)
        self._counts = _host(data.sample_counts)

    @property
    def nr_clients(self) -> int:
        return self._x.shape[0]

    def counts(self, idx: np.ndarray) -> np.ndarray:
        return self._counts[idx]

    def cohort(self, idx: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        return self._x[idx], self._y[idx], self._mask[idx]


class SyntheticFleetSource:
    """Clients generated on demand: client ``i``'s subset is a function of
    (seed, i) alone, so 100k clients cost O(cohort) bytes. Class prototypes
    come from the seed; client i draws its labels from the 2-class slice
    ``{i, i + 1} mod classes`` and its features as prototype + noise.
    numpy only: the same bytes as the JAX package's source for every
    (seed, client id), and for ``test_set``."""

    def __init__(self, nr_clients: int, *, samples_per_client: int = 8,
                 features: int = 16, classes: int = 10, seed: int = 0,
                 noise: float = 0.3):
        self.nr_clients = int(nr_clients)
        self.samples_per_client = int(samples_per_client)
        self.features = int(features)
        self.classes = int(classes)
        self.seed = int(seed)
        self.noise = float(noise)
        proto_rng = np.random.default_rng(np.random.SeedSequence([seed]))
        self.prototypes = proto_rng.normal(
            size=(classes, features)).astype(np.float32)

    def _client(self, cid: int) -> Tuple[np.ndarray, np.ndarray]:
        g = np.random.default_rng(
            np.random.SeedSequence([self.seed, int(cid)]))
        ys = (int(cid) + g.integers(0, 2, self.samples_per_client)
              ) % self.classes
        xs = (self.prototypes[ys]
              + self.noise * g.normal(
                  size=(self.samples_per_client, self.features))
              ).astype(np.float32)
        return xs, ys.astype(np.int32)

    def counts(self, idx: np.ndarray) -> np.ndarray:
        return np.full(len(idx), self.samples_per_client, np.int32)

    def cohort(self, idx: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        xs = np.empty((len(idx), self.samples_per_client, self.features),
                      np.float32)
        ys = np.empty((len(idx), self.samples_per_client), np.int32)
        for row, cid in enumerate(idx):
            xs[row], ys[row] = self._client(cid)
        return xs, ys, np.ones(ys.shape, np.float32)

    def test_set(self, n: int, seed: int = 1
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """A held-out sample of the same task, for the accuracy probe."""
        g = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.nr_clients + 1, seed]))
        ys = g.integers(0, self.classes, n)
        xs = (self.prototypes[ys]
              + self.noise * g.normal(size=(n, self.features))
              ).astype(np.float32)
        return xs, ys.astype(np.int32)


def _cohort_tensors(source, idx: np.ndarray, device: torch.device):
    """One cohort on ``device``: x, y as int64 (the loss gathers by it),
    mask."""
    xs, ys, ms = source.cohort(idx)
    return (torch.from_numpy(np.ascontiguousarray(xs)).to(device),
            torch.from_numpy(np.asarray(ys)).to(device, torch.int64),
            torch.from_numpy(np.asarray(ms, np.float32)).to(device))


# ---------------------------------------------------------------- tier policy

@dataclass(frozen=True)
class TierPolicy:
    """What one aggregation tier does to its inputs before reducing them.

    - ``defense``: an ``fl.defenses`` hook ``(stacked_inputs, weights) ->
      agg``; at the edge over its clients' deltas (collected as a flat
      ``[m_e, P]`` stack), at the server over the edge aggregates.
    - ``dp_clip`` / ``dp_noise_multiplier``: clip each tier input to the L2
      ball, then add σ = z · clip / n to the tier aggregate (uniform
      weighting needed when z > 0; no defense in the same tier, whose
      selection would change the sensitivity).
    - ``secure_agg``: ``(clip_norm, bits)``, pairwise-masked fixed-point
      uploads into the edge tier (uniform weighting, clipping at
      clip_norm); equal to ``SecureAggFedAvgServer`` at one edge.
    """
    defense: Optional[Callable] = None
    dp_clip: Optional[float] = None
    dp_noise_multiplier: float = 0.0
    secure_agg: Optional[Tuple[float, int]] = None


@dataclass(frozen=True)
class FleetConfig:
    """The fleet engine's knobs, on top of the protocol's ``FLConfig``."""
    cohort_width: int = 64
    edges: int = 1
    weighting: str = "samples"          # "samples" | "uniform"
    edge: TierPolicy = field(default_factory=TierPolicy)
    server: TierPolicy = field(default_factory=TierPolicy)


def _check_fleet(fleet: FleetConfig, cfg: FLConfig) -> None:
    """The JAX server's validations, in its order and with its messages."""
    if fleet.cohort_width < 1:
        raise ValueError(f"cohort_width={fleet.cohort_width}")
    if not 1 <= fleet.edges <= cfg.clients_per_round:
        raise ValueError(
            f"edges={fleet.edges}: need 1..clients_per_round "
            f"({cfg.clients_per_round}) — an empty edge aggregates "
            "nothing")
    if fleet.weighting not in ("samples", "uniform"):
        raise ValueError(f"weighting={fleet.weighting!r}")
    if fleet.server.secure_agg is not None:
        raise ValueError("secure_agg is an edge-tier (client-upload) "
                         "mechanism; the server tier sees E edge "
                         "aggregates, not masked client vectors")
    for tier, name in ((fleet.edge, "edge"), (fleet.server, "server")):
        if tier.dp_noise_multiplier > 0 and tier.dp_clip is None:
            raise ValueError(f"{name}: dp_noise_multiplier > 0 needs "
                             "a finite dp_clip")
        if tier.dp_noise_multiplier > 0 and tier.defense is not None:
            raise ValueError(f"{name}: dp_noise_multiplier > 0 does "
                             "not compose with a defense — the σ = "
                             "z·clip/n calibration assumes the plain "
                             "uniform mean's sensitivity")
    needs_uniform = (fleet.edge.secure_agg is not None
                     or fleet.edge.dp_noise_multiplier > 0
                     or fleet.server.dp_noise_multiplier > 0)
    if needs_uniform and fleet.weighting != "uniform":
        raise ValueError("secure_agg / DP noise require "
                         "weighting='uniform' (sample-count weights "
                         "make the sensitivity data-dependent)")
    if fleet.edge.secure_agg is not None and (
            fleet.edge.defense is not None
            or fleet.edge.dp_clip is not None):
        raise ValueError("edge secure_agg already clips and hides "
                         "per-client vectors; it composes with "
                         "server-tier policies, not with edge "
                         "defense/dp_clip")


# ------------------------------------------------------------ the fleet server

class FleetFedAvgServer(_ServerBase):
    """Δ-upload FedAvg over the cohort-streamed round engine, with an
    optional edge → server hierarchy (module docstring). The protocol
    surface of the vmapped servers: ``FLConfig``, host sampling,
    per-(client, round) seeds, ``run()`` / ``RunResult`` / telemetry.
    ``device`` defaults to CUDA.

    >>> src = SyntheticFleetSource(100_000, features=64, classes=16)
    >>> s = FleetFedAvgServer(params, apply_fn, src, xt, yt,
    ...                       FLConfig(nr_clients=100_000,
    ...                                client_fraction=1.0),
    ...                       FleetConfig(cohort_width=64, edges=4))
    >>> s.run(1)
    """

    def __init__(self, init_params, apply_fn, source, test_x, test_y,
                 cfg: FLConfig, fleet: FleetConfig = FleetConfig(), *,
                 telemetry=None, device=None):
        _check_fleet(fleet, cfg)
        super().__init__(init_params, apply_fn, source, test_x, test_y,
                         cfg, algorithm="fleet-fedavg", telemetry=telemetry,
                         device=device)
        self.source = source
        self.fleet = fleet
        # Span tree per round: fl_round → tier → cohort, the causal view
        # of the flat fl_cohort / fl_tier events.
        self._tracer = Tracer(telemetry.events) if telemetry else None
        self._manifest_extra = {"fleet": dataclasses.asdict(fleet)}
        # One client's upload: fp32 deltas, or the same-width int32 tree
        # under secure aggregation.
        self._client_payload_bytes = tree_bytes(self.params)
        if fleet.edge.secure_agg is not None:
            clip_norm, bits = fleet.edge.secure_agg
            check_secagg_capacity(bits, self._edge_width(0))
            self._secagg_scale = secagg_scale(clip_norm, bits)
            self._mask_root = cfg.seed ^ _MASK_SALT
        self._unflatten_vec = unflattener(self.params)
        # Each cohort step sees one call signature (the last cohort pads):
        # a second one is a retrace.
        events = telemetry.events if telemetry is not None else None
        self._stream_step = watch(self._stream_cohort,
                                  name="fleet/stream_step", max_caches=1,
                                  events=events)
        self._collect_step = watch(self._collect_cohort,
                                   name="fleet/collect_step", max_caches=1,
                                   events=events)
        self._secagg_step = watch(self._secagg_cohort,
                                  name="fleet/secagg_step", max_caches=1,
                                  events=events)

    def _place_data(self, data):
        return data              # a streaming source, gathered per cohort

    # ------------------------------------------------------- cohort steps
    def _client_deltas(self, params, xs, ys, ms, gens):
        """The cohort's Δ = w_global − w_local, stacked (→ clipped per
        client by the edge's ``dp_clip``, which secure aggregation leaves
        unset): ``FedAvgGradServer``'s client ops."""
        cfg = self.cfg
        new = local_sgd(self.apply_fn, params, xs, ys, ms, epochs=cfg.epochs,
                        batch_size=cfg.batch_size, lr=cfg.lr,
                        generators=gens)
        deltas = tree_map(torch.sub, params, new)
        if self.fleet.edge.dp_clip is not None:
            deltas = clip_by_global_norm(deltas, self.fleet.edge.dp_clip,
                                         stacked=True)
        return deltas

    def _stream_cohort(self, params, acc, xs, ys, ms, gens, w):
        """Fold the cohort's weighted deltas into the carried aggregate
        (weight-0 padding rows are selected around)."""
        return tree_weighted_fold(self._client_deltas(params, xs, ys, ms,
                                                      gens), w, init=acc)

    def _collect_cohort(self, params, xs, ys, ms, gens):
        """The cohort's per-client flat deltas ``[W, P]``."""
        return stack_flat(self._client_deltas(params, xs, ys, ms, gens))[0]

    def _secagg_cohort(self, params, xs, ys, ms, gens, gids, pair_ids,
                       pair_valid, r, n_real):
        """The ring sum of the cohort's real clients' masked uploads:
        ``SecureAggFedAvgServer``'s client ops (clip, quantize, add the
        pairwise masks against every valid id of the edge)."""
        clip_norm, _ = self.fleet.edge.secure_agg
        deltas = clip_by_global_norm(self._client_deltas(params, xs, ys, ms,
                                                         gens),
                                     clip_norm, stacked=True)
        q = quantize_tree(deltas, self._secagg_scale)
        ups = [add_pair_masks(tree_index(q, c), int(gids[c]), pair_ids,
                              pair_valid, self._mask_root, r)
               for c in range(n_real)]
        return ring_sum(tree_map(lambda *u: torch.stack(u), *ups))

    # ------------------------------------------------------------- plumbing
    def _edge_width(self, e: int) -> int:
        """Size of edge ``e``'s client partition (``np.array_split``)."""
        m = self.cfg.clients_per_round
        return len(np.array_split(np.arange(m), self.fleet.edges)[e])

    def _weighting_counts(self, counts: np.ndarray) -> np.ndarray:
        if self.fleet.weighting == "uniform":
            return np.ones(len(counts), np.int32)
        return counts

    def _weights(self, counts: np.ndarray) -> torch.Tensor:
        """FedAvg weights from the vmapped servers' function, on the host:
        a cohort takes its W to the device, so the device never holds a
        per-client vector of the round. Integer counts sum exactly in fp32
        below 2^24 samples, in any order, so the weights are bitwise those
        the servers compute on the device."""
        return _weights_for(torch.as_tensor(
            np.asarray(self._weighting_counts(counts))))

    def _noise_generator(self, r: int, tier: int, e: int) -> torch.Generator:
        """The DP noise stream of (round, tier, edge)."""
        return rng.generator(rng.derived_seed(
            self.cfg.seed ^ _FLEET_NOISE_SALT, r, tier, e), self.device)

    def _generators(self, r: int, cidx: np.ndarray) -> List[torch.Generator]:
        m = self.cfg.clients_per_round
        return [rng.client_generator(self.cfg.seed, r, int(i), m, self.device)
                for i in cidx]

    def _cohorts(self, eidx: np.ndarray):
        """``(c, cidx padded to W, n_real)`` per cohort of an edge; padding
        repeats the cohort's first client."""
        W = self.fleet.cohort_width
        for c in range(-(-len(eidx) // W)):
            cidx = eidx[c * W:(c + 1) * W]
            n_real = len(cidx)
            if n_real < W:
                cidx = np.concatenate(
                    [cidx, np.full(W - n_real, cidx[0], cidx.dtype)])
            yield c, cidx, n_real

    def _emit_cohort(self, r: int, tier: str, e: int, c: int,
                     n_real: int) -> None:
        if self.telemetry is not None:
            self.telemetry.events.fl_cohort(
                round=r, tier=tier, cohort=c, edge=e, clients=n_real,
                payload_bytes=n_real * self._client_payload_bytes)

    def _span(self, name: str, parent=None, **attrs):
        """A tracer span (a no-op without telemetry) under ``parent``, the
        enclosing Span, or a root on the "fleet" trace. Durations are the
        host's: a cohort span covers gather and dispatch."""
        if self._tracer is None:
            return contextlib.nullcontext()
        return self._tracer.span(
            name, parent=parent.ctx if parent is not None else None,
            trace="fleet" if parent is None else None, **attrs)

    # ----------------------------------------------------------- edge tier
    def _stream_edge(self, params, r: int, e: int, eidx: np.ndarray,
                     w: torch.Tensor, parent=None):
        """One edge's round, plain: W clients on the device at a time,
        folded in order into the carried aggregate."""
        W = self.fleet.cohort_width
        acc = tree_map(torch.zeros_like, params)
        for c, cidx, n_real in self._cohorts(eidx):
            cw = w[c * W:(c + 1) * W]
            if n_real < W:
                cw = torch.cat([cw, cw.new_zeros(W - n_real)])
            cw = cw.to(self.device)
            with self._span("cohort", parent, cohort=c, clients=n_real):
                xs, ys, ms = _cohort_tensors(self.source, cidx, self.device)
                acc = self._stream_step(params, acc, xs, ys, ms,
                                        self._generators(r, cidx), cw)
            self._emit_cohort(r, "edge", e, c, n_real)
        return acc

    def _collect_edge(self, params, r: int, e: int, eidx: np.ndarray,
                      parent=None) -> torch.Tensor:
        """One edge's round for a defense: its clients' flat deltas
        ``[m_e, P]``, collected on the host cohort by cohort."""
        rows: List[torch.Tensor] = []
        for c, cidx, n_real in self._cohorts(eidx):
            with self._span("cohort", parent, cohort=c, clients=n_real):
                xs, ys, ms = _cohort_tensors(self.source, cidx, self.device)
                flat = self._collect_step(params, xs, ys, ms,
                                          self._generators(r, cidx))
                rows.append(flat[:n_real].cpu())
            self._emit_cohort(r, "edge", e, c, n_real)
        return torch.cat(rows, dim=0)

    def _secagg_edge(self, params, r: int, e: int, eidx: np.ndarray,
                     parent=None):
        """One edge's round under pairwise masking: the masked int32 sums
        of the cohorts, added on the 2^32 ring, dequantized once."""
        m_e = len(eidx)
        # Every edge pads its id list to the widest edge's length.
        pair_w = self._edge_width(0)
        pair_ids = np.concatenate([eidx, np.zeros(pair_w - m_e, eidx.dtype)])
        pair_valid = np.arange(pair_w) < m_e
        total = None
        for c, cidx, n_real in self._cohorts(eidx):
            with self._span("cohort", parent, cohort=c, clients=n_real):
                xs, ys, ms = _cohort_tensors(self.source, cidx, self.device)
                part = self._secagg_step(params, xs, ys, ms,
                                         self._generators(r, cidx), cidx,
                                         pair_ids, pair_valid, r, n_real)
                total = part if total is None else tree_map(
                    lambda a, b: wrap_int32(a.to(torch.int64)
                                            + b.to(torch.int64)),
                    total, part)
            self._emit_cohort(r, "edge", e, c, n_real)
        # SecureAggFedAvgServer's server side: one multiply by the host
        # constant scale / m.
        return dequantize_tree(total, self._secagg_scale / m_e)

    def _edge_round(self, params, r: int, e: int, eidx: np.ndarray,
                    counts: np.ndarray, parent=None):
        """One edge aggregate: stream, then apply the edge ``TierPolicy``."""
        pol = self.fleet.edge
        with self._span("tier", parent, tier="edge", edge=e,
                        clients=len(eidx)) as tspan:
            if pol.secure_agg is not None:
                return self._secagg_edge(params, r, e, eidx, tspan)
            w = self._weights(counts)
            if pol.defense is not None:
                flat = self._collect_edge(params, r, e, eidx,
                                          tspan).to(self.device)
                flat_hook = getattr(pol.defense, "flat_hook", None)
                w = w.to(self.device)
                if flat_hook is not None:
                    agg = self._unflatten_vec(flat_hook(flat, w))
                else:
                    agg = pol.defense(unstack_flat(flat, params), w)
            else:
                agg = self._stream_edge(params, r, e, eidx, w, tspan)
            if pol.dp_noise_multiplier > 0:
                sigma = pol.dp_noise_multiplier * pol.dp_clip / len(eidx)
                agg = tree_map(torch.add, agg, gaussian_noise_like(
                    self._noise_generator(r, 0, e), agg, sigma))
            return agg

    # ---------------------------------------------------------- server tier
    def _server_round(self, r: int, edge_aggs: list,
                      edge_counts: np.ndarray, parent=None):
        """Reduce the E edge aggregates under the server ``TierPolicy``.
        Skipped at E = 1 with an empty policy (no server tier ran, so no
        server-tier span either)."""
        pol = self.fleet.server
        if (len(edge_aggs) == 1 and pol.defense is None
                and pol.dp_clip is None and pol.dp_noise_multiplier == 0):
            return edge_aggs[0]
        with self._span("tier", parent, tier="server",
                        inputs=len(edge_aggs)):
            stacked = tree_map(lambda *a: torch.stack(a), *edge_aggs)
            if pol.dp_clip is not None:
                stacked = clip_by_global_norm(stacked, pol.dp_clip,
                                              stacked=True)
            ew = self._weights(edge_counts).to(self.device)
            if pol.defense is not None:
                agg = pol.defense(stacked, ew)
            else:
                agg = tree_weighted_fold(stacked, ew)
            if pol.dp_noise_multiplier > 0:
                sigma = (pol.dp_noise_multiplier * pol.dp_clip
                         / len(edge_aggs))
                agg = tree_map(torch.add, agg, gaussian_noise_like(
                    self._noise_generator(r, 1, 0), agg, sigma))
            return agg

    # ------------------------------------------------------------ the round
    def _round(self, params, r):
        idx = self._sample(r)
        m = len(idx)
        counts = np.asarray(self.source.counts(idx))
        parts = np.array_split(np.arange(m), self.fleet.edges)
        edge_aggs = []
        edge_counts = np.empty(len(parts), np.int64)
        with self._span("fl_round", round=r, clients=m,
                        edges=len(parts)) as rspan:
            for e, pos in enumerate(parts):
                edge_aggs.append(self._edge_round(params, r, e, idx[pos],
                                                  counts[pos], rspan))
                edge_counts[e] = (int(counts[pos].sum())
                                  if self.fleet.weighting == "samples"
                                  else len(pos))
            tel = self.telemetry
            if tel is not None:
                tel.events.fl_tier(
                    round=r, tier="edge", edges=len(parts), clients=m,
                    payload_bytes=m * self._client_payload_bytes,
                    wire=("int32-masked"
                          if self.fleet.edge.secure_agg is not None
                          else "float32"))
                tel.events.fl_tier(
                    round=r, tier="server", inputs=len(edge_aggs),
                    payload_bytes=(len(edge_aggs)
                                   * self._client_payload_bytes))
            agg = self._server_round(r, edge_aggs, edge_counts, rspan)
            return tree_sub(params, agg)


# ------------------------------------------------------------ the reference

def vmapped_round_reference(params, apply_fn, source, idx, cfg: FLConfig,
                            r: int, *, weighting: str = "samples",
                            clip: Optional[float] = None, device=None):
    """The round the streamed engine implements, with every sampled client
    on the device at once (O(clients) device memory): one ``local_sgd``
    over all of ``idx``, the same per-client generators, and the same
    ordered fold. ``device`` defaults to CUDA."""
    dev = resolve_device(device)
    idx = np.asarray(idx)
    params = tree_map(lambda t: torch.as_tensor(t).to(dev), params)
    xs, ys, ms = _cohort_tensors(source, idx, dev)
    m = cfg.clients_per_round
    gens = [rng.client_generator(cfg.seed, r, int(i), m, dev) for i in idx]
    with torch.no_grad(), fp32_products():
        new = local_sgd(apply_fn, params, xs, ys, ms, epochs=cfg.epochs,
                        batch_size=cfg.batch_size, lr=cfg.lr,
                        generators=gens)
        deltas = tree_map(torch.sub, params, new)
        if clip is not None:
            deltas = clip_by_global_norm(deltas, clip, stacked=True)
        counts = (np.ones(len(idx), np.int32) if weighting == "uniform"
                  else np.asarray(source.counts(idx)))
        w = _weights_for(torch.as_tensor(counts)).to(dev)
        return tree_sub(params, tree_weighted_fold(deltas, w))
