"""Configuration: the port's own copies of ``FLConfig``, ``LlamaConfig``,
``MoEConfig``, ``TrainConfig``, ``ResilienceConfig``, ``VFLConfig`` and
``VAEConfig``.

Same fields and defaults as the JAX package's ``config.FLConfig`` (the
homework-1 federated setting: N=100, C=0.1, B=100, E=1, lr 0.01, 10
rounds), ``config.LlamaConfig`` (the canonical tiny-Llama: vocab 32000,
dmodel 288, 6 heads of dim 48, 6 layers, ctx 256), ``config.MoEConfig``
(its Mixture-of-Experts variant: 8 experts, top-2, capacity factor 1.25)
and ``config.TrainConfig``, ``config.VFLConfig`` (homework 2's split
learning: 4 parties, 300 epochs, batch 64, lr 1e-3) and ``config.VAEConfig`` (the
tabular VAE: hidden 50-12, latent 3, 200 epochs), so a config built for
one package means the same model and run in the other. The port's trainer
raises ``NotImplementedError`` for the ``TrainConfig`` fields it does not
run yet at a non-default value (``train.llm.unsupported_train_fields``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class FLConfig:
    """Horizontal federated learning (FedSGD / FedAvg) configuration."""

    nr_clients: int = 100          # N
    client_fraction: float = 0.1   # C — fraction of clients sampled per round
    batch_size: int = 100          # B — -1 means full local dataset (∞)
    epochs: int = 1                # E — local epochs per round (FedAvg)
    lr: float = 0.01               # η
    rounds: int = 10
    iid: bool = True
    seed: int = 10

    @property
    def clients_per_round(self) -> int:
        return max(1, int(self.client_fraction * self.nr_clients))


@dataclass(frozen=True)
class LlamaConfig:
    """tiny-Llama model configuration."""

    vocab_size: int = 32000
    dmodel: int = 288
    num_heads: int = 6
    n_layers: int = 6
    ctx_size: int = 256
    ffn_hidden: Optional[int] = None   # None -> 4 * dmodel (SwiGLU-gated)
    padding_idx: Optional[int] = None
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    dtype: str = "float32"             # computation dtype
    param_dtype: str = "float32"
    # Attention backend: "xla" is the plain PyTorch attention; "pallas" is
    # the hand-written CUDA flash kernel (ops/flash_attention.py) and raises
    # on CPU tensors and for heads wider than the kernels take
    # (``flash_attention.MAX_HEAD_DIM``, 128); "auto" takes the kernel iff
    # the tensors are on CUDA, the sequence is at least ``flash_min_seq``
    # long and the kernels take the head dim (models/llama.py use_flash: a
    # choice by shape, never a fallback from a failed kernel).
    attention_impl: str = "auto"
    flash_min_seq: int = 256
    # Kernel operand layout: [B·H, Dh, T] when True, else [B, T, H, Dh] as
    # given. The CUDA kernel reads either through strides.
    flash_dh_major: bool = True
    # Block-size cap handed to flash_attention for signature parity; the
    # CUDA kernel picks its own tiles.
    flash_block: int = 512
    # Dtype of the materialized [B·H, T, T] score tensor on the plain path.
    softmax_dtype: str = "float32"
    # Activation rematerialization: each block under
    # torch.utils.checkpoint (models/llama.py blocks_apply).
    remat: bool = False

    @property
    def head_dim(self) -> int:
        if self.dmodel % self.num_heads:
            raise ValueError(f"dmodel={self.dmodel} is not a multiple of "
                             f"num_heads={self.num_heads}")
        return self.dmodel // self.num_heads

    @property
    def ffn_dim(self) -> int:
        return self.ffn_hidden if self.ffn_hidden is not None else 4 * self.dmodel

    def replace(self, **kw) -> "LlamaConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-Experts tiny-Llama, field for field the JAX package's
    ``MoEConfig``: every block's SwiGLU MLP becomes a bank of
    ``n_experts`` routed top-``top_k``; attention and the embedding keep
    ``base``'s shapes."""

    base: LlamaConfig = field(default_factory=LlamaConfig)
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25  # expert capacity = ceil(N·k/E · factor)
    aux_loss_coef: float = 0.01    # load-balance loss weight (Switch-style)

    def replace(self, **kw) -> "MoEConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class TrainConfig:
    """LLM training loop configuration (Adam lr 8e-4, 5000 iterations,
    batch 3 per data shard, seq 256), field for field the JAX package's.
    Parallelism, wire formats and dispatch fields are kept so configs carry
    over; the port runs data parallelism (``data`` processes, ``dcn``
    islands, ``accum_steps``, ``steps_per_dispatch``, every ``optimizer``,
    the ring fields ``wire``, ``wire_dcn``, ``overlap_microbatches``,
    ``comm_buckets``), pipeline parallelism (``stage``, ``microbatches``,
    the DP×PP ring fields: ``train.llm.train_llm_pp``) and tensor
    parallelism (``model``, ``psa``: ``train.llm.train_llm_tp``), and
    raises for the rest (``seq``: ``train.llm.unsupported_train_fields``)."""

    batch_size: int = 3            # per-data-shard batch
    seq_len: int = 256
    lr: float = 8e-4
    iters: int = 5000
    seed: int = 0
    data: int = 1                  # data-parallel world
    dcn: int = 1                   # hierarchical DP islands
    stage: int = 1                 # pipeline stages
    model: int = 1                 # tensor parallel degree
    seq: int = 1                   # sequence/context parallel degree
    microbatches: int = 1          # pipeline microbatches per step
    remat: bool = False            # rematerialize blocks in the backward
    # "adam" (the reference's optimizer), "fused" (ops/adam.py), "pallas"
    # (ops/pallas_adam.py, the CUDA kernel), "master" (fp32 master weights).
    optimizer: str = "adam"
    wire: str = "fp32"             # gradient all-reduce wire format
    wire_dcn: str = ""             # DCN-tier wire format
    accum_steps: int = 1           # gradient accumulation microbatches
    steps_per_dispatch: int = 1    # training steps per fused dispatch
    overlap_microbatches: int = 0  # overlapped ring gradient sync
    comm_buckets: int = 1          # bucketed backward ring sync
    numerics_every: int = 0        # in-step numerics summaries
    psa: str = ""                  # TP partially-synchronized activations

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ResilienceConfig:
    """Self-healing knobs for the training loops (``resilience/``), field
    for field the JAX package's. ``faults`` is a ``FaultPlan`` spec string
    (empty: inject nothing). ``elastic=True`` re-meshes ``train_llm_dp``,
    ``train_llm_pp`` (a data-row drop, else a stage re-partition) and
    ``train_llm_tp`` (a data-row drop; a model-axis loss is fatal) over the
    surviving ranks and back (``resilience/elastic.py``); ``mirror_every``
    is its host mirror's cadence in chunk edges (0: no mirror, recovery
    from the checkpoint)."""

    guard: bool = True             # wrap the train step in a StepGuard
    # The skip fused into the step (parallel.dp ``guard_nonfinite``):
    # mutually exclusive with ``guard``.
    injit_guard: bool = False
    max_consecutive_bad: int = 3   # K consecutive bad steps → rollback
    ema_decay: float = 0.98        # update-norm EMA smoothing
    anomaly_factor: float = 10.0   # spike threshold (×EMA); <=0 disables
    ema_warmup: int = 20           # good steps before the detector arms
    retry_attempts: int = 3        # checkpoint-IO retry budget
    retry_base_delay: float = 0.1  # seconds; doubles per attempt, jittered
    faults: str = ""               # FaultPlan spec for injection runs
    fault_seed: int = 0            # drives every random fault choice
    elastic: bool = False          # elastic re-mesh (train_llm_dp)
    mirror_every: int = 1          # elastic host-RAM mirror cadence

    def fault_plan(self):
        """The configured FaultPlan (empty spec → empty plan)."""
        from .resilience.faults import FaultPlan
        return FaultPlan.from_spec(self.faults, seed=self.fault_seed)


@dataclass(frozen=True)
class VFLConfig:
    """Vertical FL / split learning configuration."""

    nr_clients: int = 4
    epochs: int = 300
    batch_size: int = 64
    lr: float = 1e-3
    # Party i sends bottom_out_mult · d_i activations up the cut.
    bottom_out_mult: int = 2
    seed: int = 0


@dataclass(frozen=True)
class VAEConfig:
    """Tabular VAE configuration (BatchNorm-MLP encoder and decoder)."""

    input_dim: int = 13
    hidden_dims: Tuple[int, ...] = (50, 12)
    latent_dim: int = 3
    lr: float = 1e-3
    epochs: int = 200
    batch_size: int = 64
    seed: int = 0


def torch_dtype(name: str) -> torch.dtype:
    """``"float32"`` / ``"bfloat16"`` / ... -> the torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt
