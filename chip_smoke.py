#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ddl25spring_tpu_torch``) on one CUDA card
and check it end to end.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each of which raises on failure (exit code 1, no result line):

1. device  — the card's name and power limit (nvidia-smi); every number
             line below carries them.
2. build   — compile the CUDA kernels from the sources in the checkout
             (nvcc, into the git-ignored build/kernels/).
3. kernels — the flash forward against its plain PyTorch version on the
             card, at the shapes the model gives it, with per-call times
             (CUDA events, median of 100) beside the plain version, one
             PyTorch library call for the same function, and the least time
             the card could take (bytes over HBM rate vs operations over
             peak). bf16 runs the tensor-core kernel: the training shape,
             B=8 in both layouts, ragged T=200 (causal and not) and
             dh-major T=100 (rows of 200 bytes: element staging). fp32
             runs the 3xTF32 tensor-core kernel: B=8 in both layouts,
             the trainer's B=3, non-causal, Dh 64 and 128, ragged T=200,
             and B=1 at T=4096 (64 key tiles a row: the tensor cores'
             truncating sums would drift there), each beside the time of
             the fp32 FMA kernel it replaced where that was measured.
3b. backward — the flash dQ and dK/dV kernels against their plain version
             (``flash_attention_bwd_reference``) at the training shape
             (B=64, T=256, H=6, Dh=48, bf16, dh-major), at B=8 in both
             layouts and both types, at ragged T=200 and at T=100 (causal
             and not), timed likewise; the library call is SDPA's backward.
3c. adam   — the fused Adam kernel (one launch over a table of leaves)
             against the plain rule, with step-3 bias corrections: on the 9
             leaves that take it at vocab 32000 (one launch), on
             ``smoke_check``'s 972 × 512 leaf, and on ragged tables (one
             leaf; leaves of 4, 512, 65,536 + 512 and the chunk ± 512
             elements; 50 leaves, more than a launch's table: two
             launches), max|d| of p, m and v and whether they are bitwise
             equal; per-step time beside ``torch._fused_adam_`` on the same
             leaves, and the two timed in turns (7 pairs of 100 calls
             each): both medians, their spread, the per-pair ratio and the
             TB/s achieved beside the bound.
4. forward — the canonical tiny-Llama (vocab 32000, dmodel 288, 6 heads of
             48, 6 layers, ctx 256) at B=8, T=256, seeded random weights:
             logits through the kernel ("auto") vs the plain path ("xla"),
             and the kernel launch count per forward (one per layer). Then
             a model with heads of 144, wider than the kernels take
             (``flash_attention.MAX_HEAD_DIM``): "auto" runs it on the
             plain path, no kernel launched, equal to "xla", and "pallas"
             raises naming the limit.
5. serving — ``run_serving`` at full width, 32 Poisson requests on 8 slots:
             every request completes with max_new tokens, and every greedy
             stream equals the port's ``generate()`` for it alone, or
             differs first at a near-tie of the reference's logits.
6. train   — the training step at full width through ``time_train_step``
             (bf16 compute, flash kernels in the dh-major layout, the fused
             Adam kernel, batch 64 × 256): launches per step of each kernel
             (flash forward 6, dQ 6, dK/dV 6, Adam 1), a finite loss,
             tokens/s (wall), the kernels' ms per step by category
             (``profile_step``) and MFU. Then, at fp32 and
             batch 8, the kernel path against the plain path: one step's
             loss and every gradient leaf, and a 5-step loss trajectory;
             and at bf16 and batch 8, one step's loss and every leaf.
7. trainer — ``train_llm_dp(device=None)`` for 20 steps on the synthetic
             corpus (byte tokenizer, vocab 259) with ``optimizer="pallas"``:
             finite losses, and 6 + 6 + 6 flash launches and 1 Adam
             launch per step.
8. fl      — horizontal federated learning at homework 1's defaults (N=100,
             C=0.1, B=100, E=1, lr 0.01) on ``synthetic_mnist(60000, 10000,
             seed=0)``, the MNIST CNN on the card, no port kernel launched:
             one FedAvg round with fixed clients and dropout off on the card
             and on the CPU (every leaf within 1e-4 of its largest entry);
             FedSGD's gradient and weight uploads for 2 rounds (rtol 2e-4,
             atol 1e-6, accuracies within 2e-4); FedAvg IID for 10 rounds
             with dropout live (accuracy per round, wall ms per round,
             client samples/s; the final accuracy at least the JAX
             package's on the CPU from the same initial parameters less
             0.03, ``fl_reference_bar.py``) and non-IID (finite, above the
             untrained model), and 3 more IID rounds under the profiler
             (kernel ms, launches and busy share per round);
             ``FedAvgGradServer`` for 5 rounds with 20%
             gradient-reversion attackers undefended, under the coordinate
             median (which must beat undefended) and under Krum, and a
             pattern backdoor's clean accuracy and attack success rate.
9. tabular — homework 2 and the privacy half of FL at the reference's
             sizes, no port kernel launched: on ``preprocess(
             synthetic_heart())`` (27 features, 820 train and 205 test
             rows, 9.3% positive) split over 4 parties, the VFL forward
             logits and gradients on the card against the CPU (1e-5 of
             each leaf's largest entry); ``train_classifier`` at its
             defaults; ``train_vfl`` at ``VFLConfig()`` in both modes (the
             faithful mode, held to a falling loss, for 100 epochs);
             ``train_vfl_vae`` for 1,000 epochs (total = recon + kl);
             ``train_vae`` and ``synthetic_data_eval`` at
             ``VAEConfig(input_dim=27)``: every loss falls, and the
             accuracies (beside the majority-class rate) stand at least at
             the JAX package's on the CPU from the same initial parameters
             less 0.03, the final VAE and VFL-VAE losses within 10% of it
             (``fl_reference_bar.py --tabular``). Then on phase 8's MNIST
             at homework 1's defaults: DP-FedAvg (clip 1.0) one round at
             z = 0 on the card against the CPU (1e-4), 5 rounds at z = 0
             (above the untrained CNN), one round at z = 1.0 whose noise
             has an empirical std within 1% of σ = 0.1, and
             ``privacy_spend(1.0, 5, 0.1)``; secure aggregation (clip
             5.0, 20 bits) one round on the card against the CPU (one
             quantum per coordinate), the masked sum equal to the unmasked
             quantized sum bitwise on the card, and 5 rounds (above the
             untrained CNN). Wall per epoch and per round.
10. dp      — multi-process data parallelism: two ranks on the one card
             (``distributed.run_ranks``, both on cuda:0), joined by gloo,
             one launch for the whole phase (``programs.phase10``):
             a. the gloo probe (int32 scalar and a 26,398,368-element fp32
             vector all-reduced and broadcast, sums exact; the route);
             b. the canonical model at fp32, B = 4 per rank x 256, against
             a world of one at B = 8 on the same tokens and weights: loss
             within 1e-5, the averaged gradient within 1e-5 of each leaf's
             largest entry, a 5-step loss trajectory within 1e-3;
             c. ``time_train_step`` at bf16, B = 32 per rank x 256 (phase
             6's 64 x 256 tokens per step): launches per rank per step, a
             finite loss, all ranks' tokens/s beside phase 6's world of
             one, and the gradient all-reduce's own ms per step (gloo on
             one card, staged through the host: not NCCL); d. ZeRO-1 on b's
             batches, within 1e-3 of b's trajectory, half the moment bytes,
             no Adam launch (its 13,199,184-element slice is not a multiple
             of 512); e. weight aggregation, 3 steps, the parameters'
             digests equal across the ranks after each; f. the K-step
             loop at K = 4 bitwise four per-step calls; g.
             ``train_llm_dp(data=2)`` at vocab 259 for 20 steps, 10 resumed
             to 20 from a checkpoint (within 1e-6 of the uninterrupted
             run), and ``optimizer="master"`` on bf16 parameters.
11. serving extensions — at full width on phase 5's pool (129 blocks of
             16, 8 slots) and workload, no port kernel launched: phase 5's
             configuration rerun as the baseline, with each dispatch timed
             between device syncs; a. speculation with a same-weights draft
             at k = 4 (acceptance, tokens per target dispatch, draft vs
             verify ms per round, tok/s and TTFT beside the baseline), and
             5 profiled steps of 8 decoding slots, plain and speculative
             (kernel ms, busy share); b. an independent 2-layer draft at
             k = 1 and 4 (acceptance near 0 with random weights); c.
             ``rejection_accept`` over 4,096 trials on the card (acceptance
             and emitted distribution within 0.03 of Σ min(p, q) and p); d.
             copy-on-write over a 128-token prefix: two overlapping
             requests' peak drops by exactly 8 blocks, 8 requests' peak
             with and without, and the shared blocks' bytes unchanged
             across every sharer's prefill; e. gather narrowing (bytes
             saved, decode ms per dispatch beside the baseline); f. the
             fleet (``run_serving_fleet``, 1 and 2 engines, both router
             policies, a two-class workload of 32 requests, per-engine
             TTFT), a same-weights publish that changes no token, a
             second-seed publish that changes none before each engine's
             swap, and the train→deploy conveyor: phase 7's trainer with a
             ``CheckpointPublisher`` every 5 steps (6/6/6/1 launches per
             step), a ``WeightPublisher`` rolling step 20 onto a 2-engine
             vocab-259 fleet, whose parameters then equal the trainer's
             bitwise. Every greedy stream meets phase 5's bar.
12. resilience and telemetry — at full width (phase 7's trainer: the
             canonical dims, byte tokenizer, vocab 259, batch 3 x 256,
             optimizer pallas): a. 10 guarded fault-free steps bitwise the
             unguarded run, 6/6/6/1 launches per step, and
             ``measure_overhead``'s guard tax at phase 6's shape; b.
             ``nan_grad@3,nan_grad@7:4,spike_grad@12:100`` under the
             guard: 2 skipped, 1 anomaly, the rest finite, the step-7 fault
             event and its flight-recorder bundle naming leaf #4
             (``blocks/w_gate``); c. three NaN steps roll back to the step-5
             checkpoint bitwise; d. ``preempt@8`` force-saves, and a second
             call completes to the uninterrupted losses (1e-6); e. b's run
             observed (``Telemetry``, ``numerics_every=5``): every event
             valid, no orphan span, the comm profile (0 wire bytes at world
             1; phase 10's data=2 step 105.6 MB of fp32 gradient), the
             preflight's state bytes equal to the live state's beside the
             measured peak, a numerics grad norm against a recomputation
             (1e-5); f. ``remat=True`` at vocab 32000, B=64 x 256, bf16:
             loss and gradients against ``remat=False`` (bitwise, else the
             bf16 limits), flash forward 12 launches per step (dQ 6, dK/dV
             6, Adam 1), both peaks and rates; g. phase 5's workload queued
             at once with ``memory_every=4``: memory events, streams bitwise
             those without, compiles 2 and retraces 0; 2 FedAvg rounds at
             phase 8's configuration with ``drop_client@0:2`` and
             telemetry: 2 ``fl_round`` events, card vs CPU within 1e-4.
13. pipeline parallelism — three stage processes on the one card, joined
             by gloo, each hop staged through the host (one
             ``programs.phase13`` launch): a. the canonical model in fp32,
             B = 12 x 256, S = 3, M = 3, GPipe, 1F1B and interleaved (two
             chunks per stage): the loss and every stage's gradient leaves
             within 1e-4 of the world-of-one step on the card at the same
             weights and batch; b. bf16, B = 48 x 256, M = 6, the "pallas"
             optimizer: each schedule's ms per step timed in turns (3
             rounds of 5 steps, the order rotating), the flash forward,
             dQ, dK/dV and Adam launches per stage per step (GPipe and
             interleaved 12/12/12/1, 1F1B 24/12/12/1: its backward
             recomputes the stage), and the hop of one [8, 256, 288] bf16
             activation alone (device→host, gloo, host→device); c. the
             homework's topologies through ``train_llm_pp`` at vocab 259,
             20 steps: b1 ``stage=3, microbatches=3`` (losses within 2e-4
             of phase 7's ``train_llm_dp`` on the same stream) and b2
             ``data=2, stage=3`` (six processes), losses finite and
             falling, 6/6/6/1 launches per stage per step; d. K = 4
             bitwise per-step, 10 steps resumed to 20 bitwise, and
             ``nan_grad@3`` skipped on every stage.
14. fleet-scale FL and the autoscaler — no port kernel launched: a.
             homework 1's FedAvg (phase 8's configuration, data and initial
             parameters) through ``FleetFedAvgServer`` over
             ``FederatedArraySource``: round 0 bitwise ``FedAvgGradServer``'s
             at cohort width 10 (the server's shapes), within 1e-6 of each
             leaf's largest entry at width 4 (cohorts 4, 4, 2) and at E=2;
             10 rounds at width 4 above phase 8's bar, ms per round beside
             ``FedAvgGradServer``'s, ``fl_cohort``/``fl_tier`` events and
             payload bytes exact, no retrace; b. the tiers: the edge
             Multi-Krum's selection that of ``FedAvgGradServer(defense=)``,
             secure aggregation at E=1 bitwise ``SecureAggFedAvgServer``'s
             round, DP at z=0 within 1e-6 of the clip-only round, at z=1
             the noise's std within 1% of σ, distinct streams per tier and
             edge; c. ``experiments.fleet_smoke``: one round of 25,000
             synthetic clients (clients/s, wall, the host's share, device
             memory growth under four cohorts and the parameters beside
             the all-at-once bytes), its control slice and Krum probe, and
             a profiled 2,048-client round (busy share); d. the
             autoscaler's serving side: phase 11f's two engines on phase
             5's pool under a load that rises and ebbs over 11 control
             ticks on a tick clock, ``Autoscaler.tick`` on
             ``router_ttft_p95`` and the post-move ``pool_headroom``
             applied through ``set_active``: a move each way, the decisions
             equal to the same script's on the CPU, every greedy stream
             ``generate()``'s, every ``scale`` event valid.
15. compressed and overlapped gradient sync — two ranks, then a 2 x 2
             layout of four (``programs.phase15_two`` / ``phase15_four``): a.
             ``ring_reduce_scatter`` on the canonical padded gradient vector
             (26,398,368 seeded fp32 values per rank) in fp32, bf16 and
             int8_ef (two calls, the residual held too), bitwise the numpy
             spec (``parallel/ring_spec.py``) at 2 and 4 ranks;
             ``hier_reduce_scatter`` (fp32 islands, int8_ef DCN) bitwise
             the spec at 2x2, 1x4 and 4x1, and at 1x4 and 4x1 bitwise the
             flat ring; each format's ms per call and per hop (and an fp32
             hop's device->host, gloo and host->device parts) beside the
             105.6 MB fp32 all-reduce, in turns; b. the ring step at two
             ranks: fp32 at B=4 per rank against a world of one at B=8
             (loss and every gradient leaf within 1e-5, phase 10's bar),
             K=4 bitwise 4 per-step calls under int8_ef, and at bf16, B=32
             per rank, phase 10's plain step and the ring in {fp32, bf16,
             int8_ef} x {gradient, zero1} at M=1 plus int8_ef zero1 at M=2
             and at comm_buckets=8, timed in turns: ms per step, wire bytes
             per step, launches per rank per step (6·M / 6·M / 6·M, Adam 1
             under gradient aggregation and 0 under zero1), replicas bitwise;
             c. the two-level step at 2x2, B=16 per rank, gradient and
             zero1: replicas bitwise, the DCN axis's bytes per step at most
             0.30 of the flat fp32 all-reduce's, the DCN ring exact to the
             analytic count, a save at step 2 resumed bitwise to the
             uninterrupted 4 steps, residuals included; d. ``train_llm_dp``
             at vocab 259, 20 steps: ``data=2, overlap_microbatches=2,
             wire="int8_ef"`` under zero1, and ``dcn=2, data=2,
             wire_dcn="int8_ef"`` observed: losses finite and falling, the
             manifest's comm profile by axis, no retrace.
16. tp    — tensor parallelism, two ranks at ``model=2`` and four laid
             out ``data=2 x model=2`` (``programs.phase16_two`` /
             ``phase16_four``): a. the fp32 step (one SGD step at lr 1024)
             at B=4 per data row against a world of one on the same rows
             (loss and every merged gradient leaf within 1e-5); b. K2, K5
             and K6 at a shard's shape (B=32, T=256, H=3, Dh=48, bf16,
             dh-major) against their plain versions (phase 3's limits),
             timed beside SDPA and their bounds; c. the bf16 step at
             B=32 timed in turns with a world of one at B=32, launches
             6/6/6/1 per rank per step, one activation sum and the
             replicated-gradient sum timed apart; d. psa "full", "defer:3"
             and "int8_ef" in the same turns, model-axis bytes per step
             exactly ``psa_sync_wire_bytes``; e. the DP x TP ring (int8_ef,
             ZeRO-1) at 2x2, B=16 per row, M=1 and 2: data-axis ring bytes
             exact, data replicas bitwise, K7 bypassed, a save at step 2
             resumed bitwise to 4 steps; f. ``train_llm_tp`` at vocab 259,
             20 steps, ``model=2, psa="int8_ef", steps_per_dispatch=2`` and
             ``data=2, model=2, overlap_microbatches=2, wire="int8_ef"``
             under zero1: losses finite and falling, the manifest's model
             axis, no retrace.
17. sp/ep — sequence and expert parallelism, four ranks on the card over
             gloo (``programs.phase17``): a. the fp32 SP forward and step
             (one SGD step at lr 1024) of the canonical model at B=2,
             T=1024 at ring 2, ring 4 and data=2 x seq=2 (B=4) against a
             world of one (plain attention): logits within 1e-4, loss
             within 1e-5, every gradient leaf within 1e-4 of its largest
             entry, every rank's parameters bitwise the same; b. the bf16
             SP step at ring 4 timed in turns with the world of one (plain
             and flash attention), one ring hop of K and V, the
             ``ring_kv_hop`` bytes per step exactly 14,155,776, each rank's
             peak allocated bytes over one step at T=4096, ring 4, 2 and 1
             (the ``sp_bench`` twin at full width), falling with the ring;
             c. the fp32 MoE (8 experts, top-2, capacity factor 1.25) at
             B=8 per data row x 256, expert 2, expert 4 and data=2 x
             expert=2 against the unsharded model: ``ep_forward``'s logits
             and aux, one step's loss and every gradient leaf (the bars of
             a), the routing's digest equal on every rank of a row, the
             dropped share of token slots; d. the bf16 EP step at expert 2
             (``optimizer="pallas"``) timed in turns with the unsharded
             step: launches 6/6/6/1 per rank per step, one combine sum and
             the replicated-gradient sum (20,440,224 fp32) timed apart;
             e. the ``longctx_bench`` twin at T=4096 (B=4), flash and
             plain, each point in this process (``longctx_bench.measure``):
             tok/s and ms per step; K2, K5 and K6 at B=2, T=4096 against their
             plain versions (phase 3's limits), timed beside SDPA and
             their bounds.
18. elastic — elastic data parallelism on a pool of four ranks on the
             card over gloo (``programs.phase18``) at the canonical width
             (vocab 259), bf16, flash dh-major, the pallas optimizer, B=8
             x 256 per rank, 6 steps a run: a. with no fault the elastic
             losses are bitwise the non-elastic run's (gradient at K=1,
             ZeRO-1 at K=2); b. ``device_loss@2,device_return@5`` walks 4
             -> 3 -> 4 on the mirror path, the post-grow losses bitwise a
             fresh 4-rank run restored from the grow point, ``returned ==
             lost``; c. an ``Autoscaler`` on a TTFT series resizes 4 -> 2
             -> 4 through ``scale_hook`` with nothing replayed; d. b's walk
             under the int8_ef ring, M=2, ZeRO-1. Each re-mesh prints its
             seconds split into drain, rebuild, restore, persist and
             replay (its span tree) and the mirror's bytes; every rank's
             launches per step in every world are held at 6/6/6/1, and at
             12/12/12/0 on d's ring (6·M flash launches; Adam 0 under
             ZeRO-1).
19. pp elastic — the DP×PP ring drivers, elastic PP and TP on a pool of
             four ranks (``programs.phase19``): a. at the canonical width,
             data 2 × stage 2 (3 layers per stage, GPipe, 2 pipeline
             microbatches), fp32 B=4 per row, SGD: every wire × aggregation
             × M against the plain DP×PP step (fp32 within 1e-5 / 1e-4,
             bf16 and int8_ef within 1e-3 / 2e-3), data rows bitwise; each
             stage's ring and gather bytes exactly K·M·(n−1)·chunk, the
             int8_ef ZeRO-1 data-axis wire at most 0.27 of the plain
             step's; K=2 and a checkpoint resume bitwise; the bf16 cells
             (B=16 per row, the pallas optimizer) timed in turns with the
             plain step, launches per stage per step; one fp32 ring hop
             split into its copies and gloo. b. ``train_llm_pp`` at vocab
             259, bf16, 6 steps a run: no fault bitwise non-elastic (plain
             and the int8_ef ZeRO-1 ring at M=2); 1×3 -> 1×2 (a stage
             re-partition), 1×3 -> 1×2 -> 1×3, 2×2 -> 1×2 on the ring, each
             bitwise a fresh run from its recovery point, every new world's
             state held against its mirror, launches per world, each
             re-mesh's seconds by part. c. ``train_llm_tp`` at
             ``psa="int8_ef"``: 2×2 -> 1×2 bitwise a fresh 1×2 run; a
             model-axis loss on 1×2 raises ``ReplicaLossError``.
20. pp x tp — DP×PP×TP: the pipeline over a (data, stage, model) grid
             of ranks, Megatron TP inside each stage, at the canonical
             width (3 layers per stage, 3 heads per model shard, GPipe, 2
             pipeline microbatches): a. four ranks on 1 × 2 × 2
             (``programs.phase20_four``): GPipe and 1F1B in fp32 at B=4
             (SGD) against the world of one, loss within 1e-5 and every
             gradient leaf within 1e-4 of its largest entry; at bf16, B=16,
             the pallas optimizer, timed in turns with the plain DP×PP
             step at 1 × 2 and with TP at 1 × 2, launches per rank per step
             (6/6/6/1 each), one activation sum over the model group. b.
             eight ranks on 2 × 2 × 2 (``programs.phase20_eight``): the
             fp32 gradient ring within 1e-5 / 1e-4 of the plain step; the
             int8_ef ZeRO-1 ring at M=1: data rows and model replicas
             bitwise, ring and gather bytes exactly K·M·(n−1)·chunk per
             (stage, model) cell, a K=2 window bitwise two steps; both
             rings at bf16 timed in turns with the plain step, K7 per cell
             as its ZeRO-1 slice's gate says; ``train_llm_pp(mesh={"data":
             2, "stage": 2, "model": 2})`` at vocab 259, 3 steps, bitwise
             the step driver's losses. c. ``bench_utils.time_decode``:
             greedy ``generate`` tokens/s at B=1 and B=64, fp32 and bf16
             weights.

Each phase's seconds print on a line of their own (``phase N: X s``) and
ride in the record as ``phase_seconds``. The line before the last is the
kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero without printing a
result when no CUDA device is available or the package is missing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import torch

# Peak rates of one H100 SXM (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
# fp32 attention runs on the tensor cores in 3xTF32 (three TF32 products per
# fp32-accurate one), so its least time is at a third of the TF32 rate; the
# rate of fp32 FMAs outside the tensor cores is printed beside it.
PEAK_FLOPS = {torch.float32: 495e12 / 3,   # 3xTF32 on the tensor cores
              torch.bfloat16: 989e12}      # bf16 tensor cores
FP32_FMA_FLOPS = 67e12

TOL_OUT = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# The fp32 FMA forward kernel that the 3xTF32 one replaced (last built at
# commit d11b9b5), in us per call, by (B, T, H, Dh, dh-major, causal), as
# PERF.md records it (an NVIDIA H100 80GB HBM3 at 700 W). Printed beside the
# kernel's time as that figure, and kept out of the kernels line: no run can
# measure a kernel that is no longer built (flash_ab --baseline times both).
FMA_FWD_US = {(8, 256, 6, 48, False, True): 37.1,
              (8, 256, 6, 48, True, True): 39.5,
              (3, 256, 6, 48, True, True): 34.0}
TOL_LSE = 1e-4
TOL_LOGITS = 1e-3
NEAR_TIE = 1e-4
# Backward kernels vs their plain version: fp32 absolute; bf16 relative to
# the largest reference gradient (one output rounding, 2^-8 relative).
TOL_BWD = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
TOL_ADAM = 1e-6           # p, m, v: the same operations in the same order
TOL_TRAIN_LOSS = 1e-4     # kernel path vs plain path, one step, fp32
TOL_TRAIN_GRAD = 1e-4     # ... every gradient leaf, relative to its max
TOL_TRAJECTORY = 1e-3     # ... 5-step loss trajectory
# The same at bf16 compute: both paths round every product and activation
# to bf16 (2^-8 relative), at places that differ (the kernels round P and
# dS before their products, the plain path P and dP), through 6 layers:
# the limits the port holds two bf16 paths to (tests/test_torch_train.py).
TOL_TRAIN_LOSS_BF16 = 2e-2
TOL_TRAIN_GRAD_BF16 = 1e-1
# Phase 8 (FL). FedAvg starts from the port's init drawn with a CPU
# generator seeded FL_INIT_SEED (its L1 norm in float64 is FL_INIT_L1, so
# a change of the draw shows). The bar for its final accuracy: the JAX
# package's FedAvg on the CPU at the same configuration, data and initial
# parameters (``fl_reference_bar.py``; PERF.md), less 0.03: the two draw
# clients and dropout from different generators. FL_JAX_OWN_INIT_ACC is
# the JAX package's from its own init (``python examples/hfl.py --algo
# fedavg --rounds 10``), printed beside it: the final accuracy depends on
# the init by more than the margin.
FL_INIT_SEED = 0
FL_INIT_L1 = 6796.943127758335
FL_JAX_FEDAVG_ACC = 0.7335
FL_JAX_OWN_INIT_ACC = 0.8134
FL_ACC_MARGIN = 0.03
TOL_FL_DEVICE = 1e-4          # card vs CPU, every leaf, of its largest entry
TOL_FL_SGD = dict(rtol=2e-4, atol=1e-6)   # FedSGD gradient vs weight upload
TOL_FL_SGD_ACC = 2e-4
# Phase 9 (tabular, VFL, DP-FedAvg, secure aggregation). Bars: the JAX
# package's trainers on the CPU from the port's initial parameters for the
# same seeds (``fl_reference_bar.py --tabular``; PERF.md), less 0.03 for an
# accuracy, and never below one test row above the majority class (9.3% of
# the labels are positive, so predicting the majority scores 0.907); within
# 10% for a final VAE loss, and within 10% plus 0.01 nats for a final
# classifier loss, which ends near 0 (a majority predictor's is the label
# entropy, ~0.3): the packages draw dropout and the VAE noise from
# different generators. TAB_INIT_L1 is the float64 L1 norm
# of the port's seed-0 inits at these shapes (classifier, VFL, VFL-VAE,
# VAE), so a change of the draw shows.
TAB_INIT_L1 = 5274.557427991182
TAB_JAX = {"classifier_best_accuracy": 0.9317073225975037,
           "classifier_final_loss": 3.8657913137285504e-06,
           "evaluator_final_losses": [3.8657913137285504e-06,
                                      1.055717007147905e-06],
           "vfl_default": 0.9512194991111755,
           "vfl_vae_final_total": 0.7075749039649963,
           "vae_final_total": 308.9256591796875,
           "synthetic_real": 0.9317073225975037,
           "synthetic_synthetic": 0.9219512343406677}
TAB_ACC_MARGIN = 0.03
TAB_LOSS_REL = 0.10
TAB_CE_ABS = 0.01
TOL_VFL_DEVICE = 1e-5         # card vs CPU: VFL logits and gradients, VFL-VAE terms
TOL_DP_DEVICE = 1e-4          # card vs CPU, one DP-FedAvg round, every leaf
TOL_NOISE_STD = 0.01          # z = 1 round: empirical std vs σ, relative
VFL_FAITHFUL_EPOCHS = 25      # the faithful-mode VFL run (a falling loss)
# Phase 10 (two ranks against a world of one, fp32): the loss and every
# averaged gradient leaf (of its largest entry) to the limits the CPU tests
# hold the port's ranks to; the trajectories as phase 6's; a resumed run
# against an uninterrupted one (bitwise expected: no port kernel uses
# atomics).
TOL_DP_LOSS = 1e-5
TOL_DP_GRAD = 1e-5
TOL_RESUME = 1e-6
# What each port kernel runs on (each flash kernel by input type).
DESIGN = {
    "flash_fwd": {
        "bfloat16": "tensor cores: mma.sync m16n8k16 bf16 -> fp32, ldmatrix "
                    "(.trans by layout), cp.async double-buffered K/V tiles, "
                    "4 warps x 16 query rows, P rounded to bf16 in registers "
                    "(csrc/mma_bf16.cuh)",
        "float32": "tensor cores in 3xTF32: mma.sync m16n8k8 tf32 -> fp32, "
                   "hi.hi + hi.lo + lo.hi per product in three passes, "
                   "cp.async double-buffered K/V tiles in padded fp32 "
                   "layouts, 4 warps x 16 query rows, Q fragments split and "
                   "held in registers, P in fp32 registers as the A operand "
                   "through permuted score columns, online softmax per 32 "
                   "keys, each step's P.V in fresh accumulators, O rescaled "
                   "and the step's P.V added in rounded fp32, ex2.approx, "
                   "one CTA per SM as the launch bound (csrc/mma_tf32.cuh)"},
    "flash_bwd_dq": {
        "bfloat16": "tensor cores: mma.sync m16n8k16 bf16 -> fp32, ldmatrix "
                    "(.trans by layout), cp.async double-buffered K/V tiles "
                    "in separate copy groups, 4 warps x 16 query rows, Q and "
                    "dO fragments and dQ in registers, dS rounded to bf16 in "
                    "registers (csrc/mma_bf16.cuh)",
        "float32": "tensor cores in 3xTF32: mma.sync m16n8k8 tf32 -> fp32, "
                   "hi.hi + hi.lo + lo.hi per product in three passes, "
                   "cp.async double-buffered K/V tiles in padded fp32 "
                   "layouts, 16 query rows per warp, Q and dO fragments in "
                   "registers, dS in fp32 registers as the A operand "
                   "through permuted score columns, per-step sums added in "
                   "fp32 in shared memory, ex2.approx (csrc/mma_tf32.cuh)"},
    "flash_bwd_dkv": {
        "bfloat16": "tensor cores: mma.sync m16n8k16 bf16 -> fp32, ldmatrix "
                    "(.trans by layout), cp.async double-buffered Q/dO tiles, "
                    "4 warps x 16 keys, K and V fragments and dK, dV in "
                    "registers, P and dS rounded to bf16 in registers "
                    "(csrc/mma_bf16.cuh)",
        "float32": "tensor cores in 3xTF32: mma.sync m16n8k8 tf32 -> fp32, "
                   "hi.hi + hi.lo + lo.hi per product in three passes, "
                   "cp.async double-buffered Q/dO tiles in padded fp32 "
                   "layouts, 16 keys per warp, K and V fragments in "
                   "registers, P and dS in fp32 registers as A operands "
                   "through permuted score columns, per-step sums added in "
                   "fp32 in shared memory, ex2.approx (csrc/mma_tf32.cuh)"},
    "adam": "one launch over a __grid_constant__ table of up to 48 leaves, "
            "a persistent grid (occupancy x SMs) striding over 1024-element "
            "chunks; a producer thread moves p, m, v, g with cp.async.bulk "
            "into 4 shared-memory stages on mbarriers, 256 consumer threads "
            "run the rule, bulk stores back, L2 evict_first",
}
PTXAS_TYPES = {"f": "float", "13__nv_bfloat16": "bf16"}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def wall_us(fn, reps: int = 20) -> float:
    """Median host wall time of one call ending in a synchronize, in
    microseconds: what a caller waits, host dispatch included."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e6)
    return statistics.median(times)


def attention_bound_us(b, t, h, dh, dtype, causal=True, peak=None) -> tuple:
    """Least time for attention forward over [B, T, H, Dh]: q, k, v read
    once, out written once (input dtype), lse written once (fp32); 4·Dh
    operations per visible (query, key) pair (two multiply-adds), at
    ``peak`` FLOP/s (default PEAK_FLOPS of the type)."""
    item = torch.empty((), dtype=dtype).element_size()
    nbytes = 4 * b * t * h * dh * item + b * h * t * 4
    flops = 4 * dh * b * h * (t * (t + 1) // 2 if causal else t * t)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e6
    t_ops = flops / (peak or PEAK_FLOPS[dtype]) * 1e6
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def attention_bwd_bound_us(b, t, h, dh, dtype, causal, which,
                           peak=None) -> tuple:
    """Least time for the backward kernel ``which`` ("dq" or "dkv"): q, k,
    v, dO read once, lse and delta read once (fp32), the gradients written
    once (input dtype); 6·Dh (dQ) or 8·Dh (dK/dV) operations per visible
    (query, key) pair, at ``peak`` FLOP/s (default PEAK_FLOPS of the
    type)."""
    item = torch.empty((), dtype=dtype).element_size()
    n = b * t * h * dh
    pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
    n_out = 1 if which == "dq" else 2
    nbytes = (4 + n_out) * n * item + 2 * b * h * t * 4
    flops = (6 if which == "dq" else 8) * dh * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e6
    t_ops = flops / (peak or PEAK_FLOPS[dtype]) * 1e6
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def tf32_hmma_counts(ext) -> dict:
    """TF32 HMMA instructions per fp32 kernel ``kernel<head dim, layout>``
    in the built flash_fwd and flash_bwd libraries, from ``cuobjdump
    -sass``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = []   # both disassemblies at once, each into its own file
        for lib in ("flash_fwd", "flash_bwd"):
            out = open(os.path.join(tmp, lib), "w+")
            procs.append((lib, out, subprocess.Popen(
                [tool, "-sass", str(ext.library_path(lib))], stdout=out,
                text=True)))
        failed = [lib for lib, _, proc in procs if proc.wait() != 0]
        check(not failed, f"cuobjdump -sass failed on {failed}")
        for lib, out, proc in procs:
            out.seek(0)
            fn = None
            for line in out:
                if "Function :" in line:
                    m = re.search(r"((?:[a-z_]|tf32)+_tf32_kernel)ILi(\d+)"
                                  r"ELi(\d+)E", line)
                    fn = (f"{m.group(1)}<{m.group(2)}, {m.group(3)}>" if m
                          else None)
                    if fn:
                        counts[fn] = 0
                elif fn and "HMMA" in line and "TF32" in line:
                    counts[fn] += 1
            out.close()
    return counts


def fl_phase(dev: torch.device, card: str) -> tuple:
    """Phase 8: horizontal FL on the card at homework 1's defaults. Raises
    on a failed check; returns the numbers for the JSON record and the
    MNIST arrays ``(x, y, xt, yt)`` for phase 9."""

    from ddl25spring_tpu_torch import fl, profile_step, rng
    from ddl25spring_tpu_torch.config import FLConfig
    from ddl25spring_tpu_torch.device import fp32_products
    from ddl25spring_tpu_torch.data import mnist
    from ddl25spring_tpu_torch.fl import attacks, defenses
    from ddl25spring_tpu_torch.metrics import backdoor_metrics
    from ddl25spring_tpu_torch.models import mnist_cnn
    from ddl25spring_tpu_torch.tree import tree_leaves

    cfg = FLConfig()
    t0 = time.perf_counter()
    x_raw, y, xt_raw, yt = mnist.synthetic_mnist(60000, 10000, seed=0)
    x, xt = mnist.normalize(x_raw), mnist.normalize(xt_raw)

    def federate(iid):
        return fl.federate(x, y, mnist.split(y, cfg.nr_clients, iid=iid,
                                             seed=cfg.seed), device=dev)

    iid = federate(True)
    data_s = time.perf_counter() - t0
    params = mnist_cnn.init(torch.Generator().manual_seed(FL_INIT_SEED),
                            device=dev)
    l1 = sum(float(p.cpu().double().abs().sum()) for p in tree_leaves(params))
    check(abs(l1 - FL_INIT_L1) <= 1e-6, f"the FL init's L1 norm {l1!r} is "
          f"not {FL_INIT_L1!r}: not the draw the accuracy bar was run from")
    check(iid.x.device.type == "cuda" and all(
        p.device.type == "cuda" for p in tree_leaves(params)),
        "FL data or parameters are not on the card")
    out = {"config": {"nr_clients": cfg.nr_clients,
                      "client_fraction": cfg.client_fraction,
                      "batch_size": cfg.batch_size, "epochs": cfg.epochs,
                      "lr": cfg.lr, "seed": cfg.seed, "n_train": 60000,
                      "n_test": 10000},
           "data_s": data_s}

    def on_card(server):
        check(server.device.type == "cuda" and all(
            p.device.type == "cuda" for p in tree_leaves(server.params)),
            f"{type(server).__name__} left the card")
        return server

    # 8.1 the card against the CPU: one FedAvg round, fixed clients,
    # dropout off (an apply_fn without dropout masks).
    def no_dropout(p, xb):
        return mnist_cnn.apply(p, xb)

    fixed = rng.sample_clients(cfg.seed, 0, cfg.nr_clients,
                               cfg.clients_per_round).numpy()
    runs = {}
    for where, data in (("cuda", iid), ("cpu", iid.to("cpu"))):
        server = fl.FedAvgServer(params, no_dropout, data, xt, yt, cfg,
                                 device=dev if where == "cuda" else "cpu")
        server._sample = lambda r: fixed
        t0 = time.perf_counter()
        server.run(1)
        runs[where] = (server, time.perf_counter() - t0)
    on_card(runs["cuda"][0])
    dev_err = max(((a.cpu() - b).abs().max() / b.abs().max()).item()
                  for a, b in zip(tree_leaves(runs["cuda"][0].params),
                                  tree_leaves(runs["cpu"][0].params)))
    check(math.isfinite(dev_err) and dev_err <= TOL_FL_DEVICE,
          f"FedAvg round card vs CPU max|d|/max|ref|={dev_err:.3g} > "
          f"{TOL_FL_DEVICE}")
    accs = [runs[w][0].result.test_accuracy[0] for w in ("cuda", "cpu")]
    out["card_vs_cpu"] = {"max_rel_err": dev_err, "accuracy_card": accs[0],
                          "accuracy_cpu": accs[1],
                          "wall_s_card": runs["cuda"][1],
                          "wall_s_cpu": runs["cpu"][1]}
    print(f"fl card vs CPU: one FedAvg round (clients {fixed.tolist()}, "
          f"dropout off) max|d|/max|ref| {dev_err:.3g} over the leaves; "
          f"accuracy {accs[0]:.4f} card / {accs[1]:.4f} CPU {card}")
    del runs

    # 8.2 FedSGD, gradient upload against weight upload (dropout live).
    sgd = [on_card(cls(params, mnist_cnn.apply, iid, xt, yt, cfg,
                       device=dev)) for cls in (fl.FedSgdGradientServer,
                                                fl.FedSgdWeightServer)]
    res = [s.run(2) for s in sgd]
    for a, b in zip(tree_leaves(sgd[0].params), tree_leaves(sgd[1].params)):
        bad = (a - b).abs() > TOL_FL_SGD["atol"] + TOL_FL_SGD["rtol"] * \
            b.abs()
        check(not bool(bad.any()), f"FedSGD gradient vs weight upload: "
              f"{int(bad.sum())} entries of a {tuple(a.shape)} leaf apart")
    acc_gap = abs(res[0].test_accuracy[-1] - res[1].test_accuracy[-1])
    check(acc_gap < TOL_FL_SGD_ACC, f"FedSGD gradient vs weight accuracy "
          f"|d|={acc_gap:.3g} >= {TOL_FL_SGD_ACC}")
    out["fedsgd"] = {"accuracy_gradient": res[0].test_accuracy,
                     "accuracy_weight": res[1].test_accuracy,
                     "wall_s_gradient": res[0].wall_time,
                     "wall_s_weight": res[1].wall_time}
    print(f"fl FedSGD gradient vs weight upload, 2 rounds: parameters within "
          f"rtol 2e-4 atol 1e-6, accuracy {res[0].test_accuracy} vs "
          f"{res[1].test_accuracy} {card}")
    del sgd

    # 8.3 / 8.4 FedAvg for 10 rounds with dropout live, IID and non-IID.
    samples = cfg.clients_per_round * int(iid.sample_counts[0]) * cfg.epochs
    for name, data in (("iid", iid), ("non_iid", federate(False))):
        server = on_card(fl.FedAvgServer(params, mnist_cnn.apply, data, xt,
                                         yt, cfg, device=dev))
        before = server.test()
        r = server.run(cfg.rounds)
        steady = statistics.median(r.wall_time[1:])
        out[f"fedavg_{name}"] = {
            "accuracy_before": before, "accuracy": r.test_accuracy,
            "wall_ms": [t * 1e3 for t in r.wall_time],
            "wall_ms_median_after_first": steady * 1e3,
            "client_samples_per_round": samples,
            "client_samples_per_s": samples / steady,
            "message_count": r.message_count}
        print(f"fl FedAvg {name}, 10 rounds: accuracy "
              f"{[round(a, 4) for a in r.test_accuracy]} (untrained "
              f"{before:.4f}); wall ms per round "
              f"{[round(t * 1e3, 1) for t in r.wall_time]}, median after the "
              f"first {steady * 1e3:.1f} ms, {samples / steady:.0f} client "
              f"samples/s {card}")
        final = r.test_accuracy[-1]
        check(math.isfinite(final), f"FedAvg {name} final accuracy {final}")
        if name == "non_iid":
            check(final > before, f"FedAvg non-IID final accuracy "
                  f"{final:.4f} not above the untrained {before:.4f}")
        else:
            bar = FL_JAX_FEDAVG_ACC - FL_ACC_MARGIN
            print(f"fl FedAvg iid final accuracy {final:.4f}; bar {bar:.4f}: "
                  f"the JAX package's on the CPU from the same init "
                  f"{FL_JAX_FEDAVG_ACC} less {FL_ACC_MARGIN} (from its own "
                  f"init it reaches {FL_JAX_OWN_INIT_ACC}) {card}")
            check(final >= bar, f"FedAvg IID final accuracy {final:.4f} < "
                  f"{bar:.4f} (the JAX package's on the CPU from the same "
                  f"init less {FL_ACC_MARGIN})")
            # Device time of a round: 3 more rounds under the profiler
            # (the test evaluation left out, as in the wall time above).
            later = iter(range(cfg.rounds, cfg.rounds + 3))

            def one_round():
                with torch.no_grad(), fp32_products():
                    server.params = server._round(server.params, next(later))

            prof = profile_step.trace(one_round, 3)
            out["fedavg_iid"]["profile"] = prof
            print(f"fl FedAvg iid round under the profiler: kernels "
                  f"{prof['kernel_ms_per_step']:.2f} ms per round "
                  f"({prof['kernels_per_step']:.0f} launches), profiled wall "
                  f"{prof['profiled_wall_ms_per_step']:.1f} ms, busy share "
                  f"{prof['profiled_busy_share']:.3f}; by category "
                  f"{json.dumps(prof['ms_per_step_by_category'])} {card}")
        del server, data

    # 8.5 attacks and defenses on the Δ-upload server, 5 rounds.
    mask = attacks.injection_mask(cfg.nr_clients, 0.2, cfg.seed)
    reversion = attacks.GradientReversion(scale=5.0)
    runs = {}
    for name, kw in (
            ("reversion_undefended", {"adversary": (mask, reversion)}),
            ("reversion_median", {"adversary": (mask, reversion),
                                  "defense": defenses.coordinate_defense(
                                      defenses.coordinate_median)}),
            ("reversion_krum", {"adversary": (mask, reversion),
                                "defense": defenses.selection_defense(
                                    defenses.krum, n_malicious=2)})):
        server = on_card(fl.FedAvgGradServer(params, mnist_cnn.apply, iid,
                                             xt, yt, cfg, device=dev, **kw))
        r = server.run(5)
        runs[name] = {"accuracy": r.test_accuracy,
                      "wall_ms": [t * 1e3 for t in r.wall_time],
                      "attackers_sampled": [int(mask[server._sample(i)].sum())
                                            for i in range(5)]}
        check(all(math.isfinite(a) for a in r.test_accuracy),
              f"{name}: accuracy {r.test_accuracy}")
    acc = {k: v["accuracy"][-1] for k, v in runs.items()}
    check(acc["reversion_median"] > acc["reversion_undefended"],
          f"the coordinate median ({acc['reversion_median']:.4f}) does not "
          f"beat the undefended server ({acc['reversion_undefended']:.4f}) "
          f"under gradient reversion")
    backdoor = attacks.PatternBackdoor(proportion=0.5, backdoor_label=0,
                                       scale=2.0)
    server = on_card(fl.FedAvgGradServer(params, mnist_cnn.apply, iid, xt,
                                         yt, cfg, device=dev,
                                         adversary=(mask, backdoor)))
    r = server.run(5)
    with torch.no_grad():
        clean = server.apply_fn(server.params, server.test_x).argmax(-1)
        trig = server.apply_fn(server.params, backdoor.trigger_test_set(
            server.test_x)).argmax(-1)
    clean_acc, asr = backdoor_metrics(clean, yt, trig, 0)
    check(0.0 <= asr <= 1.0 and math.isfinite(clean_acc),
          f"backdoor metrics {clean_acc}, {asr}")
    runs["backdoor"] = {"accuracy": r.test_accuracy, "clean_accuracy":
                        clean_acc, "attack_success_rate": asr,
                        "wall_ms": [t * 1e3 for t in r.wall_time]}
    out["attacks"] = runs
    print(f"fl FedAvgGradServer 5 rounds, 20% gradient reversion (x5): "
          f"final accuracy undefended {acc['reversion_undefended']:.4f}, "
          f"coordinate median {acc['reversion_median']:.4f}, Krum "
          f"{acc['reversion_krum']:.4f}; attackers sampled per round "
          f"{runs['reversion_undefended']['attackers_sampled']}; pattern "
          f"backdoor clean accuracy {clean_acc:.4f}, attack success rate "
          f"{asr:.4f} {card}")
    return out, (x, y, xt, yt)


def tabular_phase(dev: torch.device, card: str) -> dict:
    """Phase 9, first half: the tabular classifier, VFL, the VFL-VAE, the
    VAE and the synthetic-data protocol on the card. Raises on a failed
    check; returns the numbers for the JSON record."""

    import numpy as np

    from ddl25spring_tpu_torch import profile_step, rng
    from ddl25spring_tpu_torch.config import VAEConfig, VFLConfig
    from ddl25spring_tpu_torch.data import tabular
    from ddl25spring_tpu_torch.models import tabular as tab_model
    from ddl25spring_tpu_torch.models import vae, vfl_nets
    from ddl25spring_tpu_torch.ops.losses import cross_entropy_loss
    from ddl25spring_tpu_torch.train import (synthetic_data_eval,
                                             train_classifier, train_vae,
                                             train_vfl, train_vfl_vae)
    from ddl25spring_tpu_torch.tree import tree_leaves, tree_map

    X, y = tabular.load_heart()
    feats, names = tabular.preprocess(X)
    xtr, ytr, xte, yte = tabular.train_test_split(feats, y, seed=0)
    parts = tabular.split_features_evenly(names, 4)
    split = lambda a: [np.ascontiguousarray(a[:, q]) for q in parts]
    dims = [len(q) for q in parts]
    majority = float(max(yte.mean(), 1 - yte.mean()))
    maj = f"(majority class {majority:.4f})"
    vcfg, acfg = VFLConfig(), VAEConfig(input_dim=feats.shape[1])
    out = {"rows": [len(ytr), len(yte)], "features": feats.shape[1],
           "parties": [len(q) for q in parts],
           "positive_rate": float(y.mean()), "majority_test_rate": majority}

    inits = [tab_model.init(rng.generator(0), feats.shape[1], device="cpu"),
             vfl_nets.init_vfl(rng.generator(0), dims, device="cpu"),
             {k: v for k, v in vfl_nets.init_vfl_vae(
                 rng.generator(0), dims, device="cpu").items()
              if k != "client_latent"},
             list(vae.init(rng.generator(0), acfg, device="cpu"))]
    l1 = sum(float(t.double().abs().sum()) for t in tree_leaves(inits))
    check(abs(l1 - TAB_INIT_L1) <= 1e-6, f"the tabular inits' L1 norm {l1!r} "
          f"is not {TAB_INIT_L1!r}: not the draw the bars were run from")

    # 9.1 VFL forward and gradients, card against CPU, same parameters.
    got = {}
    for where in ("cpu", dev):
        params = tree_map(lambda t: t.to(where).requires_grad_(), inits[1])
        xs = [torch.as_tensor(a, device=where) for a in split(xtr)]
        logits = vfl_nets.vfl_forward(params, xs)
        loss = cross_entropy_loss(logits, torch.as_tensor(ytr, device=where))
        got[str(where)] = [logits.detach().cpu()] + [
            g.cpu() for g in torch.autograd.grad(loss, tree_leaves(params))]
    vfl_err = max(((a - b).abs().max() / b.abs().max()).item()
                  for a, b in zip(got[str(dev)], got["cpu"]))
    check(math.isfinite(vfl_err) and vfl_err <= TOL_VFL_DEVICE,
          f"VFL logits and gradients card vs CPU max|d|/max|ref|="
          f"{vfl_err:.3g} > {TOL_VFL_DEVICE}")
    out["vfl_card_vs_cpu"] = vfl_err
    print(f"tabular VFL forward + gradients, 4 parties {dims}, 820 rows: "
          f"card vs CPU max|d|/max|ref| {vfl_err:.3g} over the logits and "
          f"{len(got['cpu']) - 1} gradient leaves {card}")

    # VFL-VAE reconstruction and KL terms, card against CPU, same
    # parameters and a fixed reparameterization noise.
    eps = torch.randn(len(ytr), 8, generator=rng.generator(7))
    terms = {}
    for where in ("cpu", dev):
        params = tree_map(lambda t: t.to(where), inits[2])
        xs = [torch.as_tensor(a, device=where) for a in split(xtr)]
        recons, mu, logvar = vfl_nets.vfl_vae_forward(
            {**params, "client_latent": 4}, xs, eps=eps.to(where))
        terms[str(where)] = [float(t) for t in vfl_nets.vfl_vae_loss(
            recons, xs, mu, logvar)[1:]]
    vae_err = max(abs(a - b) / abs(b) for a, b in zip(terms[str(dev)],
                                                       terms["cpu"]))
    check(math.isfinite(vae_err) and vae_err <= TOL_VFL_DEVICE,
          f"VFL-VAE recon and KL card vs CPU max rel {vae_err:.3g} > "
          f"{TOL_VFL_DEVICE}")
    out["vfl_vae_card_vs_cpu"] = vae_err
    print(f"tabular VFL-VAE recon {terms['cpu'][0]:.6f} and KL "
          f"{terms['cpu'][1]:.6f} (fixed eps): card vs CPU max rel "
          f"{vae_err:.3g} {card}")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    def falls(losses, what):
        check(all(math.isfinite(v) for v in losses) and
              losses[-1] < losses[0], f"{what}: loss {losses[0]} -> "
              f"{losses[-1]} does not fall")

    n_test = len(yte)
    majority_rows = round(majority * n_test)

    def at_least(value, key, what):
        """Counted in test rows: at least the JAX value less the margin,
        and more rows than the majority class."""
        rows = max(math.ceil((TAB_JAX[key] - TAB_ACC_MARGIN) * n_test - 1e-6),
                   majority_rows + 1)
        bar = rows / n_test
        check(round(value * n_test) >= rows, f"{what} {value:.4f} < "
              f"{bar:.4f} (the JAX package's {TAB_JAX[key]:.4f} less "
              f"{TAB_ACC_MARGIN}, and above the majority {majority:.4f})")
        return bar

    # Cross-entropy of a predictor of the training labels' class rates.
    p1 = float(ytr.mean())
    collapsed = -(p1 * math.log(p1) + (1 - p1) * math.log(1 - p1))

    def near_ce(value, ref, what):
        check(abs(value - ref) <= TAB_LOSS_REL * abs(ref) + TAB_CE_ABS,
              f"{what} final loss {value:.6f} not within {TAB_LOSS_REL:.0%} "
              f"+ {TAB_CE_ABS} of the JAX package's {ref:.6f} (a majority "
              f"predictor's {collapsed:.4f})")

    def near(value, key, what):
        ref = TAB_JAX[key]
        check(abs(value - ref) <= TAB_LOSS_REL * abs(ref), f"{what} "
              f"{value:.4f} not within {TAB_LOSS_REL:.0%} of the JAX "
              f"package's {ref:.4f}")

    # 9.2 the centralized classifier at its defaults.
    (_, rep), wall = timed(lambda: train_classifier(xtr, ytr, xte, yte,
                                                    device=dev))
    falls(rep.train_losses, "train_classifier")
    near_ce(rep.train_losses[-1], TAB_JAX["classifier_final_loss"],
            "train_classifier")
    bar = at_least(rep.best_accuracy, "classifier_best_accuracy",
                   "train_classifier best accuracy")
    out["classifier"] = {"best_accuracy": rep.best_accuracy,
                         "best_epoch": rep.best_epoch,
                         "losses_first_last": [rep.train_losses[0],
                                               rep.train_losses[-1]],
                         "wall_ms_per_epoch": wall / 200 * 1e3}
    print(f"tabular train_classifier 200 epochs: loss "
          f"{rep.train_losses[0]:.4f} -> {rep.train_losses[-1]:.6f} (JAX "
          f"{TAB_JAX['classifier_final_loss']:.6f}, majority predictor "
          f"{collapsed:.4f}), best "
          f"accuracy {rep.best_accuracy:.4f} at epoch {rep.best_epoch} "
          f"{maj}, bar {bar:.4f}; {wall / 200 * 1e3:.2f} ms per epoch "
          f"(13 minibatches) {card}")

    # 9.3 VFL at VFLConfig(), both modes; 2 epochs in the middle of the
    # default run (26 minibatch steps) under the profiler. The faithful
    # mode, held only to a falling loss, runs VFL_FAITHFUL_EPOCHS of them
    # (the script's time limit).
    window = profile_step.Window(vcfg.epochs // 2, 2)
    for faithful in (False, True):
        name = "vfl_faithful" if faithful else "vfl_default"
        log = {} if faithful else dict(log_every=1, log_fn=window.tick)
        run_cfg = (dataclasses.replace(vcfg, epochs=VFL_FAITHFUL_EPOCHS)
                   if faithful else vcfg)
        (_, rep), wall = timed(lambda: train_vfl(
            split(xtr), ytr, split(xte), yte, run_cfg, faithful=faithful,
            device=dev, **log))
        falls(rep.train_losses, f"train_vfl faithful={faithful}")
        line = (f"clean accuracy {rep.test_accuracy_clean:.4f}, reported "
                f"{rep.test_accuracy:.4f} {maj}")
        if not faithful:
            bar = at_least(rep.test_accuracy_clean, "vfl_default",
                           "train_vfl clean test accuracy")
            line += f", bar {bar:.4f}"
        out[name] = {"test_accuracy_clean": rep.test_accuracy_clean,
                     "test_accuracy": rep.test_accuracy,
                     "losses_first_last": [rep.train_losses[0],
                                           rep.train_losses[-1]],
                     "wall_ms_per_epoch": wall / run_cfg.epochs * 1e3}
        print(f"tabular train_vfl faithful={faithful} {run_cfg.epochs} "
              f"epochs: loss {rep.train_losses[0]:.4f} -> "
              f"{rep.train_losses[-1]:.4f}, {line}; "
              f"{wall / run_cfg.epochs * 1e3:.2f} ms per epoch "
              f"(13 minibatches) {card}")

    prof = window.result
    check(prof is not None, "the VFL profiler window did not close")
    # The window's steps are epochs of 13 minibatch steps each.
    out["vfl_profile"] = {**prof, "minibatch_steps": 2 * 13}
    print(f"tabular train_vfl under the profiler (epochs "
          f"{vcfg.epochs // 2 + 1}-{vcfg.epochs // 2 + 2} of the default "
          f"run, 26 minibatch steps): kernels "
          f"{prof['kernel_ms_per_step'] / 13 * 1e3:.1f} us per step "
          f"({prof['kernels_per_step'] / 13:.0f} launches), profiled wall "
          f"{prof['profiled_wall_ms_per_step'] / 13:.2f} ms per step, "
          f"busy share {prof['profiled_busy_share']:.3f}; by category "
          f"{json.dumps(prof['ms_per_step_by_category'])} (ms per epoch) "
          f"{card}")

    # 9.4 the VFL-VAE, 1,000 full-batch epochs, 4 clients x latent 4.
    (_, rep), wall = timed(lambda: train_vfl_vae(split(xtr), vcfg,
                                                 epochs=1000, device=dev))
    falls(rep.total_losses, "train_vfl_vae")
    near(rep.total_losses[-1], "vfl_vae_final_total", "train_vfl_vae final "
         "total")
    out["vfl_vae"] = {"total_first_last": [rep.total_losses[0],
                                           rep.total_losses[-1]],
                      "recon_last": rep.recon_losses[-1],
                      "kl_last": rep.kl_losses[-1],
                      "wall_ms_per_epoch": wall / 1000 * 1e3}
    print(f"tabular train_vfl_vae 1000 epochs: total "
          f"{rep.total_losses[0]:.4f} -> {rep.total_losses[-1]:.4f} (recon "
          f"{rep.recon_losses[-1]:.4f} + kl {rep.kl_losses[-1]:.4f}; JAX "
          f"{TAB_JAX['vfl_vae_final_total']:.4f}); {wall:.2f} s, "
          f"{wall / 1000 * 1e3:.3f} ms per epoch {card}")

    # 9.5 the VAE and the synthetic-data protocol.
    (_, _, rep), wall = timed(lambda: train_vae(xtr, acfg, device=dev))
    falls(rep.total_losses, "train_vae")
    near(rep.total_losses[-1], "vae_final_total", "train_vae final total")
    out["vae"] = {"total_first_last": [rep.total_losses[0],
                                       rep.total_losses[-1]],
                  "wall_ms_per_epoch": wall / acfg.epochs * 1e3}
    print(f"tabular train_vae {acfg.epochs} epochs: total "
          f"{rep.total_losses[0]:.2f} -> {rep.total_losses[-1]:.2f} (JAX "
          f"{TAB_JAX['vae_final_total']:.2f}); "
          f"{wall / acfg.epochs * 1e3:.2f} ms per epoch (12 minibatches) "
          f"{card}")
    res, wall = timed(lambda: synthetic_data_eval(xtr, ytr, xte, yte, acfg,
                                                  evaluator_epochs=200,
                                                  device=dev))
    for r in res.vae_reports:
        falls(r.total_losses, "synthetic_data_eval's per-class VAE")
    ev_losses = [r.train_losses[-1] for r in res.evaluator_reports]
    for value, ref, what in zip(ev_losses, TAB_JAX["evaluator_final_losses"],
                                ("real", "synthetic")):
        near_ce(value, ref, f"synthetic_data_eval {what}-trained evaluator")
    bars = [at_least(res.real_accuracy, "synthetic_real",
                     "synthetic_data_eval real-trained accuracy"),
            at_least(res.synthetic_accuracy, "synthetic_synthetic",
                     "synthetic_data_eval synthetic-trained accuracy")]
    out["synthetic_eval"] = {"real_accuracy": res.real_accuracy,
                             "synthetic_accuracy": res.synthetic_accuracy,
                             "evaluator_final_losses": ev_losses,
                             "wall_s": wall}
    print(f"tabular synthetic_data_eval (2 per-class VAEs, 2 evaluators of "
          f"200 epochs): real {res.real_accuracy:.4f} (bar {bars[0]:.4f}), "
          f"synthetic {res.synthetic_accuracy:.4f} (bar {bars[1]:.4f}) {maj}; "
          f"evaluators' final losses {ev_losses[0]:.6f} / {ev_losses[1]:.6f} "
          f"(JAX {TAB_JAX['evaluator_final_losses'][0]:.6f} / "
          f"{TAB_JAX['evaluator_final_losses'][1]:.6f}, majority predictor "
          f"{collapsed:.4f}); "
          f"{wall:.2f} s {card}")
    return out


def private_fl_phase(dev: torch.device, card: str, mnist_arrays) -> dict:
    """Phase 9, second half: DP-FedAvg and secure aggregation at homework
    1's defaults on phase 8's MNIST. Raises on a failed check; returns the
    numbers for the JSON record."""

    from ddl25spring_tpu_torch import fl, profile_step, rng
    from ddl25spring_tpu_torch.config import FLConfig
    from ddl25spring_tpu_torch.data import mnist
    from ddl25spring_tpu_torch.device import fp32_products
    from ddl25spring_tpu_torch.fl import privacy, secure_agg
    from ddl25spring_tpu_torch.models import mnist_cnn
    from ddl25spring_tpu_torch.tree import tree_leaves

    cfg = FLConfig()
    x, y, xt, yt = mnist_arrays
    data = fl.federate(x, y, mnist.split(y, cfg.nr_clients, iid=True,
                                         seed=cfg.seed), device=dev)
    cpu_data = data.to("cpu")
    params = mnist_cnn.init(torch.Generator().manual_seed(FL_INIT_SEED),
                            device=dev)
    fixed = rng.sample_clients(cfg.seed, 0, cfg.nr_clients,
                               cfg.clients_per_round).numpy()
    m = cfg.clients_per_round

    def no_dropout(p, xb):
        return mnist_cnn.apply(p, xb)

    def pair(cls, **kw):
        """One round of ``cls`` with fixed clients and dropout off, on the
        card and on the CPU."""
        got = {}
        for where, d in (("cuda", data), ("cpu", cpu_data)):
            server = cls(params, no_dropout, d, xt, yt, cfg,
                         device=dev if where == "cuda" else "cpu", **kw)
            server._sample = lambda r: fixed
            with torch.no_grad():
                got[where] = [t.cpu() for t in tree_leaves(
                    server._round(server.params, 0))]
        return got

    out = {}
    # 9.6 DP-FedAvg, clip 1.0: card vs CPU at z = 0.
    got = pair(privacy.DPFedAvgServer, clip_norm=1.0, noise_multiplier=0.0)
    dp_err = max(((a - b).abs().max() / b.abs().max()).item()
                 for a, b in zip(got["cuda"], got["cpu"]))
    check(math.isfinite(dp_err) and dp_err <= TOL_DP_DEVICE,
          f"DP-FedAvg round card vs CPU max|d|/max|ref|={dp_err:.3g} > "
          f"{TOL_DP_DEVICE}")
    # 5 rounds at z = 0 with dropout live.
    dp = privacy.DPFedAvgServer(params, mnist_cnn.apply, data, xt, yt, cfg,
                                clip_norm=1.0, noise_multiplier=0.0,
                                device=dev)
    before = dp.test()
    r = dp.run(5)
    check(all(math.isfinite(a) for a in r.test_accuracy) and
          r.test_accuracy[-1] > before, f"DP-FedAvg z=0 accuracy "
          f"{r.test_accuracy} not above the untrained {before:.4f}")
    # One round at z = 1.0 against the same round at z = 0, same clients.
    noisy = privacy.DPFedAvgServer(dp.params, mnist_cnn.apply, data, xt, yt,
                                   cfg, clip_norm=1.0, noise_multiplier=1.0,
                                   device=dev)
    with torch.no_grad():
        quiet_p = dp._round(dp.params, 5)
        noisy_p = noisy._round(noisy.params, 5)
    noise = torch.cat([(q - n).reshape(-1) for q, n in
                       zip(tree_leaves(quiet_p), tree_leaves(noisy_p))])
    sigma = 1.0 * 1.0 / m
    std = noise.double().std().item()
    check(abs(std - sigma) <= TOL_NOISE_STD * sigma, f"DP-FedAvg z=1 round "
          f"noise std {std:.6g} not within {TOL_NOISE_STD:.0%} of "
          f"sigma {sigma}")
    spend = privacy.privacy_spend(1.0, 5, 0.1)
    out["dp_fedavg"] = {"card_vs_cpu": dp_err, "accuracy_before": before,
                        "accuracy": r.test_accuracy,
                        "wall_ms": [t * 1e3 for t in r.wall_time],
                        "noise_std": std, "sigma": sigma,
                        "noise_coordinates": noise.numel(),
                        "privacy_spend": spend}
    print(f"dp-fedavg clip 1.0: one round card vs CPU (clients "
          f"{fixed.tolist()}, dropout off) max|d|/max|ref| {dp_err:.3g}; "
          f"5 rounds at z=0: accuracy {[round(a, 4) for a in r.test_accuracy]}"
          f" (untrained {before:.4f}), wall ms per round "
          f"{[round(t * 1e3, 1) for t in r.wall_time]}; z=1.0 round: noise "
          f"std {std:.6f} over {noise.numel()} coordinates (sigma "
          f"{sigma}) {card}")
    print(f"dp-fedavg privacy_spend(1.0, 5, 0.1): {json.dumps(spend)}")

    # 9.7 secure aggregation, clip 5.0, 20 bits.
    quantum = secure_agg.secagg_scale(5.0, 20)
    got = pair(secure_agg.SecureAggFedAvgServer, clip_norm=5.0, bits=20)
    sec_err = max((a - b).abs().max().item()
                  for a, b in zip(got["cuda"], got["cpu"]))
    check(sec_err <= quantum * (1 + 1e-6), f"secure round card vs CPU "
          f"max|d|={sec_err:.3g} > one quantum {quantum:.3g}")
    sec = secure_agg.SecureAggFedAvgServer(params, mnist_cnn.apply, data, xt,
                                           yt, cfg, clip_norm=5.0, bits=20,
                                           device=dev)
    agg = {}

    def masked_round_0():
        """Round 0's clients, quantization, pair masks and ring sum: the
        whole of a secure round but its one host multiply."""
        with torch.no_grad(), fp32_products():
            agg["idx"], agg["q"] = sec.quantized_deltas(sec.params, 0)
            agg["masked"] = sec.masked_sum(agg["idx"], agg["q"], 0)

    prof = profile_step.trace(masked_round_0, 1)
    q, masked = agg["q"], agg["masked"]
    with torch.no_grad():
        plain = secure_agg.ring_sum(q)
    check(all(a.device.type == dev.type and torch.equal(a, b) for a, b in
              zip(tree_leaves(masked), tree_leaves(plain))),
          "secure aggregation: the masked sum differs from the unmasked "
          "quantized sum on the card")
    before = sec.test()
    r = sec.run(5)
    check(all(math.isfinite(a) for a in r.test_accuracy) and
          r.test_accuracy[-1] > before, f"secure aggregation accuracy "
          f"{r.test_accuracy} not above the untrained {before:.4f}")
    print(f"secagg round 0's masked aggregation (the check above) under "
          f"the profiler: kernels "
          f"{prof['kernel_ms_per_step']:.2f} ms per round "
          f"({prof['kernels_per_step']:.0f} launches), profiled wall "
          f"{prof['profiled_wall_ms_per_step']:.1f} ms, busy share "
          f"{prof['profiled_busy_share']:.3f}; by category "
          f"{json.dumps(prof['ms_per_step_by_category'])} {card}")
    out["secagg"] = {"card_vs_cpu_max_abs": sec_err, "quantum": quantum,
                     "profile": prof,
                     "masked_equals_unmasked": True,
                     "accuracy_before": before, "accuracy": r.test_accuracy,
                     "wall_ms": [t * 1e3 for t in r.wall_time]}
    print(f"secagg clip 5.0, 20 bits: one round card vs CPU max|d| "
          f"{sec_err:.3g} (one quantum {quantum:.3g}); masked sum == "
          f"unmasked quantized sum bitwise on the card over "
          f"{sum(t.numel() for t in tree_leaves(q)) // m} coordinates; 5 "
          f"rounds: accuracy {[round(a, 4) for a in r.test_accuracy]} "
          f"(untrained {before:.4f}), wall ms per round "
          f"{[round(t * 1e3, 1) for t in r.wall_time]} {card}")
    return out


def dp_phase(dev: torch.device, card: str, world_one_tok_s: float,
             world_one_step_ms: float) -> dict:
    """Phase 10: two ranks on the card (one ``run_ranks`` launch of
    ``programs.phase10``) against a world of one computed here, and phase
    6's world-of-one throughput (``world_one_tok_s``, ms per step) printed
    beside theirs. Raises on a failed check; returns the numbers for the
    JSON record."""

    from ddl25spring_tpu_torch import bench_utils
    from ddl25spring_tpu_torch.config import LlamaConfig
    from ddl25spring_tpu_torch.models import llama
    from ddl25spring_tpu_torch.parallel import distributed, dp, programs
    from ddl25spring_tpu_torch.tree import tree_leaves

    t0 = time.perf_counter()
    kcfg = LlamaConfig(attention_impl="pallas", flash_dh_major=True)
    tseq = kcfg.ctx_size
    g10 = torch.Generator()
    g10.manual_seed(10)
    toks10 = torch.randint(0, kcfg.vocab_size, (5, 8, tseq), generator=g10)
    # The world of one at B = 8 on the same tokens and weights.
    m1 = llama.init_llama(kcfg, torch.Generator().manual_seed(0), device=dev)
    x10 = toks10.to(dev)
    l1 = llama.forward_loss(m1, x10[0], kcfg)
    ref_grads = torch.autograd.grad(l1, tree_leaves(m1.tree()))
    ref_loss = l1.item()
    ref_grads = [g.cpu() for g in ref_grads]
    opt1 = bench_utils.make_optimizer("pallas")
    st1 = dp.init_state(m1.tree(), opt1)
    step1 = dp.make_grad_aggregation_step(
        lambda p, batch: llama.forward_loss(p, batch, kcfg), opt1)
    ref_traj = []
    for x in x10:
        st1, loss = step1(st1, x)
        ref_traj.append(float(loss))
    del m1, st1, step1, x10, l1
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = distributed.run_ranks(programs.phase10, 2, toks10.numpy(),
                                      tmp, timeout=900)
    dp_s = time.perf_counter() - t0
    r0 = ranks[0]
    for rk in ranks:
        pr = rk["probe"]
        check(pr["scalar_exact"] and pr["vector_exact"]
              and pr["broadcast_exact"], f"gloo probe rank {rk['rank']}: {pr}")
        check(pr["device"] == "cuda:0", f"rank {rk['rank']} on {pr['device']}")
    print(f"dp probe: 2 ranks on {r0['probe']['device']}, int32 scalar and "
          f"{r0['probe']['elements']} fp32 elements all-reduced and "
          f"broadcast exactly; route: {distributed.BACKEND}, "
          f"{distributed.ROUTE}; all-reduce of the vector "
          f"{r0['probe']['allreduce_ms']:.1f} / "
          f"{ranks[1]['probe']['allreduce_ms']:.1f} ms (median of 5) {card}")
    dp_loss_err = abs(r0["loss1"] - ref_loss)
    dp_grad_err = max(((a - r).abs().max() / r.abs().max()).item()
                      for a, r in zip(r0["grads"], ref_grads))
    traj2 = r0["gradient"]["losses"]
    dp_traj_err = max(abs(a - b) for a, b in zip(traj2, ref_traj))
    check(dp_loss_err <= TOL_DP_LOSS, f"dp loss 2 ranks vs world of one "
          f"|d|={dp_loss_err:.3g} > {TOL_DP_LOSS}")
    check(dp_grad_err <= TOL_DP_GRAD, f"dp averaged gradient vs world of one "
          f"max|d|/max|ref|={dp_grad_err:.3g} > {TOL_DP_GRAD}")
    check(dp_traj_err <= TOL_TRAJECTORY, f"dp 5-step trajectory vs world of "
          f"one max|d|={dp_traj_err:.3g} > {TOL_TRAJECTORY}")
    want_k = {"flash_fwd": 6, "flash_bwd_dq": 6, "flash_bwd_dkv": 6,
              "adam": 1}
    want_0 = dict(want_k, adam=0)
    for rk in ranks:
        check(rk["gradient"]["losses"] == traj2, "dp ranks' losses differ")
        for part, want in (("gradient", want_k), ("zero1", want_0),
                           ("weight", want_0), ("kstep", want_k),
                           ("throughput", want_k), ("trainer", want_k)):
            check(rk[part]["launches"] == want, f"dp {part} rank "
                  f"{rk['rank']}: launches per step {rk[part]['launches']}, "
                  f"expected {want}")
    print(f"dp fp32 B=4 per rank x {tseq} vs world of one at B=8: loss "
          f"{r0['loss1']:.6f} vs {ref_loss:.6f} |d| {dp_loss_err:.3g}, "
          f"averaged gradient max|d|/max|ref| {dp_grad_err:.3g} over "
          f"{len(ref_grads)} leaves; 5-step losses "
          f"{[round(x, 5) for x in traj2]} vs "
          f"{[round(x, 5) for x in ref_traj]}, max|d| {dp_traj_err:.3g}; "
          f"launches per rank per step {r0['gradient']['launches']} {card}")
    thr = [rk["throughput"] for rk in ranks]
    check(all(math.isfinite(t["loss"]) for t in thr),
          f"dp bf16 step losses {[t['loss'] for t in thr]}")
    dp_tok_s = thr[0]["tokens_per_sec"]
    dp_step_ms = 2 * 32 * tseq / dp_tok_s * 1e3
    ar_ms = statistics.median(t["allreduce_ms"] for t in thr)
    print(f"dp bf16 time_train_step, 2 ranks x B=32 x {tseq} (64 x {tseq} "
          f"tokens per step, as phase 6), optimizer pallas, gradient "
          f"aggregation: launches per rank per step {thr[0]['launches']}, "
          f"loss {thr[0]['loss']:.4f}; all ranks {dp_tok_s:.0f} tok/s wall "
          f"({dp_step_ms:.2f} ms per step) vs phase 6's world of one "
          f"{world_one_tok_s:.0f} tok/s ({world_one_step_ms:.2f} ms); the "
          f"gradient all-reduce alone {ar_ms:.2f} ms per step "
          f"({thr[0]['allreduce_bytes'] / 1e6:.1f} MB fp32; gloo on one "
          f"card, staged through the host, not NCCL; per rank "
          f"{[round(t['allreduce_ms'], 2) for t in thr]}) {card}")
    z = [rk["zero1"] for rk in ranks]
    z_err = max(abs(a - b) for a, b in zip(z[0]["losses"], traj2))
    check(z_err <= TOL_TRAJECTORY, f"dp zero1 trajectory vs gradient "
          f"aggregation max|d|={z_err:.3g} > {TOL_TRAJECTORY}")
    ratio = z[0]["moment_bytes"] / r0["gradient"]["moment_bytes"]
    check(ratio == 0.5, f"dp zero1 moment bytes ratio {ratio}")
    check(not z[0]["kernel_eligible"], "zero1 slice took the Adam kernel")
    print(f"dp zero1 fp32 B=4 per rank: 5 steps max|d| vs gradient "
          f"aggregation {z_err:.3g}; moment bytes per rank "
          f"{z[0]['moment_bytes']} vs {r0['gradient']['moment_bytes']} "
          f"({ratio}); Adam launches 0: the {z[0]['local']}-element slice "
          f"is {z[0]['local'] % 512} mod 512, so the fused apply routes it "
          f"to the plain rule (as the JAX package's _pallas_eligible); "
          f"launches per step {z[0]['launches']} {card}")
    for rk in ranks:
        w = rk["weight"]
        check(all(math.isfinite(x) for x in w["losses"])
              and all(w["digests_equal"]), f"dp weight aggregation rank "
              f"{rk['rank']}: {w}")
        ks = rk["kstep"]
        check(ks["losses_equal"] and ks["params_equal"]
              and ks["moments_equal"], f"dp K-step vs per step rank "
              f"{rk['rank']}: {ks}")
    print(f"dp weight aggregation: 3 steps, losses "
          f"{[round(x, 5) for x in r0['weight']['losses']]}, parameter "
          f"digests equal across ranks after every step; launches per step "
          f"{r0['weight']['launches']}. K-step (K=4): losses, parameters "
          f"and moments bitwise 4 per-step calls {card}")
    tr = r0["trainer"]
    check(len(tr["losses"]) == 20 and all(math.isfinite(x)
                                          for x in tr["losses"]),
          f"train_llm_dp data=2 losses {tr['losses']}")
    check(tr["resumed_start"] == 10 and tr["resumed_len"] == 20
          and tr["resume_max_abs_diff"] <= TOL_RESUME,
          f"train_llm_dp resume: {tr['resumed_start']} "
          f"{tr['resume_max_abs_diff']}")
    check(tr["master_losses"][-1] < tr["master_losses"][0]
          and tr["master_param_dtypes"] == ["torch.bfloat16"]
          and tr["master_dtypes"] == ["torch.float32"],
          f"master-weight run: {tr['master_losses'][::19]} "
          f"{tr['master_param_dtypes']} {tr['master_dtypes']}")
    print(f"train_llm_dp data=2 (vocab 259, batch 3 x 256 per rank, "
          f"optimizer pallas): loss {tr['losses'][0]:.4f} -> "
          f"{tr['losses'][-1]:.4f}, {tr['tokens_per_sec']:.0f} tok/s all "
          f"ranks after warmup; launches per rank per step {tr['launches']}; "
          f"10 steps resumed to 20 from a checkpoint: max|d| vs "
          f"uninterrupted {tr['resume_max_abs_diff']:.3g}; master weights "
          f"(bf16 params {tr['master_param_dtypes']}, master "
          f"{tr['master_dtypes']}): loss {tr['master_losses'][0]:.4f} -> "
          f"{tr['master_losses'][-1]:.4f} {card}")
    print(f"dp phase: {dp_s:.1f} s {card}")
    dp_report = {"seconds": dp_s, "route": distributed.ROUTE,
                 "comm": r0["comm"],
                 "probe": [rk["probe"] for rk in ranks],
                 "fp32_loss_abs_err": dp_loss_err,
                 "fp32_grad_rel_err": dp_grad_err,
                 "fp32_traj_max_abs_err": dp_traj_err,
                 "tokens_per_sec_2_ranks": dp_tok_s,
                 "tokens_per_sec_world_of_one": world_one_tok_s,
                 "allreduce_ms": ar_ms, "zero1_traj_err": z_err,
                 "parts": {k: r0[k] for k in ("gradient", "zero1", "weight",
                                              "kstep", "throughput",
                                              "trainer")}}
    return dp_report


# ------------------------------------------------------------- phase 11

# Phase 11 (serving extensions) at phase 5's pool and workload.
SERVE_PAGED = dict(num_blocks=129, block_len=16, max_blocks_per_seq=16)
SERVE_WL = dict(seed=0, n_requests=32, rate_rps=50.0,
                prompt_lens=(16, 64, 192), max_news=(16, 32, 64),
                temperatures=(0.0, 0.8))
SERVE_SLOTS = 8
SPEC_K = 4
COW_PREFIX_BLOCKS = 8       # a 128-token shared prefix at block_len 16
TOL_ACCEPT = 0.03           # rejection sampling: rate and distribution


@contextlib.contextmanager
def dispatch_timer(dev: torch.device):
    """Wall seconds and counts of the engine's dispatches while the block
    runs, each bracketed by device syncs: prefill chunks (with the draft's
    mirror), plain decode steps, speculative rounds, and the draft's
    propose inside them (a round's verify is the round less its
    propose)."""
    from ddl25spring_tpu_torch.serving import engine as eng_mod
    from ddl25spring_tpu_torch.serving import speculate as spec_mod

    acc: dict = {}
    saved = []
    for cls, name, key in ((eng_mod.Engine, "_advance_prefill", "prefill"),
                           (eng_mod.Engine, "_advance_decode", "decode"),
                           (eng_mod.Engine, "_advance_spec_decode", "round"),
                           (spec_mod.DraftEngine, "propose", "propose")):
        fn = getattr(cls, name)

        def timed(self, *a, _fn=fn, _key=key, **kw):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = _fn(self, *a, **kw)
            torch.cuda.synchronize(dev)
            n, s = acc.get(_key, (0, 0.0))
            acc[_key] = (n + 1, s + time.perf_counter() - t0)
            return out

        saved.append((cls, name, fn))
        setattr(cls, name, timed)
    try:
        yield acc
    finally:
        for cls, name, fn in saved:
            setattr(cls, name, fn)


def _ms_per(acc: dict, key: str) -> float:
    n, s = acc.get(key, (0, 0.0))
    return s / n * 1e3 if n else float("nan")


def greedy_bar(dev, params, cfg, paged, reqs, tokens_of: dict, refs: dict,
               what: str) -> tuple:
    """Phase 5's bar on a served run: every request has ``max_new`` tokens,
    and every greedy stream equals ``generate()`` for it alone or first
    differs where the reference's top-2 logit gap is below NEAR_TIE.
    ``refs`` caches reference streams by (prompt, max_new). Returns
    (exact, near-tie) counts."""
    from ddl25spring_tpu_torch.models import llama
    from ddl25spring_tpu_torch.serving import reference_stream

    plain_cfg = cfg.replace(attention_impl="xla")
    exact = near = 0
    for r in reqs:
        got = tokens_of[r.rid]
        check(len(got) == r.max_new, f"{what} {r.rid}: {len(got)} tokens, "
              f"max_new {r.max_new}")
        if r.temperature > 0:
            continue
        key = (tuple(r.prompt), r.max_new)
        if key not in refs:
            refs[key] = reference_stream(params, cfg, paged, r, device=dev)
        ref = refs[key]
        if got == ref:
            exact += 1
            continue
        i = next(j for j, (a, b) in enumerate(zip(got, ref)) if a != b)
        seq = torch.tensor([list(r.prompt) + ref[:i]], device=dev)
        with torch.inference_mode():
            last = llama.forward(params, seq, plain_cfg)[0, -1]
        top2 = torch.topk(last, 2).values
        gap = (top2[0] - top2[1]).item()
        check(gap < NEAR_TIE, f"{what} {r.rid}: stream differs from "
              f"generate() at token {i} where the reference's top-2 gap is "
              f"{gap:.3g}")
        near += 1
    return exact, near


def serving_ext_phase(dev: torch.device, card: str, model, cfg,
                      zero_counts, read_counts) -> dict:
    """Phase 11: speculative decoding (11a same-weights draft, 11b an
    independent 2-layer draft, 11c rejection sampling), copy-on-write
    prefix sharing (11d), gather narrowing (11e), the fleet and the
    train→deploy conveyor (11f), at full width on phase 5's pool, beside a
    plain rerun of phase 5. Raises on a failed check; returns the numbers
    for the JSON record."""
    from ddl25spring_tpu_torch import profile_step
    from ddl25spring_tpu_torch.config import LlamaConfig, TrainConfig
    from ddl25spring_tpu_torch.models import llama
    from ddl25spring_tpu_torch.serving import (
        CheckpointPublisher, Engine, PagedKVConfig, Request, ServingFleet,
        SpecConfig, TrafficClass, WeightPublisher, multi_tenant_workload,
        rejection_accept, run_serving, run_serving_fleet, synthetic_workload)
    from ddl25spring_tpu_torch.train.llm import train_llm_dp
    from ddl25spring_tpu_torch.tree import tree_leaves, tree_map

    t_phase = time.perf_counter()
    paged = PagedKVConfig(**SERVE_PAGED)
    wl = synthetic_workload(vocab_size=cfg.vocab_size, **SERVE_WL)
    refs: dict = {}
    out: dict = {}

    def served(kw, what):
        zero_counts()
        with dispatch_timer(dev) as acc:
            rep = run_serving(model, cfg, paged, wl, num_slots=SERVE_SLOTS,
                              prefill_chunk=16, device=dev, **kw)
        counts = read_counts()
        check(not any(counts.values()), f"{what} launched port kernels: "
              f"{counts}")
        check(rep.aggregates["completed"] == len(wl), f"{what}: served "
              f"{rep.aggregates['completed']} of {len(wl)}")
        ex, nt = greedy_bar(dev, model, cfg, paged, wl,
                            {k: r.tokens for k, r in rep.records.items()},
                            refs, what)
        agg = rep.aggregates
        row = {"exact": ex, "near_tie": nt,
               "tok_s": agg["sustained_tokens_per_sec"],
               "ttft_p50_ms": agg["ttft_s"]["p50"] * 1e3,
               "ttft_p99_ms": agg["ttft_s"]["p99"] * 1e3,
               "tokens_per_dispatch": rep.tokens_per_dispatch,
               "decode_dispatches": rep.decode_dispatches,
               "draft_dispatches": rep.draft_dispatches,
               "acceptance_rate": rep.acceptance_rate,
               "peak_blocks": rep.peak_blocks_in_use,
               "gather_bytes": rep.gather_bytes,
               "gather_bytes_saved": rep.gather_bytes_saved,
               "ms_per": {k: _ms_per(acc, k) for k in sorted(acc)},
               "dispatches": {k: acc[k][0] for k in sorted(acc)}}
        return rep, row

    # Phase 5's configuration again, timed per dispatch: the baseline.
    _, base = served({}, "plain")
    print(f"serving ext, plain (phase 5's configuration, rerun): greedy "
          f"{base['exact']} exact {base['near_tie']} near-tie; "
          f"{base['tok_s']:.0f} tok/s, TTFT p50 {base['ttft_p50_ms']:.1f} ms "
          f"p99 {base['ttft_p99_ms']:.1f} ms, tokens per dispatch "
          f"{base['tokens_per_dispatch']:.2f}, decode "
          f"{base['ms_per']['decode']:.2f} ms per dispatch, prefill "
          f"{base['ms_per']['prefill']:.2f} ms per chunk {card}")
    out["plain"] = base

    # 11a: a same-weights draft, k = 4.
    _, a = served({"speculate": SpecConfig(k=SPEC_K, draft_params=model)},
                  "11a")
    verify_ms = a["ms_per"]["round"] - a["ms_per"]["propose"]
    print(f"serving ext 11a, same-weights draft k={SPEC_K}: acceptance "
          f"{a['acceptance_rate']:.4f}; tokens per target dispatch "
          f"{a['tokens_per_dispatch']:.2f} (plain {base['tokens_per_dispatch']:.2f}); "
          f"{a['decode_dispatches']} verify and {a['draft_dispatches']} draft "
          f"dispatches; per round {a['ms_per']['round']:.2f} ms = draft "
          f"propose ({SPEC_K + 1} dispatches) {a['ms_per']['propose']:.2f} + "
          f"verify {verify_ms:.2f}; {a['tok_s']:.0f} tok/s (plain "
          f"{base['tok_s']:.0f}), TTFT p50 {a['ttft_p50_ms']:.1f} ms (plain "
          f"{base['ttft_p50_ms']:.1f}) p99 {a['ttft_p99_ms']:.1f} ms; greedy "
          f"{a['exact']} exact {a['near_tie']} near-tie {card}")
    a["verify_ms"] = verify_ms
    out["11a"] = a

    # Where a round's time goes: 5 profiled steps of 8 decoding slots.
    rng = torch.Generator().manual_seed(11)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_SLOTS, 16),
                            generator=rng).tolist()

    def profiled(kw):
        eng = Engine(model, cfg, paged, SERVE_SLOTS, prefill_chunk=16,
                     device=dev, **kw)
        for p in prompts:
            eng.admit(p, paged.max_seq_len - 16)
        while any(sl.phase == "prefill" for sl in eng.slots):
            eng.step()
        eng.step(), eng.step()
        return profile_step.trace(eng.step, 5)

    prof = {"plain": profiled({}),
            "narrowed": profiled({"gather_buckets": True}),
            "spec": profiled({"speculate": SpecConfig(k=SPEC_K,
                                                      draft_params=model)})}
    for name, p in prof.items():
        print(f"serving ext profile, {name} decode of {SERVE_SLOTS} slots: "
              f"{p['kernel_ms_per_step']:.2f} kernel ms in "
              f"{p['profiled_wall_ms_per_step']:.2f} ms per step (profiled), "
              f"busy {p['profiled_busy_share']:.3f}, "
              f"{p['kernels_per_step']:.0f} kernels per step {card}")
    out["profile"] = {k: {kk: v[kk] for kk in (
        "kernel_ms_per_step", "profiled_wall_ms_per_step",
        "profiled_busy_share", "kernels_per_step", "ms_per_step_by_category")}
        for k, v in prof.items()}

    # 11b: an independent 2-layer draft of its own seeded weights.
    dcfg = cfg.replace(n_layers=2)
    dmodel = llama.init_llama(dcfg, torch.Generator().manual_seed(3),
                              device=dev)
    out["11b"] = {}
    for k in (1, SPEC_K):
        _, b = served({"speculate": SpecConfig(k=k, draft_params=dmodel,
                                               draft_cfg=dcfg)}, f"11b k={k}")
        print(f"serving ext 11b, 2-layer draft k={k}: acceptance "
              f"{b['acceptance_rate']:.4f}, tokens per target dispatch "
              f"{b['tokens_per_dispatch']:.2f}, round "
              f"{b['ms_per']['round']:.2f} ms (propose "
              f"{b['ms_per']['propose']:.2f}), {b['tok_s']:.0f} tok/s; greedy "
              f"{b['exact']} exact {b['near_tie']} near-tie {card}")
        out["11b"][f"k{k}"] = b

    # 11c: rejection sampling on the card, the JAX test's p / q pair.
    p0 = torch.tensor([0.5, 0.3, 0.15, 0.05], device=dev)
    q0 = torch.tensor([0.2, 0.5, 0.2, 0.1], device=dev)
    n = 4096
    g = torch.Generator(device=dev)
    g.manual_seed(12)
    drafts = torch.multinomial(q0, n, replacement=True, generator=g)[:, None]
    u = torch.rand(n, 4, generator=g, device=dev)
    acc_n, corr = rejection_accept(u, p0.expand(n, 2, 4), q0.expand(n, 1, 4),
                                   drafts)
    rate = acc_n.float().mean().item()
    analytic = torch.minimum(p0, q0).sum().item()
    emitted = torch.where(acc_n > 0, drafts[:, 0], corr)
    emp = (torch.bincount(emitted, minlength=4).float() / n)
    dist_err = (emp - p0).abs().max().item()
    check(abs(rate - analytic) < TOL_ACCEPT, f"11c acceptance {rate:.4f} vs "
          f"analytic {analytic:.4f}")
    check(dist_err < TOL_ACCEPT, f"11c emitted distribution {emp.tolist()} "
          f"vs p {p0.tolist()}")
    print(f"serving ext 11c, rejection sampling on the card ({n} trials): "
          f"acceptance {rate:.4f} vs sum min(p, q) {analytic:.4f}; emitted "
          f"distribution {[round(x, 4) for x in emp.tolist()]} vs p "
          f"{p0.tolist()}, max|d| {dist_err:.4f} (limit {TOL_ACCEPT}) {card}")
    out["11c"] = {"trials": n, "acceptance": rate, "analytic": analytic,
                  "dist_max_abs_err": dist_err}

    # 11d: copy-on-write, 8 requests over one 128-token prefix.
    bl = paged.block_len
    pre = torch.randint(0, cfg.vocab_size, (COW_PREFIX_BLOCKS * bl,),
                        generator=rng).tolist()
    cow = [Request(rid=f"cow-{i}", prompt=tuple(
        pre + [(7 * i + j) % (cfg.vocab_size - 1) + 1 for j in range(8)]),
        max_new=16) for i in range(8)]

    def cow_run(share, reqs):
        """Admit the donor, prefill it, then the rest; returns (tokens,
        peak, shared blocks' bytes unchanged across every prefill)."""
        eng = Engine(model, cfg, paged, len(reqs), prefill_chunk=16,
                     prefix_share=share, device=dev)
        slot_of = {eng.admit(list(reqs[0].prompt), reqs[0].max_new): reqs[0]}
        toks = {r.rid: [] for r in reqs}

        def step():
            for ev in eng.step():
                toks[slot_of[ev.slot].rid].append(ev.token)

        while eng.slots[0].phase == "prefill":
            step()
        blocks = [int(x) for x in eng.tables[0, :COW_PREFIX_BLOCKS]]
        before = (eng.pool["k"][:, blocks].clone(),
                  eng.pool["v"][:, blocks].clone())
        for r in reqs[1:]:
            slot_of[eng.admit(list(r.prompt), r.max_new)] = r
        if share:
            check(all(eng.allocator.refcount(b) == len(reqs) for b in blocks),
                  f"11d refcounts {[eng.allocator.refcount(b) for b in blocks]}")
        unchanged = True
        while any(sl is not None and sl.phase == "prefill"
                  for sl in eng.slots):
            step()
            unchanged &= (torch.equal(before[0], eng.pool["k"][:, blocks])
                          and torch.equal(before[1], eng.pool["v"][:, blocks]))
        while eng.busy:
            step()
        return toks, eng.allocator.peak_in_use, unchanged

    zero_counts()
    pair_share = cow_run(True, cow[:2])
    pair_plain = cow_run(False, cow[:2])
    all_share = cow_run(True, cow)
    all_plain = cow_run(False, cow)
    check(not any(read_counts().values()), "11d launched port kernels")
    check(pair_share[1] == pair_plain[1] - COW_PREFIX_BLOCKS,
          f"11d two overlapping requests: peak {pair_share[1]} with sharing, "
          f"{pair_plain[1]} without (expected {COW_PREFIX_BLOCKS} fewer)")
    check(pair_share[2] and all_share[2], "11d the shared blocks' bytes "
          "changed during a sharer's prefill")
    cow_exact = cow_near = 0
    for toks, what in ((pair_share[0], "11d pair"), (pair_plain[0],
                                                     "11d pair plain"),
                       (all_share[0], "11d eight"), (all_plain[0],
                                                     "11d eight plain")):
        reqs = [r for r in cow if r.rid in toks]
        e, nt = greedy_bar(dev, model, cfg, paged, reqs, toks, refs, what)
        cow_exact += e
        cow_near += nt
    print(f"serving ext 11d, copy-on-write over a {COW_PREFIX_BLOCKS * bl}-"
          f"token prefix: 2 overlapping requests peak {pair_share[1]} blocks "
          f"shared vs {pair_plain[1]} ({pair_plain[1] - pair_share[1]} "
          f"fewer); 8 requests peak {all_share[1]} vs {all_plain[1]}; the "
          f"shared blocks' bytes unchanged across every sharer's prefill; "
          f"greedy {cow_exact} exact {cow_near} near-tie {card}")
    out["11d"] = {"pair_peak": [pair_share[1], pair_plain[1]],
                  "eight_peak": [all_share[1], all_plain[1]],
                  "bytes_unchanged": True, "exact": cow_exact,
                  "near_tie": cow_near}

    # 11e: gather narrowing, in turns with a plain run (one pair; two
    # through PR 16).
    turns = {"narrowed": [], "plain": []}
    for name in ("narrowed", "plain"):
        _, r = served({"gather_buckets": name == "narrowed"}, f"11e {name}")
        turns[name].append(r)
    e = turns["narrowed"][0]
    share_saved = e["gather_bytes_saved"] / (e["gather_bytes"]
                                             + e["gather_bytes_saved"])
    check(e["gather_bytes_saved"] > 0, "11e saved no gather bytes")
    dec = {k: [r["ms_per"]["decode"] for r in v] for k, v in turns.items()}
    tps = {k: [r["tok_s"] for r in v] for k, v in turns.items()}
    print(f"serving ext 11e, gather narrowing: {e['gather_bytes_saved']} of "
          f"{e['gather_bytes'] + e['gather_bytes_saved']} KV bytes not "
          f"gathered ({share_saved:.3f}); in turns (narrowed, plain) "
          f"decode ms per dispatch narrowed "
          f"{[round(x, 2) for x in dec['narrowed']]} plain "
          f"{[round(x, 2) for x in dec['plain']]} (phase 5's rerun "
          f"{base['ms_per']['decode']:.2f}); tok/s narrowed "
          f"{[round(x) for x in tps['narrowed']]} plain "
          f"{[round(x) for x in tps['plain']]}; greedy {e['exact']} exact "
          f"{e['near_tie']} near-tie {card}")
    out["11e"] = {"share_saved": share_saved,
                  "gather_bytes": e["gather_bytes"],
                  "gather_bytes_saved": e["gather_bytes_saved"],
                  "decode_ms": dec, "tok_s": tps,
                  "exact": e["exact"], "near_tie": e["near_tie"]}

    # 11f: the fleet over a two-class workload, then the deploy conveyor.
    classes = (TrafficClass("chat", 40.0, prompt_lens=(16, 64),
                            max_news=(16, 32), priority=1, ttft_p99_s=1.0),
               TrafficClass("batch", 10.0, prompt_lens=(64, 192),
                            max_news=(32, 64), temperatures=(0.0,),
                            queue_p99_s=5.0))
    fwl = multi_tenant_workload(seed=5, classes=classes, n_per_class=16,
                                vocab_size=cfg.vocab_size)
    out["11f"] = {}
    zero_counts()
    for n_eng, policy in ((1, "least_loaded"), (2, "least_loaded"),
                          (2, "predicted_ttft")):
        frep = run_serving_fleet(model, cfg, paged, fwl, num_engines=n_eng,
                                 num_slots=SERVE_SLOTS, prefill_chunk=16,
                                 policy=policy, device=dev)
        what = f"11f {n_eng} engines {policy}"
        check(frep.aggregates["completed"] == len(fwl), f"{what}: served "
              f"{frep.aggregates['completed']} of {len(fwl)}")
        ex, nt = greedy_bar(dev, model, cfg, paged, fwl,
                            {k: r.tokens for k, r in frep.records.items()},
                            refs, what)
        per = {eid: {"ttft_p50_ms": agg["ttft_s"]["p50"] * 1e3,
                     "ttft_p99_ms": agg["ttft_s"]["p99"] * 1e3,
                     "completed": agg["completed"],
                     "peak_blocks": agg["peak_blocks_in_use"]}
               for eid, agg in frep.per_engine.items()}
        cls = {c: agg["ttft_s"]["p99"] * 1e3
               for c, agg in frep.per_class.items()}
        print(f"serving ext {what}: {frep.aggregates['sustained_tokens_per_sec']:.0f} "
              f"tok/s; per engine TTFT p50/p99 ms "
              + ", ".join(f"{eid}: {v['ttft_p50_ms']:.1f}/"
                          f"{v['ttft_p99_ms']:.1f} ({v['completed']} "
                          f"requests)" for eid, v in per.items())
              + f"; per class TTFT p99 ms {cls}; greedy {ex} exact {nt} "
              f"near-tie {card}")
        out["11f"][f"{n_eng}x{policy}"] = {
            "tok_s": frep.aggregates["sustained_tokens_per_sec"],
            "per_engine": per, "per_class_ttft_p99_ms": cls,
            "exact": ex, "near_tie": nt}

    def drive(params, reqs, tcfg, publish=None, at=6):
        """Every request submitted at once to 2 engines, ticked to the end;
        ``publish(fleet)`` fires at tick ``at``. Returns (fleet, tokens
        each request had when its engine swapped)."""
        fleet = ServingFleet(params, tcfg, paged, num_engines=2,
                             num_slots=SERVE_SLOTS, prefill_chunk=16,
                             device=dev)
        for r in reqs:
            fleet.submit(r, now=0.0)
        prefix, tick = {}, 0
        while fleet.outstanding or fleet.swap_pending:
            if publish is not None and tick == at:
                publish(fleet)
            eid = fleet.next_swap()
            if eid is not None:
                prefix.update({rid: list(rec.tokens) for rid, rec in
                               fleet.scheds[eid].records.items()})
            fleet.tick()
            tick += 1
        return fleet, prefix

    swl = fwl[:16]
    base_f, _ = drive(model, swl, cfg)
    same = tree_map(lambda x: x.detach().clone(), llama.as_tree(model))
    same_f, same_pre = drive(model, swl, cfg, lambda f: f.publish(
        same, version="same"))
    other = llama.init_llama(cfg, torch.Generator().manual_seed(1),
                             device=dev)
    new_f, new_pre = drive(model, swl, cfg, lambda f: f.publish(
        other, version="seed-1"))
    check(not any(read_counts().values()), "11f fleet launched port kernels")
    for r in swl:
        want = base_f.records[r.rid].tokens
        check(same_f.records[r.rid].tokens == want, f"11f same-weights "
              f"publish changed {r.rid}")
        pre = new_pre.get(r.rid, [])
        check(new_f.records[r.rid].tokens[:len(pre)] == want[:len(pre)]
              == pre, f"11f second-seed publish changed {r.rid} before its "
              f"engine's swap")
    changed = sum(new_f.records[r.rid].tokens != base_f.records[r.rid].tokens
                  for r in swl)
    check(changed > 0, "11f second-seed publish changed nothing")
    n_pre = sum(len(v) for v in new_pre.values())
    print(f"serving ext 11f publish, 2 engines, {len(swl)} requests: "
          f"same-weights publish changed 0 tokens; second-seed publish "
          f"({[d['engine'] for d in new_f.deploys]} swapped in turn) kept "
          f"all {n_pre} tokens emitted before each engine's swap and changed "
          f"{changed} streams after it {card}")
    out["11f"]["publish"] = {"tokens_before_swap": n_pre,
                             "streams_changed": changed}

    # Deploy: phase 7's trainer publishes every 5 steps; a watcher
    # publishes its newest step to a 2-engine fleet at vocab 259.
    final = {}
    with tempfile.TemporaryDirectory() as tmp:
        pub = CheckpointPublisher(f"{tmp}/publish", log_fn=print)

        def hook(step, state):
            if step == 20:
                final["params"] = tree_map(lambda x: x.detach().clone(),
                                           state.params)
            pub(step, state)

        zero_counts()
        t0 = time.perf_counter()
        trep = train_llm_dp(None, TrainConfig(optimizer="pallas", iters=20),
                            log_every=0, checkpoint_dir=f"{tmp}/ck",
                            checkpoint_every=5, on_checkpoint=hook,
                            device=None)
        train_s = time.perf_counter() - t0
        tcounts = {k: v / 20 for k, v in read_counts().items()}
        check(pub.published == [5, 10, 15, 20], f"deploy: published "
              f"{pub.published}")
        check(tcounts == {"flash_fwd": 6, "flash_bwd_dq": 6,
                          "flash_bwd_dkv": 6, "adam": 1},
              f"deploy trainer launches per step {tcounts}")
        tcfg = LlamaConfig().replace(vocab_size=259)
        boot = llama.init_llama(tcfg, torch.Generator().manual_seed(11),
                                device=dev)
        dreq = [Request(rid=f"d{i}", prompt=tuple(
            torch.randint(0, 259, (24,), generator=rng).tolist()),
            max_new=24) for i in range(8)]
        wp = WeightPublisher(f"{tmp}/publish", boot)
        steps = []
        zero_counts()
        dbase, _ = drive(boot, dreq, tcfg)
        dfleet, dpre = drive(boot, dreq, tcfg,
                             lambda f: steps.append(wp.publish_to(f)), at=4)
        check(not any(read_counts().values()), "deploy fleet launched port "
              "kernels")
    check(steps == [20], f"deploy: publish_to returned {steps}")
    flat = tree_leaves(final["params"])
    bitwise = all(all(torch.equal(a, b) for a, b in
                      zip(tree_leaves(e.params), flat))
                  for e in dfleet.engines)
    check(bitwise, "deploy: served parameters differ from the trainer's")
    for r in dreq:
        pre = dpre[r.rid]
        check(dfleet.records[r.rid].tokens[:len(pre)] == pre
              == dbase.records[r.rid].tokens[:len(pre)], f"deploy: {r.rid} "
              f"changed before its engine's swap")
    print(f"serving ext 11f deploy: train_llm_dp (vocab 259, 20 steps, "
          f"{train_s:.1f} s, loss {trep.losses[0]:.4f} -> "
          f"{trep.losses[-1]:.4f}, launches per step {tcounts}) published "
          f"steps {pub.published}; WeightPublisher restored step {steps[0]} "
          f"and rolled it to 2 engines ({[d['engine'] for d in dfleet.deploys]}); "
          f"served parameters equal the trainer's bitwise over {len(flat)} "
          f"leaves; {sum(len(v) for v in dpre.values())} tokens before the "
          f"swaps unchanged {card}")
    out["deploy"] = {"published": pub.published, "bitwise": bitwise,
                     "train_s": train_s, "launches_per_step": tcounts}
    out["seconds"] = time.perf_counter() - t_phase
    print(f"serving ext phase: {out['seconds']:.1f} s, port kernel launches "
          f"0 outside the deploy trainer {card}")
    return out


# ------------------------------------------------------------- phase 12

# Phase 12 (resilience and telemetry): the faults b injects, and the limits.
FAULTS_B = "nan_grad@3,nan_grad@7:4,spike_grad@12:100"
# ``leaf_paths`` of the trainer's parameter tree at index 3 (1-based leaf
# #4): the string the JAX package's ``leaf_paths`` gives for that tree
# (tests/test_torch_telemetry.py holds the two equal).
LEAF_4 = "blocks/w_gate"
TOL_NUMERICS = 1e-5       # a numerics event's grad norm vs a recomputation


def resilience_phase(dev: torch.device, card: str, zero_counts, read_counts,
                     model, cfg, dp_report: dict, mnist_arrays) -> dict:
    """Phase 12: the guarded, fault-injected, preemptible and observed
    trainer at full width (12a-e), rematerialized blocks (12f), the serving
    memory census and compile counts and a faulted, observed FL run (12g).
    Raises on a failed check; returns the numbers for the JSON record."""
    from ddl25spring_tpu_torch import bench_utils, fl
    from ddl25spring_tpu_torch.checkpoint import Checkpointer
    from ddl25spring_tpu_torch.config import (FLConfig, LlamaConfig,
                                              ResilienceConfig, TrainConfig)
    from ddl25spring_tpu_torch.data import mnist
    from ddl25spring_tpu_torch.data.tokens import shard_batches
    from ddl25spring_tpu_torch.models import llama, mnist_cnn
    from ddl25spring_tpu_torch.parallel import dp
    from ddl25spring_tpu_torch.resilience import FaultPlan, measure_overhead
    from ddl25spring_tpu_torch.serving import (Engine, PagedKVConfig,
                                               Scheduler, synthetic_workload)
    from ddl25spring_tpu_torch.telemetry import (EventLog, Telemetry,
                                                 read_events, trace_trees,
                                                 tree_check, validate_event)
    from ddl25spring_tpu_torch.telemetry.introspect import (find_bundles,
                                                            leaf_paths,
                                                            load_bundle)
    from ddl25spring_tpu_torch.telemetry.memory import tree_state_bytes
    from ddl25spring_tpu_torch.tokenizers import load_tokenizer
    from ddl25spring_tpu_torch.train.llm import train_llm_dp
    from ddl25spring_tpu_torch.tree import tree_leaves

    t_phase = time.perf_counter()
    out: dict = {}
    tmp = tempfile.mkdtemp(prefix="chip-smoke-12-")
    kw = dict(log_every=0, device=None)
    tc10 = TrainConfig(optimizer="pallas", iters=10)
    want = {"flash_fwd": 6, "flash_bwd_dq": 6, "flash_bwd_dkv": 6,
            "adam": 1}

    # 12a: a fault-free run is bitwise the unguarded one; the guard tax.
    plain = train_llm_dp(None, tc10, **kw)
    zero_counts()
    guarded = train_llm_dp(None, tc10, resilience=ResilienceConfig(), **kw)
    gper = {k: n / tc10.iters for k, n in read_counts().items()}
    check(guarded.losses == plain.losses, f"guarded fault-free losses "
          f"{guarded.losses} differ from unguarded {plain.losses}")
    check(not any(guarded.resilience.as_dict().values()),
          f"guarded fault-free run counted {guarded.resilience}")
    check(gper == want, f"guarded trainer launches per step {gper}, "
          f"expected {want}")
    tcfg = LlamaConfig(dtype="bfloat16", attention_impl="pallas",
                       flash_dh_major=True, flash_block=512)

    def make_state_and_step():
        state, step, _ = bench_utils.build_train_step(tcfg, 64,
                                                      opt_name="pallas",
                                                      device=dev)
        return state, step

    g1 = torch.Generator(device=dev)
    g1.manual_seed(1)
    tokens = torch.randint(0, tcfg.vocab_size, (64, tcfg.ctx_size),
                           generator=g1, device=dev)
    # Two calls (three through PR 16), each four runs of fresh states in
    # turns (unguarded, guarded, guarded, unguarded), so no side always
    # runs first: the spread between calls says how far one call can be
    # trusted.
    pairs = []
    for _ in range(2):
        times: dict = {}
        tax, tax_stats = measure_overhead(make_state_and_step, tokens,
                                          steps=10, warmup=3, device=dev,
                                          report=times)
        check(not any(tax_stats.as_dict().values()),
              f"guard tax run counted {tax_stats}")
        pairs.append(dict(times, tax_pct=tax))
    tax = statistics.median(t["tax_pct"] for t in pairs)
    tax_ms = statistics.median(t["guarded_ms_per_step"]
                               - t["raw_ms_per_step"] for t in pairs)
    raw_ms = statistics.median(t["raw_ms_per_step"] for t in pairs)
    out["guard"] = {"bitwise": True, "launches_per_step": gper,
                    "tax_pct_median": tax, "tax_ms_median": tax_ms,
                    "raw_ms_median": raw_ms, "pairs": pairs}
    print(f"resilience 12a: 10 guarded steps of train_llm_dp (vocab 259, "
          f"batch 3 x 256, optimizer pallas) bitwise the unguarded run "
          f"(losses {plain.losses[0]:.4f} -> {plain.losses[-1]:.4f}), no "
          f"counter moved; launches per step {gper}. Guard tax at phase 6's "
          f"shape (B=64 x 256, bf16), {len(pairs)} calls of 4 runs of 10 "
          f"steps in turns (unguarded, guarded, guarded, unguarded), each "
          f"side the "
          f"mean of its two: ms per step (unguarded, guarded) "
          f"{[(round(t['raw_ms_per_step'], 2), round(t['guarded_ms_per_step'], 2)) for t in pairs]}, "
          f"median tax {tax_ms:.2f} ms per step ({tax:+.1f}%) on "
          f"{raw_ms:.2f} {card}")

    # 12b + 12e: injected faults, observed.
    tel_dir = os.path.join(tmp, "telemetry")
    tel = Telemetry(tel_dir, step_every=5)
    captured: dict = {}

    def keep_final(step, state):
        captured.update(
            step=step, finite=all(bool(torch.isfinite(p).all())
                                  for p in tree_leaves(state.params)),
            state_bytes=(tree_state_bytes(state.params)
                         + tree_state_bytes(state.opt_state)))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    zero_counts()
    faulted = train_llm_dp(
        None, TrainConfig(optimizer="pallas", iters=16, numerics_every=5),
        resilience=ResilienceConfig(ema_warmup=5),
        fault_plan=FaultPlan.from_spec(FAULTS_B), telemetry=tel,
        checkpoint_dir=os.path.join(tmp, "ck_b"), checkpoint_every=1000,
        on_checkpoint=keep_final, **kw)
    peak = torch.cuda.max_memory_allocated(dev)
    bcounts = read_counts()
    tel.close()
    rs = faulted.resilience
    check(rs.skipped_steps == 2 and rs.anomalies == 1 and rs.rollbacks == 0,
          f"12b counters {rs}")
    check(all(math.isfinite(v) for i, v in enumerate(faulted.losses)
              if i not in (3, 7)), f"12b losses {faulted.losses}")
    check(captured.get("step") == 16 and captured["finite"],
          f"12b final parameters: {captured}")
    events = read_events(os.path.join(tel_dir, "events.jsonl"))
    bad = [(e["type"], validate_event(e)) for e in events
           if validate_event(e)]
    check(not bad, f"12e events failing validate_event: {bad[:3]}")
    checks = [tree_check(t) for t in trace_trees(events).values()]
    check(checks and all(c["orphans"] == 0 for c in checks),
          f"12e span trees {checks}")
    tok = load_tokenizer()
    vcfg = LlamaConfig(vocab_size=tok.vocab_size)
    m259 = llama.init_llama(vcfg, torch.Generator().manual_seed(0),
                            device=dev)
    check(leaf_paths(m259.tree())[3] == LEAF_4, "leaf #4 is "
          f"{leaf_paths(m259.tree())[3]!r}, not {LEAF_4!r}")
    faults = {e["it"]: e for e in events if e["type"] == "fault"}
    check(sorted(faults) == [3, 7, 12], f"12b fault events at "
          f"{sorted(faults)}")
    named = faults[7]["attribution"]["nonfinite_params"]
    check(named == [LEAF_4], f"12b fault at step 7 names {named}")
    bundles = [load_bundle(p) for p in find_bundles(tel_dir)]
    b7 = [b for b in bundles if b["trigger"]["it"] == 7]
    check(len(bundles) == 3 and b7 and b7[0]["attribution"][
        "nonfinite_params"] == [LEAF_4], f"12b flight-recorder bundles "
          f"{[b['trigger']['it'] for b in bundles]}")
    print(f"resilience 12b: faults {FAULTS_B} with ema_warmup 5: skipped "
          f"{rs.skipped_steps}, anomalies {rs.anomalies}, rollbacks "
          f"{rs.rollbacks}; every other loss finite, final parameters "
          f"finite; the step-7 fault event and its postmortem bundle name "
          f"{named} (leaf #4, the JAX package's path); {len(bundles)} "
          f"bundles; port kernel launches over 16 steps and the comm probe "
          f"{bcounts} {card}")
    manifest = events[0]
    comm = manifest["comm"]
    n_params = sum(x.numel() for x in tree_leaves(m259.tree()))
    check(comm["wire_bytes_per_device_per_step"] == 0.0
          and comm["payload_bytes_per_step"] == 4 * n_params + 4,
          f"12e world-1 comm profile {comm}")
    dcomm = dp_report["comm"]
    dgrad = dcomm["collectives"]["grad_allreduce"]
    n_canon = sum(x.numel() for x in tree_leaves(model.tree()))
    check(dgrad["payload_bytes"] == 4 * n_canon and dgrad["axis_size"] == 2
          and dgrad["wire_bytes_per_device"] == 4 * n_canon,
          f"12e phase 10's data=2 comm profile {dcomm}")
    pre = manifest["preflight"]
    check(pre["state_bytes"] == captured["state_bytes"], f"12e preflight "
          f"state bytes {pre['state_bytes']} vs the live state "
          f"{captured['state_bytes']}")
    nums = {e["it"]: e for e in events if e["type"] == "numerics"}
    batch0 = torch.as_tensor(next(shard_batches(tok, 3, 256, 0,
                                                shard_skip=5000, seed=0)),
                             dtype=torch.long, device=dev).reshape(3, 256)
    g0 = torch.autograd.grad(llama.forward_loss(m259, batch0, vcfg),
                             tree_leaves(m259.tree()))
    direct = math.sqrt(sum(float((g.double() ** 2).sum()) for g in g0))
    num_err = abs(nums[0]["grad_norm"] - direct) / direct
    check(num_err <= TOL_NUMERICS, f"12e numerics grad norm "
          f"{nums[0]['grad_norm']} vs recomputed {direct} (rel {num_err:.3g})")
    del m259, g0
    types = sorted({e["type"] for e in events})
    out["faults"] = {"counters": rs.as_dict(), "losses": faulted.losses,
                     "named_leaf": named, "bundles": len(bundles),
                     "launches": bcounts}
    out["telemetry"] = {
        "events": len(events), "types": types,
        "comm_world_1": comm, "comm_data_2": dcomm,
        "preflight": pre, "live_state_bytes": captured["state_bytes"],
        "measured_peak_bytes": peak, "allocated_before_bytes": base,
        "numerics_steps": sorted(nums), "numerics_grad_norm": nums[0][
            "grad_norm"], "numerics_recomputed": direct,
        "numerics_rel_err": num_err}
    print(f"telemetry 12e: {len(events)} events ({', '.join(types)}), "
          f"every one valid, span trees without orphans; comm per step at "
          f"world 1: payload {comm['payload_bytes_per_step']} B, wire "
          f"{comm['wire_bytes_per_device_per_step']:.0f} B (analytic: "
          f"{4 * n_params + 4} B of gradient and loss, 0 on the wire); phase "
          f"10's data=2 gradient step: grad_allreduce payload "
          f"{dgrad['payload_bytes'] / 1e6:.1f} MB fp32 per step ({dgrad['payload_bytes']} "
          f"B = 4 x {n_canon} parameters), wire "
          f"{dcomm['wire_bytes_per_device_per_step'] / 1e6:.1f} MB per "
          f"device; preflight state {pre['state_bytes']} B = the live "
          f"state's {captured['state_bytes']} B (params "
          f"{pre['params_bytes']}, optimizer {pre['opt_state_bytes']}, "
          f"window {pre['window_bytes']} int64), measured peak "
          f"{peak / 1e6:.1f} MB allocated over the run ({base / 1e6:.1f} MB "
          f"allocated before it); numerics at steps "
          f"{sorted(nums)}, step 0's grad norm {nums[0]['grad_norm']:.6f} vs "
          f"recomputed {direct:.6f} (rel {num_err:.3g}) {card}")

    # 12c: rollback after three consecutive bad steps.
    ck_c = os.path.join(tmp, "ck_c")
    rb = train_llm_dp(None, TrainConfig(optimizer="pallas", iters=9),
                      resilience=ResilienceConfig(),
                      fault_plan=FaultPlan.from_spec(
                          "nan_grad@6,nan_grad@7,nan_grad@8"),
                      checkpoint_dir=ck_c, checkpoint_every=5, **kw)
    check(rb.resilience.rollbacks == 1 and rb.resilience.skipped_steps == 3,
          f"12c counters {rb.resilience}")
    template = dp.init_state(llama.init_llama(
        vcfg, torch.Generator().manual_seed(0), device="cpu").tree(),
        bench_utils.make_optimizer("pallas"))
    ckpt = Checkpointer(ck_c)
    at5 = tree_leaves(ckpt.restore(template, step=5).params)
    at9 = tree_leaves(ckpt.restore(template, step=9).params)
    same = all(torch.equal(a, b) for a, b in zip(at5, at9))
    check(same, "12c parameters after the rollback differ from step 5's")
    print(f"resilience 12c: nan_grad at steps 6, 7, 8 with checkpoints "
          f"every 5: skipped {rb.resilience.skipped_steps}, rollbacks "
          f"{rb.resilience.rollbacks}; parameters after the rollback bitwise "
          f"the step-5 checkpoint's ({len(at5)} leaves) {card}")

    # 12d: preemption, then the second call completes the run.
    ck_d = os.path.join(tmp, "ck_d")
    first = train_llm_dp(None, tc10, fault_plan=FaultPlan.from_spec(
        "preempt@8"), checkpoint_dir=ck_d, checkpoint_every=1000, **kw)
    second = train_llm_dp(None, tc10, checkpoint_dir=ck_d,
                          checkpoint_every=1000, **kw)
    resumed = first.losses + second.losses
    pre_err = max(abs(a - b) for a, b in zip(resumed, plain.losses))
    check(first.preempted and not second.preempted
          and second.start_step == len(first.losses)
          and len(resumed) == tc10.iters and pre_err <= TOL_RESUME,
          f"12d preemption: {first.preempted} {second.start_step} "
          f"{len(resumed)} {pre_err}")
    out["rollback_bitwise"] = same
    out["preempt"] = {"stopped_at": len(first.losses),
                      "max_abs_err": pre_err}
    print(f"resilience 12d: preempt@8: the first call force-saved and "
          f"returned preempted after {len(first.losses)} steps; the second "
          f"resumed at {second.start_step} and completed; 10 losses vs the "
          f"uninterrupted run max|d| {pre_err:.3g} {card}")

    # 12f: rematerialized blocks at vocab 32000, B = 64 x 256, bf16.
    rcfg = tcfg.replace(remat=True)
    state, _, toks = bench_utils.build_train_step(tcfg, 64,
                                                  opt_name="pallas",
                                                  device=dev)
    leaves = tree_leaves(state.params)
    l0 = llama.forward_loss(state.params, toks, tcfg)
    gp = torch.autograd.grad(l0, leaves)
    l1 = llama.forward_loss(state.params, toks, rcfg)
    gr = torch.autograd.grad(l1, leaves)
    bitwise = l0.item() == l1.item() and all(torch.equal(a, b)
                                             for a, b in zip(gp, gr))
    r_loss = abs(l0.item() - l1.item())
    r_grad = max(((a.float() - b.float()).abs().max()
                  / b.float().abs().max()).item() for a, b in zip(gr, gp))
    check(bitwise or (r_loss <= TOL_TRAIN_LOSS_BF16
                      and r_grad <= TOL_TRAIN_GRAD_BF16),
          f"12f remat vs plain: loss |d| {r_loss:.3g}, grads {r_grad:.3g}")
    del state, toks, leaves, gp, gr, l0, l1
    # In turns (plain, remat, remat, plain): the host sets the pace and
    # drifts, so one run of each would compare the drift.
    runs = {"plain": [], "remat": []}
    peaks, bases, per = {}, {}, {}
    for name in ("plain", "remat", "remat", "plain"):
        c = rcfg if name == "remat" else tcfg
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        bases[name] = torch.cuda.memory_allocated(dev)
        zero_counts()
        runs[name].append(bench_utils.time_train_step(
            c, 64, seq=c.ctx_size, opt_name="pallas", warmup=2,
            timed_steps=5, device=dev))
        per[name] = {k: n / 7 for k, n in read_counts().items()}
        peaks[name] = torch.cuda.max_memory_allocated(dev)
        check(per[name] == (dict(want, flash_fwd=12) if name == "remat"
                            else want), f"12f {name} launches per step "
              f"{per[name]}")
    rates = {k: statistics.median(v) for k, v in runs.items()}
    out["remat"] = {"bitwise": bitwise, "loss_abs_err": r_loss,
                    "grad_rel_err": r_grad, "tokens_per_sec": rates,
                    "tokens_per_sec_runs": runs, "peak_bytes": peaks,
                    "allocated_before_bytes": bases,
                    "launches_per_step": per}
    print(f"remat 12f (vocab 32000, B=64 x 256, bf16): loss and {len(at5)} "
          f"gradient leaves {'bitwise equal' if bitwise else 'within the bf16 limits'} "
          f"(loss |d| {r_loss:.3g}, grads max|d|/max|ref| {r_grad:.3g}); "
          f"launches per step remat {per['remat']} vs plain {per['plain']}; "
          f"peak allocated {peaks['remat'] / 1e9:.2f} GB vs "
          f"{peaks['plain'] / 1e9:.2f} GB ({bases['remat'] / 1e9:.2f} / "
          f"{bases['plain'] / 1e9:.2f} GB allocated before each); tok/s "
          f"in turns plain {[round(x) for x in runs['plain']]}, remat "
          f"{[round(x) for x in runs['remat']]}: medians {rates['remat']:.0f} "
          f"vs {rates['plain']:.0f} ({rates['remat'] / rates['plain']:.3f}x) "
          f"{card}")

    # 12g: the serving memory census and compile counts; faulted FL.
    paged = PagedKVConfig(**SERVE_PAGED)
    wl = synthetic_workload(vocab_size=cfg.vocab_size, **SERVE_WL)

    def drive(memory_every, events):
        # Every request queued at time 0 and a clock that stands still:
        # the ticks, and so the batches, are the same in both runs.
        eng = Engine(model, cfg, paged, SERVE_SLOTS, prefill_chunk=16,
                     device=dev)
        sched = Scheduler(eng, events=events, clock=lambda: 0.0,
                          memory_every=memory_every)
        for r in wl:
            sched.submit(r, now=0.0)
        while sched.outstanding:
            sched.tick()
        return {k: r.tokens for k, r in sched.records.items()}, eng

    log = EventLog(os.path.join(tmp, "serve", "events.jsonl"))
    zero_counts()
    with_census, eng = drive(4, log)
    log.close()
    without, _ = drive(0, None)
    scounts = read_counts()
    streams_equal = with_census == without
    mem_events = [e for e in read_events(log.path) if e["type"] == "memory"]
    compiles = sum(len(w.compiles) for w in eng.watches())
    retraces = sum(w.retraces for w in eng.watches())
    check(streams_equal, "12g streams with the memory census differ")
    check(mem_events and all(validate_event(e) == [] for e in mem_events),
          f"12g memory events: {len(mem_events)}")
    check(compiles == 2 and retraces == 0, f"12g compiles {compiles}, "
          f"retraces {retraces}")
    check(not any(scounts.values()), f"12g serving launched port kernels "
          f"{scounts}")
    last = mem_events[-1]
    print(f"serving 12g: phase 5's 32 requests (all queued at once), "
          f"memory_every=4: {len(mem_events)} memory events, streams bitwise "
          f"those without the census; compiles {compiles} (prefill + "
          f"decode call signatures), retraces {retraces}; last census: "
          f"{last['blocks_in_use']} blocks in use, peak "
          f"{last['peak_blocks_in_use']}, holes {last['holes']}, CUDA "
          f"allocated {last.get('cuda_allocated_bytes', 0) / 1e6:.1f} MB "
          f"{card}")
    x, y, xt, yt = mnist_arrays
    fcfg = FLConfig()
    subsets = mnist.split(y, fcfg.nr_clients, iid=True, seed=fcfg.seed)
    fparams = mnist_cnn.init(torch.Generator().manual_seed(FL_INIT_SEED),
                             device=dev)

    def no_dropout(p, xb):
        return mnist_cnn.apply(p, xb)

    runs = {}
    for where in ("cuda", "cpu"):
        d = dev if where == "cuda" else torch.device("cpu")
        ftel = Telemetry(os.path.join(tmp, f"fl-{where}"))
        server = fl.FedAvgServer(fparams, no_dropout,
                                 fl.federate(x, y, subsets, device=d), xt,
                                 yt, fcfg, device=d,
                                 fault_plan=FaultPlan.from_spec(
                                     "drop_client@0:2"), telemetry=ftel)
        t0 = time.perf_counter()
        server.run(2)
        runs[where] = (server, time.perf_counter() - t0)
        ftel.close()
    fl_err = max(((a.cpu() - b).abs().max() / b.abs().max()).item()
                 for a, b in zip(tree_leaves(runs["cuda"][0].params),
                                 tree_leaves(runs["cpu"][0].params)))
    fl_events = read_events(os.path.join(tmp, "fl-cuda", "events.jsonl"))
    rounds = [e for e in fl_events if e["type"] == "fl_round"]
    srv = runs["cuda"][0]
    check(len(rounds) == 2 and rounds[0]["faults"] == {"dropped_clients": 2},
          f"12g fl_round events {rounds}")
    check(srv.resilience.dropped_clients == 2, f"12g FL {srv.resilience}")
    check(math.isfinite(fl_err) and fl_err <= TOL_FL_DEVICE,
          f"12g faulted FedAvg card vs CPU max|d|/max|ref|={fl_err:.3g}")
    out["serving"] = {"memory_events": len(mem_events),
                      "streams_bitwise": streams_equal,
                      "compiles": compiles, "retraces": retraces}
    out["fl"] = {"max_rel_err": fl_err, "rounds": len(rounds),
                 "accuracy": srv.result.test_accuracy,
                 "wall_s_card": runs["cuda"][1],
                 "wall_s_cpu": runs["cpu"][1]}
    print(f"fl 12g: 2 FedAvg rounds at phase 8's configuration with "
          f"drop_client@0:2 (dropout off): 2 fl_round events, 2 clients "
          f"dropped in round 0; card vs CPU max|d|/max|ref| {fl_err:.3g}; "
          f"accuracy {srv.result.test_accuracy} {card}")
    shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"resilience/telemetry phase: {out['seconds']:.1f} s {card}")
    return out


# ------------------------------------------------------------- phase 13

# Phase 13 (pipeline parallelism): each schedule's gradient against the
# world of one within the kernel limits (fp32), b1's losses within the JAX
# package's own PP-vs-DP bar (tests/test_dp.py::
# test_train_llm_pp_matches_dp), and each kernel's launches per stage per
# step at S = 3 (2 layers per stage) and M microbatches: the forward twice
# per microbatch under 1F1B (its backward recomputes the stage).
TOL_PP_GRAD = 1e-4
TOL_PP_VS_DP = 2e-4


def pp_launches(schedule: str, m: int) -> dict:
    fwd = 2 * m * (2 if schedule == "1f1b" else 1)
    return {"flash_fwd": fwd, "flash_bwd_dq": 2 * m, "flash_bwd_dkv": 2 * m,
            "adam": 1}


def pp_phase(dev: torch.device, card: str, dp_losses) -> dict:
    """Phase 13: three stage processes on the one card (one
    ``programs.phase13`` launch) and six for the 2 × 3 topology
    (``programs.phase13_b2``). ``dp_losses``: phase 7's ``train_llm_dp``
    losses, the stream b1 reads. Raises on a failed check; returns the
    numbers."""
    from ddl25spring_tpu_torch.parallel import distributed, programs

    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(13)
    tokens_check = torch.randint(0, 32000, (12, 256), generator=gen).numpy()
    tokens_time = torch.randint(0, 32000, (48, 256), generator=gen).numpy()
    with tempfile.TemporaryDirectory() as d:
        ranks = distributed.run_ranks(programs.phase13, 3, tokens_check,
                                      tokens_time, d, device=None,
                                      timeout=900)
    out = {"ranks": [{k: v for k, v in r.items() if k != "hop"}
                     for r in ranks], "hop": ranks[0]["hop"]}
    # a. fp32, B=12 x 256, M=3: every stage's gradient vs the world of one.
    for sched in programs.PP_SCHEDULES:
        errs = [r["check"][sched]["grad_rel_err"] for r in ranks]
        loss_err = max(abs(r["check"][sched]["pp_loss"]
                           - r["check"][sched]["loss"]) for r in ranks)
        check(max(errs) <= TOL_PP_GRAD and loss_err <= TOL_PP_GRAD,
              f"pp {sched} fp32 vs world of one: loss |d| {loss_err:.3g}, "
              f"grads max|d|/max|ref| per stage {errs} > {TOL_PP_GRAD}")
        print(f"pp {sched} fp32 B=12 M=3 S=3 vs world of one on the card: "
              f"loss {ranks[0]['check'][sched]['pp_loss']:.6f} |d| "
              f"{loss_err:.3g}, grads max|d|/max|ref| per stage "
              f"{[f'{e:.3g}' for e in errs]}; launches per stage "
              f"{[r['check'][sched]['launches'] for r in ranks]} {card}")
    # b. bf16, B=48 x 256, M=6: ms per step in turns, launches, the hop.
    for sched in programs.PP_SCHEDULES:
        want = pp_launches(sched, 6)
        got = [r["timing"][sched]["launches"] for r in ranks]
        check(all(g == want for g in got), f"pp {sched} launches per stage "
              f"per step {got}, expected {want}")
        losses = ranks[0]["timing"][sched]["losses"]
        check(all(math.isfinite(x) for x in losses),
              f"pp {sched} bf16 losses {losses}")
        t = ranks[0]["timing"][sched]
        print(f"pp {sched} bf16 B=48 x 256 M=6 S=3: "
              f"{t['ms_per_step']:.2f} ms per step (median of 3 turns of 5 "
              f"steps: {[round(x, 2) for x in t['ms_per_step_turns']]}), "
              f"{48 * 256 / t['ms_per_step'] * 1e3:.0f} tok/s; launches per "
              f"stage per step {want}; loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f} {card}")
    hop = out["hop"]
    print(f"pp hop (stage 0 -> 1, [8, 256, 288] bf16, {hop['bytes']} B, "
          f"device->host, gloo over loopback, host->device): "
          f"{hop['hop_ms']:.3f} ms one way (half the median round trip); "
          f"device->host copy {hop['d2h_ms']:.3f} ms, host->device "
          f"{hop['h2d_ms']:.3f} ms {card}")
    # c. the homework's topologies through train_llm_pp at vocab 259.
    b1 = ranks[0]["b1"]
    for r in ranks:
        check(r["b1"]["losses"] == b1["losses"], "b1 ranks disagree on the "
              "losses")
        check(r["b1"]["launches"] == pp_launches("gpipe", 3),
              f"b1 stage {r['stage']} launches per step "
              f"{r['b1']['launches']}")
    ls = b1["losses"]
    check(len(ls) == 20 and all(math.isfinite(x) for x in ls)
          and ls[-1] < ls[0], f"b1 losses {ls}")
    vs_dp = max(abs(a - b) for a, b in zip(ls, dp_losses))
    check(vs_dp <= TOL_PP_VS_DP, f"b1 vs train_llm_dp max|d| {vs_dp:.3g} > "
          f"{TOL_PP_VS_DP}")
    print(f"pp b1 train_llm_pp(stage=3, microbatches=3), vocab 259, batch 3 "
          f"x 256: {ls[0]:.4f} -> {ls[-1]:.4f} in 20 steps "
          f"({b1['seconds']:.1f} s, {b1['tokens_per_sec']:.0f} tok/s after "
          f"warmup), max|d| vs train_llm_dp (phase 7) {vs_dp:.3g}; launches "
          f"per stage per step {b1['launches']} {card}")
    t0 = time.perf_counter()
    b2 = distributed.run_ranks(programs.phase13_b2, 6, device=None,
                               timeout=600)
    b2_s = time.perf_counter() - t0
    for r in b2:
        check(r["losses"] == b2[0]["losses"], "b2 ranks disagree")
        check(r["launches"] == pp_launches("gpipe", 3),
              f"b2 rank {r['rank']} launches per step {r['launches']}")
    ls2 = b2[0]["losses"]
    check(len(ls2) == 20 and all(math.isfinite(x) for x in ls2)
          and ls2[-1] < ls2[0], f"b2 losses {ls2}")
    out["b2"] = b2
    print(f"pp b2 train_llm_pp(data=2, stage=3, microbatches=3): "
          f"{ls2[0]:.4f} -> {ls2[-1]:.4f} in 20 steps ({b2_s:.1f} s with "
          f"the launch of 6 processes, {b2[0]['tokens_per_sec']:.0f} tok/s "
          f"after warmup); launches per rank per step {b2[0]['launches']} "
          f"{card}")
    # d. exactness: K-step, resume, a fault skipped on every rank.
    r0 = ranks[0]
    check(r0["kstep_losses"] == ls[:8], f"pp K=4 losses "
          f"{r0['kstep_losses']} != per-step {ls[:8]}")
    check(r0["resumed"]["start"] == 10 and r0["resumed"]["losses"] == ls,
          f"pp resume {r0['resumed']} != {ls}")
    for r in ranks:
        f = r["fault"]
        check(f["resilience"]["skipped_steps"] == 1
              and math.isnan(f["losses"][3])
              and all(math.isfinite(x) for i, x in enumerate(f["losses"])
                      if i != 3) and f["losses"][:3] == ls[:3],
              f"pp fault on stage {r['stage']}: {f}")
    print(f"pp exactness: K=4 losses bitwise per-step; 10 steps resumed to "
          f"20 bitwise the uninterrupted run; nan_grad@3 skipped on every "
          f"stage ({[r['fault']['resilience']['skipped_steps'] for r in ranks]}"
          f" skips) {card}")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"pp phase: {out['seconds']:.1f} s (stage processes "
          f"{[round(r['seconds'], 1) for r in ranks]} s) {card}")
    return out


# Phase 14 (fleet-scale FL and the autoscaler's serving side).
FLEET_WIDTH = 4                # homework 1's 10 clients as cohorts of 4, 4, 2
TOL_FLEET_RAGGED = 1e-6        # streamed vs vmapped, of each leaf's largest
TOL_FLEET_DP = 1e-6            # z = 0 against the clip-only round, likewise
FLEET_ROUNDS = 10
# 14c's one round (100,000 through PR 16; cut for the 1,200-s limit).
FLEET_SMOKE_CLIENTS = 25_000
FLEET_KRUM = dict(n_malicious=2, k=6)
FLEET_DP_CLIP = 1.0
FLEET_PROFILE_CLIENTS = 2048   # the profiled slice of the 100k round
# 14d: a load that rises and ebbs over 11 control ticks (peak 24 requests
# a tick), served on a tick clock (dt 0.05 s per fleet tick, 1 s between
# control ticks): TTFT counts queueing ticks, so the decisions do not
# depend on the host's or the card's speed.
SCALE_TICKS = 11
SCALE_PEAK = 24
SCALE_PROMPT, SCALE_MAX_NEW = 16, 8
SCALE_DT = 0.05
SCALE_POLICY = dict(ttft_slo_s=1.0, pressure_frac=0.8, ebb_frac=0.3,
                    sustain=2, cooldown=2, min_train_world=3,
                    max_train_world=4, min_serve_engines=1,
                    max_serve_engines=2, min_headroom_frac=0.1)


def _leaf_rel(a: dict, b: dict) -> float:
    """Largest |a − b| of a leaf over that leaf's largest |b|."""
    from ddl25spring_tpu_torch.tree import tree_leaves
    return max(((x - y).abs().max() / y.abs().max()).item()
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _bitwise(a: dict, b: dict) -> bool:
    from ddl25spring_tpu_torch.tree import tree_leaves
    return all(bool(torch.equal(x, y))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


@contextlib.contextmanager
def cudnn_mode(*, enabled: bool = True, deterministic: bool = False):
    """cuDNN switched on or off, or kept to its deterministic algorithms,
    inside the block (the previous settings restored after)."""
    saved = torch.backends.cudnn.enabled, torch.backends.cudnn.deterministic
    torch.backends.cudnn.enabled = enabled
    torch.backends.cudnn.deterministic = deterministic
    try:
        yield
    finally:
        torch.backends.cudnn.enabled, torch.backends.cudnn.deterministic = \
            saved


def fleet_phase(dev: torch.device, card: str, mnist_arrays) -> dict:
    """Phase 14 a-c: homework 1's FedAvg through the fleet engine (against
    ``FedAvgGradServer`` on the card), its tiers (edge Multi-Krum, secure
    aggregation, DP), and ``fleet_smoke``'s 25,000-client round. Raises on
    a failed check; returns the numbers for the JSON record."""
    from ddl25spring_tpu_torch import fl, profile_step
    from ddl25spring_tpu_torch.config import FLConfig
    from ddl25spring_tpu_torch.data import mnist
    from ddl25spring_tpu_torch.device import fp32_products
    from ddl25spring_tpu_torch.experiments import fleet_smoke
    from ddl25spring_tpu_torch.fl import defenses
    from ddl25spring_tpu_torch.models import mnist_cnn
    from ddl25spring_tpu_torch.telemetry import (Telemetry, read_events,
                                                 tree_bytes, validate_event)
    from ddl25spring_tpu_torch.tree import tree_leaves, tree_sub

    x, y, xt, yt = mnist_arrays
    cfg = FLConfig()
    m = cfg.clients_per_round
    host_data = fl.federate(x, y, mnist.split(y, cfg.nr_clients, iid=True,
                                              seed=cfg.seed), device="cpu")
    data = host_data.to(dev)
    source = fl.FederatedArraySource(host_data)
    params = mnist_cnn.init(torch.Generator().manual_seed(FL_INIT_SEED),
                            device=dev)
    out: dict = {}

    def fleet(width=FLEET_WIDTH, edges=1, **kw):
        return fl.FleetFedAvgServer(
            params, mnist_cnn.apply, source, xt, yt, cfg,
            fl.FleetConfig(cohort_width=width, edges=edges, **kw),
            device=dev)

    def round0(server):
        with torch.no_grad(), fp32_products():
            out = server._round(server.params, 0)
        torch.cuda.synchronize()
        return out

    # 14a: round 0 against FedAvgGradServer from the same parameters. On
    # cuDNN a round is not reproducible (its default algorithms), and its
    # deterministic algorithms differ with the convolution's group count,
    # which vmap sets to the cohort's width: both measured and printed.
    # The bars are held on PyTorch's own convolutions (cuDNN off), whose
    # per-group products do not depend on the group count.
    ref_server = fl.FedAvgGradServer(params, mnist_cnn.apply, data, xt, yt,
                                     cfg, device=dev)
    cudnn = {"default_rerun": _leaf_rel(round0(ref_server),
                                        round0(ref_server))}
    with cudnn_mode(deterministic=True):
        dref = round0(ref_server)
        cudnn["deterministic_rerun_bitwise"] = _bitwise(round0(ref_server),
                                                        dref)
        cudnn["deterministic_w10_bitwise"] = _bitwise(round0(fleet(width=m)),
                                                      dref)
        cudnn["deterministic_w4"] = _leaf_rel(round0(fleet()), dref)
    with cudnn_mode(enabled=False):
        ref = round0(ref_server)
        ref_again = round0(ref_server)
        servers = {"w10": fleet(width=m), "w4": fleet(),
                   "w4_e2": fleet(edges=2)}
        got = {k: round0(s) for k, s in servers.items()}
    equal = {"reference_rerun": _bitwise(ref_again, ref)}
    rel = {k: _leaf_rel(v, ref) for k, v in got.items()}
    equal.update({k: _bitwise(v, ref) for k, v in got.items()})
    check(equal["reference_rerun"], "14a FedAvgGradServer's round 0 "
          "differs between two runs")
    check(equal["w10"], f"14a fleet at cohort width {m} (the server's "
          f"shapes) is not bitwise FedAvgGradServer's round: max|d|/max|ref| "
          f"{rel['w10']:.3g}")
    for k in ("w4", "w4_e2"):
        check(rel[k] <= TOL_FLEET_RAGGED, f"14a fleet {k}: max|d|/max|ref| "
              f"{rel[k]:.3g} > {TOL_FLEET_RAGGED}")
    out["round0"] = {"bitwise": equal, "max_rel_diff": rel, "cudnn": cudnn}
    print(f"fleet 14a round 0 against FedAvgGradServer (homework 1, 10 "
          f"clients, dropout live, cuDNN off): width {m} bitwise "
          f"{equal['w10']}; width {FLEET_WIDTH} (cohorts 4, 4, 2) bitwise "
          f"{equal['w4']}, max|d|/max|ref| {rel['w4']:.3g}; E=2 bitwise "
          f"{equal['w4_e2']}, {rel['w4_e2']:.3g} (bar {TOL_FLEET_RAGGED}); "
          f"the reference against itself bitwise {equal['reference_rerun']}. "
          f"On cuDNN: its default algorithms' rerun "
          f"{cudnn['default_rerun']:.3g} apart; its deterministic ones: "
          f"rerun bitwise {cudnn['deterministic_rerun_bitwise']}, width {m} "
          f"bitwise {cudnn['deterministic_w10_bitwise']}, width "
          f"{FLEET_WIDTH} {cudnn['deterministic_w4']:.3g} {card}")

    # Ten rounds of each, the fleet observed.
    with tempfile.TemporaryDirectory() as tmp:
        tel = Telemetry(tmp)
        f10 = fl.FleetFedAvgServer(
            params, mnist_cnn.apply, source, xt, yt, cfg,
            fl.FleetConfig(cohort_width=FLEET_WIDTH), telemetry=tel,
            device=dev)
        fres = f10.run(FLEET_ROUNDS)
        tel.close()
        events = read_events(tel.events_path, strict=True)
    gserver = fl.FedAvgGradServer(params, mnist_cnn.apply, data, xt, yt, cfg,
                                  device=dev)
    gres = gserver.run(FLEET_ROUNDS)
    bar = FL_JAX_FEDAVG_ACC - FL_ACC_MARGIN
    acc = fres.test_accuracy[-1]
    check(acc >= bar, f"14a fleet FedAvg after {FLEET_ROUNDS} rounds: "
          f"accuracy {acc:.4f} < {bar:.4f}")
    delta_bytes = tree_bytes(params)
    cohorts = [e for e in events if e["type"] == "fl_cohort"]
    tiers = [e for e in events if e["type"] == "fl_tier"]
    sizes = [4, 4, 2] * FLEET_ROUNDS
    check([e["clients"] for e in cohorts] == sizes
          and all(e["payload_bytes"] == e["clients"] * delta_bytes
                  for e in cohorts), f"14a fl_cohort events "
          f"{[(e['clients'], e['payload_bytes']) for e in cohorts]}")
    check(len(tiers) == 2 * FLEET_ROUNDS and all(
        e["payload_bytes"] == (m if e["tier"] == "edge" else 1) * delta_bytes
        for e in tiers), "14a fl_tier events")
    check(all(validate_event(e) == [] for e in events), "14a events invalid")
    watches = [s._stream_step for s in (*servers.values(), f10)]
    check(all(w.retraces == 0 and len(w.compiles) == 1 for w in watches),
          f"14a cohort step retraces "
          f"{[(w.retraces, len(w.compiles)) for w in watches]}")
    fleet_ms = [t * 1e3 for t in fres.wall_time]
    grad_ms = [t * 1e3 for t in gres.wall_time]
    out["ten_rounds"] = {
        "accuracy": fres.test_accuracy, "bar": bar,
        "reaches_jax_0_7335": acc >= FL_JAX_FEDAVG_ACC,
        "ms_per_round": fleet_ms,
        "median_ms": statistics.median(fleet_ms),
        "fedavg_grad_server_accuracy": gres.test_accuracy,
        "fedavg_grad_server_ms_per_round": grad_ms,
        "fedavg_grad_server_median_ms": statistics.median(grad_ms),
        "fl_cohort_events": len(cohorts), "fl_tier_events": len(tiers),
        "payload_bytes_per_client": delta_bytes}
    print(f"fleet 14a {FLEET_ROUNDS} rounds at width {FLEET_WIDTH}: accuracy "
          f"{[round(a, 4) for a in fres.test_accuracy]} (bar {bar:.4f}; "
          f"FedAvgGradServer {gres.test_accuracy[-1]:.4f}); ms per round "
          f"median {statistics.median(fleet_ms):.1f} (first "
          f"{fleet_ms[0]:.1f}) against FedAvgGradServer's "
          f"{statistics.median(grad_ms):.1f} (first {grad_ms[0]:.1f}); "
          f"{len(cohorts)} fl_cohort and {len(tiers)} fl_tier events, "
          f"{delta_bytes} payload bytes per client; retraces 0 {card}")
    del f10, gserver

    # 14b: the tiers at the same configuration (cuDNN off, as 14a).
    with cudnn_mode(enabled=False):
        picks = {"fleet": [], "server": []}

        def recording(into):
            def rule(flat, n_malicious, k):
                sel = defenses.multi_krum(flat, n_malicious, k)
                picks[into].append(sorted(int(i) for i in sel))
                return sel
            return defenses.selection_defense(rule, **FLEET_KRUM)

        kfleet = fleet(edge=fl.TierPolicy(defense=recording("fleet")))
        kserver = fl.FedAvgGradServer(params, mnist_cnn.apply, data, xt, yt,
                                      cfg, defense=recording("server"),
                                      device=dev)
        krel = _leaf_rel(round0(kfleet), round0(kserver))
        check(picks["fleet"] == picks["server"], f"14b edge Multi-Krum picked "
              f"{picks['fleet']}, FedAvgGradServer {picks['server']}")
        check(krel <= TOL_FLEET_RAGGED, f"14b Multi-Krum round "
              f"max|d|/max|ref| {krel:.3g}")

        clip, bits = 5.0, 20
        secure = fl.SecureAggFedAvgServer(params, mnist_cnn.apply, data, xt,
                                          yt, cfg, clip_norm=clip, bits=bits,
                                          device=dev)
        sref = round0(secure)
        sa = {w: round0(fleet(width=w, weighting="uniform",
                              edge=fl.TierPolicy(secure_agg=(clip, bits))))
              for w in (m, FLEET_WIDTH)}
        quantum = fl.secure_agg.secagg_scale(clip, bits)
        sa_quanta = max(((a - b).abs().max() / quantum).item() for a, b in
                        zip(tree_leaves(sa[FLEET_WIDTH]), tree_leaves(sref)))
        check(_bitwise(sa[m], sref), "14b secure-aggregation edge at E=1 is "
              "not bitwise SecureAggFedAvgServer's round")

        dp_clean = round0(fl.DPFedAvgServer(params, mnist_cnn.apply, data, xt,
                                            yt, cfg, clip_norm=FLEET_DP_CLIP,
                                            device=dev))
        dp0 = round0(fleet(weighting="uniform",
                           edge=fl.TierPolicy(dp_clip=FLEET_DP_CLIP)))
        dp_rel = _leaf_rel(dp0, dp_clean)
        check(dp_rel <= TOL_FLEET_DP, f"14b DP edge at z=0 max|d|/max|ref| "
              f"{dp_rel:.3g} > {TOL_FLEET_DP}")
        dp1 = round0(fleet(weighting="uniform", edge=fl.TierPolicy(
            dp_clip=FLEET_DP_CLIP, dp_noise_multiplier=1.0)))
        noise = torch.cat([(a - b).reshape(-1) for a, b in
                           zip(tree_leaves(dp1), tree_leaves(dp0))])
        sigma = 1.0 * FLEET_DP_CLIP / m
        std = noise.std().item()
        check(abs(std / sigma - 1) <= TOL_NOISE_STD, f"14b DP noise std "
              f"{std:.5g} vs σ {sigma}")
        probe = fleet(edges=2, weighting="uniform")
        draws = [torch.randn(4096, generator=probe._noise_generator(0, t, e),
                             device=dev) for t, e in ((0, 0), (0, 1), (1, 0))]
        distinct = all(not torch.equal(draws[i], draws[j])
                       for i in range(3) for j in range(i + 1, 3))
        check(distinct, "14b DP noise streams of the tiers and edges coincide")
    out["tiers"] = {"krum_selection": picks["fleet"][0],
                    "krum_max_rel_diff": krel,
                    "secagg_bitwise_width_10": True,
                    "secagg_width_4_max_quanta": sa_quanta,
                    "secagg_width_4_bitwise": _bitwise(sa[FLEET_WIDTH], sref),
                    "dp_z0_max_rel_diff": dp_rel, "dp_z1_noise_std": std,
                    "dp_sigma": sigma, "noise_streams_distinct": distinct}
    print(f"fleet 14b: edge Multi-Krum (f=2, k=6) picked {picks['fleet'][0]} "
          f"as FedAvgGradServer did (round max|d|/max|ref| {krel:.3g}); "
          f"secure aggregation at E=1, width {m}, bitwise "
          f"SecureAggFedAvgServer's round (width {FLEET_WIDTH}: "
          f"{sa_quanta:.3g} quanta apart); DP edge z=0 {dp_rel:.3g} from "
          f"DPFedAvgServer's clip-only round, z=1 noise std {std:.5g} vs σ "
          f"{sigma}; tier and edge streams distinct {card}")

    # 14c: fleet_smoke's 25,000-client round, and a profiled slice.
    t0 = time.perf_counter()
    smoke = fleet_smoke.run(fleet_smoke.parse_args(
        ["--clients", str(FLEET_SMOKE_CLIENTS)]))
    smoke["phase_s"] = time.perf_counter() - t0
    failed = [k for k, v in smoke["checks"].items() if not v]
    check(not failed, f"14c fleet_smoke failed {failed}: "
          f"{json.dumps(smoke)}")
    pcfg = FLConfig(nr_clients=FLEET_PROFILE_CLIENTS, client_fraction=1.0,
                    batch_size=8, epochs=1, lr=0.5, seed=0)
    psrc = fl.SyntheticFleetSource(FLEET_PROFILE_CLIENTS, features=64,
                                   classes=16)
    pserver = fl.FleetFedAvgServer(
        fleet_smoke.init_params(64, 0, dev), fleet_smoke.apply_fn, psrc,
        *psrc.test_set(64), pcfg, fl.FleetConfig(cohort_width=64),
        device=dev)
    round0(pserver)
    prof = profile_step.trace(lambda: round0(pserver), 1)
    smoke["profiled_slice"] = {"clients": FLEET_PROFILE_CLIENTS, **prof}
    out["fleet_smoke"] = smoke
    print(f"fleet 14c fleet_smoke: {smoke['clients']} clients in one round, "
          f"{smoke['round_wall_s']:.2f} s, {smoke['clients_per_s']:.0f} "
          f"clients/s, host share (client data and generators) "
          f"{smoke['host_share']:.3f}; device memory growth "
          f"{smoke['memory_growth_bytes']} B (bar "
          f"{smoke['memory_bound_bytes']} B: four cohorts and the "
          f"parameters) against {smoke['naive_resident_mb']:.1f} MB all at "
          f"once; control slice "
          f"bitwise at equal shapes, ragged width bitwise "
          f"{smoke['control_ragged_bitwise']} "
          f"({smoke['control_ragged_rel_diff']:.3g}); E=8 "
          f"{smoke['hierarchical_max_diff']:.3g}; Krum probe "
          f"{smoke['krum_probe']}; profiled {FLEET_PROFILE_CLIENTS}-client "
          f"round: {prof['kernel_ms_per_step']:.1f} ms of kernels in "
          f"{prof['profiled_wall_ms_per_step']:.1f} ms, busy share "
          f"{prof['profiled_busy_share']:.3f}, "
          f"{prof['kernels_per_step']:.0f} launches {card}")
    return out


def autoscale_drive(dev: torch.device, params, cfg, events=None) -> dict:
    """The autoscaler's serving side (phase 14d) on ``dev``: phase 11f's two
    engines on phase 5's pool, one active at first, under SCALE_TICKS
    control ticks of a rising and ebbing load on a tick clock. Each tick
    serves its arrivals to completion, reads the router's p95 TTFT and the
    post-move pool headroom, and applies the decision with ``set_active``;
    ``train_world`` is only counted."""
    import numpy as np

    from ddl25spring_tpu_torch.resilience import (Autoscaler, AutoscalePolicy,
                                                  router_ttft_p95)
    from ddl25spring_tpu_torch.serving import (PagedKVConfig, Request,
                                               ServingFleet)

    class TickClock:
        def __init__(self):
            self.t = 0.0

        def __call__(self):
            return self.t

    clock = TickClock()
    fleet = ServingFleet(params, cfg, PagedKVConfig(**SERVE_PAGED),
                         num_engines=2, num_slots=SERVE_SLOTS,
                         prefill_chunk=16, events=events, token_events=False,
                         clock=clock, window_s=2.0, device=dev)
    fleet.set_active(1)
    scaler = Autoscaler(AutoscalePolicy(**SCALE_POLICY), train_world=4,
                        serve_engines=1, events=events, log_fn=None)
    curve = [max(0, round(SCALE_PEAK / 2 * (1 + math.sin(
        2 * math.pi * i / SCALE_TICKS)))) for i in range(SCALE_TICKS)]
    g = np.random.default_rng(7)
    reqs = [Request(rid=f"s{i}", prompt=tuple(int(t) for t in g.integers(
        1, cfg.vocab_size, SCALE_PROMPT)), max_new=SCALE_MAX_NEW)
        for i in range(sum(curve))]
    arrivals = iter(reqs)
    p95s = []
    for i, n in enumerate(curve):
        clock.t += 1.0
        for _ in range(n):
            fleet.submit(next(arrivals), now=clock())
        while fleet.outstanding:
            fleet.tick()
            clock.t += SCALE_DT
        fleet.router.harvest(clock())
        p95 = router_ttft_p95(fleet.router)
        p95s.append(p95)
        d = scaler.tick(p95, it=i, headroom_frac=fleet.pool_headroom(
            min(scaler.serve_engines + 1, 2)))
        if d is not None:
            fleet.set_active(d.serve_engines)
    return {"curve": curve, "p95": p95s,
            "decisions": [tuple(d) for d in scaler.decisions],
            "requests": reqs, "records": fleet.records,
            "engine_of": dict(fleet.engine_of),
            "retraces": fleet.retraces()}


def autoscale_phase(dev: torch.device, card: str, model, cfg) -> dict:
    """Phase 14d: ``autoscale_drive`` on the card and on the CPU. Raises on a
    failed check; returns the numbers for the JSON record."""
    from ddl25spring_tpu_torch.models import llama
    from ddl25spring_tpu_torch.serving import PagedKVConfig
    from ddl25spring_tpu_torch.telemetry import (EventLog, read_events,
                                                 validate_event)
    from ddl25spring_tpu_torch.tree import tree_map

    with tempfile.TemporaryDirectory() as tmp:
        log = EventLog(os.path.join(tmp, "events.jsonl"))
        t0 = time.perf_counter()
        run = autoscale_drive(dev, model, cfg, log)
        card_s = time.perf_counter() - t0
        log.close()
        scale_events = [e for e in read_events(log.path, strict=True)
                        if e["type"] == "scale"]
    t0 = time.perf_counter()
    cpu = autoscale_drive(torch.device("cpu"),
                          tree_map(lambda t: t.cpu(), llama.as_tree(model)),
                          cfg)
    cpu_s = time.perf_counter() - t0
    directions = [d[0] for d in run["decisions"]]
    check("train_to_serve" in directions and "serve_to_train" in directions,
          f"14d decisions {run['decisions']} move only one way")
    check(run["decisions"] == cpu["decisions"], f"14d decisions on the card "
          f"{run['decisions']} differ from the CPU's {cpu['decisions']}")
    check(len(scale_events) == len(run["decisions"]) and all(
        validate_event(e) == [] for e in scale_events), "14d scale events")
    recs = run["records"]
    check(len(recs) == len(run["requests"]), f"14d served {len(recs)} of "
          f"{len(run['requests'])}")
    check(set(run["engine_of"].values()) == {0, 1}, "14d one engine only")
    check(all(r == 0 for r in run["retraces"]), "14d engine retraces")
    exact, near = greedy_bar(dev, model, cfg, PagedKVConfig(**SERVE_PAGED),
                             run["requests"],
                             {k: r.tokens for k, r in recs.items()}, {},
                             "14d")
    out = {"curve": run["curve"],
           "p95_ttft_s": run["p95"], "p95_ttft_s_cpu": cpu["p95"],
           "decisions": run["decisions"], "decisions_cpu": cpu["decisions"],
           "requests": len(recs), "greedy_exact": exact,
           "greedy_near_tie": near, "card_s": card_s, "cpu_s": cpu_s}
    print(f"autoscale 14d: {len(recs)} requests over {SCALE_TICKS} control "
          f"ticks (arrivals {run['curve']}), p95 TTFT (tick clock, s) "
          f"{[None if v is None else round(v, 3) for v in run['p95']]}; "
          f"decisions {run['decisions']}, the CPU's {cpu['decisions']}; "
          f"greedy {exact} exact {near} near-tie of {len(recs)}; "
          f"{len(scale_events)} scale events valid; {card_s:.1f} s on the "
          f"card, {cpu_s:.1f} s on the CPU {card}")
    return out


# ------------------------------------------------------------- phase 15

# Phase 15 (compressed and overlapped gradient sync): the fp32 ring step
# against a world of one as phase 10 holds the plain step; the DCN tier's
# bytes per step against the flat fp32 all-reduce's (the JAX smoke's
# budget).
TOL_RING_LOSS = 1e-5
TOL_RING_GRAD = 1e-5
DCN_BUDGET = 0.30


def _k7_eligible(n_elements: int) -> bool:
    """Whether a ZeRO-1 slice of ``n_elements`` takes the Adam kernel
    (``pallas_adam._pallas_eligible``'s size rule)."""
    return n_elements >= 65536 and n_elements % 512 == 0


def comm_phase(dev: torch.device, card: str) -> dict:
    """Phase 15: two ranks (``programs.phase15_two``) and a 2 × 2 layout of
    four (``programs.phase15_four``) on the card, against a world of one
    computed here. Raises on a failed check; returns the numbers for the
    JSON record."""
    from ddl25spring_tpu_torch import bench_utils
    from ddl25spring_tpu_torch.config import LlamaConfig
    from ddl25spring_tpu_torch.models import llama
    from ddl25spring_tpu_torch.parallel import distributed, programs
    from ddl25spring_tpu_torch.tree import tree_leaves

    t0 = time.perf_counter()
    kcfg = LlamaConfig(attention_impl="pallas", flash_dh_major=True)
    g15 = torch.Generator()
    g15.manual_seed(15)
    toks = torch.randint(0, kcfg.vocab_size, (5, 8, kcfg.ctx_size),
                         generator=g15)
    m1 = llama.init_llama(kcfg, torch.Generator().manual_seed(0), device=dev)
    l1 = llama.forward_loss(m1, toks[0].to(dev), kcfg)
    ref_grads = [g.cpu() for g in torch.autograd.grad(
        l1, tree_leaves(m1.tree()))]
    ref_loss = l1.item()
    del m1, l1
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        two = distributed.run_ranks(programs.phase15_two, 2, toks.numpy(),
                                    tmp, timeout=900)
    with tempfile.TemporaryDirectory() as tmp:
        four = distributed.run_ranks(programs.phase15_four, 4, tmp,
                                     timeout=900)
    phase_s = time.perf_counter() - t0
    r0, q0 = two[0], four[0]

    # a. the rings at full size -------------------------------------------
    for rk in two + four:
        rings = rk["rings"]
        for wire, rec in rings["flat"].items():
            check(rec["bitwise"] and rec.get("residual", {"bitwise": True})
                  ["bitwise"], f"ring {wire} rank {rk['rank']} of "
                  f"{len(two) if rk in two else 4} vs the spec: {rec}")
        for lay, rec in rings["hier"].items():
            check(rec["bitwise"] and rec["residual"]["bitwise"]
                  and rec.get("flat_bitwise", True),
                  f"hier_reduce_scatter {lay} rank {rk['rank']}: {rec}")
    for world, rk in ((2, r0), (4, q0)):
        rg = rk["rings"]
        chunk_mb = 4 * rg["elements"] / world / 1e6
        print(f"ring_reduce_scatter at {world} ranks, {rg['elements']} "
              f"fp32 elements ({4 * rg['elements'] / 1e6:.1f} MB): fp32, "
              f"bf16 and int8_ef (2 calls, residual) bitwise the numpy spec"
              + (", hier_reduce_scatter fp32/int8_ef at 2x2 (2 calls), 1x4 "
                 "and 4x1 bitwise the spec, 1x4 and 4x1 bitwise the flat "
                 "ring" if world == 4 else "")
              + f"; ms per call (median of 3, in turns): all-reduce "
              f"{rg['call_ms']['allreduce']:.2f}, fp32 "
              f"{rg['call_ms']['fp32']:.2f}, bf16 {rg['call_ms']['bf16']:.2f},"
              f" int8_ef {rg['call_ms']['int8_ef']:.2f}; ms per hop "
              f"({chunk_mb:.1f} MB fp32 chunk): fp32 "
              f"{rg['hop_ms']['fp32']:.2f}, bf16 {rg['hop_ms']['bf16']:.2f}, "
              f"int8 {rg['hop_ms']['int8_ef']:.2f}; an fp32 hop's parts: "
              f"device->host {rg['fp32_hop_parts_ms']['d2h']:.2f}, gloo "
              f"{rg['fp32_hop_parts_ms']['gloo']:.2f}, host->device "
              f"{rg['fp32_hop_parts_ms']['h2d']:.2f}"
              + (f"; hier 2x2 call {rg['hier_call_ms']:.2f}"
                 if world == 4 else "") + f" {card}")

    # b. the ring step, two ranks -----------------------------------------
    loss_err = abs(r0["check"]["loss"] - ref_loss)
    grad_err = max(((a - r).abs().max() / r.abs().max()).item()
                   for a, r in zip(r0["check"]["grads"], ref_grads))
    check(loss_err <= TOL_RING_LOSS, f"ring fp32 loss vs world of one "
          f"|d|={loss_err:.3g} > {TOL_RING_LOSS}")
    check(grad_err <= TOL_RING_GRAD, f"ring fp32 gradient vs world of one "
          f"max|d|/max|ref|={grad_err:.3g} > {TOL_RING_GRAD}")
    for rk in two:
        check(rk["kstep"]["losses_equal"] and rk["kstep"]["state_equal"],
              f"ring K=4 vs per step rank {rk['rank']}: {rk['kstep']}")
    print(f"ring step fp32 B=4 per rank x {kcfg.ctx_size}, wire fp32, M=1, "
          f"B=1, vs world of one at B=8: loss {r0['check']['loss']:.6f} vs "
          f"{ref_loss:.6f} |d| {loss_err:.3g}, gradient (one SGD step at lr "
          f"1024) max|d|/max|ref| {grad_err:.3g} over {len(ref_grads)} "
          f"leaves; int8_ef zero1 M=2: K=4 bitwise 4 per-step calls "
          f"(losses, parameters, moments, residuals) {card}")
    grid = {}
    plain_ms = r0["grid"]["plain"]["ms_per_step"]
    for name, kw in programs.PHASE15_CELLS:
        cell = r0["grid"][name]
        m = (kw or {}).get("microbatches", 1)
        zero1 = (kw or {}).get("aggregation") == "zero1"
        want = {"flash_fwd": 6 * m, "flash_bwd_dq": 6 * m,
                "flash_bwd_dkv": 6 * m, "adam": 0 if zero1 else 1}
        for rk in two:
            c = rk["grid"][name]
            check(c["replicas_bitwise"], f"ring cell {name}: replicas "
                  f"differ after {3 * 3 + 2} steps")
            check(c["launches"] == want, f"ring cell {name} rank "
                  f"{rk['rank']}: launches per step {c['launches']}, "
                  f"expected {want}")
            check(math.isfinite(c["last_loss"]), f"ring cell {name}: loss "
                  f"{c['last_loss']}")
        wire_b = cell["comm"]["wire_bytes_per_device_per_step"]
        grid[name] = {"ms_per_step": cell["ms_per_step"],
                      "ms_all": cell["ms"], "wire_bytes_per_step": wire_b,
                      "launches_per_step": cell["launches"],
                      "vs_plain": cell["ms_per_step"] / plain_ms}
        print(f"ring grid {name:>17}: {cell['ms_per_step']:8.2f} ms per step "
              f"({cell['ms_per_step'] / plain_ms:.3f}x phase 10's plain "
              f"step, timed in turns), wire {wire_b / 1e6:8.3f} MB per step "
              f"per rank, launches per rank per step {cell['launches']}, "
              f"replicas bitwise {card}")

    # c. the hierarchy, 2 x 2 -------------------------------------------------
    flat_wire = q0["flat_allreduce_wire"]
    hier = {}
    for agg, h in q0["hier"].items():
        by = h["comm"]["collectives"]
        local = h["local"]
        dcn = h["comm"]["axes"]["dcn"]["wire_bytes_per_device"]
        ratio = dcn / flat_wire
        for rk in four:
            check(rk["hier"][agg]["replicas_bitwise"], f"hier {agg}: "
                  f"replicas differ (rank {rk['rank']})")
        check(ratio <= DCN_BUDGET, f"hier {agg}: DCN bytes {dcn} are "
              f"{ratio:.3f} of the flat fp32 all-reduce's {flat_wire}")
        got = (by["ring_grad_dcn_int8"]["payload_bytes"],
               by["ring_grad_dcn_scale"]["payload_bytes"],
               by["ring_grad_dcn_int8"]["wire_bytes_per_device"])
        check(got == (local, 4, local), f"hier {agg}: DCN ring bytes {got},"
              f" analytic {(local, 4, local)}")
        want = {"flash_fwd": 6, "flash_bwd_dq": 6, "flash_bwd_dkv": 6,
                "adam": 0 if agg == "zero1" else 1}
        check(h["launches"] == want, f"hier {agg}: launches {h['launches']}")
        if agg == "zero1":
            for rk in four:
                res = rk["hier"][agg]["resume"]
                check(res["losses_equal"] and res["state_equal"],
                      f"hier resume rank {rk['rank']}: {res}")
        hier[agg] = {"ms_per_step": h["ms_per_step"], "dcn_wire": dcn,
                     "dcn_ratio": ratio, "axes": h["comm"]["axes"],
                     "launches_per_step": h["launches"],
                     "losses": h["losses"]}
        print(f"hier 2x2 {agg} bf16 B=16 per rank (fp32 islands, int8_ef "
              f"DCN): {h['ms_per_step']:.2f} ms per step; DCN "
              f"{dcn / 1e6:.3f} MB per step per rank = {ratio:.4f} of the "
              f"flat fp32 all-reduce's {flat_wire / 1e6:.3f} MB (budget "
              f"{DCN_BUDGET}); DCN ring exact ({local} int8 + 4 bytes per "
              f"hop); island axis {h['comm']['axes']['data']['wire_bytes_per_device'] / 1e6:.3f}"
              f" MB; replicas bitwise; launches per rank per step "
              f"{h['launches']}"
              + ("; saved at step 2 and resumed: bitwise the uninterrupted "
                 "4 steps, residuals included" if agg == "zero1" else "")
              + f" {card}")

    # d. the trainer ----------------------------------------------------------
    tok_cfg = LlamaConfig(vocab_size=259)
    total = sum(x.numel() for x in tree_leaves(llama.init_llama(
        tok_cfg, torch.Generator().manual_seed(0), device="meta").tree()))
    for label, rk, want in (
            ("data=2 M=2 int8_ef zero1", r0,
             {"flash_fwd": 12, "flash_bwd_dq": 12, "flash_bwd_dkv": 12,
              "adam": int(_k7_eligible(-(-total // 2)))}),
            ("dcn=2 data=2 wire_dcn=int8_ef M=1", q0,
             {"flash_fwd": 6, "flash_bwd_dq": 6, "flash_bwd_dkv": 6,
              "adam": 1})):
        tr = rk["trainer"]
        ls = tr["losses"]
        check(len(ls) == 20 and all(math.isfinite(x) for x in ls)
              and ls[-1] < ls[0], f"train_llm_dp {label}: losses {ls}")
        check(tr["launches"] == want, f"train_llm_dp {label}: launches "
              f"{tr['launches']}, expected {want}")
        print(f"train_llm_dp {label} (vocab 259, batch 4 x 256 per rank, "
              f"optimizer pallas): loss {ls[0]:.4f} -> {ls[-1]:.4f} in 20 "
              f"steps ({tr['seconds']:.1f} s, {tr['tokens_per_sec']:.0f} "
              f"tok/s all ranks after warmup); launches per rank per step "
              f"{tr['launches']}" + (
                  f"; manifest mesh {tr['manifest_mesh']}, comm axes "
                  f"{tr['manifest_axes']} (DCN {tr['dcn_wire']:.0f} B per "
                  f"step), compiles {tr['compiles']}, retraces "
                  f"{tr['retraces']}" if "manifest_axes" in tr else "")
              + f" {card}")
    tq = q0["trainer"]
    check("dcn" in tq["manifest_axes"] and tq["retraces"] == 0
          and tq["compiles"] == 1, f"hierarchical trainer's manifest and "
          f"compiles: {tq}")
    print(f"comm phase: {phase_s:.1f} s (rings {r0['rings']['seconds']:.1f} "
          f"/ {q0['rings']['seconds']:.1f} s, grid "
          f"{r0['grid_seconds']:.1f} s) {card}")
    return {"seconds": phase_s,
            "rings": {w: {k: rk["rings"][k] for k in (
                "call_ms", "call_ms_all", "hop_ms", "fp32_hop_parts_ms",
                "hop_bytes", "allreduce_bytes", "elements")}
                for w, rk in (("2", r0), ("4", q0))},
            "hier_call_ms": q0["rings"]["hier_call_ms"],
            "fp32_check": {"loss_abs_err": loss_err,
                           "grad_rel_err": grad_err},
            "grid": grid, "hier": hier, "flat_allreduce_wire": flat_wire,
            "trainer": {"data2": r0["trainer"], "dcn2": q0["trainer"]}}



# ------------------------------------------------------------- phase 16

# Phase 16 (tensor parallelism): the fp32 step against a world of one as
# phase 15 holds the ring driver; K2, K5 and K6 at the TP shard's H = 3.
TOL_TP_LOSS = 1e-5
TOL_TP_GRAD = 1e-5
TOL_TP_VS_DP = 1e-3        # 20-step TP trainer losses vs the world of one's
TOL_TP_INT8_REL = 0.03     # psa="int8_ef" vs psa="" losses, relative, each step
TP_SHAPE = (32, 256, 3, 48)      # B, T, H per shard at model=2, Dh
PSA_BYTES = {"full": 56_623_104, "defer:3": 9_437_184, "int8_ef": 28_311_600}


def _attention_kernels(dev: torch.device, card: str, shape, seed: int,
                       where: str) -> dict:
    """K2, K5 and K6 at ``shape`` (B, T, H, Dh; bf16, dh-major, causal)
    against their plain versions (phase 3's limits), timed beside SDPA and
    their bounds; ``where`` names the phase's part in the lines."""
    from ddl25spring_tpu_torch.bench_utils import kernel_time_us as time_us
    from ddl25spring_tpu_torch.ops import flash_attention as fa

    b, t, h, dh = shape
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q, k, v, do = (torch.randn(b, t, h, dh, generator=gen, device=dev
                               ).to(torch.bfloat16) for _ in range(4))
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True, dh_major=True)
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = (out.float() - ref_out.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    tag = f"B={b} T={t} H={h} Dh={dh} bfloat16 dh_major=True causal=True"
    check(math.isfinite(err) and err <= TOL_OUT[torch.bfloat16],
          f"{where} flash_fwd out {tag}: max|d|={err:.3g}")
    check(math.isfinite(lse_err) and lse_err <= TOL_LSE,
          f"{where} flash_fwd lse {tag}: max|d|={lse_err:.3g}")
    ops = fa.kernel_operands(q, k, v, True)
    lse_buf = torch.empty(b * h, t, dtype=torch.float32, device=dev)
    fwd = {"max_abs_err": err, "lse_max_abs_err": lse_err,
           "kernel_us": time_us(lambda: fa._launch(*ops, lse_buf,
                                                   causal=True)),
           "plain_us": time_us(lambda: fa.flash_attention_reference(
               q, k, v, causal=True))}
    qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))
    fwd["sdpa_us"] = time_us(lambda: torch.nn.functional.
                             scaled_dot_product_attention(qs, ks, vs,
                                                          is_causal=True))
    fwd["bound_us"], fwd["bound_by"] = attention_bound_us(
        b, t, h, dh, torch.bfloat16, True)

    q4, k4, v4, out, lse = fa._fwd(q, k, v, causal=True, dh_major=True)
    got = fa.flash_attention_bwd(q4, k4, v4, out, lse, do, causal=True)
    torch.cuda.synchronize()
    ref = fa.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                           causal=True)
    scale = max(r.float().abs().max().item() for r in ref)
    errs = dict(zip(("dq", "dk", "dv"), [(g.float() - r.float()).abs().max()
                                         .item() for g, r in zip(got, ref)]))
    for name, e in errs.items():
        check(math.isfinite(e) and e <= TOL_BWD[torch.bfloat16] * scale,
              f"{where} flash backward {name} {tag}: max|d|={e:.3g}")
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).reshape(
        b * h, t)
    bops = (q4, k4, v4, do.permute(0, 2, 1, 3))
    g4 = [x.permute(0, 2, 1, 3) for x in got]
    bwd = {"max_abs_err": errs, "scale": scale,
           "dq_us": time_us(lambda: fa._launch_bwd(
               "ddl_flash_bwd_dq", bops, g4[:1], lse, delta, causal=True)),
           "dkv_us": time_us(lambda: fa._launch_bwd(
               "ddl_flash_bwd_dkv", bops, g4[1:], lse, delta, causal=True)),
           "plain_us": time_us(lambda: fa.flash_attention_bwd_reference(
               q, k, v, out, lse, do, causal=True), reps=20, burst=2)}
    qs, ks, vs = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    lib_out = torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True)
    dos = do.transpose(1, 2)
    bwd["sdpa_bwd_us"] = time_us(lambda: torch.autograd.grad(
        lib_out, (qs, ks, vs), dos, retain_graph=True), reps=20, burst=2)
    for key, which in (("dq", "dq"), ("dkv", "dkv")):
        bwd[f"{key}_bound_us"], bwd[f"{key}_bound_by"] = \
            attention_bwd_bound_us(b, t, h, dh, torch.bfloat16, True, which)
    print(f"{where} K2 {tag}: max|d| out {err:.3g} lse "
          f"{lse_err:.3g}; kernel {fwd['kernel_us']:.1f} us, plain "
          f"{fwd['plain_us']:.1f}, sdpa {fwd['sdpa_us']:.1f}, bound "
          f"{fwd['bound_us']:.2f} ({fwd['bound_by']}); K5 dq max|d| "
          f"{errs['dq']:.3g}, {bwd['dq_us']:.1f} us (bound "
          f"{bwd['dq_bound_us']:.2f}); K6 dk/dv {errs['dk']:.3g}/"
          f"{errs['dv']:.3g}, {bwd['dkv_us']:.1f} us (bound "
          f"{bwd['dkv_bound_us']:.2f}); plain backward "
          f"{bwd['plain_us']:.1f} us, sdpa backward {bwd['sdpa_bwd_us']:.1f}"
          f" us {card}")
    return {"shape": list(shape), "fwd": fwd, "bwd": bwd}


def _world_of_one(dev: torch.device, tokens: torch.Tensor) -> tuple:
    """The canonical fp32 model's loss and gradient on ``tokens``."""
    from ddl25spring_tpu_torch.config import LlamaConfig
    from ddl25spring_tpu_torch.models import llama
    from ddl25spring_tpu_torch.tree import tree_leaves

    kcfg = LlamaConfig(attention_impl="pallas", flash_dh_major=True)
    m1 = llama.init_llama(kcfg, torch.Generator().manual_seed(0), device=dev)
    loss = llama.forward_loss(m1, tokens.to(dev), kcfg)
    grads = [g.cpu() for g in torch.autograd.grad(loss,
                                                  tree_leaves(m1.tree()))]
    out = (loss.item(), grads)
    del m1, loss
    torch.cuda.empty_cache()
    return out


def tp_phase(dev: torch.device, card: str) -> dict:
    """Phase 16: two ranks at ``model=2`` (``programs.phase16_two``) and
    four at ``data=2 × model=2`` (``programs.phase16_four``) on the card,
    against worlds of one computed here, and the kernels at the TP shape.
    Raises on a failed check; returns the numbers for the JSON record."""
    from ddl25spring_tpu_torch.parallel import distributed, programs

    from ddl25spring_tpu_torch.config import TrainConfig
    from ddl25spring_tpu_torch.train.llm import train_llm_dp

    t0 = time.perf_counter()
    g16 = torch.Generator()
    g16.manual_seed(16)
    toks = torch.randint(0, 32000, (8, 256), generator=g16)
    refs = {2: _world_of_one(dev, toks[:4]), 4: _world_of_one(dev, toks)}
    # f's reference: the world of one on data row 0's stream.
    one_losses = train_llm_dp(None, TrainConfig(**programs.TRAIN_16F),
                              log_every=0, device=dev).losses
    kernels = _attention_kernels(dev, card, TP_SHAPE, 16, "16b")
    with tempfile.TemporaryDirectory() as tmp:
        two = distributed.run_ranks(programs.phase16_two, 2,
                                    toks[:4].numpy(), tmp, timeout=900)
    with tempfile.TemporaryDirectory() as tmp:
        four = distributed.run_ranks(programs.phase16_four, 4, toks.numpy(),
                                     tmp, timeout=900)
    phase_s = time.perf_counter() - t0
    r0, q0 = two[0], four[0]

    # a. the fp32 step against a world of one -----------------------------
    fp32 = {}
    for label, rk, world in (("model=2 B=4", r0, 2),
                             ("data=2 x model=2 B=4 per row", q0, 4)):
        ref_loss, ref_grads = refs[world]
        loss_err = abs(rk["check"]["loss"] - ref_loss)
        grad_err = max(((a - r).abs().max() / r.abs().max()).item()
                       for a, r in zip(rk["check"]["grads"], ref_grads))
        check(loss_err <= TOL_TP_LOSS, f"16a TP {label} fp32 loss vs world "
              f"of one |d|={loss_err:.3g} > {TOL_TP_LOSS}")
        check(grad_err <= TOL_TP_GRAD, f"16a TP {label} fp32 gradient vs "
              f"world of one max|d|/max|ref|={grad_err:.3g} > "
              f"{TOL_TP_GRAD}")
        fp32[label] = {"loss_abs_err": loss_err, "grad_rel_err": grad_err}
        print(f"16a TP {label} fp32 vs a world of one at B={4 * world // 2}"
              f": loss {rk['check']['loss']:.6f} vs {ref_loss:.6f} |d| "
              f"{loss_err:.3g}, merged gradient (one SGD step at lr 1024) "
              f"max|d|/max|ref| {grad_err:.3g} over {len(ref_grads)} leaves"
              f" {card}")

    # c, d. the bf16 step and the PSA modes, in turns -----------------------
    grid = {}
    want = {"flash_fwd": 6, "flash_bwd_dq": 6, "flash_bwd_dkv": 6,
            "adam": 1}
    one_ms = r0["grid"]["world of one"]["ms_per_step"]
    for name, cell in r0["grid"].items():
        if name == "world of one":
            check(cell["launches"] == want, f"16c world of one: launches "
                  f"{cell['launches']}")
        else:
            for rk in two:
                c = rk["grid"][name]
                check(c["launches"] == want, f"16c TP {name} rank "
                      f"{rk['rank']}: launches per step {c['launches']}, "
                      f"expected {want}")
                check(math.isfinite(c["last_loss"]), f"16c TP {name}: loss "
                      f"{c['last_loss']}")
        if name in PSA_BYTES:
            check(cell["model_wire"] == cell["budget"] == PSA_BYTES[name],
                  f"16d psa={name}: model-axis bytes {cell['model_wire']}, "
                  f"analytic {cell['budget']} / {PSA_BYTES[name]}")
        grid[name] = {"ms_per_step": cell["ms_per_step"], "ms": cell["ms"],
                      "launches_per_step": cell["launches"],
                      "vs_world_of_one": cell["ms_per_step"] / one_ms,
                      **({"model_wire": cell["model_wire"]}
                         if name in PSA_BYTES else {})}
        print(f"16c/d {name:>12} bf16 B=32 x 256: {cell['ms_per_step']:8.2f}"
              f" ms per step ({cell['ms_per_step'] / one_ms:.3f}x the world "
              f"of one, timed in turns; all {[round(x, 2) for x in cell['ms']]}"
              f"), launches per rank per step {cell['launches']}"
              + (f", model-axis activation bytes {cell['model_wire']:.0f} "
                 f"(analytic {PSA_BYTES[name]})" if name in PSA_BYTES else "")
              + f" {card}")
    print(f"16c one activation sum ({r0['act_sum_bytes']} B bf16, staged in "
          f"fp32): {r0['act_sum_ms']:.2f} ms; the replicated-gradient sum "
          f"({r0['replicated_sum_elements']} fp32): "
          f"{r0['replicated_sum_ms']:.2f} ms (medians) {card}")

    # e. the DP x TP ring ----------------------------------------------------
    ring = {}
    for m in (1, 2):
        cell = q0["ring"][f"m{m}"]
        local = q0["local"]
        got = (cell["ring_int8"], cell["ring_scale"], cell["gather_int8"])
        check(got == (m * local, 4 * m, local), f"16e ring M={m}: data-axis "
              f"bytes {got}, analytic {(m * local, 4 * m, local)}")
        wz = {"flash_fwd": 6 * m, "flash_bwd_dq": 6 * m,
              "flash_bwd_dkv": 6 * m, "adam": 0}
        for rk in four:
            c = rk["ring"][f"m{m}"]
            check(c["data_replicas_bitwise"], f"16e ring M={m}: data "
                  f"replicas differ (rank {rk['rank']})")
            check(c["launches"] == wz, f"16e ring M={m} rank {rk['rank']}: "
                  f"launches {c['launches']}, expected {wz}")
        ring[f"m{m}"] = {"ms_per_step": cell["ms_per_step"],
                         "ms": cell["ms"], "axes": cell["axes"],
                         "launches_per_step": cell["launches"]}
        print(f"16e DP x TP 2x2 int8_ef zero1 M={m} bf16 B=16 per row: "
              f"{cell['ms_per_step']:.2f} ms per step "
              f"({[round(x, 2) for x in cell['ms']]}); data ring "
              f"{cell['ring_int8']} int8 + {cell['ring_scale']} scale bytes "
              f"per step (exact), delta gather {cell['gather_int8']}; data "
              f"replicas bitwise; launches per rank per step "
              f"{cell['launches']} {card}")
    for rk in four:
        check(rk["resume_bitwise"], f"16e resume rank {rk['rank']}: the "
              "resumed state differs from 4 uninterrupted steps")
    print(f"16e saved at step 2 and resumed: bitwise the uninterrupted 4 "
          f"steps, residuals and moments included, on all 4 ranks {card}")

    # f. the trainer ---------------------------------------------------------
    # Launches per step over the 20 steps and the manifest's comm probe
    # (one dispatch: K=2 steps, or one step of M=2 microbatches).
    k2 = {"flash_fwd": 6 * 22 / 20, "flash_bwd_dq": 6 * 22 / 20,
          "flash_bwd_dkv": 6 * 22 / 20, "adam": 22 / 20}
    for label, ranks, key, want in (
            ("model=2 psa=int8_ef K=2", two, "trainer", k2),
            ("model=2 psa='' K=2", two, "trainer_plain", k2),
            ("data=2 model=2 M=2 int8_ef zero1", four, "trainer",
             {"flash_fwd": 12 * 21 / 20, "flash_bwd_dq": 12 * 21 / 20,
              "flash_bwd_dkv": 12 * 21 / 20, "adam": 0})):
        tr = ranks[0][key]
        ls = tr["losses"]
        check(all(rk[key]["losses"] == ls for rk in ranks),
              f"16f train_llm_tp {label}: the ranks disagree on the losses")
        check(all(abs(tr["launches"][k] - v) < 1e-9 for k, v in
                  want.items()), f"16f train_llm_tp {label}: launches "
              f"{tr['launches']}, expected {want}")
        check(len(ls) == 20 and all(math.isfinite(x) for x in ls)
              and ls[-1] < ls[0], f"16f train_llm_tp {label}: losses {ls}")
        check("model" in tr["manifest_axes"] and tr["retraces"] == 0,
              f"16f train_llm_tp {label}: manifest axes "
              f"{tr['manifest_axes']}, retraces {tr['retraces']}")
        print(f"16f train_llm_tp {label} (vocab 259, batch 4 x 256 per data "
              f"row, optimizer pallas): loss {ls[0]:.4f} -> {ls[-1]:.4f} in "
              f"20 steps ({tr['seconds']:.1f} s, {tr['tokens_per_sec']:.0f} "
              f"tok/s after warmup); launches per rank per step, the comm "
              f"probe included, {tr['launches']}; manifest mesh {tr['manifest_mesh']}, comm "
              f"axes {tr['manifest_axes']} (model {tr['model_wire']:.0f} B "
              f"per call), compiles {tr['compiles']}, retraces "
              f"{tr['retraces']} {card}")
    # The TP trainer against the world of one step by step (a loss spike
    # of the reference's dynamics included), and int8_ef against psa="".
    plain, int8 = r0["trainer_plain"]["losses"], r0["trainer"]["losses"]
    vs_one = max(abs(a - b) for a, b in zip(plain, one_losses))
    int8_rel = max(abs(a - b) / abs(b) for a, b in zip(int8, plain))
    check(vs_one <= TOL_TP_VS_DP, f"16f train_llm_tp psa='' vs train_llm_dp "
          f"at a world of one: max|d| {vs_one:.3g} > {TOL_TP_VS_DP}; "
          f"{plain} vs {one_losses}")
    check(int8_rel <= TOL_TP_INT8_REL, f"16f train_llm_tp psa=int8_ef vs "
          f"psa='': max|d|/|loss| {int8_rel:.3g} > {TOL_TP_INT8_REL}; "
          f"{int8} vs {plain}")
    print(f"16f train_llm_tp model=2 psa='' vs train_llm_dp at a world of "
          f"one (batch 4 x 256, the same stream): max|d| {vs_one:.3g} over "
          f"20 steps; psa=int8_ef vs psa='': max|d|/|loss| {int8_rel:.3g}; "
          f"losses world of one {[round(x, 4) for x in one_losses]}, "
          f"psa='' {[round(x, 4) for x in plain]}, int8_ef "
          f"{[round(x, 4) for x in int8]} {card}")
    print(f"tp phase: {phase_s:.1f} s {card}")
    return {"seconds": phase_s, "fp32_check": fp32, "kernels": kernels,
            "grid": grid, "act_sum_ms": r0["act_sum_ms"],
            "replicated_sum_ms": r0["replicated_sum_ms"], "ring": ring,
            "trainer": {"model2": r0["trainer"],
                        "model2_plain": r0["trainer_plain"],
                        "data2": q0["trainer"], "world_of_one": one_losses,
                        "vs_world_of_one": vs_one, "int8_vs_plain": int8_rel}}


# ------------------------------------------------------------- phase 17

# Phase 17 (sequence and expert parallelism): the fp32 steps against a
# world of one at JAX's SP bars (tests/test_sp.py), the same for EP; the
# ring's bytes exact; K2, K5 and K6 at the long-context shape.
TOL_SP_LOGITS = 1e-4
TOL_SP_LOSS = 1e-5
TOL_SP_GRAD = 1e-4
TOL_EP_AUX = 1e-6
RING_KV_BYTES = 14_155_776   # 2 x (2·256·288·2 B) x ring 4 x 6 layers
LONGCTX_SHAPE = (2, 4096, 6, 48)
LONGCTX_GRID = [(4096, 4)]     # one point: the T=1024 row was cut for time
EP_LAUNCHES = {"flash_fwd": 6, "flash_bwd_dq": 6, "flash_bwd_dkv": 6,
               "adam": 1}


def _held(label: str, res: dict, card: str) -> None:
    """Hold one fp32 SP or EP layout of phase 17a / 17c to its bars and
    print it."""
    if "logits_abs_err" in res:
        check(res["logits_abs_err"] <= TOL_SP_LOGITS, f"{label}: logits "
              f"vs the world of one max|d|={res['logits_abs_err']:.3g}")
    if "aux_abs_err" in res:
        check(res["aux_abs_err"] <= TOL_EP_AUX, f"{label}: aux vs the "
              f"unsharded model |d|={res['aux_abs_err']:.3g}")
    check(res["loss_abs_err"] <= TOL_SP_LOSS, f"{label}: loss vs the world "
          f"of one |d|={res['loss_abs_err']:.3g}")
    check(res["grad_rel_err"] <= TOL_SP_GRAD, f"{label}: gradient vs the "
          f"world of one max|d|/max|ref|={res['grad_rel_err']:.3g}")
    print(f"{label}: loss {res['loss']:.6f} vs {res['ref_loss']:.6f} |d| "
          f"{res['loss_abs_err']:.3g}, gradient (one SGD step at lr 1024) "
          f"max|d|/max|ref| {res['grad_rel_err']:.3g}"
          + (f", logits max|d| {res['logits_abs_err']:.3g}"
             if "logits_abs_err" in res else "")
          + (f", aux |d| {res['aux_abs_err']:.3g}, routing as the "
             f"unsharded model's: {res['route_equals_unsharded']}, dropped "
             f"slots per layer {[round(x, 4) for x in res['dropped_share']]}"
             if "aux_abs_err" in res else "") + f" {card}")


def sp_ep_phase(dev: torch.device, card: str) -> dict:
    """Phase 17: four ranks on the card (``programs.phase17``) for
    sequence and expert parallelism against worlds of one computed in the
    ranks, then the long-context twin and the kernels at T = 4096 here.
    Raises on a failed check; returns the numbers for the JSON record."""
    from ddl25spring_tpu_torch.experiments import longctx_bench
    from ddl25spring_tpu_torch.parallel import distributed, programs

    t0 = time.perf_counter()
    torch.cuda.empty_cache()        # the ranks and the longctx points share the card
    g17 = torch.Generator()
    g17.manual_seed(17)
    sp_toks = torch.randint(0, 32000, (4, 1024), generator=g17)
    ep_toks = torch.randint(0, 32000, (16, 256), generator=g17)
    ranks = distributed.run_ranks(programs.phase17, 4, sp_toks.numpy(),
                                  ep_toks.numpy(), timeout=900)
    ranks_s = time.perf_counter() - t0
    r0 = ranks[0]
    out = {"ranks_seconds": ranks_s,
           "parts_seconds": {k: r0[f"{k}_seconds"] for k in (
               "sp_check", "sp_time", "sp_peaks", "ep_check", "ep_time")}}

    # a. SP fp32 against the world of one -----------------------------------
    for name, res in r0["sp_check"].items():
        for rk in ranks:
            check(rk["sp_check"][name]["replicas_bitwise"], f"17a SP {name}: "
                  f"rank {rk['rank']}'s parameters differ after the step")
        _held(f"17a SP {name} fp32 T=1024", res, card)
    out["sp_check"] = r0["sp_check"]

    # b. SP bf16 ring 4: time, hop, bytes, peaks ----------------------------
    grid = r0["sp_time"]["grid"]
    cell = grid["sp ring 4"]
    hop = cell["comm"]["collectives"]["ring_kv_hop"]
    check(hop["payload_bytes"] == RING_KV_BYTES, f"17b ring_kv_hop bytes per "
          f"step {hop['payload_bytes']}, analytic {RING_KV_BYTES}")
    check(cell["replicas_bitwise"], "17b SP ring 4: the ranks' parameters "
          "differ")
    for name, c in grid.items():
        check(math.isfinite(c["last_loss"]), f"17b {name}: loss "
              f"{c['last_loss']}")
        print(f"17b {name:>18} bf16 B=2 x 1024: {c['ms_per_step']:8.2f} ms "
              f"per step ({[round(x, 2) for x in c['ms']]}, in turns), "
              f"launches per rank per step {c['launches']} {card}")
    one_ms = grid["world of one"]["ms_per_step"]
    print(f"17b SP ring 4 {cell['ms_per_step'] / one_ms:.2f}x the plain "
          f"world of one; ring_kv_hop {hop['payload_bytes']} B in "
          f"{hop['calls']} sends per step per rank (exact); one hop of K and "
          f"V ({r0['sp_time']['hop_bytes']} B bf16) "
          f"{r0['sp_time']['hop_ms']:.3f} ms (median of 20), the fp32 "
          f"gradient sum over the ring {r0['sp_time']['grad_sum_ms']:.2f} ms "
          f"(median of 3) {card}")
    peaks = {name: [rk["sp_peaks"][name]["peak_bytes"] for rk in ranks
                    if name in rk["sp_peaks"]]
             for name in ("ring1", "ring2", "ring4")}
    top = {k: max(v) for k, v in peaks.items()}
    check(top["ring4"] < top["ring2"] < top["ring1"], f"17b peak bytes per "
          f"rank do not fall with the ring: {top}")
    losses = [r0["sp_peaks"][k]["loss"] for k in ("ring1", "ring2", "ring4")]
    print(f"17b sp_bench twin, full width bf16 T=4096 B=2: peak allocated per "
          f"rank ring 1 {top['ring1'] / 1e9:.3f} GB, ring 2 "
          f"{top['ring2'] / 1e9:.3f} GB, ring 4 {top['ring4'] / 1e9:.3f} GB "
          f"(above the state: "
          + ", ".join(f"{k} {max(rk['sp_peaks'][k]['step_bytes'] for rk in ranks if k in rk['sp_peaks']) / 1e9:.3f}"
                      for k in ("ring1", "ring2", "ring4"))
          + f" GB); losses {[round(x, 5) for x in losses]} {card}")
    out.update(sp_time={"grid": grid, "hop_ms": r0["sp_time"]["hop_ms"],
                        "hop_bytes": r0["sp_time"]["hop_bytes"],
                        "grad_sum_ms": r0["sp_time"]["grad_sum_ms"],
                        "ring_kv_hop_bytes": hop["payload_bytes"]},
               sp_peaks={"peak_bytes": peaks, "losses": losses,
                         "step_bytes": {k: [rk["sp_peaks"][k]["step_bytes"]
                                            for rk in ranks
                                            if k in rk["sp_peaks"]]
                                        for k in peaks}})

    # c. EP fp32 against the unsharded model --------------------------------
    for name, res in r0["ep_check"].items():
        rows = {}
        for rk in ranks:
            row = rk["rank"] // 2 if name == "d2e2" else 0
            rows.setdefault(row, set()).add(rk["ep_check"][name]["route_digest"])
        check(all(len(v) == 1 for v in rows.values()), f"17c EP {name}: "
              f"the ranks of a row routed differently: {rows}")
        _held(f"17c EP {name} fp32 B=8 per row x 256", res, card)
    out["ep_check"] = r0["ep_check"]

    # d. EP bf16 expert 2 ----------------------------------------------------
    egrid = r0["ep_time"]["grid"]
    for rk in ranks[:2]:
        got = rk["ep_time"]["grid"]["ep expert 2"]["launches"]
        check(got == EP_LAUNCHES, f"17d EP expert 2 rank {rk['rank']}: "
              f"launches per step {got}, expected {EP_LAUNCHES}")
    e2, un = egrid["ep expert 2"], egrid["unsharded"]
    check(math.isfinite(e2["last_loss"]), f"17d EP loss {e2['last_loss']}")
    print(f"17d EP expert 2 bf16 B=8 x 256 (pallas optimizer): "
          f"{e2['ms_per_step']:.2f} ms per step ({[round(x, 2) for x in e2['ms']]}"
          f") against the unsharded step's {un['ms_per_step']:.2f} "
          f"({e2['ms_per_step'] / un['ms_per_step']:.2f}x, in turns); launches "
          f"per rank per step {e2['launches']} (unsharded {un['launches']}); "
          f"one combine sum ({r0['ep_time']['combine_bytes']} B bf16, staged "
          f"in fp32) {r0['ep_time']['combine_ms']:.2f} ms, the replicated "
          f"sum ({r0['ep_time']['replicated_elements']} fp32) "
          f"{r0['ep_time']['replicated_sum_ms']:.2f} ms (medians) {card}")
    out["ep_time"] = {k: v for k, v in r0["ep_time"].items()}

    # e. long context, each point in this process (a process per point
    # spent its start-up on every point) --------------------------------------
    t1 = time.perf_counter()
    lc = {"rows": []}
    for seq, batch in LONGCTX_GRID:
        for variant in longctx_bench.VARIANTS:
            torch.cuda.empty_cache()
            lc["rows"].append({"seq": seq, "batch": batch, "variant": variant,
                               "platform": "cuda", **longctx_bench.measure(
                                   variant, seq, batch, steps=5)})
    torch.cuda.empty_cache()
    for row in lc["rows"]:
        check(row["tokens_per_sec"] > 0 and math.isfinite(row["step_ms"]),
              f"17e longctx {row}")
        print(f"17e longctx T={row['seq']} B={row['batch']} "
              f"{row['variant']:5s}: {row['tokens_per_sec']:.0f} tok/s, "
              f"{row['step_ms']:.2f} ms per step {card}")
    out["longctx"] = lc["rows"]
    out["longctx_seconds"] = time.perf_counter() - t1
    out["kernels"] = _attention_kernels(dev, card, LONGCTX_SHAPE, 17, "17e")
    out["seconds"] = time.perf_counter() - t0
    print(f"sp/ep phase: {out['seconds']:.1f} s (ranks {ranks_s:.1f}, "
          f"longctx {out['longctx_seconds']:.1f}) {card}")
    return out


# ------------------------------------------------------------- phase 18

# Phase 18 (elastic data parallelism): four pool ranks on the card at the
# canonical width (vocab 259), bf16, flash dh-major, the pallas optimizer,
# B = 8 x 256 per rank. Launches per rank per step in every world: the
# flash kernels 6 each and Adam 1 under gradient aggregation; on the int8_ef
# ring at M = 2 microbatches the flash kernels 6·M = 12 each and Adam 0
# (ZeRO-1's flat slices miss K7's eligibility gate, ROADMAP.md B7).
ELASTIC_CFG = dict(dtype="bfloat16", attention_impl="pallas",
                   flash_dh_major=True)
ELASTIC_TCFG = dict(batch_size=8, seq_len=256, optimizer="pallas", iters=6)
ELASTIC_LAUNCHES = {"gradient": {"flash_fwd": 6, "flash_bwd_dq": 6,
                                 "flash_bwd_dkv": 6, "adam": 1},
                    "ring_zero1_m2": {"flash_fwd": 12, "flash_bwd_dq": 12,
                                     "flash_bwd_dkv": 12, "adam": 0}}


def _world_steps(rep: dict, iters: int, probe: int) -> list:
    """Steps each world of an elastic run trained, in order (``probe``:
    the manifest's comm-probe step in the first world)."""
    recs = rep["remeshes"]
    starts = [0] + [r["resume_step"] for r in recs]
    ends = [r["detected_at"] for r in recs] + [iters]
    return [e - s + (probe if i == 0 else 0)
            for i, (s, e) in enumerate(zip(starts, ends))]


def _held_launches(leg: str, ranks, agg: str, iters: int,
                   probe: int) -> list:
    """Every rank's launches per step in each world of leg ``leg`` against
    ELASTIC_LAUNCHES; returns rank 0's per world."""
    steps = _world_steps(ranks[0][leg], iters, probe)
    want = ELASTIC_LAUNCHES[agg]
    per_rank = []
    for rk in ranks:
        segs = rk[leg]["worlds"]
        check(len(segs) == len(steps), f"18{leg} rank {rk['rank']}: "
              f"{len(segs)} launch segments for {len(steps)} worlds")
        got = []
        for seg, n in zip(segs, steps):
            if seg["world"] == 0:     # outside the world: nothing runs
                check(not any(seg["launches"].values()), f"18{leg} rank "
                      f"{rk['rank']} launched outside the world: {seg}")
                got.append(None)
                continue
            per = {k: v / n for k, v in seg["launches"].items()}
            check(per == want, f"18{leg} rank {rk['rank']}: launches per "
                  f"step {per} in a world of {seg['world']}, expected "
                  f"{want}")
            got.append(per)
        per_rank.append(got)
    return per_rank[0]


def _held_reshards(leg: str, ranks) -> int:
    """Every member of every new world of leg ``leg`` held the state it
    resumed with against the mirror it came from
    (``programs.reshard_differences``, on the mirror path): fails on a
    missing audit or any misplaced coordinate; returns the audits."""
    recs = ranks[0][leg]["remeshes"]
    want = sorted((r["old_world"], r["new_world"]) for r in recs
                  for _ in range(r["new_world"]))
    got = sorted(tuple(a["worlds"]) for rk in ranks
                 for a in rk[leg]["audit"])
    check(got == want, f"18{leg}: re-mesh audits {got}, expected one per "
          f"member of each new world {want}")
    for rk in ranks:
        for a in rk[leg]["audit"]:
            check(a["path"] == "mirror" and a["differences"] == [],
                  f"18{leg} rank {rk['rank']} {a['worlds']}: the resharded "
                  f"state departs from its mirror: {a['differences']}")
    return len(got)


def _print_remeshes(leg: str, rep: dict, card: str) -> None:
    spans = rep.get("spans") or [{}] * len(rep["remeshes"])
    for rec, sp in zip(rep["remeshes"], spans):
        parts = ", ".join(f"{k} {sp[k]:.3f} s" for k in (
            "drain", "rebuild", "restore", "persist", "replay") if k in sp)
        print(f"18{leg} {rec['direction']} {rec['old_world']} -> "
              f"{rec['new_world']} at step {rec['detected_at']} (lost "
              f"{rec['lost']}, returned {rec['returned']}) via "
              f"{rec['path']}: {rec['seconds']:.3f} s"
              + (f" ({parts})" if parts else "")
              + f", {rec['steps_replayed']} steps replayed {card}")


def elastic_phase(dev: torch.device, card: str) -> dict:
    """Phase 18: four pool ranks on the card (``programs.phase18``). Raises
    on a failed check; returns the numbers for the JSON record."""
    from ddl25spring_tpu_torch.parallel import distributed, programs

    t0 = time.perf_counter()
    torch.cuda.empty_cache()           # the four ranks share the card
    tcfg = dict(ELASTIC_TCFG)
    iters = tcfg["iters"]
    with tempfile.TemporaryDirectory() as tmp:
        ranks = distributed.run_ranks(programs.phase18, 4, ELASTIC_CFG, tcfg,
                                      tmp, timeout=900)
    out = {"ranks_seconds": time.perf_counter() - t0}
    return _elastic_checks(ranks, card, iters, out)


def _elastic_checks(ranks, card: str, iters: int, out: dict) -> dict:
    r0 = ranks[0]
    for rk in ranks[1:]:        # every rank returns the final world's run
        for leg in ("a", "b", "c", "d"):
            for name, rep in (r0[leg].items() if leg == "a"
                              else [(leg, r0[leg])]):
                other = (rk[leg][name] if leg == "a" else rk[leg])
                check(other["losses"] == rep["losses"], f"18{leg} {name}: "
                      f"rank {rk['rank']}'s losses differ from rank 0's")
    a = r0["a"]
    for agg in ("gradient", "zero1"):
        ref, el = a[f"ref_{agg}"], a[f"elastic_{agg}"]
        check(len(el["losses"]) == iters and all(
            math.isfinite(x) for x in el["losses"]), f"18a {agg} losses")
        check(el["losses"] == ref["losses"] and el["remeshes"] == [],
              f"18a {agg}: elastic losses {el['losses']} are not the "
              f"non-elastic run's {ref['losses']}")
    print(f"18a no fault, 4 ranks, bf16 B=8 x 256 per rank: the elastic "
          f"losses are bitwise the non-elastic run's (gradient K=1: "
          f"{a['ref_gradient']['seconds']:.1f} s vs "
          f"{a['elastic_gradient']['seconds']:.1f} s, ZeRO-1 K=2: "
          f"{a['ref_zero1']['seconds']:.1f} s vs "
          f"{a['elastic_zero1']['seconds']:.1f} s for {iters} steps, "
          f"process start and builds included) {card}")
    out["a"] = {k: {"losses": v["losses"], "seconds": v["seconds"]}
                for k, v in a.items()}
    for leg, agg in (("b", "gradient"), ("d", "ring_zero1_m2")):
        rep, fresh = r0[leg], r0[f"{leg}_fresh"]
        recs = rep["remeshes"]
        check([(r["old_world"], r["new_world"]) for r in recs]
              == [(4, 3), (3, 4)], f"18{leg} worlds {recs}")
        check(recs[1]["returned"] == recs[0]["lost"], f"18{leg} returned "
              f"{recs[1]['returned']} is not lost {recs[0]['lost']}")
        m = recs[1]["resume_step"]
        check(len(rep["losses"]) == iters and all(
            math.isfinite(x) for x in rep["losses"]), f"18{leg} losses")
        check(fresh["start_step"] == m and rep["losses"][m:]
              == fresh["losses"], f"18{leg}: the post-grow losses "
              f"{rep['losses'][m:]} are not the fresh 4-rank run's "
              f"{fresh['losses']} from step {m}")
        launches = _held_launches(leg, ranks, agg, iters, probe=1)
        audits = _held_reshards(leg, ranks)
        _print_remeshes(leg, rep, card)
        mirror = sorted({(w, b) for _, w, b in rep["mirror_bytes"]
                         if b is not None})
        what = ("gradient K=1" if leg == "b"
                else "int8_ef ring M=2 ZeRO-1 K=1")
        print(f"18{leg} {what}, device_loss@2,device_return@5: post-grow "
              f"losses bitwise a fresh 4-rank run from step {m}; each "
              f"rank's resharded state against its mirror: {audits} "
              f"re-mesh audits, no coordinate misplaced; launches "
              f"per rank per step by world {launches}; mirror bytes (world, "
              f"bytes) {mirror}; {rep['seconds']:.1f} s for the walk "
              f"{card}")
        out[leg] = {"remeshes": recs, "spans": rep["spans"],
                    "mirror_bytes": mirror, "launches": launches,
                    "losses": rep["losses"], "seconds": rep["seconds"]}
    c = r0["c"]
    recs = c["remeshes"]
    check([(r["old_world"], r["new_world"]) for r in recs]
          == [(4, 2), (2, 4)], f"18c worlds {recs}")
    check(all(r["steps_replayed"] == 0 for r in recs) and len(c["losses"])
          == iters and all(math.isfinite(x) for x in c["losses"]),
          f"18c: a planned move replayed or lost steps: {recs}")
    launches = _held_launches("c", ranks, "gradient", iters, probe=0)
    audits = _held_reshards("c", ranks)
    _print_remeshes("c", c, card)
    print(f"18c scale_hook (Autoscaler on a TTFT series) 4 -> 2 -> 4: "
          f"nothing replayed, {iters} losses, {audits} re-mesh audits "
          f"clean; launches per rank per step by "
          f"world {launches} {card}")
    out["c"] = {"remeshes": recs, "launches": launches,
                "losses": c["losses"], "seconds": c["seconds"]}
    out["legs_seconds"] = {k: r0[f"{k}_seconds"] for k in "abcd"}
    print(f"elastic phase: {out.get('ranks_seconds', 0.0):.1f} s (legs "
          + ", ".join(f"{k} {v:.1f}" for k, v in out["legs_seconds"].items())
          + f" s) {card}")
    return out


# Phase 19: the DP×PP ring drivers (19a, canonical width, data 2 × stage
# 2), elastic train_llm_pp (19b) and train_llm_tp (19c) at vocab 259.
PP19_TCFG = dict(batch_size=8, seq_len=256, optimizer="pallas", iters=6)
TOL_PP_FP32 = (1e-5, 1e-4)      # ring vs plain step: loss, leaves of max
TOL_PP_RELAXED = (1e-3, 2e-3)   # bf16, int8_ef wires (the CPU tests' bar)
PP19_RING_BUDGET = 0.27


def pp19_launches(layers: int, pmb: int, m: int, adam: int) -> dict:
    """Launches per stage per step of a GPipe stage of ``layers`` layers:
    K2, K5 and K6 once per layer per pipeline microbatch per sync
    microbatch, K7 ``adam`` times."""
    n = layers * pmb * m
    return {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n,
            "adam": adam}


@functools.lru_cache(maxsize=None)
def _stage_chunks(vocab: int, data: int, stages: int) -> list:
    """Each stage's ZeRO-1 slice at the canonical model and ``vocab`` on a
    ``data × stages`` grid (``pp._pp_flat_geometry``)."""
    from ddl25spring_tpu_torch.config import LlamaConfig
    from ddl25spring_tpu_torch.models import llama
    from ddl25spring_tpu_torch.parallel import distributed, pp
    params = llama.init_llama(LlamaConfig(vocab_size=vocab),
                              torch.Generator().manual_seed(0),
                              device="cpu").tree()
    return [pp._pp_flat_geometry(
        distributed.PipelineMesh(data, stages, 0, s, None, None),
        params)[2] for s in range(stages)]


def _held_world_launches(name: str, ranks, want, iters: int,
                         probe: int) -> list:
    """Every rank's launches per step in each world it took part in
    against ``want(world)``; a rank outside the call's world (all its
    segments at world 0) launched nothing. Returns the per-world launches
    of the first rank that ran."""
    steps = _world_steps(ranks[0][name], iters, probe)
    first = None
    for rk in ranks:
        segs = rk[name]["worlds"]
        if all(seg["world"] == 0 for seg in segs):
            check(not any(v for seg in segs for v in seg["launches"].values()),
                  f"19 {name} rank {rk['rank']} launched outside the run")
            continue
        check(len(segs) == len(steps), f"19 {name} rank {rk['rank']}: "
              f"{len(segs)} launch segments for {len(steps)} worlds")
        got = []
        for seg, n in zip(segs, steps):
            if seg["world"] == 0:
                check(not any(seg["launches"].values()), f"19 {name} rank "
                      f"{rk['rank']} launched outside the world: {seg}")
                got.append(None)
                continue
            per = {k: v / n for k, v in seg["launches"].items()}
            check(per == want(seg["world"]), f"19 {name} rank {rk['rank']}: "
                  f"launches per step {per} in a world of {seg['world']}, "
                  f"expected {want(seg['world'])}")
            got.append(per)
        first = first or got
    return first


def pp_elastic_phase(dev: torch.device, card: str) -> dict:
    """Phase 19: four pool ranks on the card (``programs.phase19``). Raises
    on a failed check; returns the numbers for the JSON record."""
    import numpy as np
    from ddl25spring_tpu_torch.parallel import distributed, programs

    t0 = time.perf_counter()
    torch.cuda.empty_cache()           # the four ranks share the card
    rng = np.random.default_rng(19)
    tokens_check = rng.integers(0, 32000, (4, 2 * 4, 256))
    tokens_time = rng.integers(0, 32000, (2 * 16, 256))
    wall0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = distributed.run_ranks(
            programs.phase19, 4, tokens_check, tokens_time, ELASTIC_CFG,
            PP19_TCFG, tmp, timeout=900)
        wall1 = time.time()
    out = {"ranks_seconds": time.perf_counter() - t0,
           "spawn_seconds": min(r["wall"][0] for r in ranks) - wall0,
           "exit_seconds": wall1 - max(r["wall"][1] for r in ranks),
           "cleanup_seconds": time.time() - wall1}
    _pp19_ring_checks(ranks, card, out)
    _pp19_elastic_checks(ranks, card, out)
    print(f"pp elastic phase: {out['ranks_seconds']:.1f} s (spawn "
          f"{out['spawn_seconds']:.1f}, 19a {ranks[0]['a_seconds']:.1f}, 19b "
          f"{ranks[0]['b_seconds']:.1f}, 19c {ranks[0]['c_seconds']:.1f}, "
          f"exit {out['exit_seconds']:.1f}, directory cleanup "
          f"{out['cleanup_seconds']:.1f} s) {card}")
    return out


def _k7_per_stage(vocab: int, data: int, stages: int) -> int:
    """K7's launches per stage per step of a ZeRO-1 ring step on a ``data
    × stages`` grid: 1 when every stage's slice passes the kernel's gate,
    0 when none does (a grid whose stages disagree is refused here)."""
    gate = {_k7_eligible(c) for c in _stage_chunks(vocab, data, stages)}
    check(len(gate) == 1, f"the K7 gate differs across the stages of "
          f"{data}x{stages} at vocab {vocab}")
    return int(gate.pop())


def _pp19_ring_checks(ranks, card: str, out: dict) -> None:
    from ddl25spring_tpu_torch.parallel.programs import PHASE19_CELLS
    a = {rk["rank"]: rk["a"] for rk in ranks}
    plain = a[0]["plain"]["losses"]
    check(len(plain) == 4 and all(math.isfinite(x) for x in plain),
          f"19a plain losses {plain}")
    cells = {}
    for name in a[0]["cells"]:
        wire = name.split()[0]
        tol_loss, tol_leaf = (TOL_PP_FP32 if wire == "fp32"
                              else TOL_PP_RELAXED)
        losses = a[0]["cells"][name]["losses"]
        loss_err = max(abs(x - y) for x, y in zip(losses, plain))
        leaf_err = max(r["cells"][name]["leaf_err"] for r in a.values())
        for r in a.values():
            check(r["cells"][name]["losses"] == losses, f"19a {name}: the "
                  "ranks' losses differ")
            check(r["cells"][name]["replicas_bitwise"], f"19a {name}: the "
                  "data rows' parameters differ")
        check(all(math.isfinite(x) for x in losses) and loss_err <= tol_loss
              and leaf_err <= tol_leaf, f"19a {name}: loss error {loss_err} "
              f"(bar {tol_loss}), leaves {leaf_err} of their max (bar "
              f"{tol_leaf}) against the plain DP×PP step")
        cells[name] = {"loss_err": loss_err, "leaf_err": leaf_err}
    print("19a canonical width fp32, data 2 x stage 2 (3 layers per stage, "
          "GPipe, 2 pipeline microbatches), B=4 per row, SGD lr 0.02, 4 "
          "steps, against the plain DP×PP step: " + "; ".join(
              f"{k} loss {v['loss_err']:.2e} leaves {v['leaf_err']:.2e}"
              for k, v in cells.items()) + f"; data rows bitwise {card}")
    out["cells"] = cells
    out["geometry"] = {f"stage{r['stage']}": r["geometry"]
                       for r in a.values() if r["d"] == 0}
    ratios, exact = {}, {}
    for r in a.values():
        if r["d"]:
            continue
        geo, K, M = r["geometry"], r["bytes"]["K"], r["bytes"]["M"]
        chunk, n = geo["chunk"], geo["n"]
        prof = r["bytes"]["profile"]
        by = prof["collectives"]
        got = {"ring": by["pp_ring_grad_int8"]["payload_bytes"],
               "gather": by["pp_delta_gather_int8"]["wire_bytes_per_device"]}
        want = {"ring": K * M * (n - 1) * chunk, "gather": K * (n - 1) * chunk}
        check(got == want, f"19a stage {r['stage']}: ring and gather bytes "
              f"{got}, expected K·M·(n−1)·chunk {want}")
        base = r["plain"]["comm"]["axes"]["data"]["wire_bytes_per_device"]
        ring = prof["axes"]["data"]["wire_bytes_per_device"] / K
        ratios[f"stage{r['stage']}"] = ring / base
        exact[f"stage{r['stage']}"] = got
        check(ring / base <= PP19_RING_BUDGET, f"19a stage {r['stage']}: "
              f"int8_ef ZeRO-1 data-axis wire {ring / base:.3f} of the plain "
              f"step's, budget {PP19_RING_BUDGET}")
    for r in a.values():
        for what in ("kstep", "resume"):
            check(r[what]["losses_bitwise"] and r[what]["state_bitwise"],
                  f"19a rank {r['stage']}/{r['d']}: {what} not bitwise")
    print(f"19a bytes per stage (K=2, M=1, int8_ef ZeRO-1): {exact}, exactly "
          f"K·M·(n−1)·chunk; data-axis wire against the plain step "
          + ", ".join(f"{k} {v:.4f}" for k, v in ratios.items())
          + f" (budget {PP19_RING_BUDGET}); K=2 and a checkpoint resume "
          f"bitwise {card}")
    out["wire_ratio"], out["bytes"] = ratios, exact
    zero1_adam = _k7_per_stage(32000, 2, 2)
    timing = {}
    for r in a.values():
        s = r["stage"]
        for name, cell in r["timing"].items():
            agg, _, m = (("gradient", "fp32", 1) if name == "plain"
                         else PHASE19_CELLS[name])
            adam = 1 if agg == "gradient" else zero1_adam
            want = pp19_launches(3, 2, m, adam)
            check(cell["launches"] == want, f"19a {name} stage {s} row "
                  f"{r['d']}: launches per step {cell['launches']}, "
                  f"expected {want}")
            check(cell["replicas_bitwise"], f"19a timed {name}: data rows "
                  "differ")
            if r["d"] == 0 and s == 0:
                timing[name] = {"ms_per_step": cell["ms_per_step"],
                                "launches": cell["launches"]}
    hop = a[0]["hop"]
    print("19a bf16 B=16 per row, pallas Adam, timed in turns (2 rounds of "
          "3 steps): " + "; ".join(
              f"{k} {v['ms_per_step']:.1f} ms/step, launches "
              f"{v['launches']}" for k, v in timing.items())
          + f"; one fp32 ring hop of stage 0's chunk ({hop['bytes']} B) "
          f"{hop['hop_ms']:.2f} ms: device->host {hop['d2h_ms']:.2f}, gloo "
          f"{hop['gloo_ms']:.2f}, host->device {hop['h2d_ms']:.2f} {card}")
    out["timing"], out["hop"] = timing, hop


def _pp19_elastic_checks(ranks, card: str, out: dict) -> None:
    iters = PP19_TCFG["iters"]
    r0 = ranks[0]
    for ref, el in (("b_plain", "b_plain_el"), ("b_ring", "b_ring_el")):
        check(r0[el]["losses"] == r0[ref]["losses"] and len(r0[el]["losses"])
              == iters and r0[el]["remeshes"] == [], f"19b {el}: the elastic "
              f"losses {r0[el]['losses']} are not the non-elastic "
              f"{r0[ref]['losses']}")
    grids = {4: (2, 2), 3: (1, 3), 2: (1, 2)}     # world -> (data, stage)

    def pp_want(ring: bool):
        def want(world: int) -> dict:
            d, stages = grids[world]
            adam = _k7_per_stage(259, d, stages) if ring else 1
            return pp19_launches(6 // stages, 2, 2 if ring else 1, adam)
        return want

    legs = {"b_stage": ([("stage", [1, 3], [1, 2])], 1, 2, False, 0),
            "b_trip": ([("stage", [1, 3], [1, 2]), ("stage", [1, 2],
                                                     [1, 3])], 1, 3, False, 1),
            "b_rows": ([("data", [2, 2], [1, 2])], 1, 2, True, 0),
            "c_rows": ([("data", [2, 2], [1, 2])], 1, 2, False, 0)}
    for name, (shapes, d, s, ring, at) in legs.items():
        rep, fresh = r0[name], r0[f"{name}_fresh"]
        recs = rep["remeshes"]
        check([(r["axis"], r["old_shape"], r["new_shape"]) for r in recs]
              == shapes, f"19 {name}: re-meshes {recs}, expected {shapes}")
        m = recs[at]["resume_step"]
        check(len(rep["losses"]) == iters and all(
            math.isfinite(x) for x in rep["losses"]), f"19 {name} losses")
        check(fresh["start_step"] == m and rep["losses"][m:]
              == fresh["losses"], f"19 {name}: losses after the re-mesh "
              f"{rep['losses'][m:]} are not a fresh {d}x{s} run's "
              f"{fresh['losses']} from step {m}")
        want_audits = sum(r["new_world"] for r in recs)
        audits = [a for rk in ranks for a in rk[name].get("audit", [])]
        check(len(audits) == want_audits and all(
            a["path"] == "mirror" and a["differences"] == [] for a in audits),
            f"19 {name}: {len(audits)} audits (want {want_audits}): "
            f"{[a['differences'] for a in audits]}")
        want = (pp_want(ring) if name.startswith("b") else
                (lambda world: pp19_launches(6, 1, 1, 1)))
        launches = _held_world_launches(name, ranks, want, iters, probe=1)
        spans = rep.get("spans") or [{}] * len(recs)
        for rec, sp in zip(recs, spans):
            parts = ", ".join(f"{k} {sp[k]:.3f} s" for k in (
                "drain", "rebuild", "restore", "persist", "replay")
                if k in sp)
            print(f"19 {name} {rec['direction']} {rec['old_shape']} -> "
                  f"{rec['new_shape']} ({rec['axis']}) at step "
                  f"{rec['detected_at']} via {rec['path']}: "
                  f"{rec['seconds']:.3f} s ({parts}) {card}")
        print(f"19 {name}: losses after the re-mesh bitwise a fresh {d}x{s} "
              f"run from step {m}; {len(audits)} audits clean; launches per "
              f"rank per step by world {launches}; {rep['seconds']:.1f} s "
              f"{card}")
        out[name] = {"remeshes": recs, "spans": rep.get("spans"),
                     "launches": launches, "losses": rep["losses"],
                     "seconds": rep["seconds"]}
    for rk in ranks[:2]:
        err = rk["c_fatal"].get("error")
        check(err is not None and err[0] == "ReplicaLossError", f"19c a "
              f"model-axis loss on 1x2 ended with {err}, not "
              f"ReplicaLossError")
    print(f"19b no fault: elastic bitwise non-elastic (plain 2x2, int8_ef "
          f"ZeRO-1 ring M=2); 19c a model-axis loss on 1x2 raises "
          f"ReplicaLossError, nothing fabricated {card}")


# ------------------------------------------------------------- phase 20
# Phase 20: DP×PP×TP, the pipeline over a (data, stage, model) grid of
# ranks with Megatron TP inside each stage, at the canonical width (3 heads
# per model shard): 20a on 1 × 2 × 2 (four ranks), 20b on 2 × 2 × 2 (eight
# ranks, the ring drivers and train_llm_pp(mesh=...)), and 20c the decode
# rate of generate (bench_utils.time_decode).
TOL_PPTP = (1e-5, 1e-4)        # loss, leaves of their max: fp32 checks
PPTP_DECODE = [(1, False), (1, True), (64, False), (64, True)]


def _held_cell_launches(part: str, ranks, cells: dict) -> dict:
    """Every rank's launches per step in each timed cell of ``part``
    against ``cells[name] = (want, ranks that run it or None for all)``;
    a rank outside a cell launched nothing there. Returns rank 0's."""
    for r in ranks:
        for name, (want, who) in cells.items():
            got = r["timing"][name]["launches"]
            if who is not None and r["rank"] not in who:
                want_here = {k: 0 for k in want}
            else:
                want_here = want
            check(got == want_here, f"{part} {name} rank {r['rank']}: "
                  f"launches per step {got}, expected {want_here}")
    return {name: ranks[0]["timing"][name]["launches"] for name in cells}


def pp_tp_phase(dev: torch.device, card: str) -> dict:
    """Phase 20: four, then eight ranks on the card (``programs.
    phase20_four``, ``phase20_eight``), then the decode rates here. Raises
    on a failed check; returns the numbers for the JSON record."""
    import numpy as np
    from ddl25spring_tpu_torch import bench_utils
    from ddl25spring_tpu_torch.config import LlamaConfig
    from ddl25spring_tpu_torch.parallel import distributed, programs

    t0 = time.perf_counter()
    torch.cuda.empty_cache()           # the ranks share the card
    rng = np.random.default_rng(20)
    out = {}

    # a. 1 x 2 x 2 -----------------------------------------------------------
    ranks = distributed.run_ranks(programs.phase20_four, 4,
                                  rng.integers(0, 32000, (4, 256)),
                                  rng.integers(0, 32000, (16, 256)),
                                  timeout=600)
    out["a_seconds"] = time.perf_counter() - t0
    for r in ranks:
        for sched, c in r["check"].items():
            check(c["loss_err"] <= TOL_PPTP[0]
                  and c["grad_rel_err"] <= TOL_PPTP[1], f"20a {sched} rank "
                  f"{r['rank']} (stage {r['s']}, model {r['m']}): loss "
                  f"error {c['loss_err']}, gradient {c['grad_rel_err']} of "
                  f"the leaf max against the world of one (bars "
                  f"{TOL_PPTP})")
    worst = {sched: {k: max(r["check"][sched][k] for r in ranks)
                     for k in ("loss_err", "grad_rel_err")}
             for sched in ranks[0]["check"]}
    print("20a canonical width fp32, 1 x 2 x 2 (3 layers per stage, 3 "
          "heads per model shard), B=4, M=2, against the world of one: "
          + "; ".join(f"{k} loss {v['loss_err']:.2e} gradient "
                      f"{v['grad_rel_err']:.2e}" for k, v in worst.items())
          + f" {card}")
    step = pp19_launches(3, 2, 1, 1)
    launches = _held_cell_launches("20a", ranks, {
        "pp x tp 1x2x2": (step, None), "pp 1x2": (step, (0, 2)),
        "tp 1x2": (pp19_launches(6, 1, 1, 1), (0, 1))})
    check(ranks[0]["timing"]["pp x tp 1x2x2"]["replicas_bitwise"] and all(
        r["timing"]["pp x tp 1x2x2"]["replicas_bitwise"] for r in ranks),
        "20a: the model shards' replicated leaves differ")
    timing = {k: v["ms_per_step"] for k, v in ranks[0]["timing"].items()}
    for k, v in ranks[0]["timing"].items():
        check(math.isfinite(v["last_loss"]), f"20a {k}: loss "
              f"{v['last_loss']}")
    print("20a bf16 B=16, GPipe M=2, pallas Adam, timed in turns (2 rounds "
          "of 3 steps): " + "; ".join(
              f"{k} {ms:.1f} ms/step ({[round(x, 1) for x in ranks[0]['timing'][k]['ms']]}), "
              f"launches per rank {launches[k]}" for k, ms in timing.items())
          + f"; one activation sum ({ranks[0]['act_sum_bytes']} B bf16, "
          f"staged in fp32) {ranks[0]['act_sum_ms']:.2f} ms (median of 10) "
          f"{card}")
    out["a"] = {"check": worst, "timing": timing, "launches": launches,
                "act_sum_ms": ranks[0]["act_sum_ms"],
                "check_seconds": ranks[0]["check_seconds"],
                "time_seconds": ranks[0]["time_seconds"]}

    # b. 2 x 2 x 2 -----------------------------------------------------------
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = distributed.run_ranks(
            programs.phase20_eight, 8, rng.integers(0, 32000, (3, 8, 256)),
            rng.integers(0, 32000, (32, 256)), tmp, timeout=900)
    out["b_seconds"] = time.perf_counter() - t1
    exact, loss_err, leaf_err = {}, 0.0, 0.0
    for r in ranks:
        c = r["check"]
        err = max(abs(x - y) for x, y in zip(c["ring_losses"],
                                             c["plain_losses"]))
        loss_err, leaf_err = max(loss_err, err), max(leaf_err,
                                                     c["ring_leaf_err"])
        check(err <= TOL_PPTP[0] and c["ring_leaf_err"] <= TOL_PPTP[1],
              f"20b rank {r['rank']}: the fp32 ring's loss error {err}, "
              f"leaves {c['ring_leaf_err']} of their max against the plain "
              f"2x2x2 step (bars {TOL_PPTP})")
        check(c["ring_replicas_bitwise"] and c["int8_replicas_bitwise"],
              f"20b rank {r['rank']}: data rows or model replicas differ")
        check(c["kstep"]["losses_bitwise"] and c["kstep"]["state_bitwise"],
              f"20b rank {r['rank']}: the K=2 window is not two steps")
        geo, K, M = c["geometry"], c["bytes"]["K"], c["bytes"]["M"]
        by = c["bytes"]["profile"]["collectives"]
        got = {"ring": by["pp_ring_grad_int8"]["payload_bytes"],
               "gather": by["pp_delta_gather_int8"]["wire_bytes_per_device"]}
        want = {"ring": K * M * (geo["n"] - 1) * geo["chunk"],
                "gather": K * (geo["n"] - 1) * geo["chunk"]}
        check(got == want, f"20b rank {r['rank']}: ring and gather bytes "
              f"{got}, expected K·M·(n−1)·chunk {want}")
        if r["d"] == 0:
            exact[f"stage{r['s']}/model{r['m']}"] = dict(got, chunk=geo[
                "chunk"])
    print(f"20b canonical width fp32, 2 x 2 x 2, B=4 per row, SGD lr 0.02, "
          f"3 steps: fp32 gradient ring against the plain step, loss "
          f"{loss_err:.2e}, leaves {leaf_err:.2e}; int8_ef ZeRO-1 M=1 K=2 "
          f"bitwise two steps; data rows and model replicas bitwise; bytes "
          f"per cell (K=2, M=1) {exact}, exactly K·M·(n−1)·chunk {card}")
    k7 = {r["rank"]: int(_k7_eligible(r["check"]["geometry"]["chunk"]))
          for r in ranks}
    for r in ranks:
        want = {"plain": pp19_launches(3, 2, 1, 1),
                "gradient fp32 M=1": pp19_launches(3, 2, 1, 1),
                "zero1 int8_ef M=1": pp19_launches(3, 2, 1, k7[r["rank"]])}
        for name, w in want.items():
            cell = r["timing"][name]
            check(cell["launches"] == w, f"20b {name} rank {r['rank']}: "
                  f"launches per step {cell['launches']}, expected {w}")
            check(cell["replicas_bitwise"], f"20b timed {name}: replicas "
                  "differ")
            check(math.isfinite(cell["last_loss"]), f"20b {name} loss")
    timing_b = {k: v["ms_per_step"] for k, v in ranks[0]["timing"].items()}
    print("20b bf16 B=16 per row, pallas Adam, timed in turns (2 rounds of "
          "3 steps): " + "; ".join(
              f"{k} {ms:.1f} ms/step ({[round(x, 1) for x in ranks[0]['timing'][k]['ms']]}), "
              f"launches per rank {ranks[0]['timing'][k]['launches']}"
              for k, ms in timing_b.items())
          + f"; K7 per cell on the ZeRO-1 ring {k7} {card}")
    tr = [r["trainer"] for r in ranks]
    for r, t in zip(ranks, tr):
        check(len(t["losses"]) == 3 and all(math.isfinite(x)
                                            for x in t["losses"])
              and t["losses"] == t["driver_losses"] == tr[0]["losses"],
              f"20b rank {r['rank']}: train_llm_pp(mesh=2x2x2) losses "
              f"{t['losses']}, the step driver's {t['driver_losses']}")
        check(t["launches"] == pp19_launches(3, 2, 1, 1), f"20b trainer "
              f"rank {r['rank']}: launches per step {t['launches']}")
    print(f"20b train_llm_pp(mesh={{data 2, stage 2, model 2}}) vocab 259, "
          f"B=4 x 256 per row, pallas Adam: losses {tr[0]['losses']}, "
          f"bitwise the step driver's on every rank; launches per rank per "
          f"step {tr[0]['launches']}; {tr[0]['seconds']:.1f} s {card}")
    out["b"] = {"fp32_loss_err": loss_err, "fp32_leaf_err": leaf_err,
                "bytes": exact, "timing": timing_b,
                "launches": {k: ranks[0]["timing"][k]["launches"]
                             for k in timing_b},
                "k7_zero1": k7, "trainer": {
                    "losses": tr[0]["losses"],
                    "launches": tr[0]["launches"]},
                "check_seconds": ranks[0]["check_seconds"],
                "time_seconds": ranks[0]["time_seconds"],
                "trainer_seconds": ranks[0]["trainer_seconds"]}

    # c. decode ---------------------------------------------------------------
    t1 = time.perf_counter()
    cfg = LlamaConfig()
    decode = {}
    for b, bf16 in PPTP_DECODE:
        rate = bench_utils.time_decode(cfg, b, bf16_params=bf16, reps=2,
                                       device=dev)
        check(math.isfinite(rate) and rate > 0, f"20c decode rate {rate}")
        decode[f"B={b} {'bf16' if bf16 else 'fp32'} weights"] = rate
    print("20c time_decode (generate, greedy, prompt 64, 128 new tokens, 2 "
          "reps): " + "; ".join(f"{k} {v:.0f} tok/s"
                                for k, v in decode.items()) + f" {card}")
    out["decode"] = decode
    out["c_seconds"] = time.perf_counter() - t1
    out["seconds"] = time.perf_counter() - t0
    print(f"pp x tp phase: {out['seconds']:.1f} s (20a {out['a_seconds']:.1f}"
          f": check {out['a']['check_seconds']:.1f}, timing "
          f"{out['a']['time_seconds']:.1f}; 20b {out['b_seconds']:.1f}: "
          f"check {out['b']['check_seconds']:.1f}, timing "
          f"{out['b']['time_seconds']:.1f}, trainer "
          f"{out['b']['trainer_seconds']:.1f}; 20c {out['c_seconds']:.1f}) "
          f"{card}")
    return out


def _in_background(fn, *args):
    """Start ``fn(*args)`` on a thread (the kernel build, whose ``nvcc``
    runs are child processes; ``cuobjdump``) and return a function that
    waits for it: its result, or what it raised."""
    out = {}

    def run():
        try:
            out["s"] = fn(*args)
        except BaseException as e:          # re-raised by the waiter
            out["e"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()

    def wait():
        t.join()
        if "e" in out:
            raise out["e"]
        return out["s"]

    return wait


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from ddl25spring_tpu_torch import adam_ab, bench_utils, profile_step
    time_us = bench_utils.kernel_time_us
    from ddl25spring_tpu_torch.config import LlamaConfig, TrainConfig
    from ddl25spring_tpu_torch.models import llama
    from ddl25spring_tpu_torch.ops import _ext
    from ddl25spring_tpu_torch.ops import flash_attention as fa
    from ddl25spring_tpu_torch.ops import pallas_adam as padam
    from ddl25spring_tpu_torch.ops.adam import bias_corrections
    from ddl25spring_tpu_torch.parallel import dp
    from ddl25spring_tpu_torch.train.llm import train_llm_dp
    from ddl25spring_tpu_torch.tree import tree_leaves
    from ddl25spring_tpu_torch.serving import (PagedKVConfig, reference_stream,
                                               run_serving, synthetic_workload)
    from ddl25spring_tpu_torch.telemetry.costs import train_flops_per_token

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. device -----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi)
    card = f"[{smi}]"
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind} count {torch.cuda.device_count()} "
          f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    t_mark = [time.perf_counter()]
    phase_seconds = {}

    def stamp(name: str) -> None:
        """The seconds since the last stamp, as phase ``name``'s, on a line
        of their own."""
        now = time.perf_counter()
        phase_seconds[name] = now - t_mark[0]
        t_mark[0] = now
        print(f"phase {name}: {phase_seconds[name]:.1f} s {card}")

    stamp("1")

    def zero_counts():
        fa.launches = fa.dq_launches = fa.dkv_launches = padam.launches = 0

    def read_counts():
        torch.cuda.synchronize()
        return {"flash_fwd": fa.launches, "flash_bwd_dq": fa.dq_launches,
                "flash_bwd_dkv": fa.dkv_launches, "adam": padam.launches}

    # 2. build ------------------------------------------------------------
    # The kernels compile (nvcc child processes) while phases 8 and 9, which
    # launch no port kernel, run: their host times share the CPU with nvcc.
    wait_build = _in_background(_ext.build)
    try:
        # 8. horizontal FL (no port kernel on this path) -----------------
        zero_counts()
        t0 = time.perf_counter()
        fl_report, mnist_arrays = fl_phase(dev, card)
        fl_report["phase_s"] = time.perf_counter() - t0
        fl_counts = read_counts()
        check(not any(fl_counts.values()), f"the FL phase launched port "
              f"kernels: {fl_counts}")
        print(f"fl phase: {fl_report['phase_s']:.1f} s, port kernel "
              f"launches {fl_counts} {card}")
        stamp("8")

        # 9. tabular, VFL, DP-FedAvg, secure aggregation (no port kernel)
        zero_counts()
        t0 = time.perf_counter()
        tab_report = tabular_phase(dev, card)
        tab_report.update(private_fl_phase(dev, card, mnist_arrays))
        tab_report["phase_s"] = time.perf_counter() - t0
        tab_counts = read_counts()
        check(not any(tab_counts.values()), f"phase 9 launched port "
              f"kernels: {tab_counts}")
        print(f"tabular/vfl/dp/secagg phase: {tab_report['phase_s']:.1f} s, "
              f"port kernel launches {tab_counts} {card}")
        stamp("9")
    finally:
        build_s = wait_build()
    print(f"build: {build_s:.1f} s, phases 8 and 9 beside it {card}")
    stamp("2 (the build's wait after phases 8 and 9)")
    # The TF32 HMMA count (cuobjdump of the whole library, host work) runs
    # beside phase 3's device timings; phase 3b prints it.
    wait_hmma = _in_background(tf32_hmma_counts, _ext)
    ptxas = {}
    for name in _ext.KERNELS:
        log = _ext.library_path(name).with_suffix(".so.log")
        if log.exists():
            fn = ""
            for line in log.read_text().splitlines():
                if "Compiling entry function" in line:
                    # kernel<type, head dim> out of the mangled name
                    # (the mma kernels' second parameter is the layout)
                    m = re.search(r"((?:[a-z_]|tf32)+_kernel)(?:I(\w*?)Li"
                                  r"(\d+)E(?:Li(\d+)E)?)?", line)
                    args = [a for a in (PTXAS_TYPES.get(m.group(2),
                                                        m.group(2)),
                                        m.group(3), m.group(4)) if a]
                    fn = m.group(1) + (f"<{', '.join(args)}>" if args
                                       else "")
                elif "registers" in line or "spill" in line:
                    print(f"  ptxas {fn}: {line.strip()}")
                    ptxas.setdefault(fn, []).append(line.strip())
    spilled = [f"{fn}: {line}" for fn, lines in ptxas.items()
               if "_tf32_kernel" in fn for line in lines
               if any(int(n) for n in re.findall(r"(\d+) bytes spill", line))]
    check(not spilled, f"the fp32 kernels spill: {spilled}")
    fwd48 = {fn: lines for fn, lines in ptxas.items()
             if fn.startswith("flash_fwd_tf32_kernel<48")}
    check(len(fwd48) == 3, f"ptxas reported {sorted(fwd48)} for the fp32 "
          f"forward at Dh 48, expected its three layouts")
    print(f"flash_fwd_tf32_kernel at Dh 48, ptxas per layout (0 row-major, 1 "
          f"dh-major, 2 each read at run time): {fwd48} {card}")

    # 3. kernels vs plain -------------------------------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cases = [(64, 256, 6, 48, torch.bfloat16, True, True),   # training step
             (8, 256, 6, 48, torch.float32, False, True),
             (8, 256, 6, 48, torch.float32, True, True),
             (8, 256, 6, 48, torch.bfloat16, False, True),
             (8, 256, 6, 48, torch.bfloat16, True, True),
             (2, 200, 6, 48, torch.float32, False, True),
             (2, 200, 6, 48, torch.float32, True, True),
             (2, 200, 6, 48, torch.bfloat16, False, True),
             (2, 200, 6, 48, torch.bfloat16, True, False),
             (2, 100, 6, 48, torch.bfloat16, True, True),
             (3, 256, 6, 48, torch.float32, True, True),    # the trainer's
             (8, 256, 6, 48, torch.float32, True, False),
             (8, 256, 6, 64, torch.float32, True, True),
             (8, 256, 6, 128, torch.float32, True, True),
             (1, 4096, 6, 48, torch.float32, True, True)]   # 64 key tiles
    layouts = []
    for b, t, h, dh, dtype, dh_major, causal in cases:
        q, k, v = (torch.randn(b, t, h, dh, generator=gen, device=dev
                               ).to(dtype) for _ in range(3))
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                          dh_major=dh_major)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_reference(q, k, v,
                                                        causal=causal)
        err = (out.float() - ref_out.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        tag = (f"B={b} T={t} H={h} Dh={dh} {str(dtype)[6:]} "
               f"dh_major={dh_major} causal={causal}")
        check(math.isfinite(err) and err <= TOL_OUT[dtype],
              f"flash_fwd out {tag}: max|d|={err:.3g} > {TOL_OUT[dtype]}")
        check(math.isfinite(lse_err) and lse_err <= TOL_LSE,
              f"flash_fwd lse {tag}: max|d|={lse_err:.3g} > {TOL_LSE}")
        # The kernel alone, on operands already in the layout it reads.
        ops = fa.kernel_operands(q, k, v, dh_major)
        lse_buf = torch.empty(b * h, t, dtype=torch.float32, device=dev)
        kernel_us = time_us(lambda: fa._launch(*ops, lse_buf,
                                               causal=causal))
        wrapper_us = time_us(lambda: fa.flash_attention(
            q, k, v, causal=causal, dh_major=dh_major))
        plain_us = time_us(lambda: fa.flash_attention_reference(
            q, k, v, causal=causal))
        qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))
        sdpa_us = time_us(lambda: torch.nn.functional.
                          scaled_dot_product_attention(qs, ks, vs,
                                                       is_causal=causal))
        bound_us, bound_by = attention_bound_us(b, t, h, dh, dtype, causal)
        fma = (attention_bound_us(b, t, h, dh, dtype, causal,
                                  peak=FP32_FMA_FLOPS)
               if dtype == torch.float32 else None)
        fma_kernel_us = FMA_FWD_US.get((b, t, h, dh, dh_major, causal))
        layouts.append({
            "shape": [b, t, h, dh], "dtype": str(dtype)[6:],
            "dh_major": dh_major, "causal": causal,
            "replaces": ("ddl25spring_tpu/ops/flash_attention.py:321"
                         if dh_major else
                         "ddl25spring_tpu/ops/flash_attention.py:49"),
            "max_abs_err": err, "lse_max_abs_err": lse_err,
            "kernel_us": kernel_us, "wrapper_us": wrapper_us,
            "plain_us": plain_us, "sdpa_us": sdpa_us,
            "bound_us": bound_us, "bound_by": bound_by,
            **({"fma_bound_us": fma[0], "fma_bound_by": fma[1]}
               if fma else {})})
        fma_note = (f"; at the fp32 FMA rate {fma[0]:.2f} us ({fma[1]}); "
                    f"the FMA kernel it replaced "
                    + (f"{fma_kernel_us:.1f} us (PERF.md's figure, not "
                       f"this run's)" if fma_kernel_us else "not measured")
                    if fma else "")
        print(f"flash_fwd {tag}: max|d| out {err:.3g} lse {lse_err:.3g}; "
              f"kernel {kernel_us:.1f} us, wrapper {wrapper_us:.1f} us, "
              f"plain {plain_us:.1f} us, sdpa {sdpa_us:.1f} us, "
              f"bound {bound_us:.2f} us ({bound_by}{fma_note}) {card}")
        del q, k, v, out, lse, ref_out, ref_lse, ops


    stamp("3")
    # 3b. backward kernels vs plain --------------------------------------
    hmma = wait_hmma()
    print(f"fp32 flash kernels' TF32 HMMA instructions (cuobjdump -sass, "
          f"Dh 48): {hmma}")
    check(all(hmma.get(f"{kern}<48, {lay}>", 0) > 0
              for kern, layouts in (("flash_fwd_tf32_kernel", 3),
                                    ("flash_bwd_dq_tf32_kernel", 4),
                                    ("flash_bwd_dkv_tf32_kernel", 4))
              for lay in range(layouts)),
          f"an fp32 flash kernel without TF32 HMMA instructions: {hmma}")
    bwd = []
    for b, t, h, dh, dtype, dh_major, causal in [
            (64, 256, 6, 48, torch.bfloat16, True, True),   # training step
            (8, 256, 6, 48, torch.float32, False, True),
            (8, 256, 6, 48, torch.float32, True, True),
            (3, 256, 6, 48, torch.float32, True, True),     # the trainer's
            (8, 256, 6, 48, torch.bfloat16, False, True),
            (8, 256, 6, 48, torch.bfloat16, True, True),
            (2, 200, 6, 48, torch.float32, False, True),
            (2, 200, 6, 48, torch.float32, True, True),
            (2, 200, 6, 48, torch.float32, True, False),
            (2, 200, 6, 48, torch.bfloat16, False, True),
            (2, 200, 6, 48, torch.bfloat16, True, False),
            (2, 100, 6, 48, torch.bfloat16, True, True),
            (2, 100, 6, 48, torch.bfloat16, False, False)]:
        q, k, v, do = (torch.randn(b, t, h, dh, generator=gen, device=dev
                                   ).to(dtype) for _ in range(4))
        q4, k4, v4, out, lse = fa._fwd(q, k, v, causal=causal,
                                       dh_major=dh_major)
        got = fa.flash_attention_bwd(q4, k4, v4, out, lse, do,
                                     causal=causal)
        torch.cuda.synchronize()
        ref = fa.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                               causal=causal)
        errs = [(g.float() - r.float()).abs().max().item()
                for g, r in zip(got, ref)]
        scale = (1.0 if dtype == torch.float32 else
                 max(r.float().abs().max().item() for r in ref))
        tag = (f"B={b} T={t} H={h} Dh={dh} {str(dtype)[6:]} "
               f"dh_major={dh_major} causal={causal}")
        for name, err in zip(("dq", "dk", "dv"), errs):
            check(math.isfinite(err) and err <= TOL_BWD[dtype] * scale,
                  f"flash backward {name} {tag}: max|d|={err:.3g} > "
                  f"{TOL_BWD[dtype] * scale:.3g}")
        # Each kernel alone, on the operands the backward gives it.
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).reshape(
            b * h, t)
        ops = (q4, k4, v4, do.permute(0, 2, 1, 3))
        g4 = [x.permute(0, 2, 1, 3) for x in got]
        dq_us = time_us(lambda: fa._launch_bwd(
            "ddl_flash_bwd_dq", ops, g4[:1], lse, delta, causal=causal))
        dkv_us = time_us(lambda: fa._launch_bwd(
            "ddl_flash_bwd_dkv", ops, g4[1:], lse, delta, causal=causal))
        plain_us = time_us(lambda: fa.flash_attention_bwd_reference(
            q, k, v, out, lse, do, causal=causal), reps=20, burst=2)
        qs, ks, vs = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        lib_out = torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, is_causal=causal)
        do_s = do.transpose(1, 2)
        sdpa_bwd_us = time_us(lambda: torch.autograd.grad(
            lib_out, (qs, ks, vs), do_s, retain_graph=True))
        dq_bound = attention_bwd_bound_us(b, t, h, dh, dtype, causal, "dq")
        dkv_bound = attention_bwd_bound_us(b, t, h, dh, dtype, causal, "dkv")
        fma = ({w: attention_bwd_bound_us(b, t, h, dh, dtype, causal, w,
                                          peak=FP32_FMA_FLOPS)
                for w in ("dq", "dkv")} if dtype == torch.float32 else None)
        bwd.append({
            "shape": [b, t, h, dh], "dtype": str(dtype)[6:],
            "dh_major": dh_major, "causal": causal,
            "max_abs_err": {"dq": errs[0], "dk": errs[1], "dv": errs[2]},
            "max_abs_ref": max(r.float().abs().max().item() for r in ref),
            "dq_us": dq_us, "dkv_us": dkv_us, "plain_us": plain_us,
            "sdpa_bwd_us": sdpa_bwd_us, "dq_bound_us": dq_bound[0],
            "dq_bound_by": dq_bound[1], "dkv_bound_us": dkv_bound[0],
            "dkv_bound_by": dkv_bound[1],
            **({"dq_fma_bound_us": fma["dq"][0],
                "dkv_fma_bound_us": fma["dkv"][0]} if fma else {})})
        fma_note = (f"; at the fp32 FMA rate dq {fma['dq'][0]:.2f} us "
                    f"({fma['dq'][1]}), dkv {fma['dkv'][0]:.2f} us "
                    f"({fma['dkv'][1]})" if fma else "")
        print(f"flash_bwd {tag}: max|d| dq {errs[0]:.3g} dk {errs[1]:.3g} "
              f"dv {errs[2]:.3g} (largest reference gradient "
              f"{bwd[-1]['max_abs_ref']:.3g}); dq kernel {dq_us:.1f} us (bound "
              f"{dq_bound[0]:.2f} us, {dq_bound[1]}), dkv kernel "
              f"{dkv_us:.1f} us (bound {dkv_bound[0]:.2f} us, "
              f"{dkv_bound[1]}){fma_note}, plain dq+dk+dv {plain_us:.1f} us, "
              f"sdpa backward {sdpa_bwd_us:.1f} us {card}")
        del q, k, v, do, q4, k4, v4, out, lse, got, ref, lib_out

    stamp("3b")
    # 3c. Adam kernel vs plain -------------------------------------------
    leaves = adam_ab.kernel_leaf_shapes()
    check(len(leaves) == 9, f"{len(leaves)} Adam kernel leaves at vocab "
          f"32000, expected 9")
    hyper = dict(lr=8e-4, b1=0.9, b2=0.999, eps=1e-8)
    c1, c2 = bias_corrections(torch.tensor(3, device=dev), 0.9, 0.999)
    corr = torch.stack([c1, c2])

    def hold_adam(table, what):
        """One call of the multi-leaf kernel on copies of ``table`` against
        the plain rule leaf by leaf: launches and max|d| of p, m, v."""
        want = [[x.clone() for x in leaf[:3]] for leaf in table]
        got = [[x.clone() for x in leaf[:3]] for leaf in table]
        for (p, m, vv), (*_, g) in zip(want, table):
            padam._leaf_plain(p, m, vv, g, c1, c2, **hyper)
        before = padam.launches
        padam._adam_leaves_pallas(*map(list, zip(*got)),
                                  [leaf[3] for leaf in table], corr, **hyper)
        torch.cuda.synchronize()
        n_launch = padam.launches - before
        want_launch = -(-len(table) // adam_table)
        check(n_launch == want_launch, f"adam {what}: {n_launch} launches for "
              f"{len(table)} leaves, expected {want_launch}")
        errs = {name: max((a[i] - b[i]).abs().max().item()
                          for a, b in zip(got, want))
                for i, name in enumerate("pmv")}
        bitwise = all(torch.equal(x, y) for a, b in zip(got, want)
                      for x, y in zip(a, b))
        for name, err in errs.items():
            check(err <= TOL_ADAM, f"adam {what} {name}: max|d|={err:.3g} > "
                  f"{TOL_ADAM}")
        print(f"adam {what}: {len(table)} leaves, {n_launch} launch(es), "
              f"max|d| p {errs['p']:.3g} m {errs['m']:.3g} v {errs['v']:.3g}, "
              f"bitwise {bitwise} {card}")
        return max(errs.values()), bitwise

    adam_lib = _ext.library("adam")
    adam_table = adam_lib.ddl_adam_table_size()
    chunk = adam_lib.ddl_adam_chunk()
    state = adam_ab.random_leaves(leaves, dev, gen)
    adam_err = padam.smoke_check(atol=TOL_ADAM)
    err, adam_bitwise = hold_adam(state, "9 training leaves")
    adam_err = max(adam_err, err)
    ragged = {"one leaf": [(65536 + 512,)],
              "ragged table": [(4,), (512,), (65536 + 512,), (chunk - 512,),
                               (chunk + 512,)],
              "more leaves than a table": [(4,), (512,), (chunk + 512,), (8,),
                                           (chunk - 512,), (1028,)] * 8
              + [(chunk,), (4,)]}
    for what, sizes in ragged.items():
        err, same = hold_adam(adam_ab.random_leaves(sizes, dev, gen),
                              what)
        adam_err = max(adam_err, err)
        adam_bitwise &= same
    n_adam = sum(p.numel() for p, *_ in state)
    cols = [list(x) for x in zip(*state)]
    kernel_step = lambda: padam._adam_leaves_pallas(*cols, corr, **hyper)
    adam_us = time_us(kernel_step, reps=50, burst=5)
    adam_plain_us = time_us(lambda: [padam._leaf_plain(
        p, m, vv, g, c1, c2, **hyper) for p, m, vv, g in state], reps=20,
        burst=2)
    steps = [torch.tensor(3.0, device=dev) for _ in state]
    fused_step = lambda: torch._fused_adam_(
        cols[0], cols[3], cols[1], cols[2], [], steps, lr=8e-4, beta1=0.9,
        beta2=0.999, weight_decay=0.0, eps=1e-8, amsgrad=False,
        maximize=False)
    fused_us = time_us(fused_step, reps=50, burst=5)
    adam_bound_us = 28 * n_adam / HBM_BYTES_PER_S * 1e6
    print(f"adam: {len(state)} leaves, {n_adam} elements, max|d| p/m/v "
          f"{adam_err:.3g} over every table (smoke_check 972x512 included), "
          f"bitwise {adam_bitwise}; kernel {adam_us:.1f} us per step (one "
          f"launch, chunks of {chunk}), plain {adam_plain_us:.1f} us, "
          f"torch._fused_adam_ {fused_us:.1f} us, bound {adam_bound_us:.1f} "
          f"us (bytes) {card}")
    # The kernel and the library call in turns, each time 100 calls: the
    # order alternates between pairs, so drift between the two sets of
    # calls shows in both.
    pairs_k, pairs_f = [], []
    for i in range(7):
        order = ((kernel_step, pairs_k), (fused_step, pairs_f))
        for fn, dst in (order if i % 2 == 0 else order[::-1]):
            dst.append(time_us(fn, reps=100, burst=5))
    ratios = [k / f for k, f in zip(pairs_k, pairs_f)]
    tb_s = lambda us: 28 * n_adam / (us * 1e-6) / 1e12
    adam_pairs = {
        "pairs": 7, "calls_per_side": 100,
        "kernel_us": pairs_k, "fused_adam_us": pairs_f,
        "kernel_median_us": statistics.median(pairs_k),
        "fused_adam_median_us": statistics.median(pairs_f),
        "kernel_spread_us": [min(pairs_k), max(pairs_k)],
        "fused_adam_spread_us": [min(pairs_f), max(pairs_f)],
        "ratio_median": statistics.median(ratios),
        "ratio_spread": [min(ratios), max(ratios)],
        "kernel_tb_per_s": tb_s(statistics.median(pairs_k)),
        "fused_adam_tb_per_s": tb_s(statistics.median(pairs_f)),
        "bound_us": adam_bound_us}
    print(f"adam paired, 7 pairs of 100 calls in turns: kernel median "
          f"{adam_pairs['kernel_median_us']:.1f} us (spread "
          f"{min(pairs_k):.1f}-{max(pairs_k):.1f}), torch._fused_adam_ "
          f"median {adam_pairs['fused_adam_median_us']:.1f} us (spread "
          f"{min(pairs_f):.1f}-{max(pairs_f):.1f}); kernel / library per "
          f"pair median {adam_pairs['ratio_median']:.4f} (spread "
          f"{min(ratios):.4f}-{max(ratios):.4f}); "
          f"{adam_pairs['kernel_tb_per_s']:.3f} TB/s against "
          f"{adam_pairs['fused_adam_tb_per_s']:.3f}, bound "
          f"{adam_bound_us:.1f} us at 3.35 TB/s {card}")
    del state, cols

    stamp("3c")
    # 4. forward at full width (the main path of the kernel) -------------
    cfg = LlamaConfig()
    wgen = torch.Generator()
    wgen.manual_seed(0)
    model = llama.init_llama(cfg, wgen, device=dev)
    tgen = torch.Generator(device=dev)
    tgen.manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (8, cfg.ctx_size),
                           generator=tgen, device=dev)
    plain_cfg = cfg.replace(attention_impl="xla")
    with torch.inference_mode():
        fa.launches = 0
        logits = llama.forward(model, tokens, cfg)
        torch.cuda.synchronize()
        main_launches = fa.launches
        check(main_launches == cfg.n_layers,
              f"forward launched flash_fwd {main_launches} times, expected "
              f"{cfg.n_layers} (one per layer)")
        plain = llama.forward(model, tokens, plain_cfg)
        check(fa.launches == main_launches, "the plain path launched the "
              "kernel")
        check(tuple(logits.shape) == (8, cfg.ctx_size, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()),
              f"forward logits shape {tuple(logits.shape)} or non-finite")
        ferr = (logits - plain).abs().max().item()
        check(ferr <= TOL_LOGITS, f"forward logits kernel vs plain "
              f"max|d|={ferr:.3g} > {TOL_LOGITS}")
        fwd = {}
        for name, c in (("kernel", cfg), ("plain", plain_cfg)):
            call = lambda c=c: llama.forward(model, tokens, c)
            fwd[name] = (wall_us(call), time_us(call, reps=20, burst=2))
    n_tok = tokens.numel()
    print(f"forward B=8 T={cfg.ctx_size}: flash_fwd launches {main_launches} "
          f"per forward; logits max|d| kernel vs plain {ferr:.3g} {card}")
    for name, (wall, device) in fwd.items():
        print(f"forward ({name} attention): {n_tok / wall * 1e6:.0f} tok/s "
              f"wall ({wall / 1e3:.3f} ms per forward), device "
              f"{device / 1e3:.3f} ms per forward {card}")

    # Heads wider than the kernels take (2 heads of 144 at dmodel 288, 2
    # layers): "auto" runs the plain attention, "pallas" raises.
    wcfg = LlamaConfig(num_heads=2, n_layers=2)
    check(not fa.kernel_takes(wcfg.head_dim), f"head dim {wcfg.head_dim}")
    wide = llama.init_llama(wcfg, torch.Generator().manual_seed(0), device=dev)
    with torch.inference_mode():
        fa.launches = 0
        wide_auto = llama.forward(wide, tokens, wcfg)
        wide_plain = llama.forward(wide, tokens,
                                   wcfg.replace(attention_impl="xla"))
        torch.cuda.synchronize()
        wide_launches = fa.launches
        try:
            llama.forward(wide, tokens, wcfg.replace(attention_impl="pallas"))
            wide_refusal = None
        except ValueError as e:
            wide_refusal = str(e)
    wide_err = (wide_auto - wide_plain).abs().max().item()
    check(wide_launches == 0, f"Dh={wcfg.head_dim} 'auto' launched the "
          f"forward kernel {wide_launches} times")
    check(bool(torch.isfinite(wide_auto).all()) and wide_err <= TOL_LOGITS,
          f"Dh={wcfg.head_dim} forward 'auto' vs 'xla' max|d|={wide_err:.3g}")
    check(wide_refusal is not None and str(fa.MAX_HEAD_DIM) in wide_refusal,
          f"Dh={wcfg.head_dim} 'pallas': {wide_refusal!r}, expected a "
          f"refusal naming {fa.MAX_HEAD_DIM}")
    print(f"forward B=8 T={cfg.ctx_size} Dh={wcfg.head_dim} (2 heads, 2 "
          f"layers): 'auto' vs 'xla' max|d| {wide_err:.3g} (bitwise "
          f"{bool(torch.equal(wide_auto, wide_plain))}), flash_fwd launches "
          f"{wide_launches}; 'pallas' raises: {wide_refusal} {card}")
    del wide, wide_auto, wide_plain

    stamp("4")
    # 5. serving at full width -------------------------------------------
    paged = PagedKVConfig(num_blocks=129, block_len=16, max_blocks_per_seq=16)
    wl = synthetic_workload(seed=0, n_requests=32, rate_rps=50.0,
                            vocab_size=cfg.vocab_size,
                            prompt_lens=(16, 64, 192), max_news=(16, 32, 64),
                            temperatures=(0.0, 0.8))
    fa.launches = 0
    rep = run_serving(model, cfg, paged, wl, num_slots=8, prefill_chunk=16,
                      device=dev)
    torch.cuda.synchronize()
    serve_launches = fa.launches
    check(rep.aggregates["completed"] == len(wl),
          f"served {rep.aggregates['completed']} of {len(wl)} requests")
    for r in wl:
        n = len(rep.records[r.rid].tokens)
        check(n == r.max_new, f"{r.rid}: {n} tokens, max_new {r.max_new}")
    exact = near_tie = 0
    for r in wl:
        if r.temperature > 0:
            continue
        got = rep.records[r.rid].tokens
        ref = reference_stream(model, cfg, paged, r, device=dev)
        if got == ref:
            exact += 1
            continue
        i = next(j for j, (a, b) in enumerate(zip(got, ref)) if a != b)
        seq = torch.tensor([list(r.prompt) + ref[:i]], device=dev)
        with torch.inference_mode():
            last = llama.forward(model, seq, plain_cfg)[0, -1]
        top2 = torch.topk(last, 2).values
        gap = (top2[0] - top2[1]).item()
        check(gap < NEAR_TIE, f"{r.rid}: stream differs from generate() at "
              f"token {i} where the reference's top-2 gap is {gap:.3g}")
        near_tie += 1
    agg = rep.aggregates
    print(f"serving: {agg['completed']}/{len(wl)} requests, "
          f"{agg['total_tokens']} tokens; greedy streams equal to generate(): "
          f"{exact} exact, {near_tie} near-tie; sustained "
          f"{agg['sustained_tokens_per_sec']:.0f} tok/s, TTFT p50 "
          f"{agg['ttft_s']['p50'] * 1e3:.1f} ms p99 "
          f"{agg['ttft_s']['p99'] * 1e3:.1f} ms, peak blocks "
          f"{rep.peak_blocks_in_use}/{rep.pool_blocks}, decode tokens per "
          f"dispatch {rep.tokens_per_dispatch:.2f}, flash_fwd launches "
          f"{serve_launches} (paged attention is plain PyTorch) {card}")

    stamp("5")
    # 6. training step at full width (the training main path) ------------
    tcfg = LlamaConfig(dtype="bfloat16", attention_impl="pallas",
                       flash_dh_major=True, flash_block=512)
    tb, tseq, warm, timed = 64, tcfg.ctx_size, 2, 5

    zero_counts()
    tok_s = bench_utils.time_train_step(tcfg, tb, seq=tseq, opt_name="pallas",
                                        warmup=warm, timed_steps=timed,
                                        device=dev)
    counts = read_counts()
    per_step = {k: n / (warm + timed) for k, n in counts.items()}
    want = {"flash_fwd": tcfg.n_layers, "flash_bwd_dq": tcfg.n_layers,
            "flash_bwd_dkv": tcfg.n_layers, "adam": 1}
    check(per_step == want, f"train step launches per step {per_step}, "
          f"expected {want}")
    # Device time: the kernels' summed durations in a profiled window. A
    # step launches ~2,300 kernels, more than the launch queue holds, so
    # steps cannot be queued behind a GPU sleep as time_us does: the host
    # would block and pace the device.
    prof = profile_step.profile(tb, steps=3, device=dev)
    step_loss = prof["loss"]
    check(math.isfinite(step_loss), f"train step loss {step_loss}")
    step_kernel_ms = prof["kernel_ms_per_step"]
    flops_tok = train_flops_per_token(tcfg, tseq)
    n_tok = tb * tseq
    step_wall_ms = n_tok / tok_s * 1e3
    mfu_wall = flops_tok * tok_s / PEAK_FLOPS[torch.bfloat16]
    mfu_dev = flops_tok * n_tok / (step_kernel_ms * 1e-3) / \
        PEAK_FLOPS[torch.bfloat16]
    print(f"train step B={tb} T={tseq} bf16 flash dh-major + fused Adam: "
          f"launches per step {per_step}; loss {step_loss:.4f}; "
          f"{tok_s:.0f} tok/s wall ({step_wall_ms:.2f} ms per step); kernels "
          f"{step_kernel_ms:.2f} ms per step ({prof['kernels_per_step']:.0f} "
          f"launches; one Adam launch per kernel leaf would make "
          f"{prof['kernels_per_step'] + 8:.0f}), device busy "
          f"{step_kernel_ms / step_wall_ms:.3f} of the "
          f"wall step; {flops_tok / 1e6:.1f} MFLOP/token, MFU "
          f"{mfu_wall:.4f} wall / {mfu_dev:.4f} at kernel time vs 989 "
          f"TFLOP/s bf16 {card}")
    print(f"train step kernel ms per step by category: "
          f"{json.dumps(prof['ms_per_step_by_category'])} {card}")

    # The kernel path against the plain path, fp32, B=8.
    kcfg = LlamaConfig(attention_impl="pallas", flash_dh_major=True)
    pcfg = kcfg.replace(attention_impl="xla")
    tgen.manual_seed(3)
    toks8 = torch.randint(0, kcfg.vocab_size, (8, tseq), generator=tgen,
                          device=dev)
    m32 = llama.init_llama(kcfg, torch.Generator().manual_seed(0),
                           device=dev)
    leaves32 = tree_leaves(m32.tree())
    lk = llama.forward_loss(m32, toks8, kcfg)
    gk = torch.autograd.grad(lk, leaves32)
    lp = llama.forward_loss(m32, toks8, pcfg)
    gp = torch.autograd.grad(lp, leaves32)
    loss_err = abs(lk.item() - lp.item())
    grad_err = max(((a - r).abs().max() / r.abs().max()).item()
                   for a, r in zip(gk, gp))
    check(loss_err <= TOL_TRAIN_LOSS, f"train loss kernel vs plain "
          f"|d|={loss_err:.3g} > {TOL_TRAIN_LOSS}")
    check(grad_err <= TOL_TRAIN_GRAD, f"train grads kernel vs plain "
          f"max|d|/max|ref|={grad_err:.3g} > {TOL_TRAIN_GRAD}")
    n_leaves = len(leaves32)
    del m32, leaves32, gk, gp

    def trajectory(c, opt_name):
        model_t = llama.init_llama(c, torch.Generator().manual_seed(0),
                                   device=dev)
        opt = bench_utils.make_optimizer(opt_name)
        st = dp.init_state(model_t.tree(), opt)
        fn = dp.make_grad_aggregation_step(
            lambda p, batch: llama.forward_loss(p, batch, c), opt)
        g = torch.Generator(device=dev)
        g.manual_seed(4)
        out = []
        for _ in range(5):
            batch = torch.randint(0, c.vocab_size, (8, tseq), generator=g,
                                  device=dev)
            st, loss = fn(st, batch)
            out.append(float(loss))
        return out

    traj_k = trajectory(kcfg, "pallas")
    traj_p = trajectory(pcfg, "fused")
    traj_err = max(abs(a - b) for a, b in zip(traj_k, traj_p))
    check(traj_err <= TOL_TRAJECTORY, f"5-step loss trajectory kernel vs "
          f"plain max|d|={traj_err:.3g} > {TOL_TRAJECTORY}")
    print(f"train step fp32 B=8, kernel path vs plain path: loss |d| "
          f"{loss_err:.3g}, grads max|d|/max|ref| {grad_err:.3g} over "
          f"{n_leaves} leaves; 5-step losses kernel "
          f"{[round(x, 5) for x in traj_k]} vs "
          f"plain {[round(x, 5) for x in traj_p]}, max|d| {traj_err:.3g} "
          f"{card}")

    # The kernel path against the plain path, bf16 compute, B=8: the
    # tensor-core forward, dQ and dK/dV kernels inside the model.
    bkcfg = kcfg.replace(dtype="bfloat16")
    bpcfg = bkcfg.replace(attention_impl="xla")
    mb = llama.init_llama(bkcfg, torch.Generator().manual_seed(0),
                          device=dev)
    leaves_b = tree_leaves(mb.tree())
    lk = llama.forward_loss(mb, toks8, bkcfg)
    gk = torch.autograd.grad(lk, leaves_b)
    lp = llama.forward_loss(mb, toks8, bpcfg)
    gp = torch.autograd.grad(lp, leaves_b)
    loss_err_bf16 = abs(lk.item() - lp.item())
    grad_err_bf16 = max(((a.float() - r.float()).abs().max()
                         / r.float().abs().max()).item()
                        for a, r in zip(gk, gp))
    check(math.isfinite(loss_err_bf16) and
          loss_err_bf16 <= TOL_TRAIN_LOSS_BF16, f"bf16 train loss kernel vs "
          f"plain |d|={loss_err_bf16:.3g} > {TOL_TRAIN_LOSS_BF16}")
    check(math.isfinite(grad_err_bf16) and
          grad_err_bf16 <= TOL_TRAIN_GRAD_BF16, f"bf16 train grads kernel "
          f"vs plain max|d|/max|ref|={grad_err_bf16:.3g} > "
          f"{TOL_TRAIN_GRAD_BF16}")
    print(f"train step bf16 B=8, kernel path vs plain path: loss "
          f"{lk.item():.5f} vs {lp.item():.5f} |d| {loss_err_bf16:.3g}, "
          f"grads max|d|/max|ref| {grad_err_bf16:.3g} over {len(leaves_b)} "
          f"leaves {card}")
    del mb, leaves_b, gk, gp

    stamp("6")
    # 7. the trainer entry point ------------------------------------------
    iters = 20
    zero_counts()
    t0 = time.perf_counter()
    rep = train_llm_dp(None, TrainConfig(optimizer="pallas", iters=iters),
                       log_every=10, device=None)
    trainer_s = time.perf_counter() - t0
    tcounts = read_counts()
    tper = {k: n / iters for k, n in tcounts.items()}
    twant = {"flash_fwd": 6, "flash_bwd_dq": 6, "flash_bwd_dkv": 6,
             "adam": 1}
    check(len(rep.losses) == iters and all(math.isfinite(x)
                                           for x in rep.losses),
          f"train_llm_dp losses {rep.losses}")
    check(tper == twant, f"train_llm_dp launches per step {tper}, expected "
          f"{twant}")
    dp_losses = rep.losses
    print(f"train_llm_dp (byte tokenizer, vocab 259, batch 3 x 256, "
          f"optimizer pallas): {iters} steps in {trainer_s:.1f} s, loss "
          f"{rep.losses[0]:.4f} -> {rep.losses[-1]:.4f}, "
          f"{rep.tokens_per_sec:.0f} tok/s after warmup; launches per step "
          f"{tper} {card}")

    stamp("7")
    # 10. multi-process data parallelism, two ranks on the card ----------
    dp_report = dp_phase(dev, card, tok_s, step_wall_ms)

    stamp("10")
    # 11. serving extensions (no port kernel but the deploy trainer's) ---
    ext_report = serving_ext_phase(dev, card, model, cfg, zero_counts,
                                   read_counts)

    stamp("11")
    # 12. resilience and telemetry, remat ---------------------------------
    res_report = resilience_phase(dev, card, zero_counts, read_counts,
                                  model, cfg, dp_report, mnist_arrays)

    stamp("12")
    # 13. pipeline parallelism, three and six stage processes -------------
    pp_report = pp_phase(dev, card, dp_losses)

    stamp("13")
    # 14. fleet-scale FL and the autoscaler's serving side (no port kernel)
    zero_counts()
    t0 = time.perf_counter()
    fleet_report = fleet_phase(dev, card, mnist_arrays)
    fleet_report["autoscale"] = autoscale_phase(dev, card, model, cfg)
    fleet_report["phase_s"] = time.perf_counter() - t0
    fleet_counts = read_counts()
    check(not any(fleet_counts.values()), f"phase 14 launched port kernels: "
          f"{fleet_counts}")
    print(f"fleet/autoscale phase: {fleet_report['phase_s']:.1f} s, port "
          f"kernel launches {fleet_counts} {card}")

    stamp("14")
    # 15. compressed and overlapped gradient sync, 2 and 2 x 2 ranks ------
    comm_report = comm_phase(dev, card)

    stamp("15")
    # 16. tensor parallelism, 2 and 2 x 2 ranks --------------------------
    tp_report = tp_phase(dev, card)

    stamp("16")
    # 17. sequence and expert parallelism, four ranks; long context -------
    spep_report = sp_ep_phase(dev, card)

    stamp("17")
    # 18. elastic data parallelism, a pool of four ranks ----------------
    elastic_report = elastic_phase(dev, card)

    stamp("18")
    # 19. DP×PP ring drivers; elastic PP and TP, a pool of four ranks -----
    pp19_report = pp_elastic_phase(dev, card)
    stamp("19")
    # 20. DP×PP×TP on 1 x 2 x 2 and 2 x 2 x 2 ranks; decode -----------
    pptp_report = pp_tp_phase(dev, card)
    stamp("20")
    total_s = time.perf_counter() - t_start
    print(f"chip_smoke: every phase passed in {total_s:.1f} s {card}")

    fwd_main = next(x for x in layouts if x["shape"] == [64, 256, 6, 48])
    bwd_main = bwd[0]
    path_counts = {"forward (phase 4)": {"flash_fwd": main_launches},
                   "train step (phase 6), per step": per_step,
                   "train_llm_dp (phase 7), per step": tper,
                   "fl (phase 8), whole phase": fl_counts,
                   "tabular/vfl/dp/secagg (phase 9)": tab_counts,
                   "train_llm_dp data=2 (phase 10), per rank per step":
                       dp_report["parts"]["trainer"]["launches"],
                   "serving extensions (phase 11), each run":
                       {"flash_fwd": 0, "flash_bwd_dq": 0,
                        "flash_bwd_dkv": 0, "adam": 0},
                   "deploy trainer (phase 11), per step":
                       ext_report["deploy"]["launches_per_step"],
                   "guarded train_llm_dp (phase 12a), per step":
                       res_report["guard"]["launches_per_step"],
                   "faulted, observed train_llm_dp (phase 12b), 16 steps "
                   "and the comm probe": res_report["faults"]["launches"],
                   "remat train step (phase 12f), per step":
                       res_report["remat"]["launches_per_step"]["remat"],
                   "serving census (phase 12g), two runs":
                       {"flash_fwd": 0, "flash_bwd_dq": 0,
                        "flash_bwd_dkv": 0, "adam": 0},
                   **{f"pp {sched} bf16 M=6 (phase 13b), per stage per step":
                      pp_report["ranks"][0]["timing"][sched]["launches"]
                      for sched in ("gpipe", "1f1b", "interleaved")},
                   "train_llm_pp stage=3 (phase 13c), per stage per step":
                       pp_report["ranks"][0]["b1"]["launches"],
                   "train_llm_pp data=2 stage=3 (phase 13c), per rank per "
                   "step": pp_report["b2"][0]["launches"],
                   "fleet FL and autoscaler (phase 14), whole phase":
                       fleet_counts,
                   **{f"ring step {k} bf16 B=32 (phase 15b), per rank per "
                      f"step": v["launches_per_step"]
                      for k, v in comm_report["grid"].items()},
                   **{f"hier 2x2 {k} (phase 15c), per rank per step":
                      v["launches_per_step"]
                      for k, v in comm_report["hier"].items()},
                   "train_llm_dp data=2 M=2 int8_ef zero1 (phase 15d), per "
                   "rank per step": comm_report["trainer"]["data2"][
                       "launches"],
                   "train_llm_dp dcn=2 data=2 (phase 15d), per rank per "
                   "step": comm_report["trainer"]["dcn2"]["launches"],
                   **{f"tp model=2 psa={'off' if k == 'tp' else k} bf16 B=32 "
                      f"(phase 16c/d), per rank per step": v["launches_per_step"]
                      for k, v in tp_report["grid"].items()
                      if k != "world of one"},
                   **{f"tp 2x2 ring int8_ef zero1 {k} (phase 16e), per rank "
                      f"per step": v["launches_per_step"]
                      for k, v in tp_report["ring"].items()},
                   "train_llm_tp model=2 psa=int8_ef K=2 (phase 16f), per "
                   "rank per step": tp_report["trainer"]["model2"][
                       "launches"],
                   "train_llm_tp data=2 model=2 M=2 zero1 (phase 16f), per "
                   "rank per step": tp_report["trainer"]["data2"][
                       "launches"],
                   "sp ring 4 bf16 B=2 x 1024 (phase 17b), per rank per "
                   "step": spep_report["sp_time"]["grid"]["sp ring 4"][
                       "launches"],
                   "ep expert=2 bf16 B=8 x 256 (phase 17d), per rank per "
                   "step": spep_report["ep_time"]["grid"]["ep expert 2"][
                       "launches"],
                   **{f"elastic train_llm_dp 4 -> 3 -> 4 {what} (phase "
                      f"18{leg}), per rank per step, world by world":
                      elastic_report[leg]["launches"]
                      for leg, what in (("b", "gradient"),
                                        ("d", "int8_ef ring zero1"))},
                   "elastic train_llm_dp scale_hook 4 -> 2 -> 4 (phase "
                   "18c), per rank per step, world by world":
                       elastic_report["c"]["launches"],
                   **{f"pp 2x2 bf16 B=16 {k} (phase 19a), stage 0 per step":
                      v["launches"] for k, v in pp19_report["timing"].items()},
                   **{f"elastic {k} (phase 19{k[0]}), per rank per step, "
                      f"world by world": pp19_report[k]["launches"]
                      for k in ("b_stage", "b_trip", "b_rows", "c_rows")},
                   **{f"{k} bf16 B=16 (phase 20a), rank 0 per step": v
                      for k, v in pptp_report["a"]["launches"].items()},
                   **{f"pp 2x2x2 {k} bf16 B=16 (phase 20b), rank 0 per "
                      f"step": v
                      for k, v in pptp_report["b"]["launches"].items()},
                   "train_llm_pp mesh 2x2x2 (phase 20b), per rank per step":
                       pptp_report["b"]["trainer"]["launches"]}
    kernels = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "ddl25spring_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": fwd_main["replaces"],
        "launches": per_step["flash_fwd"],
        "max_abs_err": fwd_main["max_abs_err"],
        "ms": fwd_main["kernel_us"] / 1e3,
        "plain_ms": fwd_main["plain_us"] / 1e3,
        "bound_ms": fwd_main["bound_us"] / 1e3,
        "bound_by": fwd_main["bound_by"],
        "library_ms": fwd_main["sdpa_us"] / 1e3,
        "design": DESIGN["flash_fwd"],
        "ptxas": {k: v for k, v in ptxas.items()
                  if "flash_fwd" in k and re.search(r"\b48\b", k)},
        "tf32_hmma_sass": {k: v for k, v in hmma.items()
                           if k.startswith("flash_fwd_tf32")},
        "layouts": layouts}]
    for name, key, src_line in (("flash_bwd_dq", "dq", 450),
                                ("flash_bwd_dkv", "dkv", 480)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "ddl25spring_tpu_torch/ops/csrc/flash_bwd.cu",
            "replaces": f"ddl25spring_tpu/ops/flash_attention.py:{src_line}",
            "launches": per_step[name],
            "max_abs_err": (bwd_main["max_abs_err"]["dq"] if key == "dq"
                            else max(bwd_main["max_abs_err"]["dk"],
                                     bwd_main["max_abs_err"]["dv"])),
            "ms": bwd_main[f"{key}_us"] / 1e3,
            "plain_ms": bwd_main["plain_us"] / 1e3,
            "bound_ms": bwd_main[f"{key}_bound_us"] / 1e3,
            "bound_by": bwd_main[f"{key}_bound_by"],
            "library_ms": bwd_main["sdpa_bwd_us"] / 1e3,
            "plain_and_library_compute": "dq, dk and dv together",
            "design": DESIGN[name],
            "ptxas": {k: v for k, v in ptxas.items()
                      if f"{name}_" in k and re.search(r"\b48\b", k)},
            "tf32_hmma_sass": {k: v for k, v in hmma.items()
                               if k.startswith(f"{name}_tf32")},
            "cases": bwd})
    kernels.append({
        "name": "adam", "route": "cuda",
        "source": "ddl25spring_tpu_torch/ops/csrc/adam.cu",
        "replaces": "ddl25spring_tpu/ops/pallas_adam.py:50",
        "launches": per_step["adam"], "max_abs_err": adam_err,
        "ms": adam_us / 1e3, "plain_ms": adam_plain_us / 1e3,
        "bound_ms": adam_bound_us / 1e3, "bound_by": "bytes",
        "library_ms": fused_us / 1e3,
        "paired_ms": adam_pairs["kernel_median_us"] / 1e3,
        "paired_library_ms": adam_pairs["fused_adam_median_us"] / 1e3,
        "paired_ratio": adam_pairs["ratio_median"],
        "bitwise_plain": adam_bitwise, "chunk": chunk,
        "design": DESIGN["adam"],
        "times_cover": f"one train step: {len(leaves)} leaves, "
                       f"{n_adam} elements, one launch"})
    # K2, K5 and K6 at a TP shard's shape (phase 16b) and at the long
    # context's (phase 17e).
    for key, rep in (("tp_shape", tp_report), ("longctx_shape", spep_report)):
        k16 = rep["kernels"]
        f16, b16 = k16["fwd"], k16["bwd"]
        for kern, part in zip(kernels[:3], ("fwd", "dq", "dkv")):
            if part == "fwd":
                kern[key] = {
                    "shape": k16["shape"], "ms": f16["kernel_us"] / 1e3,
                    "bound_ms": f16["bound_us"] / 1e3,
                    "bound_by": f16["bound_by"],
                    "plain_ms": f16["plain_us"] / 1e3,
                    "library_ms": f16["sdpa_us"] / 1e3,
                    "max_abs_err": f16["max_abs_err"],
                    "lse_max_abs_err": f16["lse_max_abs_err"]}
            else:
                kern[key] = {
                    "shape": k16["shape"], "ms": b16[f"{part}_us"] / 1e3,
                    "bound_ms": b16[f"{part}_bound_us"] / 1e3,
                    "bound_by": b16[f"{part}_bound_by"],
                    "plain_ms": b16["plain_us"] / 1e3,
                    "library_ms": b16["sdpa_bwd_us"] / 1e3,
                    "max_abs_err": b16["max_abs_err"]}
    print(json.dumps({"kernels": kernels, "launches_by_path": path_counts,
                      "train_step": {
                          "tokens_per_sec_wall": tok_s,
                          "wall_ms_per_step": step_wall_ms,
                          "kernel_ms_per_step": step_kernel_ms,
                          "mfu_wall": mfu_wall, "mfu_kernel_time": mfu_dev,
                          "loss": step_loss, "profile": prof,
                          "bf16_b8_kernel_vs_plain": {
                              "loss_abs_err": loss_err_bf16,
                              "grad_rel_err": grad_err_bf16}},
                      "fl": fl_report, "tabular": tab_report,
                      "dp": dp_report, "serving_ext": ext_report,
                      "resilience": res_report, "pp": pp_report,
                      "fleet": fleet_report, "comm": comm_report,
                      "tp": tp_report, "sp_ep": spep_report,
                      "elastic": elastic_report,
                      "pp_elastic": pp19_report, "pp_tp": pptp_report,
                      "adam_paired": adam_pairs,
                      "phase_seconds": phase_seconds,
                      "total_seconds": total_s, "card": smi,
                      "ok": True}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
