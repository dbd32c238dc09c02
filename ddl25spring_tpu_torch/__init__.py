"""PyTorch/CUDA port of ``ddl25spring_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference: every module here keeps
the JAX function names and parameter-tree layout so each counterpart is
easy to find and the two can be held against each other on the same
weights and inputs (``tests/test_torch_*.py``). This package imports
neither ``jax`` nor ``ddl25spring_tpu``; what it needs of the reference's
host-side code it carries as its own copy.

Slices covered so far: inference — ``models.llama.forward`` (with the
hand-written CUDA flash-attention forward, ``ops/csrc/flash_fwd.cu``),
``models.generate.generate``, and the paged serving engine, scheduler and
front end (``serving/``); and training at a world of one process —
``llama.forward_loss`` (flash backward kernels ``ops/csrc/flash_bwd.cu``,
the fused loss head ``ops/losses.py``), Adam with the fused CUDA apply
(``ops/csrc/adam.cu``), ``parallel.dp``, ``bench_utils.time_train_step``
and ``train.llm.train_llm_dp``; multi-process data parallelism
(``parallel.distributed``: ranks as processes joined by gloo;
``parallel.dp``: gradient and weight aggregation, K-step dispatch,
ZeRO-1), fp32-master Adam (``ops.mixed_precision``) and checkpoints
(``checkpoint``), which add no kernel; and horizontal federated learning on the
MNIST CNN (``models.mnist_cnn``, ``data.mnist``, ``fl``: FedSGD, FedAvg,
FedProx and the centralized baseline, the Byzantine attacks and
defenses), which runs no hand-written kernel: its convolutions and
products are cuDNN and cuBLAS calls in fp32. Entry points take ``device=None``,
meaning CUDA; pass ``device="cpu"`` to run the plain PyTorch paths on the
CPU.
"""
