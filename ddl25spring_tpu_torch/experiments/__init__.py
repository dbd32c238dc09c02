"""The port's twins of the JAX package's experiments whose modules are
ported, each beside its counterpart's name and run as ``python -m
ddl25spring_tpu_torch.experiments.<name>`` (on the card by default;
``--device cpu`` for the plain paths): ``fleet_smoke`` (a 100,000-client
cohort-streamed FedAvg round), ``serving_bench`` (the serving engine and
fleet under seeded Poisson traffic), ``memory_smoke`` (the byte
accounting of training and serving) and ``comm_wire_smoke`` (the
compressed and overlapped sync's wire bytes, accounting and overlap
evidence over four ranks), ``tp_fusion_smoke``, ``sp_bench`` (each
rank's peak memory over a sequence-parallel step against the ring size)
and ``longctx_bench`` (the train step's throughput at long sequence
lengths, flash and plain). Each writes a JSON result; the smokes exit
non-zero when one of their checks fails, and ``longctx_bench`` raises for
a point that fails."""
