"""Parallel training: ``dp`` (data-parallel steps), ``compress`` (the
compressed and overlapped gradient sync, with ``ring_spec``, the numpy
statement of its ring), ``pp`` (pipeline stages), ``tp`` (tensor
parallelism), ``sp`` (sequence parallelism: ring attention), ``ep``
(expert parallelism of the MoE model), ``distributed`` (the
process group, rank launcher, layouts and collectives) and ``programs``
(what each rank runs in the multi-rank checks)."""
