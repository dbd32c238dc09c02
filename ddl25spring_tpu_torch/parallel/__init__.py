"""Parallel training: ``dp`` (data-parallel steps), ``compress`` (the
compressed and overlapped gradient sync, with ``ring_spec``, the numpy
statement of its ring), ``pp`` (pipeline stages), ``distributed`` (the
process group, rank launcher, layouts and collectives) and ``programs``
(what each rank runs in the multi-rank checks)."""
