"""Parallel training: ``dp`` (data-parallel steps), ``distributed`` (the
process group, rank launcher and collectives) and ``programs`` (what each
rank runs in the multi-rank checks)."""
