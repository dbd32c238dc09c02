"""Parallel training steps (``dp``: data parallelism at a world of one
process)."""
