"""Resilience: retry with backoff (``retry``). The step guard, fault plans
and preemption handling are ROADMAP.md queue A item 9."""
