"""Telemetry the serving path reports through: ``events`` (JSONL stream),
``trace`` (spans) and ``registry`` (percentiles)."""
