"""Training entry points (``llm``: ``train_llm_dp``)."""
