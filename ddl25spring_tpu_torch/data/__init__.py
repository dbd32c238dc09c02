"""Training data: token streams (``tokens``)."""
