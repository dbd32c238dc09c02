"""Training data: token streams (``tokens``, and ``native``: the same
batches from the checkout's C++ engine) and MNIST (``mnist``)."""
from . import mnist, native, tabular, tokens  # noqa: F401
