"""Training data: token streams (``tokens``) and MNIST (``mnist``)."""
