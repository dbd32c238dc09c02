"""tiny-Llama (``llama``), its autoregressive decoding (``generate``), and
the MNIST CNN of horizontal FL (``mnist_cnn``)."""
