"""tiny-Llama (``llama``), its Mixture-of-Experts variant (``moe``), its
autoregressive decoding (``generate``), the
MNIST CNN of horizontal FL (``mnist_cnn``), the tabular classifier
(``tabular``), the tabular VAE (``vae``) and the vertical-FL stack
(``vfl_nets``)."""

from . import generate, llama, mnist_cnn, moe, tabular, vae, vfl_nets  # noqa: F401
