"""tiny-Llama (``llama``) and its autoregressive decoding (``generate``)."""
