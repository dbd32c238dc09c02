"""Training entry points: ``train_llm_dp`` (``llm``), the tabular
classifier (``tabular``), vertical FL and the VFL-VAE (``vfl``), and the
VAE with the synthetic-data protocol (``generative``)."""

from .llm import train_llm_dp, LLMTrainReport  # noqa: F401
from .tabular import train_classifier, ClassifierReport  # noqa: F401
from .vfl import train_vfl, train_vfl_vae, VFLReport, VFLVAEReport  # noqa: F401
from .generative import (  # noqa: F401
    train_vae, synthetic_data_eval, VAEReport, SyntheticEvalResult)
