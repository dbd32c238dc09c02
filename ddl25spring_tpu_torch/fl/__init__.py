"""Horizontal federated learning: counterpart of the JAX package's ``fl``
(servers, FedProx, attacks and Byzantine defenses; privacy, secure
aggregation and the fleet engine are not ported yet)."""

from .federated_data import FederatedDataset, federate  # noqa: F401
from .fedprox import FedProxServer  # noqa: F401
from .servers import (  # noqa: F401
    CentralizedServer,
    FedAvgGradServer,
    FedAvgServer,
    FedSgdGradientServer,
    FedSgdWeightServer,
)
