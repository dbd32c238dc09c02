"""Federated learning: counterpart of the JAX package's ``fl`` (servers,
FedProx, attacks and Byzantine defenses, DP-FedAvg and secure
aggregation; the fleet engine is not ported yet)."""

from .federated_data import FederatedDataset, federate  # noqa: F401
from .fedprox import FedProxServer  # noqa: F401
from .privacy import (DPFedAvgServer, dp_epsilon,  # noqa: F401
                      dp_epsilon_tight, privacy_spend)
from .secure_agg import SecureAggFedAvgServer  # noqa: F401
from .servers import (  # noqa: F401
    CentralizedServer,
    FedAvgGradServer,
    FedAvgServer,
    FedSgdGradientServer,
    FedSgdWeightServer,
)
