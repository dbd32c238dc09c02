"""Federated learning: counterpart of the JAX package's ``fl`` (servers,
FedProx, attacks and Byzantine defenses, DP-FedAvg, secure aggregation
and the cohort-streamed fleet engine)."""

from .federated_data import FederatedDataset, federate  # noqa: F401
from .fedprox import FedProxServer  # noqa: F401
from .fleet import (FederatedArraySource, FleetConfig,  # noqa: F401
                    FleetFedAvgServer, SyntheticFleetSource, TierPolicy,
                    vmapped_round_reference)
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
