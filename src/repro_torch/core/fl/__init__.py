"""Federated profiling: FedAvg with differential privacy over the global
profiling model (paper §II-B; the port of ``repro.core.fl``)."""
from repro_torch.core.fl.dp import (DPConfig, clip_update, global_norm,
                                    privatise_update)
from repro_torch.core.fl.fedavg import (Client, FedAvgConfig, FedAvgResult,
                                        run_fedavg, split_clients)

__all__ = [
    "Client",
    "DPConfig",
    "FedAvgConfig",
    "FedAvgResult",
    "clip_update",
    "global_norm",
    "privatise_update",
    "run_fedavg",
    "split_clients",
]
