"""The port's model zoo: the dense transformer and the Zamba2 hybrid."""
from repro_torch.models.registry import ModelAPI, build_model, param_count

__all__ = ["ModelAPI", "build_model", "param_count"]
