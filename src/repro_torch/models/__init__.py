"""The port's model zoo: the dense, MoE, MLA and VLM transformers and the
Zamba2 hybrid."""
from repro_torch.models.registry import ModelAPI, build_model, param_count

__all__ = ["ModelAPI", "build_model", "param_count"]
