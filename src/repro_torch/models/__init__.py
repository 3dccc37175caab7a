"""The port's model zoo: the dense, MoE, MLA and VLM transformers, the
Zamba2 hybrid, xLSTM and whisper's encoder-decoder."""
from repro_torch.models.registry import ModelAPI, build_model, param_count

__all__ = ["ModelAPI", "build_model", "param_count"]
