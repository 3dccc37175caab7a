"""The LM training loop (the port of ``repro.train``)."""
from repro_torch.train.loop import TrainConfig, TrainResult, train

__all__ = ["TrainConfig", "TrainResult", "train"]
