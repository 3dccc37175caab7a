"""Fitted profiling regressors compiled to array form (ridge, the MLP and
the GBT families); see :mod:`repro_torch.oracle.lowered`."""
from repro_torch.oracle.lowered import (LoweredLayerTimes, LoweredLinear,
                                        LoweredMLP, LoweredPredictor,
                                        LoweredTrees, lower_layer_times,
                                        lower_predictor)

__all__ = ["LoweredLayerTimes", "LoweredLinear", "LoweredMLP",
           "LoweredPredictor", "LoweredTrees", "lower_layer_times",
           "lower_predictor"]
