"""Fitted profiling regressors compiled to array form (the GBT families
so far); see :mod:`repro_torch.oracle.lowered`."""
from repro_torch.oracle.lowered import (LoweredLayerTimes, LoweredPredictor,
                                        LoweredTrees, lower_layer_times,
                                        lower_predictor)

__all__ = ["LoweredLayerTimes", "LoweredPredictor", "LoweredTrees",
           "lower_layer_times", "lower_predictor"]
