"""repro_torch.oracle — lowered predictor serving with online
profiling-in-the-loop (the port of ``repro.oracle``).

  * lowered  — fitted regressors compiled to array form (ridge, the MLP,
               the GBT families through ``kernels.tree_predict``);
  * online   — ``OnlineOracle`` (residual correction, Page–Hinkley drift
               detection, window refits on the card), ``OracleCost`` (the
               cost model the streaming scheduler plugs in);
  * registry — ``PredictorRegistry`` versioned snapshots with an atomic
               current-pointer swap and optional on-disk persistence.
"""
from repro_torch.oracle.lowered import (LoweredLayerTimes, LoweredLinear,
                                        LoweredMLP, LoweredPredictor,
                                        LoweredTrees, lower_layer_times,
                                        lower_predictor)
from repro_torch.oracle.online import OnlineOracle, OracleCost, PageHinkley
from repro_torch.oracle.registry import PredictorRegistry, Snapshot

__all__ = ["LoweredLayerTimes", "LoweredLinear", "LoweredMLP",
           "LoweredPredictor", "LoweredTrees", "lower_layer_times",
           "lower_predictor", "OnlineOracle", "OracleCost", "PageHinkley",
           "PredictorRegistry", "Snapshot"]
