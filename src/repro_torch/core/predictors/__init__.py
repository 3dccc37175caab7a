from repro_torch.core.predictors.common import (normalised_rmse,
                                                per_target_nrmse, r2, rmse)
from repro_torch.core.predictors.gbt import GBTRegressor, MultiTargetGBT
from repro_torch.core.predictors.linear import RidgeRegressor
from repro_torch.core.predictors.mlp import SIZE_PRESETS, MLPRegressor
from repro_torch.core.predictors.persist import (load_predictor,
                                                 save_predictor)

#: the ridge baseline under the paper's generic name
LinearRegressor = RidgeRegressor

__all__ = [
    "GBTRegressor",
    "MultiTargetGBT",
    "LinearRegressor",
    "MLPRegressor",
    "RidgeRegressor",
    "SIZE_PRESETS",
    "load_predictor",
    "save_predictor",
    "normalised_rmse",
    "per_target_nrmse",
    "r2",
    "rmse",
]
