from repro_torch.core.predictors.common import (normalised_rmse,
                                                per_target_nrmse, r2, rmse)
from repro_torch.core.predictors.gbt import GBTRegressor, MultiTargetGBT
from repro_torch.core.predictors.persist import (load_predictor,
                                                 save_predictor)

__all__ = [
    "GBTRegressor",
    "MultiTargetGBT",
    "load_predictor",
    "save_predictor",
    "normalised_rmse",
    "per_target_nrmse",
    "r2",
    "rmse",
]
