"""Compile fitted profiling regressors to pure array form.

The PyTorch twin of ``repro.oracle.lowered``: :func:`lower_predictor` maps
each fitted regressor family onto an equivalent array program on a torch
device —

  * :class:`~repro_torch.core.predictors.linear.RidgeRegressor` → one f64
    standardise + augmented dot;
  * :class:`~repro_torch.core.predictors.mlp.MLPRegressor` → the f32
    matmul chain with f32 (de)standardisation, the host ``predict``'s own
    dtypes (plain ``torch.matmul``: the reference computes it outside any
    Pallas kernel too);
  * :class:`~repro_torch.core.predictors.gbt.GBTRegressor` /
    ``MultiTargetGBT`` → flattened ``(feature, threshold_bin, left, right,
    value)`` node arrays walked by :mod:`repro_torch.kernels.tree_predict`
    — the CUDA ``tree_predict`` kernel on the card, its plain version on
    the CPU, both exact in f64 and bit for bit with the host ensemble.

:class:`LoweredLayerTimes` packages the lowered model with a
``PredictorCost``'s feature function, so the decision kernel path
(:mod:`repro_torch.kernels.decide_split.ops`) can rebuild the per-layer
device/edge time vectors on its own.  Models outside these families raise
``TypeError``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.predictors.gbt import GBTRegressor, MultiTargetGBT
from repro_torch.core.predictors.linear import RidgeRegressor, ridge_predict
from repro_torch.core.predictors.mlp import MLPRegressor, mlp_predict
from repro_torch.kernels.tree_predict.ops import predict_trees
from repro_torch.kernels.tree_predict.ref import TreeArrays, flatten_gbt


class LoweredPredictor:
    """A fitted regressor compiled to array form.  ``predict`` mirrors the
    host model's ``predict`` surface (``[N, F] -> [N]`` or ``[N, T]``) as
    f64 tensors on ``device``."""

    def predict(self, x, *, device: DeviceLike = None) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass
class LoweredLinear(LoweredPredictor):
    """Ridge: standardise + augmented dot, all f64."""
    x_mu: np.ndarray
    x_sd: np.ndarray
    w: np.ndarray                       # [F+1, T]

    @classmethod
    def lower(cls, model: RidgeRegressor) -> "LoweredLinear":
        return cls(model.x_mu_, model.x_sd_, model.w_)

    def predict(self, x, *, device: DeviceLike = None) -> torch.Tensor:
        return ridge_predict(x, self.x_mu, self.x_sd, self.w,
                             resolve_device(device))


@dataclasses.dataclass
class LoweredMLP(LoweredPredictor):
    """MLP: the f32 matmul chain and f32 (de)standardisation of the host
    forward; ``stats`` is ``(x_mu, x_sd, y_mu, y_sd)`` or None."""
    params: dict
    n_layers: int
    stats: Optional[tuple]

    @classmethod
    def lower(cls, model: MLPRegressor) -> "LoweredMLP":
        return cls(dict(model.params_), model.n_layers_, model._stats())

    def predict(self, x, *, device: DeviceLike = None) -> torch.Tensor:
        dev = resolve_device(device)
        pred = mlp_predict(x, self.params, self.n_layers, self.stats, dev)
        return pred.to(torch.float64)


@dataclasses.dataclass
class LoweredTrees(LoweredPredictor):
    """GBT ensemble over flattened node arrays — one :class:`TreeArrays`
    per target, dispatched through :mod:`repro_torch.kernels.tree_predict`."""
    arrays: tuple[TreeArrays, ...]
    multi_target: bool

    @classmethod
    def lower(cls, model) -> "LoweredTrees":
        if isinstance(model, MultiTargetGBT):
            return cls(tuple(flatten_gbt(m) for m in model.models_), True)
        return cls((flatten_gbt(model),), False)

    def predict(self, x, *, device: DeviceLike = None) -> torch.Tensor:
        cols = [predict_trees(x, a, device=device) for a in self.arrays]
        if not self.multi_target:
            return cols[0]
        return torch.stack(cols, dim=1)


_LOWERINGS: dict[type, Callable] = {
    RidgeRegressor: LoweredLinear.lower,
    MLPRegressor: LoweredMLP.lower,
    GBTRegressor: LoweredTrees.lower,
    MultiTargetGBT: LoweredTrees.lower,
}


def lower_predictor(model) -> LoweredPredictor:
    """Fitted regressor → :class:`LoweredPredictor`, or ``TypeError`` if
    the model is not one of the lowerable families.

    Memoised on the model instance (flattening is the expensive part):
    treat fitted models as immutable and build a fresh model per refit.
    """
    cached = getattr(model, "_lowered_", None)
    if cached is not None:
        return cached
    lowering = _LOWERINGS.get(type(model))
    if lowering is None:
        raise TypeError(
            f"{type(model).__name__} does not lower to array form: its "
            "predict evaluates host-side, so predictor-driven decisions "
            "must use backend='torch' (lowerable: RidgeRegressor, "
            "MLPRegressor, GBTRegressor, MultiTargetGBT)")
    lowered = lowering(model)
    model._lowered_ = lowered
    return lowered


# --------------------------------------------------------------------------
# The layer-times seam the decision kernel path consumes
# --------------------------------------------------------------------------
@dataclasses.dataclass
class LoweredLayerTimes:
    """Per-layer device/edge execution times from a lowered predictor.

    The array twin of ``PredictorCost.layer_times`` + the oracle's affine
    correction: features built host-side by the same ``feature_fn``,
    inference through the lowered model, then multi-target column select,
    clamp to ≥ 0 and ``t*gain + bias`` (identity short-circuited).
    ``device``/``edge`` are :class:`DeviceSpec`s; :meth:`times` takes the
    torch device.  Memoised on the layers object identity.
    """
    predictor: LoweredPredictor
    feature_fn: Callable
    device: object                      # DeviceSpec
    edge: object
    target_index: int = 0
    correction: tuple[float, float] = (1.0, 0.0)

    def __post_init__(self):
        self._cache: tuple = (None, None, None)

    def times(self, layers: Sequence, *, device: DeviceLike = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """``(t_dev [L], t_edge [L])`` f64 tensors on the torch
        ``device``."""
        dev = resolve_device(device)
        cached = self._cache
        if cached[0] is layers and cached[1] == dev:
            return cached[2]
        feats = np.concatenate([self.feature_fn(layers, self.device),
                                self.feature_fn(layers, self.edge)], axis=0)
        pred = self.predictor.predict(feats, device=dev)
        if pred.ndim == 2:
            pred = pred[:, self.target_index]
        pred = torch.clamp_min(pred, 0.0)
        gain, bias = self.correction
        if gain != 1.0 or bias != 0.0:
            pred = torch.clamp_min(pred * gain + bias, 0.0)
        out = (pred[:len(layers)], pred[len(layers):])
        self._cache = (layers, dev, out)
        return out


def lower_layer_times(cost, correction: tuple[float, float] = (1.0, 0.0)
                      ) -> LoweredLayerTimes:
    """Lower a ``PredictorCost``-shaped cost model's layer-time pipeline
    (raises ``TypeError`` through :func:`lower_predictor` when the wrapped
    regressor has no array form)."""
    return LoweredLayerTimes(lower_predictor(cost.model), cost.feature_fn,
                             cost.device, cost.edge,
                             target_index=cost.target_index,
                             correction=correction)
