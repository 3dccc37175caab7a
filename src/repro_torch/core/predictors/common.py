"""Shared predictor API + metrics (paper Fig. 2 reports normalised RMSE).

The metrics take numpy arrays (move tensors to the host with
``.cpu().numpy()`` first), exactly as the reference's do.
"""
from __future__ import annotations

from typing import Protocol

import numpy as np
import torch

from repro_torch._device import DeviceLike


class Regressor(Protocol):
    def fit(self, x: np.ndarray, y: np.ndarray, *,
            device: DeviceLike = None) -> "Regressor": ...
    def predict(self, x: np.ndarray, *,
                device: DeviceLike = None) -> torch.Tensor: ...


def rmse(pred: np.ndarray, y: np.ndarray) -> float:
    return float(np.sqrt(np.mean((pred - y) ** 2)))


def normalised_rmse(pred: np.ndarray, y: np.ndarray) -> float:
    """RMSE on min-max-normalised targets (the paper's metric).

    Assumes pred/y are already in the normalised [0,1] space; if not,
    normalise per-target by the span of y.
    """
    span = y.max(axis=0) - y.min(axis=0)
    span = np.where(span > 0, span, 1.0)
    return float(np.sqrt(np.mean(((pred - y) / span) ** 2)))


def per_target_nrmse(pred: np.ndarray, y: np.ndarray) -> np.ndarray:
    span = y.max(axis=0) - y.min(axis=0)
    span = np.where(span > 0, span, 1.0)
    return np.sqrt(np.mean(((pred - y) / span) ** 2, axis=0))


def r2(pred: np.ndarray, y: np.ndarray) -> float:
    ss_res = np.sum((pred - y) ** 2)
    ss_tot = np.sum((y - y.mean(axis=0)) ** 2)
    return float(1.0 - ss_res / max(ss_tot, 1e-12))
