"""Ridge regression baseline (sanity floor for the predictor comparison).

The port of ``repro.core.predictors.linear``: the same closed form, in f64
throughout, solved on the torch ``device`` (None = cuda).  The fitted
arrays stay numpy f64, as the reference's, so a bundle carries them across
unchanged.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import DeviceLike, as_tensor, resolve_device

F64 = torch.float64


def _augment(xs: torch.Tensor) -> torch.Tensor:
    return torch.cat([xs, xs.new_ones((len(xs), 1))], dim=1)


def ridge_predict(x, x_mu, x_sd, w, device: torch.device) -> torch.Tensor:
    """Standardise with ``(x_mu, x_sd)`` and take the augmented dot with
    ``w [F+1, T]``, all f64 on ``device``."""
    xs = (as_tensor(x, F64, device) - as_tensor(x_mu, F64, device)) \
        / as_tensor(x_sd, F64, device)
    return _augment(xs) @ as_tensor(w, F64, device)


@dataclasses.dataclass
class RidgeRegressor:
    alpha: float = 1.0

    def fit(self, x, y, *, device: DeviceLike = None) -> "RidgeRegressor":
        dev = resolve_device(device)
        x = as_tensor(x, F64, dev)
        y = as_tensor(y, F64, dev)
        y = y[None] if y.ndim < 2 else y            # np.atleast_2d
        if y.shape[0] != len(x):
            y = y.T
        x_mu = x.mean(0)
        x_sd = x.std(0, correction=0) + 1e-8
        xs = _augment((x - x_mu) / x_sd)
        a = xs.T @ xs + self.alpha * torch.eye(xs.shape[1], dtype=F64,
                                               device=dev)
        w = torch.linalg.solve(a, xs.T @ y)
        self.x_mu_, self.x_sd_, self.w_ = (t.cpu().numpy()
                                           for t in (x_mu, x_sd, w))
        return self

    def predict(self, x, *, device: DeviceLike = None) -> torch.Tensor:
        """``[N, T]`` f64 predictions on ``device`` (None = cuda)."""
        return ridge_predict(x, self.x_mu_, self.x_sd_, self.w_,
                             resolve_device(device))
