"""MLP regression baseline (paper Fig. 2a).

The port of ``repro.core.predictors.mlp``.  The paper stacks individual
MLPs per target and sweeps width/depth from 3,143 to 4,169,991 parameters;
accuracy plateaus at nRMSE just below 0.02, an order of magnitude worse
than the tree ensembles.

The network is the reference's params dict (``w{i}`` ``[in, out]``,
``b{i}``) as f32 tensors, trained on the torch ``device`` (None = cuda)
with the port's optimisers (:mod:`repro_torch.optim`) over the reference's
batches: each epoch ``ep`` draws its permutation from
``default_rng(seed + ep)``, uploaded once an epoch.  Standardisation is the
reference's numpy f32 arithmetic on the host; destandardisation is f32 on
the device.  The initial weights are the reference's truncated-normal
fan-in init drawn from ``torch.Generator().manual_seed(seed)`` on the CPU,
so they do not depend on the device, but they are not ``jax.random``'s:
equal weights on both sides come through a bundle
(:mod:`repro_torch.core.predictors.persist`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import DeviceLike, as_tensor, resolve_device
from repro_torch.data.synthetic import batch_indices
from repro_torch.models.layers import init_dense
from repro_torch.optim import get_optimizer

F32 = torch.float32

# width presets spanning the paper's 3k .. 4.17M parameter range
SIZE_PRESETS: dict[str, list[int]] = {
    "xs": [32, 16],                       # ~3k params
    "s": [128, 64],
    "m": [512, 256],
    "l": [1024, 512, 256],
    "xl": [2048, 1024, 512],              # ~4.2M params
}


def mlp_forward(params: dict, x: torch.Tensor, n_layers: int
                ) -> torch.Tensor:
    """``x @ w{i} + b{i}`` with ReLU between layers, in f32."""
    h = x
    for i in range(n_layers):
        h = h @ params[f"w{i}"] + params[f"b{i}"]
        if i < n_layers - 1:
            h = torch.relu(h)
    return h


def mlp_predict(x, params: dict, n_layers: int, stats,
                device: torch.device) -> torch.Tensor:
    """The fitted forward on ``device``: ``stats`` is ``(x_mu, x_sd, y_mu,
    y_sd)`` (numpy f32) or None when the model does not standardise."""
    x = as_tensor(x, F32, device)
    if stats is not None:
        x_mu, x_sd, y_mu, y_sd = (as_tensor(s, F32, device) for s in stats)
        x = (x - x_mu) / x_sd
    with torch.no_grad():
        pred = mlp_forward({k: v.to(device) for k, v in params.items()}, x,
                           n_layers)
    if stats is not None:
        pred = pred * y_sd + y_mu
    return pred


@dataclasses.dataclass
class MLPRegressor:
    hidden: tuple = (256, 128)
    lr: float = 1e-3
    optimiser: str = "adam"
    epochs: int = 300
    batch_size: int = 64
    seed: int = 0
    standardize: bool = True

    def _init(self, f_in: int, f_out: int) -> dict[str, torch.Tensor]:
        """Initial params on the CPU, from ``seed``."""
        gen = torch.Generator().manual_seed(int(self.seed))
        dims = [f_in, *self.hidden, f_out]
        params = {}
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            params[f"w{i}"] = init_dense((a, b), gen)
            params[f"b{i}"] = torch.zeros(b, dtype=F32)
        return params

    def fit(self, x, y, *, device: DeviceLike = None) -> "MLPRegressor":
        dev = resolve_device(device)
        x = np.asarray(x, np.float32)
        y = np.atleast_2d(np.asarray(y, np.float32))
        if y.shape[0] != len(x):
            y = y.T
        if self.standardize:
            self.x_mu_, self.x_sd_ = x.mean(0), x.std(0) + 1e-8
            self.y_mu_, self.y_sd_ = y.mean(0), y.std(0) + 1e-8
            x = (x - self.x_mu_) / self.x_sd_
            y = (y - self.y_mu_) / self.y_sd_
        self.n_layers_ = len(self.hidden) + 1
        params = {k: v.to(dev).requires_grad_()
                  for k, v in self._init(x.shape[1], y.shape[1]).items()}
        opt = get_optimizer(self.optimiser, params.values(), self.lr)
        xd, yd = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
        bs = min(self.batch_size, len(x))
        for ep in range(self.epochs):
            order = torch.as_tensor(np.concatenate(list(batch_indices(
                len(x), bs, seed=self.seed + ep))), device=dev)
            for j in order.view(-1, bs):
                pred = mlp_forward(params, xd[j], self.n_layers_)
                loss = ((pred - yd[j]) ** 2).mean()
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
        self.params_ = {k: v.detach() for k, v in params.items()}
        return self

    def _stats(self):
        if not self.standardize:
            return None
        return self.x_mu_, self.x_sd_, self.y_mu_, self.y_sd_

    def predict(self, x, *, device: DeviceLike = None) -> torch.Tensor:
        """``[N, T]`` f32 predictions on ``device`` (None = cuda)."""
        return mlp_predict(x, self.params_, self.n_layers_, self._stats(),
                           resolve_device(device))

    def param_count(self) -> int:
        return int(sum(v.numel() for v in self.params_.values()))
