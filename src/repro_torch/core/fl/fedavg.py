"""Federated learning of the *global profiling model* (paper §II-B; the
port of ``repro.core.fl.fedavg``).

Profiling data is collected on users' devices and is sensitive, so the
global profiling model is trained with FedAvg + differential privacy:
server broadcast → client local steps → weighted aggregation, here one
process with every client's shard and the model on one torch device (None
= cuda).  Local steps are the port's optimisers (``optim.get_optimizer``)
on ``MLPRegressor``'s network over the reference's batches
(``data.synthetic.batch_indices``: the same permutations), so with the
same initial weights the rounds follow the reference's.  The initial
weights themselves are the port MLP's (``torch.Generator``), not
``jax.random``'s.

Validation modes (paper §II-B): *federated* (each client holds out a local
test split) and *centralised* (the server evaluates the global model on an
unseen dataset).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.fl.dp import DPConfig, privatise_update
from repro_torch.core.predictors.mlp import MLPRegressor, mlp_forward
from repro_torch.data.synthetic import batch_indices
from repro_torch.optim import get_optimizer


@dataclasses.dataclass
class Client:
    """One edge device holding a private shard of profiling records."""
    name: str
    x: np.ndarray
    y: np.ndarray
    test_frac: float = 0.2

    def splits(self, seed: int = 0):
        rng = np.random.default_rng(seed)
        idx = rng.permutation(len(self.x))
        k = int(len(idx) * (1 - self.test_frac))
        return (self.x[idx[:k]], self.y[idx[:k]],
                self.x[idx[k:]], self.y[idx[k:]])


def split_clients(x: np.ndarray, y: np.ndarray, n_clients: int,
                  by: Optional[np.ndarray] = None, seed: int = 0
                  ) -> list[Client]:
    """Partition the profiling dataset into per-device shards.

    ``by`` (e.g. a hardware-type column) gives one non-IID shard per value
    — the heterogeneity case the paper targets — unless it has fewer
    values than ``n_clients``, when the shards are random, as they are
    with ``by=None`` (IID)."""
    rng = np.random.default_rng(seed)
    if by is not None:
        keys = np.unique(by)
        groups = [np.where(by == k)[0] for k in keys]
        order = rng.permutation(len(x)) if len(groups) < n_clients else None
        if order is not None:
            groups = np.array_split(order, n_clients)
    else:
        groups = np.array_split(rng.permutation(len(x)), n_clients)
    return [Client(f"client{i}", x[g], y[g]) for i, g in enumerate(groups)]


@dataclasses.dataclass
class FedAvgConfig:
    rounds: int = 20
    local_epochs: int = 2
    lr: float = 1e-3
    optimiser: str = "adam"
    batch_size: int = 32
    hidden: tuple = (128, 64)
    dp: Optional[DPConfig] = None
    seed: int = 0


@dataclasses.dataclass
class FedAvgResult:
    model: MLPRegressor
    round_history: list[dict]
    federated_rmse: float
    centralised_rmse: Optional[float]


def _tree_mean(trees: list[dict], weights: np.ndarray) -> dict:
    """The ``weights``-weighted mean of the trees, leaf by leaf, in f32."""
    total = float(weights.sum())
    return {k: sum(float(np.float32(w)) * t[k] for w, t in
                   zip(weights, trees)) / total for k in trees[0]}


def _local_train(params: dict, n_layers: int, x: np.ndarray,
                 y: np.ndarray, cfg: FedAvgConfig, seed: int) -> dict:
    """Local client steps from ``params``; returns the parameter UPDATE
    (trained minus broadcast)."""
    dev = next(iter(params.values())).device
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    opt = get_optimizer(cfg.optimiser, p.values(), cfg.lr)
    xd, yd = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
    bs = min(cfg.batch_size, len(x))
    for ep in range(cfg.local_epochs):
        order = list(batch_indices(len(x), bs, seed=seed + ep))
        if not order:
            continue
        for j in torch.as_tensor(np.stack(order), device=dev):
            loss = ((mlp_forward(p, xd[j], n_layers) - yd[j]) ** 2).mean()
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
    return {k: p[k].detach() - params[k] for k in params}


def run_fedavg(clients: list[Client], cfg: FedAvgConfig,
               central_test: Optional[tuple] = None, *,
               device: DeviceLike = None) -> FedAvgResult:
    """Server loop: broadcast → local training → (DP) aggregate, each
    round validated on the clients' held-out splits (``federated_rmse``,
    in standardised units); ``central_test`` (x, y) is scored at the end
    (``centralised_rmse``)."""
    dev = resolve_device(device)
    x_all = np.concatenate([c.x for c in clients])
    y_all = np.concatenate([c.y for c in clients])
    model = MLPRegressor(hidden=cfg.hidden, lr=cfg.lr,
                         optimiser=cfg.optimiser, epochs=0, seed=cfg.seed)
    model.fit(x_all, y_all, device=dev)      # init params + scalers only
    # (pooled feature scaling is metadata, not raw data — acceptable under
    # the paper's threat model)
    params = dict(model.params_)

    def norm_x(x):
        return (x - model.x_mu_) / model.x_sd_

    def norm_y(y):
        return (y - model.y_mu_) / model.y_sd_

    splits = [c.splits(cfg.seed) for c in clients]
    weights = np.array([len(s[0]) for s in splits], np.float64)
    rng = np.random.default_rng(cfg.seed)
    history = []
    for rnd in range(cfg.rounds):
        deltas = []
        for ci, (xtr, ytr, _, _) in enumerate(splits):
            delta = _local_train(params, model.n_layers_, norm_x(xtr),
                                 norm_y(ytr), cfg,
                                 seed=cfg.seed + 997 * rnd + ci)
            if cfg.dp:
                delta = privatise_update(delta, cfg.dp, rng)
            deltas.append(delta)
        mean_delta = _tree_mean(deltas, weights)
        params = {k: params[k] + mean_delta[k] for k in params}
        # federated validation
        errs = []
        with torch.no_grad():
            for _, _, xte, yte in splits:
                if len(xte) == 0:
                    continue
                pred = mlp_forward(params, torch.as_tensor(
                    norm_x(xte), device=dev), model.n_layers_)
                target = torch.as_tensor(norm_y(yte), device=dev)
                errs.append(float(((pred - target) ** 2).mean()))
        fed_rmse = float(np.sqrt(np.mean(errs)))
        history.append({"round": rnd, "federated_rmse": fed_rmse})

    model.params_ = params
    cen = None
    if central_test is not None:
        xte, yte = central_test
        pred = model.predict(xte, device=dev).cpu().numpy()
        cen = float(np.sqrt(np.mean(
            ((pred - yte) / (np.abs(model.y_sd_) + 1e-12)) ** 2)))
    return FedAvgResult(model=model, round_history=history,
                        federated_rmse=history[-1]["federated_rmse"],
                        centralised_rmse=cen)
