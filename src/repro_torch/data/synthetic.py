"""Tabular regression data for the profiling predictors (the port of
``repro.data.synthetic``'s tabular half, in numpy as there).

The same seed gives the same permutation as the reference's, so the port
and the reference split and train on identical batches.  The token-batch
helpers of the reference wait for the training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class TabularDataset:
    x: np.ndarray                   # [N, F] float32
    y: np.ndarray                   # [N, T] float32 (multi-target)
    feature_names: list[str]
    target_names: list[str]

    def split(self, frac: float = 0.8, seed: int = 0):
        rng = np.random.default_rng(seed)
        idx = rng.permutation(len(self.x))
        k = int(len(idx) * frac)
        tr, te = idx[:k], idx[k:]
        mk = lambda i: TabularDataset(self.x[i], self.y[i],
                                      self.feature_names, self.target_names)
        return mk(tr), mk(te)

    def normalised(self):
        """Min-max normalise x and y (paper reports normalised RMSE)."""
        def norm(a):
            lo, hi = a.min(axis=0), a.max(axis=0)
            span = np.where(hi > lo, hi - lo, 1.0)
            return (a - lo) / span, (lo, span)
        xn, xs = norm(self.x)
        yn, ys = norm(self.y)
        return TabularDataset(xn.astype(np.float32), yn.astype(np.float32),
                              self.feature_names, self.target_names), (xs, ys)


def batch_indices(n: int, batch_size: int,
                  seed: int = 0) -> Iterator[np.ndarray]:
    """The row ids of each batch of :func:`batches`: one permutation of
    ``n`` rows from ``default_rng(seed)``, the last partial batch
    dropped."""
    idx = np.random.default_rng(seed).permutation(n)
    for i in range(0, n - batch_size + 1, batch_size):
        yield idx[i:i + batch_size]


def batches(x: np.ndarray, y: np.ndarray, batch_size: int,
            seed: int = 0) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    for j in batch_indices(len(x), batch_size, seed):
        yield x[j], y[j]
