"""Gradient-boosted regression trees — the paper's winning profiler model
("XGBoost, max_depth=12, subsample=0.8", Fig. 2b / Fig. 3).

The PyTorch twin of ``repro.core.predictors.gbt``, a from-scratch histogram
GBT:

  * features quantile-binned to bin codes (default 64 bins);
  * squared loss → gradient = residual, hessian = count;
  * per-node *gradient histograms* per feature — the hot loop, run by
    :mod:`repro_torch.kernels.gbt_hist`: the CUDA kernel for tensors on the
    card, its plain f64 version (bit for bit with the reference) on the CPU;
  * best split by the standard gain  GL²/nL + GR²/nR − G²/n;
  * row subsampling per boosting round, drawn from
    ``np.random.default_rng(seed)`` exactly as the reference draws it;
  * one ensemble per target.

Tree growing stays host control flow in numpy, as in the reference: only
the histogram moves to ``fit(..., device=)``.  On the CPU the port grows
node arrays identical to the reference's; on the card the f32 kernel
histogram can flip near-tied splits.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import DeviceLike, as_tensor, resolve_device
from repro_torch.kernels.gbt_hist import ops as hist_ops
from repro_torch.kernels.tree_predict.ops import predict_trees
from repro_torch.kernels.tree_predict.ref import flatten_gbt


@dataclasses.dataclass
class _Node:
    feature: int = -1
    threshold_bin: int = 0
    left: int = -1
    right: int = -1
    value: float = 0.0

    @property
    def is_leaf(self) -> bool:
        return self.feature < 0


def quantile_bins(x: np.ndarray, n_bins: int) -> np.ndarray:
    """Per-feature bin edges [F, n_bins-1] from quantiles."""
    qs = np.linspace(0, 1, n_bins + 1)[1:-1]
    return np.quantile(x, qs, axis=0).T.astype(np.float32)   # [F, n_bins-1]


def bin_data(x: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """x [N,F] → uint8 bin codes via per-feature edges."""
    codes = np.empty(x.shape, np.uint8)
    for f in range(x.shape[1]):
        codes[:, f] = np.searchsorted(edges[f], x[:, f]).astype(np.uint8)
    return codes


def grad_histogram(codes, grad, n_bins: int, *, device: DeviceLike = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(feature, bin) gradient sums + counts. The GBT hot-spot.

    codes [N, F] bin codes; grad [N]. Returns f64 ``(gsum [F, n_bins],
    cnt [F, n_bins])`` tensors on ``device`` (None = cuda): the
    ``gbt_hist`` kernel on the card, its plain version on the CPU.
    """
    dev = resolve_device(device)
    return hist_ops.grad_histogram(as_tensor(codes, torch.int32, dev),
                                   as_tensor(grad, torch.float64, dev),
                                   n_bins)


@dataclasses.dataclass
class GBTRegressor:
    """Single-target gradient-boosted trees."""
    n_trees: int = 200
    max_depth: int = 6
    learning_rate: float = 0.1
    subsample: float = 1.0
    n_bins: int = 64
    min_samples_leaf: int = 2
    lambda_reg: float = 1.0
    seed: int = 0

    def fit(self, x: np.ndarray, y: np.ndarray, *,
            device: DeviceLike = None) -> "GBTRegressor":
        """Grow ``n_trees`` trees; the histograms run on ``device``."""
        dev = resolve_device(device)
        x = np.asarray(x, np.float32)
        y = np.asarray(y, np.float64).ravel()
        rng = np.random.default_rng(self.seed)
        self.edges_ = quantile_bins(x, self.n_bins)
        codes = bin_data(x, self.edges_)
        codes_t = torch.as_tensor(codes.astype(np.int32), device=dev)
        self.base_ = float(y.mean())
        pred = np.full_like(y, self.base_)
        self.trees_: list[list[_Node]] = []
        self._arrays = None
        n = len(y)
        for _ in range(self.n_trees):
            resid = y - pred
            if self.subsample < 1.0:
                rows = rng.random(n) < self.subsample
                if rows.sum() < 2 * self.min_samples_leaf:
                    rows = np.ones(n, bool)
            else:
                rows = np.ones(n, bool)
            rows_t = torch.as_tensor(np.flatnonzero(rows), device=dev)
            tree = self._build_tree(codes[rows], resid[rows],
                                    codes_t[rows_t],
                                    torch.as_tensor(resid[rows],
                                                    device=dev))
            self.trees_.append(tree)
            pred += self.learning_rate * self._tree_predict(tree, codes)
        return self

    # -- tree growing -----------------------------------------------------
    def _build_tree(self, codes: np.ndarray, grad: np.ndarray,
                    codes_t: torch.Tensor, grad_t: torch.Tensor
                    ) -> list[_Node]:
        """``codes``/``grad`` on the host drive the growth; ``codes_t``/
        ``grad_t`` are the same rows on the fit's device, gathered per node
        for the histogram."""
        nodes: list[_Node] = []

        def grow(idx: np.ndarray, depth: int) -> int:
            node_id = len(nodes)
            nodes.append(_Node())
            g = grad[idx]
            n = len(idx)
            value = g.sum() / (n + self.lambda_reg)
            if depth >= self.max_depth or n < 2 * self.min_samples_leaf:
                nodes[node_id].value = value
                return node_id
            idx_t = torch.as_tensor(idx, device=codes_t.device)
            gsum, cnt = (h.cpu().numpy() for h in grad_histogram(
                codes_t[idx_t], grad_t[idx_t], self.n_bins,
                device=codes_t.device))
            gl = np.cumsum(gsum, axis=1)                   # [F, B]
            nl = np.cumsum(cnt, axis=1)
            gt, nt = g.sum(), float(n)
            gr, nr = gt - gl, nt - nl
            lam = self.lambda_reg
            gain = (gl ** 2 / (nl + lam) + gr ** 2 / (nr + lam)
                    - gt ** 2 / (nt + lam))
            ok = (nl >= self.min_samples_leaf) & (nr >= self.min_samples_leaf)
            gain = np.where(ok, gain, -np.inf)
            f, b = np.unravel_index(np.argmax(gain), gain.shape)
            if not np.isfinite(gain[f, b]) or gain[f, b] <= 1e-12:
                nodes[node_id].value = value
                return node_id
            mask = codes[idx, f] <= b
            left = grow(idx[mask], depth + 1)
            right = grow(idx[~mask], depth + 1)
            nodes[node_id].feature = int(f)
            nodes[node_id].threshold_bin = int(b)
            nodes[node_id].left = left
            nodes[node_id].right = right
            return node_id

        grow(np.arange(len(grad)), 0)
        return nodes

    def _tree_predict(self, tree: list[_Node], codes: np.ndarray
                      ) -> np.ndarray:
        out = np.empty(len(codes))
        # vectorised level-order traversal
        node_idx = np.zeros(len(codes), np.int32)
        active = np.ones(len(codes), bool)
        while active.any():
            for nid in np.unique(node_idx[active]):
                node = tree[nid]
                sel = active & (node_idx == nid)
                if node.is_leaf:
                    out[sel] = node.value
                    active &= ~sel
                else:
                    goes_left = codes[sel, node.feature] <= node.threshold_bin
                    tgt = np.where(goes_left, node.left, node.right)
                    node_idx[sel] = tgt
        return out

    def predict(self, x, *, device: DeviceLike = None) -> torch.Tensor:
        """``[N]`` f64 predictions on ``device`` (None = cuda; the
        ``tree_predict`` kernel there), bit for bit with the reference's
        ``GBTRegressor.predict``."""
        if getattr(self, "_arrays", None) is None:
            self._arrays = flatten_gbt(self)
        return predict_trees(x, self._arrays, device=device)


@dataclasses.dataclass
class MultiTargetGBT:
    """One ensemble per target (paper Fig. 2b)."""
    n_trees: int = 200
    max_depth: int = 12
    learning_rate: float = 0.1
    subsample: float = 0.8
    n_bins: int = 64
    seed: int = 0

    def fit(self, x: np.ndarray, y: np.ndarray, *,
            device: DeviceLike = None) -> "MultiTargetGBT":
        y = np.atleast_2d(y)
        if y.shape[0] == len(x) and y.ndim == 2:
            targets = y.T
        else:
            targets = y
        self.models_ = []
        for ti, yt in enumerate(targets):
            m = GBTRegressor(
                n_trees=self.n_trees, max_depth=self.max_depth,
                learning_rate=self.learning_rate, subsample=self.subsample,
                n_bins=self.n_bins, seed=self.seed + ti).fit(
                    x, yt, device=device)
            self.models_.append(m)
        return self

    def predict(self, x, *, device: DeviceLike = None) -> torch.Tensor:
        return torch.stack([m.predict(x, device=device)
                            for m in self.models_], dim=1)
