"""Gradient-boosted regression trees — the paper's winning profiler model
("XGBoost, max_depth=12, subsample=0.8", Fig. 2b / Fig. 3).

The PyTorch twin of ``repro.core.predictors.gbt``, a from-scratch histogram
GBT:

  * features quantile-binned to bin codes (default 64 bins);
  * squared loss → gradient = residual, hessian = count;
  * per-node *gradient histograms* per feature — the hot loop, run a level
    at a time by :mod:`repro_torch.kernels.gbt_hist`: the CUDA kernel for
    tensors on the card, its plain version on the CPU, both in f64 and bit
    for bit with the reference's ``np.bincount``;
  * best split by the standard gain  GL²/nL + GR²/nR − G²/n;
  * row subsampling per boosting round, drawn from
    ``np.random.default_rng(seed)`` exactly as the reference draws it;
  * one ensemble per target.

Tree growing stays host control flow in numpy, but level by level where
the reference recurses node by node: one histogram call builds every node
of a level (``kernels.gbt_hist.ops.level_histogram``), the gains are
vectorised over the level's nodes, and the nodes are renumbered in the
reference's pre-order at the end.  Every number is the reference's, added
in its order, so on the CPU and on the card alike the port grows node
arrays identical to the reference's.
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


def _preorder(nodes: list[_Node]) -> list[_Node]:
    """``nodes`` (root first, children by index) renumbered in pre-order,
    left subtree first: the order of the reference's recursive growth."""
    order, todo = [], [0]
    while todo:
        i = todo.pop()
        order.append(i)
        if not nodes[i].is_leaf:
            todo += [nodes[i].right, nodes[i].left]
    new = {old: i for i, old in enumerate(order)}
    new[-1] = -1
    return [_Node(nodes[old].feature, nodes[old].threshold_bin,
                  new[nodes[old].left], new[nodes[old].right],
                  nodes[old].value) for old in order]


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
            tree = self._build_tree(codes, resid, np.flatnonzero(rows),
                                    codes_t, torch.as_tensor(resid,
                                                             device=dev))
            self.trees_.append(tree)
            pred += self.learning_rate * self._tree_predict(tree, codes)
        return self

    # -- tree growing -----------------------------------------------------
    def _build_tree(self, codes: np.ndarray, grad: np.ndarray,
                    rows: np.ndarray, codes_t: torch.Tensor,
                    grad_t: torch.Tensor) -> list[_Node]:
        """Grow one tree over ``rows`` (ascending ids into ``codes`` /
        ``grad``) level by level, with one histogram call per level;
        ``codes_t`` / ``grad_t`` are all rows on the fit's device.

        Every number is the reference's recursive growth's, in its order:
        a node's histogram adds its rows in ascending order (the level's
        rows stay grouped by node, ascending within each), its gradient
        total is ``g.sum()`` over those rows, and the gains are the
        reference's formula element by element.  The nodes are numbered in
        the reference's pre-order (left subtree first) at the end."""
        lam, leaf_min = self.lambda_reg, self.min_samples_leaf
        nodes = [_Node()]              # in level order until the end
        ids = [0]                      # the level's nodes
        order = rows                   # the level's rows, grouped by node
        offsets = np.array([0, len(rows)])
        depth = 0
        while ids:
            g_level = grad[order]
            bounds = offsets.tolist()
            counts = np.diff(offsets)
            totals = [g_level[lo:hi].sum()
                      for lo, hi in zip(bounds[:-1], bounds[1:])]
            can = counts >= 2 * leaf_min
            if depth >= self.max_depth:
                can[:] = False
            for k in np.flatnonzero(~can):
                nodes[ids[k]].value = totals[k] / (int(counts[k]) + lam)
            split = np.flatnonzero(can)
            if not len(split):
                break
            scores = [totals[k] ** 2 / (float(counts[k]) + lam)
                      for k in split]
            totals = [totals[k] for k in split]
            sizes = counts[split]
            seg = order[np.repeat(can, counts)]
            seg_off = np.concatenate([[0], np.cumsum(sizes)])
            gsum, cnt = (h.cpu().numpy() for h in hist_ops.level_histogram(
                codes_t, grad_t,
                torch.as_tensor(seg.astype(np.int32), device=codes_t.device),
                torch.as_tensor(seg_off.astype(np.int32),
                                device=codes_t.device), self.n_bins))
            gl = np.cumsum(gsum, axis=2)                   # [K, F, B]
            nl = np.cumsum(cnt, axis=2)
            gt = np.array(totals)[:, None, None]
            nt = sizes.astype(np.float64)[:, None, None]
            gr, nr = gt - gl, nt - nl
            gain = (gl ** 2 / (nl + lam) + gr ** 2 / (nr + lam)
                    - np.array(scores)[:, None, None])
            ok = (nl >= leaf_min) & (nr >= leaf_min)
            gain = np.where(ok, gain, -np.inf).reshape(len(split), -1)
            best = np.argmax(gain, axis=1)
            top = gain[np.arange(len(split)), best]
            bf, bb = np.unravel_index(best, gsum.shape[1:])
            grows = np.isfinite(top) & (top > 1e-12)
            nxt = []
            for j, k in enumerate(split):
                if not grows[j]:
                    nodes[ids[k]].value = totals[j] / (int(sizes[j]) + lam)
                    continue
                node = nodes[ids[k]]
                node.feature, node.threshold_bin = int(bf[j]), int(bb[j])
                node.left, node.right = len(nodes), len(nodes) + 1
                nodes += [_Node(), _Node()]
                nxt += [node.left, node.right]
            if not nxt:
                break
            # each growing node's rows to its children, ascending in each
            part = np.flatnonzero(grows)
            n_rows = sizes[part]
            at = seg[np.repeat(grows, sizes)]
            right = codes[at, np.repeat(bf[part], n_rows)] > \
                np.repeat(bb[part], n_rows)
            child = 2 * np.repeat(np.arange(len(part)), n_rows) + right
            order = at[np.argsort(child, kind="stable")]
            offsets = np.concatenate(
                [[0], np.cumsum(np.bincount(child, minlength=len(nxt)))])
            ids = nxt
            depth += 1
        return _preorder(nodes)

    def _tree_predict(self, tree: list[_Node], codes: np.ndarray
                      ) -> np.ndarray:
        """The tree's leaf value for every row of ``codes``: all rows
        descend together, one gather a level."""
        feature, threshold, left, right = (np.array(a) for a in zip(*(
            (nd.feature, nd.threshold_bin, nd.left, nd.right)
            for nd in tree)))
        value = np.array([nd.value for nd in tree], np.float64)
        flat = codes.ravel()
        base = np.arange(len(codes)) * codes.shape[1]
        node = np.zeros(len(codes), np.int64)
        while True:
            f = feature[node]
            inner = f >= 0
            if not inner.any():
                return value[node]
            goes_left = flat[base + np.maximum(f, 0)] <= threshold[node]
            node = np.where(inner, np.where(goes_left, left[node],
                                            right[node]), node)

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
