"""Flattened tree-ensemble form + the plain PyTorch tree inference.

:func:`flatten_gbt` compiles a *fitted* :class:`repro_torch.core.
predictors.gbt.GBTRegressor` into five padded ``[n_trees, max_nodes]``
numpy arrays — ``(feature, threshold_bin, left, right, value)`` — plus
the quantile bin edges: the form every inference path consumes and the
form predictor persistence writes (the reference's ``.npz`` layout).

  * :func:`tree_predict_ref` — the plain version of the CUDA kernel
    (``kernel.tree_predict_kernel``): level-synchronous descent over bin
    codes, leaf values pre-scaled by the learning rate in f64, added one at
    a time in training order onto the ensemble's ``base``;
  * :func:`leaf_matrix_ref`, :func:`fold_ref` — the same in the kernel's
    two launches: every (row, tree)'s leaf value ``[N, T]`` (the
    descent), then each row added in tree order (the fold);
  * :func:`predict_ref`      — binning + :func:`tree_predict_ref`, bit for
    bit with the reference's ``GBTRegressor.predict`` / ``predict_ref``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TreeArrays:
    """One fitted GBT ensemble as padded node arrays (struct-of-arrays).

    Node 0 is each tree's root.  ``feature < 0`` marks a leaf; padding
    slots beyond a tree's ``n_nodes`` are leaves with value 0, so a
    descent that never reaches them stays well-defined.  ``value`` holds
    *raw* leaf values; inference scales them by ``learning_rate``.
    """
    feature: np.ndarray          # [T, M] int32, -1 == leaf
    threshold_bin: np.ndarray    # [T, M] int32 (bin code, go left if <=)
    left: np.ndarray             # [T, M] int32
    right: np.ndarray            # [T, M] int32
    value: np.ndarray            # [T, M] f64 raw leaf values
    n_nodes: np.ndarray          # [T] int32 real node count per tree
    edges: np.ndarray            # [F, n_bins-1] f32 quantile bin edges
    base: float                  # ensemble intercept (mean target)
    learning_rate: float
    max_depth: int               # deepest split depth over all trees

    @property
    def n_trees(self) -> int:
        return self.feature.shape[0]

    @property
    def max_nodes(self) -> int:
        return self.feature.shape[1]


@dataclasses.dataclass(frozen=True)
class DeviceTrees:
    """The node arrays of one :class:`TreeArrays` as tensors on a device:
    int32 node arrays, f32 bin edges, and the leaf values pre-scaled by the
    learning rate in f64."""
    feature: torch.Tensor
    threshold_bin: torch.Tensor
    left: torch.Tensor
    right: torch.Tensor
    scaled_value: torch.Tensor       # f64
    edges: torch.Tensor


def device_trees(arrays: TreeArrays, device: torch.device) -> DeviceTrees:
    """:class:`DeviceTrees` of ``arrays`` on ``device``, memoised on the
    (frozen) arrays instance per device."""
    cache = arrays.__dict__.setdefault("_device_trees", {})
    if device not in cache:
        # learning_rate folded into the leaf values in f64: the exact
        # per-leaf products the host accumulation produces
        scaled = arrays.learning_rate * np.asarray(arrays.value, np.float64)

        def put(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=device)

        cache[device] = DeviceTrees(
            put(arrays.feature, torch.int32),
            put(arrays.threshold_bin, torch.int32),
            put(arrays.left, torch.int32), put(arrays.right, torch.int32),
            put(scaled, torch.float64), put(arrays.edges, torch.float32))
    return cache[device]


def _tree_depth(feature: np.ndarray, left: np.ndarray, right: np.ndarray
                ) -> int:
    """Deepest split chain of one flattened tree (0 for a stump leaf)."""
    depth = 0
    stack = [(0, 0)]
    while stack:
        node, d = stack.pop()
        if feature[node] < 0:
            depth = max(depth, d)
        else:
            stack.append((int(left[node]), d + 1))
            stack.append((int(right[node]), d + 1))
    return depth


def flatten_gbt(model) -> TreeArrays:
    """Compile a *fitted* GBT (``trees_``, ``edges_``, ``base_``,
    ``learning_rate``) into :class:`TreeArrays` (raises ``AttributeError``
    if unfitted)."""
    trees = model.trees_
    n_trees = len(trees)
    max_nodes = max((len(t) for t in trees), default=1)
    feat = np.full((n_trees, max_nodes), -1, np.int32)
    thr = np.zeros((n_trees, max_nodes), np.int32)
    left = np.zeros((n_trees, max_nodes), np.int32)
    right = np.zeros((n_trees, max_nodes), np.int32)
    value = np.zeros((n_trees, max_nodes), np.float64)
    n_nodes = np.zeros(n_trees, np.int32)
    depth = 0
    for t, tree in enumerate(trees):
        n_nodes[t] = len(tree)
        for i, node in enumerate(tree):
            feat[t, i] = node.feature
            thr[t, i] = node.threshold_bin
            left[t, i] = node.left
            right[t, i] = node.right
            value[t, i] = node.value
        depth = max(depth, _tree_depth(feat[t], left[t], right[t]))
    return TreeArrays(feat, thr, left, right, value, n_nodes,
                      np.asarray(model.edges_, np.float32),
                      float(model.base_), float(model.learning_rate),
                      depth)


def unflatten_gbt(arrays: TreeArrays) -> list:
    """Rebuild the ``list[list[_Node]]`` tree representation — the
    persistence load path (round-trips :func:`flatten_gbt` exactly)."""
    from repro_torch.core.predictors.gbt import _Node
    trees = []
    for t in range(arrays.n_trees):
        trees.append([
            _Node(feature=int(arrays.feature[t, i]),
                  threshold_bin=int(arrays.threshold_bin[t, i]),
                  left=int(arrays.left[t, i]),
                  right=int(arrays.right[t, i]),
                  value=float(arrays.value[t, i]))
            for i in range(int(arrays.n_nodes[t]))])
    return trees


def bin_codes_ref(x: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """``[N, F]`` int32 bin codes — ``searchsorted`` semantics expressed
    as comparison counts (``code = #{edges < x}``) on f32."""
    return torch.sum(edges[None, :, :] < x.to(torch.float32)[:, :, None],
                     dim=-1, dtype=torch.int32)


def _leaves(codes: torch.Tensor, feature: torch.Tensor,
            threshold_bin: torch.Tensor, left: torch.Tensor,
            right: torch.Tensor, max_depth: int) -> torch.Tensor:
    """``[N, T]`` leaf slot per (row, tree) over the ``[T, M]`` node rows:
    every tree descends at once, ``max_depth`` levels, a row at a leaf
    staying there."""
    n, t = codes.shape[0], feature.shape[0]
    tree = torch.arange(t, device=codes.device)[None, :].expand(n, t)
    rows = torch.arange(n, device=codes.device)[:, None].expand(n, t)
    node = torch.zeros((n, t), dtype=torch.int64, device=codes.device)
    for _ in range(max_depth):
        feat = feature[tree, node].to(torch.int64)
        split = feat >= 0
        goes_left = split & (codes[rows, feat.clamp_min(0)]
                             <= threshold_bin[tree, node])
        nxt = torch.where(goes_left, left[tree, node], right[tree, node])
        node = torch.where(split, nxt.to(torch.int64), node)
    return node


def tree_predict_ref(codes: torch.Tensor, feature: torch.Tensor,
                     threshold_bin: torch.Tensor, left: torch.Tensor,
                     right: torch.Tensor, scaled_value: torch.Tensor, *,
                     max_depth: int, base: float) -> torch.Tensor:
    """Plain version of the CUDA kernel: ``codes [N, F]`` int32 bin codes,
    node arrays ``[T, M]`` (``scaled_value`` f64, pre-scaled by the
    learning rate) → ``[N]`` f64 ``base`` + each tree's leaf value, added
    one at a time in training order."""
    leaf = _leaves(codes, feature, threshold_bin, left, right, max_depth)
    pred = torch.full((codes.shape[0],), base, dtype=torch.float64,
                      device=codes.device)
    for i in range(feature.shape[0]):
        pred = pred + scaled_value[i][leaf[:, i]]
    return pred


def leaf_matrix_ref(codes: torch.Tensor, feature: torch.Tensor,
                    threshold_bin: torch.Tensor, left: torch.Tensor,
                    right: torch.Tensor, scaled_value: torch.Tensor, *,
                    max_depth: int) -> torch.Tensor:
    """Plain version of the kernel's descent: ``[N, T]`` f64, the
    pre-scaled leaf value each row reaches in each tree."""
    leaf = _leaves(codes, feature, threshold_bin, left, right, max_depth)
    tree = torch.arange(feature.shape[0], device=codes.device)[None, :]
    return scaled_value[tree, leaf]


def fold_ref(leaf: torch.Tensor, base: float) -> torch.Tensor:
    """Plain version of the kernel's fold: ``[N]`` f64 ``base`` plus each
    row of ``leaf [N, T]``, one add at a time in tree order (regrouped into
    partial sums, the f64 result would differ)."""
    pred = torch.full((leaf.shape[0],), base, dtype=torch.float64,
                      device=leaf.device)
    for t in range(leaf.shape[1]):
        pred = pred + leaf[:, t]
    return pred


def predict_ref(x: torch.Tensor, arrays: TreeArrays) -> torch.Tensor:
    """``[N]`` f64 predictions on ``x``'s device with the plain version.

    Bit for bit with the reference's ``GBTRegressor.predict``: codes from
    the same f32 edge comparisons, leaf values scaled by ``learning_rate``
    in f64, trees accumulated one add at a time in training order onto the
    ``base`` intercept.
    """
    t = device_trees(arrays, x.device)
    return tree_predict_ref(bin_codes_ref(x, t.edges), t.feature,
                            t.threshold_bin, t.left, t.right,
                            t.scaled_value, max_depth=arrays.max_depth,
                            base=arrays.base)
