"""Wrapper of the CUDA batched tree-inference kernels
(``csrc/tree_predict.cu``), and the rule by which a call picks its route."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: the descent's two routes (trees staged in shared memory, or read from
#: global memory), then the in-order fold: the CUDA kernels a call launches
ROUTES = ("descend_shared", "descend_global")
KERNELS = ROUTES + ("fold",)
#: shared memory a block can have on the H100 (227 KB), and what a staged
#: node takes of it: an int4 {feature, threshold, left, right} and its f64
#: leaf value
SMEM_LIMIT = 232_448
NODE_BYTES = 24
#: rows of a block's tile, and the blocks a call aims for: two on each of
#: the H100's 132 SMs
ROW_TILE = 128
TARGET_BLOCKS = 264


def choose_route(n_rows: int, n_feat: int, n_trees: int, max_nodes: int
                 ) -> tuple[str, int, int]:
    """``(route, trees_per_block, rows_per_block)`` of the descent over
    ``n_rows`` codes of ``n_feat`` features and ``n_trees`` trees of
    ``max_nodes`` node slots.

    A block takes ``min(n_rows, ROW_TILE)`` rows and stages their codes.
    Its trees go to shared memory (``descend_shared``) where one tree fits
    beside the codes in :data:`SMEM_LIMIT` at :data:`NODE_BYTES` a node;
    a larger tree is read from global memory (``descend_global``).  Trees
    per block: as few as give :data:`TARGET_BLOCKS` blocks (one at the
    decision path's 56 rows), at most as many as fit."""
    rows = max(1, min(n_rows, ROW_TILE))
    codes_bytes = 4 * n_feat * rows
    if codes_bytes > SMEM_LIMIT:
        raise ValueError(f"{n_feat} features: one tile's codes take "
                         f"{codes_bytes} bytes of shared memory, more than "
                         f"{SMEM_LIMIT}")
    tiles = -(-n_rows // rows)
    want = max(1, min(n_trees, -(-n_trees * tiles // TARGET_BLOCKS)))
    fit = (SMEM_LIMIT - codes_bytes) // (NODE_BYTES * max(max_nodes, 1))
    if fit < 1:
        return "descend_global", want, rows
    return "descend_shared", min(want, fit), rows


def _lib() -> ctypes.CDLL:
    lib = _build.load("tree_predict")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tree_descend.argtypes = [p] * 6 + [i] * 8 + [p, p]
    lib.tree_descend.restype = ctypes.c_int
    lib.tree_fold.argtypes = [p, ctypes.c_double, i, i, p, p]
    lib.tree_fold.restype = ctypes.c_int
    return lib


def _check_inputs(codes, feature, threshold_bin, left, right, scaled_value,
                  max_depth) -> None:
    nodes = (feature, threshold_bin, left, right)
    tensors = (codes, *nodes, scaled_value)
    if codes.device.type != "cuda" or any(t.device != codes.device
                                          for t in tensors):
        raise ValueError("tree_predict_kernel needs every tensor on one "
                         "CUDA device, got "
                         f"{sorted({str(t.device) for t in tensors})}")
    if any(t.dtype != torch.int32 for t in (codes, *nodes)) \
            or scaled_value.dtype != torch.float64:
        raise TypeError("codes and node arrays must be int32 and "
                        "scaled_value float64")
    if codes.ndim != 2 or feature.ndim != 2 or any(
            t.shape != feature.shape for t in (*nodes, scaled_value)):
        raise ValueError(f"codes must be [N, F] and node arrays one [T, M] "
                         f"shape, got {tuple(codes.shape)} and "
                         f"{[tuple(t.shape) for t in tensors[1:]]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("tree_predict_kernel needs contiguous tensors")
    if max_depth < 0:
        raise ValueError(f"max_depth must be >= 0, got {max_depth}")
    if feature.shape[0] and not feature.shape[1]:
        raise ValueError("node arrays need at least one node slot a tree")


def _descend(codes, feature, threshold_bin, left, right, scaled_value,
             max_depth, route=None) -> torch.Tensor:
    """``[N, T]`` f64: each (row, tree)'s pre-scaled leaf value, from one
    ``tree_descend`` launch on :func:`choose_route`'s route (``route``
    forces one, for the checks; ``descend_shared`` for trees that do not
    fit raises), counted in ``tree_predict_kernel.by_kernel``."""
    (n, f), (n_trees, max_nodes) = codes.shape, feature.shape
    leaf = torch.empty((n, n_trees), dtype=torch.float64, device=codes.device)
    if leaf.numel() == 0:
        return leaf
    chosen, per_block, rows = choose_route(n, f, n_trees, max_nodes)
    route = route or chosen
    if route not in ROUTES:
        raise ValueError(f"route {route!r} is not one of {ROUTES}")
    if route == "descend_shared" and chosen != route:
        raise ValueError(f"trees of {max_nodes} node slots do not fit in "
                         "shared memory: route descend_global")
    lib = _lib()
    with torch.cuda.device(codes.device):
        rc = lib.tree_descend(
            *(_build.ptr(t) for t in (codes, feature, threshold_bin, left,
                                      right, scaled_value)),
            n, f, n_trees, max_nodes, max_depth, per_block, rows,
            int(route == "descend_shared"), _build.ptr(leaf),
            _build.stream_of(codes))
    _build.check(lib, rc, f"tree_predict ({route})")
    tree_predict_kernel.by_kernel[route] += 1
    return leaf


def _fold(leaf: torch.Tensor, base: float) -> torch.Tensor:
    """``[N]`` f64: ``base`` plus each row of ``leaf`` ``[N, T]``, added
    one at a time in tree order (one ``tree_fold`` launch, counted in
    ``tree_predict_kernel.by_kernel``)."""
    n, n_trees = leaf.shape
    out = torch.empty(n, dtype=torch.float64, device=leaf.device)
    if n == 0:
        return out
    lib = _lib()
    with torch.cuda.device(leaf.device):
        rc = lib.tree_fold(_build.ptr(leaf), float(base), n, n_trees,
                           _build.ptr(out), _build.stream_of(leaf))
    _build.check(lib, rc, "tree_predict (fold)")
    tree_predict_kernel.by_kernel["fold"] += 1
    return out


def tree_predict_kernel(codes: torch.Tensor, feature: torch.Tensor,
                        threshold_bin: torch.Tensor, left: torch.Tensor,
                        right: torch.Tensor, scaled_value: torch.Tensor, *,
                        max_depth: int, base: float) -> torch.Tensor:
    """``codes [N, F]`` int32 bin codes; node arrays ``[T, M]`` int32 and
    ``scaled_value [T, M]`` f64 (leaf values pre-scaled by the learning
    rate), all contiguous on one CUDA device.  Returns ``[N]`` f64:
    ``base`` plus each tree's leaf value, added in training order.

    Two launches: the descent on :func:`choose_route`'s route, whose
    ``[N, T]`` f64 scratch is allocated here for any N (25 MB at 15.8k rows
    and 200 trees), then the fold.
    ``launches`` counts calls, ``by_kernel`` launches per CUDA kernel."""
    _check_inputs(codes, feature, threshold_bin, left, right, scaled_value,
                  max_depth)
    if codes.shape[0] == 0:
        return torch.empty(0, dtype=torch.float64, device=codes.device)
    out = _fold(_descend(codes, feature, threshold_bin, left, right,
                         scaled_value, max_depth), base)
    tree_predict_kernel.launches += 1
    return out


def reset_counts() -> None:
    """Set the launch counts (calls, and per CUDA kernel) to 0."""
    tree_predict_kernel.launches = 0
    tree_predict_kernel.by_kernel = dict.fromkeys(KERNELS, 0)


#: calls that launched the CUDA kernels since the counts were last set to
#: 0 (``launches``), and launches per kernel and route (``by_kernel``)
reset_counts()
