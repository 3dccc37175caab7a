"""Wrapper of the CUDA batched tree-inference kernel
(``csrc/tree_predict.cu``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build


def _lib() -> ctypes.CDLL:
    lib = _build.load("tree_predict")
    lib.tree_predict.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_double] \
        + [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_void_p]
    lib.tree_predict.restype = ctypes.c_int
    return lib


def tree_predict_kernel(codes: torch.Tensor, feature: torch.Tensor,
                        threshold_bin: torch.Tensor, left: torch.Tensor,
                        right: torch.Tensor, scaled_value: torch.Tensor, *,
                        max_depth: int, base: float) -> torch.Tensor:
    """``codes [N, F]`` int32 bin codes; node arrays ``[T, M]`` int32 and
    ``scaled_value [T, M]`` f64 (leaf values pre-scaled by the learning
    rate), all contiguous on one CUDA device.  Returns ``[N]`` f64:
    ``base`` plus each tree's leaf value, added in training order."""
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
    n, f = codes.shape
    n_trees, max_nodes = feature.shape
    out = torch.empty(n, dtype=torch.float64, device=codes.device)
    if n == 0:
        return out
    lib = _lib()
    with torch.cuda.device(codes.device):
        rc = lib.tree_predict(*(_build.ptr(t) for t in tensors),
                              float(base), n, f, n_trees, max_nodes,
                              max_depth, _build.ptr(out),
                              _build.stream_of(codes))
    _build.check(lib, rc, "tree_predict")
    tree_predict_kernel.launches += 1
    return out


#: launches of the CUDA kernel since the count was last set to 0
tree_predict_kernel.launches = 0
