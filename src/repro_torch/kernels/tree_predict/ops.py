"""Batched tree inference over :class:`TreeArrays`: the plain version for
CPU tensors, the CUDA ``tree_predict`` kernel for CUDA tensors.

Both are exact in f64 — leaf values pre-scaled by the learning rate in
f64, added one at a time in training order onto the ensemble's ``base`` —
so either equals the reference's ``GBTRegressor.predict`` bit for bit.
"""
# repro: module-tags=fma-sensitive
# (DET001: tree accumulation stays add-only — leaf values are pre-scaled)
from __future__ import annotations

import torch

from repro_torch._device import DeviceLike, as_tensor, resolve_device
from repro_torch.kernels.tree_predict.kernel import tree_predict_kernel
from repro_torch.kernels.tree_predict.ref import (TreeArrays, bin_codes_ref,
                                                  device_trees,
                                                  tree_predict_ref)


def tree_predict(codes: torch.Tensor, feature: torch.Tensor,
                 threshold_bin: torch.Tensor, left: torch.Tensor,
                 right: torch.Tensor, scaled_value: torch.Tensor, *,
                 max_depth: int, base: float) -> torch.Tensor:
    """``[N]`` f64 predictions from bin codes: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors."""
    fn = tree_predict_ref if codes.device.type == "cpu" \
        else tree_predict_kernel
    return fn(codes, feature, threshold_bin, left, right, scaled_value,
              max_depth=max_depth, base=base)


def predict_trees(x, arrays: TreeArrays, *,
                  device: DeviceLike = None) -> torch.Tensor:
    """``[N]`` f64 predictions for ``x [N, F]`` on ``device`` (None =
    cuda), bit for bit with the reference's ``GBTRegressor.predict``."""
    x32 = as_tensor(x, torch.float32, resolve_device(device))
    t = device_trees(arrays, x32.device)
    return tree_predict(bin_codes_ref(x32, t.edges), t.feature,
                        t.threshold_bin, t.left, t.right, t.scaled_value,
                        max_depth=arrays.max_depth, base=arrays.base)
