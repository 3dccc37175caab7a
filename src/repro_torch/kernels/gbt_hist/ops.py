"""Gradient histogram dispatch: the plain version on the CPU, the CUDA
kernel on the card."""
from __future__ import annotations

import torch

from repro_torch.kernels.gbt_hist.kernel import (grad_histogram_kernel,
                                                 level_histogram_kernel)
from repro_torch.kernels.gbt_hist.ref import (grad_histogram_ref,
                                              level_histogram_ref)


def level_histogram(codes: torch.Tensor, grad: torch.Tensor,
                    order: torch.Tensor, offsets: torch.Tensor, n_bins: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """codes [N, F] int, grad [N], order [M] (row ids grouped by node,
    ascending within each), offsets [K+1] → f64 (gsum [K, F, n_bins], cnt
    [K, F, n_bins]) on the tensors' device, in one call.  CPU tensors take
    the plain version, CUDA tensors the kernel; both add each bin's f64
    gradients in row order, so they agree bit for bit with each other and
    with ``np.bincount`` over each node's rows."""
    if codes.device.type == "cpu":
        return level_histogram_ref(codes, grad, order, offsets, n_bins)
    gsum, cnt = level_histogram_kernel(
        codes.to(torch.int32).contiguous(),
        grad.to(torch.float64).contiguous(),
        order.to(torch.int32).contiguous(),
        offsets.to(torch.int32).contiguous(), n_bins)
    return gsum, cnt.to(torch.float64)


def grad_histogram(codes: torch.Tensor, grad: torch.Tensor, n_bins: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """codes [N, F] int, grad [N] → f64 (gsum [F, n_bins], cnt [F, n_bins]):
    ``level_histogram`` of one node holding every row."""
    if codes.device.type == "cpu":
        return grad_histogram_ref(codes, grad, n_bins)
    gsum, cnt = grad_histogram_kernel(
        codes.to(torch.int32).contiguous(),
        grad.to(torch.float64).contiguous(), n_bins)
    return gsum, cnt.to(torch.float64)
