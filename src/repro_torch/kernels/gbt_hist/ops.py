"""Gradient histogram dispatch: the plain version on the CPU, the CUDA
kernel on the card."""
from __future__ import annotations

import torch

from repro_torch.kernels.gbt_hist.kernel import grad_histogram_kernel
from repro_torch.kernels.gbt_hist.ref import grad_histogram_ref


def grad_histogram(codes: torch.Tensor, grad: torch.Tensor, n_bins: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """codes [N, F] int, grad [N] → f64 (gsum [F, n_bins], cnt [F, n_bins])
    on the tensors' device.  CPU tensors take the plain version, CUDA
    tensors the kernel; both add each bin's f64 gradients in row order, so
    they agree bit for bit with each other and with ``np.bincount``."""
    if codes.device.type == "cpu":
        return grad_histogram_ref(codes, grad, n_bins)
    gsum, cnt = grad_histogram_kernel(
        codes.to(torch.int32).contiguous(),
        grad.to(torch.float64).contiguous(), n_bins)
    return gsum, cnt.to(torch.float64)
