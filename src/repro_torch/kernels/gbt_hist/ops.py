"""Gradient histogram dispatch: the plain version on the CPU, the CUDA
kernel on the card."""
from __future__ import annotations

import torch

from repro_torch.kernels.gbt_hist.kernel import grad_histogram_kernel
from repro_torch.kernels.gbt_hist.ref import grad_histogram_ref


def grad_histogram(codes: torch.Tensor, grad: torch.Tensor, n_bins: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """codes [N, F] int, grad [N] → f64 (gsum [F, n_bins], cnt [F, n_bins])
    on the tensors' device.  CPU tensors take the exact f64 plain version;
    CUDA tensors the kernel (f32 sums, exact counts)."""
    if codes.device.type == "cpu":
        return grad_histogram_ref(codes, grad, n_bins)
    gsum, cnt = grad_histogram_kernel(
        codes.to(torch.int32).contiguous(),
        grad.to(torch.float32).contiguous(), n_bins)
    return gsum.to(torch.float64), cnt.to(torch.float64)
