"""Plain PyTorch version of the gradient-histogram kernel (bincount)."""
from __future__ import annotations

import torch


def grad_histogram_ref(codes: torch.Tensor, grad: torch.Tensor, n_bins: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """codes [N,F] int, grad [N] → (gsum [F,bins] f64, cnt [F,bins] f64).

    Two ``torch.bincount`` calls over ``code + feature * n_bins``; on the
    CPU they accumulate in numpy's order, so the result equals the
    reference's ``np.bincount`` bit for bit.
    """
    n, f = codes.shape
    flat = (codes.to(torch.int64) + torch.arange(
        f, device=codes.device)[None, :] * n_bins).reshape(-1)
    # repeat_interleave(grad, f) interleaves per row, like codes.reshape(-1)
    weights = grad.to(torch.float64).repeat_interleave(f)
    gsum = torch.bincount(flat, weights=weights, minlength=f * n_bins)
    cnt = torch.bincount(flat, minlength=f * n_bins)
    # (bincount of an empty input returns int64 even with f64 weights)
    return (gsum.reshape(f, n_bins).to(torch.float64),
            cnt.reshape(f, n_bins).to(torch.float64))
