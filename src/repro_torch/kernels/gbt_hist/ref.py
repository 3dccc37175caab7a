"""Plain PyTorch version of the gradient-histogram kernel (bincount)."""
from __future__ import annotations

import torch


def level_histogram_ref(codes: torch.Tensor, grad: torch.Tensor,
                        order: torch.Tensor, offsets: torch.Tensor,
                        n_bins: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The histograms of one tree level's nodes.

    codes [N, F] int, grad [N]; ``order`` [M] holds row ids grouped by node
    (node k's rows are ``order[offsets[k]:offsets[k+1]]``, ascending), and
    ``offsets`` [K+1] → (gsum [K, F, bins] f64, cnt [K, F, bins] f64).

    Two ``torch.bincount`` calls over ``(node·F + f)·bins + code``; on the
    CPU they add in row order, so each node's histogram equals the
    reference's ``np.bincount`` over its rows bit for bit.  Codes outside
    ``[0, n_bins)`` are not counted.
    """
    f = codes.shape[1]
    k = offsets.numel() - 1
    order = order.to(torch.int64)
    node = torch.repeat_interleave(
        torch.arange(k, device=codes.device),
        (offsets[1:] - offsets[:-1]).to(torch.int64), output_size=len(order))
    c = codes[order].to(torch.int64)                       # [M, F]
    flat = (node[:, None] * f + torch.arange(f, device=codes.device)
            ) * n_bins + c
    # grad[order] repeated per feature interleaves per row, like flat
    weights = grad.to(torch.float64)[order][:, None].expand(-1, f)
    keep = (c >= 0) & (c < n_bins)
    size = k * f * n_bins
    gsum = torch.bincount(flat[keep], weights=weights[keep], minlength=size)
    cnt = torch.bincount(flat[keep], minlength=size)
    # (bincount of an empty input returns int64 even with f64 weights)
    return (gsum.reshape(k, f, n_bins).to(torch.float64),
            cnt.reshape(k, f, n_bins).to(torch.float64))


def grad_histogram_ref(codes: torch.Tensor, grad: torch.Tensor, n_bins: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """codes [N,F] int, grad [N] → (gsum [F,bins] f64, cnt [F,bins] f64):
    the one-node case of ``level_histogram_ref``, over every row."""
    n = codes.shape[0]
    gsum, cnt = level_histogram_ref(
        codes, grad, torch.arange(n, device=codes.device),
        torch.tensor([0, n], device=codes.device), n_bins)
    return gsum[0], cnt[0]
