"""Wrapper of the CUDA gradient-histogram kernel (``csrc/gbt_hist.cu``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: (node, feature, bin group) warps a block, and rows a warp stages at a
#: time, as in the source (``WARPS``, ``BATCH``): an int32 code and an f64
#: gradient a row, 6 KB of static shared memory a block, under the 48 KB a
#: block may use without opting in to more; it does not grow with the level
WARPS_PER_BLOCK = 4
ROWS_PER_BATCH = 128
SMEM_BYTES = WARPS_PER_BLOCK * ROWS_PER_BATCH * (4 + 8)


def _lib() -> ctypes.CDLL:
    lib = _build.load("gbt_hist")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gbt_hist.argtypes = [p, p, p, p, i, i, i, p, p, p]
    lib.gbt_hist.restype = ctypes.c_int
    return lib


def level_histogram_kernel(codes: torch.Tensor, grad: torch.Tensor,
                           order: torch.Tensor, offsets: torch.Tensor,
                           n_bins: int) -> tuple[torch.Tensor, torch.Tensor]:
    """codes [N, F] int32, grad [N] float64, order [M] int32 (row ids
    grouped by node, ascending within each), offsets [K+1] int32, all
    contiguous on one CUDA device → (gsum [K, F, n_bins] float64, cnt
    [K, F, n_bins] int32): the histograms of one tree level in one launch.

    Each sum adds its bin's gradients in row order from +0.0, as
    ``np.bincount`` does, so it equals the plain version on the CPU bit for
    bit.  Codes outside ``[0, n_bins)`` are not counted.  The row ids and
    offsets are not checked against N and M on the card."""
    ts = (codes, grad, order, offsets)
    if codes.device.type != "cuda" or any(t.device != codes.device
                                          for t in ts):
        raise ValueError("level_histogram_kernel needs its inputs on one "
                         f"CUDA device, got {[str(t.device) for t in ts]}")
    if (codes.dtype, grad.dtype, order.dtype, offsets.dtype) != (
            torch.int32, torch.float64, torch.int32, torch.int32):
        raise TypeError("codes, order and offsets must be int32 and grad "
                        f"float64, got {[t.dtype for t in ts]}")
    if (codes.ndim != 2 or grad.shape != (codes.shape[0],)
            or order.ndim != 1 or offsets.ndim != 1 or offsets.numel() < 2):
        raise ValueError(f"codes must be [N, F], grad [N], order [M] and "
                         f"offsets [K+1], got {[tuple(t.shape) for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("level_histogram_kernel inputs must be contiguous")
    if n_bins < 1:
        raise ValueError(f"n_bins = {n_bins} must be at least 1")
    k, f = offsets.numel() - 1, codes.shape[1]
    gsum = torch.empty((k, f, n_bins), dtype=torch.float64,
                       device=codes.device)
    cnt = torch.empty((k, f, n_bins), dtype=torch.int32, device=codes.device)
    if f == 0:
        return gsum, cnt
    lib = _lib()
    with torch.cuda.device(codes.device):
        rc = lib.gbt_hist(*(_build.ptr(t) for t in ts), k, f, n_bins,
                          _build.ptr(gsum), _build.ptr(cnt),
                          _build.stream_of(codes))
    _build.check(lib, rc, "gbt_hist")
    level_histogram_kernel.launches += 1
    return gsum, cnt


#: launches of the CUDA kernel since the count was last set to 0
level_histogram_kernel.launches = 0


def grad_histogram_kernel(codes: torch.Tensor, grad: torch.Tensor,
                          n_bins: int) -> tuple[torch.Tensor, torch.Tensor]:
    """codes [N, F] int32, grad [N] float64, both contiguous on one CUDA
    device → (gsum [F, n_bins] float64, cnt [F, n_bins] int32): the
    one-node level of ``level_histogram_kernel``, over every row (its
    launch counts there)."""
    if codes.device.type != "cuda" or grad.device != codes.device:
        raise ValueError("grad_histogram_kernel needs codes and grad on one "
                         f"CUDA device, got {codes.device} and "
                         f"{grad.device}")
    n = codes.shape[0]
    gsum, cnt = level_histogram_kernel(
        codes, grad, torch.arange(n, dtype=torch.int32, device=codes.device),
        torch.tensor([0, n], dtype=torch.int32, device=codes.device), n_bins)
    return gsum[0], cnt[0]
