"""Wrapper of the CUDA gradient-histogram kernel (``csrc/gbt_hist.cu``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: bins per block (one warp each) and rows a block stages at a time, as in
#: the source (``BINS``, ``CHUNK``): an int32 code and an f64 gradient a
#: row, 24 KB of static shared memory, under the 48 KB a block may use
#: without opting in to more; it does not grow with F or n_bins
BINS_PER_BLOCK = 8
ROWS_PER_CHUNK = 2048
SMEM_BYTES = ROWS_PER_CHUNK * (4 + 8)
#: most bins a call takes: the grid's second dimension is 65,535 blocks
MAX_BINS = 65535 * BINS_PER_BLOCK


def _lib() -> ctypes.CDLL:
    lib = _build.load("gbt_hist")
    lib.gbt_hist.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                             ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_void_p]
    lib.gbt_hist.restype = ctypes.c_int
    return lib


def grad_histogram_kernel(codes: torch.Tensor, grad: torch.Tensor,
                          n_bins: int) -> tuple[torch.Tensor, torch.Tensor]:
    """codes [N, F] int32, grad [N] float64, both contiguous on one CUDA
    device → (gsum [F, n_bins] float64, cnt [F, n_bins] int32).

    Each sum adds its bin's gradients in row order from +0.0, as
    ``np.bincount`` does, so it equals the plain version on the CPU bit for
    bit.  Codes outside ``[0, n_bins)`` are not counted."""
    if codes.device.type != "cuda" or grad.device != codes.device:
        raise ValueError("grad_histogram_kernel needs codes and grad on one "
                         f"CUDA device, got {codes.device} and "
                         f"{grad.device}")
    if codes.dtype != torch.int32 or grad.dtype != torch.float64:
        raise TypeError(f"codes must be int32 and grad float64, got "
                        f"{codes.dtype} and {grad.dtype}")
    if codes.ndim != 2 or grad.shape != (codes.shape[0],):
        raise ValueError(f"codes must be [N, F] and grad [N], got "
                         f"{tuple(codes.shape)} and {tuple(grad.shape)}")
    if not (codes.is_contiguous() and grad.is_contiguous()):
        raise ValueError("codes and grad must be contiguous")
    n, f = codes.shape
    if not 1 <= n_bins <= MAX_BINS:
        raise ValueError(f"n_bins = {n_bins} outside 1..{MAX_BINS}")
    gsum = torch.empty((f, n_bins), dtype=torch.float64, device=codes.device)
    cnt = torch.empty((f, n_bins), dtype=torch.int32, device=codes.device)
    if n == 0 or f == 0:
        return gsum.zero_(), cnt.zero_()
    lib = _lib()
    with torch.cuda.device(codes.device):
        rc = lib.gbt_hist(_build.ptr(codes), _build.ptr(grad), n, f, n_bins,
                          _build.ptr(gsum), _build.ptr(cnt),
                          _build.stream_of(codes))
    _build.check(lib, rc, "gbt_hist")
    grad_histogram_kernel.launches += 1
    return gsum, cnt


#: launches of the CUDA kernel since the count was last set to 0
grad_histogram_kernel.launches = 0
