"""Wrapper of the CUDA gradient-histogram kernel (``csrc/gbt_hist.cu``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: shared memory a block may use without opting in to more
_SMEM_LIMIT = 48 * 1024


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
    """codes [N, F] int32, grad [N] f32, both contiguous on one CUDA device
    → (gsum [F, n_bins] f32, cnt [F, n_bins] int32).  Codes outside
    ``[0, n_bins)`` are not counted."""
    if codes.device.type != "cuda" or grad.device != codes.device:
        raise ValueError("grad_histogram_kernel needs codes and grad on one "
                         f"CUDA device, got {codes.device} and "
                         f"{grad.device}")
    if codes.dtype != torch.int32 or grad.dtype != torch.float32:
        raise TypeError(f"codes must be int32 and grad float32, got "
                        f"{codes.dtype} and {grad.dtype}")
    if codes.ndim != 2 or grad.shape != (codes.shape[0],):
        raise ValueError(f"codes must be [N, F] and grad [N], got "
                         f"{tuple(codes.shape)} and {tuple(grad.shape)}")
    if not (codes.is_contiguous() and grad.is_contiguous()):
        raise ValueError("codes and grad must be contiguous")
    n, f = codes.shape
    if n_bins < 1 or f * n_bins * 8 > _SMEM_LIMIT:
        raise ValueError(f"F * n_bins = {f} * {n_bins} outside the "
                         f"kernel's shared-memory histogram (1..."
                         f"{_SMEM_LIMIT // 8} bins in all)")
    gsum = torch.empty((f, n_bins), dtype=torch.float32, device=codes.device)
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
