"""Wrapper of the CUDA sLSTM recurrence kernel (``csrc/slstm_scan.cu``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: units a head (4 du threads a block, at most 1024)
MAX_UNITS = 256
#: dynamic shared memory a block may use: 32 B du bytes
SMEM_MAX = 232448
_OUT_DTYPES = (torch.float32, torch.bfloat16)


def _lib() -> ctypes.CDLL:
    lib = _build.load("slstm_scan")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.slstm_scan.argtypes = [p, p, i, p, i, p, p, p, p, i, i, i, i, p]
    lib.slstm_scan.restype = ctypes.c_int
    return lib


def slstm_scan_kernel(pre: torch.Tensor, r: torch.Tensor, *,
                      out_dtype: torch.dtype = torch.float32):
    """pre [4, B, S, d] contiguous float32, r [4, H, du, du] contiguous
    float32 or bfloat16 (H du = d, du <= 256), on one CUDA device →
    (h [B, S, d] in ``out_dtype``, final (c, n, h, m), each [B, d]
    float32): :func:`~repro_torch.kernels.slstm_scan.ref.slstm_scan_ref`
    in one launch of H blocks.  ``launches`` counts launches."""
    if pre.device.type != "cuda" or r.device != pre.device:
        raise ValueError("slstm_scan_kernel needs pre and r on one CUDA "
                         f"device, got {pre.device} and {r.device}")
    if pre.dtype != torch.float32 or r.dtype not in (torch.float32,
                                                     torch.bfloat16):
        raise TypeError("pre must be float32 and r float32 or bfloat16, "
                        f"got {pre.dtype} and {r.dtype}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    if pre.ndim != 4 or r.ndim != 4 or pre.shape[0] != 4 or r.shape[0] != 4:
        raise ValueError(f"expected pre [4, B, S, d] and r [4, H, du, du], "
                         f"got {tuple(pre.shape)} and {tuple(r.shape)}")
    _, b, s, d = pre.shape
    _, h, du, du2 = r.shape
    if du != du2 or h * du != d:
        raise ValueError(f"r {tuple(r.shape)} is not [4, H, du, du] with "
                         f"H du = d = {d}")
    if not pre.is_contiguous() or not r.is_contiguous():
        raise ValueError("slstm_scan_kernel inputs must be contiguous")
    if not 1 <= du <= MAX_UNITS:
        raise ValueError(f"du {du} outside 1..{MAX_UNITS}")
    if 32 * b * du > SMEM_MAX:
        raise ValueError(f"batch {b} at du {du} needs {32 * b * du} bytes "
                         f"of shared memory, more than {SMEM_MAX}")
    hs = torch.empty((b, s, d), dtype=out_dtype, device=pre.device)
    state = tuple(torch.empty((b, d), dtype=torch.float32,
                              device=pre.device) for _ in range(4))
    if b * s * d == 0:
        for t in state:
            t.zero_()
        return hs, state
    lib = _lib()
    with torch.cuda.device(pre.device):
        rc = lib.slstm_scan(
            _build.ptr(pre), _build.ptr(r), int(r.dtype == torch.bfloat16),
            _build.ptr(hs), int(out_dtype == torch.bfloat16),
            *(_build.ptr(t) for t in state), b, s, h, du,
            _build.stream_of(pre))
    _build.check(lib, rc, "slstm_scan")
    slstm_scan_kernel.launches += 1
    return hs, state


#: launches of the CUDA kernel since the count was last set to 0
slstm_scan_kernel.launches = 0
