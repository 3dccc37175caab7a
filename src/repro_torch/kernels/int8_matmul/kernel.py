"""Wrapper of the CUDA W8A16 matmul kernel (``csrc/int8_matmul.cu``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load("int8_matmul")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.int8_matmul_splits.argtypes = [i, i, i, i]
    lib.int8_matmul_splits.restype = ctypes.c_int
    lib.int8_matmul.argtypes = [p] * 5 + [i] * 4 + [p]
    lib.int8_matmul.restype = ctypes.c_int
    return lib


def int8_matmul_kernel(x: torch.Tensor, w_q: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """x [M,K] float32 or bfloat16, w_q [K,N] int8, scale [N] float32, all
    contiguous on one CUDA device → ``(x · w_q) * scale`` [M,N] in x's
    dtype, summed in f32.

    bf16 runs on the tensor cores, f32 on the CUDA cores (no TF32).  Ragged
    M, N and K are masked in the kernel: no operand is padded or copied.
    Where K is split across blocks, an f32 workspace of splits × M × N is
    allocated here and reduced in a fixed order."""
    ts = (x, w_q, scale)
    if x.dtype not in _DTYPES or w_q.dtype != torch.int8 \
            or scale.dtype != torch.float32:
        raise TypeError("int8_matmul_kernel takes x float32 or bfloat16, "
                        "w_q int8 and scale float32, got "
                        f"{[t.dtype for t in ts]}")
    if x.ndim != 2 or w_q.ndim != 2 or scale.shape != w_q.shape[1:] \
            or x.shape[1] != w_q.shape[0]:
        raise ValueError(f"shapes x {tuple(x.shape)}, w_q "
                         f"{tuple(w_q.shape)}, scale {tuple(scale.shape)} "
                         "do not fit [M,K], [K,N], [N]")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("int8_matmul_kernel inputs must be contiguous")
    if x.device.type != "cuda" or any(t.device != x.device for t in ts):
        raise ValueError("int8_matmul_kernel needs x, w_q and scale on one "
                         f"CUDA device, got {[str(t.device) for t in ts]}")
    (m, k), n = x.shape, w_q.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    lib = _lib()
    dtype = _DTYPES[x.dtype]
    with torch.cuda.device(x.device):
        splits = lib.int8_matmul_splits(m, n, k, dtype)
        if splits < 0:
            _build.check(lib, -splits, "int8_matmul (plan)")
        ws = (torch.empty((splits, m, n), dtype=torch.float32,
                          device=x.device) if splits > 1 else None)
        rc = lib.int8_matmul(_build.ptr(x), _build.ptr(w_q),
                             _build.ptr(scale), _build.ptr(out),
                             None if ws is None else _build.ptr(ws), dtype,
                             m, n, k, _build.stream_of(x))
    _build.check(lib, rc, "int8_matmul")
    int8_matmul_kernel.launches += 1
    return out


#: launches of the CUDA kernel since the count was last set to 0
int8_matmul_kernel.launches = 0
