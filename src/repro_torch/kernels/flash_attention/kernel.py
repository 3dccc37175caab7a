"""Wrapper of the CUDA flash-attention forward kernel
(``csrc/flash_attention.cu``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: largest head dimension the kernels take (the CUDA-core kernel's largest
#: tile; the tensor-core kernel takes bf16 with D 64 or 128)
MAX_HEAD_DIM = 256


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention.argtypes = (
        [p, p, p, p, i, i, i, i, i, i, i, i] + [ll] * 12
        + [ctypes.c_float, i, i, p])
    lib.flash_attention.restype = ctypes.c_int
    return lib


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool = True,
                           window: int = 0, scale=None, valid_len: int = 0
                           ) -> torch.Tensor:
    """q [B,Sq,Hq,D], k/v [B,Sk,Hkv,D] on one CUDA device, all float32 or
    all bfloat16, each with a unit stride on D → [B,Sq,Hq,D] in q's dtype.

    Masks as :func:`~repro_torch.kernels.flash_attention.ref.attention_ref`
    (``valid_len`` 0 means Sk); f32 softmax statistics and accumulators."""
    if q.device.type != "cuda" or not (k.device == v.device == q.device):
        raise ValueError("flash_attention_kernel needs q, k and v on one "
                         f"CUDA device, got {q.device}, {k.device}, "
                         f"{v.device}")
    if q.dtype not in _DTYPES or not (k.dtype == v.dtype == q.dtype):
        raise TypeError("q, k and v must all be float32 or all bfloat16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"expected q [B,Sq,Hq,D] and k = v [B,Sk,Hkv,D], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, hq, d = q.shape
    _, sk, hkv, dk = k.shape
    if k.shape[0] != b or dk != d or hkv == 0 or hq % hkv:
        raise ValueError(f"incompatible q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)}: batch and D must agree and "
                         "Hq be a multiple of Hkv")
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside 1..{MAX_HEAD_DIM}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("q, k and v need a unit stride on the head dim")
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    scale = float(scale if scale is not None else d ** -0.5)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    lib = _lib()
    with torch.cuda.device(q.device):
        rc = lib.flash_attention(
            _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
            _DTYPES[q.dtype], b, hq, hkv, sq, sk, d, int(valid_len or sk),
            *strides, scale, int(causal), int(window),
            _build.stream_of(q))
    _build.check(lib, rc, "flash_attention")
    flash_attention_kernel.launches += 1
    return out


#: launches of the CUDA kernel since the count was last set to 0
flash_attention_kernel.launches = 0
