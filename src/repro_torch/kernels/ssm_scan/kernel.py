"""Wrapper of the CUDA chunked SSD scan kernel (``csrc/ssm_scan.cu``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: the kernel's shared-memory capacities: chunk, head dim, state dim
MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 128, 64, 64


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssm_scan")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssm_scan.argtypes = [p] * 6 + [i] * 6 + [p]
    lib.ssm_scan.restype = ctypes.c_int
    return lib


def ssd_scan_kernel(xdt: torch.Tensor, loga: torch.Tensor, b: torch.Tensor,
                    c: torch.Tensor, chunk: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """xdt [B,S,H,P], loga [B,S,H], b/c [B,S,N], all contiguous float32 on
    one CUDA device → (y [B,S,H,P], final state [B,H,P,N]), float32.

    The scan without the D skip term (the caller adds it), in chunks of
    ``chunk`` steps; a ragged last chunk acts as if padded with dt = 0."""
    ts = (xdt, loga, b, c)
    if xdt.device.type != "cuda" or any(t.device != xdt.device for t in ts):
        raise ValueError("ssd_scan_kernel needs all inputs on one CUDA "
                         f"device, got {[str(t.device) for t in ts]}")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("ssd_scan_kernel takes float32 inputs, got "
                        f"{[t.dtype for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("ssd_scan_kernel inputs must be contiguous")
    if xdt.ndim != 4:
        raise ValueError(f"xdt must be [B,S,H,P], got {tuple(xdt.shape)}")
    bsz, s, h, p = xdt.shape
    n = b.shape[-1]
    if (loga.shape != (bsz, s, h) or b.ndim != 3 or b.shape[:2] != (bsz, s)
            or c.shape != b.shape):
        raise ValueError(f"shapes xdt {tuple(xdt.shape)}, loga "
                         f"{tuple(loga.shape)}, b {tuple(b.shape)}, c "
                         f"{tuple(c.shape)} do not fit [B,S,H,P], [B,S,H], "
                         "[B,S,N], [B,S,N]")
    chunk = min(int(chunk), s) if s else int(chunk)
    if not (1 <= chunk <= MAX_CHUNK and p <= MAX_HEAD_DIM
            and n <= MAX_STATE):
        raise ValueError(f"chunk {chunk}, P {p}, N {n} outside the kernel's "
                         f"capacities ({MAX_CHUNK}, {MAX_HEAD_DIM}, "
                         f"{MAX_STATE})")
    y = torch.empty_like(xdt)
    state = torch.empty((bsz, h, p, n), dtype=torch.float32,
                        device=xdt.device)
    if bsz * h == 0 or p == 0 or n == 0:
        return y, state.zero_()
    lib = _lib()
    with torch.cuda.device(xdt.device):
        rc = lib.ssm_scan(*(_build.ptr(t) for t in (xdt, loga, b, c, y,
                                                    state)),
                          bsz, s, h, p, n, chunk, _build.stream_of(xdt))
    _build.check(lib, rc, "ssm_scan")
    ssd_scan_kernel.launches += 1
    return y, state


#: launches of the CUDA kernel since the count was last set to 0
ssd_scan_kernel.launches = 0
