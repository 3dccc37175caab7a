"""Wrapper of the CUDA flash-attention forward kernels
(``csrc/flash_attention.cu``), and the rule by which the tensor-core kernel
sorts key tiles into skipped, masked and full ones."""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: largest head dimension the kernels take (the CUDA-core kernel's largest
#: tile; the tensor-core kernel takes bf16 with D 64 or 128)
MAX_HEAD_DIM = 256
#: the two kernels behind ``flash_attention``, by the number the C entry
#: reports: f32 / other head dims / unaligned rows on the CUDA cores, and
#: bf16 with D 64 or 128 on the tensor cores (wgmma fed by TMA)
KERNELS = ("flash_fwd", "flash_fwd_wgmma")
#: query rows per CTA of ``flash_fwd_wgmma`` by head dim (64 per consumer
#: warpgroup: ``consumer_groups`` in the source) and keys per tile (``TK``)
BLOCK_Q = {64: 192, 128: 128}
BLOCK_K = 128


class KeyTiles(NamedTuple):
    """The key tiles (indices of ``block_k``-column tiles) of one query
    tile starting at row ``q0``: not visited, visited with the mask, and
    visited without it."""
    q0: int
    skipped: list
    masked: list
    full: list


def classify_key_tiles(sq: int, sk: int, *, d: int = 128,
                       causal: bool = True, window: int = 0,
                       valid_len: int = 0, block_q: int | None = None,
                       block_k: int = BLOCK_K) -> list[KeyTiles]:
    """For each query tile of ``block_q`` rows (the kernel's at head dim
    ``d`` by default), which key tiles the tensor-core kernel skips, visits
    with the mask, and visits whole.

    The kernel's rule (``key_tiles`` and ``tile_full`` in
    ``csrc/flash_attention.cu``): the visited tiles run from the tile of
    the first row's window edge (0 without a window) to the last column
    below ``min(sk, valid_len)`` and, when causal, at or before the tile's
    last row.  A visited tile is full when every (row, column) in it is
    live: it ends at or below ``min(sk, valid_len)``, its last column is at
    or before the tile's first row (causal) and its first column is inside
    the window of the tile's last row.  ``valid_len`` 0 means ``sk``."""
    block_q = block_q or BLOCK_Q[d]
    kv_lim = min(sk, valid_len or sk)
    n_k = -(-sk // block_k)
    out = []
    for q0 in range(0, sq, block_q):
        q_last = min(q0 + block_q, sq) - 1
        hi = min(kv_lim, q_last + 1) if causal else kv_lim
        lo = max(0, q0 - window + 1) // block_k * block_k if window > 0 else 0
        count = -(-(hi - lo) // block_k) if hi > lo else 0
        visited = range(lo // block_k, lo // block_k + count)
        full = [t for t in visited
                if (t + 1) * block_k <= kv_lim
                and (not causal or (t + 1) * block_k - 1 <= q0)
                and (window <= 0 or q_last - t * block_k < window)]
        out.append(KeyTiles(q0, [t for t in range(n_k) if t not in visited],
                            [t for t in visited if t not in full], full))
    return out


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention.argtypes = (
        [p, p, p, p, i, i, i, i, i, i, i, i] + [ll] * 12
        + [ctypes.c_float, i, i, p, ctypes.POINTER(i)])
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
    taken = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        rc = lib.flash_attention(
            _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
            _DTYPES[q.dtype], b, hq, hkv, sq, sk, d, int(valid_len or sk),
            *strides, scale, int(causal), int(window),
            _build.stream_of(q), ctypes.byref(taken))
    _build.check(lib, rc, "flash_attention")
    flash_attention_kernel.launches += 1
    flash_attention_kernel.by_kernel[KERNELS[taken.value]] += 1
    return out


def reset_counts() -> None:
    """Set the launch counts (all, and per kernel) to 0."""
    flash_attention_kernel.launches = 0
    flash_attention_kernel.by_kernel = dict.fromkeys(KERNELS, 0)


#: launches of the CUDA kernels since the counts were last set to 0, in all
#: (``launches``) and per kernel (``by_kernel``)
reset_counts()
