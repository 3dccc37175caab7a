"""Plain PyTorch versions of the W8A16 matmul: the quantiser, the product,
the quantisation error, and the tolerance a kernel is held to."""
from __future__ import annotations

import numpy as np
import torch

#: f32 unit roundoff
_U = 2.0 ** -24


def quantize(w) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8.  w [K,N] (array or tensor) →
    (w_q int8 [K,N], scale f32 [N]) on w's device (the CPU for an array).

    ``amax / 127`` in f32 and round half to even, as the reference's numpy
    quantiser: the two agree bit for bit.  An all-zero column gets scale 1.
    """
    w = (w.float() if isinstance(w, torch.Tensor)
         else torch.as_tensor(np.asarray(w, np.float32)))
    amax = w.abs().amax(dim=0)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    w_q = torch.clamp(torch.round(w / scale[None, :]), -127, 127)
    return w_q.to(torch.int8), scale


def dequantize(w_q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """w_q [K,N] int8, scale [N] → ``w_q * scale`` in f32, cast to dtype."""
    return (w_q.float() * scale[None, :].float()).to(dtype)


def int8_matmul_ref(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor
                    ) -> torch.Tensor:
    """x [M,K] × dequant(w_q, scale) in f32, cast to ``x.dtype``."""
    return torch.matmul(x.float(), dequantize(w_q, scale)).to(x.dtype)


def quant_error_bound(w) -> float:
    """Max relative dequant error (≤ 1/254 per channel by construction)."""
    w = (w.float() if isinstance(w, torch.Tensor)
         else torch.as_tensor(np.asarray(w, np.float32)))
    w_q, scale = quantize(w)
    deq = dequantize(w_q, scale)
    denom = torch.clamp(w.abs().amax(dim=0), min=1e-9)
    return float(((deq - w).abs() / denom[None, :]).max())


def int8_tolerance(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(want, tol), both f32 [M,N]: the plain version's f32 product before
    its cast, and the per-element limit of ``|kernel - want|``.

    Each side sums K products in f32 in its own order and rounds the
    dequant or the scale product once more, so each is within
    ``(K+2)·2⁻²⁴·Σₖ|x||w_q|·scale`` of the exact sum; the limit takes that
    twice (c = 2).  A bf16 output adds its one rounding, ``2⁻⁸`` of the
    value rounded.  A dropped term of K moves an output by
    ``|x_k w_k|·scale``, far above this limit at K in the thousands.
    """
    k = x.shape[-1]
    xf = x.float()
    want = torch.matmul(xf, dequantize(w_q, scale))
    mag = torch.matmul(xf.abs(), dequantize(w_q.abs(), scale))
    tol = 2.0 * (k + 2) * _U * mag
    if x.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -8 * (want.abs() + tol)
    return want, tol


#: a chunk of the weight in ``w8a16_wgmma``'s fragment order: PACK_K rows of
#: K by PACK_N weight columns (``TK`` and ``TN`` in ``csrc/int8_matmul.cu``)
PACK_K, PACK_N = 64, 128


def fragment_order() -> torch.Tensor:
    """[PACK_K · PACK_N] int64: for each byte of a packed chunk, the index
    ``k · PACK_N + n`` of the weight element of the chunk's tile it holds.

    Byte ``16 · tid + j`` belongs to consumer thread ``tid`` (warpgroup
    ``tid // 256``, warp ``tid // 64 % 4``, lane ``tid % 32``), which reads
    two 16-byte pieces 512 bytes apart (``h = tid // 32 % 2``); piece ``h``
    holds k16 steps ``2h`` and ``2h + 1``, 8 bytes each, in the order of
    wgmma's A registers 0..3 (two bytes a register, the lower k first):
    (column g, k 2t), (column g + 8, k 2t), (column g, k 2t + 8),
    (column g + 8, k 2t + 8), with g, t = lane // 4, lane % 4 and the
    warp's columns ``64 · warpgroup + 16 · warp``."""
    off = torch.arange(PACK_K * PACK_N)
    tid, j = off // 16, off % 16
    lane, h, warp, c = tid % 32, tid // 32 % 2, tid // 64 % 4, tid // 256
    g, t = lane // 4, lane % 4
    step, b = 2 * h + j // 8, j % 8
    reg, hi = b // 2, b % 2
    n = 64 * c + 16 * warp + g + 8 * (reg % 2)
    k = 16 * step + 2 * t + hi + 8 * (reg // 2)
    return k * PACK_N + n


def pack_fragments(w_q: torch.Tensor) -> torch.Tensor:
    """w_q [K,N] int8 → the flat int8 weight that ``w8a16_wgmma`` reads:
    zero-padded to whole PACK_K × PACK_N tiles, one chunk per (column block
    nb, K tile kt) at ``(nb · K_tiles + kt) · PACK_K · PACK_N``, each chunk
    in :func:`fragment_order`."""
    k, n = w_q.shape
    kt, nb = -(-k // PACK_K), -(-n // PACK_N)
    pad = torch.zeros((kt * PACK_K, nb * PACK_N), dtype=w_q.dtype,
                      device=w_q.device)
    pad[:k, :n] = w_q
    tiles = pad.reshape(kt, PACK_K, nb, PACK_N).permute(2, 0, 1, 3)
    tiles = tiles.reshape(nb, kt, PACK_K * PACK_N)
    return tiles[:, :, fragment_order().to(w_q.device)].reshape(-1)


def unpack_fragments(packed: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """The inverse of :func:`pack_fragments` for a [k, n] weight."""
    kt, nb = -(-k // PACK_K), -(-n // PACK_N)
    tiles = torch.empty((nb, kt, PACK_K * PACK_N), dtype=packed.dtype,
                        device=packed.device)
    tiles[:, :, fragment_order().to(packed.device)] = packed.reshape(
        nb, kt, -1)
    full = tiles.reshape(nb, kt, PACK_K, PACK_N).permute(1, 2, 0, 3)
    return full.reshape(kt * PACK_K, nb * PACK_N)[:k, :n]
