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
