"""Flash-attention dispatch in the model layout: the plain version on the
CPU, the CUDA kernel on the card."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
from repro_torch.kernels.flash_attention.ref import attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, scale=None
                    ) -> torch.Tensor:
    """q [B,S,Hq,D], k/v [B,S,Hkv,D] → [B,S,Hq,D] in q's dtype.

    CPU tensors take :func:`attention_ref`; CUDA tensors the kernel, which
    reads this layout with strides and masks the ragged tail itself (no
    padding, no transposed copies)."""
    if q.device.type == "cpu":
        out = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, window=window,
                            scale=scale)
        return out.transpose(1, 2)
    return flash_attention_kernel(q, k, v, causal=causal, window=window,
                                  scale=scale)
