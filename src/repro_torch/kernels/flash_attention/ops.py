"""Flash-attention dispatch in the model layout: the plain version on the
CPU, the CUDA kernel on the card."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
from repro_torch.kernels.flash_attention.ref import attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, scale=None,
                    valid_len: int = 0, return_lse: bool = False):
    """q/k [B,S,H,D] (k with Hkv heads), v [B,S,Hkv,Dv], Dv <= D →
    [B,S,Hq,Dv] in q's dtype; with ``return_lse`` also the rows'
    log-sum-exp, f32 [B,Hq,Sq] (keys at or past ``valid_len`` masked, 0
    meaning Sk).

    CPU tensors take :func:`attention_ref`; CUDA tensors the kernel, which
    reads this layout with strides, masks the ragged tail itself and takes
    v at its own head dim (MLA's 128 beside q/k's 192) as it is."""
    kw = dict(causal=causal, window=window, scale=scale,
              valid_len=valid_len, return_lse=return_lse)
    if q.device.type != "cpu":
        return flash_attention_kernel(q, k, v, **kw)
    got = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), **kw)
    if return_lse:
        return got[0].transpose(1, 2), got[1]
    return got.transpose(1, 2)
