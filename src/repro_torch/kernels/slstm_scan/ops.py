"""sLSTM recurrence dispatch: the plain step loop on the CPU, the CUDA
kernel on the card."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.slstm_scan.kernel import slstm_scan_kernel
from repro_torch.kernels.slstm_scan.ref import slstm_scan_ref


def slstm_scan(pre: torch.Tensor, r: torch.Tensor, *,
               out_dtype: torch.dtype = torch.float32):
    """pre [4, B, S, d] f32, r [4, H, du, du] → (h [B, S, d] in
    ``out_dtype``, final (c, n, h, m) [B, d] f32).  CPU tensors take
    :func:`slstm_scan_ref`; CUDA tensors the kernel, which has no
    backward: with grad mode on and an input that needs a gradient it
    raises rather than return a result cut off from autograd."""
    if pre.device.type == "cpu":
        return slstm_scan_ref(pre, r, out_dtype=out_dtype)
    _build.refuse_grad("slstm_scan", pre, r)
    return slstm_scan_kernel(pre.contiguous(), r.contiguous(),
                             out_dtype=out_dtype)
