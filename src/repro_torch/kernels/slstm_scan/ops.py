"""sLSTM recurrence dispatch: the plain step loop on the CPU, the CUDA
kernels on the card, and the recurrence's backward."""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels.slstm_scan.kernel import (slstm_scan_bwd_kernel,
                                                   slstm_scan_kernel)
from repro_torch.kernels.slstm_scan.ref import (slstm_scan_bwd_ref,
                                                slstm_scan_ref)


class SLSTMScan(torch.autograd.Function):
    """(pre, r) → (h, c, n, h_last, m) with its backward: on the card the
    forward kernel, saving each step's state and gates, and the backward
    kernel; on the CPU :func:`slstm_scan_ref` and
    :func:`slstm_scan_bwd_ref`.  Any output's cotangent may be absent."""

    @staticmethod
    def forward(ctx, pre, r, out_dtype):
        ctx.set_materialize_grads(False)
        if pre.device.type == "cpu":
            ctx.save_for_backward(pre, r)
            hs, state = slstm_scan_ref(pre, r, out_dtype=out_dtype)
        else:
            hs, state, saved = slstm_scan_kernel(pre, r, out_dtype=out_dtype,
                                                 save_states=True)
            ctx.save_for_backward(saved, r)
        return hs, *state

    @staticmethod
    @once_differentiable
    def backward(ctx, h_cot, *state_cot):
        first, r = ctx.saved_tensors
        if h_cot is None and all(g is None for g in state_cot):
            return None, None, None
        if first.device.type == "cpu":
            dpre, dr = slstm_scan_bwd_ref(first, r, h_cot, state_cot)
        else:
            dpre, dr = slstm_scan_bwd_kernel(first, r, h_cot, state_cot)
        return dpre, dr.to(r.dtype), None


def slstm_scan(pre: torch.Tensor, r: torch.Tensor, *,
               out_dtype: torch.dtype = torch.float32):
    """pre [4, B, S, d] f32, r [4, H, du, du] → (h [B, S, d] in
    ``out_dtype``, final (c, n, h, m) [B, d] f32).  With grad mode on and
    an input that needs a gradient it goes through :class:`SLSTMScan`;
    otherwise nothing is saved: :func:`slstm_scan_ref` for CPU tensors,
    the kernel for CUDA tensors."""
    if torch.is_grad_enabled() and (pre.requires_grad or r.requires_grad):
        hs, *state = SLSTMScan.apply(pre.contiguous(), r.contiguous(),
                                     out_dtype)
        return hs, tuple(state)
    if pre.device.type == "cpu":
        return slstm_scan_ref(pre, r, out_dtype=out_dtype)
    return slstm_scan_kernel(pre.contiguous(), r.contiguous(),
                             out_dtype=out_dtype)
