"""Model-layout SSD scan dispatch: the plain chunked version on the CPU,
the CUDA kernels on the card, and the scan's backward.  Same inputs and
outputs as ``models.mamba2.ssd_chunked``."""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels.ssm_scan.kernel import (ssd_scan_bwd_kernel,
                                                 ssd_scan_kernel)
from repro_torch.kernels.ssm_scan.ref import (ssd_inputs,
                                              ssd_scan_chunked_bwd_ref,
                                              ssd_scan_chunked_ref)


class SSDScan(torch.autograd.Function):
    """The scan without the D term, (xdt, loga, b, c) → (y, final state),
    with its backward: on the card the forward kernels, saving C·Bᵀ and
    each chunk's incoming state, and the backward kernels; on the CPU
    :func:`ssd_scan_chunked_ref` and :func:`ssd_scan_chunked_bwd_ref`.
    Either output's cotangent may be absent."""

    @staticmethod
    def forward(ctx, xdt, loga, b, c, chunk):
        ctx.set_materialize_grads(False)
        ctx.chunk = chunk
        if xdt.device.type == "cpu":
            ctx.save_for_backward(xdt, loga, b, c)
            return ssd_scan_chunked_ref(xdt, loga, b, c, chunk)
        y, state, saved = ssd_scan_kernel(xdt, loga, b, c, chunk,
                                          save_states=True)
        ctx.save_for_backward(xdt, loga, b, c, *(saved or ()))
        return y, state

    @staticmethod
    @once_differentiable
    def backward(ctx, y_cot, state_cot):
        xdt, loga, b, c, *saved = ctx.saved_tensors
        if y_cot is None and state_cot is None:
            return None, None, None, None, None
        if xdt.device.type == "cpu":
            grads = ssd_scan_chunked_bwd_ref(xdt, loga, b, c, ctx.chunk,
                                             y_cot, state_cot)
        elif not saved:         # an empty call: nothing was launched
            grads = tuple(torch.zeros_like(t) for t in (xdt, loga, b, c))
        else:
            grads = ssd_scan_bwd_kernel(xdt, loga, b, c, *saved, ctx.chunk,
                                        y_cot, state_cot)
        return (*grads, None)


def ssd_chunked_kernel(x: torch.Tensor, dt: torch.Tensor,
                       a_log: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, d_skip: torch.Tensor,
                       chunk: int = 128
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,H,P]; dt [B,S,H]; b/c [B,S,N]; A_log/D [H] → (y [B,S,H,P]
    f32, final state [B,H,P,N] f32).  The wrapper adds ``D·x``.

    With grad mode on and an input that needs a gradient the scan goes
    through :class:`SSDScan`; otherwise nothing is saved: the plain
    version on the CPU, the two forward kernels on the card."""
    xdt, loga = ssd_inputs(x, dt, a_log)
    args = (xdt.contiguous(), loga.contiguous(), b.float().contiguous(),
            c.float().contiguous())
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        y, state = SSDScan.apply(*args, chunk)
    elif x.device.type == "cpu":
        y, state = ssd_scan_chunked_ref(*args, chunk)
    else:
        y, state = ssd_scan_kernel(*args, chunk)
    return y + d_skip.float()[None, None, :, None] * x.float(), state
