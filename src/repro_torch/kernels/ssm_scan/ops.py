"""Model-layout SSD scan dispatch: the plain chunked version on the CPU,
the CUDA kernels on the card, and the scan's backward.  Same inputs and
outputs as ``models.mamba2.ssd_chunked``.

Each call is a ``torch.library`` custom op (``repro_torch::ssd_scan``,
``ssd_scan_save``, ``ssd_scan_bwd``): its fake implementation gives meta
and fake tensors what the kernels return and save (the dry-run runs the
model on meta tensors), and its FLOP formula, ``kernels.work.ssm_work``
and ``ssm_bwd_work``, lets ``FlopCounterMode`` count the kernels, which
ATen's counters cannot see."""
from __future__ import annotations

from typing import Optional

import torch
from torch.autograd.function import once_differentiable
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.ssm_scan.kernel import (MAX_CHUNK, MAX_HEAD_DIM,
                                                 MAX_STATE,
                                                 ssd_scan_bwd_kernel,
                                                 ssd_scan_kernel)
from repro_torch.kernels.ssm_scan.ref import (ssd_inputs,
                                              ssd_scan_chunked_bwd_ref,
                                              ssd_scan_chunked_ref)
from repro_torch.kernels.work import ssm_bwd_work, ssm_work

Tensor = torch.Tensor


@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=())
def _scan(xdt: Tensor, loga: Tensor, b: Tensor, c: Tensor, chunk: int
          ) -> tuple[Tensor, Tensor]:
    if xdt.device.type == "cpu":
        return ssd_scan_chunked_ref(xdt, loga, b, c, chunk)
    return ssd_scan_kernel(xdt, loga, b, c, chunk)


@torch.library.custom_op("repro_torch::ssd_scan_save", mutates_args=())
def _scan_save(xdt: Tensor, loga: Tensor, b: Tensor, c: Tensor, chunk: int
               ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """(y, state) and what the backward kernels read: C·Bᵀ and each
    chunk's incoming state (empty on the CPU, whose backward recomputes,
    and for an empty call, which launches nothing)."""
    if xdt.device.type == "cpu":
        y, state = ssd_scan_chunked_ref(xdt, loga, b, c, chunk)
        saved = None
    else:
        y, state, saved = ssd_scan_kernel(xdt, loga, b, c, chunk,
                                          save_states=True)
    if saved is None:
        saved = (xdt.new_empty(0), xdt.new_empty(0))
    return y, state, *saved


@torch.library.custom_op("repro_torch::ssd_scan_bwd", mutates_args=())
def _scan_bwd(xdt: Tensor, loga: Tensor, b: Tensor, c: Tensor, cb: Tensor,
              states: Tensor, chunk: int, y_cot: Optional[Tensor],
              state_cot: Optional[Tensor]
              ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    if xdt.device.type == "cpu":
        return ssd_scan_chunked_bwd_ref(xdt, loga, b, c, chunk, y_cot,
                                        state_cot)
    if cb.numel() == 0:         # an empty call: nothing was launched
        return tuple(torch.zeros_like(t) for t in (xdt, loga, b, c))
    return ssd_scan_bwd_kernel(xdt, loga, b, c, cb, states, chunk, y_cot,
                               state_cot)


def _outs(xdt, b):
    bsz, _, h, p = xdt.shape
    return torch.empty_like(xdt), xdt.new_empty((bsz, h, p, b.shape[-1]))


@_scan.register_fake
def _(xdt, loga, b, c, chunk):
    return _outs(xdt, b)


@_scan_save.register_fake
def _(xdt, loga, b, c, chunk):
    bsz, s, h, _ = xdt.shape
    nc = -(-s // chunk)
    return (*_outs(xdt, b), xdt.new_empty((bsz, nc, MAX_CHUNK, MAX_CHUNK)),
            xdt.new_empty((bsz * h, nc, MAX_HEAD_DIM, MAX_STATE)))


@_scan_bwd.register_fake
def _(xdt, loga, b, c, cb, states, chunk, y_cot, state_cot):
    return tuple(torch.empty_like(t) for t in (xdt, loga, b, c))


@register_flop_formula([torch.ops.repro_torch.ssd_scan,
                        torch.ops.repro_torch.ssd_scan_save])
def _flops(xdt_shape, loga_shape, b_shape, c_shape, chunk, *,
           out_shape=None, **kwargs) -> int:
    bsz, s, h, p = xdt_shape
    return ssm_work(bsz, s, h, p, b_shape[-1], chunk)[1]


@register_flop_formula(torch.ops.repro_torch.ssd_scan_bwd)
def _bwd_flops(xdt_shape, loga_shape, b_shape, c_shape, cb_shape,
               states_shape, chunk, *args, out_shape=None, **kwargs) -> int:
    bsz, s, h, p = xdt_shape
    return ssm_bwd_work(bsz, s, h, p, b_shape[-1], chunk)[1]


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
        y, state, *saved = torch.ops.repro_torch.ssd_scan_save(
            xdt, loga, b, c, chunk)
        ctx.save_for_backward(xdt, loga, b, c, *saved)
        return y, state

    @staticmethod
    @once_differentiable
    def backward(ctx, y_cot, state_cot):
        if y_cot is None and state_cot is None:
            return None, None, None, None, None
        grads = torch.ops.repro_torch.ssd_scan_bwd(
            *ctx.saved_tensors, ctx.chunk, y_cot, state_cot)
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
    else:
        y, state = torch.ops.repro_torch.ssd_scan(*args, chunk)
    return y + d_skip.float()[None, None, :, None] * x.float(), state
