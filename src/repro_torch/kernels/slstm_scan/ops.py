"""sLSTM recurrence dispatch: the plain step loop on the CPU, the CUDA
kernels on the card, and the recurrence's backward.

Each call is a ``torch.library`` custom op (``repro_torch::slstm_scan``,
``slstm_scan_save``, ``slstm_scan_bwd``): its fake implementation gives
meta and fake tensors what the kernels return and save (the dry-run runs
the model on meta tensors), and its FLOP formula, ``kernels.work``'s
``slstm_work`` and ``slstm_bwd_work``, lets ``FlopCounterMode`` count the
kernels, which ATen's counters cannot see."""
from __future__ import annotations

from typing import Optional

import torch
from torch.autograd.function import once_differentiable
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.slstm_scan.kernel import (slstm_scan_bwd_kernel,
                                                   slstm_scan_kernel)
from repro_torch.kernels.slstm_scan.ref import (SAVED, slstm_scan_bwd_ref,
                                                slstm_scan_ref)
from repro_torch.kernels.work import slstm_bwd_work, slstm_work

Tensor = torch.Tensor
_Outs = tuple[Tensor, Tensor, Tensor, Tensor, Tensor]


@torch.library.custom_op("repro_torch::slstm_scan", mutates_args=())
def _scan(pre: Tensor, r: Tensor, out_dtype: torch.dtype) -> _Outs:
    if pre.device.type == "cpu":
        hs, state = slstm_scan_ref(pre, r, out_dtype=out_dtype)
    else:
        hs, state = slstm_scan_kernel(pre.contiguous(), r.contiguous(),
                                      out_dtype=out_dtype)
    return hs, *state


@torch.library.custom_op("repro_torch::slstm_scan_save", mutates_args=())
def _scan_save(pre: Tensor, r: Tensor, out_dtype: torch.dtype
               ) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """The card's forward that also returns each step's saved state and
    gates, what the backward kernel reads."""
    hs, state, saved = slstm_scan_kernel(pre, r, out_dtype=out_dtype,
                                         save_states=True)
    return hs, *state, saved


@torch.library.custom_op("repro_torch::slstm_scan_bwd", mutates_args=())
def _scan_bwd(first: Tensor, r: Tensor, h_cot: Optional[Tensor],
              c_cot: Optional[Tensor], n_cot: Optional[Tensor],
              hl_cot: Optional[Tensor], m_cot: Optional[Tensor]
              ) -> tuple[Tensor, Tensor]:
    """(dpre, dr) from ``first``: the inputs ``pre`` on the CPU, whose
    backward recomputes, the forward kernel's saved planes on the card."""
    state_cot = (c_cot, n_cot, hl_cot, m_cot)
    if first.device.type == "cpu":
        return slstm_scan_bwd_ref(first, r, h_cot, state_cot)
    return slstm_scan_bwd_kernel(first, r, h_cot, state_cot)


def _outs(pre, out_dtype):
    _, b, s, d = pre.shape
    return (pre.new_empty((b, s, d), dtype=out_dtype),
            *(pre.new_empty((b, d), dtype=torch.float32) for _ in range(4)))


@_scan.register_fake
def _(pre, r, out_dtype):
    return _outs(pre, out_dtype)


@_scan_save.register_fake
def _(pre, r, out_dtype):
    _, b, s, d = pre.shape
    return (*_outs(pre, out_dtype),
            pre.new_empty((len(SAVED), b, s, d), dtype=torch.float32))


@_scan_bwd.register_fake
def _(first, r, h_cot, c_cot, n_cot, hl_cot, m_cot):
    _, b, s, d = first.shape
    return (first.new_empty((4, b, s, d), dtype=torch.float32),
            torch.empty_like(r, dtype=torch.float32))


@register_flop_formula([torch.ops.repro_torch.slstm_scan,
                        torch.ops.repro_torch.slstm_scan_save])
def _flops(pre_shape, r_shape, out_dtype, *, out_shape=None,
           **kwargs) -> int:
    _, b, s, _ = pre_shape
    return slstm_work(b, s, r_shape[1], r_shape[2], 4, 4)[1]


@register_flop_formula(torch.ops.repro_torch.slstm_scan_bwd)
def _bwd_flops(first_shape, r_shape, *args, out_shape=None,
               **kwargs) -> int:
    _, b, s, _ = first_shape
    return slstm_bwd_work(b, s, r_shape[1], r_shape[2], 4)[1]


class SLSTMScan(torch.autograd.Function):
    """(pre, r) → (h, c, n, h_last, m) with its backward: on the card the
    forward kernel, saving each step's state and gates, and the backward
    kernel; on the CPU :func:`slstm_scan_ref` and
    :func:`slstm_scan_bwd_ref`.  Any output's cotangent may be absent."""

    @staticmethod
    def forward(ctx, pre, r, out_dtype):
        ctx.set_materialize_grads(False)
        if pre.device.type == "cpu":
            outs = torch.ops.repro_torch.slstm_scan(pre, r, out_dtype)
            ctx.save_for_backward(pre, r)
        else:
            *outs, saved = torch.ops.repro_torch.slstm_scan_save(
                pre, r, out_dtype)
            ctx.save_for_backward(saved, r)
        return tuple(outs)

    @staticmethod
    @once_differentiable
    def backward(ctx, h_cot, *state_cot):
        first, r = ctx.saved_tensors
        if h_cot is None and all(g is None for g in state_cot):
            return None, None, None
        dpre, dr = torch.ops.repro_torch.slstm_scan_bwd(first, r, h_cot,
                                                        *state_cot)
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
    hs, *state = torch.ops.repro_torch.slstm_scan(pre, r, out_dtype)
    return hs, tuple(state)
