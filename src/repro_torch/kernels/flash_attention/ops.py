"""Flash-attention dispatch in the model layout: the plain version on the
CPU, the CUDA kernel on the card.

The call is a ``torch.library`` custom op, ``repro_torch::flash_attention``
(and ``flash_attention_lse``, which also returns the rows' log-sum-exp),
and the backward another, ``repro_torch::flash_attention_bwd``: their
fake implementations give meta and fake tensors the kernels' outputs (the
dry-run runs the model, and its training step, on meta tensors), and their
FLOP formulas, ``kernels.work.flash_work`` and ``flash_bwd_work``, let
``FlopCounterMode`` count the kernels, which ATen's counters cannot
see."""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_bwd_kernel, flash_attention_kernel)
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_ref)
from repro_torch.kernels.work import flash_bwd_work, flash_work


def _run(q, k, v, causal, window, scale, valid_len, return_lse):
    kw = dict(causal=causal, window=window, scale=scale,
              valid_len=valid_len, return_lse=return_lse)
    if q.device.type != "cpu":
        return flash_attention_kernel(q, k, v, **kw)
    got = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), **kw)
    if return_lse:
        return got[0].transpose(1, 2), got[1]
    return got.transpose(1, 2)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           window: int, scale: Optional[float], valid_len: int
           ) -> torch.Tensor:
    return _run(q, k, v, causal, window, scale, valid_len, False)


@torch.library.custom_op("repro_torch::flash_attention_lse",
                         mutates_args=())
def _flash_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool, window: int, scale: Optional[float],
               valid_len: int) -> tuple[torch.Tensor, torch.Tensor]:
    return _run(q, k, v, causal, window, scale, valid_len, True)


def _out(q, v):
    b, sq, hq, _ = q.shape
    return q.new_empty((b, sq, hq, v.shape[-1]))


@_flash.register_fake
def _(q, k, v, causal, window, scale, valid_len):
    return _out(q, v)


@_flash_lse.register_fake
def _(q, k, v, causal, window, scale, valid_len):
    b, sq, hq, _ = q.shape
    return _out(q, v), q.new_empty((b, hq, sq), dtype=torch.float32)


@register_flop_formula([torch.ops.repro_torch.flash_attention,
                        torch.ops.repro_torch.flash_attention_lse])
def _flops(q_shape, k_shape, v_shape, causal, window, scale, valid_len, *,
           out_shape=None, **kwargs) -> int:
    b, sq, hq, d = q_shape
    return flash_work(b, sq, hq, k_shape[2], d, 1, v_shape[-1],
                      sk=k_shape[1], causal=causal, window=window,
                      valid_len=valid_len)[1]


@torch.library.custom_op("repro_torch::flash_attention_bwd",
                         mutates_args=())
def _flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
               causal: bool, window: int, scale: Optional[float],
               valid_len: int
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    kw = dict(causal=causal, window=window, scale=scale,
              valid_len=valid_len)
    if q.device.type != "cpu":
        return flash_attention_bwd_kernel(q, k, v, out, lse, do, **kw)
    return attention_bwd_ref(q, k, v, out, lse, do, **kw)


@_flash_bwd.register_fake
def _(q, k, v, out, lse, do, causal, window, scale, valid_len):
    return tuple(torch.empty_like(t, memory_format=torch.contiguous_format)
                 for t in (q, k, v))


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _bwd_flops(q_shape, k_shape, v_shape, out_shape_, lse_shape, do_shape,
               causal, window, scale, valid_len, *, out_shape=None,
               **kwargs) -> int:
    b, sq, hq, d = q_shape
    return flash_bwd_work(b, sq, hq, k_shape[2], d, 1, v_shape[-1],
                          sk=k_shape[1], causal=causal, window=window,
                          valid_len=valid_len)[1]


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True,
                        window: int = 0, scale=None, valid_len: int = 0):
    """The backward of :func:`flash_attention` with ``return_lse``: (dq,
    dk, dv) in the shapes and dtypes of q, k and v from the saved q, k, v,
    ``out``, ``lse`` and the output's cotangent ``do``.  CPU tensors take
    :func:`~repro_torch.kernels.flash_attention.ref.attention_bwd_ref`,
    CUDA tensors the kernel (``flash_attention_bwd_kernel``), meta tensors
    the op's fake implementation."""
    return torch.ops.repro_torch.flash_attention_bwd(
        q, k, v, out, lse, do, causal, window,
        None if scale is None else float(scale), valid_len)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, scale=None,
                    valid_len: int = 0, return_lse: bool = False):
    """q/k [B,S,H,D] (k with Hkv heads), v [B,S,Hkv,Dv], Dv <= D →
    [B,S,Hq,Dv] in q's dtype; with ``return_lse`` also the rows'
    log-sum-exp, f32 [B,Hq,Sq] (keys at or past ``valid_len`` masked, 0
    meaning Sk).

    CPU tensors take :func:`attention_ref`; CUDA tensors the kernel, which
    reads this layout with strides, masks the ragged tail itself and takes
    v at its own head dim (MLA's 128 beside q/k's 192) as it is; meta
    tensors the ops' fake implementations."""
    op = (torch.ops.repro_torch.flash_attention_lse if return_lse
          else torch.ops.repro_torch.flash_attention)
    return op(q, k, v, causal, window,
              None if scale is None else float(scale), valid_len)
