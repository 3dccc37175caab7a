"""Model-layout SSD scan dispatch: the plain chunked version on the CPU,
the CUDA kernel on the card.  Same inputs and outputs as
``models.mamba2.ssd_chunked``."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssm_scan.kernel import ssd_scan_kernel
from repro_torch.kernels.ssm_scan.ref import ssd_chunked_ref, ssd_inputs


def ssd_chunked_kernel(x: torch.Tensor, dt: torch.Tensor,
                       a_log: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, d_skip: torch.Tensor,
                       chunk: int = 128
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,H,P]; dt [B,S,H]; b/c [B,S,N]; A_log/D [H] → (y [B,S,H,P]
    f32, final state [B,H,P,N] f32).  The wrapper adds ``D·x``.

    The kernel has no backward: on the card, with grad mode on and an
    input that needs a gradient, it raises rather than return a result
    cut off from autograd."""
    if x.device.type == "cpu":
        return ssd_chunked_ref(x, dt, a_log, b, c, d_skip, chunk)
    _build.refuse_grad("ssd_chunked_kernel", x, dt, a_log, b, c, d_skip)
    xdt, loga = ssd_inputs(x, dt, a_log)
    y, state = ssd_scan_kernel(xdt.contiguous(), loga.contiguous(),
                               b.float().contiguous(),
                               c.float().contiguous(), chunk)
    return y + d_skip.float()[None, None, :, None] * x.float(), state
