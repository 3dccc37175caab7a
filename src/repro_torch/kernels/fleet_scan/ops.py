"""Singleton placement scan dispatch: the plain version on the CPU, the
CUDA kernel on the card."""
from __future__ import annotations

import torch

from repro_torch.kernels.fleet_scan.kernel import place_singletons_kernel
from repro_torch.kernels.fleet_scan.ref import place_singletons_ref


def place_singletons(avail: torch.Tensor, peak_eff: torch.Tensor,
                     bwc_rows: torch.Tensor, ts: torch.Tensor,
                     fls: torch.Tensor, ibs: torch.Tensor, segs: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """Place ``n`` single-task arrival batches one after another on the
    tensors' device, updating ``avail`` in place → (j, start, finish, etc),
    each ``[n]``.  CPU tensors take the plain version, CUDA tensors the
    kernel; both equal the reference's host loop bit for bit."""
    if avail.device.type == "cpu":
        return place_singletons_ref(avail, peak_eff, bwc_rows, ts, fls, ibs,
                                    segs)
    return place_singletons_kernel(
        avail, peak_eff.to(torch.float64).contiguous(),
        bwc_rows.to(torch.float64).contiguous(),
        *(t.to(torch.float64).contiguous() for t in (ts, fls, ibs)),
        segs.to(torch.int64).contiguous())
