"""W8A16 matmul dispatch: the plain version on the CPU, the CUDA kernel on
the card."""
from __future__ import annotations

import torch

from repro_torch.kernels.int8_matmul.kernel import int8_matmul_kernel
from repro_torch.kernels.int8_matmul.ref import int8_matmul_ref


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor
                ) -> torch.Tensor:
    """x [..., K] × w_q [K, N] int8 (+ scale [N]) → [..., N] in x's dtype.

    CPU tensors take :func:`int8_matmul_ref`; CUDA tensors the kernel,
    which masks ragged edges itself, so neither operand is padded (a
    padded copy of an LM-head weight would cost more than the product).
    The leading dimensions are flattened; a non-contiguous x is copied."""
    lead, n = x.shape[:-1], w_q.shape[1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cpu":
        out = int8_matmul_ref(x2, w_q, scale)
    else:
        out = int8_matmul_kernel(x2.contiguous(), w_q, scale)
    return out.reshape(*lead, n)
