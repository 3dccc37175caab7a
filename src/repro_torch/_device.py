"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import contextlib
from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda``; any other value is taken as given.

    Asking for CUDA (explicitly or by default) on a machine without a card
    raises: the port never falls back to the CPU on its own.  The CPU runs
    only when the caller passes ``device="cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested (device=None means cuda) but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path on the CPU")
    return dev


def as_tensor(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``x`` (numpy array, tensor or scalar sequence) as a ``dtype`` tensor
    on ``device``; no copy when it already is one."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


@contextlib.contextmanager
def true_f32():
    """TF32 off for matmuls and cuDNN convolutions inside the block; each
    flag that was on is switched back on at the end (only the legacy
    ``allow_tf32`` flags are touched, so a flag that was off keeps its
    setting untouched)."""
    flags = [f for f in (torch.backends.cuda.matmul, torch.backends.cudnn)
             if f.allow_tf32]
    for f in flags:
        f.allow_tf32 = False
    try:
        yield
    finally:
        for f in flags:
            f.allow_tf32 = True
