"""repro_torch — the PyTorch + CUDA port of the ``repro`` package.

The slice ported so far is the paper's profile → predict → decide loop:

  * ``core.predictors.gbt``   — histogram GBT trained on per-layer times;
    its gradient histogram runs on the card through ``kernels.gbt_hist``;
  * ``oracle.lowered``        — the fitted GBT compiled to node arrays and
    walked by ``kernels.tree_predict``;
  * ``core.decisions`` / ``core.costs`` — the ``[n_envs, L+1]`` split sweep
    behind ``decide_all``, fused into ``kernels.decide_split``.

Every module mirrors the path and public names of its counterpart in
``repro`` and imports only ``torch``, ``numpy`` and the standard library.
Entry points take ``device=None``, which means CUDA; the CPU runs only when
the caller passes ``device="cpu"`` (see :func:`repro_torch._device.
resolve_device`).
"""
from repro_torch._device import resolve_device

__all__ = ["resolve_device"]
