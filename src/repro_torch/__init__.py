"""repro_torch — the PyTorch + CUDA port of the ``repro`` package.

Three slices are ported.  The paper's profile → predict → decide loop:

  * ``core.predictors.gbt``   — histogram GBT trained on per-layer times;
    its gradient histogram runs on the card through ``kernels.gbt_hist``;
  * ``oracle.lowered``        — the fitted GBT compiled to node arrays and
    walked by ``kernels.tree_predict``;
  * ``core.decisions`` / ``core.costs`` — the ``[n_envs, L+1]`` split sweep
    behind ``decide_all``, fused into ``kernels.decide_split``.

And serving the dense and hybrid models of the zoo:

  * ``serve.engine.ServeEngine`` / ``launch.serve`` — static-batch
    prefill + decode over ``models.build_model``;
  * ``models.attention`` — prefill attention through
    ``kernels.flash_attention``;
  * ``models.mamba2`` / ``models.hybrid`` — Mamba2 prefill through
    ``kernels.ssm_scan``, the Zamba2 shared-attention hybrid.

And the kernel micro-bench, ``bench.kernels`` (``python -m
repro_torch.bench.kernels``): each kernel beside its plain version, the
library call and its bound, including ``kernels.int8_matmul`` (W8A16),
which no other path runs.

Every module mirrors the path and public names of its counterpart in
``repro`` and imports only ``torch``, ``numpy`` and the standard library.
Entry points take ``device=None``, which means CUDA; the CPU runs only when
the caller passes ``device="cpu"`` (see :func:`repro_torch._device.
resolve_device`).
"""
from repro_torch._device import resolve_device

__all__ = ["resolve_device"]
