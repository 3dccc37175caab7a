"""Parameters of the JAX package's models as the port's parameters.

``params_from_jax(cfg, tree)`` takes the reference parameter tree with each
leaf as a numpy array (``np.asarray`` of the JAX array; bf16 leaves come
as numpy's ``bfloat16`` extension type) and returns the port's
:class:`~repro_torch.models.layers.ParamTree`:

  * dense: the stacked ``layers`` leaves ``[L, ...]`` become L per-layer
    entries;
  * hybrid: the ``mamba`` leaves ``[G, K, ...]`` become the L real layers
    (flat index ``g*K + k``); the padded slots are dropped.

Weights keep the reference's ``[in, out]`` layout, so nothing is
transposed.  This is how the tests feed equal weights to both packages.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.models.layers import ParamTree


def _tensor(a, device: torch.device) -> torch.Tensor:
    arr = np.array(a)                      # a writable, contiguous copy
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _take(tree, index, device):
    """``tree`` with every leaf indexed by ``index``, as tensors."""
    if isinstance(tree, dict):
        return {k: _take(v, index, device) for k, v in tree.items()}
    return _tensor(np.asarray(tree)[index], device)


def params_from_jax(cfg, tree: dict, device: DeviceLike = None) -> ParamTree:
    dev = resolve_device(device)
    out = {k: _take(v, (), dev) for k, v in tree.items()
           if k not in ("layers", "mamba")}
    if cfg.family == "dense":
        out["layers"] = [_take(tree["layers"], l, dev)
                         for l in range(cfg.num_layers)]
    elif cfg.family == "hybrid":
        k = cfg.shared_attn_every
        out["mamba"] = [_take(tree["mamba"], (l // k, l % k), dev)
                        for l in range(cfg.num_layers)]
    else:
        raise NotImplementedError(f"family {cfg.family!r} is not ported")
    return ParamTree(out)
