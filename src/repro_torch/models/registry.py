"""Uniform model API over the ported families (``dense`` and ``hybrid``).

``build_model(cfg)`` returns a :class:`ModelAPI` whose callables are
functions of (params, batch[, cache]) on the params' device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

from repro_torch.models import hybrid, transformer


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: Any
    init_params: Callable[..., Any]          # (seed, device=None) -> params
    forward: Callable[[Any, dict], Any]
    prefill: Callable[[Any, dict, int], tuple]
    decode_step: Callable[[Any, dict, dict], tuple]
    init_cache: Callable[..., dict]          # (batch, max_len, device=None)
    cache_shapes: Callable[[int, int], dict]
    param_shapes: Callable[[], dict]


def build_model(cfg, *, impl: str = "chunked") -> ModelAPI:
    """``impl="chunked"`` runs prefill through the port's kernels on the
    card (flash attention, the SSD scan); ``"naive"`` is the plain oracle
    path (full score matrix, plain chunked scan)."""
    if impl not in ("chunked", "naive"):
        raise ValueError(f"unknown impl {impl!r}; expected 'chunked' or "
                         "'naive'")
    if cfg.family == "dense":
        transformer.layer_shapes(cfg)        # raises for MoE / MLA / VLM
        mod = transformer
    elif cfg.family == "hybrid":
        mod = hybrid
    else:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (the port "
            "serves the dense and hybrid families); ROADMAP.md §1 item 8 "
            "ports the rest of the model zoo")
    return ModelAPI(
        cfg=cfg,
        init_params=lambda seed=0, device=None: mod.init_params(cfg, seed,
                                                                device),
        forward=lambda p, b: mod.forward(p, b, cfg, impl=impl),
        prefill=lambda p, b, m: mod.prefill(p, b, cfg, m, impl=impl),
        decode_step=lambda p, b, c: mod.decode_step(p, b, c, cfg),
        init_cache=lambda bs, m, device=None: mod.init_cache(cfg, bs, m,
                                                             device),
        cache_shapes=lambda bs, m: mod.cache_shapes(cfg, bs, m),
        param_shapes=lambda: mod.param_shapes(cfg),
    )


def param_count(shapes) -> int:
    """Number of scalars in a nested dict/list of shape tuples."""
    if isinstance(shapes, dict):
        return sum(param_count(v) for v in shapes.values())
    if isinstance(shapes, list):
        return sum(param_count(v) for v in shapes)
    return math.prod(shapes)
