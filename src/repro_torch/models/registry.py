"""Uniform model API over the model families: ``dense``, ``moe``, ``vlm``,
``hybrid``, ``ssm`` (xLSTM) and ``audio`` (whisper's encoder-decoder).

``build_model(cfg)`` returns a :class:`ModelAPI` whose callables are
functions of (params, batch[, cache]) on the params' device.
``init_params(seed, device, trainable=True)`` gives parameters that need
gradients, for training; serving keeps them frozen (the default).
``train_loss`` covers every family.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

from repro_torch.models import encdec, hybrid, transformer, xlstm_model


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: Any
    # (seed, device=None, trainable=False) -> params
    init_params: Callable[..., Any]
    train_loss: Callable[[Any, dict], tuple]  # -> (loss, metrics)
    forward: Callable[[Any, dict], Any]
    prefill: Callable[[Any, dict, int], tuple]
    decode_step: Callable[[Any, dict, dict], tuple]
    init_cache: Callable[..., dict]          # (batch, max_len, device=None)
    cache_shapes: Callable[[int, int], dict]
    param_shapes: Callable[[], dict]


def build_model(cfg, *, impl: str = "chunked") -> ModelAPI:
    """``impl="chunked"`` runs prefill through the port's kernels on the
    card (flash attention, the SSD scan, the sLSTM recurrence); ``"naive"``
    is the plain oracle path (full score matrix, plain chunked scan, the
    sLSTM's plain step loop).  An audio model's ``forward`` and
    ``prefill`` take ``{"frames", "tokens"}``."""
    if impl not in ("chunked", "naive"):
        raise ValueError(f"unknown impl {impl!r}; expected 'chunked' or "
                         "'naive'")
    mod = {"dense": transformer, "moe": transformer, "vlm": transformer,
           "hybrid": hybrid, "ssm": xlstm_model,
           "audio": encdec}.get(cfg.family)
    if mod is None:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
    def train_loss(p, b):
        return mod.train_loss(p, b, cfg, impl=impl)

    def init_params(seed=0, device=None, trainable=False):
        return mod.init_params(cfg, seed, device).requires_grad_(trainable)

    return ModelAPI(
        cfg=cfg,
        init_params=init_params,
        train_loss=train_loss,
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
