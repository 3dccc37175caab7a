"""Differential privacy for federated profiling-model updates (paper
§II-B; the port of ``repro.core.fl.dp``).

Gaussian mechanism on client updates: clip the update's global L2 norm to
``clip_norm`` and add N(0, σ²) noise, σ = clip · √(2 ln(1.25/δ)) / ε per
round.  An update is a dict of tensors; its leaves are visited in sorted
key order (the order of the reference's pytree), so the noise comes from
the caller's ``np.random.Generator`` in the reference's order: the same
generator state gives the same noise.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DPConfig:
    epsilon: float = 8.0
    delta: float = 1e-5
    clip_norm: float = 1.0

    @property
    def sigma(self) -> float:
        return (self.clip_norm * math.sqrt(2.0 * math.log(1.25 / self.delta))
                / self.epsilon)


def _keys(tree: dict) -> list:
    return sorted(tree)


def global_norm(tree: dict) -> float:
    """The L2 norm of all leaves together, in f32."""
    return float(torch.sqrt(sum(tree[k].float().square().sum()
                                for k in _keys(tree))))


def clip_update(tree: dict, clip_norm: float) -> dict:
    """``tree`` scaled so that its global norm is at most ``clip_norm``."""
    scale = min(1.0, clip_norm / max(global_norm(tree), 1e-12))
    return {k: tree[k] * scale for k in _keys(tree)}


def privatise_update(tree: dict, cfg: DPConfig,
                     rng: np.random.Generator) -> dict:
    """Clip + Gaussian noise (applied client-side before aggregation);
    the noise is drawn on the host in f64, one leaf after another, and
    cast to the leaf's dtype on its device."""
    clipped = clip_update(tree, cfg.clip_norm)
    return {k: l + torch.as_tensor(
                rng.normal(0.0, cfg.sigma, size=tuple(l.shape)),
                dtype=l.dtype, device=l.device)
            for k, l in clipped.items()}
