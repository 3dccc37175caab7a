"""Plain PyTorch references for the decision kernel.

:func:`decide_split_ref` is the plain f32 twin of the CUDA kernel: the same
factored inputs and arithmetic, but over the materialised ``[E, L+1]``
tensors with one torch op per step and a row argmin.  The f64 oracles
:func:`latency_matrix_ref` and :func:`decide_ref` delegate to the exact
``backend="torch"`` path of :mod:`repro_torch.core.decisions`.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import decisions as dec
from repro_torch.core.offload import DEFAULT_EFFICIENCY, LayerCost
from repro_torch.kernels.decide_split.kernel import (
    SPEC_DEADLINE, SPEC_ETOT, SPEC_PPG, SPEC_PPS, SPEC_RADIO, SPEC_TEXC,
    SPEC_W0, SPEC_W1, SPEC_W2, SPEC_W3, SPEC_W4, SPEC_WAIT)


def decide_split_ref(dcum, ecum, bvec, dev_div, edge_div, bw, lat, inp,
                     dev_w, edge_w, spec):
    """Same contract as ``kernel.decide_split_kernel`` (f32 in, ``(split
    [E] int32, cost [E] f32)`` out) on any device."""
    n_splits = dcum.shape[0]
    cols = torch.arange(n_splits, device=dcum.device)
    is_last = cols == n_splits - 1                       # split == L
    dev_t = dcum[None, :] / dev_div[:, None]
    edge_t = (spec[SPEC_ETOT] - ecum)[None, :] / edge_div[:, None]
    ship = torch.where(is_last, 0.0,
                       torch.where(cols == 0, inp[:, None], bvec[None, :]))
    xfer = torch.where(is_last, 0.0,
                       lat[:, None] + ship / torch.clamp_min(bw, 1.0)[:, None])
    total = dev_t + xfer + edge_t
    energy = dev_t * dev_w[:, None] + xfer * spec[SPEC_RADIO] \
        + edge_t * edge_w[:, None]
    price = edge_t * spec[SPEC_PPS] + ship / 1e9 * spec[SPEC_PPG]
    slack = torch.clamp_min(total - spec[SPEC_DEADLINE], 0.0)
    lat_col = total + torch.where(is_last, 0.0, spec[SPEC_WAIT])
    scal = spec[SPEC_W0] * lat_col + spec[SPEC_W1] * energy \
        + spec[SPEC_W2] * price + spec[SPEC_W3] * slack
    scal = scal + spec[SPEC_W4] * (
        total + torch.where(is_last, 0.0, spec[SPEC_TEXC]))
    split = torch.argmin(scal, dim=1)                    # first index of min
    cost = scal.gather(1, split[:, None])[:, 0]
    return split.to(torch.int32), cost


def latency_matrix_ref(layers: Sequence[LayerCost], envs: dec.EnvArrays,
                       efficiency: float = DEFAULT_EFFICIENCY
                       ) -> torch.Tensor:
    """``[E, L+1]`` f64 total-latency matrix on the envs' device."""
    return dec.latency_matrix(layers, envs, efficiency)


def decide_ref(layers: Sequence[LayerCost], envs: dec.EnvArrays,
               efficiency: float = DEFAULT_EFFICIENCY, *,
               cost=None) -> dec.DecisionPlan:
    """The exact f64 ``decide_all`` on the envs' device — the semantics the
    kernel path must reproduce within f32 tolerance."""
    return dec.decide_all(layers, envs, efficiency, cost=cost,
                          backend="torch", device=envs.device)
