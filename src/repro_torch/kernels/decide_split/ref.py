"""Plain PyTorch references for the decision kernel.

:func:`decide_split_ref` is the plain f32 twin of the CUDA kernel: the same
factored inputs, each objective formed and weighed as the reference kernel
forms it, over the materialised ``[E, L+1]`` tensors with one torch op per
step and a row argmin.  :func:`decide_split_factored_ref` is the kernel's
own regrouped arithmetic (reciprocals and per-environment coefficients, no
division per split) in the same form, so that the CPU checks the algebra.  The f64 oracles
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


def _first_argmin(scal: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(split [E] int32, cost [E])``: each row's first least cost."""
    split = torch.argmin(scal, dim=1)                    # first index of min
    return split.to(torch.int32), scal.gather(1, split[:, None])[:, 0]


def decide_split_ref(dcum, ecum, bvec, dev_div, edge_div, bw, lat, inp,
                     dev_w, edge_w, spec):
    """Same contract as ``kernel.decide_split_kernel`` (f32 in, ``(split
    [E] int32, cost [E] f32)`` out) on any device."""
    return _first_argmin(cost_matrix_ref(dcum, ecum, bvec, dev_div, edge_div,
                                         bw, lat, inp, dev_w, edge_w, spec))


def cost_matrix_ref(dcum, ecum, bvec, dev_div, edge_div, bw, lat, inp,
                    dev_w, edge_w, spec) -> torch.Tensor:
    """The ``[E, L+1]`` scalar costs :func:`decide_split_ref` takes its
    argmin of, in the inputs' dtype (f64 inputs give the f64 costs)."""
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
    return scal + spec[SPEC_W4] * (
        total + torch.where(is_last, 0.0, spec[SPEC_TEXC]))


def decide_split_factored_ref(dcum, ecum, bvec, dev_div, edge_div, bw, lat,
                              inp, dev_w, edge_w, spec):
    """The kernel's regrouped f32 arithmetic (``csrc/decide_split.cu``)
    over ``[E, L+1]``: the same contract as :func:`decide_split_ref`, whose
    costs it matches within f32 rounding for non-negative weights.  (The
    kernel contracts products and sums into FMAs; here each rounds.)"""
    n_splits = dcum.shape[0]
    cols = torch.arange(n_splits, device=dcum.device)
    off = (cols != n_splits - 1)[None, :]                # s != L
    rdd, red = 1.0 / dev_div[:, None], 1.0 / edge_div[:, None]
    rbw = 1.0 / torch.clamp_min(bw, 1.0)[:, None]
    wl = spec[SPEC_W0] + spec[SPEC_W4]
    c_dev = wl + spec[SPEC_W1] * dev_w[:, None]
    c_edge = wl + spec[SPEC_W1] * edge_w[:, None] \
        + spec[SPEC_W2] * spec[SPEC_PPS]
    c_xfer = wl + spec[SPEC_W1] * spec[SPEC_RADIO]
    c_ship = spec[SPEC_W2] * spec[SPEC_PPG] * 1e-9
    k = spec[SPEC_W0] * spec[SPEC_WAIT] + spec[SPEC_W4] * spec[SPEC_TEXC]
    d, eh = dcum[None, :], (spec[SPEC_ETOT] - ecum)[None, :]
    ship = torch.where(off, torch.where(cols == 0, inp[:, None],
                                        bvec[None, :]), 0.0)
    if spec[SPEC_W3] == 0:                               # three FMAs a split
        a, b = rdd * c_dev, red * c_edge
        c, k0 = rbw * c_xfer + c_ship, lat[:, None] * c_xfer + k
        scal = torch.where(off, d * a + (eh * b + (ship * c + k0)),
                           d * a + eh * b)
    else:
        # the slack cancels against total: the plain version's divisions
        dev_t, edge_t = d / dev_div[:, None], eh / edge_div[:, None]
        xfer = torch.where(off, lat[:, None]
                           + ship / torch.clamp_min(bw, 1.0)[:, None], 0.0)
        total = dev_t + xfer + edge_t
        moved = torch.where(off, xfer * c_xfer + (ship * c_ship + k), 0.0)
        scal = spec[SPEC_W3] * torch.clamp_min(total - spec[SPEC_DEADLINE],
                                               0.0) \
            + (dev_t * c_dev + (edge_t * c_edge + moved))
    return _first_argmin(scal)


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
