"""The fused decision sweep behind ``decide_all(backend="kernel")``.

:func:`decide_accel` lowers the cost model (``costs.lower_to_accel``), packs
the factored inputs of the ``decide_split`` kernel, runs it (the CUDA
kernel on the card, its plain f32 twin on CPU tensors), and re-costs the
chosen splits exactly in f64 with O(E) gathers — the port of the
reference's ``_decide_pallas``.

Exactness notes:

  * the ``[L+1]`` prefix rows ``dcum``/``ecum`` are computed in f64 on the
    host with numpy's sequential ``cumsum`` and only then moved to the
    card (CUDA's ``cumsum`` order is unspecified);
  * the f64 re-evaluation is written as separate elementwise tensor ops —
    nothing that fuses a multiply and an add — so it replays the
    reference's host arithmetic;
  * predictor costs take their per-layer times from the lowered trees on
    the ``tree_predict`` kernel (exact in f64), so the whole path runs on
    kernels and only the argmin itself is f32.
"""
# repro: module-tags=fma-sensitive
# (DET001: a @ / dot / matmul here would FMA-contract the f64 re-costing)
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.costs import (AccelSpec, lower_to_accel,
                                    scalarize_weighted)
from repro_torch.core.decisions import DecisionPlan, EnvArrays
from repro_torch.core.offload import DEFAULT_EFFICIENCY, LayerCost
from repro_torch.kernels.decide_split.kernel import (decide_split_kernel,
                                                     pack_spec)
from repro_torch.kernels.decide_split.ref import decide_split_ref

F64 = torch.float64


def decide_split(dcum, ecum, bvec, dev_div, edge_div, bw, lat, inp, dev_w,
                 edge_w, spec):
    """``(split [E] int32, cost [E] f32)``: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors (same arguments as
    ``kernel.decide_split_kernel``)."""
    fn = decide_split_ref if dcum.device.type == "cpu" \
        else decide_split_kernel
    return fn(dcum, ecum, bvec, dev_div, edge_div, bw, lat, inp, dev_w,
              edge_w, spec)


def _on_offload(offload: torch.Tensor, value: float) -> torch.Tensor:
    """f64 ``value`` where the split offloads (``s != L``), 0 elsewhere."""
    return torch.zeros(offload.shape, dtype=F64,
                       device=offload.device).masked_fill(offload, value)


def _plan(cost, spec: AccelSpec, s, dev_s, xfer_s, edge_s, total_s,
          comp_s=None, scal_s=None) -> DecisionPlan:
    """Assemble the DecisionPlan mirroring ``decide_all(backend="torch")``
    for the same ``cost`` argument."""
    if cost is None:
        return DecisionPlan(s, total_s, dev_s, xfer_s, edge_s)
    if comp_s is None:                          # latency-only cost model
        comp_s, scal_s = total_s[:, None], total_s
    if "latency_s" in spec.objectives:
        total = comp_s[:, spec.objectives.index("latency_s")]
    else:                                       # scalar cost is not seconds
        total = torch.full((len(s),), float("nan"), dtype=F64,
                           device=s.device)
    return DecisionPlan(s, total, dev_s, xfer_s, edge_s,
                        objectives=spec.objectives, components=comp_s,
                        scalar_cost=scal_s)


@dataclasses.dataclass(frozen=True)
class PackedInputs:
    """The factored inputs of one decision sweep: ``kernel_args`` are the
    eleven f32 tensors the kernel takes, in order; the f64 rows and
    divisors are kept for the exact re-costing."""
    kernel_args: tuple
    dcum: torch.Tensor               # [L+1] f64
    ecum: torch.Tensor               # [L+1] f64
    bvec: torch.Tensor               # [L+1] f64
    dev_div: torch.Tensor            # [E] f64
    edge_div: torch.Tensor           # [E] f64
    dev_w: torch.Tensor              # [E] f64
    edge_w: torch.Tensor             # [E] f64
    etot: float


def pack_inputs(layers: Sequence[LayerCost], envs: EnvArrays,
                spec: AccelSpec) -> PackedInputs:
    """Factor a sweep of ``layers`` over ``envs`` under the lowered cost
    model ``spec`` into the kernel's inputs, on the envs' device."""
    dev = envs.device
    n_env, n = len(envs), len(layers)
    act = np.fromiter((lc.act_bytes for lc in layers), np.float64, count=n)
    bvec = np.concatenate(([0.0], act))
    bvec[-1] = 0.0                                       # split == L
    if spec.lowered is not None:
        # predictor mode: prefix sums of the lowered per-layer times (the
        # tree_predict kernel), unit divisors (the rows already are seconds)
        t_dev, t_edge = (t.cpu().numpy() for t in spec.lowered.times(
            layers, device=dev))
        dcum = np.concatenate(([0.0], np.cumsum(t_dev)))
        ecum = np.concatenate(([0.0], np.cumsum(t_edge)))
        dev_div = torch.ones(n_env, dtype=F64, device=dev)
        edge_div = dev_div
    else:
        flops = np.fromiter((lc.flops for lc in layers), np.float64,
                            count=n)
        fcum = np.concatenate(([0.0], np.cumsum(flops)))  # [L+1] f64
        dcum = ecum = fcum
        dev_div = envs.dev_flops * spec.efficiency
        edge_div = envs.edge_flops * spec.efficiency
    etot = float(ecum[-1])
    zeros = torch.zeros(n_env, dtype=F64, device=dev)
    dev_w = zeros if envs.dev_tdp_watts is None else envs.dev_tdp_watts
    edge_w = zeros if envs.edge_tdp_watts is None else envs.edge_tdp_watts
    spec_vec = pack_spec(spec.weights,
                         radio_watts=spec.radio_watts,
                         price_per_edge_s=spec.price_per_edge_s,
                         price_per_gb=spec.price_per_gb,
                         deadline_s=spec.deadline_s, edge_total=etot,
                         queue_wait_s=spec.queue_wait_s,
                         tail_excess_s=spec.tail_excess_s,
                         tail_weight=spec.tail_weight)
    dcum_t, ecum_t, bvec_t = (torch.as_tensor(r, dtype=F64, device=dev)
                              for r in (dcum, ecum, bvec))
    args = tuple(x.to(torch.float32).contiguous()
                 for x in (dcum_t, ecum_t, bvec_t, dev_div, edge_div,
                           envs.link_bw, envs.link_latency_s,
                           envs.input_bytes, dev_w, edge_w)) \
        + (torch.as_tensor(spec_vec, device=dev),)
    return PackedInputs(args, dcum_t, ecum_t, bvec_t, dev_div, edge_div,
                        dev_w, edge_w, etot)


def decide_accel(layers: Sequence[LayerCost], envs: EnvArrays,
                 efficiency: float = DEFAULT_EFFICIENCY, *,
                 cost=None) -> DecisionPlan:
    """``decide_all`` through the fused kernel, on the envs' device: the
    kernel's f32 argmin, then the chosen splits re-costed in f64.  Raises
    ``TypeError`` for cost models with no array lowering."""
    spec = lower_to_accel(cost, efficiency)
    dev = envs.device
    n = len(layers)
    if len(envs) == 0:                          # nothing to launch over
        empty = torch.zeros(0, dtype=F64, device=dev)
        return _plan(cost, spec, torch.zeros(0, dtype=torch.int64,
                                             device=dev),
                     empty, empty, empty, empty,
                     None if spec.objectives == ("latency_s",)
                     else torch.zeros((0, len(spec.objectives)), dtype=F64,
                                      device=dev),
                     empty)
    p = pack_inputs(layers, envs, spec)
    s, _ = decide_split(*p.kernel_args)
    s = s.to(torch.int64)
    bw, lat, inp = envs.link_bw, envs.link_latency_s, envs.input_bytes
    # exact f64 costs at the kernel-chosen splits: O(E) gathers, no [E, S]
    dev_s = p.dcum[s] / p.dev_div
    edge_s = (p.etot - p.ecum[s]) / p.edge_div
    offload = s != n
    ship = torch.where(offload, torch.where(s == 0, inp, p.bvec[s]), 0.0)
    xfer_s = torch.where(offload, lat + ship / torch.clamp_min(bw, 1.0),
                         0.0)
    total_s = dev_s + xfer_s + edge_s
    # queue wait bumps the latency objective (and the booked transfer)
    # on offloading splits — zero when no pool is attached
    bump = _on_offload(offload, spec.queue_wait_s) \
        if spec.queue_wait_s != 0.0 else None
    if cost is None or spec.objectives == ("latency_s",):
        if bump is not None:
            total_s = total_s + bump
            xfer_s = xfer_s + bump
            return _plan(cost, spec, s, dev_s, xfer_s, edge_s, total_s,
                         total_s[:, None], total_s)
        return _plan(cost, spec, s, dev_s, xfer_s, edge_s, total_s)
    energy = dev_s * p.dev_w + xfer_s * spec.radio_watts \
        + edge_s * p.edge_w
    price = edge_s * spec.price_per_edge_s \
        + ship / 1e9 * spec.price_per_gb
    slack = torch.clamp_min(total_s - spec.deadline_s, 0.0)
    cols = [total_s, energy, price, slack]
    weights = list(spec.weights)
    if len(spec.objectives) > 4:         # tail_latency_s objective
        cols.append(total_s + _on_offload(offload, spec.tail_excess_s))
        weights.append(spec.tail_weight)
    if bump is not None:
        cols[0] = total_s + bump
        xfer_s = xfer_s + bump
        total_s = cols[0]
    comp_s = torch.stack(cols, dim=-1)
    scal_s = scalarize_weighted(comp_s, spec.objectives,
                                dict(zip(spec.objectives, weights)))
    return _plan(cost, spec, s, dev_s, xfer_s, edge_s, total_s,
                 comp_s, scal_s)
