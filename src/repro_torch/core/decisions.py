"""Batched, array-native offloading decisions (the vectorized decision core).

Given *vectors* of link bandwidths, device specs and edge specs — thousands
of concurrent users, each in a different radio condition — this module
computes the ``[n_envs, L+1]`` cost of every split and argmins every row.
It is the PyTorch twin of ``repro.core.decisions``: every array is a tensor
on one device, and an :class:`EnvArrays` lives wholly on that device.

*What* is minimised is pluggable through ``cost=`` (a
:mod:`repro_torch.core.costs` model).  *Where* the sweep runs is
``backend=``:

  * ``"kernel"`` (default) — the fused ``decide_split`` kernel
    (:mod:`repro_torch.kernels.decide_split`): f32 on the card, never
    storing the ``[E, L+1]`` cost tensor, then the chosen splits re-costed
    exactly in f64 with O(E) gathers.  On CPU tensors the kernel's plain
    f32 twin runs in its place.
  * ``"torch"`` — the exact f64 matrix path, op for op the numpy host path
    of the reference, so its plans equal the reference's bit for bit.

Usage::

    from repro_torch.core import costs as co, decisions as dec
    from repro_torch.hw import get_device

    envs = dec.make_envs(get_device("pi5-arm"),
                         get_device("edge-server-a100"),
                         link_bw=np.geomspace(1e5, 1e10, 4096),
                         input_bytes=4 * 32 * 784)       # on cuda
    plan = dec.decide_all(layers, envs)                  # fused kernel
    plan = dec.decide_all(layers, envs, backend="torch") # exact f64
    plan.splits, plan.total_time_s                       # [4096] tensors

Bit-for-bit notes: prefix sums run as a sequential column loop
(:func:`seq_cumsum`) — numpy's exact accumulation order on any device —
and every multiply and add is its own eager tensor op, so nothing fuses
into an FMA.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.offload import (DEFAULT_EFFICIENCY as EFFICIENCY,
                                      LayerCost, OffloadEnv, SplitDecision)
from repro_torch.hw import DeviceSpec

F64 = torch.float64


@dataclasses.dataclass(frozen=True)
class EnvArrays:
    """Struct-of-arrays form of ``n_envs`` :class:`OffloadEnv` instances:
    ``[E]`` f64 tensors, all on one device."""
    dev_flops: torch.Tensor          # [E] effective f32 peak of the device
    edge_flops: torch.Tensor         # [E] effective f32 peak of the edge
    link_bw: torch.Tensor            # [E] bytes/s
    link_latency_s: torch.Tensor     # [E]
    input_bytes: torch.Tensor        # [E]
    # board power, for the energy objective (None when built by hand from
    # raw arrays; make_envs always fills them from the specs)
    dev_tdp_watts: Optional[torch.Tensor] = None    # [E]
    edge_tdp_watts: Optional[torch.Tensor] = None   # [E]

    def __len__(self) -> int:
        return self.dev_flops.shape[0]

    @property
    def device(self) -> torch.device:
        return self.dev_flops.device

    def to(self, device: torch.device) -> "EnvArrays":
        """The same environments on ``device`` (``self`` when already
        there, so identity-keyed cost-model memos keep hitting)."""
        if self.device == device:
            return self
        return EnvArrays(*(None if a is None else a.to(device)
                           for a in self.columns()))

    def columns(self) -> tuple:
        """The seven fields in declaration order (``None`` kept)."""
        return tuple(getattr(self, f.name)
                     for f in dataclasses.fields(self))


def _spec_attr(spec, attr: str) -> Union[float, np.ndarray]:
    if isinstance(spec, DeviceSpec):
        return getattr(spec, attr)
    return np.asarray([getattr(s, attr) for s in spec], np.float64)


def make_envs(dev_spec, edge_spec, link_bw, link_latency_s=0.005,
              input_bytes=0.0, *, device: DeviceLike = None) -> EnvArrays:
    """Broadcast scalars/vectors of specs and link states into an
    :class:`EnvArrays` on ``device``.  ``dev_spec``/``edge_spec`` may be a
    single :class:`DeviceSpec` or a sequence of them."""
    dev = resolve_device(device)
    arrs = np.broadcast_arrays(
        np.atleast_1d(np.asarray(_spec_attr(dev_spec, "peak_flops_f32"),
                                 np.float64)),
        np.atleast_1d(np.asarray(_spec_attr(edge_spec, "peak_flops_f32"),
                                 np.float64)),
        np.atleast_1d(np.asarray(link_bw, np.float64)),
        np.atleast_1d(np.asarray(link_latency_s, np.float64)),
        np.atleast_1d(np.asarray(input_bytes, np.float64)),
        np.atleast_1d(np.asarray(_spec_attr(dev_spec, "tdp_watts"),
                                 np.float64)),
        np.atleast_1d(np.asarray(_spec_attr(edge_spec, "tdp_watts"),
                                 np.float64)))
    return EnvArrays(*(torch.tensor(np.ascontiguousarray(a), dtype=F64,
                                    device=dev) for a in arrs))


def stack_envs(envs: Sequence[OffloadEnv], *,
               device: DeviceLike = None) -> EnvArrays:
    """Struct-of-arrays from a list of scalar :class:`OffloadEnv`, on
    ``device`` (None = cuda)."""
    dev = resolve_device(device)
    cols = (
        [e.device.peak_flops_f32 for e in envs],
        [e.edge.peak_flops_f32 for e in envs],
        [e.link_bw for e in envs],
        [e.link_latency_s for e in envs],
        [e.input_bytes for e in envs],
        [e.device.tdp_watts for e in envs],
        [e.edge.tdp_watts for e in envs])
    return EnvArrays(*(torch.tensor(np.asarray(c, np.float64), dtype=F64,
                                    device=dev) for c in cols))


def _layer_vector(layers: Sequence[LayerCost], attr: str,
                 device: torch.device) -> torch.Tensor:
    """``[L]`` f64 tensor of one :class:`LayerCost` field."""
    return torch.tensor([float(getattr(lc, attr)) for lc in layers],
                        dtype=F64, device=device)


def seq_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Row-wise cumulative sum of ``[R, C]`` accumulated column by column:
    ``np.cumsum``'s exact float order on every device (CUDA's ``cumsum``
    order is unspecified)."""
    out = torch.empty_like(x)
    if x.shape[1]:
        out[:, 0] = x[:, 0]
    for k in range(1, x.shape[1]):
        out[:, k] = out[:, k - 1] + x[:, k]
    return out


def transfer_bytes(layers: Sequence[LayerCost], envs: EnvArrays
                   ) -> torch.Tensor:
    """Bytes crossing the link per split, ``[E, L+1]`` (0 at split == L):
    the raw input at split 0, the split layer's activation otherwise."""
    n = len(envs)
    act = _layer_vector(layers, "act_bytes", envs.device)
    out = torch.cat([envs.input_bytes[:, None],
                     act[None, :].expand(n, len(layers))], dim=1)
    out[:, -1] = 0.0                 # split == L ships nothing
    return out


def transfer_matrix(layers: Sequence[LayerCost], envs: EnvArrays
                    ) -> torch.Tensor:
    """Transfer latency per split, ``[E, L+1]``: link latency plus shipped
    bytes over bandwidth (0 at split == L)."""
    xfer = envs.link_latency_s[:, None] + transfer_bytes(layers, envs) \
        / torch.clamp_min(envs.link_bw, 1.0)[:, None]
    xfer[:, -1] = 0.0                # split == L ships nothing
    return xfer


def latency_components(layers: Sequence[LayerCost], envs: EnvArrays,
                       efficiency: float = EFFICIENCY
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(device, transfer, edge)`` latency matrices, each ``[E, L+1]``.

    Column ``s`` of each matrix is the corresponding component of running
    layers ``[0, s)`` on-device and the rest on-edge.
    """
    n = len(envs)
    flops = _layer_vector(layers, "flops", envs.device)
    t_dev = flops[None, :] / (envs.dev_flops[:, None] * efficiency)
    t_edge = flops[None, :] / (envs.edge_flops[:, None] * efficiency)
    zero = torch.zeros((n, 1), dtype=F64, device=envs.device)
    dev_cum = torch.cat([zero, seq_cumsum(t_dev)], dim=1)
    edge_cum = torch.cat([seq_cumsum(t_edge.flip(1)).flip(1), zero], dim=1)
    return dev_cum, transfer_matrix(layers, envs), edge_cum


def latency_matrix(layers: Sequence[LayerCost], envs: EnvArrays,
                   efficiency: float = EFFICIENCY) -> torch.Tensor:
    """Total latency of every (environment, split) pair: ``[E, L+1]``."""
    dev_cum, xfer, edge_cum = latency_components(layers, envs, efficiency)
    return dev_cum + xfer + edge_cum


@dataclasses.dataclass(frozen=True)
class DecisionPlan:
    """Per-environment optimal decisions, struct-of-arrays (all ``[E]``
    tensors on the sweep's device).

    With a multi-objective cost model, ``objectives``/``components`` carry
    the named per-objective cost at each chosen split and ``scalar_cost``
    the scalarised value the argmin ranked by; latency-only plans leave
    them at their defaults.
    """
    splits: torch.Tensor
    total_time_s: torch.Tensor
    device_time_s: torch.Tensor
    transfer_time_s: torch.Tensor
    edge_time_s: torch.Tensor
    objectives: tuple[str, ...] = ("latency_s",)
    components: Optional[torch.Tensor] = None     # [E, n_objectives]
    scalar_cost: Optional[torch.Tensor] = None    # [E]

    def __len__(self) -> int:
        return self.splits.shape[0]

    def __getitem__(self, i: int) -> SplitDecision:
        return SplitDecision(int(self.splits[i]),
                             float(self.total_time_s[i]),
                             float(self.device_time_s[i]),
                             float(self.transfer_time_s[i]),
                             float(self.edge_time_s[i]))

    def objective(self, name: str) -> torch.Tensor:
        """``[E]`` cost of the named objective at each chosen split."""
        if self.components is None:
            if name == "latency_s":
                return self.total_time_s
            raise KeyError(f"plan carries no components for {name!r}")
        return self.components[:, self.objectives.index(name)]


# the pre-CostModel name, kept for existing callers
BatchDecisions = DecisionPlan


def decide_all(layers: Sequence[LayerCost], envs: EnvArrays,
               efficiency: float = EFFICIENCY, *,
               cost=None, backend: str = "kernel",
               device: DeviceLike = None) -> DecisionPlan:
    """Optimal split per environment: one argmin over the cost matrix.

    ``cost`` is a :mod:`repro_torch.core.costs` model; ``None`` is the
    analytic latency-only default at ``efficiency`` (combining ``cost=``
    with a non-default ``efficiency`` is rejected rather than silently
    ignoring one).  ``envs`` are moved to ``device`` (``None`` = cuda).

    ``backend="kernel"`` runs the fused ``decide_split`` kernel (f32 argmin,
    f64 re-costing of the chosen splits); ``backend="torch"`` is the exact
    f64 matrix path, bit for bit with the reference host path.
    """
    if cost is not None and efficiency != EFFICIENCY:
        raise ValueError(
            "efficiency= is ignored when cost= is given; set it on the "
            "cost model instead (e.g. AnalyticCost(efficiency=...))")
    envs = envs.to(resolve_device(device))
    if backend == "kernel":
        from repro_torch.kernels.decide_split import ops
        return ops.decide_accel(layers, envs, efficiency, cost=cost)
    if backend != "torch":
        raise ValueError(f"unknown backend {backend!r}; expected 'kernel' "
                         "or 'torch'")
    rows = torch.arange(len(envs), device=envs.device)
    if cost is None:
        dev_cum, xfer, edge_cum = latency_components(layers, envs,
                                                     efficiency)
        total = dev_cum + xfer + edge_cum
        s = torch.argmin(total, dim=1)
        return DecisionPlan(s, total[rows, s], dev_cum[rows, s],
                            xfer[rows, s], edge_cum[rows, s])
    comp = cost.components(layers, envs)
    scalar = cost.scalarize(comp)
    s = torch.argmin(scalar, dim=1)
    objectives = tuple(cost.objectives)
    comp_s = comp[rows, s]
    if "latency_s" in objectives:
        total = comp_s[:, objectives.index("latency_s")]
    else:
        # no latency objective -> the scalarised weighted cost is in
        # arbitrary units, not seconds; total_time_s must not lie
        # (scalar_cost below still carries the value the argmin ranked by)
        total = torch.full((len(rows),), float("nan"), dtype=F64,
                           device=envs.device)
    parts_fn = getattr(cost, "latency_parts", None)
    if parts_fn is not None:
        dev_cum, xfer, edge_cum = parts_fn(layers, envs)
        dev_t, xfer_t, edge_t = (dev_cum[rows, s], xfer[rows, s],
                                 edge_cum[rows, s])
    else:                            # no latency decomposition available
        dev_t = xfer_t = edge_t = torch.full(
            (len(rows),), float("nan"), dtype=F64, device=envs.device)
    return DecisionPlan(s, total, dev_t, xfer_t, edge_t,
                        objectives=objectives, components=comp_s,
                        scalar_cost=scalar[rows, s])


def take_envs(envs: EnvArrays, idx) -> EnvArrays:
    """Row-subset of an :class:`EnvArrays` (``idx`` is an integer index
    array or boolean mask over the environment axis)."""
    idx = torch.as_tensor(idx, device=envs.device)
    return EnvArrays(*(None if a is None else a[idx]
                       for a in envs.columns()))


def pad_envs(envs: EnvArrays, multiple: int) -> tuple[EnvArrays, int]:
    """Pad the environment axis up to a multiple of ``multiple`` by
    repeating the last row (padded rows compute real but discarded
    decisions).  Returns ``(padded, original_length)``; the caller trims
    results back with ``[:original_length]``."""
    if multiple <= 0:
        raise ValueError(f"multiple must be positive, got {multiple}")
    e = len(envs)
    pad = (-e) % multiple
    if pad == 0:
        return envs, e
    if e == 0:
        raise ValueError("cannot pad an empty EnvArrays (no row to "
                         "repeat)")
    idx = np.concatenate([np.arange(e), np.full(pad, e - 1, np.int64)])
    return take_envs(envs, idx), e


def replan(layers: Sequence[LayerCost], envs: EnvArrays,
           prev: DecisionPlan, changed, *,
           efficiency: float = EFFICIENCY, cost=None,
           backend: str = "kernel", device: DeviceLike = None
           ) -> DecisionPlan:
    """Incremental :func:`decide_all`: re-decide only the ``changed``
    environments and splice the fresh rows into ``prev``.

    ``changed`` is an integer index array or boolean mask over the
    environment axis.  Rows outside ``changed`` are carried over
    untouched, so the result is what a full ``decide_all`` over the
    updated ``envs`` would return, at the cost of the changed rows only.
    """
    envs = envs.to(resolve_device(device))
    idx = torch.as_tensor(changed, device=envs.device)
    if idx.dtype == torch.bool:
        if tuple(idx.shape) != (len(envs),):
            raise ValueError(
                f"boolean changed mask must be [{len(envs)}], "
                f"got {tuple(idx.shape)}")
        idx = torch.nonzero(idx).flatten()
    if len(prev) != len(envs):
        raise ValueError(
            f"prev plan covers {len(prev)} envs, got {len(envs)}")
    if idx.numel() == 0:
        return prev
    sub = decide_all(layers, take_envs(envs, idx), efficiency,
                     cost=cost, backend=backend, device=envs.device)
    if sub.objectives != prev.objectives:
        raise ValueError(
            f"cost model changed between plans: prev objectives "
            f"{prev.objectives}, new {sub.objectives} — replan only "
            "splices rows of the same objective stack")

    def scatter(old, new):
        if old is None or new is None:
            if (old is None) != (new is None):
                raise ValueError(
                    "prev and updated plans disagree on carrying "
                    "components/scalar_cost — same cost= required")
            return None
        out = old.to(envs.device).clone()
        out[idx] = new.to(out.dtype)
        return out

    return DecisionPlan(scatter(prev.splits, sub.splits),
                        scatter(prev.total_time_s, sub.total_time_s),
                        scatter(prev.device_time_s, sub.device_time_s),
                        scatter(prev.transfer_time_s, sub.transfer_time_s),
                        scatter(prev.edge_time_s, sub.edge_time_s),
                        objectives=prev.objectives,
                        components=scatter(prev.components, sub.components),
                        scalar_cost=scatter(prev.scalar_cost,
                                            sub.scalar_cost))


def sweep_links(layers: Sequence[LayerCost], env_base: OffloadEnv,
                link_bws, efficiency: float = EFFICIENCY, *,
                cost=None, backend: str = "kernel",
                device: DeviceLike = None) -> DecisionPlan:
    """Optimal decisions for one device/edge pair across a bandwidth grid —
    the "radio conditions sweep" shorthand.  ``efficiency``/``cost``/
    ``backend`` pass straight through to :func:`decide_all`."""
    envs = make_envs(env_base.device, env_base.edge,
                     link_bw=np.asarray(link_bws, np.float64),
                     link_latency_s=env_base.link_latency_s,
                     input_bytes=env_base.input_bytes, device=device)
    return decide_all(layers, envs, efficiency, cost=cost, backend=backend,
                      device=envs.device)
