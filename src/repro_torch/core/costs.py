"""Pluggable cost models for offloading decisions (the CostModel API).

The PyTorch twin of ``repro.core.costs``.  A cost model maps ``(layers,
EnvArrays)`` to a ``[n_envs, L+1, n_objectives]`` component tensor with
named objectives, plus a scalarisation that collapses the objective axis
for the argmin in :func:`repro_torch.core.decisions.decide_all`.  Tensors
live on the device of the ``EnvArrays`` they are given.

  * :class:`AnalyticCost`   — FLOPs / (peak × efficiency) latency.
  * :class:`PredictorCost`  — per-layer latency from a fitted profiling
    regressor (GBT, ridge or MLP), one batched ``predict`` per sweep.
  * :class:`CompositeCost`  — latency, energy, price, deadline slack and
    optionally a tail-latency objective, weighted.
  * :class:`QueueAwareCost` — the edge pool's predicted wait folded into
    any base model.

Each also lowers (:func:`lower_to_accel`) to the :class:`AccelSpec` scalars
that the fused ``decide_split`` kernel reads, and feeds the scheduler's
``[T, N]`` expected-time-to-compute matrix through :func:`etc_from_cost`
(``PredictorCost`` and ``QueueAwareCost`` through their ``task_matrix``).
"""
# repro: module-tags=fma-sensitive
# (scalarize_weighted must accumulate term-by-term — see its docstring;
#  DET001 rejects any @ / dot / matmul creeping back into this module)
from __future__ import annotations

import dataclasses
from typing import (TYPE_CHECKING, Callable, ClassVar, Mapping, Optional,
                    Protocol, Sequence)

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.decisions import (EnvArrays, latency_components,
                                        make_envs, seq_cumsum,
                                        transfer_bytes, transfer_matrix)
from repro_torch.core.offload import DEFAULT_EFFICIENCY, LayerCost
from repro_torch.hw import DeviceSpec

if TYPE_CHECKING:
    from repro_torch.core.predictors.common import Regressor

F64 = torch.float64


class CostModel(Protocol):
    """Maps (layers, envs) to named per-objective cost components.

    ``components`` returns ``[n_envs, L+1, len(objectives)]``; column ``s``
    is the cost of running layers ``[0, s)`` on-device and the rest on the
    edge.  ``scalarize`` collapses the objective axis to the ``[E, L+1]``
    matrix that the argmin ranks splits by.  Implementations may also
    expose ``latency_parts(layers, envs) -> (device, transfer, edge)``.
    """

    @property
    def objectives(self) -> tuple[str, ...]: ...

    def components(self, layers: Sequence[LayerCost],
                   envs: EnvArrays) -> torch.Tensor: ...

    def scalarize(self, components: torch.Tensor) -> torch.Tensor: ...


def weight_vector(objectives: Sequence[str],
                  weights: Optional[Mapping[str, float]]) -> np.ndarray:
    """Objective-ordered weight vector.  ``weights`` maps objective name →
    weight; omitted names weigh 0, ``None`` means equal weight 1 for every
    objective.  Unknown names raise — a typo would otherwise zero the cost
    matrix and silently degenerate the argmin."""
    if weights is None:
        return np.ones(len(objectives), np.float64)
    unknown = set(weights) - set(objectives)
    if unknown:
        raise KeyError(f"unknown objective(s) {sorted(unknown)}; "
                       f"known: {list(objectives)}")
    return np.asarray([float(weights.get(n, 0.0)) for n in objectives],
                      np.float64)


def scalarize_weighted(components: torch.Tensor,
                       objectives: Sequence[str],
                       weights: Optional[Mapping[str, float]]
                       ) -> torch.Tensor:
    """Weighted sum over the trailing objective axis (see
    :func:`weight_vector` for the weight semantics).

    Accumulated term by term in objective order, one eager multiply and one
    eager add per objective, never as a product with ``@``: that is the
    reference's exact rounding sequence, so scalarisations stay bit for bit
    in f64.
    """
    w = weight_vector(objectives, weights)
    if w.size == 0:
        return torch.zeros(components.shape[:-1], dtype=F64,
                           device=components.device)
    out = components[..., 0] * float(w[0])
    for k in range(1, w.size):
        out = out + components[..., k] * float(w[k])
    return out


# --------------------------------------------------------------------------
# Accelerator lowering: the scalar spec the decide_split kernel consumes
# --------------------------------------------------------------------------
#: canonical objective order of the decision kernel
ACCEL_OBJECTIVES = ("latency_s", "energy_j", "price", "deadline_slack_s")


@dataclasses.dataclass(frozen=True)
class AccelSpec:
    """Parameters that fully determine a lowerable cost model.

    The ``decide_split`` kernel evaluates one fixed objective stack —
    latency, energy, price, deadline slack, in :data:`ACCEL_OBJECTIVES`
    order — and scalarises it with ``weights``.  ``lowered`` is ``None``
    for the analytic roofline, otherwise a
    :class:`repro_torch.oracle.lowered.LoweredLayerTimes` whose per-layer
    ``(t_dev, t_edge)`` the kernel turns into cumulative-split times.
    """
    efficiency: float
    weights: tuple[float, float, float, float]
    radio_watts: float = 0.0
    price_per_edge_s: float = 0.0
    price_per_gb: float = 0.0
    deadline_s: float = float("inf")
    #: predicted queueing delay at the edge pool (s), added to the latency
    #: of every offloading split
    queue_wait_s: float = 0.0
    #: tail excess (p99 / CVaR RTT over its mean) and the weight of the
    #: ``tail_latency_s`` objective; both 0.0 drop the tail column
    tail_excess_s: float = 0.0
    tail_weight: float = 0.0
    #: objective names the resulting DecisionPlan carries
    objectives: tuple[str, ...] = ("latency_s",)
    #: lowered predictor layer-times, or None for the analytic roofline
    lowered: Optional[object] = dataclasses.field(default=None,
                                                  compare=False)


def lower_to_accel(cost: Optional[CostModel],
                   efficiency: float = DEFAULT_EFFICIENCY) -> AccelSpec:
    """``cost`` → :class:`AccelSpec`, or raise ``TypeError`` if the model
    cannot run through the fused kernel (use ``backend='torch'``)."""
    if cost is None:
        return AccelSpec(efficiency, (1.0, 0.0, 0.0, 0.0))
    fn = getattr(cost, "accel_spec", None)
    if fn is None:
        raise TypeError(
            f"{type(cost).__name__} does not lower to the decide_split "
            "kernel: backend='kernel' needs pure array math over EnvArrays "
            "or a lowerable fitted regressor (AnalyticCost, CompositeCost, "
            "QueueAwareCost, PredictorCost over a GBT) — use "
            "backend='torch'")
    return fn()


# --------------------------------------------------------------------------
# Analytic cost: the roofline time model, latency-only
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AnalyticCost:
    """FLOPs / (peak × efficiency) latency — wraps ``latency_matrix``
    bit for bit, as the single objective ``latency_s``."""

    efficiency: float = DEFAULT_EFFICIENCY

    objectives: ClassVar[tuple[str, ...]] = ("latency_s",)

    def __post_init__(self):
        # memo keyed on (layers, envs) identity — components() and the
        # DecisionPlan breakdown inside one decide_all share one compute.
        # Callers must treat layers/envs as immutable (no in-place edits).
        object.__setattr__(self, "_parts_cache", (None, None, None))

    def components(self, layers, envs) -> torch.Tensor:
        dev_cum, xfer, edge_cum = self.latency_parts(layers, envs)
        return (dev_cum + xfer + edge_cum)[..., None]

    def scalarize(self, components: torch.Tensor) -> torch.Tensor:
        return components[..., 0]

    def latency_parts(self, layers, envs):
        cached = self._parts_cache
        if cached[0] is layers and cached[1] is envs:
            return cached[2]
        parts = latency_components(layers, envs, self.efficiency)
        object.__setattr__(self, "_parts_cache", (layers, envs, parts))
        return parts

    def accel_spec(self) -> AccelSpec:
        return AccelSpec(self.efficiency, (1.0, 0.0, 0.0, 0.0))


# --------------------------------------------------------------------------
# Predictor cost: the trained profiling model in the decision loop
# --------------------------------------------------------------------------
def default_layer_features(layers: Sequence[LayerCost],
                           spec: DeviceSpec) -> np.ndarray:
    """``[L, F]`` f32 feature rows for per-layer execution-time prediction:
    log-scaled layer size plus the hardware features the profiling models
    train on (``DeviceSpec.as_features``, incl. ``hw_tdp_watts``).  Built
    on the host with numpy, exactly as the reference builds them."""
    n = len(layers)
    hw = spec.as_features()
    flops = np.fromiter((lc.flops for lc in layers), np.float64, count=n)
    act = np.fromiter((lc.act_bytes for lc in layers), np.float64, count=n)
    cols = [
        np.log10(np.maximum(flops, 1.0)),
        np.log10(np.maximum(act, 1.0)),
        np.full(n, np.log10(max(hw["hw_peak_flops"], 1.0))),
        np.full(n, np.log10(max(hw["hw_hbm_bw"], 1.0))),
        np.full(n, hw["hw_clock_ghz"]),
        np.full(n, hw["hw_is_accelerated"]),
        np.full(n, hw["hw_tdp_watts"]),
    ]
    return np.stack(cols, axis=1).astype(np.float32)


def _cum_rows(t_dev: torch.Tensor, t_edge: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """``[L+1]`` forward prefix of device times and backward prefix of
    edge times, in numpy's accumulation order."""
    zero = torch.zeros(1, dtype=F64, device=t_dev.device)
    dev_cum = torch.cat([zero, seq_cumsum(t_dev[None, :])[0]])
    edge_cum = torch.cat([seq_cumsum(t_edge.flip(0)[None, :])[0].flip(0),
                          zero])
    return dev_cum, edge_cum


@dataclasses.dataclass
class PredictorCost:
    """Latency from a fitted profiling regressor (GBT, ridge or MLP).

    Per-layer times for the device and edge come from ONE batched
    ``model.predict`` over ``[2L, F]`` feature rows — independent of the
    number of environments swept.  Transfer latency keeps the analytic
    link model.  ``device``/``edge`` are :class:`DeviceSpec`s; the torch
    device is the one the environments live on.

    Predictions and latency parts are memoised on the *identity* of the
    layers/envs arguments: treat them as immutable, and build a fresh
    PredictorCost after refitting the model.
    """

    model: "Regressor"                   # fitted: predict([N, F]) -> [N]
    device: DeviceSpec
    edge: DeviceSpec
    feature_fn: Callable[[Sequence[LayerCost], DeviceSpec], np.ndarray] = \
        default_layer_features
    target_index: int = 0                # column, for multi-target models

    objectives: ClassVar[tuple[str, ...]] = ("latency_s",)

    def __post_init__(self):
        self._times_cache: tuple = (None, None, None)
        self._parts_cache: tuple = (None, None, None)
        self._accel_cache: tuple = (None, None)

    def layer_times(self, layers, device: DeviceLike = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Predicted per-layer times ``(device [L], edge [L])`` as f64
        tensors on the torch ``device`` — one ``predict`` call, clamped
        to ≥ 0, memoised on the layers object."""
        dev = resolve_device(device)
        cached = self._times_cache
        if cached[0] is layers and cached[1] == dev:
            return cached[2]
        feats = np.concatenate([self.feature_fn(layers, self.device),
                                self.feature_fn(layers, self.edge)], axis=0)
        pred = self.model.predict(feats, device=dev).to(F64)
        if pred.ndim == 2:
            pred = pred[:, self.target_index]
        pred = torch.clamp_min(pred, 0.0)
        times = (pred[:len(layers)], pred[len(layers):])
        self._times_cache = (layers, dev, times)
        return times

    def latency_parts(self, layers, envs):
        cached = self._parts_cache
        if cached[0] is layers and cached[1] is envs:
            return cached[2]
        dev_cum, edge_cum = _cum_rows(*self.layer_times(layers, envs.device))
        shape = (len(envs), len(layers) + 1)
        parts = (dev_cum.expand(shape), transfer_matrix(layers, envs),
                 edge_cum.expand(shape))
        self._parts_cache = (layers, envs, parts)
        return parts

    def components(self, layers, envs) -> torch.Tensor:
        dev_cum, xfer, edge_cum = self.latency_parts(layers, envs)
        return (dev_cum + xfer + edge_cum)[..., None]

    def scalarize(self, components: torch.Tensor) -> torch.Tensor:
        return components[..., 0]

    def accel_spec(self) -> AccelSpec:
        """Lower to the fused kernel by compiling the fitted regressor to
        array form (``repro_torch.oracle.lowered``); raises ``TypeError``
        when the model has no array lowering.  Memoised on the model."""
        if self._accel_cache[0] is self.model:
            return self._accel_cache[1]
        from repro_torch.oracle.lowered import lower_layer_times
        spec = AccelSpec(DEFAULT_EFFICIENCY, (1.0, 0.0, 0.0, 0.0),
                         lowered=lower_layer_times(self))
        self._accel_cache = (self.model, spec)
        return spec

    def task_matrix(self, tasks, nodes, *,
                    torch_device: DeviceLike = None) -> np.ndarray:
        """Predicted ``[T, N]`` f64 expected-time-to-compute matrix for
        :func:`repro_torch.core.scheduler.etc_matrix`: ONE ``predict`` over
        all ``N·T`` (node, task) rows on ``torch_device`` (None = cuda),
        brought to the host once, plus the analytic input-transfer term in
        numpy — the reference's arithmetic in its order."""
        layers = [LayerCost(t.name, flops=t.flops, act_bytes=0.0)
                  for t in tasks]
        feats = np.concatenate([self.feature_fn(layers, n.spec)
                                for n in nodes], axis=0)     # [N*T, F]
        pred = self.model.predict(
            feats, device=resolve_device(torch_device)).to(F64)
        if pred.ndim == 2:
            pred = pred[:, self.target_index]
        comp = self._corrected(torch.clamp_min(pred, 0.0)).cpu().numpy()
        comp = comp.reshape(len(nodes), len(tasks)).T
        link = np.asarray([n.spec.link_bw for n in nodes], np.float64)
        inp = np.asarray([t.input_bytes for t in tasks], np.float64)
        return comp + inp[:, None] / np.maximum(link, 1.0)[None, :]

    def _corrected(self, t: torch.Tensor) -> torch.Tensor:
        """Predicted compute times as served: unchanged here; an oracle's
        cost model applies its live correction."""
        return t


# --------------------------------------------------------------------------
# Composite cost: latency + energy + price + deadline slack
# --------------------------------------------------------------------------
def _tdp_or_zero(tdp: Optional[torch.Tensor], envs: EnvArrays
                 ) -> torch.Tensor:
    if tdp is None:
        return torch.zeros(len(envs), dtype=F64, device=envs.device)
    return tdp


@dataclasses.dataclass
class CompositeCost:
    """Multi-objective cost over a latency-producing base model.

    Objectives, in order:

      * ``latency_s``        — end-to-end latency from ``base``
      * ``energy_j``         — device compute at ``dev_tdp_watts``, radio
                               at ``radio_watts`` during transfer, edge
                               compute at ``edge_tdp_watts``
      * ``price``            — billed edge seconds + shipped gigabytes
      * ``deadline_slack_s`` — ``max(0, latency - deadline_s)`` overrun
      * ``tail_latency_s``   — only when ``tail=`` is set: latency plus the
                               p99/CVaR_α excess of ``rtt`` over its mean on
                               every offloading split

    ``rtt`` is any object with ``mean()`` and ``tail_stat(tail, alpha)``
    (the reference's ``repro.sim.queueing`` delay processes qualify).
    """

    base: CostModel = dataclasses.field(default_factory=AnalyticCost)
    weights: Optional[Mapping[str, float]] = None
    radio_watts: float = 2.5             # device NIC/radio power while TX
    price_per_edge_s: float = 0.0
    price_per_gb: float = 0.0
    deadline_s: float = float("inf")
    #: ``"p99"`` or ``"cvar"`` turns on the fifth ``tail_latency_s``
    #: objective over the ``rtt`` delay process
    tail: Optional[str] = None
    tail_alpha: float = 0.99
    rtt: Optional[object] = None

    objectives: ClassVar[tuple[str, ...]] = (
        "latency_s", "energy_j", "price", "deadline_slack_s")

    def __post_init__(self):
        if not hasattr(self.base, "latency_parts"):
            raise TypeError(
                f"CompositeCost base {type(self.base).__name__} must "
                "expose latency_parts(layers, envs) — the energy/price/"
                "slack objectives need the (device, transfer, edge) "
                "latency decomposition, not just totals")
        if self.tail is not None:
            if self.tail not in ("p99", "cvar"):
                raise ValueError(f"tail must be 'p99' or 'cvar', "
                                 f"got {self.tail!r}")
            if self.rtt is None:
                raise ValueError(
                    "tail= needs an rtt= delay process to take the tail "
                    "statistic over")
            # shadow the ClassVar: this instance carries five objectives
            self.objectives = CompositeCost.objectives + (
                "tail_latency_s",)

    def tail_excess_s(self) -> float:
        """Predicted excess of the tail RTT statistic over its mean —
        the per-offload premium the ``tail_latency_s`` column adds."""
        if self.tail is None:
            return 0.0
        return max(self.rtt.tail_stat(self.tail, self.tail_alpha)
                   - self.rtt.mean(), 0.0)

    def components(self, layers, envs) -> torch.Tensor:
        dev_t, xfer_t, edge_t = self.base.latency_parts(layers, envs)
        total = dev_t + xfer_t + edge_t
        dev_w = _tdp_or_zero(envs.dev_tdp_watts, envs)
        edge_w = _tdp_or_zero(envs.edge_tdp_watts, envs)
        energy = dev_t * dev_w[:, None] + xfer_t * self.radio_watts \
            + edge_t * edge_w[:, None]
        price = edge_t * self.price_per_edge_s \
            + transfer_bytes(layers, envs) / 1e9 * self.price_per_gb
        slack = torch.clamp_min(total - self.deadline_s, 0.0)
        if self.tail is None:
            return torch.stack([total, energy, price, slack], dim=-1)
        tail_col = total.clone()
        tail_col[..., :-1] += self.tail_excess_s()  # last split: no RTT
        return torch.stack([total, energy, price, slack, tail_col], dim=-1)

    def scalarize(self, components: torch.Tensor) -> torch.Tensor:
        return scalarize_weighted(components, self.objectives, self.weights)

    def latency_parts(self, layers, envs):
        return self.base.latency_parts(layers, envs)

    def accel_spec(self) -> AccelSpec:
        base_fn = getattr(self.base, "accel_spec", None)
        if base_fn is None:
            raise TypeError(
                f"CompositeCost over base {type(self.base).__name__} does "
                "not lower to the decide_split kernel — the base must be "
                "AnalyticCost or a lowerable PredictorCost; use "
                "backend='torch'")
        base = base_fn()
        if base.objectives != ("latency_s",):
            raise TypeError(
                "CompositeCost needs a latency-only base (AnalyticCost "
                "or PredictorCost) to lower — a base carrying its own "
                "objective stack would be silently overwritten")
        w = weight_vector(self.objectives, self.weights)
        return dataclasses.replace(
            base, weights=tuple(float(x) for x in w[:4]),
            radio_watts=self.radio_watts,
            price_per_edge_s=self.price_per_edge_s,
            price_per_gb=self.price_per_gb,
            deadline_s=float(self.deadline_s),
            tail_excess_s=float(self.tail_excess_s()),
            tail_weight=float(w[4]) if self.tail is not None else 0.0,
            objectives=self.objectives)


# --------------------------------------------------------------------------
# Queue-aware cost: live pool state folded into any cost model
# --------------------------------------------------------------------------
@dataclasses.dataclass
class QueueAwareCost:
    """Sojourn-aware wrapper: predicted completion = wait + service (+
    transfer) over any base cost model.

    ``edge_pool`` is any object with ``wait(now)`` (the reference's
    ``repro.sim.queueing.ServerPool`` qualifies): its current wait is added
    to every offloading split, re-read on every call.  ``pools`` is any
    object with ``waits(now) -> [N]`` (the reference's ``NodePools``
    qualifies): :meth:`task_matrix` adds each node's wait to its column of
    the base ETC matrix.  ``rtt`` (``mean()``) optionally adds the mean RTT
    as well; ``wait_s`` is a static extra.  Advance virtual time with
    :meth:`set_now`.
    """

    base: CostModel = dataclasses.field(default_factory=AnalyticCost)
    edge_pool: Optional[object] = None
    pools: Optional[object] = None
    rtt: Optional[object] = None
    wait_s: float = 0.0
    now: float = 0.0

    def set_now(self, now: float) -> None:
        self.now = float(now)

    @property
    def objectives(self) -> tuple[str, ...]:
        return self.base.objectives

    def _edge_wait(self) -> float:
        w = float(self.wait_s)
        if self.edge_pool is not None:
            w += float(self.edge_pool.wait(self.now))
        if self.rtt is not None:
            w += float(self.rtt.mean())
        return w

    def components(self, layers, envs) -> torch.Tensor:
        comp = self.base.components(layers, envs).clone()
        w = self._edge_wait()
        if w > 0.0:
            comp[..., :-1, 0] += w          # offloading splits wait
        return comp

    def scalarize(self, components: torch.Tensor) -> torch.Tensor:
        return self.base.scalarize(components)

    def latency_parts(self, layers, envs):
        dev_t, xfer_t, edge_t = self.base.latency_parts(layers, envs)
        w = self._edge_wait()
        if w > 0.0:
            xfer_t = xfer_t.clone()
            xfer_t[..., :-1] += w           # book the wait with transfer
        return dev_t, xfer_t, edge_t

    def task_matrix(self, tasks, nodes, *,
                    torch_device: DeviceLike = None) -> np.ndarray:
        """The base model's ``[T, N]`` ETC matrix plus each node's pool wait,
        the mean RTT and ``wait_s`` on every column."""
        etc = etc_from_cost(self.base, tasks, nodes, device=torch_device)
        extra = np.zeros(etc.shape[1], np.float64)
        if self.pools is not None:
            extra = extra + self.pools.waits(self.now)
        if self.rtt is not None:
            extra = extra + float(self.rtt.mean())
        if self.wait_s:
            extra = extra + float(self.wait_s)
        return etc + extra[None, :]

    def accel_spec(self) -> AccelSpec:
        spec = lower_to_accel(self.base)
        return dataclasses.replace(
            spec, queue_wait_s=float(spec.queue_wait_s
                                     + self._edge_wait()))


# --------------------------------------------------------------------------
# Cost-model-driven ETC matrices for the scheduler
# --------------------------------------------------------------------------
def etc_from_cost(cost: CostModel, tasks, nodes, *,
                  device: DeviceLike = None) -> np.ndarray:
    """``[T, N]`` f64 scalarised cost of running each task wholly on each
    node, on the host.

    Each task becomes a one-layer chain evaluated at split 0 — the task
    ships its input over the node's link and executes remotely — which for
    :class:`AnalyticCost` reproduces ``Node.exec_time``.  Cost models with
    a ``task_matrix`` fast path (:class:`PredictorCost`,
    :class:`QueueAwareCost`) are dispatched to it.  The cost runs on the
    torch ``device`` (None = cuda)."""
    fast = getattr(cost, "task_matrix", None)
    if fast is not None:
        return fast(tasks, nodes, torch_device=device)
    dev = resolve_device(device)
    specs = [n.spec for n in nodes]
    link = np.asarray([s.link_bw for s in specs], np.float64)
    out = np.empty((len(tasks), len(specs)))
    for i, t in enumerate(tasks):
        layers = [LayerCost(t.name, flops=t.flops, act_bytes=0.0)]
        envs = make_envs(specs, specs, link_bw=link, link_latency_s=0.0,
                         input_bytes=t.input_bytes, device=dev)
        out[i] = cost.scalarize(cost.components(layers, envs))[:, 0] \
            .cpu().numpy()
    return out
