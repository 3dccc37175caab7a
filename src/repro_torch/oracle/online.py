"""Online profiling-in-the-loop: drift detection, residual correction,
window refits — the port of ``repro.oracle.online``.

The offline loop fits a predictor once on a static ``ProfileRecord``
dataset; this module keeps it honest while it serves.  An
:class:`OnlineOracle` ingests ``(features, realised_time)`` observations
— in a streaming run, one per :func:`repro_torch.sim.stream.simulate_stream`
completion event — into a sliding window and runs three mechanisms on
the prediction residuals:

  * **always-on cheap correction** — an EWMA affine map ``t·gain +
    bias`` over the predictor's output (multiplicative ``gain`` tracks
    machine-speed drift, additive ``bias`` tracks constant offsets),
    updated per observation for a few flops.  Residuals inside
    ``deadband`` (float noise from ``finish − start`` round trips) leave
    the correction *exactly* at identity, which is what makes a
    no-drift streaming run bit-for-bit identical to the oracle-free
    path.
  * **Page–Hinkley drift detection** — two-sided PH test on normalised
    residuals: cumulative deviation from the running mean beyond
    ``ph_delta``, drift when the excursion exceeds ``ph_lambda``.
  * **full refit on drift** — a fresh clone of the current model is
    refit on the observation window, published to the versioned
    :class:`~repro_torch.oracle.registry.PredictorRegistry` (atomic
    swap), and the detector/correction reset — the paper's
    continuous-profiling loop closed.

:class:`OracleCost` is the cost-model face of the oracle: a
``PredictorCost`` whose model tracks the registry's current version and
whose predictions pass through the live correction, so every consumer —
``decide_all`` sweeps (either backend), scheduler ETC rows — picks up
refits at the next call.

The detector, the EWMA and the window are host scalar work, the
reference's f64 arithmetic in its order (the EWMA through numpy's
``log``/``exp``, as the reference computes it), so their state equals the
reference's bit for bit.  Predictions and refits run on the oracle's torch
device, ``torch_device=`` (None = cuda; the keyword is not ``device``,
which names the :class:`DeviceSpec` the features describe, as in the
reference).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.costs import (AccelSpec, PredictorCost,
                                    default_layer_features)
from repro_torch.core.offload import DEFAULT_EFFICIENCY, LayerCost
from repro_torch.core.predictors.common import normalised_rmse
from repro_torch.core.predictors.gbt import MultiTargetGBT
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.oracle.lowered import lower_layer_times
from repro_torch.oracle.registry import PredictorRegistry


@dataclasses.dataclass
class PageHinkley:
    """Two-sided Page–Hinkley change detector on a residual stream.

    The raw residuals are standardised online (Welford running
    mean/variance) so ``delta``/``lamb`` are in *sigma units* and one
    parameterisation works across predictors of very different innate
    accuracy: the cumulative deviation of the z-scored signal from its
    running mean (minus/plus the drift allowance ``delta``) is tracked
    against its running extremum, and drift fires when the excursion
    exceeds ``lamb``.  A drift-free unit-variance stream drifts the
    statistic *down* by ``delta`` per step, bounding false alarms; a
    sustained mean shift of ``k`` sigmas crosses ``lamb`` in about
    ``lamb / (min(k, z_clip) - delta)`` observations.  ``min_samples``
    suppresses triggers before the variance estimate is meaningful, and
    ``z_clip`` bounds any single observation's contribution — early
    variance estimates are noisy and profiling residuals heavy-tailed,
    and without the clip a couple of outliers can fake a mean shift.
    """
    delta: float = 0.05
    lamb: float = 30.0
    min_samples: int = 50
    z_clip: float = 8.0

    def __post_init__(self):
        self.reset()

    def reset(self) -> None:
        self.n = 0
        self.mean = 0.0
        self._m2 = 0.0          # Welford sum of squared deviations
        self._m_lo = 0.0        # cumulative (z - delta), mean-rose side
        self._m_hi = 0.0        # cumulative (z + delta), mean-fell side
        self._lo_min = 0.0
        self._hi_max = 0.0

    @property
    def std(self) -> float:
        if self.n < 2:
            return 0.0
        return float(np.sqrt(self._m2 / (self.n - 1)))

    def update(self, x: float) -> bool:
        """Feed one residual; returns True when drift is detected."""
        x = float(x)
        # z-score against the statistics *before* this sample, so a
        # genuine jump is not absorbed into its own baseline
        z = 0.0 if self.n < 2 or self._m2 <= 0.0 \
            else (x - self.mean) / self.std
        z = min(max(z, -self.z_clip), self.z_clip)
        self.n += 1
        d = x - self.mean
        self.mean += d / self.n
        self._m2 += d * (x - self.mean)
        self._m_lo += z - self.delta
        self._m_hi += z + self.delta
        self._lo_min = min(self._lo_min, self._m_lo)
        self._hi_max = max(self._hi_max, self._m_hi)
        if self.n < self.min_samples:
            return False
        return (self._m_lo - self._lo_min > self.lamb      # mean rose
                or self._hi_max - self._m_hi > self.lamb)  # mean fell


class OnlineOracle:
    """Serves a fitted profiling predictor while learning from realised
    completion times (see the module docstring for the mechanisms).

    ``model`` is the initially-fitted regressor (published as version 0
    of ``registry``); ``device``/``edge`` (:class:`DeviceSpec`) and
    ``feature_fn`` define the feature space exactly as for
    :class:`~repro_torch.core.costs.PredictorCost`.  ``correction`` is
    ``"gain"`` (multiplicative EWMA, the machine-slowdown model),
    ``"bias"`` (additive EWMA) or ``"none"``.  ``torch_device`` is where
    :meth:`predict_one` and :meth:`refit` run (None = cuda, raising
    without a card).  Set ``telemetry`` (or let ``simulate_stream`` set
    it) to stream counters/gauges into a :class:`repro_torch.sim.telemetry.
    Telemetry`.
    """

    def __init__(self, model, device, edge, *,
                 feature_fn=default_layer_features, target_index: int = 0,
                 window: int = 512, min_refit: int = 64,
                 alpha: float = 0.05, max_ratio: float = 8.0,
                 correction: str = "gain", deadband: float = 1e-9,
                 detector: Optional[PageHinkley] = None,
                 registry: Optional[PredictorRegistry] = None,
                 refit_on_drift: bool = True,
                 torch_device: DeviceLike = None):
        if correction not in ("gain", "bias", "none"):
            raise ValueError(f"unknown correction {correction!r}; "
                             "use 'gain', 'bias' or 'none'")
        self.torch_device = resolve_device(torch_device)
        self.device = device
        self.edge = edge
        self.feature_fn = feature_fn
        self.target_index = target_index
        self.window = window
        self.min_refit = min_refit
        self.alpha = float(alpha)
        self.max_ratio = float(max_ratio)
        self.correction = correction
        self.deadband = float(deadband)
        self.refit_on_drift = refit_on_drift
        self.detector = detector if detector is not None else PageHinkley()
        self.registry = registry if registry is not None \
            else PredictorRegistry()
        if self.registry.version < 0:
            self.registry.publish(model, tag="initial")
        self.gain = 1.0
        self.bias = 0.0
        self._obs_x: deque = deque(maxlen=window)
        self._obs_y: deque = deque(maxlen=window)
        self._residuals: deque = deque(maxlen=window)
        self._window_pred: deque = deque(maxlen=window)
        self.observations = 0
        self.drift_triggers = 0
        self.refits = 0
        self._refit_pending = False
        self.telemetry = None
        self.obs = NULL_TRACER                 # set by simulate_stream

    # -- serving ----------------------------------------------------------
    @property
    def model(self):
        return self.registry.current().model

    @property
    def version(self) -> int:
        return self.registry.version

    def cost_model(self) -> "OracleCost":
        """The cost-model face: plug into ``decide_all(cost=...)``,
        ``etc_matrix``, ``StreamScheduler``."""
        return OracleCost(self)

    def correct(self, t):
        """Apply the live affine residual correction to a tensor or an
        array (identity returns ``t`` itself, so an untouched oracle is
        bit-transparent)."""
        if self.gain == 1.0 and self.bias == 0.0:
            return t
        if isinstance(t, torch.Tensor):
            return torch.clamp_min(t * self.gain + self.bias, 0.0)
        return np.maximum(t * self.gain + self.bias, 0.0)

    # -- ingestion --------------------------------------------------------
    def observe(self, features: np.ndarray, realised_s: float,
                predicted_s: Optional[float] = None, *,
                refit_y: Optional[float] = None, now: float = 0.0) -> dict:
        """Ingest one ``(features, realised_time)`` observation.

        ``predicted_s`` is what the serving path actually predicted for
        this work (pass the recorded value when available — recomputing
        may disagree in the last ulp); ``refit_y`` overrides the target
        stored for refits (default ``realised_s``).  Returns
        ``{"residual", "drift", "refit_version"}``.
        """
        features = np.asarray(features, np.float64).ravel()
        if predicted_s is None:
            predicted_s = float(self.predict_one(features))
        realised_s = float(realised_s)
        self.observations += 1
        self._count("oracle_observations")
        self._obs_x.append(features)
        self._obs_y.append(realised_s if refit_y is None else float(refit_y))
        self._window_pred.append((predicted_s, realised_s))
        scale = max(abs(predicted_s), 1e-12)
        r = (realised_s - predicted_s) / scale
        self._residuals.append(r)
        if abs(r) > self.deadband:
            # cheap always-on correction: EWMA of the observed
            # ratio/offset against the *uncorrected* prediction (the
            # served value has the current correction folded in —
            # tracking against it would converge to the square root of
            # the true ratio).  Inside the deadband the correction
            # stays *exactly* identity.
            if self.correction == "gain" and self.gain > 0:
                raw = predicted_s / self.gain
                if raw > 0 and realised_s > 0:
                    # EWMA in log space (log-ratios are symmetric under
                    # multiplicative noise), clipped so one outlier
                    # cannot whip the gain around
                    lr = np.log(min(max(realised_s / raw,
                                        1.0 / self.max_ratio),
                                    self.max_ratio))
                    lg = np.log(self.gain) + self.alpha * (
                        lr - np.log(self.gain))
                    self.gain = float(np.exp(lg))
            elif self.correction == "bias":
                raw = predicted_s - self.bias
                self.bias += self.alpha * ((realised_s - raw) - self.bias)
        drift = self.detector.update(r)
        refit_version = None
        if drift:
            self.drift_triggers += 1
            self._count("oracle_drift_triggers")
            if self.obs.enabled:
                self.obs.instant("oracle", "ph_drift", float(now),
                                 args={"residual": r})
            self.detector.reset()
            if self.refit_on_drift:
                # quarantine the window: its labels straddle the change
                # point, so refitting on it would blend two regimes.
                # Collect min_refit *fresh* observations, then refit.
                self._refit_pending = True
                self._obs_x.clear()
                self._obs_y.clear()
        if self._refit_pending and len(self._obs_x) >= self.min_refit:
            refit_version = self.refit(now=now)
            self._refit_pending = False
        self._gauge("oracle_nrmse", self.rolling_nrmse())
        return {"residual": r, "drift": drift,
                "refit_version": refit_version}

    def observe_task(self, task, spec, realised_s: float,
                     predicted_s: Optional[float] = None,
                     now: float = 0.0,
                     extra_transfer_s: float = 0.0) -> dict:
        """Streaming-scheduler adapter: featurise a completed
        :class:`repro_torch.core.scheduler.Task` on the node ``spec`` it
        ran on and ingest its realised service time.  The refit target is
        the compute component (realised minus the analytic input transfer
        and any ``extra_transfer_s`` network delay), matching what the
        regressor predicts.
        """
        layers = [LayerCost(task.name, flops=task.flops, act_bytes=0.0)]
        feats = self.feature_fn(layers, spec)[0]
        transfer = float(task.input_bytes) / max(float(spec.link_bw), 1.0) \
            + float(extra_transfer_s)
        return self.observe(feats, realised_s, predicted_s,
                            refit_y=max(float(realised_s) - transfer, 0.0),
                            now=now)

    def predict_one(self, features: np.ndarray) -> float:
        """Corrected scalar prediction for one feature row: one ``predict``
        on the oracle's torch device."""
        pred = self.model.predict(
            np.asarray(features, np.float32)[None, :],
            device=self.torch_device).to(torch.float64)
        if pred.ndim == 2:
            pred = pred[:, self.target_index]
        return float(self.correct(torch.clamp_min(pred, 0.0))[0])

    # -- adaptation -------------------------------------------------------
    def refit(self, now: float = 0.0) -> int:
        """Refit the current model on the observation window, on the
        oracle's torch device, and publish it (atomic swap); resets the
        drift detector and the residual correction.  Returns the new
        version.

        Observations carry only the *served* target, so a
        ``MultiTargetGBT`` refits just its ``target_index`` ensemble
        (the other targets keep their previous trees); other
        multi-target models cannot be partially refit and are rejected
        when serving a column beyond the first.
        """
        if not self._obs_x:
            raise ValueError("cannot refit: no observations ingested")
        base = self.registry.current().model
        x = np.stack(list(self._obs_x)).astype(np.float32)
        y = np.asarray(list(self._obs_y), np.float64)
        if isinstance(base, MultiTargetGBT):
            sub = dataclasses.replace(base.models_[self.target_index])
            sub.fit(x, y, device=self.torch_device)
            fresh = dataclasses.replace(base)
            fresh.models_ = list(base.models_)
            fresh.models_[self.target_index] = sub
        elif self.target_index != 0:
            raise TypeError(
                f"cannot refit {type(base).__name__} serving "
                f"target_index={self.target_index}: observations only "
                "cover the served target, and a single-target refit "
                "would drop the other columns — use MultiTargetGBT "
                "(refits its served ensemble in place) or serve "
                "target_index=0")
        else:
            fresh = dataclasses.replace(base)    # unfitted clone
            fresh.fit(x, y, device=self.torch_device)
        version = self.registry.publish(
            fresh, tag=f"refit@{now:.3f}",
            meta={"window": len(y), "nrmse_before": self.rolling_nrmse()},
            ts=now)
        self.gain, self.bias = 1.0, 0.0
        self.detector.reset()
        self.refits += 1
        self._count("oracle_refits")
        if self.obs.enabled:
            self.obs.instant("oracle", "oracle_refit", float(now),
                             args={"version": version, "window": len(y)})
        return version

    # -- telemetry --------------------------------------------------------
    def rolling_nrmse(self) -> float:
        """Windowed normalised RMSE of served predictions vs realised
        times (the paper's Fig. 2 metric, on the live stream)."""
        if not self._window_pred:
            return 0.0
        arr = np.asarray(self._window_pred, np.float64)
        return normalised_rmse(arr[:, 0], arr[:, 1])

    def _count(self, key: str) -> None:
        if self.telemetry is not None:
            self.telemetry.count(key)

    def _gauge(self, key: str, value: float) -> None:
        if self.telemetry is not None:
            self.telemetry.gauge(key, value)


class OracleCost(PredictorCost):
    """:class:`~repro_torch.core.costs.PredictorCost` bound to an oracle:
    the model tracks the registry's current version (refits picked up at
    the next call, caches flushed) and every prediction passes through the
    live residual correction — identity-transparent until the first
    out-of-deadband observation, so a drift-free run is bit for bit the
    plain ``PredictorCost`` path.  Lowers to the ``decide_split`` kernel
    with the correction folded into the lowered layer-time program.

    One repair of the reference: its memo of the latency parts is keyed
    on the layers and environments only, so once the correction moves, a
    second sweep over the same objects returns the parts of the old
    correction.  Here the memo is also dropped when ``(gain, bias)``
    changes.
    """

    def __init__(self, oracle: OnlineOracle):
        self._oracle = oracle
        self._version = oracle.version
        self._correction = (oracle.gain, oracle.bias)
        PredictorCost.__init__(self, oracle.model, oracle.device,
                               oracle.edge, feature_fn=oracle.feature_fn,
                               target_index=oracle.target_index)

    def _sync(self) -> None:
        if self._oracle.version != self._version:
            self._version = self._oracle.version
            self.model = self._oracle.model
            # the port's memo shapes (costs.PredictorCost.__post_init__)
            self._times_cache = (None, None, None)
            self._parts_cache = (None, None, None)
        correction = (self._oracle.gain, self._oracle.bias)
        if correction != self._correction:
            self._correction = correction
            self._parts_cache = (None, None, None)

    def layer_times(self, layers, device: DeviceLike = None):
        self._sync()
        t_dev, t_edge = PredictorCost.layer_times(self, layers, device)
        return (self._oracle.correct(t_dev), self._oracle.correct(t_edge))

    def latency_parts(self, layers, envs):
        self._sync()
        return PredictorCost.latency_parts(self, layers, envs)

    def task_matrix(self, tasks, nodes, *,
                    torch_device: DeviceLike = None) -> np.ndarray:
        self._sync()
        return PredictorCost.task_matrix(self, tasks, nodes,
                                         torch_device=torch_device)

    def _corrected(self, t: torch.Tensor) -> torch.Tensor:
        return self._oracle.correct(t)

    def accel_spec(self) -> AccelSpec:
        self._sync()
        correction = (self._oracle.gain, self._oracle.bias)
        cached = getattr(self, "_oracle_accel_cache", None)
        if cached is not None and cached[0] is self.model \
                and cached[1] == correction:
            return cached[2]
        spec = AccelSpec(DEFAULT_EFFICIENCY, (1.0, 0.0, 0.0, 0.0),
                         lowered=lower_layer_times(self,
                                                   correction=correction))
        self._oracle_accel_cache = (self.model, correction, spec)
        return spec
