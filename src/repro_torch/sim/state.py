"""Drifting environment state: link bandwidth / backlog processes, the
port of ``repro.sim.state``.

The batch decision core freezes the world at t=0; this module is what
un-freezes it.  Each :class:`LinkProcess` is a seeded stochastic process
advanced by ``step(dt)`` between events, drawing from
``np.random.default_rng(seed)`` exactly as the reference does (so a link
path equals the reference's bit for bit):

  * :class:`RandomWalkLink`  — geometric (log-space) random walk, the
                               slow-fading "drifting 6G link"
  * :class:`TwoStateLink`    — Gilbert–Elliott good/bad channel with
                               exponential dwell times (bursty outages)
  * :class:`DiurnalLink`     — deterministic sinusoid × optional
                               log-normal noise (cell-load tide)
  * :class:`FixedLink`       — constant (the static-world pin used by
                               the equivalence tests)

:class:`DriftingEnv` snapshots the current state into the exact
:class:`repro_torch.core.decisions.EnvArrays` the batch core consumes, on
its torch device, so ``decide_all`` and the ``decide_split`` kernel are
reused *unchanged*.  :class:`ClusterLinks` carries one process per
scheduler node for the ``[T, N]`` streaming placement path.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Protocol, Sequence, runtime_checkable

import numpy as np

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.decisions import EnvArrays, make_envs
from repro_torch.hw import DeviceSpec


@runtime_checkable
class LinkProcess(Protocol):
    """A seeded bandwidth process: ``value`` is the current bytes/s,
    ``step(dt)`` advances virtual time and returns the new value.

    The concrete processes below additionally implement
    ``step_batch(dt, n)`` — ``n`` steps of ``dt`` as one ``[n]`` array,
    bit-for-bit the values (and the RNG stream) of ``n`` scalar
    ``step(dt)`` calls.  It is intentionally *not* part of the protocol
    so user-defined processes keep working; :func:`step_batch` below
    falls back to the scalar loop for them."""

    @property
    def value(self) -> float: ...

    def step(self, dt: float) -> float: ...


def step_batch(process: LinkProcess, dt: float, n: int) -> np.ndarray:
    """``n`` steps of ``dt`` on ``process`` as one ``[n]`` float64 array.

    Dispatches to the process's vectorized ``step_batch`` when it has
    one (every process in this module does), else loops the scalar
    ``step`` — either way the values and the process's end state are
    bit-for-bit identical to ``n`` scalar calls."""
    fn = getattr(process, "step_batch", None)
    if fn is not None:
        return np.asarray(fn(dt, int(n)), np.float64)
    return np.asarray([process.step(dt) for _ in range(int(n))],
                      np.float64)


@dataclasses.dataclass
class FixedLink:
    """Constant bandwidth — the degenerate static-world process."""
    bw: float

    @property
    def value(self) -> float:
        return float(self.bw)

    def step(self, dt: float) -> float:
        return self.value

    def step_batch(self, dt: float, n: int) -> np.ndarray:
        return np.full(int(n), self.value, np.float64)


@dataclasses.dataclass
class RandomWalkLink:
    """Geometric random walk: ``log bw`` takes N(0, sigma²·dt) steps,
    clipped to ``[min_bw, max_bw]`` — slow fading around ``base_bw``."""
    base_bw: float
    sigma: float = 0.3           # log-space std per sqrt(second)
    min_bw: float = 1e4
    max_bw: float = 1e11
    seed: "int | np.random.SeedSequence" = 0

    def __post_init__(self):
        if not self.min_bw <= self.base_bw <= self.max_bw:
            raise ValueError("need min_bw <= base_bw <= max_bw")
        self._rng = np.random.default_rng(self.seed)
        self._log = math.log(self.base_bw)

    @property
    def value(self) -> float:
        return float(math.exp(self._log))

    def step(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"dt must be >= 0, got {dt}")
        self._log += float(self._rng.normal(0.0,
                                            self.sigma * math.sqrt(dt)))
        self._log = min(max(self._log, math.log(self.min_bw)),
                        math.log(self.max_bw))
        return self.value

    def step_batch(self, dt: float, n: int) -> np.ndarray:
        if dt < 0:
            raise ValueError(f"dt must be >= 0, got {dt}")
        n = int(n)
        if n == 0:
            return np.zeros(0, np.float64)
        # one vectorized draw is the same RNG stream as n scalar draws;
        # cumsum is the same float ordering as sequential accumulation
        draws = self._rng.normal(0.0, self.sigma * math.sqrt(dt), size=n)
        logs = np.cumsum(np.concatenate(([self._log], draws)))[1:]
        lo = math.log(self.min_bw)
        hi = math.log(self.max_bw)
        if lo <= logs.min() and logs.max() <= hi:
            self._log = float(logs[-1])
            # math.exp, not np.exp: numpy's SIMD exp rounds differently
            # from libm on some platforms, and `value` uses math.exp
            return np.asarray([math.exp(x) for x in logs], np.float64)
        # a clip fired somewhere along the walk, so the later prefix
        # sums are wrong.  Accept clip-free prefixes in vectorized
        # chunks (doubling while clean, resetting after a clip): a
        # mostly-clean walk stays O(n), a boundary-pinned one degrades
        # to short lookaheads instead of a full scalar replay.
        out = np.empty(n, np.float64)
        log = self._log
        k = 0
        chunk = 32
        while k < n:
            m = min(chunk, n - k)
            logs = np.cumsum(np.concatenate(([log],
                                             draws[k:k + m])))[1:]
            bad = (logs < lo) | (logs > hi)
            if bad.any():
                b = int(np.argmax(bad))
                out[k:k + b] = [math.exp(x) for x in logs[:b]]
                # cumsum[b] == cumsum[b-1] + draw exactly, so clipping
                # it reproduces the scalar step
                log = min(max(float(logs[b]), lo), hi)
                out[k + b] = math.exp(log)
                k += b + 1
                chunk = 32
            else:
                out[k:k + m] = [math.exp(x) for x in logs]
                log = float(logs[-1])
                k += m
                chunk = min(chunk * 2, 4096)
        self._log = log
        return out


@dataclasses.dataclass
class TwoStateLink:
    """Gilbert–Elliott channel: good/bad bandwidth with exponential
    dwell times (means ``mean_good_s`` / ``mean_bad_s``)."""
    good_bw: float
    bad_bw: float
    mean_good_s: float = 5.0
    mean_bad_s: float = 1.0
    seed: "int | np.random.SeedSequence" = 0

    def __post_init__(self):
        if self.mean_good_s <= 0 or self.mean_bad_s <= 0:
            raise ValueError("dwell-time means must be positive")
        self._rng = np.random.default_rng(self.seed)
        self.good = True
        self._remaining = float(self._rng.exponential(self.mean_good_s))

    @property
    def value(self) -> float:
        return float(self.good_bw if self.good else self.bad_bw)

    def step(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"dt must be >= 0, got {dt}")
        dt = float(dt)
        while dt >= self._remaining:       # may switch several times
            dt -= self._remaining
            self.good = not self.good
            mean = self.mean_good_s if self.good else self.mean_bad_s
            self._remaining = float(self._rng.exponential(mean))
        self._remaining -= dt
        return self.value

    def step_batch(self, dt: float, n: int) -> np.ndarray:
        # the dwell chain consumes a data-dependent number of RNG draws
        # per step, so there is no safe vectorized form — the scalar
        # loop is the bit-for-bit reference
        return np.asarray([self.step(dt) for _ in range(int(n))],
                          np.float64)


@dataclasses.dataclass
class DiurnalLink:
    """Sinusoidal capacity tide around ``base_bw`` with optional
    multiplicative log-normal noise — the diurnal cell-load model."""
    base_bw: float
    amplitude: float = 0.5       # fraction of base_bw, in [0, 1)
    period_s: float = 60.0
    noise_sigma: float = 0.0     # log-space noise std per step
    phase: float = 0.0
    seed: "int | np.random.SeedSequence" = 0

    def __post_init__(self):
        if not 0.0 <= self.amplitude < 1.0:
            raise ValueError("amplitude must be in [0, 1)")
        self._rng = np.random.default_rng(self.seed)
        self._t = 0.0
        self._noise = 1.0

    @property
    def value(self) -> float:
        tide = 1.0 + self.amplitude * math.sin(
            2.0 * math.pi * self._t / self.period_s + self.phase)
        return float(self.base_bw * tide * self._noise)

    def step(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"dt must be >= 0, got {dt}")
        self._t += float(dt)
        if self.noise_sigma > 0:
            self._noise = float(np.exp(
                self._rng.normal(0.0, self.noise_sigma)))
        return self.value

    def step_batch(self, dt: float, n: int) -> np.ndarray:
        if dt < 0:
            raise ValueError(f"dt must be >= 0, got {dt}")
        n = int(n)
        if n == 0:
            return np.zeros(0, np.float64)
        # the time axis is the same float chain as repeated `_t += dt`
        ts = np.cumsum(np.concatenate(([self._t],
                                       np.full(n, float(dt)))))[1:]
        if self.noise_sigma > 0:
            noises = np.exp(self._rng.normal(0.0, self.noise_sigma,
                                             size=n))
            self._noise = float(noises[-1])
        else:
            noises = np.full(n, self._noise)
        # np.sin matches math.sin bit-for-bit on this platform (unlike
        # np.exp), so the tide vectorizes with the exact scalar
        # expression `value` uses
        tides = 1.0 + self.amplitude * np.sin(
            2.0 * math.pi * ts / self.period_s + self.phase)
        self._t = float(ts[-1])
        return self.base_bw * tides * noises


# --------------------------------------------------------------------------
# Snapshots into the batch decision core's EnvArrays
# --------------------------------------------------------------------------
@dataclasses.dataclass
class DriftingEnv:
    """One device↔edge pair whose link drifts over virtual time.

    ``snapshot()`` freezes the current state into an
    :class:`EnvArrays` (``E = len(input_bytes)``; scalar input gives
    ``E = 1``) on ``torch_device`` (None = cuda; the keyword is not
    ``device``, which is the :class:`DeviceSpec` of the device side), so
    every existing consumer — ``decide_all``, ``sweep_links``, the cost
    models, the ``decide_split`` kernel — runs on live state without
    modification.

    Snapshots are cached per (link observation, input-bytes) pair: a
    static link snapshots each distinct input size exactly once however
    many events fire, and any link movement invalidates the whole cache
    (``EnvArrays`` is frozen, so sharing the cached instance is safe).
    """
    device: DeviceSpec
    edge: DeviceSpec
    link: LinkProcess
    link_latency_s: float = 0.005
    input_bytes: float = 0.0
    torch_device: DeviceLike = dataclasses.field(default=None,
                                                 kw_only=True)
    _snap_bw: Optional[float] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)
    _snap_cache: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    def step(self, dt: float) -> float:
        return self.link.step(dt)

    def step_batch(self, dt: float, n: int) -> np.ndarray:
        """``[n]`` bandwidth trajectory: ``n`` link steps of ``dt``,
        bit-for-bit the scalar ``step`` loop (see :func:`step_batch`)."""
        return step_batch(self.link, dt, n)

    @property
    def link_bw(self) -> float:
        return self.link.value

    def snapshot(self, input_bytes=None) -> EnvArrays:
        ib = self.input_bytes if input_bytes is None else input_bytes
        ib = np.atleast_1d(np.asarray(ib, np.float64))
        bw = self.link.value
        if bw != self._snap_bw:          # link moved: every row is stale
            self._snap_cache.clear()
            self._snap_bw = bw
        key = (ib.shape, ib.tobytes())
        envs = self._snap_cache.get(key)
        if envs is None:
            if len(self._snap_cache) >= 512:
                self._snap_cache.clear()
            envs = make_envs(self.device, self.edge,
                             link_bw=np.full(ib.shape, bw),
                             link_latency_s=self.link_latency_s,
                             input_bytes=ib,
                             device=resolve_device(self.torch_device))
            self._snap_cache[key] = envs
        return envs


class ClusterLinks:
    """Per-node uplink processes for the streaming placement path.

    ``step(dt)`` advances every node's process and returns the ``[N]``
    bandwidth vector; ``changed(prev)`` gives the node indices whose
    bandwidth moved — the columns the incremental scheduler refreshes.
    """

    def __init__(self, processes: Sequence[LinkProcess]):
        if not processes:
            raise ValueError("need at least one link process")
        self.processes = list(processes)

    @classmethod
    def random_walk(cls, base_bws: Sequence[float], *, sigma: float = 0.3,
                    seed=0) -> "ClusterLinks":
        """Per-node random-walk links.  ``seed`` may be an ``int``
        (historical ``seed + j`` per-node streams, unchanged) or a
        ``np.random.SeedSequence`` whose spawned children seed each
        node independently."""
        if isinstance(seed, np.random.SeedSequence):
            kids = seed.spawn(len(list(base_bws)))
            return cls([RandomWalkLink(float(bw), sigma=sigma, seed=kid)
                        for kid, bw in zip(kids, base_bws)])
        return cls([RandomWalkLink(float(bw), sigma=sigma, seed=seed + j)
                    for j, bw in enumerate(base_bws)])

    def __len__(self) -> int:
        return len(self.processes)

    def values(self) -> np.ndarray:
        return np.asarray([p.value for p in self.processes], np.float64)

    def step(self, dt: float) -> np.ndarray:
        return np.asarray([p.step(dt) for p in self.processes],
                          np.float64)

    def step_batch(self, dt: float, n: int) -> np.ndarray:
        """``[n, N]`` bandwidth trajectory: every node advanced ``n``
        steps of ``dt`` in one vectorized draw per process — row ``k``
        is bit-for-bit what the ``k+1``-th ``step(dt)`` would return."""
        return np.stack([step_batch(p, dt, n) for p in self.processes],
                        axis=1)
