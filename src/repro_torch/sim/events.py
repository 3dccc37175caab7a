"""Virtual clock, event heap, and arrival processes (the sim's time axis),
the port of ``repro.sim.events``.

Everything in :mod:`repro_torch.sim` is *event-driven*: a :class:`Clock`
holds virtual time, an :class:`EventQueue` orders (time, kind, payload)
events with FIFO tie-breaking, and the arrival-process generators below
produce the task arrival times that drive the streaming scheduler.  All
processes are seeded and fully deterministic: they draw from
``np.random.default_rng(seed)`` exactly as the reference does, so the same
seed replays the reference's arrival times bit for bit.  Every ``seed=``
accepts ``int | np.random.SeedSequence``.

Arrival processes:

  * :func:`poisson_arrivals`  — homogeneous Poisson (exponential gaps)
  * :func:`trace_arrivals`    — replay a recorded timestamp trace
  * :func:`mmpp_arrivals`     — Markov-modulated Poisson (bursty: the
                                rate switches between states with
                                exponential dwell times)
  * :func:`diurnal_arrivals`  — sinusoidal rate (day/night load curve),
                                sampled by Lewis–Shedler thinning
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Any, Iterable, Optional, Union

import numpy as np

#: processes accept either a plain int (historical stream, unchanged)
#: or a spawned ``SeedSequence`` child (independent stream)
Seed = Union[int, np.random.SeedSequence]


class Clock:
    """Monotonic virtual time in seconds."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    @property
    def now(self) -> float:
        return self._now

    def advance(self, dt: float) -> float:
        """Move time forward by ``dt`` seconds (``dt < 0`` is an error)."""
        if dt < 0:
            raise ValueError(f"clock cannot run backwards (dt={dt})")
        self._now += float(dt)
        return self._now

    def advance_to(self, t: float) -> float:
        """Jump forward to absolute time ``t`` (no-op if already past)."""
        self._now = max(self._now, float(t))
        return self._now

    def __repr__(self) -> str:
        return f"Clock(now={self._now:.6f})"


@dataclasses.dataclass(frozen=True)
class Event:
    """One scheduled event: ``kind`` names the handler, ``payload`` is
    handler-specific (task indices, a node id, ...)."""
    time: float
    kind: str
    payload: Any = None


class EventQueue:
    """Min-heap of events ordered by time, FIFO among equal times."""

    def __init__(self):
        self._heap: list[tuple[float, int, Event]] = []
        self._seq = itertools.count()

    def push(self, time: float, kind: str, payload: Any = None) -> Event:
        ev = Event(float(time), kind, payload)
        heapq.heappush(self._heap, (ev.time, next(self._seq), ev))
        return ev

    def push_batch(self, times, kind: str,
                   payloads: Optional[Iterable[Any]] = None) -> list[Event]:
        """Bulk push: one O(n) ``heapify`` instead of n O(log n)
        sift-ups — the arrival-seeding fast path.  Sequence numbers are
        assigned in input order, so FIFO tie-breaking is identical to n
        ``push`` calls (pops interleave correctly with earlier and later
        pushes because the (time, seq) order is total)."""
        times = list(times)
        payloads = list(payloads) if payloads is not None \
            else [None] * len(times)
        if len(payloads) != len(times):
            raise ValueError(f"got {len(times)} times but "
                             f"{len(payloads)} payloads")
        evs = [Event(float(t), kind, p) for t, p in zip(times, payloads)]
        self._heap.extend((ev.time, next(self._seq), ev) for ev in evs)
        heapq.heapify(self._heap)
        return evs

    def pop(self) -> Event:
        return heapq.heappop(self._heap)[2]

    def peek_time(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)


# --------------------------------------------------------------------------
# Arrival processes (all return sorted float64 arrays of absolute times)
# --------------------------------------------------------------------------
def poisson_arrivals(rate: float, *, n: Optional[int] = None,
                     horizon: Optional[float] = None, seed: "Seed" = 0,
                     start: float = 0.0) -> np.ndarray:
    """Homogeneous Poisson arrivals at ``rate`` events/s.

    Exactly one of ``n`` (event count) or ``horizon`` (duration in
    seconds, events strictly before ``start + horizon``) must be given.
    """
    if rate <= 0:
        raise ValueError(f"rate must be positive, got {rate}")
    if (n is None) == (horizon is None):
        raise ValueError("give exactly one of n= or horizon=")
    rng = np.random.default_rng(seed)
    if n is not None:
        return start + np.cumsum(rng.exponential(1.0 / rate, size=int(n)))
    out: list[np.ndarray] = []
    t = 0.0
    chunk = max(int(rate * horizon * 1.5) + 16, 64)
    while t < horizon:
        gaps = rng.exponential(1.0 / rate, size=chunk)
        times = t + np.cumsum(gaps)
        out.append(times)
        t = float(times[-1])
    all_t = np.concatenate(out)
    return start + all_t[all_t < horizon]


def trace_arrivals(times: Iterable[float]) -> np.ndarray:
    """Replay a recorded arrival trace (validated sorted, finite, ≥ 0)."""
    t = np.asarray(list(times) if not isinstance(times, np.ndarray)
                   else times, np.float64)
    if t.ndim != 1:
        raise ValueError(f"trace must be 1-D, got shape {t.shape}")
    if t.size and (not np.isfinite(t).all() or (t < 0).any()):
        raise ValueError("trace times must be finite and non-negative")
    if t.size > 1 and (np.diff(t) < 0).any():
        raise ValueError("trace times must be sorted ascending")
    return t


def mmpp_arrivals(rates, dwell_s, *, horizon: float, seed: "Seed" = 0,
                  start: float = 0.0) -> np.ndarray:
    """Markov-modulated Poisson arrivals over ``[0, horizon)``.

    The process cycles through ``len(rates)`` states; state ``k`` emits a
    Poisson stream at ``rates[k]`` events/s for an exponential dwell of
    mean ``dwell_s[k]`` seconds.  Two states (quiet/burst) give the
    classic bursty 6G cell-load model; more states make a cycle.
    """
    rates = np.asarray(rates, np.float64)
    dwell = np.broadcast_to(np.asarray(dwell_s, np.float64), rates.shape)
    if rates.size == 0 or (rates < 0).any() or (dwell <= 0).any():
        raise ValueError("need ≥1 state, rates ≥ 0, dwell times > 0")
    rng = np.random.default_rng(seed)
    out: list[float] = []
    t, state = 0.0, 0
    while t < horizon:
        end = min(t + rng.exponential(dwell[state]), horizon)
        r = rates[state]
        if r > 0:
            tt = t + rng.exponential(1.0 / r)
            while tt < end:
                out.append(tt)
                tt += rng.exponential(1.0 / r)
        t = end
        state = (state + 1) % rates.size
    return start + np.asarray(out, np.float64)


def diurnal_arrivals(base_rate: float, *, horizon: float,
                     amplitude: float = 0.5, period_s: float = 60.0,
                     phase: float = 0.0, seed: "Seed" = 0,
                     start: float = 0.0) -> np.ndarray:
    """Sinusoidal-rate Poisson arrivals (the day/night load curve).

    Instantaneous rate ``base_rate * (1 + amplitude * sin(2πt/period +
    phase))``, sampled by thinning against the peak rate, so the output
    is an exact inhomogeneous Poisson draw.
    """
    if not 0.0 <= amplitude <= 1.0:
        raise ValueError(f"amplitude must be in [0, 1], got {amplitude}")
    if base_rate <= 0 or period_s <= 0:
        raise ValueError("base_rate and period_s must be positive")
    rng = np.random.default_rng(seed)
    rate_max = base_rate * (1.0 + amplitude)
    out: list[float] = []
    t = 0.0
    while True:
        t += rng.exponential(1.0 / rate_max)
        if t >= horizon:
            break
        r = base_rate * (1.0 + amplitude
                         * np.sin(2.0 * np.pi * t / period_s + phase))
        if rng.random() * rate_max < r:
            out.append(t)
    return start + np.asarray(out, np.float64)
