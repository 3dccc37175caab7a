"""Finite-capacity edge contention: server pools, heavy-tailed RTT — the
port of ``repro.sim.queueing``.

The simulators in :mod:`repro_torch.sim` historically modelled every node as
infinite-capacity: the scalar ``avail`` vector is a 1-server queue over
*believed* finish times, and network delay is a deterministic
``latency + bytes / bw`` term.  This module adds the missing contention
layer:

``ServerPool``
    a c-server FIFO queue per node tracking *realised* busy-until times,
    so sojourn = wait + service (+ transfer) and M/M/c statistics come
    out exactly;

``NodePools``
    a fleet of pools with an incrementally-maintained availability
    vector (the schedulers' hot path) plus a full ``recompute_avail``
    for cross-checking;

``WeibullRTT`` / ``LognormalRTT``
    seeded heavy-tailed network round-trip processes with closed-form
    ``mean`` / ``percentile`` / ``cvar`` (no scipy — the lognormal
    quantile uses the Acklam inverse-normal approximation and the CVaR
    closed form uses :func:`math.erf`);

``erlang_c`` / ``mm1_sojourn`` / ``mmc_sojourn``
    the queueing-theory closed forms the validation tests pin against.

Pool state is sequential host state, as the scheduler's heap is: it stays
numpy, and every process draws from ``np.random.default_rng`` seeded as
the reference seeds it, so the same seed gives the same draws bit for
bit.

All random processes accept ``int | np.random.SeedSequence`` seeds.
Passing an ``int`` reproduces the historical ``default_rng(int)``
stream bit-for-bit (``default_rng`` builds ``SeedSequence(int)``
internally); passing a spawned child keeps new processes statistically
independent of existing ones without perturbing them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Union

import numpy as np

from repro_torch.obs.trace import NULL_TRACER

Seed = Union[int, np.random.SeedSequence]

__all__ = [
    "ServerPool",
    "NodePools",
    "DelayProcess",
    "WeibullRTT",
    "LognormalRTT",
    "erlang_c",
    "mm1_sojourn",
    "mmc_sojourn",
    "spawn_streams",
]


def spawn_streams(seed: Seed, n: int) -> list[np.random.SeedSequence]:
    """``n`` independent child seed sequences of the run seed.

    Every stochastic process in a simulation should draw from its own
    child: adding a new process then consumes fresh entropy instead of
    shifting the draws of existing ones.
    """
    ss = seed if isinstance(seed, np.random.SeedSequence) \
        else np.random.SeedSequence(seed)
    return list(ss.spawn(int(n)))


# ---------------------------------------------------------------------------
# server pools


class ServerPool:
    """A c-server FIFO queue tracking realised busy-until times.

    ``capacity=None`` means infinite servers: admission never waits and
    the pool only records utilisation.  ``capacity=1`` with
    deterministic service reproduces the schedulers' historical scalar
    ``avail`` bookkeeping bit-for-bit (start = max(busy, now)).
    """

    __slots__ = ("capacity", "busy", "_infinite_busy", "_busy_area",
                 "_queue_area", "_last_t", "n_admitted")

    def __init__(self, capacity: Optional[int] = None,
                 available_at: float = 0.0) -> None:
        if capacity is not None and int(capacity) < 1:
            raise ValueError(f"capacity must be >= 1 or None, "
                             f"got {capacity}")
        self.capacity = None if capacity is None else int(capacity)
        if self.capacity is None:
            self.busy = np.zeros(0, dtype=np.float64)
        else:
            self.busy = np.full(self.capacity, float(available_at),
                                dtype=np.float64)
        self._infinite_busy: list[float] = []
        self._busy_area = 0.0    # integral of in-service count over time
        self._queue_area = 0.0   # integral of waiting count over time
        self._last_t = float(available_at)
        self.n_admitted = 0

    # -- state ------------------------------------------------------------

    def next_free(self) -> float:
        """Earliest time any server frees up (realised)."""
        if self.capacity is None:
            return 0.0
        return float(self.busy.min())

    def wait(self, now: float) -> float:
        """Queueing delay a task arriving at ``now`` would incur."""
        if self.capacity is None:
            return 0.0
        return max(0.0, float(self.busy.min()) - float(now))

    def queue_len(self, now: float) -> int:
        """Number of servers that are busy strictly past ``now``."""
        if self.capacity is None:
            t = float(now)
            return sum(1 for b in self._infinite_busy if b > t)
        return int(np.count_nonzero(self.busy > float(now)))

    def utilisation(self, now: float) -> float:
        """Time-averaged fraction of servers busy on [start, now]."""
        if self.capacity is None or float(now) <= 0.0:
            return 0.0
        self._accrue(float(now))
        span = float(now) - 0.0
        if span <= 0.0:
            return 0.0
        return self._busy_area / (span * self.capacity)

    def mean_queue_len(self, now: float) -> float:
        """Time-averaged number of tasks waiting (not in service)."""
        if self.capacity is None or float(now) <= 0.0:
            return 0.0
        self._accrue(float(now))
        return self._queue_area / float(now)

    # -- admission --------------------------------------------------------

    def _accrue(self, t: float) -> None:
        if self.capacity is None or t <= self._last_t:
            return
        # piecewise-constant between events: count servers busy past
        # _last_t, integrate until min(their finish, t) step by step.
        lo, hi = self._last_t, t
        times = np.unique(np.clip(self.busy, lo, hi))
        prev = lo
        for edge in times:
            e = float(edge)
            if e <= prev:
                continue
            n_busy = int(np.count_nonzero(self.busy >= e))
            self._busy_area += (e - prev) * n_busy
            prev = e
        if prev < hi:
            n_busy = int(np.count_nonzero(self.busy > hi))
            self._busy_area += (hi - prev) * n_busy
        self._last_t = t

    def admit(self, now: float, service_s: float) -> tuple[float, float]:
        """Admit a task arriving at ``now`` needing ``service_s``.

        Returns ``(start, finish)``: the task starts when the earliest
        server frees (FIFO, first-index tie-break) and occupies it for
        ``service_s``.  Busy-until state is *realised* — callers pass
        the realised service time, not the believed one.
        """
        now = float(now)
        service_s = float(service_s)
        self.n_admitted += 1
        if self.capacity is None:
            start = now
            finish = now + service_s
            self._infinite_busy.append(finish)
            if len(self._infinite_busy) > 4096:
                self._infinite_busy = [
                    b for b in self._infinite_busy if b > now]
            return start, finish
        self._accrue(now)
        k = int(np.argmin(self.busy))
        start = max(float(self.busy[k]), now)
        if start > now:
            self._queue_area += (start - now)  # this task waits 1 * w
            # waiting happens in the future; fold into queue integral
            # directly (exact for per-task waiting-time accounting).
        finish = start + service_s
        self.busy[k] = finish
        return start, finish


class NodePools:
    """Server pools for a fleet of nodes + cached availability vector.

    ``avail`` mirrors what :class:`~repro_torch.sim.stream.StreamScheduler`
    keeps today — per-node earliest-free time — but derived from
    realised pool state and updated *incrementally* on each admit
    (``O(c)`` per event) rather than recomputed across all nodes
    (``O(N·c)``, see :meth:`recompute_avail`; the benchmark pins the
    incremental path is not slower).
    """

    def __init__(self, pools: Sequence[ServerPool]) -> None:
        self.pools = list(pools)
        self.obs = NULL_TRACER                   # set by simulate_stream
        self.avail = np.array([p.next_free() for p in self.pools],
                              dtype=np.float64)

    @classmethod
    def uniform(cls, n_nodes: int, capacity: Optional[int],
                available_at: float = 0.0) -> "NodePools":
        return cls([ServerPool(capacity, available_at)
                    for _ in range(int(n_nodes))])

    def __len__(self) -> int:
        return len(self.pools)

    def wait(self, j: int, now: float) -> float:
        return self.pools[j].wait(now)

    def waits(self, now: float) -> np.ndarray:
        return np.maximum(self.avail - float(now), 0.0)

    def admit(self, j: int, now: float,
              service_s: float) -> tuple[float, float]:
        start, finish = self.pools[j].admit(now, service_s)
        self.avail[j] = self.pools[j].next_free()
        if self.obs.enabled and start > now:
            self.obs.instant(f"pool@{j}", "pool_wait", float(now),
                             args={"wait_s": start - now})
        return start, finish

    def recompute_avail(self) -> np.ndarray:
        """Full O(N·c) recompute — correctness cross-check for the
        incrementally-maintained ``avail`` cache."""
        return np.array([p.next_free() for p in self.pools],
                        dtype=np.float64)

    def utilisation(self, now: float) -> np.ndarray:
        return np.array([p.utilisation(now) for p in self.pools],
                        dtype=np.float64)

    def saturated(self, now: float, threshold: float = 0.9) -> np.ndarray:
        """Boolean mask of pools whose utilisation exceeds threshold."""
        return self.utilisation(now) > float(threshold)


# ---------------------------------------------------------------------------
# heavy-tailed delay processes

# Acklam's rational approximation to the inverse normal CDF (|eps| <
# 1.15e-9 over (0, 1)) — avoids a scipy dependency for the lognormal
# quantile.
_ACK_A = (-3.969683028665376e+01, 2.209460984245205e+02,
          -2.759285104469687e+02, 1.383577518672690e+02,
          -3.066479806614716e+01, 2.506628277459239e+00)
_ACK_B = (-5.447609879822406e+01, 1.615858368580409e+02,
          -1.556989798598866e+02, 6.680131188771972e+01,
          -1.328068155288572e+01)
_ACK_C = (-7.784894002430293e-03, -3.223964580411365e-01,
          -2.400758277161838e+00, -2.549732539343734e+00,
          4.374664141464968e+00, 2.938163982698783e+00)
_ACK_D = (7.784695709041462e-03, 3.224671290700398e-01,
          2.445134137142996e+00, 3.754408661907416e+00)


def _norm_ppf(p: float) -> float:
    """Inverse standard-normal CDF (Acklam approximation)."""
    if not 0.0 < p < 1.0:
        raise ValueError(f"p must be in (0, 1), got {p}")
    a, b, c, d = _ACK_A, _ACK_B, _ACK_C, _ACK_D
    p_low, p_high = 0.02425, 1.0 - 0.02425
    if p < p_low:
        q = math.sqrt(-2.0 * math.log(p))
        return (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q
                 + c[4]) * q + c[5]) / \
               ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1.0)
    if p > p_high:
        q = math.sqrt(-2.0 * math.log(1.0 - p))
        return -(((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q
                  + c[4]) * q + c[5]) / \
               ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1.0)
    q = p - 0.5
    r = q * q
    return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r
             + a[4]) * r + a[5]) * q / \
           (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r
             + b[4]) * r + 1.0)


def _norm_cdf(x: float) -> float:
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


class DelayProcess:
    """Protocol for seeded delay distributions (duck-typed).

    Implementations provide ``sample(n)``, ``mean()``,
    ``percentile(q)`` and ``cvar(alpha)``.
    """

    def sample(self, n: int = 1) -> np.ndarray:  # pragma: no cover
        raise NotImplementedError

    def mean(self) -> float:  # pragma: no cover
        raise NotImplementedError

    def percentile(self, q: float) -> float:  # pragma: no cover
        raise NotImplementedError

    def cvar(self, alpha: float) -> float:  # pragma: no cover
        raise NotImplementedError

    def tail_stat(self, tail: str, alpha: float) -> float:
        """Dispatch helper: ``"p99"`` → percentile, ``"cvar"`` → CVaR."""
        if tail == "p99":
            return self.percentile(0.99)
        if tail == "cvar":
            return self.cvar(alpha)
        raise ValueError(f"unknown tail statistic {tail!r}; "
                         f"expected 'p99' or 'cvar'")


@dataclass
class WeibullRTT(DelayProcess):
    """Weibull-distributed round-trip delay, ``shape < 1`` heavy-tailed.

    ``sample`` draws ``scale * Weibull(shape)`` seconds.  Closed forms:
    mean = scale * Γ(1 + 1/shape); quantile
    ``scale * (-ln(1-q))^(1/shape)``; CVaR by trapezoidal quantile
    integration (the Weibull CVaR has no elementary closed form).
    """

    shape: float = 0.7
    scale: float = 0.01
    seed: Seed = 0

    def __post_init__(self) -> None:
        if self.shape <= 0.0 or self.scale < 0.0:
            raise ValueError("shape must be > 0 and scale >= 0")
        self._rng = np.random.default_rng(self.seed)

    def sample(self, n: int = 1) -> np.ndarray:
        return self.scale * self._rng.weibull(self.shape, size=int(n))

    def mean(self) -> float:
        return self.scale * math.gamma(1.0 + 1.0 / self.shape)

    def percentile(self, q: float) -> float:
        if not 0.0 <= q < 1.0:
            raise ValueError(f"q must be in [0, 1), got {q}")
        return self.scale * (-math.log(1.0 - q)) ** (1.0 / self.shape)

    def cvar(self, alpha: float = 0.99, n_grid: int = 512) -> float:
        if not 0.0 < alpha < 1.0:
            raise ValueError(f"alpha must be in (0, 1), got {alpha}")
        # CVaR_a = 1/(1-a) * ∫_a^1 quantile(u) du, trapezoid on a
        # uniform u-grid clipped just below 1.
        hi = 1.0 - (1.0 - alpha) * 1e-6
        us = np.linspace(alpha, hi, int(n_grid))
        qs = self.scale * (-np.log1p(-us)) ** (1.0 / self.shape)
        trapezoid = getattr(np, "trapezoid", np.trapz)
        return float(trapezoid(qs, us) / (hi - alpha))


@dataclass
class LognormalRTT(DelayProcess):
    """Lognormal round-trip delay — exp(N(mu, sigma^2)) seconds.

    All of mean / percentile / CVaR are closed-form:
    mean = exp(mu + sigma^2/2); quantile = exp(mu + sigma * z_q);
    CVaR_a = mean * Phi(sigma - z_a) / (1 - a).
    """

    mu: float = -5.0
    sigma: float = 1.0
    seed: Seed = 0

    def __post_init__(self) -> None:
        if self.sigma <= 0.0:
            raise ValueError("sigma must be > 0")
        self._rng = np.random.default_rng(self.seed)

    def sample(self, n: int = 1) -> np.ndarray:
        return self._rng.lognormal(self.mu, self.sigma, size=int(n))

    def mean(self) -> float:
        return math.exp(self.mu + 0.5 * self.sigma * self.sigma)

    def percentile(self, q: float) -> float:
        if not 0.0 < q < 1.0:
            raise ValueError(f"q must be in (0, 1), got {q}")
        return math.exp(self.mu + self.sigma * _norm_ppf(q))

    def cvar(self, alpha: float = 0.99) -> float:
        if not 0.0 < alpha < 1.0:
            raise ValueError(f"alpha must be in (0, 1), got {alpha}")
        z = _norm_ppf(alpha)
        return self.mean() * _norm_cdf(self.sigma - z) / (1.0 - alpha)


# ---------------------------------------------------------------------------
# queueing-theory closed forms (validation targets)


def erlang_c(c: int, a: float) -> float:
    """Erlang-C: P(wait > 0) for an M/M/c queue with offered load a.

    ``a = lambda / mu`` (erlangs); requires ``a < c`` for stability.
    """
    c = int(c)
    if c < 1:
        raise ValueError(f"c must be >= 1, got {c}")
    if not 0.0 <= a < c:
        raise ValueError(f"offered load a={a} must satisfy 0 <= a < c")
    if a == 0.0:
        return 0.0
    # sum_{k=0}^{c-1} a^k/k! computed iteratively to avoid overflow
    term = 1.0
    s = 1.0
    for k in range(1, c):
        term *= a / k
        s += term
    term_c = term * a / c  # a^c / c!
    top = term_c * c / (c - a)
    return top / (s + top)


def mm1_sojourn(lam: float, mu: float) -> float:
    """Mean sojourn (wait + service) for M/M/1: 1 / (mu - lambda)."""
    if lam >= mu:
        raise ValueError(f"unstable: lambda={lam} >= mu={mu}")
    return 1.0 / (mu - lam)


def mmc_sojourn(lam: float, mu: float, c: int) -> float:
    """Mean sojourn for M/M/c: Erlang-C wait + service.

    W = C(c, a) / (c*mu - lambda) + 1/mu, with a = lambda/mu.
    """
    a = lam / mu
    if a >= c:
        raise ValueError(f"unstable: offered load {a} >= c={c}")
    wq = erlang_c(int(c), a) / (c * mu - lam)
    return wq + 1.0 / mu
