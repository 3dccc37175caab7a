"""Computation offloading policies (paper §II-C), the port of
``repro.core.offload``.

Split computing: the first ``s`` layers of a network run on the device, the
activation at the split crosses the link, the remaining layers run on the
edge server.  Policies, host numpy code as in the reference:

  * ``local_only`` / ``remote_only`` — degenerate baselines
  * ``greedy``   — walk split points until the marginal move stops helping
  * ``optimal``  — exact: evaluate all L+1 split points (O(L))
  * ``QLearningPolicy`` — tabular DRL over stochastic link states

:func:`split_times_all` evaluates every split latency in O(L) via
forward/backward prefix sums; the ``*_ref`` variants keep the scalar loops
as oracles for the equivalence tests.  Batched sweeps over many
environments, on a torch device, live in :mod:`repro_torch.core.decisions`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.hw import DeviceSpec


@dataclasses.dataclass(frozen=True)
class LayerCost:
    """Static per-layer profile (per batch)."""
    name: str
    flops: float                 # compute cost of the layer
    act_bytes: float             # activation size flowing OUT of the layer
    param_bytes: float = 0.0


@dataclasses.dataclass(frozen=True)
class OffloadEnv:
    device: DeviceSpec
    edge: DeviceSpec
    link_bw: float               # bytes/s currently available
    link_latency_s: float = 0.005
    input_bytes: float = 0.0     # bytes to ship if split at 0 (raw input)


DEFAULT_EFFICIENCY = 0.35            # effective MFU of the analytic model


def layer_time(flops: float, dev: DeviceSpec,
               efficiency: float = DEFAULT_EFFICIENCY) -> float:
    """Simple effective-throughput model (efficiency ≈ measured MFU)."""
    return flops / (dev.peak_flops_f32 * efficiency)


@dataclasses.dataclass
class SplitDecision:
    split: int                   # layers [0, split) on device, rest on edge
    total_time_s: float
    device_time_s: float
    transfer_time_s: float
    edge_time_s: float


def split_time(layers: Sequence[LayerCost], split: int, env: OffloadEnv,
               time_fn: Optional[Callable[[LayerCost, DeviceSpec], float]]
               = None) -> SplitDecision:
    """Latency of executing with the given split point (0..L)."""
    time_fn = time_fn or (lambda lc, dev: layer_time(lc.flops, dev))
    dev_t = sum(time_fn(lc, env.device) for lc in layers[:split])
    edge_t = sum(time_fn(lc, env.edge) for lc in layers[split:])
    if split == len(layers):
        xfer = 0.0
    else:
        xfer_bytes = (layers[split - 1].act_bytes if split > 0
                      else env.input_bytes)
        xfer = env.link_latency_s + xfer_bytes / max(env.link_bw, 1.0)
    return SplitDecision(split, dev_t + xfer + edge_t, dev_t, xfer, edge_t)


def local_only(layers, env, **kw) -> SplitDecision:
    return split_time(layers, len(layers), env, **kw)


def remote_only(layers, env, **kw) -> SplitDecision:
    return split_time(layers, 0, env, **kw)


# --------------------------------------------------------------------------
# Vectorized all-splits evaluation: O(L) prefix sums instead of O(L²)
# --------------------------------------------------------------------------
def layer_time_vector(layers: Sequence[LayerCost], dev: DeviceSpec,
                      time_fn: Optional[Callable[[LayerCost, DeviceSpec],
                                                 float]] = None
                      ) -> np.ndarray:
    """Per-layer execution times on ``dev`` as a float64 ``[L]`` vector."""
    if time_fn is None:
        flops = np.fromiter((lc.flops for lc in layers), dtype=np.float64,
                            count=len(layers))
        return flops / (dev.peak_flops_f32 * DEFAULT_EFFICIENCY)
    return np.fromiter((time_fn(lc, dev) for lc in layers),
                       dtype=np.float64, count=len(layers))


def split_components(layers: Sequence[LayerCost], env: OffloadEnv,
                     time_fn=None
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(device, transfer, edge)`` time vectors, each ``[L+1]``, indexed by
    split point: forward prefix sum of device times, backward prefix sum of
    edge times, and the activation-transfer vector."""
    L = len(layers)
    t_dev = layer_time_vector(layers, env.device, time_fn)
    t_edge = layer_time_vector(layers, env.edge, time_fn)
    dev_cum = np.concatenate(([0.0], np.cumsum(t_dev)))
    edge_cum = np.concatenate((np.cumsum(t_edge[::-1])[::-1], [0.0]))
    xfer_bytes = np.concatenate(
        ([env.input_bytes], [lc.act_bytes for lc in layers]))
    xfer = env.link_latency_s + xfer_bytes / max(env.link_bw, 1.0)
    xfer[L] = 0.0                     # split == L ships nothing
    return dev_cum, xfer, edge_cum


def split_times_all(layers: Sequence[LayerCost], env: OffloadEnv,
                    time_fn=None) -> np.ndarray:
    """Total latency of *every* split point as a ``[L+1]`` vector, O(L)."""
    dev_cum, xfer, edge_cum = split_components(layers, env, time_fn)
    return dev_cum + xfer + edge_cum


def _decision_at(split: int, dev_cum, xfer, edge_cum) -> SplitDecision:
    return SplitDecision(int(split),
                         float(dev_cum[split] + xfer[split]
                               + edge_cum[split]),
                         float(dev_cum[split]), float(xfer[split]),
                         float(edge_cum[split]))


def optimal_split(layers, env, *, time_fn=None) -> SplitDecision:
    """Exact best split: argmin over :func:`split_times_all`."""
    comps = split_components(layers, env, time_fn)
    total = comps[0] + comps[1] + comps[2]
    return _decision_at(int(np.argmin(total)), *comps)


def optimal_split_ref(layers, env, **kw) -> SplitDecision:
    """Scalar O(L²) oracle retained for equivalence tests/benchmarks."""
    return min((split_time(layers, s, env, **kw)
                for s in range(len(layers) + 1)),
               key=lambda d: d.total_time_s)


def greedy_split(layers, env, *, time_fn=None) -> SplitDecision:
    """Start local-only; move the split point while it helps — a scan over
    the precomputed all-splits vector (one O(L) pass, no re-summation)."""
    comps = split_components(layers, env, time_fn)
    total = comps[0] + comps[1] + comps[2]
    best = len(layers)
    for s in range(len(layers) - 1, -1, -1):
        if total[s] <= total[best]:
            best = s
        else:
            break
    return _decision_at(best, *comps)


def greedy_split_ref(layers, env, **kw) -> SplitDecision:
    """Scalar oracle for :func:`greedy_split` (original walk)."""
    best = local_only(layers, env, **kw)
    for s in range(len(layers) - 1, -1, -1):
        cand = split_time(layers, s, env, **kw)
        if cand.total_time_s <= best.total_time_s:
            best = cand
        else:
            break
    return best


# --------------------------------------------------------------------------
# Tabular Q-learning over stochastic link states (the DRL controller)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class QLearningPolicy:
    """State = discretised link bandwidth bucket; action = split point."""
    layers: Sequence[LayerCost]
    env_base: OffloadEnv
    link_buckets: tuple = (0.125e9 / 16, 0.125e9 / 4, 0.125e9, 1.25e9)
    episodes: int = 3000
    alpha: float = 0.2
    gamma: float = 0.0           # contextual bandit: immediate latency
    eps: float = 0.2
    seed: int = 0

    def __post_init__(self):
        self.n_actions = len(self.layers) + 1
        self.q_ = np.zeros((len(self.link_buckets), self.n_actions))

    def _env_for(self, bucket: int) -> OffloadEnv:
        return dataclasses.replace(self.env_base,
                                   link_bw=self.link_buckets[bucket])

    def latency_table(self) -> np.ndarray:
        """``[n_buckets, n_actions]`` latency of every (link state, split)."""
        return np.stack([split_times_all(self.layers, self._env_for(b))
                         for b in range(len(self.link_buckets))])

    def train(self, batch_size: int = 256) -> "QLearningPolicy":
        """Table-driven training: rewards come from a precomputed
        ``[n_buckets, n_actions]`` latency table and episodes run in
        vectorized batches (greedy actions frozen per batch).  Within a
        batch the k repeated updates of one ``(s, a)`` cell collapse to
        the exact closed form ``q ← r + (1-α)^k (q - r)`` because the
        reward of a cell is deterministic.

        The batch size is capped so the number of greedy refreshes
        (``episodes / batch``) stays ≥ 2× the action count: with
        negative rewards and optimistic-zero init, greedy exploration
        advances one action per refresh, so freezing it for too long
        leaves deep action spaces (large L) under-visited and the argmax
        biased toward under-trained cells."""
        rng = np.random.default_rng(self.seed)
        table = self.latency_table()
        reward = -table
        n_s, n_a = table.shape
        batch_size = int(np.clip(self.episodes // (2 * n_a), 1, batch_size))
        remaining = self.episodes
        while remaining > 0:
            m = min(batch_size, remaining)
            remaining -= m
            s = rng.integers(n_s, size=m)
            explore = rng.random(m) < self.eps
            a = np.where(explore, rng.integers(n_a, size=m),
                         np.argmax(self.q_[s], axis=1))
            counts = np.bincount(s * n_a + a,
                                 minlength=n_s * n_a).reshape(n_s, n_a)
            decay = (1.0 - self.alpha) ** counts
            self.q_ = np.where(counts > 0,
                               reward + decay * (self.q_ - reward),
                               self.q_)
        return self

    def decide(self, link_bw: float) -> SplitDecision:
        bucket = int(np.argmin([abs(link_bw - b) for b in self.link_buckets]))
        a = int(np.argmax(self.q_[bucket]))
        env = dataclasses.replace(self.env_base, link_bw=link_bw)
        return split_time(self.layers, a, env)

    def regret(self) -> float:
        """Mean latency gap to the optimal split across link states."""
        gaps = []
        for b in range(len(self.link_buckets)):
            env = self._env_for(b)
            learned = split_time(self.layers, int(np.argmax(self.q_[b])), env)
            best = optimal_split(self.layers, env)
            gaps.append(learned.total_time_s - best.total_time_s)
        return float(np.mean(gaps))


# --------------------------------------------------------------------------
# Per-layer costs for the Table-I workloads + assigned transformer archs
# --------------------------------------------------------------------------
def workload_layer_costs(wc, batch_size: Optional[int] = None
                         ) -> list[LayerCost]:
    """Analytic per-layer costs of a Table-I CNN/MLP (inference)."""
    from repro_torch.core.workloads import IMG, NCLASS
    bs = batch_size or wc.batch_size
    costs = []
    if wc.kind == "mlp":
        dims = [IMG * IMG] + list(wc.arch) + [NCLASS]
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            costs.append(LayerCost(
                f"fc{i}", flops=2.0 * bs * a * b,
                act_bytes=4.0 * bs * b, param_bytes=4.0 * a * b))
        return costs
    hw, c_in = IMG, 1
    for i, layer in enumerate(wc.arch):
        k, c_out = layer["kernel"], layer["out"]
        flops = 2.0 * bs * hw * hw * k * k * c_in * c_out
        if layer["pool"]:
            hw //= 2
        costs.append(LayerCost(
            f"conv{i}", flops=flops, act_bytes=4.0 * bs * hw * hw * c_out,
            param_bytes=4.0 * k * k * c_in * c_out))
        c_in = c_out
    costs.append(LayerCost(
        "head", flops=2.0 * bs * hw * hw * c_in * NCLASS,
        act_bytes=4.0 * bs * NCLASS,
        param_bytes=4.0 * hw * hw * c_in * NCLASS))
    return costs


def transformer_layer_costs(cfg, seq_len: int, batch_size: int
                            ) -> list[LayerCost]:
    """Analytic per-layer inference costs of an assigned architecture."""
    d, l = cfg.d_model, max(cfg.num_layers, 1)
    t = seq_len * batch_size
    attn_proj = 2.0 * t * d * (cfg.num_heads * cfg.head_dim) * 2
    attn_kv = 2.0 * t * d * (cfg.num_kv_heads * cfg.head_dim) * 2
    attn_scores = 2.0 * batch_size * cfg.num_heads * seq_len * seq_len \
        * cfg.head_dim * 2
    if cfg.num_experts:
        ff = 3 * 2.0 * t * d * cfg.moe_d_ff * (cfg.top_k
                                               + cfg.num_shared_experts)
    elif cfg.d_ff:
        n_mat = 2 if cfg.mlp_act in ("gelu_plain", "relu2") else 3
        ff = n_mat * 2.0 * t * d * cfg.d_ff
    else:
        ff = 2.0 * t * d * d * 4     # xlstm-style block projections
    per_layer = attn_proj + attn_kv + attn_scores + ff
    act = 2.0 * t * d
    return [LayerCost(f"layer{i}", flops=per_layer, act_bytes=act)
            for i in range(l)]
