"""Split-computing types and per-layer costs (paper §II-C).

Split computing: the first ``s`` layers of a network run on the device, the
activation at the split crosses the link, the remaining layers run on the
edge server.  This is the slice of ``repro.core.offload`` that the decision
path needs: the layer/environment/decision records, the analytic layer-time
model and the per-layer costs of the assigned transformer architectures.
Batched sweeps over many environments live in
:mod:`repro_torch.core.decisions`.
"""
from __future__ import annotations

import dataclasses

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
