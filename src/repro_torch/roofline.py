"""Three-term roofline of one step on one device (the port of
``repro.roofline``), for the H100:

    compute_term    = FLOPs / peak FLOP/s                       (per card)
    memory_term     = bytes / HBM bandwidth                     (per card)
    collective_term = collective bytes / link bandwidth         (per card)

The reference reads its terms from compiled XLA (``cost_analysis()`` and
the HLO text, ``roofline_hlo.py``).  The port has no HLO: :func:`analyze`
takes a per-device record of the step's work, which
``repro_torch.launch.dryrun`` measures by running a rank's step on meta
tensors:

  * ``flops`` — ``torch.utils.flop_counter.FlopCounterMode`` over every
    op that runs (so loops and recomputation count as often as they run):
    ATen's products, and the CUDA kernels' custom ops by the formulas of
    ``repro_torch.kernels.work`` registered for them;
  * ``bytes`` — the bytes the step must move: each input read once and
    each output written once (parameters, AdamW's moments, the batch, the
    cache);
  * ``collectives`` — the result bytes of each collective the step issues,
    per kind, counted where ``repro_torch.distributed.collectives`` issues
    it.

So the bound is a lower bound of the step's time on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.hw import DeviceSpec

# NVIDIA H100 SXM (the data sheet; dense rates at 700 W): 989 TFLOP/s bf16
# on the tensor cores, 67 TFLOP/s f32 outside them, 80 GB of HBM3 at
# 3.35 TB/s, NVLink 900 GB/s per card in both directions together
# (450 GB/s each way).  Kept out of ``repro_torch.hw``'s tables, which the
# profiling predictors read.
H100_SXM = DeviceSpec(
    name="h100-sxm",
    kind="gpu",
    isa="sm_90a",
    peak_flops=989e12,
    peak_flops_f32=67e12,
    hbm_bytes=80e9,
    hbm_bw=3.35e12,
    link_bw=450e9,
    clock_ghz=1.98,
    vmem_bytes=50 * 2**20,          # L2
    tdp_watts=700,
)


@dataclasses.dataclass
class Roofline:
    name: str
    flops: float                    # per-device FLOPs
    hbm_bytes: float                # per-device bytes moved
    coll_bytes: float               # per-device collective bytes (result)
    coll_breakdown: dict
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float = 0.0        # 6·N·D useful flops (global)
    chips: int = 1

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> Optional[float]:
        """MODEL_FLOPS / global FLOPs — catches recomputation and
        redundancy (the port's compute over "model" is replicated)."""
        if not self.model_flops or not self.flops:
            return None
        return self.model_flops / (self.flops * self.chips)

    def row(self) -> dict:
        return {
            "name": self.name,
            "flops_per_chip": self.flops,
            "hbm_bytes_per_chip": self.hbm_bytes,
            "coll_bytes_per_chip": self.coll_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bound_s": self.bound_s,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
            "coll_breakdown": self.coll_breakdown,
        }


def analyze(name: str, costs: dict, *, chips: int,
            model_flops: float = 0.0, hw: DeviceSpec = H100_SXM
            ) -> Roofline:
    """Three-term roofline from ``costs = {"flops", "bytes",
    "collectives": {kind: bytes}}`` of one device's step."""
    coll = {k: v for k, v in costs.get("collectives", {}).items() if v}
    total_coll = float(sum(coll.values()))
    flops, byts = float(costs["flops"]), float(costs["bytes"])
    return Roofline(
        name=name,
        flops=flops,
        hbm_bytes=byts,
        coll_bytes=total_coll,
        coll_breakdown=coll,
        compute_s=flops / hw.peak_flops,
        memory_s=byts / hw.hbm_bw,
        collective_s=total_coll / hw.link_bw,
        model_flops=model_flops,
        chips=chips,
    )


def model_flops_estimate(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE); 2·N·D for inference
    forward, 2·N_active per decoded token."""
    from repro_torch.models import build_model, param_count
    shapes = build_model(cfg).param_shapes()
    n = param_count(shapes)
    if cfg.family == "hybrid":
        # the reference stores (and counts) identity Mamba slots that pad
        # the last group to K layers; the port skips them
        k = cfg.shared_attn_every
        n += ((-cfg.num_layers) % k) * param_count(shapes["mamba"][0])
    if cfg.num_experts:
        # active params: replace routed-expert count with top_k
        expert = 3 * cfg.d_model * cfg.moe_d_ff * cfg.num_experts \
            * cfg.num_layers
        active_expert = expert * cfg.top_k / cfg.num_experts
        n = n - expert + active_expert
    tokens = shape.tokens if shape.mode != "decode" else shape.global_batch
    mult = 6.0 if shape.mode == "train" else 2.0
    return mult * n * tokens
