"""Hardware specification tables (the port's own copy of ``repro.hw.specs``).

The paper's thesis is that edge AI systems are *heterogeneous* — devices
differ in ISA, clock, accelerator and link speed, and any offloading decision
must be grounded in per-device capability numbers.  The values are the
reference package's, unchanged, so features built from them feed the
profiling model exactly the inputs it was trained on there.  Used by:

  * ``repro_torch.core.offload``  — edge-device specs for split computing.
  * ``repro_torch.core.costs``    — hardware features fed to the profiling
    model (``DeviceSpec.as_features``).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """Capability description of one compute device (chip or edge node)."""

    name: str
    kind: str                   # "tpu" | "gpu" | "cpu"
    isa: str                    # "tpu-v5e" | "x86" | "arm" ...
    peak_flops: float           # peak FLOP/s at the preferred dtype
    peak_flops_f32: float       # peak FLOP/s at f32
    hbm_bytes: float            # accelerator memory capacity (bytes)
    hbm_bw: float               # memory bandwidth, bytes/s
    link_bw: float              # per-link interconnect bandwidth, bytes/s
    clock_ghz: float            # nominal clock (paper uses this as a feature)
    vmem_bytes: float = 0.0     # on-chip scratch (VMEM / SMEM / L2)
    tdp_watts: float = 0.0

    def as_features(self) -> dict[str, float]:
        """Hardware features for the profiling predictor (paper §II-A)."""
        return {
            "hw_peak_flops": self.peak_flops,
            "hw_hbm_bw": self.hbm_bw,
            "hw_link_bw": self.link_bw,
            "hw_clock_ghz": self.clock_ghz,
            "hw_mem_bytes": self.hbm_bytes,
            "hw_is_accelerated": 1.0 if self.kind in ("tpu", "gpu") else 0.0,
            "hw_tdp_watts": self.tdp_watts,
        }


# --- TPU v5e: the production target of this framework -----------------------
# Constants mandated by the assignment: 197 TFLOP/s bf16, 819 GB/s HBM,
# ~50 GB/s per ICI link.
TPU_V5E = DeviceSpec(
    name="tpu-v5e",
    kind="tpu",
    isa="tpu-v5e",
    peak_flops=197e12,
    peak_flops_f32=98.5e12,
    hbm_bytes=16 * 2**30,
    hbm_bw=819e9,
    link_bw=50e9,
    clock_ghz=1.7,
    vmem_bytes=128 * 2**20,
    tdp_watts=250,
)

# --- Edge devices for the paper-faithful offloading simulation ---------------
# The paper's own testbed: Dell XPS 15, Intel Core i5 + NVIDIA GTX 1650.
XPS15_I5 = DeviceSpec(
    name="xps15-i5",
    kind="cpu",
    isa="x86",
    peak_flops=230e9,           # ~8c AVX2 FMA at boost
    peak_flops_f32=230e9,
    hbm_bytes=16 * 2**30,
    hbm_bw=40e9,
    link_bw=0.125e9,            # 1 Gb/s NIC
    clock_ghz=3.5,
    tdp_watts=45,
)

GTX_1650 = DeviceSpec(
    name="gtx-1650",
    kind="gpu",
    isa="cuda-turing",
    peak_flops=5.9e12,          # fp16
    peak_flops_f32=2.95e12,
    hbm_bytes=4 * 2**30,
    hbm_bw=128e9,
    link_bw=0.125e9,
    clock_ghz=1.49,
    tdp_watts=75,
)

# Heterogeneous extreme-edge devices (paper §I: "1.5GHz vs 3.5GHz, X86 vs ARM")
PI5_ARM = DeviceSpec(
    name="pi5-arm",
    kind="cpu",
    isa="arm",
    peak_flops=30e9,
    peak_flops_f32=30e9,
    hbm_bytes=8 * 2**30,
    hbm_bw=17e9,
    link_bw=0.125e9,
    clock_ghz=2.4,
    tdp_watts=12,
)

JETSON_ORIN_NANO = DeviceSpec(
    name="jetson-orin-nano",
    kind="gpu",
    isa="cuda-ampere",
    peak_flops=20e12,           # sparse int8 marketing → ~10 TF fp16 dense
    peak_flops_f32=2.5e12,
    hbm_bytes=8 * 2**30,
    hbm_bw=68e9,
    link_bw=0.125e9,
    clock_ghz=0.625,
    tdp_watts=15,
)

EDGE_SERVER_A100 = DeviceSpec(
    name="edge-server-a100",
    kind="gpu",
    isa="cuda-ampere",
    peak_flops=312e12,
    peak_flops_f32=19.5e12,
    hbm_bytes=40 * 2**30,
    hbm_bw=1555e9,
    link_bw=1.25e9,             # 10 Gb/s uplink to the edge site
    clock_ghz=1.41,
    tdp_watts=400,
)

EDGE_DEVICES: dict[str, DeviceSpec] = {
    d.name: d
    for d in (XPS15_I5, GTX_1650, PI5_ARM, JETSON_ORIN_NANO, EDGE_SERVER_A100)
}

ALL_DEVICES: dict[str, DeviceSpec] = {**EDGE_DEVICES, TPU_V5E.name: TPU_V5E}


def get_device(name: str) -> DeviceSpec:
    try:
        return ALL_DEVICES[name]
    except KeyError as e:
        raise KeyError(
            f"unknown device {name!r}; known: {sorted(ALL_DEVICES)}"
        ) from e
