"""Featurisation of profiling records (paper §II-A).

The port of ``repro.core.features``, in numpy as there: maps (model type,
hyperparameters, hardware, dataset) → a fixed-width feature vector for the
regression models, the reference's columns in the reference's order.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.profiler import ProfileRecord
from repro_torch.core.workloads import CNN_TYPES, MLP_TYPES, OPTIMISERS
from repro_torch.data.synthetic import TabularDataset

FEATURE_NAMES = [
    # model type
    "is_cnn", "is_mlp", "depth", "width_sum", "width_max", "log_params",
    # hyperparameters
    "log_lr", "batch_size", "epochs",
    *(f"opt_{o}" for o in OPTIMISERS),
    # dataset
    "log_dataset_size",
    # hardware
    "log_hw_peak_flops", "log_hw_hbm_bw", "log_hw_link_bw", "hw_clock_ghz",
    "hw_is_accelerated", "hw_tdp_watts",
]

TARGET_NAMES = ["flops", "macs", "total_time"]
#: the optional resource-utilisation targets (paper abstract: predict
#: "execution time and resource utilization"), selectable via targets=
EXTENDED_TARGET_NAMES = TARGET_NAMES + ["step_time", "peak_bytes"]


def featurize(rec: ProfileRecord) -> np.ndarray:
    cfg = rec.config
    kind = cfg["kind"]
    if kind == "cnn":
        arch = CNN_TYPES[cfg["type_idx"]]
        widths = [l["out"] for l in arch]
    else:
        widths = list(MLP_TYPES[cfg["type_idx"]])
    hw = rec.hardware
    feats = [
        1.0 if kind == "cnn" else 0.0,
        1.0 if kind == "mlp" else 0.0,
        float(len(widths)),
        float(sum(widths)),
        float(max(widths)),
        float(np.log10(max(rec.param_count, 1))),
        float(np.log10(cfg["lr"])),
        float(cfg["batch_size"]),
        float(cfg["epochs"]),
        *(1.0 if cfg["optimiser"] == o else 0.0 for o in OPTIMISERS),
        float(np.log10(max(cfg["dataset_size"], 1))),
        float(np.log10(hw["hw_peak_flops"])),
        float(np.log10(hw["hw_hbm_bw"])),
        float(np.log10(max(hw["hw_link_bw"], 1.0))),
        float(hw["hw_clock_ghz"]),
        float(hw["hw_is_accelerated"]),
        float(hw.get("hw_tdp_watts", 0.0)),   # absent in pre-energy records
    ]
    return np.asarray(feats, np.float32)


def targets_of(rec: ProfileRecord, targets=None) -> np.ndarray:
    """Target vector for one record.  ``targets`` selects/reorders the
    columns (default: the paper's :data:`TARGET_NAMES`; any subset of
    :data:`EXTENDED_TARGET_NAMES`)."""
    names = list(TARGET_NAMES if targets is None else targets)
    t = rec.targets(extended=True)
    unknown = set(names) - set(t)
    if unknown:
        raise KeyError(f"unknown target(s) {sorted(unknown)}; "
                       f"known: {sorted(t)}")
    return np.asarray([t[n] for n in names], np.float32)


def records_to_dataset(records: list[ProfileRecord], targets=None
                       ) -> TabularDataset:
    names = list(TARGET_NAMES if targets is None else targets)
    x = np.stack([featurize(r) for r in records])
    y = np.stack([targets_of(r, names) for r in records])
    return TabularDataset(x, y, list(FEATURE_NAMES), names)
