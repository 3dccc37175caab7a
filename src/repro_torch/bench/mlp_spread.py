"""How far the fig3 MLP's f32 training on a device drifts from the same
training on the CPU, beside the drift that a tiny change of the learning
rate causes on the CPU alone.  The tolerances of chip_smoke's MLP checks
are read off this.

    python -m repro_torch.bench.mlp_spread [--device cpu] [--seeds 12]
                                           [--records PATH]

Without ``--records`` it profiles the Table-I grid first (``generate(150
runs, 6 steps, seed 0)`` on the device), as chip_smoke's phase 3 does,
keeps the records in ``results/mlp_spread_records.json`` (a ``--records``
file for a later run) and fits on the normalised 80/20 split.  For each initial-weight seed:

  * ``one_step``: one full-batch Adam step on the device and on the CPU
    from the same weights; the median gap of the parameters'
    displacements over their median size (:func:`one_step_drift`);
  * ``two_epoch``: two epochs of 64-row batches on both; the largest
    prediction gap on the test rows over the largest prediction
    (:func:`two_epoch_drift`);
  * ``two_epoch_lr``: the same gap between two CPU fits whose learning
    rates differ by each of ``LR_NUDGES`` (relative; 1e-6 is about 8 f32
    ulps of lr = 1e-3), the drift of a change of about rounding size.

Adam over ReLU units amplifies a change of rounding size where a unit
sits at its kink for a row of a batch: its activation, near 0, is all
rounding, and Adam turns the tiny gradients of its weights into updates
of up to ``lr`` each.  So the two-epoch gaps range over orders of
magnitude from seed to seed, and so would a norm of the one-step gap (a
few hundred weights of one unit); its median is the other weights'
rounding, and a 1% change of lr moves it to 1e-2.
Rows go to ``results/bench_torch_mlp_spread.json`` and stdout.

With ``--fedavg`` it measures instead the federated profiling run that
chip_smoke's training phase holds card against CPU: ``run_fedavg`` at
the ``FedAvgConfig`` defaults (20 rounds, MLP (128, 64)) on the
normalised 80/20 split, five non-IID clients by hardware
(:func:`fedavg_clients`), without DP and with ``DPConfig()``.  Per seed
(``FedAvgConfig.seed``: the MLP's weights, the splits and the noise):

  * ``fedavg``: the largest relative gap of a round's federated RMSE,
    card against CPU (:func:`fedavg_drift`);
  * ``fedavg_lr``: the same gap between two CPU runs whose learning rates
    differ by each of ``LR_NUDGES``.

Rows go to ``results/bench_torch_fedavg_spread.json``.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core import dataset as ds
from repro_torch.core.features import records_to_dataset
from repro_torch.core.fl import (DPConfig, FedAvgConfig, run_fedavg,
                                 split_clients)
from repro_torch.core.predictors.mlp import MLPRegressor

FIG3_MLP = dict(hidden=(2048, 1024, 512), lr=1e-3)   # fig3_predictions.py
LR_NUDGES = (1e-6, 1e-5)       # relative changes of the CPU fit's lr
RESULTS = Path("results/bench_torch_mlp_spread.json")
FEDAVG_RESULTS = Path("results/bench_torch_fedavg_spread.json")
#: the hardware column that makes the clients non-IID
#: (``examples/fl_profiling.py``'s), one client per edge device
HW_COLUMN, N_CLIENTS = "log_hw_peak_flops", 5


def _displacement(x, y, device, **kw) -> torch.Tensor:
    """The fitted parameters less the initial ones, as one f64 vector."""
    start = MLPRegressor(**dict(kw, epochs=0)).fit(x, y, device="cpu")
    end = MLPRegressor(**kw).fit(x, y, device=device)
    return torch.cat([(end.params_[k].cpu().double() - v.double()).ravel()
                      for k, v in start.params_.items()])


def one_step_drift(x, y, *, device: DeviceLike = None, seed: int = 0,
                   lr_cpu: float | None = None, **mlp) -> float:
    """``median|d_dev - d_cpu| / median|d_cpu|`` for one full-batch step,
    where ``d`` is the parameters' displacement; the CPU's fit takes
    ``lr_cpu`` (default: the same learning rate)."""
    kw = dict(FIG3_MLP, **mlp, seed=seed, epochs=1, batch_size=len(x))
    d_dev = _displacement(x, y, resolve_device(device), **kw)
    if lr_cpu is not None:
        kw["lr"] = lr_cpu
    d_cpu = _displacement(x, y, "cpu", **kw)
    return float((d_dev - d_cpu).abs().median() / d_cpu.abs().median())


def two_epoch_drift(x, y, x_test, *, device: DeviceLike = None,
                    seed: int = 0, lr_cpu: float | None = None,
                    **mlp) -> float:
    """``max|p_dev - p_cpu| / max|p_cpu|`` on ``x_test`` after two epochs
    from the same initial weights over the same batches; the CPU's fit
    takes ``lr_cpu`` (default: the same learning rate)."""
    kw = dict(FIG3_MLP, **mlp, seed=seed, epochs=2)
    p_dev = MLPRegressor(**kw).fit(x, y, device=resolve_device(device)) \
        .predict(x_test, device=device).cpu().numpy()
    if lr_cpu is not None:
        kw["lr"] = lr_cpu
    p_cpu = MLPRegressor(**kw).fit(x, y, device="cpu").predict(
        x_test, device="cpu").numpy()
    return float(np.abs(p_dev - p_cpu).max() / np.abs(p_cpu).max())


def fedavg_clients(data):
    """The profiling dataset's normalised 80/20 split: the training rows
    as ``N_CLIENTS`` clients, one per value of ``HW_COLUMN`` (non-IID),
    and the test rows ``(x, y)`` for the centralised score."""
    norm, _ = data.normalised()
    tr, te = norm.split(0.8)
    hw = tr.x[:, norm.feature_names.index(HW_COLUMN)]
    return split_clients(tr.x, tr.y, N_CLIENTS, by=hw), (te.x, te.y)


def fedavg_history(data, *, device: DeviceLike = None, seed: int = 0,
                   dp: DPConfig | None = None,
                   lr: float | None = None) -> np.ndarray:
    """Each round's federated RMSE of ``run_fedavg`` at the
    ``FedAvgConfig`` defaults (``lr`` in place of its 1e-3 if given)."""
    clients, test = fedavg_clients(data)
    cfg = FedAvgConfig(seed=seed, dp=dp, **({} if lr is None else
                                              {"lr": lr}))
    res = run_fedavg(clients, cfg, central_test=test, device=device)
    return np.array([h["federated_rmse"] for h in res.round_history])


def fedavg_drift(data, *, device: DeviceLike = None, seed: int = 0,
                 dp: DPConfig | None = None,
                 lr_cpu: float | None = None) -> float:
    """``max |r_dev - r_cpu| / r_cpu`` over the rounds' federated RMSE,
    the CPU's run at ``lr_cpu`` (default: the same learning rate)."""
    r_dev = fedavg_history(data, device=resolve_device(device), seed=seed,
                           dp=dp)
    r_cpu = fedavg_history(data, device="cpu", seed=seed, dp=dp, lr=lr_cpu)
    return float(np.max(np.abs(r_dev - r_cpu) / r_cpu))


def fedavg_main(dev: torch.device, data, seeds: int) -> list[dict]:
    lr = FedAvgConfig().lr
    rows = []
    for seed in range(seeds):
        for name, dp in (("plain", None), ("dp", DPConfig())):
            t0 = time.perf_counter()
            row = dict(seed=seed, run=name,
                       fedavg=fedavg_drift(data, device=dev, seed=seed,
                                           dp=dp),
                       fedavg_lr={str(n): fedavg_drift(
                           data, device="cpu", seed=seed, dp=dp,
                           lr_cpu=lr * (1 + n)) for n in LR_NUDGES})
            row["seconds"] = time.perf_counter() - t0
            rows.append(row)
            print(json.dumps(row), flush=True)
    summary = {name: dict(
        fedavg=max(r["fedavg"] for r in rows if r["run"] == name),
        fedavg_lr={str(n): max(r["fedavg_lr"][str(n)] for r in rows
                               if r["run"] == name) for n in LR_NUDGES})
        for name in ("plain", "dp")}
    FEDAVG_RESULTS.write_text(json.dumps(dict(device=str(dev), max=summary,
                                              rows=rows), indent=1))
    print(json.dumps(dict(max=summary)))
    return rows


def main(device: DeviceLike = None, seeds: int = 12,
         records: str | None = None, fedavg: bool = False) -> list[dict]:
    dev = resolve_device(device)
    RESULTS.parent.mkdir(parents=True, exist_ok=True)
    if records is None:
        recs, data = ds.generate(n_runs=150, max_steps=6, seed=0, device=dev)
        ds.save_records(recs, str(RESULTS.with_name("mlp_spread_records.json")))
    else:
        recs = ds.load_records(records)
        data = records_to_dataset(recs)
    if fedavg:
        return fedavg_main(dev, data, seeds)
    tr, te = data.normalised()[0].split(0.8)
    lr = FIG3_MLP["lr"]
    rows = []
    for seed in range(seeds):
        t0 = time.perf_counter()
        row = dict(
            seed=seed,
            one_step=one_step_drift(tr.x, tr.y, device=dev, seed=seed),
            two_epoch=two_epoch_drift(tr.x, tr.y, te.x, device=dev,
                                      seed=seed),
            two_epoch_lr={str(n): two_epoch_drift(
                tr.x, tr.y, te.x, device="cpu", seed=seed,
                lr_cpu=lr * (1 + n)) for n in LR_NUDGES})
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {k: max(r[k] for r in rows) for k in ("one_step", "two_epoch")}
    summary["two_epoch_lr"] = {str(n): max(r["two_epoch_lr"][str(n)]
                                           for r in rows) for n in LR_NUDGES}
    out = dict(device=str(dev), records=len(recs), rows_train=len(tr.x),
               max=summary, rows=rows)
    RESULTS.write_text(json.dumps(out, indent=1))
    print(json.dumps(dict(max=summary)))
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the CPU "
                         "against itself, so only two_epoch_lr is informative)")
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--records", default=None,
                    help="a records JSON (dataset.save_records) to fit on "
                         "instead of profiling")
    ap.add_argument("--fedavg", action="store_true",
                    help="measure the FedAvg run's drift instead")
    a = ap.parse_args()
    main(a.device, a.seeds, a.records, a.fedavg)
