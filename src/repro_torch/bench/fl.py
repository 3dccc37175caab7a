"""Federated profiling-model benchmark of the port (paper §II-B):
centralised against FedAvg and FedAvg+DP on the profiling dataset, with
federated and centralised validation; the counterpart of
``benchmarks/bench_fl.py``.

The MLP has no kernel of its own: the CPU rows (``plain: true``) train on
``device="cpu"``, the card's rows (``fl_<tag>_card``) the same models on
the card, from the same initial weights and the same DP noise draws.
Each row adds ``fit_s``, the wall time of its training (FedAvg: all its
rounds).

Run:  PYTHONPATH=src python -m repro_torch.bench.fl [--device cpu]

Rows go to ``results/bench_torch_fl.json``; the profiling dataset comes
from ``bench.common.profiling_dataset``.
"""
from __future__ import annotations

from repro_torch.bench.common import (clock, counting, emit, parser,
                                      paths, profiling_dataset, tag)
from repro_torch.core.fl import (DPConfig, FedAvgConfig, run_fedavg,
                                 split_clients)
from repro_torch.core.predictors import MLPRegressor, per_target_nrmse

TIMED = ("fit_s",)
# clip_norm must sit well below the aggregate update scale or the
# Gaussian noise (σ ∝ clip/ε per round) random-walks the weights
RUNS = (("fedavg", None),
        ("fedavg_dp_eps8", DPConfig(epsilon=8.0, clip_norm=0.1)),
        ("fedavg_dp_eps2", DPConfig(epsilon=2.0, clip_norm=0.1)))


def fl_rows(data, path: str, dev, rounds: int = 15) -> list[dict]:
    norm, _ = data.normalised()
    tr, te = norm.split(0.8)
    # non-IID shards: split by hardware peak-flops feature column
    hw_col = norm.feature_names.index("log_hw_peak_flops")
    clients = split_clients(tr.x, tr.y, 5, by=tr.x[:, hw_col])
    suffix = "" if path == "cpu" else f"_{path}"

    with counting() as launched:
        t0 = clock()
        central = MLPRegressor(hidden=(128, 64), epochs=120, lr=1e-3)
        central.fit(tr.x, tr.y, device=dev)
        fit_s = clock() - t0
        nrmse_central = float(per_target_nrmse(
            central.predict(te.x, device=dev).cpu().numpy(), te.y).mean())
    rows = [tag({"name": f"fl_centralised{suffix}", "nrmse": nrmse_central,
                 "fit_s": fit_s}, path, launched)]
    for name, dp in RUNS:
        with counting() as launched:
            t0 = clock()
            res = run_fedavg(clients, FedAvgConfig(
                rounds=rounds, local_epochs=2, lr=2e-3, hidden=(128, 64),
                dp=dp), central_test=(te.x, te.y), device=dev)
            fit_s = clock() - t0
            pred = res.model.predict(te.x, device=dev).cpu().numpy()
        rows.append(tag({
            "name": f"fl_{name}{suffix}",
            "nrmse": float(per_target_nrmse(pred, te.y).mean()),
            "federated_rmse": res.federated_rmse,
            "rounds": rounds,
            "fit_s": fit_s,
        }, path, launched))
    return rows


def main(device=None, dataset=None) -> list[dict]:
    """Every row on each path; ``dataset`` (records, data) in place of
    :func:`profiling_dataset`'s."""
    runs = [(p, d) for p, d in paths(device) if p != "kernel"]
    _, data = dataset or profiling_dataset(device=runs[-1][1])
    rows = []
    for path, dev in runs:
        rows += fl_rows(data, path, dev)
    emit(rows, "fl")
    return rows


if __name__ == "__main__":
    args = parser(__doc__, smoke=False).parse_args()
    main(device=args.device)
