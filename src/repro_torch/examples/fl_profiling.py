"""Federated profiling-model training (paper §II-B), on the port.

Five simulated edge devices hold private profiling shards (non-IID by
hardware type), profiled on the card; FedAvg trains the global profiling
model, with and without differential privacy.

Run:  PYTHONPATH=src python -m repro_torch.examples.fl_profiling \
          [--device cpu]
"""
from __future__ import annotations

from repro_torch._device import resolve_device
from repro_torch.core.dataset import generate
from repro_torch.core.fl import (DPConfig, FedAvgConfig, run_fedavg,
                                 split_clients)
from repro_torch.core.predictors import per_target_nrmse
from repro_torch.examples import parser

ROUNDS = 12
# clip_norm must sit well below the aggregate update scale, or the
# per-round Gaussian noise (σ ∝ clip/ε) random-walks the weights
RUNS = (("FedAvg", None),
        ("FedAvg+DP(ε=4)", DPConfig(epsilon=4.0, clip_norm=0.1)))


def shards(data):
    """``(clients, test split)``: the normalised 80/20 split, its training
    part dealt to 5 clients by hardware."""
    norm, _ = data.normalised()
    tr, te = norm.split(0.8)
    hw_col = norm.feature_names.index("log_hw_peak_flops")
    return split_clients(tr.x, tr.y, 5, by=tr.x[:, hw_col]), te


def federate(clients, te, dp, dev):
    """``(result, centralised-test nRMSE)`` of 12 FedAvg rounds."""
    res = run_fedavg(clients,
                     FedAvgConfig(rounds=ROUNDS, local_epochs=2, lr=2e-3,
                                  hidden=(64, 32), dp=dp),
                     central_test=(te.x, te.y), device=dev)
    pred = res.model.predict(te.x, device=dev).cpu().numpy()
    return res, float(per_target_nrmse(pred, te.y).mean())


def main(argv=None) -> None:
    dev = resolve_device(parser(__doc__).parse_args(argv).device)
    print("== generating profiling shards (12 measured runs × 5 devices)")
    _, data = generate(n_runs=12, max_steps=3, device=dev)
    clients, te = shards(data)
    print("   client sizes:", [len(c.x) for c in clients])
    for tag, dp in RUNS:
        res, nrmse = federate(clients, te, dp, dev)
        first = res.round_history[0]["federated_rmse"]
        last = res.round_history[-1]["federated_rmse"]
        print(f"== {tag}: federated RMSE {first:.4f} -> {last:.4f} "
              f"over {ROUNDS} rounds; centralised-test nRMSE {nrmse:.4f}")


if __name__ == "__main__":
    main()
