"""Quickstart: the paper's pipeline in 60 seconds, on the port.

  1. profile a handful of Table-I AI workloads on the card,
  2. train the GBT profiling model (the paper's winner; its gradient
     histograms on ``gbt_hist``, its predictions on ``tree_predict``),
  3. predict resources/time for an unseen workload,
  4. use the prediction to make an offloading decision.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core import offload as off
from repro_torch.core.dataset import generate
from repro_torch.core.features import featurize, targets_of
from repro_torch.core.predictors import MultiTargetGBT, per_target_nrmse
from repro_torch.core.profiler import profile_workload
from repro_torch.core.workloads import WorkloadConfig
from repro_torch.examples import parser
from repro_torch.hw import get_device

UNSEEN = WorkloadConfig("cnn", 1, epochs=10, optimiser="rmsprop", lr=5e-3,
                        batch_size=64)


def profile(dev, n_runs: int = 12, max_steps: int = 4):
    """``(records, dataset)``: a small grid measured on ``dev``."""
    return generate(n_runs=n_runs, max_steps=max_steps, verbose=False,
                    device=dev)


def fit_profiler(data, dev):
    """``(model, (xs, ys), nrmse by target)``: MultiTargetGBT(120, depth
    8) on the normalised 80/20 split, scored on the test part."""
    norm, (xs, ys) = data.normalised()
    tr, te = norm.split(0.8)
    model = MultiTargetGBT(n_trees=120, max_depth=8, subsample=0.8)
    model.fit(tr.x, tr.y, device=dev)
    nrmse = per_target_nrmse(model.predict(te.x, device=dev).cpu().numpy(),
                             te.y)
    return model, (xs, ys), dict(zip(te.target_names, nrmse.round(4)))


def predict_row(model, xs, ys, features: np.ndarray, dev) -> np.ndarray:
    """The model's targets for one featurised record, in its units."""
    x = (features - xs[0]) / xs[1]
    return model.predict(x[None], device=dev).cpu().numpy()[0] * ys[1] \
        + ys[0]


def decide(wc: WorkloadConfig) -> tuple:
    """``(optimal, local-only, remote-only)`` for ``wc`` from pi5 to the
    A100 over a 1 Gb/s link."""
    layers = off.workload_layer_costs(wc)
    env = off.OffloadEnv(device=get_device("pi5-arm"),
                         edge=get_device("edge-server-a100"),
                         link_bw=0.125e9, input_bytes=4 * 64 * 784)
    return (off.optimal_split(layers, env), off.local_only(layers, env),
            off.remote_only(layers, env))


def main(argv=None) -> None:
    dev = resolve_device(parser(__doc__).parse_args(argv).device)
    print("== profiling 12 Table-I workloads (measured) ...")
    records, data = profile(dev)
    print(f"   {len(records)} records "
          f"({len([r for r in records if '@' not in r.label])} measured, "
          f"rest hardware-projected)")

    model, (xs, ys), nrmse = fit_profiler(data, dev)
    print(f"== GBT profiling model: nRMSE per target {nrmse}")

    rec = profile_workload(UNSEEN, max_steps=2, device=dev)  # ground truth
    pred = predict_row(model, xs, ys, featurize(rec), dev)
    print(f"== unseen workload {UNSEEN.label()}:")
    for name, p, t in zip(data.target_names, pred, targets_of(rec)):
        print(f"   {name:>12}: predicted {p:.3g}, measured {t:.3g}")

    d, local, remote = decide(UNSEEN)
    print(f"== offload decision: run layers [0,{d.split}) on-device, "
          f"rest at the edge -> {d.total_time_s*1e3:.2f} ms "
          f"(local-only {local.total_time_s*1e3:.2f} "
          f"ms, remote-only {remote.total_time_s*1e3:.2f} ms)")


if __name__ == "__main__":
    main()
