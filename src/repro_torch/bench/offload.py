"""Offloading-policy comparison of the port (paper §II-C): latency per
policy across link conditions, the split chosen by (a) analytic costs and
(b) a GBT trained on the profiling records, the paper's end-to-end
pipeline; the counterpart of ``benchmarks/bench_offload.py``.

The reference's fields are modelled latencies (``us_per_call`` among
them), splits and regrets; the port adds two timings, ``sweep_us`` (the
median of 5 ``sweep_links`` calls) and the predictor's ``fit_s``.  The
optimal split comes from one ``sweep_links`` over the four links: on the
CPU and on the card its exact ``torch`` sweep (CPU rows ``plain: true``,
equal to the reference's; ``_card`` rows), on the card also the
``decide_split`` kernel (``_kernel`` rows).  The other policies are host
code: CPU rows only.  The predictor-driven row's
GBT is fitted on the path's device (``gbt_hist`` on the card) and asked
one layer at a time (``tree_predict`` on the card).

Run:  PYTHONPATH=src python -m repro_torch.bench.offload [--device cpu]

Rows go to ``results/bench_torch_offload.json``; the profiling records
come from ``bench.common.profiling_dataset``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.bench.common import (clock, counting, emit, parser,
                                      paths, profiling_dataset, tag, times_us)
from repro_torch.core import decisions as dec
from repro_torch.core import offload as off
from repro_torch.core.predictors import GBTRegressor
from repro_torch.core.workloads import WorkloadConfig
from repro_torch.hw import get_device

LINKS = {"cell_poor": 0.125e9 / 64, "cell": 0.125e9 / 8, "wifi": 0.125e9,
         "wired": 1.25e9}
#: ``us_per_call`` here is a modelled latency, not a timing
TIMED = ("sweep_us", "fit_s")


def policy_rows(path: str, dev) -> list[dict]:
    """Every policy's latency, split and transfer time per link."""
    wc = WorkloadConfig("cnn", 2, epochs=5, optimiser="adam", lr=1e-3,
                        batch_size=32)
    layers = off.workload_layer_costs(wc)
    env_base = off.OffloadEnv(device=get_device("pi5-arm"),
                              edge=get_device("edge-server-a100"),
                              link_bw=LINKS["wifi"],
                              input_bytes=4 * 32 * 784)
    suffix = "" if path == "cpu" else f"_{path}"
    backend = "kernel" if path == "kernel" else "torch"
    with counting() as launched:
        # one [n_links, L+1] sweep + one table-trained policy for all links
        sweep_us, _ = times_us(lambda: dec.sweep_links(
            layers, env_base, list(LINKS.values()), backend=backend,
            device=dev), 5)
        plan = dec.sweep_links(layers, env_base, list(LINKS.values()),
                               backend=backend, device=dev)
        decisions_opt = [plan[i] for i in range(len(LINKS))]
    if path != "cpu":                # the other policies are host code
        return [tag({"name": f"offload_{link_name}_optimal{suffix}",
                     "us_per_call": d.total_time_s * 1e6,
                     "split": d.split,
                     "transfer_s": d.transfer_time_s,
                     "sweep_us": sweep_us},
                    path, launched, ("decide_split",))
                for link_name, d in zip(LINKS, decisions_opt)]
    pol = off.QLearningPolicy(layers, env_base,
                              link_buckets=tuple(LINKS.values()),
                              episodes=4000).train()
    rows = []
    for i, (link_name, bw) in enumerate(LINKS.items()):
        env = dataclasses.replace(env_base, link_bw=bw)
        decisions = {
            "local": off.local_only(layers, env),
            "remote": off.remote_only(layers, env),
            "greedy": off.greedy_split(layers, env),
            "optimal": decisions_opt[i],
            "qlearning": pol.decide(bw),
        }
        for name, d in decisions.items():
            rows.append(tag({
                "name": f"offload_{link_name}_{name}",
                "us_per_call": d.total_time_s * 1e6,
                "split": d.split,
                "transfer_s": d.transfer_time_s,
                **({"sweep_us": sweep_us} if name == "optimal" else {}),
            }, path))
    return rows


def predictor_row(records, path: str, dev) -> dict:
    """The split a GBT trained on (log flops, log peak flops) -> step time
    picks, against the analytic optimum."""
    wc = WorkloadConfig("cnn", 2, epochs=5, optimiser="adam", lr=1e-3,
                        batch_size=32)
    layers = off.workload_layer_costs(wc)
    with counting() as launched:
        gbt = GBTRegressor(n_trees=150, max_depth=8)
        feats = np.stack([[np.log10(max(r.flops_per_step, 1)),
                           np.log10(r.hardware["hw_peak_flops"])]
                          for r in records]).astype(np.float32)
        times = np.array([r.step_time_s for r in records])
        t0 = clock()
        gbt.fit(feats, times, device=dev)
        fit_s = clock() - t0

        def predicted_time(lc: off.LayerCost, spec) -> float:
            f = np.array([[np.log10(max(lc.flops, 1)),
                           np.log10(spec.peak_flops)]], np.float32)
            return float(max(float(gbt.predict(f, device=dev)[0]), 1e-9))

        env = off.OffloadEnv(device=get_device("pi5-arm"),
                             edge=get_device("edge-server-a100"),
                             link_bw=LINKS["wifi"],
                             input_bytes=4 * 32 * 784)
        d_pred = off.optimal_split(layers, env, time_fn=predicted_time)
    d_true = off.optimal_split(layers, env)
    return tag({
        "name": "offload_predictor_driven" + (
            "" if path == "cpu" else f"_{path}"),
        "us_per_call": off.split_time(layers, d_pred.split,
                                      env).total_time_s * 1e6,
        "split_pred": d_pred.split,
        "split_true": d_true.split,
        "regret_pct": 100.0 * (
            off.split_time(layers, d_pred.split, env).total_time_s
            / d_true.total_time_s - 1.0),
        "fit_s": fit_s,
    }, path, launched, ("gbt_hist", "tree_predict"))


def main(device=None, dataset=None) -> list[dict]:
    """Every row on each path; ``dataset`` (records, data) in place of
    :func:`profiling_dataset`'s."""
    runs = paths(device)
    rows = []
    for path, dev in runs:
        rows += policy_rows(path, dev)
    records, _ = dataset or profiling_dataset(device=runs[-1][1])
    # the GBT on the card is the kernels' path: one row for the card
    rows += [predictor_row(records, path, dev) for path, dev in runs
             if path != "card"]
    emit(rows, "offload")
    return rows


if __name__ == "__main__":
    args = parser(__doc__, smoke=False).parse_args()
    main(device=args.device)
