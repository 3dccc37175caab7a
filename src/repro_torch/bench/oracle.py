"""Oracle benchmark of the port: predictor-serving throughput and the
closed loop, the counterpart of ``benchmarks/bench_oracle.py``.

  * **predict sweep** — fitted-GBT inference at 1,024-65,536 rows: the
    GBT's own ``predict`` on the CPU (the reference's ``host`` rows), the
    plain descent (``kernels/tree_predict/ref.py``) on the card (its
    ``jax`` rows) and the ``tree_predict`` kernel (its ``pallas`` rows);
    at the largest size the card's two must be no slower than the CPU
    (best of reps, 5% allowance).
  * **predictor-driven decide** — ``decide_all(cost=PredictorCost(...))``
    at the 16,384-env fleet size: the CPU's and the card's exact
    ``torch`` sweeps (the reference's ``numpy`` and ``jax`` rows) and the
    kernel path (``tree_predict`` + ``decide_split``).
  * **closed-loop drift** — a structured slowdown streamed through an
    ``OnlineOracle``: Page–Hinkley triggers, the refit recovers accuracy
    (refits ≥ 1, recovered nRMSE < half the peak); then the gain
    correction tracks a uniform 2x slowdown (gain within 0.25 of 2).  On
    the CPU and on the card (``torch_device``: refits through
    ``gbt_hist``, predictions through ``tree_predict``), the card's values
    equal to the CPU's.
  * **the oracle path's shapes** — ``tree_predict`` at one observation's
    row and one admission's 32 rows of ``examples/oracle_serving.py``'s
    GBT (120 trees, depth 8), timed as ``bench.kernels`` times its rows
    (on the card from a CUDA graph, the eager call beside).

Rows keep the reference's names; the drift rows and the path's shapes
run on the card with ``_kernel`` appended.  CPU rows carry ``plain:
true``, card rows ``card`` and their kernels' ``launches``.

Run:  PYTHONPATH=src python -m repro_torch.bench.oracle [--device cpu] \\
          [--smoke]

Rows go to ``results/bench_torch_oracle.json``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.bench.common import (counting, emit, parser, paths,
                                      require, tag, times_us)
from repro_torch.bench.decisions import synth_layers
from repro_torch.core import costs as co
from repro_torch.core import decisions as dec
from repro_torch.core import offload as off
from repro_torch.hw import EDGE_DEVICES, get_device
from repro_torch.oracle import OnlineOracle

DEVICE_NAME, EDGE_NAME = "pi5-arm", "edge-server-a100"
TIMED = ("us_per_call", "best_us", "predictions_per_s", "speedup_vs_host",
         "decisions_per_s", "speedup_vs_numpy", "plain_us", "library_us",
         "us_per_call_eager", "kernels")
#: the reference's backend each path stands for
PREDICT_OF = {"cpu": "host", "card": "jax", "kernel": "pallas"}
DECIDE_OF = {"cpu": "numpy", "card": "jax", "kernel": "pallas"}


def layer_training_set(layers):
    feats, ys = [], []
    for spec in EDGE_DEVICES.values():
        feats.append(co.default_layer_features(layers, spec))
        ys.append([off.layer_time(lc.flops, spec) for lc in layers])
    return np.concatenate(feats), np.concatenate(ys)


def fit_profiling_gbt(n_trees: int = 40, max_depth: int = 5,
                      n_layers: int = 64, seed: int = 0, device=None):
    """Profiling GBT over task-shaped features (``act_bytes=0``, the
    ETC/oracle query form), fitted on ``device``.  The defaults are
    throughput-bench sized; the drift scenario fits a high-capacity one so
    residuals measure drift, not model noise."""
    from repro_torch.core.predictors import GBTRegressor
    rng = np.random.default_rng(seed)
    layers = [off.LayerCost(f"l{i}", flops=float(f), act_bytes=0.0)
              for i, f in enumerate(rng.uniform(1e8, 1e11, n_layers))]
    x, y = layer_training_set(layers)
    return GBTRegressor(n_trees=n_trees, max_depth=max_depth,
                        seed=seed).fit(x, y, device=device)


def predict_features(sizes) -> list[np.ndarray]:
    """The sweep's ``[n, F]`` query rows for each size, drawn in turn from
    one generator (seed 1), as the reference draws them."""
    rng = np.random.default_rng(1)
    specs = list(EDGE_DEVICES.values())
    out = []
    for n in sizes:
        qlayers = [off.LayerCost("q", flops=float(f), act_bytes=0.0)
                   for f in rng.uniform(1e8, 1e11, n // len(specs))]
        out.append(np.concatenate([co.default_layer_features(qlayers, s)
                                   for s in specs])[:n])
    return out


# --------------------------------------------------------------------------
# predict-throughput sweep
# --------------------------------------------------------------------------
def predict_rows(sizes, reps: int, runs) -> list[dict]:
    """GBT inference per path over ``sizes``; at the largest size the
    card's paths must not be slower than the CPU's."""
    from repro_torch.kernels.tree_predict import ref as tp_ref
    models = {}
    rows = []
    for n, x in zip(sizes, predict_features(sizes)):
        cell = {}
        for path, dev in runs:
            if dev.type not in models:
                models[dev.type] = fit_profiling_gbt(device=dev)
            model = models[dev.type]
            if path == "card":           # the plain descent on the card
                arrays = tp_ref.flatten_gbt(model)
                xd = torch.as_tensor(x, dtype=torch.float32, device=dev)

                def fn():
                    return tp_ref.predict_ref(xd, arrays)
            else:
                def fn():
                    return model.predict(x, device=dev)
            with counting() as launched:
                t, best = times_us(fn, reps)
            ref = PREDICT_OF[path]
            cell[ref] = best
            row = {
                "name": f"tree_predict_{ref}_{n}",
                "backend": ref,
                "port_backend": "kernel" if path == "kernel" else "torch",
                "n_rows": n,
                "us_per_call": t,
                "best_us": best,
                "predictions_per_s": n * 1e6 / t,
            }
            if path != "cpu" and "host" in cell:
                row["speedup_vs_host"] = cell["host"] / best
            rows.append(tag(row, path, launched, ("tree_predict",)))
        if n == sizes[-1]:
            for ref in ("jax", "pallas"):
                if ref in cell and "host" in cell:
                    require(cell[ref] <= cell["host"] * 1.05, (
                        f"tree predict on the card ({ref} row) slower than "
                        f"the CPU at the largest sweep: best "
                        f"{cell[ref]:.0f}us vs {cell['host']:.0f}us (n={n})"))
    return rows


# --------------------------------------------------------------------------
# predictor-driven decide sweep
# --------------------------------------------------------------------------
def decide_rows(n_envs: int, reps: int, runs) -> list[dict]:
    """``decide_all(cost=PredictorCost(gbt))`` per path at ``n_envs``."""
    layers = synth_layers(64)
    device, edge = get_device(DEVICE_NAME), get_device(EDGE_NAME)
    rows, cell, models = [], {}, {}
    for path, dev in runs:
        if dev.type not in models:
            models[dev.type] = fit_profiling_gbt(device=dev)
        envs = dec.make_envs(device, edge,
                             link_bw=np.geomspace(1e5, 1e10, n_envs),
                             input_bytes=1e5, device=dev)
        cost = co.PredictorCost(models[dev.type], device, edge)
        backend = "kernel" if path == "kernel" else "torch"
        with counting() as launched:
            t, best = times_us(lambda: dec.decide_all(
                layers, envs, cost=cost, backend=backend, device=dev), reps)
        ref = DECIDE_OF[path]
        cell[ref] = best
        row = {
            "name": f"decide_predictor_{ref}_envs{n_envs}",
            "backend": ref,
            "port_backend": backend,
            "n_envs": n_envs,
            "n_layers": 64,
            "us_per_call": t,
            "best_us": best,
            "decisions_per_s": n_envs * 1e6 / t,
        }
        if path != "cpu" and "numpy" in cell:
            row["speedup_vs_numpy"] = cell["numpy"] / best
        rows.append(tag(row, path, launched, ("decide_split",
                                              "tree_predict")))
    return rows


# --------------------------------------------------------------------------
# closed-loop drift scenario
# --------------------------------------------------------------------------
def drift_rows(smoke: bool, path: str, dev, model=None) -> list[dict]:
    """The drift -> refit loop and the gain correction on one path;
    ``model`` defaults to the scenario's 150-tree GBT fitted on ``dev``."""
    rng = np.random.default_rng(19)
    specs = list(EDGE_DEVICES.values())
    with counting() as launched:
        if model is None:
            model = fit_profiling_gbt(n_trees=150, max_depth=8,
                                      n_layers=512, device=dev)
        device, edge = get_device(DEVICE_NAME), get_device(EDGE_NAME)
        # total leaves room for the rolling-nRMSE window to flush its
        # pre-refit pairs after the refit lands
        drift_at, total = (150, 650) if smoke else (250, 800)
        oracle = OnlineOracle(model, device, edge, window=256,
                              min_refit=120, correction="none",
                              torch_device=dev)
        track, drift_step, refit_step = [], None, None
        for step in range(total):
            spec = specs[int(rng.integers(len(specs)))]
            flops = float(rng.uniform(1e8, 1e11))
            f = oracle.feature_fn(
                [off.LayerCost("q", flops=flops, act_bytes=0.0)], spec)[0]
            t = off.layer_time(flops, spec)
            if step >= drift_at and spec.tdp_watts in (12, 15):
                t *= 3.0             # pi5 + jetson slow down: structured
            out = oracle.observe(f, t)
            track.append(oracle.rolling_nrmse())
            if out["drift"] and drift_step is None:
                drift_step = step
            if out["refit_version"] is not None and refit_step is None:
                refit_step = step
    pre = float(np.mean(track[drift_at - 50:drift_at]))
    peak = float(np.max(track[drift_at:]))
    recovered = float(np.mean(track[-50:]))
    require(oracle.refits >= 1, "drift scenario produced no refit")
    require(recovered < 0.5 * peak, (
        f"online refit failed to recover accuracy: nRMSE {recovered:.4f} "
        f"vs drift peak {peak:.4f}"))
    suffix = "" if path == "cpu" else f"_{path}"
    rows = [tag({
        "name": f"oracle_drift_closed_loop{suffix}",
        "n_observations": total,
        "drift_injected_at": drift_at,
        "drift_detected_at": drift_step,
        "refit_at": refit_step,
        "nrmse_pre_drift": pre,
        "nrmse_drift_peak": peak,
        "nrmse_recovered": recovered,
        "drift_triggers": oracle.drift_triggers,
        "refits": oracle.refits,
        "registry_version": oracle.version,
    }, path, launched, ("gbt_hist", "tree_predict"))]

    # uniform 2x slowdown: the always-on gain correction alone recovers
    with counting() as launched:
        oracle2 = OnlineOracle(model, device, edge, correction="gain",
                               refit_on_drift=False, torch_device=dev)
        resid_raw, resid_corr = [], []
        for step in range(150 if smoke else 300):
            spec = specs[int(rng.integers(len(specs)))]
            flops = float(rng.uniform(1e8, 1e11))
            f = oracle2.feature_fn(
                [off.LayerCost("q", flops=flops, act_bytes=0.0)], spec)[0]
            t = 2.0 * off.layer_time(flops, spec)
            corrected = oracle2.predict_one(f)
            raw = corrected / oracle2.gain
            resid_raw.append(abs(t - raw) / t)
            resid_corr.append(abs(t - corrected) / t)
            oracle2.observe(f, t, predicted_s=corrected)
    tail = slice(len(resid_corr) // 2, None)
    rows.append(tag({
        "name": f"oracle_gain_tracks_uniform_slowdown{suffix}",
        "gain": oracle2.gain,
        "mean_rel_err_uncorrected": float(np.mean(resid_raw[tail])),
        "mean_rel_err_corrected": float(np.mean(resid_corr[tail])),
    }, path, launched, ("tree_predict",)))
    require(abs(oracle2.gain - 2.0) < 0.25, f"gain {oracle2.gain}")
    require(np.mean(resid_corr[tail]) < 0.5 * np.mean(resid_raw[tail]),
            "the gain correction did not halve the relative error")
    return rows


# --------------------------------------------------------------------------
# tree_predict at the oracle path's own shapes
# --------------------------------------------------------------------------
def oracle_gbt(device=None):
    """``examples/oracle_serving.py``'s profiling GBT: 120 trees of depth 8
    on 256 random layers x the five edge specs (seed 0)."""
    from repro_torch.examples.oracle_serving import fit_profiler
    return fit_profiler(np.random.default_rng(0), device)


def path_shape_rows(gbt, path: str, dev) -> list[dict]:
    """``tree_predict`` on one observation's row and one admission's 32
    rows (a 32-node cluster's features of one task), timed as
    ``bench.kernels.tree_predict_row`` times its rows."""
    from repro_torch.bench.kernels import tree_predict_row
    from repro_torch.kernels.tree_predict import ref as tp_ref
    specs = list(EDGE_DEVICES.values())
    rng = np.random.default_rng(2)
    q = off.LayerCost("q", flops=float(rng.uniform(1e8, 1e11)),
                      act_bytes=0.0)
    cases = {1: co.default_layer_features([q], specs[0]),
             32: np.concatenate([co.default_layer_features(
                 [q], specs[j % len(specs)]) for j in range(32)])}
    arrays = tp_ref.flatten_gbt(gbt)
    trees = tp_ref.device_trees(arrays, dev)
    kw = dict(max_depth=arrays.max_depth, base=arrays.base)
    rows = []
    for n, x in cases.items():
        codes = tp_ref.bin_codes_ref(torch.as_tensor(
            x, dtype=torch.float32, device=dev), trees.edges)
        args = (codes, trees.feature, trees.threshold_bin, trees.left,
                trees.right, trees.scaled_value)
        with counting() as launched:
            row = tree_predict_row(dev, f"oracle_r{n}", (args, kw))
        if dev.type == "cuda":
            require(row["err_over_tol"] < 1.0, f"tree_predict oracle_r{n}: "
                    "the kernel differs from its plain version (exact)")
        row["name"] = f"tree_predict_oracle_r{n}" + (
            "" if path == "cpu" else f"_{path}")
        row.pop("device")
        rows.append(tag(row, path, launched, ("tree_predict",)))
    return rows


def main(smoke: bool = False, device=None) -> list[dict]:
    runs = paths(device)
    reps = 3 if smoke else 7
    sizes = (1024, 4096) if smoke else (1024, 4096, 16384, 65536)
    rows = predict_rows(sizes, reps, runs)
    rows += decide_rows(4096 if smoke else 16384, reps, runs)
    drift = {}
    for path, dev in runs:
        if path != "card":           # no plain GBT path on the card
            drift[path] = drift_rows(smoke, path, dev)
    if "kernel" in drift:            # the card's loop is the CPU's, exactly
        for want, got in zip(drift["cpu"], drift["kernel"]):
            same = {k: v for k, v in got.items()
                    if k in want and k != "name"}
            require(same == {k: want[k] for k in same}, (
                f"{got['name']}: the card's values differ from the CPU's "
                f"({same} vs {want})"))
    rows += [r for rs in drift.values() for r in rs]
    for path, dev in runs:
        if path != "card":
            rows += path_shape_rows(oracle_gbt(dev), path, dev)
    emit(rows, "oracle")
    return rows


if __name__ == "__main__":
    args = parser(__doc__).parse_args()
    main(smoke=args.smoke, device=args.device)
