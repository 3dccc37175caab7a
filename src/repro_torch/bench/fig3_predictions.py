"""Paper Fig. 3 on the port: denormalised predictions of the best GBT
(depth 12, subsample 0.8) for FLOPS, MACs and total time, plus the
paper's headline GBT-vs-MLP comparison; the counterpart of
``benchmarks/fig3_predictions.py``.

The CPU row (``plain: true``) fits both on ``device="cpu"``; on the card
the GBT's fit runs ``gbt_hist`` and its predictions ``tree_predict``, the
MLP trains on the card (``fig3_gbt_best_kernel``, with its launches).
The row adds each fit's wall time (``gbt_fit_s``, ``mlp_fit_s``).

Run:  PYTHONPATH=src python -m repro_torch.bench.fig3_predictions \\
          [--device cpu]

Rows go to ``results/bench_torch_fig3_predictions.json``; the profiling
dataset comes from ``bench.common.profiling_dataset``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.bench.common import (clock, counting, emit, parser,
                                      paths, profiling_dataset, tag)
from repro_torch.core.predictors import (MLPRegressor, MultiTargetGBT,
                                         per_target_nrmse)

#: the best GBT of Fig. 2b and the largest MLP preset
GBT_KW = dict(n_trees=300, max_depth=12, subsample=0.8)
MLP_KW = dict(hidden=(2048, 1024, 512), epochs=150, lr=1e-3)
TIMED = ("gbt_fit_s", "mlp_fit_s")


def fig3_row(data, path: str, dev) -> dict:
    norm, (xs, ys) = data.normalised()
    tr, te = norm.split(0.8)
    with counting() as launched:
        t0 = clock()
        gbt = MultiTargetGBT(**GBT_KW)
        gbt.fit(tr.x, tr.y, device=dev)
        t1 = clock()
        pred_n = gbt.predict(te.x, device=dev).cpu().numpy()
        t2 = clock()
        mlp = MLPRegressor(**MLP_KW)
        mlp.fit(tr.x, tr.y, device=dev)
        t3 = clock()
        pred_mlp = mlp.predict(te.x, device=dev).cpu().numpy()
    nrmse = per_target_nrmse(pred_n, te.y)

    # denormalise (paper Fig. 3 shows raw-unit predictions)
    y_lo, y_span = ys
    pred = pred_n * y_span + y_lo
    true = te.y * y_span + y_lo
    rel_err = np.median(np.abs(pred - true) / np.maximum(np.abs(true),
                                                         1e-12), axis=0)
    nrmse_mlp = per_target_nrmse(pred_mlp, te.y)
    return tag({
        "name": "fig3_gbt_best" + ("" if path == "cpu" else f"_{path}"),
        **{f"nrmse_{n}": float(v) for n, v in zip(te.target_names, nrmse)},
        **{f"medrelerr_{n}": float(v)
           for n, v in zip(te.target_names, rel_err)},
        "nrmse_mean": float(nrmse.mean()),
        "nrmse_mlp_xl": float(nrmse_mlp.mean()),
        "gbt_vs_mlp_ratio": float(nrmse_mlp.mean() / max(nrmse.mean(),
                                                         1e-12)),
        "gbt_fit_s": t1 - t0,
        "mlp_fit_s": t3 - t2,
    }, path, launched, ("gbt_hist", "tree_predict"))


def main(device=None, dataset=None) -> list[dict]:
    """The row on each path; ``dataset`` (records, data) in place of
    :func:`profiling_dataset`'s."""
    runs = [(p, d) for p, d in paths(device) if p != "card"]
    _, data = dataset or profiling_dataset(device=runs[-1][1])
    rows = [fig3_row(data, path, dev) for path, dev in runs]
    emit(rows, "fig3_predictions")
    return rows


if __name__ == "__main__":
    args = parser(__doc__, smoke=False).parse_args()
    main(device=args.device)
