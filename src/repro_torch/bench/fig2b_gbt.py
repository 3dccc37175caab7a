"""Paper Fig. 2b on the port: the GBT sweep over max-depth x subsample,
the counterpart of ``benchmarks/fig2b_gbt.py``.

An individual boosted ensemble per target (``MultiTargetGBT``, 200
trees); the paper's optimum (depth 12, subsample 0.8).  The CPU rows
(``plain: true``) fit with ``gbt_hist``'s plain version; on the card the
fit's level histograms run in the ``gbt_hist`` kernel and the test
predictions in ``tree_predict`` (``fig2b_gbt_..._kernel`` rows, with their
launches).  The fit is exact f64 on both, so the card's nRMSE equals the
CPU's.  Each row adds ``fit_s``, the fit's wall time.

Run:  PYTHONPATH=src python -m repro_torch.bench.fig2b_gbt [--device cpu]

Rows go to ``results/bench_torch_fig2b_gbt.json``; the profiling dataset
comes from ``bench.common.profiling_dataset``.
"""
from __future__ import annotations

from repro_torch.bench.common import (clock, counting, emit, parser,
                                      paths, profiling_dataset, tag)
from repro_torch.core.predictors import MultiTargetGBT, per_target_nrmse

DEPTHS = (2, 4, 6, 8, 12)
SUBSAMPLES = (0.5, 0.8, 1.0)
TIMED = ("fit_s",)


def gbt_rows(data, grid, path: str, dev) -> list[dict]:
    """One row per ``(depth, subsample)`` of ``grid``, fitted on
    ``dev``."""
    norm, _ = data.normalised()
    tr, te = norm.split(0.8)
    rows = []
    for depth, sub in grid:
        with counting() as launched:
            t0 = clock()
            m = MultiTargetGBT(n_trees=200, max_depth=depth, subsample=sub,
                               learning_rate=0.1)
            m.fit(tr.x, tr.y, device=dev)
            fit_s = clock() - t0
            pred = m.predict(te.x, device=dev).cpu().numpy()
        nrmse = per_target_nrmse(pred, te.y)
        rows.append(tag({
            "name": f"fig2b_gbt_d{depth}_s{sub}" + (
                "" if path == "cpu" else f"_{path}"),
            "max_depth": depth,
            "subsample": sub,
            "nrmse_mean": float(nrmse.mean()),
            **{f"nrmse_{n}": float(v)
               for n, v in zip(te.target_names, nrmse)},
            "fit_s": fit_s,
        }, path, launched, ("gbt_hist", "tree_predict")))
    return rows


def main(device=None, dataset=None) -> list[dict]:
    """The whole grid on each path; ``dataset`` (records, data) in place of
    :func:`profiling_dataset`'s."""
    runs = [(p, d) for p, d in paths(device) if p != "card"]
    _, data = dataset or profiling_dataset(device=runs[-1][1])
    grid = [(d, s) for d in DEPTHS for s in SUBSAMPLES]
    rows = []
    for path, dev in runs:
        rows += gbt_rows(data, grid, path, dev)
    emit(rows, "fig2b_gbt")
    return rows


if __name__ == "__main__":
    args = parser(__doc__, smoke=False).parse_args()
    main(device=args.device)
