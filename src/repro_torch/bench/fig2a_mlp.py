"""Paper Fig. 2a on the port: the MLP-regressor size sweep on the
profiling dataset, the counterpart of ``benchmarks/fig2a_mlp.py``.

Individual models per target, stacked; parameter counts spanning the
paper's 3k -> 4.17M range; nRMSE per size.  The MLP has no kernel of its
own: the CPU rows (``plain: true``) train on ``device="cpu"``, the card's
rows (``fig2a_mlp_<size>_card``) the same models on the card.  Each row
adds ``fit_s``, the wall time of its per-target fits and predictions.

Run:  PYTHONPATH=src python -m repro_torch.bench.fig2a_mlp [--device cpu]

The profiling dataset comes from ``bench.common.profiling_dataset``
(profiled on the run's device, cached in
``results/profiling_records_torch.json``); rows go to
``results/bench_torch_fig2a_mlp.json``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.bench.common import (clock, counting, emit, parser,
                                      paths, profiling_dataset, tag)
from repro_torch.core.predictors import (MLPRegressor, SIZE_PRESETS,
                                         per_target_nrmse)

TIMED = ("fit_s",)


def mlp_rows(data, presets, epochs: int, path: str, dev) -> list[dict]:
    """One row per size preset: an MLP per target on ``dev``."""
    norm, _ = data.normalised()
    tr, te = norm.split(0.8)
    rows = []
    for size in presets:
        hidden = SIZE_PRESETS[size]
        preds = []
        n_params = 0
        with counting() as launched:
            t0 = clock()
            for t in range(tr.y.shape[1]):
                m = MLPRegressor(hidden=tuple(hidden), epochs=epochs,
                                 lr=1e-3, optimiser="adam", seed=t)
                m.fit(tr.x, tr.y[:, t:t + 1], device=dev)
                preds.append(m.predict(te.x, device=dev).cpu().numpy()[:, 0])
                n_params += m.param_count()
            fit_s = clock() - t0
        pred = np.stack(preds, axis=1)
        nrmse = per_target_nrmse(pred, te.y)
        rows.append(tag({
            "name": f"fig2a_mlp_{size}" + ("" if path == "cpu"
                                           else f"_{path}"),
            "params": n_params,
            "nrmse_mean": float(nrmse.mean()),
            **{f"nrmse_{n}": float(v)
               for n, v in zip(te.target_names, nrmse)},
            "fit_s": fit_s,
        }, path, launched))
    return rows


def main(epochs: int = 150, device=None, dataset=None) -> list[dict]:
    """Every preset on each path; ``dataset`` (records, data) in place of
    :func:`profiling_dataset`'s."""
    runs = [(p, d) for p, d in paths(device) if p != "kernel"]
    _, data = dataset or profiling_dataset(device=runs[-1][1])
    rows = []
    for path, dev in runs:
        rows += mlp_rows(data, tuple(SIZE_PRESETS), epochs, path, dev)
    emit(rows, "fig2a_mlp")
    return rows


if __name__ == "__main__":
    args = parser(__doc__, smoke=False).parse_args()
    main(device=args.device)
