"""Assemble the port's EXPERIMENTS document from its records, the
counterpart of ``benchmarks/write_experiments.py``:

  * §Paper-validation: ``profiling_records_torch.json`` and the figure
    benches' rows (``bench_torch_fig2a_mlp.json``,
    ``bench_torch_fig2b_gbt.json``, ``bench_torch_fig3_predictions.json``);
  * §Dry-run: the dry-run's records (``dryrun_torch.json``; a multi-pod
    file where one is named), with the port's own columns: ``run_s``, GiB
    a device and whether it fits in the H100's 80 GB;
  * §Roofline: the same records' three terms, with the constants of
    ``repro_torch.roofline.H100_SXM``;
  * §Perf: ``perf_experiments_torch.json``, each experiment's terms, its
    ratios to its pair's baseline and its verdict.

It states nothing the records do not hold.

Run:  PYTHONPATH=src python -m repro_torch.bench.write_experiments
      [--results DIR] [--dryrun PATH] [--multi-pod PATH] [--perf PATH]
      [--out PATH]

The document goes to ``results/EXPERIMENTS_torch.md`` by default.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.bench import common
from repro_torch.bench.perf_experiments import OUT_NAME as PERF_NAME
from repro_torch.bench.roofline import DRYRUN_NAME
from repro_torch.roofline import H100_SXM

OUT_NAME = "EXPERIMENTS_torch.md"
#: Fig. 2a's plateau in the paper: the largest MLP's nRMSE just below it
PAPER_PLATEAU = 0.02


def _load(path: str):
    if not path or not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _fmt_bytes(b):
    return f"{b/2**30:.2f}"


def _path_of(row: dict) -> str:
    """Where a bench row ran: ``cpu`` for a CPU row, else the suffix its
    name carries (``card`` / ``kernel``)."""
    return "cpu" if "card" not in row else row["name"].rsplit("_", 1)[1]


def _by_path(rows: list[dict]) -> dict:
    """``{path: [rows]}`` in the order the paths first appear."""
    out: dict = {}
    for r in rows:
        out.setdefault(_path_of(r), []).append(r)
    return out


def _on(path: str, rows: list[dict]) -> str:
    """A heading's note of where its rows ran (nothing for the CPU)."""
    return "" if path == "cpu" else f", {path} path on {rows[0]['card']}"


def dryrun_section(recs):
    lines = [
        "| arch | shape | status | run s | GiB/dev | fits 80 GB | "
        "sharding |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["status"] != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | {r['status']} "
                         f"| | | | {r.get('reason', r.get('error', ''))[:60]}"
                         " |")
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | ok | {r['run_s']:.1f} | "
            f"{_fmt_bytes(r['bytes_per_device'])} | "
            f"{'✓' if r['fits_hbm80'] else '✗'} | {r['sharding']} |")
    return "\n".join(lines)


def roofline_section(recs):
    lines = [
        "| arch | shape | compute s | memory s | collective s | dominant | "
        "MODEL_FLOPS | useful | bottleneck note |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    notes = {
        "collective": "shrink cross-card bytes (sharding/dtype/overlap)",
        "memory": "shrink HBM traffic (cache layout, fusion, dtype)",
        "compute": "raise MFU (larger tiles, less recompute)",
    }
    for r in recs:
        if r["status"] != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                         f"{r['status']} | | | |")
            continue
        ro = r["roofline"]
        u = ro["useful_ratio"]
        head = (f"| {r['arch']} | {r['shape']} | {ro['compute_s']:.2e} | "
                f"{ro['memory_s']:.2e} | {ro['collective_s']:.2e} | "
                f"{ro['dominant']} | ")
        lines.append(head + (f"{ro['model_flops']:.2e} | {u:.3f} | "
                             f"{notes[ro['dominant']]} |" if u is not None
                             else "| | |"))
    return "\n".join(lines)


def _ratio(v):
    return "—" if v is None else f"{v:.3g}×"


def perf_section(recs):
    out = []
    for r in recs:
        if r["status"] != "ok":
            out.append(f"* **{r['experiment']}** — FAILED: "
                       f"{r.get('error', '')[:120]}")
            continue
        ro, vs = r["roofline"], r["vs_baseline"]
        line = (
            f"* **{r['experiment']}** — {r['hypothesis']}\n"
            f"  terms: compute {ro['compute_s']:.3e}s · memory "
            f"{ro['memory_s']:.3e}s · collective {ro['collective_s']:.3e}s "
            f"→ dominant **{ro['dominant']}**; "
            f"mem/dev {_fmt_bytes(r['bytes_per_device'])} GiB\n"
            f"  over {r['baseline']}: compute {_ratio(vs['compute_s'])} · "
            f"memory {_ratio(vs['memory_s'])} · collective "
            f"{_ratio(vs['collective_s'])} · mem/dev "
            f"{_ratio(vs['bytes_per_device'])}")
        if "predicts" in r:
            p = r["predicts"]
            line += (f"\n  verdict: {p['term']} {p['direction']} against "
                     f"{p['against']}: **{r['verdict']}**")
        out.append(line)
    return "\n".join(out)


def bench_tables(results: str = "") -> str:
    """The figure benches' tables: the reference's for the CPU rows, and
    one more of each for the rows of each card path."""
    root = results or common.RESULTS_DIR

    def load(name):
        return _load(os.path.join(root, f"bench_torch_{name}.json"))

    out = []
    for path, fig2a in _by_path(load("fig2a_mlp") or []).items():
        out.append(f"### Fig. 2a — MLP regressors (ours{_on(path, fig2a)})"
                   "\n")
        out.append("| size | params | nRMSE (mean) |")
        out.append("|---|---|---|")
        for r in fig2a:
            size = r["name"].removeprefix("fig2a_mlp_").removesuffix(
                "" if path == "cpu" else f"_{path}")
            out.append(f"| {size} | {r['params']:,} | "
                       f"{r['nrmse_mean']:.4f} |")
        lo = min(r["nrmse_mean"] for r in fig2a)
        hi = max(r["nrmse_mean"] for r in fig2a)
        # the reference says "matches" whatever its rows hold; here the
        # largest MLP must be below the paper's 0.02
        largest = max(fig2a, key=lambda r: r["params"])
        verdict = ("matches" if largest["nrmse_mean"] < PAPER_PLATEAU
                   else "does not match")
        out.append(f"\nPaper: plateau just below 0.02 at 4.17M params — "
                   f"**{verdict}** (ours {lo:.3f}–{hi:.3f}).\n")
    for path, fig2b in _by_path(load("fig2b_gbt") or []).items():
        out.append(f"### Fig. 2b — GBT ensembles (ours{_on(path, fig2b)})\n")
        out.append("| max_depth | subsample | nRMSE mean | flops | macs | "
                   "total_time |")
        out.append("|---|---|---|---|---|---|")
        for r in fig2b:
            out.append(f"| {r['max_depth']} | {r['subsample']} | "
                       f"{r['nrmse_mean']:.4f} | {r['nrmse_flops']:.5f} | "
                       f"{r['nrmse_macs']:.5f} | "
                       f"{r['nrmse_total_time']:.4f} |")
    for path, fig3 in _by_path(load("fig3_predictions") or []).items():
        r = fig3[0]
        out.append("\n### Fig. 3 — best GBT (max_depth=12, subsample=0.8"
                   f"{_on(path, fig3)})\n")
        out.append(f"nRMSE: flops {r['nrmse_flops']:.5f}, macs "
                   f"{r['nrmse_macs']:.5f}, total_time "
                   f"{r['nrmse_total_time']:.4f}; GBT-vs-best-MLP ratio "
                   f"{r['gbt_vs_mlp_ratio']:.1f}× (mean across targets).")
    return "\n".join(out)


def _mesh_section(title: str, recs) -> str:
    if recs is None:
        return f"### {title}\n\nNo records: not run.\n"
    ok = sum(r["status"] == "ok" for r in recs)
    return (f"### {title}\n\n{ok} of {len(recs)} records ok.\n\n"
            f"{dryrun_section(recs)}\n")


def document(results: str = "", dryrun: str = "", multi_pod: str = "",
             perf: str = "") -> str:
    """The document from the records under ``results`` (default
    ``REPRO_RESULTS`` or ``results``); ``dryrun`` / ``perf`` default to
    their files there, ``multi_pod`` to none."""
    root = results or common.RESULTS_DIR
    recs = _load(os.path.join(root, common.RECORDS_NAME)) or []
    n_measured = len([r for r in recs if "@" not in r.get("label", "@")])
    single = _load(dryrun or os.path.join(root, DRYRUN_NAME))
    multi = _load(multi_pod)
    perf_recs = _load(perf or os.path.join(root, PERF_NAME)) or []
    single_pod = _mesh_section(
        'Single pod — 16×16 = 256 cards ("data","model")', single)
    multi_pod = _mesh_section(
        'Multi-pod — 2×16×16 = 512 cards ("pod","data","model")', multi)
    hw = H100_SXM
    return f"""# EXPERIMENTS — the PyTorch port

Assembled by `python -m repro_torch.bench.write_experiments` from the
port's records under `{root}`.  Regenerate with:
`python -m repro_torch.launch.dryrun --all --out results/dryrun_torch.json`,
`python -m repro_torch.bench.run`,
`python -m repro_torch.bench.perf_experiments`,
`python -m repro_torch.bench.write_experiments`.
A bench row names the card it ran on; a row without one ran on the CPU.

## §Paper-validation (the faithful reproduction)

Profiling dataset (`{common.RECORDS_NAME}`): {n_measured} measured runs,
{len(recs)} records with their projections onto the other edge specs.

{bench_tables(root)}

## §Dry-run (deliverable e)

Each (architecture × input shape) step built for the production mesh and
run once, rank 0's, on meta tensors (`repro_torch.launch.dryrun`): GiB/dev
is the static bytes (parameters, gradients and moments in training, the
batch, the cache) plus the peak of the bytes the step allocates.

{single_pod}
{multi_pod}
## §Roofline (deliverable g) — single-pod mesh

Constants (`repro_torch.roofline.H100_SXM`, {hw.name}):
{hw.peak_flops/1e12:g} TFLOP/s bf16 · {hw.hbm_bw/1e12:g} TB/s HBM ·
{hw.link_bw/1e9:g} GB/s NVLink each way per card, at {hw.tdp_watts:g} W.
FLOPs: `FlopCounterMode` over every op the step runs (the kernels' custom
ops by their `kernels/work.py` formulas).  Bytes: each input read once,
each output written once.  Collectives: the result bytes of each
collective the step issues, per kind.  MODEL_FLOPS =
`roofline.model_flops_estimate`.  Each term is a bound on the card, not a
measured time.

{roofline_section(single or [])}

## §Perf (the three pairs)

Pairs: **A** deepseek-v2-lite-16b × long_500k, **B** xlstm-350m ×
train_4k, **C** deepseek-moe-16b × train_4k, run by
`python -m repro_torch.bench.perf_experiments`.  Each experiment's terms,
its ratios to its pair's baseline, and the verdict on the term it
predicts, read from its record against the experiment it changes:

{perf_section(perf_recs) or 'No records: not run.'}
"""


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--results", default="",
                    help="records directory (default REPRO_RESULTS or "
                    "results)")
    ap.add_argument("--dryrun", default="",
                    help=f"single-pod dry-run (default <results>/"
                    f"{DRYRUN_NAME})")
    ap.add_argument("--multi-pod", default="",
                    help="multi-pod dry-run (default none)")
    ap.add_argument("--perf", default="",
                    help=f"perf experiments (default <results>/{PERF_NAME})")
    ap.add_argument("--out", default="",
                    help=f"document path (default <results>/{OUT_NAME})")
    args = ap.parse_args(argv)
    doc = document(args.results, args.dryrun, args.multi_pod, args.perf)
    out = args.out or os.path.join(args.results or common.RESULTS_DIR,
                                   OUT_NAME)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        f.write(doc)
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
