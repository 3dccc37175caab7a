"""The §Perf experiments on the port's dry-run, the counterpart of
``benchmarks/perf_experiments.py``: the reference's three pairs, each a
baseline and its levers, with the same configuration knobs.

  A. deepseek-v2-lite-16b × long_500k: MLA weight absorption, then the
     latent cache sequence-sharded over data.
  B. xlstm-350m × train_4k: FSDP off, then the mLSTM's inner activations
     pinned replicated.
  C. deepseek-moe-16b × train_4k: a bf16 expert combine, sequence
     parallelism off, and both.

Each experiment runs through ``repro_torch.launch.dryrun.run_one`` on the
single-pod production mesh (16 × 16, meta tensors: no device).  Its record
is the dry-run's, with ``experiment``, ``hypothesis`` (the lever and the
direction it predicts), ``vs_baseline`` (its three terms and bytes per
device over its pair's baseline: A0, B0, C0) and ``verdict``: the term it
``predicts`` against the experiment it changes, ``confirmed`` where the
term moved that way, ``refuted`` where it moved the other, ``unchanged``
where it did not move.  The terms are the dry-run's bounds at the H100
SXM's data-sheet rates, not times measured on a card.

The port has no GSPMD: its step issues the collectives by hand, so the
levers act through what it does.  C0/C2's ``seq_parallel`` splits the
residual stream by sequence (an all-gather and a reduce-scatter around
each layer's products, where it would all-reduce); B3's
``xlstm_pin_inner`` computes the mLSTM's up projection whole from its
gathered weight where B1 all-gathers its ``x_in`` activation.  The
verdicts say what the port's records show.

Run:  PYTHONPATH=src python -m repro_torch.bench.perf_experiments
      [--pairs A,C] [--out PATH]

Records go to ``results/perf_experiments_torch.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import traceback

from repro_torch.bench import common
from repro_torch.launch import dryrun

OUT_NAME = "perf_experiments_torch.json"
FORCE_FSDP = "REPRO_FORCE_FSDP"
#: the quantities each experiment is held to its pair's baseline by
RATIO_KEYS = ("compute_s", "memory_s", "collective_s", "bytes_per_device")

# The baselines A0/B0/C0 pin the knobs as they were before the reference
# adopted its winning variants (B1/B3/C2 are now the defaults).
# ``predicts``: (term, direction, the experiment it changes).
EXPERIMENTS = [
    # --- Pair A: MLA long-context decode ------------------------------------
    dict(name="A0_baseline_mla_naive", arch="deepseek-v2-lite-16b",
         shape="long_500k", kw={"mla_absorbed": False},
         hypothesis="baseline: naive MLA reconstructs K/V (S×r×H·(dn+dv)"
                    " flops + S×H×(dn+dv) bytes per layer per step)"),
    dict(name="A1_mla_absorbed", arch="deepseek-v2-lite-16b",
         shape="long_500k", kw={"mla_absorbed": True},
         predicts=("compute_s", "down", "A0_baseline_mla_naive"),
         hypothesis="absorption scores against the latent cache directly;"
                    " predict compute ↓ by more than 5x (no K/V"
                    " re-expansion)"),
    dict(name="A2_absorbed_seqshard", arch="deepseek-v2-lite-16b",
         shape="long_500k", kw={"mla_absorbed": True},
         seq_shard_cache=True,
         predicts=("bytes_per_device", "down", "A1_mla_absorbed"),
         hypothesis="also shard the latent-cache sequence over data"
                    " (flash-decode); predict bytes per device ↓"),
    # --- Pair B: xlstm collective-bound train -------------------------------
    dict(name="B0_baseline_fsdp", arch="xlstm-350m", shape="train_4k",
         kw={"xlstm_pin_inner": False, "loss_chunk": 512},
         force_fsdp=True,
         hypothesis="baseline: FSDP shards the 350M params over data;"
                    " every layer all-gathers its weights each step"),
    dict(name="B1_no_fsdp", arch="xlstm-350m", shape="train_4k",
         kw={"xlstm_pin_inner": False, "loss_chunk": 512},
         predicts=("collective_s", "down", "B0_baseline_fsdp"),
         hypothesis="replicating the params removes the per-layer weight"
                    " all-gathers; predict collective ↓"),
    dict(name="B3_pin_inner", arch="xlstm-350m", shape="train_4k",
         kw={"xlstm_pin_inner": True, "loss_chunk": 512},
         predicts=("collective_s", "down", "B1_no_fsdp"),
         hypothesis="pin the mLSTM up-projection's [B,S,di] output"
                    " replicated over 'model' instead of gathering it for"
                    " the 4-head reshape; predict collective ↓, compute ↑"
                    " (replicated matmul)"),
    # --- Pair C: MoE expert-parallel train ----------------------------------
    dict(name="C0_baseline_sp", arch="deepseek-moe-16b", shape="train_4k",
         kw={"seq_parallel": True, "loss_chunk": 512},
         hypothesis="baseline: Megatron-SP residual + expert parallelism"
                    " (the dense-model default)"),
    dict(name="C1_bf16_psum", arch="deepseek-moe-16b", shape="train_4k",
         kw={"seq_parallel": True, "loss_chunk": 512,
             "moe_bf16_combine": True},
         predicts=("collective_s", "down", "C0_baseline_sp"),
         hypothesis="halve the expert-combine psum bytes with bf16;"
                    " predict collective ↓"),
    dict(name="C2_no_sp", arch="deepseek-moe-16b", shape="train_4k",
         kw={"seq_parallel": False, "loss_chunk": 512},
         predicts=("collective_s", "down", "C0_baseline_sp"),
         hypothesis="SP reshards the residual around the MoE each layer;"
                    " disable SP for MoE -> predict collective ↓ at the"
                    " cost of unsharded saved carries (bytes ↑)"),
    dict(name="C4_no_sp_bf16combine", arch="deepseek-moe-16b",
         shape="train_4k",
         kw={"seq_parallel": False, "loss_chunk": 512,
             "moe_bf16_combine": True},
         predicts=("bytes_per_device", "down", "C2_no_sp"),
         hypothesis="keep the [T,k,d] weighted combine in bf16 instead of"
                    " f32 -> predict bytes per device ↓ with C2's"
                    " collective kept"),
]


def baseline_of(name: str) -> str:
    """The baseline of an experiment's pair: A0, B0 or C0."""
    return next(e["name"] for e in EXPERIMENTS
                if e["name"].startswith(f"{name[0]}0"))


def _value(rec: dict, key: str) -> float:
    return rec[key] if key == "bytes_per_device" else rec["roofline"][key]


def verdict(rec: dict, against: dict, term: str, direction: str) -> str:
    """``confirmed`` / ``refuted`` / ``unchanged``: how ``term`` moved
    from ``against`` to ``rec``, read against the predicted direction."""
    now, before = _value(rec, term), _value(against, term)
    if now == before:
        return "unchanged"
    return "confirmed" if (now < before) == (direction == "down") \
        else "refuted"


@contextlib.contextmanager
def forced_fsdp(on: bool):
    """``REPRO_FORCE_FSDP`` set inside the block where ``on``, cleared
    where not; the caller's value back afterwards."""
    saved = os.environ.pop(FORCE_FSDP, None)
    if on:
        os.environ[FORCE_FSDP] = "1"
    try:
        yield
    finally:
        os.environ.pop(FORCE_FSDP, None)
        if saved is not None:
            os.environ[FORCE_FSDP] = saved


def run_experiment(ex: dict) -> dict:
    """One experiment's dry-run record; a run that raises is a ``FAILED``
    record with its error, as ``run_one`` records its own failures."""
    try:
        with forced_fsdp(ex.get("force_fsdp", False)):
            rec = dryrun.run_one(
                ex["arch"], ex["shape"],
                seq_shard_cache=ex.get("seq_shard_cache", False),
                extra_cfg_kw=dict(ex.get("kw") or {}) or None)
    except Exception as e:                          # noqa: BLE001
        rec = {"arch": ex["arch"], "shape": ex["shape"], "status": "FAILED",
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-2000:]}
    rec["experiment"] = ex["name"]
    rec["hypothesis"] = ex["hypothesis"]
    return rec


def compare(results: list[dict]) -> None:
    """Add ``baseline``, ``vs_baseline`` and ``verdict`` to each ok record
    from the records of this run (a ratio or verdict whose other record
    did not run ok is ``None``)."""
    ok = {r["experiment"]: r for r in results if r["status"] == "ok"}
    predicts = {e["name"]: e.get("predicts") for e in EXPERIMENTS}
    for rec in ok.values():
        name = rec["experiment"]
        base = ok.get(baseline_of(name))
        rec["baseline"] = baseline_of(name)
        rec["vs_baseline"] = {
            k: (_value(rec, k) / _value(base, k)
                if base is not None and _value(base, k) else None)
            for k in RATIO_KEYS}
        if predicts.get(name) is None:
            rec["verdict"] = "baseline"
            continue
        term, direction, against = predicts[name]
        rec["predicts"] = {"term": term, "direction": direction,
                           "against": against}
        rec["verdict"] = (verdict(rec, ok[against], term, direction)
                          if against in ok else None)


def run(experiments=None, out: str = "") -> list[dict]:
    """Run ``experiments`` (default all of :data:`EXPERIMENTS`) and write
    their records to ``out`` (default
    ``results/perf_experiments_torch.json``)."""
    results = []
    for ex in EXPERIMENTS if experiments is None else experiments:
        print(f"\n[perf] === {ex['name']}: {ex['hypothesis']}", flush=True)
        rec = run_experiment(ex)
        results.append(rec)
        if rec["status"] == "ok":
            ro = rec["roofline"]
            print(f"[perf] terms: compute={ro['compute_s']:.3e} "
                  f"memory={ro['memory_s']:.3e} "
                  f"collective={ro['collective_s']:.3e} "
                  f"dominant={ro['dominant']} "
                  f"mem/dev={rec['bytes_per_device']/2**30:.2f}GiB",
                  flush=True)
        else:
            print(f"[perf] FAILED: {rec.get('error')}", flush=True)
    compare(results)
    for rec in results:
        if rec.get("verdict") not in (None, "baseline"):
            p = rec["predicts"]
            print(f"[perf] {rec['experiment']}: {p['term']} "
                  f"{p['direction']} vs {p['against']}: {rec['verdict']}")
    out = out or os.path.join(common.RESULTS_DIR, OUT_NAME)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"\n[perf] wrote {out}")
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--pairs", default="",
                    help="comma-separated pairs to run (default A,B,C)")
    ap.add_argument("--out", default="",
                    help=f"records path (default results/{OUT_NAME})")
    args = ap.parse_args()
    pairs = set(args.pairs.split(",")) if args.pairs else None
    run([e for e in EXPERIMENTS if pairs is None or e["name"][0] in pairs],
        out=args.out)
