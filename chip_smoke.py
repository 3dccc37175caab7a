#!/usr/bin/env python3
"""Drive the PyTorch port's profile -> predict -> decide path on one CUDA card.

    python3 chip_smoke.py

Phases, in order (any failed check exits non-zero; nothing is caught):

1. Environment: the card's name and power limit (nvidia-smi), then the
   three CUDA kernels built from ``src/repro_torch/csrc`` in parallel.
2. The slice at full width, through the entry points a user calls: a
   ``GBTRegressor(n_trees=200, max_depth=12, subsample=0.8, n_bins=64)``
   fitted on the card (``gbt_hist`` kernel) on ~15.8k per-layer rows of all
   ten configs on the five edge devices, then ``decide_all`` over 2^20
   environments for qwen3-1.7b at its published shape (28 layers) with a
   ``PredictorCost`` (``tree_predict`` + ``decide_split`` kernels), with a
   ``CompositeCost`` over it, and the analytic default over a mixed fleet.
   Each plan is held against the exact f64 ``backend="torch"`` sweep.
3. Each kernel against its plain PyTorch version on the card, at the
   slice's shapes, with the tolerance stated beside each check.
4. Launch counts of the main-path run (every kernel must have launched).
5. Timing with CUDA events after a warm-up: each kernel, its plain
   version, the library call where one computes the same function, and
   the bound (the larger of bytes over 3.35 TB/s and operations over
   67 TFLOP/s non-tensor f32, the H100 SXM's published rates).

The line before the last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or run from a
directory that holds this file and nothing else of the repository, it
fails before printing any result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12            # H100 SXM device memory
F32_OPS_PER_S = 67e12                # H100 SXM f32 outside the tensor cores
N_ENVS = 1 << 20
SEED = 0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(ok, msg: str) -> None:
    if not ok:
        fail(msg)


def line(tag: str, **kv) -> None:
    print(json.dumps({tag: kv}), flush=True)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"{ROOT / 'src' / 'repro_torch'} is missing: run from a "
             "checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch import configs
    from repro_torch.core import costs as co
    from repro_torch.core import decisions as dec
    from repro_torch.core import offload as off
    from repro_torch.core.predictors.gbt import GBTRegressor, bin_data
    from repro_torch.hw import EDGE_DEVICES, get_device
    from repro_torch.kernels import _build
    from repro_torch.kernels.decide_split import kernel as ds_kernel
    from repro_torch.kernels.decide_split import ops as ds_ops
    from repro_torch.kernels.decide_split import ref as ds_ref
    from repro_torch.kernels.gbt_hist import kernel as gh_kernel
    from repro_torch.kernels.gbt_hist import ref as gh_ref
    from repro_torch.kernels.tree_predict import kernel as tp_kernel
    from repro_torch.kernels.tree_predict import ref as tp_ref

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # -- 1. environment -----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    line("environment", python=sys.version.split()[0],
         torch=torch.__version__, cuda=torch.version.cuda, device=kind,
         device_count=torch.cuda.device_count())
    t0 = time.perf_counter()
    logs = _build.build()
    build_s = time.perf_counter() - t0
    for name, log in logs.items():
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"ptxas {name}: {ln.strip()}")
    line("build", seconds=build_s, compiled=sorted(logs))

    wrappers = {"gbt_hist": gh_kernel.grad_histogram_kernel,
                "tree_predict": tp_kernel.tree_predict_kernel,
                "decide_split": ds_kernel.decide_split_kernel}

    # -- 2. the slice at full width ----------------------------------------
    feats, times = [], []
    for name in configs.ARCH_NAMES:
        cfg = configs.get_config(name)
        for seq in (128, 512, 2048, 8192):
            for batch in (1, 4, 16):
                layers = off.transformer_layer_costs(cfg, seq, batch)
                for spec in EDGE_DEVICES.values():
                    feats.append(co.default_layer_features(layers, spec))
                    times.append([off.layer_time(lc.flops, spec)
                                  for lc in layers])
    x, y = np.concatenate(feats), np.concatenate(times)
    line("training_set", rows=int(x.shape[0]), features=int(x.shape[1]))

    qwen = configs.get_config("qwen3-1.7b")
    layers = off.transformer_layer_costs(qwen, seq_len=4096, batch_size=1)
    check(len(layers) == 28 and qwen.d_model == 2048,
          "qwen3-1.7b is not at its published shape")
    pi5, a100 = get_device("pi5-arm"), get_device("edge-server-a100")
    bw = np.geomspace(1e5, 1e10, N_ENVS)
    fleet = [get_device(n) for n in ("xps15-i5", "gtx-1650", "pi5-arm",
                                     "jetson-orin-nano")]
    gbt_kw = dict(n_trees=200, max_depth=12, subsample=0.8, n_bins=64,
                  seed=SEED)

    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gbt = GBTRegressor(**gbt_kw).fit(x, y, device=dev)
    torch.cuda.synchronize()
    t_fit = time.perf_counter()
    envs = dec.make_envs(pi5, a100, link_bw=bw, link_latency_s=0.005,
                         input_bytes=4 * 4096, device=dev)
    pcost = co.PredictorCost(gbt, pi5, a100)
    plan_p = dec.decide_all(layers, envs, cost=pcost)
    torch.cuda.synchronize()
    t_decide = time.perf_counter()
    ccost = co.CompositeCost(base=co.PredictorCost(gbt, pi5, a100),
                             weights={"latency_s": 1.0, "energy_j": 0.05})
    plan_c = dec.decide_all(layers, envs, cost=ccost)
    envs_mix = dec.make_envs([fleet[i % 4] for i in range(N_ENVS)], a100,
                             link_bw=bw, link_latency_s=0.005,
                             input_bytes=4 * 4096, device=dev)
    plan_a = dec.decide_all(layers, envs_mix)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = {k: w.launches for k, w in wrappers.items()}
    print(json.dumps({"launch_counts": launches}), flush=True)
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was not launched on the main path")
    line("e2e", fit_s=t_fit - t0, predict_and_decide_s=t_decide - t_fit,
         fit_predict_decide_s=t_decide - t0,
         composite_and_fleet_decide_s=t_end - t_decide,
         n_envs=N_ENVS, n_layers=len(layers))

    # every plan: finite, right shape, near-optimal against exact f64
    for name, plan, cost, e in (("predictor", plan_p, pcost, envs),
                                ("composite", plan_c, ccost, envs),
                                ("analytic_fleet", plan_a, None, envs_mix)):
        exact = dec.decide_all(layers, e, cost=cost, backend="torch")
        check(plan.splits.shape == (N_ENVS,), f"{name}: plan shape")
        check(bool(((plan.splits >= 0) & (plan.splits <= len(layers)))
                   .all()), f"{name}: split out of range")
        check(bool(torch.isfinite(plan.total_time_s).all()),
              f"{name}: non-finite latency")
        got = plan.total_time_s if plan.scalar_cost is None \
            else plan.scalar_cost
        ref = exact.total_time_s if exact.scalar_cost is None \
            else exact.scalar_cost
        gap = (got - ref) / ref
        check(bool((got <= ref * (1 + 1e-4) + 1e-12).all()),
              f"{name}: a kernel split is worse than the f64 optimum by "
              f"more than 1e-4 (max {gap.max().item()})")
        line("plan_check", plan=name,
             split_match_share=(plan.splits == exact.splits).double()
             .mean().item(), max_rel_gap=gap.max().item(),
             distinct_splits=int(torch.unique(plan.splits).numel()))
        del exact

    # -- 3. kernels against their plain versions ---------------------------
    records = {}

    # gbt_hist at the first tree's root node: the fit's largest histogram
    rows = np.random.default_rng(SEED).random(len(y)) < 0.8
    codes = torch.as_tensor(bin_data(x[rows], gbt.edges_).astype(np.int32),
                            device=dev)
    grad = torch.as_tensor((y - y.mean())[rows], dtype=torch.float32,
                           device=dev)
    gsum, cnt = gh_kernel.grad_histogram_kernel(codes, grad, 64)
    torch.cuda.synchronize()
    pg, pc = gh_ref.grad_histogram_ref(codes, grad, 64)
    abs_sum, _ = gh_ref.grad_histogram_ref(codes, grad.abs(), 64)
    check(torch.equal(cnt.double(), pc), "gbt_hist: counts differ")
    err = (gsum.double() - pg).abs()
    # f32 atomics in a varying order over up to N rows: |err| <= 1e-4 of
    # the bin's sum of |g| (f32 rounding is 6e-8 a step)
    check(bool((err <= 1e-4 * abs_sum).all()),
          f"gbt_hist: gsum off by {(err / abs_sum.clamp_min(1e-30)).max()}"
          " of the bin's |g| sum (tolerance 1e-4)")
    records["gbt_hist"] = dict(max_abs_err=err.max().item(),
                               shape=list(codes.shape))
    line("kernel_check", kernel="gbt_hist", rows=int(codes.shape[0]),
         counts_exact=True, max_abs_err=err.max().item(),
         max_rel_err_of_abs_sum=(err / abs_sum.clamp_min(1e-30)).max()
         .item())

    # kernel-fitted GBT against a plain (CPU) fit of the same settings
    t0 = time.perf_counter()
    gbt_plain = GBTRegressor(**gbt_kw).fit(x, y, device="cpu")
    plain_fit_s = time.perf_counter() - t0
    pk = gbt.predict(x, device=dev).cpu().numpy()
    pp = gbt_plain.predict(x, device="cpu").numpy()
    span = float(y.max() - y.min())
    rel = float(np.sqrt(np.mean((pk - pp) ** 2)) / span)
    rmse_k = float(np.sqrt(np.mean((pk - y) ** 2)))
    rmse_p = float(np.sqrt(np.mean((pp - y) ** 2)))
    same = sum(len(a) == len(b) and all(
        (n.feature, n.threshold_bin) == (m.feature, m.threshold_bin)
        for n, m in zip(a, b)) for a, b in zip(gbt.trees_, gbt_plain.trees_))
    line("fit_check", plain_fit_s=plain_fit_s, nrmse_kernel_vs_plain=rel,
         rmse_kernel_fit=rmse_k, rmse_plain_fit=rmse_p,
         trees_with_identical_splits=same, n_trees=len(gbt.trees_))
    # the f32 histogram may flip near-tied splits, so the two ensembles may
    # differ; they must predict alike (1% of the target span) and fit alike
    check(rel <= 1e-2, f"kernel-fitted GBT differs from the plain fit by "
          f"{rel} of the target span (tolerance 1e-2)")
    check(abs(rmse_k - rmse_p) <= 1e-2 * span,
          "kernel and plain fits differ in training error")

    # tree_predict at the decision path's shape: 2L feature rows
    arrays = tp_ref.flatten_gbt(gbt)
    trees = tp_ref.device_trees(arrays, dev)
    feats_p = np.concatenate([co.default_layer_features(layers, pi5),
                              co.default_layer_features(layers, a100)])
    tcodes = tp_ref.bin_codes_ref(torch.as_tensor(feats_p, device=dev),
                                  trees.edges)
    targs = (tcodes, trees.feature, trees.threshold_bin, trees.left,
             trees.right, trees.scaled_value)
    tkw = dict(max_depth=arrays.max_depth, base=arrays.base)
    tk = tp_kernel.tree_predict_kernel(*targs, **tkw)
    torch.cuda.synchronize()
    tpl = tp_ref.tree_predict_ref(*targs, **tkw)
    # f64 additions in the plain version's order: exactly equal
    check(torch.equal(tk, tpl), "tree_predict: kernel differs from plain "
          f"(max {(tk - tpl).abs().max().item()}; tolerance: exact)")
    records["tree_predict"] = dict(max_abs_err=(tk - tpl).abs().max()
                                   .item(), shape=list(tcodes.shape))
    line("kernel_check", kernel="tree_predict", rows=int(tcodes.shape[0]),
         trees=arrays.n_trees, max_nodes=arrays.max_nodes,
         max_depth=arrays.max_depth,
         max_abs_err=records["tree_predict"]["max_abs_err"])

    # decide_split: the predictor sweep's packed inputs, and L = 300 random
    # layers over 2^20 - 3 mixed environments
    rng = np.random.default_rng(SEED)
    layers300 = [off.LayerCost(f"l{i}", float(f), float(a)) for i, (f, a)
                 in enumerate(zip(rng.uniform(1e6, 1e12, 300),
                                  rng.uniform(1e2, 1e8, 300)))]
    n300 = N_ENVS - 3
    specs = list(EDGE_DEVICES.values())
    envs300 = dec.make_envs(
        [specs[i] for i in rng.integers(len(specs), size=n300)], a100,
        link_bw=rng.uniform(1e4, 1e10, n300),
        link_latency_s=rng.uniform(0.0, 0.05, n300),
        input_bytes=rng.uniform(0.0, 1e7, n300), device=dev)
    packed = {
        "main": (ds_ops.pack_inputs(layers, envs, co.lower_to_accel(pcost))
                 .kernel_args, len(layers)),
        "L300": (ds_ops.pack_inputs(layers300, envs300,
                                    co.lower_to_accel(None)).kernel_args,
                 300),
    }
    for case, (args, n_l) in packed.items():
        ks, kc = ds_kernel.decide_split_kernel(*args)
        torch.cuda.synchronize()
        ps, pcst = ds_ref.decide_split_ref(*args)
        # the min is continuous even where a near-tie flips the argmin
        check(torch.allclose(kc, pcst, rtol=1e-5, atol=0.0),
              f"decide_split {case}: costs differ from plain (rtol 1e-5)")
        share = (ks == ps).double().mean().item()
        line("kernel_check", kernel="decide_split", case=case,
             n_envs=int(ks.numel()), n_splits=n_l + 1,
             split_match_share=share,
             max_abs_err=(kc - pcst).abs().max().item())
        if case == "main":
            records["decide_split"] = dict(
                max_abs_err=(kc - pcst).abs().max().item(),
                shape=[int(ks.numel()), n_l + 1])
        del ps, pcst
    plan300 = dec.decide_all(layers300, envs300)
    exact300 = dec.decide_all(layers300, envs300, backend="torch")
    check(bool((plan300.total_time_s <= exact300.total_time_s * (1 + 1e-4)
                + 1e-12).all()), "L300: kernel split not near-optimal")
    line("plan_check", plan="L300_analytic",
         split_match_share=(plan300.splits == exact300.splits).double()
         .mean().item())
    del exact300

    # -- 5. timing ---------------------------------------------------------
    def cuda_ms(fn, reps: int, groups: int = 5) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(groups):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end) / reps)
        return statistics.median(out)

    def bound(nbytes: float, ops: float) -> tuple[float, str]:
        tb, to = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
        return max(tb, to) * 1e3, "bytes" if tb >= to else "operations"

    n, f = codes.shape
    flat = (codes.long() + torch.arange(f, device=dev) * 64).reshape(-1)
    wts = grad.double().repeat_interleave(f)
    gh_bound = bound(n * f * 4 + n * 4 + 2 * f * 64 * 4, 2 * n * f)
    gh_times = dict(
        ms=cuda_ms(lambda: gh_kernel.grad_histogram_kernel(codes, grad, 64),
                   50),
        plain_ms=cuda_ms(lambda: gh_ref.grad_histogram_ref(codes, grad, 64),
                         20),
        library_ms=cuda_ms(lambda: (torch.bincount(flat, weights=wts,
                                                   minlength=f * 64),
                                    torch.bincount(flat, minlength=f * 64)),
                           20))

    # tree_predict operations: one compare per split node visited, one f64
    # add per (row, tree) — counted on this run's data (bytes bound it)
    visits = 0
    for i in range(arrays.n_trees):
        node = torch.zeros(tcodes.shape[0], dtype=torch.int64, device=dev)
        for _ in range(arrays.max_depth):
            ft = trees.feature[i][node].long()
            split = ft >= 0
            visits += int(split.sum())
            nxt = torch.where(
                tcodes[torch.arange(len(node), device=dev), ft.clamp_min(0)]
                <= trees.threshold_bin[i][node], trees.left[i][node],
                trees.right[i][node]).long()
            node = torch.where(split, nxt, node)
    n_rows = tcodes.shape[0]
    tp_bound = bound(tcodes.numel() * 4 + 4 * trees.feature.numel() * 4
                     + trees.scaled_value.numel() * 8 + n_rows * 8,
                     visits + n_rows * arrays.n_trees)
    tp_times = dict(
        ms=cuda_ms(lambda: tp_kernel.tree_predict_kernel(*targs, **tkw), 50),
        plain_ms=cuda_ms(lambda: tp_ref.tree_predict_ref(*targs, **tkw), 3,
                         groups=3),
        library_ms=None)

    args, n_l = packed["main"]
    n_env = args[3].numel()
    ds_bound = bound(3 * (n_l + 1) * 4 + 12 * 4 + n_env * (7 * 4 + 8),
                     30 * n_env * (n_l + 1))
    ds_times = dict(
        ms=cuda_ms(lambda: ds_kernel.decide_split_kernel(*args), 20),
        plain_ms=cuda_ms(lambda: ds_ref.decide_split_ref(*args), 5),
        library_ms=None)
    args300, _ = packed["L300"]
    line("timing_extra", kernel="decide_split", case="L300",
         n_envs=int(args300[3].numel()),
         ms=cuda_ms(lambda: ds_kernel.decide_split_kernel(*args300), 5),
         plain_ms=cuda_ms(lambda: ds_ref.decide_split_ref(*args300), 2,
                          groups=3),
         bound_ms=bound(3 * 301 * 4 + 12 * 4 + n300 * 36,
                        30 * n300 * 301)[0])

    src = {"gbt_hist": ("src/repro_torch/csrc/gbt_hist.cu",
                        "src/repro/kernels/gbt_hist/kernel.py:49",
                        gh_times, gh_bound),
           "tree_predict": ("src/repro_torch/csrc/tree_predict.cu",
                            "src/repro/kernels/tree_predict/kernel.py:76",
                            tp_times, tp_bound),
           "decide_split": ("src/repro_torch/csrc/decide_split.cu",
                            "src/repro/kernels/decide_split/kernel.py:116",
                            ds_times, ds_bound)}
    kernels = []
    for name, (source, replaces, t, (bound_ms, bound_by)) in src.items():
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": records[name]["max_abs_err"],
                        "ms": t["ms"], "plain_ms": t["plain_ms"],
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": t["library_ms"],
                        "shape": records[name]["shape"]})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
