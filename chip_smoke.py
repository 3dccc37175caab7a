#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card: the profile -> predict -> decide
path, the serving path and the kernel bench.

    python3 chip_smoke.py

Phases, in order (any failed check exits non-zero; nothing is caught):

1. Environment: the card's name and power limit (nvidia-smi), then the
   six CUDA kernels built from ``src/repro_torch/csrc`` in parallel (one
   ``nvcc`` each), with each build's register and shared-memory lines;
   the SASS of ``flash_fwd_wgmma`` must hold HGMMA and UTMALDG.
2. The decision slice at full width, through the entry points a user calls:
   a ``GBTRegressor(n_trees=200, max_depth=12, subsample=0.8, n_bins=64)``
   fitted on the card (``gbt_hist`` kernel) on ~15.8k per-layer rows of all
   ten configs on the five edge devices, then ``decide_all`` over 2^20
   environments for qwen3-1.7b at its published shape (28 layers) with a
   ``PredictorCost`` (``tree_predict`` + ``decide_split`` kernels), with a
   ``CompositeCost`` over it, and the analytic default over a mixed fleet.
   Each plan is held against the exact f64 ``backend="torch"`` sweep.
   Launch counts of the three kernels are read right after this path.
3. The serving slice at full width: ``ServeEngine(cfg, batch_size=4,
   max_len=2088, seed=0)`` on qwen3-1.7b and on zamba2-1.2b at their
   published shapes in bf16, each serving 8 greedy requests of 2048 random
   tokens with 32 new tokens (``flash_attention`` and ``ssm_scan``
   kernels; their launch counts are read right after both models, and
   every flash launch must have taken ``flash_fwd_wgmma``).  Every
   request must get 32 in-range tokens and every logit must be finite.
4. The whole model on the card: at each model's full width in f32, the
   kernel path (``build_model(cfg)``) and the plain path
   (``impl="naive"``) on one 512-token prompt with shared weights; their
   last-token logits must agree within 1e-3 of max |logit|.
5. Each kernel against its plain PyTorch version on the card, at the
   slices' shapes, with the tolerance stated beside each check; flash
   also against itself (two calls, the same bits).
6. Timing with CUDA events after a warm-up: each kernel, its plain
   version, the library call where one computes the same function, and
   the bound (the larger of bytes over 3.35 TB/s and operations over the
   peak of the work's type: 67 TFLOP/s f32 outside the tensor cores, or
   989 TFLOP/s dense bf16 on the tensor cores; the H100 SXM's published
   rates, defined once in ``repro_torch.bench.common``).  The bf16 flash
   kernel and SDPA are replayed from a CUDA graph, with the eager time
   beside it.
7. The kernel bench, ``repro_torch.bench.kernels.main()``, the entry point
   of ``int8_matmul`` (W8A16; no other path runs it): every kernel of the
   bench at its main path's shape and ``int8_matmul`` at qwen3-1.7b's five
   products (decode B 1 and B 4, the down projection, the LM head,
   prefill) in bf16, each held to its tolerance (``err_over_tol`` < 1;
   ``int8_matmul`` to ``int8_matmul.ref.int8_tolerance``) and timed beside
   its plain version, the library call and its bound.  The decode B 4 up
   projection is ``int8_matmul``'s record on the kernels line.

The line before the last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or run from a
directory that holds this file and nothing else of the repository, it
fails before printing any result.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_ENVS = 1 << 20
SEED = 0
SERVE_ARCHS = ("qwen3-1.7b", "zamba2-1.2b")
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW, SERVE_REQUESTS = 4, 2048, 32, 8
CHECK_PROMPT = 512                   # the whole-model f32 check


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(ok, msg: str) -> None:
    if not ok:
        fail(msg)


def line(tag: str, **kv) -> None:
    print(json.dumps({tag: kv}), flush=True)


def flash_sass(build) -> dict:
    """Counts of the Hopper instructions in each ``flash_fwd_wgmma``
    instance's SASS (``cuobjdump --dump-sass``): the tensor-core kernel
    must run warpgroup MMAs (HGMMA) fed by TMA loads (UTMALDG)."""
    counts, cur = {}, None
    for ln in build.sass("flash_attention").splitlines():
        if "Function : " in ln:
            cur = ln.split("Function : ")[1].strip()
            if "flash_fwd_wgmma" in cur:
                counts[cur] = dict.fromkeys(("HGMMA", "UTMALDG", "UTMASTG"), 0)
            else:
                cur = None
        elif cur:
            for op in counts[cur]:
                counts[cur][op] += op in ln
    check(len(counts) == 2, f"flash_fwd_wgmma: {len(counts)} instances in "
          "the SASS, expected 2 (D 64 and 128)")
    for fn, c in counts.items():
        check(c["HGMMA"] > 0 and c["UTMALDG"] > 0,
              f"{fn}: no HGMMA or no UTMALDG in its SASS ({c})")
    return counts


def serve_slice(dev, smi: str) -> dict:
    """The serving path at full width: ``ServeEngine`` on each model in
    bf16.  Returns the serving kernels' launch counts of this run."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.ssm_scan.kernel import ssd_scan_kernel
    from repro_torch.serve import Request, ServeEngine

    wrappers = {"flash_attention": fa_kernel.flash_attention_kernel,
                "ssm_scan": ssd_scan_kernel}
    expected = dict.fromkeys(wrappers, 0)
    n_batches = -(-SERVE_REQUESTS // SERVE_BATCH)
    for w in wrappers.values():
        w.launches = 0
    fa_kernel.reset_counts()
    for arch in SERVE_ARCHS:
        cfg = get_config(arch)
        check(cfg.dtype == "bfloat16", f"{arch}: dtype {cfg.dtype}")
        if cfg.family == "hybrid":
            expected["flash_attention"] += n_batches * -(
                -cfg.num_layers // cfg.shared_attn_every)
            expected["ssm_scan"] += n_batches * cfg.num_layers
        else:
            expected["flash_attention"] += n_batches * cfg.num_layers
        before = {k: w.launches for k, w in wrappers.items()}
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        eng = ServeEngine(cfg, batch_size=SERVE_BATCH,
                          max_len=SERVE_PROMPT + SERVE_NEW + 8, seed=SEED,
                          device=dev)
        torch.cuda.synchronize(dev)
        init_s = time.perf_counter() - t0
        finite, sample = [], eng._sample

        def checked(logits, temperature, gen, sample=sample, finite=finite):
            finite.append(torch.isfinite(logits).all())
            return sample(logits, temperature, gen)

        eng._sample = checked
        rng = np.random.default_rng(0)
        reqs = [Request(rid=i, prompt=rng.integers(
                    0, cfg.vocab_size, size=SERVE_PROMPT, dtype=np.int32),
                        max_new_tokens=SERVE_NEW, temperature=0.0,
                        arrived_at=i * 1e-3)
                for i in range(SERVE_REQUESTS)]
        t0 = time.perf_counter()
        done = eng.serve(reqs)
        serve_s = time.perf_counter() - t0
        check(sorted(r.rid for r in done) == list(range(SERVE_REQUESTS)),
              f"{arch}: not every request was answered")
        for r in done:
            check(r.output is not None and r.output.shape == (SERVE_NEW,)
                  and bool(((r.output >= 0)
                            & (r.output < cfg.vocab_size)).all()),
                  f"{arch}: request {r.rid} did not get {SERVE_NEW} "
                  "in-range tokens")
        check(bool(torch.stack(finite).all()), f"{arch}: a non-finite logit")
        st = eng.stats
        line("serve", model=arch, dtype=cfg.dtype, layers=cfg.num_layers,
             d_model=cfg.d_model, batch=SERVE_BATCH,
             requests=SERVE_REQUESTS, prompt_tokens=SERVE_PROMPT,
             new_tokens=SERVE_NEW, init_s=init_s, serve_s=serve_s,
             prefill_s=st.prefill_s, decode_s=st.decode_s,
             decode_tokens_per_s=st.tokens_per_s,
             first_token_s_per_batch=[r.first_token_s for r in
                                      done[::SERVE_BATCH]],
             max_memory_allocated_bytes=torch.cuda.max_memory_allocated(dev),
             launches={k: w.launches - before[k]
                       for k, w in wrappers.items()}, device=smi)
        del eng, finite
        torch.cuda.empty_cache()
    launches = {k: w.launches for k, w in wrappers.items()}
    by_kernel = dict(fa_kernel.flash_attention_kernel.by_kernel)
    print(json.dumps({"serve_launch_counts": launches,
                      "flash_by_kernel": by_kernel,
                      "expected": expected}), flush=True)
    for k, n in launches.items():
        check(n == expected[k], f"kernel {k} launched {n} times on the "
              f"serving path, expected {expected[k]}")
    # every bf16 prefill of the served models takes the tensor-core kernel
    check(by_kernel["flash_fwd_wgmma"] == expected["flash_attention"],
          f"flash_attention: {by_kernel} on the serving path, expected all "
          f"{expected['flash_attention']} launches on flash_fwd_wgmma")
    return launches


def model_check(dev) -> None:
    """Each model at full width in f32: the kernel path against the plain
    path (``impl="naive"``) with shared weights on one prompt."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    # plain f32 products on both paths (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for arch in SERVE_ARCHS:
        cfg = get_config(arch).replace(dtype="float32")
        fast, plain = build_model(cfg), build_model(cfg, impl="naive")
        params = fast.init_params(SEED, dev)
        tokens = torch.as_tensor(np.random.default_rng(SEED).integers(
            0, cfg.vocab_size, size=(1, CHECK_PROMPT)), device=dev)
        with torch.inference_mode():
            got, _ = fast.prefill(params, {"tokens": tokens}, CHECK_PROMPT)
            want, _ = plain.prefill(params, {"tokens": tokens},
                                    CHECK_PROMPT)
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        line("model_check", model=arch, dtype="float32",
             prompt_tokens=CHECK_PROMPT, max_abs_err=err,
             max_abs_logit=scale, rel_err=err / scale,
             same_argmax=bool(got.argmax() == want.argmax()))
        check(bool(torch.isfinite(got).all()), f"{arch}: non-finite logits")
        # f32 sums in other orders through every layer: 1e-3 of max|logit|
        check(err <= 1e-3 * scale, f"{arch}: kernel path differs from the "
              f"plain path by {err / scale} of max|logit| (tolerance 1e-3)")
        del params, got, want
        torch.cuda.empty_cache()


def serving_kernels(dev, launches: dict) -> list:
    """Each serving kernel against its plain version at the serving shapes,
    then timed; returns their records for the kernels line."""
    import torch
    import torch.nn.functional as F
    from repro_torch.bench.common import (BF16_OPS_PER_S, F32_OPS_PER_S,
                                          bound, timed_ms)
    from repro_torch.bench.kernels import flash_work, ssm_work
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.ssm_scan import kernel as ss_kernel
    from repro_torch.kernels.ssm_scan import ref as ss_ref

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, dtype=torch.float32, scale=0.5):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).to(dtype)

    def plain_attn(q, k, v, **kw):
        return fa_ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2), **kw).transpose(1, 2)

    # (case, B, S, Hq, Hkv, D, window, valid_len); the first two are the
    # prefill attention of qwen3-1.7b and of zamba2's shared block; the
    # last is gemma-2b's head dim (not on this path)
    cases = [("qwen3", 4, 2048, 16, 8, 128, 0, 0),
             ("zamba2", 4, 2048, 32, 32, 64, 0, 0),
             ("window512", 4, 2048, 16, 8, 128, 512, 0),
             ("valid_len1500", 4, 2048, 16, 8, 128, 0, 1500),
             ("gemma_d256", 1, 2048, 8, 1, 256, 0, 0)]
    timed = {}
    for case, b, s, hq, hkv, d, window, valid in cases:
        for dtype in (torch.bfloat16, torch.float32):
            # unit scale: scores of std 1, so the softmax is not flat
            q = randn(b, s, hq, d, dtype=dtype, scale=1.0)
            k, v = (randn(b, s, hkv, d, dtype=dtype, scale=1.0)
                    for _ in range(2))
            kw = dict(causal=True, window=window, valid_len=valid)
            got = fa_kernel.flash_attention_kernel(q, k, v, **kw)
            torch.cuda.synchronize()
            # the same bits on a second call: no race on the K/V ring
            check(torch.equal(got, fa_kernel.flash_attention_kernel(
                q, k, v, **kw)), f"flash_attention {case} {dtype}: two "
                "calls on the same inputs differ")
            if dtype == torch.float32:
                # the JAX package's 2e-5, absolute plus relative
                want = plain_attn(q, k, v, **kw)
                tol = 2e-5 + 2e-5 * want.abs()
                rule = "2e-5 abs + rel"
            else:
                # the f32 attention of the same bf16 values, and per
                # element the rounding of P and of the output to bf16
                want, tol = (t.transpose(1, 2) for t in fa_ref.bf16_tolerance(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    **kw))
                rule = ("2e-5 + 2^-8 (|want| + min(sum p|v|, "
                        "8 sqrt(sum p^2 v^2)))")
            err = (got.float() - want).abs()
            over = (err / tol).max().item()
            line("kernel_check", kernel="flash_attention", case=case,
                 dtype=str(dtype).split(".")[-1], shape=[b, s, hq, hkv, d],
                 window=window, valid_len=valid,
                 max_abs_err=err.max().item(), err_over_tol=over,
                 median_tol=tol.median().item(), tolerance=rule)
            check(over <= 1.0, f"flash_attention {case} {dtype}: off by "
                  f"{over} of its tolerance ({rule})")
            del tol
            if case in ("qwen3", "zamba2") and (
                    dtype == torch.bfloat16 or case == "qwen3"):
                timed[case, dtype] = (q, k, v, err.max().item())
            del got, want, err

    def flash_times(q, k, v, ops_per_s, graph):
        """The kernel and SDPA replayed from a CUDA graph (``graph``), so
        the ctypes launch path stays out of a ~0.2 ms figure, and eager."""
        b, s, hq, d = q.shape
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def kernel():
            return fa_kernel.flash_attention_kernel(q, k, v)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)

        return dict(
            ms=timed_ms(kernel, 10, graph=graph),
            eager_ms=timed_ms(kernel, 10),
            plain_ms=timed_ms(lambda: plain_attn(q, k, v), 3, groups=3),
            library_ms=timed_ms(sdpa, 10, graph=graph),
            library_eager_ms=timed_ms(sdpa, 10),
            timing="graph" if graph else "eager",
            bound=bound(*flash_work(b, s, hq, k.shape[2], d,
                                    q.element_size()), ops_per_s))

    bf16 = torch.bfloat16
    # the tensor-core kernel's walk over key tiles at the qwen3 shape
    tiles = fa_kernel.classify_key_tiles(2048, 2048, d=128, causal=True)
    per_head = {c: sum(len(getattr(t, c)) for t in tiles)
                for c in ("skipped", "masked", "full")}
    line("flash_tiles", shape=[4, 2048, 16, 8, 128],
         block_q=fa_kernel.BLOCK_Q[128], block_k=fa_kernel.BLOCK_K,
         query_tiles_per_head=len(tiles),
         key_tiles_per_head=per_head,
         visited_per_call=4 * 16 * (per_head["masked"] + per_head["full"]),
         masked_per_call=4 * 16 * per_head["masked"])
    fa = flash_times(*timed["qwen3", bf16][:3], BF16_OPS_PER_S, True)
    fa_err = timed["qwen3", bf16][3]
    line("timing_extra", kernel="flash_attention", case="qwen3",
         dtype="bfloat16", shape=[4, 2048, 16, 128],
         **{k: v for k, v in fa.items() if k != "bound"},
         bound_ms=fa["bound"][0], bound_by=fa["bound"][1])
    # the zamba2 shape (tensor cores), and the f32 CUDA-core kernel that
    # f32 models run, at the qwen3 shape against the f32 peak (eager: it
    # sets its shared-memory limit at every launch)
    for (case, dtype), rate, graph in (
            (("zamba2", bf16), BF16_OPS_PER_S, True),
            (("qwen3", torch.float32), F32_OPS_PER_S, False)):
        t = flash_times(*timed[case, dtype][:3], rate, graph)
        line("timing_extra", kernel="flash_attention", case=case,
             dtype=str(dtype).split(".")[-1],
             shape=list(timed[case, dtype][0].shape),
             **{k: v for k, v in t.items() if k != "bound"},
             bound_ms=t["bound"][0], bound_by=t["bound"][1])
    del timed

    b, s, h, p, n, chunk = 4, 2048, 64, 64, 64, 128   # zamba2's Mamba2
    x = randn(b, s, h, p)
    dt = F.softplus(randn(b, s, h) - 4.0)             # the dt_bias of init
    a_log = torch.log(torch.linspace(1.0, 16.0, h, device=dev))
    bm, cm = randn(b, s, n), randn(b, s, n)
    xdt, loga = ss_ref.ssd_inputs(x, dt, a_log)
    args = (xdt, loga, bm, cm, chunk)
    y, st = ss_kernel.ssd_scan_kernel(*args)
    torch.cuda.synchronize()
    y_p, st_p = ss_ref.ssd_scan_chunked_ref(*args)
    errs = {}
    for name, got, want in (("y", y, y_p), ("state", st, st_p)):
        err = (got - want).abs()
        scale = want.abs().max().item()
        errs[name] = err.max().item()
        # f32 in another order: the JAX package's 2e-4, rel + abs of scale
        check(bool((err <= 2e-4 * want.abs() + 2e-4 * scale).all()),
              f"ssm_scan {name}: off by {errs[name]} (scale {scale}, "
              "tolerance 2e-4)")
    line("kernel_check", kernel="ssm_scan", shape=[b, s, h, p, n],
         chunk=chunk, max_abs_err_y=errs["y"],
         max_abs_err_state=errs["state"], tolerance=2e-4)
    ss = dict(ms=timed_ms(lambda: ss_kernel.ssd_scan_kernel(*args), 10),
              plain_ms=timed_ms(lambda: ss_ref.ssd_scan_chunked_ref(*args),
                                2, groups=3),
              library_ms=None,
              bound=bound(*ssm_work(b, s, h, p, n, chunk), F32_OPS_PER_S))

    out = []
    for name, t, err, shape, source, replaces in (
            ("flash_attention", fa, fa_err, [4, 2048, 16, 8, 128],
             "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:78"),
            ("ssm_scan", ss, max(errs.values()), [b, s, h, p, n],
             "src/repro_torch/csrc/ssm_scan.cu",
             "src/repro/kernels/ssm_scan/kernel.py:73")):
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": err, "ms": t["ms"],
                    "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
                    "bound_by": t["bound"][1],
                    "library_ms": t["library_ms"], "shape": shape})
    # flash: replayed from a CUDA graph; the eager call beside it
    out[0].update(timing="graph", eager_ms=fa["eager_ms"],
                  library_eager_ms=fa["library_eager_ms"])
    return out


def kernel_bench() -> list:
    """``repro_torch.bench.kernels.main()`` on the card: every row within
    its tolerance, ``int8_matmul`` launched on it; returns the
    ``int8_matmul`` record (decode B 4) for the kernels line."""
    import torch
    from repro_torch.bench import kernels as bench
    from repro_torch.kernels.int8_matmul import kernel as q_kernel

    torch.backends.cuda.matmul.allow_tf32 = False     # the plain f32 product
    q_kernel.int8_matmul_kernel.launches = 0
    t0 = time.perf_counter()
    rows = bench.main()
    bench_s = time.perf_counter() - t0
    counted = q_kernel.int8_matmul_kernel.launches
    int8 = [r for r in rows if r["name"] == "int8_matmul"]
    for r in rows:
        line("bench_row", **r)
        check(r["err_over_tol"] < 1.0, f"bench {r['name']} {r['case']}: off "
              f"by {r['err_over_tol']} of its tolerance ({r['tolerance']})")
    # one comparison call per row, the rest timed on the bench's path
    launches = counted - len(int8)
    check(launches == sum(r["launches"] for r in int8) and launches > 0,
          f"int8_matmul launched {counted} times in the bench, rows say "
          f"{[r['launches'] for r in int8]} + {len(int8)} comparisons")
    line("kernel_bench", seconds=bench_s, rows=len(rows),
         int8_matmul_launches=launches)
    head = next(r for r in int8 if r["case"] == "decode_b4")
    return [{"name": "int8_matmul", "route": "cuda",
             "source": "src/repro_torch/csrc/int8_matmul.cu",
             "replaces": "src/repro/kernels/int8_matmul/kernel.py:41",
             "launches": launches, "max_abs_err": head["max_abs_err"],
             "ms": head["us_per_call"] / 1e3,
             "plain_ms": head["plain_us"] / 1e3,
             "bound_ms": head["bound_us"] / 1e3,
             "bound_by": head["bound_by"],
             "library_ms": head["library_us"] / 1e3, "shape": head["shape"],
             "err_over_tol": head["err_over_tol"]}]


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
    from repro_torch.bench.common import bound, card, timed_ms
    from repro_torch.bench.kernels import gbt_hist_work
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
    smi = card()
    print(smi, flush=True)
    line("environment", python=sys.version.split()[0],
         torch=torch.__version__, cuda=torch.version.cuda, device=kind,
         device_count=torch.cuda.device_count())
    t0 = time.perf_counter()
    logs = _build.build()
    build_s = time.perf_counter() - t0
    wgmma_ptxas = []
    for name, log in logs.items():
        entry = name          # a source may hold several kernels
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                entry = ln.split("'")[1]
            elif ("registers" in ln or "spill" in ln or "smem" in ln
                  or "warning" in ln):
                print(f"ptxas {name} {entry}: {ln.strip()}")
                if "flash_fwd_wgmma" in entry:
                    wgmma_ptxas.append(ln.strip())
    line("build", seconds=build_s, compiled=sorted(logs))
    wgmma_sass = flash_sass(_build)
    line("flash_fwd_wgmma_build", sass=wgmma_sass, ptxas=wgmma_ptxas)

    wrappers = {"gbt_hist": gh_kernel.grad_histogram_kernel,
                "tree_predict": tp_kernel.tree_predict_kernel,
                "decide_split": ds_kernel.decide_split_kernel}

    # -- 2. the decision slice at full width -------------------------------
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

    # -- 3. the serving slice at full width -------------------------------
    serve_launches = serve_slice(dev, smi)

    # -- 4. the whole model on the card -----------------------------------
    model_check(dev)

    # -- 5. kernels against their plain versions ---------------------------
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

    # -- 6. timing ---------------------------------------------------------
    n, f = codes.shape
    flat = (codes.long() + torch.arange(f, device=dev) * 64).reshape(-1)
    wts = grad.double().repeat_interleave(f)
    gh_bound = bound(*gbt_hist_work(n, f, 64))
    gh_times = dict(
        ms=timed_ms(lambda: gh_kernel.grad_histogram_kernel(codes, grad, 64),
                    50),
        plain_ms=timed_ms(lambda: gh_ref.grad_histogram_ref(codes, grad, 64),
                          20),
        library_ms=timed_ms(lambda: (torch.bincount(flat, weights=wts,
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
        ms=timed_ms(lambda: tp_kernel.tree_predict_kernel(*targs, **tkw), 50),
        plain_ms=timed_ms(lambda: tp_ref.tree_predict_ref(*targs, **tkw), 3,
                          groups=3),
        library_ms=None)

    args, n_l = packed["main"]
    n_env = args[3].numel()
    ds_bound = bound(3 * (n_l + 1) * 4 + 12 * 4 + n_env * (7 * 4 + 8),
                     30 * n_env * (n_l + 1))
    ds_times = dict(
        ms=timed_ms(lambda: ds_kernel.decide_split_kernel(*args), 20),
        plain_ms=timed_ms(lambda: ds_ref.decide_split_ref(*args), 5),
        library_ms=None)
    args300, _ = packed["L300"]
    line("timing_extra", kernel="decide_split", case="L300",
         n_envs=int(args300[3].numel()),
         ms=timed_ms(lambda: ds_kernel.decide_split_kernel(*args300), 5),
         plain_ms=timed_ms(lambda: ds_ref.decide_split_ref(*args300), 2,
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
    kernels += serving_kernels(dev, serve_launches)

    # -- 7. the kernel bench: int8_matmul's entry point ---------------------
    kernels += kernel_bench()
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
