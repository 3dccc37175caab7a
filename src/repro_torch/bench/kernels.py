"""Kernel micro-bench of the port: each hand-written kernel beside its plain
PyTorch version, the library call that computes the same function (where
PyTorch has one) and its bound on the H100, at the main paths' full-width
shapes.  The counterpart of ``benchmarks/bench_kernels.py``.

    python -m repro_torch.bench.kernels [--device cpu] [--int8-routes]

Rows go to ``results/bench_torch_kernels.json`` and stdout as
``name,us_per_call,derived`` CSV.  ``--int8-routes`` times only the two
bf16 ``int8_matmul`` kernels over M (``int8_route_rows``), into
``results/bench_torch_int8_routes.json``: where ``w8a16_wgmma`` starts to
win sets the route rule's ``WGMMA_MIN_M``.  Without ``--device`` it needs a card;
with ``--device cpu`` only the plain versions and the library calls run
(host-timed, at the same full-width shapes: several GB and minutes), and
the kernel's columns are null.

On the card each row holds the kernel against its plain version on the
same inputs (``err_over_tol``: the largest error over its per-element
limit; below 1 passes).  ``int8_matmul`` rows, the bf16 flash rows and the
``tree_predict`` and ``decide_split`` rows time the kernel and the library
call through a CUDA graph (``timing: "graph"``), so the host's launch path
does not enter a few-microsecond decode product or a ~0.2 ms attention;
all but ``int8_matmul`` keep the eager times beside them
(``us_per_call_eager``, ``library_us_eager``), and ``decide_split`` also
the time of a call whose inputs come from device memory, not L2
(``us_per_call_cold``).
``int8_matmul`` rows cycle through copies of the weight that together
exceed the 50 MB L2 cache, so each call reads its weight from device
memory as a decode step would.  The other rows time eager calls
(``timing: "eager"``).  ``launches`` counts the kernel's launches while its
row was timed (warm-up and timed calls; a graph's captured calls once, not
its replays), not the one call compared with the plain version;
``int8_matmul`` and ``tree_predict`` rows also count them per kernel
(``routes``).
"""
from __future__ import annotations

import argparse
import math
import statistics

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.bench.common import (BF16_OPS_PER_S, F32_OPS_PER_S, bound,
                                      card, emit, host_ms, timed_ms)
from repro_torch.kernels.work import (flash_work, slstm_bwd_work,  # noqa: F401
                                      slstm_work, ssm_bwd_work, ssm_cb_work,
                                      ssm_work)

#: qwen3-1.7b's products (configs/qwen3_1_7b.py: d_model 2048, d_ff 6144,
#: vocab 151,936): (case, M, K, N)
INT8_SHAPES = (("decode_b1", 1, 2048, 6144),
               ("decode_b4", 4, 2048, 6144),
               ("decode_b4_down", 4, 6144, 2048),
               ("lm_head_b4", 4, 2048, 151936),
               ("prefill", 8192, 2048, 6144))
L2_BYTES = 50e6


def gbt_hist_work(n: int, f: int, n_bins: int, nodes: int = 1
                  ) -> tuple[int, int]:
    """(bytes, operations) of one level's histograms over its ``n`` rows:
    int32 codes, f64 gradients, int32 row ids and the ``nodes + 1`` offsets
    read, the f64 sums and int32 counts [nodes, F, bins] written; one add
    to each per (row, feature)."""
    return (n * (f * 4 + 8 + 4) + (nodes + 1) * 4
            + nodes * f * n_bins * (8 + 4), 2 * n * f)


def level_rows(n_rows: int, sizes, seed: int = 0
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """A level's ``order`` and ``offsets`` (int32, CPU): nodes of ``sizes``
    rows, each a random ascending subset of ``range(n_rows)``."""
    gen = torch.Generator().manual_seed(seed)
    perm = torch.randperm(n_rows, generator=gen)
    offsets = torch.zeros(len(sizes) + 1, dtype=torch.int64)
    offsets[1:] = torch.cumsum(torch.as_tensor(sizes), 0)
    order = torch.cat([perm[lo:hi].sort().values for lo, hi in
                       zip(offsets[:-1].tolist(), offsets[1:].tolist())])
    return order.to(torch.int32), offsets.to(torch.int32)


def _row(name: str, dev: torch.device, **kw) -> dict:
    row = {"name": name, "us_per_call": None, "plain_us": None,
           "library_us": None, "library": None, "bound_us": None,
           "bound_by": None, "launches": 0, "max_abs_err": None,
           "err_over_tol": None, "tolerance": None, "timing": None,
           "device": card() if dev.type == "cuda" else "cpu"}
    row.update(kw)
    return row


def _times(row: dict, dev, kernel, plain, library, reps: int,
           plain_reps: int, graph: bool = False,
           plain_graph: bool = True) -> dict:
    """Fill the row's times (µs): the kernel, plain and library calls on
    the card (the plain one from the graph only with ``plain_graph``), or
    the plain and library calls by the host clock on the CPU."""
    if dev.type == "cuda":
        row["us_per_call"] = 1e3 * timed_ms(kernel, reps, graph=graph)
        row["plain_us"] = 1e3 * timed_ms(plain, plain_reps, groups=3,
                                         graph=graph and plain_graph)
        if library is not None:
            row["library_us"] = 1e3 * timed_ms(library, reps, graph=graph)
        row["timing"] = "graph" if graph else "eager"
    else:
        row["plain_us"] = 1e3 * host_ms(plain)
        if library is not None:
            row["library_us"] = 1e3 * host_ms(library)
        row["timing"] = "host"
    return row


def _randn(gen, dev, *shape, dtype=torch.float32, scale=1.0):
    return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)


def flash_attention_row(dev: torch.device, case: str = "qwen3_prefill",
                        b: int = 4, s: int = 2048, hq: int = 16,
                        hkv: int = 8, d: int = 128,
                        dtype: torch.dtype = torch.bfloat16,
                        seed: int = 0) -> dict:
    """Causal prefill attention; default: qwen3-1.7b's (B 4, S 2048)."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ref as fa_ref
    gen = torch.Generator(device=dev).manual_seed(seed)
    # unit scale: scores of std 1, so the softmax is not flat
    q = _randn(gen, dev, b, s, hq, d, dtype=dtype)
    k, v = (_randn(gen, dev, b, s, hkv, d, dtype=dtype) for _ in range(2))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    bms, by = bound(*flash_work(b, s, hq, hkv, d, q.element_size()),
                    BF16_OPS_PER_S if dtype == torch.bfloat16
                    else F32_OPS_PER_S)
    row = _row("flash_attention", dev, case=case,
               shape=[b, s, hq, hkv, d], dtype=str(dtype)[6:],
               bound_us=1e3 * bms, bound_by=by,
               library="F.scaled_dot_product_attention(is_causal, "
                       "enable_gqa)")

    def kernel():
        return fa_kernel.flash_attention_kernel(q, k, v)

    def plain():
        return fa_ref.attention_ref(qt, kt, vt).transpose(1, 2)

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    if dev.type == "cuda":
        got = kernel()
        if dtype == torch.bfloat16:
            want, tol = (t.transpose(1, 2) for t in
                         fa_ref.bf16_tolerance(qt, kt, vt))
            row["tolerance"] = ("2e-5 + 2^-8 (|want| + min(sum p|v|, "
                                "8 sqrt(sum p^2 v^2)))")
        else:
            want = plain()
            tol = 2e-5 + 2e-5 * want.abs()
            row["tolerance"] = "2e-5 abs + rel"
        err = (got.float() - want).abs()
        row["max_abs_err"] = err.max().item()
        row["err_over_tol"] = (err / tol).max().item()
        del got, want, tol, err
    before = fa_kernel.flash_attention_kernel.launches
    # bf16 from a CUDA graph, the eager times beside; the plain version
    # (GBs of temporaries) and f32 eager only
    graph = dev.type == "cuda" and dtype == torch.bfloat16
    _times(row, dev, kernel, plain, library, reps=10, plain_reps=3,
           graph=graph, plain_graph=False)
    if graph:
        row["us_per_call_eager"] = 1e3 * timed_ms(kernel, 10)
        row["library_us_eager"] = 1e3 * timed_ms(library, 10)
    row["launches"] = fa_kernel.flash_attention_kernel.launches - before
    return row


def gbt_hist_row(dev: torch.device, case: str = "root_level",
                 n: int = 12589, f: int = 7, n_bins: int = 64,
                 sizes=None, distinct=None, seed: int = 0) -> dict:
    """One level's histograms in one launch, over ``n`` rows in nodes of
    ``sizes`` rows (default: one node of all of them, the GBT fit's root
    in chip_smoke).  Feature j's codes take ``distinct[j]`` values spread
    over the bins, uniformly at random (default: all ``n_bins``)."""
    sizes = (n,) if sizes is None else sizes
    distinct = (n_bins,) * f if distinct is None else distinct
    from repro_torch.kernels.gbt_hist import kernel as gh_kernel
    from repro_torch.kernels.gbt_hist import ref as gh_ref
    gen = torch.Generator(device=dev).manual_seed(seed)
    codes = torch.stack(
        [torch.randint(0, d, (n,), generator=gen, device=dev) * n_bins // d
         for d in distinct], 1).to(torch.int32).contiguous()
    grad = _randn(gen, dev, n, dtype=torch.float64)
    order, offsets = (t.to(dev) for t in level_rows(n, sizes, seed))
    m, k = order.numel(), len(sizes)
    node = torch.repeat_interleave(torch.arange(k, device=dev),
                                   (offsets[1:] - offsets[:-1]).long())
    flat = ((node[:, None] * f + torch.arange(f, device=dev)) * n_bins
            + codes[order.long()]).reshape(-1)
    wts = grad[order.long()].repeat_interleave(f)
    bms, by = bound(*gbt_hist_work(m, f, n_bins, k))
    row = _row("gbt_hist", dev, case=case, shape=[m, f, n_bins, k],
               dtype="float64", bound_us=1e3 * bms, bound_by=by,
               library="two torch.bincount")
    args = (codes, grad, order, offsets, n_bins)

    def kernel():
        return gh_kernel.level_histogram_kernel(*args)

    def plain():
        return gh_ref.level_histogram_ref(*args)

    def library():
        return (torch.bincount(flat, weights=wts, minlength=k * f * n_bins),
                torch.bincount(flat, minlength=k * f * n_bins))

    if dev.type == "cuda":
        gsum, cnt = (t.cpu() for t in kernel())
        # the plain version on a CPU copy adds in np.bincount's order (the
        # card's torch.bincount adds with atomics): exactly equal
        pg, pc = gh_ref.level_histogram_ref(*(t.cpu() for t in args[:4]),
                                            n_bins)
        same = torch.equal(gsum, pg) and torch.equal(cnt.double(), pc)
        row["max_abs_err"] = (gsum - pg).abs().max().item()
        row["err_over_tol"] = 0.0 if same else math.inf
        row["tolerance"] = "exact: bit for bit with the plain version"
    before = gh_kernel.level_histogram_kernel.launches
    _times(row, dev, kernel, plain, library, reps=50, plain_reps=20)
    row["launches"] = gh_kernel.level_histogram_kernel.launches - before
    return row


def ssm_scan_row(dev: torch.device, b: int = 4, s: int = 2048, h: int = 64,
                 p: int = 64, n: int = 64, chunk: int = 128,
                 seed: int = 0) -> dict:
    """Mamba2 SSD chunked scan; default: zamba2-1.2b's prefill."""
    from repro_torch.kernels.ssm_scan import kernel as ss_kernel
    from repro_torch.kernels.ssm_scan import ref as ss_ref
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = _randn(gen, dev, b, s, h, p, scale=0.5)
    dt = F.softplus(_randn(gen, dev, b, s, h, scale=0.5) - 4.0)
    a_log = torch.log(torch.linspace(1.0, 16.0, h, device=dev))
    bm, cm = (_randn(gen, dev, b, s, n, scale=0.5) for _ in range(2))
    xdt, loga = ss_ref.ssd_inputs(x, dt, a_log)
    args = (xdt, loga, bm, cm, chunk)
    bms, by = bound(*ssm_work(b, s, h, p, n, chunk))
    row = _row("ssm_scan", dev, case="zamba2_prefill",
               shape=[b, s, h, p, n, chunk], dtype="float32",
               bound_us=1e3 * bms, bound_by=by)

    def kernel():
        return ss_kernel.ssd_scan_kernel(*args)

    def plain():
        return ss_ref.ssd_scan_chunked_ref(*args)

    if dev.type == "cuda":
        over, worst = 0.0, 0.0
        for got, want in zip(kernel(), plain()):
            err = (got - want).abs()
            # f32 in another order: 2e-4 of |want| plus 2e-4 of its scale
            tol = 2e-4 * want.abs() + 2e-4 * want.abs().max()
            worst = max(worst, err.max().item())
            over = max(over, (err / tol.clamp_min(1e-30)).max().item())
        row.update(max_abs_err=worst, err_over_tol=over,
                   tolerance="2e-4 rel + 2e-4 of max|want| (y and state)")
    before = ss_kernel.ssd_scan_kernel.launches
    _times(row, dev, kernel, plain, None, reps=10, plain_reps=2)
    row["launches"] = ss_kernel.ssd_scan_kernel.launches - before
    return row


def random_trees(n_trees: int, max_nodes: int, max_depth: int, n_feat: int,
                 n_bins: int = 64, seed: int = 0) -> dict:
    """A seeded synthetic ensemble in the flattened form (numpy, ``[T, M]``
    int32 ``feature``, ``threshold_bin``, ``left``, ``right`` and f64
    ``scaled_value``): each tree holds one chain of ``max_depth`` splits,
    then splits leaves at random (none deeper than ``max_depth``) while two
    more nodes fit in ``max_nodes``; leaf values ~ N(0, 0.1), padding slots
    leaves of value 0."""
    rng = np.random.default_rng(seed)
    out = {k: np.zeros((n_trees, max_nodes), np.int32)
           for k in ("feature", "threshold_bin", "left", "right")}
    out["feature"][:] = -1
    out["scaled_value"] = np.zeros((n_trees, max_nodes), np.float64)
    for t in range(n_trees):
        depth = np.zeros(max_nodes, np.int64)
        n, chain, open_ = 1, 0, []

        def split(node):
            nonlocal n
            out["feature"][t, node] = rng.integers(n_feat)
            out["threshold_bin"][t, node] = rng.integers(n_bins)
            out["left"][t, node], out["right"][t, node] = n, n + 1
            depth[n:n + 2] = depth[node] + 1
            n += 2
            open_.extend(c for c in (n - 2, n - 1) if depth[c] < max_depth)

        for _ in range(max_depth):
            if n + 2 > max_nodes:
                break
            split(chain)
            if chain in open_:
                open_.remove(chain)
            chain = n - 2 + int(rng.integers(2))
        while n + 2 <= max_nodes and open_:
            i = int(rng.integers(len(open_)))
            open_[i], open_[-1] = open_[-1], open_[i]
            split(open_.pop())
        leaves = np.flatnonzero(out["feature"][t, :n] < 0)
        out["scaled_value"][t, leaves] = rng.normal(0.0, 0.1, len(leaves))
    return out


def tree_predict_work(codes: torch.Tensor, feature: torch.Tensor,
                      threshold_bin: torch.Tensor, left: torch.Tensor,
                      right: torch.Tensor, max_depth: int
                      ) -> tuple[int, int]:
    """(bytes, operations) of tree inference on these inputs, counted on
    this data: the codes read once, of the node arrays only the nodes that
    some row reaches (24 B each: four int32 and the f64 leaf value; padding
    slots and nodes no row reaches are not needed), the [N] f64 result
    written; one compare per split node a row passes and one f64 add per
    (row, tree)."""
    n, n_trees = codes.shape[0], feature.shape[0]
    rows = torch.arange(n, device=codes.device)
    tree = torch.arange(n_trees, device=codes.device)[:, None]
    node = torch.zeros((n_trees, n), dtype=torch.int64, device=codes.device)
    reached = torch.zeros(feature.shape, dtype=torch.bool,
                          device=codes.device)
    visits = 0
    for _ in range(max_depth):
        reached[tree, node] = True
        ft = feature[tree, node].long()
        split = ft >= 0
        visits += int(split.sum())
        nxt = torch.where(codes[rows, ft.clamp_min(0)]
                          <= threshold_bin[tree, node], left[tree, node],
                          right[tree, node]).long()
        node = torch.where(split, nxt, node)
    reached[tree, node] = True
    nbytes = 4 * codes.numel() + 24 * int(reached.sum()) + 8 * n
    return nbytes, visits + n * n_trees


def tree_predict_inputs(dev: torch.device, n: int = 56, n_trees: int = 200,
                        max_nodes: int = 643, max_depth: int = 12,
                        n_feat: int = 7, n_bins: int = 64, seed: int = 0
                        ) -> tuple[tuple, dict]:
    """``tree_predict_kernel``'s arguments, ``(codes, *node arrays)`` and
    ``{max_depth, base}``: ``n`` rows of random codes and a seeded synthetic
    ensemble (:func:`random_trees`); default: the decision path's 2L = 56
    feature rows and an ensemble of the chip_smoke fit's size (200 trees,
    643 node slots, depth 12)."""
    trees = random_trees(n_trees, max_nodes, max_depth, n_feat, n_bins, seed)
    nodes = tuple(torch.as_tensor(trees[k], device=dev) for k in
                  ("feature", "threshold_bin", "left", "right",
                   "scaled_value"))
    codes = torch.as_tensor(np.random.default_rng(seed).integers(
        0, n_bins, (n, n_feat)), dtype=torch.int32, device=dev)
    return (codes, *nodes), dict(max_depth=max_depth, base=0.5)


def tree_predict_row(dev: torch.device, case: str = "decision_path",
                     inputs: tuple[tuple, dict] | None = None) -> dict:
    """GBT inference on ``inputs`` (``tree_predict_kernel``'s arguments;
    default: :func:`tree_predict_inputs`).  Exact: the kernel must equal
    the plain version bit for bit.  On the card also the eager call's time
    and each CUDA kernel's from a graph (``kernels``: the descent on its
    route, then the fold; µs)."""
    from repro_torch.kernels.tree_predict import kernel as tp_kernel
    from repro_torch.kernels.tree_predict import ref as tp_ref
    args, kw = tree_predict_inputs(dev) if inputs is None else inputs
    codes, feature = args[0], args[1]
    bms, by = bound(*tree_predict_work(*args[:5], kw["max_depth"]))
    row = _row("tree_predict", dev, case=case,
               shape=[codes.shape[0], *feature.shape, kw["max_depth"]],
               dtype="float64", bound_us=1e3 * bms, bound_by=by)

    def kernel():
        return tp_kernel.tree_predict_kernel(*args, **kw)

    def plain():
        return tp_ref.tree_predict_ref(*args, **kw)

    if dev.type == "cuda":
        got, want = kernel(), plain()
        row["max_abs_err"] = (got - want).abs().max().item()
        row["err_over_tol"] = 0.0 if torch.equal(got, want) else math.inf
        row["tolerance"] = "exact: bit for bit with the plain version"
    before = tp_kernel.tree_predict_kernel.launches
    routes = dict(tp_kernel.tree_predict_kernel.by_kernel)
    _times(row, dev, kernel, plain, None, reps=50, plain_reps=3,
           graph=dev.type == "cuda", plain_graph=False)
    if dev.type == "cuda":
        row["us_per_call_eager"] = 1e3 * timed_ms(kernel, 50)
    row["launches"] = tp_kernel.tree_predict_kernel.launches - before
    row["routes"] = {k: v - routes[k] for k, v in
                     tp_kernel.tree_predict_kernel.by_kernel.items()
                     if v > routes[k]}
    if dev.type == "cuda" and codes.shape[0]:
        route = tp_kernel.choose_route(*codes.shape, *feature.shape)[0]
        leaf = tp_kernel._descend(*args, kw["max_depth"])
        row["kernels"] = {
            route: 1e3 * timed_ms(lambda: tp_kernel._descend(
                *args, kw["max_depth"]), 50, graph=True),
            "fold": 1e3 * timed_ms(lambda: tp_kernel._fold(
                leaf, kw["base"]), 50, graph=True)}
    return row


def decide_split_work(n_envs: int, n_splits: int, spec) -> tuple[int, int]:
    """(bytes, operations) of the decision sweep on these inputs: the three
    split rows, the spec and seven f32 columns per environment read once,
    the split and the cost written; per (environment, split) three FMAs
    and a compare (7 operations) where the deadline weighs nothing, else 19
    (``csrc/decide_split.cu``), and 20 per environment (its reciprocals
    and coefficients)."""
    from repro_torch.kernels.decide_split.kernel import SPEC_W3
    per_split = 7 if float(spec[SPEC_W3]) == 0.0 else 19
    return (3 * n_splits * 4 + len(spec) * 4 + n_envs * (7 * 4 + 8),
            n_envs * (per_split * n_splits + 20))


def decide_split_case(dev: torch.device, case: str = "qwen3",
                      n_envs: int = 1 << 20, seed: int = 0) -> tuple:
    """``(layers, envs)`` of one decision sweep under the analytic cost:
    ``qwen3``, qwen3-1.7b's 28 layers (seq 4096, batch 1) on pi5-arm to
    edge-server-a100 over ``n_envs`` links from 1e5 to 1e10 B/s; ``L300``,
    300 random layers over ``n_envs - 3`` mixed environments."""
    from repro_torch import configs
    from repro_torch.core import decisions as dec
    from repro_torch.core import offload as off
    from repro_torch.hw import EDGE_DEVICES, get_device
    a100 = get_device("edge-server-a100")
    if case == "qwen3":
        layers = off.transformer_layer_costs(
            configs.get_config("qwen3-1.7b"), seq_len=4096, batch_size=1)
        return layers, dec.make_envs(
            get_device("pi5-arm"), a100,
            link_bw=np.geomspace(1e5, 1e10, n_envs), link_latency_s=0.005,
            input_bytes=4 * 4096, device=dev)
    rng = np.random.default_rng(seed)
    layers = [off.LayerCost(f"l{i}", float(f), float(a)) for i, (f, a)
              in enumerate(zip(rng.uniform(1e6, 1e12, 300),
                               rng.uniform(1e2, 1e8, 300)))]
    n, specs = n_envs - 3, list(EDGE_DEVICES.values())
    return layers, dec.make_envs(
        [specs[i] for i in rng.integers(len(specs), size=n)], a100,
        link_bw=rng.uniform(1e4, 1e10, n),
        link_latency_s=rng.uniform(0.0, 0.05, n),
        input_bytes=rng.uniform(0.0, 1e7, n), device=dev)


def decide_split_inputs(dev: torch.device, case: str = "qwen3",
                        n_envs: int = 1 << 20, seed: int = 0) -> tuple:
    """The eleven kernel arguments (``pack_inputs``) of
    :func:`decide_split_case`'s sweep."""
    from repro_torch.core.costs import lower_to_accel
    from repro_torch.kernels.decide_split.ops import pack_inputs
    return pack_inputs(*decide_split_case(dev, case, n_envs, seed),
                       lower_to_accel(None)).kernel_args


def timed_cold_ms(fn, reps: int, groups: int = 5) -> float:
    """Median over ``groups`` of the mean CUDA-event time (ms) of ``reps``
    calls of ``fn``, each timed alone after three times the L2 cache has
    been written (so its inputs come from device memory), after 3 warm-up
    calls.  A spin kernel holds the stream while a group is enqueued, so
    the card runs it without waiting for the host between the events."""
    flush = torch.empty(int(3 * L2_BYTES), dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    out = []
    for _ in range(groups):
        pairs = []
        torch.cuda._sleep(20_000_000)        # ~10 ms of clock cycles
        for _ in range(reps):
            flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        out.append(sum(a.elapsed_time(b) for a, b in pairs) / reps)
    return statistics.median(out)


def decide_split_row(dev: torch.device, case: str = "qwen3",
                     args: tuple | None = None) -> dict:
    """The fused decision sweep on ``args``, the kernel's eleven arguments
    (default: :func:`decide_split_inputs` of ``case``): costs within rtol
    1e-5 of the plain version, ``split_match_share`` beside.  On the card
    also ``us_per_call_cold``, each call after L2 was overwritten, and
    ``bound_us_30ops``, the bound at the 30 operations a split of the
    kernel before the division-free form."""
    from repro_torch.kernels.decide_split import kernel as ds_kernel
    from repro_torch.kernels.decide_split import ref as ds_ref
    args = decide_split_inputs(dev, case) if args is None else args
    e, n_splits = args[3].numel(), args[0].numel()
    nbytes, ops = decide_split_work(e, n_splits, args[-1].cpu())
    bms, by = bound(nbytes, ops)
    row = _row("decide_split", dev, case=case, shape=[e, n_splits],
               dtype="float32", bound_us=1e3 * bms, bound_by=by,
               bound_us_30ops=1e3 * bound(nbytes, 30 * e * n_splits)[0])

    def kernel():
        return ds_kernel.decide_split_kernel(*args)

    def plain():
        return ds_ref.decide_split_ref(*args)

    if dev.type == "cuda":
        (ks, kc), (ps, pc) = kernel(), plain()
        err = (kc - pc).abs()
        row["max_abs_err"] = err.max().item()
        row["err_over_tol"] = (err / (1e-5 * pc.abs()).clamp_min(1e-30)
                               ).max().item()
        row["tolerance"] = "rtol 1e-5 on the least cost"
        row["split_match_share"] = (ks == ps).double().mean().item()
        del ks, kc, ps, pc, err
    before = ds_kernel.decide_split_kernel.launches
    _times(row, dev, kernel, plain, None, reps=20, plain_reps=2,
           graph=dev.type == "cuda", plain_graph=False)
    if dev.type == "cuda":
        row["us_per_call_eager"] = 1e3 * timed_ms(kernel, 20)
        row["us_per_call_cold"] = 1e3 * timed_cold_ms(kernel, 10)
    row["launches"] = ds_kernel.decide_split_kernel.launches - before
    return row


def int8_matmul_row(dev: torch.device, case: str = "decode_b4",
                    m: int = 4, k: int = 2048, n: int = 6144,
                    dtype: torch.dtype = torch.bfloat16,
                    seed: int = 0, route: str | None = None) -> dict:
    """W8A16 product x [M,K] · w_q [K,N] int8 (+ scale [N]); default: the
    decode up projection of qwen3-1.7b at serving batch 4.  ``route``
    forces one of the kernels (default: the one ``choose_route`` picks);
    the row's ``routes`` counts its launches per kernel."""
    from repro_torch.kernels.int8_matmul import kernel as q_kernel
    from repro_torch.kernels.int8_matmul import ref as q_ref
    if dev.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the plain f32 product must not run in TF32: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = _randn(gen, dev, m, k, dtype=dtype)
    w_q, scale = q_ref.quantize(_randn(gen, dev, k, n))
    el = x.element_size()
    bms, by = bound(x.numel() * el + w_q.numel() + 4 * n + m * n * el,
                    2 * m * n * k, BF16_OPS_PER_S if dtype == torch.bfloat16
                    else F32_OPS_PER_S)
    row = _row("int8_matmul", dev, case=case, shape=[m, k, n],
               dtype=str(dtype)[6:], bound_us=1e3 * bms, bound_by=by,
               library="torch.matmul(x, w_deq), w dequantised to x's dtype "
                       "once")
    if dev.type == "cuda":
        got = q_kernel.int8_matmul_kernel(x, w_q, scale, route=route)
        want, tol = q_ref.int8_tolerance(x, w_q, scale)
        err = (got.float() - want).abs()
        row["max_abs_err"] = err.max().item()
        row["err_over_tol"] = (err / tol.clamp_min(1e-30)).max().item()
        row["tolerance"] = ("2 (K+2) 2^-24 sum|x||w_q| scale"
                            + (" + 2^-8 |want|" if dtype == torch.bfloat16
                               else ""))
        del got, want, tol, err
    # on the card, copies of the weight that together exceed L2, in turn
    def copies(nbytes):
        return (1 if dev.type == "cpu"
                else min(64, math.ceil(3 * L2_BYTES / max(nbytes, 1))))

    wqs = [w_q] + [w_q.clone() for _ in range(copies(w_q.numel()) - 1)]
    deqs = [q_ref.dequantize(w, scale, dtype)
            for w in wqs[:copies(w_q.numel() * el)]]
    turn = {"kernel": 0, "plain": 0, "library": 0}

    def take(key, pool):
        turn[key] += 1
        return pool[turn[key] % len(pool)]

    def kernel():
        return q_kernel.int8_matmul_kernel(x, take("kernel", wqs), scale,
                                           route=route)

    def plain():
        return q_ref.int8_matmul_ref(x, take("plain", wqs), scale)

    def library():
        return torch.matmul(x, take("library", deqs))

    reps = len(wqs) * max(1, math.ceil(20 / len(wqs)))
    before = q_kernel.int8_matmul_kernel.launches
    routes = dict(q_kernel.int8_matmul_kernel.by_route)
    _times(row, dev, kernel, plain, library, reps=reps,
           plain_reps=len(wqs), graph=dev.type == "cuda")
    row["weight_copies"] = [len(wqs), len(deqs)]
    row["launches"] = q_kernel.int8_matmul_kernel.launches - before
    row["routes"] = {r: q_kernel.int8_matmul_kernel.by_route[r] - routes[r]
                     for r in routes
                     if q_kernel.int8_matmul_kernel.by_route[r] > routes[r]}
    return row


#: the rows of x at which the route sweep times both bf16 kernels, at
#: qwen3-1.7b's up projection (K 2048, N 6144)
ROUTE_SWEEP_M = (16, 32, 48, 64, 80, 96, 112, 128, 192, 256, 512, 1024,
                 2048, 8192)


def int8_route_rows(dev: torch.device, ms=ROUTE_SWEEP_M, k: int = 2048,
                    n: int = 6144) -> list[dict]:
    """``int8_matmul_row`` at each M of ``ms`` on each bf16 kernel
    (``w8a16_mma``, ``w8a16_wgmma``), forced: where the second starts to
    win sets ``kernel.WGMMA_MIN_M``."""
    return [int8_matmul_row(dev, case=f"route_{r}_m{m}", m=m, k=k, n=n,
                            route=r)
            for m in ms for r in ("w8a16_mma", "w8a16_wgmma")]


#: the GBT fit of chip_smoke (200 trees, depth 12, subsample 0.8, 64 bins,
#: seed 0, on its 15,780 profile rows): the distinct codes of each feature
#: at its first root, and the node sizes of its level with the most nodes
#: (130 nodes, 8,376 of a tree's 12,589 rows), read off the same fit on the
#: CPU, which grows the card's trees; the order of the nodes is numpy 2.0's
#: (numpy 2.3 gives the same sizes in another order)
FIT_DISTINCT = (60, 22, 5, 5, 5, 2, 5)
WIDEST_LEVEL = (
    45, 143, 24, 24, 31, 32, 42, 43, 21, 27, 63, 87, 71, 13, 14, 26, 28, 46,
    25, 23, 17, 29, 19, 16, 28, 266, 210, 41, 39, 198, 39, 44, 19, 23, 20, 22,
    29, 24, 26, 17, 33, 111, 4, 23, 24, 28, 26, 28, 18, 24, 58, 248, 65, 95,
    267, 4, 81, 432, 27, 117, 106, 24, 68, 296, 27, 15, 16, 48, 53, 26, 26,
    42, 48, 47, 41, 84, 87, 80, 78, 21, 38, 146, 313, 45, 51, 145, 90, 25, 51,
    231, 226, 44, 41, 91, 93, 86, 52, 25, 26, 15, 20, 16, 81, 29, 23, 25, 121,
    24, 23, 27, 26, 16, 52, 13, 53, 4, 260, 269, 49, 98, 49, 50, 46, 27, 25,
    28, 95, 43, 26, 24)

#: the bench's rows: (function, keyword arguments), at full width
ROWS = ([(flash_attention_row, {}),
         (flash_attention_row, dict(case="zamba2_prefill", hq=32, hkv=32,
                                    d=64)),
         (gbt_hist_row, dict(distinct=FIT_DISTINCT)),
         (gbt_hist_row, dict(case="widest_level", sizes=WIDEST_LEVEL,
                             distinct=FIT_DISTINCT)),
         (ssm_scan_row, {}),
         (tree_predict_row, {}),
         (decide_split_row, {}),
         (decide_split_row, dict(case="L300"))]
        + [(int8_matmul_row, dict(case=c, m=m, k=k, n=n))
           for c, m, k, n in INT8_SHAPES])


def main(device: DeviceLike = None, routes: bool = False) -> list[dict]:
    """Every row on ``device`` (None: the card; raises without one); with
    ``routes``, only the sweep of ``int8_route_rows`` (written as
    ``results/bench_torch_int8_routes.json``)."""
    dev = resolve_device(device)
    rows = []
    todo = ([(int8_route_rows, {})] if routes else ROWS)
    for fn, kw in todo:
        got = fn(dev, **kw)
        rows += got if isinstance(got, list) else [got]
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    emit(rows, "int8_routes" if routes else "kernels")
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    ap.add_argument("--int8-routes", action="store_true",
                    help="only time both bf16 int8_matmul kernels over M "
                         "(ROUTE_SWEEP_M)")
    args = ap.parse_args()
    main(args.device, routes=args.int8_routes)
