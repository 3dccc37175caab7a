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
limit; below 1 passes).  ``int8_matmul`` rows and the bf16 flash rows
time the kernel and the library call through a CUDA graph (``timing:
"graph"``), so the host's launch path does not enter a few-microsecond
decode product or a ~0.2 ms attention; the flash rows keep the eager
times beside them (``us_per_call_eager``, ``library_us_eager``).
``int8_matmul`` rows cycle through copies of the weight that together
exceed the 50 MB L2 cache, so each call reads its weight from device
memory as a decode step would.  The other rows time eager calls
(``timing: "eager"``).  ``launches`` counts the kernel's launches while its
row was timed (warm-up and timed calls; a graph's captured calls once, not
its replays), not the one call compared with the plain version;
``int8_matmul`` rows also count them per kernel (``routes``).
"""
from __future__ import annotations

import argparse
import math

import torch
import torch.nn.functional as F

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.bench.common import (BF16_OPS_PER_S, F32_OPS_PER_S, bound,
                                      card, emit, host_ms, timed_ms)

#: qwen3-1.7b's products (configs/qwen3_1_7b.py: d_model 2048, d_ff 6144,
#: vocab 151,936): (case, M, K, N)
INT8_SHAPES = (("decode_b1", 1, 2048, 6144),
               ("decode_b4", 4, 2048, 6144),
               ("decode_b4_down", 4, 6144, 2048),
               ("lm_head_b4", 4, 2048, 151936),
               ("prefill", 8192, 2048, 6144))
L2_BYTES = 50e6


def flash_work(b: int, s: int, hq: int, hkv: int, d: int, el: int
               ) -> tuple[int, int]:
    """(bytes, operations) of causal attention: q, k, v read and o written
    once; q·kᵀ and p·v over the causal (row, col) pairs."""
    pairs = s * (s + 1) // 2
    return (2 * b * s * hq + 2 * b * s * hkv) * d * el, 4 * d * pairs * b * hq


def ssm_work(b: int, s: int, h: int, p: int, n: int, chunk: int
             ) -> tuple[int, int]:
    """(bytes, operations) of the f32 chunked scan: C·Bᵀ on the causal
    triangle once per batch row and chunk (the heads share it), and per
    head and chunk its product with dt·x, C·H and the state update's
    (dt·x)ᵀ(B∘decay); xdt, loga, B, C read, y and the state written."""
    nc, tri = -(-s // chunk), chunk * (chunk + 1) // 2
    ops = (b * h * nc * (2 * tri * p + 2 * 2 * chunk * p * n)
           + b * nc * 2 * tri * n)
    return 4 * (2 * b * s * h * p + b * s * h + 2 * b * s * n
                + b * h * p * n), ops


def ssm_cb_work(b: int, s: int, n: int, chunk: int) -> tuple[int, int]:
    """(bytes, operations) of ``ssd_cb`` alone: B and C read, the [Q, Q]
    tile of each batch row and chunk written, C·Bᵀ on the causal
    triangle."""
    nc, tri = -(-s // chunk), chunk * (chunk + 1) // 2
    return 4 * (2 * b * s * n + b * nc * chunk * chunk), b * nc * 2 * tri * n


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
         (ssm_scan_row, {})]
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
