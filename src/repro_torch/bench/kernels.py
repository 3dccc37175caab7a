"""Kernel micro-bench of the port: each hand-written kernel beside its plain
PyTorch version, the library call that computes the same function (where
PyTorch has one) and its bound on the H100, at the main paths' full-width
shapes.  The counterpart of ``benchmarks/bench_kernels.py``.

    python -m repro_torch.bench.kernels [--device cpu]

Rows go to ``results/bench_torch_kernels.json`` and stdout as
``name,us_per_call,derived`` CSV.  Without ``--device`` it needs a card;
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
its replays), not the one call compared with the plain version.
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
    """(bytes, operations) of the f32 chunked scan: per chunk and row, C·Bᵀ
    and its product with dt·x on the causal triangle, C·H and the state
    update's (dt·x)ᵀ(B∘decay); xdt, loga, B, C read, y and the state
    written."""
    nc, tri = -(-s // chunk), chunk * (chunk + 1) // 2
    ops = b * h * nc * (2 * tri * (n + p) + 2 * 2 * chunk * p * n)
    return 4 * (2 * b * s * h * p + b * s * h + 2 * b * s * n
                + b * h * p * n), ops


def gbt_hist_work(n: int, f: int, n_bins: int) -> tuple[int, int]:
    """(bytes, operations) of the histogram: codes and gradients read, the
    two [F, bins] tables written; one add to each per (row, feature)."""
    return n * f * 4 + n * 4 + 2 * f * n_bins * 4, 2 * n * f


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


def gbt_hist_row(dev: torch.device, n: int = 12589, f: int = 7,
                 n_bins: int = 64, seed: int = 0) -> dict:
    """Gradient histogram; default: the GBT fit's root node (chip_smoke)."""
    from repro_torch.kernels.gbt_hist import kernel as gh_kernel
    from repro_torch.kernels.gbt_hist import ref as gh_ref
    gen = torch.Generator(device=dev).manual_seed(seed)
    codes = torch.randint(0, n_bins, (n, f), generator=gen, device=dev,
                          dtype=torch.int32)
    grad = _randn(gen, dev, n)
    flat = (codes.long() + torch.arange(f, device=dev) * n_bins).reshape(-1)
    wts = grad.double().repeat_interleave(f)
    bms, by = bound(*gbt_hist_work(n, f, n_bins))
    row = _row("gbt_hist", dev, case="root_node", shape=[n, f, n_bins],
               dtype="float32", bound_us=1e3 * bms, bound_by=by,
               library="two torch.bincount")

    def kernel():
        return gh_kernel.grad_histogram_kernel(codes, grad, n_bins)

    def plain():
        return gh_ref.grad_histogram_ref(codes, grad, n_bins)

    def library():
        return (torch.bincount(flat, weights=wts, minlength=f * n_bins),
                torch.bincount(flat, minlength=f * n_bins))

    if dev.type == "cuda":
        gsum, cnt = kernel()
        pg, pc = plain()
        abs_sum, _ = gh_ref.grad_histogram_ref(codes, grad.abs(), n_bins)
        if not torch.equal(cnt.double(), pc):
            raise AssertionError("gbt_hist: kernel counts differ from plain")
        err = (gsum.double() - pg).abs()
        # f32 atomics in a varying order: 1e-4 of the bin's sum of |g|
        row["max_abs_err"] = err.max().item()
        row["err_over_tol"] = (err / (1e-4 * abs_sum).clamp_min(1e-30)
                               ).max().item()
        row["tolerance"] = "1e-4 of the bin's sum of |g|; counts exact"
    before = gh_kernel.grad_histogram_kernel.launches
    _times(row, dev, kernel, plain, library, reps=50, plain_reps=20)
    row["launches"] = gh_kernel.grad_histogram_kernel.launches - before
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
                    seed: int = 0) -> dict:
    """W8A16 product x [M,K] · w_q [K,N] int8 (+ scale [N]); default: the
    decode up projection of qwen3-1.7b at serving batch 4."""
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
        got = q_kernel.int8_matmul_kernel(x, w_q, scale)
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
        return q_kernel.int8_matmul_kernel(x, take("kernel", wqs), scale)

    def plain():
        return q_ref.int8_matmul_ref(x, take("plain", wqs), scale)

    def library():
        return torch.matmul(x, take("library", deqs))

    reps = len(wqs) * max(1, math.ceil(20 / len(wqs)))
    before = q_kernel.int8_matmul_kernel.launches
    _times(row, dev, kernel, plain, library, reps=reps,
           plain_reps=len(wqs), graph=dev.type == "cuda")
    row["weight_copies"] = [len(wqs), len(deqs)]
    row["launches"] = q_kernel.int8_matmul_kernel.launches - before
    return row


#: the bench's rows: (function, keyword arguments), at full width
ROWS = ([(flash_attention_row, {}),
         (flash_attention_row, dict(case="zamba2_prefill", hq=32, hkv=32,
                                    d=64)),
         (gbt_hist_row, {}), (ssm_scan_row, {})]
        + [(int8_matmul_row, dict(case=c, m=m, k=k, n=n))
           for c, m, k, n in INT8_SHAPES])


def main(device: DeviceLike = None) -> list[dict]:
    """Every row on ``device`` (None: the card; raises without one)."""
    dev = resolve_device(device)
    rows = []
    for fn, kw in ROWS:
        rows.append(fn(dev, **kw))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    emit(rows, "kernels")
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    main(ap.parse_args().device)
