"""Flash attention's backward timed on the card at chip_smoke's
``BWD_TIMED`` shapes (bf16, causal): the kernel
(``flash_attention_bwd_kernel``, from a CUDA graph and eager), the plain
backward (``ref.attention_bwd_ref``), SDPA's backward under autograd (the
library's call for the same function, timed here and used nowhere in the
port), and the bound (``kernels.work.flash_bwd_work`` over the H100's
bf16 rate and memory rate); each row also reads the kernel's largest
error over ``ref.bwd_bf16_tolerance``::

    python -m repro_torch.bench.attn_bwd [--shapes qwen3_prefill,...]

One JSON line a shape, rows to ``results/bench_torch_attn_bwd.json``;
needs the card."""
from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.bench.common import BF16_OPS_PER_S, bound, card, emit, \
    timed_ms
from repro_torch.kernels.work import flash_bwd_work

#: case -> (B, S, Hq, Hkv, D, Dv): chip_smoke's BWD_TIMED, the training
#: shapes of qwen3-1.7b (B 8, S 128 and B 4, S 2048), of the six
#: configurations trained in phase 11(m) (B 8, S 128) and starcoder2-7b's
#: B 4, S 2048 (its group of 9)
SHAPES = {
    "qwen3_train": (8, 128, 16, 8, 128, 128),
    "qwen3_prefill": (4, 2048, 16, 8, 128, 128),
    "moe_train": (8, 128, 16, 16, 128, 128),
    "mla_train": (8, 128, 16, 16, 192, 128),
    "phi3v_train": (8, 128, 32, 32, 96, 96),
    "gemma_train": (8, 128, 8, 1, 256, 256),
    "starcoder2_train": (8, 128, 36, 4, 128, 128),
    "minitron_train": (8, 128, 24, 8, 128, 128),
    "starcoder2_prefill": (4, 2048, 36, 4, 128, 128),
}


def bwd_row(dev: torch.device, b: int, s: int, hq: int, hkv: int, d: int,
            dv: int, seed: int = 0) -> dict:
    """One shape's row: the kernel's time from a CUDA graph (``ms``) and
    eager, the plain backward's, SDPA's backward's (``library_ms``), the
    bound, the route taken, and the kernel's largest error (absolute, and
    over ``bwd_bf16_tolerance``) on unit-scale inputs drawn from ``seed``."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ref as fa_ref
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(sh, generator=gen, device=dev).bfloat16()
                   for sh in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, dv),
                              (b, s, hq, dv)))
    o, lse = fa_kernel.flash_attention_kernel(q, k, v, return_lse=True)
    fa_kernel.reset_counts()
    got = fa_kernel.flash_attention_bwd_kernel(q, k, v, o, lse, do)
    route = [r for r, n in fa_kernel.flash_attention_bwd_kernel
             .by_kernel.items() if n]
    want, tol = fa_ref.bwd_bf16_tolerance(q, k, v, o, lse, do)
    err = max((g.float() - w).abs().max().item() for g, w in zip(got, want))
    over = max(((g.float() - w).abs() / t).max().item()
               for g, w, t in zip(got, want, tol))
    del got, want, tol
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    so = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                        enable_gqa=True)
    dot = do.transpose(1, 2)

    def kernel():
        return fa_kernel.flash_attention_bwd_kernel(q, k, v, o, lse, do)

    nbytes, ops = flash_bwd_work(b, s, hq, hkv, d, 2, dv)
    bound_ms, bound_by = bound(nbytes, ops, BF16_OPS_PER_S)
    return dict(
        shape=[b, s, hq, hkv, d, dv], dtype="bfloat16", causal=True,
        route=route[0], ms=timed_ms(kernel, 10, graph=True),
        eager_ms=timed_ms(kernel, 10),
        plain_ms=timed_ms(lambda: fa_ref.attention_bwd_ref(q, k, v, o, lse,
                                                           do), 3),
        library_ms=timed_ms(lambda: torch.autograd.grad(
            so, (qt, kt, vt), dot, retain_graph=True), 10),
        library="SDPA's backward under autograd, eager",
        bound_ms=bound_ms, bound_by=bound_by, operations=ops, bytes=nbytes,
        max_abs_err=err, err_over_tol=over)


def main(device: DeviceLike = None,
         shapes: tuple[str, ...] = tuple(SHAPES)) -> list[dict]:
    """A row for each of ``shapes`` (names of :data:`SHAPES`) on the
    card."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("attn_bwd times the backward kernel: it needs "
                           "the card")
    rows = []
    for case in shapes:
        row = dict(case=case, **bwd_row(dev, *SHAPES[case]), device=card())
        print(json.dumps(row), flush=True)
        rows.append(row)
        torch.cuda.empty_cache()
    emit([dict(name=f"attn_bwd_{r['case']}", us_per_call=r["ms"] * 1e3,
               **r) for r in rows], "attn_bwd")
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    ap.add_argument("--shapes", default=",".join(SHAPES),
                    help="comma-separated names of SHAPES")
    args = ap.parse_args()
    main(args.device, tuple(args.shapes.split(",")))
