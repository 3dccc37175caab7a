"""The two scan backward kernels timed part by part on the card: the SSD
backward (``ssd_bwd_chain``, ``ssd_bwd_chunk``, the head sum of dB and dC)
at zamba2-1.2b's Mamba2 shape and the sLSTM backward (the cluster route's
reverse chain, the true-f32 dR product) at xlstm-350m's, each at the
training shapes (B 8, S 128 and B 4, S 2048), beside its bounds.

``--parent DIR`` also builds ``DIR/ssm_scan.cu`` and ``DIR/slstm_scan.cu``
(an earlier commit's sources, e.g. from ``git show
<commit>:src/repro_torch/csrc/ssm_scan.cu``, whose ``ssm_scan_bwd_chunks``
writes one share of dB and dC a head) into ``build/parent/`` and times
them in the same process through their own C interface, each held to the
current kernels' results::

    python -m repro_torch.bench.scan_bwd [--parent DIR] [--shapes train]

Rows to ``results/bench_torch_scan_bwd.json``; needs the card."""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.bench.common import (F32_OPS_PER_S, TF32_OPS_PER_S, bound,
                                      card, emit, timed_ms)
from repro_torch.kernels import _build
from repro_torch.kernels.work import slstm_bwd_work, ssm_bwd_work

#: (case, B, S): the training shapes of phase 11(k)
SHAPES = (("train", 8, 128), ("prefill", 4, 2048))
#: zamba2-1.2b's Mamba2 (H, P, N, Q) and xlstm-350m's sLSTM (H, du)
SSM_SHAPE, SLSTM_SHAPE = (64, 64, 64, 128), (4, 256)
#: each gradient within this share of its largest magnitude of the other
#: design's (chip_smoke's SCAN_BWD_TOL)
AGREE_TOL = 1e-4


def ssm_case(dev: torch.device, b: int, s: int, seed: int = 0) -> dict:
    """zamba2's inputs at B ``b``, S ``s`` (chip_smoke's draws), the
    forward's saved C·Bᵀ and chunk states, and random cotangents."""
    from repro_torch.kernels.ssm_scan import kernel as ss_kernel
    from repro_torch.kernels.ssm_scan import ref as ss_ref
    h, p, n, chunk = SSM_SHAPE
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x = randn(b, s, h, p)
    dt = F.softplus(randn(b, s, h) - 4.0)
    a_log = torch.log(torch.linspace(1.0, 16.0, h, device=dev))
    bm, cm = randn(b, s, n), randn(b, s, n)
    xdt, loga = ss_ref.ssd_inputs(x, dt, a_log)
    dy, dst = randn(b, s, h, p), randn(b, h, p, n)
    _, _, saved = ss_kernel.ssd_scan_kernel(xdt, loga, bm, cm, chunk,
                                            save_states=True)
    return dict(xdt=xdt, loga=loga, b=bm, c=cm, cb=saved[0],
                h_prev=saved[1], chunk=chunk, dy=dy, dst=dst)


def ssm_bounds(b: int, s: int) -> dict:
    """Both bounds of the SSD backward (ms, by): the function's f32
    operations on the CUDA cores, and the three TF32 products a split-TF32
    design forms for each of them on the tensor cores."""
    h, p, n, chunk = SSM_SHAPE
    nbytes, ops = ssm_bwd_work(b, s, h, p, n, chunk)
    return dict(bound_f32=bound(nbytes, ops, F32_OPS_PER_S),
                bound_3xtf32=bound(nbytes, 3 * ops, TF32_OPS_PER_S))


def ssm_parts(case: dict, reps: int = 5) -> dict:
    """The current SSD backward on ``case``: the call's ms and each part's
    (``ssd_bwd_chain``, ``ssd_bwd_chunk``, also at each head group, and
    the head sum), its gradients and the heads a block takes."""
    from repro_torch.kernels.ssm_scan import kernel as ss_kernel
    c = case
    fwd = (c["xdt"], c["loga"], c["b"], c["c"])
    d_h = ss_kernel.bwd_chain_kernel(c["loga"], c["c"], c["dy"], c["dst"],
                                     c["chunk"])
    shares = ss_kernel.bwd_chunk_kernel(*fwd, c["cb"], c["h_prev"], d_h,
                                        c["dy"], c["chunk"])
    bsz, s, h, _ = c["xdt"].shape
    return dict(
        ms=timed_ms(lambda: ss_kernel.ssd_scan_bwd_kernel(
            *fwd, c["cb"], c["h_prev"], c["chunk"], c["dy"], c["dst"]),
            reps),
        parts=dict(
            ssd_bwd_chain=timed_ms(lambda: ss_kernel.bwd_chain_kernel(
                c["loga"], c["c"], c["dy"], c["dst"], c["chunk"]), reps),
            ssd_bwd_chunk=timed_ms(lambda: ss_kernel.bwd_chunk_kernel(
                *fwd, c["cb"], c["h_prev"], d_h, c["dy"], c["chunk"]),
                reps),
            head_sum=timed_ms(lambda: ss_kernel.head_sum(*shares[2:]),
                              reps)),
        grads=ss_kernel.ssd_scan_bwd_kernel(*fwd, c["cb"], c["h_prev"],
                                            c["chunk"], c["dy"], c["dst"]),
        heads_per_block=ss_kernel.head_group(
            bsz, -(-s // c["chunk"]), h, torch.cuda.get_device_properties(
                c["xdt"].device).multi_processor_count),
        chunk_by_group={g: timed_ms(lambda: ss_kernel.bwd_chunk_kernel(
            *fwd, c["cb"], c["h_prev"], d_h, c["dy"], c["chunk"], g), reps)
            for g in (1, *ss_kernel.HEAD_GROUPS)})


def _parent_lib(src_dir: Path, name: str) -> ctypes.CDLL:
    """``src_dir/<name>.cu`` built with the port's flags into
    ``build/parent/`` (keyed on its bytes) and loaded."""
    src = src_dir / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    out = _build.BUILD_DIR / "parent" / f"lib{name}-{digest}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                        str(out), str(src)], check=True,
                       capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def ssm_parent_parts(lib: ctypes.CDLL, case: dict, reps: int = 5) -> dict:
    """The SSD backward of sources whose C interface writes one share of
    dB and dC a head, [H, B, S, N], on ``case``, as :func:`ssm_parts`."""
    p_, i_ = ctypes.c_void_p, ctypes.c_int
    lib.ssm_scan_bwd_chain.argtypes = [p_] * 6 + [i_] * 6 + [p_]
    lib.ssm_scan_bwd_chunks.argtypes = [p_] * 12 + [i_] * 6 + [p_]
    c = case
    bsz, s, h, p = c["xdt"].shape
    n, chunk, dev = c["b"].shape[-1], c["chunk"], c["xdt"].device
    nc = -(-s // chunk)
    d_h = torch.empty((bsz * h, nc, 64, 64), device=dev)
    counters = torch.empty(bsz * h + 1, dtype=torch.int32, device=dev)
    dxdt, dloga = torch.empty_like(c["xdt"]), torch.empty_like(c["loga"])
    db = torch.empty((h, bsz, s, n), device=dev)
    dc = torch.empty_like(db)
    stream = _build.stream_of(c["xdt"])
    dims = (bsz, s, h, p, n, chunk, stream)

    def chain():
        _build.check(lib, lib.ssm_scan_bwd_chain(*(_build.ptr(t) for t in (
            c["loga"], c["c"], c["dy"], c["dst"], d_h, counters)), *dims),
            "parent ssd_bwd_chain")

    def chunks():
        _build.check(lib, lib.ssm_scan_bwd_chunks(*(_build.ptr(t) for t in (
            c["xdt"], c["loga"], c["b"], c["c"], c["cb"], c["h_prev"], d_h,
            c["dy"], dxdt, dloga, db, dc)), *dims), "parent ssd_bwd_chunk")

    def call():
        chain()
        chunks()
        return dxdt, dloga, db.sum(0), dc.sum(0)

    grads = [t.clone() for t in call()]
    return dict(ms=timed_ms(call, reps),
                parts=dict(ssd_bwd_chain=timed_ms(chain, reps),
                           ssd_bwd_chunk=timed_ms(chunks, reps),
                           head_sum=timed_ms(lambda: (db.sum(0), dc.sum(0)),
                                             reps)),
                grads=grads, heads_per_block=1)


def slstm_case(dev: torch.device, b: int, s: int, dtype: torch.dtype,
               seed: int = 0) -> dict:
    """xlstm-350m's sLSTM at B ``b``, S ``s`` with R in ``dtype``
    (chip_smoke's draws): the forward's saved steps and random cotangents
    on h and the final state."""
    from repro_torch.kernels.slstm_scan import kernel as sl_kernel
    h, du = SLSTM_SHAPE
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    pre = randn(4, b, s, h * du)
    r = randn(4, h, du, du, scale=du ** -0.5).to(dtype)
    h_cot = randn(b, s, h * du)
    st_cot = tuple(randn(b, h * du) for _ in range(4))
    _, _, saved = sl_kernel.slstm_scan_kernel(pre, r, out_dtype=dtype,
                                              save_states=True)
    return dict(saved=saved, r=r, h_cot=h_cot, st_cot=st_cot, pre=pre)


def slstm_bounds(b: int, s: int, el: int) -> dict:
    """The sLSTM backward's bound (ms, by) at the f32 rate of the CUDA
    cores, which its chain and dR's true-f32 product both use."""
    h, du = SLSTM_SHAPE
    return dict(bound_f32=bound(*slstm_bwd_work(b, s, h, du, el),
                                F32_OPS_PER_S))


def slstm_parts(case: dict, reps: int = 3) -> dict:
    """The current sLSTM backward on ``case`` (the cluster route): the
    call's ms, the chain's and dR's, and its gradients."""
    from repro_torch.kernels.slstm_scan import kernel as sl_kernel
    c = case
    args = (c["saved"], c["r"], c["h_cot"], c["st_cot"])
    dpre = sl_kernel.bwd_chain_kernel(*args, "cluster")
    h = c["r"].shape[1]
    return dict(
        ms=timed_ms(lambda: sl_kernel.slstm_scan_bwd_kernel(
            *args, route="cluster"), reps, groups=3),
        parts=dict(
            slstm_bwd_cluster=timed_ms(lambda: sl_kernel.bwd_chain_kernel(
                *args, "cluster"), reps, groups=3),
            dR=timed_ms(lambda: sl_kernel.recurrent_grad(c["saved"], dpre,
                                                         h), reps,
                        groups=3)),
        grads=sl_kernel.slstm_scan_bwd_kernel(*args, route="cluster"))


def slstm_parent_parts(lib: ctypes.CDLL, case: dict, reps: int = 3) -> dict:
    """The sLSTM backward's cluster route of an earlier commit's sources on
    ``case`` through its C interface, then the same dR product, as
    :func:`slstm_parts`."""
    from repro_torch.kernels.slstm_scan import kernel as sl_kernel
    p_, i_ = ctypes.c_void_p, ctypes.c_int
    lib.slstm_scan_bwd.argtypes = [p_, p_, i_] + [p_] * 6 + [i_] * 5 + [p_]
    c = case
    saved, r = c["saved"], c["r"]
    _, b, s, d = saved.shape
    h, du = r.shape[1], r.shape[2]
    dpre = torch.empty((4, b, s, d), device=saved.device)

    def chain():
        _build.check(lib, lib.slstm_scan_bwd(
            _build.ptr(saved), _build.ptr(r), int(r.dtype == torch.bfloat16),
            *(_build.ptr(t) for t in (c["h_cot"], *c["st_cot"], dpre)), 1,
            b, s, h, du, _build.stream_of(saved)), "parent slstm_bwd")
        return dpre

    chain()
    grads = (dpre.clone(), sl_kernel.recurrent_grad(saved, dpre, h))
    return dict(ms=timed_ms(lambda: (chain(), sl_kernel.recurrent_grad(
                    saved, dpre, h)), reps, groups=3),
                parts=dict(slstm_bwd_cluster=timed_ms(chain, reps, groups=3),
                           dR=timed_ms(lambda: sl_kernel.recurrent_grad(
                               saved, dpre, h), reps, groups=3)),
                grads=grads)


def _agree(got, want) -> float:
    """The largest gap of a gradient over its largest magnitude."""
    return max(((g - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
               for g, w in zip(got, want))


def main(device: DeviceLike = None, parent: str | None = None,
         shapes: tuple[str, ...] = tuple(c for c, _, _ in SHAPES)
         ) -> list[dict]:
    """Every row at ``shapes`` (names of :data:`SHAPES`) on the card; with
    ``parent``, the sources there timed beside, in turns (parent, current,
    current, parent)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("scan_bwd times CUDA kernels: it needs the card")
    libs = ({n: _parent_lib(Path(parent), n)
             for n in ("ssm_scan", "slstm_scan")} if parent else {})
    rows = []
    for case, b, s in SHAPES:
        if case not in shapes:
            continue
        sc = ssm_case(dev, b, s)
        runs = ([("parent", lambda: ssm_parent_parts(libs["ssm_scan"], sc))]
                if libs else []) + [("current", lambda: ssm_parts(sc))]
        order = runs + runs[::-1] if libs else runs
        got = {}
        for who, fn in order:
            got.setdefault(who, []).append(fn())
        cur = got["current"][0]["grads"]
        for who, outs in got.items():
            row = dict(name="ssm_scan_backward", design=who, case=case,
                       shape=[b, s, *SSM_SHAPE], ms=[o["ms"] for o in outs],
                       parts={k: [o["parts"][k] for o in outs]
                              for k in outs[0]["parts"]},
                       heads_per_block=outs[0]["heads_per_block"],
                       **ssm_bounds(b, s),
                       chunk_by_group=outs[0].get("chunk_by_group"),
                       device=card())
            if who == "parent":
                row["gap_to_current"] = _agree(outs[0]["grads"], cur)
                row["agrees"] = row["gap_to_current"] <= AGREE_TOL
            rows.append(row)
        del sc, got, cur
        torch.cuda.empty_cache()
        for dtype in (torch.bfloat16, torch.float32):
            lc = slstm_case(dev, b, s, dtype)
            runs = ([("parent", lambda: slstm_parent_parts(
                libs["slstm_scan"], lc))] if libs else []) + [
                ("current", lambda: slstm_parts(lc))]
            order = runs + runs[::-1] if libs else runs
            got = {}
            for who, fn in order:
                got.setdefault(who, []).append(fn())
            cur = got["current"][0]["grads"]
            for who, outs in got.items():
                row = dict(name="slstm_scan_backward", design=who, case=case,
                           dtype=str(dtype).split(".")[-1],
                           shape=[b, s, *SLSTM_SHAPE],
                           ms=[o["ms"] for o in outs],
                           us_per_step=[o["ms"] * 1e3 / s for o in outs],
                           parts={k: [o["parts"][k] for o in outs]
                                  for k in outs[0]["parts"]},
                           **slstm_bounds(b, s, dtype.itemsize),
                           device=card())
                if who == "parent":
                    row["gap_to_current"] = _agree(outs[0]["grads"], cur)
                    row["agrees"] = row["gap_to_current"] <= AGREE_TOL
                rows.append(row)
            del lc, got, cur
            torch.cuda.empty_cache()
    emit(rows, "scan_bwd")
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    ap.add_argument("--parent", default=None,
                    help="a directory holding an earlier commit's "
                         "ssm_scan.cu and slstm_scan.cu (one dB and dC "
                         "share a head), timed beside")
    ap.add_argument("--shapes", default=",".join(c for c, _, _ in SHAPES),
                    help="comma-separated cases of SHAPES")
    args = ap.parse_args()
    main(args.device, args.parent, tuple(args.shapes.split(",")))
