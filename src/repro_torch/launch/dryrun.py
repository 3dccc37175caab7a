"""Dry-run of every (architecture × input shape) on the production meshes
(the port of ``repro.launch.dryrun``), for the H100.

The reference lowers and compiles each step for 256 or 512 TPU chips and
reads XLA's memory and cost analyses.  The port has no compiler to ask: it
builds the step with ``launch.steps.assemble`` on an abstract mesh (names
and sizes, no devices) and runs rank 0's step once on meta tensors
(shapes and dtypes, no data, no device), at the local shapes the specs
give, with shape-only collectives
(``distributed.collectives``); the kernels are custom ops whose fake
implementations give meta tensors their outputs.  Each record holds:

  * ``memory.static`` — bytes the rank holds across the step, exactly from
    the specs' local shapes: parameters (in training also their gradients
    and AdamW's two f32 moments), the batch, the decode cache;
  * ``memory.temp_peak_bytes`` — the peak of the bytes the step allocates
    while it runs (activations, gathered weights and caches, the kernels'
    outputs and saved states; gradients move to ``static`` as they land);
  * ``bytes_per_device`` = static + temp peak, and ``fits_hbm80`` against
    the H100's 80 GB;
  * ``roofline`` — ``roofline.analyze`` of the step's FLOPs
    (``FlopCounterMode``: ATen's products, and the kernels' custom ops by
    their formulas in ``kernels.work``), the bytes it must move, and its
    collectives' bytes (``collectives``, per kind);
  * ``tp_compute`` — the matrices each "model" rank computes with its
    part of (``split``) and those it computes whole (``launch.steps``).

A step that cannot run that way gets ``status: FAILED`` and its error; no
record holds a guessed number.  The reference's CPU-legalisation fields
have no counterpart and are left out.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b \
        --shape train_4k [--multi-pod] [--out results/dryrun.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \
        --out results/dryrun_torch.json
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import ARCH_NAMES, INPUT_SHAPES, get_config
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import (arch_shape_cfg, assemble,
                                     cache_input_specs, static_bytes)
from repro_torch.roofline import H100_SXM, analyze, model_flops_estimate

HBM_BYTES = H100_SXM.hbm_bytes


class PeakBytes(TorchDispatchMode):
    """The live and peak bytes of the storages the ops under it allocate:
    a storage counts from the first op output on it until the last tensor
    on it is gone; :meth:`release` moves one out (a gradient, counted
    elsewhere), and :meth:`held` marks storages that exist before (the
    step's arguments, counted in ``static``), which an in-place op's
    output on them does not count again."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self._refs: dict[int, list] = {}          # storage -> [count, bytes]
        self._held: set[int] = set()

    def held(self, tensors) -> None:
        self._held.update(t.untyped_storage()._cdata for t in tensors)

    def _drop(self, key: int) -> None:
        ref = self._refs.get(key)
        if ref is not None:
            ref[0] -= 1
            if ref[0] == 0:
                self.live -= ref[1]
                del self._refs[key]

    def release(self, t: torch.Tensor) -> None:
        ref = self._refs.pop(t.untyped_storage()._cdata, None)
        if ref is not None:
            self.live -= ref[1]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._held:
                continue
            ref = self._refs.get(key)
            if ref is None:
                ref = self._refs[key] = [0, st.nbytes()]
                self.live += ref[1]
                self.peak = max(self.peak, self.live)
            ref[0] += 1
            weakref.finalize(t, self._drop, key)
        return out


class _NoUpdate:
    """An optimiser that updates nothing: the dry-run counts AdamW's
    moments in ``static`` and its elementwise update adds no products."""

    def __init__(self, params):
        self.params = list(params)

    def zero_grad(self, set_to_none=True):
        for p in self.params:
            p.grad = None

    def step(self):
        pass


def _meta_tree(tree, specs, mesh, *, grad=False):
    """Meta blocks of a meta-tensor tree at the specs' local shapes."""
    def make(path, t):
        s = specs
        for k in path:
            s = s[k]
        out = torch.empty(shd.local_shape(tuple(t.shape), s, mesh),
                          dtype=t.dtype, device="meta")
        return out.requires_grad_(grad)
    return shd.tree_map_with_path(make, tree)


def kernel_flops(fc) -> dict:
    """{kernel op: operations} of a ``FlopCounterMode``'s count: the
    port's custom ops (``repro_torch::...``)."""
    out = {}
    for op, n in fc.get_flop_counts().get("Global", {}).items():
        ns, _, name = str(op).partition(".")
        if ns == "repro_torch":
            out[name] = out.get(name, 0) + int(n)
    return out


def step_costs(step, shape) -> dict:
    """Run rank 0's step of a ``LoweredStep`` once on meta tensors:
    {"flops", "aten_flops", "kernel_flops", "temp_peak_bytes",
    "collectives", "bytes"} (``bytes``: each input read once, each output
    written once: the prefill's cache and logits, the decode's logits)."""
    from torch.utils.flop_counter import FlopCounterMode
    mesh, static = step.mesh, static_bytes(step)
    coll.reset_counts()
    tracker = PeakBytes()
    params = _meta_tree(step.arg_specs[0], step.specs[0], mesh,
                        grad=step.mode == "train")
    leaves = shd.tree_leaves(params)
    for p in leaves if step.mode == "train" else ():
        p.register_post_accumulate_grad_hook(
            lambda p: tracker.release(p.grad))
    batch = step.arg_specs[2 if step.mode == "train" else 1]
    args = ((params, _NoUpdate(leaves), batch) if step.mode == "train"
            else (params, batch))
    if step.mode == "decode":
        cache = _meta_tree(step.arg_specs[2], step.specs[2], mesh)
        cache["pos"] = shape.seq_len - 1
        args = args + (cache,)
        # the decode step writes its token into the cache blocks in place
        tracker.held(shd.tree_leaves(cache["layers"] if "layers" in cache
                                     else {k: v for k, v in cache.items()
                                           if k != "pos"}))
    with FlopCounterMode(display=False) as fc, tracker:
        out = step(*args)
    del out, args
    kernel = kernel_flops(fc)
    aten = fc.get_total_flops() - sum(kernel.values())
    if step.mode == "train":            # params and moments, read + written
        moved = 2 * static["params"] + 2 * static["opt_moments"] \
            + static["batch"]
    else:
        # the logits of this rank's rows, [rows, 1, V] in the model's dtype
        first = next(iter(batch))
        rows = shd.local_shape(tuple(batch[first].shape),
                               step.specs[1][first], mesh)[0]
        moved = static["total"] + rows * step.cfg.vocab_size * torch.empty(
            (), dtype=getattr(torch, step.cfg.dtype)).element_size()
    if step.mode == "prefill":          # the cache it writes
        moved += sum(
            math.prod(shd.local_shape(tuple(t.shape), s, mesh))
            * t.element_size() for t, s in zip(
                shd.tree_leaves(cache_input_specs(step.api, shape)),
                shd.tree_leaves(step.specs[2])))
    return {"flops": float(fc.get_total_flops()), "aten_flops": float(aten),
            "kernel_flops": kernel,
            "temp_peak_bytes": int(tracker.peak),
            "collectives": dict(coll.COLLECTIVE_BYTES),
            "bytes": float(moved), "static": static}


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            seq_shard_cache: bool = False, extra_cfg_kw=None,
            verbose: bool = True) -> dict:
    """Dry-run one (arch, shape, mesh). Returns the result record."""
    base_cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    cfg = arch_shape_cfg(base_cfg, shape)
    mesh = make_production_mesh(multi_pod=multi_pod)
    rec: dict = {"arch": arch, "shape": shape_name,
                 "mesh": "x".join(str(s) for s in mesh.shape)}
    if cfg is None:
        rec["status"] = "skipped"
        rec["reason"] = "no 500k-token decoder for whisper (skip policy)"
        return rec
    chips = mesh.size()
    t0 = time.perf_counter()
    try:
        step = assemble(cfg, shape, mesh, seq_shard_cache=seq_shard_cache,
                        extra_cfg_kw=extra_cfg_kw)
        costs = step_costs(step, shape)
    except Exception as e:                         # noqa: BLE001
        rec["status"] = "FAILED"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[dryrun] {arch} × {shape_name} FAILED: {rec['error']}")
        return rec
    rec["status"] = "ok"
    rec["sharding"] = step.shard_report.summary()
    rec["tp_compute"] = step.tp_compute
    rec["run_s"] = time.perf_counter() - t0
    rec["memory"] = {"static": costs["static"],
                     "temp_peak_bytes": costs["temp_peak_bytes"]}
    rec["bytes_per_device"] = costs["static"]["total"] + \
        costs["temp_peak_bytes"]
    rec["fits_hbm80"] = bool(rec["bytes_per_device"] < HBM_BYTES)
    roof = analyze(f"{arch}/{shape_name}", costs, chips=chips,
                   model_flops=model_flops_estimate(step.cfg, shape))
    rec["roofline"] = roof.row()
    rec["flops"] = {"aten": costs["aten_flops"],
                    "kernels": costs["kernel_flops"]}
    rec["collectives"] = costs["collectives"]
    if verbose:
        print(f"[dryrun] {arch} × {shape_name} ({rec['mesh']}): OK "
              f"mem/dev={rec['bytes_per_device'] / 2**30:.2f}GiB "
              f"dominant={roof.dominant} "
              f"terms=({roof.compute_s:.2e},{roof.memory_s:.2e},"
              f"{roof.collective_s:.2e})s in {rec['run_s']:.1f}s")
    return rec


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, action="append",
                    help="an architecture (repeat for more; default all)")
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--seq-shard-cache", action="store_true",
                    help="sequence-parallel KV cache (perf variant)")
    ap.add_argument("--out", default=None, help="JSON output path")
    args = ap.parse_args(argv)

    archs = ARCH_NAMES if (args.all or not args.arch) else args.arch
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    results = []
    for mp in meshes:
        for arch in archs:
            for shp in shapes:
                results.append(run_one(arch, shp, multi_pod=mp,
                                       seq_shard_cache=args.seq_shard_cache))
    ok = sum(r["status"] == "ok" for r in results)
    skip = sum(r["status"] == "skipped" for r in results)
    fail = sum(r["status"] == "FAILED" for r in results)
    print(f"[dryrun] done: {ok} ok, {skip} skipped, {fail} failed "
          f"of {len(results)}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"[dryrun] wrote {args.out}")
    if fail:
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()
