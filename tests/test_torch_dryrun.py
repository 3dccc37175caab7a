"""The port's dry-run and roofline on the CPU: ``tests/test_dryrun_small.py``'s
three cases (reduced qwen3 train, deepseek-moe prefill, zamba2 decode) on a
(4, 2) abstract mesh, run on meta tensors — FLOPs > 0, a valid dominant
term, and the static bytes per device equal to the sum of the local shard
bytes under the reference's specs — plus the production records of
``launch.dryrun``, the kernels' custom ops on meta tensors and their
operation counts, and the byte tracker."""
import json
import math

import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh as RAbstractMesh

from repro.configs import reduced_config as r_reduced
from repro.distributed import sharding as rshd
from repro.launch.steps import batch_input_specs as r_batch_input_specs
from repro.models import build_model as r_build_model
from repro.models import param_count as r_param_count

from repro_torch.configs import reduced_config
from repro_torch.configs.base import InputShape
from repro_torch.distributed.context import AbstractMesh
from repro_torch.kernels import work
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.slstm_scan.ops import slstm_scan
from repro_torch.kernels.ssm_scan.ops import ssd_chunked_kernel
from repro_torch.launch import dryrun
from repro_torch.launch.steps import assemble, static_bytes
from repro_torch.models import build_model
from repro_torch.roofline import H100_SXM, analyze, model_flops_estimate

CASES = [("qwen3-1.7b", InputShape("t", 64, 8, "train")),
         ("deepseek-moe-16b", InputShape("p", 64, 8, "prefill")),
         ("zamba2-1.2b", InputShape("d", 64, 8, "decode"))]


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (i,))
    else:
        yield path, tree


def at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def local_bytes(shape, spec, sizes, itemsize, drop):
    """Bytes of one rank's block under a reference spec whose first
    ``drop`` entries are stack dims the port's tensor does not have."""
    n = 1
    for d, entry in zip(shape, tuple(spec)[drop:]):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        n *= d // math.prod(sizes[a] for a in axes)
    return n * itemsize


def ref_static_bytes(arch, shape):
    """One rank's static bytes of the port's tensors under the
    reference's specs on a (4, 2) mesh."""
    sizes = {"data": 4, "model": 2}
    rmesh = RAbstractMesh((4, 2), ("data", "model"))
    rcfg, pcfg = r_reduced(arch), reduced_config(arch)
    rshapes = r_build_model(rcfg).param_shapes()
    mode = "train" if shape.mode == "train" else "serve"
    no_fsdp = mode == "train" and r_param_count(rshapes) < 5e8
    rspecs, _ = rshd.param_specs(rcfg, rshapes, rmesh, mode=mode,
                                 no_fsdp=no_fsdp)
    papi = build_model(pcfg)
    item = torch.empty((), dtype=getattr(torch, pcfg.dtype)).element_size()
    params = 0
    for path, pshape in leaves(papi.param_shapes()):
        rpath = tuple(k for k in path if not isinstance(k, int))
        drop = len(at(rshapes, rpath)) - len(pshape)
        params += local_bytes(pshape, at(rspecs, rpath), sizes, item, drop)
    out = {"params": params}
    rb = r_batch_input_specs(rcfg, shape)
    bspecs = rshd.batch_specs(rcfg, {k: v.shape for k, v in rb.items()},
                              rmesh)
    # the port's token ids are int64 where the reference's are int32
    out["batch"] = sum(local_bytes(v.shape, bspecs[k], sizes,
                                   8 if v.dtype == jnp.int32 else
                                   v.dtype.itemsize, 0)
                       for k, v in rb.items())
    if mode == "train":
        out["grads"] = params
        out["opt_moments"] = 2 * params * 4 // item
    if shape.mode == "decode":
        rc = r_build_model(rcfg).cache_shapes(shape.global_batch,
                                              shape.seq_len)
        cspecs = rshd.cache_specs(rcfg, rc, rmesh)
        cache = 0
        for path, (cshape, dt) in leaves(
                papi.cache_shapes(shape.global_batch, shape.seq_len)):
            drop = len(at(rc, path)[0]) - len(cshape)
            cache += local_bytes(cshape, at(cspecs, path), sizes,
                                 dt.itemsize, drop)
        out["cache"] = cache
    out["total"] = sum(out.values())
    return out


@pytest.mark.parametrize("arch,shape", CASES, ids=[c[0] for c in CASES])
def test_dryrun_on_a_4x2_mesh(arch, shape):
    mesh = AbstractMesh((4, 2), ("data", "model"))
    step = assemble(reduced_config(arch), shape, mesh, auto_knobs=False)
    costs = dryrun.step_costs(step, shape)
    roof = analyze(arch, costs, chips=8,
                   model_flops=model_flops_estimate(step.cfg, shape))
    assert roof.flops > 0 and costs["aten_flops"] > 0
    assert roof.dominant in ("compute", "memory", "collective")
    assert costs["temp_peak_bytes"] > 0
    assert costs["static"] == static_bytes(step)
    assert costs["static"] == ref_static_bytes(arch, shape)
    # every sharded step gathers its weights
    assert costs["collectives"]["all-gather"] > 0


def test_production_records_and_skip_policy(capsys):
    records = dryrun.main(["--arch", "whisper-tiny", "--shape",
                           "long_500k"])
    assert [r["status"] for r in records] == ["skipped"]
    rec = dryrun.run_one("gemma-2b", "long_500k")
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    for key in ("sharding", "memory", "bytes_per_device", "roofline",
                "collectives", "fits_hbm80"):
        assert key in rec
    assert rec["bytes_per_device"] == (rec["memory"]["static"]["total"]
                                       + rec["memory"]["temp_peak_bytes"])
    assert rec["roofline"]["bound_s"] > 0
    assert "[dryrun]" in capsys.readouterr().out


@pytest.mark.parametrize("status,exits", [("ok", False),
                                           ("FAILED", True)])
def test_cli_takes_several_archs_and_exits_1_on_a_failure(
        status, exits, monkeypatch, tmp_path):
    seen = []
    monkeypatch.setattr(dryrun, "run_one", lambda a, s, **kw: seen.append(
        (a, s)) or {"arch": a, "shape": s, "status": status})
    out = tmp_path / "records.json"
    argv = ["--arch", "gemma-2b", "--arch", "zamba2-1.2b", "--shape",
            "long_500k", "--out", str(out)]
    if exits:
        with pytest.raises(SystemExit) as e:
            dryrun.main(argv)
        assert e.value.code == 1
    else:
        dryrun.main(argv)
    assert seen == [("gemma-2b", "long_500k"), ("zamba2-1.2b", "long_500k")]
    assert [r["arch"] for r in json.loads(out.read_text())] == [
        "gemma-2b", "zamba2-1.2b"]


@pytest.mark.parametrize("sq,sk,causal,window,valid", [
    (7, 7, True, 0, 0), (5, 9, True, 0, 0), (9, 9, True, 3, 0),
    (6, 11, False, 0, 8), (4, 4, False, 2, 0), (1, 16, True, 0, 10)])
def test_attention_pairs_count_the_mask(sq, sk, causal, window, valid):
    row = torch.arange(sq)[:, None]
    col = torch.arange(sk)[None, :]
    live = (col < (valid or sk)).expand(sq, sk)
    if causal:
        live = live & (col <= row)
    if window:
        live = live & (row - col < window)
    assert work.attention_pairs(sq, sk, causal=causal, window=window,
                                  valid_len=valid) == int(live.sum())


def test_kernels_take_their_shape_only_route_on_meta_tensors():
    """Meta tensors go through each kernel's custom op to its fake
    implementation (forward and, under autograd, backward), and
    ``FlopCounterMode`` counts each op by its ``kernels.work`` formula."""
    from torch.utils.flop_counter import FlopCounterMode
    meta = dict(device="meta")
    with FlopCounterMode(display=False) as fc:
        q = torch.empty(2, 16, 4, 32, dtype=torch.bfloat16, **meta)
        kv = torch.empty(2, 16, 2, 32, dtype=torch.bfloat16, **meta)
        out, lse = flash_attention(q, kv, kv, return_lse=True)
        assert out.shape == q.shape and out.is_meta
        assert lse.shape == (2, 4, 16)
        x = torch.empty(2, 10, 4, 8, **meta, requires_grad=True)
        dt = torch.empty(2, 10, 4, **meta)
        a_log, d_skip = torch.empty(4, **meta), torch.empty(4, **meta)
        b = torch.empty(2, 10, 16, **meta)
        y, state = ssd_chunked_kernel(x, dt, a_log, b, b, d_skip, chunk=4)
        assert y.shape == x.shape and state.shape == (2, 4, 8, 16)
        y.sum().backward()
        assert x.grad.shape == x.shape
        pre = torch.empty(4, 2, 10, 32, **meta, requires_grad=True)
        r = torch.empty(4, 2, 16, 16, **meta)
        hs, st = slstm_scan(pre, r, out_dtype=torch.bfloat16)
        assert hs.shape == (2, 10, 32) and hs.dtype == torch.bfloat16
        assert len(st) == 4
        hs.float().sum().backward()
        assert pre.grad.shape == pre.shape
    got = dryrun.kernel_flops(fc)
    assert got == {
        "flash_attention_lse": 2 * 2 * 4 * 64 * (16 * 17 // 2),
        "ssd_scan_save": work.ssm_work(2, 10, 4, 8, 16, 4)[1],
        "ssd_scan_bwd": work.ssm_bwd_work(2, 10, 4, 8, 16, 4)[1],
        "slstm_scan_save": 8 * 2 * 10 * 2 * 16 * 16,
        "slstm_scan_bwd": 16 * 2 * 10 * 2 * 16 * 16}


def test_peak_bytes_tracks_storages_not_views():
    with dryrun.PeakBytes() as tracker:
        a = torch.empty(1024, device="meta")                  # 4 KiB
        v = a.view(32, 32)                                    # same storage
        b = torch.empty(512, device="meta")                   # 2 KiB
        assert tracker.live == 6144 and tracker.peak == 6144
        del a, v
        c = torch.empty(256, device="meta")
        assert tracker.live == 2048 + 1024
        tracker.release(b)
        assert tracker.live == 1024 and tracker.peak == 6144
        del b, c


def test_roofline_terms_on_the_h100():
    roof = analyze("x", {"flops": 989e12, "bytes": 3.35e12,
                         "collectives": {"all-gather": 450e9}}, chips=2,
                   model_flops=989e12)
    assert roof.compute_s == pytest.approx(1.0)
    assert roof.memory_s == pytest.approx(1.0)
    assert roof.collective_s == pytest.approx(1.0)
    assert roof.bound_s == pytest.approx(1.0)
    assert roof.useful_ratio == pytest.approx(0.5)
    assert H100_SXM.peak_flops == 989e12 and H100_SXM.hbm_bw == 3.35e12
