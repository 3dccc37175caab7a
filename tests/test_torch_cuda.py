"""The port's CUDA kernels against their plain versions, on the card.

A CUDA kernel has no CPU mode, so these tests skip where there is no card.
On a machine with one they run with::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import dataclasses
import importlib.util
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import decisions as dec
from repro_torch.core.costs import CompositeCost, lower_to_accel
from repro_torch.core import offload as off
from repro_torch.core.predictors.gbt import GBTRegressor
from repro_torch.hw import EDGE_DEVICES, get_device
from repro_torch.kernels.decide_split import kernel as ds_kernel
from repro_torch.kernels.decide_split import ref as ds_ref
from repro_torch.kernels.decide_split.ops import pack_inputs
from repro_torch.kernels.gbt_hist import kernel as gh_kernel
from repro_torch.kernels.gbt_hist import ref as gh_ref
from repro_torch.kernels.tree_predict import kernel as tp_kernel
from repro_torch.kernels.tree_predict import ref as tp_ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("n,f,n_bins", [(12000, 7, 64), (3, 2, 8), (0, 7, 64)])
def test_gbt_hist_kernel_matches_plain(cuda, n, f, n_bins):
    """The f64 sums in np.bincount's order: equal to the plain version on
    a CPU copy bit for bit (the card's torch.bincount adds with atomics)."""
    rng = np.random.default_rng(n)
    codes = torch.as_tensor(rng.integers(0, n_bins, (n, f)), dtype=torch.int32,
                            device=cuda)
    grad = torch.as_tensor(rng.normal(size=n), dtype=torch.float64,
                           device=cuda)
    gsum, cnt = gh_kernel.grad_histogram_kernel(codes, grad, n_bins)
    torch.cuda.synchronize()
    pg, pc = gh_ref.grad_histogram_ref(codes.cpu(), grad.cpu(), n_bins)
    assert gsum.dtype == torch.float64 and cnt.dtype == torch.int32
    assert torch.equal(cnt.cpu().double(), pc)
    assert torch.equal(gsum.cpu(), pg)


def _level_case(n_rows: int, sizes: list[int], f: int, n_bins: int,
                seed: int):
    """Codes with a 3-valued feature (most rows in few bins, as the fit's
    data has) and some out of range, f64 gradients, and a level's rows:
    random ascending ids grouped into nodes of ``sizes`` rows."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, n_bins, (n_rows, f))
    codes[:, 0] = rng.integers(0, 3, n_rows)
    codes[rng.random((n_rows, f)) < 0.01] = n_bins + 3
    grad = rng.normal(size=n_rows)
    perm = rng.permutation(n_rows)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    order = np.concatenate([np.sort(perm[lo:hi]) for lo, hi in
                            zip(offsets[:-1], offsets[1:])])
    return codes, grad, order, offsets


@pytest.mark.parametrize("level", ["root", "deep"])
def test_gbt_level_kernel_matches_plain(cuda, level):
    """One launch for a whole level, bit for bit with the plain version on
    a CPU copy: the root (one node of 12,589 rows) and a deep level of
    1,500 nodes of 0 to 20 rows."""
    if level == "root":
        n_rows, sizes = 15800, [12589]
    else:
        sizes = list(np.random.default_rng(1).integers(0, 21, 1500))
        n_rows = 15800
    codes, grad, order, offsets = _level_case(n_rows, sizes, 7, 64, 0)
    args = [torch.as_tensor(a, dtype=dt, device=cuda) for a, dt in
            ((codes, torch.int32), (grad, torch.float64),
             (order, torch.int32), (offsets, torch.int32))]
    gh_kernel.level_histogram_kernel.launches = 0
    gsum, cnt = gh_kernel.level_histogram_kernel(*args, 64)
    torch.cuda.synchronize()
    assert gh_kernel.level_histogram_kernel.launches == 1
    pg, pc = gh_ref.level_histogram_ref(*(a.cpu() for a in args), 64)
    assert gsum.shape == (len(sizes), 7, 64)
    assert torch.equal(cnt.cpu().double(), pc)
    assert torch.equal(gsum.cpu(), pg)


def _reference_module(rel: str):
    """A numpy-only module of the JAX package, loaded from its file so that
    the package's ``__init__`` (which imports jax) does not run."""
    path = Path(__file__).resolve().parents[1] / "src" / "repro" / rel
    name = "_reference_" + rel.replace("/", "_")[:-3]
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        sys.modules[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[name])
    return sys.modules[name]


def test_gbt_fit_on_the_card_grows_the_reference_trees(cuda):
    """Two fits on the card with one seed give the reference's node arrays
    (``repro.core.predictors.gbt``, whose histogram is np.bincount), as
    ``tests/test_torch_gbt.py`` asks of a fit on the CPU."""
    r_gbt = _reference_module("core/predictors/gbt.py")
    r_flatten = _reference_module("kernels/tree_predict/ref.py").flatten_gbt
    rng = np.random.default_rng(0)
    x = rng.normal(size=(300, 5)).astype(np.float32)
    y = np.sin(x[:, 0]) + x[:, 1] ** 2 + 0.1 * rng.normal(size=300)
    kw = dict(n_trees=10, max_depth=6, subsample=0.8, seed=0)
    ref = r_flatten(r_gbt.GBTRegressor(**kw).fit(x, y))
    gh_kernel.level_histogram_kernel.launches = 0
    for _ in range(2):
        got = tp_ref.flatten_gbt(GBTRegressor(**kw).fit(x, y, device=cuda))
        for f in ("feature", "threshold_bin", "left", "right", "value",
                  "n_nodes", "edges"):
            assert np.array_equal(getattr(ref, f), getattr(got, f)), f
        assert (ref.base, ref.learning_rate, ref.max_depth) == \
            (got.base, got.learning_rate, got.max_depth)
    # one launch per level that splits a node: at most depth levels a tree
    assert 0 < gh_kernel.level_histogram_kernel.launches \
        <= 2 * kw["n_trees"] * kw["max_depth"]


def test_tree_predict_kernel_matches_plain(cuda):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(500, 6)).astype(np.float32)
    y = np.sin(x[:, 0]) * x[:, 1]
    model = GBTRegressor(n_trees=30, max_depth=8, subsample=0.8).fit(
        x, y, device=cuda)
    a = tp_ref.flatten_gbt(model)
    t = tp_ref.device_trees(a, cuda)
    codes = tp_ref.bin_codes_ref(torch.as_tensor(x, device=cuda), t.edges)
    args = (codes, t.feature, t.threshold_bin, t.left, t.right,
            t.scaled_value)
    got = tp_kernel.tree_predict_kernel(*args, max_depth=a.max_depth,
                                        base=a.base)
    want = tp_ref.tree_predict_ref(*args, max_depth=a.max_depth, base=a.base)
    # the same f64 additions in the same order: exactly equal
    assert torch.equal(got, want)
    assert torch.equal(model.predict(x, device=cuda).cpu(),
                       model.predict(x, device="cpu"))


@pytest.mark.parametrize("n_layers,n_envs", [(0, 7), (28, 100003), (300, 4099)])
def test_decide_split_kernel_matches_plain(cuda, n_layers, n_envs):
    rng = np.random.default_rng(n_layers)
    layers = [off.LayerCost(f"l{i}", float(f), float(a)) for i, (f, a) in
              enumerate(zip(rng.uniform(1e6, 1e12, n_layers),
                            rng.uniform(1e2, 1e8, n_layers)))]
    specs = list(EDGE_DEVICES.values())
    envs = dec.make_envs([specs[i] for i in rng.integers(5, size=n_envs)],
                         get_device("edge-server-a100"),
                         link_bw=rng.uniform(1e4, 1e10, n_envs),
                         link_latency_s=rng.uniform(0, 0.05, n_envs),
                         input_bytes=rng.uniform(0, 1e7, n_envs),
                         device=cuda)
    spec = lower_to_accel(CompositeCost(
        weights={"latency_s": 1.0, "energy_j": 0.05}, deadline_s=0.5))
    args = pack_inputs(layers, envs, spec).kernel_args
    ks, kc = ds_kernel.decide_split_kernel(*args)
    ps, pc = ds_ref.decide_split_ref(*args)
    torch.testing.assert_close(kc, pc, rtol=1e-5, atol=0.0)
    assert (ks == ps).double().mean().item() > 0.999
    kernel_plan = dec.decide_all(layers, envs, device=cuda)
    exact = dec.decide_all(layers, envs, backend="torch", device=cuda)
    assert torch.all(kernel_plan.total_time_s
                     <= exact.total_time_s * (1 + 1e-4) + 1e-12)


# (descent's route forced through the private helper, or None; N, T, node
# slots, depth): the decision path's shape; N not a multiple of the 128-row
# tile with T not a multiple of the trees a block takes (7 at N 1000, T 205
# in shared memory; 2 at N 1000, T 41 on the global route); N 0 and 1;
# stumps; trees beyond shared memory (10,001 slots), which choose the global
# route themselves; the global route forced at the decision path's shape
TREE_GPU_CASES = [
    (None, 56, 200, 643, 12),
    (None, 0, 200, 643, 12),
    (None, 1, 200, 643, 12),
    (None, 1000, 205, 643, 12),
    (None, 300, 37, 101, 6),
    (None, 56, 10, 1, 0),
    ("descend_global", 56, 200, 643, 12),
    ("descend_global", 1000, 205, 643, 12),
    (None, 57, 3, 10_001, 20),
    (None, 0, 3, 10_001, 20),
    (None, 1, 3, 10_001, 20),
    (None, 1000, 41, 10_001, 20),
]


@pytest.mark.parametrize("route,n,n_trees,max_nodes,depth", TREE_GPU_CASES)
def test_tree_predict_routes_match_plain(cuda, route, n, n_trees, max_nodes,
                                         depth):
    """The whole call on the route it chooses, and the descent (on
    ``route`` where one is forced) and the fold on their own, bit for bit
    with the plain version (``torch.equal``), on synthetic ensembles."""
    from repro_torch.bench.kernels import random_trees
    trees = random_trees(n_trees, max_nodes, depth, 7, 64, seed=n + depth)
    nodes = tuple(torch.as_tensor(trees[k], device=cuda) for k in
                  ("feature", "threshold_bin", "left", "right",
                   "scaled_value"))
    codes = torch.as_tensor(np.random.default_rng(n).integers(0, 64, (n, 7)),
                            dtype=torch.int32, device=cuda)
    chosen = tp_kernel.choose_route(n, 7, n_trees, max_nodes)[0]
    assert chosen == ("descend_global" if max_nodes > 9_400
                      else "descend_shared")
    tp_kernel.reset_counts()
    got = tp_kernel.tree_predict_kernel(codes, *nodes, max_depth=depth,
                                        base=0.25)
    leaf = tp_kernel._descend(codes, *nodes, depth, route)
    folded = tp_kernel._fold(leaf, 0.25)
    torch.cuda.synchronize()
    want = tp_ref.tree_predict_ref(codes, *nodes, max_depth=depth, base=0.25)
    assert got.shape == (n,) and torch.equal(got, want)
    assert torch.equal(leaf, tp_ref.leaf_matrix_ref(codes, *nodes,
                                                    max_depth=depth))
    assert torch.equal(folded, tp_ref.fold_ref(leaf, 0.25))
    expect = dict.fromkeys(tp_kernel.KERNELS, 0)
    if n:
        expect[chosen] += 1
        expect[route or chosen] += 1
        expect["fold"] = 2
    assert tp_kernel.tree_predict_kernel.launches == (n > 0)
    assert tp_kernel.tree_predict_kernel.by_kernel == expect
    if chosen == "descend_global" and n:
        with pytest.raises(ValueError, match="shared memory"):
            tp_kernel._descend(codes, *nodes, depth, "descend_shared")


def _decision_inputs(cuda, seed, n_splits, n_envs, **spec_kw):
    """Random factored inputs of a sweep (links of 1e4 to 1e10 B/s) and
    its packed spec, f32 on the card."""
    rng = np.random.default_rng(seed)
    dcum = np.concatenate(([0.0], np.cumsum(rng.uniform(1e8, 1e11,
                                                        n_splits - 1))))
    bvec = np.concatenate(([0.0], rng.uniform(1e2, 1e8, n_splits - 1)))
    bvec[-1] = 0.0
    cols = [rng.uniform(1e9, 1e13, n_envs), rng.uniform(1e11, 1e14, n_envs),
            rng.uniform(1e4, 1e10, n_envs), rng.uniform(0.0, 0.05, n_envs),
            rng.uniform(0.0, 1e7, n_envs), rng.uniform(5, 50, n_envs),
            rng.uniform(100, 400, n_envs)]
    spec = ds_kernel.pack_spec(edge_total=float(dcum[-1]), **spec_kw)
    return [torch.as_tensor(np.asarray(a, np.float32), device=cuda)
            for a in (dcum, dcum, bvec, *cols, spec)]


DECIDE_SPECS = {
    "latency": dict(weights=(1.0, 0.0, 0.0, 0.0)),
    "composite": dict(weights=(1.0, 0.05, 1.0, 0.0), radio_watts=2.5,
                      price_per_edge_s=0.1, price_per_gb=0.01),
    # w3 != 0: the path that keeps the divisions of total
    "queue_tail_deadline": dict(weights=(1.0, 0.05, 1.0, 2.0),
                                radio_watts=2.5, price_per_edge_s=0.1,
                                price_per_gb=0.01, deadline_s=0.05,
                                queue_wait_s=0.02, tail_excess_s=0.03,
                                tail_weight=0.5),
    "deadline": dict(weights=(0.0, 0.0, 0.0, 1.0), deadline_s=0.05),
}


@pytest.mark.parametrize("spec_name", sorted(DECIDE_SPECS))
@pytest.mark.parametrize("n_splits", [1, 2, 29, 301])
def test_decide_split_kernel_edges_match_plain(cuda, n_splits, spec_name):
    """L+1 of 1, 2, 29 and 301 (two chunks of splits) over 1,003
    environments (not a multiple of the 256-thread block): costs within
    rtol 1e-5 of the plain version, splits matching in > 0.999 of them,
    each split near-optimal in f64 on the same inputs."""
    args = _decision_inputs(cuda, n_splits, n_splits, 1003,
                            **DECIDE_SPECS[spec_name])
    ks, kc = ds_kernel.decide_split_kernel(*args)
    ps, pc = ds_ref.decide_split_ref(*args)
    torch.testing.assert_close(kc, pc, rtol=1e-5, atol=0.0)
    assert (ks == ps).double().mean().item() > 0.999
    exact = ds_ref.cost_matrix_ref(*(a.double() for a in args))
    got = exact.gather(1, ks.long()[:, None])[:, 0]
    assert torch.all(got <= exact.min(dim=1).values * (1 + 1e-4) + 1e-12)


@pytest.mark.parametrize("spec_name", ["composite", "queue_tail_deadline"])
def test_decide_split_kernel_keeps_the_first_of_tied_splits(cuda,
                                                            spec_name):
    """Planted ties of the least cost at splits 3 and 7, and at 100 and 290
    (across the kernel's chunks of 256 splits): the first is taken."""
    for first, second, n_splits in ((3, 7, 9), (100, 290, 301)):
        args = _decision_inputs(cuda, 0, n_splits, 1003,
                                **DECIDE_SPECS[spec_name])
        dcum, ecum, bvec = (torch.full((n_splits,), v, device=cuda)
                            for v in (5e11, 1e9, 1e3))
        dcum[[first, second]] = 1e9
        cols = [torch.full_like(a, a[0].item()) for a in args[3:10]]
        args = [dcum, ecum, bvec, *cols, args[10]]
        args[10][ds_kernel.SPEC_ETOT] = 1e9
        ks, _ = ds_kernel.decide_split_kernel(*args)
        ps, _ = ds_ref.decide_split_ref(*args)
        assert ps.tolist() == [first] * 1003
        assert torch.equal(ks, ps)


# (B, S, Hq, Hkv, D, window, causal, valid_len, dtype); bf16 with D 64, 96,
# 128 or 256 runs the tensor-core kernel, the rest the f32 CUDA-core kernel
FLASH_GPU_CASES = [
    (1, 128, 4, 4, 32, 0, True, 0, torch.float32),
    (2, 200, 8, 2, 64, 0, True, 0, torch.float32),
    (2, 65, 4, 1, 16, 0, True, 0, torch.float32),
    (1, 256, 2, 2, 128, 31, True, 0, torch.float32),
    (2, 100, 4, 2, 64, 0, False, 77, torch.float32),
    (2, 128, 4, 2, 64, 0, True, 0, torch.bfloat16),
    (2, 130, 4, 2, 32, 0, True, 0, torch.bfloat16),
    (2, 150, 4, 4, 128, 40, False, 120, torch.bfloat16),
    (1, 384, 6, 6, 64, 100, True, 0, torch.bfloat16),
    (4, 2048, 16, 8, 128, 0, True, 0, torch.bfloat16),   # qwen3-1.7b
    (4, 2048, 32, 32, 64, 0, True, 0, torch.bfloat16),   # zamba2-1.2b
    (4, 2048, 36, 4, 128, 0, True, 0, torch.bfloat16),   # starcoder2-7b
    (4, 2048, 24, 8, 128, 0, True, 0, torch.bfloat16),   # minitron-4b
    (4, 2048, 16, 8, 128, 512, True, 0, torch.bfloat16),
    (4, 2048, 16, 8, 128, 0, True, 1500, torch.bfloat16),
    (2, 150, 4, 1, 256, 0, True, 0, torch.float32),      # gemma-2b's D
    (1, 700, 8, 1, 256, 64, True, 600, torch.bfloat16),
    # bf16 around flash_fwd_wgmma's tiles (128 keys; 128 query rows at D
    # 128, 192 at D 64): ragged S, windows at and beside the tile edge,
    # valid_len 1 and 129, non-causal with valid_len or a window, GQA
    # groups of 1, 2 and 4
    (1, 127, 4, 4, 64, 0, True, 0, torch.bfloat16),
    (2, 129, 4, 2, 128, 0, True, 0, torch.bfloat16),
    (1, 255, 8, 2, 64, 0, True, 0, torch.bfloat16),
    (2, 257, 8, 2, 128, 0, True, 0, torch.bfloat16),
    (1, 257, 4, 1, 128, 1, True, 0, torch.bfloat16),
    (1, 255, 4, 4, 64, 127, True, 0, torch.bfloat16),
    (2, 257, 4, 2, 128, 128, True, 0, torch.bfloat16),
    (1, 255, 8, 2, 64, 129, True, 0, torch.bfloat16),
    (1, 129, 4, 1, 128, 0, True, 1, torch.bfloat16),
    (2, 257, 4, 2, 64, 0, True, 129, torch.bfloat16),
    (2, 255, 4, 4, 128, 0, False, 129, torch.bfloat16),
    (1, 127, 8, 2, 64, 0, False, 1, torch.bfloat16),
    (1, 257, 4, 1, 64, 129, False, 0, torch.bfloat16),
    (2, 193, 4, 2, 64, 0, True, 0, torch.bfloat16),
    (1, 385, 4, 1, 64, 191, True, 300, torch.bfloat16),
    # D 96 and 256 on the tensor cores (64-key tiles at 256): ragged S,
    # windows at and beside the tile edge, valid_len, non-causal, MQA
    (2, 77, 8, 1, 256, 0, True, 0, torch.bfloat16),
    (1, 300, 8, 1, 256, 0, True, 0, torch.bfloat16),
    (1, 300, 8, 1, 256, 64, True, 0, torch.bfloat16),
    (1, 300, 8, 1, 256, 65, True, 0, torch.bfloat16),
    (2, 300, 8, 1, 256, 0, True, 129, torch.bfloat16),
    (1, 257, 4, 1, 256, 0, False, 200, torch.bfloat16),
    (2, 77, 4, 2, 96, 0, True, 0, torch.bfloat16),
    (1, 300, 8, 8, 96, 129, True, 250, torch.bfloat16),
    (1, 257, 4, 1, 96, 40, False, 0, torch.bfloat16),
]


def _bf16_reading(got, q, k, v, **kw):
    """The bf16 output's largest error over ``bf16_tolerance``: the f32
    attention of the same values, P's and the output's rounding."""
    from repro_torch.kernels.flash_attention.ref import bf16_tolerance
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    want, tol = (t.transpose(1, 2) for t in bf16_tolerance(qt, kt, vt, **kw))
    return ((got.float() - want).abs() / tol).max().item()


def _check_flash(got, q, k, v, **kw):
    """f32: the JAX package's own 2e-5; bf16: within ``bf16_tolerance``."""
    from repro_torch.kernels.flash_attention.ref import attention_ref
    if q.dtype == torch.float32:
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        want = attention_ref(qt, kt, vt, **kw).transpose(1, 2)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
        return
    over = _bf16_reading(got, q, k, v, **kw)
    assert over <= 1.0, f"bf16 kernel off by {over} of its tolerance"


def _flash_inputs(cuda, b, s, hq, hkv, d, dtype=torch.bfloat16, seed=0,
                  dv=None):
    """Unit-scale q, k, v (scores of std 1, so the softmax is not flat); v
    at head dim ``dv`` (default ``d``)."""
    gen = torch.Generator(device=cuda).manual_seed(seed + s + d)
    return tuple(torch.randn((b, s, h, w), generator=gen, device=cuda)
                 .to(dtype) for h, w in ((hq, d), (hkv, d), (hkv, dv or d)))


def test_flash_attention_unaligned_rows_take_the_cuda_core_kernel(cuda):
    """A head stride that is not a multiple of 8 elements cannot feed the
    tensor-core kernel's 16-byte loads: the f32 CUDA-core kernel runs."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    base = torch.randn(2, 96, 4, 68, device=cuda, dtype=torch.bfloat16)
    q = k = v = base[..., :64]
    fa_kernel.reset_counts()
    got = fa_kernel.flash_attention_kernel(q, k, v)
    assert fa_kernel.flash_attention_kernel.by_kernel == {
        "flash_fwd": 1, "flash_fwd_wgmma": 0}
    _check_flash(got, q, k, v)


@pytest.mark.parametrize("b,s,hq,hkv,d,window,causal,valid_len,dtype",
                         FLASH_GPU_CASES)
def test_flash_attention_kernel_matches_plain(cuda, b, s, hq, hkv, d, window,
                                              causal, valid_len, dtype):
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    rng = np.random.default_rng(s + d)
    # unit scale: scores of std 1, so the softmax is not flat
    q, k, v = (torch.as_tensor(rng.normal(size=(b, s, h, d)),
                               dtype=dtype, device=cuda)
               for h in (hq, hkv, hkv))
    kw = dict(causal=causal, window=window, valid_len=valid_len)
    fa_kernel.reset_counts()
    got = fa_kernel.flash_attention_kernel(q, k, v, **kw)
    torch.cuda.synchronize()
    wgmma = dtype == torch.bfloat16 and (d, d) in fa_kernel.BLOCK_Q
    assert fa_kernel.flash_attention_kernel.by_kernel == {
        "flash_fwd": int(not wgmma), "flash_fwd_wgmma": int(wgmma)}
    _check_flash(got, q, k, v, **kw)


@pytest.mark.parametrize("d", [64, 128])
def test_flash_attention_reads_fused_qkv_views(cuda, d):
    """q, k and v as strided views of one fused [B, S, (Hq+2Hkv)·D] tensor:
    the tensor maps take the caller's strides, not contiguous ones."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    b, s, hq, hkv = 2, 300, 8, 2
    gen = torch.Generator(device=cuda).manual_seed(d)
    fused = torch.randn((b, s, (hq + 2 * hkv) * d), generator=gen,
                        device=cuda).bfloat16()
    q = fused[..., :hq * d].view(b, s, hq, d)
    k = fused[..., hq * d:(hq + hkv) * d].view(b, s, hkv, d)
    v = fused[..., (hq + hkv) * d:].view(b, s, hkv, d)
    assert not (q.is_contiguous() or k.is_contiguous() or v.is_contiguous())
    fa_kernel.reset_counts()
    got = fa_kernel.flash_attention_kernel(q, k, v)
    torch.cuda.synchronize()
    assert fa_kernel.flash_attention_kernel.by_kernel["flash_fwd_wgmma"] == 1
    _check_flash(got, q, k, v)
    _check_flash(fa_kernel.flash_attention_kernel(q.contiguous(),
                                                  k.contiguous(),
                                                  v.contiguous()), q, k, v)


@pytest.mark.parametrize("b,s,hq,hkv,d,dv", [(4, 2048, 16, 8, 128, 128),
                                             (4, 2048, 32, 32, 64, 64),
                                             (4, 2048, 32, 32, 96, 96),
                                             (4, 2048, 16, 16, 192, 128),
                                             (1, 2048, 8, 1, 256, 256)])
def test_flash_attention_is_bitwise_deterministic(cuda, b, s, hq, hkv, d, dv):
    """Calls on the same inputs give the same bits at the prefill shapes of
    qwen3-1.7b, zamba2-1.2b, phi-3-vision, deepseek-v2-lite's MLA and
    gemma-2b: a race on the K/V ring (a wrong barrier parity) would show
    as a difference between calls."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    q, k, v = _flash_inputs(cuda, b, s, hq, hkv, d, dv=dv)
    fa_kernel.reset_counts()
    first = fa_kernel.flash_attention_kernel(q, k, v)
    for _ in range(3):
        assert torch.equal(fa_kernel.flash_attention_kernel(q, k, v), first)
    assert fa_kernel.flash_attention_kernel.by_kernel["flash_fwd_wgmma"] == 4


# faults planted in a copy of the source: the diagonal tile's causal test
# `<=` written as `<`; the last live key tile dropped from the walk
FLASH_FAULTS = {
    "diagonal_excluded": ("(!causal || col <= row)",
                          "(!causal || col < row)"),
    "last_tile_dropped": (
        "return {lo, hi > lo ? (hi - lo + TK - 1) / TK : 0};",
        "return {lo, hi > lo ? (hi - lo - 1) / TK : 0};"),
}
# the qwen3-1.7b prefill shape and ragged ones at D 128, 96 and 256
FLASH_FAULT_SHAPES = [(4, 2048, 16, 8, 128), (1, 700, 8, 1, 128),
                      (1, 700, 8, 2, 96), (1, 700, 8, 1, 256)]


def _flash_fault_readings(cuda):
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    out = []
    for shape in FLASH_FAULT_SHAPES:
        q, k, v = _flash_inputs(cuda, *shape)
        fa_kernel.reset_counts()
        got = fa_kernel.flash_attention_kernel(q, k, v)
        assert fa_kernel.flash_attention_kernel.by_kernel[
            "flash_fwd_wgmma"] == 1
        out.append(_bf16_reading(got, q, k, v))
    return out


@pytest.mark.parametrize("fault", sorted(FLASH_FAULTS))
def test_flash_tolerance_sees_planted_faults(cuda, fault, tmp_path,
                                             monkeypatch):
    """Each fault, built from a copy of ``csrc`` (``flash_attention.cu``
    and the header it includes) in a temporary directory, reads above 1 at
    every shape; the sound kernel reads below 1 there."""
    from repro_torch.kernels import _build
    csrc = _csrc_copy(tmp_path, "flash_attention", *FLASH_FAULTS[fault])
    sound = _flash_fault_readings(cuda)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    planted = _flash_fault_readings(cuda)
    print(f"flash_attention fault {fault}: err_over_tol sound {sound}, "
          f"planted {planted}")
    assert all(r < 1.0 for r in sound)
    assert all(r > 1.0 for r in planted)


# (B, S, H, P, N, chunk)
SSD_GPU_CASES = [(1, 64, 2, 8, 8, 16), (2, 100, 3, 16, 4, 32),
                 (1, 33, 1, 4, 32, 8), (4, 2048, 64, 64, 64, 128)]


def _ssd_case(cuda, b, s, h, p, n):
    from repro_torch.kernels.ssm_scan.ref import ssd_inputs
    rng = np.random.default_rng(s)
    x = torch.as_tensor(rng.normal(size=(b, s, h, p)) * 0.5,
                        dtype=torch.float32, device=cuda)
    dt = torch.nn.functional.softplus(torch.as_tensor(
        rng.normal(size=(b, s, h)) * 0.5, dtype=torch.float32, device=cuda))
    bb, cc = (torch.as_tensor(rng.normal(size=(b, s, n)) * 0.5,
                              dtype=torch.float32, device=cuda)
              for _ in range(2))
    a_log = torch.log(torch.linspace(1.0, 8.0, h, device=cuda))
    return (*ssd_inputs(x, dt, a_log), bb, cc)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_GPU_CASES)
def test_ssm_scan_kernel_matches_plain(cuda, b, s, h, p, n, chunk):
    from repro_torch.kernels.ssm_scan import kernel as ss_kernel
    from repro_torch.kernels.ssm_scan.ref import ssd_scan_chunked_ref
    xdt, loga, bb, cc = _ssd_case(cuda, b, s, h, p, n)
    ss_kernel.reset_counts()
    y, st = ss_kernel.ssd_scan_kernel(xdt, loga, bb, cc, chunk)
    torch.cuda.synchronize()
    assert ss_kernel.ssd_scan_kernel.launches == 1
    assert ss_kernel.ssd_scan_kernel.by_kernel == {"ssd_cb": 1,
                                                   "ssd_chunk": 1}
    y_p, st_p = ssd_scan_chunked_ref(xdt, loga, bb, cc, chunk)
    # f32 in another summation order: the JAX package's 2e-4, relative to
    # the output's scale
    for got, want in ((y, y_p), (st, st_p)):
        torch.testing.assert_close(got, want, rtol=2e-4,
                                   atol=2e-4 * want.abs().max().item())


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_GPU_CASES)
def test_ssm_scan_kernel_is_bitwise_deterministic(cuda, b, s, h, p, n, chunk):
    """The chunks hand the state on through counters: a race in that
    hand-off would show as a difference between calls."""
    from repro_torch.kernels.ssm_scan import kernel as ss_kernel
    args = (*_ssd_case(cuda, b, s, h, p, n), chunk)
    first = ss_kernel.ssd_scan_kernel(*args)
    for _ in range(3):
        for got, want in zip(ss_kernel.ssd_scan_kernel(*args), first):
            assert torch.equal(got, want)


# faults planted in a copy of the source: each chunk hands on the state it
# received instead of the one it formed (H one chunk late), and the decay
# exp(total) dropped from the state update
SSD_FAULTS = {
    "handed_one_chunk_late": (
        "make_float4(hnew[i][0], hnew[i][1], hnew[i][2], hnew[i][3])",
        "make_float4(hprev[i][0], hprev[i][1], hprev[i][2], hprev[i][3])"),
    "exp_total_dropped": ("hnew[i][j] = decay * hprev[i][j] + hs[i][j];",
                          "hnew[i][j] = hprev[i][j] + hs[i][j];"),
}
# zamba2-1.2b's prefill and a ragged case
SSD_FAULT_SHAPES = [(4, 2048, 64, 64, 64, 128), (2, 100, 3, 16, 4, 32)]


def _ssd_fault_readings(cuda):
    """Per shape, the largest error of y and of the state over the checks'
    limit (2e-4 of |want| plus 2e-4 of max |want|)."""
    from repro_torch.kernels.ssm_scan import kernel as ss_kernel
    from repro_torch.kernels.ssm_scan.ref import ssd_scan_chunked_ref
    out = []
    for b, s, h, p, n, chunk in SSD_FAULT_SHAPES:
        args = (*_ssd_case(cuda, b, s, h, p, n), chunk)
        worst = 0.0
        for got, want in zip(ss_kernel.ssd_scan_kernel(*args),
                             ssd_scan_chunked_ref(*args)):
            tol = 2e-4 * want.abs() + 2e-4 * want.abs().max()
            worst = max(worst, ((got - want).abs() / tol).max().item())
        out.append(worst)
    return out


@pytest.mark.parametrize("fault", sorted(SSD_FAULTS))
def test_ssm_tolerance_sees_planted_faults(cuda, fault, tmp_path,
                                           monkeypatch):
    """Each fault, built from a copy of ``csrc`` in a temporary directory,
    reads above 1 at both shapes; the sound kernel reads below 1 there."""
    from repro_torch.kernels import _build
    csrc = _csrc_copy(tmp_path, "ssm_scan", *SSD_FAULTS[fault])
    sound = _ssd_fault_readings(cuda)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    planted = _ssd_fault_readings(cuda)
    print(f"ssm_scan fault {fault}: err_over_tol sound {sound}, "
          f"planted {planted}")
    assert all(r < 1.0 for r in sound)
    assert all(r > 1.0 for r in planted)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "zamba2-1.2b"])
def test_serving_path_runs_the_kernels(cuda, arch):
    from repro_torch.configs import reduced_config
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.ssm_scan import kernel as ss_kernel
    from repro_torch.models import build_model
    from repro_torch.serve import Request, ServeEngine
    cfg = reduced_config(arch).replace(dtype="float32")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 150)), device=cuda)
    params = build_model(cfg).init_params(0, cuda)
    got, _ = build_model(cfg).prefill(params, {"tokens": tokens}, 160)
    want, _ = build_model(cfg, impl="naive").prefill(params,
                                                     {"tokens": tokens}, 160)
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-4 * want.abs().max().item())
    fa_kernel.flash_attention_kernel.launches = 0
    ss_kernel.ssd_scan_kernel.launches = 0
    engine = ServeEngine(cfg, batch_size=2, max_len=64, device=cuda)
    done = engine.serve([Request(rid=i, prompt=np.arange(20 + i) % 97,
                                 max_new_tokens=4) for i in range(3)])
    assert [len(r.output) for r in done] == [4, 4, 4]
    n_attn = (cfg.num_layers if cfg.family == "dense"
              else -(-cfg.num_layers // cfg.shared_attn_every))
    assert fa_kernel.flash_attention_kernel.launches == 2 * n_attn
    assert ss_kernel.ssd_scan_kernel.launches == (
        2 * cfg.num_layers if cfg.family == "hybrid" else 0)


def test_head_dim_256_serves_on_the_card(cuda):
    """gemma-2b at full width (head dim 256, MQA), cut to 2 layers: the
    kernel path against the naive path in f32, then served in bf16 on the
    tensor-core kernel."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.models import build_model
    from repro_torch.serve import Request, ServeEngine
    cfg = get_config("gemma-2b").replace(num_layers=2, dtype="float32")
    assert cfg.head_dim == 256
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(1, 300)), device=cuda)
    params = build_model(cfg).init_params(0, cuda)
    got, _ = build_model(cfg).prefill(params, {"tokens": tokens}, 300)
    want, _ = build_model(cfg, impl="naive").prefill(params,
                                                     {"tokens": tokens}, 300)
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-4 * want.abs().max().item())
    del params
    fa_kernel.reset_counts()
    engine = ServeEngine(cfg.replace(dtype="bfloat16"), batch_size=1,
                         max_len=64, device=cuda)
    done = engine.serve([Request(rid=0, prompt=np.arange(40) % 97,
                                 max_new_tokens=4)])
    assert len(done[0].output) == 4
    assert fa_kernel.flash_attention_kernel.launches == cfg.num_layers
    # bf16 at head dim 256: every prefill on the tensor cores
    assert fa_kernel.flash_attention_kernel.by_kernel == {
        "flash_fwd": 0, "flash_fwd_wgmma": cfg.num_layers}


# (B, S, H, D, Dv): phi-3-vision's head dim 96, deepseek-v2-lite's MLA
# prefill (q/k 192 = 128 + 64 rope, v 128), and ragged lengths of both
OTHER_HEAD_DIMS = [(2, 300, 32, 96, 96), (1, 2048, 32, 96, 96),
                   (2, 300, 16, 192, 128), (1, 2048, 16, 192, 128),
                   (1, 77, 4, 192, 128)]


@pytest.mark.parametrize("b,s,h,d,dv", OTHER_HEAD_DIMS)
def test_flash_attention_other_head_dims_on_the_cuda_core_kernel(
        cuda, b, s, h, d, dv):
    """f32 at head dims 96 and 192 (v 128, taken at its own width) runs
    the CUDA-core kernel, within the JAX package's 2e-5."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    q, k, v = _flash_inputs(cuda, b, s, h, h, d, torch.float32, dv=dv)
    scale = d ** -0.5
    fa_kernel.reset_counts()
    got = fa_ops.flash_attention(q, k, v, scale=scale)
    torch.cuda.synchronize()
    assert got.shape == (b, s, h, dv)
    assert fa_kernel.flash_attention_kernel.by_kernel == {
        "flash_fwd": 1, "flash_fwd_wgmma": 0}
    _check_flash(got, q, k, v, scale=scale)
    assert torch.equal(fa_ops.flash_attention(q, k, v, scale=scale), got)


# (B, S, Hq, Hkv, D, Dv, window, valid_len): the shapes above, gemma-2b's
# head dim 256 with one kv head, and ragged S, a window and valid_len at
# each new head dim
TENSOR_CORE_HEAD_DIMS = [
    (b, s, h, h, d, dv, 0, 0) for b, s, h, d, dv in OTHER_HEAD_DIMS] + [
    (1, 2048, 8, 1, 256, 256, 0, 0), (2, 77, 8, 1, 256, 256, 0, 0),
    (1, 300, 8, 1, 256, 256, 100, 0), (2, 300, 8, 1, 256, 256, 0, 250),
    (1, 300, 16, 16, 192, 128, 64, 0), (2, 300, 16, 16, 192, 128, 0, 129),
    (2, 77, 32, 32, 96, 96, 33, 0), (1, 300, 32, 32, 96, 96, 0, 257)]


@pytest.mark.parametrize("b,s,hq,hkv,d,dv,window,valid_len",
                         TENSOR_CORE_HEAD_DIMS)
def test_flash_attention_other_head_dims_on_the_tensor_cores(
        cuda, b, s, hq, hkv, d, dv, window, valid_len):
    """bf16 at head dims 96, 192 (v 128) and 256 runs flash_fwd_wgmma
    through ``ops`` as the models call it: within ``bf16_tolerance`` of
    the plain version, [B,S,Hq,Dv], the same bits in two calls."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    q, k, v = _flash_inputs(cuda, b, s, hq, hkv, d, dv=dv)
    scale = d ** -0.5
    kw = dict(scale=scale, window=window)
    fa_kernel.reset_counts()
    if valid_len:
        got = fa_kernel.flash_attention_kernel(q, k, v, valid_len=valid_len,
                                               **kw)
        again = fa_kernel.flash_attention_kernel(q, k, v,
                                                 valid_len=valid_len, **kw)
    else:
        got = fa_ops.flash_attention(q, k, v, **kw)
        again = fa_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.shape == (b, s, hq, dv)
    assert fa_kernel.flash_attention_kernel.by_kernel == {
        "flash_fwd": 0, "flash_fwd_wgmma": 2}
    _check_flash(got, q, k, v, valid_len=valid_len, **kw)
    assert torch.equal(got, again)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "deepseek-v2-lite-16b",
                                  "phi-3-vision-4.2b"])
def test_moe_mla_vlm_prefill_runs_the_kernel(cuda, arch):
    """The reduced MoE, MLA and VLM models in f32: the kernel path against
    the naive path, one flash launch a layer."""
    from repro_torch.configs import reduced_config
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.models import build_model
    cfg = reduced_config(arch).replace(dtype="float32")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 150)), device=cuda)
    params = build_model(cfg).init_params(0, cuda)
    fa_kernel.reset_counts()
    got, _ = build_model(cfg).prefill(params, {"tokens": tokens}, 160)
    assert fa_kernel.flash_attention_kernel.launches == cfg.num_layers
    want, _ = build_model(cfg, impl="naive").prefill(params,
                                                     {"tokens": tokens}, 160)
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-4 * want.abs().max().item())


def test_continuous_engine_on_the_card_matches_static_decoding(cuda):
    """Reduced deepseek-moe-16b in f32 served by ``ContinuousBatchEngine``
    on the card: one batch-1 prefill (a flash launch a layer) and one
    ``decide_split`` launch per admission, and the greedy tokens of
    ``ServeEngine(batch_size=1)``."""
    from repro_torch.configs import reduced_config
    from repro_torch.core.costs import AnalyticCost
    from repro_torch.kernels.decide_split import kernel as ds_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.serve import ContinuousBatchEngine, Request, ServeEngine
    cfg = reduced_config("deepseek-moe-16b").replace(dtype="float32")
    rng = np.random.default_rng(3)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=n,
                                               dtype=np.int32),
                    max_new_tokens=5, arrived_at=i * 0.004)
            for i, n in enumerate((9, 33, 17, 5, 21))]
    eng = ContinuousBatchEngine(cfg, slots=2, max_len=64, seed=1,
                                cost=AnalyticCost(), device=cuda)
    fa_kernel.reset_counts()
    ds_kernel.decide_split_kernel.launches = 0
    done = eng.serve(reqs)
    assert eng.replans == ds_kernel.decide_split_kernel.launches == 5
    assert fa_kernel.flash_attention_kernel.launches == 5 * cfg.num_layers
    assert eng.occupancy > 1.0
    ref = ServeEngine(cfg, batch_size=1, max_len=64, device=cuda)
    ref.load_params(eng.params)
    for r in done:
        np.testing.assert_array_equal(
            r.output, ref.generate_batch(r.prompt[None], 5)[0])


# (M, K, N): qwen3-1.7b's five timed products (decode B 1 and B 4, the
# down projection, the LM head, prefill), the JAX package's ragged
# INT8_CASES, empty M, N, K, and bf16 shapes on w8a16_wgmma: ragged M, K
# and N tiles, a prefill's down projection (K 6144), a shorter prefill
INT8_GPU_CASES = [(1, 2048, 6144), (4, 2048, 6144), (4, 6144, 2048),
                  (4, 2048, 151936), (8192, 2048, 6144),
                  (8, 32, 16), (64, 128, 256), (33, 70, 90), (16, 64, 64),
                  (0, 64, 32), (8, 64, 0), (8, 0, 32),
                  (1000, 2056, 6160), (2048, 2048, 6144), (8192, 6144, 2048)]
# the bf16 shapes above that take w8a16_wgmma
INT8_WGMMA_CASES = [(1000, 2056, 6160), (2048, 2048, 6144),
                    (8192, 6144, 2048), (8192, 2048, 6144)]


def _int8_inputs(cuda, m, k, n, dtype, seed=0):
    """Seeded unit-scale x and a quantised weight."""
    from repro_torch.kernels.int8_matmul.ref import quantize
    gen = torch.Generator(device=cuda).manual_seed(seed + m + n)
    x = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
    w_q, scale = (quantize(torch.randn((k, n), generator=gen, device=cuda))
                  if k else (torch.zeros((0, n), dtype=torch.int8,
                                         device=cuda),
                             torch.ones(n, device=cuda)))
    return x, w_q, scale


def _int8_reading(cuda, m, k, n, dtype, seed=0, route=None):
    """The kernel's largest error over ``int8_tolerance`` on seeded
    unit-scale inputs, and the kernel that ran (None: none did)."""
    from repro_torch.kernels.int8_matmul import kernel as q_kernel
    from repro_torch.kernels.int8_matmul.ref import int8_tolerance
    x, w_q, scale = _int8_inputs(cuda, m, k, n, dtype, seed)
    q_kernel.reset_counts()
    got = q_kernel.int8_matmul_kernel(x, w_q, scale, route=route)
    torch.cuda.synchronize()
    assert got.shape == (m, n) and got.dtype == dtype
    ran = [r for r, c in q_kernel.int8_matmul_kernel.by_route.items() if c]
    want, tol = int8_tolerance(x, w_q, scale)
    if got.numel() == 0:
        return 0.0, None
    # (K = 0 launches nothing: the output is zeros)
    return (((got.float() - want).abs() / tol.clamp_min(1e-30)).max().item(),
            ran[0] if ran else None)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", INT8_GPU_CASES)
def test_int8_matmul_kernel_matches_plain(cuda, m, k, n, dtype):
    from repro_torch.kernels.int8_matmul.kernel import choose_route
    torch.backends.cuda.matmul.allow_tf32 = False    # the plain f32 product
    over, ran = _int8_reading(cuda, m, k, n, dtype)
    print(f"int8_matmul {m}x{k}x{n} {dtype}: err_over_tol {over} ({ran})")
    assert over < 1.0
    if m * n * k:
        # contiguous tensors from the caching allocator: aligned bases
        assert ran == choose_route(dtype, m, k, n)


@pytest.mark.parametrize("m,k,n", INT8_WGMMA_CASES)
def test_int8_wgmma_route_is_exact_to_tolerance_and_deterministic(cuda, m, k,
                                                                  n):
    """The bf16 prefill kernel at ragged and full-width shapes: within
    ``int8_tolerance``, and two calls give the same bits (a wrong parity on
    the TMA ring would show as a difference)."""
    from repro_torch.kernels.int8_matmul import kernel as q_kernel
    from repro_torch.kernels.int8_matmul.ref import int8_tolerance
    x, w_q, scale = _int8_inputs(cuda, m, k, n, torch.bfloat16)
    q_kernel.reset_counts()
    first = q_kernel.int8_matmul_kernel(x, w_q, scale)
    for _ in range(2):
        assert torch.equal(q_kernel.int8_matmul_kernel(x, w_q, scale), first)
    assert q_kernel.int8_matmul_kernel.by_route["w8a16_wgmma"] == 3
    want, tol = int8_tolerance(x, w_q, scale)
    over = ((first.float() - want).abs() / tol).max().item()
    print(f"int8_matmul wgmma {m}x{k}x{n}: err_over_tol {over}")
    assert over < 1.0


@pytest.mark.parametrize("k,n", [(2048, 6144), (2056, 6160), (64, 16),
                                 (70, 32), (1, 128)])
def test_int8_pack_kernel_matches_plain(cuda, k, n):
    """The weight in fragment order: the kernel's first pass against
    ``ref.pack_fragments``, byte for byte."""
    from repro_torch.kernels.int8_matmul.kernel import pack_fragments_kernel
    from repro_torch.kernels.int8_matmul.ref import pack_fragments
    w = torch.as_tensor(np.random.default_rng(k + n).integers(
        -127, 128, (k, n)), dtype=torch.int8)
    assert torch.equal(pack_fragments_kernel(w.to(cuda)).cpu(),
                       pack_fragments(w))


def test_int8_wgmma_route_refuses_what_tma_cannot_take(cuda):
    """Forced onto w8a16_wgmma, a call whose rows TMA cannot read raises:
    no kernel quietly takes over."""
    from repro_torch.kernels.int8_matmul import kernel as q_kernel
    for m, k, n in ((64, 70, 256), (64, 128, 90)):
        x, w_q, scale = _int8_inputs(cuda, m, k, n, torch.bfloat16)
        with pytest.raises(RuntimeError, match="w8a16_wgmma"):
            q_kernel.int8_matmul_kernel(x, w_q, scale, route="w8a16_wgmma")
    x, w_q, scale = _int8_inputs(cuda, 64, 128, 256, torch.float32)
    with pytest.raises(RuntimeError, match="w8a16_wgmma"):
        q_kernel.int8_matmul_kernel(x, w_q, scale, route="w8a16_wgmma")


def test_int8_matmul_ops_flattens_and_runs_the_kernel(cuda):
    from repro_torch.kernels.int8_matmul import kernel as q_kernel
    from repro_torch.kernels.int8_matmul.ops import int8_matmul
    from repro_torch.kernels.int8_matmul.ref import int8_tolerance, quantize
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((3, 40, 2), generator=gen, device=cuda,
                    dtype=torch.bfloat16).transpose(1, 2)   # not contiguous
    w_q, scale = quantize(torch.randn((40, 24), generator=gen, device=cuda))
    q_kernel.int8_matmul_kernel.launches = 0
    got = int8_matmul(x, w_q, scale)
    assert got.shape == (3, 2, 24)
    assert q_kernel.int8_matmul_kernel.launches == 1
    want, tol = int8_tolerance(x.reshape(-1, 40), w_q, scale)
    assert ((got.reshape(-1, 24).float() - want).abs() <= tol).all()


# faults planted in a copy of the source, each read where its code runs:
# in w8a16_mma and w8a16_f32 (at the ragged (33, 70, 90), both types), one
# column's scale taken from its neighbour at every 8-column tile edge and
# the ragged last K tile dropped; in w8a16_wgmma (bf16 at the ragged
# (1000, 2056, 6160)), the same two in its own epilogue and launcher
INT8_SPLIT_K_READS = [(33, 70, 90, torch.bfloat16, "w8a16_mma"),
                      (33, 70, 90, torch.float32, "w8a16_f32")]
INT8_WGMMA_READS = [(1000, 2056, 6160, torch.bfloat16, "w8a16_wgmma")]
INT8_FAULTS = {
    "scale_off_by_one": ("  return acc * scale[n];",
                         "  return acc * scale[n ^ ((n & 7) == 7)];",
                         INT8_SPLIT_K_READS),
    "ragged_k_tile_dropped": (
        "inline int k_tiles(int k, int bk) { return cdiv(k, bk); }",
        "inline int k_tiles(int k, int bk) { return k / bk; }",
        INT8_SPLIT_K_READS),
    "wgmma_scale_off_by_one": (
        "  const float sc[2] = {nc < N ? scale[nc] : 0.f,",
        "  const float sc[2] = {nc < N ? scale[nc ^ ((nc & 7) == 7)] : 0.f,",
        INT8_WGMMA_READS),
    "wgmma_ragged_k_tile_dropped": (
        "  const int nk = cdiv(k, TK);  // a ragged last K tile loads as zeros",
        "  const int nk = k / TK;  // a ragged last K tile loads as zeros",
        INT8_WGMMA_READS),
}


def _csrc_copy(tmp_path, name: str, old: str, new: str) -> Path:
    """``csrc`` (sources and headers) copied into ``tmp_path`` with ``old``
    replaced by ``new`` in ``<name>.cu``, where it occurs once."""
    from repro_torch.kernels import _build
    dst = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, dst)
    src = (dst / f"{name}.cu").read_text()
    assert src.count(old) == 1
    (dst / f"{name}.cu").write_text(src.replace(old, new))
    return dst


@pytest.mark.parametrize("fault", sorted(INT8_FAULTS))
def test_int8_tolerance_sees_planted_faults(cuda, fault, tmp_path,
                                            monkeypatch):
    """Each fault, built from a copy of ``csrc`` in a temporary directory,
    reads above 1 on the kernels whose code it is in; the sound kernels
    read below 1 there."""
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    old, new, reads = INT8_FAULTS[fault]
    csrc = _csrc_copy(tmp_path, "int8_matmul", old, new)

    def readings():
        out = {}
        for m, k, n, dt, route in reads:
            out[route], ran = _int8_reading(cuda, m, k, n, dt)
            assert ran == route
        return out

    sound = readings()
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    planted = readings()
    print(f"int8_matmul fault {fault}: err_over_tol sound {sound}, "
          f"planted {planted}")
    assert all(v < 1.0 for v in sound.values())
    assert all(v > 1.0 for v in planted.values())


# --------------------------------------------------------------------------
# The profiling loop on the card
# --------------------------------------------------------------------------
def test_profiler_runs_in_true_f32_and_restores_tf32(cuda, monkeypatch):
    """Inside the run both TF32 flags are off; after it each is back."""
    from repro_torch.core import profiler as pprof
    from repro_torch.core.workloads import WorkloadConfig
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = [f.allow_tf32 for f in flags]
    seen = []
    loss_fn = pprof.workload_loss

    def spy(model, batch):
        seen.append([f.allow_tf32 for f in flags])
        return loss_fn(model, batch)

    monkeypatch.setattr(pprof, "workload_loss", spy)
    try:
        for f in flags:
            f.allow_tf32 = True
        rec = pprof.profile_workload(
            WorkloadConfig("cnn", 1, 5, "adam", 1e-3, 32, dataset_size=128),
            max_steps=2)
        assert [f.allow_tf32 for f in flags] == [True, True]
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v
    assert seen and all(s == [False, False] for s in seen)
    assert rec.peak_bytes > 0 and rec.step_time_s > 0


@pytest.mark.parametrize("kind,ti", [(k, i) for k in ("mlp", "cnn")
                                     for i in range(3)])
def test_profile_on_the_card_counts_as_the_cpu(cuda, kind, ti):
    """FlopCounterMode counts by formula: the card's FLOPs and parameter
    count equal the CPU profile's of the same config."""
    from repro_torch.core.profiler import profile_workload
    from repro_torch.core.workloads import WorkloadConfig
    wc = WorkloadConfig(kind, ti, 5, "rmsprop", 1e-3, 64, dataset_size=256)
    card = profile_workload(wc, max_steps=3)
    host = profile_workload(wc, max_steps=1, device="cpu")
    assert card.flops_per_step == host.flops_per_step
    assert card.param_count == host.param_count
    assert np.isfinite(card.final_loss) and card.peak_bytes > 0


def test_profiling_dataset_gbt_fit_on_the_card_equals_the_cpu_fit(cuda):
    """A MultiTargetGBT on a profiling dataset measured on the card grows
    the same node arrays on the card as on the CPU."""
    from repro_torch.core.dataset import generate
    from repro_torch.core.predictors.gbt import MultiTargetGBT
    records, data = generate(n_runs=12, max_steps=2)
    norm, _ = data.normalised()
    kw = dict(n_trees=30, max_depth=12, subsample=0.8)
    on_card = MultiTargetGBT(**kw).fit(norm.x, norm.y)
    on_host = MultiTargetGBT(**kw).fit(norm.x, norm.y, device="cpu")
    for a, b in zip(on_card.models_, on_host.models_):
        fa, fb = tp_ref.flatten_gbt(a), tp_ref.flatten_gbt(b)
        for f in ("feature", "threshold_bin", "left", "right", "value",
                  "n_nodes", "edges"):
            assert np.array_equal(getattr(fa, f), getattr(fb, f)), f
    assert torch.equal(on_card.predict(norm.x).cpu(),
                       on_host.predict(norm.x, device="cpu"))


def test_mlp_fit_on_the_card_agrees_with_the_cpu(cuda):
    """Two epochs from the same initial weights on the same batches: the
    card's predictions within 1e-4 of the CPU's (relative to the target
    scale; cuBLAS and the CPU sum the products in other orders)."""
    from repro_torch.core.predictors.mlp import MLPRegressor
    rng = np.random.default_rng(0)
    x = rng.normal(size=(600, 20)).astype(np.float32)
    y = np.stack([np.sin(x[:, 0]) + x[:, 1], x[:, 2] * x[:, 3],
                  np.abs(x[:, 4])], axis=1).astype(np.float32)
    kw = dict(hidden=(256, 128), epochs=2, lr=1e-3)
    card = MLPRegressor(**kw).fit(x, y).predict(x).cpu().numpy()
    host = MLPRegressor(**kw).fit(x, y, device="cpu").predict(
        x, device="cpu").numpy()
    assert np.abs(card - host).max() <= 1e-4 * np.abs(host).max()


def _oracle_case(seed: int = 19):
    """A GBT on per-layer rows of the five edge specs, and a feature
    stream of those specs with the 12 W and 15 W ones 3x slower from step
    200 (``examples/oracle_serving.py``'s step 3)."""
    specs = list(EDGE_DEVICES.values())
    rng = np.random.default_rng(seed)
    layers = [off.LayerCost(f"l{i}", flops=float(f), act_bytes=0.0)
              for i, f in enumerate(rng.uniform(1e8, 1e11, 48))]
    from repro_torch.core.costs import default_layer_features
    x = np.concatenate([default_layer_features(layers, s) for s in specs])
    y = np.concatenate([[off.layer_time(lc.flops, s) for lc in layers]
                        for s in specs])
    stream = []
    for step in range(500):
        spec = specs[int(rng.integers(len(specs)))]
        flops = float(rng.uniform(1e8, 1e11))
        t = off.layer_time(flops, spec)
        if step >= 200 and spec.tdp_watts in (12, 15):
            t *= 3.0
        stream.append((default_layer_features(
            [off.LayerCost("q", flops=flops, act_bytes=0.0)], spec)[0], t))
    return x, y, stream


def test_oracle_refit_on_the_card_grows_the_cpu_refit(cuda):
    """The drift loop on the card and on the CPU: the same drift steps,
    refit versions and nRMSE track, and refits equal node for node."""
    from repro_torch.oracle import OnlineOracle
    x, y, stream = _oracle_case()
    runs = []
    for dev in (cuda, "cpu"):
        gbt = GBTRegressor(n_trees=30, max_depth=5).fit(x, y, device=dev)
        o = OnlineOracle(gbt, get_device("pi5-arm"),
                         get_device("edge-server-a100"), window=256,
                         min_refit=120, correction="none", torch_device=dev)
        outs = [o.observe(f, t) for f, t in stream]
        runs.append((o, [(d["drift"], d["refit_version"]) for d in outs]))
    (card, a), (host, b) = runs
    assert a == b and card.refits >= 1
    assert card.rolling_nrmse() == host.rolling_nrmse()
    fa, fb = tp_ref.flatten_gbt(card.model), tp_ref.flatten_gbt(host.model)
    for f in ("feature", "threshold_bin", "left", "right", "value",
              "n_nodes", "edges"):
        assert np.array_equal(getattr(fa, f), getattr(fb, f)), f


def test_static_stream_on_the_card_equals_the_cpu_run(cuda):
    """bench_stream's largest cell (300 tasks, 32 nodes, Poisson 200/s)
    with a PredictorCost and with an oracle: the card's records equal the
    CPU's, and the oracle stays transparent."""
    from repro_torch import sim
    from repro_torch.core import costs as co
    from repro_torch.core import scheduler as sch
    from repro_torch.oracle import OnlineOracle
    x, y, _ = _oracle_case()
    specs = list(EDGE_DEVICES.values())
    rng = np.random.default_rng(232)
    tasks = [sch.Task(f"t{i}", flops=float(rng.uniform(1e9, 5e11)),
                      input_bytes=float(rng.uniform(1e4, 1e7)))
             for i in range(300)]
    arrivals = sim.poisson_arrivals(200.0, n=300, seed=1432)
    nodes = [sch.Node(specs[j % len(specs)]) for j in range(32)]
    pi5, a100 = get_device("pi5-arm"), get_device("edge-server-a100")
    recs = {}
    for dev in (cuda, "cpu"):
        gbt = GBTRegressor(n_trees=30, max_depth=5).fit(x, y, device=dev)
        plain = sim.simulate_stream(tasks, arrivals, nodes,
                                    cost=co.PredictorCost(gbt, pi5, a100),
                                    device=dev)
        o = OnlineOracle(gbt, pi5, a100, torch_device=dev)
        riding = sim.simulate_stream(tasks, arrivals, nodes, oracle=o,
                                     device=dev)
        recs[str(dev)] = [[(r.node_id, r.started_s, r.finished_s)
                           for r in t.records] for t in (plain, riding)]
        assert recs[str(dev)][0] == recs[str(dev)][1]
        assert o.refits == 0 and o.gain == 1.0
    assert recs["cuda"] == recs["cpu"]


def test_oracle_cost_kernel_sweep_with_gain_is_near_optimal(cuda):
    """After a uniform 2x slowdown has moved the gain, the decide_split
    sweep over the oracle's cost (the correction lowered into the layer
    times) is within 1e-4 of the exact f64 sweep."""
    from repro_torch.oracle import OnlineOracle
    x, y, _ = _oracle_case()
    pi5, a100 = get_device("pi5-arm"), get_device("edge-server-a100")
    gbt = GBTRegressor(n_trees=30, max_depth=5).fit(x, y, device=cuda)
    o = OnlineOracle(gbt, pi5, a100, refit_on_drift=False,
                     torch_device=cuda)
    feats = x[:40]
    for i in range(120):
        f = feats[i % len(feats)]
        o.observe(f, realised_s=2.0 * o.predict_one(f) / o.gain)
    assert abs(o.gain - 2.0) < 0.15
    rng = np.random.default_rng(3)
    layers = [off.LayerCost(f"l{i}", flops=float(rng.uniform(1e8, 1e9)),
                            act_bytes=float(rng.uniform(1e3, 1e5)))
              for i in range(48)]
    envs = dec.make_envs(pi5, a100, link_bw=np.geomspace(1e4, 1e10, 4096),
                         input_bytes=1e7, device=cuda)
    cost = o.cost_model()
    fast = dec.decide_all(layers, envs, cost=cost, device=cuda)
    exact = dec.decide_all(layers, envs, cost=cost, backend="torch",
                           device=cuda)
    assert bool((fast.total_time_s <= exact.total_time_s * (1 + 1e-4)
                 + 1e-12).all())
    assert cost.accel_spec().lowered.correction == (o.gain, 0.0)


# --------------------------------------------------------------------------
# the fleet engine's singleton scan, and the contention stack's sweep
# --------------------------------------------------------------------------
def _scan_case(n_nodes, n, k, seed, ties):
    rng = np.random.default_rng(seed)
    peak = rng.uniform(1e10, 1e13, n_nodes)
    rows = rng.uniform(1e5, 1e8, (k, n_nodes))
    avail = rng.uniform(0, 2, n_nodes)
    if ties:                             # identical nodes: first index wins
        peak[:], rows[:], avail[:] = 1e12, 1e7, 0.0
    ts = np.sort(rng.uniform(0, 10, n))
    fls, ibs = rng.uniform(1e9, 5e11, n), rng.uniform(1e4, 1e7, n)
    segs = np.sort(rng.integers(0, k, n)).astype(np.int64)
    return [torch.as_tensor(a) for a in (avail, peak, rows, ts, fls, ibs,
                                         segs)]


# (nodes, route): both routes up to 256 nodes (1 to 8 a lane on the
# registers route, each count of slots, full and not), the shared route past
# it, up to MAX_NODES
FLEET_SCAN_CASES = [(n, route) for n in (1, 2, 31, 32, 33, 65, 96, 100, 128,
                                         160, 200, 224, 255, 256)
                    for route in ("registers", "shared")] + [
    (n, "shared") for n in (257, 300, 1000, 9684)]


@pytest.mark.parametrize("n_nodes,route", FLEET_SCAN_CASES)
@pytest.mark.parametrize("ties", [False, True])
def test_fleet_scan_kernel_matches_plain_bit_for_bit(cuda, n_nodes, route,
                                                     ties):
    """One block places every task, its etc rows a chunk ahead (up to 64
    steps a chunk, one at MAX_NODES): j, start, finish, etc and
    the final avail equal to the plain version on a CPU copy, bit for bit
    (IEEE f64 divisions and additions, first index on ties), on the route
    named, which ``choose_route`` gives where it takes the shape."""
    from repro_torch.kernels.fleet_scan import kernel as fs_kernel
    from repro_torch.kernels.fleet_scan import ref as fs_ref
    cpu = _scan_case(n_nodes, 900, 7, n_nodes, ties)
    gpu = [x.to(cuda) for x in cpu]
    want = fs_ref.place_singletons_ref(*cpu)
    fs_kernel.reset_counts()
    got = fs_kernel.place_singletons_kernel(*gpu, route=route)
    torch.cuda.synchronize()
    assert fs_kernel.place_singletons_kernel.by_route == {
        r: int(r == route) for r in fs_kernel.ROUTES}
    assert fs_kernel.choose_route(n_nodes) == (
        "registers" if n_nodes <= 256 else "shared")
    for w, g in zip(want, got):
        assert torch.equal(w, g.cpu())
    assert torch.equal(cpu[0], gpu[0].cpu())
    if ties:
        assert int(got[0][0]) == 0


def test_fleet_scan_refuses_a_route_that_cannot_take_the_shape(cuda):
    from repro_torch.kernels.fleet_scan import kernel as fs_kernel
    gpu = [x.to(cuda) for x in _scan_case(300, 10, 2, 0, False)]
    fs_kernel.reset_counts()
    with pytest.raises(ValueError, match="at most 256"):
        fs_kernel.place_singletons_kernel(*gpu, route="registers")
    with pytest.raises(ValueError, match="route"):
        fs_kernel.place_singletons_kernel(*gpu, route="warp")
    assert fs_kernel.place_singletons_kernel.launches == 0


def test_fleet_engine_on_the_card_equals_the_cpu(cuda):
    """A diurnal day of 3,000 tasks on 24 nodes: one singleton run through
    fleet_scan on the card, the plain version on the CPU; the same
    records, summary and counters."""
    from repro_torch import sim
    from repro_torch.core import scheduler as sch
    from repro_torch.kernels.fleet_scan import kernel as fs_kernel
    specs = list(EDGE_DEVICES.values())
    arr = sim.diurnal_arrivals(3000 / 600.0 * 1.2, horizon=600.0,
                               amplitude=0.6, period_s=300.0, seed=1)[:3000]
    rng = np.random.default_rng(0)
    tasks = [sch.Task(f"t{i}", flops=float(rng.uniform(1e9, 5e11)),
                      input_bytes=float(rng.uniform(1e4, 1e7)))
             for i in range(len(arr))]
    out = []
    for dev in (cuda, torch.device("cpu")):
        links = sim.ClusterLinks([sim.DiurnalLink(
            4e7, amplitude=0.5, period_s=300.0, noise_sigma=0.1, seed=2 + j)
            for j in range(24)])
        before = fs_kernel.place_singletons_kernel.launches
        tel = sim.simulate_stream(tasks, arr, [sch.Node(specs[j % 5])
                                               for j in range(24)],
                                  links=links, engine="fleet", device=dev)
        if dev.type == "cuda":
            assert fs_kernel.place_singletons_kernel.launches > before
        out.append(([dataclasses.astuple(r) for r in tel.records],
                    tel.summary(), dict(tel.counters)))
    assert out[0] == out[1]


@pytest.mark.parametrize("tail", [None, "p99", "cvar"])
def test_decide_split_with_live_pool_wait_and_rtt_tail_is_near_optimal(
        cuda, tail):
    """QueueAwareCost over CompositeCost(tail=...): the live ServerPool
    wait and the WeibullRTT tail excess lowered into the kernel, every
    split within 1e-4 of the exact f64 sweep's scalar cost."""
    from repro_torch.core import costs as co
    from repro_torch.sim import queueing as q
    rtt = q.WeibullRTT(shape=0.6, scale=0.02, seed=0)
    base = co.CompositeCost(
        weights={"latency_s": 1.0} if tail is None
        else {"tail_latency_s": 1.0},
        tail=tail, rtt=None if tail is None else rtt, tail_alpha=0.99)
    pool = q.ServerPool(2)
    pool.admit(0.0, 0.08)
    pool.admit(0.0, 0.05)
    cost = co.QueueAwareCost(base=base, edge_pool=pool, rtt=rtt)
    rng = np.random.default_rng(3)
    layers = [off.LayerCost(f"l{i}", flops=float(rng.uniform(2e10, 4.5e10)),
                            act_bytes=float(rng.uniform(2e5, 4e6)))
              for i in range(8)]
    jetson, a100 = get_device("jetson-orin-nano"), \
        get_device("edge-server-a100")
    for now in (0.0, 0.03, 0.2):
        cost.set_now(now)
        spec = cost.accel_spec()
        assert spec.queue_wait_s == pytest.approx(pool.wait(now)
                                                  + rtt.mean())
        envs = dec.make_envs(jetson, a100,
                             link_bw=np.geomspace(1e6, 1e9, 2048),
                             input_bytes=2e6, device=cuda)
        fast = dec.decide_all(layers, envs, cost=cost, device=cuda)
        exact = dec.decide_all(layers, envs, cost=cost, backend="torch",
                               device=cuda)
        assert bool((fast.scalar_cost <= exact.scalar_cost * (1 + 1e-4)
                     + 1e-12).all())


# --------------------------------------------------------------------------
# The sLSTM recurrence and whisper's attention shapes
# --------------------------------------------------------------------------
# (B, S, H, du, dtype of R and h): B 1, 2 and 4, S 1, 7 and 2048
# (xlstm-350m's prefill at its width, H 4 and du 256), head counts other
# than 4, B past one group of 4 rows, and unit counts that are not powers
# of two; each on every route that takes it (the block route up to du 256,
# the cluster route where ``cluster_fits``)
SLSTM_SHAPES = [
    (b, s, 4, 256, dtype) for b in (1, 2, 4) for s in (1, 7, 2048)
    for dtype in (torch.float32, torch.bfloat16)] + [
    (2, 300, 8, 32, torch.float32), (3, 65, 2, 128, torch.bfloat16),
    (5, 33, 3, 24, torch.float32), (2, 40, 2, 30, torch.float32),
    (1, 9, 3, 6, torch.bfloat16), (8, 50, 2, 256, torch.float32),
    (6, 20, 2, 64, torch.bfloat16), (9, 20, 2, 256, torch.bfloat16)]


def _slstm_routes(b, du, dtype):
    from repro_torch.kernels.slstm_scan import kernel as sl_kernel
    routes = ["block"] if du <= sl_kernel.MAX_UNITS else []
    if sl_kernel.cluster_fits(b, du, dtype):
        routes.insert(0, "cluster")
    return routes


SLSTM_GPU_CASES = [(*shape, route) for shape in SLSTM_SHAPES
                   for route in _slstm_routes(shape[0], shape[3], shape[4])]


def _slstm_inputs(cuda, b, s, h, du, dtype, seed=0):
    """pre [4, B, S, d] of unit scale and R [4, H, du, du] at the model's
    init scale (std du^-1/2, as ``init_dense`` draws it)."""
    gen = torch.Generator(device=cuda).manual_seed(seed + s + du)
    pre = torch.randn((4, b, s, h * du), generator=gen, device=cuda)
    r = torch.randn((4, h, du, du), generator=gen, device=cuda) * du ** -0.5
    return pre, r.to(dtype)


@pytest.mark.parametrize("b,s,h,du,dtype,route", SLSTM_GPU_CASES)
def test_slstm_scan_kernel_matches_plain(cuda, b, s, h, du, dtype, route):
    """f32: h and the final (c, n, h, m) within 1e-4 absolute of the plain
    step loop (|h| <= 1, since |c| <= n); bf16 (R and h): the f32 state as
    in f32, and h within one bf16 ulp of |h| (2^-7 |h| bounds it) plus
    1e-4, as both round the same f32 h to bf16.  On the route named; the
    same bits in a second call."""
    from repro_torch.kernels.slstm_scan import kernel as sl_kernel
    from repro_torch.kernels.slstm_scan import ref as sl_ref
    pre, r = _slstm_inputs(cuda, b, s, h, du, dtype)
    sl_kernel.reset_counts()
    got, st = sl_kernel.slstm_scan_kernel(pre, r, out_dtype=dtype,
                                          route=route)
    torch.cuda.synchronize()
    assert sl_kernel.slstm_scan_kernel.launches == 1
    assert sl_kernel.slstm_scan_kernel.by_route[route] == 1
    want, st_want = sl_ref.slstm_scan_ref(pre, r, out_dtype=dtype)
    assert got.dtype == dtype and got.shape == (b, s, h * du)
    tol = 1e-4 + (want.float().abs() * 2.0 ** -7 if dtype == torch.bfloat16
                  else 0.0)
    assert bool(((got.float() - want.float()).abs() <= tol).all()), \
        (got.float() - want.float()).abs().max().item()
    for name, g, w in zip("cnhm", st, st_want):
        assert g.dtype == torch.float32
        err = (g - w).abs().max().item()
        assert err <= 1e-4, (name, err)
    # the same bits in a second call
    again, st2 = sl_kernel.slstm_scan_kernel(pre, r, out_dtype=dtype,
                                             route=route)
    assert torch.equal(got, again)
    assert all(torch.equal(a, c) for a, c in zip(st, st2))


def _slstm_held_to_plain(pre, r, dtype, got, st):
    """The tolerances of ``test_slstm_scan_kernel_matches_plain``."""
    from repro_torch.kernels.slstm_scan import ref as sl_ref
    want, st_want = sl_ref.slstm_scan_ref(pre, r, out_dtype=dtype)
    tol = 1e-4 + (want.float().abs() * 2.0 ** -7 if dtype == torch.bfloat16
                  else 0.0)
    assert bool(((got.float() - want.float()).abs() <= tol).all())
    for g, w in zip(st, st_want):
        assert (g - w).abs().max().item() <= 1e-4


# (B, H, du) the cluster route takes off xlstm-350m's shape: one to two
# blocks of four rows, 32 to 512 threads a CTA, du from 32 to 256 with
# 4 to 32 units a CTA
SLSTM_CLUSTER_SHAPES = [(3, 2, 128), (1, 1, 32), (4, 2, 64), (5, 2, 64),
                        (7, 1, 256), (8, 1, 128), (2, 3, 96), (1, 2, 160),
                        (6, 2, 192)]


@pytest.mark.parametrize("b,h,du", SLSTM_CLUSTER_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slstm_scan_cluster_route_matches_plain(cuda, b, h, du, dtype):
    """The cluster route's one plan (8 CTAs a head, 8 lanes a unit's sums)
    at shapes other than the served one, within the tolerances of
    ``test_slstm_scan_kernel_matches_plain``, and the same bits twice."""
    from repro_torch.kernels.slstm_scan import kernel as sl_kernel
    pre, r = _slstm_inputs(cuda, b, 37, h, du, dtype)
    assert sl_kernel.choose_route(b, du, dtype) == "cluster"
    got, st = sl_kernel.slstm_scan_kernel(pre, r, out_dtype=dtype,
                                          route="cluster")
    again, st2 = sl_kernel.slstm_scan_kernel(pre, r, out_dtype=dtype,
                                             route="cluster")
    torch.cuda.synchronize()
    _slstm_held_to_plain(pre, r, dtype, got, st)
    assert torch.equal(got, again)
    assert all(torch.equal(a, c) for a, c in zip(st, st2))


@pytest.mark.parametrize("b,s,h,du,dtype,route", [
    (5, 33, 3, 24, torch.float32, "block"),
    (2, 40, 2, 30, torch.float32, "block"),
    (9, 20, 2, 256, torch.bfloat16, "block"),
    (3, 65, 2, 128, torch.bfloat16, "cluster"),
    (2, 300, 8, 32, torch.float32, "cluster")])
def test_slstm_scan_ops_takes_the_route_by_shape(cuda, b, s, h, du, dtype,
                                                 route):
    """``ops.slstm_scan`` at edge shapes: one launch, on the route
    ``choose_route`` gives, held to the plain step loop."""
    from repro_torch.kernels.slstm_scan import kernel as sl_kernel
    from repro_torch.kernels.slstm_scan import ops as sl_ops
    pre, r = _slstm_inputs(cuda, b, s, h, du, dtype)
    sl_kernel.reset_counts()
    got, st = sl_ops.slstm_scan(pre, r, out_dtype=dtype)
    torch.cuda.synchronize()
    assert sl_kernel.slstm_scan_kernel.by_route == {
        k: int(k == route) for k in sl_kernel.ROUTES}
    _slstm_held_to_plain(pre, r, dtype, got, st)


@pytest.mark.parametrize("b", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_slstm_scan_served_shape_takes_the_cluster_route(cuda, b, dtype):
    """xlstm-350m's width (H 4, du 256) through ``ops``: one launch, on
    the cluster route, at every batch the engine serves."""
    from repro_torch.kernels.slstm_scan import kernel as sl_kernel
    from repro_torch.kernels.slstm_scan import ops as sl_ops
    pre, r = _slstm_inputs(cuda, b, 16, 4, 256, dtype)
    sl_kernel.reset_counts()
    sl_ops.slstm_scan(pre, r, out_dtype=dtype)
    torch.cuda.synchronize()
    assert sl_kernel.slstm_scan_kernel.by_route == {"cluster": 1,
                                                    "block": 0}


def test_slstm_scan_kernel_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels.slstm_scan import kernel as sl_kernel
    pre, r = _slstm_inputs(cuda, 2, 5, 4, 16, torch.float32)
    sl_kernel.slstm_scan_kernel.launches = 0
    with pytest.raises(ValueError, match="CUDA"):
        sl_kernel.slstm_scan_kernel(pre.cpu(), r.cpu())
    with pytest.raises(ValueError, match="H du"):
        sl_kernel.slstm_scan_kernel(pre, r[:, :3].contiguous())
    with pytest.raises(ValueError, match="expected pre"):
        sl_kernel.slstm_scan_kernel(pre[:3], r)
    with pytest.raises(TypeError, match="float32"):
        sl_kernel.slstm_scan_kernel(pre.to(torch.bfloat16), r)
    with pytest.raises(ValueError, match="contiguous"):
        sl_kernel.slstm_scan_kernel(pre.transpose(2, 3).contiguous()
                                    .transpose(2, 3), r)
    with pytest.raises(ValueError, match="du"):
        sl_kernel.slstm_scan_kernel(torch.zeros(4, 1, 2, 512, device=cuda),
                                    torch.zeros(4, 1, 512, 512,
                                                device=cuda))
    with pytest.raises(ValueError, match="cluster route"):
        sl_kernel.slstm_scan_kernel(torch.zeros(4, 1, 2, 30, device=cuda),
                                    torch.zeros(4, 1, 30, 30, device=cuda),
                                    route="cluster")
    with pytest.raises(ValueError, match="route"):
        sl_kernel.slstm_scan_kernel(pre, r, route="grid")
    assert sl_kernel.slstm_scan_kernel.launches == 0


# whisper-tiny's flash shapes (B, Sq, Sk, H, D, causal): the encoder over
# 1,500 frames, cross-attention of a 224-token prompt, the decoder's self
# attention, and ragged small ones around the 192-row and 128-key tiles
WHISPER_FLASH_CASES = [(4, 1500, 1500, 6, 64, False),
                       (4, 224, 1500, 6, 64, False),
                       (4, 224, 224, 6, 64, True),
                       (2, 100, 300, 4, 64, False),
                       (1, 193, 129, 6, 64, False)]


@pytest.mark.parametrize("b,sq,sk,h,d,causal", WHISPER_FLASH_CASES)
def test_flash_attention_at_whisper_shapes(cuda, b, sq, sk, h, d, causal):
    """bf16 on flash_fwd_wgmma<64, 64> through ``ops``, within
    ``bf16_tolerance``; f32 on flash_fwd within 2e-5."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    gen = torch.Generator(device=cuda).manual_seed(sq + sk)
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn((b, sq, h, d), generator=gen, device=cuda).to(dtype)
        k, v = (torch.randn((b, sk, h, d), generator=gen, device=cuda)
                .to(dtype) for _ in range(2))
        fa_kernel.reset_counts()
        got = fa_ops.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        wgmma = dtype == torch.bfloat16
        assert fa_kernel.flash_attention_kernel.by_kernel == {
            "flash_fwd": int(not wgmma), "flash_fwd_wgmma": int(wgmma)}
        assert got.shape == (b, sq, h, d)
        _check_flash(got, q, k, v, causal=causal)


@pytest.mark.parametrize("arch", ["xlstm-350m", "whisper-tiny"])
def test_xlstm_and_whisper_run_their_kernels(cuda, arch):
    """Reduced xlstm-350m and whisper-tiny in f32: the kernel path against
    the naive path (one slstm_scan launch a group; one flash launch an
    encoder layer and two a decoder layer), then served in bf16 (whisper
    at its published head dim 64, which the tensor-core kernel takes)."""
    from repro_torch.configs import reduced_config
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.slstm_scan import kernel as sl_kernel
    from repro_torch.models import build_model
    from repro_torch.serve import Request, ServeEngine
    cfg = reduced_config(arch).replace(dtype="float32")
    if cfg.family == "audio":
        cfg = cfg.replace(head_dim=64)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab_size, size=(2, 150)), device=cuda)}
    if cfg.family == "audio":
        batch["frames"] = torch.as_tensor(rng.normal(
            size=(2, cfg.enc_seq, cfg.d_model)), dtype=torch.float32,
            device=cuda)
    params = build_model(cfg).init_params(0, cuda)
    fa_kernel.reset_counts()
    sl_kernel.reset_counts()
    got, _ = build_model(cfg).prefill(params, batch, 160)
    n_flash = (cfg.enc_layers + 2 * cfg.num_layers
               if cfg.family == "audio" else 0)
    n_slstm = (cfg.num_layers // cfg.slstm_every
               if cfg.family == "ssm" else 0)
    assert fa_kernel.flash_attention_kernel.launches == n_flash
    assert sl_kernel.slstm_scan_kernel.launches == n_slstm
    want, _ = build_model(cfg, impl="naive").prefill(params, batch, 160)
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-4 * want.abs().max().item())
    fa_kernel.reset_counts()
    sl_kernel.reset_counts()
    engine = ServeEngine(cfg.replace(dtype="bfloat16"), batch_size=2,
                         max_len=64, device=cuda)
    done = engine.serve([Request(rid=i, prompt=np.arange(20 + i) % 97,
                                 max_new_tokens=4) for i in range(3)])
    assert [len(r.output) for r in done] == [4, 4, 4]
    assert fa_kernel.flash_attention_kernel.by_kernel == {
        "flash_fwd": 0, "flash_fwd_wgmma": 2 * n_flash}
    assert sl_kernel.slstm_scan_kernel.launches == 2 * n_slstm
    assert sl_kernel.slstm_scan_kernel.by_route["block"] == 0


# the log-sum-exp the training forward stores, per (B, Sq, Sk, Hq, Hkv, D,
# Dv, causal, window, valid_len): every served flash_fwd_wgmma instance
# (bf16) and flash_fwd (f32) at ragged S, GQA and MQA, a window, a ragged
# valid_len, Sq != Sk, and rows with no live key (valid_len 100, window
# 16: rows from 116 on see none)
LSE_CASES = [(2, 300, 300, 8, 2, 128, 128, True, 0, 0),
             (2, 257, 257, 4, 4, 64, 64, True, 0, 0),
             (1, 300, 300, 8, 8, 96, 96, True, 0, 0),
             (1, 200, 200, 4, 4, 192, 128, True, 0, 0),
             (1, 200, 200, 8, 1, 256, 256, True, 0, 0),
             (2, 224, 1500, 6, 6, 64, 64, False, 0, 0),
             (1, 257, 257, 4, 2, 128, 128, True, 40, 0),
             (2, 255, 255, 4, 4, 128, 128, False, 0, 129),
             (1, 200, 200, 4, 2, 128, 128, True, 16, 100)]
# f32 sums in another order and exp2 in place of exp: the lse of rows of
# |lse| <= ~10 within 2e-5 absolute plus relative
LSE_TOL = 2e-5


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,dv,causal,window,valid_len",
                         LSE_CASES)
def test_flash_attention_lse_matches_plain(cuda, b, sq, sk, hq, hkv, d, dv,
                                           causal, window, valid_len, dtype):
    """Both kernels store each row's log-sum-exp as ``ref.attention_ref``
    forms it (-1e30 where no key is live), and their output keeps the
    bits of a call without it."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention.ref import attention_ref
    gen = torch.Generator(device=cuda).manual_seed(sq + d)
    q = torch.randn((b, sq, hq, d), generator=gen, device=cuda).to(dtype)
    k = torch.randn((b, sk, hkv, d), generator=gen, device=cuda).to(dtype)
    v = torch.randn((b, sk, hkv, dv), generator=gen, device=cuda).to(dtype)
    kw = dict(causal=causal, window=window, valid_len=valid_len)
    fa_kernel.reset_counts()
    out, lse = fa_kernel.flash_attention_kernel(q, k, v, return_lse=True,
                                                **kw)
    plain_out = fa_kernel.flash_attention_kernel(q, k, v, **kw)
    torch.cuda.synchronize()
    wgmma = dtype == torch.bfloat16
    assert fa_kernel.flash_attention_kernel.by_kernel == {
        "flash_fwd": 2 * int(not wgmma), "flash_fwd_wgmma": 2 * int(wgmma)}
    assert torch.equal(out, plain_out)
    _, want = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), return_lse=True, **kw)
    assert lse.shape == (b, hq, sq) and lse.dtype == torch.float32
    dead = want == -1e30
    assert torch.equal(lse == -1e30, dead)
    torch.testing.assert_close(lse[~dead], want[~dead], rtol=LSE_TOL,
                               atol=LSE_TOL)


# (B, Sq, Sk, Hq, Hkv, D, Dv, causal, window) of the attention backward:
# qwen3's GQA, whisper's non-causal cross-attention, MLA's narrower v, a
# window, a ragged tail
BWD_CASES = [(2, 256, 256, 8, 4, 128, 128, True, 0),
             (2, 100, 300, 6, 6, 64, 64, False, 0),
             (1, 200, 200, 4, 4, 192, 128, True, 0),
             (1, 300, 300, 4, 2, 64, 64, True, 40),
             (2, 77, 77, 4, 1, 96, 96, True, 0)]


@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,dv,causal,window", BWD_CASES)
def test_flash_attention_backward_matches_autograd_of_naive(
        cuda, b, sq, sk, hq, hkv, d, dv, causal, window):
    """f32: ``chunked_attention`` under autograd (``flash_fwd`` with its
    lse, then the plain flash backward) against autograd through
    ``naive_attention``: the output and dq, dk, dv within 1e-5 of each
    one's largest magnitude (TF32 off, f32 sums in other orders)."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.models.attention import (chunked_attention,
                                              naive_attention)
    gen = torch.Generator(device=cuda).manual_seed(sq + d)
    q = torch.randn((b, sq, hq, d), generator=gen, device=cuda)
    k = torch.randn((b, sk, hkv, d), generator=gen, device=cuda)
    v = torch.randn((b, sk, hkv, dv), generator=gen, device=cuda)
    do = torch.randn((b, sq, hq, dv), generator=gen, device=cuda)
    grads = []
    for fn in (chunked_attention, naive_attention):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        fa_kernel.reset_counts()
        out = fn(*leaves, causal=causal, window=window)
        out.backward(do)
        grads.append([out.detach()] + [t.grad for t in leaves])
        if fn is chunked_attention:
            assert fa_kernel.flash_attention_kernel.by_kernel == {
                "flash_fwd": 1, "flash_fwd_wgmma": 0}
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * want.abs().max().item())


def test_bf16_train_step_on_the_card(cuda):
    """One bf16 ``train_loss`` backward and AdamW step of reduced qwen3 at
    its published head dim 128: every flash call (the forward and its
    recompute in the backward) on flash_fwd_wgmma, a finite loss near the
    f32 loss of the same weights, finite gradients on every parameter,
    and a step that lowers the loss on the same batch."""
    from repro_torch.configs import reduced_config
    from repro_torch.data.synthetic import train_batch
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    cfg = reduced_config("qwen3-1.7b").replace(dtype="bfloat16",
                                               head_dim=128)
    api = build_model(cfg)
    params = api.init_params(0, cuda, trainable=True)
    batch = train_batch(cfg, 4, 128, seed=0, device=cuda)
    fa_kernel.reset_counts()
    loss, _ = api.train_loss(params, batch)
    loss.backward()
    assert fa_kernel.flash_attention_kernel.by_kernel == {
        "flash_fwd": 0, "flash_fwd_wgmma": 2 * cfg.num_layers}
    assert torch.isfinite(loss)
    for name, p in params.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
    f32 = build_model(cfg.replace(dtype="float32"))
    p32 = f32.init_params(0, cuda)
    for a, b in zip(p32.parameters(), params.parameters()):
        a.data.copy_(b.detach().float())
    with torch.no_grad():
        loss32, _ = f32.train_loss(p32, batch)
    assert abs(loss.item() - loss32.item()) < 2e-2 * loss32.item()
    opt = AdamW(params.parameters(), 1e-3)
    opt.step()
    with torch.no_grad():
        after, _ = api.train_loss(params, batch)
    assert after.item() < loss.item()


# --------------------------------------------------------------------------
# The scans' backward kernels
# --------------------------------------------------------------------------
# (B, S, H, P, N, chunk) of the SSD backward: one step, a ragged last chunk
# (N != P), B 3 over several chunks at P = N = 64 (the float4 forward), H 1
# over a ragged tail, zamba2's chunk of 128 at B 1 and two chunks at B 5
SSD_BWD_GPU_CASES = [(1, 1, 2, 8, 8, 16), (2, 100, 3, 16, 4, 32),
                     (3, 200, 4, 64, 64, 64), (1, 33, 1, 4, 32, 8),
                     (1, 128, 8, 64, 64, 128), (5, 256, 2, 64, 16, 128)]
# f32 sums in other orders (the head sums of dB and dC over up to 64
# heads): each gradient within SSD_BWD_GPU_TOL of its largest magnitude
SSD_BWD_GPU_TOL = 1e-4


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_BWD_GPU_CASES)
def test_ssm_scan_backward_matches_plain(cuda, b, s, h, p, n, chunk):
    """The forward with its states saved keeps the served call's bits; the
    backward kernels (``ssd_bwd_chain``, ``ssd_bwd_chunk``) against
    ``ssd_scan_chunked_bwd_ref`` with random cotangents on y and the final
    state, and the same bits in a second call."""
    from repro_torch.kernels.ssm_scan import kernel as ss_kernel
    from repro_torch.kernels.ssm_scan.ref import ssd_scan_chunked_bwd_ref
    xdt, loga, bb, cc = _ssd_case(cuda, b, s, h, p, n)
    gen = torch.Generator(device=cuda).manual_seed(s)
    dy = torch.randn(xdt.shape, generator=gen, device=cuda)
    dst = torch.randn((b, h, p, n), generator=gen, device=cuda)
    ss_kernel.reset_counts()
    y, st, saved = ss_kernel.ssd_scan_kernel(xdt, loga, bb, cc, chunk,
                                             save_states=True)
    served = ss_kernel.ssd_scan_kernel(xdt, loga, bb, cc, chunk)
    assert torch.equal(y, served[0]) and torch.equal(st, served[1])
    got = ss_kernel.ssd_scan_bwd_kernel(xdt, loga, bb, cc, *saved, chunk, dy,
                                        dst)
    again = ss_kernel.ssd_scan_bwd_kernel(xdt, loga, bb, cc, *saved, chunk,
                                          dy, dst)
    torch.cuda.synchronize()
    assert ss_kernel.ssd_scan_bwd_kernel.launches == 2
    assert ss_kernel.ssd_scan_bwd_kernel.by_kernel == {"ssd_bwd_chain": 2,
                                                       "ssd_bwd_chunk": 2}
    want = ssd_scan_chunked_bwd_ref(xdt, loga, bb, cc, chunk, dy, dst)
    for name, g, g2, w in zip(("dxdt", "dloga", "db", "dc"), got, again,
                              want):
        assert torch.equal(g, g2), name
        err = (g - w).abs().max().item() / _ssd_bwd_scale(name, w, xdt, want)
        print(f"ssd backward {(b, s, h, p, n, chunk)} {name}: {err:.3g}")
        assert err <= SSD_BWD_GPU_TOL, (name, err)


def _ssd_bwd_scale(name, w, xdt, want):
    """The scale a gradient's gap is held against: its largest magnitude;
    for dloga at least 1e-2 of max |xdt| · max |dxdt|, the size of the
    terms it sums (both in the loss's units), since at one step they cancel
    to 0 exactly (y and the state do not depend on loga) and what is left
    on either side is rounding."""
    scale = w.abs().max().item()
    if name == "dloga":
        scale = max(scale, 1e-2 * xdt.abs().max().item()
                    * want[0].abs().max().item())
    return scale


def test_ssm_scan_backward_takes_absent_cotangents(cuda):
    """A cotangent on y alone (training: the final state unused) and on the
    state alone, each against the plain backward."""
    from repro_torch.kernels.ssm_scan import kernel as ss_kernel
    from repro_torch.kernels.ssm_scan.ref import ssd_scan_chunked_bwd_ref
    xdt, loga, bb, cc = _ssd_case(cuda, 2, 90, 3, 16, 8)
    _, _, saved = ss_kernel.ssd_scan_kernel(xdt, loga, bb, cc, 32,
                                            save_states=True)
    gen = torch.Generator(device=cuda).manual_seed(1)
    dy = torch.randn(xdt.shape, generator=gen, device=cuda)
    dst = torch.randn((2, 3, 16, 8), generator=gen, device=cuda)
    for cots in ((dy, None), (None, dst)):
        got = ss_kernel.ssd_scan_bwd_kernel(xdt, loga, bb, cc, *saved, 32,
                                            *cots)
        want = ssd_scan_chunked_bwd_ref(xdt, loga, bb, cc, 32, *cots)
        for name, g, w in zip(("dxdt", "dloga", "db", "dc"), got, want):
            assert ((g - w).abs().max().item() <= SSD_BWD_GPU_TOL
                    * _ssd_bwd_scale(name, w, xdt, want)), name


# (B, S, H, du, dtype of R and h, route) of the sLSTM backward: one step,
# B not a multiple of 4, xlstm-350m's width (H 4, du 256) on both routes
# and both dtypes, B 8 (two row blocks), and shapes only the block route
# takes (du 24, B 9 at du 256)
SLSTM_BWD_GPU_CASES = [
    (1, 1, 4, 256, torch.float32, "cluster"),
    (3, 40, 4, 256, torch.bfloat16, "cluster"),
    (3, 40, 4, 256, torch.float32, "block"),
    (4, 300, 4, 256, torch.bfloat16, "cluster"),
    (4, 300, 4, 256, torch.float32, "cluster"),
    (8, 60, 2, 256, torch.float32, "cluster"),
    (5, 33, 2, 64, torch.bfloat16, "cluster"),
    (2, 1, 3, 24, torch.float32, "block"),
    (5, 33, 3, 24, torch.float32, "block"),
    (9, 20, 2, 256, torch.bfloat16, "block")]
# f32 sums in other orders along the reverse chain: dpre and dR each within
# SLSTM_BWD_GPU_TOL of its largest magnitude
SLSTM_BWD_GPU_TOL = 1e-4


@pytest.mark.parametrize("b,s,h,du,dtype,route", SLSTM_BWD_GPU_CASES)
def test_slstm_scan_backward_matches_plain(cuda, b, s, h, du, dtype, route):
    """The forward with its steps saved keeps the served call's bits (on
    the route that takes the shape); ``slstm_scan_bwd`` on ``route``
    against ``slstm_scan_bwd_ref``, with cotangents on h and on the final
    (c, n, h, m), and the same bits in a second call."""
    from repro_torch.kernels.slstm_scan import kernel as sl_kernel
    from repro_torch.kernels.slstm_scan import ref as sl_ref
    pre, r = _slstm_inputs(cuda, b, s, h, du, dtype)
    gen = torch.Generator(device=cuda).manual_seed(b + s)
    h_cot = torch.randn((b, s, h * du), generator=gen, device=cuda)
    st_cot = tuple(torch.randn((b, h * du), generator=gen, device=cuda)
                   for _ in range(4))
    sl_kernel.reset_counts()
    hs, st, saved = sl_kernel.slstm_scan_kernel(pre, r, out_dtype=dtype,
                                                save_states=True)
    served, st2 = sl_kernel.slstm_scan_kernel(pre, r, out_dtype=dtype)
    assert torch.equal(hs, served)
    assert all(torch.equal(a, c) for a, c in zip(st, st2))
    got = sl_kernel.slstm_scan_bwd_kernel(saved, r, h_cot, st_cot,
                                          route=route)
    again = sl_kernel.slstm_scan_bwd_kernel(saved, r, h_cot, st_cot,
                                            route=route)
    torch.cuda.synchronize()
    assert sl_kernel.slstm_scan_bwd_kernel.by_route[route] == 2
    want = sl_ref.slstm_scan_bwd_ref(pre, r, h_cot, st_cot)
    for name, g, g2, w in zip(("dpre", "dR"), got, again, want):
        assert torch.equal(g, g2), name
        # dR is 0 at one step (h before the first is 0)
        err = (g - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
        print(f"slstm backward {(b, s, h, du, dtype, route)} {name}: "
              f"{err:.3g}")
        assert err <= SLSTM_BWD_GPU_TOL, (name, err)


def test_scan_ops_take_the_backward_kernels_under_autograd(cuda):
    """Under autograd ``ssd_chunked_kernel`` and ``slstm_scan`` run the
    forward kernels saving their states and, in the backward, one call of
    each backward kernel; their gradients match autograd on CPU copies (the
    plain versions).  Without grad mode nothing is saved: one forward call,
    no backward."""
    from repro_torch.kernels.slstm_scan import kernel as sl_kernel
    from repro_torch.kernels.slstm_scan.ops import slstm_scan
    from repro_torch.kernels.ssm_scan import kernel as ss_kernel
    from repro_torch.kernels.ssm_scan.ops import ssd_chunked_kernel
    gen = torch.Generator(device=cuda).manual_seed(0)
    b, s, h, p, n = 2, 70, 2, 16, 16
    x = torch.randn((b, s, h, p), generator=gen, device=cuda)
    dt = torch.rand((b, s, h), generator=gen, device=cuda) * 0.1
    a_log = torch.zeros(h, device=cuda)
    bm, cm = (torch.randn((b, s, n), generator=gen, device=cuda)
              for _ in range(2))
    d_skip = torch.ones(h, device=cuda)
    pre = torch.randn((4, b, s, 2 * 32), generator=gen, device=cuda)
    r = torch.randn((4, 2, 32, 32), generator=gen, device=cuda) * 0.1
    for args, fn, kw, kern in (((x, dt, a_log, bm, cm, d_skip),
                                ssd_chunked_kernel, dict(chunk=32),
                                ss_kernel.ssd_scan_bwd_kernel),
                               ((pre, r), slstm_scan, {},
                                sl_kernel.slstm_scan_bwd_kernel)):
        grads = []
        for dev in (cuda, "cpu"):
            leaves = [a.detach().to(dev).requires_grad_() for a in args]
            ss_kernel.reset_counts()
            sl_kernel.reset_counts()
            out = fn(*leaves, **kw)
            out[0].float().square().sum().backward()
            grads.append([t.grad.cpu() for t in leaves])
            if dev == cuda:
                assert kern.launches == 1
        for g, w in zip(*grads):
            assert ((g - w).abs().max() <= 1e-4 * w.abs().max()).item()
        ss_kernel.reset_counts()
        sl_kernel.reset_counts()
        with torch.no_grad():
            fn(*(a.clone().requires_grad_() for a in args), **kw)
        assert kern.launches == 0
        assert (ss_kernel.ssd_scan_kernel.launches
                + sl_kernel.slstm_scan_kernel.launches) == 1
