"""The port's histogram GBT against the JAX package's.

* The plain gradient histogram equals the reference's ``np.bincount``
  histogram bit for bit in f64, and the reference Pallas kernel (interpret
  mode) within ``rtol=atol=1e-4`` on the sums (f32 accumulation) with the
  counts exact.
* Fitted on the CPU, the port grows node arrays identical to the
  reference's, for ``GBTRegressor`` and ``MultiTargetGBT``.
* A model saved by the reference loads into the port (and back) with
  identical predictions.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core.predictors import gbt as rgbt
from repro.core.predictors.persist import load_predictor as r_load
from repro.core.predictors.persist import save_predictor as r_save
from repro.kernels.gbt_hist.kernel import grad_histogram_kernel as r_hist_k
from repro.kernels.gbt_hist.ref import grad_histogram_ref as r_hist
from repro.kernels.tree_predict.ref import flatten_gbt as r_flatten

from repro_torch.core.predictors import gbt as pgbt
from repro_torch.core.predictors.persist import load_predictor as p_load
from repro_torch.core.predictors.persist import save_predictor as p_save
from repro_torch.kernels.gbt_hist import kernel as pkernel
from repro_torch.kernels.gbt_hist import ops as pops
from repro_torch.kernels.gbt_hist.ref import grad_histogram_ref as p_hist
from repro_torch.kernels.gbt_hist.ref import level_histogram_ref as p_level
from repro_torch.kernels.tree_predict.ref import flatten_gbt as p_flatten

CPU = "cpu"
TREE_FIELDS = ("feature", "threshold_bin", "left", "right", "value",
               "n_nodes", "edges")


def hist_case(seed, n, f, n_bins):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_bins, size=(n, f)).astype(np.int32),
            rng.normal(size=n))


def regression_data(seed, n=300, f=5, n_targets=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    ys = [np.sin(x[:, t % f]) + x[:, (t + 1) % f] ** 2
          + 0.1 * rng.normal(size=n) for t in range(n_targets)]
    return x, (ys[0] if n_targets == 1 else np.stack(ys, axis=1))


def assert_same_trees(ref_model, port_model):
    a, b = r_flatten(ref_model), p_flatten(port_model)
    for f in TREE_FIELDS:
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert (a.base, a.learning_rate, a.max_depth) == \
        (b.base, b.learning_rate, b.max_depth)


@pytest.mark.parametrize("seed,n,f,n_bins",
                         [(0, 1000, 7, 64), (1, 17, 3, 8), (2, 0, 4, 16),
                          (3, 4096, 1, 256)])
def test_plain_histogram_bit_for_bit(seed, n, f, n_bins):
    codes, grad = hist_case(seed, n, f, n_bins)
    rg, rc = r_hist(codes, grad, n_bins)
    pg, pc = p_hist(torch.as_tensor(codes), torch.as_tensor(grad), n_bins)
    assert pg.dtype == pc.dtype == torch.float64
    assert np.array_equal(rg, pg.numpy()) and np.array_equal(rc, pc.numpy())
    # the predictor-level entry point on the CPU is the same histogram
    rg2, rc2 = rgbt.grad_histogram(codes.astype(np.uint8) if n_bins <= 256
                                   else codes, grad, n_bins)
    pg2, pc2 = pgbt.grad_histogram(codes, grad, n_bins, device=CPU)
    assert np.array_equal(rg2, pg2.numpy())
    assert np.array_equal(rc2, pc2.numpy())


@pytest.mark.parametrize("seed,n,f,n_bins",
                         [(4, 1000, 7, 64), (5, 513, 3, 32), (6, 9, 2, 8)])
def test_plain_histogram_matches_pallas_interpret(seed, n, f, n_bins):
    codes, grad = hist_case(seed, n, f, n_bins)
    grad32 = grad.astype(np.float32)
    kg, kc = r_hist_k(jnp.asarray(codes), jnp.asarray(grad32), n_bins,
                      interpret=True)
    pg, pc = pops.grad_histogram(torch.as_tensor(codes),
                                 torch.as_tensor(grad32), n_bins)
    assert np.array_equal(np.asarray(kc), pc.numpy())
    np.testing.assert_allclose(pg.numpy(), np.asarray(kg), rtol=1e-4,
                               atol=1e-4)


def _per_node_bincount(codes, grad, order, offsets, n_bins):
    """The reference's histogram of each node's rows (``np.bincount`` in
    row order), with codes outside [0, n_bins) dropped in place."""
    gs, cs = [], []
    for lo, hi in zip(offsets[:-1], offsets[1:]):
        rows = order[lo:hi]
        c, g = codes[rows], grad[rows]
        gsum = np.zeros((codes.shape[1], n_bins))
        cnt = np.zeros((codes.shape[1], n_bins))
        for f in range(codes.shape[1]):
            keep = (c[:, f] >= 0) & (c[:, f] < n_bins)
            gsum[f] = np.bincount(c[keep, f], weights=g[keep],
                                  minlength=n_bins)
            cnt[f] = np.bincount(c[keep, f], minlength=n_bins)
        gs.append(gsum)
        cs.append(cnt)
    return np.array(gs).reshape(-1, codes.shape[1], n_bins), \
        np.array(cs).reshape(-1, codes.shape[1], n_bins)


@pytest.mark.parametrize("case", ["mixed_sizes", "one_heavy_bin",
                                  "out_of_range", "all_empty"])
def test_level_histogram_plain_equals_per_node_bincount(case):
    """One call for a level's nodes: each node's histogram is
    ``np.bincount`` over its rows, bit for bit, with empty and 1-row nodes,
    one bin holding most rows, and codes out of range not counted."""
    rng = np.random.default_rng(3)
    n, f, n_bins = 500, 4, 16
    codes = rng.integers(0, n_bins, size=(n, f))
    grad = rng.normal(size=n) * 10.0 ** rng.integers(-3, 4, size=n)
    sizes = [0, 1, 37, 0, 1, 120, 2, 200]
    if case == "one_heavy_bin":
        codes[rng.random((n, f)) < 0.9] = 5
    elif case == "out_of_range":
        codes[rng.random((n, f)) < 0.2] = n_bins + 2
        codes[rng.random((n, f)) < 0.1] = -1
    elif case == "all_empty":
        sizes = [0, 0]
    perm = rng.permutation(n)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    order = np.concatenate([np.sort(perm[lo:hi]) for lo, hi in
                            zip(offsets[:-1], offsets[1:])]).astype(np.int64)
    want_g, want_c = _per_node_bincount(codes, grad, order, offsets, n_bins)
    got_g, got_c = p_level(torch.as_tensor(codes), torch.as_tensor(grad),
                           torch.as_tensor(order), torch.as_tensor(offsets),
                           n_bins)
    assert got_g.dtype == got_c.dtype == torch.float64
    assert got_g.shape == (len(sizes), f, n_bins)
    assert np.array_equal(got_g.numpy(), want_g)
    assert np.array_equal(got_c.numpy(), want_c)
    # the dispatch takes the plain version for CPU tensors
    og, oc = pops.level_histogram(torch.as_tensor(codes),
                                  torch.as_tensor(grad),
                                  torch.as_tensor(order),
                                  torch.as_tensor(offsets), n_bins)
    assert torch.equal(og, got_g) and torch.equal(oc, got_c)


def test_histogram_kernel_refuses_cpu_tensors():
    codes, grad = hist_case(0, 8, 2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        pkernel.grad_histogram_kernel(torch.as_tensor(codes),
                                      torch.as_tensor(grad, dtype=torch.float32),
                                      4)


def three_valued_data(seed, n=3000, f=6):
    """Regression data whose feature 2 takes 3 values: most of a node's
    rows then fall in one of its bins."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    x[:, 2] = rng.integers(0, 3, n)
    y = (np.sin(x[:, 0]) + x[:, 1] ** 2 + 0.5 * x[:, 2]
         + 0.1 * rng.normal(size=n))
    return x, y


# cases beyond the seed's data, by seed: deep trees on data with a
# 3-valued feature, a depth of 1, and min_samples_leaf cutting nodes
FIT_CASES = {3: dict(data=three_valued_data),
             5: dict(data=three_valued_data, min_samples_leaf=60)}


@pytest.mark.parametrize("seed,subsample,max_depth",
                         [(0, 0.8, 4), (1, 1.0, 3), (2, 0.5, 6),
                          (3, 0.8, 12), (4, 0.8, 1), (5, 0.8, 8)])
def test_gbt_fit_grows_identical_node_arrays(seed, subsample, max_depth):
    extra = dict(FIT_CASES.get(seed, {}))
    data = extra.pop("data", regression_data)
    x, y = data(seed)
    kw = dict(n_trees=10, max_depth=max_depth, subsample=subsample,
              seed=seed, **extra)
    ref = rgbt.GBTRegressor(**kw).fit(x, y)
    port = pgbt.GBTRegressor(**kw).fit(x, y, device=CPU)
    assert_same_trees(ref, port)
    xt = data(seed + 100, n=64)[0]
    assert np.array_equal(ref.predict(xt), port.predict(xt, device=CPU)
                          .numpy())


def test_tree_update_equals_the_references():
    """The fit's per-tree update (every row descends to its leaf, one
    gather a level) gives the reference's ``_tree_predict`` bits."""
    x, y = three_valued_data(11, n=2000)
    kw = dict(n_trees=5, max_depth=10, subsample=0.8, seed=11)
    ref = rgbt.GBTRegressor(**kw).fit(x, y)
    port = pgbt.GBTRegressor(**kw).fit(x, y, device=CPU)
    codes = rgbt.bin_data(x, ref.edges_)
    for r_tree, p_tree in zip(ref.trees_, port.trees_):
        assert np.array_equal(ref._tree_predict(r_tree, codes),
                              port._tree_predict(p_tree, codes))


def test_multi_target_gbt_identical():
    x, y = regression_data(7, n_targets=3)
    kw = dict(n_trees=6, max_depth=4, subsample=0.8, seed=3)
    ref = rgbt.MultiTargetGBT(**kw).fit(x, y)
    port = pgbt.MultiTargetGBT(**kw).fit(x, y, device=CPU)
    assert len(ref.models_) == len(port.models_) == 3
    for r, p in zip(ref.models_, port.models_):
        assert_same_trees(r, p)
    assert np.array_equal(ref.predict(x), port.predict(x, device=CPU)
                          .numpy())


@pytest.mark.parametrize("multi", [False, True])
def test_reference_bundle_loads_into_port_and_back(tmp_path, multi):
    x, y = regression_data(9, n_targets=2 if multi else 1)
    cls = rgbt.MultiTargetGBT if multi else rgbt.GBTRegressor
    ref = cls(n_trees=8, max_depth=4, subsample=0.8, seed=5).fit(x, y)
    r_save(ref, str(tmp_path / "ref"))
    port = p_load(str(tmp_path / "ref"))
    assert type(port).__name__ == type(ref).__name__
    assert np.array_equal(ref.predict(x), port.predict(x, device=CPU)
                          .numpy())
    # the port writes the same format: the reference reads it back
    p_save(port, str(tmp_path / "port"))
    back = r_load(str(tmp_path / "port"))
    assert np.array_equal(ref.predict(x), back.predict(x))


def test_persist_rejects_unported_families(tmp_path):
    """Ridge and MLP are ported: the reference's bundles of both load and
    predict in the port, and the port's load back in the reference; only
    objects of no regressor family are refused."""
    from repro.core.predictors.linear import RidgeRegressor
    from repro.core.predictors.mlp import MLPRegressor
    x, y = regression_data(1)
    for name, ref, tol in (
            ("ridge", RidgeRegressor().fit(x, y), 1e-12),
            ("mlp", MLPRegressor(hidden=(8,), epochs=2).fit(x, y), 1e-5)):
        r_save(ref, str(tmp_path / name))
        port = p_load(str(tmp_path / name))
        assert type(port).__name__ == type(ref).__name__
        got = port.predict(x, device=CPU).numpy()
        np.testing.assert_allclose(got, ref.predict(x), rtol=tol,
                                   atol=tol)
        p_save(port, str(tmp_path / f"{name}_port"))
        back = r_load(str(tmp_path / f"{name}_port"))
        np.testing.assert_allclose(back.predict(x), ref.predict(x),
                                   rtol=tol, atol=tol)
    with pytest.raises(TypeError, match="cannot persist"):
        p_save(object(), str(tmp_path / "x"))


def test_histogram_ops_hands_the_kernel_f64(monkeypatch):
    """Off the CPU the dispatch hands the kernel int32 codes and the f64
    gradient as it is (no cast to f32), and returns f64 sums and counts.
    The kernel is replaced by a recorder; meta tensors stand in for the
    card's."""
    seen = {}

    def record(codes, grad, n_bins):
        seen.update(codes=codes.dtype, grad=grad.dtype, n_bins=n_bins)
        f = codes.shape[1]
        return (torch.zeros((f, n_bins), dtype=torch.float64,
                            device=codes.device),
                torch.zeros((f, n_bins), dtype=torch.int32,
                            device=codes.device))

    monkeypatch.setattr(pops, "grad_histogram_kernel", record)
    codes = torch.zeros((5, 3), dtype=torch.int64, device="meta")
    grad = torch.zeros(5, dtype=torch.float64, device="meta")
    gsum, cnt = pops.grad_histogram(codes, grad, 8)
    assert seen == {"codes": torch.int32, "grad": torch.float64,
                    "n_bins": 8}
    assert gsum.dtype == cnt.dtype == torch.float64


def test_histogram_kernel_constants_match_the_source():
    """The wrapper's block constants are the source's: 4 warps a block,
    each staging 128 rows, 6 KB of static shared memory."""
    import re
    from repro_torch.kernels import _build
    src = (_build.CSRC / "gbt_hist.cu").read_text()
    const = dict(re.findall(r"constexpr int (WARPS|PER_LANE) = (\d+);",
                            src))
    assert int(const["WARPS"]) == pkernel.WARPS_PER_BLOCK
    assert 32 * int(const["PER_LANE"]) == pkernel.ROWS_PER_BATCH
    assert pkernel.SMEM_BYTES <= 48 * 1024


def test_bench_histogram_work_counts_f64_gradients_and_sums():
    from repro_torch.bench.kernels import gbt_hist_work
    n, f, b, k = 12589, 7, 64, 3
    # int32 codes, f64 gradients, int32 row ids and offsets read; f64 sums
    # and int32 counts [K, F, B] written
    assert gbt_hist_work(n, f, b, k) == (
        n * f * 4 + n * 8 + n * 4 + (k + 1) * 4 + k * f * b * (8 + 4),
        2 * n * f)
