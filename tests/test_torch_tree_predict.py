"""The port's batched tree inference against the JAX package's.

* f64: the port's descent (the plain version of the ``tree_predict``
  kernel, which is exact in f64 like the kernel itself) equals
  ``GBTRegressor.predict`` and the reference ``predict_ref`` bit for bit.
* Against the reference Pallas kernel (interpret mode, f32 leaf values and
  sum): within ``rtol=1e-4, atol=1e-7``, the tolerance of
  ``tests/test_oracle.py``.
* The CUDA kernel's two phases in plain PyTorch (``leaf_matrix_ref`` then
  ``fold_ref``): bit for bit with the above, where partial sums per block
  of trees are not; and the rule that picks its route.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core.predictors import gbt as rgbt
from repro.kernels.tree_predict import ref as rref
from repro.kernels.tree_predict.kernel import tree_predict_kernel as r_kernel

from repro_torch.core.predictors import gbt as pgbt
from repro_torch.kernels.tree_predict import kernel as pkernel
from repro_torch.kernels.tree_predict import ops as pops
from repro_torch.kernels.tree_predict import ref as pref
from repro_torch.oracle import lowered

CPU = "cpu"


def fitted(seed, n_targets=1, n_trees=12, max_depth=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(400, 6)).astype(np.float32)
    ys = [np.cos(x[:, t]) * x[:, t + 1] + 0.1 * rng.normal(size=400)
          for t in range(n_targets)]
    y = ys[0] if n_targets == 1 else np.stack(ys, axis=1)
    kw = dict(n_trees=n_trees, max_depth=max_depth, subsample=0.8,
              seed=seed)
    cls = (rgbt.GBTRegressor, pgbt.GBTRegressor) if n_targets == 1 \
        else (rgbt.MultiTargetGBT, pgbt.MultiTargetGBT)
    ref, port = cls[0](**kw).fit(x, y), cls[1](**kw).fit(x, y, device=CPU)
    xt = rng.normal(size=(97, 6)).astype(np.float32) * 1.5
    return ref, port, xt


@pytest.mark.parametrize("seed,max_depth", [(0, 5), (1, 1), (2, 9)])
def test_f64_descent_bit_for_bit(seed, max_depth):
    ref, port, xt = fitted(seed, max_depth=max_depth)
    arrays = pref.flatten_gbt(port)
    want = ref.predict(xt)
    assert np.array_equal(rref.predict_ref(xt, rref.flatten_gbt(ref)), want)
    got = pops.predict_trees(xt, arrays, device=CPU)
    assert got.dtype == torch.float64
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(pref.predict_ref(torch.as_tensor(xt), arrays)
                          .numpy(), want)
    assert np.array_equal(
        pref.bin_codes_ref(torch.as_tensor(xt),
                           torch.as_tensor(arrays.edges)).numpy(),
        rref.bin_codes_ref(xt, arrays.edges))


@pytest.mark.parametrize("seed,max_depth", [(3, 5), (4, 8), (5, 0)])
def test_plain_twin_matches_pallas_interpret(seed, max_depth):
    _, port, xt = fitted(seed, max_depth=max_depth)
    a = pref.flatten_gbt(port)
    codes = rref.bin_codes_ref(xt, a.edges)
    scaled = (a.learning_rate * a.value).astype(np.float32)
    want = np.asarray(r_kernel(
        jnp.asarray(codes), *(jnp.asarray(v) for v in
                              (a.feature, a.threshold_bin, a.left, a.right)),
        jnp.asarray(scaled), max_depth=a.max_depth, interpret=True))
    got = pops.tree_predict(
        torch.as_tensor(codes),
        *(torch.as_tensor(v) for v in (a.feature, a.threshold_bin, a.left,
                                       a.right)),
        torch.as_tensor(a.learning_rate * a.value), max_depth=a.max_depth,
        base=0.0)
    assert got.dtype == torch.float64 and got.shape == (len(xt),)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-7)


def test_lowered_trees_multi_target_and_memo():
    ref, port, xt = fitted(6, n_targets=2)
    low = lowered.lower_predictor(port)
    assert lowered.lower_predictor(port) is low
    got = low.predict(xt, device=CPU)
    assert got.shape == (len(xt), 2)
    assert np.array_equal(got.numpy(), ref.predict(xt))


def test_lowering_refuses_other_families(tmp_path):
    """Ridge and MLP lower since their port: a reference bundle of each,
    loaded into the port, lowers and predicts as the reference does.  A
    class of another module under the same name, and an object of no
    family, are refused."""
    from repro.core.predictors.linear import RidgeRegressor as RRidge
    from repro.core.predictors.mlp import MLPRegressor as RMLP
    from repro.core.predictors.persist import save_predictor as r_save
    from repro_torch.core.predictors.persist import load_predictor as p_load
    rng = np.random.default_rng(3)
    x = rng.normal(size=(64, 4)).astype(np.float32)
    y = np.stack([x[:, 0] * 2 + x[:, 1], np.sin(x[:, 2])], axis=1)
    for name, ref, cls, tol in (
            ("ridge", RRidge().fit(x, y), lowered.LoweredLinear, 1e-12),
            ("mlp", RMLP(hidden=(8,), epochs=2).fit(x, y),
             lowered.LoweredMLP, 1e-5)):
        r_save(ref, str(tmp_path / name))
        low = lowered.lower_predictor(p_load(str(tmp_path / name)))
        assert isinstance(low, cls)
        got = low.predict(x, device=CPU)
        assert got.dtype == torch.float64 and got.shape == (64, 2)
        np.testing.assert_allclose(got.numpy(), ref.predict(x), rtol=tol,
                                   atol=tol)

    class RidgeRegressor:
        pass

    with pytest.raises(TypeError, match="does not lower"):
        lowered.lower_predictor(RidgeRegressor())
    with pytest.raises(TypeError, match="does not lower"):
        lowered.lower_predictor(object())


def test_kernel_wrapper_refuses_cpu_tensors():
    z = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        pkernel.tree_predict_kernel(z, z, z, z, z, z.double(), max_depth=1,
                                    base=0.0)


# --------------------------------------------------------------------------
# The kernel's two phases: the [N, T] leaf matrix, then the in-order fold
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def fitted_deep(max_depth):
    """Both packages' fits on 600 rows at ``max_depth`` (40 trees)."""
    rng = np.random.default_rng(100 + max_depth)
    x = rng.normal(size=(600, 6)).astype(np.float32)
    y = np.sin(2 * x[:, 0]) * x[:, 1] + x[:, 2] ** 2 \
        + 0.1 * rng.normal(size=600)
    kw = dict(n_trees=40, max_depth=max_depth, subsample=0.8,
              min_samples_leaf=1, seed=max_depth)
    return (rgbt.GBTRegressor(**kw).fit(x, y),
            pgbt.GBTRegressor(**kw).fit(x, y, device=CPU))


def _node_tensors(a):
    t = pref.device_trees(a, torch.device(CPU))
    return (t.feature, t.threshold_bin, t.left, t.right, t.scaled_value)


@pytest.mark.parametrize("n", [0, 1, 56, 1000])
@pytest.mark.parametrize("max_depth", [0, 1, 5, 12])
def test_two_phase_mirror_bit_for_bit(max_depth, n):
    """The leaf matrix folded in tree order (the CUDA kernel's two phases)
    equals the one-tree-at-a-time plain version and the reference's
    ``GBTRegressor.predict`` bit for bit."""
    ref, port = fitted_deep(max_depth)
    a = pref.flatten_gbt(port)
    assert a.max_depth == max_depth
    if max_depth > 1:                   # trees of fewer nodes than the slots
        assert a.n_nodes.min() < a.max_nodes
    xt = np.random.default_rng(n).normal(size=(n, 6)).astype(np.float32) \
        * 1.5
    t = pref.device_trees(a, torch.device(CPU))
    codes = pref.bin_codes_ref(torch.as_tensor(xt), t.edges)
    leaf = pref.leaf_matrix_ref(codes, *_node_tensors(a),
                                max_depth=a.max_depth)
    assert leaf.shape == (n, a.n_trees) and leaf.dtype == torch.float64
    got = pref.fold_ref(leaf, a.base)
    want = pref.tree_predict_ref(codes, *_node_tensors(a),
                                 max_depth=a.max_depth, base=a.base)
    assert torch.equal(got, want)
    assert np.array_equal(got.numpy(), ref.predict(xt))


def test_partial_sum_fold_differs_from_the_in_order_fold():
    """Why the kernel keeps one chain of adds per row: partial sums over
    blocks of 8 trees, added up in block order, give other f64 bits than
    the in-order fold on this seeded ensemble (which equals the
    reference)."""
    ref, port = fitted_deep(5)
    a = pref.flatten_gbt(port)
    xt = np.random.default_rng(7).normal(size=(1000, 6)).astype(np.float32)
    t = pref.device_trees(a, torch.device(CPU))
    codes = pref.bin_codes_ref(torch.as_tensor(xt), t.edges)
    leaf = pref.leaf_matrix_ref(codes, *_node_tensors(a),
                                max_depth=a.max_depth)
    in_order = pref.fold_ref(leaf, a.base)
    partial = torch.full_like(in_order, a.base)
    for block in leaf.split(8, dim=1):
        partial = partial + pref.fold_ref(block, 0.0)
    assert np.array_equal(in_order.numpy(), ref.predict(xt))
    assert not torch.equal(partial, in_order)
    np.testing.assert_allclose(partial.numpy(), in_order.numpy(),
                               rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("n_rows,n_feat", [(56, 7), (1, 7), (1000, 7),
                                           (128, 64)])
def test_route_chooser_either_side_of_the_shared_memory_limit(n_rows,
                                                              n_feat):
    rows = min(n_rows, pkernel.ROW_TILE)
    room = pkernel.SMEM_LIMIT - 4 * n_feat * rows
    largest = room // pkernel.NODE_BYTES          # most node slots staged
    route, per_block, got_rows = pkernel.choose_route(n_rows, n_feat, 200,
                                                      largest)
    assert (route, per_block, got_rows) == ("descend_shared", 1, rows)
    tiles = -(-n_rows // rows)
    assert pkernel.choose_route(n_rows, n_feat, 200, largest + 1) == \
        ("descend_global", -(-200 * tiles // pkernel.TARGET_BLOCKS), rows)
    # the decision path's shape: one tree a block, 200 blocks
    if (n_rows, n_feat) == (56, 7):
        assert pkernel.choose_route(56, 7, 200, 643) == \
            ("descend_shared", 1, 56)
        assert largest > 9_400


def test_route_chooser_groups_trees_as_rows_grow():
    """More row tiles, more trees a block: as few as give TARGET_BLOCKS
    blocks (ceil(200 tiles / 264)), no more than fit beside the codes."""
    fit = (pkernel.SMEM_LIMIT - 4 * 7 * 128) // (24 * 643)
    for n_rows, want in ((56, 1), (1000, 7), (15_780, fit)):
        assert pkernel.choose_route(n_rows, 7, 200, 643) == \
            ("descend_shared", want, min(n_rows, 128))
    with pytest.raises(ValueError, match="features"):
        pkernel.choose_route(128, 1000, 1, 1)


@pytest.mark.parametrize("n", [0, 1, 56])
def test_bench_tree_predict_work_counts_the_nodes_rows_reach(n):
    """The bound's bytes: the codes, 24 B for each node that some row
    reaches (found here by walking each row through each tree), the f64
    result; no padding slot and no node that no row reaches.  Operations:
    one compare per split passed, one add per (row, tree)."""
    from repro_torch.bench.kernels import tree_predict_work
    _, port = fitted_deep(12)
    a = pref.flatten_gbt(port)
    xt = np.random.default_rng(n).normal(size=(n, 6)).astype(np.float32)
    codes = pref.bin_codes_ref(
        torch.as_tensor(xt), pref.device_trees(a, torch.device(CPU)).edges)
    reached, splits = set(), 0
    for t in range(a.n_trees):
        for r in range(n):
            node = 0
            while True:
                reached.add((t, node))
                f = a.feature[t, node]
                if f < 0:
                    break
                splits += 1
                node = (a.left if codes[r, f] <= a.threshold_bin[t, node]
                        else a.right)[t, node]
    nbytes, ops = tree_predict_work(codes, *_node_tensors(a)[:4],
                                    a.max_depth)
    assert nbytes == 4 * codes.numel() + 24 * len(reached) + 8 * n
    assert ops == splits + n * a.n_trees
    assert len(reached) < int(a.n_nodes.sum()) < a.feature.size
