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


def test_histogram_kernel_refuses_cpu_tensors():
    codes, grad = hist_case(0, 8, 2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        pkernel.grad_histogram_kernel(torch.as_tensor(codes),
                                      torch.as_tensor(grad, dtype=torch.float32),
                                      4)


@pytest.mark.parametrize("seed,subsample,max_depth",
                         [(0, 0.8, 4), (1, 1.0, 3), (2, 0.5, 6)])
def test_gbt_fit_grows_identical_node_arrays(seed, subsample, max_depth):
    x, y = regression_data(seed)
    kw = dict(n_trees=10, max_depth=max_depth, subsample=subsample,
              seed=seed)
    ref = rgbt.GBTRegressor(**kw).fit(x, y)
    port = pgbt.GBTRegressor(**kw).fit(x, y, device=CPU)
    assert_same_trees(ref, port)
    xt = regression_data(seed + 100, n=64)[0]
    assert np.array_equal(ref.predict(xt), port.predict(xt, device=CPU)
                          .numpy())


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
    from repro.core.predictors.linear import RidgeRegressor
    x, y = regression_data(1)
    r_save(RidgeRegressor().fit(x, y), str(tmp_path / "ridge"))
    with pytest.raises(TypeError, match="later slice"):
        p_load(str(tmp_path / "ridge"))
    with pytest.raises(TypeError, match="later slice"):
        p_save(object(), str(tmp_path / "x"))
