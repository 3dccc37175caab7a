"""The port's batched tree inference against the JAX package's.

* f64: the port's descent (the plain version of the ``tree_predict``
  kernel, which is exact in f64 like the kernel itself) equals
  ``GBTRegressor.predict`` and the reference ``predict_ref`` bit for bit.
* Against the reference Pallas kernel (interpret mode, f32 leaf values and
  sum): within ``rtol=1e-4, atol=1e-7``, the tolerance of
  ``tests/test_oracle.py``.
"""
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


def test_lowering_refuses_other_families():
    class RidgeRegressor:
        pass

    with pytest.raises(TypeError, match="later slice"):
        lowered.lower_predictor(RidgeRegressor())
    with pytest.raises(TypeError, match="does not lower"):
        lowered.lower_predictor(object())


def test_kernel_wrapper_refuses_cpu_tensors():
    z = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        pkernel.tree_predict_kernel(z, z, z, z, z, z.double(), max_depth=1,
                                    base=0.0)
