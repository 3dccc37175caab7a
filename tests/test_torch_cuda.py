"""The port's CUDA kernels against their plain versions, on the card.

A CUDA kernel has no CPU mode, so these tests skip where there is no card.
On a machine with one they run with::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
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
    rng = np.random.default_rng(n)
    codes = torch.as_tensor(rng.integers(0, n_bins, (n, f)), dtype=torch.int32,
                            device=cuda)
    grad = torch.as_tensor(rng.normal(size=n), dtype=torch.float32,
                           device=cuda)
    gsum, cnt = gh_kernel.grad_histogram_kernel(codes, grad, n_bins)
    torch.cuda.synchronize()
    pg, pc = gh_ref.grad_histogram_ref(codes, grad, n_bins)
    assert torch.equal(cnt.double(), pc)
    abs_sum, _ = gh_ref.grad_histogram_ref(codes, grad.abs(), n_bins)
    assert torch.all((gsum.double() - pg).abs() <= 1e-4 * abs_sum)


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
