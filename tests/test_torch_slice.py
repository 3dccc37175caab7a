"""The ported slice end to end at small size: profile → predict → decide.

Layer costs of ``qwen3-1.7b``'s reduced config, a GBT fitted on per-layer
times on both sides, and ``decide_all`` over 64 environments with a
``PredictorCost`` and a ``CompositeCost`` over it: the port's
``backend="torch"`` plans equal the JAX package's ``backend="numpy"`` plans
bit for bit, and ``backend="kernel"`` picks the same splits.
"""
import numpy as np
import pytest

from repro import configs as rconfigs
from repro.core import costs as rco
from repro.core import decisions as rdec
from repro.core import offload as roff
from repro.core.predictors import gbt as rgbt
from repro.hw import EDGE_DEVICES as R_DEVICES

from repro_torch import configs as pconfigs
from repro_torch.core import costs as pco
from repro_torch.core import decisions as pdec
from repro_torch.core import offload as poff
from repro_torch.core.predictors import gbt as pgbt
from repro_torch.hw import EDGE_DEVICES as P_DEVICES

CPU = "cpu"
N_ENVS = 64


def training_set(configs, offload, costs, devices):
    """Per-layer (features, layer_time) rows over reduced configs, shapes
    and the five edge devices — built with one package's own modules."""
    feats, times = [], []
    for name in ("qwen3-1.7b", "gemma-2b", "xlstm-350m"):
        cfg = configs.reduced_config(name)
        for seq, batch in ((64, 1), (256, 2), (1024, 4), (4096, 1)):
            layers = offload.transformer_layer_costs(cfg, seq, batch)
            for spec in devices.values():
                feats.append(costs.default_layer_features(layers, spec))
                times.append([offload.layer_time(lc.flops, spec)
                              for lc in layers])
    return np.concatenate(feats), np.concatenate(times)


@pytest.fixture(scope="module")
def slice_pair():
    rx, ry = training_set(rconfigs, roff, rco, R_DEVICES)
    px, py = training_set(pconfigs, poff, pco, P_DEVICES)
    assert np.array_equal(rx, px) and np.array_equal(ry, py)
    kw = dict(n_trees=20, max_depth=6, subsample=0.8, seed=0)
    rmodel = rgbt.GBTRegressor(**kw).fit(rx, ry)
    pmodel = pgbt.GBTRegressor(**kw).fit(px, py, device=CPU)
    rlayers = roff.transformer_layer_costs(
        rconfigs.reduced_config("qwen3-1.7b"), 4096, 1)
    players = poff.transformer_layer_costs(
        pconfigs.reduced_config("qwen3-1.7b"), 4096, 1)
    bw = np.geomspace(1e5, 1e10, N_ENVS)
    renvs = rdec.make_envs(R_DEVICES["pi5-arm"],
                           R_DEVICES["edge-server-a100"], link_bw=bw,
                           input_bytes=4 * 4096 * 256)
    penvs = pdec.make_envs(P_DEVICES["pi5-arm"],
                           P_DEVICES["edge-server-a100"], link_bw=bw,
                           input_bytes=4 * 4096 * 256, device=CPU)
    return (rmodel, rlayers, renvs), (pmodel, players, penvs)


def costs_for(kind, rmodel, pmodel):
    rbase = rco.PredictorCost(rmodel, R_DEVICES["pi5-arm"],
                              R_DEVICES["edge-server-a100"])
    pbase = pco.PredictorCost(pmodel, P_DEVICES["pi5-arm"],
                              P_DEVICES["edge-server-a100"])
    if kind == "predictor":
        return rbase, pbase
    w = {"latency_s": 1.0, "energy_j": 0.05}
    return (rco.CompositeCost(base=rbase, weights=w),
            pco.CompositeCost(base=pbase, weights=w))


@pytest.mark.parametrize("kind", ["predictor", "composite"])
def test_slice_torch_backend_bit_for_bit(slice_pair, kind):
    (rmodel, rlayers, renvs), (pmodel, players, penvs) = slice_pair
    rcost, pcost = costs_for(kind, rmodel, pmodel)
    ref = rdec.decide_all(rlayers, renvs, cost=rcost, backend="numpy")
    got = pdec.decide_all(players, penvs, cost=pcost, backend="torch",
                          device=CPU)
    assert len(got) == N_ENVS
    for f in ("splits", "total_time_s", "device_time_s", "transfer_time_s",
              "edge_time_s", "components", "scalar_cost"):
        assert np.array_equal(getattr(ref, f), getattr(got, f).numpy()), f
    # the predictor really decides: splits vary across the link sweep
    assert len(np.unique(ref.splits)) > 1


@pytest.mark.parametrize("kind", ["predictor", "composite"])
def test_slice_kernel_backend_same_splits(slice_pair, kind):
    (rmodel, rlayers, renvs), (pmodel, players, penvs) = slice_pair
    rcost, pcost = costs_for(kind, rmodel, pmodel)
    ref = rdec.decide_all(rlayers, renvs, cost=rcost, backend="numpy")
    got = pdec.decide_all(players, penvs, cost=pcost, device=CPU)
    assert np.array_equal(ref.splits, got.splits.numpy())
    np.testing.assert_allclose(got.scalar_cost.numpy(), ref.scalar_cost,
                               rtol=1e-5)
    assert np.all(np.isfinite(got.total_time_s.numpy()))
