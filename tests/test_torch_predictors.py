"""The port's ridge and MLP predictors against the JAX package's.

* Ridge: the same closed form in f64; fitted on the same rows, the port's
  predictions equal the reference's within ``rtol=1e-12`` (the solves and
  reductions are each library's own, so not bit for bit), and
  ``decide_all`` with a ``PredictorCost`` over it picks the reference's
  ``backend="numpy"`` splits on both of the port's backends.
* MLP: with the reference's fitted params carried over (through a bundle,
  or directly), the port's f32 forward agrees within ``rtol=1e-5,
  atol=1e-6`` of the reference's; a 3-epoch fit from the reference's
  initial weights, on the reference's batches, agrees within ``rtol=1e-5,
  atol=1e-6`` with every Table-I optimiser (autograd and XLA sum the
  gradients in other orders; the parameters drift by at most 6e-8 and the
  predictions by 2e-7 here).
* Bundles round-trip in both directions, and both families lower to
  array form (``oracle.lowered``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import costs as rco
from repro.core import decisions as rdec
from repro.core import offload as roff
from repro.core.predictors import linear as rlin
from repro.core.predictors import mlp as rmlp
from repro.core.predictors.persist import load_predictor as r_load
from repro.core.predictors.persist import save_predictor as r_save
from repro.hw import EDGE_DEVICES as R_DEVICES
from repro import configs as rconfigs

from repro_torch import configs as pconfigs
from repro_torch.core import costs as pco
from repro_torch.core import decisions as pdec
from repro_torch.core import offload as poff
from repro_torch.core.predictors import LinearRegressor
from repro_torch.core.predictors import linear as plin
from repro_torch.core.predictors import mlp as pmlp
from repro_torch.core.predictors.persist import load_predictor as p_load
from repro_torch.core.predictors.persist import save_predictor as p_save
from repro_torch.hw import EDGE_DEVICES as P_DEVICES
from repro_torch.oracle import lowered as plowered

CPU = "cpu"
MLP_RTOL, MLP_ATOL = 1e-5, 1e-6
FIT_RTOL, FIT_ATOL = 1e-5, 1e-6


def regression_data(seed, n=96, f=5, n_targets=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32) * rng.uniform(
        0.5, 20, size=f).astype(np.float32)
    w = rng.normal(size=(f, n_targets))
    y = np.tanh(x @ w / 10) + 0.05 * rng.normal(size=(n, n_targets))
    return x, y.astype(np.float32)


# --------------------------------------------------------------------------
# Ridge
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n_targets", [1, 3])
@pytest.mark.parametrize("alpha", [1.0, 1e-3])
def test_ridge_predictions_match_reference(n_targets, alpha):
    x, y = regression_data(n_targets, n_targets=n_targets)
    yy = y[:, 0] if n_targets == 1 else y
    ref = rlin.RidgeRegressor(alpha=alpha).fit(x, yy)
    port = plin.RidgeRegressor(alpha=alpha).fit(x, yy, device=CPU)
    got = port.predict(x, device=CPU)
    assert got.dtype == torch.float64
    assert got.shape == ref.predict(x).shape
    np.testing.assert_allclose(got.numpy(), ref.predict(x), rtol=1e-12,
                               atol=1e-12)
    for k in ("x_mu_", "x_sd_", "w_"):
        np.testing.assert_allclose(getattr(port, k), getattr(ref, k),
                                   rtol=1e-12, atol=1e-13)
    assert LinearRegressor is plin.RidgeRegressor


def layer_training_set(configs, offload, costs, devices):
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
def decision_case():
    x, y = layer_training_set(rconfigs, roff, rco, R_DEVICES)
    rlayers = roff.transformer_layer_costs(
        rconfigs.reduced_config("qwen3-1.7b"), 4096, 1)
    players = poff.transformer_layer_costs(
        pconfigs.reduced_config("qwen3-1.7b"), 4096, 1)
    bw = np.geomspace(1e5, 1e10, 64)
    renvs = rdec.make_envs(R_DEVICES["pi5-arm"],
                           R_DEVICES["edge-server-a100"], link_bw=bw,
                           input_bytes=4 * 4096 * 256)
    penvs = pdec.make_envs(P_DEVICES["pi5-arm"],
                           P_DEVICES["edge-server-a100"], link_bw=bw,
                           input_bytes=4 * 4096 * 256, device=CPU)
    return x, y, (rlayers, renvs), (players, penvs)


def decide_both(rmodel, pmodel, case, backend):
    _, _, (rlayers, renvs), (players, penvs) = case
    rcost = rco.PredictorCost(rmodel, R_DEVICES["pi5-arm"],
                              R_DEVICES["edge-server-a100"])
    pcost = pco.PredictorCost(pmodel, P_DEVICES["pi5-arm"],
                              P_DEVICES["edge-server-a100"])
    ref = rdec.decide_all(rlayers, renvs, cost=rcost, backend="numpy")
    got = pdec.decide_all(players, penvs, cost=pcost, backend=backend,
                          device=CPU)
    return ref, got


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_ridge_decide_all_matches_reference_splits(decision_case, backend):
    x, y = decision_case[:2]
    rmodel = rlin.RidgeRegressor().fit(x, y)
    pmodel = plin.RidgeRegressor().fit(x, y, device=CPU)
    ref, got = decide_both(rmodel, pmodel, decision_case, backend)
    assert np.array_equal(got.splits.numpy(), ref.splits)
    np.testing.assert_allclose(got.total_time_s.numpy(), ref.total_time_s,
                               rtol=1e-10 if backend == "torch" else 1e-5)
    assert len(np.unique(ref.splits)) > 1


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_mlp_decide_all_runs_and_matches_reference(decision_case, backend):
    x, y = decision_case[:2]
    rmodel = rmlp.MLPRegressor(hidden=(16, 8), epochs=2, seed=3).fit(x, y)
    pmodel = carried_mlp(rmodel)
    ref, got = decide_both(rmodel, pmodel, decision_case, backend)
    # f32 forwards agree to ~1e-6: the same splits on this sweep, and the
    # chosen costs within f32 tolerance of the reference's
    assert np.array_equal(got.splits.numpy(), ref.splits)
    np.testing.assert_allclose(got.total_time_s.numpy(), ref.total_time_s,
                               rtol=1e-5)


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------
def carried_mlp(ref):
    """A port MLP holding the reference's fitted params and statistics."""
    port = pmlp.MLPRegressor(hidden=ref.hidden, lr=ref.lr,
                             optimiser=ref.optimiser, epochs=ref.epochs,
                             batch_size=ref.batch_size, seed=ref.seed,
                             standardize=ref.standardize)
    port.params_ = {k: torch.tensor(np.asarray(v))
                    for k, v in ref.params_.items()}
    port.n_layers_ = ref.n_layers_
    if ref.standardize:
        port.x_mu_, port.x_sd_ = ref.x_mu_, ref.x_sd_
        port.y_mu_, port.y_sd_ = ref.y_mu_, ref.y_sd_
    return port


@pytest.mark.parametrize("standardize", [True, False])
def test_mlp_predictions_from_reference_params(standardize):
    x, y = regression_data(5)
    ref = rmlp.MLPRegressor(hidden=(32, 16), epochs=3,
                            standardize=standardize).fit(x, y)
    port = carried_mlp(ref)
    got = port.predict(x, device=CPU)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref.predict(x), rtol=MLP_RTOL,
                               atol=MLP_ATOL)
    assert port.param_count() == ref.param_count()


@pytest.mark.parametrize("optimiser", ["adam", "sgd", "rmsprop", "adagrad"])
def test_mlp_fit_from_the_reference_init_matches(optimiser):
    x, y = regression_data(6)
    kw = dict(hidden=(16, 8), epochs=3, batch_size=32, lr=1e-2,
              optimiser=optimiser, seed=4)
    ref = rmlp.MLPRegressor(**kw).fit(x, y)
    port = pmlp.MLPRegressor(**kw)
    init = {k: torch.tensor(np.asarray(v))
            for k, v in ref._init(x.shape[1], y.shape[1]).items()}
    port._init = lambda f_in, f_out: {k: v.clone() for k, v in init.items()}
    port.fit(x, y, device=CPU)
    for k in ("x_mu_", "x_sd_", "y_mu_", "y_sd_"):
        assert np.array_equal(getattr(port, k), getattr(ref, k)), k
    for k, v in ref.params_.items():
        np.testing.assert_allclose(port.params_[k].numpy(), v,
                                   rtol=FIT_RTOL, atol=FIT_ATOL, err_msg=k)
        # the fit moved every weight matrix away from the initial draw
        if k.startswith("w"):
            assert not np.allclose(v, init[k].numpy())
    np.testing.assert_allclose(port.predict(x, device=CPU).numpy(),
                               ref.predict(x), rtol=FIT_RTOL, atol=FIT_ATOL)


def test_mlp_init_is_seeded_truncated_fan_in_and_device_free():
    a = pmlp.MLPRegressor(hidden=(64, 32), seed=7)._init(20, 3)
    b = pmlp.MLPRegressor(hidden=(64, 32), seed=7)._init(20, 3)
    c = pmlp.MLPRegressor(hidden=(64, 32), seed=8)._init(20, 3)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["w0"], c["w0"])
    assert {k: tuple(v.shape) for k, v in a.items()} == {
        "w0": (20, 64), "b0": (64,), "w1": (64, 32), "b1": (32,),
        "w2": (32, 3), "b2": (3,)}
    for k, fan_in in (("w0", 20), ("w1", 64), ("w2", 32)):
        assert float(a[k].abs().max()) <= 2.0 * fan_in ** -0.5
    assert all(not a[f"b{i}"].any() for i in range(3))
    assert pmlp.SIZE_PRESETS == rmlp.SIZE_PRESETS


def test_mlp_fit_trains_on_the_reference_batches():
    """One epoch of plain SGD on a linear model is a sum over the epoch's
    batches: the port's parameters agree with the same update made by hand
    from the reference's ``batches``."""
    from repro.data.synthetic import batches as r_batches
    x, y = regression_data(9, n=70, n_targets=1)
    port = pmlp.MLPRegressor(hidden=(), epochs=1, batch_size=16, lr=0.1,
                             optimiser="sgd", seed=2, standardize=False)
    port.fit(x, y, device=CPU)
    w = port._init(x.shape[1], 1)
    w, b = w["w0"].double().numpy(), w["b0"].double().numpy()
    for bx, by in r_batches(x, y, 16, seed=2):
        err = bx @ w + b - by
        w = w - 0.1 * 2 * bx.T @ err / err.size
        b = b - 0.1 * 2 * err.sum(0) / err.size
    np.testing.assert_allclose(port.params_["w0"].numpy(), w, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(port.params_["b0"].numpy(), b, rtol=1e-4,
                               atol=1e-5)


def test_mlp_spread_measures_see_a_one_percent_learning_rate():
    """The card-vs-CPU measures of ``bench.mlp_spread``: the CPU against
    itself drifts by exactly 0; one full-batch step whose lr differs by 1%
    moves the median displacement by 0.01/1.01 (within 1e-3), far above
    the card check's 1e-5; two epochs see the same change too."""
    from repro_torch.bench.mlp_spread import one_step_drift, two_epoch_drift
    x, y = regression_data(11, n=96, n_targets=2)
    small = dict(hidden=(32, 16))
    assert one_step_drift(x, y, device=CPU, **small) == 0.0
    assert two_epoch_drift(x, y, x[:20], device=CPU, **small) == 0.0
    step = one_step_drift(x, y, device=CPU, lr_cpu=1.01e-3, **small)
    assert abs(step - 0.01 / 1.01) < 1e-3
    assert two_epoch_drift(x, y, x[:20], device=CPU, lr_cpu=1.01e-3,
                           **small) > 1e-4


# --------------------------------------------------------------------------
# Persistence and lowering
# --------------------------------------------------------------------------
@pytest.mark.parametrize("family", ["ridge", "mlp"])
def test_bundles_round_trip_both_ways(tmp_path, family):
    x, y = regression_data(11)
    if family == "ridge":
        ref = rlin.RidgeRegressor(alpha=0.5).fit(x, y)
        port_fit = plin.RidgeRegressor(alpha=0.5).fit(x, y, device=CPU)
        rtol, atol = 1e-12, 1e-12      # the same f64 arrays, two BLASes
    else:
        ref = rmlp.MLPRegressor(hidden=(16, 8), epochs=2).fit(x, y)
        port_fit = pmlp.MLPRegressor(hidden=(16, 8), epochs=2).fit(
            x, y, device=CPU)
        rtol, atol = MLP_RTOL, MLP_ATOL
    # the reference's bundle loads into the port
    r_save(ref, str(tmp_path / "ref"))
    port = p_load(str(tmp_path / "ref"))
    assert type(port).__name__ == type(ref).__name__
    np.testing.assert_allclose(port.predict(x, device=CPU).numpy(),
                               ref.predict(x), rtol=rtol, atol=atol)
    # and the port's own fit, saved by the port, loads into the reference
    p_save(port_fit, str(tmp_path / "port"))
    back = r_load(str(tmp_path / "port"))
    assert type(back).__name__ == type(port_fit).__name__
    np.testing.assert_allclose(back.predict(x),
                               port_fit.predict(x, device=CPU).numpy(),
                               rtol=rtol, atol=atol)
    if family == "mlp":
        assert back.hidden == (16, 8)
        assert back.param_count() == port_fit.param_count()


@pytest.mark.parametrize("family", ["ridge", "mlp"])
def test_lowered_predictor_equals_host_predict(family):
    x, y = regression_data(12, n_targets=3)
    if family == "ridge":
        model = plin.RidgeRegressor().fit(x, y, device=CPU)
        cls = plowered.LoweredLinear
    else:
        model = pmlp.MLPRegressor(hidden=(16,), epochs=2).fit(x, y,
                                                              device=CPU)
        cls = plowered.LoweredMLP
    low = plowered.lower_predictor(model)
    assert isinstance(low, cls)
    assert plowered.lower_predictor(model) is low
    got = low.predict(x, device=CPU)
    assert got.dtype == torch.float64 and got.shape == (len(x), 3)
    assert torch.equal(got, model.predict(x, device=CPU).double())


def test_mlp_fit_and_predict_need_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y = regression_data(13)
    for model in (pmlp.MLPRegressor(hidden=(4,), epochs=1),
                  plin.RidgeRegressor()):
        with pytest.raises(RuntimeError, match="device=None means cuda"):
            model.fit(x, y)
        model.fit(x, y, device=CPU)
        with pytest.raises(RuntimeError, match="device=None means cuda"):
            model.predict(x)
        with pytest.raises(RuntimeError, match="device=None means cuda"):
            plowered.lower_predictor(model).predict(x)
