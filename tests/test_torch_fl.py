"""The port's federated profiling (paper §II-B) on the CPU: ``tests/
test_fl.py``'s four tests on the port, then the port against the JAX
package — the client splits and DP arithmetic exactly or to f32, and the
FedAvg round history from the reference MLP's initial weights (the port
draws its own from ``torch.Generator``, so the test hands the reference's
to the port's model)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fl as r_fl
from repro.core.predictors.mlp import MLPRegressor as RMLP

from repro_torch.core import fl
from repro_torch.core.predictors.mlp import MLPRegressor

CPU = torch.device("cpu")
# f32 FedAvg in other orders of summation from the same initial weights:
# each round's federated RMSE within 1e-5 relative (measured 1e-7 without
# DP, 5e-7 with it), the final weights within 1e-4 of their largest
# magnitude
HISTORY_TOL, PARAM_TOL = 1e-5, 1e-4


def _toy(n=400, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, size=(n, 6)).astype(np.float32)
    y = (np.sin(2 * x[:, 0]) + x[:, 1] * x[:, 2])[:, None].astype(np.float32)
    return x, y


# -- tests/test_fl.py on the port ------------------------------------------
def test_split_clients_partitions_everything():
    x, y = _toy()
    clients = fl.split_clients(x, y, 5)
    assert len(clients) == 5
    assert sum(len(c.x) for c in clients) == len(x)


def test_fedavg_learns():
    x, y = _toy(600)
    clients = fl.split_clients(x[:480], y[:480], 4)
    cfg = fl.FedAvgConfig(rounds=10, local_epochs=2, lr=3e-3,
                          hidden=(32, 16))
    res = fl.run_fedavg(clients, cfg, central_test=(x[480:], y[480:]),
                        device=CPU)
    hist = [h["federated_rmse"] for h in res.round_history]
    assert hist[-1] < hist[0] * 0.7, hist
    assert res.centralised_rmse is not None and res.centralised_rmse < 1.0


def test_fedavg_with_dp_still_learns_but_noisier():
    x, y = _toy(600, seed=1)
    clients = fl.split_clients(x[:480], y[:480], 4)
    plain = fl.run_fedavg(clients, fl.FedAvgConfig(
        rounds=8, hidden=(32, 16), lr=3e-3), device=CPU)
    dp = fl.run_fedavg(clients, fl.FedAvgConfig(
        rounds=8, hidden=(32, 16), lr=3e-3,
        dp=fl.DPConfig(epsilon=4.0, clip_norm=0.5)), device=CPU)
    assert dp.federated_rmse >= plain.federated_rmse * 0.5  # sanity
    # DP must cost accuracy (noise is really being added)
    assert dp.federated_rmse > plain.federated_rmse


def test_dp_clip_and_noise():
    tree = {"w": torch.ones((10, 10)) * 5.0}
    clipped = fl.clip_update(tree, 1.0)
    assert abs(fl.global_norm(clipped) - 1.0) < 1e-5
    rng = np.random.default_rng(0)
    cfg = fl.DPConfig(epsilon=1.0, delta=1e-5, clip_norm=1.0)
    noised = fl.privatise_update(tree, cfg, rng)
    assert float(noised["w"].std()) > 0.5 * cfg.sigma


# -- against the reference --------------------------------------------------
@pytest.mark.parametrize("n_clients,by", [(5, None), (3, "hw"), (4, "hw"),
                                          (2, "hw")])
def test_split_clients_equal_the_reference(n_clients, by):
    """IID shards, and non-IID ones by a hardware column (3 values: one
    shard each when there are at least as many values as clients, random
    shards otherwise), row for row."""
    x, y = _toy(300)
    col = np.random.default_rng(2).integers(0, 3, len(x)) if by else None
    want = r_fl.split_clients(x, y, n_clients, by=col, seed=4)
    got = fl.split_clients(x, y, n_clients, by=col, seed=4)
    assert [c.name for c in got] == [c.name for c in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.x, w.x)
        np.testing.assert_array_equal(g.y, w.y)
        for a, b in zip(g.splits(7), w.splits(7)):
            np.testing.assert_array_equal(a, b)


def test_dp_arithmetic_equals_the_reference():
    """``sigma``, ``global_norm``, ``clip_update`` and ``privatise_update``
    on the same tree and generator state: the noise is the reference's,
    drawn leaf by leaf in its (sorted-key) order."""
    rng = np.random.default_rng(0)
    tree = {"w1": rng.normal(size=(7, 3)), "b0": rng.normal(size=3),
            "w0": rng.normal(size=(4, 7)) * 3}
    tree = {k: v.astype(np.float32) for k, v in tree.items()}
    jt = {k: jnp.asarray(v) for k, v in tree.items()}
    tt = {k: torch.as_tensor(v) for k, v in tree.items()}
    cfg, rcfg = fl.DPConfig(epsilon=2.0, clip_norm=0.7), \
        r_fl.DPConfig(epsilon=2.0, clip_norm=0.7)
    assert cfg.sigma == rcfg.sigma
    np.testing.assert_allclose(fl.global_norm(tt), r_fl.global_norm(jt),
                               rtol=1e-6)
    for k, v in r_fl.clip_update(jt, 0.7).items():
        np.testing.assert_allclose(fl.clip_update(tt, 0.7)[k].numpy(),
                                   np.asarray(v), rtol=1e-6)
    want = r_fl.privatise_update(jt, rcfg, np.random.default_rng(9))
    got = fl.privatise_update(tt, cfg, np.random.default_rng(9))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6)


def _reference_init(monkeypatch, clients, cfg):
    """The reference MLP's initial weights for these clients, handed to
    the port's ``MLPRegressor``."""
    x = np.concatenate([c.x for c in clients])
    y = np.concatenate([c.y for c in clients])
    init = RMLP(hidden=cfg.hidden, lr=cfg.lr, optimiser=cfg.optimiser,
                epochs=0, seed=cfg.seed).fit(x, y).params_
    monkeypatch.setattr(MLPRegressor, "_init", lambda self, f_in, f_out: {
        k: torch.as_tensor(np.array(v)) for k, v in init.items()})


@pytest.mark.parametrize("dp", [False, True])
@pytest.mark.parametrize("optimiser", ["adam", "sgd"])
def test_fedavg_round_history_matches_the_reference(monkeypatch, dp,
                                                    optimiser):
    x, y = _toy(500, seed=3)
    hw = np.random.default_rng(5).integers(0, 3, 400)
    kw = dict(rounds=3, local_epochs=2, lr=3e-3, hidden=(32, 16),
              optimiser=optimiser)
    want = r_fl.run_fedavg(
        r_fl.split_clients(x[:400], y[:400], 3, by=hw),
        r_fl.FedAvgConfig(**kw, dp=r_fl.DPConfig(epsilon=50.0) if dp
                          else None), central_test=(x[400:], y[400:]))
    clients = fl.split_clients(x[:400], y[:400], 3, by=hw)
    cfg = fl.FedAvgConfig(**kw, dp=fl.DPConfig(epsilon=50.0) if dp
                          else None)
    _reference_init(monkeypatch, clients, cfg)
    got = fl.run_fedavg(clients, cfg, central_test=(x[400:], y[400:]),
                        device=CPU)
    assert [h["round"] for h in got.round_history] == [0, 1, 2]
    np.testing.assert_allclose(
        [h["federated_rmse"] for h in got.round_history],
        [h["federated_rmse"] for h in want.round_history], rtol=HISTORY_TOL)
    np.testing.assert_allclose(got.centralised_rmse, want.centralised_rmse,
                               rtol=HISTORY_TOL)
    for k, v in want.model.params_.items():
        v = np.asarray(v)
        np.testing.assert_allclose(got.model.params_[k].numpy(), v, rtol=0,
                                   atol=PARAM_TOL * np.abs(v).max())
