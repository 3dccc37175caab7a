"""The port's examples of the profiling, federated, serving and training
paths against the JAX package on the CPU, each at a small size:
``quickstart``, ``fl_profiling``, ``serve_batched`` and ``train_tiny_lm``.

Their data are measured (profiling runs) or sampled, so the steps are held
on inputs given to both packages:

- ``quickstart``: one profiling dataset (the port's ``generate`` at 8 runs)
  for both; the GBT's nodes for each target, its nRMSE, its prediction of
  one featurised record and the offload decision;
- ``fl_profiling``: the same dataset's client shards, then FedAvg with
  and without DP from the reference MLP's initial weights, within
  ``tests/test_torch_fl.py``'s tolerance;
- ``serve_batched``: the offload plan exactly, and the logits of each
  sampling step along the reference's sampled tokens (the port's sampler
  draws from a ``torch.Generator``, so its tokens cannot equal JAX's),
  from the reference's weights through ``params_from_jax``;
- ``train_tiny_lm``: the losses of its ``train()`` on the kernels' path
  (``impl="chunked"``) from converted initial weights, within
  ``tests/test_torch_train.py``'s tolerance of the reference's f32
  ``train()`` (its naive path), and the checkpoint round trip.
"""
import importlib
import json
import re

import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as r_reduced
from repro.core import fl as r_fl
from repro.core import offload as r_off
from repro.core.costs import CompositeCost as RCompositeCost
from repro.core.predictors import MultiTargetGBT as RMultiTargetGBT
from repro.core.predictors import per_target_nrmse as r_nrmse
from repro.core.predictors.mlp import MLPRegressor as RMLP
from repro.core.workloads import WorkloadConfig as RWorkloadConfig
from repro.data.synthetic import TabularDataset as RTabular
from repro.hw import get_device as r_get_device
from repro.kernels.tree_predict.ref import flatten_gbt as r_flatten
from repro.models import build_model as r_build
from repro.serve import ServeEngine as RServeEngine
from repro.train import TrainConfig as RTrainConfig
from repro.train import train as r_train

from repro_torch.configs import reduced_config as p_reduced
from repro_torch.core.dataset import generate
from repro_torch.core.features import featurize
from repro_torch.core.predictors.mlp import MLPRegressor
from repro_torch.core.profiler import profile_workload
from repro_torch.kernels.tree_predict.ref import flatten_gbt as p_flatten
from repro_torch.models.convert import params_from_jax
from repro_torch.train import loop as p_loop

CPU = torch.device("cpu")
TREE_FIELDS = ("feature", "threshold_bin", "left", "right", "value",
               "n_nodes", "edges")
# tests/test_torch_fl.py's: each round's federated RMSE within 1e-5
# relative of the reference's from the same initial weights
HISTORY_TOL = 1e-5
# tests/test_torch_train.py's: each step's loss within 1e-5 relative
LOSS_TOL = 1e-5
# tests/test_torch_serve.py's: f32 logits in other summation orders, within
# 1e-5 of the largest |logit| of the step
LOGIT_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny tensors: torch's CPU thread pool beside JAX's only contends
    (the port's GBT fits ran 2.5x slower with it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def example(name):
    return importlib.import_module(f"repro_torch.examples.{name}")


@pytest.fixture(scope="module")
def profiling():
    """One measured profiling dataset, handed to both packages: the port's
    records and dataset, and the same arrays as the reference's type."""
    records, data = generate(n_runs=8, max_steps=1, device=CPU)
    return records, data, RTabular(data.x.copy(), data.y.copy(),
                                   list(data.feature_names),
                                   list(data.target_names))


def test_quickstart_steps_match_the_reference(profiling):
    records, data, rdata = profiling
    qs = example("quickstart")
    model, (xs, ys), nrmse = qs.fit_profiler(data, CPU)

    norm, (rxs, rys) = rdata.normalised()
    tr, te = norm.split(0.8)
    ref = RMultiTargetGBT(n_trees=120, max_depth=8, subsample=0.8).fit(
        tr.x, tr.y)
    want = dict(zip(te.target_names,
                    r_nrmse(ref.predict(te.x), te.y).round(4)))
    assert np.array_equal(xs, rxs) and np.array_equal(ys, rys)
    assert len(model.models_) == len(ref.models_) == 3
    for rm, pm in zip(ref.models_, model.models_):
        a, b = r_flatten(rm), p_flatten(pm)
        for f in TREE_FIELDS:
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert nrmse == want

    # one featurised record (a measured one from the dataset's grid)
    feats = featurize(records[0])
    got = qs.predict_row(model, xs, ys, feats, CPU)
    x = (feats - rxs[0]) / rxs[1]
    np.testing.assert_allclose(got, ref.predict(x[None])[0] * rys[1]
                               + rys[0], rtol=1e-12)

    d, local, remote = qs.decide(qs.UNSEEN)
    wc = qs.UNSEEN
    rlayers = r_off.workload_layer_costs(RWorkloadConfig(
        wc.kind, wc.type_idx, epochs=wc.epochs, optimiser=wc.optimiser,
        lr=wc.lr, batch_size=wc.batch_size))
    env = r_off.OffloadEnv(device=r_get_device("pi5-arm"),
                           edge=r_get_device("edge-server-a100"),
                           link_bw=0.125e9, input_bytes=4 * 64 * 784)
    want_d = r_off.optimal_split(rlayers, env)
    assert (d.split, d.total_time_s) == (want_d.split, want_d.total_time_s)
    assert local.total_time_s == r_off.local_only(rlayers, env).total_time_s
    assert remote.total_time_s == r_off.remote_only(rlayers,
                                                    env).total_time_s


def test_quickstart_prints_its_lines(capsys, monkeypatch):
    qs = example("quickstart")
    real = qs.generate
    monkeypatch.setattr(qs, "generate", lambda **kw: real(
        **dict(kw, n_runs=4, max_steps=1)))
    monkeypatch.setattr(qs, "profile_workload", lambda wc, **kw: (
        profile_workload(wc, **dict(kw, max_steps=1))))
    qs.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[1] == "   20 records (4 measured, rest hardware-projected)"
    assert out[2].startswith("== GBT profiling model: nRMSE per target {")
    assert out[3] == f"== unseen workload {qs.UNSEEN.label()}:"
    assert [ln.split(":")[0].strip() for ln in out[4:7]] == [
        "flops", "macs", "total_time"]
    assert re.fullmatch(r"== offload decision: run layers \[0,\d+\) "
                        r"on-device, .* ms\)", out[7])


def test_fl_profiling_rounds_match_the_reference(profiling, monkeypatch):
    _, data, rdata = profiling
    flp = example("fl_profiling")
    monkeypatch.setattr(flp, "ROUNDS", 3)       # of 12, to keep it short
    clients, te = flp.shards(data)

    norm, _ = rdata.normalised()
    rtr, rte = norm.split(0.8)
    hw_col = norm.feature_names.index("log_hw_peak_flops")
    rclients = r_fl.split_clients(rtr.x, rtr.y, 5, by=rtr.x[:, hw_col])
    assert [len(c.x) for c in clients] == [len(c.x) for c in rclients]
    assert np.array_equal(te.x, rte.x)

    x = np.concatenate([c.x for c in clients])
    y = np.concatenate([c.y for c in clients])
    for (tag, dp), rdp in zip(flp.RUNS, (None, r_fl.DPConfig(
            epsilon=4.0, clip_norm=0.1))):
        rcfg = r_fl.FedAvgConfig(rounds=flp.ROUNDS, local_epochs=2,
                                 lr=2e-3, hidden=(64, 32), dp=rdp)
        init = RMLP(hidden=rcfg.hidden, lr=rcfg.lr,
                    optimiser=rcfg.optimiser, epochs=0,
                    seed=rcfg.seed).fit(x, y).params_
        monkeypatch.setattr(MLPRegressor, "_init", lambda self, f_in, f_out:
                            {k: torch.as_tensor(np.array(v))
                             for k, v in init.items()})
        want = r_fl.run_fedavg(rclients, rcfg, central_test=(rte.x, rte.y))
        got, nrmse = flp.federate(clients, te, dp, CPU)
        assert tag in ("FedAvg", "FedAvg+DP(ε=4)")
        np.testing.assert_allclose(
            [h["federated_rmse"] for h in got.round_history],
            [h["federated_rmse"] for h in want.round_history],
            rtol=HISTORY_TOL)
        want_nrmse = r_nrmse(np.asarray(want.model.predict(rte.x)),
                             rte.y).mean()
        np.testing.assert_allclose(nrmse, want_nrmse, rtol=1e-4)


@pytest.fixture(scope="module")
def served():
    """The example's engine on the reference's weights beside the
    reference's engine; the first 8 requests (two batches) through both,
    the port following the reference's sampled tokens."""
    sb = example("serve_batched")
    rcfg = r_reduced("qwen3-1.7b").replace(dtype="float32")
    ref = RServeEngine(rcfg, batch_size=4, max_len=128, cost=RCompositeCost(
        weights={"latency_s": 1.0, "energy_j": 0.1}, deadline_s=0.25))
    port = sb.build_engine(CPU)
    port.load_params(params_from_jax(
        port.cfg, jax.tree_util.tree_map(np.asarray, ref.params), CPU))
    steps = []                      # (reference logits, its tokens)
    sample = ref._sample

    def recording(logits, temperature, key):
        tok = sample(logits, temperature, key)
        steps.append((np.asarray(logits), np.asarray(tok)))
        return tok

    ref._sample = recording
    port_logits = []

    def following(logits, temperature, gen):
        port_logits.append(logits.numpy().copy())
        return torch.tensor(steps[len(port_logits) - 1][1]).long()

    port._sample = following
    from repro.serve import Request as RRequest
    reqs = sb.make_requests(port.cfg.vocab_size)[:8]
    done_r = ref.serve([RRequest(rid=r.rid, prompt=r.prompt,
                                 max_new_tokens=r.max_new_tokens,
                                 temperature=r.temperature,
                                 arrived_at=r.arrived_at) for r in reqs])
    done_p = port.serve(reqs)
    return sb, ref, port, steps, port_logits, done_r, done_p


def test_serve_batched_offload_plan_is_the_reference_plan(served):
    sb, ref, port = served[:3]
    rows = sb.offload(port)
    plan = ref.offload_plan(list(sb.LINK_BWS), seq_len=48,
                            device=r_get_device("jetson-orin-nano"),
                            edge=r_get_device("edge-server-a100"))
    for i, (bw, place, total, energy, slack) in enumerate(rows):
        d = plan[i]
        n = ref.cfg.num_layers
        assert place == ("edge" if d.split == 0 else "device"
                         if d.split == n else f"split@{d.split}")
        assert total == d.total_time_s
        assert energy == float(np.asarray(plan.objective("energy_j"))[i])
        assert slack == float(np.asarray(
            plan.objective("deadline_slack_s"))[i])


def test_serve_batched_logits_follow_the_reference(served):
    _, ref, port, steps, port_logits, done_r, done_p = served
    # two batches of 4, each prefill + 24 decode steps
    assert len(port_logits) == len(steps) == 2 * 25
    for (want, _), got in zip(steps, port_logits):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=LOGIT_TOL * np.abs(want).max())
    for r, p in zip(done_r, done_p):
        assert r.rid == p.rid
        assert np.array_equal(p.output, np.asarray(r.output))
    assert port.stats.tokens_out == ref.stats.tokens_out == 8 * 24


def test_serve_batched_prefill_logits_are_the_first_step(served):
    sb, _, port, steps = served[:4]
    reqs = sb.make_requests(port.cfg.vocab_size)[:8]
    got = sb.prefill_logits(port, reqs).numpy()
    want = steps[0][0]
    assert got.shape == want.shape == (port.batch_size, port.cfg.vocab_size)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LOGIT_TOL * np.abs(want).max())


def test_serve_batched_prints_its_lines(capsys):
    example("serve_batched").main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 7 and out[-1] == "[serve] OK"
    assert all(ln.startswith("[offload] link ") for ln in out[:3])
    assert out[3] == "[serve] completed 16 requests, 384 new tokens"


def test_train_tiny_lm_losses_match_the_reference(tmp_path, monkeypatch):
    tt = example("train_tiny_lm")
    rc = r_reduced("qwen3-1.7b").replace(dtype="float32")
    pc = p_reduced("qwen3-1.7b").replace(dtype="float32")
    rp = r_build(rc).init_params(jax.random.key(0))
    pp = params_from_jax(pc, jax.tree_util.tree_map(np.asarray, rp), CPU)
    tcfg = tt.train_config(8, 2, 16, str(tmp_path / "port"))
    want = r_train(rc, RTrainConfig(
        steps=8, batch_size=2, seq_len=16, lr=1e-3, log_every=25,
        ckpt_every=2, ckpt_dir=str(tmp_path / "ref")), params=rp)
    build, seen = p_loop.build_model, []
    monkeypatch.setattr(p_loop, "build_model", lambda cfg, impl: seen.append(
        impl) or build(cfg, impl=impl))
    got = tt.run(pc, tcfg, CPU, params=pp)
    assert seen == ["chunked"]
    np.testing.assert_allclose(got.losses, want.losses, rtol=LOSS_TOL)
    assert got.losses[-1] < got.losses[0]
    latest, meta, n = tt.round_trip(tcfg.ckpt_dir, got.final_params)
    assert latest.endswith("ckpt_6.npz") and meta == {"step": 6}
    assert n == sum(1 for _ in got.final_params.parameters())


def test_train_tiny_lm_prints_its_lines(capsys, tmp_path):
    # past TrainConfig's 20 warm-up steps, so that the loss falls
    losses = tmp_path / "losses.json"
    example("train_tiny_lm").main(["--device", "cpu", "--steps", "24",
                                   "--batch-size", "2", "--seq-len", "8",
                                   "--losses-out", str(losses)])
    out = capsys.readouterr().out.splitlines()
    kept = json.loads(losses.read_text())
    assert len(kept) == 24 and out[-3].startswith(
        f"[example] qwen3-1.7b-reduced: loss {kept[0]:.3f} -> "
        f"{kept[-1]:.3f} (")
    assert re.fullmatch(r"\[example\] qwen3-1.7b-reduced: loss [0-9.]+ -> "
                        r"[0-9.]+ \([0-9.]+ steps/s\)", out[-3]), out
    assert out[-2] == ("[example] checkpoint round-trip OK: ckpt_18.npz "
                       "(step 18)")
    assert re.fullmatch(r"\[example\] restored \d+ tensors", out[-1])
