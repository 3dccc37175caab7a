"""The port's profiling loop against the JAX package's: the Table-I grid
and data, the six workload networks, the profiler, the features and the
dataset.

* Bit for bit: ``full_grid``/``sample_grid``, ``synthetic_image_data``,
  ``TabularDataset.split``/``normalised`` and ``batches``, ``featurize``,
  ``records_to_dataset``, ``project_hardware`` and the records' JSON.
* The six networks, with the reference's initial weights carried over by
  ``workload_params_from_jax``: logits within 1e-5 of max |logit|, the
  loss within 1e-5 relative, the accuracy equal.
* ``profile_workload(device="cpu")``: the reference's schema and
  ``param_count``; FLOPs a step from ``FlopCounterMode`` within
  [0.8, 1.15]× XLA's ``cost_analysis`` count (it counts the products only,
  XLA the elementwise and optimiser ops too; measured 0.83–1.12 over
  Table I's networks, optimisers and batch sizes).
"""
import dataclasses
import json
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.core import dataset as rds
from repro.core import features as rfeat
from repro.core import profiler as rprof
from repro.core import workloads as rwl
from repro.data import synthetic as rsyn

from repro_torch.core import dataset as pds
from repro_torch.core import features as pfeat
from repro_torch.core import profiler as pprof
from repro_torch.core import workloads as pwl
from repro_torch.data import synthetic as psyn

CPU = "cpu"
FLOP_BAND = (0.8, 1.15)
ARCHS = [(k, i) for k in ("mlp", "cnn") for i in range(3)]


def port_wc(wc):
    return pwl.WorkloadConfig(**dataclasses.asdict(wc))


# --------------------------------------------------------------------------
# Grid, data and tabular helpers: bit for bit
# --------------------------------------------------------------------------
def test_grid_constants_and_full_grid_match_reference():
    for name in ("IMG", "NCLASS", "CNN_TYPES", "MLP_TYPES", "EPOCHS",
                 "OPTIMISERS", "LEARNING_RATES", "BATCH_SIZES"):
        assert getattr(pwl, name) == getattr(rwl, name), name
    ref, port = list(rwl.full_grid()), list(pwl.full_grid())
    assert len(port) == 2304
    assert [dataclasses.asdict(w) for w in port] == \
        [dataclasses.asdict(w) for w in ref]
    assert [w.label() for w in port] == [w.label() for w in ref]
    assert [w.arch for w in port] == [w.arch for w in ref]


@pytest.mark.parametrize("n,seed", [(1, 0), (12, 3), (150, 0), (5000, 1)])
def test_sample_grid_matches_reference(n, seed):
    assert [w.label() for w in pwl.sample_grid(n, seed)] == \
        [w.label() for w in rwl.sample_grid(n, seed)]


@pytest.mark.parametrize("n,seed", [(0, 0), (7, 1), (64, 5)])
def test_synthetic_image_data_bit_for_bit(n, seed):
    rx, ry = rwl.synthetic_image_data(n, seed)
    px, py = pwl.synthetic_image_data(n, seed)
    assert px.dtype == rx.dtype and py.dtype == ry.dtype
    assert np.array_equal(px, rx) and np.array_equal(py, ry)


def test_tabular_dataset_and_batches_bit_for_bit():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(53, 4)).astype(np.float32)
    x[:, 2] = 3.0                                   # a constant column
    y = rng.uniform(size=(53, 2)).astype(np.float32)
    names = (["a", "b", "c", "d"], ["t0", "t1"])
    r, p = rsyn.TabularDataset(x, y, *names), psyn.TabularDataset(x, y,
                                                                  *names)
    for frac, seed in ((0.8, 0), (0.5, 7)):
        for rs, ps in zip(r.split(frac, seed), p.split(frac, seed)):
            assert np.array_equal(rs.x, ps.x) and np.array_equal(rs.y, ps.y)
    (rn, (rxs, rys)), (pn, (pxs, pys)) = r.normalised(), p.normalised()
    assert np.array_equal(rn.x, pn.x) and np.array_equal(rn.y, pn.y)
    for a, b in zip((*rxs, *rys), (*pxs, *pys)):
        assert np.array_equal(a, b)
    for bs, seed in ((8, 0), (53, 1), (60, 2)):
        rb = list(rsyn.batches(x, y, bs, seed))
        pb = list(psyn.batches(x, y, bs, seed))
        assert len(rb) == len(pb)
        for (rx_, ry_), (px_, py_) in zip(rb, pb):
            assert np.array_equal(rx_, px_) and np.array_equal(ry_, py_)


# --------------------------------------------------------------------------
# The six Table-I networks
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kind,ti", ARCHS)
def test_workload_forward_loss_and_accuracy_match_reference(kind, ti):
    wc = rwl.WorkloadConfig(kind, ti, 5, "adam", 0.01, 16, dataset_size=32)
    params = jax.device_get(rwl.init_workload_params(wc, jax.random.key(3)))
    x, y = rwl.synthetic_image_data(32, seed=4)
    if kind == "mlp":
        x = x.reshape(32, -1)                 # both layouts are accepted
    r_logits = np.asarray(rwl.workload_forward(params, jnp.asarray(x), wc))
    r_loss, r_acc = rwl.workload_loss(
        params, {"x": jnp.asarray(x), "y": jnp.asarray(y)}, wc)

    model = pwl.init_workload(port_wc(wc), seed=0, device=CPU)
    model.load_state_dict(pwl.workload_params_from_jax(params, wc))
    batch = {"x": torch.as_tensor(x), "y": torch.as_tensor(y)}
    with torch.no_grad():
        p_logits = model(batch["x"]).numpy()
        p_loss, p_acc = pwl.workload_loss(model, batch)
    scale = np.abs(r_logits).max()
    assert np.abs(p_logits - r_logits).max() <= 1e-5 * scale
    np.testing.assert_allclose(float(p_loss), float(r_loss), rtol=1e-5)
    assert float(p_acc) == float(r_acc)
    # the same parameter count, and the state dict covers every parameter
    assert sum(p.numel() for p in model.parameters()) == \
        sum(int(np.prod(v.shape)) for v in params.values())


def test_cnn_head_flattens_in_nhwc_order():
    """A head whose first logit weighs each position of the last feature
    map by its NHWC index gives the reference's logit; the same head read
    in NCHW order gives another."""
    wc = rwl.WorkloadConfig("cnn", 0, 5, "sgd", 0.01, 16)
    params = jax.device_get(rwl.init_workload_params(wc, jax.random.key(0)))
    head = np.zeros_like(params["head_w"])
    head[:, 0] = np.arange(len(head)) / len(head)
    params = {**params, "head_w": head}
    x, _ = rwl.synthetic_image_data(2, seed=1)
    want = np.asarray(rwl.workload_forward(params, jnp.asarray(x), wc))
    state = pwl.workload_params_from_jax(params, wc)
    model = pwl.init_workload(port_wc(wc), device=CPU)
    model.load_state_dict(state)
    with torch.no_grad():
        got = model(torch.as_tensor(x)).numpy()
        # the head's rows taken as an NCHW flatten (channel 32, 14 x 14)
        state["head.weight"] = state["head.weight"].reshape(
            10, 14, 14, 32).permute(0, 3, 1, 2).reshape(10, -1)
        model.load_state_dict(state)
        other = model(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.abs(other[:, 0] - want[:, 0]).min() > 1e-3 * np.abs(
        want[:, 0]).max()


def test_workload_init_is_seeded_and_leaves_the_global_rng_alone():
    wc = pwl.WorkloadConfig("cnn", 1, 5, "adam", 0.01, 16)
    state = torch.get_rng_state()
    a = pwl.init_workload(wc, seed=5, device=CPU).state_dict()
    b = pwl.init_workload(wc, seed=5, device=CPU).state_dict()
    assert torch.equal(torch.get_rng_state(), state)
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = pwl.init_workload(wc, seed=6, device=CPU).state_dict()
    assert not torch.equal(a["convs.0.weight"], c["convs.0.weight"])
    # truncated-normal fan-in: |w| <= 2 / sqrt(k*k*c_in) for the first conv
    assert float(a["convs.0.weight"].abs().max()) <= 2.0 / 5.0


# --------------------------------------------------------------------------
# Features, dataset, records
# --------------------------------------------------------------------------
def records_pair(n=6):
    """The same made-up records in both packages (the measured fields are
    numbers from a seed, so the two sides are identical)."""
    rng = np.random.default_rng(8)
    pairs = []
    for rw in rwl.sample_grid(n, seed=2):
        vals = dict(flops_per_step=float(rng.uniform(1e6, 1e9)),
                    total_time_s=float(rng.uniform(0.1, 50)),
                    step_time_s=float(rng.uniform(1e-4, 1e-2)),
                    peak_bytes=float(rng.uniform(1e5, 1e8)),
                    param_count=int(rng.integers(5e4, 3e5)),
                    final_loss=float(rng.uniform(0.5, 3)),
                    final_acc=float(rng.uniform(0, 1)))
        vals["macs_per_step"] = vals["flops_per_step"] / 2
        common = dict(label=rw.label(), kind=rw.kind,
                      config=dataclasses.asdict(rw),
                      hardware=rprof.get_device("xps15-i5").as_features(),
                      **vals)
        pairs.append((rprof.ProfileRecord(**common),
                      pprof.ProfileRecord(**json.loads(json.dumps(common)))))
    r, p = zip(*pairs)
    return list(r), list(p)


def test_feature_names_and_featurize_bit_for_bit():
    assert pfeat.FEATURE_NAMES == rfeat.FEATURE_NAMES
    assert pfeat.TARGET_NAMES == rfeat.TARGET_NAMES
    assert pfeat.EXTENDED_TARGET_NAMES == rfeat.EXTENDED_TARGET_NAMES
    rrecs, precs = records_pair()
    for r, p in zip(rrecs + rds.project_hardware(rrecs),
                    precs + pds.project_hardware(precs)):
        f = pfeat.featurize(p)
        assert f.dtype == np.float32
        assert np.array_equal(f, rfeat.featurize(r))
        for t in (None, ["total_time", "peak_bytes"],
                  pfeat.EXTENDED_TARGET_NAMES):
            assert np.array_equal(pfeat.targets_of(p, t),
                                  rfeat.targets_of(r, t))
    with pytest.raises(KeyError, match="unknown target"):
        pfeat.targets_of(precs[0], ["energy"])


@pytest.mark.parametrize("targets", [None, ["step_time", "flops"]])
def test_records_to_dataset_bit_for_bit(targets):
    rrecs, precs = records_pair()
    rd = rfeat.records_to_dataset(rrecs + rds.project_hardware(rrecs),
                                  targets)
    pd_ = pfeat.records_to_dataset(precs + pds.project_hardware(precs),
                                   targets)
    assert isinstance(pd_, psyn.TabularDataset)
    assert np.array_equal(pd_.x, rd.x) and np.array_equal(pd_.y, rd.y)
    assert pd_.feature_names == rd.feature_names
    assert pd_.target_names == rd.target_names


def test_project_hardware_and_records_json_bit_for_bit(tmp_path):
    rrecs, precs = records_pair(4)
    rproj, pproj = rds.project_hardware(rrecs), pds.project_hardware(precs)
    assert len(pproj) == 4 * 4
    assert [dataclasses.asdict(r) for r in rproj] == \
        [dataclasses.asdict(p) for p in pproj]
    rds.save_records(rrecs + rproj, str(tmp_path / "ref.json"))
    pds.save_records(precs + pproj, str(tmp_path / "port.json"))
    assert (tmp_path / "ref.json").read_bytes() == \
        (tmp_path / "port.json").read_bytes()
    # each package reads the other's file
    back_p = pds.load_records(str(tmp_path / "ref.json"))
    back_r = rds.load_records(str(tmp_path / "port.json"))
    assert [dataclasses.asdict(r) for r in back_p] == \
        [dataclasses.asdict(r) for r in back_r]
    assert all(isinstance(r, pprof.ProfileRecord) for r in back_p)


# --------------------------------------------------------------------------
# The profiler and the dataset generator on the CPU
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference_costs():
    """XLA's count of one step of each network at batch 16 with a Table-I
    optimiser each (the reference's analytic probe: compile, no run)."""
    out = {}
    for (kind, ti), opt in zip(ARCHS, ["adam", "sgd", "rmsprop", "adagrad",
                                       "adam", "sgd"]):
        wc = rwl.WorkloadConfig(kind, ti, 5, opt, 0.005, 16,
                                dataset_size=64)
        out[kind, ti] = (wc, rprof.profile_workload(wc, measure=False))
    return out


@pytest.mark.parametrize("kind,ti", ARCHS)
def test_profile_workload_on_the_cpu(reference_costs, kind, ti):
    wc, ref = reference_costs[kind, ti]
    rec = pprof.profile_workload(port_wc(wc), max_steps=2, device=CPU)
    assert [f.name for f in dataclasses.fields(rec)] == \
        [f.name for f in dataclasses.fields(ref)]
    assert (rec.label, rec.kind, rec.config, rec.hardware) == \
        (ref.label, ref.kind, ref.config, ref.hardware)
    assert rec.param_count == ref.param_count
    ratio = rec.flops_per_step / ref.flops_per_step
    assert FLOP_BAND[0] <= ratio <= FLOP_BAND[1], ratio
    assert rec.macs_per_step == rec.flops_per_step / 2
    planned = wc.epochs * max(wc.dataset_size // wc.batch_size, 1)
    assert rec.step_time_s > 0
    assert rec.total_time_s == pytest.approx(rec.step_time_s * planned,
                                             rel=1e-12)
    assert math.isfinite(rec.final_loss) and 0 <= rec.final_acc <= 1
    assert math.isfinite(rec.peak_bytes) and rec.peak_bytes > 0
    assert all(v > 0 and math.isfinite(v) for v in rec.targets(True).values())


def test_peak_bytes_stand_in_rises_with_batch_size():
    peaks = [pprof.profile_workload(
        pwl.WorkloadConfig("cnn", 0, 5, "adam", 0.01, bs, dataset_size=128),
        max_steps=1, device=CPU).peak_bytes for bs in (16, 32, 64)]
    assert peaks[0] < peaks[1] < peaks[2]


def test_analytic_probe_is_the_spec_roofline():
    from repro_torch.hw import get_device
    spec = get_device("pi5-arm")
    wc = pwl.WorkloadConfig("mlp", 1, 10, "sgd", 0.01, 32, dataset_size=64)
    rec = pprof.profile_workload(wc, spec=spec, measure=False, device=CPU)
    assert math.isnan(rec.final_loss) and math.isnan(rec.final_acc)
    assert rec.hardware == spec.as_features()
    # compute-bound on this spec: FLOPs over its f32 peak
    assert rec.step_time_s >= rec.flops_per_step / spec.peak_flops_f32
    assert rec.total_time_s == pytest.approx(rec.step_time_s * 10 * 2)


def test_generate_on_the_cpu():
    records, data = pds.generate(n_runs=4, max_steps=2, device=CPU)
    assert len(records) == 4 * 5
    measured = [r for r in records if "@" not in r.label]
    assert [r.label for r in measured] == \
        [w.label() for w in rwl.sample_grid(4, 0)]
    assert data.x.shape == (20, len(rfeat.FEATURE_NAMES))
    assert data.y.shape == (20, 3)
    assert np.isfinite(data.y).all() and (data.y > 0).all()
    rd = rfeat.records_to_dataset(
        [rprof.ProfileRecord(**dataclasses.asdict(r)) for r in records])
    assert np.array_equal(rd.x, data.x) and np.array_equal(rd.y, data.y)


def test_true_f32_switches_tf32_off_and_restores_it():
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = [f.allow_tf32 for f in flags]
    try:
        for f in flags:
            f.allow_tf32 = True
        with pprof.true_f32():
            assert [f.allow_tf32 for f in flags] == [False, False]
        assert [f.allow_tf32 for f in flags] == [True, True]
        with pytest.raises(ZeroDivisionError):
            with pprof.true_f32():
                1 / 0
        assert [f.allow_tf32 for f in flags] == [True, True]
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v


def test_profiling_entry_points_need_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wc = pwl.WorkloadConfig("mlp", 0, 5, "sgd", 0.01, 16, dataset_size=32)
    for call in (lambda: pprof.profile_workload(wc),
                 lambda: pds.generate(n_runs=1, max_steps=1),
                 lambda: pwl.init_workload(wc)):
        with pytest.raises(RuntimeError, match="device=None means cuda"):
            call()
