"""The port's ``repro_torch.obs`` against the JAX package's ``repro.obs``,
on the CPU, case by case after ``tests/test_obs.py``.

Each case of the reference's file has its counterpart here, run on the
port and held to the reference: a traced run of either simulator engine
computes the untraced run's records, summary, counters and link state,
and its Chrome JSON is the text the reference's tracer writes for the
reference's run of the same stream; the same events fed to both tracers
give the same span and instant tuples, the same flight recorder and the
same Chrome JSON; the validator raises the reference's messages; the
registry, histograms and Prometheus text equal the reference's; and
``Telemetry``'s exports equal the reference's on the same stream.

Beyond the reference's file: the reference's ``Tracer.task_spans`` raises
where a zero service time rounds ``finished - transfer`` below
``started`` (its ``test_exported_lifecycles_well_formed`` fails on that);
the port ends the service span at ``started`` there.  Each port seam
(stream, queueing, Pareto, fleet slab path, oracle, both serving engines)
runs once untraced and once traced through a hook that hands every event
to a port tracer and a reference tracer alike: the records or tokens are
the untraced run's, and both tracers hold the same events.  Tensor
columns given to ``span_arrays`` come to the host once per column.
"""
import dataclasses
import json
import types

import numpy as np
import pytest
import torch
from hypothesis_shim import given, settings, st

from repro import obs as robs
from repro import sim as rsim
from repro.core import offload as roff
from repro.core import scheduler as rsch
from repro.core.workloads import WorkloadConfig as RWorkload
from repro.hw import EDGE_DEVICES as R_DEVICES
from repro.hw import get_device as r_get

from repro_torch import obs as pobs
from repro_torch import sim as psim
from repro_torch.core import offload as poff
from repro_torch.core import scheduler as psch
from repro_torch.core.workloads import WorkloadConfig as PWorkload
from repro_torch.hw import EDGE_DEVICES as P_DEVICES
from repro_torch.hw import get_device as p_get
from repro_torch.obs import (LATENCY_BOUNDARIES, NULL_TRACER, Histogram,
                             MetricsRegistry, NullTracer, Tracer,
                             validate_chrome)

CPU = "cpu"
SIDES = {
    "ref": types.SimpleNamespace(
        sim=rsim, sch=rsch, off=roff, workload=RWorkload, get=r_get,
        specs=list(R_DEVICES.values()), run_kw={}, dev_kw={}),
    "port": types.SimpleNamespace(
        sim=psim, sch=psch, off=poff, workload=PWorkload, get=p_get,
        specs=list(P_DEVICES.values()), run_kw={"device": CPU},
        dev_kw={"torch_device": CPU}),
}


def make_tasks(sch, n, seed=3):
    rng = np.random.default_rng(seed)
    return [sch.Task(f"t{i}", flops=float(rng.uniform(1e9, 5e11)),
                     input_bytes=float(rng.uniform(1e4, 1e7)),
                     deadline_s=float(rng.uniform(0.02, 2.0)))
            for i in range(n)]


def make_nodes(m, n):
    return [m.sch.Node(m.specs[j % len(m.specs)]) for j in range(n)]


def cnn_layers(m):
    return m.off.workload_layer_costs(m.workload(
        "cnn", 2, epochs=5, optimiser="adam", lr=1e-3, batch_size=32))


def run_stream(side, engine, obs, cfg, *, n_tasks=24, n_nodes=3, seed=5):
    """``tests/test_obs.py``'s ``run_stream`` on either package (fresh
    stateful processes every call) -> (Telemetry, end link bandwidths)."""
    m = SIDES[side]
    tasks = make_tasks(m.sch, n_tasks, seed=seed)
    arrivals = m.sim.poisson_arrivals(8.0, n=n_tasks, seed=seed)
    links = m.sim.ClusterLinks.random_walk(
        [40e6 + 5e6 * j for j in range(n_nodes)], sigma=0.4,
        seed=seed + 100)
    kw = dict(m.run_kw)
    if cfg == "links_planner":
        kw["split_planner"] = m.sim.ParetoStreamScheduler(**m.dev_kw)
        kw["split_env"] = m.sim.DriftingEnv(
            m.get("jetson-orin-nano"), m.get("edge-server-a100"),
            m.sim.TwoStateLink(80e6, 8e6, seed=seed + 7),
            input_bytes=2e6, **m.dev_kw)
        kw["split_layers"] = cnn_layers(m)
    elif cfg == "pools_rtt":
        kw["pools"] = m.sim.NodePools.uniform(n_nodes, 2)
        kw["rtt"] = m.sim.WeibullRTT(shape=0.7, scale=0.01, seed=seed + 9)
    else:
        raise ValueError(cfg)
    tel = m.sim.simulate_stream(tasks, arrivals, make_nodes(m, n_nodes),
                                policy="min_min", links=links,
                                link_update_dt=0.5, engine=engine,
                                obs=obs, **kw)
    return tel, links.values()


def rec_tuple(r):
    return (r.name, r.arrived_s, r.started_s, r.finished_s, r.node,
            r.node_id, r.deadline_s, r.energy_j, r.split, r.switches,
            r.transfer_s)


def events(tracer):
    """Span and instant tuples, whichever package's tracer."""
    return ([dataclasses.astuple(e) for e in tracer.all_spans()],
            [dataclasses.astuple(e) for e in tracer.all_instants()])


def chrome_text(tracer) -> str:
    return json.dumps(tracer.export_chrome(None), default=float)


class Both:
    """An ``obs=`` hook that hands every event of one run to a port tracer
    and to a reference tracer, so the two can be held equal on the same
    port run; the flight recorder is the port's."""
    enabled = True

    def __init__(self):
        self.port, self.ref = Tracer(), robs.Tracer()

    def __getattr__(self, name):
        def hook(*args, **kwargs):
            getattr(self.ref, name)(*args, **kwargs)
            return getattr(self.port, name)(*args, **kwargs)
        return hook

    def last(self, n=64):
        return self.port.last(n)


# --------------------------------------------------------------------------
# tracing perturbs nothing, in either engine, and writes the reference's
# trace
# --------------------------------------------------------------------------
@pytest.mark.parametrize("engine", ["event", "fleet"])
@pytest.mark.parametrize("cfg", ["links_planner", "pools_rtt"])
def test_tracing_zero_perturbation(engine, cfg):
    tel_off, links_off = run_stream("port", engine, None, cfg)
    both = Both()
    tel_on, links_on = run_stream("port", engine, both, cfg)
    assert [rec_tuple(r) for r in tel_on.records] \
        == [rec_tuple(r) for r in tel_off.records]
    assert tel_on.summary() == tel_off.summary()
    assert tel_on.counters == tel_off.counters
    np.testing.assert_array_equal(links_on, links_off)
    stats = validate_chrome(both.port.export_chrome(None))
    assert stats["n_spans"] >= 2 * len(tel_on.records)
    assert stats["n_instants"] >= 1
    # the reference's tracer on the same port run sees the same events
    assert events(both.port) == events(both.ref)
    # the reference's run of the same stream: the same Chrome JSON text
    ref = robs.Tracer()
    run_stream("ref", engine, ref, cfg)
    assert chrome_text(both.port) == chrome_text(ref)
    assert stats == robs.validate_chrome(ref.export_chrome(None))


@pytest.mark.parametrize("cfg", ["links_planner", "pools_rtt"])
def test_traced_event_fleet_equivalence(cfg):
    stats, tels = [], []
    for engine in ("event", "fleet"):
        tracer = Tracer()
        tel, _ = run_stream("port", engine, tracer, cfg)
        tels.append(tel)
        stats.append(validate_chrome(tracer.export_chrome(None)))
    assert [rec_tuple(r) for r in tels[0].records] \
        == [rec_tuple(r) for r in tels[1].records]
    assert stats[0] == stats[1]


def test_example_trace_file_roundtrip(tmp_path):
    tracer, ref = Tracer(), robs.Tracer()
    run_stream("port", "event", tracer, "links_planner")
    run_stream("ref", "event", ref, "links_planner")
    path = str(tmp_path / "trace.json")
    trace = tracer.export_chrome(path)
    assert trace["displayTimeUnit"] == "ms"
    with open(path) as f:
        on_disk = json.load(f)
    assert on_disk == json.loads(json.dumps(trace))
    assert validate_chrome(path) == validate_chrome(trace)
    meta = [e for e in on_disk["traceEvents"] if e["ph"] == "M"]
    assert {e["name"] for e in meta} == {"process_name"}
    names = {e["args"]["name"] for e in meta}
    assert "scheduler" in names
    assert any("@" in n for n in names)
    # the file is the reference's, byte for byte
    ref.export_chrome(str(tmp_path / "ref.json"))
    assert (tmp_path / "trace.json").read_bytes() == \
        (tmp_path / "ref.json").read_bytes()


# --------------------------------------------------------------------------
# property: any set of task lifecycles exports well-formed
# --------------------------------------------------------------------------
@given(data=st.data())
@settings(max_examples=60, deadline=None)
def test_exported_lifecycles_well_formed(data):
    """The reference's property on the port's tracer: every B matched by
    a LIFO E, children nested, per-track monotone timestamps — including
    where the reference's tracer raises (a zero service time that rounds
    ``finished - transfer`` below ``started``); wherever the reference
    accepts the lifecycles, the same spans and the same JSON."""
    pos = st.floats(0.0, 50.0, allow_nan=False, allow_infinity=False)
    tracer, ref = Tracer(), robs.Tracer()
    ref_ok = True
    n = data.draw(st.integers(1, 30), label="n_tasks")
    for i in range(n):
        track = f"node@{data.draw(st.integers(0, 3))}"
        arrived = data.draw(pos, label=f"arrived{i}")
        wait = data.draw(pos, label=f"wait{i}")
        service = data.draw(pos, label=f"service{i}")
        transfer = data.draw(pos, label=f"transfer{i}")
        life = (track, i, f"t{i}", arrived, arrived + wait,
                arrived + wait + service + transfer)
        tracer.task_spans(*life, transfer_s=transfer)
        try:
            ref.task_spans(*life, transfer_s=transfer)
        except ValueError:
            ref_ok = False
    for k in range(data.draw(st.integers(0, 8), label="n_instants")):
        ts = data.draw(pos, label=f"ts{k}")
        tracer.instant("scheduler", "replan", ts)
        ref.instant("scheduler", "replan", ts)
    stats = validate_chrome(tracer.export_chrome(None))
    assert stats["n_spans"] == len(tracer.all_spans())
    assert stats["n_instants"] == len(tracer.all_instants())
    if ref_ok:
        assert events(tracer) == events(ref)
        assert chrome_text(tracer) == chrome_text(ref)


# the reference's fault (ROADMAP §3): arrived 0, wait w, service 0,
# transfer x; finished - transfer rounds 7e-15 below started
FAULT_WAIT, FAULT_TRANSFER = 15.844593384656818, 49.128718932516044


def test_reference_task_spans_fault_is_repaired():
    started = 0.0 + FAULT_WAIT
    finished = started + 0.0 + FAULT_TRANSFER
    assert finished - FAULT_TRANSFER < started
    life = ("node@0", 0, "t0", 0.0, started, finished)
    ref = robs.Tracer()
    with pytest.raises(ValueError, match="ends before it starts"):
        ref.task_spans(*life, transfer_s=FAULT_TRANSFER)
    tracer = Tracer()
    tracer.task_spans(*life, transfer_s=FAULT_TRANSFER)
    assert [(s.name, s.t0, s.t1) for s in tracer.all_spans()] == [
        ("sojourn", 0.0, finished), ("queue_wait", 0.0, started),
        ("service", started, started), ("transfer", started, finished)]
    assert validate_chrome(tracer.export_chrome(None)) == {
        "n_events": 9, "n_spans": 4, "n_instants": 0, "n_tracks": 1}
    # the slab path takes the same lifecycle
    slab = Tracer()
    slab.span_arrays(["node@0"], [0], ["t0"], [0.0], [started], [finished],
                     transfer_s=[FAULT_TRANSFER])
    assert events(slab) == events(tracer)


# --------------------------------------------------------------------------
# the slab path: deferred columns, brought home once per column
# --------------------------------------------------------------------------
SLAB = dict(tracks=["a@0", "b@1", "a@0"], names=["t0", "t1", "t2"],
            tids=[0, 1, 2], arrived_s=[0.0, 0.5, 1.0],
            started_s=[0.1, 0.5, 1.4], finished_s=[0.9, 0.8, 2.0],
            transfer_s=[0.1, 0.0, 0.2])


def slab_cols(kind):
    """The slab's numeric columns as numpy arrays or f64/int64 tensors."""
    cols = dict(SLAB)
    for key in ("tids", "arrived_s", "started_s", "finished_s",
                "transfer_s"):
        if kind == "numpy":
            cols[key] = np.asarray(cols[key])
        elif kind == "tensor":
            cols[key] = torch.tensor(cols[key], dtype=torch.int64
                                     if key == "tids" else torch.float64)
    return cols


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_slab_ingestion_matches_per_event_path(kind):
    cols = slab_cols(kind)
    instants = np.array([0.0, 0.5]) if kind == "numpy" \
        else torch.tensor([0.0, 0.5], dtype=torch.float64)
    batch = np.array([2, 1]) if kind == "numpy" else torch.tensor([2, 1])
    batched, ref = Tracer(), robs.Tracer()
    for t in (batched, ref):
        t.span_arrays(**cols)
        t.instant_arrays("scheduler", "replan", instants,
                         args_cols={"batch": batch})
    loop = Tracer()
    for k in range(3):
        loop.task_spans(SLAB["tracks"][k], SLAB["tids"][k],
                        SLAB["names"][k], SLAB["arrived_s"][k],
                        SLAB["started_s"][k], SLAB["finished_s"][k],
                        transfer_s=SLAB["transfer_s"][k])
    for ts, b in ((0.0, 2), (0.5, 1)):
        loop.instant("scheduler", "replan", ts, args={"batch": b})
    assert len(batched) == 5
    assert batched._pending and not loop._pending
    assert batched.all_spans() == loop.all_spans()
    assert batched.all_instants() == loop.all_instants()
    assert len(batched) == len(loop)
    assert events(batched) == events(ref)
    # args come out as Python scalars, as .item() gives them
    assert all(type(i.args["batch"]) is int for i in batched.all_instants())


def test_span_arrays_brings_each_tensor_column_home_once(monkeypatch):
    """Five tensor columns and a tensor args column: six ``tolist`` calls
    at the first read, and no element read (no per-element sync)."""
    cols = slab_cols("tensor")
    deadline = torch.tensor([0.4, 0.5, 3.0], dtype=torch.float64)
    tracer = Tracer()
    tracer.span_arrays(**cols, args_cols={"deadline_s": deadline})
    calls = {"tolist": 0, "element": 0}
    tolist, getitem = torch.Tensor.tolist, torch.Tensor.__getitem__

    def counted_tolist(self):
        calls["tolist"] += 1
        return tolist(self)

    def counted_getitem(self, k):
        calls["element"] += 1
        return getitem(self, k)

    monkeypatch.setattr(torch.Tensor, "tolist", counted_tolist)
    monkeypatch.setattr(torch.Tensor, "__getitem__", counted_getitem)
    spans = tracer.all_spans()
    monkeypatch.undo()
    assert calls == {"tolist": 6, "element": 0}
    want = Tracer()
    want.span_arrays(**slab_cols("numpy"),
                     args_cols={"deadline_s": [0.4, 0.5, 3.0]})
    assert spans == want.all_spans() and len(spans) == 10
    assert spans[0].args == {"task": "t0", "deadline_s": 0.4}


def test_tracer_rejects_malformed_input():
    tracer = Tracer()
    with pytest.raises(ValueError, match="ends before it starts"):
        tracer.span("n", "bad", 2.0, 1.0)
    with pytest.raises(ValueError, match="column started_s"):
        tracer.span_arrays(["a"], [0], ["t0"], [0.0], [0.1, 0.2], [1.0])
    with pytest.raises(ValueError, match="args column"):
        tracer.instant_arrays("s", "replan", [0.0, 1.0],
                              args_cols={"batch": [1]})


def test_export_rejects_partial_overlap():
    tracer = Tracer()
    tracer.span("n", "a", 0.0, 2.0)
    tracer.span("n", "b", 1.0, 3.0)
    with pytest.raises(ValueError, match="partially overlap"):
        tracer.export_chrome(None)


def test_flight_recorder_ring():
    tracer, ref = Tracer(ring=8), robs.Tracer(ring=8)
    for k in range(20):
        tracer.instant("s", f"e{k}", float(k))
        ref.instant("s", f"e{k}", float(k))
    assert [e.name for e in tracer.last(64)] \
        == [f"e{k}" for k in range(12, 20)]
    assert [e.name for e in tracer.last(3)] == ["e17", "e18", "e19"]
    assert tracer.last(0) == []
    assert [dataclasses.astuple(e) for e in tracer.last(5)] == \
        [dataclasses.astuple(e) for e in ref.last(5)]


def test_null_tracer_is_inert(tmp_path):
    assert NULL_TRACER.enabled is False
    assert isinstance(NULL_TRACER, NullTracer)
    NULL_TRACER.span("n", "a", 0.0, 1.0)
    NULL_TRACER.instant("n", "a", 0.0)
    NULL_TRACER.task_spans("n", 0, "t", 0.0, 0.0, 1.0)
    NULL_TRACER.span_arrays([], [], [], [], [], [])
    NULL_TRACER.instant_arrays("n", "a", [])
    assert NULL_TRACER.last() == []
    with pytest.raises(ValueError, match="no-op tracer"):
        NULL_TRACER.export_chrome(str(tmp_path / "nope.json"))
    assert not (tmp_path / "nope.json").exists()


# --------------------------------------------------------------------------
# validator negatives: each clause bites, with the reference's message
# --------------------------------------------------------------------------
def _ev(ph, name, ts, pid=0, tid=0):
    return {"name": name, "ph": ph, "pid": pid, "tid": tid, "ts": ts}


@pytest.mark.parametrize("events_,match", [
    ([_ev("E", "a", 1.0)], "no open 'B'"),
    ([_ev("B", "a", 0.0), _ev("B", "b", 1.0), _ev("E", "a", 2.0)],
     "close LIFO"),
    ([_ev("B", "a", 2.0), _ev("E", "a", 1.0)], "backwards"),
    ([_ev("B", "a", 0.0)], "unmatched 'B'"),
    ([_ev("X", "a", 0.0)], "unknown phase"),
    ([_ev("i", "a", 2.0), _ev("i", "b", 1.0)], "backwards"),
])
def test_validator_negatives(events_, match):
    with pytest.raises(ValueError, match=match) as got:
        validate_chrome(events_)
    with pytest.raises(ValueError) as want:
        robs.validate_chrome(events_)
    assert str(got.value) == str(want.value)


def test_validator_accepts_nested_and_counts():
    events_ = [_ev("B", "sojourn", 0.0), _ev("B", "service", 1.0),
               _ev("E", "service", 2.0), _ev("i", "replan", 2.5),
               _ev("E", "sojourn", 3.0),
               _ev("B", "other", 0.0, pid=1), _ev("E", "other", 1.0,
                                                  pid=1)]
    assert validate_chrome(events_) == {"n_events": 7, "n_spans": 3,
                                        "n_instants": 1, "n_tracks": 2}
    assert validate_chrome(events_) == robs.validate_chrome(events_)


# --------------------------------------------------------------------------
# metrics registry + Prometheus exposition
# --------------------------------------------------------------------------
def test_registry_get_or_create_and_mismatches():
    reg = MetricsRegistry()
    c = reg.counter("req_total", help="requests")
    assert reg.counter("req_total") is c
    with pytest.raises(TypeError, match="already registered"):
        reg.gauge("req_total")
    reg.histogram("lat", boundaries=(1.0, 2.0))
    with pytest.raises(ValueError, match="boundaries"):
        reg.histogram("lat", boundaries=(1.0, 3.0))
    with pytest.raises(ValueError, match="invalid metric name"):
        reg.counter("bad name!")
    with pytest.raises(ValueError, match="cannot decrease"):
        c.inc(-1)
    with pytest.raises(ValueError, match="strictly increasing"):
        Histogram("h", boundaries=(1.0, 1.0, 2.0))


def test_histogram_buckets_and_percentile():
    h = Histogram("lat_seconds", boundaries=(1.0, 2.0, 5.0))
    h.observe_many([0.5, 1.0, 1.5, 10.0])
    assert h.counts.tolist() == [2, 1, 0, 1]
    assert h.count == 4 and h.sum == pytest.approx(13.0)
    exp = h.expose()
    assert 'lat_seconds_bucket{le="1"} 2' in exp
    assert 'lat_seconds_bucket{le="2"} 3' in exp
    assert 'lat_seconds_bucket{le="+Inf"} 4' in exp
    assert h.percentile_bound(0.5) == 1.0
    assert h.percentile_bound(1.0) == 10.0
    assert h.observed_max == 10.0
    assert h.percentile_bound(0.0) == 1.0
    h2 = Histogram("lat_seconds", boundaries=(1.0, 2.0, 5.0))
    h2.observe_many([3.0, 20.0])
    h.merge(h2)
    assert h.counts.tolist() == [2, 1, 1, 2]
    assert h.count == 6 and h.percentile_bound(1.0) == 20.0
    with pytest.raises(ValueError, match="identical boundaries"):
        h.merge(Histogram("other", boundaries=(1.0, 2.0)))
    # the reference's histogram on the same values; a tensor observed in
    # one piece lands in the same buckets
    r = robs.Histogram("lat_seconds", boundaries=(1.0, 2.0, 5.0))
    r.observe_many([0.5, 1.0, 1.5, 10.0])
    r.observe_many([3.0, 20.0])
    t = Histogram("lat_seconds", boundaries=(1.0, 2.0, 5.0))
    t.observe_many(torch.tensor([0.5, 1.0, 1.5, 10.0, 3.0, 20.0],
                                dtype=torch.bfloat16))
    for got in (h, t):
        assert got.expose() == r.expose()
        assert got.percentile_bound(0.9) == r.percentile_bound(0.9)


def test_prometheus_text_and_rows(tmp_path):
    regs = []
    for m in (pobs, robs):
        reg = m.MetricsRegistry()
        reg.counter("tasks_total", help="done").inc(3)
        reg.gauge("energy_joules").set(1.5)
        reg.histogram("sojourn_seconds",
                      boundaries=m.LATENCY_BOUNDARIES).observe_many(
                          [0.002, 0.3, 4.0])
        regs.append(reg)
    reg, ref = regs
    text = reg.to_prometheus()
    assert "# HELP tasks_total done" in text
    assert "# TYPE tasks_total counter" in text
    assert "# TYPE sojourn_seconds histogram" in text
    assert "tasks_total 3" in text
    assert "energy_joules 1.5" in text
    assert "sojourn_seconds_count 3" in text
    assert text == ref.to_prometheus()
    rows = reg.to_rows("m")
    assert rows[0] == {"name": "m", "energy_joules": 1.5,
                       "tasks_total": 3.0}
    assert rows[1]["name"] == "m_hist_sojourn_seconds"
    assert sum(rows[1]["counts"]) == 3
    assert rows == ref.to_rows("m")
    assert LATENCY_BOUNDARIES == robs.LATENCY_BOUNDARIES
    path = str(tmp_path / "metrics.json")
    reg.save(path, "m")
    ref.save(str(tmp_path / "ref.json"), "m")
    with open(path) as f:
        assert json.load(f) == json.loads(json.dumps(rows))
    assert (tmp_path / "metrics.json").read_bytes() == \
        (tmp_path / "ref.json").read_bytes()


# --------------------------------------------------------------------------
# Telemetry bridges: registry() / to_prometheus(), cvar95 in summary()
# --------------------------------------------------------------------------
def test_telemetry_registry_bridge():
    tel, _ = run_stream("port", "event", None, "pools_rtt", n_tasks=30)
    reg = tel.registry()
    assert isinstance(reg, MetricsRegistry)
    assert reg.get("sim_tasks_completed_total").value == len(tel.records)
    assert reg.get("sim_task_sojourn_seconds").count == len(tel.records)
    for key in tel.counters:
        assert reg.get(f"sim_{key}_total").value == tel.counters[key]
    text = tel.to_prometheus()
    assert "# TYPE sim_tasks_completed_total counter" in text
    assert "sim_task_wait_seconds_bucket" in text
    ref, _ = run_stream("ref", "event", None, "pools_rtt", n_tasks=30)
    assert text == ref.to_prometheus()
    assert tel.to_prometheus("edge") == ref.to_prometheus("edge")

    s = tel.summary()
    assert np.isfinite(s["cvar95_completion_s"])
    assert s["cvar95_completion_s"] >= s["p50_completion_s"]
    rows = tel.to_rows()
    assert rows[0]["cvar95_completion_s"] == s["cvar95_completion_s"]
    assert len(rows) == 1 + len(tel.utilisation())
    for row in rows[1:]:
        assert {"name", "utilisation", "mean_queue_len"} <= set(row)


# --------------------------------------------------------------------------
# serving engines: wall-clock spans
# --------------------------------------------------------------------------
def test_serve_engines_emit_spans():
    from repro_torch.configs import reduced_config
    from repro_torch.serve import ContinuousBatchEngine, Request, \
        ServeEngine
    cfg = reduced_config("qwen3-1.7b").replace(dtype="float32")

    tracer = Tracer()
    engine = ServeEngine(cfg, batch_size=2, max_len=48, obs=tracer,
                         device=CPU)
    prompts = np.tile(np.arange(8, dtype=np.int32)[None], (2, 1))
    engine.generate_batch(prompts, 5)
    spans = tracer.all_spans()
    assert [s.name for s in spans] == ["prefill", "decode"]
    assert all(s.track == "serve_engine" for s in spans)
    assert [i.name for i in tracer.all_instants()] == ["first_token"]
    assert spans[0].duration == engine.stats.prefill_s
    assert spans[1].duration == engine.stats.decode_s
    validate_chrome(tracer.export_chrome(None))

    ctracer = Tracer()
    ceng = ContinuousBatchEngine(cfg, slots=2, max_len=48, seed=3,
                                 obs=ctracer, device=CPU)
    rng = np.random.default_rng(7)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=n,
                                               dtype=np.int32),
                    max_new_tokens=4, arrived_at=i * 0.01)
            for i, n in enumerate((5, 9, 7))]
    done = ceng.serve(reqs)
    sojourns = [s for s in ctracer.all_spans() if s.name == "sojourn"]
    assert len(sojourns) == len(done)
    assert {i.name for i in ctracer.all_instants()} >= {"admit"}
    validate_chrome(ctracer.export_chrome(None))


# --------------------------------------------------------------------------
# every port seam: the traced run computes the untraced run's numbers, and
# a reference tracer on the same run records the same events
# --------------------------------------------------------------------------
def sim_seam(seam):
    """(run(obs) -> Telemetry, instant names the run must emit)."""
    m = SIDES["port"]
    n_nodes = 3
    tasks = make_tasks(psch, 30, seed=11)
    arrivals = psim.poisson_arrivals(12.0, n=30, seed=11)

    def links():
        return psim.ClusterLinks.random_walk(
            [40e6 + 5e6 * j for j in range(n_nodes)], sigma=0.4, seed=12)

    def env():
        return psim.DriftingEnv(
            p_get("pi5-arm"), p_get("edge-server-a100"),
            psim.TwoStateLink(80e6, 8e6, seed=13), input_bytes=2e6,
            torch_device=CPU)

    if seam == "stream":
        kw = lambda: dict(links=links(), link_update_dt=0.5)  # noqa: E731
        names = {"replan", "link_drift"}
    elif seam == "queueing":
        kw = lambda: dict(  # noqa: E731
            pools=psim.NodePools.uniform(n_nodes, 1),
            rtt=psim.WeibullRTT(shape=0.7, scale=0.01, seed=14))
        names = {"replan", "pool_wait"}
    elif seam == "pareto":
        kw = lambda: dict(  # noqa: E731
            split_planner=psim.ParetoStreamScheduler(torch_device=CPU),
            split_env=env(), split_layers=cnn_layers(m),
            pools=psim.NodePools.uniform(n_nodes, 1),
            saturation_threshold=0.3, link_update_dt=0.1)
        # the planner re-picks at every link tick; no pick changes here
        names = {"replan", "pool_wait", "pool_saturation"}
    elif seam == "fleet":
        kw = lambda: dict(  # noqa: E731
            engine="fleet", links=links(), link_update_dt=0.5,
            rtt=psim.WeibullRTT(shape=0.7, scale=0.01, seed=14))
        names = {"replan", "link_drift"}
    else:
        raise ValueError(seam)

    def run(obs):
        return psim.simulate_stream(tasks, arrivals, make_nodes(m, n_nodes),
                                    policy="min_min", obs=obs, device=CPU,
                                    **kw())
    return run, names


def oracle_seam():
    """``examples/oracle_serving.py``'s drifted stream: two node classes 3x
    slower from t = 130 s, so the oracle's Page–Hinkley detector fires and
    it refits."""
    from repro_torch.core import costs as pco
    from repro_torch.core.predictors import GBTRegressor
    from repro_torch.oracle import OnlineOracle
    specs = SIDES["port"].specs
    rng = np.random.default_rng(32)
    layers = [poff.LayerCost(f"l{i}", flops=float(rng.uniform(1e8, 1e11)),
                             act_bytes=0.0) for i in range(48)]
    x = np.concatenate([pco.default_layer_features(layers, s)
                        for s in specs])
    y = np.concatenate([[poff.layer_time(lc.flops, s) for lc in layers]
                        for s in specs])
    gbt = GBTRegressor(n_trees=30, max_depth=5).fit(x, y, device=CPU)
    tasks = [psch.Task(f"t{i}", flops=float(rng.uniform(1e8, 1e11)),
                       input_bytes=0.0) for i in range(400)]
    arrivals = np.sort(rng.uniform(0.0, 400.0, len(tasks)))

    def truth(task, spec, etc_s, start_s):
        slow = 3.0 if start_s >= 130.0 and spec.tdp_watts in (12, 15) \
            else 1.0
        return slow * poff.layer_time(task.flops, spec)

    def run(obs):
        oracle = OnlineOracle(gbt, specs[2], specs[-1], window=256,
                              min_refit=64, correction="none",
                              torch_device=CPU)
        return psim.simulate_stream(tasks, arrivals,
                                    [psch.Node(s) for s in specs],
                                    oracle=oracle, service_time_fn=truth,
                                    obs=obs, device=CPU)
    return run, {"ph_drift", "oracle_refit", "registry_publish"}


@pytest.mark.parametrize("seam", ["stream", "queueing", "pareto", "fleet",
                                  "oracle"])
def test_sim_seam_traced_equals_untraced(seam):
    run, names = oracle_seam() if seam == "oracle" else sim_seam(seam)
    plain = run(None)
    both = Both()
    traced = run(both)
    assert [rec_tuple(r) for r in traced.records] \
        == [rec_tuple(r) for r in plain.records]
    assert traced.summary() == plain.summary()
    assert events(both.port) == events(both.ref)
    assert chrome_text(both.port) == chrome_text(both.ref)
    stats = validate_chrome(both.port.export_chrome(None))
    assert stats["n_spans"] >= 2 * len(traced)
    assert names <= {i.name for i in both.port.all_instants()}


@pytest.mark.parametrize("engine", ["serve", "continuous"])
def test_serve_seam_traced_equals_untraced(engine):
    """Both engines on a reduced f32 model: the same tokens with and
    without a tracer and a registry; the port's tracer and the
    reference's hold the same events of the traced run."""
    from repro_torch.configs import reduced_config
    from repro_torch.core.costs import AnalyticCost
    from repro_torch.serve import ContinuousBatchEngine, Request, \
        ServeEngine
    cfg = reduced_config("qwen3-1.7b" if engine == "serve"
                         else "deepseek-moe-16b").replace(dtype="float32")
    rng = np.random.default_rng(5)
    lens = (6, 11, 8, 4, 9)

    def serve(obs, metrics):
        reqs = [Request(rid=i, prompt=rng_prompts[i], max_new_tokens=4,
                        arrived_at=i * 0.01) for i in range(len(lens))]
        if engine == "serve":
            eng = ServeEngine(cfg, batch_size=2, max_len=32, seed=1,
                              obs=obs, metrics=metrics, device=CPU)
        else:
            link = iter([1e5, 3e9, 2e7, 8e8, 1e6])
            eng = ContinuousBatchEngine(
                cfg, slots=2, max_len=32, seed=1, cost=AnalyticCost(),
                link_bw=lambda: next(link), decision_backend="torch",
                obs=obs, metrics=metrics, device=CPU)
        done = eng.serve(reqs)
        return eng, {r.rid: r.output.tolist() for r in done}

    rng_prompts = [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
                   for n in lens]
    _, plain = serve(None, None)
    both, reg = Both(), MetricsRegistry()
    eng, traced = serve(both, reg)
    assert traced == plain
    assert events(both.port) == events(both.ref)
    validate_chrome(both.port.export_chrome(None))
    spans, instants = both.port.all_spans(), both.port.all_instants()
    if engine == "serve":
        assert [s.name for s in spans] == ["prefill", "decode"] * 3
        assert [i.name for i in instants] == ["first_token"] * 3
        # the spans reuse the engine's own clock readings
        for phase in ("prefill", "decode"):
            assert sum(s.duration for s in spans if s.name == phase) \
                == getattr(eng.stats, f"{phase}_s")
        assert reg.counter("serve_requests_completed").value == len(lens)
    else:
        assert [i.name for i in instants].count("admit") == len(lens)
        assert [i.name for i in instants].count("replan") == len(lens)
        assert sum(s.name == "sojourn" for s in spans) == len(lens)
        assert reg.quantile("serve_sojourn_seconds").count == len(lens)
