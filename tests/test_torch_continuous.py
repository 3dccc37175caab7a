"""The port's ``ContinuousBatchEngine`` on the CPU: the reference's three
engine tests (``tests/test_train_serve_ckpt.py``) on the port, and the
port against the reference engine with the same weights and requests on
reduced qwen3-1.7b and deepseek-moe-16b: outputs, admission instants,
steps, occupancy, re-planned splits, and what a ``repro.obs`` tracer and
``MetricsRegistry`` see."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as r_reduced
from repro.core.costs import AnalyticCost as RAnalyticCost
from repro.hw import get_device as r_get_device
from repro.obs import MetricsRegistry, Tracer
from repro.serve import Request as RRequest
from repro.serve.continuous import ContinuousBatchEngine as REngine

from repro_torch.configs import reduced_config as p_reduced
from repro_torch.core.costs import AnalyticCost
from repro_torch.core.decisions import decide_all, make_envs
from repro_torch.core.offload import transformer_layer_costs
from repro_torch.hw import get_device
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import ContinuousBatchEngine, Request, ServeEngine
from repro_torch.sim.events import Clock

# logits of the two packages differ by ~1e-6 of max |logit| (f32, other
# summation orders); greedy tokens are compared where the port's top-2
# margin exceeds 10x this
TOL = 1e-5
CPU = "cpu"
# link observations at successive admissions: wired, then a congested cell
LINK = [1.25e9, 1.25e9, 0.125e9 / 64, 0.125e9 / 64, 1e7, 3e8]


def cfg_of(arch):
    return p_reduced(arch).replace(dtype="float32")


def prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n, dtype=np.int32) for n in lens]


def test_continuous_batching_matches_static():
    """Continuous batching with ragged admission gives the greedy tokens of
    one-request-at-a-time static decoding (the reference's test)."""
    cfg = cfg_of("qwen3-1.7b")
    ps = prompts(cfg.vocab_size, (5, 9, 7, 12, 4, 6), 7)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=6, arrived_at=i * 0.01)
            for i, p in enumerate(ps)]
    eng = ContinuousBatchEngine(cfg, slots=2, max_len=48, seed=3,
                                device=CPU)
    done = eng.serve(reqs)
    assert len(done) == len(ps)
    assert eng.occupancy > 1.0            # slots actually shared
    ref = ServeEngine(cfg, batch_size=1, max_len=48, seed=0, device=CPU)
    ref.load_params(eng.params)
    for r in sorted(done, key=lambda r: r.rid):
        np.testing.assert_array_equal(
            r.output, ref.generate_batch(r.prompt[None],
                                         r.max_new_tokens)[0])


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_continuous_engine_replans_offload_per_admission(backend):
    """Every admitted request gets a split planned against the link
    observation at its admission (the reference's test)."""
    cfg = cfg_of("qwen3-1.7b")
    obs = iter(LINK[:4])
    eng = ContinuousBatchEngine(cfg, slots=2, max_len=48, seed=3,
                                cost=AnalyticCost(),
                                link_bw=lambda: next(obs),
                                decision_backend=backend, device=CPU)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=3, arrived_at=i * 0.01)
            for i, p in enumerate(prompts(cfg.vocab_size, (5, 9, 7, 12),
                                          11))]
    done = eng.serve(reqs)
    assert len(done) == 4 and eng.replans == 4
    device, edge = get_device("jetson-orin-nano"), \
        get_device("edge-server-a100")
    for r, bw in zip(sorted(done, key=lambda r: r.rid), LINK[:4]):
        assert r.offload is not None
        assert r.admitted_at >= r.arrived_at
        layers = transformer_layer_costs(cfg, len(r.prompt), 1)
        envs = make_envs(device, edge, link_bw=np.asarray([bw]),
                         input_bytes=4.0 * len(r.prompt), device=CPU)
        expect = decide_all(layers, envs, cost=AnalyticCost(),
                            backend="torch", device=CPU)[0]
        assert r.offload.split == expect.split
        np.testing.assert_allclose(r.offload.total_time_s,
                                   expect.total_time_s, rtol=1e-12)


def test_continuous_engine_honours_arrival_clock():
    """No admission before arrival: virtual time moves a step latency per
    decode step and jumps over idle gaps (the reference's test)."""
    cfg = cfg_of("qwen3-1.7b")
    clock = Clock()
    eng = ContinuousBatchEngine(cfg, slots=2, max_len=48, seed=3,
                                clock=clock, step_latency_s=5e-3,
                                device=CPU)
    ps = prompts(cfg.vocab_size, (5, 7, 6), 5)
    reqs = [Request(rid=0, prompt=ps[0], max_new_tokens=4, arrived_at=0.0),
            Request(rid=1, prompt=ps[1], max_new_tokens=4,
                    arrived_at=0.012),
            Request(rid=2, prompt=ps[2], max_new_tokens=4, arrived_at=10.0)]
    done = eng.serve(reqs)
    assert len(done) == 3
    by = {r.rid: r for r in done}
    assert all(r.admitted_at >= r.arrived_at for r in done)
    assert by[0].admitted_at == 0.0
    assert by[1].admitted_at <= 0.012 + 2 * eng.step_latency_s
    assert by[2].admitted_at == 10.0
    assert clock.now >= 10.0
    ref = ServeEngine(cfg, batch_size=1, max_len=48, seed=0, device=CPU)
    ref.load_params(eng.params)
    for r in done:
        np.testing.assert_array_equal(
            r.output, ref.generate_batch(r.prompt[None],
                                         r.max_new_tokens)[0])


def requests(cls, vocab):
    """Six requests over two slots: arrivals while both slots decode, a
    short one, one after an idle gap; two prompts long enough that the
    pi5-arm offloads them."""
    lens, arrive = (5, 40, 7, 34, 4, 6), (0.0, 0.004, 0.006, 0.02, 0.021,
                                          1.0)
    return [cls(rid=i, prompt=p, max_new_tokens=(3, 6, 4, 5, 2, 4)[i],
                arrived_at=arrive[i])
            for i, p in enumerate(prompts(vocab, lens, 13))]


@pytest.fixture(scope="module", params=["qwen3-1.7b", "deepseek-moe-16b"])
def engines(request):
    """The reference engine (``decision_backend="numpy"``) and the port's
    (``"torch"``) on the same weights, requests, link observations and
    clock step, each with its own ``repro.obs`` tracer and registry.  The
    end device is the pi5-arm, which runs the short prompts' reduced model
    locally and offloads the long ones."""
    rcfg = r_reduced(request.param).replace(dtype="float32")
    pcfg = cfg_of(request.param)
    out = {}
    for side in ("ref", "port"):
        link = iter(LINK)
        kw = dict(slots=2, max_len=64, seed=0, link_bw=lambda: next(link),
                  step_latency_s=4e-3, obs=Tracer(),
                  metrics=MetricsRegistry())
        if side == "ref":
            eng = REngine(rcfg, cost=RAnalyticCost(),
                          offload_device=r_get_device("pi5-arm"), **kw)
            done = eng.serve(requests(RRequest, rcfg.vocab_size))
            params = eng.params
            out["ref"] = (eng, done)
            continue
        eng = ContinuousBatchEngine(pcfg, cost=AnalyticCost(),
                                    offload_device=get_device("pi5-arm"),
                                    decision_backend="torch", device=CPU,
                                    **kw)
        eng.params = params_from_jax(
            pcfg, jax.tree_util.tree_map(np.asarray, params), CPU)
        margins = []                  # top-2 margin of each active slot

        def recording(fn, rows):
            def wrapped(*args):
                logits, cache = fn(*args)
                last = logits[:, -1].detach()
                top2 = torch.topk(last, 2, dim=-1).values
                live = rows()
                margins.extend(((top2[:, 0] - top2[:, 1])
                                / last.abs().max())[live].tolist())
                return logits, cache
            return wrapped

        eng._prefill = recording(eng._prefill, lambda: [0])
        eng.api = dataclasses.replace(eng.api, decode_step=recording(
            eng.api.decode_step,
            lambda: [s for s, r in enumerate(eng.slot_req) if r]))
        done = eng.serve(requests(Request, pcfg.vocab_size))
        out["port"] = (eng, done)
        out["margins"] = margins
    return out


def test_outputs_and_admissions_match_reference(engines):
    (ref, done_r), (port, done_p) = engines["ref"], engines["port"]
    # every greedy choice of the port is clear of a near tie, so the
    # tokens must be the reference's
    assert min(engines["margins"]) > 10 * TOL
    assert [r.rid for r in done_p] == [r.rid for r in done_r]
    for rr, rp in zip(done_r, done_p):
        assert rp.output.dtype == np.int32
        np.testing.assert_array_equal(rp.output, rr.output)
        assert rp.admitted_at == rr.admitted_at >= rr.arrived_at
    assert port.steps == ref.steps
    assert port.tokens_out == ref.tokens_out
    assert port.occupancy == ref.occupancy > 1.0
    assert port.clock.now == ref.clock.now


def test_replanned_splits_match_reference(engines):
    (ref, done_r), (port, done_p) = engines["ref"], engines["port"]
    assert port.replans == ref.replans == len(done_r)
    for rr, rp in zip(done_r, done_p):
        assert rp.offload.split == rr.offload.split
        np.testing.assert_allclose(rp.offload.total_time_s,
                                   rr.offload.total_time_s, rtol=1e-12)
    assert len({r.offload.split for r in done_p}) > 1


def test_tracer_and_metrics_see_what_the_reference_sees(engines):
    (ref, _), (port, _) = engines["ref"], engines["port"]
    want = [dataclasses.astuple(e) for e in ref.obs.all_instants()]
    got = [dataclasses.astuple(e) for e in port.obs.all_instants()]
    assert got == want
    assert {e[2] for e in got} == {"admit", "replan"}
    want = [dataclasses.astuple(e) for e in ref.obs.all_spans()]
    assert [dataclasses.astuple(e)
            for e in port.obs.all_spans()] == want and want
    for name in ("serve_sojourn_seconds", "serve_queue_wait_seconds"):
        q_r, q_p = ref.metrics.quantile(name), port.metrics.quantile(name)
        assert q_p.count == q_r.count == 6
        for p in (0.5, 0.99):
            assert q_p.quantile(p) == q_r.quantile(p)
    assert port.metrics.counter("serve_requests_completed").value == \
        ref.metrics.counter("serve_requests_completed").value == 6


def test_engine_needs_a_card_and_a_gqa_decode_path(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=None means cuda"):
        ContinuousBatchEngine(cfg_of("deepseek-moe-16b"), slots=2,
                              max_len=16)
    for arch in ("deepseek-v2-lite-16b", "zamba2-1.2b", "xlstm-350m"):
        with pytest.raises(ValueError, match="vector-position GQA"):
            ContinuousBatchEngine(cfg_of(arch), slots=2, max_len=16,
                                  device=CPU)


def test_vlm_engine_serves_tokens():
    """phi-3-vision is served on tokens, as in the reference, and matches
    static batch-1 decoding."""
    cfg = cfg_of("phi-3-vision-4.2b")
    eng = ContinuousBatchEngine(cfg, slots=2, max_len=32, seed=1,
                                device=CPU)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=4, arrived_at=0.0)
            for i, p in enumerate(prompts(cfg.vocab_size, (6, 9, 5), 2))]
    done = eng.serve(reqs)
    ref = ServeEngine(cfg, batch_size=1, max_len=32, device=CPU)
    ref.load_params(eng.params)
    for r in done:
        np.testing.assert_array_equal(
            r.output, ref.generate_batch(r.prompt[None], 4)[0])
