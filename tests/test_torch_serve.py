"""The port's ``ServeEngine`` against the reference engine on the CPU: the
same requests (mixed prompt lengths, a short last batch) with the same
weights give the same greedy tokens wherever the reference's top-2 margin
is clear; ``offload_plan`` gives the reference's plans; the launcher runs
with ``--device cpu``."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as r_reduced
from repro.hw import get_device as r_get_device
from repro.obs import MetricsRegistry, Tracer
from repro.serve import Request as RRequest
from repro.serve import ServeEngine as RServeEngine

from repro_torch.configs import reduced_config as p_reduced
from repro_torch.hw import get_device
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import Request, ServeEngine

# logits of the two engines differ by ~1e-6 of max |logit| (f32, other
# summation orders); tokens are compared while the margin exceeds 10x this
TOL = 1e-5
PROMPT_LENS = (7, 12, 5, 9, 11)


def requests(cls, vocab, max_new=6):
    rng = np.random.default_rng(4)
    return [cls(rid=i, prompt=rng.integers(0, vocab, size=n, dtype=np.int32),
                max_new_tokens=max_new - (i == 1), arrived_at=i * 1e-3)
            for i, n in enumerate(PROMPT_LENS)]


@pytest.fixture(scope="module", params=["qwen3-1.7b", "zamba2-1.2b"])
def engines(request):
    rcfg = r_reduced(request.param).replace(dtype="float32")
    pcfg = p_reduced(request.param).replace(dtype="float32")
    ref = RServeEngine(rcfg, batch_size=2, max_len=32, seed=0)
    margins = []                    # (batch, step) -> [B] top-2 margins
    sample = ref._sample

    def recording_sample(logits, temperature, key):
        top2 = np.sort(np.asarray(logits), axis=-1)[:, -2:]
        margins.append((top2[:, 1] - top2[:, 0])
                       / np.abs(np.asarray(logits)).max())
        return sample(logits, temperature, key)

    ref._sample = recording_sample
    port = ServeEngine(pcfg, batch_size=2, max_len=32, seed=0, device="cpu")
    port.load_params(params_from_jax(
        pcfg, jax.tree_util.tree_map(np.asarray, ref.params), "cpu"))
    done_r = ref.serve(requests(RRequest, rcfg.vocab_size))
    done_p = port.serve(requests(Request, pcfg.vocab_size))
    return ref, port, done_r, done_p, margins


def test_serve_matches_reference_engine(engines):
    ref, port, done_r, done_p, margins = engines
    assert [r.rid for r in done_p] == [r.rid for r in done_r] == [0, 1, 2,
                                                                  3, 4]
    # batches of (0,1), (2,3), (4 + its rid=-1 copy); each batch samples
    # max_new + 1 times (prefill + one per decode step)
    per_batch = len(margins) // 3
    for i, (rr, rp) in enumerate(zip(done_r, done_p)):
        assert rp.output.shape == (rr.max_new_tokens,) == (
            rp.max_new_tokens,)
        assert rp.output.dtype == np.int32
        batch, row = divmod(i, 2)
        for t in range(len(rr.output)):
            if margins[batch * per_batch + t][row] <= 10 * TOL:
                break           # a near tie: later tokens may differ
            assert rp.output[t] == rr.output[t], (i, t)
    assert port.stats.served == ref.stats.served == 5
    assert port.stats.tokens_out == ref.stats.tokens_out
    assert port.stats.prefill_s > 0 and port.stats.decode_s > 0


def test_engine_traces_and_streams_metrics():
    cfg = p_reduced("qwen3-1.7b").replace(dtype="float32")
    tracer, reg = Tracer(), MetricsRegistry()
    eng = ServeEngine(cfg, batch_size=2, max_len=24, device="cpu",
                      obs=tracer, metrics=reg)
    done = eng.serve(requests(Request, cfg.vocab_size, max_new=3)[:3])
    assert [s.name for s in tracer.all_spans()] == ["prefill", "decode"] * 2
    assert [i.name for i in tracer.all_instants()] == ["first_token"] * 2
    assert reg.counter("serve_requests_completed").value == 3
    assert reg.quantile("serve_first_token_seconds").count == 2
    assert reg.quantile("serve_request_total_seconds").count == 3
    assert all(r.first_token_s > 0 and r.total_s >= r.first_token_s
               for r in done)


def test_sampling_is_deterministic_and_greedy_rows_stay_greedy():
    cfg = p_reduced("qwen3-1.7b").replace(dtype="float32")
    eng = ServeEngine(cfg, batch_size=2, max_len=24, device="cpu")
    prompts = np.tile(np.arange(6, dtype=np.int32)[None], (2, 1))
    greedy = eng.generate_batch(prompts, 5)
    mixed = eng.generate_batch(prompts, 5, np.asarray([0.0, 1.5]), seed=3)
    again = eng.generate_batch(prompts, 5, np.asarray([0.0, 1.5]), seed=3)
    np.testing.assert_array_equal(mixed, again)
    np.testing.assert_array_equal(mixed[0], greedy[0])
    other = [eng.generate_batch(prompts, 5, 1.5, seed=s)[1]
             for s in range(4)]
    assert len({tuple(o) for o in other}) > 1
    assert eng.stats.tokens_out == 2 * 5 * 7


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_offload_plan_matches_reference(backend):
    rcfg = r_reduced("qwen3-1.7b").replace(dtype="float32")
    pcfg = p_reduced("qwen3-1.7b").replace(dtype="float32")
    ref = RServeEngine(rcfg, batch_size=2, max_len=32)
    port = ServeEngine(pcfg, batch_size=2, max_len=32, device="cpu")
    bws = np.geomspace(1e2, 1e10, 97)
    want = ref.offload_plan(bws, device=r_get_device("pi5-arm"),
                            backend="numpy")
    got = port.offload_plan(bws, device=get_device("pi5-arm"),
                            backend=backend)
    np.testing.assert_array_equal(got.splits.numpy(), want.splits)
    if backend == "torch":           # exact f64, bit for bit
        np.testing.assert_array_equal(got.total_time_s.numpy(),
                                      want.total_time_s)
    else:                            # f32 argmin, f64 re-costing
        np.testing.assert_allclose(got.total_time_s.numpy(),
                                   want.total_time_s, rtol=1e-12)
    assert set(want.splits.tolist()) == {0, 2}     # local and offloaded


def test_launcher_runs_on_the_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--requests", "3", "--batch-size", "2",
                "--prompt-len", "8", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "[serve] qwen3-1.7b on cpu: 3 requests, 12 tokens" in out


def test_engine_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = p_reduced("qwen3-1.7b")
    with pytest.raises(RuntimeError, match="device=None means cuda"):
        ServeEngine(cfg, batch_size=1, max_len=16)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ServeEngine(p_reduced("whisper-tiny"), device="cpu")
