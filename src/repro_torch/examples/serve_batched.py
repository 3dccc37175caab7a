"""End-to-end serving example, on the port: a small model serving batched
requests through the broker → engine pipeline, with the profiling model
deciding WHERE each batch runs (device vs edge).

Reduced qwen3-1.7b in f32: its prefill attention runs on ``flash_fwd``
(the f32 instance of ``flash_attention``), the offload plan on
``decide_split``.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_batched \
          [--device cpu]
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import reduced_config
from repro_torch.core.costs import CompositeCost
from repro_torch.examples import parser, require
from repro_torch.hw import get_device
from repro_torch.serve import Request, ServeEngine

LINK_BWS = (0.125e9 / 8, 0.125e9, 1.25e9)


def build_engine(dev) -> ServeEngine:
    """Reduced qwen3-1.7b in f32; the construction-time cost model, a
    deadline-aware latency+energy blend, is every offload_plan's
    default."""
    cfg = reduced_config("qwen3-1.7b").replace(dtype="float32")
    cost = CompositeCost(weights={"latency_s": 1.0, "energy_j": 0.1},
                         deadline_s=0.25)
    return ServeEngine(cfg, batch_size=4, max_len=128, cost=cost,
                       device=dev)


def make_requests(vocab_size: int) -> list[Request]:
    """16 requests with ragged prompts (8-47 tokens), 24 new tokens each
    at temperature 0.8."""
    rng = np.random.default_rng(0)
    return [Request(rid=i,
                    prompt=rng.integers(0, vocab_size,
                                        size=int(rng.integers(8, 48)),
                                        dtype=np.int32),
                    max_new_tokens=24,
                    temperature=0.8,
                    arrived_at=time.time() + 0.01 * i)
            for i in range(16)]


@torch.inference_mode()
def prefill_logits(engine: ServeEngine, requests: list[Request]):
    """``[B, V]``: the first batch's logits at its last prompt position,
    the batch left-padded as ``ServeEngine.serve`` pads it (what its
    first sampling step draws from)."""
    chunk = sorted(requests, key=lambda r: r.arrived_at)[:engine.batch_size]
    s = max(len(r.prompt) for r in chunk)
    prompts = np.stack([np.pad(r.prompt, (s - len(r.prompt), 0))
                        for r in chunk])
    batch = {"tokens": torch.as_tensor(prompts, dtype=torch.int64,
                                       device=engine.device)}
    logits, _ = engine.api.prefill(engine.params, batch, engine.max_len)
    return logits[:, -1]


def offload(engine: ServeEngine) -> list[tuple]:
    """``[(link bw, place, total s, energy J, deadline slack s)]``: one
    decision per candidate link state, from the vectorized decision
    core."""
    n_layers = max(engine.cfg.num_layers, 1)    # one LayerCost per block
    plan = engine.offload_plan(list(LINK_BWS), seq_len=48,
                               device=get_device("jetson-orin-nano"),
                               edge=get_device("edge-server-a100"))
    energy = plan.objective("energy_j").cpu().numpy()
    slack = plan.objective("deadline_slack_s").cpu().numpy()
    rows = []
    for i, bw in enumerate(LINK_BWS):
        decision = plan[i]
        place = ("edge" if decision.split == 0 else
                 "device" if decision.split == n_layers else
                 f"split@{decision.split}")
        rows.append((bw, place, decision.total_time_s, float(energy[i]),
                     float(slack[i])))
    return rows


def main(argv=None) -> None:
    dev = resolve_device(parser(__doc__).parse_args(argv).device)
    engine = build_engine(dev)
    reqs = make_requests(engine.cfg.vocab_size)
    for bw, place, total, energy, slack in offload(engine):
        print(f"[offload] link {bw/0.125e9:6.2f} Gb/s -> {place} "
              f"(predicted {total*1e3:.2f} ms/batch, "
              f"{energy:.2f} J, deadline slack {slack*1e3:.1f} ms)")

    done = engine.serve(reqs)
    st = engine.stats
    print(f"[serve] completed {st.served} requests, "
          f"{st.tokens_out} new tokens")
    print(f"[serve] decode throughput {st.tokens_per_s:.1f} tok/s, "
          f"prefill {st.prefill_s:.2f}s total")
    sample = done[0]
    print(f"[serve] request {sample.rid}: prompt {len(sample.prompt)} toks "
          f"-> output {sample.output[:8]}..., "
          f"first token {sample.first_token_s*1e3:.1f} ms")
    require(all(r.output is not None and len(r.output) == r.max_new_tokens
                for r in done), "a request without its tokens")
    require(all(r.first_token_s > 0 for r in done),
            "a request without a first-token time")
    print("[serve] OK")


if __name__ == "__main__":
    main()
