"""Serving throughput of the port on reduced configs (a health check of
the serving substrate): prefill + decode tokens/s for three architecture
families, the counterpart of ``benchmarks/bench_serving.py``.

qwen3-1.7b, xlstm-350m and deepseek-moe-16b at the reference's reduced
shapes in f32, ``ServeEngine(batch_size=2, max_len=96)``, four requests of
32 prompt tokens and 16 new ones (the same prompts on every path).  Paths:
the CPU (``plain: true``), the card with the models' plain path
(``impl="naive"``: the score matrix in full, the sLSTM's step loop;
``_card`` rows), and the card's default path through the kernels
(``flash_attention``'s f32 ``flash_fwd``, ``slstm_scan``; ``_kernel`` rows,
with their launches).  Each (family, path) first serves a batch of two
2-token requests outside the stats, so that ``prefill_s`` holds no kernel
build or first call's set-up (the reference's includes its jit compile).
Full-width serving runs in ``chip_smoke.py``.

Run:  PYTHONPATH=src python -m repro_torch.bench.serving [--device cpu]

Rows go to ``results/bench_torch_serving.json``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.bench.common import counting, emit, parser, paths, tag
from repro_torch.configs import reduced_config
from repro_torch.models import build_model
from repro_torch.serve import EngineStats, Request, ServeEngine

ARCHS = ["qwen3-1.7b", "xlstm-350m", "deepseek-moe-16b"]
#: the kernels each family's prefill runs on the card
KERNELS = {"qwen3-1.7b": ("flash_attention",),
           "xlstm-350m": ("slstm_scan",),
           "deepseek-moe-16b": ("flash_attention",)}
TIMED = ("us_per_call", "decode_tok_per_s", "prefill_s")


def prompts(archs=ARCHS) -> dict:
    """Four 32-token prompts per arch, drawn in turn from one generator
    (seed 0), as the reference draws them."""
    rng = np.random.default_rng(0)
    out = {}
    for arch in archs:
        vocab = reduced_config(arch).vocab_size
        out[arch] = [rng.integers(0, vocab, size=32, dtype=np.int32)
                     for _ in range(4)]
    return out


def serve_row(arch: str, toks, path: str, dev) -> dict:
    """One family on one path; a first batch of two 2-token requests,
    outside the stats and the launches, builds the kernels and sets up the
    device's first calls."""
    cfg = reduced_config(arch).replace(dtype="float32")
    engine = ServeEngine(cfg, batch_size=2, max_len=96, device=dev)
    if path == "card":
        engine.api = build_model(cfg, impl="naive")
    engine.serve([Request(rid=i, prompt=p, max_new_tokens=2)
                  for i, p in enumerate(toks[:2])])
    engine.stats = EngineStats()
    with counting() as launched:
        engine.serve([Request(rid=i, prompt=p, max_new_tokens=16)
                      for i, p in enumerate(toks)])
    st = engine.stats
    return tag({
        "name": f"serve_{arch}" + ("" if path == "cpu" else f"_{path}"),
        "us_per_call": 1e6 * st.decode_s / max(st.tokens_out, 1),
        "decode_tok_per_s": st.tokens_per_s,
        "prefill_s": st.prefill_s,
        "tokens_out": st.tokens_out,
    }, path, launched, KERNELS[arch])


def main(device=None, archs=ARCHS) -> list[dict]:
    toks = prompts(archs)
    rows = [serve_row(arch, toks[arch], path, dev)
            for path, dev in paths(device) for arch in archs]
    emit(rows, "serving")
    return rows


if __name__ == "__main__":
    args = parser(__doc__, smoke=False).parse_args()
    main(device=args.device)
