"""Serving launcher: batched requests against a (reduced) model.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --requests 8 --max-new 16 [--device cpu]

``--device`` defaults to the card and fails without one; ``--device cpu``
runs the plain PyTorch path.
"""
import argparse

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    args = ap.parse_args(argv)

    from repro_torch.configs import reduced_config
    from repro_torch.serve import Request, ServeEngine

    cfg = reduced_config(args.arch).replace(dtype="float32")
    engine = ServeEngine(cfg, batch_size=args.batch_size,
                         max_len=args.prompt_len + args.max_new + 8,
                         device=args.device)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        size=args.prompt_len,
                                        dtype=np.int32),
                    max_new_tokens=args.max_new,
                    # virtual arrival stamps: only their order matters
                    arrived_at=i * 1e-3)
            for i in range(args.requests)]
    done = engine.serve(reqs)
    st = engine.stats
    print(f"[serve] {args.arch} on {engine.device}: {st.served} requests, "
          f"{st.tokens_out} tokens, {st.tokens_per_s:.1f} tok/s decode, "
          f"prefill {st.prefill_s:.2f}s decode {st.decode_s:.2f}s")
    assert all(r.output is not None for r in done)


if __name__ == "__main__":
    main()
