"""Train a reduced-config LM for a few hundred steps, on the port.

Uses the production training loop + checkpointing on a family-faithful
reduced architecture in f32, through the kernels' path
(``impl="chunked"``: the loop's own f32 default is the naive path, as
the reference's is): the default qwen3-1.7b runs flash attention storing
its log-sum-exp, zamba2-1.2b ``ssm_scan`` forward and backward,
xlstm-350m ``slstm_scan`` forward and backward.  The initial weights are
drawn from the seed on the host, so that a run on any device starts from
the same weights.  Pass --arch to pick any of the 10 assigned
architectures; --steps to extend; --losses-out to keep each step's loss.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_tiny_lm \
          --arch qwen3-1.7b [--device cpu]
"""
from __future__ import annotations

import json
import os
import tempfile

from repro_torch._device import resolve_device
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import reduced_config
from repro_torch.examples import parser, require
from repro_torch.models import build_model
from repro_torch.train import TrainConfig, train


def train_config(steps: int, batch_size: int, seq_len: int,
                 ckpt_dir: str) -> TrainConfig:
    return TrainConfig(steps=steps, batch_size=batch_size, seq_len=seq_len,
                       lr=1e-3, log_every=25,
                       ckpt_every=max(steps // 4, 1), ckpt_dir=ckpt_dir)


def run(cfg, tcfg: TrainConfig, dev, params=None):
    """``train()`` on the kernels' path (``impl="chunked"``) from
    ``params`` (default ``init_params(tcfg.seed)`` drawn on the host and
    moved to ``dev``)."""
    if params is None:
        params = build_model(cfg).init_params(tcfg.seed, "cpu").to(dev)
    return train(cfg, tcfg, params=params, device=dev, impl="chunked")


def round_trip(ckpt_dir: str, final_params):
    """``(path, meta, tensors)`` of the latest checkpoint restored into
    ``final_params``' structure; None where none was written."""
    latest = ckpt.latest(ckpt_dir)
    if not latest:
        return None
    restored, meta = ckpt.restore(latest, final_params)
    return latest, meta, sum(1 for _ in restored.parameters())


def main(argv=None) -> None:
    ap = parser(__doc__)
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--losses-out", default=None,
                    help="write each step's loss to this JSON file")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = reduced_config(args.arch).replace(dtype="float32")
    with tempfile.TemporaryDirectory(prefix="repro_ckpt_") as ckpt_dir:
        res = run(cfg, train_config(args.steps, args.batch_size,
                                    args.seq_len, ckpt_dir), dev)
        print(f"[example] {cfg.name}: loss {res.losses[0]:.3f} -> "
              f"{res.losses[-1]:.3f} ({res.steps_per_s:.1f} steps/s)")
        if args.losses_out:
            with open(args.losses_out, "w") as f:
                json.dump(res.losses, f)
        require(res.losses[-1] < res.losses[0], "the loss did not fall")

        back = round_trip(ckpt_dir, res.final_params)
        if back:
            latest, meta, n = back
            print(f"[example] checkpoint round-trip OK: "
                  f"{os.path.basename(latest)} (step {meta['step']})")
            print(f"[example] restored {n} tensors")


if __name__ == "__main__":
    main()
