"""Training steps/s at full width and depth in bf16 through ``train()``, at
chip_smoke's training runs (10 steps at B 8, S 128, 3 warm-up steps; then
3 at B 4, S 2048): by default the two recurrent families whose scans have
backward kernels, zamba2-1.2b (Mamba2: ``ssm_scan``) and xlstm-350m
(sLSTM: ``slstm_scan``); ``--arch`` names others instead (e.g.
qwen3-1.7b, whose attention backward is a kernel).  It uses only
``configs``, ``train`` and ``bench.common.card``, so it also runs against
another commit's package::

    python -m repro_torch.bench.scan_train [--arch qwen3-1.7b ...]
    PYTHONPATH=<other tree>/src python src/repro_torch/bench/scan_train.py

One JSON line a run; needs the card."""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.bench.common import card
from repro_torch.configs import get_config
from repro_torch.train import TrainConfig, train

ARCHS = ("zamba2-1.2b", "xlstm-350m")
#: (steps, B, S) of each run, as chip_smoke's SCAN_TRAIN_RUNS
RUNS = ((10, 8, 128), (3, 4, 2048))
WARMUP = 3


def main(archs: tuple[str, ...] = ARCHS) -> list[dict]:
    if not torch.cuda.is_available():
        raise RuntimeError("scan_train times training on the card: it needs "
                           "one")
    dev = torch.device("cuda")
    rows = []
    for arch in archs:
        params = None
        for steps, b, s in RUNS:
            res = train(get_config(arch),
                        TrainConfig(steps=steps, batch_size=b, seq_len=s,
                                    warmup_steps=WARMUP, log_every=0),
                        params=params, device=dev, log_fn=lambda m: None)
            params = res.final_params
            rows.append(dict(model=arch, steps=steps, batch=b, seq_len=s,
                             steps_per_s=res.steps_per_s,
                             losses=res.losses, device=card()))
            print(json.dumps(rows[-1]), flush=True)
        del params
        torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", action="append",
                    help="a configuration to train (repeatable); default "
                         f"{', '.join(ARCHS)}")
    main(tuple(ap.parse_args().arch or ARCHS))
