"""LM training loop (the port of ``repro.train.loop``): config-driven,
checkpointed, mesh-aware.

One step is ``train_loss`` forward, ``backward()`` and the port's AdamW
(``optim.AdamW``: b2 0.95, weight decay 0.1, f32 moments) under the
reference's schedule, ``warmup_cosine(lr, warmup_steps, steps)``.  As in
the reference, a bf16 model takes ``impl="chunked"`` (flash attention: the
CUDA kernel's forward and the plain-torch flash backward on the card) and
any other dtype ``"naive"`` (the full score matrix).  ``jit_step=`` and
``batch_fn=`` take the place of that step and of the batches, as the
reference's do: ``launch.train --debug-mesh`` passes a mesh step from
``launch.steps.assemble``.
"""
from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Callable, Optional

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.data.synthetic import train_batch
from repro_torch.models import build_model
from repro_torch.optim import AdamW, warmup_cosine


def build_train_step(api, opt) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state, loss,
    metrics)``: params (a ParamTree, trained in place) and ``opt_state``,
    a torch optimiser over them that the first call makes with
    ``opt(params.parameters())`` when it is None."""
    def train_step(params, opt_state, batch):
        opt_state = opt_state or opt(params.parameters())
        loss, metrics = api.train_loss(params, batch)
        opt_state.zero_grad(set_to_none=True)
        loss.backward()
        opt_state.step()
        return params, opt_state, loss.detach(), metrics
    return train_step


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    batch_size: int = 8
    seq_len: int = 128
    lr: float = 3e-4
    warmup_steps: int = 20
    log_every: int = 10
    ckpt_every: int = 0
    ckpt_dir: str = "checkpoints"
    seed: int = 0


@dataclasses.dataclass
class TrainResult:
    losses: list
    steps_per_s: float
    final_params: object


def train(cfg, tcfg: TrainConfig, *, batch_fn: Optional[Callable] = None,
          jit_step=None, params=None, opt_state=None,
          device: DeviceLike = None,
          log_fn: Callable[[str], None] = print) -> TrainResult:
    """Train ``cfg`` (a ModelConfig) for ``tcfg.steps`` steps on ``device``
    (None = cuda): step i on ``batch_fn(i)``, by default
    ``train_batch(cfg, B, S, seed=tcfg.seed + i)``.  ``params`` (a
    ParamTree on ``device``, trained in place with its gradients switched
    on) defaults to ``init_params(tcfg.seed)``.  ``jit_step(params,
    opt_state, batch) -> (params, opt_state, loss, metrics)`` defaults to
    ``build_train_step`` with AdamW under
    ``warmup_cosine(lr, warmup_steps, steps)``; ``opt_state`` (None: the
    step makes its own) is handed from step to step.

    ``steps_per_s`` leaves out step 0 (the first call builds kernels and
    warms the allocator) and is timed to a synchronised end."""
    dev = resolve_device(device)
    api = build_model(cfg, impl="chunked" if cfg.dtype == "bfloat16"
                      else "naive")
    if params is None:
        params = api.init_params(tcfg.seed, dev)
    params.requires_grad_(True)
    if jit_step is None:
        jit_step = build_train_step(api, partial(
            AdamW, lr=warmup_cosine(tcfg.lr, tcfg.warmup_steps, tcfg.steps)))
    batch_fn = batch_fn or (lambda i: train_batch(
        cfg, tcfg.batch_size, tcfg.seq_len, seed=tcfg.seed + i, device=dev))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    losses = []
    t0 = None
    for i in range(tcfg.steps):
        params, opt_state, loss, _ = jit_step(params, opt_state, batch_fn(i))
        losses.append(loss.item())
        if i == 0:
            sync()
            t0 = time.perf_counter()      # exclude the first step
        if tcfg.log_every and (i % tcfg.log_every == 0 or
                               i == tcfg.steps - 1):
            log_fn(f"[train] step {i} loss={losses[-1]:.4f}")
        if tcfg.ckpt_every and i and i % tcfg.ckpt_every == 0:
            ckpt.save(f"{tcfg.ckpt_dir}/ckpt_{i}.npz", params, step=i)
    sync()
    dt = time.perf_counter() - (t0 or time.perf_counter())
    sps = (tcfg.steps - 1) / dt if dt > 0 else float("nan")
    return TrainResult(losses=losses, steps_per_s=sps, final_params=params)
