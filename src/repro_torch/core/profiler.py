"""The profiler (paper §II-A): run an AI workload, capture its execution
profile — FLOPs, MACs, memory, wall time, accuracy — on concrete hardware.

The port of ``repro.core.profiler``, with the same :class:`ProfileRecord`
schema, so records measured here train the same predictors.  Two probes:

  * **measured** — trains the Table-I workload on the torch ``device``
    (None = cuda; the CPU only when asked for) and times it;
  * **analytic** (``measure=False``) — the spec's roofline from the counted
    FLOPs and bytes.

What each field means in the port (the reference takes FLOPs, bytes and
memory from XLA's ``cost_analysis`` / ``memory_analysis`` of the jitted
step, which the port does not have):

  * ``flops_per_step``: ``torch.utils.flop_counter.FlopCounterMode`` over
    one train step (forward, backward, optimiser step).  It counts the
    products (matmuls, convolutions) by formula and no elementwise or
    optimiser op, where XLA counts those too: over Table I's networks,
    optimisers and batch sizes it reads 0.83–1.12× XLA's count
    (``tests/test_torch_profiler.py`` holds 0.8–1.15).  ``macs_per_step``
    is half of it, as in the reference.
  * bytes (analytic probe only): input plus output bytes of every aten op
    of that step that is not a view, unfused.
  * ``peak_bytes``: on the card, ``torch.cuda.max_memory_allocated`` over
    the run (model, optimiser state, batches, activations) less what was
    allocated before it; on the CPU, a stand-in: parameters, gradients,
    optimiser state, one batch and the tensors autograd saves for the
    backward.  The reference's is XLA's temp + argument size of the step.
  * ``step_time_s`` / ``total_time_s``: one warm-up step (the counted one)
    excluded, then ``min(planned, max_steps)`` steps, each batch uploaded
    from host numpy as the reference does, timed on the host clock up to a
    ``torch.cuda.synchronize()``; the total extrapolated to the planned
    steps.

The workload runs in true f32: TF32 is switched off for matmuls and cuDNN
convolutions for the run (:func:`true_f32`), since the records' hardware
features are f32 peaks.  ``spec=`` is the hardware the record is labelled
with (a ``DeviceSpec``, default ``xps15-i5`` as in the reference, whose
``device=`` it is); ``device=`` is the torch device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch
from torch.autograd.graph import saved_tensors_hooks
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch._device import DeviceLike, resolve_device, true_f32
from repro_torch.core.workloads import (WorkloadConfig, init_workload,
                                        synthetic_image_data, workload_loss)
from repro_torch.hw import DeviceSpec, get_device
from repro_torch.optim import get_optimizer


@dataclasses.dataclass
class ProfileRecord:
    """One profiling run (one row of the paper's dataset)."""
    label: str
    kind: str
    # --- profile targets (paper Fig. 3: FLOPS, MACs, total time) ---
    flops_per_step: float
    macs_per_step: float
    total_time_s: float
    # --- extended targets ---
    step_time_s: float
    peak_bytes: float
    param_count: int
    final_loss: float
    final_acc: float
    # --- inputs (features) ---
    config: dict
    hardware: dict

    def targets(self, extended: bool = False) -> dict:
        """Prediction targets.  The default three are the paper's Fig. 3
        stack; ``extended=True`` adds the resource-utilisation targets
        (per-step time and peak memory)."""
        out = {
            "flops": self.flops_per_step,
            "macs": self.macs_per_step,
            "total_time": self.total_time_s,
        }
        if extended:
            out["step_time"] = self.step_time_s
            out["peak_bytes"] = self.peak_bytes
        return out


class _BytesAccessed(TorchDispatchMode):
    """Input plus output bytes of every aten op that is not a view."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.bytes += sum(t.numel() * t.element_size()
                              for t in tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        return out


def _tensor_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def profile_workload(wc: WorkloadConfig, *, spec: Optional[DeviceSpec] = None,
                     measure: bool = True, max_steps: int = 0, seed: int = 0,
                     device: DeviceLike = None) -> ProfileRecord:
    """Train the Table-I workload on ``device`` and record its profile,
    labelled with the hardware ``spec``.

    ``max_steps`` > 0 truncates the run and extrapolates total time from the
    measured per-step time (the profiling-dataset generator uses this to
    keep >100-run grids tractable)."""
    dev = resolve_device(device)
    spec = spec or get_device("xps15-i5")
    with true_f32():
        return _profile(wc, spec, measure, max_steps, seed, dev)


def _profile(wc: WorkloadConfig, spec: DeviceSpec, measure: bool,
             max_steps: int, seed: int, dev: torch.device) -> ProfileRecord:
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    model = init_workload(wc, seed, device=dev)
    opt = get_optimizer(wc.optimiser, model.parameters(), wc.lr)
    x, y = synthetic_image_data(wc.dataset_size, seed=seed)
    bs = wc.batch_size

    def batch_at(lo: int) -> dict:
        return {"x": torch.as_tensor(x[lo:lo + bs]).to(dev),
                "y": torch.as_tensor(y[lo:lo + bs]).to(dev)}

    def train_step(batch: dict):
        opt.zero_grad(set_to_none=True)
        loss, acc = workload_loss(model, batch)
        loss.backward()
        opt.step()
        return loss.detach(), acc

    # the counted step is also the warm-up, excluded from the timing
    saved = []
    batch0 = batch_at(0)
    with FlopCounterMode(display=False) as flop_count, \
            _BytesAccessed() as bytes_count, \
            saved_tensors_hooks(lambda t: saved.append(t) or t,
                                lambda t: t):
        train_step(batch0)
    flops = float(flop_count.get_total_flops())
    saved_bytes = _tensor_bytes(saved)
    del saved

    steps_per_epoch = max(wc.dataset_size // bs, 1)
    planned = wc.epochs * steps_per_epoch
    loss_v = acc_v = float("nan")
    if measure:
        run_steps = min(planned, max_steps) if max_steps else planned
        if cuda:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for step in range(run_steps):
            loss_t, acc_t = train_step(
                batch_at((step % steps_per_epoch) * bs % wc.dataset_size))
        if cuda:
            torch.cuda.synchronize(dev)
        step_time = (time.perf_counter() - t0) / max(run_steps, 1)
        loss_v, acc_v = float(loss_t), float(acc_t)
    else:
        step_time = max(flops / spec.peak_flops_f32,
                        bytes_count.bytes / spec.hbm_bw)
    if cuda:
        peak = torch.cuda.max_memory_allocated(dev) - before
    else:
        params = list(model.parameters())
        peak = (2 * _tensor_bytes(params) + saved_bytes
                + _tensor_bytes(v for st in opt.state.values()
                                for v in st.values())
                + _tensor_bytes(batch0.values()))
    return ProfileRecord(
        label=wc.label(),
        kind=wc.kind,
        flops_per_step=flops,
        macs_per_step=flops / 2.0,
        total_time_s=step_time * planned,
        step_time_s=step_time,
        peak_bytes=float(peak),
        param_count=int(sum(p.numel() for p in model.parameters())),
        final_loss=loss_v,
        final_acc=acc_v,
        config=dataclasses.asdict(wc),
        hardware=spec.as_features(),
    )
