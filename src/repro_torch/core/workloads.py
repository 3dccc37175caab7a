"""The paper's Table I workload grid: CNN and MLP families × hyperparameters.

The port of ``repro.core.workloads``.  These are the AI tasks whose
execution the profiler characterises (paper §II-A / §III-A).  Exact
configurations from Table I:

  CNN types:
    1. [{out_channels: 32, kernel: 5, pool}]
    2. [{32, 5, pool}, {64, 3, pool}]
    3. [{64, 5, pool}, {64, 3, pool}, {128, 3, pool}]
  MLP types: [100, 50], [150, 100, 50], [200, 150, 100, 50]
  Epochs: 5, 10, 15, 20
  Optimisers: Adam, SGD, RMSprop, Adagrad
  Learning rates: 0.01, 0.05, 0.001, 0.005, 0.0001, 0.0005
  Batch sizes: 16, 32, 64, 128

Images are 28×28×1 (MNIST-like synthetic), 10 classes.  The grid and the
data are the reference's numpy code, so the same seed gives the same runs
and the same images.  The two families are ``nn.Module``s
(:class:`WorkloadNet`) that take the reference's input layouts: the CNN
permutes its NHWC images to NCHW for ``Conv2d`` (SAME padding is
``k // 2`` for the odd kernels of Table I; pooling is 2×2 VALID) and
flattens its last feature map in NHWC order again before the head, so the
reference's ``head_w`` rows carry over unpermuted
(:func:`workload_params_from_jax`).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Iterator

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.models.layers import init_dense

IMG = 28
NCLASS = 10

CNN_TYPES: list[list[dict]] = [
    [{"out": 32, "kernel": 5, "pool": True}],
    [{"out": 32, "kernel": 5, "pool": True},
     {"out": 64, "kernel": 3, "pool": True}],
    [{"out": 64, "kernel": 5, "pool": True},
     {"out": 64, "kernel": 3, "pool": True},
     {"out": 128, "kernel": 3, "pool": True}],
]
MLP_TYPES: list[list[int]] = [[100, 50], [150, 100, 50], [200, 150, 100, 50]]
EPOCHS = [5, 10, 15, 20]
OPTIMISERS = ["adam", "sgd", "rmsprop", "adagrad"]
LEARNING_RATES = [0.01, 0.05, 0.001, 0.005, 0.0001, 0.0005]
BATCH_SIZES = [16, 32, 64, 128]


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    """One cell of the Table I grid."""
    kind: str                   # "cnn" | "mlp"
    type_idx: int               # index into CNN_TYPES / MLP_TYPES
    epochs: int
    optimiser: str
    lr: float
    batch_size: int
    dataset_size: int = 2048    # synthetic samples (paper varies data size)

    @property
    def arch(self):
        return (CNN_TYPES if self.kind == "cnn" else MLP_TYPES)[self.type_idx]

    def label(self) -> str:
        return (f"{self.kind}{self.type_idx}-e{self.epochs}-{self.optimiser}"
                f"-lr{self.lr}-b{self.batch_size}")


def full_grid() -> Iterator[WorkloadConfig]:
    """The complete Table I cross-product (2 kinds × 3 × 4 × 4 × 6 × 4 =
    2,304 runs; the paper reports >3,000 including data-size variations)."""
    for kind, n_types in (("cnn", len(CNN_TYPES)), ("mlp", len(MLP_TYPES))):
        for ti, ep, op, lr, bs in itertools.product(
                range(n_types), EPOCHS, OPTIMISERS, LEARNING_RATES,
                BATCH_SIZES):
            yield WorkloadConfig(kind, ti, ep, op, lr, bs)


def sample_grid(n: int, seed: int = 0) -> list[WorkloadConfig]:
    grid = list(full_grid())
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(grid), size=min(n, len(grid)), replace=False)
    return [grid[i] for i in sorted(idx)]


# --------------------------------------------------------------------------
# Model implementations (torch modules)
# --------------------------------------------------------------------------
class WorkloadNet(nn.Module):
    """One Table-I network: an MLP over the flattened image, or a conv
    stack (conv, ReLU, 2×2 max-pool per layer) with a dense head.

    Weights are the reference's truncated-normal fan-in init, drawn in
    order from ``gen`` (not ``jax.random``'s values); the layers skip
    torch's own init, so the global RNG is not touched."""

    def __init__(self, wc: WorkloadConfig, gen: torch.Generator):
        super().__init__()
        self.kind = wc.kind
        if wc.kind == "mlp":
            dims = [IMG * IMG] + list(wc.arch) + [NCLASS]
            self.layers = nn.ModuleList(
                _linear(a, b, gen) for a, b in zip(dims[:-1], dims[1:]))
            return
        self.convs = nn.ModuleList()
        self.pools: list[bool] = []
        c_in, hw = 1, IMG
        for layer in wc.arch:
            k = layer["kernel"]
            conv = skip_init(nn.Conv2d, c_in, layer["out"], k,
                             padding=k // 2)
            w = init_dense((k, k, c_in, layer["out"]), gen,
                           scale=(k * k * c_in) ** -0.5)
            with torch.no_grad():
                conv.weight.copy_(w.permute(3, 2, 0, 1))   # HWIO -> OIHW
                conv.bias.zero_()
            self.convs.append(conv)
            self.pools.append(layer["pool"])
            c_in = layer["out"]
            if layer["pool"]:
                hw //= 2
        self.head = _linear(hw * hw * c_in, NCLASS, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, 28, 28, 1] (cnn) or [B, 784] (mlp), as the reference
        takes them → logits [B, 10]."""
        if self.kind == "mlp":
            h = x.reshape(x.shape[0], -1)
            for i, layer in enumerate(self.layers):
                h = layer(h)
                if i < len(self.layers) - 1:
                    h = torch.relu(h)
            return h
        h = x.reshape(x.shape[0], IMG, IMG, 1).permute(0, 3, 1, 2)
        for conv, pool in zip(self.convs, self.pools):
            h = torch.relu(conv(h))
            if pool:
                h = F.max_pool2d(h, 2)
        # flatten in the reference's NHWC order
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        return self.head(h)


def _linear(a: int, b: int, gen: torch.Generator) -> nn.Linear:
    lin = skip_init(nn.Linear, a, b)
    with torch.no_grad():
        lin.weight.copy_(init_dense((a, b), gen).T)
        lin.bias.zero_()
    return lin


def init_workload(wc: WorkloadConfig, seed: int = 0, *,
                  device: DeviceLike = None) -> WorkloadNet:
    """The workload's network on ``device`` (None = cuda), its weights
    drawn on the CPU from ``torch.Generator().manual_seed(seed)``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    return WorkloadNet(wc, gen).to(dev)


def workload_params_from_jax(params: dict, wc: WorkloadConfig
                             ) -> dict[str, torch.Tensor]:
    """The reference's ``init_workload_params`` dict (numpy arrays) as a
    :class:`WorkloadNet` state dict: dense ``[in, out]`` → ``Linear``'s
    ``[out, in]``, conv HWIO → OIHW; the head's rows are already in the
    NHWC order :meth:`WorkloadNet.forward` flattens in."""
    t = {k: torch.tensor(np.asarray(v, np.float32))
         for k, v in params.items()}
    if wc.kind == "mlp":
        out = {}
        for i in range(len(wc.arch) + 1):
            out[f"layers.{i}.weight"] = t[f"w{i}"].T.contiguous()
            out[f"layers.{i}.bias"] = t[f"b{i}"]
        return out
    out = {}
    for i in range(len(wc.arch)):
        out[f"convs.{i}.weight"] = t[f"conv{i}"].permute(3, 2, 0, 1) \
            .contiguous()
        out[f"convs.{i}.bias"] = t[f"cb{i}"]
    out["head.weight"] = t["head_w"].T.contiguous()
    out["head.bias"] = t["head_b"]
    return out


def workload_loss(model: WorkloadNet, batch: dict
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(loss, acc)``: mean cross-entropy and accuracy on ``batch``
    (``x`` images, ``y`` integer labels)."""
    logits = model(batch["x"])
    labels = batch["y"].long()
    loss = F.cross_entropy(logits, labels)
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, acc


def synthetic_image_data(n: int, seed: int = 0):
    """Class-conditional gaussian 'digit' blobs — learnable 10-class task."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(NCLASS, IMG, IMG, 1)).astype(np.float32)
    y = rng.integers(0, NCLASS, size=n)
    x = protos[y] + 0.8 * rng.normal(size=(n, IMG, IMG, 1)).astype(np.float32)
    return x.astype(np.float32), y.astype(np.int32)
