"""The paper's Table-I optimisers in PyTorch (the port of
``repro.optim.optimizers``).

Table I sweeps four optimisers (Adam, SGD, RMSprop, Adagrad) as
profiling variables; AdamW rides along.  Each is a small
``torch.optim.Optimizer`` whose ``step`` does the reference's arithmetic
op for op in f32, with the reference's defaults, rather than
``torch.optim``'s classes, whose defaults and forms differ:

  * rmsprop: ``decay=0.9`` (torch ``alpha=0.99``);
  * adagrad: ``initial_accumulator=0.1``, ``eps=1e-10`` (torch 0.0);
  * adamw: ``b2=0.95``, ``weight_decay=0.1``;
  * adam: ``sqrt(v/bc2) + eps`` (torch forms ``sqrt(v)/sqrt(bc2) + eps``);
  * weight decay is decoupled for every optimiser, ``u - lr·wd·p`` on the
    old parameters, as the reference applies it.

``lr`` is a float or a ``step -> lr`` schedule
(:mod:`repro_torch.optim.schedules`); the step counts from 1 at the first
``step()``, as in the reference.  The constructors take the parameters
first, as ``torch.optim`` does: ``adam(model.parameters(), 1e-3)``.
"""
from __future__ import annotations

from typing import Callable, Iterable, Union

import numpy as np
import torch

Schedule = Callable[[int], float]
LR = Union[float, Schedule]


def _as_schedule(lr: LR) -> Schedule:
    if callable(lr):
        return lr
    return lambda step: lr


def _f32(v: float) -> float:
    """``v`` rounded to f32: the reference forms its scalars in f32."""
    return float(np.float32(v))


class Optimizer(torch.optim.Optimizer):
    """Shared plumbing: one step counter, the schedule, and the decoupled
    weight decay.  Subclasses fill ``_init_state`` and ``_update``."""

    def __init__(self, params: Iterable, lr: LR, weight_decay: float = 0.0,
                 **hyper):
        super().__init__(params, dict(weight_decay=weight_decay, **hyper))
        self._sched = _as_schedule(lr)
        self.step_count = 0

    def _init_state(self, p: torch.Tensor, group: dict) -> dict:
        raise NotImplementedError

    def _update(self, g: torch.Tensor, st: dict, group: dict, lr_t: float
                ) -> torch.Tensor:
        """The update ``u`` before weight decay, in the reference's order
        of operations."""
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("these optimisers take no closure")
        self.step_count += 1
        lr_t = _f32(self._sched(self.step_count))
        for group in self.param_groups:
            wd = group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st.update(self._init_state(p, group))
                g = p.grad.to(torch.float32)
                u = self._update(g, st, group, lr_t)
                if wd:
                    u = u - p.to(torch.float32) * _f32(lr_t * _f32(wd))
                p.add_(u.to(p.dtype))


def _zeros(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


class SGD(Optimizer):
    def __init__(self, params, lr: LR, momentum: float = 0.0,
                 nesterov: bool = False, weight_decay: float = 0.0):
        super().__init__(params, lr, weight_decay, momentum=momentum,
                         nesterov=nesterov)

    def _init_state(self, p, group):
        return {"mu": _zeros(p)} if group["momentum"] else {}

    def _update(self, g, st, group, lr_t):
        m = group["momentum"]
        d = g
        if m:
            st["mu"] = st["mu"] * m + g
            d = st["mu"] * m + g if group["nesterov"] else st["mu"]
        return d * -lr_t


class Adam(Optimizer):
    def __init__(self, params, lr: LR, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, lr, weight_decay, b1=b1, b2=b2, eps=eps)

    def _init_state(self, p, group):
        return {"m": _zeros(p), "v": _zeros(p)}

    def _update(self, g, st, group, lr_t):
        b1, b2 = group["b1"], group["b2"]
        st["m"] = st["m"] * b1 + g * (1 - b1)
        st["v"] = st["v"] * b2 + g.square() * (1 - b2)
        # 1 - b**t in f32, as the reference forms it from an f32 step
        t = np.float32(self.step_count)
        bc1 = _f32(1 - np.float32(b1) ** t)
        bc2 = _f32(1 - np.float32(b2) ** t)
        return (st["m"] / bc1 * -lr_t) / ((st["v"] / bc2).sqrt()
                                           + group["eps"])


class AdamW(Adam):
    def __init__(self, params, lr: LR, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1):
        super().__init__(params, lr, b1=b1, b2=b2, eps=eps,
                         weight_decay=weight_decay)


class RMSprop(Optimizer):
    def __init__(self, params, lr: LR, decay: float = 0.9, eps: float = 1e-8,
                 momentum: float = 0.0, weight_decay: float = 0.0):
        super().__init__(params, lr, weight_decay, decay=decay, eps=eps,
                         momentum=momentum)

    def _init_state(self, p, group):
        st = {"nu": _zeros(p)}
        if group["momentum"]:
            st["mu"] = _zeros(p)
        return st

    def _update(self, g, st, group, lr_t):
        d = group["decay"]
        st["nu"] = st["nu"] * d + g.square() * (1 - d)
        scaled = g / (st["nu"].sqrt() + group["eps"])
        if group["momentum"]:
            st["mu"] = st["mu"] * group["momentum"] + scaled
            scaled = st["mu"]
        return scaled * -lr_t


class Adagrad(Optimizer):
    def __init__(self, params, lr: LR, eps: float = 1e-10,
                 initial_accumulator: float = 0.1,
                 weight_decay: float = 0.0):
        super().__init__(params, lr, weight_decay, eps=eps,
                         initial_accumulator=initial_accumulator)

    def _init_state(self, p, group):
        return {"acc": torch.full(p.shape, group["initial_accumulator"],
                                  dtype=torch.float32, device=p.device)}

    def _update(self, g, st, group, lr_t):
        st["acc"] = st["acc"] + g.square()
        return g * -lr_t / (st["acc"].sqrt() + group["eps"])


sgd, adam, adamw, rmsprop, adagrad = SGD, Adam, AdamW, RMSprop, Adagrad

_REGISTRY: dict[str, type[Optimizer]] = {
    "sgd": SGD,
    "adam": Adam,
    "adamw": AdamW,
    "rmsprop": RMSprop,
    "adagrad": Adagrad,
}


def get_optimizer(name: str, params: Iterable, lr: LR, **kwargs
                  ) -> Optimizer:
    """Look up an optimiser by the name used in the paper's Table I."""
    key = name.lower()
    if key not in _REGISTRY:
        raise KeyError(f"unknown optimiser {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[key](params, lr, **kwargs)
