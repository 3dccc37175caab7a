"""Learning-rate schedules (step -> lr), the port of
``repro.optim.schedules``: each is formed in f32, as the reference forms
it, and returned as a Python float."""
from __future__ import annotations

import numpy as np

F32 = np.float32


def constant(lr: float):
    def sched(step: int) -> float:
        return float(F32(lr))
    return sched


def cosine_decay(lr: float, decay_steps: int, alpha: float = 0.0):
    def sched(step: int) -> float:
        t = np.minimum(F32(step), F32(decay_steps)) / F32(decay_steps)
        cos = F32(0.5) * (F32(1) + np.cos(F32(np.pi) * t))
        return float(F32(lr) * (F32(1 - alpha) * cos + F32(alpha)))
    return sched


def warmup_cosine(lr: float, warmup_steps: int, decay_steps: int,
                  alpha: float = 0.1):
    cos = cosine_decay(lr, max(decay_steps - warmup_steps, 1), alpha)

    def sched(step: int) -> float:
        if step <= warmup_steps:
            return float(F32(lr) * F32(step) / F32(max(warmup_steps, 1)))
        return cos(step - warmup_steps)
    return sched
