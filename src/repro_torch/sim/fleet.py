"""The fleet engine's split decision, the one piece of ``repro.sim.fleet``
the event loop needs: :func:`_split_decide`.

The time-slabbed fleet engine itself (``simulate_fleet``) and the sharded
sweep (``decide_all_sharded``) are not ported yet (ROADMAP.md §1 item 6).
"""
from __future__ import annotations

from repro_torch.core import decisions as dec


def _split_decide(layers, envs, cost, backend) -> dec.DecisionPlan:
    """One admission's split plan over ``envs`` (on their torch device):
    ``backend`` is ``"kernel"`` (the ``decide_split`` kernel) or
    ``"torch"`` (the exact f64 sweep)."""
    if backend == "sharded":
        raise NotImplementedError(
            "split_backend='sharded' is not ported yet (ROADMAP.md §1 "
            "item 6: decide_all_sharded comes with the fleet engine)")
    return dec.decide_all(layers, envs, cost=cost, backend=backend,
                          device=envs.device)
