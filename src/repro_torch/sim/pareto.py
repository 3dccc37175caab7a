"""Pareto-aware streaming split planning: keep every live task's
(latency, energy, price) Pareto front alive and re-pick along it as the
link drifts, instead of committing to one scalarisation at admission — the
port of ``repro.sim.pareto``.

:class:`ParetoStreamScheduler`:

  * at admission, computes the task's full ``[L+1, K]`` component
    matrix, extracts the non-dominated front over the configured
    ``pareto_objectives``, and picks the scalarised argmin *restricted
    to the front* (:func:`repro_torch.core.costs.pareto_pick`);
  * on every link observation, recomputes the components of all live
    tasks in ONE batched ``cost.components`` call per distinct layer
    chain (the environments stack into one
    :class:`repro_torch.core.decisions.EnvArrays`), re-extracts the
    current fronts, and re-picks — counting a *switch* whenever a task's
    chosen split moves;
  * verifies (``verify=True``, cheap) that every pick is on the current
    non-dominated front before accepting it.

The component stack, the fronts and the picks are f64 tensors on
``torch_device`` (None = cuda); each call brings its picks, front sizes
and verification home in one copy.  The live set and the counters are host
state.  Completion returns the realised components of both the live pick
and the admission-time pick under the *final* link state.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core import costs as co
from repro_torch.core.decisions import make_envs
from repro_torch.core.offload import LayerCost
from repro_torch.hw import DeviceSpec, get_device
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.sim.telemetry import Telemetry

#: default objective subset the domination test runs on (deadline slack
#: stays in the scalarisation but not the front, per the paper's
#: latency/energy/price trade-off)
PARETO_OBJECTIVES = ("latency_s", "energy_j", "price")


@dataclasses.dataclass
class SplitState:
    """One live task's split plan."""
    rid: int
    layers: Sequence[LayerCost]
    input_bytes: float
    deadline_s: Optional[float]
    pick: int                        # current split on the live front
    admission_pick: int
    front_size: int
    switches: int = 0
    history: list = dataclasses.field(default_factory=list)


class ParetoStreamScheduler:
    """Online device↔edge split planner that re-picks along live
    Pareto fronts.

    ``cost`` must expose the multi-objective ``components`` /
    ``objectives`` / ``scalarize`` surface (default: an equal-weight
    :class:`repro_torch.core.costs.CompositeCost` over the analytic base);
    ``pareto_objectives`` names the objectives the domination test uses.
    ``device``/``edge`` are :class:`DeviceSpec`s; the sweep runs on
    ``torch_device`` (None = cuda).
    """

    def __init__(self, cost=None, *, device: Optional[DeviceSpec] = None,
                 edge: Optional[DeviceSpec] = None,
                 pareto_objectives: Sequence[str] = PARETO_OBJECTIVES,
                 link_latency_s: float = 0.005, verify: bool = True,
                 telemetry: Optional[Telemetry] = None,
                 torch_device: DeviceLike = None):
        self.cost = cost if cost is not None else co.CompositeCost(
            price_per_edge_s=0.1, price_per_gb=0.02)
        missing = set(pareto_objectives) - set(self.cost.objectives)
        if missing:
            raise KeyError(
                f"pareto objectives {sorted(missing)} not produced by "
                f"{type(self.cost).__name__} "
                f"(objectives: {list(self.cost.objectives)})")
        self.pareto_objectives = tuple(pareto_objectives)
        self.device = device or get_device("jetson-orin-nano")
        self.edge = edge or get_device("edge-server-a100")
        self.torch_device = resolve_device(torch_device)
        self.link_latency_s = link_latency_s
        self.verify = verify
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self.obs = NULL_TRACER                   # set by simulate_stream
        self.live: dict[int, SplitState] = {}
        self.total_repicks = 0
        self.total_switches = 0
        self._env_key: Optional[tuple] = None    # one-slot env cache
        self._env_cache = None

    # -- internals --------------------------------------------------------
    def _envs(self, link_bw, input_bytes):
        """``link_bw`` may be a scalar (one observation for every row,
        the event-loop path) or an ``[E]`` vector (per-row observations,
        the fleet engine's slab-batched path).  A one-slot cache skips
        the rebuild when consecutive calls see the same observation and
        live set — the common static-link case."""
        ib = np.atleast_1d(np.asarray(input_bytes, np.float64))
        bw = np.broadcast_to(np.asarray(link_bw, np.float64), ib.shape)
        key = (bw.tobytes(), ib.tobytes())
        if key == self._env_key:
            return self._env_cache
        envs = make_envs(self.device, self.edge, link_bw=bw,
                         link_latency_s=self.link_latency_s,
                         input_bytes=ib, device=self.torch_device)
        self._env_key, self._env_cache = key, envs
        return envs

    def _pick_rows(self, layers, link_bw, input_bytes
                   ) -> tuple[torch.Tensor, np.ndarray, np.ndarray]:
        """``(components [E, L+1, K] on the device, picks [E], front sizes
        [E])`` for tasks sharing one layer chain at the current link
        state; picks and sizes come home in one copy."""
        envs = self._envs(link_bw, input_bytes)
        comp = self.cost.components(layers, envs).to(torch.float64)
        # rank with the model's own scalarisation (not a re-derived
        # weighted sum) so picks agree with decide_all(cost=...) up to
        # the front restriction, whatever the model's scalarize does
        front, picks = co.pareto_pick(comp, self.cost.objectives,
                                      subset=self.pareto_objectives,
                                      scalar=self.cost.scalarize(comp))
        on_front = front.gather(-1, picks[:, None])[:, 0]
        home = torch.stack([picks, front.sum(dim=-1),
                            on_front.to(torch.int64)]).cpu().numpy()
        if self.verify and not bool(home[2].all()):
            raise AssertionError(
                "pareto_pick returned a dominated split — "
                "cost model produced inconsistent components")
        return comp, home[0], home[1]

    # -- lifecycle --------------------------------------------------------
    def admit(self, rid: int, layers: Sequence[LayerCost],
              link_bw: float, *, input_bytes: float = 0.0,
              now: float = 0.0,
              deadline_s: Optional[float] = None) -> SplitState:
        """Plan the split for one admitted task at the current link
        observation; the task stays live (re-picked on every subsequent
        link event) until :meth:`complete`."""
        if rid in self.live:
            raise KeyError(f"rid {rid} already live")
        _, picks, sizes = self._pick_rows(layers, link_bw, [input_bytes])
        st = SplitState(rid=rid, layers=layers,
                        input_bytes=float(input_bytes),
                        deadline_s=deadline_s, pick=int(picks[0]),
                        admission_pick=int(picks[0]),
                        front_size=int(sizes[0]),
                        history=[(float(now), int(picks[0]))])
        self.live[rid] = st
        self.telemetry.count("split_admissions")
        return st

    def admit_batch(self, rids: Sequence[int],
                    layers: Sequence[LayerCost], link_bw, *,
                    input_bytes: Sequence[float], now: float = 0.0,
                    deadlines_s: Optional[Sequence] = None
                    ) -> list[SplitState]:
        """Admit several tasks sharing one layer chain in ONE batched
        ``components`` call — the per-row picks are bit-for-bit what
        per-task :meth:`admit` calls at the same observations produce
        (the cost models are row-wise over the environment axis).  Used
        by the fleet engine to drain a whole slab's admissions at once.
        """
        rids = [int(r) for r in rids]
        ib = [float(b) for b in input_bytes]
        if deadlines_s is None:
            deadlines_s = [None] * len(rids)
        if not len(rids) == len(ib) == len(deadlines_s):
            raise ValueError("rids, input_bytes and deadlines_s must "
                             "have equal lengths")
        _, picks, sizes = self._pick_rows(layers, link_bw, ib)
        out = []
        for k, rid in enumerate(rids):
            if rid in self.live:
                raise KeyError(f"rid {rid} already live")
            st = SplitState(rid=rid, layers=layers, input_bytes=ib[k],
                            deadline_s=deadlines_s[k],
                            pick=int(picks[k]),
                            admission_pick=int(picks[k]),
                            front_size=int(sizes[k]),
                            history=[(float(now), int(picks[k]))])
            self.live[rid] = st
            self.telemetry.count("split_admissions")
            out.append(st)
        return out

    def on_link(self, link_bw: float, now: float = 0.0) -> int:
        """Re-pick every live task along its *current* front at the new
        link observation.  Tasks sharing a layer-chain object are
        re-picked in one batched ``components`` call.  Returns the
        number of tasks whose split switched."""
        if not self.live:
            return 0
        groups: dict[int, list[SplitState]] = {}
        for st in self.live.values():
            groups.setdefault(id(st.layers), []).append(st)
        switched = 0
        for members in groups.values():
            _, picks, sizes = self._pick_rows(
                members[0].layers, link_bw,
                [st.input_bytes for st in members])
            for k, st in enumerate(members):
                self.total_repicks += 1
                self.telemetry.count("split_repicks")
                st.front_size = int(sizes[k])
                new = int(picks[k])
                if new != st.pick:
                    if self.obs.enabled:
                        self.obs.instant(
                            "split_planner", "split_repick", float(now),
                            tid=st.rid,
                            args={"from": st.pick, "to": new})
                    st.pick = new
                    st.switches += 1
                    st.history.append((float(now), new))
                    switched += 1
                    self.total_switches += 1
                    self.telemetry.count("split_switches")
        return switched

    def on_saturation(self, link_bw: float, now: float = 0.0) -> int:
        """An edge pool's utilisation just crossed the saturation
        threshold from below: re-pick every live task's split along its
        current front (contention shifts the latency/energy trade-off,
        so picks made under an idle edge may now be tail-hostile).
        Counts ``split_saturation_repicks``; returns switches."""
        self.telemetry.count("split_saturation_repicks")
        return self.on_link(link_bw, now=now)

    def complete(self, rid: int, link_bw: float, *,
                 now: float = 0.0) -> dict:
        """Close a task's plan.  Returns its final pick, switch count,
        and the realised objective components — of both the live pick
        and the admission-time pick — under the final link state, so
        Pareto re-picking can be scored against commit-at-admission."""
        st = self.live.pop(rid)
        comp, _, _ = self._pick_rows(st.layers, link_bw, [st.input_bytes])
        names = tuple(self.cost.objectives)
        at = comp[0, [st.pick, st.admission_pick]].cpu().numpy()
        realised = {n: float(at[0, k]) for k, n in enumerate(names)}
        committed = {n: float(at[1, k]) for k, n in enumerate(names)}
        return {
            "rid": rid, "pick": st.pick,
            "admission_pick": st.admission_pick,
            "switches": st.switches, "front_size": st.front_size,
            "history": list(st.history), "finished_s": float(now),
            "realised": realised, "realised_at_admission_pick": committed,
        }
