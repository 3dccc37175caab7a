"""Continuous batching engine (slot-based, vLLM-style scheduling).

Unlike :class:`~repro_torch.serve.engine.ServeEngine` (static batches),
slots are freed the moment a sequence finishes and refilled from the
queue, so the decode step runs at full batch width.  An incoming request
is prefilled on its own (batch 1) and its cache rows are spliced into its
slot of the shared cache; decode runs all slots at ragged ``[B]``
positions.

With a cost model the engine closes the paper's offloading loop per
request: at admission it observes the link bandwidth and re-plans the
device/edge split of that request through
:func:`repro_torch.core.decisions.decide_all` (one E = 1 sweep: on the
card, one ``decide_split`` launch).

Deviations from the reference engine: the family check raises
``ValueError`` where the reference asserts; the model is built with the
default ``impl="chunked"`` (as :class:`ServeEngine` is), so each
admission's prefill runs the flash-attention kernel on the card; decode
runs eagerly and updates the cache in place (the reference jits it and
donates the cache).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.models import build_model
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.serve.engine import Request


class ContinuousBatchEngine:
    """Slot-based continuous batching for one model on one device.

    ``device=None`` is the card (and raises without one).  ``cost`` is an
    optional :mod:`repro_torch.core.costs` model; when set, every admitted
    request gets an offload split re-planned against the current
    ``link_bw`` observation (a float, or a zero-argument callable returning
    bytes/s) and recorded on ``request.offload``.  ``offload_device`` and
    ``offload_edge`` are the :class:`~repro_torch.hw.DeviceSpec`s of the
    end device and the edge server (defaults: jetson-orin-nano,
    edge-server-a100); ``decision_backend`` is ``"kernel"`` (the fused
    ``decide_split`` sweep) or ``"torch"`` (exact f64).

    Admission is clocked: a virtual clock (``clock``, anything with
    ``.now``, ``.advance`` and ``.advance_to``; default a new
    :class:`repro_torch.sim.events.Clock`) advances ``step_latency_s`` per
    decode step and jumps over idle gaps, and a request is admitted only
    once ``request.arrived_at`` has passed; ``request.admitted_at`` records
    the instant.  ``obs`` is a :class:`repro_torch.obs.Tracer` (``admit``
    and ``replan`` instants, each request's lifecycle spans, on the
    virtual clock); ``metrics`` a :class:`repro_torch.obs.MetricsRegistry`
    (quantile sketches of sojourn and queue wait, a count of completed
    requests).
    """

    def __init__(self, cfg, *, slots: int = 4, max_len: int = 256,
                 seed: int = 0, cost=None, link_bw=1.25e9,
                 offload_device=None, offload_edge=None,
                 decision_backend: str = "kernel", clock=None,
                 step_latency_s: float = 5e-3, obs=None, metrics=None,
                 device: DeviceLike = None):
        if not (cfg.family in ("dense", "moe", "vlm")
                and cfg.attn_kind == "gqa"):
            raise ValueError("continuous batching requires the "
                             "vector-position GQA decode path")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.api = build_model(cfg)
        self.slots = slots
        self.max_len = max_len
        self.cost = cost
        self.decision_backend = decision_backend
        self.link_bw = link_bw
        self.offload_device = offload_device
        self.offload_edge = offload_edge
        if clock is None:
            from repro_torch.sim.events import Clock
            clock = Clock()
        self.clock = clock
        self.step_latency_s = float(step_latency_s)
        self.obs = obs if obs is not None else NULL_TRACER
        self.metrics = metrics
        if metrics is not None:
            self._q_sojourn = metrics.quantile(
                "serve_sojourn_seconds",
                help="request sojourn (arrival to completion)")
            self._q_wait = metrics.quantile(
                "serve_queue_wait_seconds",
                help="request queue wait (arrival to admission)")
        self.replans = 0
        self.params = self.api.init_params(seed, self.device)
        self.cache = self.api.init_cache(slots, max_len, self.device)
        # per-slot state (host side)
        self.slot_pos = np.zeros(slots, np.int64)        # tokens consumed
        self.slot_req: list[Optional[Request]] = [None] * slots
        self.slot_remaining = np.zeros(slots, np.int64)
        self.slot_last_tok = np.zeros(slots, np.int64)
        self.steps = 0
        self.tokens_out = 0

    # -- prefill and cache splicing ------------------------------------------
    def _prefill(self, batch: dict):
        """Batch-1 prefill of one admitted prompt: (logits, cache)."""
        return self.api.prefill(self.params, batch, self.max_len)

    def _splice(self, slot: int, cache1: dict) -> None:
        """Copy a batch-1 cache's rows into ``slot`` of the shared cache
        (batch is dim 1 of every layer-stacked leaf)."""
        for name, big in self.cache["layers"].items():
            big[:, slot] = cache1["layers"][name][:, 0]

    # -- offload re-planning ------------------------------------------------
    def observe_link_bw(self) -> float:
        """Current link-bandwidth observation (bytes/s)."""
        bw = self.link_bw() if callable(self.link_bw) else self.link_bw
        return float(bw)

    def _plan_offload(self, req: Request) -> None:
        """Re-plan the device/edge split of one admitted request against
        the engine's cost model and a fresh link observation."""
        from repro_torch.core.decisions import decide_all, make_envs
        from repro_torch.core.offload import transformer_layer_costs
        from repro_torch.hw import get_device
        device = self.offload_device or get_device("jetson-orin-nano")
        edge = self.offload_edge or get_device("edge-server-a100")
        seq = max(len(req.prompt), 1)
        layers = transformer_layer_costs(self.cfg, seq, 1)
        envs = make_envs(device, edge,
                         link_bw=np.asarray([self.observe_link_bw()]),
                         input_bytes=4.0 * seq, device=self.device)
        req.offload = decide_all(layers, envs, cost=self.cost,
                                 backend=self.decision_backend,
                                 device=self.device)[0]
        self.replans += 1
        if self.obs.enabled:
            self.obs.instant("continuous_engine", "replan", self.clock.now,
                             tid=req.rid,
                             args={"split": int(req.offload.split)})

    # -- admission ----------------------------------------------------------
    def _admit(self, req: Request, slot: int) -> None:
        req.admitted_at = self.clock.now
        if self.obs.enabled:
            self.obs.instant("continuous_engine", "admit", self.clock.now,
                             tid=req.rid, args={"slot": slot})
        if self.cost is not None:
            self._plan_offload(req)
        tokens = torch.as_tensor(np.asarray(req.prompt)[None],
                                 dtype=torch.int64, device=self.device)
        logits, cache1 = self._prefill({"tokens": tokens})
        self._splice(slot, cache1)
        self.slot_pos[slot] = len(req.prompt)
        self.slot_req[slot] = req
        self.slot_remaining[slot] = req.max_new_tokens
        self.slot_last_tok[slot] = int(torch.argmax(logits[0, -1]))
        req.output = np.zeros(req.max_new_tokens, np.int32)
        req._written = 0              # type: ignore[attr-defined]

    # -- main loop ----------------------------------------------------------
    @torch.inference_mode()
    def serve(self, requests: list[Request]) -> list[Request]:
        queue = sorted(requests, key=lambda r: r.arrived_at)
        done: list[Request] = []
        while queue or any(r is not None for r in self.slot_req):
            # idle engine, future arrivals only: jump the virtual clock to
            # the next arrival instead of spinning empty decode steps
            if queue and not any(r is not None for r in self.slot_req) \
                    and queue[0].arrived_at > self.clock.now:
                self.clock.advance_to(queue[0].arrived_at)
            # fill free slots, only with requests that have arrived
            for s in range(self.slots):
                if self.slot_req[s] is None and queue \
                        and queue[0].arrived_at <= self.clock.now:
                    self._admit(queue.pop(0), s)
            # one decode step for all slots at their own positions
            toks = torch.as_tensor(self.slot_last_tok[:, None],
                                   device=self.device)
            self.cache["pos"] = torch.as_tensor(self.slot_pos,
                                                device=self.device)
            logits, self.cache = self.api.decode_step(
                self.params, {"token": toks}, self.cache)
            nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
            self.steps += 1
            self.clock.advance(self.step_latency_s)
            for s in range(self.slots):
                req = self.slot_req[s]
                if req is None:
                    continue
                w = req._written        # type: ignore[attr-defined]
                req.output[w] = self.slot_last_tok[s]
                req._written = w + 1    # type: ignore[attr-defined]
                self.tokens_out += 1
                self.slot_last_tok[s] = nxt[s]
                self.slot_pos[s] += 1
                self.slot_remaining[s] -= 1
                if self.slot_remaining[s] <= 0 \
                        or self.slot_pos[s] >= self.max_len - 1:
                    done.append(req)
                    self.slot_req[s] = None
                    if self.metrics is not None:
                        self._q_sojourn.observe(
                            self.clock.now - req.arrived_at)
                        self._q_wait.observe(
                            req.admitted_at - req.arrived_at)
                        self.metrics.counter(
                            "serve_requests_completed").inc()
                    if self.obs.enabled:
                        # virtual-clock lifecycle: sojourn [arrived, now] ⊃
                        # queue_wait [arrived, admitted] · service
                        # [admitted, now]
                        self.obs.task_spans(
                            "continuous_engine", req.rid, f"req{req.rid}",
                            req.arrived_at, req.admitted_at, self.clock.now)
        return done

    @property
    def occupancy(self) -> float:
        """Mean generated tokens per decode step (≤ slots)."""
        return self.tokens_out / max(self.steps, 1)
