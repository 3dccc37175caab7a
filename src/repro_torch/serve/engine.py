"""Batched serving engine: prefill + decode with a static-batch scheduler.

Requests are batched to the engine's batch size, prefill builds the KV
(and SSM) cache, greedy or temperature decode runs step by step.  The
offloading decision — serve locally or ship to an edge node — goes to the
port's decision core (``core.decisions.decide_all``), closing the paper's
loop.

One deliberate difference from the reference engine: it builds its model
with ``impl="naive"`` (a full ``[B, Hkv, G, S, S]`` f32 score matrix per
layer); this engine builds with the default ``impl="chunked"``, so prefill
attention runs the flash-attention kernel, Mamba2 prefill the SSD scan
kernel and the sLSTM recurrence its scan kernel on the card.  The reference calls the two implementations
numerically equivalent; the tests hold this engine against the reference
engine.

Reproduced as the reference does it (not repaired): :meth:`ServeEngine.
serve` left-pads shorter prompts with token 0 under no attention mask (an
xLSTM's recurrent state takes the zeros in), and fills a short last batch
with copies of its last request (``rid=-1``).  An audio model's encoder
frames (the stubbed frontend's output) are drawn on the host from the
batch's seed, as the reference draws them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.models import build_model
from repro_torch.obs.trace import NULL_TRACER


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray               # [S] int32
    max_new_tokens: int = 16
    temperature: float = 0.0
    arrived_at: float = 0.0
    # virtual time of admission to a slot: filled by ContinuousBatchEngine
    # (admitted_at >= arrived_at); stays 0.0 under ServeEngine
    admitted_at: float = 0.0
    # filled on completion
    output: Optional[np.ndarray] = None
    first_token_s: float = 0.0
    total_s: float = 0.0
    # the SplitDecision that ContinuousBatchEngine plans at admission when
    # it carries a cost model (ServeEngine plans per batch: offload_plan)
    offload: Optional[object] = None


@dataclasses.dataclass
class EngineStats:
    served: int = 0
    tokens_out: int = 0
    prefill_s: float = 0.0
    decode_s: float = 0.0

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_out / max(self.decode_s, 1e-9)


class ServeEngine:
    """Static-batch serving for one model on one device.

    ``device=None`` is the card (and raises without one).  ``cost`` is an
    optional :mod:`repro_torch.core.costs` model, the default of
    :meth:`offload_plan`; ``decision_backend`` is ``"kernel"`` (the fused
    ``decide_split`` sweep) or ``"torch"`` (exact f64).  ``obs`` is a
    :class:`repro_torch.obs.Tracer` (a ``prefill`` and a ``decode`` span
    and a ``first_token`` instant per batch, on the host's wall clock);
    ``metrics`` a :class:`repro_torch.obs.MetricsRegistry` (quantile
    sketches of the first token and of each request's latency, a count of
    completed requests).
    """

    def __init__(self, cfg, *, batch_size: int = 4, max_len: int = 256,
                 seed: int = 0, cost=None, decision_backend: str = "kernel",
                 obs=None, metrics=None, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.api = build_model(cfg)
        self.batch_size = batch_size
        self.max_len = max_len
        self.cost = cost
        self.decision_backend = decision_backend
        self.obs = obs if obs is not None else NULL_TRACER
        self.metrics = metrics
        if metrics is not None:
            self._q_first = metrics.quantile(
                "serve_first_token_seconds",
                help="time to first token per batch")
            self._q_total = metrics.quantile(
                "serve_request_total_seconds",
                help="end-to-end request latency")
        self._batches = 0                # obs track row per batch
        self.params = self.api.init_params(seed, self.device)
        self.stats = EngineStats()
        self.last_first_token_s = 0.0

    def load_params(self, params):
        self.params = params

    def _now(self) -> float:
        """Host clock after the device has finished its queued work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    # -- core batched generation ------------------------------------------
    @torch.inference_mode()
    def generate_batch(self, prompts: np.ndarray, max_new: int,
                       temperature=0.0, seed: int = 0) -> np.ndarray:
        """prompts [B, S] → generated tokens [B, max_new].

        ``temperature`` may be a scalar (whole batch) or a ``[B]`` vector
        (per row; ≤ 0 means greedy for that row).  Sampled rows draw from
        a ``torch.Generator`` seeded with ``seed``.
        """
        b, s = prompts.shape
        assert b == self.batch_size, (b, self.batch_size)
        t0 = self._now()
        batch = {"tokens": torch.as_tensor(prompts, dtype=torch.int64,
                                           device=self.device)}
        if self.cfg.family == "audio":
            # the stubbed frontend's frames, drawn on the host as the
            # reference engine draws them, uploaded once per batch
            frames = np.random.default_rng(seed).normal(
                size=(b, self.cfg.enc_seq, self.cfg.d_model))
            batch["frames"] = torch.as_tensor(frames.astype(np.float32),
                                              device=self.device)
        logits, cache = self.api.prefill(self.params, batch, self.max_len)
        t_pf = self._now()
        self.stats.prefill_s += t_pf - t0

        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        tok = self._sample(logits[:, -1], temperature, gen)
        t_ft = self._now()
        self.last_first_token_s = t_ft - t0
        t1 = t_ft
        toks = []
        for _ in range(max_new):
            toks.append(tok)
            logits, cache = self.api.decode_step(self.params,
                                                 {"token": tok}, cache)
            tok = self._sample(logits[:, -1], temperature, gen)
        out = torch.cat(toks, dim=1).to(torch.int32).cpu().numpy()
        t_end = self._now()
        self.stats.decode_s += t_end - t1
        self.stats.tokens_out += b * max_new
        if self.metrics is not None:
            self._q_first.observe(self.last_first_token_s)
        if self.obs.enabled:
            # the spans reuse the wall readings above: tracing adds no
            # clock reads to the serving path
            bid = self._batches
            self._batches += 1
            self.obs.span("serve_engine", "prefill", t0, t_pf, tid=bid,
                          args={"batch": b})
            self.obs.instant("serve_engine", "first_token", t_ft, tid=bid)
            self.obs.span("serve_engine", "decode", t1, t_end, tid=bid,
                          args={"tokens": b * max_new})
        return out

    @staticmethod
    def _sample(logits: torch.Tensor, temperature,
                gen: torch.Generator) -> torch.Tensor:
        """[B, V] logits → [B, 1] int64 tokens."""
        greedy = torch.argmax(logits, dim=-1)
        temp = torch.as_tensor(temperature, dtype=torch.float32)
        if temp.ndim == 0:
            if float(temp) <= 0:
                return greedy[:, None]
            temp = temp.expand(logits.shape[0])
        temp = temp.to(logits.device)
        probs = torch.softmax(
            logits.float() / temp.clamp_min(1e-6)[:, None], dim=-1)
        sampled = torch.multinomial(probs, 1, generator=gen)[:, 0]
        return torch.where(temp > 0, sampled, greedy)[:, None]

    # -- broker loop --------------------------------------------------------
    def serve(self, requests: list[Request]) -> list[Request]:
        """Process a queue of requests in arrival order, batched."""
        queue = sorted(requests, key=lambda r: r.arrived_at)
        done = []
        while queue:
            chunk = queue[:self.batch_size]
            queue = queue[self.batch_size:]
            # pad the batch to engine size with dummy repeats
            while len(chunk) < self.batch_size:
                chunk.append(dataclasses.replace(chunk[-1], rid=-1))
            s = max(len(r.prompt) for r in chunk)
            prompts = np.stack([
                np.pad(r.prompt, (s - len(r.prompt), 0)) for r in chunk])
            max_new = max(r.max_new_tokens for r in chunk)
            temps = np.asarray([r.temperature for r in chunk], np.float32)
            t0 = time.perf_counter()
            outs = self.generate_batch(prompts, max_new, temps)
            dt = time.perf_counter() - t0
            for r, o in zip(chunk, outs):
                if r.rid < 0:
                    continue
                r.output = o[:r.max_new_tokens]
                r.first_token_s = self.last_first_token_s
                r.total_s = dt
                done.append(r)
                self.stats.served += 1
                if self.metrics is not None:
                    self._q_total.observe(dt)
                    self.metrics.counter("serve_requests_completed").inc()
        return done

    # -- offload delegation -------------------------------------------------
    def offload_plan(self, link_bws, *, device=None, edge=None,
                     seq_len: int = 0, link_latency_s: float = 0.005,
                     cost=None, backend=None):
        """Split-computing plan for this model across candidate link
        states, on the engine's device: one ``[n_links, L+1]`` sweep.
        ``device``/``edge`` are the :class:`~repro_torch.hw.DeviceSpec`s
        of the end device and the edge server (defaults: jetson-orin-nano,
        edge-server-a100); ``cost`` and ``backend`` override the engine's.
        Returns a :class:`repro_torch.core.decisions.DecisionPlan`."""
        from repro_torch.core.decisions import decide_all, make_envs
        from repro_torch.core.offload import transformer_layer_costs
        from repro_torch.hw import get_device
        device = device or get_device("jetson-orin-nano")
        edge = edge or get_device("edge-server-a100")
        seq_len = seq_len or self.max_len
        layers = transformer_layer_costs(self.cfg, seq_len, self.batch_size)
        envs = make_envs(device, edge,
                         link_bw=np.atleast_1d(link_bws).astype(np.float64),
                         link_latency_s=link_latency_s,
                         input_bytes=4.0 * self.batch_size * seq_len,
                         device=self.device)
        return decide_all(layers, envs,
                          cost=cost if cost is not None else self.cost,
                          backend=backend or self.decision_backend,
                          device=self.device)
