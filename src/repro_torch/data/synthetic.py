"""Synthetic data (the port of ``repro.data.synthetic``).

Token batches for every model family — token streams for LMs, embedding
sequences for the VLM backbone, frame embeddings for the audio encoder —
drawn on the host from ``np.random.default_rng(seed)`` in the reference's
order, so they equal its batches bit for bit, then placed on a torch
device (None = cuda).  The LM stream is a learnable order-1 Markov source
so short training runs show a falling loss.  Tokens are int64 (torch's
index type; the reference's are int32 of the same values).

Tabular regression sets for the profiling predictors, in numpy as in the
reference: the same seed gives the same permutation, so the port and the
reference split and train on identical batches.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device


def train_batch(cfg, batch_size: int, seq_len: int, seed: int = 0,
                device: DeviceLike = None) -> dict:
    """One training batch matching the family's ``train_loss``: tokens
    [B,S+1]; a VLM's embeds [B,S,d] (f32) and labels [B,S]; the audio
    family's frames [B,enc_seq,d] (f32) and tokens [B,S+1]."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        frames = rng.normal(size=(batch_size, cfg.enc_seq, cfg.d_model),
                            scale=0.5).astype(np.float32)
        tokens = _markov_tokens(rng, batch_size, seq_len + 1, cfg.vocab_size)
        return {"frames": torch.as_tensor(frames, device=dev),
                "tokens": _ids(tokens, dev)}
    if cfg.family == "vlm":
        embeds = rng.normal(size=(batch_size, seq_len, cfg.d_model),
                            scale=0.5).astype(np.float32)
        labels = _markov_tokens(rng, batch_size, seq_len, cfg.vocab_size)
        return {"embeds": torch.as_tensor(embeds, device=dev),
                "labels": _ids(labels, dev)}
    tokens = _markov_tokens(rng, batch_size, seq_len + 1, cfg.vocab_size)
    return {"tokens": _ids(tokens, dev)}


def prefill_batch(cfg, batch_size: int, seq_len: int, seed: int = 0,
                  device: DeviceLike = None) -> dict:
    """A prompt of ``seq_len``: the first ``seq_len`` tokens of a training
    batch (a VLM's embeds; audio's frames and tokens)."""
    b = train_batch(cfg, batch_size, max(seq_len - 1, 1), seed, device)
    if cfg.family == "vlm":
        return {"embeds": b["embeds"]}
    if cfg.family == "audio":
        return {"frames": b["frames"], "tokens": b["tokens"][:, :seq_len]}
    return {"tokens": b["tokens"][:, :seq_len]}


def decode_batch(cfg, batch_size: int, seed: int = 0,
                 device: DeviceLike = None) -> dict:
    """One uniform token per row: {"token": [B,1]}."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, size=(batch_size, 1))
    return {"token": _ids(tok, resolve_device(device))}


def _ids(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(a.astype(np.int64), device=device)


def _markov_tokens(rng, batch: int, seq: int, vocab: int) -> np.ndarray:
    """Order-1 Markov chain over a small state set mapped into the vocab —
    learnable structure for loss-decrease tests.  int32 [batch, seq], the
    reference's draws in its order."""
    states = min(vocab, 16)
    trans = rng.dirichlet(np.ones(states) * 0.3, size=states)
    out = np.zeros((batch, seq), np.int64)
    s = rng.integers(0, states, size=batch)
    for t in range(seq):
        out[:, t] = s
        u = rng.random(batch)
        cum = np.cumsum(trans[s], axis=1)
        s = (u[:, None] < cum).argmax(axis=1)
    # map states onto spread-out vocab ids to exercise the full embed table
    ids = np.linspace(0, vocab - 1, states, dtype=np.int64)
    return ids[out].astype(np.int32)


@dataclasses.dataclass
class TabularDataset:
    x: np.ndarray                   # [N, F] float32
    y: np.ndarray                   # [N, T] float32 (multi-target)
    feature_names: list[str]
    target_names: list[str]

    def split(self, frac: float = 0.8, seed: int = 0):
        rng = np.random.default_rng(seed)
        idx = rng.permutation(len(self.x))
        k = int(len(idx) * frac)
        tr, te = idx[:k], idx[k:]
        mk = lambda i: TabularDataset(self.x[i], self.y[i],
                                      self.feature_names, self.target_names)
        return mk(tr), mk(te)

    def normalised(self):
        """Min-max normalise x and y (paper reports normalised RMSE)."""
        def norm(a):
            lo, hi = a.min(axis=0), a.max(axis=0)
            span = np.where(hi > lo, hi - lo, 1.0)
            return (a - lo) / span, (lo, span)
        xn, xs = norm(self.x)
        yn, ys = norm(self.y)
        return TabularDataset(xn.astype(np.float32), yn.astype(np.float32),
                              self.feature_names, self.target_names), (xs, ys)


def batch_indices(n: int, batch_size: int,
                  seed: int = 0) -> Iterator[np.ndarray]:
    """The row ids of each batch of :func:`batches`: one permutation of
    ``n`` rows from ``default_rng(seed)``, the last partial batch
    dropped."""
    idx = np.random.default_rng(seed).permutation(n)
    for i in range(0, n - batch_size + 1, batch_size):
        yield idx[i:i + batch_size]


def batches(x: np.ndarray, y: np.ndarray, batch_size: int,
            seed: int = 0) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    for j in batch_indices(len(x), batch_size, seed):
        yield x[j], y[j]
