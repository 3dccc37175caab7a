"""Plain PyTorch version of the flash-attention kernel: the whole score
matrix, masked, through one f32 softmax."""
from __future__ import annotations

import torch

NEG_INF = -1e30
#: unit roundoff of bfloat16 (8 significant bits)
BF16_U = 2.0 ** -8


def _scores(q, k, *, causal, window, scale, valid_len):
    """Scaled f32 scores [B,Hkv,G,Sq,Sk], masked to -1e30, and the [Sq]
    rows that have at least one unmasked column."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    valid_len = valid_len or sk
    qg = q.float().reshape(b, hkv, hq // hkv, sq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    row = torch.arange(sq, device=q.device)[:, None]
    col = torch.arange(sk, device=q.device)[None, :]
    ok = col < valid_len
    if causal:
        ok = ok & (col <= row)
    if window:
        ok = ok & ((row - col) < window)
    return torch.where(ok, s, NEG_INF), ok.any(dim=-1)[:, None]


def _probs(q, k, *, causal, window, scale, valid_len):
    """Normalised f32 probabilities [B,Hkv,G,Sq,Sk] and the [Sq] rows that
    have at least one unmasked column."""
    s, live = _scores(q, k, causal=causal, window=window, scale=scale,
                      valid_len=valid_len)
    return torch.softmax(s, dim=-1), live


def _apply(p, v, live, hq):
    b, hkv, _, sq, _ = p.shape
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v)
    return torch.where(live, out, 0.0).reshape(b, hq, sq, v.shape[-1])


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0, scale=None,
                  valid_len: int = 0, return_lse: bool = False):
    """q [B,Hq,Sq,D], k/v [B,Hkv,Sk,D] → [B,Hq,Sq,D] in q's dtype.

    Masks ``col < valid_len`` (0 means Sk), ``col <= row`` when causal and
    ``row - col < window`` when ``window > 0``; a row with no unmasked
    column gives 0.  Kv head of query head h is ``h // (Hq // Hkv)``.

    With ``return_lse`` also each row's log-sum-exp of its scaled scores,
    f32 [B,Hq,Sq], in natural-log units: ``m + log(l)``, the reference's
    ``lse`` (``repro/models/attention.py:136``); a row with no unmasked
    column gives -1e30, as there (all its scores are -1e30).
    """
    s, live = _scores(q, k, causal=causal, window=window, scale=scale,
                      valid_len=valid_len)
    out = _apply(torch.softmax(s, dim=-1), v.float(), live,
                 q.shape[1]).to(q.dtype)
    if not return_lse:
        return out
    b, hq, sq, _ = q.shape
    return out, torch.logsumexp(s, dim=-1).reshape(b, hq, sq)


def bf16_tolerance(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: int = 0, scale=None,
                   valid_len: int = 0, sigmas: float = 8.0):
    """For bf16 q, k, v [B,H,S,D] as in :func:`attention_ref`: the f32
    attention ``want`` of these values and a per-element limit ``tol`` on
    the distance of a bf16 kernel's output from it, both f32 [B,Hq,Sq,D].

    A kernel that accumulates in f32 but rounds P to bf16 before P·V and
    rounds its output to bf16 lies within the sum of:
    - 2e-5: f32 sums in another order (the f32 check's limit);
    - ``u·|want|``: the output's rounding, ``u`` = 2^-8;
    - P's rounding, each p off by at most ``u·p``: the smaller of the worst
      case ``u·Σp|v|`` and the Hoeffding limit ``sigmas·u·sqrt(Σp²v²)``,
      which independent roundings pass with probability
      ``2·exp(-sigmas²/2)`` per element (3e-14 at 8).
    p is normalised.  A key wrongly taken in or left out moves a row by
    ``p·|v - want|``, about ``|v|/n`` for n live keys of similar score,
    while the rounding terms shrink like ``1/sqrt(n)``, so a mask that is
    off by one exceeds ``tol`` for long rows."""
    p, live = _probs(q, k, causal=causal, window=window, scale=scale,
                     valid_len=valid_len)
    hq, vf = q.shape[1], v.float()
    want = _apply(p, vf, live, hq)
    worst = _apply(p, vf.abs(), live, hq)
    spread = _apply(p.square(), vf.square(), live, hq).sqrt()
    del p
    tol = 2e-5 + BF16_U * (want.abs() + torch.minimum(worst,
                                                       sigmas * spread))
    return want, tol
