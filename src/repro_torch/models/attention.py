"""Attention: GQA/MQA, sliding window, qk-norm; prefill and decode.

Two prefill paths compute the same function (the tests hold them together
and against the reference):

  * ``naive``   — the full score matrix through one softmax; the oracle.
  * ``chunked`` — :func:`chunked_attention`, the flash-attention forward of
                  ``kernels.flash_attention``: the plain version on CPU
                  tensors, the hand-written CUDA kernel on the card.

``decode_attention`` is one query token against a (possibly ring-buffered)
KV cache, plain torch as in the reference.  The port has no attention
backward: this slice serves.

Shapes: q [B,Sq,Hq,D], k/v [B,Skv,Hkv,D]; grouping G = Hq // Hkv.
"""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import apply_rope, matmul, rms_norm

NEG_INF = -1e30

Pos = Union[int, torch.Tensor]


def _group(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """[B,S,Hq,D] -> [B,S,Hkv,G,D]."""
    b, s, hq, d = q.shape
    return q.reshape(b, s, n_kv, hq // n_kv, d)


def _mask_bias(pos_q: torch.Tensor, pos_k: torch.Tensor, causal: bool,
               window: int, valid_k=None) -> torch.Tensor:
    """Additive f32 bias [..., Sq, Sk] from absolute positions."""
    dq = pos_q[..., :, None]
    dk = pos_k[..., None, :]
    ok = torch.ones(torch.broadcast_shapes(dq.shape, dk.shape),
                    dtype=torch.bool, device=pos_q.device)
    if causal:
        ok = ok & (dk <= dq)
    if window:
        ok = ok & ((dq - dk) < window)
    if valid_k is not None:
        ok = ok & valid_k[..., None, :]
    return torch.where(ok, 0.0, NEG_INF).float()


def naive_attention(q, k, v, *, causal=True, window=0, pos_q=None,
                    pos_k=None, valid_k=None, scale=None):
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if pos_q is None:
        pos_q = torch.arange(sq, device=q.device)
    if pos_k is None:
        pos_k = torch.arange(sk, device=q.device)
    scale = scale if scale is not None else d ** -0.5
    qg = _group(q, hkv)                                      # [B,Sq,Hkv,G,D]
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    scores = scores + _mask_bias(pos_q, pos_k, causal, window, valid_k)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, sq, hq, v.shape[-1]).to(q.dtype)


def chunked_attention(q, k, v, *, causal=True, window=0, scale=None):
    """Flash-attention forward (online softmax over key tiles, fully masked
    tiles skipped); on the card, the CUDA kernel."""
    return flash_attention(q, k, v, causal=causal, window=window,
                           scale=scale)


def _pos_vector(pos: Pos, b: int, device) -> torch.Tensor:
    """``pos`` (int, 0-d or [B] tensor) as a [B] int64 tensor on ``device``
    (an int is filled there: no host-to-device copy, which would wait for
    the card's queue)."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.int64).expand(b)
    return torch.full((b,), int(pos), dtype=torch.int64, device=device)


def decode_attention(q, k_cache, v_cache, pos: Pos, *, window=0,
                     scale=None):
    """One-token attention against a cache.

    q [B,1,Hq,D]; caches [B,Smax,Hkv,D]; ``pos`` — the absolute position of
    the query token: an int, or [B] for ragged per-slot positions.  With
    ``window > 0`` the cache is a ring buffer of Smax == window slots (slot
    = abs_pos % window); otherwise it is linear and slots <= pos are valid.
    """
    b, _, hq, d = q.shape
    smax, hkv = k_cache.shape[1], k_cache.shape[2]
    scale = scale if scale is not None else d ** -0.5
    slots = torch.arange(smax, device=q.device)
    pos_v = _pos_vector(pos, b, q.device)[:, None]
    if window:
        # absolute position held by each ring slot (after this step's write)
        valid = pos_v - torch.remainder(pos_v - slots[None, :], window) >= 0
    else:
        valid = slots[None, :] <= pos_v                         # [B,Smax]
    qg = _group(q, hkv)[:, 0]                                  # [B,Hkv,G,D]
    # native-dtype dot against the cache; softmax statistics in f32
    s = torch.einsum("bhgd,bkhd->bhgk", qg,
                     k_cache.to(q.dtype)).float() * scale
    s = s + torch.where(valid, 0.0, NEG_INF)[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(b, 1, hq, v_cache.shape[-1]).to(q.dtype)


# --------------------------------------------------------------------------
# Full GQA attention layer (projections + rope + qk-norm + attention)
# --------------------------------------------------------------------------
def attn_param_shapes(cfg) -> dict:
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    shapes = {"wq": (d, hq * hd), "wk": (d, hkv * hd), "wv": (d, hkv * hd),
              "wo": (hq * hd, d)}
    if cfg.use_qk_norm:
        shapes["q_norm_scale"] = (hd,)
        shapes["k_norm_scale"] = (hd,)
    return shapes


def _project_qkv(params, x, cfg, positions):
    b, s, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = matmul(x, params["wq"]).reshape(b, s, hq, hd)
    k = matmul(x, params["wk"]).reshape(b, s, hkv, hd)
    v = matmul(x, params["wv"]).reshape(b, s, hkv, hd)
    if cfg.use_qk_norm:
        q = rms_norm(q, params["q_norm_scale"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm_scale"], cfg.norm_eps)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_self_attention(params, x, cfg, *, positions, impl="chunked"):
    """Self-attention over a full segment (prefill).  Returns
    (out, (k, v))."""
    q, k, v = _project_qkv(params, x, cfg, positions)
    if impl == "naive":
        out = naive_attention(q, k, v, causal=True, window=cfg.window)
    else:
        out = chunked_attention(q, k, v, causal=True, window=cfg.window)
    b, s, hq, hd = q.shape
    return matmul(out.reshape(b, s, hq * hd), params["wo"]), (k, v)


def gqa_decode_attention(params, x, cfg, *, k_cache, v_cache, pos: Pos):
    """One-token self-attention; returns (out, (k_cache, v_cache)).

    ``pos`` is the absolute position of the incoming token — an int, or
    [B] for ragged slots.  Its K/V are written at slot ``pos % window``
    (ring) or ``pos`` (linear) *in place* (the reference returns updated
    copies), then attention runs over the updated cache.
    """
    b = x.shape[0]
    pos_v = _pos_vector(pos, b, x.device)
    q, k, v = _project_qkv(params, x, cfg, pos_v[:, None])
    slot = torch.remainder(pos_v, cfg.window) if cfg.window else pos_v
    rows = torch.arange(b, device=x.device)
    k_cache[rows, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[rows, slot] = v[:, 0].to(v_cache.dtype)
    out = decode_attention(q, k_cache, v_cache, pos, window=cfg.window)
    _, _, hq, hd = q.shape
    return matmul(out.reshape(b, 1, hq * hd), params["wo"]), (k_cache,
                                                              v_cache)
