"""Attention: GQA/MQA, sliding window, qk-norm; prefill and decode.

Two prefill paths compute the same function (the tests hold them together
and against the reference):

  * ``naive``   — the full score matrix through one softmax; the oracle.
  * ``chunked`` — :func:`chunked_attention`, the flash-attention forward of
                  ``kernels.flash_attention``: the plain version on CPU
                  tensors, the hand-written CUDA kernel on the card.

Under autograd ``chunked_attention`` runs :class:`FlashAttention`: the
same forward, which also keeps each row's log-sum-exp, and the flash
backward (the reference's ``repro/models/attention.py:167-213``), which
recomputes the probabilities key block by key block from that
log-sum-exp: the plain version on CPU tensors, the hand-written CUDA
kernel (``csrc/flash_attention_bwd.cu``) on the card.

``decode_attention`` is one query token against a (possibly ring-buffered)
KV cache, plain torch as in the reference.  On a mesh whose cache spec
splits the cache's sequence, each rank keeps its block: it writes the new
token only where its block holds the slot, and the softmax is the
distributed one (the row max, the sum of exponentials and ``p·V``
all-reduced over the axes that split the sequence), what GSPMD makes of
the reference's plain ``decode_attention``.

Shapes: q [B,Sq,Hq,D], k/v [B,Skv,Hkv,D]; grouping G = Hq // Hkv.
"""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.distributed import collectives as coll
from repro_torch.distributed.context import current_mesh, tp_axes
from torch.autograd.function import once_differentiable

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ops import \
    flash_attention_bwd as flash_attention_bwd_op
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
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


def chunked_attention(q, k, v, *, causal=True, window=0, scale=None,
                      valid_len=0):
    """Flash-attention forward (online softmax over key tiles, fully masked
    tiles skipped); on the card, the CUDA kernel.  When autograd records
    (grad mode on and q, k or v needing a gradient) it goes through
    :class:`FlashAttention`; otherwise nothing but the output is stored."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, scale,
                                    valid_len)
    return flash_attention(q, k, v, causal=causal, window=window,
                           scale=scale, valid_len=valid_len)


class FlashAttention(torch.autograd.Function):
    """Flash attention with the flash backward: the forward of
    :func:`chunked_attention` saving (q, k, v, out, lse), the backward the
    op ``repro_torch::flash_attention_bwd`` (the plain version on CPU
    tensors, the CUDA kernel on the card)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, valid_len):
        out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale, valid_len=valid_len,
                                   return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, scale=scale,
                        valid_len=valid_len)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        grads = flash_attention_bwd_op(*ctx.saved_tensors, do, **ctx.opts)
        return (*grads, None, None, None, None)


#: the plain backward (``kernels.flash_attention.ref.attention_bwd_ref``),
#: what the op runs on CPU tensors
flash_attention_bwd = attention_bwd_ref


def _pos_vector(pos: Pos, b: int, device) -> torch.Tensor:
    """``pos`` (int, 0-d or [B] tensor) as a [B] int64 tensor on ``device``
    (an int is filled there: no host-to-device copy, which would wait for
    the card's queue)."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.int64).expand(b)
    return torch.full((b,), int(pos), dtype=torch.int64, device=device)


def cache_slots(cache: torch.Tensor) -> torch.Tensor:
    """The sequence slot index of each row of a cache block [B, S, ...]:
    ``0..S-1``, or on a sequence split (``collectives.SeqSplit``) the
    block's own slots of the whole cache."""
    size = cache.shape[1]
    split = coll.seq_split_of(cache)
    base = 0 if split is None else split.index * size
    return torch.arange(base, base + size, device=cache.device)


def cache_write(cache: torch.Tensor, slot: torch.Tensor,
                new: torch.Tensor) -> None:
    """Write ``new`` [B, ...] at each row's ``slot`` ([B], the whole
    cache's index) of ``cache`` [B, S, ...] in place; on a sequence split
    only the rows whose slot lies in this block."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    split = coll.seq_split_of(cache)
    new = new.to(cache.dtype)
    if split is None:
        cache[rows, slot] = new
        return
    size = cache.shape[1]
    local = slot - split.index * size
    mine = ((local >= 0) & (local < size)).reshape(-1, *[1] * (new.ndim - 1))
    at = local.clamp(0, size - 1)
    cache[rows, at] = torch.where(mine, new, cache[rows, at])


def softmax_attend(s: torch.Tensor, attend, split) -> torch.Tensor:
    """``attend(softmax(s))`` for f32 masked scores ``s`` [..., S] and
    ``attend``: probabilities [..., S] -> [..., D] (the product with the
    values).  On a sequence split (``split``, a ``collectives.SeqSplit``)
    the distributed softmax: the row max all-reduced (MAX), then the sum
    of exponentials and ``attend`` of them (SUM) over ``split.axes``; the
    result in f32."""
    if split is None:
        return attend(torch.softmax(s, dim=-1))
    mesh = current_mesh()
    m = coll.all_reduce_max(s.amax(dim=-1, keepdim=True), mesh, split.axes)
    e = torch.exp(s - m)
    total = coll.all_reduce(e.sum(dim=-1, keepdim=True), mesh, split.axes)
    return coll.all_reduce(attend(e).float(), mesh, split.axes) / total


def decode_attention(q, k_cache, v_cache, pos: Pos, *, window=0,
                     scale=None):
    """One-token attention against a cache.

    q [B,1,Hq,D]; caches [B,Smax,Hkv,D]; ``pos`` — the absolute position of
    the query token: an int, or [B] for ragged per-slot positions.  With
    ``window > 0`` the cache is a ring buffer of Smax == window slots (slot
    = abs_pos % window); otherwise it is linear and slots <= pos are valid.
    A cache block split by sequence (``collectives.SeqSplit``, a decode
    step on a mesh) holds its slots of the whole: the valid mask reads
    their whole-cache index and the softmax is the distributed one
    (:func:`softmax_attend`).
    """
    b, _, hq, d = q.shape
    hkv = k_cache.shape[2]
    scale = scale if scale is not None else d ** -0.5
    slots = cache_slots(k_cache)
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
    out = softmax_attend(s, lambda p: torch.einsum(
        "bhgk,bkhd->bhgd", p.to(v_cache.dtype), v_cache),
        coll.seq_split_of(k_cache))
    return out.reshape(b, 1, hq, v_cache.shape[-1]).to(q.dtype)


def heads_across(cache: torch.Tensor, held: int, total: int) -> bool:
    """Whether a decode layer that holds ``held`` of ``total`` query heads
    scores every head against ``cache``: its sequence is split over the
    "model" ranks that split the heads, so each rank's block serves every
    head (its queries are gathered first, and its output cut back to its
    own heads)."""
    split = coll.seq_split_of(cache)
    return split is not None and "model" in split.axes and held < total


def _all_kv_heads(t: torch.Tensor, n_kv: int) -> torch.Tensor:
    """Every key/value head of a new token [B, 1, Hkv_local, D] from the
    "model" ranks' heads (a head shared by several ranks taken once)."""
    t = coll.tp_gather(t, 2)
    return t[:, :, ::t.shape[2] // n_kv]


def cached_attention(q, k_cache, v_cache, pos: Pos, *, n_heads: int,
                     n_kv_heads: int, new_kv=None, window=0):
    """The new token's (k, v) ([B,1,Hkv,D] each, or None: a cache written
    before) written at slot ``pos`` (``pos % window`` in a ring), then
    :func:`decode_attention` of ``q`` [B,1,Hq,D] at this layer's heads.
    Where the cache's sequence is split over the ranks that split the
    heads (:func:`heads_across`), the queries and the new key/value heads
    are gathered over "model", every head is scored against this block,
    and the output is cut back to this rank's heads."""
    b, _, hq, _ = q.shape
    across = heads_across(k_cache, hq, n_heads)
    if across:
        q = coll.tp_gather(q, 2)
    if new_kv is not None:
        pos_v = _pos_vector(pos, b, q.device)
        slot = torch.remainder(pos_v, window) if window else pos_v
        for cache, new in zip((k_cache, v_cache), new_kv):
            if across:
                new = _all_kv_heads(new, n_kv_heads)
            cache_write(cache, slot, new[:, 0])
    out = decode_attention(q, k_cache, v_cache, pos, window=window)
    if across:
        out = out.narrow(2, coll.group_rank(current_mesh(), tp_axes()) * hq,
                         hq)
    return out


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
    """q, k, v at the heads the weights hold: all of them, or on a mesh
    this rank's (``launch.steps``)."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    hq, hkv = params["wq"].shape[1] // hd, params["wk"].shape[1] // hd
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
    """Self-attention over a full segment (train / prefill).  Returns
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
    copies), then attention runs over the updated cache
    (:func:`cached_attention`).
    """
    b = x.shape[0]
    pos_v = _pos_vector(pos, b, x.device)
    q, k, v = _project_qkv(params, x, cfg, pos_v[:, None])
    out = cached_attention(q, k_cache, v_cache, pos, n_heads=cfg.num_heads,
                           n_kv_heads=cfg.num_kv_heads, new_kv=(k, v),
                           window=cfg.window)
    _, _, hq, hd = q.shape
    return matmul(out.reshape(b, 1, hq * hd), params["wo"]), (k_cache,
                                                              v_cache)
