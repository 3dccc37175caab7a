"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434).

KV state is compressed to a per-token latent ``c_kv`` of ``kv_lora_rank``
plus one shared rope key of ``qk_rope_dim``; per-head keys and values are
rebuilt with up-projections.  The decode cache holds only (c_kv, k_rope).

Prefill packs the rope part into the head dim, so one attention call takes
q/k at ``qk_nope_dim + qk_rope_dim`` and v at ``v_head_dim`` (on the card
the kernel takes v at that width, unpadded).  Two decode paths:

  * ``absorbed=False``: rebuild K/V for the whole context each step;
  * ``absorbed=True``: fold W_uk into the query and W_uv past the
    attention, so scores are taken against the latent cache.

``pos`` is an int or ``[B]`` ragged per-row positions
(:data:`~repro_torch.models.attention.Pos`); each row's new latent is
written in place at its own position.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import collectives as coll
from repro_torch.distributed.context import current_mesh, tp_axes
from repro_torch.models.attention import (NEG_INF, Pos, _pos_vector,
                                          cache_slots, cache_write,
                                          chunked_attention, heads_across,
                                          naive_attention, softmax_attend)
from repro_torch.models.layers import apply_rope, matmul, rms_norm


def mla_param_shapes(cfg) -> dict:
    d, h = cfg.d_model, cfg.num_heads
    r, dn, dr, dv = (cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    return {"wq": (d, h * (dn + dr)),      # queries (nope + rope parts)
            "w_dkv": (d, r),               # KV down-projection (latent)
            "w_kr": (d, dr),               # shared rope key
            "kv_norm_scale": (r,),
            "w_uk": (r, h * dn),           # latent -> per-head key (nope)
            "w_uv": (r, h * dv),           # latent -> per-head value
            "wo": (h * dv, d)}


def held_heads(params, cfg) -> int:
    """The heads the weights hold: all of them, or on a mesh this rank's
    (the latent and the shared rope key are every head's)."""
    return params["wq"].shape[1] // (cfg.qk_nope_dim + cfg.qk_rope_dim)


def _queries(params, x, cfg, positions):
    b, s, _ = x.shape
    h, dn, dr = held_heads(params, cfg), cfg.qk_nope_dim, cfg.qk_rope_dim
    q = matmul(x, params["wq"]).reshape(b, s, h, dn + dr)
    return q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope_theta)


def _latent(params, x, cfg, positions):
    c_kv = rms_norm(matmul(x, params["w_dkv"]), params["kv_norm_scale"],
                    cfg.norm_eps)                       # [B,S,r]
    k_rope = matmul(x, params["w_kr"])[:, :, None, :]   # [B,S,1,dr]
    return c_kv, apply_rope(k_rope, positions, cfg.rope_theta)[:, :, 0]


def mla_self_attention(params, x, cfg, *, positions, impl="chunked"):
    """Full-segment MLA (prefill).  Returns (out, (c_kv, k_rope))."""
    b, s, _ = x.shape
    h, dn, dv, dr = (held_heads(params, cfg), cfg.qk_nope_dim,
                     cfg.v_head_dim, cfg.qk_rope_dim)
    q_nope, q_rope = _queries(params, x, cfg, positions)
    c_kv, k_rope = _latent(params, x, cfg, positions)
    k_nope = matmul(c_kv, params["w_uk"]).reshape(b, s, h, dn)
    v = matmul(c_kv, params["w_uv"]).reshape(b, s, h, dv)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, dr)],
                  dim=-1)
    fn = naive_attention if impl == "naive" else chunked_attention
    out = fn(q, k, v, causal=True, scale=(dn + dr) ** -0.5)
    return matmul(out.reshape(b, s, h * dv), params["wo"]), (c_kv, k_rope)


def mla_decode_attention(params, x, cfg, *, ckv_cache, kr_cache, pos: Pos,
                         absorbed=True):
    """One-token MLA against the latent cache.

    ckv_cache [B,Smax,r], kr_cache [B,Smax,dr], written in place at
    ``pos`` (the reference returns updated copies).  Returns
    (out, (ckv_cache, kr_cache)).  On a mesh whose cache spec splits the
    latent's sequence (``collectives.SeqSplit``), each rank writes the new
    latent only where its block holds the slot and the softmax is the
    distributed one (``attention.softmax_attend``); where the split runs
    over the "model" ranks that split the heads, every head is scored
    against the block (the queries gathered over "model": the absorbed
    path's latent-space ones, the naive path's with its up-projections)
    and the output cut back to this rank's heads."""
    b = x.shape[0]
    h, dn, dv, dr, r = (held_heads(params, cfg), cfg.qk_nope_dim,
                        cfg.v_head_dim, cfg.qk_rope_dim, cfg.kv_lora_rank)
    pos_v = _pos_vector(pos, b, x.device)
    positions = pos_v[:, None]
    q_nope, q_rope = _queries(params, x, cfg, positions)    # [B,1,h,dn/dr]
    c_new, kr_new = _latent(params, x, cfg, positions)
    cache_write(ckv_cache, pos_v, c_new[:, 0])
    cache_write(kr_cache, pos_v, kr_new[:, 0])
    split = coll.seq_split_of(ckv_cache)
    across = heads_across(ckv_cache, h, cfg.num_heads)
    smax = ckv_cache.shape[1]
    valid = cache_slots(ckv_cache)[None, :] <= positions
    bias = torch.where(valid, 0.0, NEG_INF)[:, None, :]     # [B,1,Smax]
    scale = (dn + dr) ** -0.5
    dt = x.dtype
    ckv, kr = ckv_cache.to(dt), kr_cache.to(dt)
    w_uk, w_uv = params["w_uk"], params["w_uv"]
    if across:
        q_rope = coll.tp_gather(q_rope, 2)
    s_rope = torch.einsum("bohd,bsd->bhs", q_rope, kr)
    if absorbed:
        # W_uk folded into the query: per-head latent-space query [B,h,r]
        q_lat = torch.einsum("bohd,rhd->bhr", q_nope,
                             w_uk.reshape(r, h, dn).to(dt))
        if across:
            q_lat = coll.tp_gather(q_lat, 1)
        s_nope = torch.einsum("bhr,bsr->bhs", q_lat, ckv)
        s = (s_nope + s_rope).float() * scale + bias
        o_lat = softmax_attend(s, lambda p: torch.einsum(
            "bhs,bsr->bhr", p.to(dt), ckv), split).to(dt)
        if across:
            o_lat = _own_heads(o_lat, h)
        out = torch.einsum("bhr,rhd->bhd", o_lat,
                           w_uv.reshape(r, h, dv).to(dt))
    else:
        # rebuild K/V for the whole context every step (every head's, from
        # the up-projections gathered over "model", where the block serves
        # every head)
        if across:
            q_nope = coll.tp_gather(q_nope, 2)
            w_uk, w_uv = coll.tp_gather(w_uk, 1), coll.tp_gather(w_uv, 1)
        hs = q_nope.shape[2]
        k_nope = matmul(ckv_cache, w_uk).reshape(b, smax, hs, dn)
        v = matmul(ckv_cache, w_uv).reshape(b, smax, hs, dv)
        s_nope = torch.einsum("bohd,bshd->bhs", q_nope, k_nope.to(dt))
        s = (s_nope + s_rope).float() * scale + bias
        out = softmax_attend(s, lambda p: torch.einsum(
            "bhs,bshd->bhd", p.to(dt), v), split).to(dt)
        if across:
            out = _own_heads(out, h)
    out = out.reshape(b, 1, h * dv).to(x.dtype)
    return matmul(out, params["wo"]), (ckv_cache, kr_cache)


def _own_heads(t: torch.Tensor, h: int) -> torch.Tensor:
    """This "model" rank's ``h`` heads of [B, H, ...] computed for every
    head."""
    return t.narrow(1, coll.group_rank(current_mesh(), tp_axes()) * h, h)
