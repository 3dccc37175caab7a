"""Decoder-only transformer, dense family: prefill and decode.

Parameters are a :class:`~repro_torch.models.layers.ParamTree` with one
entry per layer (``params["layers"][l]``) where the reference stacks a
leading ``[L, ...]`` axis and scans; weights keep the reference's
``[in, out]`` layout.  Decode updates the KV cache in place.

    init_params(cfg, seed, device)              -> params
    forward(params, batch, cfg)                 -> logits [B,S,V]
    prefill(params, batch, cfg, max_len)        -> (logits [B,1,V], cache)
    decode_step(params, batch, cache, cfg)      -> (logits [B,1,V], cache)
    init_cache(cfg, batch_size, max_len, device) -> cache (zeros, pos 0)

MoE, MLA and VLM configs raise ``NotImplementedError``: ROADMAP.md §1
item 8 ports them.
"""
from __future__ import annotations

import math

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import (ParamTree, gated_mlp, init_tree,
                                       matmul, mlp_param_shapes, rms_norm)


def dtype_of(cfg) -> torch.dtype:
    """The config's weight and activation dtype (``"bfloat16"`` → bf16)."""
    return getattr(torch, cfg.dtype)


def _require_dense(cfg) -> None:
    if (cfg.family != "dense" or cfg.attn_kind != "gqa" or cfg.num_experts
            or cfg.takes_embeddings):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} with attn_kind "
            f"{cfg.attn_kind!r}, {cfg.num_experts} experts — the port runs "
            "the dense GQA family only; MoE, MLA and VLM models are "
            "ROADMAP.md §1 item 8")


# --------------------------------------------------------------------------
# Parameter shapes
# --------------------------------------------------------------------------
def layer_shapes(cfg) -> dict:
    _require_dense(cfg)
    d = cfg.d_model
    return {"ln1_scale": (d,), "ln2_scale": (d,),
            "attn": attn_mod.attn_param_shapes(cfg),
            "mlp": mlp_param_shapes(d, cfg.d_ff, cfg.mlp_act)}


def param_shapes(cfg) -> dict:
    shapes = {"embed": (cfg.vocab_size, cfg.d_model),
              "final_norm_scale": (cfg.d_model,),
              "layers": [layer_shapes(cfg) for _ in range(cfg.num_layers)]}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (cfg.d_model, cfg.vocab_size)
    return shapes


def init_params(cfg, seed: int = 0, device: DeviceLike = None) -> ParamTree:
    return init_tree(param_shapes(cfg), dtype_of(cfg), seed,
                     resolve_device(device))


# --------------------------------------------------------------------------
# Blocks
# --------------------------------------------------------------------------
def block_full(lp, x, cfg, positions, impl):
    """One pre-norm layer over a full segment.  Returns (x, (k, v))."""
    h, kv = attn_mod.gqa_self_attention(
        lp["attn"], rms_norm(x, lp["ln1_scale"], cfg.norm_eps), cfg,
        positions=positions, impl=impl)
    x = x + h
    f = gated_mlp(rms_norm(x, lp["ln2_scale"], cfg.norm_eps), lp["mlp"],
                  cfg.mlp_act)
    return x + f, kv


def block_decode(lp, x, cfg, cache_l, pos):
    """One layer, one token; writes this token's K/V into ``cache_l``."""
    h, (k, v) = attn_mod.gqa_decode_attention(
        lp["attn"], rms_norm(x, lp["ln1_scale"], cfg.norm_eps), cfg,
        k_cache=cache_l["k"], v_cache=cache_l["v"], pos=pos)
    x = x + h
    f = gated_mlp(rms_norm(x, lp["ln2_scale"], cfg.norm_eps), lp["mlp"],
                  cfg.mlp_act)
    return x + f, {"k": k, "v": v}


# --------------------------------------------------------------------------
# Full-model passes
# --------------------------------------------------------------------------
def _embed_in(params, batch, cfg):
    """Token embedding times sqrt(d_model), in the config's dtype (the
    reference's convention for every dense model, Qwen included)."""
    x = params["embed"][batch["tokens"]].to(dtype_of(cfg))
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)


def _lm_head(params, x, cfg):
    if cfg.tie_embeddings and "lm_head" not in params:
        return matmul(x, params["embed"].T)
    return matmul(x, params["lm_head"])


def backbone(params, batch, cfg, *, impl="chunked"):
    """All layers + final norm; returns hidden [B,S,d]."""
    x = _embed_in(params, batch, cfg)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for lp in params["layers"]:
        x, _ = block_full(lp, x, cfg, positions, impl)
    return rms_norm(x, params["final_norm_scale"], cfg.norm_eps)


def forward(params, batch, cfg, *, impl="chunked"):
    """Full-segment forward.  Returns logits [B,S,V]."""
    return _lm_head(params, backbone(params, batch, cfg, impl=impl), cfg)


# --------------------------------------------------------------------------
# KV cache: prefill & decode
# --------------------------------------------------------------------------
def cache_shapes(cfg, batch_size: int, max_len: int) -> dict:
    """(shape, dtype) of each cache tensor, stacked over layers; the cache
    also carries ``pos``, an int."""
    _require_dense(cfg)
    s = min(max_len, cfg.window) if cfg.window else max_len
    kv = (cfg.num_layers, batch_size, s, cfg.num_kv_heads, cfg.head_dim)
    return {"layers": {"k": (kv, dtype_of(cfg)), "v": (kv, dtype_of(cfg))}}


def init_cache(cfg, batch_size: int, max_len: int,
               device: DeviceLike = None) -> dict:
    dev = resolve_device(device)
    layers = {name: torch.zeros(shape, dtype=dt, device=dev) for name,
              (shape, dt) in cache_shapes(cfg, batch_size,
                                          max_len)["layers"].items()}
    return {"layers": layers, "pos": 0}


def prefill(params, batch, cfg, max_len: int, *, impl="chunked"):
    """Run the prompt; build the cache.  Returns (last-token logits,
    cache)."""
    x = _embed_in(params, batch, cfg)
    b, s = x.shape[0], x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :]
    cache = init_cache(cfg, b, max_len, x.device)
    cache_len = cache["layers"]["k"].shape[2]
    for l, lp in enumerate(params["layers"]):
        x, kv = block_full(lp, x, cfg, positions, impl)
        for name, val in zip(("k", "v"), kv):
            if cfg.window and s >= cache_len:
                # ring-buffer invariant: token p lives at slot p % window
                val = torch.roll(val[:, -cache_len:],
                                 shifts=(s - cache_len) % cache_len, dims=1)
            cache["layers"][name][l, :, :val.shape[1]] = val
    x = rms_norm(x, params["final_norm_scale"], cfg.norm_eps)
    cache["pos"] = s
    return _lm_head(params, x[:, -1:], cfg), cache


def decode_step(params, batch, cache, cfg):
    """One decode step.  batch: {"token": [B,1]}.  Updates ``cache`` in
    place and returns (logits [B,1,V], cache)."""
    x = _embed_in(params, {"tokens": batch["token"]}, cfg)
    pos = cache["pos"]
    for l, lp in enumerate(params["layers"]):
        x, _ = block_decode(lp, x, cfg, {"k": cache["layers"]["k"][l],
                                         "v": cache["layers"]["v"][l]}, pos)
    x = rms_norm(x, params["final_norm_scale"], cfg.norm_eps)
    cache["pos"] = pos + 1
    return _lm_head(params, x, cfg), cache
