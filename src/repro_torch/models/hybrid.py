"""Zamba2-style hybrid: Mamba2 backbone + one *shared* attention block
(arXiv:2411.15242).

The shared transformer block (attention + MLP, one weight set) runs before
every ``cfg.shared_attn_every``-th Mamba2 layer.  Layers form G groups of
K = ``shared_attn_every``:

    for g in range(G):
        x += shared_attn(ln(x)); x += shared_mlp(ln(x))   # own KV slot g
        for l in group g's real layers:
            x += mamba2(ln(x))

When L % K != 0 the reference pads the last group with identity layers
(residual times 0, decode state kept) and stores weights and caches for
them.  The port skips those slots outright — the logits are the same —
so its Mamba parameters and SSM/conv caches hold the L real layers only
(``params["mamba"][l]``, ``cache["ssm"][l]``); ``pad_fraction`` still
reports the reference's padding.  Decode updates the caches in place.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.context import constrain
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba2 as m2
from repro_torch.models.layers import (ParamTree, embed_lookup, gated_mlp,
                                       init_tree, mlp_param_shapes, rms_norm)
from repro_torch.models.transformer import _lm_head, dtype_of, head_loss


def _grouping(cfg) -> tuple[int, int]:
    k = cfg.shared_attn_every
    return -(-cfg.num_layers // k), k


def pad_fraction(cfg) -> float:
    g, k = _grouping(cfg)
    return (g * k - cfg.num_layers) / (g * k)


def valid_mask(cfg) -> torch.Tensor:
    """[G, K] f32: 1 for a real layer, 0 for a padded slot."""
    g, k = _grouping(cfg)
    return (torch.arange(g * k).reshape(g, k) < cfg.num_layers).float()


def _group_layers(cfg, gi: int) -> range:
    """Indices of the real Mamba layers of group ``gi``."""
    _, k = _grouping(cfg)
    return range(gi * k, min((gi + 1) * k, cfg.num_layers))


def param_shapes(cfg) -> dict:
    d = cfg.d_model
    mamba = {**m2.mamba2_param_shapes(cfg), "pre_norm_scale": (d,)}
    return {
        "embed": (cfg.vocab_size, d),
        "final_norm_scale": (d,),
        "mamba": [mamba for _ in range(cfg.num_layers)],
        # shared *transformer* block (attn + MLP), one weight set reused
        "shared_attn": {
            "ln_scale": (d,),
            "attn": attn_mod.attn_param_shapes(cfg),
            "ln2_scale": (d,),
            "mlp": mlp_param_shapes(d, cfg.d_ff, cfg.mlp_act),
        },
    }


def init_params(cfg, seed: int = 0, device: DeviceLike = None) -> ParamTree:
    return init_tree(param_shapes(cfg), dtype_of(cfg), seed,
                     resolve_device(device))


def _embed(params, tokens, cfg):
    x = embed_lookup(params["embed"], tokens).to(dtype_of(cfg))
    return constrain(x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype),
                     "activation")


def _shared_block_full(shared, x, cfg, positions, impl):
    a, kv = attn_mod.gqa_self_attention(
        shared["attn"], rms_norm(x, shared["ln_scale"], cfg.norm_eps), cfg,
        positions=positions, impl=impl)
    x = x + a
    x = x + gated_mlp(rms_norm(x, shared["ln2_scale"], cfg.norm_eps),
                      shared["mlp"], cfg.mlp_act)
    return constrain(x, "activation"), kv


def _hidden(params, tokens, cfg, impl, cache=None):
    """All groups + final norm → hidden [B,S,d]; fills ``cache`` (KV per
    group, SSM state and conv tail per layer) when one is given."""
    x = _embed(params, tokens, cfg)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :]
    g, _ = _grouping(cfg)
    for gi in range(g):
        x, (k, v) = _shared_block_full(params["shared_attn"], x, cfg,
                                       positions, impl)
        if cache is not None:
            cache["attn_k"][gi, :, :s] = k
            cache["attn_v"][gi, :, :s] = v
        for li in _group_layers(cfg, gi):
            lp = params["mamba"][li]
            y, (ssm, conv) = m2.mamba2_block(
                lp, rms_norm(x, lp["pre_norm_scale"], cfg.norm_eps), cfg,
                impl=impl)
            x = constrain(x + y, "activation")
            if cache is not None:
                cache["ssm"][li] = ssm
                cache["conv"][li] = conv
    return rms_norm(x, params["final_norm_scale"], cfg.norm_eps)


def forward(params, batch, cfg, *, impl="chunked"):
    """Full segment.  Returns logits [B,S,V]."""
    return _lm_head(params, _hidden(params, batch["tokens"], cfg, impl), cfg)


def _shared_train(shared, x, cfg, positions, impl):
    return _shared_block_full(shared, x, cfg, positions, impl)[0]


def _mamba_train(lp, x, cfg, impl):
    y, _ = m2.mamba2_block(lp, rms_norm(x, lp["pre_norm_scale"],
                                        cfg.norm_eps), cfg, impl=impl)
    return constrain(x + y, "activation")


def train_loss(params, batch, cfg, *, impl="chunked"):
    """batch: tokens [B,S+1] (optional ``mask`` [B,S]) → (xent, {"xent",
    "aux"}), the reference's ``train_loss``: the shared block and each
    Mamba layer under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint`` of ``group`` and ``layer``), no cache collected."""
    tokens = batch["tokens"]
    x = _embed(params, tokens[:, :-1], cfg)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    g, _ = _grouping(cfg)
    for gi in range(g):
        x = checkpoint(_shared_train, params["shared_attn"], x, cfg,
                       positions, impl, use_reentrant=False)
        for li in _group_layers(cfg, gi):
            x = checkpoint(_mamba_train, params["mamba"][li], x, cfg, impl,
                           use_reentrant=False)
    x = rms_norm(x, params["final_norm_scale"], cfg.norm_eps)
    loss = head_loss(params, x, tokens[:, 1:], cfg, batch.get("mask"))
    return loss, {"xent": loss, "aux": torch.zeros((), device=loss.device)}


# --------------------------------------------------------------------------
# Cache / decode
# --------------------------------------------------------------------------
def cache_shapes(cfg, batch_size: int, max_len: int, held=None) -> dict:
    """(shape, dtype) of each cache tensor; the cache also carries
    ``pos``, an int.  ``held``: (key/value heads, SSM heads, d_inner) of
    the weights when they hold fewer than the config (:func:`held_units`)."""
    g, _ = _grouping(cfg)
    dtype = dtype_of(cfg)
    hkv, h, di = held or (cfg.num_kv_heads, cfg.n_ssm_heads, cfg.d_inner)
    n = cfg.ssm_state
    kv = (g, batch_size, max_len, hkv, cfg.head_dim)
    return {
        "attn_k": (kv, dtype),
        "attn_v": (kv, dtype),
        "ssm": ((cfg.num_layers, batch_size, h, di // h, n), torch.float32),
        "conv": ((cfg.num_layers, batch_size, cfg.ssm_conv - 1, di + 2 * n),
                 dtype),
    }


def held_units(params, cfg) -> tuple[int, int, int]:
    """(key/value heads, SSM heads, d_inner) the weights hold: all of
    them, or on a mesh this rank's (the shapes of the cache it builds)."""
    lp = params["mamba"][0]
    return (params["shared_attn"]["attn"]["wk"].shape[1] // cfg.head_dim,
            lp["w_dt"].shape[1], lp["w_x"].shape[1])


def init_cache(cfg, batch_size: int, max_len: int,
               device: DeviceLike = None, held=None) -> dict:
    dev = resolve_device(device)
    cache = {name: torch.zeros(shape, dtype=dt, device=dev) for name,
             (shape, dt) in cache_shapes(cfg, batch_size, max_len,
                                         held).items()}
    cache["pos"] = 0
    return cache


def prefill(params, batch, cfg, max_len: int, *, impl="chunked"):
    tokens = batch["tokens"]
    cache = init_cache(cfg, tokens.shape[0], max_len, tokens.device,
                       held_units(params, cfg))
    x = _hidden(params, tokens, cfg, impl, cache)
    cache["pos"] = tokens.shape[1]
    return _lm_head(params, x[:, -1:], cfg), cache


def decode_step(params, batch, cache, cfg):
    """One decode step.  batch: {"token": [B,1]}.  Updates ``cache`` in
    place and returns (logits [B,1,V], cache)."""
    x = _embed(params, batch["token"], cfg)
    pos = cache["pos"]
    shared = params["shared_attn"]
    g, _ = _grouping(cfg)
    for gi in range(g):
        a, _ = attn_mod.gqa_decode_attention(
            shared["attn"], rms_norm(x, shared["ln_scale"], cfg.norm_eps),
            cfg, k_cache=coll.layer_of(cache["attn_k"], gi),
            v_cache=coll.layer_of(cache["attn_v"], gi), pos=pos)
        x = x + a
        x = x + gated_mlp(rms_norm(x, shared["ln2_scale"], cfg.norm_eps),
                          shared["mlp"], cfg.mlp_act)
        for li in _group_layers(cfg, gi):
            lp = params["mamba"][li]
            y, (ssm, conv) = m2.mamba2_step(
                lp, rms_norm(x, lp["pre_norm_scale"], cfg.norm_eps), cfg,
                ssm_state=cache["ssm"][li], conv_state=cache["conv"][li])
            x = x + y
            cache["ssm"][li] = ssm
            cache["conv"][li] = conv
    x = rms_norm(x, params["final_norm_scale"], cfg.norm_eps)
    cache["pos"] = pos + 1
    return _lm_head(params, x, cfg), cache
