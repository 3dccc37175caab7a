"""Whisper-style encoder-decoder backbone (arXiv:2212.04356).

As in the reference, the mel-spectrogram and conv frontend are a stub: the
encoder takes precomputed frame embeddings [B, enc_seq, d].  Sinusoidal
positions on both sides (the decoder's a deviation from whisper's learned
table, kept from the reference), bias-free projections, layer norms with
the ``(1 + scale)`` convention, the tied head ``x @ embed.T``.

Parameters are a :class:`~repro_torch.models.layers.ParamTree` with one
entry per layer: ``params["enc_layers"][l]``, ``params["dec_layers"][l]``.
Self- and cross-attention over full segments go through
``attention.chunked_attention`` (the flash kernel on the card) or, with
``impl="naive"``, ``attention.naive_attention``.  Decode writes the
self-attention K/V cache in place; the cross K/V are written once, at
prefill.  On a mesh (``launch.steps``) the layers compute at the heads
the weights hold (the attention's heads, the MLP's units, the rows of
``wo`` and of the MLP's output, summed over "model"); the layer norms
stay over the whole d, and whisper's projections carry no bias to add
after that sum.

    encode(params, frames, cfg)                    -> enc_out [B,enc_seq,d]
    decode_full(params, tokens, enc_out, cfg)      -> (logits, kvs)
    train_loss(params, batch, cfg)                 -> (loss, metrics)
    prefill(params, batch, cfg, max_len)           -> (logits [B,1,V], cache)
    decode_step(params, batch, cache, cfg)         -> (logits [B,1,V], cache)
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.distributed import collectives as coll
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import (ParamTree, embed_lookup, gated_mlp,
                                       init_tree, layer_norm, matmul,
                                       mlp_param_shapes,
                                       sinusoidal_positions)
from repro_torch.models.transformer import _lm_head, dtype_of, head_loss


def _ln_shapes(d):
    return {"scale": (d,), "bias": (d,)}


def enc_layer_shapes(cfg) -> dict:
    d = cfg.d_model
    return {
        "ln1": _ln_shapes(d),
        "attn": attn_mod.attn_param_shapes(cfg),
        "ln2": _ln_shapes(d),
        "mlp": mlp_param_shapes(d, cfg.d_ff, "gelu_plain"),
    }


def dec_layer_shapes(cfg) -> dict:
    d = cfg.d_model
    return {
        "ln1": _ln_shapes(d),
        "self_attn": attn_mod.attn_param_shapes(cfg),
        "ln2": _ln_shapes(d),
        "cross_attn": attn_mod.attn_param_shapes(cfg),
        "ln3": _ln_shapes(d),
        "mlp": mlp_param_shapes(d, cfg.d_ff, "gelu_plain"),
    }


def param_shapes(cfg) -> dict:
    d = cfg.d_model
    return {
        "embed": (cfg.vocab_size, d),
        "enc_layers": [enc_layer_shapes(cfg) for _ in range(cfg.enc_layers)],
        "enc_final_ln": _ln_shapes(d),
        "dec_layers": [dec_layer_shapes(cfg) for _ in range(cfg.num_layers)],
        "dec_final_ln": _ln_shapes(d),
    }


def init_params(cfg, seed: int = 0, device: DeviceLike = None) -> ParamTree:
    return init_tree(param_shapes(cfg), dtype_of(cfg), seed,
                     resolve_device(device))


def _ln(x, p, eps):
    return layer_norm(x, p["scale"], p["bias"], eps)


def _heads(params, x, cfg, name):
    """``x @ params[name]`` as heads [B, S, h, hd] (h the heads the weight
    holds: all of them, or on a mesh this rank's)."""
    return matmul(x, params[name]).reshape(*x.shape[:2], -1, cfg.head_dim)


def _mha(params, x, cfg, *, kv=None, causal, impl):
    """Self (``kv=None``) or cross attention, no rope, at the heads the
    weights hold.  Returns (out, (k, v))."""
    b, s, _ = x.shape
    src = x if kv is None else kv
    q = _heads(params, x, cfg, "wq")
    k, v = _heads(params, src, cfg, "wk"), _heads(params, src, cfg, "wv")
    h, hd = q.shape[2], cfg.head_dim
    if impl == "naive":
        out = attn_mod.naive_attention(q, k, v, causal=causal)
    else:
        out = attn_mod.chunked_attention(q, k, v, causal=causal)
    return matmul(out.reshape(b, s, h * hd), params["wo"]), (k, v)


def _enc_layer(lp, x, cfg, impl):
    a, _ = _mha(lp["attn"], _ln(x, lp["ln1"], cfg.norm_eps), cfg,
                causal=False, impl=impl)
    x = x + a
    return x + gated_mlp(_ln(x, lp["ln2"], cfg.norm_eps), lp["mlp"],
                         "gelu_plain")


def encode(params, frames, cfg, *, impl="chunked", remat=False):
    """frames [B, enc_seq, d] (the stubbed frontend's output) → encoder
    output [B, enc_seq, d]: non-causal self-attention layers, each run
    again in the backward with ``remat``."""
    x = frames.to(dtype_of(cfg))
    x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                 x.device).to(x.dtype)[None]
    for lp in params["enc_layers"]:
        x = (checkpoint(_enc_layer, lp, x, cfg, impl, use_reentrant=False)
             if remat else _enc_layer(lp, x, cfg, impl))
    return _ln(x, params["enc_final_ln"], cfg.norm_eps)


def _dec_embed(params, tokens, cfg):
    """Token embeddings plus the sinusoidal table's first S rows."""
    x = embed_lookup(params["embed"], tokens).to(dtype_of(cfg))
    pos = sinusoidal_positions(tokens.shape[1], cfg.d_model, x.device)
    return x + pos.to(x.dtype)[None]


def _dec_embed_at(params, token, cfg, pos: int):
    """One token's embedding plus position ``pos``'s sin/cos, the angle
    formed in f32 from ``pos`` (the reference's decode formula)."""
    x = embed_lookup(params["embed"], token).to(dtype_of(cfg))
    d = cfg.d_model
    dim = torch.arange(d // 2, dtype=torch.float32, device=x.device)
    ang = (torch.tensor(float(pos), dtype=torch.float32, device=x.device)
           / (10000.0 ** (2 * dim / d)))
    pe = torch.cat([torch.sin(ang), torch.cos(ang)]).to(x.dtype)
    return x + pe[None, None, :]


def _dec_layer(lp, x, enc_out, cfg, impl):
    """One decoder layer: (x, ((self k, v), (cross k, v)))."""
    a, skv = _mha(lp["self_attn"], _ln(x, lp["ln1"], cfg.norm_eps), cfg,
                  causal=True, impl=impl)
    x = x + a
    c, ckv = _mha(lp["cross_attn"], _ln(x, lp["ln2"], cfg.norm_eps), cfg,
                  kv=enc_out, causal=False, impl=impl)
    x = x + c
    x = x + gated_mlp(_ln(x, lp["ln3"], cfg.norm_eps), lp["mlp"],
                      "gelu_plain")
    return x, (skv, ckv)


def _dec_layer_train(lp, x, enc_out, cfg, impl):
    return _dec_layer(lp, x, enc_out, cfg, impl)[0]


def decode_full(params, tokens, enc_out, cfg, *, impl="chunked",
                remat=False, return_hidden=False):
    """Teacher-forced decoder pass.  Returns (logits [B,S,V], kvs): per
    layer ((self k, v), (cross k, v)).  With ``remat`` (training) each
    layer runs again in the backward and no K/V are kept (``kvs`` empty);
    ``return_hidden`` gives the final-norm hidden [B,S,d] for the logits."""
    x = _dec_embed(params, tokens, cfg)
    kvs = []
    for lp in params["dec_layers"]:
        if remat:
            x = checkpoint(_dec_layer_train, lp, x, enc_out, cfg, impl,
                           use_reentrant=False)
        else:
            x, kv = _dec_layer(lp, x, enc_out, cfg, impl)
            kvs.append(kv)
    x = _ln(x, params["dec_final_ln"], cfg.norm_eps)
    if return_hidden:
        return x, kvs
    return _lm_head(params, x, cfg), kvs


def forward(params, batch, cfg, *, impl="chunked"):
    """batch {"frames", "tokens"} → logits [B,S,V]."""
    enc_out = encode(params, batch["frames"], cfg, impl=impl)
    return decode_full(params, batch["tokens"], enc_out, cfg, impl=impl)[0]


def train_loss(params, batch, cfg, *, impl="chunked"):
    """batch: frames [B,enc_seq,d], tokens [B,S+1] (optional ``mask``).
    Returns (xent, {"xent", "aux"}); whisper has no auxiliary loss."""
    enc_out = encode(params, batch["frames"], cfg, impl=impl, remat=True)
    tokens = batch["tokens"]
    x, _ = decode_full(params, tokens[:, :-1], enc_out, cfg, impl=impl,
                       remat=True, return_hidden=True)
    loss = head_loss(params, x, tokens[:, 1:], cfg, batch.get("mask"))
    return loss, {"xent": loss, "aux": torch.zeros((), device=loss.device)}


# --------------------------------------------------------------------------
# Cache / decode
# --------------------------------------------------------------------------
def cache_shapes(cfg, batch_size: int, max_len: int, held=None) -> dict:
    """(shape, dtype) of each cache tensor, stacked over decoder layers;
    the cache also carries ``pos``, an int.  ``held``: the key/value heads
    the weights hold (on a mesh this rank's); default all."""
    l, dtype = cfg.num_layers, dtype_of(cfg)
    h, hd = held or cfg.num_kv_heads, cfg.head_dim
    return {
        "self_k": ((l, batch_size, max_len, h, hd), dtype),
        "self_v": ((l, batch_size, max_len, h, hd), dtype),
        "cross_k": ((l, batch_size, cfg.enc_seq, h, hd), dtype),
        "cross_v": ((l, batch_size, cfg.enc_seq, h, hd), dtype),
    }


def init_cache(cfg, batch_size: int, max_len: int,
               device: DeviceLike = None, held=None) -> dict:
    dev = resolve_device(device)
    cache = {name: torch.zeros(shape, dtype=dt, device=dev) for name,
             (shape, dt) in cache_shapes(cfg, batch_size, max_len,
                                         held).items()}
    cache["pos"] = 0
    return cache


def prefill(params, batch, cfg, max_len: int, *, impl="chunked"):
    """batch: frames + tokens (the prompt).  Encodes, runs the decoder
    over the prompt and builds the self and cross caches."""
    tokens = batch["tokens"]
    enc_out = encode(params, batch["frames"], cfg, impl=impl)
    logits, kvs = decode_full(params, tokens, enc_out, cfg, impl=impl)
    held = params["dec_layers"][0]["self_attn"]["wk"].shape[1] \
        // cfg.head_dim
    cache = init_cache(cfg, tokens.shape[0], max_len, tokens.device, held)
    s = tokens.shape[1]
    for l, ((sk, sv), (ck, cv)) in enumerate(kvs):
        cache["self_k"][l, :, :s] = sk
        cache["self_v"][l, :, :s] = sv
        cache["cross_k"][l] = ck
        cache["cross_v"][l] = cv
    cache["pos"] = s
    return logits[:, -1:], cache


def decode_step(params, batch, cache, cfg):
    """One token.  batch: {"token": [B,1]}.  Writes the token's self K/V
    at ``pos`` in place; cross-attention sees all ``enc_seq`` frames (its
    query position ``enc_seq - 1``)."""
    pos = cache["pos"]
    x = _dec_embed_at(params, batch["token"], cfg, pos)
    heads = dict(n_heads=cfg.num_heads, n_kv_heads=cfg.num_kv_heads)
    for l, lp in enumerate(params["dec_layers"]):
        xn = _ln(x, lp["ln1"], cfg.norm_eps)
        sa = lp["self_attn"]
        q = _heads(sa, xn, cfg, "wq")
        a = attn_mod.cached_attention(
            q, coll.layer_of(cache["self_k"], l),
            coll.layer_of(cache["self_v"], l), pos,
            new_kv=(_heads(sa, xn, cfg, "wk"), _heads(sa, xn, cfg, "wv")),
            **heads)
        x = x + matmul(a.flatten(2), sa["wo"])
        xn = _ln(x, lp["ln2"], cfg.norm_eps)
        ca = lp["cross_attn"]
        c = attn_mod.cached_attention(
            _heads(ca, xn, cfg, "wq"), coll.layer_of(cache["cross_k"], l),
            coll.layer_of(cache["cross_v"], l), cfg.enc_seq - 1, **heads)
        x = x + matmul(c.flatten(2), ca["wo"])
        x = x + gated_mlp(_ln(x, lp["ln3"], cfg.norm_eps), lp["mlp"],
                          "gelu_plain")
    x = _ln(x, params["dec_final_ln"], cfg.norm_eps)
    cache["pos"] = pos + 1
    return _lm_head(params, x, cfg), cache
