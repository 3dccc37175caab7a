"""Decoder-only transformer: the dense, MoE, MLA and VLM families;
training losses, prefill and decode.

Parameters are a :class:`~repro_torch.models.layers.ParamTree` with one
entry per layer (``params["layers"][l]``) where the reference stacks a
leading ``[L, ...]`` axis and scans; weights keep the reference's
``[in, out]`` layout.  Decode updates the cache in place: K/V for GQA, the
latent ``ckv``/``kr`` for MLA.

    init_params(cfg, seed, device)              -> params
    train_loss(params, batch, cfg)              -> (loss, metrics)
    forward(params, batch, cfg)                 -> logits [B,S,V]
    prefill(params, batch, cfg, max_len)        -> (logits [B,1,V], cache)
    decode_step(params, batch, cache, cfg)      -> (logits [B,1,V], cache)
    init_cache(cfg, batch_size, max_len, device) -> cache (zeros, pos 0)

A VLM prompt may come as ``batch["embeds"]`` [B,S,d] (no sqrt(d) scale on
that path, as in the reference); decode always takes tokens.
``backbone`` also returns the MoE layers' summed load-balance loss (0 for
dense models), which ``train_loss`` adds to the cross-entropy as the
reference does.  Training
recomputes each layer in the backward
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``).
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.context import (constrain, sequence_parallel,
                                             sp_split)
from repro_torch.models import attention as attn_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (ParamTree, embed_lookup, gated_mlp,
                                       init_tree, matmul, mlp_param_shapes,
                                       rms_norm)


def dtype_of(cfg) -> torch.dtype:
    """The config's weight and activation dtype (``"bfloat16"`` → bf16)."""
    return getattr(torch, cfg.dtype)


# --------------------------------------------------------------------------
# Parameter shapes
# --------------------------------------------------------------------------
def layer_shapes(cfg) -> dict:
    d = cfg.d_model
    shapes = {"ln1_scale": (d,), "ln2_scale": (d,),
              "attn": (mla_mod.mla_param_shapes(cfg) if cfg.attn_kind == "mla"
                       else attn_mod.attn_param_shapes(cfg))}
    if cfg.num_experts:
        shapes["moe"] = moe_mod.moe_param_shapes(cfg)
    else:
        shapes["mlp"] = mlp_param_shapes(d, cfg.d_ff, cfg.mlp_act)
    return shapes


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
def _ffn(lp, x, cfg):
    """The layer's MLP or MoE: (y, aux), aux 0.0 without experts."""
    if cfg.num_experts:
        return moe_mod.moe_mlp(lp["moe"], constrain(x, "activation"), cfg)
    return gated_mlp(x, lp["mlp"], cfg.mlp_act), 0.0


def block_full(lp, x, cfg, positions, impl, sp=None):
    """One pre-norm layer over a full segment.  Returns (x, aux, kv): kv
    is (k, v), or (c_kv, k_rope) for MLA.

    With ``sp`` (the sequence length, on a mesh whose "model" group splits
    it: Megatron-SP) ``x`` holds this rank's rows: each norm runs on them,
    its output is all-gathered on the sequence before the column-parallel
    products, and each row-parallel product ends in a reduce-scatter back
    to this rank's rows (an output computed whole is cut to them).  Run
    under ``torch.utils.checkpoint``, the recomputation sets the split
    again."""
    with sequence_parallel(sp):
        xn = coll.tp_stream(rms_norm(x, lp["ln1_scale"], cfg.norm_eps))
        if cfg.attn_kind == "mla":
            h, kv = mla_mod.mla_self_attention(lp["attn"], xn, cfg,
                                               positions=positions,
                                               impl=impl)
        else:
            h, kv = attn_mod.gqa_self_attention(lp["attn"], xn, cfg,
                                                positions=positions,
                                                impl=impl)
        x = x + coll.tp_rows(h)
        f, aux = _ffn(lp, coll.tp_stream(
            rms_norm(x, lp["ln2_scale"], cfg.norm_eps)), cfg)
        return x + coll.tp_rows(f), aux, kv


def _block_train(lp, x, cfg, positions, impl, sp=None):
    """:func:`block_full` without its K/V: (x, aux)."""
    x, aux, _ = block_full(lp, x, cfg, positions, impl, sp)
    return x, aux


def block_decode(lp, x, cfg, cache_l, pos):
    """One layer, one token; writes this token's K/V (or latent) into
    ``cache_l``."""
    xn = rms_norm(x, lp["ln1_scale"], cfg.norm_eps)
    if cfg.attn_kind == "mla":
        h, _ = mla_mod.mla_decode_attention(
            lp["attn"], xn, cfg, ckv_cache=cache_l["ckv"],
            kr_cache=cache_l["kr"], pos=pos, absorbed=cfg.mla_absorbed)
    else:
        h, _ = attn_mod.gqa_decode_attention(
            lp["attn"], xn, cfg, k_cache=cache_l["k"], v_cache=cache_l["v"],
            pos=pos)
    x = x + h
    return x + _ffn(lp, rms_norm(x, lp["ln2_scale"], cfg.norm_eps), cfg)[0]


# --------------------------------------------------------------------------
# Full-model passes
# --------------------------------------------------------------------------
def _embed_in(params, batch, cfg):
    """A VLM's ``embeds`` as given, else the token embedding times
    sqrt(d_model), in the config's dtype (the reference's convention for
    every model, Qwen included)."""
    if cfg.takes_embeddings and "embeds" in batch:
        return constrain(batch["embeds"].to(dtype_of(cfg)), "activation")
    x = embed_lookup(params["embed"], batch["tokens"]).to(dtype_of(cfg))
    return constrain(x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype),
                     "activation")


def _lm_head(params, x, cfg):
    """Logits [..., V]; from a head that holds this rank's vocabulary
    columns, gathered whole over the "model" group."""
    head_w = _head_weight(params, cfg)
    logits = constrain(matmul(x, head_w), "logits")
    return coll.tp_gather(logits, -1) if coll.split_of(head_w) else logits


def backbone(params, batch, cfg, *, impl="chunked", remat=False):
    """All layers + final norm; returns (hidden [B,S,d], aux_loss).  With
    ``remat`` each layer keeps only its input for the backward and runs
    again there.  On a mesh where ``cfg.seq_parallel`` splits the sequence
    (``context.sp_split``) the stream between layers, and so each layer's
    saved input, holds this rank's S/tp rows: the embedding's sum is
    reduce-scattered to them, and the final norm's rows are gathered back
    into the whole sequence for the LM head."""
    act_name = "activation_sp" if cfg.seq_parallel else "activation"
    key = "embeds" if cfg.takes_embeddings and "embeds" in batch \
        else "tokens"
    seq = batch[key].shape[1]
    sp = sp_split(cfg, seq)
    with sequence_parallel(sp):
        x = constrain(coll.tp_rows(_embed_in(params, batch, cfg)), act_name)
    positions = torch.arange(seq, device=x.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in params["layers"]:
        if remat:
            x, a = checkpoint(_block_train, lp, x, cfg, positions, impl, sp,
                              use_reentrant=False)
        else:
            x, a = _block_train(lp, x, cfg, positions, impl, sp)
        with sequence_parallel(sp):
            x = constrain(x, act_name)
        aux = aux + a
    x = rms_norm(x, params["final_norm_scale"], cfg.norm_eps)
    with sequence_parallel(sp):
        return coll.tp_stream(x), aux


def forward(params, batch, cfg, *, impl="chunked"):
    """Full-segment forward.  Returns logits [B,S,V]."""
    x, _ = backbone(params, batch, cfg, impl=impl)
    return _lm_head(params, x, cfg)


# --------------------------------------------------------------------------
# Losses
# --------------------------------------------------------------------------
def token_nll(logits32, labels, split=None):
    """Per-token cross-entropy [...] of f32 logits [..., V] at ``labels``
    (in [0, V)).  With ``split`` the logits are this rank's vocabulary
    columns (a ``Split``): the label's logit and the log-sum-exp are
    joined over the "model" group (vocabulary-parallel cross-entropy)."""
    if split is None:
        ll = torch.gather(logits32, -1, labels[..., None].long())[..., 0]
        return torch.logsumexp(logits32, dim=-1) - ll
    v = logits32.shape[-1]
    local = labels.long() - split.index * v
    ok = (local >= 0) & (local < v)
    ll = torch.gather(logits32, -1, local.clamp(0, v - 1)[..., None])[..., 0]
    ll = coll.tp_sum(ll * ok.float())
    lse = coll.tp_gather(torch.logsumexp(logits32, dim=-1)[..., None], -1)
    return torch.logsumexp(lse, dim=-1) - ll


def lm_loss(logits, labels, mask=None, split=None):
    """Mean token cross-entropy in f32.  logits [B,S,V] (this rank's
    vocabulary columns with ``split``); labels [B,S]."""
    nll = token_nll(logits.float(), labels, split)
    if mask is None:
        return nll.mean()
    m = mask.float()
    return (nll * m).sum() / m.sum().clamp_min(1.0)


def _chunk_nll(xi, head_w, li):
    """Summed cross-entropy of one sequence chunk; labels < 0 count 0."""
    logits32 = constrain(matmul(xi, head_w), "logits").float()
    nll = token_nll(logits32, li.clamp_min(0), coll.split_of(head_w))
    return (nll * (li >= 0).float()).sum()


def chunked_lm_loss(x, head_w, labels, cfg):
    """Sequence-chunked cross-entropy: the f32 [B,S,V] logits never exist
    at once; each chunk's logits are recomputed in the backward (the
    reference's ``jax.checkpoint`` of its scan body).  x [B,S,d]."""
    b, s, _ = x.shape
    chunk = min(cfg.loss_chunk, s)
    pad = (-s) % chunk
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=-1)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s + pad, chunk):
        total = total + checkpoint(_chunk_nll, x[:, c0:c0 + chunk], head_w,
                                   labels[:, c0:c0 + chunk],
                                   use_reentrant=False)
    return total / (b * s)


def _head_weight(params, cfg):
    """[d, V] (this rank's vocabulary columns on a mesh, marked)."""
    if cfg.tie_embeddings and "lm_head" not in params:
        embed = params["embed"]
        split = coll.split_of(embed)
        return coll.mark(embed.T, split and coll.Split(1, split.index,
                                                       split.parts))
    return params["lm_head"]


def head_loss(params, x, labels, cfg, mask=None):
    """The LM head's cross-entropy of hidden ``x`` [B,S,d] against
    ``labels`` [B,S]: sequence-chunked when ``cfg.loss_chunk``, else over
    the whole logits (with the optional ``mask``)."""
    head_w = _head_weight(params, cfg)
    if cfg.loss_chunk:
        return chunked_lm_loss(x, head_w, labels, cfg)
    return lm_loss(constrain(matmul(x, head_w), "logits"), labels, mask,
                   coll.split_of(head_w))


def train_loss(params, batch, cfg, *, impl="chunked"):
    """batch: tokens [B,S+1] (or a VLM's embeds [B,S,d] + labels [B,S]),
    an optional ``mask`` [B,S].  Returns (xent + aux, {"xent", "aux"})."""
    if cfg.takes_embeddings and "embeds" in batch:
        inputs, labels = {"embeds": batch["embeds"]}, batch["labels"]
    else:
        tokens = batch["tokens"]
        inputs, labels = {"tokens": tokens[:, :-1]}, tokens[:, 1:]
    x, aux = backbone(params, inputs, cfg, impl=impl, remat=True)
    loss = head_loss(params, x, labels, cfg, batch.get("mask"))
    return loss + aux, {"xent": loss, "aux": aux}


# --------------------------------------------------------------------------
# KV cache: prefill & decode
# --------------------------------------------------------------------------
def cache_shapes(cfg, batch_size: int, max_len: int) -> dict:
    """(shape, dtype) of each cache tensor, stacked over layers: K/V, or
    MLA's latent ``ckv`` and rope key ``kr``; the cache also carries
    ``pos``, an int (or [B] ragged positions, set by the caller)."""
    l, dt = cfg.num_layers, dtype_of(cfg)
    s = min(max_len, cfg.window) if cfg.window else max_len
    if cfg.attn_kind == "mla":
        return {"layers": {"ckv": ((l, batch_size, s, cfg.kv_lora_rank), dt),
                           "kr": ((l, batch_size, s, cfg.qk_rope_dim), dt)}}
    kv = (l, batch_size, s, cfg.num_kv_heads, cfg.head_dim)
    return {"layers": {"k": (kv, dt), "v": (kv, dt)}}


def held_cfg(params, cfg):
    """``cfg`` at the key/value heads the layer weights hold: all of them,
    or on a mesh this rank's (the shapes of the cache it builds)."""
    if cfg.attn_kind == "mla":
        return cfg
    hkv = params["layers"][0]["attn"]["wk"].shape[1] // cfg.head_dim
    return cfg if hkv == cfg.num_kv_heads else cfg.replace(num_kv_heads=hkv)


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
    cache = init_cache(held_cfg(params, cfg), b, max_len, x.device)
    names = list(cache["layers"])
    cache_len = cache["layers"][names[0]].shape[2]
    for l, lp in enumerate(params["layers"]):
        x, _, kv = block_full(lp, x, cfg, positions, impl)
        for name, val in zip(names, kv):
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
        x = block_decode(lp, x, cfg, {name: coll.layer_of(val, l) for
                                      name, val in cache["layers"].items()},
                         pos)
    x = rms_norm(x, params["final_norm_scale"], cfg.norm_eps)
    cache["pos"] = pos + 1
    return _lm_head(params, x, cfg), cache
