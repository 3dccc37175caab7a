"""xLSTM language model: G groups of (``slstm_every`` - 1) mLSTM blocks
and one sLSTM block, ``[m, m, m, s] × 6`` for xlstm-350m.

With ``slstm_every == 0`` the stack is pure mLSTM (one group).  No FFN:
the projection capacity lives inside the blocks (proj factor 2).

Parameters are a :class:`~repro_torch.models.layers.ParamTree` with one
entry per block where the reference stacks leading axes:
``params["mlstm"][g*M + m]`` and ``params["slstm"][g]``.  The cache keeps
the reference's keys and stacked shapes (``m_C`` [G, M, B, H, D, D] …);
decode updates it in place.  The state is O(1) in sequence length.

    init_params(cfg, seed, device)               -> params
    train_loss(params, batch, cfg)               -> (loss, metrics)
    forward(params, batch, cfg)                  -> logits [B,S,V]
    prefill(params, batch, cfg, max_len)         -> (logits [B,1,V], cache)
    decode_step(params, batch, cache, cfg)       -> (logits [B,1,V], cache)
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.distributed.context import constrain
from repro_torch.models import xlstm as xl
from repro_torch.models.layers import (ParamTree, embed_lookup, init_tree,
                                       rms_norm)
from repro_torch.models.transformer import _lm_head, dtype_of, head_loss


def _grouping(cfg) -> tuple[int, int]:
    """(G groups, M mLSTM blocks a group)."""
    if not cfg.slstm_every:
        return 1, cfg.num_layers
    assert cfg.num_layers % cfg.slstm_every == 0, \
        f"{cfg.name}: num_layers must divide by slstm_every"
    return cfg.num_layers // cfg.slstm_every, cfg.slstm_every - 1


def param_shapes(cfg) -> dict:
    g, m = _grouping(cfg)
    shapes = {
        "embed": (cfg.vocab_size, cfg.d_model),
        "final_norm_scale": (cfg.d_model,),
        "mlstm": [xl.mlstm_block_shapes(cfg) for _ in range(g * m)],
    }
    if cfg.slstm_every:
        shapes["slstm"] = [xl.slstm_block_shapes(cfg) for _ in range(g)]
    return shapes


def init_params(cfg, seed: int = 0, device: DeviceLike = None) -> ParamTree:
    return init_tree(param_shapes(cfg), dtype_of(cfg), seed,
                     resolve_device(device))


def _embed(params, tokens, cfg):
    x = embed_lookup(params["embed"], tokens).to(dtype_of(cfg))
    return constrain(x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype),
                     "activation")


def _hidden(params, tokens, cfg, impl, cache=None):
    """Every group in the reference's order, then the final norm → hidden
    [B,S,d]; fills ``cache`` (each block's state and conv tail) when one
    is given."""
    x = _embed(params, tokens, cfg)
    g, m = _grouping(cfg)
    for gi in range(g):
        for mi in range(m):
            x, (c, n, mx), conv = xl.mlstm_block(params["mlstm"][gi * m + mi],
                                                 x, cfg)
            x = constrain(x, "activation")
            if cache is not None:
                for name, val in (("m_C", c), ("m_n", n), ("m_m", mx),
                                  ("m_conv", conv)):
                    cache[name][gi, mi] = val
        if cfg.slstm_every:
            x, state, conv = xl.slstm_block(params["slstm"][gi], x, cfg,
                                            impl=impl)
            x = constrain(x, "activation")
            if cache is not None:
                for name, val in zip(("s_c", "s_n", "s_h", "s_m", "s_conv"),
                                     (*state, conv)):
                    cache[name][gi] = val
    return rms_norm(x, params["final_norm_scale"], cfg.norm_eps)


def forward(params, batch, cfg, *, impl="chunked"):
    """Full segment.  Returns logits [B,S,V] (tied head)."""
    return _lm_head(params, _hidden(params, batch["tokens"], cfg, impl), cfg)


def _mlstm_train(lp, x, cfg):
    return constrain(xl.mlstm_block(lp, x, cfg)[0], "activation")


def _slstm_train(lp, x, cfg, impl):
    return constrain(xl.slstm_block(lp, x, cfg, impl=impl)[0], "activation")


def train_loss(params, batch, cfg, *, impl="chunked"):
    """batch: tokens [B,S+1] (optional ``mask`` [B,S]) → (xent, {"xent",
    "aux"}), the reference's ``train_loss``: every block under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of each
    mLSTM layer and of the sLSTM block), no state collected."""
    tokens = batch["tokens"]
    x = _embed(params, tokens[:, :-1], cfg)
    g, m = _grouping(cfg)
    for gi in range(g):
        for mi in range(m):
            x = checkpoint(_mlstm_train, params["mlstm"][gi * m + mi], x,
                           cfg, use_reentrant=False)
        if cfg.slstm_every:
            x = checkpoint(_slstm_train, params["slstm"][gi], x, cfg, impl,
                           use_reentrant=False)
    x = rms_norm(x, params["final_norm_scale"], cfg.norm_eps)
    loss = head_loss(params, x, tokens[:, 1:], cfg, batch.get("mask"))
    return loss, {"xent": loss, "aux": torch.zeros((), device=loss.device)}


# --------------------------------------------------------------------------
# Cache / decode
# --------------------------------------------------------------------------
def cache_shapes(cfg, batch_size: int, max_len: int, held=None) -> dict:
    """(shape, dtype) of each cache tensor (``max_len`` is unused: no KV
    growth); the cache also carries ``pos``, an int.  The mLSTM head dim
    is di / H (512 at xlstm-350m, not its ``head_dim``).  ``held``: the
    (mLSTM heads, sLSTM units) the weights hold, on a mesh this rank's
    (:func:`held_units`); default all."""
    del max_len
    g, m = _grouping(cfg)
    d, h = cfg.d_model, cfg.num_heads
    di = int(cfg.xlstm_proj_factor * d)
    dh = di // h
    hl, du = held or (h, d)
    b, f32, dtype = batch_size, torch.float32, dtype_of(cfg)
    shapes = {
        "m_C": ((g, m, b, hl, dh, dh), f32),
        "m_n": ((g, m, b, hl, dh), f32),
        "m_m": ((g, m, b, hl), f32),
        "m_conv": ((g, m, b, 3, di), dtype),
    }
    if cfg.slstm_every:
        shapes.update({
            "s_c": ((g, b, du), f32),
            "s_n": ((g, b, du), f32),
            "s_h": ((g, b, du), f32),
            "s_m": ((g, b, du), f32),
            "s_conv": ((g, b, 3, d), dtype),
        })
    return shapes


def held_units(params, cfg) -> tuple[int, int]:
    """(mLSTM heads, sLSTM units) the weights hold: all of them, or on a
    mesh this rank's."""
    dh = int(cfg.xlstm_proj_factor * cfg.d_model) // cfg.num_heads
    du = cfg.d_model // cfg.num_heads
    hl = params["mlstm"][0]["w_q"].shape[1] // dh
    units = params["slstm"][0]["r_z"].shape[0] * du if cfg.slstm_every \
        else cfg.d_model
    return hl, units


def init_cache(cfg, batch_size: int, max_len: int,
               device: DeviceLike = None, held=None) -> dict:
    dev = resolve_device(device)
    cache = {name: torch.zeros(shape, dtype=dt, device=dev) for name,
             (shape, dt) in cache_shapes(cfg, batch_size, max_len,
                                         held).items()}
    cache["pos"] = 0
    return cache


def prefill(params, batch, cfg, max_len: int, *, impl="chunked"):
    """Run the prompt; build the cache.  Returns (last-token logits,
    cache)."""
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
    g, m = _grouping(cfg)
    for gi in range(g):
        for mi in range(m):
            x, (c, n, mx), conv = xl.mlstm_block_step(
                params["mlstm"][gi * m + mi], x, cfg,
                state=(cache["m_C"][gi, mi], cache["m_n"][gi, mi],
                       cache["m_m"][gi, mi]),
                conv_state=cache["m_conv"][gi, mi])
            for name, val in (("m_C", c), ("m_n", n), ("m_m", mx),
                              ("m_conv", conv)):
                cache[name][gi, mi] = val
        if cfg.slstm_every:
            names = ("s_c", "s_n", "s_h", "s_m")
            x, state, conv = xl.slstm_block_step(
                params["slstm"][gi], x, cfg,
                state=tuple(cache[k][gi] for k in names),
                conv_state=cache["s_conv"][gi])
            for name, val in zip((*names, "s_conv"), (*state, conv)):
                cache[name][gi] = val
    x = rms_norm(x, params["final_norm_scale"], cfg.norm_eps)
    cache["pos"] += 1
    return _lm_head(params, x, cfg), cache
