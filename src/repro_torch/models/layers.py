"""Shared low-level layers: norms, rotary and sinusoidal positions, gated
MLPs, parameter initialisation.

Numerics policy (the reference's): weights and activations in
``cfg.dtype`` (bf16 on the card, f32 in the tests); norm statistics,
softmax and rope angles in f32; matmuls in the activation's dtype (the
card's bf16 products accumulate in f32).

Parameters are :class:`ParamTree` modules: nested ``nn.Module``s whose
leaves are ``nn.Parameter``s, frozen for serving (``requires_grad=False``;
training turns them on with ``requires_grad_()``), indexed like the
reference's parameter dicts (``p["layers"][i]["attn"]``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import collectives as coll


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Native-dtype product ``x @ w`` with ``w`` stored ``[in, out]``.  A
    ``w`` that holds this rank's rows (``distributed.collectives.Split``
    on dim 0, a row-parallel product on a mesh) gives a partial product,
    summed over the "model" group here (``collectives.tp_reduce``: on a
    sequence-parallel stream the sum keeps this rank's rows)."""
    y = torch.matmul(x, w.to(x.dtype))
    split = coll.split_of(w)
    return coll.tp_reduce(y) if split is not None and split.dim == 0 else y


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``; a table that holds this rank's vocabulary rows
    (a ``Split`` on dim 0) looks up the tokens in its range, 0 elsewhere,
    and sums the rows over the "model" group (``collectives.tp_reduce``)."""
    split = coll.split_of(table)
    if split is None:
        return table[tokens]
    rows = table.shape[0]
    local = tokens - split.index * rows
    ok = (local >= 0) & (local < rows)
    out = table[local.clamp(0, rows - 1)] * ok[..., None].to(table.dtype)
    return coll.tp_reduce(out)


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMS norm with f32 statistics over the last dim (over the "model"
    group's whole width when ``scale`` holds this rank's units, a
    ``Split``), scaled by ``1 + scale`` (zero-init
    scales are the identity; this is not ``torch.nn.RMSNorm``)."""
    x32 = x.float()
    split = coll.split_of(scale)
    if split is None:
        var = x32.square().mean(dim=-1, keepdim=True)
    else:        # this rank's units of a norm over the whole width
        var = coll.tp_sum(x32.square().sum(dim=-1, keepdim=True)) / (
            x.shape[-1] * split.parts)
    normed = x32 * torch.rsqrt(var + eps)
    return (normed * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Layer norm with f32 statistics (biased variance), scaled by
    ``1 + scale`` as :func:`rms_norm` is, plus ``bias``."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    normed = (x32 - mu) * torch.rsqrt(var + eps)
    return (normed * (1.0 + scale.float()) + bias.float()).to(x.dtype)


# --------------------------------------------------------------------------
# Rotary position embedding
# --------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for the even half of the head dimension."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """Rotate ``x`` ([..., S, H, D]) by ``positions`` ([..., S]), pairing
    the first half of D with the second (split halves)."""
    inv = rope_freqs(x.shape[-1], theta, x.device)           # [D/2]
    ang = positions[..., None].float() * inv                 # [..., S, D/2]
    cos = torch.cos(ang)[..., None, :]                       # [..., S, 1, D/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d_model: int, device=None
                         ) -> torch.Tensor:
    """The classic sin/cos table [seq, d_model] in f32 (whisper's encoder
    and, in this port as in the reference, its decoder)."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d_model // 2, dtype=torch.float32,
                       device=device)[None, :]
    ang = pos / (10000.0 ** (2 * dim / d_model))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# --------------------------------------------------------------------------
# Gated MLPs
# --------------------------------------------------------------------------
_ACTS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_plain": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "relu2": lambda x: F.relu(x).square(),      # Nemotron squared-ReLU
}

_NON_GATED = ("gelu_plain", "relu2")


def gated_mlp(x: torch.Tensor, params, act: str) -> torch.Tensor:
    """SwiGLU / GeGLU ``act(x W_gate) * (x W_up) W_down``; ``gelu_plain``
    and ``relu2`` are the non-gated two-matrix MLP."""
    fn = _ACTS[act]
    if act in _NON_GATED:
        return matmul(fn(matmul(x, params["w_up"])), params["w_down"])
    g = fn(matmul(x, params["w_gate"]))
    return matmul(g * matmul(x, params["w_up"]), params["w_down"])


def mlp_param_shapes(d_model: int, d_ff: int, act: str) -> dict:
    if act in _NON_GATED:
        return {"w_up": (d_model, d_ff), "w_down": (d_ff, d_model)}
    return {"w_gate": (d_model, d_ff), "w_up": (d_model, d_ff),
            "w_down": (d_ff, d_model)}


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------
class ParamTree(nn.Module):
    """A nested parameter dict as a module: sub-dicts become child
    ``ParamTree``s, lists ``nn.ModuleList``s, tensors frozen
    ``nn.Parameter``s.  ``tree[name]`` reads a child or a leaf."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, ParamTree(value))
            elif isinstance(value, list):
                self.add_module(name, nn.ModuleList(
                    ParamTree(v) for v in value))
            else:
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def _leaf(name: str, shape: tuple, dtype: torch.dtype,
          gen: torch.Generator, device: torch.device) -> torch.Tensor:
    f32 = torch.float32
    if "a_log" in name:                      # Mamba2: A in [1, 16]
        return torch.empty(shape, dtype=f32, device=device).uniform_(
            math.log(1.0), math.log(16.0), generator=gen)
    if "dt_bias" in name:                    # softplus^-1(~0.02)
        return torch.full(shape, -4.0, dtype=f32, device=device)
    if "d_skip" in name:
        return torch.ones(shape, dtype=f32, device=device)
    if name == "b_fg":                       # mLSTM forget gate: start open
        return torch.linspace(3.0, 6.0, math.prod(shape), dtype=f32,
                              device=device).reshape(shape)
    if name == "b_ig":                       # mLSTM input gate: start small
        return torch.full(shape, -5.0, dtype=f32, device=device)
    if "scale" in name or "norm" in name:
        return torch.zeros(shape, dtype=f32, device=device)
    if "bias" in name or name.startswith("b_"):
        return torch.zeros(shape, dtype=dtype, device=device)
    return init_dense(shape, gen, device=device).to(dtype)


def init_dense(shape: tuple, gen: torch.Generator, *,
               scale: float | None = None,
               device: torch.device | None = None) -> torch.Tensor:
    """Truncated-normal fan-in init in f32, the reference's
    ``models.layers.init_dense`` drawn from ``gen`` (the values are not
    ``jax.random``'s)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    w = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w * std


def init_tree(shapes: dict, dtype: torch.dtype, seed: int,
              device: torch.device) -> ParamTree:
    """Initialise a nested dict (and lists) of shape tuples by the
    reference's name rules (``a_log``, ``dt_bias``, ``d_skip``, ``b_fg``,
    ``b_ig``, ``scale``/``norm``, ``bias``; otherwise truncated-normal
    fan-in), drawing from one ``torch.Generator`` seeded with ``seed``
    in the tree's order.  The draws are not ``jax.random``'s: equal weights
    on both sides come through ``models.convert.params_from_jax``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))

    def build(node, name=""):
        if isinstance(node, dict):
            return {k: build(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [build(v, name) for v in node]
        return _leaf(name, tuple(node), dtype, gen, device)

    return ParamTree(build(shapes))
