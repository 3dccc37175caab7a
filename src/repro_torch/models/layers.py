"""Shared low-level layers: norms, rotary embeddings, gated MLPs, parameter
initialisation.

Numerics policy (the reference's): weights and activations in
``cfg.dtype`` (bf16 on the card, f32 in the tests); norm statistics,
softmax and rope angles in f32; matmuls in the activation's dtype (the
card's bf16 products accumulate in f32).

Parameters are :class:`ParamTree` modules: nested ``nn.Module``s whose
leaves are ``nn.Parameter``s (``requires_grad=False``: this slice serves),
indexed like the reference's parameter dicts (``p["layers"][i]["attn"]``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Native-dtype product ``x @ w`` with ``w`` stored ``[in, out]``."""
    return torch.matmul(x, w.to(x.dtype))


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMS norm with f32 statistics, scaled by ``1 + scale`` (zero-init
    scales are the identity; this is not ``torch.nn.RMSNorm``)."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    return (normed * (1.0 + scale.float())).to(x.dtype)


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
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    w = torch.empty(shape, dtype=f32, device=device)
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * fan_in ** -0.5).to(dtype)


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
