"""Mixture-of-Experts layer (DeepSeekMoE-style: shared + fine-grained
routed experts), the reference's sort-based dispatch with static capacity:

  1. route: softmax(router) → top-k experts and weights per token
  2. stable sort of the token choices by expert id → per-expert runs
  3. expert buffer [E, C, d] gathered from the sorted tokens (choices past
     the capacity C are dropped, Switch/GShard semantics)
  4. batched expert products [E,C,d]×[E,d,ff] (``torch.bmm``; the
     reference's ``einsum``s run outside any Pallas kernel too)
  5. inverse-permutation gather back to [T, k, d] → weighted combine

Which choices capacity drops depends on the sort order, so both sorts are
stable, as ``jnp.argsort`` is, and the top k come from a stable descending
sort, which puts the lower expert first on a tie as ``jax.lax.top_k``
does.  The router runs in true f32 (TF32 off).  The auxiliary
load-balance loss is returned by :func:`route` and :func:`moe_mlp`.

On a mesh (``repro_torch.distributed.context``) with a "model" axis of tp
> 1 ranks that divides the expert count, :func:`moe_mlp` takes the
reference's expert-parallel branch (its ``shard_map``): each "model" rank
computes only its E/tp experts over the tokens it holds, and the partial
outputs meet in one sum over the "model" group in the compute dtype.
Tokens held whole on every dp rank are split over dp first (when they
divide) and gathered after, as the reference's ``shard_map`` splits them;
capacity is taken per local token count, so with drops the result is the
reference's sharded one, not its single-device one.  On a
sequence-parallel stream (``context.sequence_parallel``) the layer takes
the gathered sequence, and its output, the routed experts' sum and the
shared experts' alike, is reduce-scattered to this rank's rows (cut to
them where it was computed whole).
"""
from __future__ import annotations

import math

import torch

from repro_torch._device import true_f32
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.context import (axis_sizes, batch_split,
                                             current_mesh, dp_axes, sp_seq,
                                             tp_axes)
from repro_torch.models.layers import _ACTS, gated_mlp, mlp_param_shapes


def moe_param_shapes(cfg) -> dict:
    d, e, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    shapes = {"router": (d, e), "w_gate": (e, d, ff), "w_up": (e, d, ff),
              "w_down": (e, ff, d)}
    if cfg.num_shared_experts:
        shapes["shared"] = mlp_param_shapes(
            d, ff * cfg.num_shared_experts, cfg.mlp_act)
    return shapes


def capacity(num_tokens: int, cfg) -> int:
    """Static per-expert capacity, rounded up to a multiple of 8."""
    c = int(num_tokens * cfg.top_k / cfg.num_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)


def route(params, x_flat: torch.Tensor, cfg):
    """Router: returns (weights [T,k] f32, expert_idx [T,k] int64,
    aux_loss 0-d f32)."""
    with true_f32():
        logits = torch.matmul(x_flat.float(), params["router"].float())
    probs = torch.softmax(logits, dim=-1)                    # [T,E]
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, idx = top[:, :cfg.top_k], idx[:, :cfg.top_k]
    weights = weights / weights.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    # load-balance auxiliary loss: E * sum_e f_e * P_e
    e = cfg.num_experts
    f = torch.zeros(e, dtype=torch.float32, device=x_flat.device)
    f.index_add_(0, idx.reshape(-1), torch.full(
        (idx.numel(),), 1.0 / idx.numel(), device=x_flat.device))
    p = probs.mean(dim=0)
    mesh, dp = current_mesh(), dp_axes()
    if mesh is not None and batch_split() and coll.group_size(mesh, dp) > 1:
        # this rank holds its batch rows only: the means over all tokens
        n = coll.group_size(mesh, dp)
        f = coll.all_reduce(f, mesh, dp) / n
        p = coll.all_reduce(p, mesh, dp) / n
    aux = e * torch.sum(f * p) * cfg.router_aux_coef
    return weights, idx, aux


def _expert_compute(x_flat, idx, weights, w_gate, w_up, w_down, cfg,
                    e_base: int, n_local: int, cap: int) -> torch.Tensor:
    """Sort-based dispatch → batched products → combine over the
    ``n_local`` experts from ``e_base`` (all of them, from 0, on one
    device); choices of other experts add 0.  With
    ``cfg.moe_bf16_combine`` the weighted combine stays in the compute
    dtype (at most k accumulands) instead of f32."""
    t, d = x_flat.shape
    k = cfg.top_k
    tk = t * k
    dev = x_flat.device
    e_flat = idx.reshape(tk)
    order = torch.argsort(e_flat, stable=True)               # [Tk]
    e_sorted = e_flat[order]
    tok_sorted = order // k                                  # source token
    # counts over the local expert range only (a scatter-add, as the
    # reference's .at[].add, so that the shapes do not depend on the data)
    e_local = e_sorted - e_base
    in_range = (e_local >= 0) & (e_local < n_local)
    e_clip = e_local.clamp(0, n_local - 1)
    counts = torch.zeros(n_local, dtype=torch.int64, device=dev).index_add_(
        0, e_clip, in_range.long())
    first = torch.argmax(in_range.int())                     # first local row
    starts = first + torch.cumsum(counts, 0) - counts        # exclusive
    pos_in_e = torch.arange(tk, device=dev) - starts[e_clip]  # rank

    # gather into the expert buffer [E_local, C, d]
    slots = torch.arange(cap, device=dev)
    buf_src = starts[:, None] + slots[None, :]               # [E,C]
    buf_valid = slots[None, :] < counts[:, None]
    buf_tok = torch.where(buf_valid, tok_sorted[buf_src.clamp(0, tk - 1)], 0)
    dt = x_flat.dtype
    buf = x_flat[buf_tok] * buf_valid[..., None].to(dt)

    # the experts
    act = _ACTS[cfg.mlp_act]
    g = torch.bmm(buf, w_gate.to(dt))
    u = torch.bmm(buf, w_up.to(dt))
    h = (act(g.float()) * u.float()).to(dt)
    y_buf = torch.bmm(h, w_down.to(dt))

    # combine back (gathers only)
    inv_order = torch.empty_like(order)
    inv_order[order] = torch.arange(tk, device=dev)          # rank of (t,k)
    kept = in_range & (pos_in_e < cap)
    dest = e_clip * cap + pos_in_e.clamp(0, cap - 1)
    y_tk = (y_buf.reshape(n_local * cap, d)[dest[inv_order]]
            * kept[inv_order][:, None].to(dt)).reshape(t, k, d)
    if cfg.moe_bf16_combine:
        y = (y_tk * weights[..., None].to(dt)).sum(dim=1)
    else:
        y = (y_tk.float() * weights[..., None]).sum(dim=1)
    return y.to(dt)


def moe_mlp(params, x: torch.Tensor, cfg):
    """x [B,S,d] (or [T,d]) → (y of the same shape, or this rank's rows of
    it on a sequence-parallel stream, aux_loss); on a mesh
    the expert-parallel branch (module docstring).  The expert weights may
    hold all E experts or, on a mesh, this "model" rank's E/tp."""
    shape = x.shape
    x_flat = x.reshape(-1, shape[-1])
    t, e = x_flat.shape[0], cfg.num_experts
    weights, idx, aux = route(params, x_flat, cfg)
    w = (params["w_gate"], params["w_up"], params["w_down"])
    mesh, tp, dp = current_mesh(), tp_axes(), dp_axes()
    tp_size = axis_sizes(mesh).get("model", 1) if mesh is not None and tp \
        else 1
    if tp_size > 1 and e % tp_size == 0:
        n_local = e // tp_size
        e_base = mesh.get_local_rank("model") * n_local
        if w[0].shape[0] == e:                       # all experts given
            w = tuple(wi[e_base:e_base + n_local] for wi in w)
        dp_size = math.prod(axis_sizes(mesh)[a] for a in dp)
        split = not batch_split() and dp_size > 1 and t % dp_size == 0
        xl, il, wl = x_flat, idx, weights
        if split:                        # tokens whole here: split over dp
            tl = t // dp_size
            lo = coll.group_rank(mesh, dp) * tl
            xl, il, wl = x_flat[lo:lo + tl], idx[lo:lo + tl], \
                weights[lo:lo + tl]
        y = _expert_compute(xl, il, wl, *w, cfg, e_base, n_local,
                            capacity(xl.shape[0], cfg))
        if sp_seq() is None:
            y = coll.all_reduce(y, mesh, tuple(tp))      # compute dtype
            if split:
                y = coll.all_gather(y, mesh, dp, 0)
            y = y.reshape(shape)
        else:
            # a sequence-parallel stream: the experts' partial sums
            # reduce-scattered to this rank's rows
            if split:
                y = coll.all_gather(y, mesh, dp, 0)
            y = coll.tp_reduce(y.reshape(shape))
    else:
        y = coll.tp_rows(_expert_compute(x_flat, idx, weights, *w, cfg, 0,
                                         e, capacity(t, cfg)).reshape(shape))
    if cfg.num_shared_experts:
        y = y + coll.tp_rows(gated_mlp(x, params["shared"], cfg.mlp_act))
    return y, aux
