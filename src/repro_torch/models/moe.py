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

The reference's expert-parallel ``shard_map`` branch needs a device mesh;
it waits for ROADMAP.md §1 item 9 step 2, so this is its single-device
branch.
"""
from __future__ import annotations

import torch

from repro_torch._device import true_f32
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
    aux = e * torch.sum(f * probs.mean(dim=0)) * cfg.router_aux_coef
    return weights, idx, aux


def _expert_compute(x_flat, idx, weights, w_gate, w_up, w_down, cfg,
                    cap: int) -> torch.Tensor:
    """Sort-based dispatch → batched products → combine over all the
    experts (the reference's single-device case: ``e_base`` 0, every
    expert local).  With ``cfg.moe_bf16_combine`` the weighted combine
    stays in the compute dtype (at most k accumulands) instead of f32."""
    t, d = x_flat.shape
    e, k = cfg.num_experts, cfg.top_k
    tk = t * k
    dev = x_flat.device
    e_flat = idx.reshape(tk)
    order = torch.argsort(e_flat, stable=True)               # [Tk]
    e_sorted = e_flat[order]
    tok_sorted = order // k                                  # source token
    counts = torch.bincount(e_flat, minlength=e)
    starts = torch.cumsum(counts, 0) - counts                # exclusive
    pos_in_e = torch.arange(tk, device=dev) - starts[e_sorted]  # rank

    # gather into the expert buffer [E, C, d]
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
    kept = pos_in_e < cap
    dest = e_sorted * cap + pos_in_e.clamp(0, cap - 1)
    y_tk = (y_buf.reshape(e * cap, d)[dest[inv_order]]
            * kept[inv_order][:, None].to(dt)).reshape(t, k, d)
    if cfg.moe_bf16_combine:
        y = (y_tk * weights[..., None].to(dt)).sum(dim=1)
    else:
        y = (y_tk.float() * weights[..., None]).sum(dim=1)
    return y.to(dt)


def moe_mlp(params, x: torch.Tensor, cfg):
    """x [B,S,d] (or [T,d]) → (y of the same shape, aux_loss)."""
    shape = x.shape
    x_flat = x.reshape(-1, shape[-1])
    weights, idx, aux = route(params, x_flat, cfg)
    y = _expert_compute(x_flat, idx, weights, params["w_gate"],
                        params["w_up"], params["w_down"], cfg,
                        capacity(x_flat.shape[0], cfg))
    if cfg.num_shared_experts:
        y = y + gated_mlp(x_flat, params["shared"], cfg.mlp_act)
    return y.reshape(shape), aux
