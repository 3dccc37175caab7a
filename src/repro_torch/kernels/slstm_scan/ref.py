"""Plain PyTorch versions of the sLSTM recurrence and of its backward: the
functions the CUDA kernels compute, one step after another."""
from __future__ import annotations

import torch
import torch.nn.functional as F

#: the four gates of ``pre`` and ``r``, in order
GATES = ("z", "i", "f", "o")
#: what the forward saves for the backward, per step and unit: the state
#: after the step, then the gates (z and o activated, i and f raw)
SAVED = ("c", "n", "m", "h", "z", "i", "f", "o")


def slstm_cell_ref(state, gates: torch.Tensor):
    """One step of the cell.  state = (c, n, h, m), each [B, d] f32;
    ``gates`` [4, B, d] f32, the z, i, f and o pre-activations with the
    input, the bias and ``R·h`` already added → the new (c, n, h, m)."""
    c, n, _, m = state
    z = torch.tanh(gates[0])
    it, ft = gates[1], gates[2]
    o = torch.sigmoid(gates[3])
    lf = F.logsigmoid(ft)
    m_new = torch.maximum(lf + m, it)
    ip = torch.exp(it - m_new)
    fp = torch.exp(lf + m - m_new)
    c = fp * c + ip * z
    n = fp * n + ip
    h = o * c / torch.clamp_min(n, 1e-6)
    return c, n, h, m_new


def recurrent_gates(h: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """h [B, d] f32 times the block-diagonal ``r`` [4, H, du, du] of each
    gate (widened to f32) → [4, B, d]: per head, ``h_head @ r[g, head]``."""
    b, d = h.shape
    g, nh, du, _ = r.shape
    out = torch.einsum("bhu,ghuv->gbhv", h.reshape(b, nh, du), r.float())
    return out.reshape(g, b, d)


def slstm_scan_ref(pre: torch.Tensor, r: torch.Tensor, *,
                   out_dtype: torch.dtype = torch.float32):
    """pre [4, B, S, d] f32 (the z, i, f, o pre-activations of the whole
    sequence: input product plus bias), r [4, H, du, du] with H·du = d →
    (h [B, S, d] in ``out_dtype``, final (c, n, h, m), each [B, d] f32).

    The state starts at zero (``m`` too, as in the reference); step t forms
    each gate as ``pre[:, :, t] + R·h`` and applies
    :func:`slstm_cell_ref` — ``repro/models/xlstm.py:slstm_scan``'s
    ``lax.scan`` body."""
    _, b, s, d = pre.shape
    zeros = pre.new_zeros((b, d))
    state = (zeros, zeros, zeros, zeros)
    hs = pre.new_empty((b, s, d), dtype=out_dtype)
    r32 = r.float()
    for t in range(s):
        state = slstm_cell_ref(state, pre[:, :, t]
                               + recurrent_gates(state[2], r32))
        hs[:, t] = state[2]
    return hs, state


def _tie_weight(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The share of max(a, b)'s gradient that goes to a: 1 where a > b,
    0.5 at a tie, 0 below (``jax.lax.max`` and ``torch.maximum``)."""
    return torch.where(a > b, 1.0, torch.where(a == b, 0.5, 0.0))


def slstm_scan_bwd_ref(pre: torch.Tensor, r: torch.Tensor,
                       h_cot: torch.Tensor | None, state_cot
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward of :func:`slstm_scan_ref`: the cotangents of h [B, S,
    d] and of the final (c, n, h, m) (each may be None: zero) → (dpre
    [4, B, S, d], dR [4, H, du, du]), f32.

    The forward runs again, keeping each step's gates and state; then
    from the last step down, dh_t (h's cotangent plus the recurrent
    ``Rᵀ·dg_{t+1}``) and the carried dc, dn and dm give the four gates'
    dg_t, the reference's autodiff graph written out: through
    ``h = o·c / max(n, 1e-6)``, the exponentials, the stabiliser
    ``m' = max(log_sigmoid(f) + m, i)`` (0.5 each at a tie) and
    ``log_sigmoid``, whose derivative is sigmoid(-f).  dpre = dg, and
    dR[g, head] = sum over b, t of h_{t-1}ᵀ dg_t."""
    _, b, s, d = pre.shape
    _, nh, du, _ = r.shape
    r32 = r.float()
    zeros = pre.new_zeros((b, d))
    states, gates = [(zeros, zeros, zeros, zeros)], []
    for t in range(s):
        gates.append(pre[:, :, t] + recurrent_gates(states[-1][2], r32))
        states.append(slstm_cell_ref(states[-1], gates[-1]))
    dc, dn, dh_last, dm = (zeros if g is None else g.float()
                           for g in (state_cot or (None,) * 4))
    dpre = torch.empty_like(pre)
    rec = zeros
    for t in reversed(range(s)):
        c0, n0, _, m0 = states[t]
        c1, n1, _, m1 = states[t + 1]
        g = gates[t]
        dh = rec if h_cot is None else h_cot[:, t].float() + rec
        if t == s - 1:
            dh = dh + dh_last
        z, it, o = torch.tanh(g[0]), g[1], torch.sigmoid(g[3])
        a = F.logsigmoid(g[2]) + m0
        ip, fp = torch.exp(it - m1), torch.exp(a - m1)
        den = torch.clamp_min(n1, 1e-6)
        d_oc = dh / den
        dc = dc + d_oc * o
        dn = dn - d_oc * (o * c1 / den) * _tie_weight(n1, torch.full_like(
            n1, 1e-6))
        dfp, dip = dc * c0 + dn * n0, dc * z + dn
        dm = dm - dip * ip - dfp * fp
        wa = _tie_weight(a, it)
        da = dfp * fp + dm * wa
        dit = dip * ip + dm * (1.0 - wa)
        dg = torch.stack([dc * ip * (1.0 - z * z), dit,
                          da * torch.sigmoid(-g[2]),
                          d_oc * c1 * o * (1.0 - o)])
        dpre[:, :, t] = dg
        rec = torch.einsum("gbhv,ghuv->bhu", dg.reshape(4, b, nh, du),
                           r32).reshape(b, d)
        dc, dn, dm = dc * fp, dn * fp, da
    h_prev = torch.stack([st[2] for st in states[:-1]], dim=1)  # [B, S, d]
    dr = torch.einsum("xhu,gxhv->ghuv", h_prev.reshape(b * s, nh, du),
                      dpre.reshape(4, b * s, nh, du))
    return dpre, dr
