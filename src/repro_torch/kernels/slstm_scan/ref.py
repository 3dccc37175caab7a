"""Plain PyTorch version of the sLSTM recurrence: the function the CUDA
kernel computes, one step after another."""
from __future__ import annotations

import torch
import torch.nn.functional as F

#: the four gates of ``pre`` and ``r``, in order
GATES = ("z", "i", "f", "o")


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
