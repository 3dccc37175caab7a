"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM
(scalar memory).

mLSTM runs in the chunkwise-parallel form (dense [Q, Q] tiles and a short
loop over chunks), with the exact step-by-step recurrence kept as the
oracle (:func:`mlstm_sequential`).  Stabilisation follows the paper: a
running per-head max ``m`` and the denominator ``max(|q·n|, exp(-m))``.

sLSTM is a per-unit recurrence with block-diagonal recurrent weights per
head.  :func:`slstm_scan` forms the four gates' input products for the
whole sequence in f32 and hands the recurrence to
``kernels.slstm_scan``: the CUDA kernel on the card, the plain step loop
on the CPU or with ``impl="naive"``.

Shapes: x [B, S, d]; mLSTM q/k/v [B, S, H, D] with D = di / H (di =
``xlstm_proj_factor`` d), gates [B, S, H]; sLSTM units du = d / H.

Tensor parallelism (``launch.steps``): on a mesh the blocks compute with
the parts of the weights a step builder hands them, H the heads those
hold.  The mLSTM's ``w_up`` holds this rank's units of both halves
``[x_in | gate]`` (its ``x_in`` units all-gathered: q, k and v contract
over the whole di) or, with ``xlstm_pin_inner``, is computed whole;
``w_down`` holds this rank's rows, the output's units cut to them and the
partial products summed over "model".  The sLSTM's gates, biases and
block-diagonal ``R`` hold this rank's heads, its output norm's statistics
run over the whole d.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch._device import true_f32
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.context import constrain
from repro_torch.kernels.slstm_scan.ops import slstm_scan as slstm_scan_op
from repro_torch.kernels.slstm_scan.ref import (GATES, recurrent_gates,
                                                slstm_cell_ref,
                                                slstm_scan_ref)
from repro_torch.models.layers import matmul, rms_norm

NEG = -1e30


def _mlstm_inputs(q, k, v, i_raw, f_raw):
    """f32 q, k / sqrt(D), v, i and log sigmoid(f)."""
    d = q.shape[-1]
    return (q.float(), k.float() / math.sqrt(d), v.float(), i_raw.float(),
            F.logsigmoid(f_raw.float()))


def _mlstm_zero_state(bsz, h, d, device):
    return (torch.zeros((bsz, h, d, d), dtype=torch.float32, device=device),
            torch.zeros((bsz, h, d), dtype=torch.float32, device=device),
            torch.zeros((bsz, h), dtype=torch.float32, device=device))


# --------------------------------------------------------------------------
# mLSTM cell
# --------------------------------------------------------------------------
def _mlstm_update(state, qt, kt, vt, it, lft):
    """One step on f32 inputs (k already scaled, the forget gate as its
    log) → (new state, h [B, H, D])."""
    c, n, m = state
    m_new = torch.maximum(lft + m, it)                       # [B,H]
    ip = torch.exp(it - m_new)
    fp = torch.exp(lft + m - m_new)
    c = (c * fp[..., None, None]
         + ip[..., None, None] * (kt[..., :, None] * vt[..., None, :]))
    n = n * fp[..., None] + ip[..., None] * kt
    num = torch.einsum("bhd,bhde->bhe", qt, c)
    den = torch.einsum("bhd,bhd->bh", qt, n).abs()
    den = torch.maximum(den, torch.exp(-m_new))[..., None]
    return (c, n, m_new), num / den


def mlstm_sequential(q, k, v, i_raw, f_raw):
    """Oracle: the step-by-step recurrence.  q/k/v [B,S,H,D]; gates
    [B,S,H] → (h [B,S,H,D] f32, (C [B,H,D,D], n [B,H,D], m [B,H]))."""
    bsz, s, h, d = q.shape
    q, k, v, i_raw, logf = _mlstm_inputs(q, k, v, i_raw, f_raw)
    state = _mlstm_zero_state(bsz, h, d, q.device)
    hs = []
    for t in range(s):
        state, out = _mlstm_update(state, q[:, t], k[:, t], v[:, t],
                                   i_raw[:, t], logf[:, t])
        hs.append(out)
    return torch.stack(hs, dim=1), state


def mlstm_chunked(q, k, v, i_raw, f_raw, chunk: int = 128):
    """Chunkwise-parallel mLSTM, numerically equal to
    :func:`mlstm_sequential`.  A ragged tail is padded with ``f_raw`` = 30
    (forget gate ~1) and ``i_raw`` = ``NEG``, and the causal mask is
    ``NEG``, as in the reference, so the maxima and ``exp(dmat - m)`` see
    the same numbers."""
    bsz, s, h, d = q.shape
    qc = min(chunk, s)
    pad = (-s) % qc
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        i_raw = F.pad(i_raw, (0, 0, 0, pad), value=NEG)
        f_raw = F.pad(f_raw, (0, 0, 0, pad), value=30.0)
    nc = (s + pad) // qc
    q, k, v, i_raw, logf = _mlstm_inputs(q, k, v, i_raw, f_raw)

    def cshape(t):
        return t.reshape(bsz, nc, qc, *t.shape[2:])

    qs, ks, vs, is_, lfs = map(cshape, (q, k, v, i_raw, logf))
    causal = torch.tril(torch.ones((qc, qc), dtype=torch.bool,
                                   device=q.device))[None, :, :, None]
    c_st, n_st, m_st = _mlstm_zero_state(bsz, h, d, q.device)
    outs = []
    for ci in range(nc):
        qq, kk, vv, ii, lf = (t[:, ci] for t in (qs, ks, vs, is_, lfs))
        b = torch.cumsum(lf, dim=1)                          # [B,Q,H]
        btot = b[:, -1]                                      # [B,H]
        dmat = b[:, :, None, :] - b[:, None, :, :] + ii[:, None, :, :]
        dmat = torch.where(causal, dmat, NEG)                # [B,t,s,H]
        m_intra = dmat.amax(dim=2)                           # [B,Q,H]
        m_t = torch.maximum(b + m_st[:, None, :], m_intra)
        sc = torch.einsum("bqhd,bshd->bqsh", qq, kk)
        scw = sc * torch.exp(dmat - m_t[:, :, None, :])
        # sc·w formed first: no [b, q, s, h, e] intermediate
        num = torch.einsum("bqsh,bshe->bqhe", scw, vv)
        den = scw.sum(dim=2)                                 # [B,Q,H]
        scale_in = torch.exp(b + m_st[:, None, :] - m_t)     # [B,Q,H]
        num = num + scale_in[..., None] * torch.einsum("bqhd,bhde->bqhe",
                                                       qq, c_st)
        den = den + scale_in * torch.einsum("bqhd,bhd->bqh", qq, n_st)
        den = torch.maximum(den.abs(), torch.exp(-m_t))[..., None]
        outs.append(num / den)
        # state update
        tail = btot[:, None] - b + ii                        # [B,Q,H]
        m_new = torch.maximum(btot + m_st, tail.amax(dim=1))
        sc_out = torch.exp(tail - m_new[:, None])            # [B,Q,H]
        decay = torch.exp(btot + m_st - m_new)
        wk = sc_out[..., None] * kk                          # [B,Q,H,D]
        c_st = (c_st * decay[..., None, None]
                + torch.einsum("bqhd,bqhe->bhde", wk, vv))
        n_st = n_st * decay[..., None] + wk.sum(dim=1)
        m_st = m_new
    out = torch.stack(outs, dim=1).reshape(bsz, nc * qc, h, d)[:, :s]
    return out, (c_st, n_st, m_st)


def mlstm_step(state, q_t, k_t, v_t, i_t, f_t):
    """Single-token mLSTM.  state = (C, n, m); q/k/v [B,H,D]; gates
    [B,H] → (new state, h [B,H,D] f32)."""
    return _mlstm_update(state, *_mlstm_inputs(q_t, k_t, v_t, i_t, f_t))


# --------------------------------------------------------------------------
# sLSTM cell (scalar memory, block-diagonal recurrence)
# --------------------------------------------------------------------------
def _block_diag_matmul(h, r):
    """h [B, d] × blockdiag r [H, du, du] → [B, d] (r widened to h's
    dtype, as the reference's einsum promotes it)."""
    return recurrent_gates(h, r[None])[0]


def _stacked_r(params) -> torch.Tensor:
    """The four recurrent matrices as one [4, H, du, du]."""
    return torch.stack([params[f"r_{g}"] for g in GATES])


def slstm_scan(x, params, n_heads: int, *, impl: str = "chunked"):
    """x [B,S,d] → (h [B,S,d] in x's dtype, final (c, n, h, m) [B, d]
    f32).

    The gates' input products for the whole sequence are four true-f32
    matmuls (``pre`` [4, B, S, d], bias added); the recurrence is
    ``kernels.slstm_scan``: its kernel on the card (under autograd with
    its backward kernel), or with ``impl="naive"`` its plain step loop.
    ``n_heads`` is the heads the weights hold (on a mesh this rank's: the
    block-diagonal recurrence splits by head with no collective)."""
    assert params["r_z"].shape[0] == n_heads, (params["r_z"].shape, n_heads)
    x32 = x.float()
    with true_f32():
        pre = torch.stack([x32 @ params[f"w_{g}"].float()
                           + params[f"b_{g}"].float() for g in GATES])
    scan = slstm_scan_ref if impl == "naive" else slstm_scan_op
    return scan(pre, _stacked_r(params), out_dtype=x.dtype)


def slstm_step(state, x_t, params):
    """Single-token sLSTM.  state = (c, n, h, m) [B, d] f32; x_t [B, d] →
    (new state, h in x_t's dtype)."""
    x32 = x_t.float()
    with true_f32():
        gates = torch.stack([
            x32 @ params[f"w_{g}"].float() + params[f"b_{g}"].float()
            + _block_diag_matmul(state[2], params[f"r_{g}"])
            for g in GATES])
    new = slstm_cell_ref(state, gates)
    return new, new[2].to(x_t.dtype)


# --------------------------------------------------------------------------
# Blocks
# --------------------------------------------------------------------------
def mlstm_block_shapes(cfg) -> dict:
    d = cfg.d_model
    di = int(cfg.xlstm_proj_factor * d)
    h = cfg.num_heads
    return {
        "norm_scale": (d,),
        "w_up": (d, 2 * di),
        "conv_w": (4, di),
        "conv_b": (di,),
        "w_q": (di, di),
        "w_k": (di, di),
        "w_v": (di, di),
        "w_ig": (di, h),
        "b_ig": (h,),
        "w_fg": (di, h),
        "b_fg": (h,),
        "out_norm_scale": (di,),
        "w_down": (di, d),
    }


def slstm_block_shapes(cfg) -> dict:
    d = cfg.d_model
    h = cfg.num_heads
    du = d // h
    shapes = {"norm_scale": (d,), "conv_w": (4, d), "conv_b": (d,),
              "out_norm_scale": (d,), "w_down": (d, d)}
    for g in GATES:
        shapes[f"w_{g}"] = (d, d)
        shapes[f"r_{g}"] = (h, du, du)
        shapes[f"b_{g}"] = (d,)
    return shapes


def _conv_causal(x, w, b):
    """Depthwise causal conv (width W) and SiLU in f32: x [B,S,C],
    w [W,C] → [B,S,C] in x's dtype."""
    w32 = w.float()
    width = w32.shape[0]
    s = x.shape[1]
    padded = F.pad(x.float(), (0, 0, width - 1, 0))
    out = padded[:, 0:s] * w32[0]
    for i in range(1, width):
        out = out + padded[:, i:i + s] * w32[i]
    return F.silu(out + b.float()).to(x.dtype)


def _conv_window(window, w, b, dtype):
    """The causal conv at one step: window [B, W, C] (the W - 1 inputs
    before and this one) → [B, C] in ``dtype``."""
    out = torch.einsum("bwc,wc->bc", window.float(), w.float())
    return F.silu(out + b.float()).to(dtype)


def _gates_in(xc, params):
    """mLSTM input and forget pre-activations in f32 from the convolved
    input: [.., H] each."""
    xc32 = xc.float()
    with true_f32():
        i_raw = xc32 @ params["w_ig"].float() + params["b_ig"].float()
        f_raw = xc32 @ params["w_fg"].float() + params["b_fg"].float()
    return i_raw, f_raw


def _units(t: torch.Tensor, w_down) -> torch.Tensor:
    """The units of ``t`` [..., n] that ``w_down``'s rows take: all of
    them, or on a mesh this rank's block where ``t`` was computed whole."""
    rows, split = w_down.shape[0], coll.split_of(w_down)
    if split is None or t.shape[-1] == rows:
        return t
    return t.narrow(-1, split.index * rows, rows)


def _up(params, xn, cfg):
    """The up projection's two halves: (x_in [.., di] whole, the output
    gate [.., units], di).  On a mesh whose ``w_up`` holds this rank's
    units of both halves, its ``x_in`` units are all-gathered over "model"
    (``w_q``/``w_k``/``w_v`` contract over the whole di) and the gate
    keeps its units; a ``w_up`` computed whole (``xlstm_pin_inner``:
    ``u`` pinned replicated) gives both halves whole."""
    w = params["w_up"]
    u = matmul(xn, w)
    half = u.shape[-1] // 2
    if coll.split_of(w) is not None:
        return coll.tp_gather(u[..., :half], -1), u[..., half:], \
            half * coll.split_of(w).parts
    if cfg.xlstm_pin_inner:
        u = constrain(u, "activation")
    return u[..., :half], u[..., half:], half


def _qkv_gates(params, xc, x_in, dh):
    """q, k (from the convolved input), v (from the raw one) at the heads
    the weights hold, [.., h, dh], and the input and forget gates."""
    lead = xc.shape[:-1]
    q = matmul(xc, params["w_q"]).reshape(*lead, -1, dh)
    k = matmul(xc, params["w_k"]).reshape(*lead, -1, dh)
    v = matmul(x_in, params["w_v"]).reshape(*lead, -1, dh)
    return (q, k, v, *_gates_in(xc, params))


def _mlstm_out(params, out, gate, x, cfg):
    """Per-head output norm, the SiLU output gate, the down projection and
    the residual; ``out`` [.., h, dh] at the heads the weights hold, and
    on a mesh the units ``w_down``'s rows take (its partial products
    summed over "model")."""
    h, dh = out.shape[-2:]
    shape = out.shape[:-2]
    out = rms_norm(out.to(x.dtype), params["out_norm_scale"].reshape(
        h, dh), cfg.norm_eps).reshape(*shape, h * dh)
    wd = params["w_down"]
    out = _units(out, wd) * F.silu(_units(gate, wd).float()).to(x.dtype)
    return x + matmul(out, wd)


def mlstm_block(params, x, cfg, chunk: int = 128):
    """Full-segment mLSTM block.  x [B,S,d] → (y, (C, n, m), conv_tail):
    q and k from the convolved input, v from the raw one; the conv tail
    that decode carries is the pre-conv input's last 3 steps.  On a mesh
    the heads are the weights' (``mlstm_chunked`` runs on them)."""
    xn = rms_norm(x, params["norm_scale"], cfg.norm_eps)
    x_in, gate, di = _up(params, xn, cfg)
    conv_tail = x_in[:, -3:]
    xc = _conv_causal(x_in, params["conv_w"], params["conv_b"])
    if cfg.xlstm_pin_inner:
        xc = constrain(xc, "activation")
    out, state = mlstm_chunked(*_qkv_gates(params, xc, x_in,
                                           di // cfg.num_heads), chunk)
    return _mlstm_out(params, out, gate, x, cfg), state, conv_tail


def mlstm_block_step(params, x, cfg, *, state, conv_state):
    """Single-token mLSTM block.  x [B,1,d]; conv_state [B,3,di] →
    (y, new state, new conv_state)."""
    xn = rms_norm(x, params["norm_scale"], cfg.norm_eps)
    x_in, gate, di = _up(params, xn, cfg)
    window = torch.cat([conv_state.to(x_in.dtype), x_in], dim=1)  # [B,4,di]
    xc = _conv_window(window, params["conv_w"], params["conv_b"], x.dtype)
    new_state, out = mlstm_step(state, *_qkv_gates(
        params, xc, x_in[:, 0], di // cfg.num_heads))
    y = _mlstm_out(params, out[:, None], gate, x, cfg)
    return y, new_state, window[:, 1:]


def _slstm_out(params, out, x, cfg):
    """The output norm (over the whole d: its statistics summed over
    "model" where the scale holds this rank's units), the down projection
    and the residual."""
    out = rms_norm(out, params["out_norm_scale"], cfg.norm_eps)
    wd = params["w_down"]
    return x + matmul(_units(out, wd), wd)


def slstm_block(params, x, cfg, *, impl: str = "chunked"):
    """Full-segment sLSTM block → (y, (c, n, h, m), conv_tail); the conv
    tail is the normed input's last 3 steps.  On a mesh the heads (and
    the state's units) are the weights'."""
    xn = rms_norm(x, params["norm_scale"], cfg.norm_eps)
    conv_tail = xn[:, -3:]
    xc = _conv_causal(xn, params["conv_w"], params["conv_b"])
    out, state = slstm_scan(xc, params, params["r_z"].shape[0], impl=impl)
    return _slstm_out(params, out, x, cfg), state, conv_tail


def slstm_block_step(params, x, cfg, *, state, conv_state):
    """Single-token sLSTM block.  x [B,1,d]; conv_state [B,3,d]."""
    xn = rms_norm(x, params["norm_scale"], cfg.norm_eps)     # [B,1,d]
    window = torch.cat([conv_state.to(xn.dtype), xn], dim=1)
    xc = _conv_window(window, params["conv_w"], params["conv_b"], x.dtype)
    new_state, out = slstm_step(state, xc, params)
    return _slstm_out(params, out[:, None], x, cfg), new_state, window[:, 1:]
