"""Mamba2 / SSD block (arXiv:2405.21060 form), used by zamba2.

State-space recurrence per head h with scalar decay:

    H_t = a_t * H_{t-1} + dt_t * x_t ⊗ B_t          H ∈ [P, N]
    y_t = H_t · C_t + D * x_t

Prefill computes it in the chunked form through ``kernels.ssm_scan`` (the
plain version on CPU tensors, the hand-written CUDA kernel on the card);
decode is the one-step recurrence, plain torch.  As in the reference, the
depthwise conv runs on separate x/B/C streams, which is exactly the fused
conv of the original.

Shapes: x [B,S,H,P]; dt [B,S,H]; B,C [B,S,N] (single group, shared across
heads); A_log [H]; D [H].  The blocks run at the heads their weights hold
(H = ``w_dt``'s columns, d_inner = ``w_x``'s): all of them, or on a mesh
this rank's, with the gated norm's statistics and ``w_out``'s product
joined over the "model" group (``layers.rms_norm``, ``layers.matmul``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssm_scan.ops import ssd_chunked_kernel
from repro_torch.kernels.ssm_scan.ref import ssd_chunked_ref
from repro_torch.models.layers import matmul, rms_norm


def ssd_chunked(x, dt, a_log, b, c, d_skip, chunk: int):
    """Chunked SSD scan.  Returns (y [B,S,H,P] f32, final_state
    [B,H,P,N] f32)."""
    return ssd_chunked_kernel(x, dt, a_log, b, c, d_skip, chunk)


def ssd_step(state, x_t, dt_t, a_log, b_t, c_t, d_skip):
    """Single-token SSD recurrence.

    state [B,H,P,N]; x_t [B,H,P]; dt_t [B,H]; b_t/c_t [B,N].
    Returns (y_t [B,H,P], new_state), f32.
    """
    a = torch.exp(-torch.exp(a_log.float())[None, :] * dt_t.float())  # [B,H]
    xb = x_t.float() * dt_t.float()[..., None]
    outer = torch.einsum("bhp,bn->bhpn", xb, b_t.float())
    new_state = state * a[..., None, None] + outer
    y = torch.einsum("bhpn,bn->bhp", new_state, c_t.float())
    return y + d_skip.float()[None, :, None] * x_t.float(), new_state


# --------------------------------------------------------------------------
# Full Mamba2 block: projections + causal depthwise convs + SSD + gated norm
# --------------------------------------------------------------------------
def mamba2_param_shapes(cfg) -> dict:
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    return {
        "w_z": (d, di), "w_x": (d, di), "w_b": (d, n), "w_c": (d, n),
        "w_dt": (d, h),
        "conv_x_w": (cfg.ssm_conv, di), "conv_x_b": (di,),
        "conv_b_w": (cfg.ssm_conv, n), "conv_b_b": (n,),
        "conv_c_w": (cfg.ssm_conv, n), "conv_c_b": (n,),
        "a_log": (h,), "d_skip": (h,), "dt_bias": (h,),
        "norm_scale": (di,), "w_out": (di, d),
    }


def _held(params, cfg) -> tuple[int, int, int]:
    """(d_inner, N, H) at the heads the weights hold."""
    return params["w_x"].shape[1], cfg.ssm_state, params["w_dt"].shape[1]


def _causal_conv(x, w, b):
    """Depthwise causal conv + silu over the sequence axis.  x [B,S,C]."""
    w32 = w.float()
    width, s = w32.shape[0], x.shape[1]
    padded = F.pad(x.float(), (0, 0, width - 1, 0))
    out = sum(padded[:, i:i + s] * w32[i] for i in range(width))
    return F.silu(out + b.float()).to(x.dtype)


def _conv_step(window, w, b):
    """window [B,W,C] (already includes the new token last) → f32 [B,C]."""
    out = torch.einsum("bwc,wc->bc", window.float(), w.float())
    return F.silu(out + b.float())


def mamba2_block(params, x, cfg, *, impl: str = "chunked"):
    """Full-segment Mamba2.  x [B,S,d] → (y [B,S,d], (ssm_state,
    conv_tail)).  ``impl="naive"`` takes the plain chunked scan on every
    device (the oracle path); otherwise :func:`ssd_chunked`."""
    bsz, s, _ = x.shape
    di, n, h = _held(params, cfg)
    p = di // h
    z = matmul(x, params["w_z"])
    x_pre = matmul(x, params["w_x"])
    b_pre = matmul(x, params["w_b"])
    c_pre = matmul(x, params["w_c"])
    dt_raw = matmul(x, params["w_dt"])
    tail = cfg.ssm_conv - 1
    conv_tail = torch.cat([x_pre[:, -tail:], b_pre[:, -tail:],
                           c_pre[:, -tail:]], dim=-1)
    xs = _causal_conv(x_pre, params["conv_x_w"], params["conv_x_b"])
    b = _causal_conv(b_pre, params["conv_b_w"], params["conv_b_b"])
    c = _causal_conv(c_pre, params["conv_c_w"], params["conv_c_b"])
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())
    scan = ssd_chunked_ref if impl == "naive" else ssd_chunked
    y, ssm_state = scan(xs.reshape(bsz, s, h, p), dt, params["a_log"], b, c,
                        params["d_skip"], cfg.ssm_chunk)
    y = y.reshape(bsz, s, di).to(x.dtype)
    y = rms_norm(y * F.silu(z.float()).to(x.dtype), params["norm_scale"],
                 cfg.norm_eps)
    return matmul(y, params["w_out"]), (ssm_state.float(), conv_tail)


def mamba2_step(params, x, cfg, *, ssm_state, conv_state):
    """Single-token Mamba2.  x [B,1,d]; conv_state [B,W-1,di+2n].  Returns
    (y [B,1,d], (new_ssm_state, new_conv_state))."""
    bsz = x.shape[0]
    di, n, h = _held(params, cfg)
    p = di // h
    z = matmul(x, params["w_z"])
    new_col = torch.cat([matmul(x, params["w_x"]), matmul(x, params["w_b"]),
                         matmul(x, params["w_c"])], dim=-1)  # [B,1,di+2n]
    dt_raw = matmul(x, params["w_dt"])
    window = torch.cat([conv_state, new_col.to(conv_state.dtype)], dim=1)
    xw, bw, cw = window[..., :di], window[..., di:di + n], window[..., di + n:]
    xs = _conv_step(xw, params["conv_x_w"], params["conv_x_b"]).to(x.dtype)
    b = _conv_step(bw, params["conv_b_w"], params["conv_b_b"]).to(x.dtype)
    c = _conv_step(cw, params["conv_c_w"], params["conv_c_b"]).to(x.dtype)
    dt = F.softplus(dt_raw[:, 0].float() + params["dt_bias"].float())
    y, new_ssm = ssd_step(ssm_state, xs.reshape(bsz, h, p), dt,
                          params["a_log"], b, c, params["d_skip"])
    y = y.reshape(bsz, 1, di).to(x.dtype)
    y = rms_norm(y * F.silu(z.float()).to(x.dtype), params["norm_scale"],
                 cfg.norm_eps)
    return matmul(y, params["w_out"]), (new_ssm, window[:, 1:])
