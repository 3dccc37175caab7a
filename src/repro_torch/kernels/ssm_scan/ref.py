"""Plain PyTorch versions of the SSD scan: the chunked form the kernel
computes and its backward, the model-level wrapper around it, and the
step-by-step recurrence."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _chunked(xdt, loga, b, c, chunk, *more):
    """Pad the sequence to whole chunks (dt = 0 steps: decay 1, input 0)
    and split it: xdt [B,nc,Q,H,P], loga [B,nc,Q,H], b/c [B,nc,Q,N], and
    each of ``more`` (shaped as xdt) as xdt."""
    bsz, s, h, p = xdt.shape
    n = b.shape[-1]
    q = min(chunk, s)
    pad = (-s) % q
    nc = (s + pad) // q
    split = [F.pad(t, (0, 0, 0, 0, 0, pad)).reshape(bsz, nc, q, h, p)
             for t in (xdt, *more)]
    return (split[0], F.pad(loga, (0, 0, 0, pad)).reshape(bsz, nc, q, h),
            F.pad(b, (0, 0, 0, pad)).reshape(bsz, nc, q, n),
            F.pad(c, (0, 0, 0, pad)).reshape(bsz, nc, q, n), *split[1:])


def ssd_scan_chunked_ref(xdt: torch.Tensor, loga: torch.Tensor,
                         b: torch.Tensor, c: torch.Tensor, chunk: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function: xdt [B,S,H,P], loga [B,S,H], b/c [B,S,N]
    (f32) → (y [B,S,H,P], final state [B,H,P,N]), without the D term.

    Dense per-chunk tiles, as ``repro.models.mamba2.ssd_chunked``: the
    causal decay-masked ``C·Bᵀ`` tile times ``dt·x``, the carried state's
    ``exp(csum)·C·Hᵀ``, then ``H' = exp(total)·H + (dt·x)ᵀ(B∘decay_out)``.
    """
    bsz, s, h, p = xdt.shape
    n = b.shape[-1]
    xc, lc, bc, cc = _chunked(xdt, loga, b, c, chunk)
    nc, q = lc.shape[1], lc.shape[2]
    causal = torch.tril(torch.ones(q, q, dtype=torch.bool,
                                   device=xdt.device))
    state = xdt.new_zeros((bsz, h, p, n))
    ys = []
    for i in range(nc):
        xq, lq, bq, cq = xc[:, i], lc[:, i], bc[:, i], cc[:, i]
        csum = torch.cumsum(lq, dim=1)                      # [B,Q,H]
        total = csum[:, -1]                                 # [B,H]
        y_inter = (torch.einsum("bqn,bhpn->bqhp", cq, state)
                   * torch.exp(csum)[..., None])
        rel = csum[:, :, None, :] - csum[:, None, :, :]     # [B,Q,Q,H]
        gate = torch.where(causal[None, :, :, None], torch.exp(rel), 0.0)
        scores = torch.einsum("bqn,bsn->bqs", cq, bq)       # [B,Q,Q]
        y_intra = torch.einsum("bqsh,bshp->bqhp", scores[..., None] * gate,
                               xq)
        decay_out = torch.exp(total[:, None] - csum)        # [B,Q,H]
        state = (state * torch.exp(total)[..., None, None]
                 + torch.einsum("bsh,bsn,bshp->bhpn", decay_out, bq, xq))
        ys.append(y_inter + y_intra)
    y = torch.stack(ys, dim=1).reshape(bsz, nc * q, h, p)[:, :s]
    return y, state


def ssd_scan_chunked_bwd_ref(xdt: torch.Tensor, loga: torch.Tensor,
                             b: torch.Tensor, c: torch.Tensor, chunk: int,
                             y_cot: torch.Tensor | None,
                             state_cot: torch.Tensor | None
                             ) -> tuple[torch.Tensor, ...]:
    """The backward of :func:`ssd_scan_chunked_ref`, written out per chunk:
    the cotangents ``y_cot`` [B,S,H,P] of y and ``state_cot`` [B,H,P,N] of
    the final state (either may be None: zero) → (dxdt, dloga, db, dc) in
    the inputs' shapes, f32.

    Per chunk, with csum the inclusive cumsum of loga, total = csum[Q-1],
    L[t,s] = exp(csum_t - csum_s) for s <= t (else 0), H_prev the state
    before the chunk and dH the cotangent of the state after it:

    - dH_prev = exp(total) dH + sum_t exp(csum_t) dy_t ⊗ C_t, from the last
      chunk (dH = state_cot) down;
    - with DX[t,s] = dy_t · xdt_s and W = L ∘ DX:
      dxdt_s = sum_{t>=s} (C_t·B_s) L[t,s] dy_t + exp(total - csum_s) dH B_s,
      dC_t = sum_s W[t,s] B_s + exp(csum_t) dy_t H_prev,
      dB_s = sum_t W[t,s] C_t + exp(total - csum_s) xdt_s dH,
      dB and dC summed over heads (B and C are shared by them);
    - dcsum from the intra gate (row sums minus column sums of
      (C·Bᵀ) ∘ W), from exp(csum) C·H_prev, from the state update's
      exp(total - csum) and, at Q-1, total's sum(dH ∘ H_new); dloga is
      its reverse cumsum within the chunk.

    A ragged last chunk acts as dt = 0 padding whose cotangents are
    dropped."""
    bsz, s, h, p = xdt.shape
    n = b.shape[-1]
    if y_cot is None:
        y_cot = torch.zeros_like(xdt)
    if state_cot is None:
        state_cot = xdt.new_zeros((bsz, h, p, n))
    xc, lc, bc, cc, dyc = _chunked(xdt, loga, b, c, chunk, y_cot.float())
    nc, q = lc.shape[1], lc.shape[2]
    csum = torch.cumsum(lc, dim=2)                          # [B,nc,Q,H]
    total = csum[:, :, -1]                                  # [B,nc,H]
    ecs, decay = torch.exp(csum), torch.exp(total)
    dout = torch.exp(total[:, :, None] - csum)              # [B,nc,Q,H]
    # the forward's chunk states: H_prev before each chunk, H_new after
    s_c = torch.einsum("bcsh,bcsn,bcshp->bchpn", dout, bc, xc)
    hps, state = [], xdt.new_zeros((bsz, h, p, n))
    for i in range(nc):
        hps.append(state)
        state = decay[:, i, :, None, None] * state + s_c[:, i]
    h_prev = torch.stack(hps, dim=1)                        # [B,nc,H,P,N]
    h_new = decay[..., None, None] * h_prev + s_c
    # the reverse chain: dH after each chunk
    sb = torch.einsum("bcth,bcthp,bctn->bchpn", ecs, dyc, cc)
    dhs, g = [], state_cot.float()
    for i in reversed(range(nc)):
        dhs.append(g)
        g = decay[:, i, :, None, None] * g + sb[:, i]
    d_h = torch.stack(dhs[::-1], dim=1)                     # [B,nc,H,P,N]
    # the intra-chunk terms
    causal = torch.tril(torch.ones(q, q, dtype=torch.bool,
                                   device=xdt.device))[None, None, :, :,
                                                       None]
    rel = csum[:, :, :, None, :] - csum[:, :, None, :, :]   # [B,nc,t,s,H]
    gate = torch.where(causal, torch.exp(rel), 0.0)
    cb = torch.einsum("bctn,bcsn->bcts", cc, bc)[..., None]
    w = gate * torch.einsum("bcthp,bcshp->bctsh", dyc, xc)
    t_cb = cb * w
    dxdt = (torch.einsum("bctsh,bcthp->bcshp", cb * gate, dyc)
            + dout[..., None] * torch.einsum("bcsn,bchpn->bcshp", bc, d_h))
    dc_inter = torch.einsum("bcth,bcthp,bchpn->bcthn", ecs, dyc, h_prev)
    db_state = torch.einsum("bcsh,bcshp,bchpn->bcshn", dout, xc, d_h)
    dc = torch.einsum("bctsh,bcsn->bctn", w, bc) + dc_inter.sum(3)
    db = torch.einsum("bctsh,bctn->bcsn", w, cc) + db_state.sum(3)
    dcsum = (t_cb.sum(3) - t_cb.sum(2)
             + torch.einsum("bcthn,bctn->bcth", dc_inter, cc)
             - torch.einsum("bcshn,bcsn->bcsh", db_state, bc))
    dcsum[:, :, -1] += (d_h * h_new).sum((-1, -2))
    dloga = torch.flip(torch.cumsum(torch.flip(dcsum, (2,)), 2), (2,))
    return (dxdt.reshape(bsz, nc * q, h, p)[:, :s],
            dloga.reshape(bsz, nc * q, h)[:, :s],
            db.reshape(bsz, nc * q, n)[:, :s],
            dc.reshape(bsz, nc * q, n)[:, :s])


def ssd_inputs(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(xdt = x·dt, loga = -exp(A_log)·dt) in f32 from x [B,S,H,P],
    dt [B,S,H], A_log [H]."""
    dt32 = dt.float()
    loga = -torch.exp(a_log.float())[None, None, :] * dt32
    return x.float() * dt32[..., None], loga


def ssd_chunked_ref(x, dt, a_log, b, c, d_skip, chunk: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Model-level chunked SSD: x [B,S,H,P], dt [B,S,H], b/c [B,S,N],
    A_log/D [H] → (y [B,S,H,P] f32 incl. ``D·x``, final state [B,H,P,N])."""
    xdt, loga = ssd_inputs(x, dt, a_log)
    y, state = ssd_scan_chunked_ref(xdt, loga, b.float(), c.float(), chunk)
    return y + d_skip.float()[None, None, :, None] * x.float(), state


def ssd_scan_ref(xdt, loga, b, c, *, n_heads_per_batch: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Step-by-step recurrence in f64, in the Pallas kernel's layout:
    xdt [BH,nc,Q,P], loga [BH,nc,Q,1], b/c [B,nc,Q,N] → (y [BH,nc,Q,P],
    state [BH,P,N]) in f32."""
    xdt, loga, b, c = (torch.as_tensor(t).double() for t in (xdt, loga, b, c))
    bh, nc, q, p = xdt.shape
    h = n_heads_per_batch
    y = torch.zeros_like(xdt)
    state = xdt.new_zeros((bh, p, b.shape[-1]))
    for i in range(bh):
        st = state[i]
        for ic in range(nc):
            for t in range(q):
                st = (st * torch.exp(loga[i, ic, t, 0])
                      + torch.outer(xdt[i, ic, t], b[i // h, ic, t]))
                y[i, ic, t] = st @ c[i // h, ic, t]
        state[i] = st
    return y.float(), state.float()
