"""Plain PyTorch versions of the SSD scan: the chunked form the kernel
computes, the model-level wrapper around it, and the step-by-step
recurrence."""
from __future__ import annotations

import torch
import torch.nn.functional as F


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
    q = min(chunk, s)
    pad = (-s) % q
    if pad:     # dt = 0 steps: decay 1, input 0
        xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
        loga = F.pad(loga, (0, 0, 0, pad))
        b, c = F.pad(b, (0, 0, 0, pad)), F.pad(c, (0, 0, 0, pad))
    nc = (s + pad) // q
    xc = xdt.reshape(bsz, nc, q, h, p)
    lc = loga.reshape(bsz, nc, q, h)
    bc, cc = b.reshape(bsz, nc, q, n), c.reshape(bsz, nc, q, n)
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
