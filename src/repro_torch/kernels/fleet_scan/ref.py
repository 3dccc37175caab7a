"""Plain PyTorch version of the fleet engine's singleton placement scan."""
from __future__ import annotations

import torch

#: tasks whose ETC rows are formed together (one ``[BLOCK, N]`` broadcast);
#: the placements themselves stay one after another
BLOCK = 4096


def place_singletons_ref(avail: torch.Tensor, peak_eff: torch.Tensor,
                         bwc_rows: torch.Tensor, ts: torch.Tensor,
                         fls: torch.Tensor, ibs: torch.Tensor,
                         segs: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor, torch.Tensor]:
    """Place ``n`` single-task arrival batches one after another.

    avail [N] f64 (updated in place), peak_eff [N] f64, bwc_rows [K, N]
    f64, ts, fls, ibs [n] f64, segs [n] int64 → (j [n] int64, start [n],
    finish [n], etc [n] f64).  Step k: ``etc = fls[k] / peak_eff + ibs[k] /
    bwc_rows[segs[k]]``, ``fin = max(avail, ts[k]) + etc``, ``j`` the first
    index of the least ``fin``, ``start = max(avail[j], ts[k])``,
    ``avail[j] = fin[j]`` — the reference's host loop
    (``repro/sim/fleet.py:463-476``) in its f64 arithmetic, so equal to it
    bit for bit.  Every division is tensor by tensor (IEEE), and
    ``torch.argmin`` returns the first of tied minima, as ``np.argmin``
    does.  No host sync inside the loop: indices stay tensors.
    """
    n, dev = ts.shape[0], avail.device
    j_out = torch.empty(n, dtype=torch.int64, device=dev)
    start, finish, etc = (torch.empty(n, dtype=torch.float64, device=dev)
                          for _ in range(3))
    for lo in range(0, n, BLOCK):
        hi = min(lo + BLOCK, n)
        rows = fls[lo:hi, None] / peak_eff[None, :] \
            + ibs[lo:hi, None] / bwc_rows[segs[lo:hi]]
        for k in range(lo, hi):
            row, t = rows[k - lo], ts[k:k + 1]
            fin = torch.maximum(avail, t) + row
            j = torch.argmin(fin, dim=0, keepdim=True)
            f_j = fin.index_select(0, j)
            start[k:k + 1] = torch.maximum(avail.index_select(0, j), t)
            finish[k:k + 1] = f_j
            etc[k:k + 1] = row.index_select(0, j)
            j_out[k:k + 1] = j
            avail.index_copy_(0, j, f_j)
    return j_out, start, finish, etc
