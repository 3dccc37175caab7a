"""Wrapper of the CUDA singleton placement scan (``csrc/fleet_scan.cu``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: the kernel keeps avail and, double buffered, a chunk of at least one
#: step's etc row and arrival time in shared memory (232,448 bytes)
MAX_NODES = (232448 - 16) // 24


def _lib() -> ctypes.CDLL:
    lib = _build.load("fleet_scan")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fleet_scan.argtypes = [p, p, p, p, p, p, p, i, ll, p, p, p, p, p]
    lib.fleet_scan.restype = ctypes.c_int
    return lib


def place_singletons_kernel(avail: torch.Tensor, peak_eff: torch.Tensor,
                            bwc_rows: torch.Tensor, ts: torch.Tensor,
                            fls: torch.Tensor, ibs: torch.Tensor,
                            segs: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor, torch.Tensor]:
    """avail [N] f64 (updated in place), peak_eff [N] f64, bwc_rows [K, N]
    f64, ts, fls, ibs [n] f64, segs [n] int64, all contiguous on one CUDA
    device → (j [n] int64, start, finish, etc [n] f64): the ``n``
    placements in one launch of one block, equal to
    ``ref.place_singletons_ref`` bit for bit.  ``segs`` are not checked
    against K on the card."""
    ts_ = (avail, peak_eff, bwc_rows, ts, fls, ibs, segs)
    if avail.device.type != "cuda" or any(t.device != avail.device
                                          for t in ts_):
        raise ValueError("place_singletons_kernel needs its inputs on one "
                         f"CUDA device, got {[str(t.device) for t in ts_]}")
    if any(t.dtype != torch.float64 for t in ts_[:6]) \
            or segs.dtype != torch.int64:
        raise TypeError("avail, peak_eff, bwc_rows, ts, fls and ibs must be "
                        "float64 and segs int64, got "
                        f"{[t.dtype for t in ts_]}")
    n_nodes, n = avail.numel(), ts.numel()
    if (avail.ndim != 1 or peak_eff.shape != (n_nodes,)
            or bwc_rows.ndim != 2 or bwc_rows.shape[1] != n_nodes
            or bwc_rows.shape[0] < 1 or any(t.shape != (n,)
                                            for t in (ts, fls, ibs, segs))):
        raise ValueError(f"avail and peak_eff must be [N], bwc_rows [K, N] "
                         f"and ts, fls, ibs, segs [n], got "
                         f"{[tuple(t.shape) for t in ts_]}")
    if not all(t.is_contiguous() for t in ts_):
        raise ValueError("place_singletons_kernel inputs must be contiguous")
    if not 1 <= n_nodes <= MAX_NODES:
        raise ValueError(f"{n_nodes} nodes: the kernel takes 1 to "
                         f"{MAX_NODES}")
    j = torch.empty(n, dtype=torch.int64, device=avail.device)
    start, finish, etc = (torch.empty(n, dtype=torch.float64,
                                      device=avail.device) for _ in range(3))
    if n == 0:
        return j, start, finish, etc
    lib = _lib()
    with torch.cuda.device(avail.device):
        rc = lib.fleet_scan(*(_build.ptr(t) for t in ts_), n_nodes, n,
                            _build.ptr(j), _build.ptr(start),
                            _build.ptr(finish), _build.ptr(etc),
                            _build.stream_of(avail))
    _build.check(lib, rc, "fleet_scan")
    place_singletons_kernel.launches += 1
    return j, start, finish, etc


#: launches of the CUDA kernel since the count was last set to 0
place_singletons_kernel.launches = 0
