"""Wrapper of the CUDA singleton placement scans (``csrc/fleet_scan.cu``),
and the rule by which a call picks one of them."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: the kernel keeps avail and, double buffered, a chunk of at least one
#: step's etc row and arrival time in shared memory (232,448 bytes)
MAX_NODES = (232448 - 16) // 24
#: the two kernels behind ``place_singletons``: avail in the consumer
#: lanes' registers (up to :data:`REGISTER_NODES` nodes), avail in shared
#: memory (the first design)
ROUTES = ("registers", "shared")
#: most nodes the registers route takes: 8 a lane of the consumer warp
REGISTER_NODES = 256


def choose_route(n_nodes: int) -> str:
    """The kernel a call over ``n_nodes`` nodes takes, by that alone:
    ``"registers"`` up to :data:`REGISTER_NODES`, else ``"shared"``."""
    return "registers" if n_nodes <= REGISTER_NODES else "shared"


def _lib() -> ctypes.CDLL:
    lib = _build.load("fleet_scan")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fleet_scan.argtypes = [p, p, p, p, p, p, p, i, ll, p, p, p, p, p]
    lib.fleet_scan.restype = ctypes.c_int
    lib.fleet_scan_registers.argtypes = lib.fleet_scan.argtypes
    lib.fleet_scan_registers.restype = ctypes.c_int
    return lib


def place_singletons_kernel(avail: torch.Tensor, peak_eff: torch.Tensor,
                            bwc_rows: torch.Tensor, ts: torch.Tensor,
                            fls: torch.Tensor, ibs: torch.Tensor,
                            segs: torch.Tensor, *,
                            route: str | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor, torch.Tensor]:
    """avail [N] f64 (updated in place), peak_eff [N] f64, bwc_rows [K, N]
    f64, ts, fls, ibs [n] f64, segs [n] int64, all contiguous on one CUDA
    device → (j [n] int64, start, finish, etc [n] f64): the ``n``
    placements in one launch of one block, equal to
    ``ref.place_singletons_ref`` bit for bit.  ``segs`` are not checked
    against K on the card.

    ``route`` (one of :data:`ROUTES`; default :func:`choose_route`) names
    the kernel; one that cannot take the call raises ``ValueError`` before
    anything is built.  ``launches`` counts launches, ``by_route``
    launches per route."""
    ts_ = (avail, peak_eff, bwc_rows, ts, fls, ibs, segs)
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
    if route is not None and route not in ROUTES:
        raise ValueError(f"route {route!r} is not one of {ROUTES}")
    route = route or choose_route(n_nodes)
    if route == "registers" and n_nodes > REGISTER_NODES:
        raise ValueError(f"the registers route takes at most "
                         f"{REGISTER_NODES} nodes, got {n_nodes}")
    if avail.device.type != "cuda" or any(t.device != avail.device
                                          for t in ts_):
        raise ValueError("place_singletons_kernel needs its inputs on one "
                         f"CUDA device, got {[str(t.device) for t in ts_]}")
    j = torch.empty(n, dtype=torch.int64, device=avail.device)
    start, finish, etc = (torch.empty(n, dtype=torch.float64,
                                      device=avail.device) for _ in range(3))
    if n == 0:
        return j, start, finish, etc
    lib = _lib()
    args = (*(_build.ptr(t) for t in ts_), n_nodes, n, _build.ptr(j),
            _build.ptr(start), _build.ptr(finish), _build.ptr(etc))
    with torch.cuda.device(avail.device):
        entry = (lib.fleet_scan_registers if route == "registers"
                 else lib.fleet_scan)
        rc = entry(*args, _build.stream_of(avail))
    _build.check(lib, rc, f"fleet_scan ({route})")
    place_singletons_kernel.launches += 1
    place_singletons_kernel.by_route[route] += 1
    return j, start, finish, etc


def reset_counts() -> None:
    """Set the launch counts (all, and per route) to 0."""
    place_singletons_kernel.launches = 0
    place_singletons_kernel.by_route = dict.fromkeys(ROUTES, 0)


#: launches of the CUDA kernels since the counts were last set to 0, in all
#: (``launches``) and per route (``by_route``)
reset_counts()
