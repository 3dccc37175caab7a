"""Wrapper of the CUDA sLSTM recurrence kernels (``csrc/slstm_scan.cu``),
and the rule by which a call picks one of them."""
from __future__ import annotations

import ctypes

import torch

from repro_torch._device import true_f32
from repro_torch.kernels import _build
from repro_torch.kernels.slstm_scan.ref import SAVED

#: the two kernels behind ``slstm_scan``: a thread-block cluster per head
#: with its R slice in shared memory and h passed through distributed
#: shared memory; one block per head reading R from L2 (the first design)
ROUTES = ("cluster", "block")
#: units a head on the block route (4 du threads a block, at most 1024)
MAX_UNITS = 256
#: dynamic shared memory a block may use (the block route: 32 B du bytes)
SMEM_MAX = 232448
#: CTAs a cluster and lanes that split a unit's sums: the cluster route's
#: one plan.  At xlstm-350m's prefill on an H100, 8 × 8 ran a step in
#: ~2.3 µs; 8 × 16, 8 × 4, 4 × 8 and 4 × 4 ran slower (PERF.md)
CLUSTER, LANES = 8, 8
CLUSTER_THREADS = 512
#: batch rows a lane group holds (B is padded up to a multiple)
ROWS = 4
_OUT_DTYPES = (torch.float32, torch.bfloat16)


def _r_stride(du: int, el: int) -> int:
    """Elements of a unit's row of a CTA's R slice: du u's of four gates,
    padded to 64 bytes past a multiple of 128 (``csrc`` ``r_stride``)."""
    nbytes = 4 * du * el
    return (nbytes + (64 - nbytes % 128) % 128) // el


def cluster_smem(b: int, du: int, el: int) -> int:
    """Shared memory of a CTA of the cluster route: the head's h, [du] ×
    ``b`` rows padded to a multiple of 4, twice, then its R slice of
    du / :data:`CLUSTER` units in R's dtype (``el`` bytes an entry)."""
    rows = ROWS * -(-b // ROWS)
    return 4 * 2 * du * rows + (du // CLUSTER) * _r_stride(du, el) * el


def cluster_fits(b: int, du: int, r_dtype: torch.dtype) -> bool:
    """Whether the cluster route takes B rows at du units a head with R in
    ``r_dtype``: :data:`CLUSTER` divides du, a CTA's du / 8 · ceil(B / 4) ·
    8 threads are a multiple of 32 and at most :data:`CLUSTER_THREADS`, and
    its R slice and h buffers fit in :data:`SMEM_MAX` bytes."""
    el = torch.empty((), dtype=r_dtype).element_size()
    threads = du // CLUSTER * -(-b // ROWS) * LANES
    return (b >= 1 and du >= 1 and du % CLUSTER == 0 and threads % 32 == 0
            and threads <= CLUSTER_THREADS
            and cluster_smem(b, du, el) <= SMEM_MAX)


def choose_route(b: int, du: int, r_dtype: torch.dtype) -> str:
    """The kernel a call of B rows at du units a head takes, by shape and
    R's dtype alone: ``"cluster"`` where :func:`cluster_fits`, else
    ``"block"``."""
    return "cluster" if cluster_fits(b, du, r_dtype) else "block"


def _r_stride_bwd(units: int, el: int) -> int:
    """Elements of a row u of the backward's R slice: the CTA's units v of
    four gates, padded to 4 entries past a multiple of 128 bytes
    (``csrc`` ``r_stride_bwd``)."""
    nbytes = 4 * units * el
    return (nbytes + (4 * el - nbytes % 128) % 128) // el


def cluster_bwd_smem(b: int, du: int, el: int) -> int:
    """Shared memory of a CTA of the backward's cluster route: the partial
    sums of dh of its du / :data:`CLUSTER` units from every CTA, [8] ×
    [units] × ``b`` rows padded to a multiple of 4, twice; its units' four
    gates' dg; then the forward's R slice (every u, its own v), a row per
    u."""
    rows, units = ROWS * -(-b // ROWS), du // CLUSTER
    return (4 * (2 * CLUSTER * units * rows + units * rows * 4)
            + du * _r_stride_bwd(units, el) * el)


def bwd_routes(b: int, du: int, r_dtype: torch.dtype) -> tuple[str, ...]:
    """The backward kernels that take B rows at du units a head with R in
    ``r_dtype``: ``"cluster"`` where the forward's cluster plan takes the
    shape and :func:`cluster_bwd_smem` fits in :data:`SMEM_MAX`;
    ``"block"`` where du <= :data:`MAX_UNITS` and its 44 B du bytes fit.
    A call takes the first (``"cluster"`` before ``"block"``)."""
    el = torch.empty((), dtype=r_dtype).element_size()
    fits = {"cluster": cluster_fits(b, du, r_dtype)
            and cluster_bwd_smem(b, du, el) <= SMEM_MAX,
            "block": 1 <= du <= MAX_UNITS and 44 * b * du <= SMEM_MAX}
    return tuple(r for r in ROUTES if fits[r])


def _lib() -> ctypes.CDLL:
    lib = _build.load("slstm_scan")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.slstm_scan.argtypes = [p, p, i, p, i, p, p, p, p, p, i, i, i, i, p]
    lib.slstm_scan.restype = ctypes.c_int
    lib.slstm_scan_cluster.argtypes = lib.slstm_scan.argtypes
    lib.slstm_scan_cluster.restype = ctypes.c_int
    lib.slstm_scan_bwd.argtypes = [p, p, i] + [p] * 6 + [i] * 5 + [p]
    lib.slstm_scan_bwd.restype = ctypes.c_int
    return lib


def _route_checked(route: str | None, b: int, du: int,
                   r_dtype: torch.dtype) -> str:
    """The route a call takes; raises ``ValueError`` for an unknown route or one that cannot take the
    shape."""
    if route is not None and route not in ROUTES:
        raise ValueError(f"route {route!r} is not one of {ROUTES}")
    route = route or choose_route(b, du, r_dtype)
    if route == "block" and (not 1 <= du <= MAX_UNITS
                             or 32 * b * du > SMEM_MAX):
        raise ValueError(
            f"the block route takes du 1..{MAX_UNITS} and 32 B du <= "
            f"{SMEM_MAX} bytes of shared memory, not B {b} at du {du}")
    if route == "cluster" and not cluster_fits(b, du, r_dtype):
        raise ValueError(f"the cluster route does not take B {b} at du "
                         f"{du} with R in {r_dtype}")
    return route


def slstm_scan_kernel(pre: torch.Tensor, r: torch.Tensor, *,
                      out_dtype: torch.dtype = torch.float32,
                      route: str | None = None, save_states: bool = False):
    """pre [4, B, S, d] contiguous float32, r [4, H, du, du] contiguous
    float32 or bfloat16 (H du = d), on one CUDA device → (h [B, S, d] in
    ``out_dtype``, final (c, n, h, m), each [B, d] float32):
    :func:`~repro_torch.kernels.slstm_scan.ref.slstm_scan_ref` in one
    launch.

    ``route`` (one of :data:`ROUTES`; default :func:`choose_route`) names
    the kernel; one that cannot take the call raises ``ValueError`` before
    anything is built.  With ``save_states`` it returns a third item, what
    :func:`slstm_scan_bwd_kernel` reads: [8, B, S, d] f32, each step's
    state and gates (``ref.SAVED``).  ``launches`` counts launches,
    ``by_route`` launches per route."""
    if pre.dtype != torch.float32 or r.dtype not in (torch.float32,
                                                     torch.bfloat16):
        raise TypeError("pre must be float32 and r float32 or bfloat16, "
                        f"got {pre.dtype} and {r.dtype}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    if pre.ndim != 4 or r.ndim != 4 or pre.shape[0] != 4 or r.shape[0] != 4:
        raise ValueError(f"expected pre [4, B, S, d] and r [4, H, du, du], "
                         f"got {tuple(pre.shape)} and {tuple(r.shape)}")
    _, b, s, d = pre.shape
    _, h, du, du2 = r.shape
    if du != du2 or h * du != d:
        raise ValueError(f"r {tuple(r.shape)} is not [4, H, du, du] with "
                         f"H du = d = {d}")
    if not pre.is_contiguous() or not r.is_contiguous():
        raise ValueError("slstm_scan_kernel inputs must be contiguous")
    route = _route_checked(route, b, du, r.dtype)
    if pre.device.type != "cuda" or r.device != pre.device:
        raise ValueError("slstm_scan_kernel needs pre and r on one CUDA "
                         f"device, got {pre.device} and {r.device}")
    hs = torch.empty((b, s, d), dtype=out_dtype, device=pre.device)
    state = tuple(torch.empty((b, d), dtype=torch.float32,
                              device=pre.device) for _ in range(4))
    saved = (torch.empty((len(SAVED), b, s, d), dtype=torch.float32,
                         device=pre.device) if save_states else None)
    if b * s * d == 0:
        for t in state:
            t.zero_()
        return (hs, state, saved) if save_states else (hs, state)
    lib = _lib()
    args = (_build.ptr(pre), _build.ptr(r), int(r.dtype == torch.bfloat16),
            _build.ptr(hs), int(out_dtype == torch.bfloat16),
            *(_build.ptr(t) for t in state),
            None if saved is None else _build.ptr(saved), b, s, h, du)
    with torch.cuda.device(pre.device):
        entry = (lib.slstm_scan_cluster if route == "cluster"
                 else lib.slstm_scan)
        rc = entry(*args, _build.stream_of(pre))
    _build.check(lib, rc, f"slstm_scan ({route})")
    slstm_scan_kernel.launches += 1
    slstm_scan_kernel.by_route[route] += 1
    return (hs, state, saved) if save_states else (hs, state)


def slstm_scan_bwd_kernel(saved: torch.Tensor, r: torch.Tensor,
                          h_cot: torch.Tensor | None, state_cot, *,
                          route: str | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward of :func:`slstm_scan_kernel` from what it saved
    ([8, B, S, d]), R, and the cotangents of h [B, S, d] and of the final
    (c, n, h, m) [B, d] (any of them None: zero) → (dpre [4, B, S, d],
    dR [4, H, du, du]), f32: :func:`~repro_torch.kernels.slstm_scan.ref.
    slstm_scan_bwd_ref`.

    One launch, ``slstm_scan_bwd`` on ``route`` (default the first of
    :func:`bwd_routes`; ``by_route`` counts them), runs the reverse chain
    and writes dpre; dR = sum over b and t of h_{t-1}ᵀ dg_t is then one
    true-f32 batched product (a plain product outside the chain, as the
    reference leaves it to XLA).  ``launches`` counts calls."""
    if saved.ndim != 4 or saved.shape[0] != len(SAVED):
        raise ValueError(f"saved must be [{len(SAVED)}, B, S, d], got "
                         f"{tuple(saved.shape)}")
    _, b, s, d = saved.shape
    _, h, du, _ = r.shape
    if h * du != d or not (saved.is_contiguous() and r.is_contiguous()):
        raise ValueError(f"r {tuple(r.shape)} does not fit d = {d}, or an "
                         "input is not contiguous")
    if route is not None and route not in ROUTES:
        raise ValueError(f"route {route!r} is not one of {ROUTES}")
    takes = bwd_routes(b, du, r.dtype)
    route = route or (takes[0] if takes else "block")
    if route not in takes:
        raise ValueError(f"the backward's {route} route does not take B {b} "
                         f"at du {du} with R in {r.dtype}")
    dev = saved.device
    if dev.type != "cuda" or r.device != dev:
        raise ValueError("slstm_scan_bwd_kernel needs its inputs on one CUDA "
                         f"device, got {dev} and {r.device}")
    if b * s * d == 0:
        return (torch.zeros((4, b, s, d), dtype=torch.float32, device=dev),
                torch.zeros(r.shape, dtype=torch.float32, device=dev))
    dpre = bwd_chain_kernel(saved, r, h_cot, state_cot, route)
    slstm_scan_bwd_kernel.launches += 1
    return dpre, recurrent_grad(saved, dpre, h)


def bwd_chain_kernel(saved: torch.Tensor, r: torch.Tensor,
                     h_cot: torch.Tensor | None, state_cot, route: str
                     ) -> torch.Tensor:
    """The backward's reverse chain, ``slstm_scan_bwd`` on ``route`` (one
    launch, counted in ``slstm_scan_bwd_kernel.by_route``) → dpre [4, B,
    S, d] f32."""
    _, b, s, d = saved.shape
    _, h, du, _ = r.shape
    dev = saved.device
    zeros = torch.zeros((b, d), dtype=torch.float32, device=dev)
    h_cot = (torch.zeros((b, s, d), dtype=torch.float32, device=dev)
             if h_cot is None else h_cot.float().contiguous())
    finals = [zeros if g is None else g.float().contiguous()
              for g in (state_cot or (None,) * 4)]
    dpre = torch.empty((4, b, s, d), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.slstm_scan_bwd(
            _build.ptr(saved), _build.ptr(r), int(r.dtype == torch.bfloat16),
            *(_build.ptr(t) for t in (h_cot, *finals, dpre)),
            int(route == "cluster"), b, s, h, du, _build.stream_of(saved))
    _build.check(lib, rc, f"slstm_scan_bwd ({route})")
    slstm_scan_bwd_kernel.by_route[route] += 1
    return dpre


def recurrent_grad(saved: torch.Tensor, dpre: torch.Tensor, h: int
                   ) -> torch.Tensor:
    """dR [4, H, du, du] = sum over b and t of h_{t-1}ᵀ dg_t: one true-f32
    batched product (a plain product outside the chain, as the reference
    leaves it to XLA) of the saved h one step later, 0 before the first,
    and dpre."""
    _, b, s, d = saved.shape
    du = d // h
    h_prev = torch.nn.functional.pad(saved[SAVED.index("h"), :, :-1],
                                     (0, 0, 1, 0))
    with true_f32():
        return torch.einsum("xhu,gxhv->ghuv", h_prev.reshape(b * s, h, du),
                            dpre.reshape(4, b * s, h, du))


def reset_counts() -> None:
    """Set the launch counts (all, and per route) of the forward and the
    backward to 0."""
    slstm_scan_kernel.launches = 0
    slstm_scan_kernel.by_route = dict.fromkeys(ROUTES, 0)
    slstm_scan_bwd_kernel.launches = 0
    slstm_scan_bwd_kernel.by_route = dict.fromkeys(ROUTES, 0)


#: launches of the CUDA kernels since the counts were last set to 0, in all
#: (``launches``) and per route (``by_route``), of the forward
#: (``slstm_scan_kernel``) and of the backward (``slstm_scan_bwd_kernel``)
reset_counts()
