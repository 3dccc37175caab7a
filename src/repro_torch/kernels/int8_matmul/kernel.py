"""Wrapper of the CUDA W8A16 matmul kernels (``csrc/int8_matmul.cu``), and
the rule by which a call picks one of them."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the three kernels behind ``int8_matmul``, by the number the C entry
#: takes: f32 x on the CUDA cores; bf16 x on the tensor cores through
#: ``mma.sync`` (decode, the LM head, shapes TMA cannot take); bf16 x at
#: prefill sizes through ``wgmma`` fed by TMA
ROUTES = ("w8a16_f32", "w8a16_mma", "w8a16_wgmma")
#: fewest rows of x for which bf16 takes ``w8a16_wgmma``: below it
#: ``w8a16_mma`` is faster (at qwen3-1.7b's up projection, K 2048, N 6144,
#: on the H100: 28.53 against 30.98 µs at M 48, 31.51 against 31.23 at
#: M 64; ``python -m repro_torch.bench.kernels --int8-routes``, PERF.md)
WGMMA_MIN_M = 64


def choose_route(dtype: torch.dtype, m: int, k: int, n: int,
                 bases: tuple = (0, 0, 0)) -> str:
    """The kernel a call of x [m, k] (``dtype``) × w_q [k, n] takes, by
    dtype, M and TMA's alignment rules alone.

    f32 x takes ``w8a16_f32``.  bf16 x takes ``w8a16_wgmma`` where m is at
    least :data:`WGMMA_MIN_M` and TMA can read and write the rows: the
    bases of x, w_q and out (``bases``, their addresses) 16-byte aligned,
    x's rows a multiple of 16 bytes (k % 8 == 0), w_q's rows of whole
    16-byte pieces (n % 16 == 0, which also makes out's rows a multiple of
    16 bytes); any other bf16 call takes ``w8a16_mma``."""
    if dtype == torch.float32:
        return "w8a16_f32"
    if dtype != torch.bfloat16:
        raise TypeError(f"int8_matmul takes float32 or bfloat16 x, got "
                        f"{dtype}")
    aligned = (k % 8 == 0 and n % 16 == 0
               and all(int(b) % 16 == 0 for b in bases))
    return "w8a16_wgmma" if m >= WGMMA_MIN_M and aligned else "w8a16_mma"


def _lib() -> ctypes.CDLL:
    lib = _build.load("int8_matmul")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.int8_matmul_workspace.argtypes = [i, i, i, i]
    lib.int8_matmul_workspace.restype = ctypes.c_longlong
    lib.int8_matmul_pack.argtypes = [p, p, i, i, p]
    lib.int8_matmul_pack.restype = ctypes.c_int
    lib.int8_matmul.argtypes = [p] * 5 + [i] * 5 + [p]
    lib.int8_matmul.restype = ctypes.c_int
    return lib


def _workspace(lib, m: int, n: int, k: int, route: int,
               device) -> torch.Tensor | None:
    nbytes = lib.int8_matmul_workspace(m, n, k, route)
    if nbytes < 0:
        _build.check(lib, int(-nbytes), "int8_matmul (plan)")
    return (torch.empty(nbytes, dtype=torch.uint8, device=device)
            if nbytes > 0 else None)


def int8_matmul_kernel(x: torch.Tensor, w_q: torch.Tensor,
                       scale: torch.Tensor, *, route: str | None = None
                       ) -> torch.Tensor:
    """x [M,K] float32 or bfloat16, w_q [K,N] int8, scale [N] float32, all
    contiguous on one CUDA device → ``(x · w_q) * scale`` [M,N] in x's
    dtype, summed in f32.

    ``route`` (one of :data:`ROUTES`; default :func:`choose_route`) names
    the kernel; one that cannot take the call raises.  bf16 runs on the
    tensor cores, f32 on the CUDA cores (no TF32).  Ragged M, N and K are
    masked in the kernels: x is not padded or copied.  The workspace is
    allocated here: ``w8a16_wgmma``'s copy of the weight in fragment order,
    or the f32 partial sums where K is split across blocks (reduced in a
    fixed order)."""
    ts = (x, w_q, scale)
    if x.dtype not in _DTYPES or w_q.dtype != torch.int8 \
            or scale.dtype != torch.float32:
        raise TypeError("int8_matmul_kernel takes x float32 or bfloat16, "
                        "w_q int8 and scale float32, got "
                        f"{[t.dtype for t in ts]}")
    if x.ndim != 2 or w_q.ndim != 2 or scale.shape != w_q.shape[1:] \
            or x.shape[1] != w_q.shape[0]:
        raise ValueError(f"shapes x {tuple(x.shape)}, w_q "
                         f"{tuple(w_q.shape)}, scale {tuple(scale.shape)} "
                         "do not fit [M,K], [K,N], [N]")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("int8_matmul_kernel inputs must be contiguous")
    if x.device.type != "cuda" or any(t.device != x.device for t in ts):
        raise ValueError("int8_matmul_kernel needs x, w_q and scale on one "
                         f"CUDA device, got {[str(t.device) for t in ts]}")
    if route is not None and route not in ROUTES:
        raise ValueError(f"route {route!r} is not one of {ROUTES}")
    (m, k), n = x.shape, w_q.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    route = route or choose_route(
        x.dtype, m, k, n, (x.data_ptr(), w_q.data_ptr(), out.data_ptr()))
    lib = _lib()
    r = ROUTES.index(route)
    with torch.cuda.device(x.device):
        ws = _workspace(lib, m, n, k, r, x.device)
        rc = lib.int8_matmul(_build.ptr(x), _build.ptr(w_q),
                             _build.ptr(scale), _build.ptr(out),
                             None if ws is None else _build.ptr(ws),
                             _DTYPES[x.dtype], m, n, k, r,
                             _build.stream_of(x))
    _build.check(lib, rc, f"int8_matmul ({route})")
    int8_matmul_kernel.launches += 1
    int8_matmul_kernel.by_route[route] += 1
    return out


def pack_fragments_kernel(w_q: torch.Tensor) -> torch.Tensor:
    """w_q [K,N] int8, contiguous on a CUDA device, N % 16 == 0 → the flat
    weight in ``w8a16_wgmma``'s fragment order, from the pass the kernel
    runs first (the plain version: ``ref.pack_fragments``)."""
    if w_q.device.type != "cuda" or w_q.dtype != torch.int8 \
            or w_q.ndim != 2 or not w_q.is_contiguous() or 0 in w_q.shape:
        raise ValueError("pack_fragments_kernel takes a contiguous, "
                         "non-empty [K, N] int8 tensor on a CUDA device")
    k, n = w_q.shape
    lib = _lib()
    with torch.cuda.device(w_q.device):
        packed = _workspace(lib, 1, n, k, ROUTES.index("w8a16_wgmma"),
                            w_q.device)
        rc = lib.int8_matmul_pack(_build.ptr(w_q), _build.ptr(packed), n, k,
                                  _build.stream_of(w_q))
    _build.check(lib, rc, "int8_matmul (pack_fragments)")
    return packed.view(torch.int8)


def reset_counts() -> None:
    """Set the launch counts (all, and per route) to 0."""
    int8_matmul_kernel.launches = 0
    int8_matmul_kernel.by_route = dict.fromkeys(ROUTES, 0)


#: launches of the CUDA kernels since the counts were last set to 0, in all
#: (``launches``) and per route (``by_route``)
reset_counts()
