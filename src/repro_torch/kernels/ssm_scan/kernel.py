"""Wrapper of the CUDA chunked SSD scan kernels (``csrc/ssm_scan.cu``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: the kernels' shared-memory capacities: chunk, head dim, state dim
MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 128, 64, 64
#: the two CUDA kernels each call launches, in order
KERNELS = ("ssd_cb", "ssd_chunk")
#: the two CUDA kernels each backward call launches, in order: the reverse
#: chain over chunks, then one block per (batch row, chunk, group of heads)
BWD_KERNELS = ("ssd_bwd_chain", "ssd_bwd_chunk")
#: heads a block of ``ssd_bwd_chunk`` may take besides 1 (``head_group``)
HEAD_GROUPS = (4, 2)


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssm_scan")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssm_scan_cb.argtypes = [p] * 3 + [i] * 4 + [p]
    lib.ssm_scan_cb.restype = ctypes.c_int
    lib.ssm_scan_chunks.argtypes = [p] * 10 + [i] * 6 + [p]
    lib.ssm_scan_chunks.restype = ctypes.c_int
    lib.ssm_scan_bwd_chain.argtypes = [p] * 6 + [i] * 6 + [p]
    lib.ssm_scan_bwd_chain.restype = ctypes.c_int
    lib.ssm_scan_bwd_chunks.argtypes = [p] * 12 + [i] * 7 + [p]
    lib.ssm_scan_bwd_chunks.restype = ctypes.c_int
    return lib


def _check_inputs(xdt, loga, b, c, chunk) -> int:
    """Raise on what the kernels do not take; return the chunk used."""
    ts = (xdt, loga, b, c)
    if xdt.device.type != "cuda" or any(t.device != xdt.device for t in ts):
        raise ValueError("ssd_scan_kernel needs all inputs on one CUDA "
                         f"device, got {[str(t.device) for t in ts]}")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("ssd_scan_kernel takes float32 inputs, got "
                        f"{[t.dtype for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("ssd_scan_kernel inputs must be contiguous")
    if xdt.ndim != 4:
        raise ValueError(f"xdt must be [B,S,H,P], got {tuple(xdt.shape)}")
    bsz, s, h, p = xdt.shape
    n = b.shape[-1]
    if (loga.shape != (bsz, s, h) or b.ndim != 3 or b.shape[:2] != (bsz, s)
            or c.shape != b.shape):
        raise ValueError(f"shapes xdt {tuple(xdt.shape)}, loga "
                         f"{tuple(loga.shape)}, b {tuple(b.shape)}, c "
                         f"{tuple(c.shape)} do not fit [B,S,H,P], [B,S,H], "
                         "[B,S,N], [B,S,N]")
    chunk = min(int(chunk), s) if s else int(chunk)
    if not (1 <= chunk <= MAX_CHUNK and p <= MAX_HEAD_DIM
            and n <= MAX_STATE):
        raise ValueError(f"chunk {chunk}, P {p}, N {n} outside the kernel's "
                         f"capacities ({MAX_CHUNK}, {MAX_HEAD_DIM}, "
                         f"{MAX_STATE})")
    return chunk


def cb_kernel(b: torch.Tensor, c: torch.Tensor, chunk: int) -> torch.Tensor:
    """b/c [B,S,N] as ``ssd_scan_kernel`` takes them (S >= 1) → [B, nc,
    128, 128] float32: per batch row and chunk, C_t · B_s at [s][t] over the
    chunk's steps, 0 elsewhere (``ssd_cb``, one launch, counted in
    ``ssd_scan_kernel.by_kernel``)."""
    bsz, s, n = b.shape
    nc = -(-s // chunk)
    cb = torch.empty((bsz, nc, MAX_CHUNK, MAX_CHUNK), dtype=torch.float32,
                     device=b.device)
    lib = _lib()
    with torch.cuda.device(b.device):
        rc = lib.ssm_scan_cb(_build.ptr(b), _build.ptr(c), _build.ptr(cb),
                             bsz, s, n, chunk, _build.stream_of(b))
    _build.check(lib, rc, "ssm_scan (ssd_cb)")
    ssd_scan_kernel.by_kernel["ssd_cb"] += 1
    return cb


def _states(bsz: int, h: int, s: int, chunk: int, device) -> torch.Tensor:
    """[B·H, nc, 64, 64] f32: one [P, N] state a (batch, head, chunk), at
    the kernels' capacities."""
    return torch.empty((bsz * h, -(-s // chunk), MAX_HEAD_DIM, MAX_STATE),
                       dtype=torch.float32, device=device)


def chunk_kernel(xdt: torch.Tensor, loga: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor, cb: torch.Tensor, chunk: int,
                 h_prev: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The scan from ``cb_kernel``'s C·Bᵀ (``ssd_chunk``, one launch,
    counted in ``ssd_scan_kernel.by_kernel``): every (batch, head, chunk) a
    block, the state handed from chunk to chunk → (y, final state).  Given
    ``h_prev`` (:func:`_states`), each block also writes the state its
    chunk starts from there."""
    bsz, s, h, p = xdt.shape
    n = b.shape[-1]
    y = torch.empty_like(xdt)
    state = torch.empty((bsz, h, p, n), dtype=torch.float32,
                        device=xdt.device)
    hbuf = torch.empty((2, bsz * h, MAX_HEAD_DIM, MAX_STATE),
                       dtype=torch.float32, device=xdt.device)
    counters = torch.empty(bsz * h + 1, dtype=torch.int32,
                           device=xdt.device)
    lib = _lib()
    save = None if h_prev is None else _build.ptr(h_prev)
    with torch.cuda.device(xdt.device):
        rc = lib.ssm_scan_chunks(
            *(_build.ptr(t) for t in (xdt, loga, b, c, cb, y, state, hbuf,
                                      counters)), save,
            bsz, s, h, p, n, chunk, _build.stream_of(xdt))
    _build.check(lib, rc, "ssm_scan (ssd_chunk)")
    ssd_scan_kernel.by_kernel["ssd_chunk"] += 1
    return y, state


def ssd_scan_kernel(xdt: torch.Tensor, loga: torch.Tensor, b: torch.Tensor,
                    c: torch.Tensor, chunk: int, *,
                    save_states: bool = False):
    """xdt [B,S,H,P], loga [B,S,H], b/c [B,S,N], all contiguous float32 on
    one CUDA device → (y [B,S,H,P], final state [B,H,P,N]), float32.

    The scan without the D skip term (the caller adds it), in chunks of
    ``chunk`` steps; a ragged last chunk acts as if padded with dt = 0.
    Two launches: C·Bᵀ once per batch row and chunk (``cb_kernel``), then
    the chunks (``chunk_kernel``); ``launches`` counts calls.  With
    ``save_states`` it returns a third item, what
    :func:`ssd_scan_bwd_kernel` reads: (C·Bᵀ, each chunk's incoming state
    [B·H, nc, 64, 64])."""
    chunk = _check_inputs(xdt, loga, b, c, chunk)
    bsz, s, h, p = xdt.shape
    if bsz * h == 0 or s == 0 or p == 0 or b.shape[-1] == 0:
        out = (torch.zeros_like(xdt),
               torch.zeros((bsz, h, p, b.shape[-1]), dtype=torch.float32,
                           device=xdt.device))
        return (*out, None) if save_states else out
    cb = cb_kernel(b, c, chunk)
    h_prev = _states(bsz, h, s, chunk, xdt.device) if save_states else None
    out = chunk_kernel(xdt, loga, b, c, cb, chunk, h_prev)
    ssd_scan_kernel.launches += 1
    return (*out, (cb, h_prev)) if save_states else out


def ssd_scan_bwd_kernel(xdt: torch.Tensor, loga: torch.Tensor,
                        b: torch.Tensor, c: torch.Tensor,
                        cb: torch.Tensor, h_prev: torch.Tensor, chunk: int,
                        y_cot: torch.Tensor | None,
                        state_cot: torch.Tensor | None, *,
                        heads_per_block: int | None = None
                        ) -> tuple[torch.Tensor, ...]:
    """The backward of :func:`ssd_scan_kernel` from what it saved (``cb``,
    ``h_prev``) and the cotangents of y [B,S,H,P] and of the final state
    [B,H,P,N] (either None: zero) → (dxdt, dloga, db, dc), f32:
    :func:`~repro_torch.kernels.ssm_scan.ref.ssd_scan_chunked_bwd_ref`.

    Two launches (``by_kernel``): ``ssd_bwd_chain`` runs the chunks from
    the last down, each forming the cotangent of the state after it, dH;
    ``ssd_bwd_chunk`` then gives every (batch row, chunk, group of heads)
    a block that forms dxdt and dloga of each head on the tensor cores in
    split TF32 (f32 accuracy) and the group's share of dB and dC.  Where
    there are several groups (``heads_per_block``, default
    :func:`head_group`) the shares are summed here, in a fixed order: two
    calls give the same bits.  ``launches`` counts calls."""
    chunk = _check_inputs(xdt, loga, b, c, chunk)
    bsz, s, h, p = xdt.shape
    n = b.shape[-1]
    dev = xdt.device
    y_cot = (torch.zeros_like(xdt) if y_cot is None
             else y_cot.float().contiguous())
    state_cot = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                             device=dev) if state_cot is None
                 else state_cot.float().contiguous())
    if y_cot.shape != xdt.shape or state_cot.shape != (bsz, h, p, n):
        raise ValueError(f"cotangents {tuple(y_cot.shape)} and "
                         f"{tuple(state_cot.shape)} do not fit y "
                         f"{tuple(xdt.shape)} and the state "
                         f"{(bsz, h, p, n)}")
    nc = -(-s // chunk)
    if (cb.shape != (bsz, nc, MAX_CHUNK, MAX_CHUNK)
            or h_prev.shape != (bsz * h, nc, MAX_HEAD_DIM, MAX_STATE)):
        raise ValueError(f"saved cb {tuple(cb.shape)} and h_prev "
                         f"{tuple(h_prev.shape)} are not the forward's at "
                         f"this shape and chunk {chunk}")
    d_h = bwd_chain_kernel(loga, c, y_cot, state_cot, chunk)
    dxdt, dloga, db, dc = bwd_chunk_kernel(xdt, loga, b, c, cb, h_prev, d_h,
                                           y_cot, chunk, heads_per_block)
    ssd_scan_bwd_kernel.launches += 1
    return dxdt, dloga, *head_sum(db, dc)


def bwd_chain_kernel(loga: torch.Tensor, c: torch.Tensor,
                     y_cot: torch.Tensor, state_cot: torch.Tensor,
                     chunk: int) -> torch.Tensor:
    """The backward's reverse chain (``ssd_bwd_chain``, one launch, counted
    in ``ssd_scan_bwd_kernel.by_kernel``) → dH [B·H, nc, 64, 64]: the
    cotangent of the state after each chunk."""
    bsz, s, h = loga.shape
    p, n = y_cot.shape[-1], c.shape[-1]
    d_h = _states(bsz, h, s, chunk, loga.device)
    counters = torch.empty(bsz * h + 1, dtype=torch.int32,
                           device=loga.device)
    lib = _lib()
    with torch.cuda.device(loga.device):
        rc = lib.ssm_scan_bwd_chain(
            *(_build.ptr(t) for t in (loga, c, y_cot, state_cot, d_h,
                                      counters)),
            bsz, s, h, p, n, chunk, _build.stream_of(loga))
    _build.check(lib, rc, "ssm_scan (ssd_bwd_chain)")
    ssd_scan_bwd_kernel.by_kernel["ssd_bwd_chain"] += 1
    return d_h


def head_group(bsz: int, nc: int, h: int, sms: int) -> int:
    """Heads one block of ``ssd_bwd_chunk`` takes (1 or one of
    :data:`HEAD_GROUPS` up to H): the one that leaves the fewest heads on
    the busiest of the card's ``sms`` SMs (B·nc·ceil(H / group) blocks,
    one an SM at a time), the largest of those that tie.  More heads a
    block load B and C once for more of them and leave fewer shares of dB
    and dC to add; fewer fill the card."""
    def busiest(g: int) -> int:
        return -(-bsz * nc * -(-h // g) // sms) * g

    return min((g for g in (*HEAD_GROUPS, 1) if g == 1 or g <= h),
               key=lambda g: (busiest(g), -g))


def bwd_chunk_kernel(xdt: torch.Tensor, loga: torch.Tensor, b: torch.Tensor,
                     c: torch.Tensor, cb: torch.Tensor, h_prev: torch.Tensor,
                     d_h: torch.Tensor, y_cot: torch.Tensor, chunk: int,
                     heads_per_block: int | None = None
                     ) -> tuple[torch.Tensor, ...]:
    """The backward's chunks (``ssd_bwd_chunk``, one launch, counted in
    ``ssd_scan_bwd_kernel.by_kernel``): a block per (batch row, chunk,
    group of ``heads_per_block`` heads; default :func:`head_group`) →
    dxdt, dloga, and dB and dC as one share a group, [G, B, S, N], that
    :func:`head_sum` adds up."""
    bsz, s, h, p = xdt.shape
    n = b.shape[-1]
    dev = xdt.device
    if heads_per_block is None:
        heads_per_block = head_group(
            bsz, -(-s // chunk), h, torch.cuda.get_device_properties(dev)
            .multi_processor_count)
    if heads_per_block < 1:
        raise ValueError(f"heads_per_block must be >= 1, got "
                         f"{heads_per_block}")
    groups = -(-h // heads_per_block)
    dxdt = torch.empty_like(xdt)
    dloga = torch.empty_like(loga)
    db = torch.empty((groups, bsz, s, n), dtype=torch.float32, device=dev)
    dc = torch.empty_like(db)
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.ssm_scan_bwd_chunks(
            *(_build.ptr(t) for t in (xdt, loga, b, c, cb, h_prev, d_h,
                                      y_cot, dxdt, dloga, db, dc)),
            bsz, s, h, p, n, chunk, heads_per_block, _build.stream_of(xdt))
    _build.check(lib, rc, "ssm_scan (ssd_bwd_chunk)")
    ssd_scan_bwd_kernel.by_kernel["ssd_bwd_chunk"] += 1
    return dxdt, dloga, db, dc


def head_sum(db: torch.Tensor, dc: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """dB and dC from :func:`bwd_chunk_kernel`'s shares: the one share
    itself, or the shares added in a fixed order (no atomics: two calls
    give the same bits)."""
    if db.shape[0] == 1:
        return db[0], dc[0]
    return db.sum(0), dc.sum(0)


def reset_counts() -> None:
    """Set the launch counts (calls, and per CUDA kernel) of the forward
    and the backward to 0."""
    ssd_scan_kernel.launches = 0
    ssd_scan_kernel.by_kernel = dict.fromkeys(KERNELS, 0)
    ssd_scan_bwd_kernel.launches = 0
    ssd_scan_bwd_kernel.by_kernel = dict.fromkeys(BWD_KERNELS, 0)


#: calls that launched the CUDA kernels since the counts were last set to
#: 0 (``launches``), and launches per kernel (``by_kernel``), of the forward
#: (``ssd_scan_kernel``) and of the backward (``ssd_scan_bwd_kernel``)
reset_counts()
