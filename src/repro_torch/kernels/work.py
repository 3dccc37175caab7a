"""The work of the model-path kernels: (bytes, operations) of one call of
flash attention, the SSD scan and the sLSTM recurrence, each forward and
backward, from its shapes.

One source for every count of the port: the kernel bench's bounds
(``bench.kernels``), ``chip_smoke.py``'s bounds, and the FLOP formulas that
``torch.utils.flop_counter.FlopCounterMode`` reads for the kernels' custom
ops (``kernels.ops``), and so the dry-run's FLOPs.  Operations count the
multiply-adds (2 each) of the products the kernel forms, masked work left
out; ``dense=True`` counts the SSD scan's chunk tiles whole, as its plain
version forms them (``tests/test_torch_kernel_work.py`` holds each count
against ``FlopCounterMode`` of the plain version).
"""
from __future__ import annotations

import numpy as np


def attention_pairs(sq: int, sk: int, *, causal: bool = True,
                    window: int = 0, valid_len: int = 0) -> int:
    """(query, key) pairs left by the masks of
    ``flash_attention.ref.attention_ref``: ``col < valid_len`` (0: Sk),
    ``col <= row`` when causal, ``row - col < window`` when window > 0."""
    row = np.arange(sq, dtype=np.int64)
    hi = np.full(sq, min(valid_len or sk, sk) - 1, np.int64)
    if causal:
        hi = np.minimum(hi, row)
    lo = np.maximum(row - window + 1, 0) if window else np.zeros(sq,
                                                                 np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_work(b: int, s: int, hq: int, hkv: int, d: int, el: int,
               dv: int | None = None, *, sk: int | None = None,
               causal: bool = True, window: int = 0, valid_len: int = 0
               ) -> tuple[int, int]:
    """(bytes, operations) of attention of ``s`` queries over ``sk`` keys
    (default ``s``) with q/k head dim ``d`` and v/o head dim ``dv``
    (default ``d``): q, k, v read and o written once; q·kᵀ and p·v over
    the (row, col) pairs the masks leave (:func:`attention_pairs`)."""
    dv = d if dv is None else dv
    sk = s if sk is None else sk
    pairs = attention_pairs(s, sk, causal=causal, window=window,
                            valid_len=valid_len)
    return ((b * s * hq + b * sk * hkv) * (d + dv) * el,
            2 * (d + dv) * pairs * b * hq)


def flash_bwd_work(b: int, s: int, hq: int, hkv: int, d: int, el: int,
                   dv: int | None = None, *, sk: int | None = None,
                   causal: bool = True, window: int = 0, valid_len: int = 0
                   ) -> tuple[int, int]:
    """(bytes, operations) of attention's backward, the shapes as in
    :func:`flash_work`: q, k, v, out and the output's cotangent read, dq,
    dk and dv written once, the lse (f32 [B, Hq, S]) read; five products
    over the (row, col) pairs the masks leave: q·kᵀ and do·vᵀ recomputed,
    dv = pᵀ·do, dk = dsᵀ·q and dq = ds·k, 3 at D and 2 at Dv, so
    2 (3 D + 2 Dv) operations a pair (a kernel that recomputes the first
    two for a pass of its own does more)."""
    dv = d if dv is None else dv
    sk = s if sk is None else sk
    pairs = attention_pairs(s, sk, causal=causal, window=window,
                            valid_len=valid_len)
    return (2 * (b * s * hq + b * sk * hkv) * (d + dv) * el
            + 4 * b * hq * s, 2 * (3 * d + 2 * dv) * pairs * b * hq)


def slstm_work(b: int, s: int, h: int, du: int, r_el: int, out_el: int
               ) -> tuple[int, int]:
    """(bytes, operations) of the sLSTM recurrence: pre [4, B, S, d] f32
    and R [4, H, du, du] read once, h [B, S, d] and the four [B, d] f32
    states written once; per step and row the four gates' block-diagonal
    products, 2 · 4 H du² operations (the cell's ~20 a unit are left
    out)."""
    d = h * du
    return (16 * b * s * d + 4 * h * du * du * r_el + b * s * d * out_el
            + 16 * b * d, 2 * b * s * 4 * h * du * du)


def _tiles(s: int, chunk: int, dense: bool) -> tuple[int, int, int]:
    """(chunks, query-key pairs of a chunk's tile, its steps): the causal
    triangle, or the whole tile with ``dense``."""
    tri = chunk * chunk if dense else chunk * (chunk + 1) // 2
    return -(-s // chunk), tri, chunk


def ssm_work(b: int, s: int, h: int, p: int, n: int, chunk: int, *,
             dense: bool = False) -> tuple[int, int]:
    """(bytes, operations) of the f32 chunked scan: C·Bᵀ on the causal
    triangle once per batch row and chunk (the heads share it), and per
    head and chunk its product with dt·x, C·H and the state update's
    (dt·x)ᵀ(B∘decay); xdt, loga, B, C read, y and the state written."""
    nc, tri, q = _tiles(s, chunk, dense)
    ops = (b * h * nc * (2 * tri * p + 2 * 2 * q * p * n)
           + b * nc * 2 * tri * n)
    return 4 * (2 * b * s * h * p + b * s * h + 2 * b * s * n
                + b * h * p * n), ops


def ssm_bwd_work(b: int, s: int, h: int, p: int, n: int, chunk: int, *,
                 dense: bool = False) -> tuple[int, int]:
    """(bytes, operations) of the chunked scan's backward: xdt, dy, loga,
    B, C and the final state's cotangent read, dxdt, dloga, dB and dC
    written; C·Bᵀ on the causal triangle once per batch row and chunk, and
    per head and chunk dy·xdtᵀ, the gate's products with dy, B and C on the
    triangle, and four [Q, P] × [P, N] products (the chain's
    Σ exp(csum) dy ⊗ C, dC's and dB's state terms, dxdt's)."""
    nc, tri, q = _tiles(s, chunk, dense)
    ops = (b * h * nc * (2 * tri * (2 * p + 2 * n) + 4 * 2 * q * p * n)
           + b * nc * 2 * tri * n)
    return 4 * (3 * b * s * h * p + 2 * b * s * h + 4 * b * s * n
                + b * h * p * n), ops


def slstm_bwd_work(b: int, s: int, h: int, du: int, r_el: int
                   ) -> tuple[int, int]:
    """(bytes, operations) of the sLSTM backward: the forward's eight saved
    [B, S, d] f32 planes, h's cotangent, R and the final state's four
    [B, d] cotangents read, dpre [4, B, S, d] and dR [4, H, du, du] f32
    written; per step and row the four gates' transposed block-diagonal
    products for the chain and their products into dR, 2 · 2 · 4 H du²
    operations (twice the forward's; the cell's ~40 a unit are left
    out)."""
    d = h * du
    return (4 * (8 + 1 + 4) * b * s * d + 4 * h * du * du * (r_el + 4)
            + 16 * b * d, 2 * 2 * b * s * 4 * h * du * du)


def ssm_cb_work(b: int, s: int, n: int, chunk: int) -> tuple[int, int]:
    """(bytes, operations) of ``ssd_cb`` alone: B and C read, the [Q, Q]
    tile of each batch row and chunk written, C·Bᵀ on the causal
    triangle."""
    nc, tri = -(-s // chunk), chunk * (chunk + 1) // 2
    return 4 * (2 * b * s * n + b * nc * chunk * chunk), b * nc * 2 * tri * n
