"""Wrapper of the fused CUDA decision kernel (``csrc/decide_split.cu``):
the cost of every (environment, split) pair and its row argmin, without
storing the ``[n_envs, L+1]`` cost tensor.

The caller ships the factored form: two ``[L+1]`` prefix rows (``dcum``,
``ecum``), the shipped-bytes row ``bvec`` and seven ``[E]`` environment
columns; the kernel rebuilds per split::

    dev_t  = dcum[s] / dev_div[e]
    edge_t = (etot − ecum[s]) / edge_div[e]
    xfer   = 0 at s == L, else lat[e] + ship / max(bw[e], 1)
    ship   = input_bytes[e] at s == 0, else act_bytes[s − 1]

and scores latency, energy, price, deadline slack, the queue wait and the
tail excess with the weights of the lowered cost model (the ``SPEC_*``
layout below, identical to the reference kernel's).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build

# spec vector layout: scalar parameters of the lowered cost model
SPEC_RADIO, SPEC_PPS, SPEC_PPG, SPEC_DEADLINE = range(4)
SPEC_W0, SPEC_W1, SPEC_W2, SPEC_W3, SPEC_ETOT = range(4, 9)
# queue-aware extension: predicted edge-pool wait added to every
# offloading split's latency, and the tail_latency_s objective
# (latency + tail-RTT excess on offloading splits) weighted by W4.
SPEC_WAIT, SPEC_TEXC, SPEC_W4 = range(9, 12)
SPEC_LEN = 12


def pack_spec(weights, radio_watts=0.0, price_per_edge_s=0.0,
              price_per_gb=0.0, deadline_s=np.inf, edge_total=0.0,
              queue_wait_s=0.0, tail_excess_s=0.0, tail_weight=0.0):
    """Build the [SPEC_LEN] f32 scalar vector the kernel reads
    (``edge_total`` is ``ecum[-1]``, the full edge-side prefix)."""
    out = np.zeros(SPEC_LEN, np.float32)
    out[SPEC_RADIO] = radio_watts
    out[SPEC_PPS] = price_per_edge_s
    out[SPEC_PPG] = price_per_gb
    out[SPEC_DEADLINE] = deadline_s
    out[SPEC_W0:SPEC_W0 + 4] = weights
    out[SPEC_ETOT] = edge_total
    out[SPEC_WAIT] = queue_wait_s
    out[SPEC_TEXC] = tail_excess_s
    out[SPEC_W4] = tail_weight
    return out


def _lib() -> ctypes.CDLL:
    lib = _build.load("decide_split")
    lib.decide_split.argtypes = [ctypes.c_void_p] * 11 \
        + [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3
    lib.decide_split.restype = ctypes.c_int
    return lib


def decide_split_kernel(dcum, ecum, bvec, dev_div, edge_div, bw, lat, inp,
                        dev_w, edge_w, spec):
    """``dcum``/``ecum``/``bvec`` [L+1] f32 split rows; env columns [E] f32;
    ``spec`` [SPEC_LEN] f32; all contiguous on one CUDA device.  Returns
    ``(split [E] int32, scalar cost [E] f32)``."""
    rows, cols = (dcum, ecum, bvec), (dev_div, edge_div, bw, lat, inp,
                                      dev_w, edge_w)
    tensors = (*rows, *cols, spec)
    if dcum.device.type != "cuda" or any(t.device != dcum.device
                                         for t in tensors):
        raise ValueError("decide_split_kernel needs every tensor on one "
                         "CUDA device, got "
                         f"{sorted({str(t.device) for t in tensors})}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("decide_split_kernel takes float32 tensors, got "
                        f"{sorted({str(t.dtype) for t in tensors})}")
    n_splits, n_envs = dcum.shape[0], dev_div.shape[0]
    if n_splits < 1 or any(t.shape != (n_splits,) for t in rows) \
            or any(t.shape != (n_envs,) for t in cols) \
            or spec.shape != (SPEC_LEN,):
        raise ValueError(
            f"expected [L+1] split rows (L+1 >= 1), [E] env columns and a "
            f"[{SPEC_LEN}] spec, got {[tuple(t.shape) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("decide_split_kernel needs contiguous tensors")
    split = torch.empty(n_envs, dtype=torch.int32, device=dcum.device)
    cost = torch.empty(n_envs, dtype=torch.float32, device=dcum.device)
    if n_envs == 0:                     # a grid of size 0 is a launch error
        return split, cost
    lib = _lib()
    with torch.cuda.device(dcum.device):
        rc = lib.decide_split(*(_build.ptr(t) for t in tensors), n_envs,
                              n_splits, _build.ptr(split), _build.ptr(cost),
                              _build.stream_of(dcum))
    _build.check(lib, rc, "decide_split")
    decide_split_kernel.launches += 1
    return split, cost


#: launches of the CUDA kernel since the count was last set to 0
decide_split_kernel.launches = 0
