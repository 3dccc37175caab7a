"""The kernels' operation counts (``repro_torch.kernels.work``), which the
dry-run's FLOPs, the kernel bench's bounds and ``chip_smoke.py`` read,
held against ``FlopCounterMode`` of each kernel's plain version, which
forms the same products in ATen:

  * flash attention: ``attention_ref`` with no mask counts every (query,
    key) pair; with masks the formula counts the pairs the masks leave;
  * the SSD scan's forward: ``ssd_scan_chunked_ref`` forms each chunk's
    tiles whole, ``ssm_work(dense=True)``;
  * the sLSTM recurrence: ``slstm_scan_ref`` exactly; ``slstm_scan_bwd_ref``
    recomputes the forward's products (it keeps no states) and then forms
    the backward's, so it counts ``slstm_work`` + ``slstm_bwd_work``.

The SSD scan's backward is not held here: its plain version contracts
three-operand einsums in an order torch picks per shape, and recomputes
the chunk states the kernel saves, so its count is not the kernel's
``ssm_bwd_work`` by any fixed relation.
"""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import work
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.slstm_scan.ref import (slstm_scan_bwd_ref,
                                                slstm_scan_ref)
from repro_torch.kernels.ssm_scan.ref import ssd_scan_chunked_ref


def counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def randn(*shape, seed=0):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,dv", [
    (2, 4, 2, 8, 12, 16, 8), (1, 6, 6, 16, 16, 32, 32),
    (3, 8, 1, 5, 9, 16, 16)])
def test_flash_work_is_the_plain_attention_count(b, hq, hkv, sq, sk, d, dv):
    q, k, v = (randn(b, hq, sq, d), randn(b, hkv, sk, d, seed=1),
               randn(b, hkv, sk, dv, seed=2))
    got = counted(lambda: attention_ref(q, k, v, causal=False))
    assert got == work.flash_work(b, sq, hq, hkv, d, 1, dv, sk=sk,
                                  causal=False)[1]


@pytest.mark.parametrize("sq,sk,causal,window,valid", [
    (8, 8, True, 0, 0), (8, 12, True, 0, 0), (9, 9, True, 3, 0),
    (6, 11, False, 0, 8), (16, 16, True, 4, 12)])
def test_flash_work_counts_the_masked_pairs(sq, sk, causal, window, valid):
    """The formula is the unmasked count of the plain version times the
    share of pairs the masks leave, and the kernel's custom op is counted
    by it."""
    b, hq, hkv, d, dv = 2, 4, 2, 16, 8
    row, col = torch.arange(sq)[:, None], torch.arange(sk)[None, :]
    live = (col < (valid or sk)).expand(sq, sk)
    if causal:
        live = live & (col <= row)
    if window:
        live = live & (row - col < window)
    q, k, v = (randn(b, sq, hq, d), randn(b, sk, hkv, d, seed=1),
               randn(b, sk, hkv, dv, seed=2))
    dense = counted(lambda: attention_ref(q.transpose(1, 2),
                                          k.transpose(1, 2),
                                          v.transpose(1, 2), causal=False))
    want = work.flash_work(b, sq, hq, hkv, d, 1, dv, sk=sk, causal=causal,
                           window=window, valid_len=valid)[1]
    assert want * sq * sk == dense * int(live.sum())
    assert counted(lambda: flash_attention(
        q, k, v, causal=causal, window=window, valid_len=valid)) == want


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 10, 4, 8, 16, 4), (1, 16, 2, 4, 8, 8), (2, 7, 3, 4, 4, 4)])
def test_ssm_work_is_the_plain_chunked_scan_count(b, s, h, p, n, chunk):
    xdt, loga = randn(b, s, h, p), -randn(b, s, h, seed=1).abs()
    bb, cc = randn(b, s, n, seed=2), randn(b, s, n, seed=3)
    got = counted(lambda: ssd_scan_chunked_ref(xdt, loga, bb, cc, chunk))
    assert got == work.ssm_work(b, s, h, p, n, chunk, dense=True)[1]
    # the kernel forms the causal triangle of each tile, not the whole
    assert work.ssm_work(b, s, h, p, n, chunk)[1] < got


@pytest.mark.parametrize("b,s,h,du", [(2, 5, 2, 8), (1, 3, 4, 4),
                                      (3, 4, 1, 16)])
def test_slstm_work_is_the_plain_step_loop_count(b, s, h, du):
    pre, r = randn(4, b, s, h * du), 0.1 * randn(4, h, du, du, seed=1)
    fwd = work.slstm_work(b, s, h, du, 4, 4)[1]
    assert counted(lambda: slstm_scan_ref(pre, r)) == fwd
    h_cot = randn(b, s, h * du, seed=2)
    got = counted(lambda: slstm_scan_bwd_ref(pre, r, h_cot,
                                             (None, None, None, None)))
    assert got == fwd + work.slstm_bwd_work(b, s, h, du, 4)[1]
