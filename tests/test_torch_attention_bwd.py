"""Flash attention's backward as the port dispatches it, on the CPU:

- the custom op ``repro_torch::flash_attention_bwd`` (schema, fake
  implementation, ``torch.library.opcheck``), equal bit for bit to the
  plain backward ``ref.attention_bwd_ref`` on CPU tensors, and
  ``FlashAttention``'s backward going through it (once, and nothing else);
- its FLOP formula ``kernels.work.flash_bwd_work``: what ``FlopCounterMode``
  counts for a backward, once and not the plain version's einsums, and
  what the dry-run's meta-tensor train step counts;
- the bf16 tolerance ``ref.bwd_bf16_tolerance`` that the card's tensor-core
  route is held to (``chip_smoke.py``, ``tests/test_torch_cuda.py``):
  the kernel's rounding points emulated in plain torch (``rounding=``: p
  and ds rounded to bf16 as the operands of their products, f32 sums)
  stay inside it, and the faults it must catch (a dropped mask, delta left
  out, a wrong scale) land far outside it.

The plain backward against ``jax.vjp`` of the reference is in
``tests/test_torch_train.py`` (``BWD_CASES``).
"""
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import reduced_config
from repro_torch.configs.base import InputShape
from repro_torch.distributed.context import AbstractMesh
from repro_torch.kernels import work
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.launch import dryrun
from repro_torch.launch.steps import assemble
from repro_torch.models import attention as p_attn

BF16 = torch.bfloat16
# (B, Sq, Sk, Hq, Hkv, D, Dv, causal, window, valid_len): GQA, a cross
# case with a ragged Sk, MLA's narrower v, a window with valid_len that
# leaves dead rows, a group of 8 at D 256, starcoder2's group of 9
CASES = [(2, 40, 40, 4, 2, 32, 32, True, 0, 0),
         (2, 24, 75, 6, 6, 64, 64, False, 0, 0),
         (1, 48, 48, 4, 4, 96, 64, True, 0, 0),
         (1, 64, 64, 4, 2, 32, 32, True, 4, 20),
         (1, 48, 48, 8, 1, 256, 256, True, 0, 0),
         (1, 33, 33, 18, 2, 64, 64, True, 0, 0)]


def _inputs(b, sq, sk, hq, hkv, d, dv, causal, window, valid_len, *,
            dtype=torch.float32, seed=0):
    """q, k, v, do from a seed in ``dtype``, and the forward's out and lse
    from the plain forward on them."""
    g = torch.Generator().manual_seed(seed + sq + sk + d)
    q, k, v, do = (torch.randn(s, generator=g).to(dtype) for s in (
        (b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, dv), (b, sq, hq, dv)))
    out, lse = fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                      valid_len=valid_len, return_lse=True)
    return q, k, v, out, lse, do


def _kw(causal, window, valid_len):
    return dict(causal=causal, window=window, valid_len=valid_len)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("case", [CASES[0], CASES[1], CASES[3]])
def test_backward_op_passes_opcheck(case, dtype):
    """Schema, fake implementation and autograd registration of the op on
    CPU tensors (``torch.library.opcheck``)."""
    *shape, causal, window, valid_len = case
    args = _inputs(*shape, causal, window, valid_len, dtype=dtype)
    torch.library.opcheck(torch.ops.repro_torch.flash_attention_bwd.default,
                          (*args, causal, window, None, valid_len))


@pytest.mark.parametrize("case", CASES)
def test_backward_op_on_cpu_is_the_plain_backward(case):
    """The op on CPU tensors returns the plain backward's bits, in the
    dtypes and shapes of q, k and v, whatever the scale argument's type."""
    *shape, causal, window, valid_len = case
    args = _inputs(*shape, causal, window, valid_len)
    kw = _kw(causal, window, valid_len)
    got = fa_ops.flash_attention_bwd(*args, **kw, scale=shape[5] ** -0.5)
    want = fa_ref.attention_bwd_ref(*args, **kw)
    for g, w, t in zip(got, want, args[:3]):
        assert g.shape == t.shape and g.dtype == t.dtype
        assert torch.equal(g, w)
    assert p_attn.flash_attention_bwd is fa_ref.attention_bwd_ref


class _OpLog(TorchDispatchMode):
    """The ops dispatched while it is on, by name."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("case", [CASES[0], CASES[3], CASES[5]])
def test_flash_attention_backward_goes_through_the_op(case):
    """``FlashAttention``'s backward is one call of the op and no product
    of its own: the gradients equal the op's on the saved tensors."""
    *shape, causal, window, valid_len = case
    q, k, v, out, lse, do = _inputs(*shape, causal, window, valid_len)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = p_attn.chunked_attention(*leaves, causal=causal, window=window,
                                 valid_len=valid_len)
    assert torch.equal(o.detach(), out)
    with _OpLog() as log:
        o.backward(do)
    bwd = [n for n in log.names if n.startswith("repro_torch.")]
    assert bwd == ["repro_torch.flash_attention_bwd"]
    assert not {"aten.mm", "aten.bmm", "aten.einsum"} & set(log.names)
    want = fa_ref.attention_bwd_ref(q, k, v, out, lse, do,
                                    **_kw(causal, window, valid_len))
    for t, w in zip(leaves, want):
        assert torch.equal(t.grad, w)


@pytest.mark.parametrize("case", CASES)
def test_flop_counter_counts_the_backward_op_once(case):
    """``FlopCounterMode`` over a CPU backward counts ``flash_bwd_work``'s
    operations, on the op, and nothing of the plain version's einsums."""
    b, sq, sk, hq, hkv, d, dv, causal, window, valid_len = case
    q, k, v, *_ = _inputs(b, sq, sk, hq, hkv, d, dv, causal, window,
                          valid_len)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = p_attn.chunked_attention(*leaves, causal=causal, window=window,
                                 valid_len=valid_len)
    with FlopCounterMode(display=False) as fc:
        o.backward(torch.ones_like(o))
    want = work.flash_bwd_work(b, sq, hq, hkv, d, 1, dv, sk=sk,
                               causal=causal, window=window,
                               valid_len=valid_len)[1]
    assert dryrun.kernel_flops(fc) == {"flash_attention_bwd": want}
    assert fc.get_total_flops() == want


def test_flash_bwd_work_counts_five_products_of_the_live_pairs():
    """2 (3 D + 2 Dv) operations a live pair; q, out, do, dq, k, v, dk,
    dv once and the lse."""
    b, s, hq, hkv, d, dv = 2, 10, 4, 2, 16, 8
    pairs = work.attention_pairs(s, s, causal=True)
    nbytes, ops = work.flash_bwd_work(b, s, hq, hkv, d, 2, dv)
    assert ops == 2 * (3 * d + 2 * dv) * pairs * b * hq
    assert nbytes == (b * s * hq * (2 * d + 2 * dv) + b * s * hkv * 2
                      * (d + dv)) * 2 + 4 * b * hq * s
    fwd_bytes, fwd_ops = work.flash_work(b, s, hq, hkv, d, 2, dv)
    assert nbytes == 2 * fwd_bytes + 4 * b * hq * s
    assert ops * (d + dv) == fwd_ops * (3 * d + 2 * dv)


def test_dryrun_train_step_counts_the_backward_op():
    """The dry-run's train step on meta tensors (reduced qwen3-1.7b, one
    rank) runs the backward op's fake implementation once a layer, and
    counts it by its formula."""
    cfg = reduced_config("qwen3-1.7b")
    shape = InputShape("t", 32, 2, "train")
    step = assemble(cfg, shape, AbstractMesh((1, 1), ("data", "model")),
                    auto_knobs=False)
    costs = dryrun.step_costs(step, shape)
    kernels = costs["kernel_flops"]
    want = cfg.num_layers * work.flash_bwd_work(
        2, 32, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, 1)[1]
    assert kernels["flash_attention_bwd"] == want
    assert kernels["flash_attention_lse"] > 0


# -- the bf16 tolerance -------------------------------------------------


def _over(got, want, tol):
    """The largest error of each gradient over its tolerance."""
    return [((g.float() - w).abs() / t).max().item()
            for g, w, t in zip(got, want, tol)]


# bf16 cases: the CASES, and a longer causal one (rows of up to 256 keys)
BF16_CASES = CASES + [(1, 256, 256, 4, 2, 128, 128, True, 0, 0)]


@pytest.mark.parametrize("case", BF16_CASES)
def test_bf16_emulation_stays_inside_the_tolerance(case):
    """The tensor-core route's rounding points in plain torch (p and ds in
    bf16 as product operands, f32 sums, bf16 outputs) read below 1 of
    ``bwd_bf16_tolerance`` against the f32 plain backward of the same
    bf16 inputs; the f32 backward itself reads far below."""
    *shape, causal, window, valid_len = case
    args = _inputs(*shape, causal, window, valid_len, dtype=BF16)
    kw = _kw(causal, window, valid_len)
    want, tol = fa_ref.bwd_bf16_tolerance(*args, **kw)
    emulated = fa_ref.attention_bwd_ref(*args, **kw, rounding=BF16)
    over = _over(emulated, want, tol)
    print(f"bf16 emulation {case}: err_over_tol {over}")
    assert max(over) < 1.0
    f32 = fa_ref.attention_bwd_ref(*(a.float() for a in args), **kw)
    assert max(_over(f32, want, tol)) < 0.05


def _planted(fault, args, kw, d, dv):
    """The emulated kernel with one fault: the causal mask dropped, delta
    left out (out read as 0), or the scale taken from v's head dim (MLA's
    trap: 192 against 128) or, where D = Dv, doubled."""
    q, k, v, out, lse, do = args
    if fault == "mask_dropped":
        kw = dict(kw, causal=not kw["causal"])
    elif fault == "delta_dropped":
        out = torch.zeros_like(out)
    else:
        kw = dict(kw, scale=dv ** -0.5 if dv != d else 2 * d ** -0.5)
    return fa_ref.attention_bwd_ref(q, k, v, out, lse, do, **kw,
                                    rounding=BF16)


@pytest.mark.parametrize("fault", ["mask_dropped", "delta_dropped",
                                   "scale_wrong"])
@pytest.mark.parametrize("case", [CASES[0], CASES[2], CASES[4]])
def test_bf16_tolerance_sees_planted_faults(case, fault):
    """Each fault reads far above 1 of the tolerance."""
    b, sq, sk, hq, hkv, d, dv, causal, window, valid_len = case
    args = _inputs(b, sq, sk, hq, hkv, d, dv, causal, window, valid_len,
                   dtype=BF16)
    kw = _kw(causal, window, valid_len)
    want, tol = fa_ref.bwd_bf16_tolerance(*args, **kw)
    over = max(_over(_planted(fault, args, kw, d, dv), want, tol))
    print(f"bf16 fault {fault} {case}: err_over_tol {over}")
    assert over > 10.0
