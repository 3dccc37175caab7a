"""The port's SSD scan (plain versions on the CPU) against the JAX package:
the Pallas kernel in interpret mode, ``mamba2.ssd_chunked`` and the
sequential oracle; its backward (the plain ``ssd_scan_chunked_bwd_ref`` and
``SSDScan``) against ``jax.vjp`` of ``mamba2.ssd_chunked``.  Inputs come
from numpy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan.kernel import ssd_scan_kernel as r_scan_kernel
from repro.kernels.ssm_scan.ops import ssd_chunked_kernel as r_ssd_kernel
from repro.kernels.ssm_scan.ref import ssd_scan_ref as r_scan_ref
from repro.models import mamba2 as r_m2

from repro_torch.kernels.ssm_scan.kernel import head_group
from repro_torch.kernels.ssm_scan.ops import ssd_chunked_kernel
from repro_torch.kernels.ssm_scan.ref import (ssd_inputs,
                                              ssd_scan_chunked_bwd_ref,
                                              ssd_scan_chunked_ref,
                                              ssd_scan_ref)
from repro_torch.models import mamba2 as p_m2

# the reference's SSD_CASES (tests/test_kernels.py): (B, S, H, P, N, chunk)
SSD_CASES = [(1, 64, 2, 8, 8, 16), (2, 100, 3, 16, 4, 32),
             (1, 33, 1, 4, 32, 8)]


def ssd_inputs_np(seed, b, s, h, p, n):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, s, h, p)) * 0.5).astype(np.float32)
    dt = np.logaddexp(rng.normal(size=(b, s, h)) * 0.5, 0).astype(np.float32)
    bb = (rng.normal(size=(b, s, n)) * 0.5).astype(np.float32)
    cc = (rng.normal(size=(b, s, n)) * 0.5).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 8.0, h)).astype(np.float32)
    d_skip = np.linspace(0.5, 1.5, h).astype(np.float32)
    return x, dt, a_log, bb, cc, d_skip


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_CASES)
def test_plain_ssd_matches_pallas_and_model(b, s, h, p, n, chunk):
    args = ssd_inputs_np(b * s, b, s, h, p, n)
    y, st = ssd_chunked_kernel(*map(torch.as_tensor, args), chunk=chunk)
    jargs = list(map(jnp.asarray, args))
    for y_r, st_r in (r_ssd_kernel(*jargs, chunk=chunk),
                      r_m2.ssd_chunked(*jargs, chunk=chunk)):
        # f32 in another order: the JAX package's 2e-4
        np.testing.assert_allclose(y.numpy(), np.asarray(y_r), rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(st.numpy(), np.asarray(st_r), rtol=2e-4,
                                   atol=2e-4)


def test_sequential_ref_matches_pallas_and_chunked():
    """As tests/test_kernels.py: the Pallas kernel ≡ the sequential oracle
    (1e-4); and the port's chunked form ≡ its sequential oracle."""
    rng = np.random.default_rng(5)
    bh, nc, q, p, n, h = 4, 3, 8, 4, 6, 2
    xdt = rng.normal(size=(bh, nc, q, p)).astype(np.float32)
    loga = -np.abs(rng.normal(size=(bh, nc, q, 1))).astype(np.float32) * 0.1
    b = rng.normal(size=(bh // h, nc, q, n)).astype(np.float32)
    c = rng.normal(size=(bh // h, nc, q, n)).astype(np.float32)
    y_p, st_p = ssd_scan_ref(xdt, loga, b, c, n_heads_per_batch=h)
    y_k, st_k = jax.jit(lambda *a: r_scan_kernel(
        *a, n_heads_per_batch=h))(*map(jnp.asarray, (xdt, loga, b, c)))
    y_r, st_r = r_scan_ref(xdt, loga, b, c, n_heads_per_batch=h)
    for y_o, st_o in ((y_k, st_k), (y_r, st_r)):
        np.testing.assert_allclose(y_p.numpy(), np.asarray(y_o), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(st_p.numpy(), np.asarray(st_o),
                                   rtol=1e-4, atol=1e-4)
    # the same scan in the model layout [B, S, H, P] through the chunked form
    bsz = bh // h
    to_model = torch.as_tensor(xdt).reshape(bsz, h, nc * q, p).transpose(1, 2)
    y_c, st_c = ssd_scan_chunked_ref(
        to_model.contiguous(),
        torch.as_tensor(loga).reshape(bsz, h, nc * q).transpose(1, 2),
        torch.as_tensor(b).reshape(bsz, nc * q, n),
        torch.as_tensor(c).reshape(bsz, nc * q, n), chunk=q)
    np.testing.assert_allclose(
        y_c.transpose(1, 2).reshape(bh, nc, q, p).numpy(), y_p.numpy(),
        rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(st_c.reshape(bh, p, n).numpy(), st_p.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_ssd_step_matches_reference_and_continues_the_scan():
    x, dt, a_log, bb, cc, d_skip = ssd_inputs_np(9, 2, 5, 3, 4, 6)
    st0 = np.random.default_rng(1).normal(size=(2, 3, 4, 6)).astype(
        np.float32)
    args = (st0, x[:, 0], dt[:, 0], a_log, bb[:, 0], cc[:, 0], d_skip)
    y, st = p_m2.ssd_step(*map(torch.as_tensor, args))
    y_r, st_r = r_m2.ssd_step(*map(jnp.asarray, args))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_r), rtol=1e-6,
                               atol=1e-6)
    # S steps of ssd_step from zero ≡ the chunked scan over S
    state = torch.zeros(2, 3, 4, 6)
    ys = []
    t = list(map(torch.as_tensor, (x, dt, a_log, bb, cc, d_skip)))
    for i in range(5):
        yi, state = p_m2.ssd_step(state, t[0][:, i], t[1][:, i], t[2],
                                  t[3][:, i], t[4][:, i], t[5])
        ys.append(yi)
    y_c, st_c = ssd_chunked_kernel(*t, chunk=2)
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), y_c.numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(state.numpy(), st_c.numpy(), rtol=1e-5,
                               atol=1e-5)


def four_phase_scan(xdt, loga, b, c, chunk):
    """The CUDA kernels' decomposition written out in torch: C·Bᵀ once per
    batch row and chunk (``ssd_cb``); per (batch, head, chunk) on its own
    the intra-chunk output and the chunk's state contribution S; the only
    sequential part H_c = exp(total_c)·H_{c-1} + S_c; then y += (C∘exp(csum))
    · H_{c-1} (``ssd_chunk``).  Ragged tails load as dt = 0 steps."""
    bsz, s, h, p = xdt.shape
    n = b.shape[-1]
    q = min(chunk, s)
    nc = -(-s // q)
    pad = nc * q - s
    xdt = torch.nn.functional.pad(xdt, (0, 0, 0, 0, 0, pad))
    loga = torch.nn.functional.pad(loga, (0, 0, 0, pad))
    b, c = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (b, c))
    xc = xdt.reshape(bsz, nc, q, h, p)
    bc, cc = b.reshape(bsz, nc, q, n), c.reshape(bsz, nc, q, n)
    csum = torch.cumsum(loga.reshape(bsz, nc, q, h), dim=2)   # [B,nc,Q,H]
    total = csum[:, :, -1]                                     # [B,nc,H]
    cb = torch.einsum("bctn,bcsn->bcts", cc, bc)               # phase 1
    causal = torch.tril(torch.ones(q, q, dtype=torch.bool))
    rel = csum[:, :, :, None, :] - csum[:, :, None, :, :]      # [B,nc,t,s,H]
    gate = torch.where(causal[None, None, :, :, None], torch.exp(rel), 0.0)
    y = torch.einsum("bcts,bctsh,bcshp->bcthp", cb, gate, xc)  # phase 2
    dout = torch.exp(total[:, :, None] - csum)                 # [B,nc,Q,H]
    s_c = torch.einsum("bcsh,bcsn,bcshp->bchpn", dout, bc, xc)
    hs, state = [], xdt.new_zeros((bsz, h, p, n))              # phase 3
    for i in range(nc):
        hs.append(state)
        state = torch.exp(total[:, i])[..., None, None] * state + s_c[:, i]
    h_prev = torch.stack(hs, dim=1)                            # [B,nc,H,P,N]
    ce = cc[:, :, :, None, :] * torch.exp(csum)[..., None]     # phase 4
    y = y + torch.einsum("bcthn,bchpn->bcthp", ce, h_prev)
    return y.reshape(bsz, nc * q, h, p)[:, :s], state


@pytest.mark.parametrize("b,s,h,p,n,chunk",
                         SSD_CASES + [(2, 300, 4, 8, 16, 128)])
def test_four_phase_scan_matches_chunked_ref(b, s, h, p, n, chunk):
    """The kernels' four phases equal the chunked form within the JAX
    package's 2e-4, ragged tails and chunks under 128 included."""
    x, dt, a_log, bb, cc, _ = ssd_inputs_np(b + s, b, s, h, p, n)
    xdt, loga = ssd_inputs(*map(torch.as_tensor, (x, dt, a_log)))
    args = (xdt, loga, torch.as_tensor(bb), torch.as_tensor(cc), chunk)
    for got, want in zip(four_phase_scan(*args), ssd_scan_chunked_ref(*args)):
        torch.testing.assert_close(got, want, rtol=2e-4,
                                   atol=2e-4 * want.abs().max().item())


def test_ssd_inputs_are_the_references_decay_and_weighted_input():
    x, dt, a_log, *_ = ssd_inputs_np(2, 1, 6, 2, 3, 4)
    xdt, loga = ssd_inputs(*map(torch.as_tensor, (x, dt, a_log)))
    np.testing.assert_allclose(xdt.numpy(), x * dt[..., None], rtol=1e-6)
    np.testing.assert_allclose(loga.numpy(), -np.exp(a_log) * dt, rtol=1e-6)


# (B, S, H, P, N, chunk) of the backward: one chunk (H 1, N != P), several
# chunks, ragged tails (N != P; H 1), zamba2-reduced's P 64 and N 16 over a
# ragged third chunk, a chunk longer than the sequence, and a short ragged
# run of several heads
SSD_BWD_CASES = [(1, 16, 1, 4, 8, 16), (2, 64, 2, 8, 8, 16),
                 (2, 100, 3, 16, 4, 32), (1, 33, 1, 4, 32, 8),
                 (2, 20, 4, 64, 16, 8), (1, 40, 2, 8, 8, 128),
                 (3, 7, 2, 4, 4, 3)]
# f32 sums in other orders, each gradient within SSD_BWD_TOL of its largest
# magnitude (measured <= 7.1e-6, on dA_log, which sums every step's decay
# term; <= 7.6e-7 elsewhere)
SSD_BWD_TOL = 5e-5


def ssd_bwd_inputs(seed, b, s, h, p, n, *, rate=0.25):
    """ssd_inputs_np with dt scaled by ``rate``: a chunk's decay stays
    below e^88, where the reference's gradient is finite (see
    test_ssd_backward_stays_finite_where_the_reference_overflows)."""
    x, dt, a_log, bb, cc, d_skip = ssd_inputs_np(seed, b, s, h, p, n)
    rng = np.random.default_rng(seed + 1)
    dy = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dst = rng.normal(size=(b, h, p, n)).astype(np.float32)
    return (x, (dt * rate).astype(np.float32), a_log, bb, cc, d_skip), (dy,
                                                                        dst)


def reference_vjp(args, cots, chunk):
    """jax.vjp of the reference's ssd_chunked: the gradients of x, dt,
    A_log, b, c and D."""
    _, vjp = jax.vjp(lambda *a: r_m2.ssd_chunked(*a, chunk=chunk),
                     *map(jnp.asarray, args))
    return [np.asarray(g) for g in vjp(tuple(map(jnp.asarray, cots)))]


def port_grads(args, cots, chunk, how):
    """The port's gradients of x, dt, A_log, b, c and D: through
    ``SSDScan`` under autograd (``ssd_chunked_kernel``), or the plain
    backward's (dxdt, dloga, db, dc) carried through ``ssd_inputs`` and
    the D term by autograd."""
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    dy, dst = map(torch.as_tensor, cots)
    if how == "function":
        y, st = ssd_chunked_kernel(*leaves, chunk=chunk)
        assert type(y.grad_fn).__name__ != "NoneType"
        torch.autograd.backward([y, st], [dy, dst])
    else:
        x, dt, a_log, b, c, d_skip = leaves
        xdt, loga = ssd_inputs(x, dt, a_log)
        grads = ssd_scan_chunked_bwd_ref(xdt.detach(), loga.detach(),
                                         b.detach(), c.detach(), chunk, dy,
                                         dst)
        skip = d_skip[None, None, :, None] * x
        torch.autograd.backward([xdt, loga, b, c, skip], [*grads, dy])
    return [t.grad.numpy() for t in leaves]


@pytest.mark.parametrize("how", ["plain", "function"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_BWD_CASES)
def test_ssd_backward_matches_jax_vjp(b, s, h, p, n, chunk, how):
    """``ssd_scan_chunked_bwd_ref`` and ``SSDScan`` (the CPU runs its plain
    versions) against jax.vjp of ``repro.models.mamba2.ssd_chunked``, with
    random cotangents on y and on the final state."""
    args, cots = ssd_bwd_inputs(b + s + h, b, s, h, p, n)
    want = reference_vjp(args, cots, chunk)
    for name, got, w in zip(("x", "dt", "A_log", "b", "c", "D"),
                            port_grads(args, cots, chunk, how), want):
        assert np.isfinite(w).all()
        np.testing.assert_allclose(got, w, rtol=0,
                                   atol=SSD_BWD_TOL * np.abs(w).max(),
                                   err_msg=name)


def test_ssd_backward_stays_finite_where_the_reference_overflows():
    """At dt ~ 0.7 and A up to 8 a 32-step chunk decays by more than e^88:
    the reference's masked ``exp(csum_t - csum_s)`` (s > t) overflows and
    its gradient through ``where`` is 0 · inf = NaN.  The port's backward,
    written out, forms the decay for s <= t only: finite, and equal to the
    reference's at chunk 4 (the gradients do not depend on the chunking)."""
    args, cots = ssd_bwd_inputs(11, 2, 64, 2, 8, 8, rate=1.0)
    assert not all(np.isfinite(g).all() for g in reference_vjp(args, cots,
                                                               32))
    want = reference_vjp(args, cots, 4)
    # chunks of 32 and of 4 group the decay terms differently: measured
    # 1.2e-4 of dA_log's largest magnitude, <= 4.3e-7 elsewhere
    for how in ("plain", "function"):
        for got, w in zip(port_grads(args, cots, 32, how), want):
            np.testing.assert_allclose(got, w, rtol=0,
                                       atol=1e-3 * np.abs(w).max())


def test_ssd_scan_saves_nothing_without_grad():
    """Frozen inputs, or no_grad, take the plain scan with no graph; an
    input that needs a gradient goes through ``SSDScan``, whose backward
    takes a cotangent on y alone (the final state unused) or on the state
    alone."""
    args, (dy, dst) = ssd_bwd_inputs(3, 1, 12, 2, 4, 4)
    t = list(map(torch.as_tensor, args))
    y, st = ssd_chunked_kernel(*t, chunk=4)
    assert y.grad_fn is None and st.grad_fn is None
    t[0].requires_grad_()
    with torch.no_grad():
        assert ssd_chunked_kernel(*t, chunk=4)[0].grad_fn is None
    for cot in ("y", "state"):
        x = t[0].detach().requires_grad_()
        y, st = ssd_chunked_kernel(x, *t[1:], chunk=4)
        assert type(st.grad_fn).__name__ == "SSDScanBackward"
        (y if cot == "y" else st).backward(torch.as_tensor(
            dy if cot == "y" else dst))
        assert torch.isfinite(x.grad).all() and x.grad.abs().sum() > 0


# the card's backward kernels are held to their plain versions within
# SCAN_BWD_TOL of each gradient's scale (chip_smoke.py)
SCAN_BWD_TOL = 1e-4


def tf32(x, rounded=True):
    """``x`` (f32) at TF32's 10 mantissa bits: rounded to nearest, ties
    away from zero (``cvt.rna.tf32.f32``), or with the low 13 bits dropped,
    as the tensor cores read an f32 register given as TF32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000 if rounded else bits) & -0x2000).view(
        torch.float32)


def split_tf32_einsum(terms):
    """``torch.einsum`` on f32 operands as ``ssd_bwd_chunk`` forms its
    products on the tensor cores: each operand split into a TF32 high part
    (rounded) and the remainder (read as TF32: truncated), the product of
    the high parts plus, with ``terms`` 3, each product with one remainder
    in place of its high part (hi·hi + hi·lo + lo·hi for two operands),
    summed in f32."""
    plain = torch.einsum

    def einsum(eq, *ops):
        his = [tf32(o) for o in ops]
        out = plain(eq, *his)
        if terms == 3:
            los = [tf32(o - hi, rounded=False) for o, hi in zip(ops, his)]
            for i in range(len(ops)):
                out = out + plain(eq, *his[:i], los[i], *his[i + 1:])
        return out

    return einsum


@pytest.mark.parametrize("b,s,h,p,n,chunk", [(2, 40, 3, 16, 8, 16),
                                             (1, 128, 2, 64, 64, 128)])
def test_split_tf32_keeps_the_backward_at_f32_accuracy(b, s, h, p, n, chunk,
                                                       monkeypatch):
    """Every product of ``ssd_scan_chunked_bwd_ref`` in split TF32 (the
    card's ``ssd_bwd_chunk`` design, emulated on the CPU) against autograd
    of the plain scan in f64: the three-term split within SCAN_BWD_TOL of
    each gradient's scale, single TF32 (hi·hi alone) at least 10x further
    off."""
    args, (dy, dst) = ssd_bwd_inputs(b * s + p, b, s, h, p, n)
    x, dt, a_log, bb, cc, _ = map(torch.as_tensor, args)
    xdt, loga = ssd_inputs(x, dt, a_log)
    dy, dst = torch.as_tensor(dy), torch.as_tensor(dst)
    leaves = [t.double().requires_grad_() for t in (xdt, loga, bb, cc)]
    torch.autograd.backward(ssd_scan_chunked_ref(*leaves, chunk),
                            [dy.double(), dst.double()])
    want = [t.grad for t in leaves]
    errs = {}
    for terms in (3, 1):
        monkeypatch.setattr(torch, "einsum", split_tf32_einsum(terms))
        got = ssd_scan_chunked_bwd_ref(xdt, loga, bb, cc, chunk, dy, dst)
        monkeypatch.undo()
        errs[terms] = {}
        for name, g, w in zip(("dxdt", "dloga", "db", "dc"), got, want):
            # dloga: at least 1e-2 of max |xdt| · max |dxdt|, the terms it
            # sums (they cancel to 0 at one step)
            scale = w.abs().max().item()
            if name == "dloga":
                scale = max(scale, 1e-2 * xdt.abs().max().item()
                            * want[0].abs().max().item())
            errs[terms][name] = (g.double() - w).abs().max().item() / scale
    print(f"split TF32 {(b, s, h, p, n, chunk)}: 3 terms {errs[3]}, "
          f"1 term {errs[1]}")
    assert max(errs[3].values()) <= SCAN_BWD_TOL
    assert max(errs[1].values()) >= 10 * max(errs[3].values())


# (B, nc, H, SMs) → heads a block of ssd_bwd_chunk takes: zamba2's training
# shapes on 132 SMs (every group leaves 4 or 32 heads on the busiest SM:
# the largest, 4, taken), fewer heads than a group, and a small card
HEAD_GROUP_CASES = [(8, 1, 64, 132, 4), (4, 16, 64, 132, 4),
                    (1, 1, 3, 132, 1), (2, 4, 3, 132, 1),
                    (1, 4, 8, 16, 2), (3, 2, 64, 2, 4)]


@pytest.mark.parametrize("b,nc,h,sms,want", HEAD_GROUP_CASES)
def test_head_group_leaves_the_fewest_heads_on_the_busiest_sm(b, nc, h, sms,
                                                              want):
    assert head_group(b, nc, h, sms) == want


def test_scan_bwd_bench_bounds_and_refusal():
    """``bench.scan_bwd``'s bounds at zamba2's B 4, S 2048: the f32 rate
    over ``ssm_bwd_work``'s operations, three TF32 products at the TF32
    rate; the bench refuses the CPU (it times CUDA kernels), and
    ``bench.scan_train`` a machine without a card."""
    from repro_torch.bench import scan_bwd
    from repro_torch.kernels.work import ssm_bwd_work
    _, ops = ssm_bwd_work(4, 2048, 64, 64, 64, 128)
    got = scan_bwd.ssm_bounds(4, 2048)
    assert got["bound_f32"] == (pytest.approx(ops / 67e12 * 1e3),
                                "operations")
    assert got["bound_3xtf32"] == (pytest.approx(3 * ops / 495e12 * 1e3),
                                   "operations")
    with pytest.raises(RuntimeError, match="card"):
        scan_bwd.main("cpu")
    if not torch.cuda.is_available():
        from repro_torch.bench import scan_train
        with pytest.raises(RuntimeError, match="card"):
            scan_train.main()
