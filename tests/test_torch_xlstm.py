"""The port's xLSTM against the reference's on the CPU, the same
numpy-seeded inputs and weights on both sides: the mLSTM cell (sequential,
chunked with and without a padded tail, one step), the sLSTM recurrence
(``kernels.slstm_scan``'s plain version, which the CPU runs, and one
step) and its backward (the plain ``slstm_scan_bwd_ref`` and
``SLSTMScan`` against ``jax.vjp``), each block and block step, and reduced
xlstm-350m in f32 end to end (forward, prefill, teacher-forced decode,
caches); prefill(S) then one decode step against prefill(S+1); the sLSTM
kernel wrappers' refusals."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as r_reduced
from repro.models import build_model as r_build
from repro.models import xlstm as r_xl
from repro.models import xlstm_model as r_model
from repro.models.layers import init_tree as r_init_tree
from repro.models.transformer import _lm_head as r_lm_head

from repro_torch.configs import reduced_config as p_reduced
from repro_torch.kernels.slstm_scan import kernel as sl_kernel
from repro_torch.kernels.slstm_scan import ops as sl_ops
from repro_torch.kernels.slstm_scan import ref as sl_ref
from repro_torch.models import build_model
from repro_torch.models import xlstm as xl
from repro_torch.models import xlstm_model
from repro_torch.models.convert import _tensor, params_from_jax

ARCH = "xlstm-350m"
CPU = torch.device("cpu")
# f32 sums in other orders, relative to max |want| (measured ~1e-6 here)
TOL = 1e-5
# the whole model: ~1e-6 of max |logit| measured
MODEL_TOL = 1e-5
MAX_LEN, PROMPT, STEPS = 32, 19, 6


def configs():
    return (r_reduced(ARCH).replace(dtype="float32"),
            p_reduced(ARCH).replace(dtype="float32"))


def tensors(tree):
    if isinstance(tree, dict):
        return {k: tensors(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tensors(v) for v in tree)
    return _tensor(np.asarray(tree), CPU)


def close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def mlstm_inputs(s, seed=0, b=2, h=3, d=8):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32)
               for _ in range(3))
    i_raw = rng.normal(size=(b, s, h)).astype(np.float32)
    f_raw = (rng.normal(size=(b, s, h)) + 2.0).astype(np.float32)
    return q, k, v, i_raw, f_raw


def both(fn_r, fn_p, *arrays, **kw):
    """The reference on jnp arrays and the port on tensors of the same
    numpy inputs."""
    return (fn_r(*map(jnp.asarray, arrays), **kw),
            fn_p(*map(torch.from_numpy, arrays), **kw))


# --------------------------------------------------------------------------
# mLSTM cell
# --------------------------------------------------------------------------
def test_mlstm_sequential_matches_reference():
    (h_r, st_r), (h_p, st_p) = both(r_xl.mlstm_sequential,
                                    xl.mlstm_sequential, *mlstm_inputs(13))
    close(h_p, h_r)
    for got, want in zip(st_p, st_r):
        close(got, want)


@pytest.mark.parametrize("s,chunk", [(32, 8), (29, 8), (5, 16)],
                         ids=["whole_chunks", "padded_tail", "one_chunk"])
def test_mlstm_chunked_matches_reference(s, chunk):
    args = mlstm_inputs(s, seed=s)
    (h_r, st_r), (h_p, st_p) = both(r_xl.mlstm_chunked, xl.mlstm_chunked,
                                    *args, chunk=chunk)
    assert h_p.shape == h_r.shape == args[0].shape
    close(h_p, h_r)
    for got, want in zip(st_p, st_r):
        close(got, want)
    # and the port's chunked form against its own sequential oracle
    h_s, st_s = xl.mlstm_sequential(*map(torch.from_numpy, args))
    close(h_p, h_s.numpy(), 1e-4)
    for got, want in zip(st_p, st_s):
        close(got, want.numpy(), 1e-4)


def test_mlstm_step_matches_reference():
    rng = np.random.default_rng(3)
    b, h, d = 2, 3, 8
    state = (rng.normal(size=(b, h, d, d)).astype(np.float32),
             rng.normal(size=(b, h, d)).astype(np.float32),
             rng.normal(size=(b, h)).astype(np.float32))
    q, k, v = (rng.normal(size=(b, h, d)).astype(np.float32)
               for _ in range(3))
    i_t, f_t = (rng.normal(size=(b, h)).astype(np.float32)
                for _ in range(2))
    st_r, h_r = r_xl.mlstm_step(tuple(map(jnp.asarray, state)),
                                *map(jnp.asarray, (q, k, v, i_t, f_t)))
    st_p, h_p = xl.mlstm_step(tuple(map(torch.from_numpy, state)),
                              *map(torch.from_numpy, (q, k, v, i_t, f_t)))
    close(h_p, h_r)
    for got, want in zip(st_p, st_r):
        close(got, want)


# --------------------------------------------------------------------------
# sLSTM cell
# --------------------------------------------------------------------------
def slstm_params(d=24, h=3, seed=4):
    rng = np.random.default_rng(seed)
    du = d // h
    out = {}
    for g in ("z", "i", "f", "o"):
        out[f"w_{g}"] = (rng.normal(size=(d, d)) / np.sqrt(d)).astype(
            np.float32)
        out[f"r_{g}"] = (rng.normal(size=(h, du, du)) / np.sqrt(du)).astype(
            np.float32)
        out[f"b_{g}"] = rng.normal(size=(d,)).astype(np.float32)
    return out


def test_block_diag_matmul_matches_reference():
    rng = np.random.default_rng(5)
    hp = rng.normal(size=(2, 24)).astype(np.float32)
    r = rng.normal(size=(3, 8, 8)).astype(np.float32)
    want, got = both(r_xl._block_diag_matmul, xl._block_diag_matmul, hp, r)
    close(got, want)


@pytest.mark.parametrize("impl", ["naive", "chunked"])
def test_slstm_scan_matches_reference(impl):
    """On the CPU both impls run the plain step loop; the recurrence over
    37 steps, its h in x's dtype and the final (c, n, h, m)."""
    p = slstm_params()
    x = np.random.default_rng(6).normal(size=(2, 37, 24)).astype(np.float32)
    h_r, st_r = r_xl.slstm_scan(jnp.asarray(x), jax.tree_util.tree_map(
        jnp.asarray, p), 3)
    h_p, st_p = xl.slstm_scan(torch.from_numpy(x), tensors(p), 3, impl=impl)
    assert h_p.dtype == torch.float32 and h_p.shape == x.shape
    close(h_p, h_r)
    assert len(st_p) == 4
    for got, want in zip(st_p, st_r):
        close(got, want)


def test_slstm_scan_op_takes_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(7)
    pre = torch.from_numpy(rng.normal(size=(4, 3, 9, 16)).astype(np.float32))
    r = torch.from_numpy(rng.normal(size=(4, 2, 8, 8)).astype(np.float32))
    sl_kernel.slstm_scan_kernel.launches = 0
    h_o, st_o = sl_ops.slstm_scan(pre, r, out_dtype=torch.bfloat16)
    h_r, st_r = sl_ref.slstm_scan_ref(pre, r, out_dtype=torch.bfloat16)
    assert h_o.dtype == torch.bfloat16 and torch.equal(h_o, h_r)
    assert all(torch.equal(a, b) for a, b in zip(st_o, st_r))
    assert sl_kernel.slstm_scan_kernel.launches == 0
    # the plain scan is the cell applied step after step
    state = (torch.zeros(3, 16),) * 4
    for t in range(9):
        state = sl_ref.slstm_cell_ref(
            state, pre[:, :, t] + sl_ref.recurrent_gates(state[2], r))
    assert all(torch.equal(a, b) for a, b in zip(state, st_r))


def test_slstm_step_matches_reference():
    p = slstm_params()
    rng = np.random.default_rng(8)
    state = tuple(rng.normal(size=(2, 24)).astype(np.float32)
                  for _ in range(4))
    x_t = rng.normal(size=(2, 24)).astype(np.float32)
    st_r, h_r = r_xl.slstm_step(tuple(map(jnp.asarray, state)),
                                jnp.asarray(x_t),
                                jax.tree_util.tree_map(jnp.asarray, p))
    st_p, h_p = xl.slstm_step(tuple(map(torch.from_numpy, state)),
                              torch.from_numpy(x_t), tensors(p))
    close(h_p, h_r)
    for got, want in zip(st_p, st_r):
        close(got, want)


# (B, S, d, H, weight scale) of the sLSTM backward: one step, H 1, several
# heads, B 1 and 4, and weights (input and recurrent) scaled ×5, where the
# stabiliser's max switches between its branches from step to step
SLSTM_BWD_CASES = [(2, 13, 24, 3, 1.0), (1, 1, 8, 2, 1.0),
                   (3, 37, 16, 1, 1.0), (2, 20, 32, 4, 1.0),
                   (4, 9, 24, 3, 5.0), (1, 25, 16, 2, 5.0),
                   (2, 30, 24, 3, 5.0)]
# f32 in other orders: each gradient within SLSTM_BWD_TOL of its largest
# magnitude (measured <= 1.8e-6 at weights ×1; at ×5 the recurrence grows
# the rounding with the steps, to 1.6e-5 over 30)
SLSTM_BWD_TOL = 1e-4


def slstm_bwd_inputs(b, s, d, h, scale):
    p = {k: v * scale if k[0] in "wr" else v
         for k, v in slstm_params(d, h, seed=b + s + d).items()}
    rng = np.random.default_rng(b * s + d)
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    h_cot = rng.normal(size=(b, s, d)).astype(np.float32)
    st_cot = tuple(rng.normal(size=(b, d)).astype(np.float32)
                   for _ in range(4))
    return p, x, h_cot, st_cot


def slstm_port_grads(p, x, h_cot, st_cot, h, how):
    """The port's gradients of x and of every weight: through
    ``SLSTMScan`` under autograd (``models.xlstm.slstm_scan``), or the
    plain backward's (dpre, dR) carried into x, W and b by autograd."""
    tp = {k: v.requires_grad_() for k, v in tensors(p).items()}
    tx = torch.from_numpy(x).requires_grad_()
    cots = [torch.from_numpy(h_cot), *map(torch.from_numpy, st_cot)]
    if how == "function":
        hs, st = xl.slstm_scan(tx, tp, h, impl="chunked")
        assert type(hs.grad_fn).__name__ == "SLSTMScanBackward"
        torch.autograd.backward([hs, *st], cots)
    else:
        pre = torch.stack([tx @ tp[f"w_{g}"] + tp[f"b_{g}"]
                           for g in sl_ref.GATES])
        r = torch.stack([tp[f"r_{g}"] for g in sl_ref.GATES])
        dpre, dr = sl_ref.slstm_scan_bwd_ref(pre.detach(), r.detach(),
                                             cots[0], tuple(cots[1:]))
        torch.autograd.backward([pre, r], [dpre, dr])
    return tx.grad, {k: v.grad for k, v in tp.items()}


@pytest.mark.parametrize("how", ["plain", "function"])
@pytest.mark.parametrize("b,s,d,h,scale", SLSTM_BWD_CASES)
def test_slstm_backward_matches_jax_vjp(b, s, d, h, scale, how):
    """``slstm_scan_bwd_ref`` and ``SLSTMScan`` (the CPU runs its plain
    versions) against jax.vjp of ``repro.models.xlstm.slstm_scan``, with
    cotangents on h and on the final (c, n, h, m)."""
    p, x, h_cot, st_cot = slstm_bwd_inputs(b, s, d, h, scale)
    _, vjp = jax.vjp(lambda x, p: r_xl.slstm_scan(x, p, h), jnp.asarray(x),
                     jax.tree_util.tree_map(jnp.asarray, p))
    want_x, want_p = vjp((jnp.asarray(h_cot),
                          tuple(map(jnp.asarray, st_cot))))
    got_x, got_p = slstm_port_grads(p, x, h_cot, st_cot, h, how)
    close(got_x, want_x, SLSTM_BWD_TOL)
    for k in p:
        assert np.isfinite(np.asarray(want_p[k])).all()
        close(got_p[k], want_p[k], SLSTM_BWD_TOL)


def test_slstm_scan_saves_nothing_without_grad():
    """Frozen inputs, or no_grad, take the plain loop with no graph; under
    autograd ``SLSTMScan`` takes a cotangent on h alone (the final state
    unused, as in training) or on one state entry alone."""
    p, x, h_cot, st_cot = slstm_bwd_inputs(2, 6, 16, 2, 1.0)
    hs, st = xl.slstm_scan(torch.from_numpy(x), tensors(p), 2)
    assert hs.grad_fn is None and st[0].grad_fn is None
    for which in ("h", "m"):
        tx = torch.from_numpy(x).requires_grad_()
        with torch.no_grad():
            assert xl.slstm_scan(tx, tensors(p), 2)[0].grad_fn is None
        hs, st = xl.slstm_scan(tx, tensors(p), 2)
        out = hs if which == "h" else st[3]
        out.backward(torch.ones_like(out))
        assert torch.isfinite(tx.grad).all() and tx.grad.abs().sum() > 0


def test_slstm_kernel_wrapper_refuses_what_it_does_not_take():
    """Checked before anything is built: a CPU tensor, a wrong shape."""
    pre, r = torch.zeros(4, 1, 3, 8), torch.zeros(4, 2, 4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        sl_kernel.slstm_scan_kernel(pre, r)
    assert sl_kernel.slstm_scan_kernel.launches == 0



# (B, du, R's dtype) → the route: xlstm-350m's width (du 256) at the
# served batches and both dtypes, B 5-8 as two row blocks (512 threads a
# CTA), B 9 and 12 as three (768 threads: the block route), the reduced
# xlstm-350m (du 32), du 24 (24 threads a CTA, not whole warps), du 30 and
# 6 (8 does not divide them), du 512 (its R slice fits no CTA; past the
# block route's 256 too)
SLSTM_ROUTE_CASES = [
    (4, 256, torch.bfloat16, "cluster"),
    (4, 256, torch.float32, "cluster"),
    (1, 256, torch.bfloat16, "cluster"),
    (2, 256, torch.float32, "cluster"),
    (3, 256, torch.bfloat16, "cluster"),
    (8, 256, torch.float32, "cluster"),
    (9, 256, torch.bfloat16, "block"),
    (12, 256, torch.float32, "block"),
    (17, 256, torch.float32, "block"),
    (4, 32, torch.float32, "cluster"),
    (1, 128, torch.bfloat16, "cluster"),
    (1, 24, torch.float32, "block"),
    (2, 30, torch.float32, "block"),
    (1, 6, torch.bfloat16, "block"),
    (1, 512, torch.float32, "block")]


@pytest.mark.parametrize("b,du,dtype,route", SLSTM_ROUTE_CASES)
def test_slstm_scan_choose_route_by_shape(b, du, dtype, route):
    assert sl_kernel.choose_route(b, du, dtype) == route
    assert sl_kernel.cluster_fits(b, du, dtype) == (route == "cluster")


def test_slstm_cluster_route_shared_memory():
    """A CTA's R slice at xlstm-350m's du 256 (each unit's row padded by 64
    bytes) and the head's h twice: 64 KiB + 2 KiB of R in bf16 and twice
    that in f32 at a cluster of 8; at B 8 the h buffers double and f32
    still fits; du 512's slice does not."""
    h = 2 * 256 * 4 * 4
    assert sl_kernel.cluster_smem(4, 256, 2) == h + 32 * 2112
    assert sl_kernel.cluster_smem(4, 256, 4) == h + 32 * 4160
    assert sl_kernel.cluster_smem(8, 256, 4) == 2 * h + 32 * 4160
    assert sl_kernel.cluster_smem(8, 256, 4) <= sl_kernel.SMEM_MAX
    assert sl_kernel.cluster_smem(1, 512, 2) > sl_kernel.SMEM_MAX


# (B, du, R's dtype) → the backward's routes: the cluster route where the
# forward's plan fits and the partial sums of dh from the 8 CTAs (twice)
# and the CTA's dg beside the R slice fit a CTA (xlstm-350m's du 256 up to
# B 8 in f32), the block route while 44 B du bytes fit (B 20 at du 256),
# neither past both
SLSTM_BWD_ROUTE_CASES = [
    (4, 256, torch.bfloat16, ("cluster", "block")),
    (8, 256, torch.float32, ("cluster", "block")),
    (9, 256, torch.bfloat16, ("block",)),
    (20, 256, torch.float32, ("block",)),
    (21, 256, torch.float32, ()),
    (4, 32, torch.float32, ("cluster", "block")),
    (2, 30, torch.float32, ("block",)),
    (1, 512, torch.float32, ())]


@pytest.mark.parametrize("b,du,dtype,routes", SLSTM_BWD_ROUTE_CASES)
def test_slstm_backward_routes_by_shape(b, du, dtype, routes):
    assert sl_kernel.bwd_routes(b, du, dtype) == routes
    el = torch.empty((), dtype=dtype).element_size()
    rows, units = 4 * -(-b // 4), du // 8
    assert (sl_kernel.cluster_bwd_smem(b, du, el)
            == 4 * (2 * 8 * units * rows + units * rows * 4)
            + du * sl_kernel._r_stride_bwd(units, el) * el)
    assert sl_kernel._r_stride_bwd(units, el) * el % 128 == 4 * el


def test_slstm_backward_wrapper_refuses_before_building():
    """A CPU tensor, an unknown route and a route that cannot take the
    shape raise ValueError before anything is built; nothing is counted."""
    sl_kernel.reset_counts()
    saved, r = torch.zeros(8, 1, 3, 60), torch.zeros(4, 2, 30, 30)
    with pytest.raises(ValueError, match="CUDA"):
        sl_kernel.slstm_scan_bwd_kernel(saved, r, None, None)
    meta = saved.to("meta"), r.to("meta")
    with pytest.raises(ValueError, match="CUDA"):
        sl_kernel.slstm_scan_bwd_kernel(*meta, None, None)
    with pytest.raises(ValueError, match="saved must be"):
        sl_kernel.slstm_scan_bwd_kernel(saved[:4], r, None, None)
    with pytest.raises(ValueError, match="not one of"):
        sl_kernel.slstm_scan_bwd_kernel(saved, r, None, None, route="grid")
    with pytest.raises(ValueError, match="cluster route does not take"):
        sl_kernel.slstm_scan_bwd_kernel(saved, r, None, None,
                                        route="cluster")
    with pytest.raises(ValueError, match="block route does not take"):
        sl_kernel.slstm_scan_bwd_kernel(torch.zeros(8, 1, 2, 512),
                                        torch.zeros(4, 1, 512, 512), None,
                                        None, route="block")
    assert sl_kernel.slstm_scan_bwd_kernel.launches == 0


def test_slstm_kernel_wrapper_refuses_routes_before_building():
    """An unknown route, and a route that cannot take the shape, raise
    ValueError before the device is looked at or anything is built; the
    CPU's plain version counts no launch."""
    sl_kernel.reset_counts()
    pre, r = torch.zeros(4, 1, 3, 60), torch.zeros(4, 2, 30, 30)
    with pytest.raises(ValueError, match="not one of"):
        sl_kernel.slstm_scan_kernel(pre, r, route="grid")
    with pytest.raises(ValueError, match="cluster route does not take"):
        sl_kernel.slstm_scan_kernel(pre, r, route="cluster")
    with pytest.raises(ValueError, match="block route takes du"):
        sl_kernel.slstm_scan_kernel(torch.zeros(4, 1, 2, 512),
                                    torch.zeros(4, 1, 512, 512),
                                    route="block")
    with pytest.raises(ValueError, match="cluster route does not take"):
        # three row blocks of 32 units × 8 lanes: 768 threads a CTA
        sl_kernel.slstm_scan_kernel(torch.zeros(4, 12, 2, 1024),
                                    torch.zeros(4, 4, 256, 256),
                                    route="cluster")
    with pytest.raises(ValueError, match="block route takes du"):
        # 32 B du bytes of shared memory: 237,568
        sl_kernel.slstm_scan_kernel(torch.zeros(4, 29, 2, 256),
                                    torch.zeros(4, 1, 256, 256),
                                    route="block")
    pre, r = torch.zeros(4, 4, 3, 1024), torch.zeros(4, 4, 256, 256)
    with pytest.raises(ValueError, match="CUDA"):
        sl_kernel.slstm_scan_kernel(pre, r, route="cluster")
    sl_ops.slstm_scan(pre, r)
    assert sl_kernel.slstm_scan_kernel.launches == 0
    assert sl_kernel.slstm_scan_kernel.by_route == {"cluster": 0,
                                                    "block": 0}

# --------------------------------------------------------------------------
# Blocks
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def blocks():
    rc, pc = configs()
    keys = jax.random.split(jax.random.key(2), 2)
    mp = r_init_tree(keys[0], r_xl.mlstm_block_shapes(rc), jnp.float32)
    sp = r_init_tree(keys[1], r_xl.slstm_block_shapes(rc), jnp.float32)
    x = np.random.default_rng(9).normal(size=(2, 21, rc.d_model)).astype(
        np.float32)
    return rc, pc, {"mlstm": (mp, tensors(mp)), "slstm": (sp, tensors(sp))}, x


def test_block_shapes_match_reference(blocks):
    rc, pc = blocks[:2]
    assert xl.mlstm_block_shapes(pc) == r_xl.mlstm_block_shapes(rc)
    assert xl.slstm_block_shapes(pc) == r_xl.slstm_block_shapes(rc)


def test_conv_causal_matches_reference():
    rng = np.random.default_rng(10)
    x = rng.normal(size=(2, 9, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    want, got = both(r_xl._conv_causal, xl._conv_causal, x, w, b)
    close(got, want)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_matches_reference(blocks, kind):
    rc, pc, params, x = blocks
    rp, pp = params[kind]
    y_r, st_r, conv_r = getattr(r_xl, f"{kind}_block")(rp, jnp.asarray(x),
                                                       rc)
    y_p, st_p, conv_p = getattr(xl, f"{kind}_block")(pp, torch.from_numpy(x),
                                                     pc)
    close(y_p, y_r)
    close(conv_p, conv_r)
    for got, want in zip(st_p, st_r):
        close(got, want)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_step_matches_reference(blocks, kind):
    """One step from the state the block left after the first 20 steps,
    with the 21st input."""
    rc, pc, params, x = blocks
    rp, pp = params[kind]
    _, st, conv = getattr(r_xl, f"{kind}_block")(rp, jnp.asarray(x[:, :20]),
                                                 rc)
    x_t = x[:, 20:21]
    y_r, st_r, conv_r = getattr(r_xl, f"{kind}_block_step")(
        rp, jnp.asarray(x_t), rc, state=st, conv_state=conv)
    y_p, st_p, conv_p = getattr(xl, f"{kind}_block_step")(
        pp, torch.from_numpy(x_t), pc, state=tensors(tuple(st)),
        conv_state=tensors(conv))
    close(y_p, y_r)
    close(conv_p, conv_r)
    for got, want in zip(st_p, st_r):
        close(got, want)
    # and the step continues the full block: the 21-step block's output
    y_full, st_full, _ = getattr(xl, f"{kind}_block")(pp, torch.from_numpy(x),
                                                      pc)
    close(y_p, y_full[:, 20:21].numpy(), 1e-4)
    for got, want in zip(st_p, st_full):
        close(got, want.numpy(), 1e-4)


# --------------------------------------------------------------------------
# The whole reduced model
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def run():
    rc, pc = configs()
    ref, port = r_build(rc), build_model(pc)
    rp = ref.init_params(jax.random.key(0))
    pp = params_from_jax(pc, jax.tree_util.tree_map(np.asarray, rp), CPU)
    tokens = np.random.default_rng(1).integers(
        0, rc.vocab_size, size=(2, PROMPT)).astype(np.int32)
    rl, rcache = jax.jit(lambda p, b: ref.prefill(p, b, MAX_LEN))(
        rp, {"tokens": jnp.asarray(tokens)})
    pl, pcache = port.prefill(pp, {"tokens": torch.as_tensor(tokens)},
                              MAX_LEN)
    out = {"cfg": (rc, pc), "params": (rp, pp), "tokens": tokens,
           "prefill": (np.asarray(rl), pl.numpy()),
           "cache": (jax.tree_util.tree_map(np.asarray, rcache),
                     {k: v.clone() if torch.is_tensor(v) else v
                      for k, v in pcache.items()}),
           "decode": []}
    dec = jax.jit(ref.decode_step)
    logits_r = rl
    for _ in range(STEPS):
        tok = np.array(jnp.argmax(logits_r[:, -1], -1))[:, None]
        logits_r, rcache = dec(rp, {"token": jnp.asarray(tok, jnp.int32)},
                               rcache)
        logits_p, pcache = port.decode_step(
            pp, {"token": torch.as_tensor(tok, dtype=torch.int64)}, pcache)
        out["decode"].append((np.asarray(logits_r), logits_p.numpy()))
    out["final_cache"] = (jax.tree_util.tree_map(np.asarray, rcache), pcache)
    return out


def test_params_and_shapes_match_reference(run):
    rc, pc = run["cfg"]
    g, m = r_model._grouping(rc)
    assert xlstm_model._grouping(pc) == (g, m) == (1, 3)
    assert len(run["params"][1]["mlstm"]) == g * m
    assert len(run["params"][1]["slstm"]) == g
    want = r_model.cache_shapes(rc, 2, MAX_LEN)
    got = xlstm_model.cache_shapes(pc, 2, MAX_LEN)
    assert set(got) == set(want) - {"pos"}
    for name, (shape, _) in got.items():
        assert shape == want[name][0], name


def test_forward_matches_reference(run):
    rc, pc = run["cfg"]
    rp, pp = run["params"]
    x, _, _ = r_model.forward(rp, {"tokens": jnp.asarray(run["tokens"])}, rc)
    want = np.asarray(r_lm_head(rp, x, rc))
    got = build_model(pc).forward(pp, {"tokens": torch.as_tensor(
        run["tokens"])}).numpy()
    close(got, want, MODEL_TOL)
    # the plain path (the sLSTM's step loop) gives the same on the CPU
    got_naive = build_model(pc, impl="naive").forward(
        pp, {"tokens": torch.as_tensor(run["tokens"])}).numpy()
    np.testing.assert_array_equal(got_naive, got)


def test_prefill_and_decode_logits_match(run):
    want, got = run["prefill"]
    assert got.shape == want.shape == (2, 1, run["cfg"][1].vocab_size)
    close(got, want, MODEL_TOL)
    for want, got in run["decode"]:
        close(got, want, MODEL_TOL)


@pytest.mark.parametrize("when", ["prefill", "final"])
def test_caches_match(run, when):
    want, got = run["cache"] if when == "prefill" else run["final_cache"]
    assert int(want["pos"]) == got["pos"] == PROMPT + (
        0 if when == "prefill" else STEPS)
    assert set(got) == set(want)
    for name in set(want) - {"pos"}:
        assert got[name].dtype == torch.float32
        close(got[name].numpy(), want[name], 1e-4)


def test_decode_matches_a_longer_prefill():
    """prefill(S) then one decode step ≡ prefill(S+1)'s last logits."""
    _, pc = configs()
    api = build_model(pc)
    params = api.init_params(1, CPU)
    tokens = torch.as_tensor(np.random.default_rng(3).integers(
        0, pc.vocab_size, size=(2, 13)))
    full, _ = api.prefill(params, {"tokens": tokens}, 20)
    _, cache = api.prefill(params, {"tokens": tokens[:, :12]}, 20)
    step, cache = api.decode_step(params, {"token": tokens[:, 12:]}, cache)
    assert cache["pos"] == 13
    close(step.numpy(), full.numpy(), 1e-4)
