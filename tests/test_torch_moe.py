"""The port's MoE layer against the reference's on the CPU, with the same
weights: the capacity rule, the router (indices equal, ties included;
weights and the aux loss within 1e-6) and the whole layer (within 1e-5 of
max |y|) with capacity drops, shared experts and both combine dtypes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as r_reduced
from repro.models import moe as r_moe
from repro.models.layers import init_tree as r_init_tree

from repro_torch.configs import reduced_config as p_reduced
from repro_torch.models import moe
from repro_torch.models.convert import _tensor

ARCH = "deepseek-moe-16b"
TOL = 1e-5                          # f32 sums in other orders, of max |y|


def configs(**kw):
    return (r_reduced(ARCH).replace(dtype="float32", **kw),
            p_reduced(ARCH).replace(dtype="float32", **kw))


def to_torch(tree):
    """A reference parameter tree as CPU tensors (bf16 leaves too)."""
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return _tensor(np.asarray(tree), torch.device("cpu"))


def layer(rc, seed, tokens=32):
    """Reference MoE weights and inputs, and the same as tensors."""
    rp = r_init_tree(jax.random.key(seed), r_moe.moe_param_shapes(rc),
                     jnp.float32)
    x = np.random.default_rng(seed + 10).normal(
        size=(tokens, rc.d_model)).astype(np.float32)
    return rp, x, to_torch(rp)


@pytest.mark.parametrize("tokens", [1, 4, 7, 64, 2048, 12289])
@pytest.mark.parametrize("experts,top_k,factor",
                         [(4, 2, 1.25), (64, 6, 1.25), (64, 6, 0.25),
                          (160, 6, 8.0), (8, 1, 1.0)])
def test_capacity_matches_reference(tokens, experts, top_k, factor):
    rc, pc = configs(num_experts=experts, top_k=top_k,
                     capacity_factor=factor)
    assert moe.capacity(tokens, pc) == r_moe.capacity(tokens, rc)
    assert moe.capacity(tokens, pc) % 8 == 0


@pytest.mark.parametrize("case", ["random", "all_tied", "pair_tied"])
def test_route_matches_reference(case):
    rc, pc = configs(num_experts=8, top_k=3)
    rp, x, pp = layer(rc, 0, tokens=48)
    router = np.asarray(rp["router"]).copy()
    if case == "all_tied":            # every logit 0: experts 0..k-1 win
        router[:] = 0.0
    elif case == "pair_tied":         # experts 2 and 5 score the same
        router[:, 5] = router[:, 2]
    rp = dict(rp, router=jnp.asarray(router))
    pp = dict(pp, router=torch.from_numpy(router))
    w_r, i_r, a_r = r_moe.route(rp, jnp.asarray(x), rc)
    w_p, i_p, a_p = moe.route(pp, torch.from_numpy(x), pc)
    np.testing.assert_array_equal(i_p.numpy(), np.asarray(i_r))
    np.testing.assert_allclose(w_p.numpy(), np.asarray(w_r), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(float(a_p), float(a_r), rtol=1e-6, atol=0)
    if case == "all_tied":
        np.testing.assert_array_equal(i_p.numpy(), np.tile([0, 1, 2],
                                                           (48, 1)))
    if case == "pair_tied":           # the tie was reached, lower id first
        both = (i_p == 2).any(-1) & (i_p == 5).any(-1)
        assert bool(both.any())
        rows = i_p[both].tolist()
        assert all(r.index(2) < r.index(5) for r in rows)


def dropped(rc, rp, x):
    """Token choices the reference drops at its capacity."""
    _, idx, _ = r_moe.route(rp, jnp.asarray(x), rc)
    counts = np.bincount(np.asarray(idx).ravel(), minlength=rc.num_experts)
    return int(np.maximum(counts - r_moe.capacity(len(x), rc), 0).sum())


@pytest.mark.parametrize("bf16_combine", [False, True])
@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("factor", [0.25, 1.25, 8.0])
def test_moe_mlp_matches_reference(factor, shared, bf16_combine):
    rc, pc = configs(capacity_factor=factor, num_shared_experts=shared,
                     moe_bf16_combine=bf16_combine)
    rp, x, pp = layer(rc, 3, tokens=64)
    if factor == 0.25:                # capacity 8 < 64·2/4 choices
        assert dropped(rc, rp, x) > 0
    if factor == 8.0:
        assert dropped(rc, rp, x) == 0
    want, aux_r = r_moe.moe_mlp(rp, jnp.asarray(x.reshape(4, 16, -1)), rc)
    got, aux_p = moe.moe_mlp(pp, torch.from_numpy(x.reshape(4, 16, -1)), pc)
    want = np.asarray(want)
    assert got.shape == want.shape == (4, 16, rc.d_model)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TOL * np.abs(want).max())
    np.testing.assert_allclose(float(aux_p), float(aux_r), rtol=1e-6)


@pytest.mark.parametrize("seed", range(4))
def test_capacity_drops_only_reduce_moe_output(seed):
    """Tokens dropped by capacity give fewer combined outputs, never
    garbage: with a tiny capacity the output norm stays at most 1.5x that
    with ample capacity (the reference's property)."""
    _, pc = configs(num_shared_experts=0)
    params = to_torch(r_init_tree(jax.random.key(seed),
                                  r_moe.moe_param_shapes(pc), jnp.float32))
    x = torch.from_numpy(np.random.default_rng(seed + 10).normal(
        size=(32, pc.d_model)).astype(np.float32))
    y_small, _ = moe.moe_mlp(params, x, pc.replace(capacity_factor=0.25))
    y_big, _ = moe.moe_mlp(params, x, pc.replace(capacity_factor=8.0))
    assert float(y_small.norm()) <= float(y_big.norm()) * 1.5
    assert bool(torch.isfinite(y_small).all())


def test_bf16_layer_matches_reference():
    """The served dtype: bf16 weights and tokens through both packages."""
    rc, pc = configs()
    rc, pc = rc.replace(dtype="bfloat16"), pc.replace(dtype="bfloat16")
    rp, x, _ = layer(rc, 5, tokens=40)
    rp = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), rp)
    pp = to_torch(rp)
    xb = jnp.asarray(x, jnp.bfloat16)
    want, _ = r_moe.moe_mlp(rp, xb, rc)
    got, _ = moe.moe_mlp(pp, torch.from_numpy(x).to(torch.bfloat16), pc)
    _, i_r, _ = r_moe.route(rp, xb, rc)
    _, i_p, _ = moe.route(pp, torch.from_numpy(x).to(torch.bfloat16), pc)
    np.testing.assert_array_equal(i_p.numpy(), np.asarray(i_r))
    want = np.asarray(want.astype(jnp.float32))
    # one bf16 rounding of each product and of the combine: 2^-7 of max|y|
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2.0 ** -7 * np.abs(want).max())
