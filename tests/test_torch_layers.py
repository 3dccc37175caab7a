"""The port's layers, decode attention and Mamba2 blocks against the JAX
package's, on the CPU in f32, with inputs and weights from numpy."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as r_reduced
from repro.models import attention as r_attn
from repro.models import layers as r_layers
from repro.models import mamba2 as r_m2

from repro_torch.configs import reduced_config as p_reduced
from repro_torch.models import attention as p_attn
from repro_torch.models import layers as p_layers
from repro_torch.models import mamba2 as p_m2
from repro_torch.models.convert import _take

TOL = 1e-5      # f32, the same operations in another order


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def normal(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def test_rms_norm_scales_by_one_plus_scale():
    x, scale = normal(0, 3, 5, 16), normal(1, 16, scale=0.1)
    got = p_layers.rms_norm(torch.as_tensor(x), torch.as_tensor(scale), 1e-6)
    close(got, r_layers.rms_norm(jnp.asarray(x), jnp.asarray(scale)))
    # zero-initialised scale is the plain normalisation, not RMSNorm's 0
    zero = p_layers.rms_norm(torch.as_tensor(x), torch.zeros(16))
    close(zero, x / np.sqrt((x ** 2).mean(-1, keepdims=True) + 1e-6))


def test_rms_norm_statistics_in_f32_cast_back():
    x = torch.as_tensor(normal(2, 4, 64) * 30).to(torch.bfloat16)
    got = p_layers.rms_norm(x, torch.zeros(64))
    assert got.dtype == torch.bfloat16
    want = r_layers.rms_norm(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                             jnp.zeros(64))
    close(got, want, tol=0)


@pytest.mark.parametrize("pos_shape", [(1, 7), (3, 1)])
def test_rope_split_halves(pos_shape):
    x = normal(3, 3, 7, 4, 16)
    pos = np.arange(int(np.prod(pos_shape))).reshape(pos_shape) * 37
    got = p_layers.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), 1e6)
    close(got, r_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6))
    # split halves: dim i pairs with i + D/2 and the rotation keeps norms
    np.testing.assert_allclose(
        np.linalg.norm(got.numpy()[..., [0, 8]], axis=-1),
        np.linalg.norm(x[..., [0, 8]], axis=-1), rtol=1e-5)


@pytest.mark.parametrize("act", ["silu", "gelu", "gelu_plain", "relu",
                                 "relu2"])
def test_gated_mlp_and_activations(act):
    shapes = p_layers.mlp_param_shapes(16, 24, act)
    assert shapes == r_layers.mlp_param_shapes(16, 24, act)
    params = {k: normal(i, *s, scale=0.3)
              for i, (k, s) in enumerate(shapes.items())}
    x = normal(9, 2, 5, 16)
    got = p_layers.gated_mlp(torch.as_tensor(x),
                             {k: torch.as_tensor(v)
                              for k, v in params.items()}, act)
    close(got, r_layers.gated_mlp(jnp.asarray(x), params, act))
    if act == "gelu":       # the tanh approximation, not the erf form
        z = torch.linspace(-3, 3, 101)
        want = 0.5 * z * (1 + torch.tanh(math.sqrt(2 / math.pi)
                                         * (z + 0.044715 * z ** 3)))
        torch.testing.assert_close(p_layers._ACTS["gelu"](z), want)


def test_init_tree_name_rules_and_seed():
    shapes = {"a_log": (64,), "dt_bias": (4,), "d_skip": (4,),
              "b_fg": (2, 3), "b_ig": (5,), "q_norm_scale": (8,),
              "out_bias": (6,), "conv_x_b": (6,), "w": (256, 512),
              "layers": [{"w2": (4, 4)}]}
    t = p_layers.init_tree(shapes, torch.bfloat16, 0, torch.device("cpu"))
    a = t["a_log"]
    assert a.dtype == torch.float32
    assert bool((a >= 0).all() and (a <= math.log(16.0)).all())
    assert torch.equal(t["dt_bias"], torch.full((4,), -4.0))
    assert torch.equal(t["d_skip"], torch.ones(4))
    torch.testing.assert_close(t["b_fg"].reshape(-1),
                               torch.linspace(3.0, 6.0, 6))
    assert torch.equal(t["b_ig"], torch.full((5,), -5.0))
    assert torch.equal(t["q_norm_scale"], torch.zeros(8))
    assert t["out_bias"].dtype == torch.bfloat16
    assert not t["out_bias"].float().any()
    # "conv_x_b" matches no rule (as in the reference): a fan-in draw
    assert t["conv_x_b"].float().abs().min() > 0
    w = t["w"].float()
    assert t["w"].dtype == torch.bfloat16
    # truncated normal at ±2σ, σ = fan_in^-1/2 (std of the cut law 0.88σ)
    assert w.abs().max() <= 2 * 256 ** -0.5 + 1e-3
    assert abs(w.std().item() * 16 - 0.88) < 0.02
    assert t["layers"][0]["w2"].shape == (4, 4)
    again = p_layers.init_tree(shapes, torch.bfloat16, 0,
                               torch.device("cpu"))
    assert torch.equal(again["w"], t["w"])
    other = p_layers.init_tree(shapes, torch.bfloat16, 1,
                               torch.device("cpu"))
    assert not torch.equal(other["w"], t["w"])
    assert "w" in t and "nope" not in t
    assert sum(p.numel() for p in t.parameters()) == sum(
        math.prod(s) for s in (*[v for v in shapes.values()
                                 if isinstance(v, tuple)], (4, 4)))


def cache_and_query(seed, b, smax, hq, hkv, d):
    return (normal(seed, b, 1, hq, d), normal(seed + 1, b, smax, hkv, d),
            normal(seed + 2, b, smax, hkv, d))


@pytest.mark.parametrize("window,pos", [(0, 5), (0, [3, 11]), (8, 21),
                                        (8, [2, 30]), (8, 7)])
def test_decode_attention_linear_ring_and_ragged(window, pos):
    q, kc, vc = cache_and_query(4, 2, 8 if window else 12, 4, 2, 16)
    got = p_attn.decode_attention(*map(torch.as_tensor, (q, kc, vc)),
                                  torch.as_tensor(pos), window=window)
    want = r_attn.decode_attention(*map(jnp.asarray, (q, kc, vc)),
                                   jnp.asarray(pos, jnp.int32),
                                   window=window)
    close(got, want)


@pytest.mark.parametrize("window,pos", [(0, 6), (0, [1, 9]), (5, [3, 12])])
def test_gqa_decode_attention_writes_the_cache(window, pos):
    cfg = r_reduced("qwen3-1.7b").replace(dtype="float32", window=window)
    shapes = r_attn.attn_param_shapes(cfg)
    params = {k: normal(i, *s, scale=0.05)
              for i, (k, s) in enumerate(shapes.items())}
    x = normal(7, 2, 1, cfg.d_model)
    smax = window or 12
    kc = normal(8, 2, smax, cfg.num_kv_heads, cfg.head_dim)
    vc = normal(9, 2, smax, cfg.num_kv_heads, cfg.head_dim)
    out_r, (kc_r, vc_r) = r_attn.gqa_decode_attention(
        params, jnp.asarray(x), cfg, k_cache=jnp.asarray(kc),
        v_cache=jnp.asarray(vc), pos=jnp.asarray(pos, jnp.int32))
    pk, pv = torch.as_tensor(kc), torch.as_tensor(vc)
    out_p, (kc_p, vc_p) = p_attn.gqa_decode_attention(
        {k: torch.as_tensor(v) for k, v in params.items()},
        torch.as_tensor(x), p_reduced("qwen3-1.7b").replace(
            dtype="float32", window=window),
        k_cache=pk, v_cache=pv, pos=torch.as_tensor(pos))
    close(out_p, out_r)
    close(kc_p, kc_r)
    close(vc_p, vc_r)
    assert kc_p is pk            # updated in place


@pytest.fixture(scope="module")
def mamba_pair():
    rcfg = r_reduced("zamba2-1.2b").replace(dtype="float32", ssm_chunk=16)
    pcfg = p_reduced("zamba2-1.2b").replace(dtype="float32", ssm_chunk=16)
    tree = r_layers.init_tree(jax.random.key(3),
                              r_m2.mamba2_param_shapes(rcfg), jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, tree)
    # non-trivial norm scale and conv bias
    tree["norm_scale"] = normal(11, *tree["norm_scale"].shape, scale=0.1)
    tree["conv_x_b"] = normal(12, *tree["conv_x_b"].shape, scale=0.1)
    return rcfg, pcfg, tree, _take(tree, (), torch.device("cpu"))


def test_mamba2_block_matches_reference(mamba_pair):
    rcfg, pcfg, tree, params = mamba_pair
    x = normal(13, 2, 37, rcfg.d_model)
    y_r, (st_r, conv_r) = jax.jit(
        lambda t, x: r_m2.mamba2_block(t, x, rcfg))(tree, jnp.asarray(x))
    for impl in ("chunked", "naive"):
        y_p, (st_p, conv_p) = p_m2.mamba2_block(params, torch.as_tensor(x),
                                                pcfg, impl=impl)
        close(y_p, y_r, 1e-4)
        close(st_p, st_r, 1e-4)
        close(conv_p, conv_r)


def test_mamba2_step_matches_reference(mamba_pair):
    rcfg, pcfg, tree, params = mamba_pair
    h, n = rcfg.n_ssm_heads, rcfg.ssm_state
    ssm = normal(14, 2, h, rcfg.d_inner // h, n, scale=0.3)
    conv = normal(15, 2, rcfg.ssm_conv - 1, rcfg.d_inner + 2 * n)
    x = normal(16, 2, 1, rcfg.d_model)
    y_r, (ssm_r, conv_r) = jax.jit(
        lambda t, x, s, c: r_m2.mamba2_step(t, x, rcfg, ssm_state=s,
                                            conv_state=c))(
        tree, jnp.asarray(x), jnp.asarray(ssm), jnp.asarray(conv))
    y_p, (ssm_p, conv_p) = p_m2.mamba2_step(
        params, torch.as_tensor(x), pcfg, ssm_state=torch.as_tensor(ssm),
        conv_state=torch.as_tensor(conv))
    close(y_p, y_r, 1e-4)
    close(ssm_p, ssm_r)
    close(conv_p, conv_r)
