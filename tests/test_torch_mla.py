"""The port's Multi-head Latent Attention against the reference's on the
CPU with the same weights: prefill (naive and chunked), decode (absorbed
and naive) and the latent caches; absorbed against naive decode; ragged
[B] positions against per-row scalar calls; and flash attention with a
value head narrower than the query/key head, which MLA's prefill takes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as r_reduced
from repro.models import attention as r_attn
from repro.models import build_model as r_build
from repro.models import mla as r_mla
from repro.models.layers import init_tree as r_init_tree

from repro_torch.configs import reduced_config as p_reduced
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.models import build_model, mla
from repro_torch.models.convert import _tensor, params_from_jax

ARCH = "deepseek-v2-lite-16b"
TOL = 1e-5                          # f32 sums in other orders, of max |out|
CPU = torch.device("cpu")


def configs(**kw):
    return (r_reduced(ARCH).replace(dtype="float32", **kw),
            p_reduced(ARCH).replace(dtype="float32", **kw))


def tensors(tree):
    if isinstance(tree, dict):
        return {k: tensors(v) for k, v in tree.items()}
    return _tensor(np.asarray(tree), CPU)


@pytest.fixture(scope="module")
def layer():
    rc, pc = configs()
    rp = r_init_tree(jax.random.key(0), r_mla.mla_param_shapes(rc),
                     jnp.float32)
    x = np.random.default_rng(1).normal(size=(2, 11, rc.d_model)).astype(
        np.float32)
    return rc, pc, rp, tensors(rp), x


def close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * np.abs(want).max())


def test_param_shapes_match_reference(layer):
    rc, pc = layer[:2]
    assert mla.mla_param_shapes(pc) == r_mla.mla_param_shapes(rc)


@pytest.mark.parametrize("impl", ["naive", "chunked"])
def test_prefill_matches_reference(layer, impl):
    rc, pc, rp, pp, x = layer
    pos = np.arange(x.shape[1])[None]
    want, (c_r, k_r) = r_mla.mla_self_attention(
        rp, jnp.asarray(x), rc, positions=jnp.asarray(pos), impl=impl)
    got, (c_p, k_p) = mla.mla_self_attention(
        pp, torch.from_numpy(x), pc, positions=torch.from_numpy(pos),
        impl=impl)
    assert got.shape == want.shape == x.shape
    close(got, want)
    close(c_p, c_r)
    close(k_p, k_r)


def prefilled_caches(rc, rp, x, smax):
    """Reference latent caches of ``x``'s prefill, zero past it."""
    pos = jnp.arange(x.shape[1])[None]
    _, (c, k) = r_mla.mla_self_attention(rp, jnp.asarray(x), rc,
                                         positions=pos, impl="naive")
    pad = ((0, 0), (0, smax - x.shape[1]), (0, 0))
    return np.pad(np.asarray(c), pad), np.pad(np.asarray(k), pad)


@pytest.mark.parametrize("absorbed", [False, True])
def test_decode_matches_reference(layer, absorbed):
    rc, pc, rp, pp, x = layer
    ckv, kr = prefilled_caches(rc, rp, x, 16)
    tok = np.random.default_rng(2).normal(size=(2, 1, rc.d_model)).astype(
        np.float32)
    pos = x.shape[1]
    want, (c_r, k_r) = r_mla.mla_decode_attention(
        rp, jnp.asarray(tok), rc, ckv_cache=jnp.asarray(ckv),
        kr_cache=jnp.asarray(kr), pos=pos, absorbed=absorbed)
    c_p, k_p = torch.from_numpy(ckv.copy()), torch.from_numpy(kr.copy())
    got, (c_out, k_out) = mla.mla_decode_attention(
        pp, torch.from_numpy(tok), pc, ckv_cache=c_p, kr_cache=k_p, pos=pos,
        absorbed=absorbed)
    assert c_out is c_p and k_out is k_p          # written in place
    close(got, want)
    close(c_p, c_r)
    close(k_p, k_r)


def test_absorbed_decode_equals_naive():
    """The reference's invariant (``test_model_invariants``) on the port:
    folding W_uk and W_uv changes no logit beyond 5e-4."""
    _, pc = configs()
    api_n = build_model(pc.replace(mla_absorbed=False), impl="naive")
    api_a = build_model(pc.replace(mla_absorbed=True), impl="naive")
    params = api_n.init_params(2, CPU)
    tokens = torch.as_tensor(np.random.default_rng(3).integers(
        0, pc.vocab_size, (2, 10)))
    _, cache_n = api_n.prefill(params, {"tokens": tokens}, 16)
    _, cache_a = api_n.prefill(params, {"tokens": tokens}, 16)
    tok = {"token": torch.tensor([[3], [5]])}
    ln, _ = api_n.decode_step(params, tok, cache_n)
    la, _ = api_a.decode_step(params, tok, cache_a)
    np.testing.assert_allclose(la.numpy(), ln.numpy(), rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("absorbed", [False, True])
def test_vector_pos_equals_per_row_scalar_calls(layer, absorbed):
    """Ragged [B] positions write each row's latent at its own position and
    mask each row at its own length, as B scalar-position calls do."""
    _, pc, _, pp, x = layer
    rng = np.random.default_rng(4)
    ckv = rng.normal(size=(3, 16, pc.kv_lora_rank)).astype(np.float32)
    kr = rng.normal(size=(3, 16, pc.qk_rope_dim)).astype(np.float32)
    tok = torch.from_numpy(rng.normal(size=(3, 1, pc.d_model)).astype(
        np.float32))
    pos = torch.tensor([4, 11, 0])
    c_v, k_v = torch.from_numpy(ckv.copy()), torch.from_numpy(kr.copy())
    got, _ = mla.mla_decode_attention(pp, tok, pc, ckv_cache=c_v,
                                      kr_cache=k_v, pos=pos,
                                      absorbed=absorbed)
    for row in range(3):
        c_s = torch.from_numpy(ckv[row:row + 1].copy())
        k_s = torch.from_numpy(kr[row:row + 1].copy())
        want, _ = mla.mla_decode_attention(
            pp, tok[row:row + 1], pc, ckv_cache=c_s, kr_cache=k_s,
            pos=int(pos[row]), absorbed=absorbed)
        # the latent of one row in a batch of 3 and alone: products in
        # other blockings, a few ulps apart
        for got_t, want_t in ((got[row:row + 1], want),
                              (c_v[row:row + 1], c_s),
                              (k_v[row:row + 1], k_s)):
            torch.testing.assert_close(got_t, want_t, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("hq,hkv,d,dv", [(4, 4, 48, 32), (4, 2, 24, 16),
                                         (2, 1, 96, 64)])
def test_flash_ops_with_narrower_values_match_reference(hq, hkv, d, dv):
    """``flash_attention`` with Dv < D (MLA's 192/128 at reduced size)
    against the reference's ``chunked_attention``."""
    rng = np.random.default_rng(d + dv)
    q = rng.normal(size=(2, 37, hq, d)).astype(np.float32)
    k = rng.normal(size=(2, 37, hkv, d)).astype(np.float32)
    v = rng.normal(size=(2, 37, hkv, dv)).astype(np.float32)
    scale = (d + 7) ** -0.5
    want = r_attn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True,
                                    q_chunk=16, kv_chunk=16, scale=scale)
    got = fa_ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                 causal=True, scale=scale)
    assert got.shape == (2, 37, hq, dv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_attention_ref_sizes_its_output_by_v():
    """The plain version takes Dv != D and equals the padded-v call sliced
    back (the kernel route's rule)."""
    rng = np.random.default_rng(9)
    q, k = (torch.from_numpy(rng.normal(size=(1, 2, 9, 24)).astype(
        np.float32)) for _ in range(2))
    v = torch.from_numpy(rng.normal(size=(1, 2, 9, 16)).astype(np.float32))
    out = fa_ref.attention_ref(q, k, v)
    assert out.shape == (1, 2, 9, 16)
    padded = fa_ref.attention_ref(q, k, torch.nn.functional.pad(v, (0, 8)))
    torch.testing.assert_close(padded[..., :16], out, rtol=0, atol=0)
    assert bool((padded[..., 16:] == 0).all())


def test_mla_model_caches_match_reference():
    """The whole reduced model: prefill's latent caches, then a decode
    step's logits and caches, against the reference."""
    rc, pc = configs()
    ref = r_build(rc)
    rp = ref.init_params(jax.random.key(5))
    pp = params_from_jax(pc, jax.tree_util.tree_map(np.asarray, rp), CPU)
    tokens = np.random.default_rng(6).integers(0, rc.vocab_size, (2, 9))
    rl, rcache = ref.prefill(rp, {"tokens": jnp.asarray(tokens)}, 16)
    port = build_model(pc)
    pl, pcache = port.prefill(pp, {"tokens": torch.as_tensor(tokens)}, 16)
    close(pl, rl)
    for name in ("ckv", "kr"):
        close(pcache["layers"][name], rcache["layers"][name])
    tok = np.asarray([[7], [1]])
    rl, rcache = ref.decode_step(rp, {"token": jnp.asarray(tok)}, rcache)
    pl, pcache = port.decode_step(pp, {"token": torch.as_tensor(tok)},
                                  pcache)
    close(pl, rl)
    for name in ("ckv", "kr"):
        close(pcache["layers"][name], rcache["layers"][name])
