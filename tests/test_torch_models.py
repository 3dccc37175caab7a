"""The ported serving path end to end at small size: reduced qwen3-1.7b
(with and without a sliding window), starcoder2-7b (``gelu_plain``),
minitron-4b (``relu2``), deepseek-moe-16b (MoE), deepseek-v2-lite-16b
(MLA + MoE), phi-3-vision-4.2b (VLM), zamba2-1.2b and
gemma-2b at its real head dim 256 with one kv head in f32, with the JAX
package's initial weights carried over by ``params_from_jax``.  Prefill
logits and caches match, then 8 teacher-forced decode steps on the JAX
greedy tokens match; greedy tokens are compared only where the reference's
top-2 logit margin exceeds 10× the tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as r_reduced
from repro.models import build_model as r_build
from repro.models import hybrid as r_hybrid
from repro.models import registry as r_registry

from repro_torch.configs import get_config
from repro_torch.configs import reduced_config as p_reduced
from repro_torch.models import build_model, hybrid, param_count
from repro_torch.models.convert import params_from_jax

CPU = torch.device("cpu")
# f32 logits of the same network with sums in other orders, relative to
# max |logit| (measured ~4e-7 on these configs)
TOL = 1e-5
MAX_LEN, PROMPT, STEPS = 48, 21, 8
CASES = {"qwen3": ("qwen3-1.7b", 0), "qwen3-swa": ("qwen3-1.7b", 16),
         "starcoder2": ("starcoder2-7b", 0), "minitron": ("minitron-4b", 0),
         "zamba2": ("zamba2-1.2b", 0), "moe": ("deepseek-moe-16b", 0),
         "mla": ("deepseek-v2-lite-16b", 0), "vlm": ("phi-3-vision-4.2b", 0),
         "gemma-d256": ("gemma-2b", 0)}
# reduced configs carried back to a published shape the kernels see: gemma-2b
# at its real head dim (its reduced config has 64) and MQA
REPLACE = {"gemma-2b": dict(head_dim=256)}
FAMILY_ARCHS = ["deepseek-moe-16b", "deepseek-v2-lite-16b",
                "phi-3-vision-4.2b"]


def configs(name, window):
    rc = r_reduced(name).replace(dtype="float32", **REPLACE.get(name, {}))
    pc = p_reduced(name).replace(dtype="float32", **REPLACE.get(name, {}))
    if window:
        rc, pc = rc.with_window(window), pc.with_window(window)
    return rc, pc


@pytest.fixture(scope="module", params=list(CASES))
def run(request):
    """Both packages' prefill and teacher-forced decode on one prompt."""
    rc, pc = configs(*CASES[request.param])
    ref, port = r_build(rc), build_model(pc)
    rp = ref.init_params(jax.random.key(0))
    pp = params_from_jax(pc, jax.tree_util.tree_map(np.asarray, rp), CPU)
    tokens = np.random.default_rng(1).integers(
        0, rc.vocab_size, size=(2, PROMPT)).astype(np.int32)
    rl, rcache = jax.jit(lambda p, b: ref.prefill(p, b, MAX_LEN))(
        rp, {"tokens": jnp.asarray(tokens)})
    pl, pcache = port.prefill(pp, {"tokens": torch.as_tensor(tokens)},
                              MAX_LEN)
    out = {"cfg": (rc, pc), "prefill": (np.asarray(rl), pl.numpy()),
           "cache": (jax.tree_util.tree_map(np.asarray, rcache),
                     snapshot(pcache)),
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
    out["final_cache"] = (jax.tree_util.tree_map(np.asarray, rcache),
                          pcache)
    return out


def snapshot(cache):
    """A copy of the port's cache (decode updates it in place)."""
    return {k: snapshot(v) if isinstance(v, dict)
            else v.clone() if torch.is_tensor(v) else v
            for k, v in cache.items()}


def assert_logits_close(want, got):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)
    # greedy tokens agree wherever the reference's top-2 margin is clear
    top2 = np.sort(want[:, -1], axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 10 * TOL * scale
    np.testing.assert_array_equal(got[:, -1].argmax(-1)[clear],
                                  want[:, -1].argmax(-1)[clear])


def test_prefill_logits_match(run):
    want, got = run["prefill"]
    assert got.shape == want.shape == (2, 1, run["cfg"][1].vocab_size)
    assert_logits_close(want, got)


def test_teacher_forced_decode_logits_match(run):
    for want, got in run["decode"]:
        assert_logits_close(want, got)


def hybrid_views(rcfg, ref_cache):
    """The reference's [G, K, ...] SSM/conv caches as [L, ...]: its real
    layers only (the port keeps no padded slots)."""
    g, k = r_hybrid._grouping(rcfg)
    real = {}
    for name in ("ssm", "conv"):
        flat = ref_cache[name].reshape(g * k, *ref_cache[name].shape[2:])
        real[name] = flat[:rcfg.num_layers]
    return real


@pytest.mark.parametrize("when", ["prefill", "final"])
def test_caches_match(run, when):
    rc, pc = run["cfg"]
    want, got = run["cache"] if when == "prefill" else run["final_cache"]
    assert int(want["pos"]) == got["pos"] == PROMPT + (
        0 if when == "prefill" else STEPS)
    if pc.family != "hybrid":             # K/V, or MLA's ckv/kr
        assert set(got["layers"]) == set(want["layers"])
        for name in want["layers"]:
            np.testing.assert_allclose(got["layers"][name].numpy(),
                                       want["layers"][name], rtol=1e-5,
                                       atol=1e-5)
        return
    for name in ("attn_k", "attn_v"):
        np.testing.assert_allclose(got[name].numpy(), want[name], rtol=1e-5,
                                   atol=1e-5)
    for name, real in hybrid_views(rc, want).items():
        np.testing.assert_allclose(got[name].numpy(), real, rtol=1e-4,
                                   atol=1e-4)


def test_window_cache_is_a_ring():
    """The windowed prompt outgrows its 16-slot ring: token p lives at
    slot p % 16 after prefill, as in the reference."""
    rc, pc = configs("qwen3-1.7b", 16)
    assert PROMPT > rc.window
    port = build_model(pc)
    params = port.init_params(0, CPU)
    tokens = torch.as_tensor(np.arange(PROMPT)[None] % pc.vocab_size)
    _, cache = port.prefill(params, {"tokens": tokens}, MAX_LEN)
    assert cache["layers"]["k"].shape[2] == 16
    _, full = build_model(pc.replace(window=0)).prefill(
        params, {"tokens": tokens}, MAX_LEN)
    # layer 0 keys depend only on their own token and position
    for p in range(PROMPT - 16, PROMPT):
        torch.testing.assert_close(cache["layers"]["k"][0, 0, p % 16],
                                   full["layers"]["k"][0, 0, p])


def test_zamba2_padded_slot_is_skipped():
    """Reduced zamba2: 5 layers in groups of 2, one padded slot.  The
    reference's output does not depend on the padded slot's weights, which
    is what lets the port drop them."""
    rc, pc = configs("zamba2-1.2b", 0)
    g, k = r_hybrid._grouping(rc)
    assert (g, k) == hybrid._grouping(pc) == (3, 2)
    assert hybrid.pad_fraction(pc) == r_hybrid.pad_fraction(rc) == 1 / 6
    np.testing.assert_array_equal(hybrid.valid_mask(pc).numpy(),
                                  np.asarray(r_hybrid.valid_mask(rc)))
    ref = r_build(rc)
    rp = ref.init_params(jax.random.key(0))
    tokens = {"tokens": jnp.asarray(np.arange(12)[None] % rc.vocab_size)}
    prefill = jax.jit(lambda p, b: ref.prefill(p, b, 16)[0])
    base = prefill(rp, tokens)
    noisy = dict(rp, mamba=jax.tree_util.tree_map(
        lambda a: a.at[g - 1, k - 1].set(a[g - 1, k - 1] + 3.0),
        rp["mamba"]))
    moved = prefill(noisy, tokens)
    np.testing.assert_array_equal(np.asarray(base), np.asarray(moved))
    pp = params_from_jax(pc, jax.tree_util.tree_map(np.asarray, rp), CPU)
    assert len(pp["mamba"]) == pc.num_layers == 5
    assert param_count(build_model(pc).param_shapes()) == (
        r_registry.param_count(ref.param_shapes())
        - r_registry.param_count(jax.tree_util.tree_map(
            lambda s: s[2:], ref.param_shapes()["mamba"],
            is_leaf=lambda s: isinstance(s, tuple))))


def test_dense_param_count_and_shapes_match_reference():
    rc, pc = configs("qwen3-1.7b", 0)
    assert param_count(build_model(pc).param_shapes()) == \
        r_registry.param_count(r_build(rc).param_shapes())
    full = get_config("qwen3-1.7b")
    # the published shape: ~1.7B parameters with tied embeddings
    assert 1.6e9 < param_count(build_model(full).param_shapes()) < 1.8e9


def test_forward_matches_reference():
    rc, pc = configs("qwen3-1.7b", 0)
    ref = r_build(rc)
    rp = ref.init_params(jax.random.key(2))
    pp = params_from_jax(pc, jax.tree_util.tree_map(np.asarray, rp), CPU)
    tokens = np.random.default_rng(3).integers(0, rc.vocab_size, (2, 9))
    from repro.models import transformer as r_tf
    want, _ = r_tf.forward(rp, {"tokens": jnp.asarray(tokens)}, rc)
    got = build_model(pc).forward(pp, {"tokens": torch.as_tensor(tokens)})
    assert_logits_close(np.asarray(want), got.numpy())


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_param_count_matches_reference(arch):
    rc, pc = configs(arch, 0)
    assert param_count(build_model(pc).param_shapes()) == \
        r_registry.param_count(r_build(rc).param_shapes())


@pytest.mark.parametrize("arch,low,high",
                         [("deepseek-moe-16b", 16.0e9, 17.5e9),
                          ("deepseek-v2-lite-16b", 15.0e9, 16.5e9),
                          ("phi-3-vision-4.2b", 3.7e9, 3.9e9)])
def test_family_published_sizes(arch, low, high):
    """The full configs' sizes (all 28 deepseek-moe layers MoE, the
    reference's stated deviation; phi-3's phi-3-mini backbone, 3.8B, the
    vision encoder being a stub)."""
    n = param_count(build_model(get_config(arch)).param_shapes())
    assert low < n < high, n


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_forward_matches_reference(arch):
    rc, pc = configs(arch, 0)
    ref = r_build(rc)
    rp = ref.init_params(jax.random.key(2))
    pp = params_from_jax(pc, jax.tree_util.tree_map(np.asarray, rp), CPU)
    tokens = np.random.default_rng(3).integers(0, rc.vocab_size, (2, 9))
    from repro.models import transformer as r_tf
    want, _ = r_tf.forward(rp, {"tokens": jnp.asarray(tokens)}, rc)
    for impl in ("chunked", "naive"):
        got = build_model(pc, impl=impl).forward(
            pp, {"tokens": torch.as_tensor(tokens)})
        assert_logits_close(np.asarray(want), got.numpy())


def test_vlm_prefills_embeds_like_the_reference():
    """phi-3-vision's prompt as embeddings (no sqrt(d) scale), then a token
    decode step on that cache."""
    rc, pc = configs("phi-3-vision-4.2b", 0)
    ref = r_build(rc)
    rp = ref.init_params(jax.random.key(4))
    pp = params_from_jax(pc, jax.tree_util.tree_map(np.asarray, rp), CPU)
    embeds = np.random.default_rng(5).normal(
        size=(2, rc.num_image_tokens + 3, rc.d_model)).astype(np.float32)
    rl, rcache = jax.jit(lambda p, b: ref.prefill(p, b, MAX_LEN))(
        rp, {"embeds": jnp.asarray(embeds)})
    port = build_model(pc)
    pl, pcache = port.prefill(pp, {"embeds": torch.as_tensor(embeds)},
                              MAX_LEN)
    assert_logits_close(np.asarray(rl), pl.numpy())
    tok = np.asarray([[7], [300]])
    rl, _ = ref.decode_step(rp, {"token": jnp.asarray(tok)}, rcache)
    pl, _ = port.decode_step(pp, {"token": torch.as_tensor(tok)}, pcache)
    assert_logits_close(np.asarray(rl), pl.numpy())
    # the embeds path is not the token path scaled: it takes them as given
    tokens = torch.zeros((2, embeds.shape[1]), dtype=torch.int64)
    pt, _ = port.prefill(pp, {"tokens": tokens}, MAX_LEN)
    assert not torch.allclose(pt, build_model(pc).prefill(
        pp, {"tokens": tokens, "embeds": torch.as_tensor(embeds)},
        MAX_LEN)[0])


def test_unknown_impl_is_rejected():
    with pytest.raises(ValueError, match="impl"):
        build_model(p_reduced("qwen3-1.7b"), impl="flash")
