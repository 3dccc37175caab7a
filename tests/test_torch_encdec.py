"""The port's whisper-style encoder-decoder against the reference's on the
CPU, reduced whisper-tiny in f32 with the reference's weights through
``params_from_jax`` and the same numpy-seeded frames: the layer norm and
sinusoidal positions, ``encode``, ``decode_full`` (both impls), prefill
and its caches, teacher-forced decode steps and the decode-time position
formula; prefill(S) then one decode step against prefill(S+1)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as r_reduced
from repro.models import build_model as r_build
from repro.models import encdec as r_encdec
from repro.models import layers as r_layers

from repro_torch.configs import reduced_config as p_reduced
from repro_torch.models import build_model, encdec
from repro_torch.models import layers as p_layers
from repro_torch.models.convert import params_from_jax

ARCH = "whisper-tiny"
CPU = torch.device("cpu")
# f32 sums in other orders, relative to max |want| (measured ~1e-6)
TOL = 1e-5
MAX_LEN, PROMPT, STEPS = 32, 11, 6


def close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def test_layer_norm_matches_reference():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 5, 16)) * 3 + 1).astype(np.float32)
    scale, bias = (rng.normal(size=(16,)).astype(np.float32)
                   for _ in range(2))
    want = r_layers.layer_norm(*map(jnp.asarray, (x, scale, bias)))
    got = p_layers.layer_norm(*map(torch.from_numpy, (x, scale, bias)))
    close(got, want)


@pytest.mark.parametrize("seq,d", [(64, 128), (1500, 384)])
def test_sinusoidal_positions_match_reference(seq, d):
    close(p_layers.sinusoidal_positions(seq, d),
          r_layers.sinusoidal_positions(seq, d))


@pytest.fixture(scope="module")
def model():
    rc = r_reduced(ARCH).replace(dtype="float32")
    pc = p_reduced(ARCH).replace(dtype="float32")
    rp = r_build(rc).init_params(jax.random.key(0))
    pp = params_from_jax(pc, jax.tree_util.tree_map(np.asarray, rp), CPU)
    rng = np.random.default_rng(1)
    frames = rng.normal(size=(2, rc.enc_seq, rc.d_model)).astype(np.float32)
    tokens = rng.integers(0, rc.vocab_size, size=(2, PROMPT)).astype(
        np.int32)
    return rc, pc, rp, pp, frames, tokens


def test_params_convert_per_layer(model):
    rc, pc, rp, pp = model[:4]
    assert len(pp["enc_layers"]) == rc.enc_layers
    assert len(pp["dec_layers"]) == rc.num_layers
    np.testing.assert_array_equal(
        pp["dec_layers"][1]["cross_attn"]["wq"].numpy(),
        np.asarray(rp["dec_layers"]["cross_attn"]["wq"][1]))
    shapes = encdec.param_shapes(pc)
    assert shapes["dec_layers"][0] == r_encdec.dec_layer_shapes(rc)
    assert shapes["enc_layers"][0] == r_encdec.enc_layer_shapes(rc)


@pytest.mark.parametrize("impl", ["naive", "chunked"])
def test_encode_and_decode_full_match_reference(model, impl):
    rc, pc, rp, pp, frames, tokens = model
    enc_r = r_encdec.encode(rp, jnp.asarray(frames), rc, impl=impl)
    enc_p = encdec.encode(pp, torch.from_numpy(frames), pc, impl=impl)
    assert enc_p.shape == (2, rc.enc_seq, rc.d_model)
    close(enc_p, enc_r)
    logits_r, kvs_r = r_encdec.decode_full(rp, jnp.asarray(tokens), enc_r,
                                           rc, impl=impl)
    logits_p, kvs_p = encdec.decode_full(
        pp, torch.as_tensor(tokens, dtype=torch.int64), enc_p, pc, impl=impl)
    close(logits_p, logits_r)
    (sk, sv), (ck, cv) = kvs_r
    for l, ((psk, psv), (pck, pcv)) in enumerate(kvs_p):
        for got, want in ((psk, sk), (psv, sv), (pck, ck), (pcv, cv)):
            close(got, want[l])
    # the model API's forward takes frames and tokens
    got = build_model(pc, impl=impl).forward(
        pp, {"frames": torch.from_numpy(frames),
             "tokens": torch.as_tensor(tokens)})
    close(got, logits_r)


@pytest.fixture(scope="module")
def run(model):
    rc, pc, rp, pp, frames, tokens = model
    ref, port = r_build(rc), build_model(pc)
    batch_r = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens)}
    rl, rcache = jax.jit(lambda p, b: ref.prefill(p, b, MAX_LEN))(rp,
                                                                 batch_r)
    pl, pcache = port.prefill(pp, {"frames": torch.from_numpy(frames),
                                   "tokens": torch.as_tensor(tokens)},
                              MAX_LEN)
    out = {"prefill": (np.asarray(rl), pl.numpy()),
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


def test_prefill_and_decode_logits_match(run, model):
    want, got = run["prefill"]
    assert got.shape == want.shape == (2, 1, model[1].vocab_size)
    close(got, want)
    for want, got in run["decode"]:
        close(got, want)


@pytest.mark.parametrize("when", ["prefill", "final"])
def test_caches_match(run, when):
    want, got = run["cache"] if when == "prefill" else run["final_cache"]
    assert int(want["pos"]) == got["pos"] == PROMPT + (
        0 if when == "prefill" else STEPS)
    assert set(got) == set(want)
    for name in set(want) - {"pos"}:
        close(got[name].numpy(), want[name])


@pytest.mark.parametrize("pos", [0, 7, 447])
def test_decode_position_matches_reference(model, pos):
    """``_dec_embed_at``'s f32 angle from the position, as the reference's
    decode forms it."""
    rc, pc, rp, pp = model[:4]
    tok = np.asarray([[3], [500]], np.int32)
    want = r_encdec._dec_embed_at(rp, jnp.asarray(tok), rc,
                                  jnp.asarray(pos, jnp.int32))
    got = encdec._dec_embed_at(pp, torch.as_tensor(tok), pc, pos)
    close(got, want)


def test_decode_matches_a_longer_prefill(model):
    """prefill(S) then one decode step ≡ prefill(S+1)'s last logits: the
    table at prefill and the f32 formula at decode give one position."""
    _, pc, _, pp, frames, tokens = model
    api = build_model(pc)
    t = torch.as_tensor(tokens)
    f = torch.from_numpy(frames)
    full, _ = api.prefill(pp, {"frames": f, "tokens": t}, 20)
    _, cache = api.prefill(pp, {"frames": f, "tokens": t[:, :-1]}, 20)
    step, cache = api.decode_step(pp, {"token": t[:, -1:]}, cache)
    assert cache["pos"] == PROMPT
    close(step.numpy(), full.numpy(), 1e-4)
