"""The port's training path against the JAX package on the CPU, in f32 with
the reference's weights through ``params_from_jax``:

- ``train_loss`` and every parameter's gradient against
  ``jax.value_and_grad(api.train_loss)`` (the reference's gradient tree
  carried over by ``params_from_jax`` too) for every family (dense, MoE,
  MLA, VLM, audio, the hybrid and xLSTM), both impls, and the chunked
  cross-entropy;
- the attention backward (``FlashAttention``: the flash forward with its
  log-sum-exp, the backward op ``repro_torch::flash_attention_bwd``, on
  the CPU the plain flash backward) against ``jax.vjp`` of the
  reference's ``flash_attention``, and the log-sum-exp against the
  reference's ``_flash_fwd_inner``;
- ``train()`` over 5 steps against the reference's ``train()``;
- the synthetic batches bit for bit; checkpoints (round trip, ``latest``,
  files read by the other package); the launcher.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as r_ckpt
from repro.configs import reduced_config as r_reduced
from repro.data import synthetic as r_syn
from repro.models import attention as r_attn
from repro.models import build_model as r_build
from repro.train import TrainConfig as RTrainConfig
from repro.train import train as r_train

from repro_torch import ckpt
from repro_torch.configs import reduced_config as p_reduced
from repro_torch.data import synthetic as p_syn
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.launch import train as launch_train
from repro_torch.models import attention as p_attn
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.train import TrainConfig, train

CPU = torch.device("cpu")
# f32 sums in other orders: the loss within 1e-5 relative (measured
# <= 1.5e-7), each gradient leaf within 2e-5 of its largest magnitude
# (measured <= 2.6e-6)
LOSS_TOL, GRAD_TOL = 1e-5, 2e-5
# xLSTM's gate biases: their gradients are small differences of large terms
# (the stabilisers' paths; the sLSTM input gate's cancels to ~1e-9), so each
# leaf's gap is held to GRAD_TOL of the largest gradient of its block (the
# leaves of one name prefix): measured <= 1.4e-4 of the mLSTM input-gate
# bias's own magnitude and ~0.9 of the sLSTM's, by this port's backward and
# by autograd through the plain sLSTM loop alike, <= 1.3e-5 of every leaf's
# own magnitude elsewhere
BLOCK_SCALED = {"xlstm", "xlstm-loss-chunk"}
# (arch, config overrides, impl): every transformer family, whisper, the
# chunked cross-entropy (loss_chunk 8 over 20 tokens: a padded last chunk);
# zamba2 with ssm_chunk 8 (chunks of 8, 8 and 4: the SSD backward's chain
# over chunks and a ragged tail) and at its default chunk (one chunk), and
# through the plain scan (naive); xlstm-350m
LOSS_CASES = {
    "qwen3": ("qwen3-1.7b", {}, "chunked"),
    "qwen3-naive": ("qwen3-1.7b", {}, "naive"),
    "qwen3-swa": ("qwen3-1.7b", {"window": 8}, "chunked"),
    "qwen3-loss-chunk": ("qwen3-1.7b", {"loss_chunk": 8}, "chunked"),
    "starcoder2": ("starcoder2-7b", {}, "chunked"),
    "minitron": ("minitron-4b", {}, "chunked"),
    "moe": ("deepseek-moe-16b", {}, "chunked"),
    "mla": ("deepseek-v2-lite-16b", {}, "chunked"),
    "vlm": ("phi-3-vision-4.2b", {}, "chunked"),
    "whisper": ("whisper-tiny", {}, "chunked"),
    "whisper-naive": ("whisper-tiny", {}, "naive"),
    "whisper-loss-chunk": ("whisper-tiny", {"loss_chunk": 8}, "chunked"),
    "zamba2-chunk8": ("zamba2-1.2b", {"ssm_chunk": 8}, "chunked"),
    "zamba2": ("zamba2-1.2b", {}, "chunked"),
    "zamba2-naive": ("zamba2-1.2b", {}, "naive"),
    "xlstm": ("xlstm-350m", {}, "chunked"),
    "xlstm-loss-chunk": ("xlstm-350m", {"loss_chunk": 8}, "chunked"),
}


def configs(arch, **over):
    return (r_reduced(arch).replace(dtype="float32", **over),
            p_reduced(arch).replace(dtype="float32", **over))


def port_params(pc, rp):
    return params_from_jax(pc, jax.tree_util.tree_map(np.asarray, rp), CPU)


def to_torch(batch):
    return {k: torch.as_tensor(np.array(v)).long()
            if np.asarray(v).dtype == np.int32 else torch.as_tensor(
                np.array(v)) for k, v in batch.items()}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_train_loss_and_gradients_match_reference(case):
    arch, over, impl = LOSS_CASES[case]
    rc, pc = configs(arch, **over)
    ref, port = r_build(rc, impl=impl), build_model(pc, impl=impl)
    rp = ref.init_params(jax.random.key(0))
    pp = port_params(pc, rp).requires_grad_(True)
    batch = r_syn.train_batch(rc, 2, 20, seed=1)
    (want, r_metrics), r_grads = jax.value_and_grad(
        ref.train_loss, has_aux=True)(rp, batch)
    got, metrics = port.train_loss(pp, to_torch(batch))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_TOL)
    for k in ("xent", "aux"):
        np.testing.assert_allclose(metrics[k].item(), float(r_metrics[k]),
                                   rtol=LOSS_TOL, atol=1e-9)
    if rc.num_experts:
        assert metrics["aux"].item() > 0
    if over.get("ssm_chunk"):
        assert -(-20 // over["ssm_chunk"]) >= 3      # the chain is exercised
    want_grads = {name: t.detach().numpy() for name, t in
                  port_params(pc, r_grads).named_parameters()}
    scale = {name: np.abs(w).max() for name, w in want_grads.items()}
    if case in BLOCK_SCALED:
        block = {}
        for name, m in scale.items():
            key = name.rsplit(".", 1)[0]
            block[key] = max(block.get(key, 0.0), m)
        scale = {name: block[name.rsplit(".", 1)[0]] for name in scale}
    for name, p in pp.named_parameters():
        w = want_grads[name]
        # a parameter the loss never reads (a VLM's token embedding beside
        # its embeds) gets no gradient: the reference's is zero
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=GRAD_TOL * scale[name] + 1e-12,
                                   err_msg=name)


def test_train_loss_with_mask_matches_reference():
    rc, pc = configs("qwen3-1.7b")
    ref, port = r_build(rc), build_model(pc)
    rp = ref.init_params(jax.random.key(3))
    batch = dict(r_syn.train_batch(rc, 2, 12, seed=2))
    batch["mask"] = jnp.asarray(
        np.random.default_rng(0).random((2, 12)) < 0.6)
    want, _ = ref.train_loss(rp, batch)
    got, _ = port.train_loss(port_params(pc, rp), to_torch(batch))
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_TOL)


# (B, Sq, Sk, Hq, Hkv, D, Dv, causal, window, valid_len): causal and not,
# a window on either, GQA and MQA, Sq != Sk (whisper's cross-attention),
# ragged tails padded to the 16-wide chunks, an explicit valid_len, v
# narrower than q/k (MLA); the served models' head dims and groups: phi-3's
# D 96, MLA's 192 with v at 128, gemma's 256 on one kv head, starcoder2's
# group of 9 and minitron's of 3 at D 128; whisper's kind of cross
# attention (24 queries against a ragged 75 keys, non-causal, D 64), a
# group of 8 on one kv head at D 256, and a window with valid_len that
# leaves rows with no live key (dead rows)
BWD_CASES = [(2, 64, 64, 4, 4, 32, 32, True, 0, 0),
             (2, 64, 64, 4, 4, 32, 32, False, 0, 0),
             (1, 96, 96, 4, 2, 32, 32, True, 17, 0),
             (1, 64, 64, 4, 4, 32, 32, False, 9, 0),
             (2, 50, 50, 6, 2, 16, 16, True, 0, 0),
             (2, 24, 70, 4, 4, 32, 32, False, 0, 0),
             (1, 64, 64, 4, 1, 48, 32, True, 0, 0),
             (1, 40, 40, 2, 2, 24, 16, True, 7, 0),
             (2, 64, 64, 4, 2, 32, 32, True, 0, 40),
             (2, 48, 64, 4, 4, 32, 32, False, 0, 37),
             (1, 64, 64, 4, 4, 96, 96, True, 0, 0),
             (1, 64, 64, 4, 4, 192, 128, True, 0, 0),
             (1, 64, 64, 4, 1, 256, 256, True, 0, 0),
             (1, 48, 48, 18, 2, 128, 128, True, 0, 0),
             (1, 48, 48, 6, 2, 128, 128, True, 0, 0),
             (2, 24, 75, 6, 6, 64, 64, False, 0, 0),
             (1, 48, 48, 8, 1, 256, 256, True, 0, 0),
             (1, 64, 64, 4, 2, 32, 32, True, 4, 20)]
# f32 in other orders: within 1e-5 of each output's largest magnitude
# (measured <= 1e-6)
BWD_TOL = 1e-5


def _bwd_inputs(b, sq, sk, hq, hkv, d, dv, seed=0):
    rng = np.random.default_rng(seed + sq + sk + d)
    return [rng.normal(size=shape).astype(np.float32) for shape in
            ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, dv),
             (b, sq, hq, dv))]


@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,dv,causal,window,valid_len",
                         BWD_CASES)
def test_attention_backward_matches_jax_vjp(b, sq, sk, hq, hkv, d, dv,
                                            causal, window, valid_len):
    q, k, v, do = _bwd_inputs(b, sq, sk, hq, hkv, d, dv)
    scale = d ** -0.5
    if valid_len:                       # chunk multiples, the tail masked
        def ref(q, k, v):
            return r_attn.flash_attention(q, k, v, causal, window, scale,
                                          16, 16, valid_len)
    else:                               # padded to the chunks and cut
        def ref(q, k, v):
            return r_attn.chunked_attention(q, k, v, causal=causal,
                                            window=window, q_chunk=16,
                                            kv_chunk=16, scale=scale)
    # a window past valid_len leaves rows >= valid_len + window - 1 with
    # no live key: the reference reads their masked scores as live there
    # (exp(-1e30 - lse) with lse -1e30), the port gives them output 0 and
    # no gradient; its callers pad those rows with a cotangent of 0, and
    # the reference is held to the port on the rows below valid_len
    dead = bool(window and valid_len)
    rows = slice(0, valid_len if dead else sq)
    do_live = do.copy()
    do_live[:, rows.stop:] = 0
    want_out, vjp = jax.vjp(ref, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do_live))
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = p_attn.chunked_attention(*leaves, causal=causal, window=window,
                                   scale=scale, valid_len=valid_len)
    assert out.grad_fn is not None
    out.backward(torch.as_tensor(do_live))
    for got, w in zip([out.detach()[:, rows]] + [t.grad for t in leaves],
                      [np.asarray(want_out)[:, rows], *want]):
        w = np.asarray(w)
        np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                   atol=BWD_TOL * np.abs(w).max())
    if dead:
        # the port's dead rows: output 0, and their cotangent moves nothing
        assert not out.detach()[:, valid_len + window - 1:].any()
        grads = [t.grad.clone() for t in leaves]
        for t in leaves:
            t.grad = None
        do_dead = do_live.copy()
        do_dead[:, valid_len + window - 1:] = do[:, valid_len + window - 1:]
        p_attn.chunked_attention(*leaves, causal=causal, window=window,
                                 scale=scale, valid_len=valid_len
                                 ).backward(torch.as_tensor(do_dead))
        for t, g in zip(leaves, grads):
            assert torch.equal(t.grad, g)


@pytest.mark.parametrize("causal,window,valid_len",
                         [(True, 0, 0), (False, 0, 0), (True, 5, 0),
                          (True, 0, 40), (True, 4, 20)])
def test_lse_matches_reference(causal, window, valid_len):
    """The plain version's log-sum-exp against the reference's
    ``_flash_fwd_inner`` (natural-log units of the scaled scores); rows
    that see no key (a window past valid_len) give -1e30 on both sides."""
    b, s, hq, hkv, d = 2, 64, 4, 2, 32
    q, k, v, _ = _bwd_inputs(b, s, s, hq, hkv, d, d)
    scale = d ** -0.5
    _, want = r_attn._flash_fwd_inner(*map(jnp.asarray, (q, k, v)), causal,
                                      window, scale, 16, 16,
                                      valid_len or s)
    want = np.asarray(want).reshape(b, hq, s)
    _, got = attention_ref(*(torch.as_tensor(a).transpose(1, 2)
                             for a in (q, k, v)), causal=causal,
                           window=window, scale=scale, valid_len=valid_len,
                           return_lse=True)
    dead = want <= -1e29
    assert dead.any() == (window and valid_len and True or False)
    np.testing.assert_array_equal(got.numpy()[dead], want[dead])
    np.testing.assert_allclose(got.numpy()[~dead], want[~dead], rtol=1e-6,
                               atol=1e-6)


def test_flash_attention_skips_the_lse_when_nothing_needs_a_gradient():
    """Serving (no grad, or frozen inputs) calls the forward alone; an
    input that needs a gradient goes through ``FlashAttention``."""
    q, k, v, _ = (torch.as_tensor(a) for a in _bwd_inputs(1, 8, 8, 2, 2, 8,
                                                           8))
    assert p_attn.chunked_attention(q, k, v).grad_fn is None
    with torch.no_grad():
        assert p_attn.chunked_attention(q.requires_grad_(), k, v
                                        ).grad_fn is None
    out = p_attn.chunked_attention(q, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-moe-16b",
                                  "deepseek-v2-lite-16b", "whisper-tiny",
                                  "phi-3-vision-4.2b", "gemma-2b",
                                  "starcoder2-7b", "minitron-4b",
                                  "zamba2-1.2b", "xlstm-350m"])
def test_train_matches_reference_train(arch):
    """5 steps of AdamW under warmup_cosine from the same weights: each
    step's loss within 1e-5 relative (measured <= 1e-7)."""
    rc, pc = configs(arch)
    rp = r_build(rc).init_params(jax.random.key(0))
    pp = port_params(pc, rp)            # the reference's step donates rp
    kw = dict(steps=5, batch_size=2, seq_len=16, warmup_steps=2,
              log_every=0)
    want = r_train(rc, RTrainConfig(**kw), params=rp, log_fn=print)
    got = train(pc, TrainConfig(**kw), params=pp, device="cpu",
                log_fn=print)
    np.testing.assert_allclose(got.losses, want.losses, rtol=LOSS_TOL)
    assert got.steps_per_s > 0


def test_train_checkpoints_on_its_cadence(tmp_path):
    rc, pc = configs("qwen3-1.7b")
    res = train(pc, TrainConfig(steps=5, batch_size=2, seq_len=8,
                                ckpt_every=2, ckpt_dir=str(tmp_path),
                                log_every=0), device="cpu")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ckpt_2.npz",
                                                          "ckpt_4.npz"]
    path = ckpt.latest(str(tmp_path))
    assert path == r_ckpt.latest(str(tmp_path)) == str(tmp_path /
                                                       "ckpt_4.npz")
    tree, meta = ckpt.restore(path, res.final_params)
    assert meta == {"step": 4}
    assert [n for n, _ in tree.named_parameters()] == [
        n for n, _ in res.final_params.named_parameters()]


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "phi-3-vision-4.2b",
                                  "whisper-tiny", "zamba2-1.2b"])
def test_synthetic_batches_equal_the_reference(arch):
    rc, pc = r_reduced(arch), p_reduced(arch)
    for name, args in (("train_batch", (3, 17)), ("prefill_batch", (2, 9)),
                       ("decode_batch", (4,))):
        want = getattr(r_syn, name)(rc, *args, seed=5)
        got = getattr(p_syn, name)(pc, *args, seed=5, device="cpu")
        assert set(got) == set(want)
        for key in want:
            w = np.asarray(want[key])
            g = got[key].numpy()
            assert g.shape == w.shape and g.dtype.kind == w.dtype.kind
            np.testing.assert_array_equal(g, w)


def test_checkpoint_round_trip_keeps_dtypes_devices_and_grads(tmp_path):
    cfg = p_reduced("deepseek-v2-lite-16b")          # bf16, MoE + MLA
    params = build_model(cfg).init_params(0, "cpu", trainable=True)
    ckpt.save(str(tmp_path / "ckpt_7.npz"), params, step=7,
              metadata={"arch": cfg.name})
    tree, meta = ckpt.restore(str(tmp_path / "ckpt_7.npz"), params)
    assert meta == {"step": 7, "arch": cfg.name}
    got = dict(tree.named_parameters())
    for name, p in params.named_parameters():
        assert got[name].dtype == p.dtype and got[name].requires_grad
        assert torch.equal(got[name], p), name
    frozen = build_model(cfg).init_params(1, "cpu")
    tree, _ = ckpt.restore(str(tmp_path / "ckpt_7.npz"), frozen)
    assert not any(p.requires_grad for p in tree.parameters())
    assert torch.equal(tree["embed"], params["embed"])


@pytest.mark.parametrize("names", [["ckpt_2.npz", "ckpt_10.npz",
                                    "ckpt_9.npz", "other.npz",
                                    "ckpt_3.tmp"], ["x.npz"], []])
def test_latest_picks_the_reference_file(tmp_path, names):
    for n in names:
        (tmp_path / n).write_bytes(b"")
    assert ckpt.latest(str(tmp_path)) == r_ckpt.latest(str(tmp_path))
    assert ckpt.latest(str(tmp_path / "missing")) is None


def test_checkpoint_files_are_read_by_both_packages(tmp_path):
    """A flat tree (the profiling MLP's params dict) written by either
    package restores in the other with equal values and the step."""
    rng = np.random.default_rng(0)
    tree = {"w0": rng.normal(size=(6, 4)).astype(np.float32),
            "b0": rng.normal(size=4).astype(np.float32)}
    r_ckpt.save(str(tmp_path / "ref.npz"), {k: jnp.asarray(v) for k, v in
                                            tree.items()}, step=3)
    like = {k: torch.zeros(v.shape) for k, v in tree.items()}
    got, meta = ckpt.restore(str(tmp_path / "ref.npz"), like)
    assert meta["step"] == 3
    ckpt.save(str(tmp_path / "port.npz"), got, step=4)
    back, meta = r_ckpt.restore(str(tmp_path / "port.npz"),
                                {k: jnp.zeros(v.shape) for k, v in
                                 tree.items()})
    assert meta["step"] == 4
    for k, v in tree.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
        np.testing.assert_array_equal(np.asarray(back[k]), v)


def test_launcher_trains_the_reduced_model_on_the_cpu(capsys):
    res = launch_train.main(["--reduced", "--device", "cpu", "--steps", "3",
                             "--batch-size", "2", "--seq-len", "16"])
    assert len(res.losses) == 3 and all(np.isfinite(res.losses))
    assert "qwen3-1.7b: loss" in capsys.readouterr().out
    # the mesh path: 4 gloo ranks on the CPU, a (2, 2) mesh
    res = launch_train.main(["--reduced", "--debug-mesh", "--steps", "2"])
    assert len(res.losses) == 2 and all(np.isfinite(res.losses))
    assert "qwen3-1.7b: loss" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-350m"])
def test_launcher_trains_the_recurrent_families_on_the_cpu(arch, capsys):
    """``--arch`` takes the hybrid and xLSTM families (f32, the plain
    scans, as the reference's launcher runs them)."""
    res = launch_train.main(["--reduced", "--device", "cpu", "--arch", arch,
                             "--steps", "2", "--batch-size", "2",
                             "--seq-len", "16"])
    assert len(res.losses) == 2 and all(np.isfinite(res.losses))
    assert f"{arch}: loss" in capsys.readouterr().out


def test_serving_parameters_stay_frozen():
    api = build_model(p_reduced("qwen3-1.7b"))
    assert not any(p.requires_grad for p in
                   api.init_params(0, "cpu").parameters())
    assert all(p.requires_grad for p in
               api.init_params(0, "cpu", trainable=True).parameters())
