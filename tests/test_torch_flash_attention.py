"""The port's flash attention (plain version on the CPU) against the JAX
package: the Pallas kernel in interpret mode, its oracle, and the model's
``chunked_attention`` / ``naive_attention``.  Inputs come from numpy."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as r_flash
from repro.kernels.flash_attention.ref import attention_ref as r_attn_ref
from repro.models import attention as r_attn

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import attention as p_attn

# the reference's FLASH_CASES (tests/test_kernels.py):
# (B, Sq, Hq, Hkv, D, window, dtype, tol)
FLASH_CASES = [
    (1, 128, 4, 4, 32, 0, "float32", 2e-5),
    (2, 200, 8, 2, 64, 0, "float32", 2e-5),
    (2, 65, 4, 1, 16, 0, "float32", 2e-5),      # MQA + ragged seq
    (1, 256, 2, 2, 128, 31, "float32", 2e-5),   # sliding window
    (2, 128, 4, 2, 64, 0, "bfloat16", 3e-2),
    (1, 384, 6, 6, 64, 100, "bfloat16", 3e-2),
]


def qkv(seed, b, s, hq, hkv, d, dtype="float32"):
    rng = np.random.default_rng(seed)
    arrs = [(rng.normal(size=(b, s, h, d)) * 0.5).astype(np.float32)
            for h in (hq, hkv, hkv)]
    jx = [jnp.asarray(a, dtype) for a in arrs]
    pt = [torch.as_tensor(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, pt


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("b,s,hq,hkv,d,window,dtype,tol", FLASH_CASES)
def test_plain_flash_matches_pallas_interpret(b, s, hq, hkv, d, window,
                                              dtype, tol):
    (jq, jk, jv), (q, k, v) = qkv(s + d, b, s, hq, hkv, d, dtype)
    want = r_flash(jq, jk, jv, window=window, qblk=64, kblk=64)
    got = flash_attention(q, k, v, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("causal,window,valid_len",
                         [(True, 0, 0), (False, 0, 50), (True, 9, 0),
                          (False, 5, 0)])
def test_attention_ref_matches_reference_oracle(causal, window, valid_len):
    (jq, jk, jv), (q, k, v) = qkv(3, 2, 70, 6, 3, 32)
    t = (0, 2, 1, 3)
    want = r_attn_ref(jq.transpose(t), jk.transpose(t), jv.transpose(t),
                      causal=causal, window=window, valid_len=valid_len)
    got = attention_ref(q.permute(t), k.permute(t), v.permute(t),
                        causal=causal, window=window, valid_len=valid_len)
    # f32 softmax of the same scores: 2e-5, the JAX package's tolerance
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("window", [0, 24])
def test_chunked_attention_matches_model_paths(window):
    """The port's chunked path ≡ the reference's jnp flash twin and its
    naive path (2e-5 in f32, as tests/test_kernels.py pins them)."""
    (jq, jk, jv), (q, k, v) = qkv(21, 2, 96, 4, 2, 32)
    got = p_attn.chunked_attention(q, k, v, window=window)
    for want in (r_attn.chunked_attention(jq, jk, jv, window=window,
                                          q_chunk=32, kv_chunk=32),
                 r_attn.naive_attention(jq, jk, jv, window=window)):
        np.testing.assert_allclose(as_np(got), as_np(want), rtol=2e-5,
                                   atol=2e-5)
    np.testing.assert_allclose(
        as_np(p_attn.naive_attention(q, k, v, window=window)), as_np(got),
        rtol=2e-5, atol=2e-5)


def test_naive_attention_positions_and_valid_keys():
    (jq, jk, jv), (q, k, v) = qkv(5, 2, 12, 4, 1, 16)
    pos_q, pos_k = np.arange(12) + 5, np.arange(12)
    valid = np.random.default_rng(0).random((2, 12)) < 0.8
    valid[:, 0] = True
    want = r_attn.naive_attention(jq, jk, jv, window=7,
                                  pos_q=jnp.asarray(pos_q),
                                  pos_k=jnp.asarray(pos_k),
                                  valid_k=jnp.asarray(valid)[:, None, None])
    got = p_attn.naive_attention(q, k, v, window=7,
                                 pos_q=torch.as_tensor(pos_q),
                                 pos_k=torch.as_tensor(pos_k),
                                 valid_k=torch.as_tensor(valid)[:, None,
                                                                None])
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=2e-5, atol=2e-5)


def test_cuda_tensor_never_takes_the_plain_path(monkeypatch):
    """On a CUDA tensor the dispatch goes to the kernel wrapper (which
    builds and launches or raises), never to the plain version."""
    from repro_torch.kernels.flash_attention import ops
    called = []
    monkeypatch.setattr(ops, "flash_attention_kernel",
                        lambda *a, **kw: called.append(kw) or "kernel")
    fake = torch.empty(0, device="meta")
    assert ops.flash_attention(fake, fake, fake, window=3) == "kernel"
    assert called == [{"causal": True, "window": 3, "scale": None}]


def _tensor_core_emulation(q, k, v, *, causal, window, valid_len):
    """What the bf16 tensor-core kernel computes, in plain torch: f32
    scores and row sums, P rounded to bf16 before P·V, output in bf16."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, hkv, hq // hkv, sq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * d ** -0.5
    row, col = torch.arange(sq)[:, None], torch.arange(sk)[None, :]
    ok = col < (valid_len or sk)
    if causal:
        ok = ok & (col <= row)
    if window:
        ok = ok & (row - col < window)
    s = torch.where(ok, s, -torch.inf)
    m = s.amax(-1, keepdim=True).clamp_min(-1e30)
    p = torch.where(ok, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p.bfloat16().float(), v.float())
    out = torch.where(l > 0, out / l.clamp_min(1e-30), 0.0)
    return out.reshape(b, hq, sq, d).bfloat16()


@pytest.mark.parametrize("window,valid_len", [(64, 0), (0, 200), (48, 250)])
def test_bf16_tolerance_holds_rounding_and_catches_mask_faults(window,
                                                               valid_len):
    """The card's bf16 check: a kernel that rounds P and its output to
    bf16 stays within ``bf16_tolerance``; the same kernel with its window
    or valid-length mask off by one does not."""
    from repro_torch.kernels.flash_attention.ref import bf16_tolerance
    rng = np.random.default_rng(window + valid_len)
    q, k, v = (torch.as_tensor(rng.normal(size=(2, h, 320, 64)),
                               dtype=torch.bfloat16) for h in (4, 2, 2))
    kw = dict(causal=True, window=window, valid_len=valid_len)
    want, tol = bf16_tolerance(q, k, v, **kw)
    assert torch.equal(want, attention_ref(q.float(), k.float(), v.float(),
                                           **kw))

    def over(out):
        return ((out.float() - want).abs() / tol).max().item()

    assert over(_tensor_core_emulation(q, k, v, **kw)) <= 1.0
    faulty = dict(kw, window=window + 1 if window else 0,
                  valid_len=valid_len + 1 if valid_len else 0)
    assert over(_tensor_core_emulation(q, k, v, **faulty)) > 1.0
