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


# (Sq, Sk, causal, window, valid_len): every shape of the card's bf16
# flash cases (tests/test_torch_cuda.py and chip_smoke.py), and Sq != Sk
TILE_CASES = [
    (2048, 2048, True, 0, 0), (2048, 2048, True, 512, 0),
    (2048, 2048, True, 0, 1500), (700, 700, True, 64, 600),
    (700, 700, True, 0, 0), (128, 128, True, 0, 0), (130, 130, True, 0, 0),
    (150, 150, False, 40, 120), (384, 384, True, 100, 0),
    (127, 127, True, 0, 0), (129, 129, True, 0, 0), (255, 255, True, 0, 0),
    (257, 257, True, 0, 0), (257, 257, True, 1, 0), (255, 255, True, 127, 0),
    (257, 257, True, 128, 0), (255, 255, True, 129, 0),
    (129, 129, True, 0, 1), (257, 257, True, 0, 129),
    (255, 255, False, 0, 129), (127, 127, False, 0, 1),
    (257, 257, False, 129, 0), (300, 300, True, 0, 0),
    (100, 300, True, 0, 0), (300, 100, False, 0, 0), (257, 129, True, 64, 100),
]


def _live(sq, sk, causal, window, valid_len):
    """The brute-force [Sq, Sk] mask of ``ref._probs``: q = k = 0 make every
    score 0, so a live pair gets p = 1/n > 0 and a masked one exactly 0."""
    from repro_torch.kernels.flash_attention.ref import _probs
    p, live = _probs(torch.zeros(1, 1, sq, 1), torch.zeros(1, 1, sk, 1),
                     causal=causal, window=window, scale=1.0,
                     valid_len=valid_len)
    return (p[0, 0, 0] > 0) & live


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,sk,causal,window,valid_len", TILE_CASES)
def test_key_tile_classes_cover_the_mask(sq, sk, causal, window, valid_len,
                                         d):
    """At the kernel's tile sizes for head dim ``d``: every full tile is
    wholly live, every skipped tile wholly masked, and every live pair lies
    in a visited tile; the three classes partition the key tiles."""
    from repro_torch.kernels.flash_attention.kernel import (
        BLOCK_K, BLOCK_Q, classify_key_tiles)
    ok = _live(sq, sk, causal, window, valid_len)
    n_k = -(-sk // BLOCK_K)
    bq = BLOCK_Q[d]
    tiles = classify_key_tiles(sq, sk, d=d, causal=causal, window=window,
                               valid_len=valid_len)
    assert [t.q0 for t in tiles] == list(range(0, sq, bq))
    for t in tiles:
        rows = ok[t.q0:t.q0 + bq]
        assert sorted(t.skipped + t.masked + t.full) == list(range(n_k))
        for j in t.full:
            assert rows[:, j * BLOCK_K:(j + 1) * BLOCK_K].all()
            assert (j + 1) * BLOCK_K <= sk
        for j in t.skipped:
            assert not rows[:, j * BLOCK_K:(j + 1) * BLOCK_K].any()
    if causal and window == 0 and sq == sk and not valid_len:
        # a causal prefill masks only the tiles that the diagonal crosses
        assert all(t.masked == list(range(
            t.q0 // BLOCK_K, (min(t.q0 + bq, sq) - 1) // BLOCK_K + 1))
            for t in tiles)


def test_tile_sizes_match_the_source():
    """``BLOCK_Q`` is 64 rows per consumer warpgroup of the CUDA source
    (``consumer_groups``) at D 64 and 128; ``BLOCK_K`` is its ``TK``."""
    import re
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.kernel import BLOCK_K, BLOCK_Q
    src = (_build.CSRC / "flash_attention.cu").read_text()
    groups = re.search(r"int consumer_groups\(int d\) \{ return d == 64 \? "
                       r"(\d+) : (\d+); \}", src)
    assert BLOCK_Q == {64: 64 * int(groups[1]), 128: 64 * int(groups[2])}
    assert re.search(r"constexpr int TK = (\d+);", src)[1] == str(BLOCK_K)
    assert re.search(r"TQ = 64 \* NC;", src)


def _tile_walk(q, k, v, *, causal, window, valid_len, block_q, block_k):
    """The tensor-core kernel's walk in plain f32 torch, one head (q [Sq,D],
    k/v [Sk,D]): per query tile the visited key tiles in order, the mask
    applied on masked tiles only, masked scores p = 0 explicitly and
    corr = 1 while a row has seen nothing."""
    from repro_torch.kernels.flash_attention.kernel import classify_key_tiles
    sq, sk, d = q.shape[0], k.shape[0], q.shape[1]
    kv_lim = min(sk, valid_len or sk)
    out = torch.zeros_like(q)
    for t in classify_key_tiles(sq, sk, causal=causal, window=window,
                                valid_len=valid_len, block_q=block_q,
                                block_k=block_k):
        row = torch.arange(t.q0, min(t.q0 + block_q, sq))[:, None]
        m = torch.full((len(row), 1), -torch.inf)
        l = torch.zeros(len(row), 1)
        acc = torch.zeros(len(row), d)
        for j in sorted(t.masked + t.full):
            col = torch.arange(j * block_k, min((j + 1) * block_k, sk))[None]
            s = q[row[:, 0]] @ k[col[0]].T * d ** -0.5
            if j in t.masked:
                live = col < kv_lim
                if causal:
                    live = live & (col <= row)
                if window:
                    live = live & (row - col < window)
                s = torch.where(live, s, -torch.inf)
            m_new = torch.maximum(m, s.amax(1, keepdim=True))
            corr = torch.where(m_new == -torch.inf, 1.0, torch.exp(m - m_new))
            p = torch.where(s == -torch.inf, 0.0, torch.exp(s - m_new))
            l = l * corr + p.sum(1, keepdim=True)
            acc = acc * corr + p @ v[col[0]]
            m = m_new
        out[row[:, 0]] = torch.where(l > 0, acc / l.clamp_min(1e-30), 0.0)
    return out


@pytest.mark.parametrize("sq,sk,causal,window,valid_len,block_q,block_k",
                         [(300, 300, True, 0, 0, 128, 128),
                          (257, 257, True, 129, 0, 128, 128),
                          (255, 255, False, 0, 129, 128, 128),
                          (129, 129, True, 0, 1, 128, 128),
                          (400, 400, True, 0, 0, 192, 128),
                          (385, 385, True, 150, 300, 192, 128),
                          (200, 150, True, 37, 0, 48, 32),
                          (150, 200, False, 20, 90, 16, 16)])
def test_tile_walk_matches_attention_ref(sq, sk, causal, window, valid_len,
                                         block_q, block_k):
    """Visiting only the classified tiles, and masking only the masked
    ones, gives the plain attention (f32, the JAX package's 2e-5)."""
    rng = np.random.default_rng(sq + sk)
    q, k, v = (torch.as_tensor(rng.normal(size=(s, 32)), dtype=torch.float32)
               for s in (sq, sk, sk))
    kw = dict(causal=causal, window=window, valid_len=valid_len)
    got = _tile_walk(q, k, v, block_q=block_q, block_k=block_k, **kw)
    want = attention_ref(q[None, None], k[None, None], v[None, None], **kw)
    np.testing.assert_allclose(got.numpy(), want[0, 0].numpy(), rtol=2e-5,
                               atol=2e-5)
