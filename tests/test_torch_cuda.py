"""The port's CUDA kernels against their plain versions, on the card.

A CUDA kernel has no CPU mode, so these tests skip where there is no card.
On a machine with one they run with::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import decisions as dec
from repro_torch.core.costs import CompositeCost, lower_to_accel
from repro_torch.core import offload as off
from repro_torch.core.predictors.gbt import GBTRegressor
from repro_torch.hw import EDGE_DEVICES, get_device
from repro_torch.kernels.decide_split import kernel as ds_kernel
from repro_torch.kernels.decide_split import ref as ds_ref
from repro_torch.kernels.decide_split.ops import pack_inputs
from repro_torch.kernels.gbt_hist import kernel as gh_kernel
from repro_torch.kernels.gbt_hist import ref as gh_ref
from repro_torch.kernels.tree_predict import kernel as tp_kernel
from repro_torch.kernels.tree_predict import ref as tp_ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("n,f,n_bins", [(12000, 7, 64), (3, 2, 8), (0, 7, 64)])
def test_gbt_hist_kernel_matches_plain(cuda, n, f, n_bins):
    rng = np.random.default_rng(n)
    codes = torch.as_tensor(rng.integers(0, n_bins, (n, f)), dtype=torch.int32,
                            device=cuda)
    grad = torch.as_tensor(rng.normal(size=n), dtype=torch.float32,
                           device=cuda)
    gsum, cnt = gh_kernel.grad_histogram_kernel(codes, grad, n_bins)
    torch.cuda.synchronize()
    pg, pc = gh_ref.grad_histogram_ref(codes, grad, n_bins)
    assert torch.equal(cnt.double(), pc)
    abs_sum, _ = gh_ref.grad_histogram_ref(codes, grad.abs(), n_bins)
    assert torch.all((gsum.double() - pg).abs() <= 1e-4 * abs_sum)


def test_tree_predict_kernel_matches_plain(cuda):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(500, 6)).astype(np.float32)
    y = np.sin(x[:, 0]) * x[:, 1]
    model = GBTRegressor(n_trees=30, max_depth=8, subsample=0.8).fit(
        x, y, device=cuda)
    a = tp_ref.flatten_gbt(model)
    t = tp_ref.device_trees(a, cuda)
    codes = tp_ref.bin_codes_ref(torch.as_tensor(x, device=cuda), t.edges)
    args = (codes, t.feature, t.threshold_bin, t.left, t.right,
            t.scaled_value)
    got = tp_kernel.tree_predict_kernel(*args, max_depth=a.max_depth,
                                        base=a.base)
    want = tp_ref.tree_predict_ref(*args, max_depth=a.max_depth, base=a.base)
    # the same f64 additions in the same order: exactly equal
    assert torch.equal(got, want)
    assert torch.equal(model.predict(x, device=cuda).cpu(),
                       model.predict(x, device="cpu"))


@pytest.mark.parametrize("n_layers,n_envs", [(0, 7), (28, 100003), (300, 4099)])
def test_decide_split_kernel_matches_plain(cuda, n_layers, n_envs):
    rng = np.random.default_rng(n_layers)
    layers = [off.LayerCost(f"l{i}", float(f), float(a)) for i, (f, a) in
              enumerate(zip(rng.uniform(1e6, 1e12, n_layers),
                            rng.uniform(1e2, 1e8, n_layers)))]
    specs = list(EDGE_DEVICES.values())
    envs = dec.make_envs([specs[i] for i in rng.integers(5, size=n_envs)],
                         get_device("edge-server-a100"),
                         link_bw=rng.uniform(1e4, 1e10, n_envs),
                         link_latency_s=rng.uniform(0, 0.05, n_envs),
                         input_bytes=rng.uniform(0, 1e7, n_envs),
                         device=cuda)
    spec = lower_to_accel(CompositeCost(
        weights={"latency_s": 1.0, "energy_j": 0.05}, deadline_s=0.5))
    args = pack_inputs(layers, envs, spec).kernel_args
    ks, kc = ds_kernel.decide_split_kernel(*args)
    ps, pc = ds_ref.decide_split_ref(*args)
    torch.testing.assert_close(kc, pc, rtol=1e-5, atol=0.0)
    assert (ks == ps).double().mean().item() > 0.999
    kernel_plan = dec.decide_all(layers, envs, device=cuda)
    exact = dec.decide_all(layers, envs, backend="torch", device=cuda)
    assert torch.all(kernel_plan.total_time_s
                     <= exact.total_time_s * (1 + 1e-4) + 1e-12)


# (B, S, Hq, Hkv, D, window, causal, valid_len, dtype); bf16 with D 64 or
# 128 runs the tensor-core kernel, the rest the f32 CUDA-core kernel
FLASH_GPU_CASES = [
    (1, 128, 4, 4, 32, 0, True, 0, torch.float32),
    (2, 200, 8, 2, 64, 0, True, 0, torch.float32),
    (2, 65, 4, 1, 16, 0, True, 0, torch.float32),
    (1, 256, 2, 2, 128, 31, True, 0, torch.float32),
    (2, 100, 4, 2, 64, 0, False, 77, torch.float32),
    (2, 128, 4, 2, 64, 0, True, 0, torch.bfloat16),
    (2, 130, 4, 2, 32, 0, True, 0, torch.bfloat16),
    (2, 150, 4, 4, 128, 40, False, 120, torch.bfloat16),
    (1, 384, 6, 6, 64, 100, True, 0, torch.bfloat16),
    (4, 2048, 16, 8, 128, 0, True, 0, torch.bfloat16),   # qwen3-1.7b
    (4, 2048, 32, 32, 64, 0, True, 0, torch.bfloat16),   # zamba2-1.2b
    (4, 2048, 16, 8, 128, 512, True, 0, torch.bfloat16),
    (4, 2048, 16, 8, 128, 0, True, 1500, torch.bfloat16),
    (2, 150, 4, 1, 256, 0, True, 0, torch.float32),      # gemma-2b's D
    (1, 700, 8, 1, 256, 64, True, 600, torch.bfloat16),
    # bf16 around flash_fwd_wgmma's tiles (128 keys; 128 query rows at D
    # 128, 192 at D 64): ragged S, windows at and beside the tile edge,
    # valid_len 1 and 129, non-causal with valid_len or a window, GQA
    # groups of 1, 2 and 4
    (1, 127, 4, 4, 64, 0, True, 0, torch.bfloat16),
    (2, 129, 4, 2, 128, 0, True, 0, torch.bfloat16),
    (1, 255, 8, 2, 64, 0, True, 0, torch.bfloat16),
    (2, 257, 8, 2, 128, 0, True, 0, torch.bfloat16),
    (1, 257, 4, 1, 128, 1, True, 0, torch.bfloat16),
    (1, 255, 4, 4, 64, 127, True, 0, torch.bfloat16),
    (2, 257, 4, 2, 128, 128, True, 0, torch.bfloat16),
    (1, 255, 8, 2, 64, 129, True, 0, torch.bfloat16),
    (1, 129, 4, 1, 128, 0, True, 1, torch.bfloat16),
    (2, 257, 4, 2, 64, 0, True, 129, torch.bfloat16),
    (2, 255, 4, 4, 128, 0, False, 129, torch.bfloat16),
    (1, 127, 8, 2, 64, 0, False, 1, torch.bfloat16),
    (1, 257, 4, 1, 64, 129, False, 0, torch.bfloat16),
    (2, 193, 4, 2, 64, 0, True, 0, torch.bfloat16),
    (1, 385, 4, 1, 64, 191, True, 300, torch.bfloat16),
]


def _bf16_reading(got, q, k, v, **kw):
    """The bf16 output's largest error over ``bf16_tolerance``: the f32
    attention of the same values, P's and the output's rounding."""
    from repro_torch.kernels.flash_attention.ref import bf16_tolerance
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    want, tol = (t.transpose(1, 2) for t in bf16_tolerance(qt, kt, vt, **kw))
    return ((got.float() - want).abs() / tol).max().item()


def _check_flash(got, q, k, v, **kw):
    """f32: the JAX package's own 2e-5; bf16: within ``bf16_tolerance``."""
    from repro_torch.kernels.flash_attention.ref import attention_ref
    if q.dtype == torch.float32:
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        want = attention_ref(qt, kt, vt, **kw).transpose(1, 2)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
        return
    over = _bf16_reading(got, q, k, v, **kw)
    assert over <= 1.0, f"bf16 kernel off by {over} of its tolerance"


def _flash_inputs(cuda, b, s, hq, hkv, d, dtype=torch.bfloat16, seed=0):
    """Unit-scale q, k, v (scores of std 1, so the softmax is not flat)."""
    gen = torch.Generator(device=cuda).manual_seed(seed + s + d)
    return tuple(torch.randn((b, s, h, d), generator=gen, device=cuda)
                 .to(dtype) for h in (hq, hkv, hkv))


def test_flash_attention_unaligned_rows_take_the_cuda_core_kernel(cuda):
    """A head stride that is not a multiple of 8 elements cannot feed the
    tensor-core kernel's 16-byte loads: the f32 CUDA-core kernel runs."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    base = torch.randn(2, 96, 4, 68, device=cuda, dtype=torch.bfloat16)
    q = k = v = base[..., :64]
    fa_kernel.reset_counts()
    got = fa_kernel.flash_attention_kernel(q, k, v)
    assert fa_kernel.flash_attention_kernel.by_kernel == {
        "flash_fwd": 1, "flash_fwd_wgmma": 0}
    _check_flash(got, q, k, v)


@pytest.mark.parametrize("b,s,hq,hkv,d,window,causal,valid_len,dtype",
                         FLASH_GPU_CASES)
def test_flash_attention_kernel_matches_plain(cuda, b, s, hq, hkv, d, window,
                                              causal, valid_len, dtype):
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    rng = np.random.default_rng(s + d)
    # unit scale: scores of std 1, so the softmax is not flat
    q, k, v = (torch.as_tensor(rng.normal(size=(b, s, h, d)),
                               dtype=dtype, device=cuda)
               for h in (hq, hkv, hkv))
    kw = dict(causal=causal, window=window, valid_len=valid_len)
    fa_kernel.reset_counts()
    got = fa_kernel.flash_attention_kernel(q, k, v, **kw)
    torch.cuda.synchronize()
    wgmma = dtype == torch.bfloat16 and d in (64, 128)
    assert fa_kernel.flash_attention_kernel.by_kernel == {
        "flash_fwd": int(not wgmma), "flash_fwd_wgmma": int(wgmma)}
    _check_flash(got, q, k, v, **kw)


@pytest.mark.parametrize("d", [64, 128])
def test_flash_attention_reads_fused_qkv_views(cuda, d):
    """q, k and v as strided views of one fused [B, S, (Hq+2Hkv)·D] tensor:
    the tensor maps take the caller's strides, not contiguous ones."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    b, s, hq, hkv = 2, 300, 8, 2
    gen = torch.Generator(device=cuda).manual_seed(d)
    fused = torch.randn((b, s, (hq + 2 * hkv) * d), generator=gen,
                        device=cuda).bfloat16()
    q = fused[..., :hq * d].view(b, s, hq, d)
    k = fused[..., hq * d:(hq + hkv) * d].view(b, s, hkv, d)
    v = fused[..., (hq + hkv) * d:].view(b, s, hkv, d)
    assert not (q.is_contiguous() or k.is_contiguous() or v.is_contiguous())
    fa_kernel.reset_counts()
    got = fa_kernel.flash_attention_kernel(q, k, v)
    torch.cuda.synchronize()
    assert fa_kernel.flash_attention_kernel.by_kernel["flash_fwd_wgmma"] == 1
    _check_flash(got, q, k, v)
    _check_flash(fa_kernel.flash_attention_kernel(q.contiguous(),
                                                  k.contiguous(),
                                                  v.contiguous()), q, k, v)


@pytest.mark.parametrize("b,s,hq,hkv,d", [(4, 2048, 16, 8, 128),
                                          (4, 2048, 32, 32, 64)])
def test_flash_attention_is_bitwise_deterministic(cuda, b, s, hq, hkv, d):
    """Calls on the same inputs give the same bits at the qwen3-1.7b and
    zamba2-1.2b prefill shapes: a race on the K/V ring (a wrong barrier
    parity) would show as a difference between calls."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    q, k, v = _flash_inputs(cuda, b, s, hq, hkv, d)
    first = fa_kernel.flash_attention_kernel(q, k, v)
    for _ in range(3):
        assert torch.equal(fa_kernel.flash_attention_kernel(q, k, v), first)


# faults planted in a copy of the source: the diagonal tile's causal test
# `<=` written as `<`; the last live key tile dropped from the walk
FLASH_FAULTS = {
    "diagonal_excluded": ("(!causal || col <= row)",
                          "(!causal || col < row)"),
    "last_tile_dropped": (
        "return {lo, hi > lo ? (hi - lo + TK - 1) / TK : 0};",
        "return {lo, hi > lo ? (hi - lo - 1) / TK : 0};"),
}
# the qwen3-1.7b prefill shape and a ragged one
FLASH_FAULT_SHAPES = [(4, 2048, 16, 8, 128), (1, 700, 8, 1, 128)]


def _flash_fault_readings(cuda):
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    out = []
    for shape in FLASH_FAULT_SHAPES:
        q, k, v = _flash_inputs(cuda, *shape)
        fa_kernel.reset_counts()
        got = fa_kernel.flash_attention_kernel(q, k, v)
        assert fa_kernel.flash_attention_kernel.by_kernel[
            "flash_fwd_wgmma"] == 1
        out.append(_bf16_reading(got, q, k, v))
    return out


@pytest.mark.parametrize("fault", sorted(FLASH_FAULTS))
def test_flash_tolerance_sees_planted_faults(cuda, fault, tmp_path,
                                             monkeypatch):
    """Each fault, built from a copy of ``csrc/flash_attention.cu`` in a
    temporary directory, reads above 1 at both shapes; the sound kernel
    reads below 1 there."""
    from repro_torch.kernels import _build
    src = (_build.CSRC / "flash_attention.cu").read_text()
    old, new = FLASH_FAULTS[fault]
    assert src.count(old) == 1
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "flash_attention.cu").write_text(
        src.replace(old, new))
    sound = _flash_fault_readings(cuda)
    monkeypatch.setattr(_build, "CSRC", tmp_path / "csrc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    planted = _flash_fault_readings(cuda)
    print(f"flash_attention fault {fault}: err_over_tol sound {sound}, "
          f"planted {planted}")
    assert all(r < 1.0 for r in sound)
    assert all(r > 1.0 for r in planted)


# (B, S, H, P, N, chunk)
SSD_GPU_CASES = [(1, 64, 2, 8, 8, 16), (2, 100, 3, 16, 4, 32),
                 (1, 33, 1, 4, 32, 8), (4, 2048, 64, 64, 64, 128)]


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_GPU_CASES)
def test_ssm_scan_kernel_matches_plain(cuda, b, s, h, p, n, chunk):
    from repro_torch.kernels.ssm_scan import kernel as ss_kernel
    from repro_torch.kernels.ssm_scan.ref import ssd_inputs, \
        ssd_scan_chunked_ref
    rng = np.random.default_rng(s)
    x = torch.as_tensor(rng.normal(size=(b, s, h, p)) * 0.5,
                        dtype=torch.float32, device=cuda)
    dt = torch.nn.functional.softplus(torch.as_tensor(
        rng.normal(size=(b, s, h)) * 0.5, dtype=torch.float32, device=cuda))
    bb, cc = (torch.as_tensor(rng.normal(size=(b, s, n)) * 0.5,
                              dtype=torch.float32, device=cuda)
              for _ in range(2))
    a_log = torch.log(torch.linspace(1.0, 8.0, h, device=cuda))
    xdt, loga = ssd_inputs(x, dt, a_log)
    y, st = ss_kernel.ssd_scan_kernel(xdt, loga, bb, cc, chunk)
    torch.cuda.synchronize()
    y_p, st_p = ssd_scan_chunked_ref(xdt, loga, bb, cc, chunk)
    # f32 in another summation order: the JAX package's 2e-4, relative to
    # the output's scale
    for got, want in ((y, y_p), (st, st_p)):
        torch.testing.assert_close(got, want, rtol=2e-4,
                                   atol=2e-4 * want.abs().max().item())


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "zamba2-1.2b"])
def test_serving_path_runs_the_kernels(cuda, arch):
    from repro_torch.configs import reduced_config
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.ssm_scan import kernel as ss_kernel
    from repro_torch.models import build_model
    from repro_torch.serve import Request, ServeEngine
    cfg = reduced_config(arch).replace(dtype="float32")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 150)), device=cuda)
    params = build_model(cfg).init_params(0, cuda)
    got, _ = build_model(cfg).prefill(params, {"tokens": tokens}, 160)
    want, _ = build_model(cfg, impl="naive").prefill(params,
                                                     {"tokens": tokens}, 160)
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-4 * want.abs().max().item())
    fa_kernel.flash_attention_kernel.launches = 0
    ss_kernel.ssd_scan_kernel.launches = 0
    engine = ServeEngine(cfg, batch_size=2, max_len=64, device=cuda)
    done = engine.serve([Request(rid=i, prompt=np.arange(20 + i) % 97,
                                 max_new_tokens=4) for i in range(3)])
    assert [len(r.output) for r in done] == [4, 4, 4]
    n_attn = (cfg.num_layers if cfg.family == "dense"
              else -(-cfg.num_layers // cfg.shared_attn_every))
    assert fa_kernel.flash_attention_kernel.launches == 2 * n_attn
    assert ss_kernel.ssd_scan_kernel.launches == (
        2 * cfg.num_layers if cfg.family == "hybrid" else 0)


def test_head_dim_256_serves_on_the_card(cuda):
    """gemma-2b at full width (head dim 256, MQA), cut to 2 layers: the
    kernel path against the naive path in f32, then served in bf16."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.models import build_model
    from repro_torch.serve import Request, ServeEngine
    cfg = get_config("gemma-2b").replace(num_layers=2, dtype="float32")
    assert cfg.head_dim == 256
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(1, 300)), device=cuda)
    params = build_model(cfg).init_params(0, cuda)
    got, _ = build_model(cfg).prefill(params, {"tokens": tokens}, 300)
    want, _ = build_model(cfg, impl="naive").prefill(params,
                                                     {"tokens": tokens}, 300)
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-4 * want.abs().max().item())
    del params
    fa_kernel.flash_attention_kernel.launches = 0
    engine = ServeEngine(cfg.replace(dtype="bfloat16"), batch_size=1,
                         max_len=64, device=cuda)
    done = engine.serve([Request(rid=0, prompt=np.arange(40) % 97,
                                 max_new_tokens=4)])
    assert len(done[0].output) == 4
    assert fa_kernel.flash_attention_kernel.launches == cfg.num_layers


# (M, K, N): qwen3-1.7b's five timed products (decode B 1 and B 4, the
# down projection, the LM head, prefill), the JAX package's ragged
# INT8_CASES, and empty M, N, K
INT8_GPU_CASES = [(1, 2048, 6144), (4, 2048, 6144), (4, 6144, 2048),
                  (4, 2048, 151936), (8192, 2048, 6144),
                  (8, 32, 16), (64, 128, 256), (33, 70, 90), (16, 64, 64),
                  (0, 64, 32), (8, 64, 0), (8, 0, 32)]


def _int8_reading(cuda, m, k, n, dtype, seed=0):
    """The kernel's largest error over ``int8_tolerance`` on seeded
    unit-scale inputs."""
    from repro_torch.kernels.int8_matmul import kernel as q_kernel
    from repro_torch.kernels.int8_matmul.ref import int8_tolerance, quantize
    gen = torch.Generator(device=cuda).manual_seed(seed + m + n)
    x = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
    w_q, scale = (quantize(torch.randn((k, n), generator=gen, device=cuda))
                  if k else (torch.zeros((0, n), dtype=torch.int8,
                                         device=cuda),
                             torch.ones(n, device=cuda)))
    got = q_kernel.int8_matmul_kernel(x, w_q, scale)
    torch.cuda.synchronize()
    assert got.shape == (m, n) and got.dtype == dtype
    want, tol = int8_tolerance(x, w_q, scale)
    if got.numel() == 0:
        return 0.0
    return ((got.float() - want).abs() / tol.clamp_min(1e-30)).max().item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", INT8_GPU_CASES)
def test_int8_matmul_kernel_matches_plain(cuda, m, k, n, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False    # the plain f32 product
    over = _int8_reading(cuda, m, k, n, dtype)
    print(f"int8_matmul {m}x{k}x{n} {dtype}: err_over_tol {over}")
    assert over < 1.0


def test_int8_matmul_ops_flattens_and_runs_the_kernel(cuda):
    from repro_torch.kernels.int8_matmul import kernel as q_kernel
    from repro_torch.kernels.int8_matmul.ops import int8_matmul
    from repro_torch.kernels.int8_matmul.ref import int8_tolerance, quantize
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((3, 40, 2), generator=gen, device=cuda,
                    dtype=torch.bfloat16).transpose(1, 2)   # not contiguous
    w_q, scale = quantize(torch.randn((40, 24), generator=gen, device=cuda))
    q_kernel.int8_matmul_kernel.launches = 0
    got = int8_matmul(x, w_q, scale)
    assert got.shape == (3, 2, 24)
    assert q_kernel.int8_matmul_kernel.launches == 1
    want, tol = int8_tolerance(x.reshape(-1, 40), w_q, scale)
    assert ((got.reshape(-1, 24).float() - want).abs() <= tol).all()


# faults planted in a copy of the source: one column's scale taken from its
# neighbour at every 8-column tile edge; the ragged last K tile dropped
INT8_FAULTS = {
    "scale_off_by_one": ("  return acc * scale[n];",
                         "  return acc * scale[n ^ ((n & 7) == 7)];"),
    "ragged_k_tile_dropped": (
        "inline int k_tiles(int k, int bk) { return cdiv(k, bk); }",
        "inline int k_tiles(int k, int bk) { return k / bk; }"),
}


@pytest.mark.parametrize("fault", sorted(INT8_FAULTS))
def test_int8_tolerance_sees_planted_faults(cuda, fault, tmp_path,
                                            monkeypatch):
    """Each fault, built from a copy of ``csrc/int8_matmul.cu`` in a
    temporary directory, reads above 1 at the ragged (33, 70, 90) in both
    types; the sound kernel reads below 1 there."""
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    src = (_build.CSRC / "int8_matmul.cu").read_text()
    old, new = INT8_FAULTS[fault]
    assert src.count(old) == 1
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "int8_matmul.cu").write_text(src.replace(old, new))
    sound = {dt: _int8_reading(cuda, 33, 70, 90, dt)
             for dt in (torch.bfloat16, torch.float32)}
    monkeypatch.setattr(_build, "CSRC", tmp_path / "csrc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    planted = {dt: _int8_reading(cuda, 33, 70, 90, dt)
               for dt in (torch.bfloat16, torch.float32)}
    print(f"int8_matmul fault {fault}: err_over_tol sound {sound}, "
          f"planted {planted}")
    assert all(v < 1.0 for v in sound.values())
    assert all(v > 1.0 for v in planted.values())
