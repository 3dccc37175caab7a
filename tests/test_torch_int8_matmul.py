"""The port's W8A16 matmul (plain versions on the CPU) against the JAX
package: its Pallas kernel in interpret mode and its plain version, the
quantiser bit for bit, the tolerance the card kernel is held to, the
wrapper's checks, and the kernel bench's rows.  Inputs come from numpy."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.int8_matmul.ops import int8_matmul as r_int8_matmul
from repro.kernels.int8_matmul.ref import int8_matmul_ref as r_int8_ref
from repro.kernels.int8_matmul.ref import quant_error_bound as r_qeb
from repro.kernels.int8_matmul.ref import quantize as r_quantize

from repro_torch.bench import common as bench_common
from repro_torch.bench import kernels as bench
from repro_torch.kernels.int8_matmul.kernel import int8_matmul_kernel
from repro_torch.kernels.int8_matmul.ops import int8_matmul
from repro_torch.kernels.int8_matmul.ref import (int8_matmul_ref,
                                                 int8_tolerance,
                                                 quant_error_bound, quantize)

# the reference's INT8_CASES (tests/test_kernels.py), M = 1 in both types,
# and a leading [2, 3] shape: (lead, K, N, dtype)
INT8_CASES = [((8,), 32, 16, "float32"), ((64,), 128, 256, "float32"),
              ((33,), 70, 90, "float32"), ((16,), 64, 64, "bfloat16"),
              ((1,), 2048, 48, "float32"), ((1,), 2048, 48, "bfloat16"),
              ((2, 3), 40, 24, "bfloat16"), ((2, 3), 40, 24, "float32")]
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def int8_inputs(seed, lead, k, n):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(k, n)).astype(np.float32)
    x = (rng.normal(size=(*lead, k)) * 0.5).astype(np.float32)
    return x, w


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 step at |v|: 2^(floor(log2|v|) - 7)."""
    _, e = torch.frexp(v.abs().float())
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)


@pytest.mark.parametrize("shape", [(32, 16), (70, 90), (2048, 6144)])
def test_quantize_matches_reference_bit_for_bit(shape):
    rng = np.random.default_rng(shape[0])
    w = rng.normal(size=shape).astype(np.float32)
    w[:, shape[1] // 3] = 0.0                  # an all-zero column: scale 1
    wq_r, sc_r = r_quantize(w)
    wq, sc = quantize(w)
    assert wq.dtype == torch.int8 and sc.dtype == torch.float32
    np.testing.assert_array_equal(wq.numpy(), wq_r)
    np.testing.assert_array_equal(sc.numpy().view(np.uint32),
                                  sc_r.view(np.uint32))
    assert sc[shape[1] // 3] == 1.0
    # a tensor on its device quantises the same
    wq_t, sc_t = quantize(torch.as_tensor(w))
    assert torch.equal(wq_t, wq) and torch.equal(sc_t, sc)


def test_quant_error_bound_matches_reference():
    w = np.random.default_rng(0).normal(size=(128, 64)).astype(np.float32)
    got = quant_error_bound(w)
    assert got == r_qeb(w)
    assert got < 1.0 / 127.0


@pytest.mark.parametrize("lead,k,n,dtype", INT8_CASES)
def test_int8_matmul_matches_pallas_and_ref(lead, k, n, dtype):
    x, w = int8_inputs(sum(lead) + n, lead, k, n)
    wq_r, sc_r = r_quantize(w)
    wq, sc = quantize(w)
    xt = torch.as_tensor(x).to(TORCH_DTYPES[dtype])
    got = int8_matmul(xt, wq, sc)
    assert got.shape == (*lead, n) and got.dtype == xt.dtype
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    # the same bf16 inputs on both sides
    np.testing.assert_array_equal(np.asarray(xj, np.float32),
                                  xt.float().numpy())
    pallas = r_int8_matmul(xj, jnp.asarray(wq_r), jnp.asarray(sc_r),
                           bm=32, bn=32, bk=32)
    plain = r_int8_ref(xj.reshape(-1, k), jnp.asarray(wq_r),
                       jnp.asarray(sc_r)).reshape(*lead, n)
    assert torch.equal(int8_matmul_ref(xt.reshape(-1, k), wq, sc),
                       got.reshape(-1, n))
    for want in (pallas, plain):
        want = torch.as_tensor(np.array(want, np.float32))
        if dtype == "float32":
            # f32 sums in another order: the JAX package's 2e-5
            torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
        else:
            # both sides round an f32 sum of the same terms to bf16 once:
            # at most one bf16 step apart (measured on these cases: 0 steps
            # on every element)
            err = (got.float() - want).abs()
            assert bool((err <= bf16_ulp(want) + 1e-6).all()), \
                (err / (bf16_ulp(want) + 1e-6)).max()


def test_int8_matmul_vs_full_precision_model_level():
    """As the JAX package's model-level test: the dequantised product is
    within int8 error of the f32 product."""
    rng = np.random.default_rng(3)
    w = (rng.normal(size=(96, 48)) * 0.05).astype(np.float32)
    x = (rng.normal(size=(4, 96)) * 0.5).astype(np.float32)
    w_q, scale = quantize(w)
    out_q = int8_matmul(torch.as_tensor(x), w_q, scale)
    out_f = torch.as_tensor(x) @ torch.as_tensor(w)
    rel = float((out_q - out_f).abs().max() / (out_f.abs().max() + 1e-9))
    assert rel < 0.02, rel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_tolerance_holds_another_order_and_catches_a_dropped_term(dtype):
    """The card kernel's limit: the same product summed in another f32
    order (in 64-term blocks, as the kernel's tiles) reads below 1; the
    same product with one of its K = 2048 terms dropped, or with one
    column's scale taken from its neighbour, reads above 1."""
    x, w = int8_inputs(11, (4,), 2048, 256)
    w_q, scale = quantize(w)
    xt = torch.as_tensor(x).to(TORCH_DTYPES[dtype])
    want, tol = int8_tolerance(xt, w_q, scale)
    xf, wf = xt.float(), w_q.float()

    def blocked(xf, wf, sc):
        acc = torch.zeros(xf.shape[0], wf.shape[1])
        for k0 in range(0, xf.shape[1], 64):
            acc = acc + xf[:, k0:k0 + 64] @ wf[k0:k0 + 64]
        return (acc * sc).to(xt.dtype).float()

    def reading(got):
        return ((got - want).abs() / tol).max().item()

    assert reading(blocked(xf, wf, scale)) < 1.0
    assert reading(blocked(xf[:, :-1], wf[:-1], scale)) > 1.0
    shifted = scale.clone()
    shifted[7] = scale[6]
    assert reading(blocked(xf, wf, shifted)) > 1.0


def test_kernel_wrapper_checks_and_cpu_dispatch_launches_nothing():
    x = torch.zeros(4, 8)
    w_q = torch.zeros(8, 6, dtype=torch.int8)
    scale = torch.ones(6)
    with pytest.raises(ValueError, match="CUDA device"):
        int8_matmul_kernel(x, w_q, scale)
    with pytest.raises(TypeError, match="int8"):
        int8_matmul_kernel(x, w_q.float(), scale)
    with pytest.raises(TypeError):
        int8_matmul_kernel(x.double(), w_q, scale)
    with pytest.raises(ValueError, match="do not fit"):
        int8_matmul_kernel(torch.zeros(4, 7), w_q, scale)
    with pytest.raises(ValueError, match="do not fit"):
        int8_matmul_kernel(x, w_q, torch.ones(5))
    with pytest.raises(ValueError, match="contiguous"):
        int8_matmul_kernel(torch.zeros(8, 4).t(), w_q, scale)
    int8_matmul_kernel.launches = 0
    out = int8_matmul(torch.ones(2, 3, 8), w_q + 1, scale)
    assert out.shape == (2, 3, 6) and bool((out == 8.0).all())
    assert int8_matmul_kernel.launches == 0


ROW_KEYS = {"name", "case", "shape", "dtype", "us_per_call", "plain_us",
            "library_us", "library", "bound_us", "bound_by", "launches",
            "max_abs_err", "err_over_tol", "tolerance", "timing", "device"}
SMALL_ROWS = [(bench.flash_attention_row, dict(b=1, s=40, hq=4, hkv=2, d=16)),
              (bench.gbt_hist_row, dict(n=50, f=3, n_bins=8)),
              (bench.ssm_scan_row, dict(b=1, s=40, h=2, p=8, n=4, chunk=16)),
              (bench.int8_matmul_row, dict(case="small", m=3, k=40, n=24)),
              (bench.int8_matmul_row, dict(case="small_f32", m=3, k=40,
                                           n=24, dtype=torch.float32))]


@pytest.mark.parametrize("fn,kw", SMALL_ROWS,
                         ids=[f"{f.__name__}-{i}" for i, (f, _) in
                              enumerate(SMALL_ROWS)])
def test_bench_rows_on_the_cpu(fn, kw):
    row = fn(torch.device("cpu"), **kw)
    assert ROW_KEYS <= set(row)
    # on the CPU only the plain version runs: no kernel time, no launch
    assert row["us_per_call"] is None and row["err_over_tol"] is None
    assert row["launches"] == 0 and row["device"] == "cpu"
    assert row["plain_us"] > 0 and row["timing"] == "host"
    assert row["bound_us"] > 0 and row["bound_by"] in ("bytes",
                                                       "operations")
    assert (row["library_us"] is None) == (row["library"] is None)


def test_bench_main_needs_a_card_unless_asked_for_the_cpu(monkeypatch,
                                                          tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=None means cuda"):
        bench.main()
    monkeypatch.setattr(bench, "ROWS", SMALL_ROWS)
    monkeypatch.setattr(bench_common, "RESULTS_DIR", str(tmp_path))
    rows = bench.main(device="cpu")
    saved = json.loads((tmp_path / "bench_torch_kernels.json").read_text())
    assert [r["name"] for r in saved] == [r["name"] for r in rows] == [
        "flash_attention", "gbt_hist", "ssm_scan", "int8_matmul",
        "int8_matmul"]


def test_bench_shapes_are_qwen3_at_full_width():
    from repro_torch.configs import get_config
    cfg = get_config("qwen3-1.7b")
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    assert [s[1:] for s in bench.INT8_SHAPES] == [
        (1, d, f), (4, d, f), (4, f, d), (4, d, v), (4 * 2048, d, f)]
    # the bound of the decode product is its int8 weight over 3.35 TB/s
    row = bench.int8_matmul_row(torch.device("cpu"), m=4, k=8, n=16)
    assert row["bound_by"] == "bytes"
    ms, by = bench_common.bound(4 * 2048 * 2 + 2048 * 6144 + 4 * 6144
                                + 4 * 6144 * 2, 2 * 4 * 2048 * 6144,
                                bench_common.BF16_OPS_PER_S)
    assert by == "bytes" and abs(ms - 3.78e-3) < 0.01e-3


def test_bench_flash_rows_are_the_served_prefills():
    """The bench times flash_attention at both served models' prefill
    attention at full width: qwen3-1.7b and zamba2-1.2b's shared block,
    B 4 x S 2048 (chip_smoke's serving batch and prompt)."""
    import inspect
    from repro_torch.configs import get_config
    flash = [kw for fn, kw in bench.ROWS if fn is bench.flash_attention_row]
    defaults = {k: p.default for k, p in inspect.signature(
        bench.flash_attention_row).parameters.items() if k != "dev"}
    got = {kw.get("case", defaults["case"]):
           tuple({**defaults, **kw}[k] for k in ("b", "s", "hq", "hkv", "d"))
           for kw in flash}
    want = {}
    for arch, case in (("qwen3-1.7b", "qwen3_prefill"),
                       ("zamba2-1.2b", "zamba2_prefill")):
        cfg = get_config(arch)
        want[case] = (4, 2048, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    assert got == want
