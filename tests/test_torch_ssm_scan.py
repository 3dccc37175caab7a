"""The port's SSD scan (plain versions on the CPU) against the JAX package:
the Pallas kernel in interpret mode, ``mamba2.ssd_chunked`` and the
sequential oracle.  Inputs come from numpy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan.kernel import ssd_scan_kernel as r_scan_kernel
from repro.kernels.ssm_scan.ops import ssd_chunked_kernel as r_ssd_kernel
from repro.kernels.ssm_scan.ref import ssd_scan_ref as r_scan_ref
from repro.models import mamba2 as r_m2

from repro_torch.kernels.ssm_scan.ops import ssd_chunked_kernel
from repro_torch.kernels.ssm_scan.ref import (ssd_inputs,
                                              ssd_scan_chunked_ref,
                                              ssd_scan_ref)
from repro_torch.models import mamba2 as p_m2

# the reference's SSD_CASES (tests/test_kernels.py): (B, S, H, P, N, chunk)
SSD_CASES = [(1, 64, 2, 8, 8, 16), (2, 100, 3, 16, 4, 32),
             (1, 33, 1, 4, 32, 8)]


def ssd_inputs_np(seed, b, s, h, p, n):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, s, h, p)) * 0.5).astype(np.float32)
    dt = np.logaddexp(rng.normal(size=(b, s, h)) * 0.5, 0).astype(np.float32)
    bb = (rng.normal(size=(b, s, n)) * 0.5).astype(np.float32)
    cc = (rng.normal(size=(b, s, n)) * 0.5).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 8.0, h)).astype(np.float32)
    d_skip = np.linspace(0.5, 1.5, h).astype(np.float32)
    return x, dt, a_log, bb, cc, d_skip


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_CASES)
def test_plain_ssd_matches_pallas_and_model(b, s, h, p, n, chunk):
    args = ssd_inputs_np(b * s, b, s, h, p, n)
    y, st = ssd_chunked_kernel(*map(torch.as_tensor, args), chunk=chunk)
    jargs = list(map(jnp.asarray, args))
    for y_r, st_r in (r_ssd_kernel(*jargs, chunk=chunk),
                      r_m2.ssd_chunked(*jargs, chunk=chunk)):
        # f32 in another order: the JAX package's 2e-4
        np.testing.assert_allclose(y.numpy(), np.asarray(y_r), rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(st.numpy(), np.asarray(st_r), rtol=2e-4,
                                   atol=2e-4)


def test_sequential_ref_matches_pallas_and_chunked():
    """As tests/test_kernels.py: the Pallas kernel ≡ the sequential oracle
    (1e-4); and the port's chunked form ≡ its sequential oracle."""
    rng = np.random.default_rng(5)
    bh, nc, q, p, n, h = 4, 3, 8, 4, 6, 2
    xdt = rng.normal(size=(bh, nc, q, p)).astype(np.float32)
    loga = -np.abs(rng.normal(size=(bh, nc, q, 1))).astype(np.float32) * 0.1
    b = rng.normal(size=(bh // h, nc, q, n)).astype(np.float32)
    c = rng.normal(size=(bh // h, nc, q, n)).astype(np.float32)
    y_p, st_p = ssd_scan_ref(xdt, loga, b, c, n_heads_per_batch=h)
    y_k, st_k = jax.jit(lambda *a: r_scan_kernel(
        *a, n_heads_per_batch=h))(*map(jnp.asarray, (xdt, loga, b, c)))
    y_r, st_r = r_scan_ref(xdt, loga, b, c, n_heads_per_batch=h)
    for y_o, st_o in ((y_k, st_k), (y_r, st_r)):
        np.testing.assert_allclose(y_p.numpy(), np.asarray(y_o), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(st_p.numpy(), np.asarray(st_o),
                                   rtol=1e-4, atol=1e-4)
    # the same scan in the model layout [B, S, H, P] through the chunked form
    bsz = bh // h
    to_model = torch.as_tensor(xdt).reshape(bsz, h, nc * q, p).transpose(1, 2)
    y_c, st_c = ssd_scan_chunked_ref(
        to_model.contiguous(),
        torch.as_tensor(loga).reshape(bsz, h, nc * q).transpose(1, 2),
        torch.as_tensor(b).reshape(bsz, nc * q, n),
        torch.as_tensor(c).reshape(bsz, nc * q, n), chunk=q)
    np.testing.assert_allclose(
        y_c.transpose(1, 2).reshape(bh, nc, q, p).numpy(), y_p.numpy(),
        rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(st_c.reshape(bh, p, n).numpy(), st_p.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_ssd_step_matches_reference_and_continues_the_scan():
    x, dt, a_log, bb, cc, d_skip = ssd_inputs_np(9, 2, 5, 3, 4, 6)
    st0 = np.random.default_rng(1).normal(size=(2, 3, 4, 6)).astype(
        np.float32)
    args = (st0, x[:, 0], dt[:, 0], a_log, bb[:, 0], cc[:, 0], d_skip)
    y, st = p_m2.ssd_step(*map(torch.as_tensor, args))
    y_r, st_r = r_m2.ssd_step(*map(jnp.asarray, args))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_r), rtol=1e-6,
                               atol=1e-6)
    # S steps of ssd_step from zero ≡ the chunked scan over S
    state = torch.zeros(2, 3, 4, 6)
    ys = []
    t = list(map(torch.as_tensor, (x, dt, a_log, bb, cc, d_skip)))
    for i in range(5):
        yi, state = p_m2.ssd_step(state, t[0][:, i], t[1][:, i], t[2],
                                  t[3][:, i], t[4][:, i], t[5])
        ys.append(yi)
    y_c, st_c = ssd_chunked_kernel(*t, chunk=2)
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), y_c.numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(state.numpy(), st_c.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_ssd_inputs_are_the_references_decay_and_weighted_input():
    x, dt, a_log, *_ = ssd_inputs_np(2, 1, 6, 2, 3, 4)
    xdt, loga = ssd_inputs(*map(torch.as_tensor, (x, dt, a_log)))
    np.testing.assert_allclose(xdt.numpy(), x * dt[..., None], rtol=1e-6)
    np.testing.assert_allclose(loga.numpy(), -np.exp(a_log) * dt, rtol=1e-6)
