"""The port's optimisers and schedules against the JAX package's.

The same parameters and the same five gradients, made from a seed with
numpy, go through ``repro.optim`` (op by op, not jitted) and through
``repro_torch.optim``: each optimiser's parameters after every step agree
within ``rtol=2e-6, atol=1e-8`` in f32 (both do the reference's
arithmetic in the reference's order; ``1 - b**t`` is formed by each
package's own f32 power), and the schedules' learning rates within
``rtol=1e-6`` (each package's f32 cosine is its own approximation, and
``1 + cos`` near the end of the decay magnifies their last-ulp difference:
5 ulp, 3e-7 relative, at the worst step here).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro import optim as roptim

from repro_torch import optim as poptim

RTOL, ATOL = 2e-6, 1e-8

CASES = [
    ("sgd", {}),
    ("sgd", {"momentum": 0.9}),
    ("sgd", {"momentum": 0.9, "nesterov": True}),
    ("sgd", {"momentum": 0.5, "weight_decay": 0.01}),
    ("adam", {}),
    ("adam", {"weight_decay": 0.05}),
    ("adamw", {}),
    ("rmsprop", {}),
    ("rmsprop", {"momentum": 0.9}),
    ("adagrad", {}),
    ("adagrad", {"weight_decay": 0.1}),
]


def problem(seed=0, steps=5):
    rng = np.random.default_rng(seed)
    shapes = {"w": (7, 5), "b": (5,)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * 10.0 ** rng.uniform(-3, 1))
              .astype(np.float32) for k, s in shapes.items()}
             for _ in range(steps)]
    return params, grads


def run_reference(name, kw, lr, params, grads):
    opt = roptim.get_optimizer(name, lr, **kw)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(p)
    out = []
    for g in grads:
        updates, state = opt.update({k: jnp.asarray(v) for k, v in
                                     g.items()}, state, p)
        p = roptim.apply_updates(p, updates)
        out.append({k: np.asarray(v) for k, v in p.items()})
    return out


def run_port(name, kw, lr, params, grads):
    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt = poptim.get_optimizer(name, p.values(), lr, **kw)
    out = []
    for g in grads:
        for k, t in p.items():
            t.grad = torch.as_tensor(g[k])
        opt.step()
        out.append({k: t.detach().numpy().copy() for k, t in p.items()})
    return out


@pytest.mark.parametrize("name,kw", CASES,
                         ids=[f"{n}-{'-'.join(f'{k}{v}' for k, v in kw.items())}"
                              for n, kw in CASES])
def test_optimiser_steps_match_reference(name, kw):
    params, grads = problem()
    lr = 3e-3
    want = run_reference(name, kw, lr, params, grads)
    got = run_port(name, kw, lr, params, grads)
    for step, (w, g) in enumerate(zip(want, got)):
        for k in params:
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name} step {step} {k}")
    # the parameters moved
    assert not np.allclose(got[-1]["w"], params["w"])


@pytest.mark.parametrize("name", ["sgd", "adam", "rmsprop", "adagrad"])
def test_optimiser_follows_a_schedule_from_step_one(name):
    params, grads = problem(seed=1)
    want = run_reference(name, {}, roptim.warmup_cosine(1e-2, 2, 6),
                         params, grads)
    got = run_port(name, {}, poptim.warmup_cosine(1e-2, 2, 6), params,
                   grads)
    for w, g in zip(want, got):
        for k in params:
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("make", [
    lambda m: m.constant(3e-4),
    lambda m: m.cosine_decay(1e-2, 10),
    lambda m: m.cosine_decay(1e-2, 10, alpha=0.2),
    lambda m: m.warmup_cosine(5e-3, 3, 12),
])
def test_schedules_match_reference(make):
    r, p = make(roptim), make(poptim)
    for step in range(0, 16):
        want = np.float32(r(jnp.asarray(step, jnp.int32)))
        got = p(step)
        assert isinstance(got, float)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0,
                                   err_msg=f"step {step}")


def test_defaults_are_the_reference_defaults():
    p = [torch.zeros(2, requires_grad=True)]
    rms = poptim.get_optimizer("rmsprop", p, 1e-3).defaults
    assert rms["decay"] == 0.9 and rms["eps"] == 1e-8
    ada = poptim.get_optimizer("ADAGRAD", p, 1e-3).defaults
    assert ada["initial_accumulator"] == 0.1 and ada["eps"] == 1e-10
    aw = poptim.get_optimizer("adamw", p, 1e-3).defaults
    assert aw["b2"] == 0.95 and aw["weight_decay"] == 0.1
    with pytest.raises(KeyError, match="unknown optimiser"):
        poptim.get_optimizer("lamb", p, 1e-3)
